"""JAX/flax variables of DeepLab (MobileNetV2) and of the FCDiscriminator ->
the port's state_dicts, and the JAX package's parameter order.

``from_jax_variables(params, batch_stats)`` takes the flax-style nested dicts
of numpy arrays that ``DeepLab.init`` produces (or a checkpoint holds) and
returns the reference torch key schema, the one s2r_tpu/io/torch_export.py
``export_deeplab`` writes: ``backbone.features.N.conv.j`` with its
``low_level_features``/``high_level_features`` aliases, ``aspp.aspp{k}``,
``aspp.global_avg_pool.{1,2}``, ``decoder.last_conv.{0,1,4,5,8}``.  The
result loads into ``models.deeplab.DeepLab`` with ``strict=True``.
``from_jax_discriminator(params)`` does the same for the discriminator's
``conv1``..``conv4`` and ``classifier`` (s2r_tpu/io/torch_import.py:265),
and ``from_jax_domain(params, batch_stats)`` for the domain classifier's
``DC_adnn1.{0,1}``, ``DC_adnn2.{0,1}`` and ``DC_adnn3`` (the keys
s2r_tpu/io/torch_export.py ``export_domain`` writes).

``deeplab_param_order``, ``discriminator_param_order`` and
``domain_param_order`` list the port's parameter names in the order
jax.tree flattens the JAX parameters (dict keys sorted at every level),
the order of the JAX package's flat optimizer buffers
(s2r_tpu/train/optim.py FusedOptimizer); ``feature_param_order`` is the
part of DeepLab's under f = backbone + ASPP, in the same order.

``train_state_from_jax`` carries the numpy trees of a JAX TrainState
(params, batch_stats, opt_state, step) of either layout, output_adapt or
feature_adapt / source_only, into the port's TrainState: the weights and
statistics through the converters above, and each flat optimizer buffer
leaf by leaf (``flat_to_port``), since the two packages list the leaves in
one order but each in its own layout (ROADMAP C.5).

Layouts: conv kernels HWIO -> OIHW (a depthwise [3,3,1,C] becomes
[C,1,3,3]); BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var, plus the num_batches_tracked buffer torch expects.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from s2r_tpu_torch.models.discriminator import NAMES as DISC_NAMES
from s2r_tpu_torch.models.domain import DOMAIN_LAYOUT
from s2r_tpu_torch.models.mobilenet import LOW_LEVEL_SPLIT, block_plan


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32))


def _conv(out: Dict, key: str, leaf: Mapping) -> None:
    out[f"{key}.weight"] = _t(np.transpose(np.asarray(leaf["kernel"]),
                                           (3, 2, 0, 1)))
    if "bias" in leaf:
        out[f"{key}.bias"] = _t(leaf["bias"])


def _bn(out: Dict, key: str, p: Mapping, s: Mapping) -> None:
    out[f"{key}.weight"] = _t(p["scale"])
    out[f"{key}.bias"] = _t(p["bias"])
    out[f"{key}.running_mean"] = _t(s["mean"])
    out[f"{key}.running_var"] = _t(s["var"])
    out[f"{key}.num_batches_tracked"] = torch.tensor(0, dtype=torch.long)


def _layout(output_stride: int) -> List[Tuple[Tuple[str, ...], str, str]]:
    """(JAX path, torch key, kind) of every conv and BatchNorm of DeepLab;
    kind is 'conv', 'conv_bias' (a conv with a bias) or 'bn'."""
    out = [(("backbone", "features_0_conv"), "backbone.features.0.0", "conv"),
           (("backbone", "features_0_bn"), "backbone.features.0.1", "bn")]
    for i, (_, _, _, _, t) in enumerate(block_plan(output_stride)):
        subs = ("dw_conv", "dw_bn", None, "project_conv", "project_bn")
        if t != 1:
            subs = ("expand_conv", "expand_bn", None) + subs
        for j, sub in enumerate(subs):
            if sub is not None:  # None: ReLU6, no parameters
                out.append((("backbone", f"features_{i + 1}", sub),
                            f"backbone.features.{i + 1}.conv.{j}",
                            "bn" if sub.endswith("_bn") else "conv"))
    for k in range(1, 5):
        out.append((("aspp", f"aspp{k}", "atrous_conv"),
                    f"aspp.aspp{k}.atrous_conv", "conv"))
        out.append((("aspp", f"aspp{k}", "bn"), f"aspp.aspp{k}.bn", "bn"))
    out += [(("aspp", "gap_conv"), "aspp.global_avg_pool.1", "conv"),
            (("aspp", "gap_bn"), "aspp.global_avg_pool.2", "bn"),
            (("aspp", "conv1"), "aspp.conv1", "conv"),
            (("aspp", "bn1"), "aspp.bn1", "bn"),
            (("decoder", "conv1"), "decoder.conv1", "conv"),
            (("decoder", "bn1"), "decoder.bn1", "bn"),
            (("decoder", "last_conv_0"), "decoder.last_conv.0", "conv"),
            (("decoder", "last_bn_0"), "decoder.last_conv.1", "bn"),
            (("decoder", "last_conv_1"), "decoder.last_conv.4", "conv"),
            (("decoder", "last_bn_1"), "decoder.last_conv.5", "bn"),
            (("decoder", "classifier"), "decoder.last_conv.8", "conv_bias")]
    return out


def _get(tree: Mapping, path: Tuple[str, ...]) -> Mapping:
    for k in path:
        tree = tree[k]
    return tree


def _alias(key: str) -> str:
    """backbone.features.N.rest -> the same key under low_level_features
    (N <= LOW_LEVEL_SPLIT) or high_level_features."""
    idx, rest = key[len("backbone.features."):].split(".", 1)
    alias = ("low_level_features" if int(idx) <= LOW_LEVEL_SPLIT
             else "high_level_features")
    return f"backbone.{alias}.{idx}.{rest}"


def from_jax_variables(params: Mapping, batch_stats: Mapping,
                       output_stride: int = 16) -> Dict[str, torch.Tensor]:
    """{'backbone','aspp','decoder'} params and batch_stats (nested dicts of
    numpy arrays) -> float32 CPU state_dict in the reference schema."""
    out: Dict[str, torch.Tensor] = {}
    for path, key, kind in _layout(output_stride):
        if kind == "bn":
            _bn(out, key, _get(params, path), _get(batch_stats, path))
        else:
            _conv(out, key, _get(params, path))
    for k in [k for k in out if k.startswith("backbone.features.")]:
        out[_alias(k)] = out[k]
    return out


def from_jax_discriminator(params: Mapping) -> Dict[str, torch.Tensor]:
    """FCDiscriminator params {'conv1'..'conv4','classifier': {'kernel',
    'bias'}} (numpy arrays) -> float32 CPU state_dict of
    models.discriminator.FCDiscriminator."""
    out: Dict[str, torch.Tensor] = {}
    for name in DISC_NAMES:
        _conv(out, name, params[name])
    return out


def from_jax_domain(params: Mapping, batch_stats: Mapping
                    ) -> Dict[str, torch.Tensor]:
    """DomainClassifier params and batch_stats ({'adnn1_conv', 'adnn1_bn',
    'adnn2_conv', 'adnn2_bn', 'adnn3_conv'}; numpy arrays) -> float32 CPU
    state_dict of models.domain.DomainClassifier."""
    out: Dict[str, torch.Tensor] = {}
    for jname, key, kind in DOMAIN_LAYOUT:
        if kind == "bn":
            _bn(out, key, params[jname], batch_stats[jname])
        else:
            _conv(out, key, params[jname])
    return out


_LEAVES = {"conv": (("kernel", "weight"),),
           "conv_bias": (("bias", "bias"), ("kernel", "weight")),
           "bn": (("bias", "bias"), ("scale", "weight"))}


def deeplab_param_order(output_stride: int = 16) -> List[str]:
    """DeepLab's parameter names (the canonical ``backbone.features`` ones)
    in the order jax.tree flattens the JAX params."""
    leaves = [(path + (jname,), f"{key}.{tname}")
              for path, key, kind in _layout(output_stride)
              for jname, tname in _LEAVES[kind]]
    return [k for _, k in sorted(leaves)]


def discriminator_param_order() -> List[str]:
    """The FCDiscriminator's parameter names in JAX flatten order."""
    return [f"{name}.{tname}" for name in sorted(DISC_NAMES)
            for _, tname in _LEAVES["conv_bias"]]


def feature_param_order(output_stride: int = 16) -> List[str]:
    """The names under f = backbone + ASPP, in DeepLab's flatten order
    (the JAX package's ``d_inv`` buffer: {'backbone', 'aspp'} flattens
    'aspp' first, as the whole of G does)."""
    return [k for k in deeplab_param_order(output_stride)
            if not k.startswith("decoder.")]


def domain_param_order() -> List[str]:
    """The DomainClassifier's parameter names in JAX flatten order."""
    leaves = [((jname, j), f"{key}.{t}")
              for jname, key, kind in DOMAIN_LAYOUT
              for j, t in _LEAVES[kind]]
    return [k for _, k in sorted(leaves)]


def _leaves(tree) -> List[np.ndarray]:
    """The leaves of nested dicts in jax.tree order (keys sorted at every
    level)."""
    if isinstance(tree, Mapping):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    return [tree]


def _unflatten(tree, leaves: List[np.ndarray]):
    """Nested dicts shaped like `tree` holding `leaves` (consumed in
    jax.tree order)."""
    if isinstance(tree, Mapping):
        return {k: _unflatten(tree[k], leaves) for k in sorted(tree)}
    return leaves.pop(0)


def flat_to_port(flat, tree: Mapping, convert: Callable[[Mapping], Dict],
                 order: Sequence[str]) -> torch.Tensor:
    """A JAX FusedOptimizer buffer (float32, leaves in jax.tree order, each
    in JAX's layout) -> the port's flat buffer (the same leaf order, each
    leaf in the port's layout: conv kernels HWIO -> OIHW).  `tree` gives
    the leaves' shapes, `convert` maps a tree of them to a state_dict, and
    `order` lists the state_dict's keys in flatten order."""
    shapes = [np.shape(leaf) for leaf in _leaves(tree)]
    sizes = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]
    parts = np.split(np.asarray(flat, np.float32).reshape(-1), sizes)
    sd = convert(_unflatten(tree, [q.reshape(s)
                                   for q, s in zip(parts, shapes)]))
    return torch.cat([sd[k].reshape(-1) for k in order])


def train_state_from_jax(state, params: Mapping, batch_stats: Mapping,
                         opt_state: Mapping, step: int,
                         output_stride: int = 16):
    """Load a JAX TrainState's numpy trees into the port's TrainState
    `state` (in place; returned): G's and D's weights and BatchNorm
    statistics, the step, and the optimizer buffers converted leaf by leaf
    to the port's layout on the modules' device.  The layout follows
    `opt_state`: output_adapt's {'G': {'momentum'}, 'D': {'m', 'v',
    'count'}} with D the FCDiscriminator and batch_stats G's; or
    feature_adapt's {'task' over G, 'd' over D, 'd_inv' over f = backbone +
    ASPP, 'c' over G}, each SGD {'momentum'} or Adam {'m', 'v', 'count'},
    with D the DomainClassifier and batch_stats {'G', 'D'}.  The dropout
    generator keeps its state: a JAX PRNG key has no torch counterpart."""
    feature = "task" in opt_state
    g_stats = batch_stats["G"] if feature else batch_stats

    def g_tree(t):
        return from_jax_variables(t, g_stats, output_stride)

    if feature:
        def d_tree(t):
            return from_jax_domain(t, batch_stats["D"])
        d_order = domain_param_order()
    else:
        d_tree, d_order = from_jax_discriminator, discriminator_param_order()
    state.G.load_state_dict(g_tree(params["G"]), strict=True)
    state.D.load_state_dict(d_tree(params["D"]), strict=True)
    dev = state.G.device
    f = {k: params["G"][k] for k in ("backbone", "aspp")}
    # (the tree a buffer runs over, its converter, its flatten order)
    over = {"G": (params["G"], g_tree, deeplab_param_order(output_stride)),
            "D": (params["D"], d_tree, d_order),
            "f": (f, lambda t: g_tree({**params["G"], **t}),
                  feature_param_order(output_stride))}
    nets = ({"task": "G", "d": "D", "d_inv": "f", "c": "G"} if feature
            else {"G": "G", "D": "D"})

    def buffers(s, net):
        tree, convert, order = over[net]
        return {k: int(np.asarray(v)) if k == "count" else
                flat_to_port(v, tree, convert, order).to(dev)
                for k, v in s.items()}

    state.opt_state = {name: buffers(opt_state[name], net)
                       for name, net in nets.items()}
    state.step = int(np.asarray(step))
    return state

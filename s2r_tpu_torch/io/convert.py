"""JAX/flax variables of DeepLab (any backbone) and of the FCDiscriminator ->
the port's state_dicts, and the JAX package's parameter order.

``from_jax_variables(params, batch_stats, backbone)`` takes the flax-style
nested dicts of numpy arrays that ``DeepLab.init`` produces (or a
checkpoint holds) and returns the torch key schema that
s2r_tpu/io/torch_export.py ``export_deeplab(..., backbone=)`` writes:
MobileNetV2's reference keys ``backbone.features.N.conv.j`` with their
``low_level_features``/``high_level_features`` aliases, torchvision's
``backbone.layer{L}.{B}.*`` for ResNet, and the JAX package's canonical
schemas for Xception (``backbone.block{k}.sep{r}.*``) and DRN
(``backbone.level{L}.*``); then ``aspp.aspp{k}``,
``aspp.global_avg_pool.{1,2}``, ``decoder.last_conv.{0,1,4,5,8}``.  The
result loads into ``models.deeplab.DeepLab(backbone=...)`` with
``strict=True``.  ``from_jax_discriminator(params)`` does the same for the
discriminator's ``conv1``..``conv4`` and ``classifier``
(s2r_tpu/io/torch_import.py:265), and ``from_jax_domain(params,
batch_stats)`` for the domain classifier's ``DC_adnn1.{0,1}``,
``DC_adnn2.{0,1}`` and ``DC_adnn3`` (the keys s2r_tpu/io/torch_export.py
``export_domain`` writes).  Each backbone's rows (JAX path, torch key,
kind) come from its model module's ``param_layout``; no layout depends on
the output stride.

``deeplab_param_order``, ``discriminator_param_order`` and
``domain_param_order`` list the port's parameter names in the order
jax.tree flattens the JAX parameters (dict keys sorted as strings at every
level, so ``block10`` comes before ``block2``), the order of the JAX
package's flat optimizer buffers (s2r_tpu/train/optim.py FusedOptimizer);
``feature_param_order`` is the part of DeepLab's under f = backbone +
ASPP, in the same order.  ``reference_param_order`` lists them in the
order the JAX package's torch importers record (``order_sink``), the
param ids of a reference optimizer.

``train_state_from_jax`` carries the numpy trees of a JAX TrainState
(params, batch_stats, opt_state, step) of either layout, output_adapt or
feature_adapt / source_only, into the port's TrainState (through
``state_tree_from_jax``): the weights and statistics through the
converters above, and each flat optimizer buffer leaf by leaf
(``flat_to_port``), since the two packages list the leaves in one order
but each in its own layout (ROADMAP C.5).

The other way, ``to_jax_variables``, ``to_jax_discriminator``,
``to_jax_domain`` and ``port_to_flat`` invert those converters bit for
bit, and ``train_state_to_jax`` makes the state dict of a JAX TrainState
from the port's, which io/checkpoint.py writes as a JAX-format checkpoint
the JAX package resumes.

Layouts: conv kernels HWIO -> OIHW (a depthwise [3,3,1,C] becomes
[C,1,3,3]); BatchNorm scale/bias/mean/var -> weight/bias/running_mean/
running_var, plus the num_batches_tracked buffer torch expects.
"""

from __future__ import annotations

import functools
from typing import Callable, Dict, List, Mapping, Sequence, Tuple

import numpy as np
import torch

from s2r_tpu_torch.models import drn, resnet, xception
from s2r_tpu_torch.models.deeplab import family
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


def _mobilenet_layout() -> List[Tuple[Tuple[str, ...], str, str]]:
    out = [(("features_0_conv",), "features.0.0", "conv"),
           (("features_0_bn",), "features.0.1", "bn")]
    # the parameters do not depend on the output stride
    for i, (_, _, _, _, t) in enumerate(block_plan(16)):
        subs = ("dw_conv", "dw_bn", None, "project_conv", "project_bn")
        if t != 1:
            subs = ("expand_conv", "expand_bn", None) + subs
        for j, sub in enumerate(subs):
            if sub is not None:  # None: ReLU6, no parameters
                out.append(((f"features_{i + 1}", sub),
                            f"features.{i + 1}.conv.{j}",
                            "bn" if sub.endswith("_bn") else "conv"))
    return out


def _backbone_layout(backbone: str) -> List[Tuple[Tuple[str, ...], str, str]]:
    fam = family(backbone)
    if fam == "mobilenet":
        return _mobilenet_layout()
    if fam == "resnet":
        return resnet.param_layout(resnet.depth_of(backbone))
    return (xception if fam == "xception" else drn).param_layout()


@functools.lru_cache(maxsize=None)
def _layout(backbone: str = "mobilenet"
            ) -> Tuple[Tuple[Tuple[str, ...], str, str], ...]:
    """(JAX path, torch key, kind) of every conv and BatchNorm of DeepLab
    on `backbone`, in the order the JAX package's torch importers visit
    them; kind is 'conv', 'conv_bias' (a conv with a bias) or 'bn'."""
    out = [(("backbone",) + path, f"backbone.{key}", kind)
           for path, key, kind in _backbone_layout(backbone)]
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
    return tuple(out)


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
                       backbone: str = "mobilenet"
                       ) -> Dict[str, torch.Tensor]:
    """{'backbone','aspp','decoder'} params and batch_stats (nested dicts of
    numpy arrays) -> float32 CPU state_dict in the torch schema."""
    out: Dict[str, torch.Tensor] = {}
    for path, key, kind in _layout(backbone):
        if kind == "bn":
            _bn(out, key, _get(params, path), _get(batch_stats, path))
        else:
            _conv(out, key, _get(params, path))
    return with_aliases(out)


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


@functools.lru_cache(maxsize=None)
def _param_order(backbone: str) -> Tuple[str, ...]:
    leaves = [(path + (jname,), f"{key}.{tname}")
              for path, key, kind in _layout(backbone)
              for jname, tname in _LEAVES[kind]]
    return tuple(k for _, k in sorted(leaves))


def deeplab_param_order(backbone: str = "mobilenet") -> List[str]:
    """DeepLab's parameter names (without MobileNetV2's aliases) in the
    order jax.tree flattens the JAX params."""
    return list(_param_order(backbone))


def discriminator_param_order() -> List[str]:
    """The FCDiscriminator's parameter names in JAX flatten order."""
    return [f"{name}.{tname}" for name in sorted(DISC_NAMES)
            for _, tname in _LEAVES["conv_bias"]]


def feature_param_order(backbone: str = "mobilenet") -> List[str]:
    """The names under f = backbone + ASPP, in DeepLab's flatten order
    (the JAX package's ``d_inv`` buffer: {'backbone', 'aspp'} flattens
    'aspp' first, as the whole of G does)."""
    return [k for k in _param_order(backbone)
            if not k.startswith("decoder.")]


def domain_param_order() -> List[str]:
    """The DomainClassifier's parameter names in JAX flatten order."""
    leaves = [((jname, j), f"{key}.{t}")
              for jname, key, kind in DOMAIN_LAYOUT
              for j, t in _LEAVES[kind]]
    return [k for _, k in sorted(leaves)]


_TORCH_PARAMS = {"conv": ("weight",), "conv_bias": ("weight", "bias"),
                 "bn": ("weight", "bias")}
_BN_BUFFERS = ("running_mean", "running_var", "num_batches_tracked")


def reference_param_order(backbone: str = "mobilenet",
                          parts: Sequence[str] = ("backbone", "aspp",
                                                  "decoder")) -> List[str]:
    """DeepLab's parameter names (canonical keys) under `parts`, in the
    order of a reference optimizer's param ids (the backbone's 1x group,
    then ASPP and the decoder in the 10x group), as the JAX package's
    importers record it (s2r_tpu/io/torch_import.py ``order_sink``): the
    reference's module registration for MobileNetV2; for the other
    backbones each block's convs before its BatchNorms, and DRN's plain
    levels before its residual ones, as those importers visit them."""
    prefixes = tuple(f"{p}." for p in parts)
    return [f"{key}.{t}" for _, key, kind in _layout(backbone)
            if key.startswith(prefixes) for t in _TORCH_PARAMS[kind]]


def domain_reference_order() -> List[str]:
    """The DomainClassifier's parameter names in torch registration
    order."""
    return [f"{key}.{t}" for _, key, kind in DOMAIN_LAYOUT
            for t in _TORCH_PARAMS[kind]]


def deeplab_state_keys(backbone: str = "mobilenet") -> List[str]:
    """DeepLab's state_dict keys without the backbone aliases: parameters
    and BatchNorm buffers, in module order."""
    return [f"{key}.{t}" for _, key, kind in _layout(backbone)
            for t in _TORCH_PARAMS[kind] + (_BN_BUFFERS if kind == "bn"
                                            else ())]


def domain_state_keys() -> List[str]:
    """The DomainClassifier's state_dict keys."""
    return [f"{key}.{t}" for _, key, kind in DOMAIN_LAYOUT
            for t in _TORCH_PARAMS[kind] + (_BN_BUFFERS if kind == "bn"
                                            else ())]


def with_aliases(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """`sd` plus the ``low_level_features``/``high_level_features`` alias
    of every ``backbone.features`` key (the same tensor)."""
    out = dict(sd)
    for k in [k for k in sd if k.startswith("backbone.features.")]:
        out[_alias(k)] = sd[k]
    return out


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


def state_tree_from_jax(params: Mapping, batch_stats: Mapping,
                        opt_state: Mapping, step,
                        backbone: str = "mobilenet") -> Dict:
    """A JAX TrainState's numpy trees (params, batch_stats, opt_state,
    step) of either layout -> the port's state tree (io/checkpoint.py
    ``state_tree``) on the CPU: {'step', 'G', 'D' (state_dicts),
    'opt_state' (flat buffers, each leaf in the port's layout), 'generator':
    None}.  The layout follows `opt_state`: output_adapt's {'G':
    {'momentum'}, 'D': {'m', 'v', 'count'}} with D the FCDiscriminator and
    batch_stats G's; or feature_adapt's {'task' over G, 'd' over D, 'd_inv'
    over f = backbone + ASPP, 'c' over G}, each SGD {'momentum'} or Adam
    {'m', 'v', 'count'}, with D the DomainClassifier and batch_stats {'G',
    'D'}.  A JAX PRNG key has no torch counterpart: 'generator' is None."""
    feature = "task" in opt_state
    g_stats = batch_stats["G"] if feature else batch_stats

    def g_tree(t):
        return from_jax_variables(t, g_stats, backbone)

    if feature:
        def d_tree(t):
            return from_jax_domain(t, batch_stats["D"])
        d_order = domain_param_order()
    else:
        d_tree, d_order = from_jax_discriminator, discriminator_param_order()
    f = {k: params["G"][k] for k in ("backbone", "aspp")}
    # (the tree a buffer runs over, its converter, its flatten order)
    over = {"G": (params["G"], g_tree, deeplab_param_order(backbone)),
            "D": (params["D"], d_tree, d_order),
            "f": (f, lambda t: g_tree({**params["G"], **t}),
                  feature_param_order(backbone))}

    def buffers(s, net):
        tree, convert, order = over[net]
        return {k: int(np.asarray(v)) if k == "count" else
                flat_to_port(v, tree, convert, order)
                for k, v in s.items()}

    return {"step": int(np.asarray(step)), "G": g_tree(params["G"]),
            "D": d_tree(params["D"]),
            "opt_state": {name: buffers(opt_state[name], net)
                          for name, net in _nets(feature).items()},
            "generator": None}


def _nets(feature: bool) -> Dict[str, str]:
    """Each optimizer state's name -> the net its buffer runs over."""
    return ({"task": "G", "d": "D", "d_inv": "f", "c": "G"} if feature
            else {"G": "G", "D": "D"})


def train_state_from_jax(state, params: Mapping, batch_stats: Mapping,
                         opt_state: Mapping, step: int):
    """Load a JAX TrainState's numpy trees into the port's TrainState
    `state` (in place; returned): G's and D's weights and BatchNorm
    statistics, the step, and the optimizer buffers converted leaf by leaf
    to the port's layout on the modules' device (``state_tree_from_jax``
    gives the layouts).  The dropout generator keeps its state."""
    tree = state_tree_from_jax(params, batch_stats, opt_state, step,
                               state.G.backbone_name)
    state.G.load_state_dict(tree["G"], strict=True)
    state.D.load_state_dict(tree["D"], strict=True)
    dev = state.G.device
    state.opt_state = {name: {k: v.to(dev) if torch.is_tensor(v) else v
                              for k, v in s.items()}
                       for name, s in tree["opt_state"].items()}
    state.step = tree["step"]
    return state


# ------------------------------------------------- the port -> JAX layouts

def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().to(torch.float32).numpy().copy()


def _set(tree: Dict, path: Tuple[str, ...], leaf) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = leaf


def _jax_conv(sd: Mapping, key: str, bias: bool) -> Dict:
    leaf = {"kernel": np.ascontiguousarray(
        np.transpose(_np(sd[f"{key}.weight"]), (2, 3, 1, 0)))}
    if bias:
        leaf["bias"] = _np(sd[f"{key}.bias"])
    return leaf


def _jax_bn(sd: Mapping, key: str) -> Tuple[Dict, Dict]:
    return ({"scale": _np(sd[f"{key}.weight"]),
             "bias": _np(sd[f"{key}.bias"])},
            {"mean": _np(sd[f"{key}.running_mean"]),
             "var": _np(sd[f"{key}.running_var"])})


def to_jax_variables(sd: Mapping[str, torch.Tensor],
                     backbone: str = "mobilenet") -> Tuple[Dict, Dict]:
    """The inverse of ``from_jax_variables``: DeepLab's state_dict (the
    canonical keys; MobileNetV2's aliases are not read) ->
    (params, batch_stats), nested dicts of float32 numpy arrays with conv
    kernels HWIO.  num_batches_tracked has no JAX counterpart."""
    params: Dict = {}
    stats: Dict = {}
    for path, key, kind in _layout(backbone):
        if kind == "bn":
            p, s = _jax_bn(sd, key)
            _set(params, path, p)
            _set(stats, path, s)
        else:
            _set(params, path, _jax_conv(sd, key, kind == "conv_bias"))
    return params, stats


def to_jax_discriminator(sd: Mapping[str, torch.Tensor]) -> Dict:
    """The inverse of ``from_jax_discriminator``."""
    return {name: _jax_conv(sd, name, True) for name in DISC_NAMES}


def to_jax_domain(sd: Mapping[str, torch.Tensor]) -> Tuple[Dict, Dict]:
    """The inverse of ``from_jax_domain``: (params, batch_stats)."""
    params: Dict = {}
    stats: Dict = {}
    for jname, key, kind in DOMAIN_LAYOUT:
        if kind == "bn":
            params[jname], stats[jname] = _jax_bn(sd, key)
        else:
            params[jname] = _jax_conv(sd, key, kind == "conv_bias")
    return params, stats


def port_to_flat(flat: torch.Tensor, template: Mapping[str, torch.Tensor],
                 to_jax: Callable[[Mapping], Mapping],
                 order: Sequence[str]) -> np.ndarray:
    """The inverse of ``flat_to_port``: the port's flat buffer (leaves in
    `order`, each in the port's layout) -> the JAX FusedOptimizer buffer
    (the same leaf order, each in JAX's layout).  `template` (a state_dict)
    gives the leaves' shapes and fills what the buffer does not cover, and
    `to_jax` maps a state_dict to the params tree the buffer runs over."""
    parts = flat.detach().cpu().to(torch.float32).split(
        [template[k].numel() for k in order])
    sd = dict(template)
    sd.update({k: q.view(template[k].shape) for k, q in zip(order, parts)})
    return np.concatenate([np.asarray(leaf, np.float32).reshape(-1)
                           for leaf in _leaves(to_jax(sd))])


def jax_rng(seed: int, prng_impl: str = "rbg") -> np.ndarray:
    """The uint32 bits of ``jax.random.PRNGKey(seed)`` (seed below 2^32):
    [0, seed] under threefry2x32; [0, seed, 0, seed] under the rbg
    implementations (the JAX Config's default 'rbg')."""
    words = [0, int(seed) & 0xFFFFFFFF]
    if prng_impl in ("rbg", "unsafe_rbg"):
        words = words * 2
    elif prng_impl != "threefry2x32":
        raise ValueError(f"unknown PRNG implementation {prng_impl!r}")
    return np.asarray(words, np.uint32)


def train_state_to_jax(state, seed: int = 1, prng_impl: str = "rbg") -> Dict:
    """The inverse of ``train_state_from_jax``: the port's TrainState ->
    the state dict of a JAX TrainState of the same method ({'step',
    'params', 'batch_stats', 'opt_state', 'rng'}, numpy leaves in the
    dtypes the JAX package keeps: step and Adam counts int32, buffers
    float32, each leaf in JAX's layout), what s2r_tpu/io/checkpoint.py
    writes under 'state'.  'rng' is ``jax_rng(seed, prng_impl)``; the
    dropout generator has no JAX counterpart (io/checkpoint.py keeps it
    beside the state)."""
    feature = "task" in state.opt_state
    backbone = state.G.backbone_name
    g_sd = {k: v for k, v in state.G.state_dict().items()}
    d_sd = {k: v for k, v in state.D.state_dict().items()}
    g_params, g_stats = to_jax_variables(g_sd, backbone)
    if feature:
        d_params, d_stats = to_jax_domain(d_sd)
        batch_stats = {"G": g_stats, "D": d_stats}
        d_conv, d_order = (lambda sd: to_jax_domain(sd)[0],
                           domain_param_order())
    else:
        d_params, batch_stats = to_jax_discriminator(d_sd), g_stats
        d_conv, d_order = to_jax_discriminator, discriminator_param_order()

    def g_conv(sd):
        return to_jax_variables(sd, backbone)[0]

    over = {"G": (g_sd, g_conv, deeplab_param_order(backbone)),
            "D": (d_sd, d_conv, d_order),
            "f": (g_sd, lambda sd: {k: v for k, v in g_conv(sd).items()
                                    if k != "decoder"},
                  feature_param_order(backbone))}

    def buffers(s, net):
        template, conv, order = over[net]
        return {k: np.asarray(v, np.int32) if k == "count" else
                port_to_flat(v, template, conv, order)
                for k, v in s.items()}

    return {"step": np.asarray(state.step, np.int32),
            "params": {"G": g_params, "D": d_params},
            "batch_stats": batch_stats,
            "opt_state": {name: buffers(state.opt_state[name], net)
                          for name, net in _nets(feature).items()},
            "rng": jax_rng(seed, prng_impl)}

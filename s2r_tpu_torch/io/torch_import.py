"""Reference torch checkpoints -> the port (s2r_tpu/io/torch_import.py).

The reference writes two schemas (SURVEY.md §2.5):

- ``single`` (train_adapt.py:204-209): {'state_dict': DeepLab, 'optimizer',
  'epoch', 'best_pred'};
- ``four`` (train.py:242-253): {'backbone_model_state_dict',
  'assp_model_state_dict' (sic), 'y_model_state_dict',
  'd_model_state_dict', 'task_optimizer', 'd_optimizer',
  'd_inv_optimizer', 'c_optimizer', 'epoch', 'best_pred'}.

The port's modules use the reference key schema and layouts (io/convert.py),
so the weights need only their keys picked and prefixed; the backbone's
``low_level_features``/``high_level_features`` aliases are made here, and a
file's ``num_batches_tracked`` is kept (0 when it has none).

Optimizer state (``import_optimizer_state``, ``merge_torch_opt_state``):
a torch optimizer's state is keyed by param id, the position of the
parameter in its param groups, which follow module registration (the 1x
group, then the 10x group: ``convert.reference_param_order``), not the
JAX flatten order of the port's flat buffers
(``convert.deeplab_param_order``).  Each entry is mapped by name: SGD's
``momentum_buffer`` to ``momentum``, Adam's ``exp_avg``/``exp_avg_sq``/
``step`` to ``m``/``v``/``count``.  Both frameworks lay a conv weight out
OIHW, so no buffer is transposed.  A missing entry is zero, as a fresh
buffer is; a buffer of another kind than the run's raises.

``apply_reference`` loads an imported checkpoint into a TrainState with
the JAX Trainer's ``_resume`` semantics (s2r_tpu/train/trainer.py:
188-221), and ``init_backbone`` is its ``--backbone-init``
(s2r_tpu/train/trainer.py:144-172).  Files are read with
``torch.load(weights_only=True)``, numpy scalars allowed.  Every backbone
of the JAX package's factory reads its own schema (io/convert.py): the
reference's MobileNetV2 keys, torchvision's ResNet keys (a torchvision
file's ``fc.*`` keys are not read), and the JAX package's canonical
Xception and DRN keys (s2r_tpu/io/torch_export.py).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                      deeplab_state_keys, domain_param_order,
                                      domain_reference_order,
                                      domain_state_keys, feature_param_order,
                                      reference_param_order, with_aliases)


def _numpy_scalar_globals() -> List:
    """What unpickling a numpy scalar needs (a reference's best_pred may be
    a numpy float64)."""
    try:
        from numpy._core.multiarray import scalar
    except ImportError:  # numpy 1
        from numpy.core.multiarray import scalar
    out = [scalar, np.dtype]
    dtypes = getattr(np, "dtypes", None)
    if dtypes is not None:
        out += [getattr(dtypes, n) for n in dir(dtypes)
                if n.endswith("DType") and isinstance(getattr(dtypes, n),
                                                      type)]
    return out


def torch_load(path: str):
    """``torch.load(path, weights_only=True)`` on the CPU, numpy scalars
    allowed."""
    with torch.serialization.safe_globals(_numpy_scalar_globals()):
        return torch.load(path, map_location="cpu", weights_only=True)


def _take(sd: Mapping, keys: Sequence[str], drop: str = "",
          add: str = "") -> Dict[str, torch.Tensor]:
    """{k: sd[add + k without its prefix `drop`]} of each key (float
    parameters and statistics as float32); a missing num_batches_tracked
    is 0."""
    out = {}
    for k in keys:
        src = add + k[len(drop):]
        if k.endswith("num_batches_tracked"):
            out[k] = (torch.as_tensor(sd[src]).detach() if src in sd
                      else torch.tensor(0, dtype=torch.long))
        else:
            out[k] = torch.as_tensor(sd[src]).detach().to(torch.float32)
    return out


def import_backbone(sd: Mapping, backbone: str = "mobilenet",
                    prefix: str = "") -> Dict[str, torch.Tensor]:
    """A torch state dict of the backbone (keys ``{prefix}features.N...``
    for MobileNetV2, ``{prefix}layer{L}.{B}...`` for ResNet, ...) -> the
    port's ``backbone.*`` keys (with MobileNetV2's aliases).  Every key
    of the schema is required; others are not read."""
    keys = [k for k in deeplab_state_keys(backbone)
            if k.startswith("backbone.")]
    return with_aliases(_take(sd, keys, "backbone.", prefix))


def import_optimizer_state(opt_sd: Mapping, order: Sequence[str],
                           template: Mapping[str, torch.Tensor]) -> Dict:
    """A torch optimizer state dict -> {'kind': 'empty'}, {'kind': 'sgd',
    'momentum': {name: tensor}} or {'kind': 'adam', 'm', 'v', 'count'}:
    the per-parameter buffers under the port's names (`order`: the param
    ids' names), zero where the file has no entry."""
    ids = [i for g in opt_sd["param_groups"] for i in g["params"]]
    if len(ids) != len(order):
        raise ValueError(
            f"optimizer covers {len(ids)} params but architecture order has "
            f"{len(order)} — checkpoint/architecture mismatch")
    state = opt_sd.get("state", {})
    kind = "empty"
    for st in state.values():
        if "exp_avg" in st:
            kind = "adam"
            break
        if st.get("momentum_buffer") is not None:
            kind = "sgd"
            break
    if kind == "empty":
        return {"kind": "empty"}

    def zeros():
        return {k: torch.zeros(template[k].shape) for k in order}

    def put(tree, name, value):
        value = torch.as_tensor(value).detach().to(torch.float32)
        if value.shape != tree[name].shape:
            raise ValueError(f"optimizer buffer of {name}: shape "
                             f"{tuple(value.shape)}, the parameter's "
                             f"{tuple(tree[name].shape)}")
        tree[name] = value

    if kind == "sgd":
        mom = zeros()
        for pid, name in zip(ids, order):
            st = state.get(pid)
            if st is not None and st.get("momentum_buffer") is not None:
                put(mom, name, st["momentum_buffer"])
        return {"kind": "sgd", "momentum": mom}
    m, v, count = zeros(), zeros(), 0
    for pid, name in zip(ids, order):
        st = state.get(pid)
        if st is None:
            continue
        put(m, name, st["exp_avg"])
        put(v, name, st["exp_avg_sq"])
        count = max(count, int(st.get("step", 0)))
    return {"kind": "adam", "m": m, "v": v, "count": count}


def import_reference_checkpoint(ckpt, backbone: str = "mobilenet") -> Dict:
    """A reference checkpoint of `backbone` (a path, or what
    ``torch_load`` returned) ->
    {'schema': 'single'|'four', 'epoch', 'best_pred', 'G': DeepLab
    state_dict (aliases included), 'D': DomainClassifier state_dict or
    None, 'opt': {name: import_optimizer_state result}} with the names of
    the port's optimizer states: 'G' (single); 'task', 'd', 'd_inv', 'c'
    (four)."""
    if isinstance(ckpt, str):
        ckpt = torch_load(ckpt)
    out = {"epoch": int(ckpt.get("epoch", 0)),
           "best_pred": float(ckpt.get("best_pred", 0.0)), "opt": {}}
    keys = deeplab_state_keys(backbone)
    g_order = reference_param_order(backbone)

    def opt(name, key, order, template):
        sd = ckpt.get(key)
        if isinstance(sd, dict) and "param_groups" in sd:
            out["opt"][name] = import_optimizer_state(sd, order, template)

    if "state_dict" in ckpt:
        out["schema"] = "single"
        out["G"] = with_aliases(_take(ckpt["state_dict"], keys))
        out["D"] = None
        # train_adapt.py:207: D's Adam is not saved
        opt("G", "optimizer", g_order, out["G"])
        return out
    out["schema"] = "four"
    g = {}
    for part, key in (("backbone", "backbone_model_state_dict"),
                      ("aspp", "assp_model_state_dict"),
                      ("decoder", "y_model_state_dict")):
        g.update(_take(ckpt[key], [k for k in keys
                                   if k.startswith(part + ".")],
                       part + "."))
    out["G"] = with_aliases(g)
    d_sd = ckpt.get("d_model_state_dict") or {}
    out["D"] = _take(d_sd, domain_state_keys()) if d_sd else None
    # train.py:58-82: f = backbone + ASPP, task and c over f + y, d over D,
    # d_inv over f
    f_order = reference_param_order(backbone, ("backbone", "aspp"))
    opt("task", "task_optimizer", g_order, out["G"])
    if out["D"] is not None:
        opt("d", "d_optimizer", domain_reference_order(), out["D"])
    opt("d_inv", "d_inv_optimizer", f_order, out["G"])
    opt("c", "c_optimizer", g_order, out["G"])
    return out


def merge_torch_opt_state(opt_imports: Mapping, opt_state: Mapping,
                          backbone: str = "mobilenet",
                          device: Optional[torch.device] = None) -> Dict:
    """Imported optimizer buffers -> a copy of the port's `opt_state` with
    those entries replaced by flat buffers in the port's leaf order (on
    `device`).  An entry the run lacks, or an empty one (a never-stepped
    optimizer), leaves the current zeros."""
    g_order = deeplab_param_order(backbone)
    orders = {"G": g_order, "task": g_order, "c": g_order,
              "D": domain_param_order(), "d": domain_param_order(),
              "d_inv": feature_param_order(backbone)}
    new = dict(opt_state)
    for key, imp in opt_imports.items():
        if key not in new or imp["kind"] == "empty":
            continue
        want = "sgd" if "momentum" in new[key] else "adam"
        if imp["kind"] != want:
            raise ValueError(
                f"checkpoint optimizer '{key}' is {imp['kind']} but the run "
                f"is configured for {want} — pass --optimizer to match or "
                f"resume with --ft")

        def flat(tree):
            return torch.cat([tree[k].reshape(-1) for k in orders[key]]
                             ).to(device)

        if imp["kind"] == "sgd":
            new[key] = {"momentum": flat(imp["momentum"])}
        else:
            new[key] = {"m": flat(imp["m"]), "v": flat(imp["v"]),
                        "count": int(imp["count"])}
    return new


def apply_reference(state, imported: Mapping, ft: bool) -> Tuple[int, float]:
    """Load an imported reference checkpoint into `state` as the JAX
    Trainer does: G's weights and statistics always; D's only from a
    ``four`` file into a feature-method state (output_adapt's D stays at
    init: the reference saves no discriminator); without `ft` also the
    optimizer buffers.  The step and the dropout generator stay.  Returns
    (epoch, best_pred) of the file."""
    state.G.load_state_dict(imported["G"], strict=True)
    feature = "task" in state.opt_state
    if imported["D"] is not None and feature:
        state.D.load_state_dict(imported["D"], strict=True)
    if not ft and imported["opt"]:
        state.opt_state = merge_torch_opt_state(
            imported["opt"], state.opt_state, state.G.backbone_name,
            state.G.device)
    return imported["epoch"], imported["best_pred"]


def init_backbone(model, path: str) -> None:
    """``--backbone-init``: load a torch state dict of `model`'s backbone
    (the reference's mobilenet_VOC.pth, a torchvision ResNet, or the
    JAX package's Xception and DRN exports; a ``state_dict`` entry is
    unwrapped) into that backbone: its weights and running statistics,
    every key of the schema required, as the JAX package's importers
    (s2r_tpu/io/torch_import.py ``_backbone_importer``) read them."""
    sd = torch_load(path)
    if "state_dict" in sd:
        sd = sd["state_dict"]
    new = import_backbone(sd, model.backbone_name)
    current = model.state_dict()
    current.update({k: v for k, v in new.items()
                    if not k.endswith("num_batches_tracked")})
    model.load_state_dict(current, strict=True)

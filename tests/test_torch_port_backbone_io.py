"""Checkpoints of the port's other backbones (ResNet-50, Aligned
Xception-65, DRN-D-54) against the JAX package's readers and writers, on
the CPU.  Every comparison is exact.

- A JAX ``.ckpt`` of the output_adapt state (optimizer buffers drawn from
  a seed, step 5) resumed into the port equals train_state_from_jax of its
  trees; a port-written ``.ckpt`` reads back bit-equal, is resumed by the
  JAX Trainer (``_resume``) and carried back unchanged.
- A reference ``.pth.tar`` written by the port
  (``save_reference_checkpoint(backbone=)``, ``single`` and ``four``) is
  read by the JAX package's importer, and one the JAX package writes is
  resumed by the port.
- ``--backbone-init`` from the JAX package's backbone exporters equals the
  JAX Trainer's ``_init_backbone`` (ResNet-101 and -50 with a
  torchvision ``fc``, which is not read).
- A servable records its backbone, and load_servable rebuilds it.

The files are full width (hundreds of MB); each test removes its own.
"""

import functools
import os
import shutil
import tempfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.io.checkpoint import save_checkpoint as jax_save
from s2r_tpu.io.torch_export import export_any_backbone
from s2r_tpu.io.torch_export import save_reference_checkpoint as jax_export
from s2r_tpu.io.torch_import import \
    import_reference_checkpoint as jax_import
from s2r_tpu_torch import config as PC
from s2r_tpu_torch.io.checkpoint import (host_tree, load_checkpoint,
                                         save_jax_checkpoint)
from s2r_tpu_torch.io.convert import (from_jax_variables,
                                      train_state_from_jax)
from s2r_tpu_torch.io.torch_export import save_reference_checkpoint
from s2r_tpu_torch.io.torch_import import init_backbone
from s2r_tpu_torch.models.deeplab import DeepLab
from s2r_tpu_torch.models.domain import DomainClassifier
from s2r_tpu_torch.train.setup import build_method
from s2r_tpu_torch.train.trainer import resume_into

from _torch_port_common import (jax_output_adapt, perturb_stats,
                                torch_threads)

# each backbone family once
CKPT = ("resnet50", "xception", "drn")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture
def tmp_dir():
    """A directory removed after the test: pytest keeps its tmp_path
    directories, and these checkpoints are hundreds of MB each."""
    path = tempfile.mkdtemp(prefix="s2r_backbone_io_")
    yield path
    shutil.rmtree(path, ignore_errors=True)


@functools.lru_cache(maxsize=None)
def _variables(backbone):
    """G's (params, perturbed batch_stats) as numpy trees."""
    js = jax_output_adapt(backbone)[1]
    return _np(js.params["G"]), perturb_stats(_np(js.batch_stats))


def _port(backbone):
    params, stats = _variables(backbone)
    model = DeepLab(device="cpu", backbone=backbone)
    model.load_state_dict(from_jax_variables(params, stats, backbone),
                          strict=True)
    return model


def _filled(js, seed=0):
    rs = np.random.RandomState(seed + 10)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.float32 and x.ndim == 1:
            return rs.randn(*x.shape).astype(np.float32)
        if x.ndim == 0:
            return np.asarray(3, x.dtype)
        return x

    return js.replace(opt_state=jax.tree_util.tree_map(fill, js.opt_state),
                      step=jnp.asarray(5, jnp.int32))


def _port_method(backbone):
    return build_method(PC.Config(precision="f32", backbone=backbone), 4,
                        method="output_adapt", device="cpu")


def _tree_equal(a, b):
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_tree_equal(a[k], b[k]) for k in a))
    return a == b


@pytest.mark.parametrize("backbone", CKPT)
def test_jax_ckpt_resumes_and_port_ckpt_is_resumed_by_jax(backbone,
                                                          tmp_dir):
    from s2r_tpu.core.mesh import make_mesh
    from s2r_tpu.train.trainer import Trainer as JaxTrainer

    jm, js = jax_output_adapt(backbone)
    js = _filled(js)
    path = os.path.join(tmp_dir, "jax.ckpt")
    jax_save(path, js, 4, 0.625)
    with torch_threads():
        st = _port_method(backbone).init_state()
        ref = _port_method(backbone).init_state()
    assert resume_into(st, path, ft=False) == (4, 0.625)
    t = _np(js)
    want = host_tree(train_state_from_jax(ref, t.params, t.batch_stats,
                                          t.opt_state, t.step))
    got = host_tree(st)
    for k in ("G", "D", "opt_state"):
        assert _tree_equal(got[k], want[k]), k
    assert got["step"] == 5

    # port -> JAX-format file -> the JAX Trainer -> back, unchanged
    for s in st.opt_state.values():
        for k, v in s.items():
            if torch.is_tensor(v):
                v.mul_(-1.5)
    st.step = 17
    path = os.path.join(tmp_dir, "port.ckpt")
    cfg = JaxConfig(backbone=backbone, dataset="synthetic", crop_size=33,
                    base_size=33, batch_size=2, ft=False)
    save_jax_checkpoint(path, st, 6, 0.375, seed=cfg.seed)
    assert _tree_equal(load_checkpoint(path, backbone)["state"],
                       host_tree(st))
    old = jax.config.jax_default_prng_impl
    try:
        jax.config.update("jax_default_prng_impl", cfg.prng_impl)
        jt = object.__new__(JaxTrainer)
        jt.cfg, jt.mesh, jt.method = cfg, make_mesh(1), jm
        jt.state, jt.start_epoch, jt.best_pred = jax_output_adapt(backbone)[1], 0, 0.0
        jt._resume(path)
        restored = _np(jt.state)
        assert (jt.start_epoch, jt.best_pred) == (6, 0.375)
    finally:
        jax.config.update("jax_default_prng_impl", old)
    back = host_tree(train_state_from_jax(ref, restored.params,
                                          restored.batch_stats,
                                          restored.opt_state, restored.step))
    mine = host_tree(st)
    assert _tree_equal(back["opt_state"], mine["opt_state"])
    assert back["step"] == 17
    for net in ("G", "D"):  # JAX has no num_batches_tracked
        assert _tree_equal(
            {k: v for k, v in back[net].items()
             if not k.endswith("num_batches_tracked")},
            {k: v for k, v in mine[net].items()
             if not k.endswith("num_batches_tracked")})


@pytest.mark.parametrize("schema", ["single", "four"])
@pytest.mark.parametrize("backbone", CKPT)
def test_reference_pth_round_trips(backbone, schema, tmp_dir):
    params, stats = _variables(backbone)
    model = _port(backbone)
    path = os.path.join(tmp_dir, "port.pth.tar")
    domain = DomainClassifier(device="cpu") if schema == "four" else None
    save_reference_checkpoint(path, model, domain, epoch=3, best_pred=0.5,
                              schema=schema, backbone=backbone)
    with pytest.raises(ValueError, match="backbone"):
        save_reference_checkpoint(path, model, schema=schema,
                                  backbone="mobilenet")
    got = jax_import(path, 16, backbone=backbone)
    assert (got["epoch"], got["best_pred"], got["schema"]) == (3, 0.5, schema)
    for a, b in ((got["G"][0], params), (got["G"][1], stats)):
        la, ta = jax.tree_util.tree_flatten(a)
        lb, tb = jax.tree_util.tree_flatten(b)
        assert ta == tb and all(np.array_equal(x, y) for x, y in zip(la, lb))

    path = os.path.join(tmp_dir, "jax.pth.tar")
    jax_export(path, params, stats, epoch=7, best_pred=0.25, schema=schema,
               backbone=backbone)
    with torch_threads():
        st = _port_method(backbone).init_state()
    assert resume_into(st, path, ft=False) == (7, 0.25)
    want = from_jax_variables(params, stats, backbone)
    got = st.G.state_dict()
    assert sorted(got) == sorted(want)
    assert all(torch.equal(got[k], want[k]) for k in want)


@pytest.mark.parametrize("backbone", ("resnet101",) + CKPT)
def test_backbone_init_matches_jax(backbone, tmp_dir):
    from s2r_tpu.core.mesh import make_mesh
    from s2r_tpu.train.trainer import Trainer as JaxTrainer

    params, stats = _variables(backbone)
    sd = export_any_backbone(backbone, params["backbone"], stats["backbone"])
    if backbone.startswith("resnet"):  # a torchvision file's classifier
        sd["fc.weight"], sd["fc.bias"] = torch.ones(1000, 2048), \
            torch.zeros(1000)
    path = os.path.join(tmp_dir, "backbone.pth")
    torch.save({"state_dict": sd}, path)

    jt = object.__new__(JaxTrainer)
    jt.method, jt.state = jax_output_adapt(backbone)
    jt.cfg = JaxConfig(backbone=backbone, dataset="synthetic", crop_size=33,
                       base_size=33, batch_size=2)
    jt.mesh = make_mesh(1)
    jt._init_backbone(path)
    want = from_jax_variables(_np(jt.state.params["G"]),
                              _np(jt.state.batch_stats), backbone)

    model = DeepLab(device="cpu", backbone=backbone)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    init_backbone(model, path)
    for k, v in model.state_dict().items():
        if k.startswith("backbone.") and "num_batches_tracked" not in k:
            assert torch.equal(v, want[k]), k
        else:  # ASPP, decoder and the counters keep their init
            assert torch.equal(v, before[k]), k


def test_servable_records_and_rebuilds_backbone(tmp_dir):
    """A servable of an Xception model names its backbone in the meta,
    and load_servable (what cli.infer calls) rebuilds that model: its
    labels equal the exporting model's."""
    from s2r_tpu_torch.io.serving import (export_servable, load_servable,
                                          make_serving_fn)

    model = _port("xception")
    path = os.path.join(tmp_dir, "xception.s2rt")
    info = export_servable(model, (1, 33, 33, 3), path, input="rgb8")
    served = load_servable(path, "cpu")
    assert info["backbone"] == served.meta["backbone"] == "xception"
    assert served.model.backbone_name == "xception"
    image = np.random.RandomState(4).randint(0, 256, (1, 33, 33, 3),
                                             dtype=np.uint8)
    with torch_threads():
        want = make_serving_fn(model, input="rgb8")(torch.from_numpy(image))
        got = served(torch.from_numpy(image))
    assert torch.equal(got, want)

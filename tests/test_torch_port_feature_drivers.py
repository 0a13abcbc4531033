"""The feature method's modules and drivers against the JAX package's, on
the CPU.

- ``DomainClassifier``: eval and train-mode forwards (dropout off, the
  BatchNorm running statistics after it) against s2r_tpu's on the same
  weights, float32, within 1e-5 of the output's largest value (measured
  1.5e-6 eval, 2.4e-6 train); ``from_jax_domain`` writes the keys and values of
  s2r_tpu/io/torch_export.py ``export_domain``.
- ``train_state_from_jax`` maps each leaf of the four optimizer states
  ('task', 'd', 'd_inv', 'c'), SGD and Adam, to its port parameter.
- ``make_optimizer`` and the method inferred from the dataset match the
  JAX package's; class weights (``--use_balanced_weights``) reach the
  feature step's task loss.
- The export: ``nearest_index`` equals PIL's NEAREST resize (this
  environment has PIL; the port never imports it) from 64x64, 513x513,
  512x1024, 1024x2048 and 1052x1914 to 1280x640, exactly, and
  ``_save_prediction``'s PNGs decode to the pixels and names the JAX
  package's do.
- The drivers at 64x64 batch 2 float32 on the CPU (``S2R_PLATFORM=cpu``):
  ``cli.train`` (feature_adapt on --dataset synthetic --device-aug), then
  ``cli.val`` with the per-image export and with --skip-sep (its mIoU the
  Trainer's, and
  within 1e-4 of the JAX package's ``cli.val`` on the same weights, handed
  over as a reference checkpoint), then ``cli.test``.  Two epochs
  straight are bit-equal to one, a resume with ft off, and one more.
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from PIL import Image

from s2r_tpu_torch import config as PC

from _torch_port_common import (jax_deeplab, perturb_affine, perturb_stats,
                                torch_threads)

FEAT_HW, FEAT_N = (5, 7), 2


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _jax_domain(hw=FEAT_HW):
    from s2r_tpu.models import DomainClassifier as JaxDC

    model = JaxDC()
    v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(3)},
                                   jnp.zeros((1,) + hw + (256,)), False))()
    params = perturb_affine(_np(v["params"]), seed=4)
    return model, params, perturb_stats(_np(v["batch_stats"]), seed=5)


def _port_domain(params, stats):
    from s2r_tpu_torch.io.convert import from_jax_domain
    from s2r_tpu_torch.models.domain import DomainClassifier

    model = DomainClassifier(device="cpu")
    model.load_state_dict(from_jax_domain(params, stats), strict=True)
    return model


@pytest.mark.parametrize("train", [False, True])
def test_domain_classifier_matches_jax(train, monkeypatch):
    from s2r_tpu.models import layers as L
    from s2r_tpu_torch.models.layers import set_dropout

    monkeypatch.setattr(L.Dropout, "__call__",
                        lambda self, x, deterministic: x)
    model, params, stats = _jax_domain()
    x = np.random.RandomState(0).randn(FEAT_N, *FEAT_HW, 256).astype(
        np.float32)
    variables = {"params": params, "batch_stats": stats}
    if train:
        want, upd = model.apply(variables, x, True, mutable=["batch_stats"])
    else:
        want = model.apply(variables, x, False)
    want = np.asarray(want)
    port = _port_domain(params, stats).train(train)
    set_dropout(port, False)
    with torch.no_grad():
        got = port(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(
            0, 2, 3, 1).numpy()
    assert got.shape == want.shape == (FEAT_N,) + FEAT_HW + (2,)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 * np.abs(want).max())
    if train:
        from s2r_tpu_torch.io.convert import from_jax_domain

        after = from_jax_domain(params, _np(upd["batch_stats"]))
        sd = port.state_dict()
        for k in after:
            if k.endswith(("running_mean", "running_var")):
                np.testing.assert_allclose(
                    sd[k].numpy(), after[k].numpy(), rtol=0,
                    atol=1e-5 * float(after[k].abs().max()), err_msg=k)


def test_domain_key_schema_matches_export():
    from s2r_tpu.io.torch_export import export_domain
    from s2r_tpu_torch.io.convert import domain_param_order, from_jax_domain

    _, params, stats = _jax_domain()
    want = export_domain(params, stats)
    got = from_jax_domain(params, stats)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    port = _port_domain(params, stats)
    assert sorted(port.state_dict()) == sorted(want)
    assert sorted(domain_param_order()) == sorted(
        k for k, _ in port.named_parameters())
    with pytest.raises(NotImplementedError):
        from s2r_tpu_torch.models.domain import DomainClassifier
        DomainClassifier(level="low", device="cpu")


@pytest.mark.parametrize("optimizer", ["SGD", "Adam"])
def test_train_state_from_jax_maps_four_buffers(optimizer):
    """Each buffer holds the parameters it runs over (times a constant per
    buffer), so every leaf of the port's buffer must equal the port's
    parameter it belongs to."""
    from jax.flatten_util import ravel_pytree

    from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                          domain_param_order,
                                          feature_param_order,
                                          train_state_from_jax)
    from s2r_tpu_torch.train.setup import build_method

    _, params_g, stats_g = jax_deeplab(33)
    params_g = perturb_affine(params_g)
    _, params_d, stats_d = _jax_domain((3, 3))
    params = {"G": params_g, "D": params_d}
    flat = {"G": np.asarray(ravel_pytree(params_g)[0]),
            "D": np.asarray(ravel_pytree(params_d)[0]),
            "f": np.asarray(ravel_pytree({k: params_g[k] for k in
                                          ("backbone", "aspp")})[0])}
    nets = {"task": ("G", 1), "d": ("D", 2), "d_inv": ("f", 3),
            "c": ("G", 4)}
    if optimizer == "SGD":
        opt = {n: {"momentum": c * flat[net]} for n, (net, c) in nets.items()}
    else:
        opt = {n: {"m": c * flat[net], "v": -c * flat[net],
                   "count": np.int32(c)} for n, (net, c) in nets.items()}
    with torch_threads():
        m = build_method(PC.Config(precision="f32", optimizer=optimizer), 4,
                         method="feature_adapt", device="cpu")
        state = train_state_from_jax(m.init_state(), params,
                                     {"G": stats_g, "D": stats_d}, opt,
                                     np.int32(9))
    g = dict(state.G.named_parameters())
    d = dict(state.D.named_parameters())
    want = {"G": torch.cat([g[k].detach().reshape(-1)
                            for k in deeplab_param_order()]),
            "D": torch.cat([d[k].detach().reshape(-1)
                            for k in domain_param_order()]),
            "f": torch.cat([g[k].detach().reshape(-1)
                            for k in feature_param_order()])}
    assert sorted(state.opt_state) == sorted(nets) and state.step == 9
    for name, (net, c) in nets.items():
        s = state.opt_state[name]
        if optimizer == "SGD":
            assert torch.equal(s["momentum"], c * want[net]), name
        else:
            assert torch.equal(s["m"], c * want[net]), name
            assert torch.equal(s["v"], -c * want[net]), name
            assert s["count"] == c
    # the domain classifier's statistics came across too
    np.testing.assert_array_equal(
        state.D.DC_adnn2[1].running_var.numpy(),
        stats_d["adnn2_bn"]["var"])


@pytest.mark.parametrize("name", ["SGD", "Adam"])
def test_make_optimizer_matches_jax(name):
    from s2r_tpu.train.optim import make_optimizer as jax_make
    from s2r_tpu_torch.train.optim import make_optimizer

    got = dataclasses.asdict(make_optimizer(name, 0.7, 1e-3, True))
    want = dataclasses.asdict(jax_make(name, 0.7, 1e-3, True))
    assert got == want
    with pytest.raises(NotImplementedError):
        make_optimizer("RMSprop", 0.9, 0.0, False)


@pytest.mark.parametrize("dataset,method", [("gtav", "source_only"),
                                            ("gtav2cityscapes",
                                             "feature_adapt"),
                                            ("synthetic", "feature_adapt")])
def test_method_inferred_from_dataset(dataset, method):
    from s2r_tpu_torch.models.domain import DomainClassifier
    from s2r_tpu_torch.train.setup import build_method

    with torch_threads():
        m = build_method(PC.Config(dataset=dataset, precision="f32"), 2,
                         device="cpu")
    assert m.name == method and isinstance(m.aux_model, DomainClassifier)
    assert sorted(m.init_state().opt_state) == ["c", "d", "d_inv", "task"]


# from-sizes of the NEAREST export: the crops of the configurations, the
# Cityscapes frame and the GTA5 frame
EXPORT_FROM = [(64, 64), (513, 513), (512, 1024), (1024, 2048), (1052, 1914)]


@pytest.mark.parametrize("hw", EXPORT_FROM)
def test_nearest_index_equals_pil(hw):
    from s2r_tpu_torch.cli._eval_common import EXPORT_SIZE
    from s2r_tpu_torch.data.imaging import nearest_index, resize_nearest

    h, w = hw
    rows = np.asarray(Image.fromarray(
        np.repeat(np.arange(h, dtype=np.int32)[:, None], w, 1), mode="I")
        .resize(EXPORT_SIZE, Image.NEAREST))
    cols = np.asarray(Image.fromarray(
        np.repeat(np.arange(w, dtype=np.int32)[None], h, 0), mode="I")
        .resize(EXPORT_SIZE, Image.NEAREST))
    assert np.array_equal(rows, np.repeat(
        nearest_index(h, EXPORT_SIZE[1])[:, None], EXPORT_SIZE[0], 1))
    assert np.array_equal(cols, np.repeat(
        nearest_index(w, EXPORT_SIZE[0])[None], EXPORT_SIZE[1], 0))
    rs = np.random.RandomState(h + w)
    for shape in ((h, w), (h, w, 3)):
        img = rs.randint(0, 256, shape).astype(np.uint8)
        want = np.asarray(Image.fromarray(img).resize(EXPORT_SIZE,
                                                      Image.NEAREST))
        assert np.array_equal(resize_nearest(img, EXPORT_SIZE), want), shape


@pytest.mark.parametrize("miou", [None, 0.123456])
def test_save_prediction_matches_jax(tmp_path, miou):
    from s2r_tpu.cli import _eval_common as jax_common
    from s2r_tpu_torch.cli import _eval_common as port_common

    rs = np.random.RandomState(1)
    pred = rs.randint(0, 19, (65, 129)).astype(np.int64)
    pred[:3] = 255
    for mod, sub in ((jax_common, "jax"), (port_common, "port")):
        mod._save_prediction(pred, "dir/frame_000001.png",
                             str(tmp_path / sub), "synthetic", miou)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names
    assert len(names) == 2
    if miou is not None:
        assert any("_color_0.1235_" in n for n in names)
    for n in names:
        a = Image.open(tmp_path / "jax" / n)
        b = Image.open(tmp_path / "port" / n)
        assert a.mode == b.mode and a.size == b.size == (1280, 640), n
        assert np.array_equal(np.asarray(a), np.asarray(b)), n


ARGV = ["--dataset", "synthetic", "--device-aug", "--batch-size", "2",
        "--crop-size", "64", "--base-size", "64", "--precision", "f32",
        "--workers", "2"]


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """cli.train's main, one epoch, on the CPU through S2R_PLATFORM."""
    from s2r_tpu_torch.cli import train

    root = tmp_path_factory.mktemp("feature_fit")
    mp = pytest.MonkeyPatch()
    mp.setenv("S2R_PLATFORM", "cpu")
    try:
        with torch_threads():
            trainer = train.main(ARGV + ["--epochs", "1", "--run-root",
                                         str(root)])
    finally:
        mp.undo()
    return trainer


def _scalars(trainer):
    import json

    path = os.path.join(trainer.saver.experiment_dir, "scalars.jsonl")
    return {r["tag"]: r["value"] for r in map(json.loads, open(path))}


def test_cli_train_runs_feature_adapt(trained):
    from s2r_tpu_torch.models.domain import DomainClassifier

    assert trained.method.name == "feature_adapt"
    assert isinstance(trained.state.D, DomainClassifier)
    assert trained.state.step == len(trained.train_loader) == 8
    tags = _scalars(trained)
    for k in ("train/task_loss", "train/d_loss", "train/d_inv_loss",
              "train/d_acc", "val/total_loss_epoch"):
        assert np.isfinite(tags[k]), k
    assert 0.0 < tags["val/mIoU"] == trained.best_pred <= 1.0
    assert os.path.isfile(os.path.join(trained.saver.directory,
                                       "model_best.ckpt"))


def _reference_checkpoint(trainer, path):
    """The trainer's G and D in the reference's four-state schema
    (train.py:242-253), which the JAX package imports."""
    g = trainer.state.G.state_dict()

    def part(prefix):
        return {k[len(prefix):]: v for k, v in g.items()
                if k.startswith(prefix)}

    torch.save({"backbone_model_state_dict": part("backbone."),
                "assp_model_state_dict": part("aspp."),
                "y_model_state_dict": part("decoder."),
                "d_model_state_dict": trainer.state.D.state_dict(),
                "epoch": 1, "best_pred": trainer.best_pred}, path)


def test_cli_val_exports_and_matches_jax(trained, tmp_path, monkeypatch):
    from s2r_tpu.cli import val as jax_val
    from s2r_tpu_torch.cli import val

    best = os.path.join(trained.saver.directory, "model_best.ckpt")
    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    with torch_threads():
        miou, _ = val.main(ARGV + ["--resume", best, "--out-dir",
                                   str(tmp_path / "port")])
    assert miou == trained.best_pred
    with torch_threads():
        miou_skip, _ = val.main(ARGV + ["--resume", best, "--skip-sep",
                                        "--out-dir", str(tmp_path / "skip")])
    assert miou_skip == miou
    assert os.listdir(tmp_path / "skip") == ["val_info.txt"]
    pngs = sorted(os.listdir(tmp_path / "port" / "predictions"))
    n = 2 * len(trained.val_loader)
    assert len(pngs) == 2 * n
    labels = [p for p in pngs if p.endswith("_labelId.png")]
    colors = [p for p in pngs if "_color_" in p]
    assert len(labels) == len(colors) == n
    for p in (labels[0], colors[0]):
        im = Image.open(tmp_path / "port" / "predictions" / p)
        assert im.size == (1280, 640) and im.mode in ("L", "RGB")
    # the same weights through the JAX package's own val driver
    ref = str(tmp_path / "port.pth.tar")
    _reference_checkpoint(trained, ref)
    want, _ = jax_val.main(ARGV + ["--resume", ref, "--skip-sep",
                                   "--out-dir", str(tmp_path / "jax")])
    assert abs(miou - want) <= 1e-4, (miou, want)


def test_cli_test_writes_predictions(trained, tmp_path, monkeypatch):
    from s2r_tpu_torch.cli import test

    best = os.path.join(trained.saver.directory, "model_best.ckpt")
    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    with torch_threads():
        test.main(ARGV + ["--resume", best, "--out-dir", str(tmp_path)])
    pngs = sorted(os.listdir(tmp_path))
    n = 2 * len(trained.test_loader)
    assert len(pngs) == 2 * n and sum(p.endswith("_color.png")
                                      for p in pngs) == n


def test_balanced_weights_reach_feature_loss():
    """--use_balanced_weights hands class weights to the feature method's
    CE: the weighted task loss is the weighted mean of the pixel losses."""
    from s2r_tpu_torch.models.layers import set_dropout
    from s2r_tpu_torch.train.losses import cross_entropy
    from s2r_tpu_torch.train.setup import build_method

    rs = np.random.RandomState(3)
    batch = {"src_image": rs.randn(2, 32, 32, 3).astype(np.float32),
             "tgt_image": rs.randn(2, 32, 32, 3).astype(np.float32),
             "src_label": rs.randint(0, 19, (2, 32, 32))}
    weights = torch.from_numpy(rs.uniform(0.5, 2.0, 19).astype(np.float32))
    cfg = PC.Config(precision="f32")
    losses = []
    with torch_threads():
        for w in (None, weights):
            m = build_method(cfg, 2, class_weights=w, method="feature_adapt",
                             device="cpu")
            set_dropout(m.deeplab, False)
            set_dropout(m.aux_model, False)
            m.deeplab.train()
            with torch.no_grad():
                logits, _ = m.deeplab(torch.from_numpy(
                    batch["src_image"]).permute(0, 3, 1, 2))
            want = float(cross_entropy(logits, torch.from_numpy(
                batch["src_label"]), w))
            m.deeplab.load_state_dict(build_method(
                cfg, 2, method="feature_adapt",
                device="cpu").deeplab.state_dict())
            _, met = m.step_fn(m.init_state(), batch)
            losses.append((float(met["task_loss"]), want))
    for got, want in losses:
        assert abs(got - want) <= 1e-5 * abs(want), (got, want)
    assert abs(losses[0][0] - losses[1][0]) > 1e-3


def test_feature_resume_is_bit_identical(tmp_path):
    from s2r_tpu_torch.io.checkpoint import host_tree
    from s2r_tpu_torch.train.trainer import Trainer

    def cfg(root, **kw):
        kw = {"epochs": 2, **kw}
        return PC.Config(dataset="synthetic", device_aug=True, batch_size=2,
                         crop_size=32, base_size=32, precision="f32",
                         workers=2, no_val=True,
                         run_root=str(tmp_path / root), **kw)

    def equal(a, b):
        if torch.is_tensor(a):
            return torch.is_tensor(b) and a.dtype == b.dtype and \
                torch.equal(a, b)
        if isinstance(a, dict):
            return sorted(a) == sorted(b) and all(equal(a[k], b[k])
                                                  for k in a)
        return a == b

    with torch_threads():
        straight = Trainer(cfg("a"), device="cpu")
        straight.fit()
        first = Trainer(cfg("b"), device="cpu")
        first.training(0)
        first.saver.wait()
        ckpt = os.path.join(first.saver.experiment_dir, "checkpoint.ckpt")
        resumed = Trainer(cfg("b", resume=ckpt, ft=False), device="cpu")
        assert resumed.start_epoch == 1
        assert equal(host_tree(resumed.state), host_tree(first.state))
        resumed.fit()
        # an output_adapt checkpoint does not restore into this layout
        adapt = Trainer(cfg("c", epochs=1), method="output_adapt",
                        device="cpu")
        adapt.fit()
        other = os.path.join(adapt.saver.experiment_dir, "checkpoint.ckpt")
        with pytest.raises((ValueError, RuntimeError)):
            Trainer(cfg("d", resume=other, ft=False), device="cpu")
    assert resumed.method.name == "feature_adapt"
    assert resumed.state.step == straight.state.step == 16
    assert equal(host_tree(resumed.state), host_tree(straight.state))
    assert float(resumed.state.opt_state["c"]["momentum"].abs().max()) == 0

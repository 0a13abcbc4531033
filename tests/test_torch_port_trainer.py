"""The port's drivers against the JAX package's (s2r_tpu/config.py,
io/saver.py, train/trainer.py, cli/train_adapt.py, cli/val_adapt.py), on
the CPU.

- config_from_args equals JAX's field by field for a set of argv lists,
  and the two parsers register the same flags, dests, defaults and
  choices; each flag whose feature the port lacks raises, and the flags
  ported since (--num-devices under a world of 2, --logits-dtype,
  --split-concat, --data-backend native, --profile-dir) parse and build.
- Saver: the same files and model_best promotions as JAX's over one
  sequence of best_preds across three experiments.
- An asynchronous save holds the pre-step values even when a step runs
  before wait().
- train_state_from_jax maps each optimizer leaf to its OIHW counterpart.
- train_adapt end to end at crop 32, batch 2, f32, S2R_PLATFORM=cpu; then
  val_adapt on model_best.ckpt reproduces the Trainer's mIoU, with and
  without the per-image PNG export.
- 2 epochs straight are bit-equal to 1 epoch + resume (ft=False) + 1 epoch.
- --resume of a JAX checkpoint or a reference .pth loads; --data-backend
  native with --dataset synthetic loads the default batches (the JAX
  package ignores it there); --dataset synthetic trains without
  --device-aug.
"""

import argparse
import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import jax

from s2r_tpu import config as JC
from s2r_tpu_torch import config as PC

from _torch_port_common import jax_deeplab, perturb_affine, torch_threads

ARGVS = [
    [],
    ["--dataset", "synthetic", "--device-aug", "--epochs", "3",
     "--batch-size", "8", "--crop-size", "512", "--base-size", "512",
     "--precision", "f32", "--workers", "4"],
    ["--lr", "0.01", "--lr-scheduler", "cos", "--warmup-epochs", "2",
     "--momentum", "0.5", "--weight-decay", "0.001", "--nesterov",
     "--use_balanced_weights", "--loss-type", "focal", "--seed", "7",
     "--freeze-bn", "true", "--sync-bn", "false", "--no_d_loss", "yes"],
    ["--resume", "auto", "--checkname", "x", "--ft", "--eval-interval", "2",
     "--no-val", "--no-async-save", "--run-root", "/tmp/r",
     "--adv-softmax-axis", "class", "--no-val-drop-last", "--batch-pad",
     "off", "--prng-impl", "threefry2x32", "--num-devices", "1",
     "--data-cache", "--data-cache-gb", "2.5", "--test-batch-size", "3",
     "--optimizer", "Adam", "--start_epoch", "4", "--lr-step", "5",
     "--out-stride", "8", "--src_img_root", "a", "--val_label_root", "b"],
]

UNPORTED = [(["--num-devices", "2"], "--num-devices"),
            (["--spatial-shard", "2"], "--spatial-shard"),
            (["--eval-spatial-shard"], "--eval-spatial-shard"),
            (["--data-backend", "native"], "--data-backend"),
            (["--remat"], "--remat"),
            (["--fast-pad-stats"], "--fast-pad-stats"),
            (["--logits-dtype", "bf16"], "--logits-dtype"),
            (["--split-concat"], "--split-concat"),
            (["--profile-dir", "p"], "--profile-dir")]


def _parse(mod, argv):
    p = argparse.ArgumentParser()
    mod.add_common_flags(p)
    return p, p.parse_args(argv)


@pytest.mark.parametrize("argv", ARGVS)
def test_config_from_args_equals_jax(argv):
    want = JC.config_from_args(_parse(JC, argv)[1])
    got = PC.config_from_args(_parse(PC, argv)[1])
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.to_json() == want.to_json()
    assert PC.Config.from_json(got.to_json()) == got


def test_parsers_register_the_same_flags():
    def flags(mod):
        return {tuple(a.option_strings): (a.dest, a.default, a.choices,
                                          type(a).__name__)
                for a in _parse(mod, [])[0]._actions}
    assert flags(PC) == flags(JC)
    assert ([f.name for f in dataclasses.fields(PC.Config)]
            == [f.name for f in dataclasses.fields(JC.Config)])
    assert dataclasses.asdict(PC.Config()) == dataclasses.asdict(JC.Config())


# flags of UNPORTED whose features are ported now: they parse and build
PORTED = {"--num-devices", "--logits-dtype", "--split-concat",
          "--data-backend", "--profile-dir"}


def _world_of(monkeypatch, world: int, rank: int = 0):
    """Pretend this process is `rank` of a process group of `world` (no
    collective runs while a method is built)."""
    from s2r_tpu_torch.core import mesh
    monkeypatch.setattr(mesh, "process_info", lambda: (rank, world))


@pytest.mark.parametrize("argv,flag", UNPORTED)
def test_unported_flag_raises(argv, flag, monkeypatch):
    if flag not in PORTED:
        with pytest.raises(NotImplementedError, match=flag):
            PC.config_from_args(_parse(PC, argv)[1])
        return
    from s2r_tpu_torch.core.mesh import pick_num_devices
    from s2r_tpu_torch.train.setup import build_method

    if flag == "--num-devices":
        _world_of(monkeypatch, 2)
    cfg = PC.config_from_args(_parse(PC, argv)[1])
    n = pick_num_devices(cfg.batch_size, cfg.num_devices)
    m = build_method(cfg, 1, method="output_adapt", device="cpu",
                     n_devices=n)
    assert m.mesh.size == n == (2 if flag == "--num-devices" else 1)
    assert m.deeplab.split_concat == (flag == "--split-concat")
    assert m.deeplab.logits_dtype == (torch.bfloat16
                                      if flag == "--logits-dtype" else None)


@pytest.mark.parametrize("backbone", ["mobilenet", "resnet", "resnet101",
                                      "resnet50", "xception", "drn"])
def test_backbone_flag_is_ported(backbone):
    """--backbone takes every name of the factory (it raised before the
    other backbones were ported) and reaches the Config as the JAX
    package's parser puts it there."""
    argv = ["--backbone", backbone]
    cfg = PC.config_from_args(_parse(PC, argv)[1])
    assert cfg.backbone == backbone
    assert cfg.to_json() == JC.config_from_args(_parse(JC, argv)[1]).to_json()
    PC.check_ported(cfg, "output_adapt")


def test_unported_methods_raise(monkeypatch):
    """All three methods are ported; a name outside them raises.  The
    feature methods build and take a step on a ResNet backbone (they
    raised before it was ported).  Two devices build under a process
    group of two, with every BatchNorm synchronized over it, and raise
    in a process of one."""
    from s2r_tpu_torch.train.setup import build_method

    with pytest.raises(ValueError, match="unknown method"):
        build_method(PC.Config(), 1, method="output", device="cpu")
    rs = np.random.RandomState(0)
    image = torch.from_numpy(rs.randn(2, 33, 33, 3).astype(np.float32))
    label = torch.from_numpy(rs.randint(0, 19, (2, 33, 33)))
    for method in ("feature_adapt", "source_only"):
        with torch_threads():
            m = build_method(PC.Config(backbone="resnet50", precision="f32"),
                             1, method=method, device="cpu")
            batch = ({"image": image, "label": label}
                     if method == "source_only" else
                     {"src_image": image, "src_label": label,
                      "tgt_image": image.flip(1)})
            _, met = m.step_fn(m.init_state(), batch)
        assert m.deeplab.backbone_name == "resnet50"
        assert np.isfinite(float(met["task_loss"]))
    with pytest.raises(ValueError, match="one of 1"):
        build_method(PC.Config(), 1, device="cpu", n_devices=2)
    _world_of(monkeypatch, 2, rank=1)
    m = build_method(PC.Config(), 1, device="cpu", n_devices=2)
    assert (m.mesh.size, m.mesh.rank) == (2, 1)
    from s2r_tpu_torch.models.layers import BatchNorm
    bns = [b for net in (m.deeplab, m.aux_model) for b in net.modules()
           if isinstance(b, BatchNorm)]
    assert len(bns) == 62 and all(b.sync is m.mesh for b in bns)


def _promotions(saver_cls, cfg, save, load, tmp_path):
    """Run three experiments' best_pred sequences; return, after each save,
    the files under the run root and model_best's (epoch, best_pred)."""
    seen = []
    for run, preds in enumerate(([0.3, 0.5], [0.4], [0.45, 0.6])):
        saver = saver_cls(cfg)
        saver.save_experiment_config()
        for k, pred in enumerate(preds):
            save(saver, 10 * run + k, pred)
            saver.wait()
            files = sorted(os.path.relpath(os.path.join(d, f), tmp_path)
                           for d, _, fs in os.walk(tmp_path) for f in fs)
            best = os.path.join(saver.directory, "model_best.ckpt")
            with open(os.path.join(saver.experiment_dir,
                                   "best_pred.txt")) as f:
                text = f.read()
            seen.append((files, load(best), text))
    return seen


def test_saver_matches_jax(tmp_path):
    from s2r_tpu.io.checkpoint import load_checkpoint as jax_load
    from s2r_tpu.io.saver import Saver as JaxSaver
    from s2r_tpu_torch.io.checkpoint import load_checkpoint
    from s2r_tpu_torch.io.saver import Saver
    from s2r_tpu_torch.train.state import TrainState

    kw = dict(dataset="synthetic", checkname="c")
    j_root, p_root = tmp_path / "j", tmp_path / "p"

    def j_save(saver, epoch, pred):
        saver.save_checkpoint({"w": np.ones(2, np.float32)}, epoch, pred,
                              is_best=True)

    def p_save(saver, epoch, pred):
        state = TrainState(step=epoch, G=torch.nn.Linear(2, 2),
                           D=torch.nn.Linear(2, 1), opt_state={},
                           generator=torch.Generator())
        saver.save_checkpoint(state, epoch, pred, is_best=True)

    def j_load(path):
        d = jax_load(path)
        return int(d["epoch"]), float(d["best_pred"])

    def p_load(path):
        d = load_checkpoint(path)
        return d["epoch"], d["best_pred"]

    want = _promotions(JaxSaver, JC.Config(run_root=str(j_root), **kw),
                       j_save, j_load, j_root)
    got = _promotions(Saver, PC.Config(run_root=str(p_root), **kw), p_save,
                      p_load, p_root)
    assert got == want
    # the third experiment promoted 0.6, the second kept 0.5
    assert [b for _, b, _ in got] == [(0, 0.3), (1, 0.5), (1, 0.5),
                                      (1, 0.5), (21, 0.6)]
    for name in ("parameters.txt", "config.json"):
        rel = os.path.join("synthetic", "c", "experiment_0", name)
        if name == "config.json":
            j, p = (json.loads((r / rel).read_text()) for r in (j_root,
                                                                 p_root))
            j["run_root"] = p["run_root"] = None
            assert p == j
        else:
            assert (p_root / rel).read_bytes() == (j_root / rel).read_bytes()


def _tiny_method():
    from s2r_tpu_torch.train.setup import build_method

    return build_method(PC.Config(precision="f32"), 4,
                        method="output_adapt", device="cpu")


def _batch(seed, hw=32, n=2):
    rs = np.random.RandomState(seed)
    return {"src_image": rs.randn(n, hw, hw, 3).astype(np.float32),
            "tgt_image": rs.randn(n, hw, hw, 3).astype(np.float32),
            "src_label": rs.randint(0, 19, (n, hw, hw)).astype(np.int64)}


def _flat(state):
    from s2r_tpu_torch.io.checkpoint import host_tree

    return host_tree(state)


def _tree_equal(a, b):
    if torch.is_tensor(a):
        return torch.is_tensor(b) and a.dtype == b.dtype and torch.equal(a, b)
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_tree_equal(a[k], b[k]) for k in a))
    return a == b


def test_async_save_holds_pre_step_values(tmp_path):
    from s2r_tpu_torch.io.checkpoint import load_checkpoint, save_checkpoint
    from s2r_tpu_torch.io.saver import Saver

    with torch_threads():
        m = _tiny_method()
        state = m.init_state()
        state, _ = m.step_fn(state, _batch(0))
        before = _flat(state)
        saver = Saver(PC.Config(run_root=str(tmp_path), dataset="synthetic"))
        gate = threading.Event()
        saver._writer.submit(gate.wait)  # hold the writer thread
        path = saver.save_checkpoint(state, 1, 0.5, is_best=False)
        state, _ = m.step_fn(state, _batch(1))  # updates in place
        gate.set()
        saver.wait()
        after = _flat(state)
    saved = load_checkpoint(path)["state"]
    assert _tree_equal(saved, before)
    assert not _tree_equal(saved["G"], after["G"])
    assert saved["step"] == 1 and after["step"] == 2
    # a synchronous save writes the state as it is now
    sync = str(tmp_path / "sync.ckpt")
    save_checkpoint(sync, state, 2, 0.25, extra={"note": "x"})
    payload = load_checkpoint(sync)
    assert _tree_equal(payload["state"], after)
    assert (payload["epoch"], payload["best_pred"], payload["extra"]) == (
        2, 0.25, {"note": "x"})


def test_train_state_from_jax_maps_optimizer_leaves():
    from jax.flatten_util import ravel_pytree

    from s2r_tpu.models import FCDiscriminator as JaxD
    from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                          discriminator_param_order,
                                          train_state_from_jax)

    _, params_g, stats = jax_deeplab(33)
    params_g = perturb_affine(params_g)
    vd = jax.jit(lambda: JaxD(num_classes=19).init(
        jax.random.PRNGKey(1), jax.numpy.zeros((1, 32, 32, 19))))()
    params = {"G": params_g,
              "D": jax.tree_util.tree_map(np.asarray, vd["params"])}
    flat_g, flat_d = (np.asarray(ravel_pytree(params[k])[0])
                      for k in ("G", "D"))
    # each buffer holds the parameters themselves, so every leaf of the
    # port's buffer must equal the port's parameter it belongs to
    opt = {"G": {"momentum": flat_g},
           "D": {"m": flat_d, "v": 2 * flat_d, "count": np.int32(5)}}
    with torch_threads():
        m = _tiny_method()
        state = train_state_from_jax(m.init_state(), params, stats, opt,
                                     np.int32(17))
        g = dict(state.G.named_parameters())
        d = dict(state.D.named_parameters())
        want_g = torch.cat([g[k].detach().reshape(-1)
                            for k in deeplab_param_order()])
        want_d = torch.cat([d[k].detach().reshape(-1)
                            for k in discriminator_param_order()])
    assert torch.equal(state.opt_state["G"]["momentum"], want_g)
    assert torch.equal(state.opt_state["D"]["m"], want_d)
    assert torch.equal(state.opt_state["D"]["v"], 2 * want_d)
    assert state.opt_state["D"]["count"] == 5 and state.step == 17
    # a conv kernel really was transposed, not copied flat
    k = "backbone.features.0.0.weight"
    assert g[k].shape == (32, 3, 3, 3)
    np.testing.assert_array_equal(
        g[k].detach().numpy(),
        np.transpose(params_g["backbone"]["features_0_conv"]["kernel"],
                     (3, 2, 0, 1)))


ARGV = ["--dataset", "synthetic", "--device-aug", "--batch-size", "2",
        "--crop-size", "32", "--base-size", "32", "--precision", "f32",
        "--workers", "2"]


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    """train_adapt's main, one epoch, on the CPU through S2R_PLATFORM."""
    from s2r_tpu_torch.cli import train_adapt

    root = tmp_path_factory.mktemp("fit")
    mp = pytest.MonkeyPatch()
    mp.setenv("S2R_PLATFORM", "cpu")
    try:
        with torch_threads():
            trainer = train_adapt.main(ARGV + ["--epochs", "1", "--run-root",
                                               str(root)])
    finally:
        mp.undo()
    return trainer, root


def test_train_adapt_end_to_end(fitted):
    trainer, root = fitted
    exp = trainer.saver.experiment_dir
    assert exp == os.path.join(str(root), "synthetic", "deeplab-mobilenet",
                               "experiment_0")
    for name in ("checkpoint.ckpt", "best_pred.txt", "parameters.txt",
                 "config.json", "scalars.jsonl"):
        assert os.path.isfile(os.path.join(exp, name)), name
    assert os.path.isfile(os.path.join(trainer.saver.directory,
                                       "model_best.ckpt"))
    rows = [json.loads(line) for line in
            open(os.path.join(exp, "scalars.jsonl"))]
    tags = {r["tag"]: r["value"] for r in rows}
    for k in ("train/seg_loss", "train/adv_loss", "train/d_loss",
              "val/total_loss_epoch"):
        assert np.isfinite(tags[k]), k
    assert 0.0 < tags["val/mIoU"] <= 1.0
    assert tags["val/mIoU"] == trainer.best_pred
    assert float(open(os.path.join(exp, "best_pred.txt")).read()) == \
        trainer.best_pred
    assert os.path.isfile(os.path.join(exp, "images",
                                       "Image_00000000.png"))
    assert trainer.state.step == len(trainer.train_loader) == 8


def test_val_adapt_reproduces_mIoU(fitted, tmp_path, monkeypatch):
    from s2r_tpu_torch.cli import val_adapt

    trainer, _ = fitted
    best = os.path.join(trainer.saver.directory, "model_best.ckpt")
    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    with torch_threads():
        miou, iou = val_adapt.main(ARGV + ["--resume", best, "--skip-sep",
                                           "--out-dir", str(tmp_path)])
    assert miou == trainer.best_pred
    assert (tmp_path / "val_info.txt").read_text().startswith("Validation:")
    # without --skip-sep it also writes each image's two PNGs
    with torch_threads():
        miou_sep, _ = val_adapt.main(ARGV + ["--resume", best, "--out-dir",
                                             str(tmp_path / "sep")])
    assert miou_sep == trainer.best_pred
    pngs = sorted(os.listdir(tmp_path / "sep" / "predictions"))
    n = len(trainer.val_loader) * 2
    assert len(pngs) == 2 * n
    assert sum(p.endswith("_labelId.png") for p in pngs) == n


def test_test_adapt_writes_predictions(fitted, tmp_path, monkeypatch):
    """test_adapt on the output_adapt checkpoint: one labelId and one color
    PNG a test image."""
    from s2r_tpu_torch.cli import test_adapt

    trainer, _ = fitted
    best = os.path.join(trainer.saver.directory, "model_best.ckpt")
    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    with torch_threads():
        test_adapt.main(ARGV + ["--resume", best, "--out-dir",
                                str(tmp_path)])
    pngs = sorted(os.listdir(tmp_path))
    n = 2 * len(trainer.test_loader)
    assert len(pngs) == 2 * n
    assert sum(p.endswith("_labelId.png") for p in pngs) == n


def test_no_card_raises_without_cpu_platform(monkeypatch):
    from s2r_tpu_torch.cli import train_adapt

    monkeypatch.delenv("S2R_PLATFORM", raising=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="S2R_PLATFORM=cpu"):
        train_adapt.main(ARGV + ["--epochs", "1"])


def test_resume_is_bit_identical(tmp_path):
    from s2r_tpu_torch.train.trainer import Trainer

    def cfg(root, **kw):
        return PC.Config(dataset="synthetic", device_aug=True, batch_size=2,
                         crop_size=32, base_size=32, precision="f32",
                         workers=2, epochs=2, no_val=True,
                         run_root=str(tmp_path / root), **kw)

    with torch_threads():
        straight = Trainer(cfg("a"), method="output_adapt", device="cpu")
        straight.fit()
        first = Trainer(cfg("b"), method="output_adapt", device="cpu")
        first.training(0)
        first.saver.wait()
        ckpt = os.path.join(first.saver.experiment_dir, "checkpoint.ckpt")
        resumed = Trainer(cfg("b", resume=ckpt, ft=False),
                          method="output_adapt", device="cpu")
        assert resumed.start_epoch == 1
        assert _tree_equal(_flat(resumed.state), _flat(first.state))
        resumed.fit()
    assert resumed.state.step == straight.state.step == 16
    assert _tree_equal(_flat(resumed.state), _flat(straight.state))


def test_resume_with_ft_loads_weights_only(tmp_path, fitted):
    from s2r_tpu_torch.train.trainer import Trainer

    trainer, _ = fitted
    ckpt = os.path.join(trainer.saver.experiment_dir, "checkpoint.ckpt")
    with torch_threads():
        t = Trainer(PC.Config(dataset="synthetic", device_aug=True,
                              batch_size=2, crop_size=32, base_size=32,
                              precision="f32", workers=2,
                              run_root=str(tmp_path), resume=ckpt),
                    method="output_adapt", device="cpu")
    got, want = _flat(t.state), _flat(trainer.state)
    assert _tree_equal(got["G"], want["G"]) and _tree_equal(got["D"],
                                                            want["D"])
    assert got["step"] == 0 and t.start_epoch == 0
    assert float(got["opt_state"]["G"]["momentum"].abs().max()) == 0.0
    assert t.best_pred == trainer.best_pred


@pytest.mark.parametrize("kind", ["jax", "pth"])
def test_resume_of_foreign_checkpoint_loads(tmp_path, kind):
    """A JAX msgpack checkpoint and a reference .pth resume into the
    Trainer with ft off: the weights, epoch and best_pred of the file
    (tests/test_torch_port_checkpoint_io.py and test_torch_port_interop.py
    hold the optimizer state and both layouts); a file of neither format
    raises."""
    from s2r_tpu.config import Config as JaxConfig
    from s2r_tpu.io.checkpoint import save_checkpoint as jax_save
    from s2r_tpu.io.torch_export import save_reference_checkpoint
    from s2r_tpu.train.setup import build_method as jax_build
    from s2r_tpu_torch.io.convert import from_jax_variables
    from s2r_tpu_torch.train.trainer import Trainer

    jm = jax_build(JaxConfig(dataset="synthetic", crop_size=32,
                             base_size=32, batch_size=2), 1,
                   method="output_adapt")
    js = jm.init_state(jax.random.PRNGKey(3))
    params = jax.tree_util.tree_map(np.asarray, js.params)
    stats = jax.tree_util.tree_map(np.asarray, js.batch_stats)
    if kind == "jax":
        path = str(tmp_path / "jax.ckpt")
        jax_save(path, js, 3, 0.5)
    else:
        path = str(tmp_path / "ref.pth")
        save_reference_checkpoint(path, params["G"], stats, epoch=3,
                                  best_pred=0.5)
    cfg = PC.Config(dataset="synthetic", device_aug=True, batch_size=2,
                    crop_size=32, base_size=32, workers=1, precision="f32",
                    run_root=str(tmp_path / "run"), resume=path, ft=False)
    with torch_threads():
        t = Trainer(cfg, method="output_adapt", device="cpu")
    want = from_jax_variables(params["G"], stats)
    got = t.state.G.state_dict()
    assert all(torch.equal(got[k], want[k]) for k in want)
    assert (t.start_epoch, t.best_pred) == (3, 0.5)
    t.writer.close()
    bad = str(tmp_path / "bad.ckpt")
    with open(bad, "wb") as f:
        f.write(b"not a checkpoint")
    with pytest.raises(ValueError, match="not a checkpoint"):
        Trainer(dataclasses.replace(cfg, resume=bad), device="cpu")


def test_synthetic_without_device_aug_raises(tmp_path):
    """The host train transforms are ported, so --dataset synthetic trains
    without --device-aug on uint8 crops that the device normalizes; and
    --data-backend native, which the JAX package ignores for synthetic
    (only its gtav2cityscapes arm has the native loader), gives the same
    batches as the default (ROADMAP C.10)."""
    from s2r_tpu_torch.train.trainer import Trainer

    with torch_threads():
        native = Trainer(PC.Config(dataset="synthetic", data_backend="native",
                                   batch_size=2, crop_size=32, base_size=32,
                                   workers=1, run_root=str(tmp_path)),
                         device="cpu")
        t = Trainer(PC.Config(dataset="synthetic", batch_size=2,
                              crop_size=32, base_size=32, workers=1,
                              run_root=str(tmp_path)), device="cpu")
    batch = next(iter(t.train_loader))
    other = next(iter(native.train_loader))
    assert sorted(other) == sorted(batch)
    for k in batch:
        np.testing.assert_array_equal(other[k], batch[k])
    native.writer.close()
    assert batch["src_image"].dtype == np.uint8
    assert batch["src_image"].shape == (2, 32, 32, 3)
    arrays = t._finish_batch({k: torch.as_tensor(v)
                              for k, v in batch.items()}, 0, 0)
    assert arrays["src_image"].dtype == torch.float32
    assert arrays["src_label"].dtype == torch.int64
    t.writer.close()

"""--fast-pad-stats in the port (pad_stats=False: no padding ring in the
expand BatchNorms' statistics, the depthwise convs zero-padded; models/
mobilenet.py) against the JAX package, on the CPU.

- A train-mode MobileNetV2 forward in float64, pad_stats False, from the
  JAX package's weights with perturbed statistics: both features within
  1e-10 of JAX's largest, the running statistics within 1e-10.
- One output step with --fast-pad-stats in float64 against JAX's, at
  tests/test_torch_port_train_step_f64.py's size (64x64 batch 2) and
  bounds (_torch_port_common.check_port_step).
- ROADMAP C.14: the flag changes the eval function too, once an expand
  BatchNorm's shift is positive.  An inverted residual (16 channels,
  stride 1, dilation 2, expand 6) in eval on a [1, 9, 9, 16] input with
  the expand BN's running mean at -0.5: pad_stats on and off differ by
  more than 0.5 in both packages, and each of the port's outputs is
  JAX's within 1e-5.
- A servable exported with --fast-pad-stats records pad_stats False, and
  load_servable rebuilds the ring-free model: its logits are the
  ring-free model's within 1e-5, and the ring model's differ.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from s2r_tpu.models.mobilenet import InvertedResidual as JaxBlock
from s2r_tpu.models.mobilenet import MobileNetV2 as JaxMobileNetV2
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.io.checkpoint import save_checkpoint
from s2r_tpu_torch.io import convert
from s2r_tpu_torch.io.convert import from_jax_variables
from s2r_tpu_torch.io.serving import load_servable, read_servable
from s2r_tpu_torch.models.deeplab import DeepLab
from s2r_tpu_torch.models.mobilenet import InvertedResidual
from s2r_tpu_torch.train.setup import build_method

from _torch_port_common import (check_port_step, jax_deeplab,
                                jax_f64_output_step, port_step_from_jax,
                                step_batches, torch_threads)


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def test_train_forward_without_ring_matches_jax_f64(monkeypatch):
    _, params, stats = jax_deeplab(33)
    x = np.random.RandomState(4).randn(2, 33, 33, 3)
    with jax.enable_x64(True):
        jm = JaxMobileNetV2(pad_stats=False, dtype=jnp.float64)
        f64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                     {"params": params["backbone"],
                                      "batch_stats": stats["backbone"]})
        (high, low), upd = jax.jit(lambda v, x: jm.apply(
            v, x, True, mutable=["batch_stats"]))(f64, jnp.asarray(x))
        want = (np.asarray(high), np.asarray(low))
        want_stats = jax.tree_util.tree_map(np.asarray, upd["batch_stats"])
    model = DeepLab(device="cpu", dtype="f64", pad_stats=False)
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    model.double().train()
    with torch_threads(), torch.no_grad():
        got = model.backbone(_nchw(x))
    for g, w in zip(got, want):
        g = g.permute(0, 2, 3, 1).numpy()
        assert np.abs(g - w).max() <= 1e-10 * np.abs(w).max()
    sd = model.state_dict()
    monkeypatch.setattr(convert, "_t", lambda a: torch.from_numpy(
        np.array(a, dtype=np.float64)))  # JAX's statistics unrounded
    new = convert.from_jax_variables(params,
                                     {**stats, "backbone": want_stats})
    keys = [k for k in new if k.startswith("backbone.features.")
            and "running" in k]
    assert len(keys) == 2 * 51
    for k in keys:
        np.testing.assert_allclose(sd[k].numpy(), new[k].numpy(),
                                   rtol=1e-10, atol=1e-10, err_msg=k)


def test_output_step_without_ring_matches_jax_f64():
    (batch,) = step_batches(1, 64, 2)
    jax_step = jax_f64_output_step(batch, 64, 2, pad_stats=False)
    with torch_threads():
        port = port_step_from_jax(*jax_step[:3], 0, batch, "f64",
                                  pad_stats=False)
    check_port_step(jax_step, port)


def _block_weights(variables):
    """The JAX inverted residual's variables -> the port block's
    state_dict (conv.0-7)."""
    p, s = variables["params"], variables["batch_stats"]
    out = {}
    for i, name in ((0, "expand_conv"), (3, "dw_conv"), (6, "project_conv")):
        out[f"conv.{i}.weight"] = torch.from_numpy(
            np.asarray(p[name]["kernel"]).transpose(3, 2, 0, 1).copy())
    for i, name in ((1, "expand_bn"), (4, "dw_bn"), (7, "project_bn")):
        out[f"conv.{i}.weight"] = torch.from_numpy(np.asarray(
            p[name]["scale"]).copy())
        out[f"conv.{i}.bias"] = torch.from_numpy(np.asarray(
            p[name]["bias"]).copy())
        out[f"conv.{i}.running_mean"] = torch.from_numpy(np.asarray(
            s[name]["mean"]).copy())
        out[f"conv.{i}.running_var"] = torch.from_numpy(np.asarray(
            s[name]["var"]).copy())
        out[f"conv.{i}.num_batches_tracked"] = torch.tensor(0)
    return out


def test_c14_eval_differs_once_a_shift_is_positive():
    x = np.random.RandomState(5).randn(1, 9, 9, 16).astype(np.float32)
    blk = dict(out_ch=16, stride=1, dilation=2, expand_ratio=6)
    v = JaxBlock(**blk).init({"params": jax.random.PRNGKey(3)},
                             jnp.asarray(x), False)
    v = jax.tree_util.tree_map(np.asarray, v)
    v["batch_stats"]["expand_bn"]["mean"] = np.full((96,), -0.5, np.float32)
    out = {}
    for ring in (True, False):
        want = np.asarray(JaxBlock(**blk, pad_stats=ring).apply(
            v, jnp.asarray(x), False))
        block = InvertedResidual(16, 16, 1, 2, 6, pad_stats=ring).eval()
        block.load_state_dict(_block_weights(v), strict=True)
        with torch.no_grad():
            got = block(_nchw(x)).permute(0, 2, 3, 1).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        out[ring] = (got, want)
    port_gap = np.abs(out[True][0] - out[False][0]).max()
    jax_gap = np.abs(out[True][1] - out[False][1]).max()
    assert port_gap > 0.5 and jax_gap > 0.5
    np.testing.assert_allclose(port_gap, jax_gap, rtol=1e-4)


HW = 32


def test_servable_keeps_fast_pad_stats(tmp_path, monkeypatch):
    from s2r_tpu_torch.cli import export

    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    st = build_method(Config(precision="f32"), 1, method="output_adapt",
                      device="cpu").init_state()
    with torch.no_grad():  # positive expand shifts: the ring shows
        for block in st.G.backbone.features[2:]:
            block.conv[1].running_mean.fill_(-0.5)
    ckpt = str(tmp_path / "s.ckpt")
    save_checkpoint(ckpt, st, 1, 0.5)
    argv = ["--dataset", "synthetic", "--precision", "f32", "--crop-size",
            str(HW), "--base-size", str(HW), "--resume", ckpt, "--format",
            "servable", "--serve-output", "logits", "--serve-shape", "1",
            str(HW), str(HW)]
    frames = np.random.RandomState(6).randn(1, HW, HW, 3).astype(np.float32)
    served = {}
    for fast in (True, False):
        out = str(tmp_path / f"{fast}.s2rt")
        with torch_threads():
            export.main(argv + ["--out", out]
                        + (["--fast-pad-stats"] if fast else []))
        assert read_servable(out)[0]["pad_stats"] is (not fast)
        serve = load_servable(out, device="cpu")
        assert serve.model.pad_stats is (not fast)
        assert all(b.pad_stats is (not fast)
                   for b in serve.model.backbone.features[1:])
        model = DeepLab(device="cpu", pad_stats=not fast)
        model.load_state_dict(st.G.state_dict(), strict=True)
        with torch_threads(), torch.no_grad():
            served[fast] = serve(frames)
            want = model(_nchw(frames))[0].permute(0, 2, 3, 1)
        torch.testing.assert_close(served[fast], want, rtol=1e-5,
                                   atol=1e-5)
    assert float((served[True] - served[False]).abs().max()) > 1e-3

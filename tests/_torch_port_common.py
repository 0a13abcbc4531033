"""Shared set-up for the tests of the PyTorch port (tests/test_torch_port_*.py).

One JAX DeepLab-V3+ (MobileNetV2, output stride 16, 19 classes, full width,
float32) initialized from PRNGKey(0) with its BatchNorm statistics perturbed
from a numpy seed (mean != 0, var != 1), and the port's DeepLab on the CPU
holding the same weights.  Inputs are made with numpy and handed to both.
"""

import contextlib
import functools

import numpy as np

import jax
import jax.numpy as jnp
import torch

from s2r_tpu.models import DeepLab as JaxDeepLab
from s2r_tpu_torch.io.convert import flat_to_port, from_jax_variables  # noqa: F401
from s2r_tpu_torch.models.deeplab import DeepLab

HW = 65


def perturb_stats(tree, seed: int = 1):
    """Copy of a batch_stats tree with mean ~ N(0, 0.1) and var ~ U(0.5, 1.5)."""
    rs = np.random.RandomState(seed)

    def walk(d):
        out = {}
        for k in sorted(d):
            v = d[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "mean":
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
        return out

    return walk(tree)


def jax_deeplab(hw: int = HW):
    """(flax DeepLab, params, batch_stats) as numpy trees."""
    model = JaxDeepLab(output_stride=16, num_classes=19)
    x = jnp.zeros((1, hw, hw, 3), jnp.float32)
    v = jax.jit(lambda: model.init({"params": jax.random.PRNGKey(0)}, x,
                                   False))()
    params = jax.tree_util.tree_map(np.asarray, v["params"])
    stats = perturb_stats(jax.tree_util.tree_map(np.asarray,
                                                 v["batch_stats"]))
    return model, params, stats


@functools.lru_cache(maxsize=None)
def jax_output_adapt(backbone: str):
    """(JAX output_adapt method on `backbone`, its initial TrainState from
    PRNGKey(5)), built once a process: both are immutable.  The
    parameters do not depend on the output stride."""
    from s2r_tpu.config import Config as JaxConfig
    from s2r_tpu.train.setup import build_method as jax_build

    jm = jax_build(JaxConfig(backbone=backbone, dataset="synthetic",
                             crop_size=33, base_size=33, batch_size=2), 4,
                   method="output_adapt")
    return jm, jm.init_state(jax.random.PRNGKey(5))


def port_deeplab(params, stats, dtype=torch.float32) -> DeepLab:
    """The port's DeepLab on the CPU holding the JAX weights."""
    model = DeepLab(num_classes=19, output_stride=16, dtype=dtype,
                    device="cpu")
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    return model


def images(n: int = 2, hw: int = HW, seed: int = 0) -> np.ndarray:
    """Normalized-looking float32 NHWC images."""
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(np.float32)


@contextlib.contextmanager
def torch_threads():
    """Run torch's CPU ops on 2 threads: the test runner puts several test
    files on one machine at once, and torch's default of one thread per
    core in each of them makes the heavy step fixtures crawl (9 minutes
    instead of one)."""
    old = torch.get_num_threads()
    torch.set_num_threads(2)
    try:
        yield
    finally:
        torch.set_num_threads(old)


def step_batches(steps: int, hw: int, batch: int, seed: int = 7):
    """`steps` numpy train batches: NHWC float32 source and target images
    and [N,H,W] int32 source labels with the top rows ignored (255)."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(steps):
        lbl = rs.randint(0, 19, (batch, hw, hw)).astype(np.int32)
        lbl[:, :4] = 255
        out.append({"src_image": rs.randn(batch, hw, hw, 3).astype(np.float32),
                    "src_label": lbl,
                    "tgt_image": rs.randn(batch, hw, hw, 3).astype(np.float32)})
    return out


def perturb_affine(tree, seed: int = 2):
    """Copy of a params tree with every BatchNorm scale ~ U(0.5, 1.5) and
    every bias ~ N(0, 0.1).  At the initial scale 1 and bias 0 each block's
    input has a batch mean of exactly 0, so every expand BatchNorm's shift
    is 0 in exact arithmetic and fill = relu6(shift) sits on the kink:
    the gradient of those channels is then decided by the sign of rounding
    error, in either framework.  Away from that point the step is smooth."""
    rs = np.random.RandomState(seed)

    def walk(d):
        out = {}
        for k in sorted(d):
            v = d[k]
            if isinstance(v, dict):
                out[k] = walk(v)
            elif k == "scale":
                out[k] = rs.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias":
                out[k] = (rs.randn(*v.shape) * 0.1).astype(np.float32)
            else:
                out[k] = v
        return out

    return walk(tree)


def port_step_from_jax(params, stats, opt_state, step: int, batch,
                       precision: str, method: str = "output_adapt",
                       backbone: str = "mobilenet", **config):
    """One step of the port's `method` started from a JAX TrainState's
    contents (numpy trees: params {'G','D'}, batch_stats, opt_state of the
    method's layout, step), dropout off, on the CPU; `config`: more Config
    fields.  Returns (metrics as floats, G state_dict, D state_dict,
    opt_state), tensors as float64 copies."""
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.io.convert import train_state_from_jax
    from s2r_tpu_torch.models.layers import set_dropout
    from s2r_tpu_torch.train.setup import build_method

    pm = build_method(Config(precision=precision, backbone=backbone,
                             **config),
                      iters_per_epoch=10, method=method, device="cpu")
    set_dropout(pm.deeplab, False)
    set_dropout(pm.aux_model, False)
    state = train_state_from_jax(pm.init_state(), params, stats, opt_state,
                                 step)
    state, met = pm.step_fn(state, batch)
    return ({k: float(v) for k, v in met.items()},
            {k: v.detach().double().clone()
             for k, v in pm.deeplab.state_dict().items()},
            {k: v.detach().double().clone()
             for k, v in pm.aux_model.state_dict().items()},
            {net: {k: v.double().clone() if torch.is_tensor(v) else v
                   for k, v in s.items()}
             for net, s in state.opt_state.items()})


def jax_f64_output_step(batch, hw: int, n: int, pad_to=None, **fields):
    """One JAX output_adapt step in float64 (tests/test_torch_port_train_
    step_f64.py's set-up: a float64 compute policy under jax.enable_x64,
    dropout off, G's BatchNorm scale and bias and every running statistic
    perturbed) from PRNGKey(0), on `batch` (numpy) at crop `hw` and batch
    size `n`; `pad_to` monkeypatches the JAX package's _step_pad_to, as
    its own test does; `fields`: more Config fields.  Returns numpy trees
    (params, stats, opt_state) before the step, (params, stats) after it,
    and the metrics as floats."""
    import pytest

    from s2r_tpu.config import Config as JaxConfig
    from s2r_tpu.core.precision import Policy
    from s2r_tpu.models import layers as JL
    from s2r_tpu.train import setup as jax_setup

    def np_tree(t):
        return jax.tree_util.tree_map(np.asarray, t)

    from_name = Policy.from_name.__func__
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JL.Dropout, "__call__", lambda self, x, deterministic: x)
        mp.setattr(Policy, "from_name", classmethod(
            lambda cls, name: cls(compute_dtype=jnp.float64)
            if name == "f64" else from_name(cls, name)))
        if pad_to is not None:
            mp.setattr(jax_setup, "_step_pad_to", lambda cfg, k: pad_to)
        jm = jax_setup.build_method(
            JaxConfig(crop_size=hw, base_size=hw, batch_size=n,
                      precision="f64", **fields),
            iters_per_epoch=10, method="output_adapt")
        state = jm.init_state(jax.random.PRNGKey(0))
        params = np_tree(state.params)
        params["G"] = perturb_affine(params["G"])
        stats = perturb_stats(np_tree(state.batch_stats))
        state = state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            batch_stats=jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), stats))
        opt = np_tree(state.opt_state)
        after, met = jax.jit(jm.step_fn)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        return (params, stats, opt, np_tree(after.params),
                np_tree(after.batch_stats),
                {k: float(v) for k, v in met.items()})


def check_port_step(jax_step, port_step) -> None:
    """The port's output step (port_step_from_jax's result) against the
    JAX one (jax_f64_output_step's) at tests/test_torch_port_train_step_
    f64.py's bounds: losses rtol 1e-5; G's and D's updates per leaf within
    1e-3 relative L2; running statistics within 1e-5 of each layer's
    largest."""
    from s2r_tpu_torch.io.convert import from_jax_discriminator

    params, stats, _, after_params, after_stats, met = jax_step
    got_met, got_g, got_d, _ = port_step
    for k in ("seg_loss", "adv_loss", "d_loss"):
        np.testing.assert_allclose(got_met[k], met[k], rtol=1e-5, err_msg=k)
    before = from_jax_variables(params["G"], stats)
    want = from_jax_variables(after_params["G"], after_stats)
    n_stats = 0
    for k, w in want.items():
        w, b = w.double(), before[k].double()
        if "running" in k:
            n_stats += k.startswith(("backbone.features.", "aspp.",
                                     "decoder."))
            err = float((got_g[k] - w).abs().max())
            assert err <= 1e-5 * float(w.abs().max()), (k, err)
        elif "num_batches" not in k and float((w - b).norm()) > 0:
            rel = float((got_g[k] - w).norm() / (w - b).norm())
            assert rel <= 1e-3, (k, rel)
    assert n_stats == 2 * 60  # every BatchNorm of G
    d0 = from_jax_discriminator(params["D"])
    d1 = from_jax_discriminator(after_params["D"])
    for k in d1:
        w, b = d1[k].double(), d0[k].double()
        rel = float((got_d[k] - w).norm() / (w - b).norm())
        assert rel <= 1e-3, (k, rel)

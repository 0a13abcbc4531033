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
                       backbone: str = "mobilenet"):
    """One step of the port's `method` started from a JAX TrainState's
    contents (numpy trees: params {'G','D'}, batch_stats, opt_state of the
    method's layout, step), dropout off, on the CPU.  Returns (metrics as
    floats, G state_dict, D state_dict, opt_state), tensors as float64
    copies."""
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.io.convert import train_state_from_jax
    from s2r_tpu_torch.models.layers import set_dropout
    from s2r_tpu_torch.train.setup import build_method

    pm = build_method(Config(precision=precision, backbone=backbone),
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

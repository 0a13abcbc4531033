"""Shared set-up for the tests of the PyTorch port (tests/test_torch_port_*.py).

One JAX DeepLab-V3+ (MobileNetV2, output stride 16, 19 classes, full width,
float32) initialized from PRNGKey(0) with its BatchNorm statistics perturbed
from a numpy seed (mean != 0, var != 1), and the port's DeepLab on the CPU
holding the same weights.  Inputs are made with numpy and handed to both.
"""

import numpy as np

import jax
import jax.numpy as jnp
import torch

from s2r_tpu.models import DeepLab as JaxDeepLab
from s2r_tpu_torch.io.convert import from_jax_variables
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


def port_deeplab(params, stats, dtype=torch.float32) -> DeepLab:
    """The port's DeepLab on the CPU holding the JAX weights."""
    model = DeepLab(num_classes=19, output_stride=16, dtype=dtype,
                    device="cpu")
    model.load_state_dict(from_jax_variables(params, stats), strict=True)
    return model


def images(n: int = 2, hw: int = HW, seed: int = 0) -> np.ndarray:
    """Normalized-looking float32 NHWC images."""
    return np.random.RandomState(seed).randn(n, hw, hw, 3).astype(np.float32)

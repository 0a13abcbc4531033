"""The port's output-space adaptation step on ResNet-50 and Aligned
Xception-65 against the JAX package's, both computing in float64, leaf by
leaf (the harness of tests/test_torch_port_train_step_f64.py).

Set-up: DeepLab-V3+ on the backbone (os 16, 19 classes, full width) and
the FCDiscriminator from JAX's init, BatchNorm running statistics and
scale and bias perturbed, dropout off, one step at 33x33 batch 2.  The
JAX side runs its own ``build_method(..., 'output_adapt')`` under
``jax.enable_x64`` with a float64 compute policy; the port is loaded with
JAX's state and takes the same step.

Bounds (those of tests/test_torch_port_train_step_f64.py):
- losses rtol 1e-5;
- SGD's momentum buffer of G read leaf by leaf in the JAX package's flat
  order (flat_to_port): every leaf within 1e-5 relative L2 of the port's
  (a buffer read in another order fails at once: the leaves' shapes and
  values move);
- G's gradient per leaf, from that buffer, relative L2 <= 1e-5; left out
  are the leaves the float32 buffer does not resolve, the same on both
  sides.  On Xception these are the biases of every separable conv's
  depthwise BatchNorm: the pointwise conv after it carries a per-channel
  constant into a train-mode BatchNorm, which removes it, so their
  gradient is exactly 0;
- G's and D's updates per leaf: relative L2 <= 1e-3;
- BatchNorm running statistics: per layer within 1e-5 of its largest.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.core.precision import Policy
from s2r_tpu.models import layers as L
from s2r_tpu.train.setup import build_method as jax_build_method
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                      from_jax_discriminator,
                                      from_jax_variables)
from s2r_tpu_torch.tools.step_conditioning import sgd_gradients

from _torch_port_common import (flat_to_port, perturb_affine,
                                perturb_stats, port_step_from_jax,
                                step_batches, torch_threads)

HW, BATCH = 33, 2
MOMENTUM, WD = Config().momentum, Config().weight_decay


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module", params=["resnet50", "xception"])
def run(request):
    """(backbone, JAX state before and after the step, JAX metrics, the
    port's step from the JAX state)."""
    backbone = request.param
    batch = step_batches(1, HW, BATCH)[0]
    from_name = Policy.from_name.__func__
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(L.Dropout, "__call__", lambda self, x, deterministic: x)
        mp.setattr(Policy, "from_name", classmethod(
            lambda cls, name: cls(compute_dtype=jnp.float64)
            if name == "f64" else from_name(cls, name)))
        jm = jax_build_method(JaxConfig(crop_size=HW, base_size=HW,
                                        batch_size=BATCH, precision="f64",
                                        backbone=backbone),
                              iters_per_epoch=10, method="output_adapt")
        state = jm.init_state(jax.random.PRNGKey(0))
        params = _np(state.params)
        params["G"] = perturb_affine(params["G"])
        stats = perturb_stats(_np(state.batch_stats))
        state = state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            batch_stats=jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), stats))
        before = (params, stats, _np(state.opt_state), 0)
        state, met = jax.jit(jm.step_fn)(
            state, {k: jnp.asarray(v) for k, v in batch.items()})
        after = (_np(state.params), _np(state.batch_stats),
                 _np(state.opt_state), int(state.step))
    with torch_threads():
        port = port_step_from_jax(*before, batch, "f64", backbone=backbone)
    return (backbone, before, after, {k: float(v) for k, v in met.items()},
            port)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _worst(got, want, keys):
    errs = {k: _rel(got[k], want[k]) for k in keys}
    k = max(errs, key=errs.get)
    return errs[k], k


def _jax_buffer(run):
    backbone, _, after, _, _ = run
    return flat_to_port(after[2]["G"]["momentum"], after[0]["G"],
                        lambda t: from_jax_variables(t, after[1], backbone),
                        deeplab_param_order(backbone))


def test_f64_losses_match_jax(run):
    _, _, _, metrics, port = run
    for k in ("seg_loss", "adv_loss", "d_loss", "lr"):
        np.testing.assert_allclose(port[0][k], metrics[k], rtol=1e-5,
                                   err_msg=k)


def test_f64_optimizer_buffer_order_matches_jax(run):
    backbone = run[0]
    order = deeplab_param_order(backbone)
    shapes = {k: v.shape for k, v in run[4][1].items()}
    sizes = [int(np.prod(shapes[k])) for k in order]
    want = dict(zip(order, _jax_buffer(run).double().split(sizes)))
    got = dict(zip(order, run[4][3]["G"]["momentum"].split(sizes)))
    err, leaf = _worst(got, want, order)
    assert err <= 1e-5, (leaf, err)


def test_f64_g_gradient_per_leaf_matches_jax(run):
    backbone, before_state, _, _, port = run
    before = from_jax_variables(before_state[0]["G"], before_state[1],
                                backbone)
    order = deeplab_param_order(backbone)
    want = sgd_gradients(_jax_buffer(run), before, WD, None, MOMENTUM, order)
    got = sgd_gradients(port[3]["G"]["momentum"], before, WD, None, MOMENTUM,
                        order)
    zero = {k for k in want if want[k] is None}
    assert zero == {k for k in got if got[k] is None}
    if backbone == "xception":
        dw_bn = {k for k in order
                 if k.startswith("backbone.") and k.endswith(".bn.bias")}
        assert zero == dw_bn and len(dw_bn) == 59  # 6 + 48 + 2 + 3
    else:
        assert not zero
    err, leaf = _worst(got, want, [k for k in want if k not in zero])
    assert err <= 1e-5, (leaf, err)


def test_f64_g_update_per_leaf_matches_jax(run):
    backbone, before_state, after_state, _, port = run
    before = from_jax_variables(before_state[0]["G"], before_state[1],
                                backbone)
    after = from_jax_variables(after_state[0]["G"], after_state[1], backbone)
    keys = deeplab_param_order(backbone)
    want = {k: after[k].double() - before[k].double() for k in keys}
    got = {k: port[1][k] - before[k].double() for k in keys}
    assert all(float(want[k].norm()) > 0 for k in keys)
    err, leaf = _worst(got, want, keys)
    assert err <= 1e-3, (leaf, err)


def test_f64_d_update_per_leaf_matches_jax(run):
    _, before_state, after_state, _, port = run
    before = from_jax_discriminator(before_state[0]["D"])
    after = from_jax_discriminator(after_state[0]["D"])
    want = {k: after[k].double() - before[k].double() for k in before}
    got = {k: port[2][k] - before[k].double() for k in before}
    err, leaf = _worst(got, want, list(before))
    assert err <= 1e-3, (leaf, err)


def test_f64_bn_running_stats_match_jax(run):
    backbone, before_state, after_state, _, port = run
    want = from_jax_variables(after_state[0]["G"], after_state[1], backbone)
    start = from_jax_variables(before_state[0]["G"], before_state[1],
                               backbone)
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))]
    n_bn = {"resnet50": 53 + 9, "xception": 124 + 9}[backbone]
    assert len(keys) == 2 * n_bn  # every BatchNorm of G
    for k in keys:
        w = want[k].double()
        err = float((port[1][k] - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (k, err)
    assert any(not torch.equal(start[k], want[k]) for k in keys)

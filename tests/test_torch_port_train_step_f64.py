"""The port's output-space adaptation step against the JAX package's, both
computing in float64, leaf by leaf.

In float32 neither framework resolves this step at 64x64 batch 2 to 1e-3:
rounding alone moves every leaf of G's gradient by ~1e-2 (the float32
bounds and their reasons are in tests/test_torch_port_train_step.py).  In
float64 both sides compute one function, so each leaf is held to 1e-3
or tighter.

Set-up: DeepLab-V3+ MobileNetV2 (os 16, 19 classes, full width) and the
FCDiscriminator (ndf 64) from JAX's init, BatchNorm running statistics
perturbed and BatchNorm scale and bias perturbed too (perturb_affine says
why: at the initial point every expand BatchNorm's fill sits exactly on
relu6's kink).  Dropout off on both sides.  The JAX side runs its own
``build_method(..., 'output_adapt')`` under ``jax.enable_x64`` with a
float64 compute policy (its parameters and optimizer stay float32, as the
port's 'f64' precision keeps them); the JAX package itself still rounds a
few values to float32 (the fill product, the BCE logits), so the
agreement stops near float32 rounding of those values.  JAX takes 3 steps; before
each, the port is loaded with JAX's state (parameters, statistics,
optimizer buffers, step) and takes the same step, so every step is
compared from one starting point and the comparison does not drift.

Bounds, each step:
- losses rtol 1e-5 (measured <= 3.3e-7);
- G's gradient per leaf, read from SGD's momentum buffer (new buffer less
  momentum x old buffer less weight decay x parameter): relative L2 of the
  worst leaf <= 1e-5 (measured <= 4.3e-7).  Left out, by a rule on the
  buffers: leaves whose gradient the float32 buffer does not resolve (norm
  within 100 float32 roundings of the buffer's).  That is one leaf, the
  bias of block 17's projection BatchNorm: every consumer of block 17 is a
  BatchNorm without a padding ring, which removes a per-channel constant,
  so its gradient is exactly 0;
- G's and D's updates per leaf: relative L2 of the worst leaf <= 1e-3
  (measured <= 1.4e-4 and 1.6e-5: the parameters are float32, so a small
  update is a few units in the last place);
- BatchNorm running statistics: per layer within 1e-5 of its largest
  (measured <= 2.1e-7).
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

HW, BATCH, STEPS = 64, 2, 3
MOMENTUM, WD = Config().momentum, Config().weight_decay
ZERO_GRADIENT = {"backbone.features.17.conv.7.bias"}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """(JAX states before each step and after the last, JAX metrics, the
    port's step from each JAX state)."""
    batches = step_batches(STEPS, HW, BATCH)
    from_name = Policy.from_name.__func__
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(L.Dropout, "__call__", lambda self, x, deterministic: x)
        mp.setattr(Policy, "from_name", classmethod(
            lambda cls, name: cls(compute_dtype=jnp.float64)
            if name == "f64" else from_name(cls, name)))
        jm = jax_build_method(JaxConfig(crop_size=HW, base_size=HW,
                                        batch_size=BATCH, precision="f64"),
                              iters_per_epoch=10, method="output_adapt")
        state = jm.init_state(jax.random.PRNGKey(0))
        params = _np(state.params)
        params["G"] = perturb_affine(params["G"])
        stats = perturb_stats(_np(state.batch_stats))
        # float64 statistics from the start: the step writes float64 ones
        state = state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            batch_stats=jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), stats))
        step = jax.jit(jm.step_fn)
        states = [(params, stats, _np(state.opt_state), 0)]
        metrics = []
        for b in batches:
            state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append({k: float(v) for k, v in met.items()})
            states.append((_np(state.params), _np(state.batch_stats),
                           _np(state.opt_state), int(state.step)))
    with torch_threads():
        port = [port_step_from_jax(*states[i], batches[i], "f64")
                for i in range(STEPS)]
    return states, metrics, port


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _worst(got, want, keys):
    errs = {k: _rel(got[k], want[k]) for k in keys}
    k = max(errs, key=errs.get)
    return errs[k], k


@pytest.mark.parametrize("i", range(STEPS))
def test_f64_losses_match_jax(runs, i):
    _, metrics, port = runs
    for k in ("seg_loss", "adv_loss", "d_loss", "lr"):
        np.testing.assert_allclose(port[i][0][k], metrics[i][k], rtol=1e-5,
                                   err_msg=f"step {i} {k}")


@pytest.mark.parametrize("i", range(STEPS))
def test_f64_g_gradient_per_leaf_matches_jax(runs, i):
    states, _, port = runs
    before = from_jax_variables(states[i][0]["G"], states[i][1])

    def buf(j):  # JAX's momentum buffer after step j, in the port's layout
        return flat_to_port(states[j][2]["G"]["momentum"], states[j][0]["G"],
                            lambda t: from_jax_variables(t, states[j][1]),
                            deeplab_param_order())

    want = sgd_gradients(buf(i + 1), before, WD, buf(i), MOMENTUM)
    got = sgd_gradients(port[i][3]["G"]["momentum"], before, WD, buf(i),
                        MOMENTUM)
    zero = {k for k in want if want[k] is None}
    assert zero == ZERO_GRADIENT == {k for k in got if got[k] is None}
    err, leaf = _worst(got, want, [k for k in want if k not in zero])
    assert err <= 1e-5, (leaf, err)


@pytest.mark.parametrize("i", range(STEPS))
def test_f64_g_update_per_leaf_matches_jax(runs, i):
    states, _, port = runs
    before = from_jax_variables(states[i][0]["G"], states[i][1])
    after = from_jax_variables(states[i + 1][0]["G"], states[i + 1][1])
    keys = deeplab_param_order()
    want = {k: after[k].double() - before[k].double() for k in keys}
    got = {k: port[i][1][k] - before[k].double() for k in keys}
    assert all(float(want[k].norm()) > 0 for k in keys)
    err, leaf = _worst(got, want, keys)
    assert err <= 1e-3, (leaf, err)


@pytest.mark.parametrize("i", range(STEPS))
def test_f64_d_update_per_leaf_matches_jax(runs, i):
    states, _, port = runs
    before = from_jax_discriminator(states[i][0]["D"])
    after = from_jax_discriminator(states[i + 1][0]["D"])
    want = {k: after[k].double() - before[k].double() for k in before}
    got = {k: port[i][2][k] - before[k].double() for k in before}
    err, leaf = _worst(got, want, list(before))
    assert err <= 1e-3, (leaf, err)


@pytest.mark.parametrize("i", range(STEPS))
def test_f64_bn_running_stats_match_jax(runs, i):
    states, _, port = runs
    want = from_jax_variables(states[i + 1][0]["G"], states[i + 1][1])
    start = from_jax_variables(states[i][0]["G"], states[i][1])
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))
            and k.startswith(("backbone.features.", "aspp.", "decoder."))]
    assert len(keys) == 2 * 60  # every BatchNorm of G
    for k in keys:
        w = want[k].double()
        err = float((port[i][1][k] - w).abs().max())
        assert err <= 1e-5 * float(w.abs().max()), (k, err)
    assert any(not torch.equal(start[k], want[k]) for k in keys)

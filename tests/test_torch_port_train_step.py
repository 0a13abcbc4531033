"""The port's output-space adaptation step against the JAX package's, in
float32.

Both sides are built by their ``build_method(cfg, ..., 'output_adapt')``
at 64x64, batch 2, float32 on the CPU (DeepLab-V3+ MobileNetV2 os 16, 19
classes, full width; FCDiscriminator ndf 64), start from the same weights
(JAX's init, BatchNorm running statistics perturbed) with zero optimizer
state, and see the same 3 numpy batches.  Dropout is off on both sides:
the JAX Dropout is patched to the identity, as
tests/test_train_step_parity.py does, and the port's is switched off with
``set_dropout``.  On the CPU every kernel wrapper runs its plain version.
The port takes one step from each of JAX's states (parameters,
statistics, optimizer buffers, step), so each step is compared from one
starting point, and one step free from the initial weights.
The port also takes the first step computing in float64 (precision 'f64':
float32 parameters and optimizer buffers, every activation and gradient in
float64), which shows how far float32 rounding alone moves the result.

Bounds:
- the three losses of each step from JAX's state: rtol 1e-4.  Not of a
  free-running port: float32 rounding alone moves this step's gradient by
  0.5-5% in either framework (ROADMAP C.4), so two free float32
  trajectories part after an update by an amount that depends on the
  machine's thread layout (step 2's seg_loss 3.25613 against 3.26326 in
  one run);
- the BatchNorm running statistics after each step from JAX's state: 1e-3
  of the largest statistic of the same BatchNorm;
- G's update from each of JAX's states: global relative L2 of the
  difference from JAX's <= 5e-2, the JAX package's own bound against the
  torch reference (tests/test_train_step_parity.py:201).  Not 1e-3, and
  not per leaf: float32 rounding alone moves this step's gradient by
  ~1e-2 in either framework (the port's first float32 update is 2.4e-2
  from its float64 one and JAX's 2.6e-2,
  test_first_update_is_float32_rounding_from_exact), and at the initial
  point (BatchNorm bias 0) every expand BatchNorm's fill = relu6(shift)
  sits exactly on the kink, so a few bias leaves follow the sign of
  rounding error.  Measured 3.1e-2, 1.3e-2 and 5.5e-3 for the three
  steps.  tests/test_torch_port_train_step_f64.py holds the same step in
  float64, leaf by leaf, away from the kink;
- D's update agrees in sign with JAX's on >= 99% of the elements at each
  step (Adam's first step is sign-driven; measured >= 99.93%).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.models import layers as L
from s2r_tpu.train.setup import build_method as jax_build_method
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                      from_jax_discriminator,
                                      from_jax_variables)
from s2r_tpu_torch.models.layers import set_dropout
from s2r_tpu_torch.train.setup import build_method

from _torch_port_common import (perturb_stats, port_step_from_jax,
                                step_batches, torch_threads)

HW, BATCH, STEPS = 64, 2, 3


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs():
    """(initial weights, JAX metrics, JAX states before each step and after
    the last, the port's first step from the initial weights by precision,
    the port's step from each JAX state)."""
    batches = step_batches(STEPS, HW, BATCH)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(L.Dropout, "__call__", lambda self, x, deterministic: x)
        jm = jax_build_method(JaxConfig(crop_size=HW, base_size=HW,
                                        batch_size=BATCH, precision="f32"),
                              iters_per_epoch=10, method="output_adapt")
        state = jm.init_state(jax.random.PRNGKey(0))
        state = state.replace(batch_stats=jax.tree_util.tree_map(
            jnp.asarray, perturb_stats(_np(state.batch_stats))))
        init = (_np(state.params), _np(state.batch_stats))
        step = jax.jit(jm.step_fn)
        jax_metrics = []
        states = [init + (_np(state.opt_state), 0)]
        for b in batches:
            state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
            jax_metrics.append({k: float(v) for k, v in met.items()})
            states.append((_np(state.params), _np(state.batch_stats),
                           _np(state.opt_state), int(state.step)))

    with torch_threads():
        port = {"f32": _port_run(init, batches[:1], "f32"),
                "f64": _port_run(init, batches[:1], "f64")}
        forced = [port_step_from_jax(*states[i], batches[i], "f32")
                  for i in range(STEPS)]
    return init, jax_metrics, states, port, forced


def _port_run(init, batches, precision):
    """The port's steps on `batches` from JAX's initial weights:
    ([metrics], [(G state_dict, D state_dict)]) after each step."""
    pm = build_method(Config(precision=precision), iters_per_epoch=10,
                      method="output_adapt", device="cpu")
    pm.deeplab.load_state_dict(from_jax_variables(init[0]["G"], init[1]),
                               strict=True)
    pm.aux_model.load_state_dict(from_jax_discriminator(init[0]["D"]),
                                 strict=True)
    set_dropout(pm.deeplab, False)
    state = pm.init_state()
    metrics, after = [], []
    for b in batches:
        state, met = pm.step_fn(state, b)
        metrics.append({k: float(v) for k, v in met.items()})
        after.append(tuple({k: v.detach().double().clone() for k, v in
                            m.state_dict().items()}
                           for m in (pm.deeplab, pm.aux_model)))
    return metrics, after


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _g_update(start, sd):
    """G's update from `start` to state_dict `sd`, flattened, float64."""
    return torch.cat([(sd[k].double() - start[k].double()).reshape(-1)
                      for k in deeplab_param_order()])


def _d_update(start, sd):
    return torch.cat([(sd[k].double() - start[k].double()).reshape(-1)
                      for k in start])


def _sign_agreement(a, b):
    return float((torch.sign(a) == torch.sign(b)).double().mean())


@pytest.mark.parametrize("i", range(STEPS))
def test_losses_match_jax(runs, i):
    _, jax_metrics, _, _, forced = runs
    for k in ("seg_loss", "adv_loss", "d_loss", "lr"):
        np.testing.assert_allclose(forced[i][0][k], jax_metrics[i][k],
                                   rtol=1e-4, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("i", range(STEPS))
def test_bn_running_stats_match_jax(runs, i):
    _, _, states, _, forced = runs
    want = from_jax_variables(states[i + 1][0]["G"], states[i + 1][1])
    start = from_jax_variables(states[i][0]["G"], states[i][1])
    got = forced[i][1]
    keys = [k for k in want if k.endswith(("running_mean", "running_var"))
            and k.startswith(("backbone.features.", "aspp.", "decoder."))]
    assert len(keys) == 2 * 60  # every BatchNorm of G
    for k in keys:
        w = want[k].double()
        err = float((got[k] - w).abs().max())
        assert err <= 1e-3 * float(w.abs().max()), (k, err)
    assert any(not torch.equal(start[k], want[k]) for k in keys)


def test_first_update_is_float32_rounding_from_exact(runs):
    """Both float32 updates sit within float32 rounding of the port's
    float64 one, the port's no farther than 1.5x JAX's (measured 2.4e-2
    and 2.6e-2): the frameworks compute one function."""
    init, _, states, port, _ = runs
    start = from_jax_variables(init[0]["G"], init[1])
    exact = _g_update(start, port["f64"][1][0][0])
    port32 = _g_update(start, port["f32"][1][0][0])
    jax32 = _g_update(start, from_jax_variables(states[1][0]["G"],
                                                states[1][1]))
    assert _rel(jax32, exact) <= 5e-2, _rel(jax32, exact)
    assert _rel(port32, exact) <= 1.5 * _rel(jax32, exact), (
        _rel(port32, exact), _rel(jax32, exact))


@pytest.mark.parametrize("i", range(STEPS))
def test_g_update_matches_jax(runs, i):
    _, _, states, _, forced = runs
    start = from_jax_variables(states[i][0]["G"], states[i][1])
    want = _g_update(start, from_jax_variables(states[i + 1][0]["G"],
                                               states[i + 1][1]))
    got = _g_update(start, forced[i][1])
    assert float(want.norm()) > 0 and _rel(got, want) <= 5e-2, _rel(got, want)


@pytest.mark.parametrize("i", range(STEPS))
def test_d_update_sign_matches_jax(runs, i):
    _, _, states, _, forced = runs
    start = from_jax_discriminator(states[i][0]["D"])
    want = _d_update(start, from_jax_discriminator(states[i + 1][0]["D"]))
    got = _d_update(start, forced[i][2])
    assert _sign_agreement(got, want) >= 0.99, _sign_agreement(got, want)

"""The port's feature-space adaptation and source-only steps against the
JAX package's, on the CPU.

Both sides are built by their ``build_method(cfg, ..., 'feature_adapt')``
and ``'source_only'`` at 64x64, batch 2 (DeepLab-V3+ MobileNetV2 os 16,
19 classes, full width; the DomainClassifier on the 4x4 ASPP feature),
start from JAX's init with every BatchNorm's running statistics perturbed
(G's 60 and D's 2), and see the same 3 numpy batches.  Dropout is off on
both sides: the JAX Dropout is patched to the identity, the port's
switched off with ``set_dropout``.  JAX takes the 3 steps; before each,
the port is loaded with JAX's state (parameters, statistics, the four
optimizer buffers, step; ``train_state_from_jax``) and takes the same
step, so every step is compared from one starting point.  On the CPU every
kernel wrapper runs its plain version.

Bounds, float32, each step:
- the five metrics (task_loss, d_loss, d_inv_loss, d_acc, lr): rtol 1e-4
  (measured <= 2.4e-5);
- the running statistics of G's 60 BatchNorms and D's 2: 1e-3 of the
  largest statistic of the same layer;
- G's and D's updates: global relative L2 of the difference from JAX's <=
  5e-2, the bound of tests/test_torch_port_train_step.py (float32
  rounding alone moves the step's gradient by ~1e-2 in either framework,
  ROADMAP C.4; measured G 3.3e-2, 1.8e-2, 1.4e-2 and D <= 7.0e-3);
- the 'd_inv' buffer likewise (measured as G's), and 'c' (never stepped)
  equal to JAX's.

Float64, one feature step (JAX under ``jax.enable_x64`` with a float64
compute policy, BatchNorm scale and bias perturbed off relu6's kink as in
tests/test_torch_port_train_step_f64.py): the metrics at rtol 1e-5, and
G's and D's gradients leaf by leaf (read from the 'task' and 'd' SGD
buffers) with the worst leaf's relative L2 <= 1e-5 (measured: metrics
<= 3.2e-7, G's worst leaf 1.8e-7, D's 6.5e-7).  The JAX package
rounds the domain logits to float32 before their CE
(s2r_tpu/train/losses.py:81), which bounds the agreement.

Source-only: D's parameters, statistics and optimizer buffers come out
untouched, and the three domain metrics are zero.  The learning rate of
the feature step has no 1x/10x groups: the decoder's first update is
-lr x its 'task' buffer, and f's is -lr x ('task' + 'd_inv'), up to the
rounding of the float32 parameters.
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
                                      domain_param_order,
                                      feature_param_order, flat_to_port,
                                      from_jax_domain, from_jax_variables)
from s2r_tpu_torch.tools.step_conditioning import sgd_gradients

from _torch_port_common import (perturb_affine, perturb_stats,
                                port_step_from_jax, step_batches,
                                torch_threads)

HW, BATCH, STEPS = 64, 2, 3
WD = Config().weight_decay
METRICS = ("task_loss", "d_loss", "d_inv_loss", "d_acc", "lr")


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _batches(method):
    out = step_batches(STEPS, HW, BATCH)
    if method == "source_only":
        out = [{"image": b["src_image"], "label": b["src_label"]}
               for b in out]
    return out


def _jax_states(method, batches, precision="f32", affine=False):
    """JAX's metrics of each step and its states before each step and
    after the last, as numpy trees (params, batch_stats, opt_state,
    step)."""
    jm = jax_build_method(JaxConfig(crop_size=HW, base_size=HW,
                                    batch_size=BATCH, precision=precision),
                          iters_per_epoch=10, method=method)
    state = jm.init_state(jax.random.PRNGKey(0))
    params = _np(state.params)
    if affine:
        params = {"G": perturb_affine(params["G"]),
                  "D": perturb_affine(params["D"], seed=3)}
    f = jnp.float64 if precision == "f64" else jnp.float32
    stats = perturb_stats(_np(state.batch_stats))
    state = state.replace(
        params=jax.tree_util.tree_map(jnp.asarray, params),
        batch_stats=jax.tree_util.tree_map(lambda a: jnp.asarray(a, f),
                                           stats))
    step = jax.jit(jm.step_fn)
    states = [(params, stats, _np(state.opt_state), 0)]
    metrics = []
    for b in batches:
        state, met = step(state, {k: jnp.asarray(v) for k, v in b.items()})
        metrics.append({k: float(v) for k, v in met.items()})
        states.append((_np(state.params), _np(state.batch_stats),
                       _np(state.opt_state), int(state.step)))
    return metrics, states


def _run(method, steps, precision="f32", affine=False):
    batches = _batches(method)[:steps]
    from_name = Policy.from_name.__func__
    with pytest.MonkeyPatch.context() as mp, \
            jax.enable_x64(precision == "f64"):
        mp.setattr(L.Dropout, "__call__", lambda self, x, deterministic: x)
        mp.setattr(Policy, "from_name", classmethod(
            lambda cls, name: cls(compute_dtype=jnp.float64)
            if name == "f64" else from_name(cls, name)))
        metrics, states = _jax_states(method, batches, precision, affine)
    with torch_threads():
        port = [port_step_from_jax(*states[i], batches[i], precision,
                                   method=method)
                for i in range(steps)]
    return metrics, states, port


@pytest.fixture(scope="module")
def feature():
    return _run("feature_adapt", STEPS)


@pytest.fixture(scope="module")
def source():
    return _run("source_only", STEPS)


@pytest.fixture(scope="module")
def feature64():
    return _run("feature_adapt", 1, precision="f64", affine=True)


def _rel(a, b):
    return float((a - b).norm() / b.norm())


def _g(state):
    return from_jax_variables(state[0]["G"], state[1]["G"])


def _d(state):
    return from_jax_domain(state[0]["D"], state[1]["D"])


def _update(start, after, keys):
    return torch.cat([(after[k].double() - start[k].double()).reshape(-1)
                      for k in keys])


def _buf(state, name, net):
    """JAX's flat SGD buffer `name` of `state`, in the port's layout."""
    params, stats = state[0], state[1]
    if net == "D":
        return flat_to_port(state[2][name]["momentum"], params["D"],
                            lambda t: from_jax_domain(t, stats["D"]),
                            domain_param_order())
    g = params["G"]
    tree = g if net == "G" else {k: g[k] for k in ("backbone", "aspp")}
    order = deeplab_param_order() if net == "G" else feature_param_order()
    return flat_to_port(state[2][name]["momentum"], tree,
                        lambda t: from_jax_variables({**g, **t}, stats["G"]),
                        order)


@pytest.mark.parametrize("i", range(STEPS))
def test_feature_metrics_match_jax(feature, i):
    metrics, _, port = feature
    assert set(port[i][0]) == set(metrics[i]) == set(METRICS)
    for k in METRICS:
        np.testing.assert_allclose(port[i][0][k], metrics[i][k], rtol=1e-4,
                                   err_msg=f"step {i} {k}")


@pytest.mark.parametrize("i", range(STEPS))
def test_feature_bn_running_stats_match_jax(feature, i):
    _, states, port = feature
    for start, want, got, n in ((_g(states[i]), _g(states[i + 1]),
                                 port[i][1], 60),
                                (_d(states[i]), _d(states[i + 1]),
                                 port[i][2], 2)):
        keys = [k for k in want
                if k.endswith(("running_mean", "running_var"))
                and not k.startswith(("backbone.low_level",
                                      "backbone.high_level"))]
        assert len(keys) == 2 * n
        for k in keys:
            w = want[k].double()
            err = float((got[k] - w).abs().max())
            assert err <= 1e-3 * float(w.abs().max()), (k, err)
        assert any(not torch.equal(start[k], want[k]) for k in keys)


@pytest.mark.parametrize("i", range(STEPS))
def test_feature_updates_match_jax(feature, i):
    _, states, port = feature
    for start, after, got, keys in (
            (_g(states[i]), _g(states[i + 1]), port[i][1],
             deeplab_param_order()),
            (_d(states[i]), _d(states[i + 1]), port[i][2],
             domain_param_order())):
        want = _update(start, after, keys)
        mine = _update(start, got, keys)
        assert float(want.norm()) > 0 and _rel(mine, want) <= 5e-2, \
            _rel(mine, want)


@pytest.mark.parametrize("i", range(STEPS))
def test_feature_d_inv_and_c_buffers_match_jax(feature, i):
    _, states, port = feature
    want = _buf(states[i + 1], "d_inv", "f").double()
    got = port[i][3]["d_inv"]["momentum"]
    assert got.shape == want.shape and _rel(got, want) <= 5e-2, \
        _rel(got, want)
    c = _buf(states[i + 1], "c", "G").double()
    assert float(c.abs().max()) == 0.0
    assert torch.equal(port[i][3]["c"]["momentum"], c)


def test_feature_step_has_no_lr_groups(feature):
    """From zero buffers SGD steps by lr x its buffer: the decoder by the
    'task' buffer alone (1x, not the output method's 10x), f = backbone +
    ASPP by 'task' and then 'd_inv'.  The float32 parameters round each
    update: a leaf within 0.2 (a 10x group is off by 9; measured <= 6.3e-2
    on BatchNorm scales near 1, whose updates are a few dozen ulps), all
    of G within 1e-3 (measured 1.7e-5)."""
    metrics, states, port = feature
    lr = metrics[0]["lr"]
    start, after, opt = _g(states[0]), port[0][1], port[0][3]
    task = dict(zip(deeplab_param_order(), opt["task"]["momentum"].split(
        [start[k].numel() for k in deeplab_param_order()])))
    inv = dict(zip(feature_param_order(), opt["d_inv"]["momentum"].split(
        [start[k].numel() for k in feature_param_order()])))
    want = {k: -lr * (task[k] + inv.get(k, 0.0))
            for k in deeplab_param_order()}
    got = {k: (after[k] - start[k].double()).reshape(-1) for k in want}
    errs = {k: _rel(got[k], want[k]) for k in want}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 0.2, (worst, errs[worst])
    flat = [torch.cat(list(t.values())) for t in (got, want)]
    assert _rel(*flat) <= 1e-3, _rel(*flat)
    assert any(k.startswith("decoder.") for k in want)


@pytest.mark.parametrize("i", range(STEPS))
def test_source_only_matches_jax(source, i):
    metrics, states, port = source
    for k in METRICS:
        np.testing.assert_allclose(port[i][0][k], metrics[i][k], rtol=1e-4,
                                   err_msg=f"step {i} {k}")
    start, after = _g(states[i]), _g(states[i + 1])
    keys = deeplab_param_order()
    want, got = _update(start, after, keys), _update(start, port[i][1], keys)
    assert _rel(got, want) <= 5e-2, _rel(got, want)
    stats = [k for k in after if k.endswith(("running_mean", "running_var"))
             and k.startswith(("backbone.features.", "aspp.", "decoder."))]
    assert len(stats) == 2 * 60
    for k in stats:
        w = after[k].double()
        assert float((port[i][1][k] - w).abs().max()) \
            <= 1e-3 * float(w.abs().max()), k


@pytest.mark.parametrize("i", range(STEPS))
def test_source_only_leaves_d_untouched(source, i):
    metrics, states, port = source
    assert port[i][0]["d_loss"] == port[i][0]["d_inv_loss"] == \
        port[i][0]["d_acc"] == 0.0
    start = _d(states[i])
    for k, v in start.items():
        assert torch.equal(port[i][2][k], v.double()), k
    for name in ("d", "d_inv", "c"):
        assert float(port[i][3][name]["momentum"].abs().max()) == 0.0, name
    assert float(port[i][3]["task"]["momentum"].abs().max()) > 0


def test_f64_feature_metrics_match_jax(feature64):
    metrics, _, port = feature64
    for k in METRICS:
        np.testing.assert_allclose(port[0][0][k], metrics[0][k], rtol=1e-5,
                                   err_msg=k)


@pytest.mark.parametrize("net", ["G", "D"])
def test_f64_feature_gradient_per_leaf_matches_jax(feature64, net):
    """The gradient of task + d + d_inv per leaf, from the first step's SGD
    buffer (gradient + weight decay x parameter), in float64.  Leaves the
    float32 buffer leaves unresolved are out, on both sides alike (the
    rule of tests/test_torch_port_train_step_f64.py)."""
    _, states, port = feature64
    if net == "G":
        before, order, name = _g(states[0]), deeplab_param_order(), "task"
    else:
        before, order, name = _d(states[0]), domain_param_order(), "d"
    want = sgd_gradients(_buf(states[1], name, net), before, WD, order=order)
    got = sgd_gradients(port[0][3][name]["momentum"], before, WD,
                        order=order)
    zero = {k for k in want if want[k] is None}
    assert zero == {k for k in got if got[k] is None}
    errs = {k: _rel(got[k], want[k]) for k in order if k not in zero}
    worst = max(errs, key=errs.get)
    assert errs[worst] <= 1e-5, (worst, errs[worst])

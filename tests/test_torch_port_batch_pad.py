"""Masked batch padding in the port (`pad_to` of the step factories,
models/layers.py ``bn_real_batch``) against the unpadded steps and the JAX
package's padded step, on the CPU.

- The padded steps of all three methods (3 real samples padded to 4,
  64x64, float32, dropout on) against the unpadded ones, at
  tests/test_batch_pad.py's bounds: parameters rtol 1e-2 atol 2e-3,
  running statistics rtol 1e-2 atol 1e-4, metrics rtol 1e-4 atol 1e-5;
  and bit-equal, the dropout generator's state (the padded step draws the
  real rows' masks at [3, ...], as the unpadded step does).
- The masked BatchNorm chain (conv, BN, relu6, conv, BN) in float64: the
  padded batch's gradients and running statistics equal the unpadded
  batch's to 1e-10 (tests/test_batch_pad.py:127), and the JAX package's
  padded chain's.  The padding rows' dx is the affine's, g * inv (zero
  here): the kernels' dx over all rows would give them a nonzero dx,
  which the second conv's weight gradient would pick up.
- One padded output step in float64 against the JAX package's padded step
  (its ``_step_pad_to`` monkeypatched, as its own test reaches it),
  dropout off, from JAX's state with BatchNorm statistics, scale and bias
  perturbed, at tests/test_torch_port_train_step_f64.py's bounds.
- ``_step_pad_to`` gives None off a TPU, and a mesh of two processes
  builds a padded step (tests/test_torch_port_uneven.py steps one).
"""

import numpy as np
import pytest

import flax.linen as fnn
import jax
import jax.numpy as jnp
import torch
import torch.nn as nn

from s2r_tpu.models import layers as JL
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.core.mesh import Mesh
from s2r_tpu_torch.models.layers import (BatchNorm, Conv2d, bn_real_batch,
                                         relu6)
from s2r_tpu_torch.train import setup as S
from s2r_tpu_torch.train.steps import (make_feature_adapt_step,
                                       make_output_adapt_step)

from _torch_port_common import (check_port_step, jax_f64_output_step,
                                perturb_affine, port_step_from_jax,
                                torch_threads)

CROP, K, PAD = 64, 3, 4


def _batch(source_only, hw=CROP, seed=0):
    rng = np.random.RandomState(seed)
    img = lambda: rng.randn(K, hw, hw, 3).astype(np.float32)  # noqa: E731
    lbl = lambda: rng.randint(0, 19, (K, hw, hw)).astype(np.int32)  # noqa
    if source_only:
        return {"image": img(), "label": lbl()}
    return {"src_image": img(), "src_label": lbl(), "tgt_image": img()}


def _step(method, pad_to, monkeypatch):
    monkeypatch.setattr(S, "_step_pad_to", lambda cfg, n: pad_to)
    m = S.build_method(Config(precision="f32", crop_size=CROP,
                              base_size=CROP, batch_size=K,
                              dataset="synthetic"),
                       10, method=method, device="cpu")
    state = m.init_state()
    with torch_threads():
        state, met = m.step_fn(state, _batch(method == "source_only"))
    return ({k: float(v) for k, v in met.items()},
            {k: v.detach().clone() for k, v in state.G.state_dict().items()},
            {k: v.detach().clone() for k, v in state.D.state_dict().items()},
            state.generator.get_state())


@pytest.mark.parametrize("method", ["output_adapt", "feature_adapt",
                                    "source_only"])
def test_padded_step_matches_unpadded(method, monkeypatch):
    plain = _step(method, None, monkeypatch)
    padded = _step(method, PAD, monkeypatch)
    for k in plain[0]:
        np.testing.assert_allclose(padded[0][k], plain[0][k], rtol=1e-4,
                                   atol=1e-5, err_msg=k)
    for i in (1, 2):
        for k, v in plain[i].items():
            stat = "running" in k or "num_batches" in k
            np.testing.assert_allclose(
                padded[i][k].double().numpy(), v.double().numpy(),
                rtol=1e-2, atol=1e-4 if stat else 2e-3, err_msg=k)
            if "num_batches" in k:
                assert torch.equal(padded[i][k], v), k
    assert torch.equal(padded[3], plain[3])


class _JaxTiny(fnn.Module):
    @fnn.compact
    def __call__(self, x):
        x = JL.Conv2d(8, 3, padding=1, dtype=jnp.float64)(x)
        x = JL.BatchNorm(dtype=jnp.float64)(x, False)
        x = JL.relu6(x)
        x = JL.Conv2d(4, 3, padding=1, dtype=jnp.float64)(x)
        return JL.BatchNorm(dtype=jnp.float64)(x, False)


class _Tiny(nn.Module):
    def __init__(self):
        super().__init__()
        self.c1, self.b1 = Conv2d(5, 8, 3, padding=1), BatchNorm(8)
        self.c2, self.b2 = Conv2d(8, 4, 3, padding=1), BatchNorm(4)

    def forward(self, x):
        return self.b2(self.c2(relu6(self.b1(self.c1(x)))))


def test_masked_bn_grads_exact_f64():
    rng = np.random.RandomState(0)
    xk = rng.randn(K, 8, 8, 5)
    jm = _JaxTiny()
    with jax.enable_x64(True):
        v = jm.init({"params": jax.random.PRNGKey(0)}, jnp.asarray(xk))
        params = jax.tree_util.tree_map(
            lambda a: np.asarray(a, np.float64),
            perturb_affine(jax.tree_util.tree_map(np.asarray, v["params"])))
        bs = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                    v["batch_stats"])
        xpad = np.concatenate([xk, np.zeros((2,) + xk.shape[1:])])

        def loss_pad(p):
            with JL.bn_real_batch(K):
                y, upd = jm.apply({"params": p, "batch_stats": bs},
                                  jnp.asarray(xpad), mutable=["batch_stats"])
            return jnp.sum(y[:K] ** 2), upd["batch_stats"]

        (jl, jbs), jg = jax.value_and_grad(loss_pad, has_aux=True)(
            jax.tree_util.tree_map(jnp.asarray, params))
        jg = jax.tree_util.tree_map(np.asarray, jg)
        jbs = jax.tree_util.tree_map(np.asarray, jbs)

    names = (("Conv2d_0", "c1"), ("BatchNorm_0", "b1"), ("Conv2d_1", "c2"),
             ("BatchNorm_1", "b2"))

    def port(tree):  # a JAX tree (params or gradients) -> the port's keys
        out = {}
        for jn, pn in names:
            for leaf, val in tree[jn].items():
                key = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
                val = np.asarray(val, np.float64)
                if leaf == "kernel":
                    val = val.transpose(3, 2, 0, 1)
                out[f"{pn}.{key}"] = torch.from_numpy(val.copy())
        return out

    results = []
    for pad in (False, True):
        model = _Tiny().double().train()
        model.load_state_dict(port(params), strict=False)
        x = torch.from_numpy(xpad if pad else xk).permute(0, 3, 1, 2)
        with bn_real_batch(K if pad else None):
            y = model(x)
        loss = (y[:K] ** 2).sum()
        grads = dict(zip([k for k, _ in model.named_parameters()],
                         torch.autograd.grad(loss, list(model.parameters()))))
        results.append((float(loss.detach()), grads, {
            k: v.clone() for k, v in model.state_dict().items()
            if "running" in k}))
    (l0, g0, s0), (l1, g1, s1) = results
    np.testing.assert_allclose(l1, l0, rtol=1e-12)
    np.testing.assert_allclose(l1, float(jl), rtol=1e-12)
    want = port(jg)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-10, atol=1e-12)
        torch.testing.assert_close(g1[k], want[k], rtol=1e-10, atol=1e-12)
    for jn, pn in (("BatchNorm_0", "b1"), ("BatchNorm_1", "b2")):
        for jk, pk in (("mean", "running_mean"), ("var", "running_var")):
            key = f"{pn}.{pk}"
            torch.testing.assert_close(s1[key], s0[key], rtol=1e-10,
                                       atol=1e-12)
            np.testing.assert_allclose(s1[key].numpy(), jbs[jn][jk],
                                       rtol=1e-10, atol=1e-12)


HW64 = 64


def test_padded_output_step_matches_jax_f64(monkeypatch):
    """One padded output step from JAX's state, both sides in float64
    (_torch_port_common.check_port_step's bounds)."""
    batch = _batch(False, HW64, seed=7)
    batch["src_label"][:, :4] = 255
    jax_step = jax_f64_output_step(batch, HW64, K, pad_to=PAD)
    monkeypatch.setattr(S, "_step_pad_to", lambda cfg, n: PAD)
    with torch_threads():
        port = port_step_from_jax(*jax_step[:3], 0, batch, "f64")
    check_port_step(jax_step, port)


def test_step_pad_to_is_off_here_and_a_mesh_refuses_it():
    assert S._step_pad_to(Config(), 1) is None
    assert S._step_pad_to(Config(batch_pad="off", batch_size=3), 1) is None
    m = S.build_method(Config(precision="f32"), 10, method="output_adapt",
                       device="cpu")
    from s2r_tpu_torch.train import optim as po
    from s2r_tpu_torch.train import losses as pl
    # a mesh of two processes takes pad_to now (ROADMAP A.9 is done;
    # tests/test_torch_port_uneven.py steps it against the JAX package)
    two = Mesh(2, 0)
    assert callable(make_output_adapt_step(
        m.deeplab, m.aux_model, po.SGD(), po.Adam(), lambda s: 1e-3,
        pl.cross_entropy, pad_to=8, mesh=two))
    f = S.build_method(Config(precision="f32"), 10, method="feature_adapt",
                       device="cpu")
    assert callable(make_feature_adapt_step(
        f.deeplab, f.aux_model, po.SGD(), po.SGD(), po.SGD(),
        lambda s: 1e-3, pl.cross_entropy, pad_to=8, mesh=two))

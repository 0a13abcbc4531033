"""The port's training layers, discriminator, losses, optimizers and
schedules against the JAX package's, on the CPU in float32.

- Kink rules: the gradients of relu, relu6 and leaky_relu at exactly 0 and
  6 equal jax.grad of the JAX package's functions (bit for bit).
- Dropout: keep rate within 5 binomial standard deviations, kept values
  scaled by 1/keep, the same mask forward and backward, the same mask from
  the same generator seed, the identity in eval and when switched off.
- FCDiscriminator: forward and parameter gradients against JAX's, with its
  Pallas conv1 on (interpret) and off; atol 1e-5 on outputs of order 0.1,
  rtol 1e-4 on gradients (float32 convs in another order).
- Weight conversion and the JAX flatten order of the parameters.
- Losses rtol 1e-6, optimizers over 3 updates rtol 1e-6 / atol 1e-9, and
  the learning-rate schedules rtol 1e-6: the same float32 formulas.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from s2r_tpu.models import layers as L
from s2r_tpu.models.discriminator import FCDiscriminator as JaxFCD
from s2r_tpu.ops.pallas import disc_conv as jax_disc_conv
from s2r_tpu.train import losses as jl
from s2r_tpu.train import optim as jo
from s2r_tpu.train.lr_schedule import make_lr_schedule as jax_schedule
from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                      discriminator_param_order,
                                      from_jax_discriminator,
                                      from_jax_variables)
from s2r_tpu_torch.models.discriminator import FCDiscriminator
from s2r_tpu_torch.models.layers import (Dropout, leaky_relu, relu, relu6,
                                         set_dropout)
from s2r_tpu_torch.train import losses as pl
from s2r_tpu_torch.train import optim as po
from s2r_tpu_torch.train.lr_schedule import make_lr_schedule

from _torch_port_common import jax_deeplab

KINKS = np.array([-1.0, 0.0, 0.5, 6.0, 7.0, -0.0], np.float32)


@pytest.mark.parametrize("name", ["relu", "relu6", "leaky_relu"])
def test_kink_gradients_match_jax(name):
    jf = {"relu": L.relu, "relu6": L.relu6,
          "leaky_relu": lambda x: L.leaky_relu(x, 0.2)}[name]
    pf = {"relu": relu, "relu6": relu6,
          "leaky_relu": lambda x: leaky_relu(x, 0.2)}[name]
    want = np.asarray(jax.grad(lambda x: jnp.sum(jf(x)))(jnp.asarray(KINKS)))
    x = torch.from_numpy(KINKS.copy()).requires_grad_()
    y = pf(x)
    y.sum().backward()
    np.testing.assert_array_equal(y.detach().numpy(), np.asarray(jf(KINKS)))
    np.testing.assert_array_equal(x.grad.numpy(), want)


def test_kink_rules_are_jax_not_clamp():
    x = torch.tensor([0.0, 6.0], requires_grad=True)
    relu6(x).sum().backward()
    assert x.grad.tolist() == [0.0, 0.0]
    x = torch.tensor([0.0], requires_grad=True)
    relu(x).sum().backward()
    assert x.grad.tolist() == [0.5]


@pytest.mark.parametrize("rate", [0.5, 0.1])
def test_dropout_rate_scale_and_mask(rate):
    keep = 1.0 - rate
    drop = Dropout(rate).train()
    x = (torch.rand(200_000) + 0.5).requires_grad_()
    y = drop(x, torch.Generator().manual_seed(0))
    kept = y != 0
    n = x.numel()
    assert abs(float(kept.sum()) - keep * n) <= 5 * (n * keep * rate) ** 0.5
    torch.testing.assert_close(y[kept], x[kept] / keep, rtol=0, atol=0)
    y.sum().backward()
    assert torch.equal(x.grad != 0, kept)
    torch.testing.assert_close(x.grad[kept],
                               torch.full_like(x.grad[kept], 1.0 / keep))
    again = drop(x.detach(), torch.Generator().manual_seed(0))
    assert torch.equal(again != 0, kept)
    other = drop(x.detach(), torch.Generator().manual_seed(1))
    assert not torch.equal(other != 0, kept)


def test_dropout_identity_in_eval_and_when_off():
    x = torch.randn(1000)
    drop = Dropout(0.5)
    assert torch.equal(drop.eval()(x), x)
    drop.train()
    set_dropout(drop, False)
    assert torch.equal(drop(x), x)
    set_dropout(drop, True)
    assert not torch.equal(drop(x), x)


@pytest.fixture(scope="module")
def discriminators():
    jd = JaxFCD(num_classes=19)
    x = jnp.zeros((1, 64, 64, 19), jnp.float32)
    params = jax.tree_util.tree_map(
        np.asarray, jd.init(jax.random.PRNGKey(3), x)["params"])
    pd = FCDiscriminator(num_classes=19, device="cpu")
    pd.load_state_dict(from_jax_discriminator(params), strict=True)
    return params, pd


@pytest.mark.parametrize("pallas", [True, False])
def test_discriminator_matches_jax(discriminators, pallas, monkeypatch):
    params, pd = discriminators
    monkeypatch.setattr(jax_disc_conv, "INTERPRET", True)
    jd = JaxFCD(num_classes=19, pallas_wminor_conv1=pallas)
    rng = np.random.RandomState(1)
    x = jax.nn.softmax(jnp.asarray(rng.randn(2, 64, 64, 19), jnp.float32),
                       axis=0)
    g = rng.randn(2, 2, 2, 1).astype(np.float32)

    def loss(p):
        return jnp.sum(jd.apply({"params": p}, x) * g)

    want = np.asarray(jd.apply({"params": params}, x))
    grads = from_jax_discriminator(jax.grad(loss)(params))
    pd.zero_grad()
    got = pd(torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2))
    assert got.shape == (2, 1, 2, 2)
    np.testing.assert_allclose(got.detach().permute(0, 2, 3, 1).numpy(),
                               want, rtol=0, atol=1e-5)
    (got * torch.from_numpy(g).permute(0, 3, 1, 2)).sum().backward()
    for name, p in pd.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads[name].numpy(),
                                   rtol=1e-4, atol=1e-6, err_msg=name)


def test_discriminator_init_is_torch_default():
    pd = FCDiscriminator(device="cpu",
                         generator=torch.Generator().manual_seed(0))
    for name in ("conv1", "classifier"):
        conv = getattr(pd, name)
        bound = 1.0 / conv.weight[0].numel() ** 0.5
        for p in (conv.weight, conv.bias):
            assert float(p.abs().max()) <= bound
        assert float(conv.weight.abs().max()) > 0.9 * bound


def test_param_order_is_jax_flatten_order(discriminators):
    """The i-th name holds the i-th leaf jax.tree flattens, for both
    networks."""
    params, pd = discriminators
    sd = pd.state_dict()
    leaves = jax.tree_util.tree_leaves(params)
    names = discriminator_param_order()
    assert len(names) == len(leaves) == len(dict(pd.named_parameters()))
    for name, leaf in zip(names, leaves):
        want = np.transpose(leaf, (3, 2, 0, 1)) if leaf.ndim == 4 else leaf
        np.testing.assert_array_equal(sd[name].numpy(), want)
    _, gparams, gstats = jax_deeplab(33)
    gsd = from_jax_variables(gparams, gstats)
    gleaves = jax.tree_util.tree_leaves(gparams)
    gnames = deeplab_param_order()
    assert len(gnames) == len(gleaves)
    for name, leaf in zip(gnames, gleaves):
        want = np.transpose(leaf, (3, 2, 0, 1)) if leaf.ndim == 4 else leaf
        np.testing.assert_array_equal(gsd[name].numpy(), want, err_msg=name)


def _logits(seed=0, n=2, c=19, hw=(9, 11)):
    rng = np.random.RandomState(seed)
    x = (rng.randn(n, *hw, c) * 3).astype(np.float32)
    lbl = rng.randint(0, c, (n, *hw)).astype(np.int32)
    lbl[0, :2] = 255
    lbl[1, 0, :3] = -1
    return x, lbl


@pytest.mark.parametrize("weighted", [False, True])
def test_cross_entropy_and_focal_match_jax(weighted):
    x, lbl = _logits()
    w = np.random.RandomState(5).rand(19).astype(np.float32) + 0.5
    jw = jnp.asarray(w) if weighted else None
    tw = torch.from_numpy(w) if weighted else None
    xt = torch.from_numpy(x).permute(0, 3, 1, 2)
    lt = torch.from_numpy(lbl)
    np.testing.assert_allclose(
        float(pl.cross_entropy(xt, lt, tw)),
        float(jl.cross_entropy(jnp.asarray(x), jnp.asarray(lbl), jw)),
        rtol=1e-6)
    np.testing.assert_allclose(
        float(pl.focal_loss(xt, lt, tw)),
        float(jl.focal_loss(jnp.asarray(x), jnp.asarray(lbl), jw)),
        rtol=1e-6)


def test_cross_entropy_gradient_matches_jax():
    x, lbl = _logits(1)
    want = jax.grad(lambda a: jl.cross_entropy(a, jnp.asarray(lbl)))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).requires_grad_()
    pl.cross_entropy(xt, torch.from_numpy(lbl)).backward()
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(),
                               np.asarray(want), rtol=1e-5, atol=1e-9)


@pytest.mark.parametrize("target", [0.0, 1.0])
def test_bce_with_logits_matches_jax(target):
    x = np.array([-30.0, -2.0, 0.0, 0.0, 1.5, 40.0], np.float32)
    want = jl.bce_with_logits(jnp.asarray(x), target)
    gwant = jax.grad(lambda a: jl.bce_with_logits(a, target))(jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_()
    got = pl.bce_with_logits(xt, target)
    got.backward()
    np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(gwant), rtol=1e-6,
                               atol=1e-12)


def test_domain_loss_matches_jax():
    rng = np.random.RandomState(2)
    s = rng.randn(2, 5, 6, 2).astype(np.float32)
    t = rng.randn(2, 5, 6, 2).astype(np.float32)
    want = jl.domain_loss(jnp.asarray(s), jnp.asarray(t))
    got = pl.domain_loss(torch.from_numpy(s).permute(0, 3, 1, 2),
                         torch.from_numpy(t).permute(0, 3, 1, 2))
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)


def _tree(seed):
    rng = np.random.RandomState(seed)
    return {"a": rng.randn(3, 4).astype(np.float32),
            "b": rng.randn(5).astype(np.float32)}


def _leaves(tree):
    return [torch.from_numpy(tree[k].copy()) for k in sorted(tree)]


@pytest.mark.parametrize("name,jopt,popt", [
    ("sgd", jo.SGD(0.9, 5e-4, False), po.SGD(0.9, 5e-4, False)),
    ("sgd_nesterov", jo.SGD(0.9, 5e-4, True), po.SGD(0.9, 5e-4, True)),
    ("adam", jo.Adam(0.9, 0.99), po.Adam(0.9, 0.99)),
    ("adam_wd", jo.Adam(0.9, 0.999, 1e-8, 1e-2), po.Adam(0.9, 0.999, 1e-8,
                                                          1e-2)),
])
def test_optimizers_match_jax_over_three_updates(name, jopt, popt):
    """The JAX package's per-leaf rules against the port's
    FusedOptimizer (the only way the port applies them), with lr_mult."""
    jp = {k: jnp.asarray(v) for k, v in _tree(0).items()}
    pp = [torch.nn.Parameter(t) for t in _leaves(_tree(0))]
    pf = po.FusedOptimizer(popt, pp, [1.0, 10.0])
    js, ps = jopt.init(jp), pf.init(pp)
    for i in range(3):
        g = _tree(10 + i)
        steps, js = jopt.direction({k: jnp.asarray(v) for k, v in g.items()},
                                   js, jp)
        jp = jo.apply_updates(jp, steps, 1e-2, {"a": 1.0, "b": 10.0})
        ps = pf.apply(_leaves(g), ps, pp, 1e-2)
    for k, t in zip(sorted(jp), pp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)


@pytest.mark.parametrize("opt", ["sgd", "adam"])
def test_fused_optimizer_matches_jax_over_three_updates(opt):
    jopt = jo.SGD(0.9, 5e-4, True) if opt == "sgd" else jo.Adam(0.9, 0.99)
    popt = po.SGD(0.9, 5e-4, True) if opt == "sgd" else po.Adam(0.9, 0.99)
    jp = {k: jnp.asarray(v) for k, v in _tree(1).items()}
    pp = [torch.nn.Parameter(t) for t in _leaves(_tree(1))]
    jf = jo.FusedOptimizer(jopt, jp, {"a": 1.0, "b": 10.0})
    pf = po.FusedOptimizer(popt, pp, [1.0, 10.0])
    js, ps = jf.init(jp), pf.init(pp)
    for i in range(3):
        g = _tree(20 + i)
        lr = 5e-3 * (1 + i)
        jp, js = jf.apply({k: jnp.asarray(v) for k, v in g.items()}, js, jp,
                          lr)
        ps = pf.apply(_leaves(g), ps, pp, lr)
    for k, t in zip(sorted(jp), pp):
        np.testing.assert_allclose(t.detach().numpy(), np.asarray(jp[k]),
                                   rtol=1e-6, atol=1e-9, err_msg=k)
    flat_state = {"sgd": "momentum", "adam": "m"}[opt]
    np.testing.assert_allclose(ps[flat_state].numpy(),
                               np.asarray(js[flat_state]), rtol=1e-6,
                               atol=1e-9)


@pytest.mark.parametrize("mode,lr_step,warmup", [
    ("poly", 0, 0), ("poly", 0, 2), ("cos", 0, 1), ("step", 3, 0),
    ("step", 2, 1)])
def test_lr_schedules_match_jax(mode, lr_step, warmup):
    jf = jax_schedule(mode, 5e-4, 10, 7, lr_step, warmup)
    pf = make_lr_schedule(mode, 5e-4, 10, 7, lr_step, warmup)
    for step in (0, 1, 6, 7, 13, 20, 35, 69, 70, 75):
        np.testing.assert_allclose(float(pf(step)), float(jf(step)),
                                   rtol=1e-6, err_msg=f"step {step}")


def test_freeze_bn_keeps_batchnorm_and_dropout_in_eval():
    """DeepLab(freeze_bn=True).train(): every submodule stays in eval, as
    the JAX package hands `train and not freeze_bn` to every layer."""
    from s2r_tpu_torch.models.deeplab import DeepLab
    from s2r_tpu_torch.models.layers import BatchNorm

    model = DeepLab(device="cpu", freeze_bn=True).train()
    assert model.training
    assert not any(m.training for m in model.modules()
                   if isinstance(m, (BatchNorm, Dropout)))
    model = DeepLab(device="cpu").train()
    assert all(m.training for m in model.modules()
               if isinstance(m, (BatchNorm, Dropout)))


def test_unported_options_raise():
    from s2r_tpu_torch.config import Config
    from s2r_tpu_torch.core.mesh import Mesh
    from s2r_tpu_torch.train.setup import build_method
    from s2r_tpu_torch.train.steps import (make_feature_adapt_step,
                                           make_output_adapt_step)

    cfg = Config(precision="f32")
    # the other backbones are ported: xception builds (it raised before)
    x = build_method(Config(backbone="xception"), 10,
                     method="feature_adapt", device="cpu")
    assert x.deeplab.backbone_name == "xception"
    assert x.deeplab.decoder.conv1.in_channels == 128
    # batch padding is ported (tests/test_torch_port_batch_pad.py), under
    # a mesh of more than one process too (tests/test_torch_port_uneven.py)
    two = Mesh(2, 0)
    m = build_method(cfg, 10, method="output_adapt", device="cpu")
    assert callable(make_output_adapt_step(
        m.deeplab, m.aux_model, po.SGD(), po.Adam(), lambda s: 1e-3,
        pl.cross_entropy, pad_to=8))
    assert callable(make_output_adapt_step(
        m.deeplab, m.aux_model, po.SGD(), po.Adam(), lambda s: 1e-3,
        pl.cross_entropy, pad_to=8, mesh=two))
    f = build_method(cfg, 10, method="feature_adapt", device="cpu")
    assert callable(make_feature_adapt_step(
        f.deeplab, f.aux_model, po.SGD(), po.SGD(), po.SGD(),
        lambda s: 1e-3, pl.cross_entropy, pad_to=8))
    assert callable(make_feature_adapt_step(
        f.deeplab, f.aux_model, po.SGD(), po.SGD(), po.SGD(),
        lambda s: 1e-3, pl.cross_entropy, pad_to=8, mesh=two))

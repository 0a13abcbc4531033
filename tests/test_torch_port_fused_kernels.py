"""The port's third kernel slice on the CPU: the tensor-core disc_conv1's
packed operand, the BatchNorm kernel entries, and the batch split that
lifts the 32-bit per-launch limit.

On the CPU each wrapper takes its plain PyTorch version (the CUDA kernels
run only on the card, through chip_smoke.py); the JAX side runs its Pallas
kernels in interpret mode.  Inputs come from seeded numpy generators.

Tolerances, all float32: the disc conv as an im2col product against the
Pallas kernel 1e-5 (16*C products summed in another order); BatchNorm sums
and statistics rtol 1e-5, y and dx atol 1e-5 on values of order 1-10 (the
same formulas rounded in another order), gradients through the ring rtol
1e-4 (the Pallas backward form against autodiff, as
tests/test_torch_port_train_kernels.py holds the module); the batch split
bit for bit (the same per-item arithmetic).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from s2r_tpu.models.layers import BatchNorm as JaxBatchNorm
from s2r_tpu.ops.pallas.batchnorm import batch_norm_train as jax_bn_train
from s2r_tpu.ops.pallas.disc_conv import disc_conv1 as jax_disc_conv1
from s2r_tpu_torch.ops.kernels import batchnorm as bnk
from s2r_tpu_torch.ops.kernels import build, depthwise, requant
from s2r_tpu_torch.ops.kernels.disc_conv import pack_kernel


# --- disc_conv1: the packed (kh, ci, kw) operand ---------------------------

def _im2col_kh_ci_kw(x):
    """x [N,H,C,W] -> [N*(H/2)*(W/2), 16*C] patches of the 4x4/s2/p1 conv,
    column k = (kh*C + ci)*4 + kw."""
    n, h, c, w = x.shape
    oh, ow = h // 2, w // 2
    xp = torch.nn.functional.pad(x, (1, 1, 0, 0, 1, 1))  # W, then H
    taps = torch.stack([torch.stack([xp[:, kh:kh + 2 * oh:2, :, kw:kw + 2 * ow:2]
                                     for kw in range(4)], -1)
                        for kh in range(4)], 3)  # [N, OH, C, kh, OW, kw]
    return taps.permute(0, 1, 4, 3, 2, 5).reshape(n * oh * ow, 16 * c)


@pytest.mark.parametrize("n,h,c,w", [(2, 16, 19, 32), (1, 10, 6, 14)])
def test_packed_operand_times_im2col_matches_pallas(n, h, c, w):
    rng = np.random.RandomState(10 + c)
    x = rng.randn(n, h, c, w).astype(np.float32)
    k = (rng.randn(4, 4, c, 64) * 0.1).astype(np.float32)
    b = (rng.randn(64) * 0.1).astype(np.float32)
    want = np.asarray(jax_disc_conv1(jnp.asarray(x), jnp.asarray(k),
                                     jnp.asarray(b), True))
    packed = pack_kernel(torch.from_numpy(k))
    assert packed.shape == (16 * c, 64) and packed.is_contiguous()
    got = (_im2col_kh_ci_kw(torch.from_numpy(x)) @ packed
           + torch.from_numpy(b)).view(n, h // 2, w // 2, 64)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_pack_kernel_row_order():
    c = 5
    k = torch.arange(16 * c * 8, dtype=torch.float32).view(4, 4, c, 8)
    packed = pack_kernel(k)
    for kh in range(4):
        for ci in range(c):
            for kw in range(4):
                assert torch.equal(packed[(kh * c + ci) * 4 + kw],
                                   k[kh, kw, ci])
    with pytest.raises(ValueError):
        pack_kernel(torch.zeros(3, 3, c, 8))


# --- BatchNorm: the four entries --------------------------------------------

def _bn_inputs(seed, shape=(2, 4, 8, 16)):
    rng = np.random.RandomState(seed)
    c = shape[-1]
    x = (rng.randn(*shape) * 2 + 1).astype(np.float32)
    scale = (rng.rand(c) + 0.5).astype(np.float32)
    bias = rng.randn(c).astype(np.float32)
    g = rng.randn(*shape).astype(np.float32)
    return x, scale, bias, g


def _jax_bn(x, scale, bias, g):
    def loss(x, s, b):
        y, _, _ = jax_bn_train(x, s, b, 1e-5, True)
        return jnp.sum(y * g)

    out = jax_bn_train(jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias),
                       1e-5, True)
    grads = jax.grad(loss, argnums=(0, 1, 2))(
        jnp.asarray(x), jnp.asarray(scale), jnp.asarray(bias))
    return [np.asarray(v) for v in out], [np.asarray(v) for v in grads]


def test_batch_norm_stats_matches_pallas():
    x, scale, bias, g = _bn_inputs(20)
    (_, mean_j, var_j), _ = _jax_bn(x, scale, bias, g)
    c = x.shape[-1]
    rows = torch.from_numpy(x).view(-1, c)
    st = bnk.batch_norm_stats(rows, torch.from_numpy(scale),
                              torch.from_numpy(bias), rows.shape[0], 1e-5)
    assert st.shape == (bnk.STAT_ROWS, c) and st.dtype == torch.float32
    np.testing.assert_allclose(st[bnk.MEAN].numpy(), mean_j, rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(st[bnk.VAR].numpy(), var_j, rtol=1e-5)
    rstd = 1 / np.sqrt(var_j + 1e-5)
    np.testing.assert_allclose(st[bnk.RSTD].numpy(), rstd, rtol=1e-5)
    np.testing.assert_allclose(st[bnk.INV].numpy(), rstd * scale, rtol=1e-5)
    np.testing.assert_allclose(st[bnk.SHIFT].numpy(),
                               bias - mean_j * rstd * scale, atol=1e-5)
    np.testing.assert_allclose(st[bnk.SUM_X].numpy(), x.reshape(-1, c).sum(0),
                               rtol=1e-5, atol=1e-4)


def test_batch_norm_apply_matches_pallas():
    x, scale, bias, g = _bn_inputs(21)
    (y_j, _, _), _ = _jax_bn(x, scale, bias, g)
    rows = torch.from_numpy(x).view(-1, x.shape[-1])
    st = bnk.batch_norm_stats(rows, torch.from_numpy(scale),
                              torch.from_numpy(bias), rows.shape[0], 1e-5)
    y = bnk.batch_norm_apply(rows, st[bnk.INV], st[bnk.SHIFT])
    assert y.dtype == torch.float32 and y.shape == rows.shape
    np.testing.assert_allclose(y.view(x.shape).numpy(), y_j, rtol=0,
                               atol=1e-5)


def test_batch_norm_apply_rounds_once_in_bf16():
    """bf16 x: the affine in float32, one rounding to bf16 at the end."""
    rng = np.random.RandomState(22)
    x = torch.from_numpy(rng.randn(40, 16).astype(np.float32)).bfloat16()
    inv = torch.from_numpy(rng.rand(16).astype(np.float32) + 0.5)
    shift = torch.from_numpy(rng.randn(16).astype(np.float32))
    y = bnk.batch_norm_apply(x, inv, shift)
    assert y.dtype == torch.bfloat16
    assert torch.equal(y, (x.float() * inv + shift).bfloat16())


def test_batch_norm_grad_sums_and_dx_match_pallas_vjp():
    x, scale, bias, g = _bn_inputs(23)
    _, (gx_j, gs_j, gb_j) = _jax_bn(x, scale, bias, g)
    c = x.shape[-1]
    rows = torch.from_numpy(x).view(-1, c)
    grows = torch.from_numpy(g).view(-1, c)
    st = bnk.batch_norm_stats(rows, torch.from_numpy(scale),
                              torch.from_numpy(bias), rows.shape[0], 1e-5)
    gr = bnk.batch_norm_grad_sums(grows, rows, st, None, rows.shape[0])
    assert gr.shape == (bnk.GRAD_ROWS, c) and gr.dtype == torch.float32
    np.testing.assert_allclose(gr[bnk.DWEIGHT].numpy(), gs_j, rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(gr[bnk.DBIAS].numpy(), gb_j, rtol=1e-5,
                               atol=1e-5)
    dx = bnk.batch_norm_dx(grows, rows, st[bnk.INV], gr[bnk.COEF_B],
                           gr[bnk.COEF_C0])
    np.testing.assert_allclose(dx.view(x.shape).numpy(), gx_j, rtol=0,
                               atol=1e-5)


@pytest.mark.parametrize("pad", [1, 2])
def test_batch_norm_entries_ring_path_match_jax_module(pad):
    """The four entries with the ring's count, the cotangent of shift and
    the running statistics, against JAX's BatchNorm(zero_pad_width=pad)
    and its autodiff."""
    rng = np.random.RandomState(30 + pad)
    c = 12
    x = (rng.randn(2, 7, 9, c) * 1.5 + 0.3).astype(np.float32)
    p = {"scale": (rng.rand(c) + 0.5).astype(np.float32),
         "bias": rng.randn(c).astype(np.float32)}
    s = {"mean": (rng.randn(c) * 0.1).astype(np.float32),
         "var": (rng.rand(c) + 0.5).astype(np.float32)}
    gy = rng.randn(2, 7, 9, c).astype(np.float32)
    gs = rng.randn(c).astype(np.float32)
    mod = JaxBatchNorm()

    def run(params, x):
        (y, shift), upd = mod.apply({"params": params, "batch_stats": s}, x,
                                    False, zero_pad_width=pad,
                                    mutable=["batch_stats"])
        return y, shift, upd["batch_stats"]

    def loss(params, x):
        y, shift, _ = run(params, x)
        return jnp.sum(y * gy) + jnp.sum(shift * gs)

    y_j, shift_j, stats_j = run(p, jnp.asarray(x))
    gp_j, gx_j = jax.grad(loss, argnums=(0, 1))(p, jnp.asarray(x))

    rows = torch.from_numpy(x).view(-1, c)
    count = 2 * (7 + 2 * pad) * (9 + 2 * pad)
    rm, rv = torch.from_numpy(s["mean"].copy()), torch.from_numpy(s["var"].copy())
    st = bnk.batch_norm_stats(rows, torch.from_numpy(p["scale"]),
                              torch.from_numpy(p["bias"]), count, 1e-5, rm,
                              rv, 0.1)
    y = bnk.batch_norm_apply(rows, st[bnk.INV], st[bnk.SHIFT])
    np.testing.assert_allclose(y.view(x.shape).numpy(), np.asarray(y_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(st[bnk.SHIFT].numpy(), np.asarray(shift_j),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(rm.numpy(), np.asarray(stats_j["mean"]),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(rv.numpy(), np.asarray(stats_j["var"]),
                               rtol=1e-5)
    grows = torch.from_numpy(gy).view(-1, c)
    gr = bnk.batch_norm_grad_sums(grows, rows, st, torch.from_numpy(gs),
                                  count)
    dx = bnk.batch_norm_dx(grows, rows, st[bnk.INV], gr[bnk.COEF_B],
                           gr[bnk.COEF_C0])
    np.testing.assert_allclose(dx.view(x.shape).numpy(), np.asarray(gx_j),
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(gr[bnk.DWEIGHT].numpy(),
                               np.asarray(gp_j["scale"]), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(gr[bnk.DBIAS].numpy(),
                               np.asarray(gp_j["bias"]), rtol=1e-4, atol=1e-5)


def test_batch_norm_module_runs_only_the_entries(monkeypatch):
    """The train-mode module's forward and backward go through the four
    entries, once each, and update the running statistics through them."""
    from s2r_tpu_torch.models.layers import BatchNorm

    calls = []
    for name in ("batch_norm_stats", "batch_norm_apply",
                 "batch_norm_grad_sums", "batch_norm_dx"):
        fn = getattr(bnk, name)
        monkeypatch.setattr(bnk, name, lambda *a, _f=fn, _n=name, **k:
                            calls.append(_n) or _f(*a, **k))
    bn = BatchNorm(8).train()
    x = torch.from_numpy(np.random.RandomState(24).randn(2, 8, 5, 5)
                         .astype(np.float32))
    x = x.to(memory_format=torch.channels_last).requires_grad_()
    before = bn.running_var.clone()
    y, shift = bn(x, ring=True, zero_pad_width=1)
    (y.sum() + shift.sum()).backward()
    assert calls == ["batch_norm_stats", "batch_norm_apply",
                     "batch_norm_grad_sums", "batch_norm_dx"]
    assert not torch.equal(bn.running_var, before)
    assert int(bn.num_batches_tracked) == 1
    assert y.permute(0, 2, 3, 1).is_contiguous()


def test_batch_norm_stats_takes_both_running_statistics_or_neither():
    with pytest.raises(ValueError):
        bnk.batch_norm_stats(torch.zeros(4, 3), torch.ones(3), torch.zeros(3),
                             4, 1e-5, running_mean=torch.zeros(3))


def test_channels_last_rows_counts_only_copies():
    x = torch.zeros(2, 3, 4, 5)
    before = bnk.channels_last_rows.copies
    bnk.channels_last_rows(x.to(memory_format=torch.channels_last))
    assert bnk.channels_last_rows.copies == before
    rows = bnk.channels_last_rows(x)
    assert rows.shape == (40, 3) and rows.is_contiguous()
    assert bnk.channels_last_rows.copies == before + 1


# --- the batch split under 2^31 elements a launch ---------------------------

@pytest.mark.parametrize("n,want", [
    (2047, [(0, 2047)]),                   # 2^31 - 2^20 elements
    (2048, [(0, 2047), (2047, 2048)]),     # exactly 2^31
    (2049, [(0, 2047), (2047, 2049)]),     # over
])
def test_batch_chunks_around_2_31(n, want):
    per = 2 ** 20
    got = build.batch_chunks(n, per)
    assert got == want
    assert all((b - a) * per < 2 ** 31 for a, b in got)


def test_batch_chunks_at_the_first_split_batches():
    # depthwise bf16 [N, 256, 512, 144]: batch 113 fits, 114 splits
    per = 256 * 512 * 144
    assert build.batch_chunks(113, per) == [(0, 113)]
    assert build.batch_chunks(114, per) == [(0, 113), (113, 114)]
    # requant [65, 256, 512, 256] as [M, 256] rows
    rows = 65 * 256 * 512
    chunks = build.batch_chunks(rows, 256)
    assert chunks[0] == (0, (2 ** 31 - 1) // 256) and chunks[-1][1] == rows
    assert len(chunks) == 2
    assert build.batch_chunks(0, per) == []
    assert build.batch_chunks(3, 2 ** 31 - 1) == [(0, 1), (1, 2), (2, 3)]


def test_batch_chunks_refuse_one_item_at_the_limit():
    with pytest.raises(ValueError, match="one batch item"):
        build.batch_chunks(1, 2 ** 31)


def test_depthwise_split_equals_one_launch():
    rng = np.random.RandomState(40)
    x = torch.from_numpy(rng.randn(7, 5, 6, 8).astype(np.float32))
    k = torch.from_numpy(rng.randn(3, 3, 8).astype(np.float32))
    want = depthwise.depthwise_conv3x3_plain(x, k, 2)
    y = torch.empty_like(x)
    launches = []

    def launch(xc, kc, yc, d):
        launches.append(xc.shape[0])
        yc.copy_(depthwise.depthwise_conv3x3_plain(xc, kc, d))

    limit = 3 * x[0].numel()  # two images a launch
    depthwise.over_batch(x, k, y, 2, launch, limit=limit)
    assert launches == [2, 2, 2, 1]
    assert torch.equal(y, want)


def test_requant_split_equals_one_launch():
    rng = np.random.RandomState(41)
    x = torch.from_numpy(rng.randint(-300, 300, (9, 4, 16)).astype(np.int32))
    m = torch.from_numpy(rng.rand(16).astype(np.float32))
    b = torch.from_numpy(rng.randn(16).astype(np.float32))
    want = requant.requant_plain(x, m, b)
    y = torch.empty(x.shape, dtype=torch.int8)
    launches = []

    def launch(xc, mc, bc, yc):
        launches.append(xc.shape[0])
        yc.copy_(requant.requant_plain(xc, mc, bc))

    requant.over_rows(x.view(-1, 16), m, b, y.view(-1, 16), launch,
                      limit=10 * 16 + 1)
    assert launches == [10, 10, 10, 6]
    assert torch.equal(y, want)

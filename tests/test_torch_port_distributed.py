"""Data-parallel training of the port (core/mesh.py, core/distributed.py,
the split BatchNorm entries, the global losses, the loader's shares)
against one process and against the JAX package, on the CPU.

- The loader: DataLoader(process_index=r, process_count=W) gives the JAX
  package's batches index for index, W in {2, 4}, ragged tails included.
- The BatchNorm math in float64: the split entries on chunks of rows, their
  sums added between the calls, equal the fused entries on all rows (1e-12
  relative), both directions, each chunk's cotangent of shift added once;
  the running variance takes the global count's unbiased factor.
  BatchNormTrain, the global losses and the batch-axis softmax with W
  ranks simulated by threads (an all-reduce over shared memory): values
  and gradients equal the whole batch's (float64, 1e-12); BatchNormTrain's
  synchronized route over 4 thread ranks in float32 against the JAX
  package's Pallas batch_norm_train (interpret mode) and its VJP on the
  whole batch (max relative error 1e-5).
- Four gloo processes (tools/dist_check.py, one torch thread each; as
  tests/test_multihost.py spawns its children): the output step (from
  JAX's state) and the feature step, 2 steps each in float64 with every
  leaf in float64, against one process on the whole batch: losses rel
  <= 1e-10, every leaf's update and the BatchNorm running statistics rel
  L2 <= 1e-10, every rank's state bit-equal.  One output step from the
  same state with float32 leaves, as JAX's are, against JAX's at the
  bounds of tests/test_torch_port_train_step_f64.py (losses rtol 1e-5,
  G's and D's updates rel L2 <= 1e-3; JAX single-device
  at the global batch, which tests/test_steps.py:85 holds equal to the
  8-device mesh).  The Trainer at world 4: the validation confusion
  matrix equals world 1's, best_pred is the same on every rank, and rank
  0 alone writes the run directory.
- The same spawn at 2 data rows x 2 bands of rows (--spatial-shard 2):
  the output step under --remat and the feature step, float64, against
  one process (losses and every leaf's update within rel 1e-10, ranks
  bit-equal; the recompute re-issues its halo gathers but no
  all-reduce); one float32 output step against JAX's single-device step
  at the bounds above (JAX's own tests/test_spatial_train.py ties that
  step to its 2-D mesh); the Trainer with --spatial-shard 2, with and
  without --eval-spatial-shard: the validation confusion matrix equals
  world 1's.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.core.distributed import local_shard as jax_local_shard
from s2r_tpu.core.precision import Policy
from s2r_tpu.data.loader import DataLoader as JaxLoader
from s2r_tpu.models import layers as JL
from s2r_tpu.ops.pallas.batchnorm import batch_norm_train as jax_bn_train
from s2r_tpu.train.setup import build_method as jax_build_method
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.core.distributed import local_shard
from s2r_tpu_torch.data.loader import DataLoader
from s2r_tpu_torch.io.convert import (from_jax_discriminator,
                                      from_jax_variables,
                                      train_state_from_jax)
from s2r_tpu_torch.ops.kernels import batchnorm as BN
from s2r_tpu_torch.tools import dist_check
from s2r_tpu_torch.train import losses as L
from s2r_tpu_torch.train.setup import build_method
from s2r_tpu_torch.train.steps import batch_softmax

from _torch_port_common import perturb_affine, perturb_stats

WORLD, HW, BATCH = 4, 64, 4
SPATIAL_HW = 64  # the smallest crop 4 bands split at stride 16
F64 = torch.float64


class _Dataset:
    def __init__(self, n):
        self.n = n

    def __len__(self):
        return self.n

    def __getitem__(self, i, rng=None):
        return {"x": np.int64(i)}


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("n,batch,shuffle,drop_last", [
    (13, 4, True, True), (13, 4, False, False), (18, 8, True, False),
    (10, 4, True, False)])
def test_loader_shares_equal_jax(world, n, batch, shuffle, drop_last):
    for rank in range(world):
        kw = dict(shuffle=shuffle, drop_last=drop_last, num_workers=1,
                  seed=7, process_index=rank, process_count=world)
        got, want = DataLoader(_Dataset(n), batch, **kw), \
            JaxLoader(_Dataset(n), batch, **kw)
        for epoch in (0, 3):
            got.set_epoch(epoch)
            want.set_epoch(epoch)
            assert got._index_batches() == want._index_batches()
            assert [b["x"].tolist() for b in got] == \
                [b["x"].tolist() for b in want]
            # the batches it gives (JAX's len counts a dropped tail: C.11)
            assert len(got) == len(got._index_batches())
        assert local_shard(n, rank, world) == jax_local_shard(n, rank, world)
    with pytest.raises(ValueError, match="divisible"):
        DataLoader(_Dataset(n), 6, process_index=0, process_count=4)


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max().clamp(min=1e-300))


def test_split_batchnorm_entries_equal_fused_f64():
    rs = np.random.RandomState(0)
    m, c, chunks = 96, 24, 4
    x = torch.from_numpy(rs.randn(m, c) * 2 + 0.5)
    g = torch.from_numpy(rs.randn(m, c))
    weight = torch.from_numpy(rs.uniform(0.5, 1.5, c))
    bias = torch.from_numpy(rs.randn(c) * 0.1)
    gshifts = [torch.from_numpy(rs.randn(c)) for _ in range(chunks)]
    count = m + 40  # a padding ring's positions
    rm0, rv0 = torch.from_numpy(rs.randn(c)), torch.from_numpy(
        rs.uniform(0.5, 1.5, c))
    rm, rv = rm0.clone(), rv0.clone()
    want = BN.batch_norm_stats(x, weight, bias, count, 1e-5, rm, rv)
    want_y = BN.batch_norm_apply(x, want[BN.INV], want[BN.SHIFT])
    srm, srv = rm0.clone(), rv0.clone()
    xs = x.chunk(chunks)
    sums = sum(BN.batch_norm_sums(xc)[:2] for xc in xs)
    got = BN.batch_norm_sums(xs[0])
    got[:2] = sums
    # each rank applies its own rows with the global statistics
    ys = [BN.batch_norm_finish_apply(xc, got.clone(), weight, bias, count,
                                     1e-5) for xc in xs[1:]]
    y = BN.batch_norm_finish_apply(xs[0], got, weight, bias, count, 1e-5,
                                   srm, srv)  # fills got's rows in place
    assert _rel(got, want) <= 1e-12
    assert _rel(torch.cat([y] + ys), want_y) <= 1e-12
    assert _rel(srm, rm) <= 1e-12 and _rel(srv, rv) <= 1e-12
    # the running variance's unbiased factor is the global count's
    var = want[BN.VAR]
    np.testing.assert_allclose(
        rv, 0.9 * rv0 + 0.1 * var * count / (count - 1), rtol=1e-13)

    total = sum(gshifts)
    fused = BN.batch_norm_grad_sums(g, x, want, total, count)
    gs = g.chunk(chunks)
    shares = [BN.batch_norm_grad_sums_local(gc, xc, want, gsh)
              for gc, xc, gsh in zip(gs, xs, gshifts)]
    reduced = shares[0].clone()
    reduced[:2] = sum(s[:2] for s in shares)
    done = BN.batch_norm_grad_finish(reduced, want, count)
    assert _rel(done[BN.SUM_G], fused[BN.DBIAS]) <= 1e-12  # G, gshift once
    assert _rel(done[BN.SUM_GX], fused[BN.SUM_GX]) <= 1e-12
    for row in (BN.COEF_B, BN.COEF_C0):
        assert _rel(done[row], fused[row]) <= 1e-12
    for row in (BN.DWEIGHT, BN.DBIAS):  # the ranks' shares add up
        assert _rel(sum(s[row] for s in shares), fused[row]) <= 1e-12
    dx = torch.cat([BN.batch_norm_dx(gc, xc, want[BN.INV], done[BN.COEF_B],
                                     done[BN.COEF_C0])
                    for gc, xc in zip(gs, xs)])
    assert _rel(dx, BN.batch_norm_dx(g, x, want[BN.INV], fused[BN.COEF_B],
                                     fused[BN.COEF_C0])) <= 1e-12


class _Shared:
    def __init__(self, world):
        self.slots = [None] * world
        self.barrier = threading.Barrier(world)


class _ThreadMesh:
    """Rank `rank` of `world` threads: the all-reduce of core/mesh.py Mesh
    over shared memory."""

    def __init__(self, shared, world, rank):
        self.shared, self.size, self.rank = shared, world, rank
        self.calls = self.elements = 0

    def all_reduce_(self, t, op="sum"):
        self.shared.slots[self.rank] = t.detach().clone()
        self.shared.barrier.wait()
        stack = torch.stack(self.shared.slots)
        total = stack.sum(0) if op == "sum" else stack.amax(0)
        self.shared.barrier.wait()
        with torch.no_grad():
            t.copy_(total)
        self.calls += 1
        return t


def _threads(world, fn):
    """fn(mesh, rank) on `world` threads at once; their results by rank."""
    shared, out, errors = _Shared(world), [None] * world, []

    def run(r):
        try:
            out[r] = fn(_ThreadMesh(shared, world, r), r)
        except BaseException as e:  # noqa: BLE001 - re-raised below
            errors.append(e)
            shared.barrier.abort()

    ts = [threading.Thread(target=run, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    if errors:
        raise errors[0]
    return out


def _grad_of(fn, *inputs):
    inputs = [i.detach().clone().requires_grad_(True) for i in inputs]
    value = fn(*inputs)
    return value.detach(), torch.autograd.grad(value, inputs)


@pytest.mark.parametrize("pad", [0, 1])
def test_batchnorm_train_synchronized_equals_whole_batch(pad):
    """BatchNormTrain with the sums all-reduced over 4 ranks equals it on
    the whole batch: y, shift, the running statistics over the global
    count, dx, and dweight / dbias summed over the ranks' shares; the loss
    reaches shift (the padding ring's value) as the model's fill does."""
    rs = np.random.RandomState(1)
    x = torch.from_numpy(rs.randn(8, 6, 5, 7))
    up = torch.from_numpy(rs.randn(8, 6, 5, 7))
    ush = torch.from_numpy(rs.randn(6))
    weight = torch.from_numpy(rs.uniform(0.5, 1.5, 6))
    bias = torch.from_numpy(rs.randn(6) * 0.1)

    def loss(xx, w, b, sync, rm, rv, n_ranks=1):
        y, shift, _, _ = BN.BatchNormTrain.apply(xx, w, b, 1e-5, pad, rm, rv,
                                                 0.1, sync)
        scale = up[:xx.shape[0]] if sync is None else sync_part(sync)
        return (y * scale).sum() + (shift * ush).sum() / n_ranks

    def sync_part(sync):
        return up[sync.rank::sync.size]

    rm, rv = torch.zeros(6, dtype=F64), torch.ones(6, dtype=F64)
    want, (gx, gw, gb) = _grad_of(
        lambda a, w, b: loss(a, w, b, None, rm, rv), x, weight, bias)

    def rank(mesh, r):
        srm, srv = torch.zeros(6, dtype=F64), torch.ones(6, dtype=F64)
        v, grads = _grad_of(lambda a, w, b: loss(a, w, b, mesh, srm, srv,
                                                 WORLD),
                            x[r::WORLD], weight, bias)
        return v, grads, srm, srv

    out = _threads(WORLD, rank)
    assert abs(float(sum(o[0] for o in out)) - float(want)) <= \
        1e-12 * abs(float(want))
    got_dx = torch.empty_like(x)
    for r, o in enumerate(out):
        got_dx[r::WORLD] = o[1][0]
        assert torch.equal(o[2], out[0][2]) and torch.equal(o[3], out[0][3])
    assert _rel(got_dx, gx) <= 1e-12
    assert _rel(sum(o[1][1] for o in out), gw) <= 1e-12
    assert _rel(sum(o[1][2] for o in out), gb) <= 1e-12
    assert _rel(out[0][2], rm) <= 1e-12 and _rel(out[0][3], rv) <= 1e-12


def test_batchnorm_train_synchronized_matches_jax_pallas(monkeypatch):
    """The synchronized route (batch_norm_sums, the all-reduce,
    batch_norm_finish_apply; grad_sums_local, the all-reduce, grad_finish,
    dx) of BatchNormTrain over 4 thread ranks, float32, against the JAX
    package's Pallas batch_norm_train (interpret mode) and its VJP on the
    whole batch: y, dx, and dweight and dbias summed over the ranks
    (float32: the two packages sum in different orders)."""
    rs = np.random.RandomState(5)
    n, c, h, w = 8, 16, 6, 5
    x = (rs.randn(n, h, w, c) * 1.5 + 0.5).astype(np.float32)
    gy = rs.randn(n, h, w, c).astype(np.float32)
    scale = rs.uniform(0.5, 1.5, c).astype(np.float32)
    bias = (rs.randn(c) * 0.1).astype(np.float32)

    def jax_loss(xx, s, b):
        y, _, _ = jax_bn_train(xx, s, b, 1e-5, True)
        return jnp.sum(y * gy)

    want_y = np.asarray(jax_bn_train(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias), 1e-5, True)[0])
    want_dx, want_ds, want_db = (np.asarray(v) for v in jax.grad(
        jax_loss, argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(scale),
                                     jnp.asarray(bias)))
    nchw = torch.from_numpy(x).permute(0, 3, 1, 2)
    g_nchw = torch.from_numpy(gy).permute(0, 3, 1, 2)
    calls = dict.fromkeys(dist_check.BN_ENTRIES, 0)
    lock = threading.Lock()

    def counted(name, fn):
        def call(*args, **kwargs):
            with lock:
                calls[name] += 1
            return fn(*args, **kwargs)
        return call

    for name in dist_check.BN_ENTRIES:
        monkeypatch.setattr(BN, name, counted(name, getattr(BN, name)))

    def rank(mesh, r):
        xr = nchw[r::WORLD].clone().requires_grad_(True)
        s = torch.from_numpy(scale).requires_grad_(True)
        b = torch.from_numpy(bias).requires_grad_(True)
        y, _, _, _ = BN.BatchNormTrain.apply(xr, s, b, 1e-5, 0, None, None,
                                             0.1, mesh)
        (y * g_nchw[r::WORLD]).sum().backward()
        return (y.detach().permute(0, 2, 3, 1), xr.grad.permute(0, 2, 3, 1),
                s.grad, b.grad, mesh.calls)

    out = _threads(WORLD, rank)
    got_y, got_dx = np.empty_like(x), np.empty_like(x)
    for r, o in enumerate(out):
        got_y[r::WORLD], got_dx[r::WORLD] = o[0].numpy(), o[1].numpy()
        assert o[4] == 2  # one all-reduce each way
    # each rank's route: two entries and an all-reduce a direction, and dx
    route = ("batch_norm_sums", "batch_norm_finish_apply",
             "batch_norm_grad_sums_local", "batch_norm_grad_finish",
             "batch_norm_dx")
    assert calls == {k: WORLD * (k in route) for k in calls}, calls

    def max_rel(a, b):
        return float(np.abs(a - b).max() / np.abs(b).max())

    assert max_rel(got_y, want_y) <= 1e-5
    assert max_rel(got_dx, want_dx) <= 1e-5
    assert max_rel(sum(o[2] for o in out).numpy(), want_ds) <= 1e-5
    assert max_rel(sum(o[3] for o in out).numpy(), want_db) <= 1e-5


def _seg_inputs():
    rs = np.random.RandomState(2)
    logits = torch.from_numpy(rs.randn(8, 19, 6, 5))
    labels = torch.from_numpy(rs.randint(0, 19, (8, 6, 5)))
    for i in range(8):  # ignored pixels spread unevenly over the ranks
        labels[i, :i % 5] = 255
    weight = torch.from_numpy(rs.uniform(0.2, 2.0, 19))
    return logits, labels, weight


LOSSES = {
    "ce": lambda lg, lb, w, mesh: L.cross_entropy(lg, lb, w, mesh=mesh),
    "focal": lambda lg, lb, w, mesh: L.focal_loss(lg, lb, w, mesh=mesh),
    "domain": lambda lg, lb, w, mesh: L.domain_loss(lg[:, :2],
                                                    lg[:, 2:4], mesh)[0],
    "domain_acc": lambda lg, lb, w, mesh: L.domain_loss(
        lg[:, :2], lg[:, 2:4], mesh)[1].double() + 0 * lg.sum(),  # float32
    "bce": lambda lg, lb, w, mesh: L.bce_with_logits(lg, 1.0, mesh),
    "batch_softmax": lambda lg, lb, w, mesh: (
        batch_softmax(lg, mesh) * torch.cos(lg)).sum(),
}


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_global_losses_equal_whole_batch(name):
    """Each rank's share, summed over 4 ranks, equals the loss of the
    whole batch, value and gradient (the batch-axis softmax: the sum of
    an elementwise function of it)."""
    fn = LOSSES[name]
    logits, labels, weight = _seg_inputs()
    want, (gwant,) = _grad_of(lambda lg: fn(lg, labels, weight, None),
                              logits)
    out = _threads(WORLD, lambda mesh, r: _grad_of(
        lambda lg: fn(lg, labels[r::WORLD], weight, mesh), logits[r::WORLD]))
    got = sum(float(o[0]) for o in out)
    tol = 1e-6 if name == "domain_acc" else 1e-12  # acc: float32 shares
    assert abs(got - float(want)) <= tol * max(1.0, abs(float(want)))
    grad = torch.empty_like(logits)
    for r, o in enumerate(out):
        grad[r::WORLD] = o[1][0]
    assert float((grad - gwant).abs().max()) <= \
        1e-12 * max(1.0, float(gwant.abs().max()))


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The tasks at world 4 (4 gloo processes) and at world 1 (one more):
    the feature step and the Trainer at once; JAX's output step at the
    global batch, float64, from a perturbed state, and that state as the
    port's init file for the output steps, started before JAX's step
    compiles.  Returns (JAX's metrics, params and statistics after its
    step, each rank's results, world 1's, the root)."""
    root = tmp_path_factory.mktemp("dist")
    common = dict(hw=HW, batch=BATCH, steps=2, precision="f64",
                  float64_leaves=True)

    def rest(run_root, spatial):
        tasks = [dict(kind="steps", method="feature_adapt", **common),
                 dict(kind="trainer", hw=32, batch=BATCH, precision="f64",
                      train_steps=2, run_root=str(run_root))]
        if spatial:  # 2 data rows x 2 bands; at one process, the reference
            tasks.append(dict(kind="steps", method="feature_adapt",
                              spatial=2, **common))
        tasks.append(dict(kind="trainer", hw=SPATIAL_HW, batch=BATCH,
                          precision="f64", train_steps=1,
                          run_root=str(run_root / "spatial"),
                          spatial=2 if spatial else 1, eval_spatial=spatial))
        if spatial:  # validation over the data rows and the bands
            tasks.append(dict(tasks[-1], eval_spatial=False,
                              run_root=str(run_root / "spatial_rows")))
        return {"tasks": tasks}

    rest4 = dist_check.start(rest(root / "run4", True), WORLD, "cpu",
                             timeout=300)
    rest1 = dist_check.start(rest(root / "run1", False), 1, "cpu",
                             timeout=300, threads=2)
    batch = dist_check.global_batch("output_adapt", HW, BATCH, 7)
    from_name = Policy.from_name.__func__
    with pytest.MonkeyPatch.context() as mp, jax.enable_x64(True):
        mp.setattr(JL.Dropout, "__call__", lambda self, x, deterministic: x)
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
        pm = build_method(Config(precision="f64"), iters_per_epoch=10,
                          method="output_adapt", device="cpu")
        st = train_state_from_jax(pm.init_state(), params, stats,
                                  _np(state.opt_state), 0)
        init = str(root / "init.pt")
        torch.save({"G": st.G.state_dict(), "D": st.D.state_dict(),
                    "opt_state": st.opt_state, "step": st.step}, init)
        out = {"tasks": [
            dict(kind="steps", method="output_adapt", init=init, **common),
            # JAX's leaves are float32: so are these, as in
            # tests/test_torch_port_train_step_f64.py
            dict(kind="steps", method="output_adapt", init=init, hw=HW,
                 batch=BATCH, steps=1, precision="f64")]}
        # 2 data rows x 2 bands of rows, the first under --remat
        spatial = {"tasks": [dict(t, spatial=2, remat=not i)
                             for i, t in enumerate(out["tasks"])]}
        out4 = dist_check.start({"tasks": out["tasks"] + spatial["tasks"]},
                                WORLD, "cpu", timeout=300)
        out1 = dist_check.start(out, 1, "cpu", timeout=300, threads=2)
        state = state.replace(
            params=jax.tree_util.tree_map(jnp.asarray, params),
            batch_stats=jax.tree_util.tree_map(
                lambda a: jnp.asarray(a, jnp.float64), stats))
        state, met = jax.jit(jm.step_fn)(state, {k: jnp.asarray(v) for k, v
                                                 in batch.items()})
        jax_run = ({k: float(v) for k, v in met.items()}, _np(state.params),
                   _np(state.batch_stats))

    def tasks(o, r):  # in the order the tests index them
        return [o[0], r[0], r[1], o[1]] + ([o[2], r[2], o[3], r[3], r[4]]
                                           if len(o) > 2 else [r[2]])

    ranks = [tasks(o, r) for o, r in zip(out4.results(), rest4.results())]
    return (jax_run, ranks, tasks(out1.results()[0], rest1.results()[0]),
            root)


def _updates(snaps, i):
    before, after = snaps[i], snaps[i + 1]
    return {net: {k: after[net][k] - before[net][k] for k in after[net]
                  if after[net][k].is_floating_point()}
            for net in ("G", "D")}


@pytest.mark.parametrize("task,ref_task", [(0, 0), (1, 1), (4, 0), (5, 1)],
                         ids=["output", "feature", "output_spatial_remat",
                              "feature_spatial"])
def test_four_ranks_equal_one_process_f64(runs, task, ref_task):
    _, ranks, ref, _ = runs
    assert all(r[task]["ranks_equal"] for r in ranks)
    got, want = ranks[0][task], ref[ref_task]
    # G's 60 BatchNorms (and the domain classifier's 2) in both directions,
    # the softmax or the domain terms, the gradients, the metrics
    assert got["collectives_per_step"] >= 240
    assert want["collectives_per_step"] == 0
    if task >= 4:  # the bands' halos: every 3x3, stride-2 and resize
        assert got["gathers_per_step"] >= 100
    for i in range(2):
        for k, w in want["metrics"][i].items():
            assert abs(got["metrics"][i][k] - w) <= 1e-10 * abs(w), (i, k)
        gu, wu = _updates(got["snapshots"], i), _updates(want["snapshots"], i)
        for net in ("G", "D"):
            for k, w in wu[net].items():
                if float(w.abs().max()) == 0:
                    assert float(gu[net][k].abs().max()) == 0, (i, net, k)
                    continue
                err = dist_check.rel_l2(gu[net][k], w)
                assert err <= 1e-10, (i, net, k, err)
    stats = [k for k in want["snapshots"][-1]["G"]
             if k.endswith(("running_mean", "running_var"))
             and k.startswith(("backbone.features.", "aspp.", "decoder."))]
    assert len(stats) == 120  # every BatchNorm of G
    for k in stats:
        assert dist_check.rel_l2(got["snapshots"][-1]["G"][k],
                                 want["snapshots"][-1]["G"][k]) <= 1e-10, k


def test_four_ranks_output_step_matches_jax(runs):
    _output_step_matches_jax(runs, 3)


def test_spatial_output_step_matches_jax(runs):
    """2 data rows x 2 bands of rows, float32 leaves, against JAX's
    single-device step."""
    _output_step_matches_jax(runs, 6)


def _output_step_matches_jax(runs, task):
    (jax_metrics, jax_params, jax_stats), ranks, _, _ = runs
    got = ranks[0][task]
    assert all(r[task]["ranks_equal"] for r in ranks)
    for k in ("seg_loss", "adv_loss", "d_loss", "lr"):
        np.testing.assert_allclose(got["metrics"][0][k], jax_metrics[k],
                                   rtol=1e-5, err_msg=k)
    before, after = got["snapshots"][0], got["snapshots"][1]
    for net, want in (
            ("G", from_jax_variables(jax_params["G"], jax_stats)),
            ("D", from_jax_discriminator(jax_params["D"]))):
        keys = [k for k in want if not k.endswith(
            ("running_mean", "running_var", "num_batches_tracked"))]
        err, leaf = max((dist_check.rel_l2(after[net][k] - before[net][k],
                                           want[k].double() - before[net][k]),
                         k) for k in keys)
        assert err <= 1e-3, (net, leaf, err)


def test_four_ranks_validation_and_run_directory(runs):
    _, ranks, ref, root = runs
    want = ref[2]
    for r in ranks:
        np.testing.assert_array_equal(r[2]["confusion"], want["confusion"])
        assert r[2]["best_pred"] == ranks[0][2]["best_pred"]
        assert r[2]["ranks_equal"]
    assert want["confusion"].sum() > 0
    run = root / "run4" / "synthetic" / "deeplab-mobilenet"
    one = root / "run1" / "synthetic" / "deeplab-mobilenet"
    assert sorted(os.listdir(run)) == sorted(os.listdir(one)) == [
        "experiment_0", "model_best.ckpt"]

    def files(d):
        return sorted(f for f in os.listdir(d) if not f.startswith("events"))

    # train-image logging ('images') runs at one process only
    assert files(run / "experiment_0") == [
        f for f in files(one / "experiment_0") if f != "images"]
    assert "checkpoint.ckpt" in files(run / "experiment_0")


@pytest.mark.parametrize("task", [7, 8], ids=["eval_spatial", "eval_rows"])
def test_spatial_trainer_validation(runs, task):
    """--spatial-shard 2 at world 4, with --eval-spatial-shard (each rank a
    band of a quarter of every batch's rows) or without (each rank its
    data row's samples, a band of half their rows): the validation
    confusion matrix equals world 1's, and every rank's state is the same
    after the epoch."""
    _, ranks, ref, _ = runs
    want = ref[4]["confusion"]
    assert want.sum() > 0
    for r in ranks:
        np.testing.assert_array_equal(r[task]["confusion"], want)
        assert r[task]["ranks_equal"]
        assert r[task]["best_pred"] == ranks[0][task]["best_pred"]


def test_spatial_remat_recompute_gathers_again(runs):
    """Under --remat the recompute replays BatchNorm's statistics (no
    all-reduce) and re-issues its halo gathers: the remat output step's
    all-reduces over the world equal the step's without remat, its
    gathers are more."""
    _, ranks, _, _ = runs
    remat, plain = ranks[0][4], ranks[0][6]
    assert remat["world_collectives_per_step"] == \
        plain["world_collectives_per_step"]
    assert remat["gathers_per_step"] > plain["gathers_per_step"]


def test_dropout_stream_per_rank(monkeypatch):
    """Each rank draws its dropout masks from its own stream, seeded from
    (seed, rank): with one seed every rank would draw the same masks for
    different samples.  One process keeps the seed itself."""
    from s2r_tpu_torch.core import mesh as M

    seeds = {}
    for world, rank in ((1, 0), (2, 0), (2, 1)):
        monkeypatch.setattr(M, "process_info", lambda: (rank, world))
        m = build_method(Config(), 1, method="output_adapt", device="cpu",
                         n_devices=world)
        seeds[(world, rank)] = m.init_state().generator.initial_seed()
    assert seeds[(1, 0)] == Config().seed
    assert len(set(seeds.values())) == 3

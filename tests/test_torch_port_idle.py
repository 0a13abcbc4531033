"""The devices JAX idles (core/mesh.py ``pick_num_devices``, ``make_mesh``,
``end_of_run``) against the JAX package's rule, on the CPU.

- ``pick_num_devices`` equals s2r_tpu.train.trainer.pick_num_devices over
  a grid: worlds 1-8, batches 1-9, no ``--num-devices``, fewer and more,
  ``--spatial-shard`` 1, 2 and 4, one node and many (the port's
  LOCAL_WORLD_SIZE below WORLD_SIZE playing jax.process_count() > 1):
  the same count, or the same kind of refusal.
- Three gloo processes at batch 4 (tools/dist_check.py, a ``subworld``
  spec): JAX's rule takes 2.  Ranks 0-1 take a float64 output step
  against one process on the whole batch (tests/test_torch_port_
  distributed.py's bounds: losses, every update and every running
  statistic within rel 1e-10, the ranks bit-equal), broadcast rank 0's
  tensors over their group, and run the Trainer, whose validation
  equals one process's; rank 2 builds nothing, issues no collective
  after set-up, allocates nothing, passes the end barrier once for the
  Trainer's fit and once at the end, and writes nothing; every process
  exits 0.
- Four gloo processes at --spatial-shard 2 and batch 3 (which the 2 data
  rows do not divide): JAX takes one data row x 2 bands; the two idle ranks make the same groups and no
  collective, and the step equals one process's.
"""

import os

import jax
import pytest

from s2r_tpu.train import trainer as jax_trainer
from s2r_tpu_torch.config import Config
from s2r_tpu_torch.core import distributed as D
from s2r_tpu_torch.core import mesh as M
from s2r_tpu_torch.tools import dist_check

BATCH, HW = 4, 32


def _jax_count(monkeypatch, world, hosts, batch, requested, spatial):
    monkeypatch.setattr(jax, "devices", lambda *a: list(range(world)))
    monkeypatch.setattr(jax, "process_count", lambda: hosts)
    try:
        return jax_trainer.pick_num_devices(batch, requested, spatial,
                                            log=False)
    except (ValueError, NotImplementedError) as e:
        return type(e)


def _port_count(monkeypatch, world, hosts, batch, requested, spatial):
    monkeypatch.setattr(M, "process_info", lambda: (0, world))
    monkeypatch.setenv("LOCAL_WORLD_SIZE", str(world // hosts))
    try:
        return M.pick_num_devices(batch, requested, spatial, log=False)
    except (ValueError, NotImplementedError) as e:
        return type(e)


@pytest.mark.parametrize("hosts", [1, 2])
@pytest.mark.parametrize("world", range(1, 9))
def test_pick_num_devices_matches_jax(monkeypatch, world, hosts):
    if world % hosts:
        hosts = 1
    cases = 0
    for batch in range(1, 10):
        for requested in (None, max(world - 1, 1), world + 2):
            for spatial in (1, 2, 4):
                want = _jax_count(monkeypatch, world, hosts, batch,
                                  requested, spatial)
                got = _port_count(monkeypatch, world, hosts, batch,
                                  requested, spatial)
                assert got == want, (batch, requested, spatial)
                cases += 1
    assert cases == 81


def test_pick_num_devices_says_so_on_rank_0(monkeypatch, capsys):
    """Rank 0 prints JAX's message with the port's prefix; rank 1 stays
    quiet."""
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    monkeypatch.setattr(M, "process_info", lambda: (0, 3))
    assert M.pick_num_devices(4) == 2
    assert capsys.readouterr().out == (
        "[s2r_tpu_torch] using 2/3 devices: batch_size 4 is not divisible "
        "by 3 (consider --batch-pad auto or a divisible batch)\n")
    monkeypatch.setattr(M, "process_info", lambda: (0, 4))
    assert M.pick_num_devices(3, None, 2) == 2
    assert "using 2/4 devices (1 data x 2 spatial)" in \
        capsys.readouterr().out
    monkeypatch.setattr(M, "process_info", lambda: (1, 3))
    assert M.pick_num_devices(4) == 2
    assert capsys.readouterr().out == ""


def test_whole_world_keeps_its_path(monkeypatch):
    """At n == world no group is made: the default one carries the step,
    and the shares are (rank, world), as before; a rank past the
    sub-world gets no share and builds no method."""
    from s2r_tpu_torch.train.setup import build_method

    monkeypatch.setattr(M, "process_info", lambda: (1, 2))
    monkeypatch.setattr(D, "process_info", lambda: (1, 2))
    mesh = M.make_mesh(2)
    assert (mesh.size, mesh.rank, mesh.group) == (2, 1, None)
    assert M._SUBWORLDS == {}
    assert D.process_shares(2) == ((0, 1), (0, 1))
    assert D.process_shares(1, n_devices=2) == ((1, 2), (1, 2))
    assert D.process_shares(1, True, 2) == ((1, 2), (0, 1))
    with pytest.raises(ValueError, match="idles"):
        D.process_shares(1, n_devices=1)
    M._SUBWORLDS[1] = (None, None)  # as make_mesh leaves it, no group
    try:
        idle = M.make_mesh(1)
        assert isinstance(idle, M.IdleRank) and idle.size == 1
        assert M.make_layout(idle, 1) is None
        with pytest.raises(ValueError, match="IdleRank"):
            build_method(Config(), 1, method="output_adapt", device="cpu",
                         n_devices=1)
    finally:
        M._SUBWORLDS.pop(1)


def _steps(**kw):
    return dict(dict(kind="steps", method="output_adapt", hw=HW, steps=1,
                     precision="f64", float64_leaves=True), **kw)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Three ranks at batch 4 and four at --spatial-shard 2, batch 3, each
    beside one process on the same tasks; started together."""
    root = tmp_path_factory.mktemp("idle")
    trainer = dict(kind="trainer", hw=HW, batch=BATCH, precision="f64",
                   train_steps=1, num_devices=None)
    tasks = [dict(kind="ping"), _steps(batch=BATCH)]
    three = dist_check.start(
        {"subworld": {"batch": BATCH}, "tasks": tasks + [dict(
            trainer, run_root=str(root / "run3"))]}, 3, "cpu", timeout=300)
    one = dist_check.start({"tasks": tasks + [dict(
        trainer, run_root=str(root / "run1"))]}, 1, "cpu", timeout=300)
    # 64 rows: two bands at the path's stride 32 (at 32 one rank holds all)
    spatial = [_steps(batch=3, spatial=2, hw=64)]
    four = dist_check.start({"subworld": {"batch": 3, "spatial": 2},
                             "tasks": spatial}, 4, "cpu", timeout=300)
    one_s = dist_check.start({"tasks": [dict(spatial[0], spatial=1)]}, 1,
                             "cpu", timeout=300)
    return (three.results(), one.results()[0], four.results(),
            one_s.results()[0], root)


def _updates(snaps, i):
    before, after = snaps[i], snaps[i + 1]
    return {net: {k: after[net][k] - before[net][k] for k in after[net]
                  if after[net][k].is_floating_point()}
            for net in ("G", "D")}


def _equal_steps(got, want, steps):
    for i in range(steps):
        for k, w in want["metrics"][i].items():
            assert abs(got["metrics"][i][k] - w) <= 1e-10 * abs(w), (i, k)
        gu, wu = _updates(got["snapshots"], i), _updates(want["snapshots"], i)
        for net in ("G", "D"):
            for k, w in wu[net].items():
                if float(w.abs().max()) == 0:
                    assert float(gu[net][k].abs().max()) == 0, (i, net, k)
                    continue
                assert dist_check.rel_l2(gu[net][k], w) <= 1e-10, (i, net, k)
    stats = [k for k in want["snapshots"][-1]["G"]
             if k.endswith(("running_mean", "running_var"))]
    assert len(stats) >= 120
    for k in stats:
        assert dist_check.rel_l2(got["snapshots"][-1]["G"][k],
                                 want["snapshots"][-1]["G"][k]) <= 1e-10, k


def test_sub_world_step_equals_one_process(runs):
    three, one, _, _, _ = runs
    ping, step = three[0][0], three[0][1]
    assert [r[0]["sum"] for r in three[:2]] == [2.0, 2.0]  # two ranks
    assert [r[0]["broadcast"] for r in three[:2]] == [1.0, 1.0]
    assert all(r[1]["ranks_equal"] for r in three[:2])
    assert step["collectives_per_step"] >= 240
    assert one[1]["collectives_per_step"] == 0
    assert ping["collectives_after_setup"]["all_reduce"] > 500
    _equal_steps(step, one[1], 1)


def test_idle_rank_joins_no_collective(runs):
    three, _, four, _, root = runs
    for idle in [three[2]] + four[2:]:
        for task in idle:
            assert task["idle"] and task["collectives"] == 0
            assert task["peak_bytes"] == 0
    # the Trainer's fit passes the end barrier once; the spec's end once
    assert three[2][0]["end_barriers"] == 1
    assert four[2][0]["end_barriers"] == 0
    for r in three[:2]:
        assert r[0]["collectives_after_setup"]["end"] == 1


def test_sub_world_trainer(runs):
    three, one, _, _, root = runs
    want = one[2]
    for r in three[:2]:
        assert (r[2]["confusion"] == want["confusion"]).all()
        assert r[2]["best_pred"] == three[0][2]["best_pred"]
        assert r[2]["ranks_equal"]
    assert want["confusion"].sum() > 0
    run = root / "run3" / "synthetic" / "deeplab-mobilenet"
    assert sorted(os.listdir(run)) == ["experiment_0", "model_best.ckpt"]


def test_sub_world_spatial_step(runs):
    """--spatial-shard 2, batch 3, four ranks: one data row x 2 bands;
    the step equals one process's, its ranks bit-equal."""
    _, _, four, one, _ = runs
    got = four[0][0]
    assert all(r[0]["ranks_equal"] for r in four[:2])
    assert got["gathers_per_step"] >= 100  # the bands' halos
    _equal_steps(got, one[0], 1)

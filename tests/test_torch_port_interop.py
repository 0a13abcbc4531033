"""The port's torch interop (s2r_tpu_torch/io/torch_import.py,
io/torch_export.py, cli/export.py --format torch, --backbone-init) against
the JAX package's (s2r_tpu/io/torch_import.py, io/torch_export.py,
train/trainer.py), on the CPU.  No test reads /root/reference: every file
is written here, by the JAX package's exporters or by torch optimizers
stepped over the port's modules.

- A reference checkpoint s2r_tpu's save_reference_checkpoint writes, of
  either schema, resumed into the port gives from_jax_variables /
  from_jax_domain of the same trees; a four-schema domain classifier loads
  only into a feature-method state, as in the JAX Trainer.
- The port's export (cli.export --format torch, both schemas) read by
  s2r_tpu's import_reference_checkpoint gives back the JAX trees.
- Optimizer state: torch SGD and Adam, stepped a few times over the port's
  modules with their parameters in the reference's group order and saved
  in a .pth, go through s2r_tpu's import_reference_checkpoint +
  merge_torch_opt_state and through the port; the flat buffers are equal
  after flat_to_port, and the Adam counts too.
- --backbone-init from a state dict s2r_tpu's export_backbone writes gives
  the backbone JAX's Trainer._init_backbone gives.
Every comparison is exact.
"""

import argparse
import dataclasses
import functools
import os

import jax
import numpy as np
import pytest
import torch

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.io.torch_export import export_backbone
from s2r_tpu.io.torch_export import save_reference_checkpoint as jax_export
from s2r_tpu.io.torch_import import (import_reference_checkpoint,
                                     merge_torch_opt_state)
from s2r_tpu.train.setup import build_method as jax_build
from s2r_tpu_torch import config as PC
from s2r_tpu_torch.io.checkpoint import host_tree, save_checkpoint
from s2r_tpu_torch.io.convert import (deeplab_param_order,
                                      domain_param_order,
                                      feature_param_order, flat_to_port,
                                      from_jax_domain, from_jax_variables,
                                      reference_param_order,
                                      domain_reference_order)
from s2r_tpu_torch.train.setup import build_method
from s2r_tpu_torch.train.trainer import resume_into

from _torch_port_common import perturb_stats, torch_threads


@pytest.fixture(scope="module")
def jax_trees():
    """Numpy trees of a JAX feature_adapt state: G params and perturbed
    statistics, the domain classifier's params and perturbed statistics."""
    js = jax.tree_util.tree_map(np.asarray, _jax_init("feature_adapt")[1])
    return {"G": (js.params["G"], perturb_stats(js.batch_stats["G"], 2)),
            "D": (js.params["D"], perturb_stats(js.batch_stats["D"], 3))}


@functools.lru_cache(maxsize=None)
def _jax_init(method, optimizer="SGD"):
    """(JAX method, its initial TrainState), built once a module: both
    are immutable."""
    jm = jax_build(JaxConfig(dataset="synthetic", crop_size=32, base_size=32,
                             batch_size=2, optimizer=optimizer), 4,
                   method=method)
    return jm, jm.init_state(jax.random.PRNGKey(5))


def _port_state(method, optimizer="SGD"):
    return build_method(PC.Config(precision="f32", optimizer=optimizer), 4,
                        method=method, device="cpu").init_state()


def _equal_sd(got, want):
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("schema", ["single", "four"])
@pytest.mark.parametrize("method", ["output_adapt", "feature_adapt"])
def test_reference_checkpoint_resumes_into_port(jax_trees, tmp_path,
                                                 schema, method):
    (gp, gs), (dp, ds) = jax_trees["G"], jax_trees["D"]
    path = str(tmp_path / "ref.pth.tar")
    jax_export(path, gp, gs, epoch=7, best_pred=0.25, schema=schema,
               domain=(dp, ds))
    st = _port_state(method)
    d_before = host_tree(st)["D"]
    epoch, best = resume_into(st, path, ft=False)
    assert (epoch, best) == (7, 0.25)
    _equal_sd(st.G.state_dict(), from_jax_variables(gp, gs))
    if schema == "four" and method == "feature_adapt":
        _equal_sd(st.D.state_dict(), from_jax_domain(dp, ds))
    else:  # output_adapt's D, or no D in the file: D stays at init
        _equal_sd(host_tree(st)["D"], d_before)
    # the exported optimizers are empty: the buffers stay zero
    for s in st.opt_state.values():
        for k, v in s.items():
            assert (v == 0) if k == "count" else float(v.abs().max()) == 0


def _tree_equal_np(got, want, path=""):
    if isinstance(want, dict):
        assert sorted(got) == sorted(want), path
        for k in want:
            _tree_equal_np(got[k], want[k], f"{path}/{k}")
    else:
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want),
                                      err_msg=path)


@pytest.mark.parametrize("schema", ["single", "four"])
def test_port_export_is_read_by_jax(jax_trees, tmp_path, monkeypatch,
                                    schema):
    """cli.export --format torch of a port checkpoint holding the JAX
    trees: s2r_tpu's importer gives the trees back."""
    from s2r_tpu_torch.cli import export

    (gp, gs), (dp, ds) = jax_trees["G"], jax_trees["D"]
    st = _port_state("feature_adapt")
    st.G.load_state_dict(from_jax_variables(gp, gs), strict=True)
    st.D.load_state_dict(from_jax_domain(dp, ds), strict=True)
    ckpt = str(tmp_path / "port.ckpt")
    save_checkpoint(ckpt, st, 9, 0.5)
    out = str(tmp_path / "out.pth.tar")
    monkeypatch.setenv("S2R_PLATFORM", "cpu")
    with torch_threads():
        export.main(["--dataset", "synthetic", "--precision", "f32",
                     "--resume", ckpt, "--out", out, "--schema", schema,
                     "--method", "feature_adapt"])
    imp = import_reference_checkpoint(out)
    assert (imp["schema"], imp["epoch"], imp["best_pred"]) == (schema, 9,
                                                               0.5)
    _tree_equal_np(imp["G"][0], gp)
    _tree_equal_np(imp["G"][1], gs)
    if schema == "four":
        _tree_equal_np(imp["D"][0], dp)
        _tree_equal_np(imp["D"][1], ds)
    else:
        assert imp["D"] is None


def _step_torch(opt, params, steps, seed):
    gen = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        for p in params:
            p.grad = torch.randn(p.shape, generator=gen)
        opt.step()


def _named(module, names):
    params = dict(module.named_parameters())
    return [params[k] for k in names]


def _torch_opt(kind, groups):
    if kind == "sgd":
        return torch.optim.SGD(groups, lr=0.01, momentum=0.9,
                               weight_decay=5e-4)
    return torch.optim.Adam(groups, lr=0.01)


@pytest.mark.parametrize("schema,kind", [("single", "sgd"), ("four", "sgd"),
                                         ("four", "adam")])
def test_optimizer_state_import_matches_jax(tmp_path, schema, kind):
    method = "output_adapt" if schema == "single" else "feature_adapt"
    optimizer = "Adam" if kind == "adam" else "SGD"
    st = _port_state(method, optimizer)
    G, D = st.G, st.D
    bb = reference_param_order(parts=("backbone",))
    head = reference_param_order(parts=("aspp", "decoder"))
    f_head = reference_param_order(parts=("aspp",))
    with torch.no_grad():
        for i, p in enumerate(G.parameters()):
            p.add_(0.01 * i)  # weights that differ per leaf
    if schema == "single":
        opt = _torch_opt(kind, [{"params": _named(G, bb)},
                                {"params": _named(G, head)}])
        _step_torch(opt, _named(G, bb + head), 3, 0)
        ckpt = {"state_dict": G.state_dict(), "optimizer": opt.state_dict(),
                "epoch": 2, "best_pred": 0.125}
    else:
        task = _torch_opt(kind, [{"params": _named(G, bb)},
                                 {"params": _named(G, head)}])
        d = _torch_opt(kind, _named(D, domain_reference_order()))
        d_inv = _torch_opt(kind, [{"params": _named(G, bb)},
                                  {"params": _named(G, f_head)}])
        c = _torch_opt(kind, [{"params": _named(G, bb)},
                              {"params": _named(G, head)}])
        _step_torch(task, _named(G, bb + head), 3, 1)
        _step_torch(d, _named(D, domain_reference_order()), 2, 2)
        _step_torch(d_inv, _named(G, bb + f_head), 4, 3)
        sd = G.state_dict()
        ckpt = {"backbone_model_state_dict": {
                    k[9:]: v for k, v in sd.items()
                    if k.startswith("backbone.")},
                "assp_model_state_dict": {k[5:]: v for k, v in sd.items()
                                          if k.startswith("aspp.")},
                "y_model_state_dict": {k[8:]: v for k, v in sd.items()
                                       if k.startswith("decoder.")},
                "d_model_state_dict": D.state_dict(),
                "task_optimizer": task.state_dict(),
                "d_optimizer": d.state_dict(),
                "d_inv_optimizer": d_inv.state_dict(),
                "c_optimizer": c.state_dict(),  # never stepped: no state
                "epoch": 4, "best_pred": 0.5}
    path = str(tmp_path / "opt.pth.tar")
    torch.save(ckpt, path)

    imp = import_reference_checkpoint(path)
    js = _jax_init(method, optimizer)[1]
    params = {"G": imp["G"][0],
              "D": imp["D"][0] if imp["D"] is not None else js.params["D"]}
    merged = jax.tree_util.tree_map(
        np.asarray, merge_torch_opt_state(imp["opt"], params, js.opt_state))

    port = _port_state(method, optimizer)
    resume_into(port, path, ft=False)
    g_stats = imp["G"][1]
    over = {"G": (params["G"], lambda t: from_jax_variables(t, g_stats),
                  deeplab_param_order()),
            "f": ({k: params["G"][k] for k in ("backbone", "aspp")},
                  lambda t: from_jax_variables({**params["G"], **t},
                                               g_stats),
                  feature_param_order())}
    if imp["D"] is not None:
        over["D"] = (params["D"], lambda t: from_jax_domain(t, imp["D"][1]),
                     domain_param_order())
    nets = ({"G": "G"} if schema == "single"
            else {"task": "G", "d": "D", "d_inv": "f", "c": "G"})
    for name, net in nets.items():
        tree, convert, order = over[net]
        for k, v in merged[name].items():
            got = port.opt_state[name][k]
            if k == "count":
                assert got == int(v), (name, k)
            else:
                want = flat_to_port(v, tree, convert, order)
                assert torch.equal(got, want), (name, k)
    stepped = port.opt_state["G" if schema == "single" else "task"]
    assert float(stepped["momentum" if kind == "sgd" else "m"].abs().max()) > 0
    if schema == "four":
        if kind == "adam":
            assert port.opt_state["d"]["count"] == 2
        assert float(port.opt_state["c"][
            "momentum" if kind == "sgd" else "m"].abs().max()) == 0


def test_optimizer_kind_mismatch_raises(tmp_path):
    """An SGD buffer into an Adam run raises, as in the JAX package."""
    st = _port_state("output_adapt")
    bb = reference_param_order(parts=("backbone",))
    head = reference_param_order(parts=("aspp", "decoder"))
    opt = torch.optim.SGD([{"params": _named(st.G, bb)},
                           {"params": _named(st.G, head)}], lr=0.1,
                          momentum=0.9)
    _step_torch(opt, _named(st.G, bb + head), 1, 0)
    path = str(tmp_path / "sgd.pth")
    torch.save({"state_dict": st.G.state_dict(),
                "optimizer": opt.state_dict()}, path)
    port = _port_state("output_adapt")
    port.opt_state["G"] = {"m": port.opt_state["G"]["momentum"],
                           "v": port.opt_state["G"]["momentum"], "count": 0}
    with pytest.raises(ValueError, match="is sgd but the run is configured "
                       "for adam"):
        resume_into(port, path, ft=False)


@pytest.mark.parametrize("wrapped", [False, True])
def test_backbone_init_matches_jax(jax_trees, tmp_path, wrapped):
    from s2r_tpu.core.mesh import make_mesh
    from s2r_tpu.train.trainer import Trainer as JaxTrainer
    from s2r_tpu_torch.train.trainer import Trainer

    gp, gs = jax_trees["G"]
    sd = export_backbone(gp["backbone"], gs["backbone"])
    path = str(tmp_path / "mobilenet.pth")
    torch.save({"state_dict": sd} if wrapped else sd, path)

    jt = object.__new__(JaxTrainer)
    jt.method, jt.state = _jax_init("output_adapt")
    jt.cfg = JaxConfig(dataset="synthetic", crop_size=32, base_size=32,
                       batch_size=2)
    jt.mesh = make_mesh(1)
    jt._init_backbone(path)
    want = from_jax_variables(jax.tree_util.tree_map(np.asarray,
                                                     jt.state.params["G"]),
                              jax.tree_util.tree_map(np.asarray,
                                                     jt.state.batch_stats))

    parser = argparse.ArgumentParser()
    PC.add_common_flags(parser)  # the flag no longer raises
    cfg = PC.config_from_args(parser.parse_args(
        ["--dataset", "synthetic", "--device-aug", "--batch-size", "2",
         "--crop-size", "32", "--base-size", "32", "--precision", "f32",
         "--workers", "1", "--run-root", str(tmp_path / "run"),
         "--backbone-init", path]))
    with torch_threads():
        t = Trainer(cfg, method="output_adapt", device="cpu")
        fresh = Trainer(dataclasses.replace(cfg, backbone_init=None),
                        method="output_adapt", device="cpu")
    t.writer.close()
    fresh.writer.close()
    got, before = t.state.G.state_dict(), fresh.state.G.state_dict()
    for k in got:
        if k.startswith("backbone.") and "num_batches_tracked" not in k:
            assert torch.equal(got[k], want[k]), k
        else:  # ASPP, decoder and the counters keep their init
            assert torch.equal(got[k], before[k]), k
    assert os.path.exists(path)

"""Import rules of the PyTorch port and the behaviour of chip_smoke.py
without a GPU.

- Importing s2r_tpu_torch and every module under it, and chip_smoke.py,
  leaves jax, flax, msgpack, PIL and s2r_tpu out of sys.modules: the port
  must run on a machine that has none of them.
- chip_smoke.py exits non-zero and prints no result when torch finds no
  CUDA device, and likewise from a directory holding nothing else of the
  repository.
"""

import json
import os
import shutil
import subprocess
import sys


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "msgpack", "PIL", "s2r_tpu", "tensorboard")

_CHILD = """
import importlib, json, pkgutil, sys
sys.path.insert(0, {repo!r})
import s2r_tpu_torch
names = ["s2r_tpu_torch"]
for m in pkgutil.walk_packages(s2r_tpu_torch.__path__, "s2r_tpu_torch."):
    names.append(m.name)
    importlib.import_module(m.name)
import chip_smoke
loaded = sorted({{k.split(".")[0] for k in sys.modules}})
print(json.dumps({{"modules": names, "loaded": loaded}}))
"""


def _env():
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    return env


def test_port_imports_no_jax_flax_or_jax_package():
    out = subprocess.run([sys.executable, "-c", _CHILD.format(repo=REPO)],
                         capture_output=True, text=True, timeout=120,
                         cwd="/", env=_env())
    assert out.returncode == 0, out.stderr
    result = json.loads(out.stdout.strip().splitlines()[-1])
    for mod in ("s2r_tpu_torch.ops.kernels.depthwise",
                "s2r_tpu_torch.ops.kernels.requant",
                "s2r_tpu_torch.io.serving", "s2r_tpu_torch.io.quant",
                "s2r_tpu_torch.io.convert", "s2r_tpu_torch.models.deeplab",
                "s2r_tpu_torch.ops.kernels.batchnorm",
                "s2r_tpu_torch.ops.kernels.disc_conv",
                "s2r_tpu_torch.models.discriminator",
                "s2r_tpu_torch.train.steps", "s2r_tpu_torch.train.setup",
                "s2r_tpu_torch.tools.profile_train",
                "s2r_tpu_torch.config", "s2r_tpu_torch.eval.metrics",
                "s2r_tpu_torch.data.palette", "s2r_tpu_torch.data.synthetic",
                "s2r_tpu_torch.data.loader", "s2r_tpu_torch.data.device_aug",
                "s2r_tpu_torch.parallel.feed", "s2r_tpu_torch.io.checkpoint",
                "s2r_tpu_torch.io.saver", "s2r_tpu_torch.utils.png",
                "s2r_tpu_torch.utils.summaries",
                "s2r_tpu_torch.utils.calculate_weights",
                "s2r_tpu_torch.train.trainer",
                "s2r_tpu_torch.cli.train_adapt", "s2r_tpu_torch.cli.val_adapt",
                "s2r_tpu_torch.cli.val", "s2r_tpu_torch.cli._eval_common",
                "s2r_tpu_torch.models.domain", "s2r_tpu_torch.cli.train",
                "s2r_tpu_torch.cli.test", "s2r_tpu_torch.cli.test_adapt",
                "s2r_tpu_torch.data.imaging", "s2r_tpu_torch.data.transforms",
                "s2r_tpu_torch.data.datasets", "s2r_tpu_torch.data.hostcrop",
                "s2r_tpu_torch.tools.fixtures",
                "s2r_tpu_torch.tools.profile_driver",
                "s2r_tpu_torch.io.msgpack_io", "s2r_tpu_torch.io.torch_import",
                "s2r_tpu_torch.io.torch_export", "s2r_tpu_torch.cli.export",
                "s2r_tpu_torch.cli.infer", "s2r_tpu_torch.utils.tree",
                "s2r_tpu_torch.tools.profile_infer",
                "s2r_tpu_torch.models.resnet", "s2r_tpu_torch.models.xception",
                "s2r_tpu_torch.models.drn", "s2r_tpu_torch.core.mesh",
                "s2r_tpu_torch.core.distributed",
                "s2r_tpu_torch.tools.dist_check",
                "s2r_tpu_torch.tools.profile_dist",
                "s2r_tpu_torch.data.native",
                "s2r_tpu_torch.data.native_loader",
                "s2r_tpu_torch.utils.profiling"):
        assert mod in result["modules"]
    leaked = [m for m in FORBIDDEN if m in result["loaded"]]
    assert not leaked, leaked


def _run_smoke(cwd):
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""  # no GPU, whatever the machine has
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          capture_output=True, text=True, timeout=120,
                          env=env)


def _no_result(proc):
    assert proc.returncode != 0
    for line in proc.stdout.splitlines():
        assert '"ok"' not in line and '"kernels"' not in line


def test_chip_smoke_fails_without_gpu():
    _no_result(_run_smoke(REPO))


def test_chip_smoke_fails_alone(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    proc = _run_smoke(tmp_path)
    _no_result(proc)


def test_chip_smoke_fails_alone_even_with_a_gpu(tmp_path, monkeypatch,
                                                capsys):
    """Run in-process with CUDA reported present: outside the repository
    the port is missing and the script stops before doing anything."""
    import torch

    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.syspath_prepend(str(tmp_path))
    monkeypatch.setattr(sys, "path", [p for p in sys.path
                                      if os.path.abspath(p or ".") != REPO])
    monkeypatch.delitem(sys.modules, "chip_smoke", raising=False)
    for name in [m for m in sys.modules if m.startswith("s2r_tpu_torch")]:
        monkeypatch.delitem(sys.modules, name)
    import chip_smoke

    assert os.path.dirname(chip_smoke.__file__) == str(tmp_path)
    assert chip_smoke.main() != 0
    assert "s2r_tpu_torch not found" in capsys.readouterr().err

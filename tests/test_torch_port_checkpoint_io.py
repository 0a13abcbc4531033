"""The port's reading and writing of the JAX package's checkpoints
(s2r_tpu_torch/io/msgpack_io.py, io/checkpoint.py, io/convert.py) against
flax and s2r_tpu/io/checkpoint.py, on the CPU.

- The msgpack reader gives flax.serialization.msgpack_restore's tree leaf
  for leaf and dtype for dtype (bfloat16 leaves as torch.bfloat16), for
  every container type, ints of every width, the three extension types
  and flax's chunked leaves (MAX_CHUNK_SIZE patched small); the writer
  gives flax's bytes for the same trees, and flax reads them back.
- A checkpoint s2r_tpu's save_checkpoint writes, of either method layout
  (output_adapt; feature_adapt), with its optimizer state filled from a
  numpy seed and bfloat16 and chunked leaves in 'extra', reads exactly.
- Resumed into the port's Trainer with ft on and off it equals
  train_state_from_jax of the same trees, with JAX's epoch and best_pred.
- The port's JAX-format writer: bit-equal back through the port (the
  dropout generator and num_batches_tracked too), resumed by the JAX
  Trainer at its Config's defaults (the 'rbg' PRNG, whose key it then
  splits) with the template's structure, shapes and dtypes, and carried
  back by train_state_from_jax to the same state.
- A checkpoint of the other method's layout raises, naming both layouts;
  a file of no known format raises.
Every comparison is exact.
"""

import functools
import os

import flax.serialization as fs
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from s2r_tpu.config import Config as JaxConfig
from s2r_tpu.io.checkpoint import save_checkpoint as jax_save
from s2r_tpu.train.setup import build_method as jax_build
from s2r_tpu_torch import config as PC
from s2r_tpu_torch.io import msgpack_io
from s2r_tpu_torch.io.checkpoint import (host_tree, load_checkpoint,
                                         read_jax_checkpoint,
                                         save_jax_checkpoint)
from s2r_tpu_torch.io.convert import train_state_from_jax
from s2r_tpu_torch.train.setup import build_method

from _torch_port_common import torch_threads

METHODS = ("output_adapt", "feature_adapt")


def _bf16_jax(a):
    return jnp.asarray(a, jnp.bfloat16)


def _bf16_torch(a):
    """The torch tensor holding the same bits as _bf16_jax(a)."""
    bits = np.asarray(_bf16_jax(a)).view(np.uint16).copy()
    return torch.from_numpy(bits).view(torch.bfloat16)


def _assert_leaf_equal(got, want, path):
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _assert_leaf_equal(got[k], want[k], f"{path}/{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _assert_leaf_equal(g, w, f"{path}[{i}]")
    elif isinstance(want, (np.ndarray, np.generic)):
        if np.asarray(want).dtype.name == "bfloat16":
            assert torch.is_tensor(got) and got.dtype == torch.bfloat16, path
            assert tuple(got.shape) == np.shape(want), path
            np.testing.assert_array_equal(
                got.view(torch.uint16).numpy(),
                np.asarray(want).view(np.uint16), err_msg=path)
        else:
            assert type(got) is type(want), (path, type(got), type(want))
            assert got.dtype == want.dtype and got.shape == want.shape, path
            np.testing.assert_array_equal(got, want, err_msg=path)
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


_RS = np.random.RandomState(0)
TREES = {
    "ints": {"pos": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                     2 ** 32, 2 ** 63, 2 ** 64 - 1],
             "neg": [-1, -32, -33, -128, -129, -32768, -32769, -2 ** 31,
                     -2 ** 31 - 1, -2 ** 63]},
    "scalars": {"f": 0.1, "g": -2.5e300, "none": None, "t": True, "f0": False,
                "s": "k" * 31, "s8": "é" * 20, "s16": "x" * 300,
                "s32": "y" * 70000, "b8": b"\x01" * 200, "b16": b"\x02" * 300,
                "b32": b"\x03" * 70000},
    "containers": {"m16": {f"k{i}": i for i in range(20)},
                   "a16": list(range(20)), "empty": {}, "nested": {"a": {
                       "b": {"c": [1, {"d": 2}]}}}},
    "arrays": {name: (_RS.randn(3, 5) * 50).astype(name) for name in (
        "float16", "float32", "float64", "int8", "int16", "int32", "int64",
        "uint8", "uint16", "uint32", "uint64", "complex64", "complex128")},
    "array_shapes": {"0d": np.float32(1.5) * np.ones((), np.float32),
                     "empty": np.zeros((0, 4), np.float32),
                     "bool": np.array([True, False, True]),
                     "4d": _RS.randn(2, 3, 1, 4).astype(np.float32)},
    "np_scalars": {"f32": np.float32(3.25), "i64": np.int64(-7),
                   "u8": np.uint8(200), "f64": np.float64(0.5),
                   "b": np.bool_(True)},
    "complex": {"c": complex(1.5, -2.0), "list": [complex(0, 1), 2]},
    "bfloat16": {"w": _RS.randn(7, 3).astype(np.float32),
                 "s": np.float32(-0.75)},
}


def _flax_tree(name):
    tree = TREES[name]
    if name == "bfloat16":
        return {"w": _bf16_jax(tree["w"]),
                "s": jnp.bfloat16(tree["s"])}
    return tree


def _port_tree(name):
    tree = TREES[name]
    if name == "bfloat16":
        return {"w": _bf16_torch(tree["w"]),
                "s": _bf16_torch(tree["s"]).reshape(())}
    return tree


def _first_difference(got: bytes, want: bytes) -> str:
    """Where two encodings part, and the msgpack type byte each has there."""
    i = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
             min(len(got), len(want)))
    return (f"the encodings differ from byte {i} (port 0x{got[i]:02x} vs "
            f"flax 0x{want[i]:02x})" if i < min(len(got), len(want)) else
            f"lengths {len(got)} vs {len(want)}")


@pytest.mark.parametrize("name", sorted(TREES))
def test_reader_equals_flax(name):
    blob = fs.msgpack_serialize(_flax_tree(name))
    _assert_leaf_equal(msgpack_io.unpackb(blob), fs.msgpack_restore(blob),
                       name)


@pytest.mark.parametrize("name", sorted(TREES))
def test_writer_bytes_equal_flax(name):
    want = fs.msgpack_serialize(_flax_tree(name))
    got = msgpack_io.packb(_port_tree(name))
    assert got == want, f"{name}: {_first_difference(got, want)}"
    _assert_leaf_equal(msgpack_io.unpackb(got), fs.msgpack_restore(got),
                       name)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int8"])
def test_chunked_leaves(monkeypatch, dtype):
    """flax splits an array over MAX_CHUNK_SIZE bytes into chunks; the
    reader joins them, and the writer splits as flax does."""
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 96)
    a = (np.random.RandomState(1).randn(11, 13) * 20).astype(
        "float32" if dtype == "bfloat16" else dtype)
    flax_tree = {"x": {"leaf": _bf16_jax(a) if dtype == "bfloat16" else a},
                 "small": np.ones(3, np.float32)}
    blob = fs.msgpack_serialize(flax_tree)
    assert b"__msgpack_chunked_array__" in blob
    _assert_leaf_equal(msgpack_io.unpackb(blob), fs.msgpack_restore(blob),
                       dtype)
    port_tree = {"x": {"leaf": _bf16_torch(a) if dtype == "bfloat16"
                       else a}, "small": flax_tree["small"]}
    got = msgpack_io.packb(port_tree, max_chunk_size=96)
    assert got == blob, _first_difference(got, blob)


def test_reader_rejects_bad_data():
    blob = fs.msgpack_serialize({"a": np.ones(4, np.float32)})
    with pytest.raises(ValueError, match="truncated"):
        msgpack_io.unpackb(blob[:-3])
    with pytest.raises(ValueError, match="after the end"):
        msgpack_io.unpackb(blob + b"\x00")


# ----------------------------------------------------------- checkpoints

@functools.lru_cache(maxsize=None)
def _jax_state(method, seed=0):
    """A JAX TrainState of `method` with every optimizer buffer drawn from
    a numpy seed, step 5 and Adam counts 3 (built once a module: it is
    immutable)."""
    jm = jax_build(JaxConfig(dataset="synthetic", crop_size=32, base_size=32,
                             batch_size=2), 4, method=method)
    js = jm.init_state(jax.random.PRNGKey(seed))
    rs = np.random.RandomState(seed + 10)

    def fill(x):
        x = np.asarray(x)
        if x.dtype == np.float32 and x.ndim == 1:
            return rs.randn(*x.shape).astype(np.float32)
        if x.ndim == 0:
            return np.asarray(3, x.dtype)
        return x

    opt = jax.tree_util.tree_map(fill, js.opt_state)
    return js.replace(opt_state=opt, step=jnp.asarray(5, jnp.int32))


@pytest.fixture(scope="module", params=METHODS)
def jax_ckpt(request, tmp_path_factory):
    """(method, JAX TrainState, path of its checkpoint: epoch 4, best_pred
    0.625, a bfloat16 leaf and a chunked one in 'extra')."""
    method = request.param
    js = _jax_state(method)
    path = str(tmp_path_factory.mktemp("ckpt") / f"{method}.ckpt")
    old = fs.MAX_CHUNK_SIZE
    fs.MAX_CHUNK_SIZE = 1 << 12
    try:
        jax_save(path, js, 4, 0.625,
                 extra={"bf": _bf16_jax(np.arange(6.0).reshape(2, 3)),
                        "big": np.arange(3000, dtype=np.float32)})
    finally:
        fs.MAX_CHUNK_SIZE = old
    return method, js, path


def test_port_reads_jax_checkpoint_leaf_for_leaf(jax_ckpt):
    _, _, path = jax_ckpt
    with open(path, "rb") as f:
        blob = f.read()
    assert b"__msgpack_chunked_array__" in blob  # the chunked leaves
    want = fs.msgpack_restore(blob)
    got = read_jax_checkpoint(path)
    _assert_leaf_equal(got, want, "ckpt")
    assert got["extra"]["bf"].dtype == torch.bfloat16


def _trainer(tmp_path, method, path, ft):
    from s2r_tpu_torch.train.trainer import Trainer

    cfg = PC.Config(dataset="synthetic", device_aug=True, batch_size=2,
                    crop_size=32, base_size=32, workers=1, precision="f32",
                    run_root=str(tmp_path), resume=path, ft=ft)
    with torch_threads():
        t = Trainer(cfg, method=method, device="cpu")
    t.writer.close()
    return t


def _tree_equal(a, b):
    if torch.is_tensor(a):
        return (torch.is_tensor(b) and a.dtype == b.dtype
                and torch.equal(a, b))
    if isinstance(a, dict):
        return (isinstance(b, dict) and sorted(a) == sorted(b)
                and all(_tree_equal(a[k], b[k]) for k in a))
    return a == b


@pytest.mark.parametrize("ft", [False, True])
def test_trainer_resumes_jax_checkpoint(jax_ckpt, tmp_path, ft):
    method, js, path = jax_ckpt
    t = _trainer(tmp_path, method, path, ft)
    ref = build_method(PC.Config(precision="f32"), 4, method=method,
                       device="cpu")
    fresh = ref.init_state()
    zero_opt = host_tree(fresh)["opt_state"]
    np_tree = jax.tree_util.tree_map(np.asarray, js)
    want = host_tree(train_state_from_jax(
        fresh, np_tree.params, np_tree.batch_stats, np_tree.opt_state,
        np_tree.step))
    got = host_tree(t.state)
    for k in ("G", "D"):
        assert _tree_equal(got[k], want[k]), k
    assert t.best_pred == 0.625
    if ft:
        assert got["step"] == 0 and t.start_epoch == 0
        assert _tree_equal(got["opt_state"], zero_opt)
    else:
        assert got["step"] == 5 and t.start_epoch == 4
        assert _tree_equal(got["opt_state"], want["opt_state"])


def _port_state(method, seed=3):
    """A port state with every buffer, parameter and counter drawn from a
    seed, and a dropout generator that has drawn."""
    m = build_method(PC.Config(precision="f32"), 4, method=method,
                     device="cpu")
    st = m.init_state()
    gen = torch.Generator().manual_seed(seed)
    for s in st.opt_state.values():
        for k, v in s.items():
            if torch.is_tensor(v):
                v.copy_(torch.randn(v.shape, generator=gen))
            else:
                s[k] = 9
    for mod in (st.G, st.D):
        for k, v in mod.state_dict().items():
            if k.endswith("num_batches_tracked"):
                v.fill_(11)
            else:
                v.copy_(torch.randn(v.shape, generator=gen))
    st.step = 17
    torch.rand(5, generator=st.generator)
    return st


@pytest.mark.parametrize("method", METHODS)
def test_port_jax_checkpoint_round_trips(tmp_path, method):
    """Port -> JAX-format file -> port is bit-equal; the JAX Trainer at its
    Config's defaults (prng_impl 'rbg') resumes the file with ft off onto
    its own template and splits the restored rng; and JAX's trees carried
    back by train_state_from_jax give the same weights and buffers."""
    from s2r_tpu.core.mesh import make_mesh
    from s2r_tpu.train.trainer import Trainer as JaxTrainer

    st = _port_state(method)
    cfg = JaxConfig(dataset="synthetic", crop_size=32, base_size=32,
                    batch_size=2, ft=False)
    path = str(tmp_path / "port.ckpt")
    save_jax_checkpoint(path, st, 6, 0.375, seed=cfg.seed)
    payload = load_checkpoint(path)
    assert payload["format"] == "jax"
    assert (payload["epoch"], payload["best_pred"]) == (6, 0.375)
    assert _tree_equal(payload["state"], host_tree(st))

    old = jax.config.jax_default_prng_impl
    try:
        # what JaxTrainer.__init__ does with cfg.prng_impl
        jax.config.update("jax_default_prng_impl", cfg.prng_impl)
        jt = object.__new__(JaxTrainer)
        jt.cfg, jt.mesh = cfg, make_mesh(1)
        jt.method = jax_build(cfg, 4, method=method)
        template = jt.method.init_state(jax.random.PRNGKey(cfg.seed))
        jt.state, jt.start_epoch, jt.best_pred = template, 0, 0.0
        jt._resume(path)
        restored = jt.state
        assert (jt.start_epoch, jt.best_pred) == (6, 0.375)
        np.testing.assert_array_equal(
            np.asarray(restored.rng),
            np.asarray(jax.random.PRNGKey(cfg.seed)))
        split = jax.random.split(restored.rng)
        assert split.shape == (2,) + np.shape(template.rng) == (2, 4)
    finally:
        jax.config.update("jax_default_prng_impl", old)
    leaves, tree = jax.tree_util.tree_flatten(restored)
    t_leaves, t_tree = jax.tree_util.tree_flatten(template)
    assert tree == t_tree
    for a, b in zip(leaves, t_leaves):
        assert np.shape(a) == np.shape(b)
        assert np.asarray(a).dtype == np.asarray(b).dtype
    back = train_state_from_jax(
        build_method(PC.Config(precision="f32"), 4, method=method,
                     device="cpu").init_state(),
        restored.params, restored.batch_stats, restored.opt_state,
        restored.step)
    got, want = host_tree(back), host_tree(st)
    assert _tree_equal(got["opt_state"], want["opt_state"])
    assert got["step"] == 17
    for net in ("G", "D"):  # JAX has no num_batches_tracked
        assert _tree_equal(
            {k: v for k, v in got[net].items()
             if not k.endswith("num_batches_tracked")},
            {k: v for k, v in want[net].items()
             if not k.endswith("num_batches_tracked")})


@pytest.mark.parametrize("impl,want", [("threefry2x32", [0, 7]),
                                       ("rbg", [0, 7, 0, 7]),
                                       ("unsafe_rbg", [0, 7, 0, 7])])
def test_rng_is_jax_prng_key(impl, want):
    from s2r_tpu_torch.io.convert import jax_rng

    got = jax_rng(7, impl)
    assert got.dtype == np.uint32
    np.testing.assert_array_equal(got, np.asarray(want, np.uint32))
    old = jax.config.jax_default_prng_impl
    try:
        jax.config.update("jax_default_prng_impl", impl)
        np.testing.assert_array_equal(np.asarray(jax.random.PRNGKey(7)), got)
    finally:
        jax.config.update("jax_default_prng_impl", old)


def test_wrong_method_layout_raises(jax_ckpt, tmp_path):
    method, _, path = jax_ckpt
    other = "feature_adapt" if method == "output_adapt" else "output_adapt"
    with pytest.raises(ValueError, match="output_adapt layout.*feature_adapt"
                       if other == "feature_adapt" else
                       "feature_adapt / source_only layout.*output_adapt"):
        _trainer(tmp_path, other, path, ft=False)


def test_unknown_format_raises(tmp_path):
    from s2r_tpu_torch.io.checkpoint import checkpoint_format

    path = str(tmp_path / "x.ckpt")
    for head in (b"\x00\x01", b"GIF89a", b"\x83\xa1a"):
        with open(path, "wb") as f:
            f.write(head)
        with pytest.raises(ValueError, match="not a checkpoint"):
            checkpoint_format(path)
    torch.save({"something": 1}, path)
    with pytest.raises(ValueError, match="neither"):
        load_checkpoint(path)
    assert os.path.exists(path)

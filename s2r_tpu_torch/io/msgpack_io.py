"""A reader and writer, in Python and numpy alone, for the msgpack that
``flax.serialization.msgpack_serialize`` writes (the JAX package's
checkpoints, s2r_tpu/io/checkpoint.py).  The card's machine has neither
msgpack nor flax.

What it covers:

- the container types: maps, arrays, str, bin, nil, bool, ints of every
  width, float32 and float64;
- flax's extension types: 1, an ndarray as an inner msgpack (shape, dtype
  name, C-order bytes); 2, a Python complex as (real, imag); 3, a numpy
  scalar, written as a 0-d ndarray;
- ``bfloat16`` leaves, which numpy lacks: they come back as
  ``torch.bfloat16`` tensors through a uint16 view, and such tensors are
  written as flax writes a ``jnp.bfloat16`` array;
- flax's chunked leaves (``__msgpack_chunked_array__``), which it writes
  for an array of more than ``MAX_CHUNK_SIZE`` bytes: read, joined, and
  written the same way.

``packb`` emits what flax emits for the same tree: str keys, ints in their
smallest encoding, Python floats as float64, arrays as ``bin``; the parts
are joined once at the end.  ``unpackb`` slices one memoryview and copies
each array leaf once (``np.frombuffer(...).copy()``), so an 80 MB
checkpoint reads in about a second.  Arrays come back as lists, other
dtypes as numpy arrays, an unknown extension as ``ExtType``.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, List, NamedTuple

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # flax.serialization.MAX_CHUNK_SIZE
_CHUNKED = "__msgpack_chunked_array__"
_EXT_NDARRAY, _EXT_COMPLEX, _EXT_NPSCALAR = 1, 2, 3


class ExtType(NamedTuple):
    code: int
    data: bytes


# -------------------------------------------------------------------- read

class _Reader:
    def __init__(self, data):
        self.mv = memoryview(data).cast("B")
        self.pos = 0

    def take(self, n: int) -> memoryview:
        a = self.pos
        self.pos = a + n
        if self.pos > len(self.mv):
            raise ValueError("msgpack: truncated data")
        return self.mv[a:self.pos]

    def unpack(self, fmt: str, n: int):
        return struct.unpack(fmt, self.take(n))[0]

    def read(self) -> Any:
        b = self.take(1)[0]
        if b <= 0x7f:
            return b
        if b >= 0xe0:
            return b - 0x100
        if 0x80 <= b <= 0x8f:
            return self.map(b & 0x0f)
        if 0x90 <= b <= 0x9f:
            return self.array(b & 0x0f)
        if 0xa0 <= b <= 0xbf:
            return str(self.take(b & 0x1f), "utf-8")
        if b == 0xc0:
            return None
        if b in (0xc2, 0xc3):
            return b == 0xc3
        if b in (0xc4, 0xc5, 0xc6):
            return bytes(self.take(self.length(b - 0xc4)))
        if b in (0xc7, 0xc8, 0xc9):
            n = self.length(b - 0xc7)
            return self.ext(self.unpack(">b", 1), n)
        if b == 0xca:
            return self.unpack(">f", 4)
        if b == 0xcb:
            return self.unpack(">d", 8)
        if 0xcc <= b <= 0xcf:
            return self.unpack(">" + "BHIQ"[b - 0xcc], 1 << (b - 0xcc))
        if 0xd0 <= b <= 0xd3:
            return self.unpack(">" + "bhiq"[b - 0xd0], 1 << (b - 0xd0))
        if 0xd4 <= b <= 0xd8:
            return self.ext(self.unpack(">b", 1), 1 << (b - 0xd4))
        if b in (0xd9, 0xda, 0xdb):
            return str(self.take(self.length(b - 0xd9)), "utf-8")
        if b in (0xdc, 0xdd):
            return self.array(self.length(b - 0xdc + 1))
        if b in (0xde, 0xdf):
            return self.map(self.length(b - 0xde + 1))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def length(self, width_code: int) -> int:
        """A big-endian length of 1, 2 or 4 bytes (width_code 0, 1, 2)."""
        return self.unpack(">" + "BHI"[width_code], 1 << width_code)

    def array(self, n: int) -> List:
        return [self.read() for _ in range(n)]

    def map(self, n: int) -> Dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, code: int, n: int):
        end = self.pos + n
        if code in (_EXT_NDARRAY, _EXT_NPSCALAR):
            out = self.ndarray()
            if code == _EXT_NPSCALAR:
                out = out.reshape(()) if torch.is_tensor(out) else out[()]
        elif code == _EXT_COMPLEX:
            re, im = self.read()
            out = complex(re, im)
        else:
            out = ExtType(code, bytes(self.take(n)))
        if self.pos != end:
            raise ValueError(f"msgpack: extension {code} of {n} bytes is "
                             "malformed")
        return out

    def ndarray(self):
        """flax's inner (shape, dtype name, bytes), the bytes copied once."""
        b = self.take(1)[0]
        if b != 0x93:
            raise ValueError("msgpack: an ndarray extension holds no "
                             "(shape, dtype, bytes) triple")
        shape = self.read()
        name = self.read()
        name = name.decode() if isinstance(name, bytes) else name
        b = self.take(1)[0]
        if b not in (0xc4, 0xc5, 0xc6):
            raise ValueError("msgpack: an ndarray's data is not bin")
        buf = self.take(self.length(b - 0xc4))
        return _array(buf, name, shape)


def _array(buf: memoryview, name: str, shape):
    if name == "bfloat16":
        bits = np.frombuffer(buf, np.uint16).copy()
        return torch.from_numpy(bits).view(torch.bfloat16).reshape(shape)
    try:
        dtype = np.dtype(name)
    except TypeError:
        raise ValueError(f"msgpack: array dtype {name!r} has no numpy or "
                         "torch counterpart here") from None
    return np.frombuffer(buf, dtype).copy().reshape(shape)


def _unchunk(tree):
    if isinstance(tree, dict):
        if tree.get(_CHUNKED) is True:
            shape = [tree["shape"][str(i)] for i in range(len(tree["shape"]))]
            chunks = [tree["chunks"][str(i)]
                      for i in range(len(tree["chunks"]))]
            if torch.is_tensor(chunks[0]):
                return torch.cat([c.reshape(-1) for c in chunks]
                                 ).reshape(shape)
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def unpackb(data) -> Any:
    """The tree `data` (bytes or any buffer) encodes, chunked leaves
    joined (flax.serialization.msgpack_restore)."""
    r = _Reader(data)
    out = r.read()
    if r.pos != len(r.mv):
        raise ValueError(f"msgpack: {len(r.mv) - r.pos} bytes after the "
                         "end of the object")
    return _unchunk(out)


# ------------------------------------------------------------------- write

def _uint(n: int, codes: str, first: int) -> bytes:
    """Type byte first + i, then n in the smallest field codes[i] of
    struct's big-endian "B", "H" or "I" that holds it."""
    for i, c in enumerate(codes):
        if n < 1 << (8 * struct.calcsize(c)):
            return bytes((first + i,)) + struct.pack(">" + c, n)
    raise ValueError(f"msgpack: length {n} is too large")


class _Writer:
    def __init__(self, max_chunk_size: int):
        self.parts: List = []
        self.max_chunk = max_chunk_size

    def write(self, obj) -> None:
        p = self.parts.append
        if obj is None:
            p(b"\xc0")
        elif obj is True or obj is False:
            p(b"\xc3" if obj else b"\xc2")
        elif isinstance(obj, np.generic):
            self.ext_array(_EXT_NPSCALAR, np.asarray(obj))
        elif isinstance(obj, int):
            p(_int(obj))
        elif isinstance(obj, float):
            p(struct.pack(">Bd", 0xcb, obj))
        elif isinstance(obj, complex):
            inner = _Writer(self.max_chunk)
            inner.write((obj.real, obj.imag))
            data = b"".join(inner.parts)
            p(_ext_header(_EXT_COMPLEX, len(data)))
            p(data)
        elif isinstance(obj, str):
            raw = obj.encode("utf-8")
            p(bytes((0xa0 | len(raw),)) if len(raw) < 32
              else _uint(len(raw), "BHI", 0xd9))
            p(raw)
        elif isinstance(obj, (bytes, bytearray, memoryview)):
            raw = memoryview(obj).cast("B")
            p(_uint(len(raw), "BHI", 0xc4))
            p(raw)
        elif isinstance(obj, dict):
            n = len(obj)
            p(bytes((0x80 | n,)) if n < 16 else _uint(n, "HI", 0xde))
            # flax copies the tree with jax.tree_util.tree_map, which sorts
            # each dict's keys; the chunked form it makes afterwards keeps
            # its own order
            chunked = obj.get(_CHUNKED) is True
            for k in (obj if chunked else _sorted(obj)):
                v = obj[k]
                self.write(k)
                if _is_array(v) and _nbytes(v) > self.max_chunk:
                    v = _chunk(v, self.max_chunk)
                if chunked and isinstance(v, dict):
                    self.write(_Ordered(v))
                else:
                    self.write(v)
        elif isinstance(obj, _Ordered):
            n = len(obj.d)
            p(bytes((0x80 | n,)) if n < 16 else _uint(n, "HI", 0xde))
            for k, v in obj.d.items():
                self.write(k)
                self.write(v)
        elif isinstance(obj, (list, tuple)):
            n = len(obj)
            p(bytes((0x90 | n,)) if n < 16 else _uint(n, "HI", 0xdc))
            for v in obj:
                self.write(v)
        elif _is_array(obj):
            self.ext_array(_EXT_NDARRAY, obj)
        else:
            raise TypeError(f"msgpack: cannot encode {type(obj).__name__}")

    def ext_array(self, code: int, arr) -> None:
        """flax's ndarray extension: msgpack (shape, dtype name, bin)."""
        if torch.is_tensor(arr):
            t = arr.detach().cpu().contiguous()
            if t.dtype == torch.bfloat16:
                name, raw = "bfloat16", t.view(torch.uint16).numpy()
            else:
                raw = t.numpy()
                name = raw.dtype.name
        else:
            if arr.dtype.hasobject or arr.dtype.isalignedstruct:
                raise ValueError("msgpack: object and structured dtypes "
                                 "cannot be written")
            raw = arr if arr.flags.c_contiguous else \
                np.ascontiguousarray(arr)
            name = arr.dtype.name
        shape = tuple(int(s) for s in raw.shape)
        data = memoryview(raw.reshape(-1).view(np.uint8))
        inner = _Writer(self.max_chunk)
        inner.parts.append(b"\x93")
        inner.write(shape)
        inner.write(name)
        inner.parts.append(_uint(len(data), "BHI", 0xc4))
        head = b"".join(inner.parts)
        self.parts.append(_ext_header(code, len(head) + len(data)))
        self.parts.append(head)
        self.parts.append(data)


class _Ordered(NamedTuple):
    """A dict written in its own key order (the chunked form's parts)."""
    d: Dict


def _sorted(d: Dict) -> List:
    try:
        return sorted(d)
    except TypeError:  # keys of mixed types: jax would refuse them too
        return list(d)


def _int(n: int) -> bytes:
    if 0 <= n < 128:
        return bytes((n,))
    if -32 <= n < 0:
        return bytes((n + 0x100,))
    if n > 0:
        for i, c in enumerate("BHIQ"):
            if n < 1 << (8 << i):
                return struct.pack(">B" + c, 0xcc + i, n)
    else:
        for i, c in enumerate("bhiq"):
            if n >= -(1 << ((8 << i) - 1)):
                return struct.pack(">B" + c, 0xd0 + i, n)
    raise OverflowError(f"msgpack: integer {n} does not fit 64 bits")


def _ext_header(code: int, n: int) -> bytes:
    fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
    if n in fixed:
        return struct.pack(">Bb", fixed[n], code)
    return _uint(n, "BHI", 0xc7) + struct.pack(">b", code)


def _is_array(v) -> bool:
    return isinstance(v, np.ndarray) or torch.is_tensor(v)


def _nbytes(v) -> int:
    return v.numel() * v.element_size() if torch.is_tensor(v) else v.nbytes


def _chunk(arr, max_chunk: int) -> Dict:
    """flax's chunked form of an array over `max_chunk` bytes."""
    itemsize = arr.element_size() if torch.is_tensor(arr) else \
        arr.dtype.itemsize
    size = max(1, int(max_chunk / itemsize))
    flat = arr.reshape(-1)
    chunks = [flat[i:i + size] for i in range(0, flat.shape[0], size)]
    return {_CHUNKED: True,
            "shape": {str(i): int(s) for i, s in enumerate(arr.shape)},
            "chunks": {str(i): c for i, c in enumerate(chunks)}}


def packb(tree, max_chunk_size: int = MAX_CHUNK_SIZE) -> bytes:
    """The bytes flax.serialization.msgpack_serialize writes for `tree`
    (dicts, lists, tuples, scalars, numpy arrays and CPU tensors)."""
    w = _Writer(max_chunk_size)
    if _is_array(tree) and _nbytes(tree) > max_chunk_size:
        tree = _chunk(tree, max_chunk_size)
    w.write(tree)
    return b"".join(w.parts)

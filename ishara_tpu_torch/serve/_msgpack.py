"""A msgpack codec for the JAX package's ``params.msgpack`` files, in the
standard library, numpy and torch alone.

It reads and writes what flax's ``serialization.to_bytes`` and
``msgpack_restore`` produce, so a serving host needs neither ``msgpack``
nor ``flax`` (the port depends on neither):

* maps (str keys), arrays, str, bin, int, float, bool and nil;
* ext 1, an array: a msgpack array ``(shape, dtype name, raw C-order
  bytes)`` (the name read as bytes, as flax reads it with ``raw=True``);
* ext 3, a numpy scalar (the same encoding at shape ``()``); ext 2, a
  complex number (a msgpack array ``(real, imag)``), read only;
* flax's chunked form of an array over 2**30 bytes (a map with
  ``__msgpack_chunked_array__``), read; writing an array that large
  raises (no model here comes near it).

:func:`unpackb` returns every array as a CPU ``torch.Tensor`` -- numpy has no
bfloat16, so a ``bfloat16`` array is read as 16-bit words and viewed as
``torch.bfloat16`` -- and a scalar as a numpy scalar (a 0-d bfloat16 tensor
for a bfloat16 one). :func:`packb` takes numpy arrays and scalars and torch
tensors, and gives flax's bytes for the same tree: keys in insertion order,
ints in their shortest form, Python floats as float64.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

EXT_NDARRAY, EXT_COMPLEX, EXT_NPSCALAR = 1, 2, 3
MAX_CHUNK_SIZE = 2 ** 30          # flax's limit for one array leaf
_CHUNKED = "__msgpack_chunked_array__"

_TORCH_DTYPE_NAME = {torch.float32: "float32", torch.float64: "float64",
                     torch.float16: "float16", torch.bfloat16: "bfloat16",
                     torch.int8: "int8", torch.uint8: "uint8",
                     torch.int16: "int16", torch.int32: "int32",
                     torch.int64: "int64", torch.bool: "bool"}


# ---------------------------------------------------------------------------
# Writing
# ---------------------------------------------------------------------------

def _head(out: bytearray, n: int, fix: int | None, fix_max: int,
          codes: tuple[int, int, int]) -> None:
    """A length header: the fix form up to ``fix_max``, then 8-, 16- or
    32-bit lengths (``codes``; 0 where the form does not exist)."""
    if fix is not None and n <= fix_max:
        out.append(fix | n)
    elif codes[0] and n < 2 ** 8:
        out += bytes((codes[0], n))
    elif n < 2 ** 16:
        out.append(codes[1])
        out += struct.pack(">H", n)
    elif n < 2 ** 32:
        out.append(codes[2])
        out += struct.pack(">I", n)
    else:
        raise ValueError(f"msgpack object of {n} entries or bytes is too "
                         f"large")


def _pack_int(out: bytearray, v: int) -> None:
    if 0 <= v < 128:
        out.append(v)
    elif -32 <= v < 0:
        out.append(v & 0xFF)
    elif v >= 0:
        for code, fmt, top in ((0xCC, ">B", 2 ** 8), (0xCD, ">H", 2 ** 16),
                               (0xCE, ">I", 2 ** 32), (0xCF, ">Q", 2 ** 64)):
            if v < top:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")
    else:
        for code, fmt, low in ((0xD0, ">b", -2 ** 7), (0xD1, ">h", -2 ** 15),
                               (0xD2, ">i", -2 ** 31), (0xD3, ">q", -2 ** 63)):
            if v >= low:
                out.append(code)
                out += struct.pack(fmt, v)
                return
        raise OverflowError(f"int {v} does not fit msgpack")


def _pack_ext(out: bytearray, code: int, data: bytes) -> None:
    n = len(data)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _head(out, n, None, 0, (0xC7, 0xC8, 0xC9))
    out.append(code)
    out += data


def _array_bytes(shape, name: str, raw: bytes) -> bytes:
    out = bytearray()
    _pack(out, [[int(s) for s in shape], name, raw])
    return bytes(out)


def _tensor_parts(t: torch.Tensor) -> tuple[tuple, str, bytes]:
    t = t.detach().cpu().contiguous()
    name = _TORCH_DTYPE_NAME.get(t.dtype)
    if name is None:
        raise TypeError(f"cannot serialize a tensor of dtype {t.dtype}")
    if t.dtype == torch.bfloat16:
        raw = t.view(torch.int16).numpy().tobytes()
    else:
        raw = t.numpy().tobytes()
    return tuple(t.shape), name, raw


def _pack(out: bytearray, x) -> None:
    if x is None:
        out.append(0xC0)
    elif x is True:
        out.append(0xC3)
    elif x is False:
        out.append(0xC2)
    elif isinstance(x, (np.ndarray, torch.Tensor)):
        nbytes = (x.nbytes if isinstance(x, np.ndarray)
                  else x.numel() * x.element_size())
        if nbytes > MAX_CHUNK_SIZE:
            raise ValueError(
                f"an array of {nbytes} bytes needs flax's chunked form "
                f"(over {MAX_CHUNK_SIZE} bytes), which this codec reads but "
                f"does not write")
        if isinstance(x, np.ndarray):
            if x.dtype.hasobject or x.dtype.isalignedstruct:
                raise ValueError("object and structured dtypes cannot be "
                                 "serialized")
            parts = (x.shape, x.dtype.name, x.tobytes("C"))
        else:
            parts = _tensor_parts(x)
        _pack_ext(out, EXT_NDARRAY, _array_bytes(*parts))
    elif isinstance(x, np.generic):
        a = np.asarray(x)
        _pack_ext(out, EXT_NPSCALAR, _array_bytes(a.shape, a.dtype.name,
                                                  a.tobytes("C")))
    elif type(x) is int:
        _pack_int(out, x)
    elif type(x) is float:
        out.append(0xCB)
        out += struct.pack(">d", x)
    elif type(x) is str:
        b = x.encode("utf-8")
        _head(out, len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += b
    elif type(x) in (bytes, bytearray):
        _head(out, len(x), None, 0, (0xC4, 0xC5, 0xC6))
        out += x
    elif type(x) in (list, tuple):
        _head(out, len(x), 0x90, 15, (0, 0xDC, 0xDD))
        for v in x:
            _pack(out, v)
    elif type(x) is dict:
        _head(out, len(x), 0x80, 15, (0, 0xDE, 0xDF))
        for k, v in x.items():
            _pack(out, k)
            _pack(out, v)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def packb(tree) -> bytes:
    """A tree of dicts (str keys), lists, Python scalars, numpy arrays and
    scalars and torch tensors -> the bytes ``flax.serialization.to_bytes``
    gives for the same tree."""
    out = bytearray()
    _pack(out, tree)
    return bytes(out)


# ---------------------------------------------------------------------------
# Reading
# ---------------------------------------------------------------------------

class _Reader:
    def __init__(self, data: bytes, raw: bool):
        self.data, self.pos, self.raw = memoryview(data), 0, raw

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack data")
        b = self.data[self.pos:self.pos + n]
        self.pos += n
        return b

    def num(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]

    def text(self, n: int):
        b = bytes(self.take(n))
        return b if self.raw else b.decode("utf-8")

    def seq(self, n: int) -> list:
        return [self.read() for _ in range(n)]

    def mapping(self, n: int) -> dict:
        out = {}
        for _ in range(n):
            k = self.read()
            out[k] = self.read()
        return out

    def ext(self, n: int):
        code = self.num(">b")
        return _ext(code, bytes(self.take(n)))

    def read(self):
        c = self.num(">B")
        if c <= 0x7F:
            return c
        if c >= 0xE0:
            return c - 0x100
        if 0x80 <= c <= 0x8F:
            return self.mapping(c & 0x0F)
        if 0x90 <= c <= 0x9F:
            return self.seq(c & 0x0F)
        if 0xA0 <= c <= 0xBF:
            return self.text(c & 0x1F)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if c in simple:
            return simple[c]
        if c in (0xC4, 0xC5, 0xC6):
            return bytes(self.take(self.num((">B", ">H", ">I")[c - 0xC4])))
        if c in (0xC7, 0xC8, 0xC9):
            return self.ext(self.num((">B", ">H", ">I")[c - 0xC7]))
        if c == 0xCA:
            return self.num(">f")
        if c == 0xCB:
            return self.num(">d")
        if 0xCC <= c <= 0xD3:
            return self.num((">B", ">H", ">I", ">Q",
                             ">b", ">h", ">i", ">q")[c - 0xCC])
        if 0xD4 <= c <= 0xD8:
            return self.ext(1 << (c - 0xD4))
        if c in (0xD9, 0xDA, 0xDB):
            return self.text(self.num((">B", ">H", ">I")[c - 0xD9]))
        if c in (0xDC, 0xDD):
            return self.seq(self.num((">H", ">I")[c - 0xDC]))
        if c in (0xDE, 0xDF):
            return self.mapping(self.num((">H", ">I")[c - 0xDE]))
        raise ValueError(f"unknown msgpack type byte 0x{c:02x}")


def _array(data: bytes):
    """Ext 1's payload -> a CPU tensor (a copy, writable)."""
    shape, name, raw = _Reader(data, raw=True).read()
    name = name.decode() if isinstance(name, bytes) else name
    if name == "bfloat16":
        words = np.frombuffer(raw, dtype=np.int16).reshape(shape)
        return torch.from_numpy(words.copy()).view(torch.bfloat16)
    a = np.frombuffer(raw, dtype=np.dtype(name)).reshape(shape)
    return torch.from_numpy(a.copy())


def _ext(code: int, data: bytes):
    if code == EXT_NDARRAY:
        return _array(data)
    if code == EXT_NPSCALAR:
        t = _array(data)
        return t if t.dtype == torch.bfloat16 else t.numpy()[()]
    if code == EXT_COMPLEX:
        re, im = _Reader(data, raw=False).read()
        return complex(re, im)
    raise ValueError(f"unknown msgpack ext type {code}")


def _unchunk(x):
    """flax's ``_unchunk_array_leaves_in_place``: chunked maps back to
    arrays."""
    if not isinstance(x, dict):
        return x
    if _CHUNKED in x:
        shape = [x["shape"][str(i)] for i in range(len(x["shape"]))]
        chunks = [x["chunks"][str(i)] for i in range(len(x["chunks"]))]
        return torch.cat([c.reshape(-1) for c in chunks]).reshape(shape)
    return {k: _unchunk(v) for k, v in x.items()}


def unpackb(data: bytes):
    """``params.msgpack`` bytes -> the tree ``flax.serialization.
    msgpack_restore`` gives, with torch tensors for its arrays."""
    reader = _Reader(data, raw=False)
    tree = reader.read()
    if reader.pos != len(reader.data):
        raise ValueError("trailing bytes after the msgpack object")
    return _unchunk(tree)

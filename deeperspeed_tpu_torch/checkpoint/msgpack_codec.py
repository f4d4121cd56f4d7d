"""The msgpack form of a parameter tree that flax writes and reads
(``flax.serialization.msgpack_serialize`` / ``msgpack_restore``), without
flax or the ``msgpack`` package.

The JAX package's checkpoints are this form of its state trees, so the port
writes and reads it byte for byte.  The subset flax emits:

* maps with ``str`` keys, written in the tree's insertion order;
* arrays (``np.ndarray`` or ``torch.Tensor``, on any device) as ext type 1,
  whose payload is itself msgpack of ``(shape, dtype name, C-order bytes)``;
  numpy scalars as ext type 3, the payload of their 0-d array;
* nil, bool, int, float (always float 64), str and bin, each in the
  smallest msgpack form that holds it, as msgpack-python packs them;
* an array of more than ``MAX_CHUNK_SIZE`` bytes under a map key as flax's
  ``{"__msgpack_chunked_array__": True, "shape": {"0": d0, ...}, "chunks":
  {"0": flat chunk, ...}}``, each chunk ``MAX_CHUNK_SIZE // itemsize``
  elements (msgpack holds at most 2^32 - 1 bytes in one object).

:func:`encode` sizes the whole message first, then fills one buffer: each
array's bytes are copied once, straight from its tensor (a device tensor is
copied to the host into its place in the buffer), so a payload of N bytes
costs N bytes of host memory.  :func:`decode` reads a buffer without copying
array data: each array is a view of the buffer (``np.frombuffer``); only
chunked arrays are joined into a new one.  ``bfloat16``, which numpy lacks,
decodes to a ``torch.bfloat16`` tensor viewing the buffer.
"""

import struct

import numpy as np
import torch

# flax.serialization.MAX_CHUNK_SIZE: arrays above it are split (read at
# call time, so a test may lower it)
MAX_CHUNK_SIZE = 2 ** 30
CHUNKED_KEY = "__msgpack_chunked_array__"
EXT_NDARRAY, EXT_NPSCALAR = 1, 3

_TORCH_NAMES = {
    torch.float32: "float32", torch.float64: "float64", torch.float16: "float16",
    torch.bfloat16: "bfloat16", torch.int8: "int8", torch.int16: "int16",
    torch.int32: "int32", torch.int64: "int64", torch.uint8: "uint8",
    torch.bool: "bool",
}


# ------------------------------------------------------------------ encode
def _int(x):
    if x < -(1 << 63) or x >= (1 << 64):
        raise OverflowError(f"int {x} does not fit msgpack")
    if x >= 0:
        if x < 0x80:
            return bytes([x])
        if x <= 0xFF:
            return b"\xcc" + struct.pack(">B", x)
        if x <= 0xFFFF:
            return b"\xcd" + struct.pack(">H", x)
        if x <= 0xFFFFFFFF:
            return b"\xce" + struct.pack(">I", x)
        return b"\xcf" + struct.pack(">Q", x)
    if x >= -32:
        return struct.pack(">b", x)
    if x >= -0x80:
        return b"\xd0" + struct.pack(">b", x)
    if x >= -0x8000:
        return b"\xd1" + struct.pack(">h", x)
    if x >= -0x80000000:
        return b"\xd2" + struct.pack(">i", x)
    return b"\xd3" + struct.pack(">q", x)


def _sized(n, fix, fix_max, codes):
    """A length header: the fix form ``fix | n`` up to ``fix_max``, then the
    8/16/32-bit forms of ``codes`` (None where the family has none)."""
    if fix is not None and n <= fix_max:
        return bytes([fix | n])
    for code, fmt, top in zip(codes, (">B", ">H", ">I"), (0xFF, 0xFFFF, 0xFFFFFFFF)):
        if code is not None and n <= top:
            return bytes([code]) + struct.pack(fmt, n)
    raise OverflowError(f"length {n} does not fit msgpack")


def _str(s):
    b = s.encode("utf-8")
    return _sized(len(b), 0xA0, 31, (0xD9, 0xDA, 0xDB)) + b


def _bin_header(n):
    return _sized(n, None, 0, (0xC4, 0xC5, 0xC6))


def _array_header(n):
    return _sized(n, 0x90, 15, (None, 0xDC, 0xDD))


def _map_header(n):
    return _sized(n, 0x80, 15, (None, 0xDE, 0xDF))


def _ext_header(n, code):
    fixed = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixed:
        return bytes([fixed[n], code])
    return _sized(n, None, 0, (0xC7, 0xC8, 0xC9)) + bytes([code])


def _dtype_name(x):
    if isinstance(x, torch.Tensor):
        if x.dtype not in _TORCH_NAMES:
            raise TypeError(f"no msgpack dtype name for {x.dtype}")
        return _TORCH_NAMES[x.dtype]
    if x.dtype.hasobject or x.dtype.isalignedstruct:
        raise ValueError("object and structured dtypes cannot be serialized")
    return x.dtype.name


def _nbytes(x):
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) else x.nbytes


def _is_array(x):
    return isinstance(x, (np.ndarray, torch.Tensor))


class _Blob:
    """An array's bytes, copied into the message at fill time."""

    __slots__ = ("array", "nbytes")

    def __init__(self, array):
        self.array, self.nbytes = array, _nbytes(array)


def _array_parts(x, code=EXT_NDARRAY):
    name = _dtype_name(x)
    shape = tuple(x.shape)
    inner = (_array_header(3) + _array_header(len(shape))
             + b"".join(_int(int(d)) for d in shape) + _str(name))
    blob = _Blob(x)
    inner += _bin_header(blob.nbytes)
    return [_ext_header(len(inner) + blob.nbytes, code) + inner, blob]


def _chunked(x):
    """flax's ``_chunk``: the flat array in chunks of ``MAX_CHUNK_SIZE //
    itemsize`` elements."""
    itemsize = x.element_size() if isinstance(x, torch.Tensor) else x.dtype.itemsize
    size = max(1, int(MAX_CHUNK_SIZE / itemsize))
    flat = x.reshape(-1)
    n = flat.shape[0]
    return {CHUNKED_KEY: True,
            "shape": {str(i): int(d) for i, d in enumerate(x.shape)},
            "chunks": {str(j): flat[i:i + size]
                       for j, i in enumerate(range(0, n, size))}}


def _parts(x, out, chunk):
    if isinstance(x, dict):
        out.append(_map_header(len(x)))
        for k, v in x.items():
            if not isinstance(k, str):
                raise TypeError(f"a state dict must only have string keys, got {k!r}")
            out.append(_str(k))
            _parts(v, out, True)
    elif _is_array(x):
        if chunk and _nbytes(x) > MAX_CHUNK_SIZE:
            _parts(_chunked(x), out, False)
        else:
            out.extend(_array_parts(x))
    elif isinstance(x, np.generic):
        out.extend(_array_parts(np.asarray(x), EXT_NPSCALAR))
    elif x is None:
        out.append(b"\xc0")
    elif x is True or x is False:
        out.append(b"\xc3" if x else b"\xc2")
    elif isinstance(x, int):
        out.append(_int(x))
    elif isinstance(x, float):
        out.append(b"\xcb" + struct.pack(">d", x))
    elif isinstance(x, str):
        out.append(_str(x))
    elif isinstance(x, (bytes, bytearray, memoryview)):
        b = bytes(x)
        out.append(_bin_header(len(b)) + b)
    elif isinstance(x, (list, tuple)):
        out.append(_array_header(len(x)))
        for v in x:
            _parts(v, out, False)
    else:
        raise TypeError(f"cannot serialize {type(x).__name__}")


def _fill(buf, off, blob):
    n = blob.nbytes
    if n == 0:
        return
    x = blob.array
    if isinstance(x, torch.Tensor):
        dst = torch.frombuffer(buf, dtype=torch.uint8, count=n, offset=off)
        dst.copy_(x.detach().reshape(-1).view(torch.uint8))
    else:
        dst = np.frombuffer(buf, dtype=np.uint8, count=n, offset=off)
        dst[:] = np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def encode(tree):
    """The msgpack bytes of ``tree`` as flax writes it, in one new buffer
    (a writable ``memoryview``)."""
    parts = []
    _parts(tree, parts, True)
    total = sum(p.nbytes if isinstance(p, _Blob) else len(p) for p in parts)
    buf = np.empty(total, dtype=np.uint8).data
    off = 0
    for p in parts:
        if isinstance(p, _Blob):
            _fill(buf, off, p)
            off += p.nbytes
        else:
            buf[off:off + len(p)] = p
            off += len(p)
    return buf


# ------------------------------------------------------------------ decode
_SIMPLE = {0xC0: None, 0xC2: False, 0xC3: True}
_NUMBERS = {0xCA: (">f", 4), 0xCB: (">d", 8), 0xCC: (">B", 1), 0xCD: (">H", 2),
            0xCE: (">I", 4), 0xCF: (">Q", 8), 0xD0: (">b", 1), 0xD1: (">h", 2),
            0xD2: (">i", 4), 0xD3: (">q", 8)}
_FIXEXT = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
# type byte -> (length format, its width, what follows)
_SIZED = {0xC4: (">B", 1, "bin"), 0xC5: (">H", 2, "bin"), 0xC6: (">I", 4, "bin"),
          0xD9: (">B", 1, "str"), 0xDA: (">H", 2, "str"), 0xDB: (">I", 4, "str"),
          0xDC: (">H", 2, "array"), 0xDD: (">I", 4, "array"),
          0xDE: (">H", 2, "map"), 0xDF: (">I", 4, "map"),
          0xC7: (">B", 1, "ext"), 0xC8: (">H", 2, "ext"), 0xC9: (">I", 4, "ext")}


class _Reader:
    """msgpack values from a buffer; ``views``: bin values as views of it
    (inside an array's payload) rather than ``bytes``."""

    def __init__(self, buf, views=False):
        self.buf = memoryview(buf).cast("B")
        self.pos = 0
        self.views = views

    def take(self, n):
        if self.pos + n > len(self.buf):
            raise ValueError("truncated msgpack data")
        view = self.buf[self.pos:self.pos + n]
        self.pos += n
        return view

    def unpack(self, fmt, n):
        return struct.unpack(fmt, self.take(n))[0]

    def value(self):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F)
        if b in _SIMPLE:
            return _SIMPLE[b]
        if b in _NUMBERS:
            return self.unpack(*_NUMBERS[b])
        if b in _FIXEXT:
            return self.ext(_FIXEXT[b])
        if b not in _SIZED:
            raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")
        fmt, width, kind = _SIZED[b]
        n = self.unpack(fmt, width)
        if kind == "bin":
            return self.take(n) if self.views else bytes(self.take(n))
        return getattr(self, kind)(n)

    def map(self, n):
        out = {}
        for _ in range(n):
            k = self.value()
            out[k] = self.value()
        return out

    def array(self, n):
        return [self.value() for _ in range(n)]

    def str(self, n):
        return str(self.take(n), "utf-8")

    def ext(self, n):
        code = self.take(1)[0]
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"unsupported msgpack ext type {code}")
        inner = _Reader(payload, views=True)
        shape, name, data = inner.value()
        arr = _array_from(data, name, tuple(shape))
        return arr[()] if code == EXT_NPSCALAR else arr


def _array_from(data, name, shape):
    if name == "bfloat16":
        if len(data) == 0:
            return torch.empty(shape, dtype=torch.bfloat16)
        if data.readonly:           # a tensor cannot view read-only memory
            data = bytearray(data)
        return torch.frombuffer(data, dtype=torch.bfloat16).reshape(shape)
    return np.frombuffer(data, dtype=np.dtype(name)).reshape(shape)


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED_KEY in tree:
        shape = tuple(tree["shape"][str(i)] for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    for k, v in tree.items():
        tree[k] = _unchunk(v)
    return tree


def decode(buf):
    """The tree in msgpack bytes written by flax or by :func:`encode`:
    dicts, numpy arrays viewing ``buf`` (bfloat16 as torch tensors),
    numpy scalars and Python values; chunked arrays joined."""
    reader = _Reader(buf)
    tree = reader.value()
    if reader.pos != len(reader.buf):
        raise ValueError(f"{len(reader.buf) - reader.pos} trailing bytes after msgpack data")
    return _unchunk(tree)

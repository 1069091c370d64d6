"""Flax's msgpack checkpoint format, read and written in pure Python (no
``msgpack``, no ``flax``): ``flax.serialization.to_bytes`` /
``from_bytes`` of a parameter tree, as the JAX package writes the
generator-only ``*.generator.msgpack`` sidecar of a vocoder.

The format is msgpack of the tree's state dict: maps with str keys
(lists and tuples become maps keyed "0", "1", ...), str, bin, ints,
floats, nil and bool, and two extension types whose payload is itself
msgpack of the triple ``(shape, dtype name, C-order bytes)``:
``ndarray = 1`` and ``npscalar = 3``. An array leaf above
``MAX_CHUNK_SIZE`` bytes is stored as ``{"__msgpack_chunked_array__":
True, "shape": {...}, "chunks": {"0": ..., ...}}`` of its flattened
pieces. The dtype name ``bfloat16`` (which numpy lacks) reads as a
``torch.bfloat16`` tensor; every other array leaf reads as a numpy array.
"""

import struct
from typing import Any, Dict

import numpy as np
import torch

MAX_CHUNK_SIZE = 2 ** 30  # bytes of one leaf before it is chunked, as in Flax
EXT_NDARRAY, EXT_NPSCALAR = 1, 3
CHUNKED = "__msgpack_chunked_array__"


# ---------------------------------------------------------------- reading


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.data):
            raise ValueError("msgpack: truncated data")
        out = self.data[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str):
        return struct.unpack(">" + fmt, self.take(struct.calcsize(fmt)))[0]

    def value(self, raw: bool = False):
        b = self.take(1)[0]
        if b <= 0x7F:
            return b
        if b >= 0xE0:
            return b - 0x100
        if 0x80 <= b <= 0x8F:
            return self.map(b & 0x0F, raw)
        if 0x90 <= b <= 0x9F:
            return self.array(b & 0x0F, raw)
        if 0xA0 <= b <= 0xBF:
            return self.str(b & 0x1F, raw)
        simple = {0xC0: None, 0xC2: False, 0xC3: True}
        if b in simple:
            return simple[b]
        sized = {0xC4: "B", 0xC5: "H", 0xC6: "I"}           # bin
        if b in sized:
            return self.take(self.unpack(sized[b]))
        sized = {0xD9: "B", 0xDA: "H", 0xDB: "I"}           # str
        if b in sized:
            return self.str(self.unpack(sized[b]), raw)
        numbers = {0xCA: "f", 0xCB: "d", 0xCC: "B", 0xCD: "H", 0xCE: "I", 0xCF: "Q",
                   0xD0: "b", 0xD1: "h", 0xD2: "i", 0xD3: "q"}
        if b in numbers:
            return self.unpack(numbers[b])
        if b in (0xDC, 0xDD):
            return self.array(self.unpack("H" if b == 0xDC else "I"), raw)
        if b in (0xDE, 0xDF):
            return self.map(self.unpack("H" if b == 0xDE else "I"), raw)
        fixext = {0xD4: 1, 0xD5: 2, 0xD6: 4, 0xD7: 8, 0xD8: 16}
        if b in fixext:
            return self.ext(fixext[b])
        sized = {0xC7: "B", 0xC8: "H", 0xC9: "I"}           # ext
        if b in sized:
            return self.ext(self.unpack(sized[b]))
        raise ValueError(f"msgpack: unknown type byte 0x{b:02x}")

    def str(self, n: int, raw: bool):
        s = self.take(n)
        return s if raw else s.decode("utf-8")

    def array(self, n: int, raw: bool):
        return [self.value(raw) for _ in range(n)]

    def map(self, n: int, raw: bool):
        out = {}
        for _ in range(n):
            key = self.value(raw)
            out[key] = self.value(raw)
        return out

    def ext(self, n: int):
        code = struct.unpack(">b", self.take(1))[0]
        payload = self.take(n)
        if code not in (EXT_NDARRAY, EXT_NPSCALAR):
            raise ValueError(f"msgpack: extension type {code} is not a Flax array")
        arr = _array_from_payload(payload)
        return arr[()] if code == EXT_NPSCALAR and isinstance(arr, np.ndarray) else arr


def _array_from_payload(payload: bytes):
    r = _Reader(payload)
    shape, name, buffer = r.value(raw=True)
    if r.pos != len(payload):
        raise ValueError("msgpack: trailing bytes in an array payload")
    shape = tuple(int(s) for s in shape)
    if name == b"bfloat16":
        flat = torch.frombuffer(bytearray(buffer), dtype=torch.int16).view(torch.bfloat16)
        return flat.reshape(shape)
    return np.frombuffer(buffer, dtype=np.dtype(name.decode())).reshape(shape).copy()


def _unchunk(tree):
    if not isinstance(tree, dict):
        return tree
    if CHUNKED in tree:
        shape = tuple(int(tree["shape"][str(i)]) for i in range(len(tree["shape"])))
        chunks = [tree["chunks"][str(i)] for i in range(len(tree["chunks"]))]
        if isinstance(chunks[0], torch.Tensor):
            return torch.cat(chunks).reshape(shape)
        return np.concatenate(chunks).reshape(shape)
    return {k: _unchunk(v) for k, v in tree.items()}


def msgpack_restore(data: bytes):
    """Bytes of ``flax.serialization.to_bytes`` -> the nested state dict,
    array leaves as numpy arrays (``torch.bfloat16`` tensors for bf16),
    chunked leaves joined."""
    r = _Reader(data)
    tree = r.value()
    if r.pos != len(data):
        raise ValueError("msgpack: trailing bytes after the top-level object")
    return _unchunk(tree)


# ---------------------------------------------------------------- writing


def _pack_len(out: bytearray, n: int, fix: int, fix_max: int, codes) -> None:
    if n <= fix_max and fix is not None:
        out.append(fix | n)
    elif n < 2 ** 8 and codes[0] is not None:
        out += bytes([codes[0]]) + struct.pack(">B", n)
    elif n < 2 ** 16:
        out += bytes([codes[1]]) + struct.pack(">H", n)
    else:
        out += bytes([codes[2]]) + struct.pack(">I", n)


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out.append(0xC0)
    elif obj is True or obj is False:
        out.append(0xC3 if obj else 0xC2)
    elif isinstance(obj, (np.ndarray, torch.Tensor)):
        _pack_ext(EXT_NDARRAY, _array_payload(obj), out)
    elif isinstance(obj, np.generic):
        _pack_ext(EXT_NPSCALAR, _array_payload(np.asarray(obj)), out)
    elif isinstance(obj, int):
        # the smallest encoding, as the msgpack package writes it
        if 0 <= obj <= 0x7F or -32 <= obj < 0:
            out += struct.pack(">b" if obj < 0 else ">B", obj)
        elif obj >= 0:
            for code, fmt, top in ((0xCC, "B", 2 ** 8), (0xCD, "H", 2 ** 16),
                                   (0xCE, "I", 2 ** 32), (0xCF, "Q", 2 ** 64)):
                if obj < top:
                    out += bytes([code]) + struct.pack(">" + fmt, obj)
                    break
        else:
            for code, fmt, low in ((0xD0, "b", -2 ** 7), (0xD1, "h", -2 ** 15),
                                   (0xD2, "i", -2 ** 31), (0xD3, "q", -2 ** 63)):
                if obj >= low:
                    out += bytes([code]) + struct.pack(">" + fmt, obj)
                    break
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        raw = obj.encode("utf-8")
        _pack_len(out, len(raw), 0xA0, 31, (0xD9, 0xDA, 0xDB))
        out += raw
    elif isinstance(obj, (bytes, bytearray)):
        _pack_len(out, len(obj), None, -1, (0xC4, 0xC5, 0xC6))
        out += obj
    elif isinstance(obj, dict):
        _pack_len(out, len(obj), 0x80, 15, (None, 0xDE, 0xDF))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, (list, tuple)):
        _pack_len(out, len(obj), 0x90, 15, (None, 0xDC, 0xDD))
        for v in obj:
            _pack(v, out)
    else:
        raise TypeError(f"msgpack: cannot pack {type(obj).__name__}")


def _pack_ext(code: int, payload: bytes, out: bytearray) -> None:
    n = len(payload)
    fixext = {1: 0xD4, 2: 0xD5, 4: 0xD6, 8: 0xD7, 16: 0xD8}
    if n in fixext:
        out.append(fixext[n])
    else:
        _pack_len(out, n, None, -1, (0xC7, 0xC8, 0xC9))
    out += struct.pack(">b", code) + payload


def _array_payload(arr) -> bytes:
    if isinstance(arr, torch.Tensor):
        t = arr.detach().cpu().contiguous()
        if t.dtype == torch.bfloat16:
            name, buffer = "bfloat16", t.view(torch.int16).numpy().tobytes()
        else:
            a = t.numpy()
            name, buffer = a.dtype.name, a.tobytes("C")
        shape = tuple(t.shape)
    else:
        if arr.dtype.hasobject:
            raise ValueError("msgpack: object arrays are not taken")
        name, buffer, shape = arr.dtype.name, np.ascontiguousarray(arr).tobytes("C"), arr.shape
    out = bytearray()
    _pack([list(shape), name, buffer], out)
    return bytes(out)


def _nbytes(arr) -> int:
    return arr.numel() * arr.element_size() if isinstance(arr, torch.Tensor) else arr.nbytes


def _chunk(tree):
    """Flax's state dict of ``tree``: lists as maps keyed "0", "1", ...,
    leaves above MAX_CHUNK_SIZE bytes chunked."""
    if isinstance(tree, dict):
        return {str(k): _chunk(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _chunk(v) for i, v in enumerate(tree)}
    if isinstance(tree, (np.ndarray, torch.Tensor)) and _nbytes(tree) > MAX_CHUNK_SIZE:
        flat = tree.reshape(-1)
        itemsize = _nbytes(tree) // max(flat.shape[0], 1)
        step = max(1, MAX_CHUNK_SIZE // itemsize)
        pieces = [flat[i:i + step] for i in range(0, flat.shape[0], step)]
        return {CHUNKED: True, "shape": {str(i): int(s) for i, s in enumerate(tree.shape)},
                "chunks": {str(i): p for i, p in enumerate(pieces)}}
    return tree


def to_bytes(tree: Dict[str, Any]) -> bytes:
    """A nested dict of numpy arrays (or torch tensors) -> the bytes that
    ``flax.serialization.to_bytes`` gives for the same tree."""
    out = bytearray()
    _pack(_chunk(tree), out)
    return bytes(out)

"""Msgpack + zstd pytree checkpoints, one file format for both packages.

The JAX package's ``checkpoint/msgpack_ckpt.py`` writes a tree as one
compressed msgpack document; this module reads and writes the same bytes
without the ``msgpack`` package: a plain-Python encoder and decoder for
exactly the subset that format uses -- maps with str keys, arrays (lists),
bin, str, ints, float64, bool and nil -- with the reference's tags:

* ``__array__``: ``dtype`` (numpy's ``.str``, or the name ``bfloat16`` /
  ``float8_e4m3fn`` / ``float8_e5m2``), ``shape`` and the raw bytes;
* ``__scalar__``: a numpy scalar's dtype and Python value;
* ``__namedtuple__``: the type name and its fields (read back as a dict);
* ``__tuple__``: the items.

Tensors and numpy arrays are written as arrays (a CUDA tensor is copied
to the host first); bf16 and fp8 tensors go by name from their raw bytes,
viewed as integers, since numpy has no such dtype here.  Arrays read back
as CPU tensors.  Integers take the smallest msgpack form and Python floats
float64, as ``msgpack.packb(..., use_bin_type=True)`` writes them, so the
encoder's bytes equal the package's.

Compression as the reference: zstd when ``zstandard`` imports, zlib
otherwise; reading a zstd frame without ``zstandard`` raises the
reference's error.  ``save_trainer`` writes the params in the reference's
layout (``convert.params_to_jax``), so a trainer file of either package
loads in the other; a LoRA trainer's file adds its adapter state and A
bases under keys the reference's ``load_trainer`` does not read.
"""
from __future__ import annotations

import json
import os
import struct
import zlib
from typing import Any

import numpy as np
import torch

from repro_torch.convert import params_from_jax, params_to_jax

try:
    import zstandard
except ImportError:  # optional: fall back to stdlib zlib, as the reference
    zstandard = None

_ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"

_ARRAY = "__array__"
_NAMEDTUPLE = "__namedtuple__"
_TUPLE = "__tuple__"
_SCALAR = "__scalar__"

# dtypes numpy lacks here: written by name, their bytes viewed as integers
_BY_NAME = {torch.bfloat16: ("bfloat16", torch.int16),
            torch.float8_e4m3fn: ("float8_e4m3fn", torch.uint8),
            torch.float8_e5m2: ("float8_e5m2", torch.uint8)}
_FROM_NAME = {name: (dt, np.int16 if raw == torch.int16 else np.uint8)
              for dt, (name, raw) in _BY_NAME.items()}

PyTree = Any


def _compress(data: bytes) -> bytes:
    if zstandard is not None:
        return zstandard.ZstdCompressor(level=3).compress(data)
    return zlib.compress(data, 6)


def _decompress(data: bytes) -> bytes:
    if data[:4] == _ZSTD_MAGIC:
        if zstandard is None:
            raise RuntimeError("checkpoint is zstd-compressed but the "
                               "'zstandard' package is not installed")
        return zstandard.ZstdDecompressor().decompress(data)
    return zlib.decompress(data)


# ---------------------------------------------------------------- msgpack

def _pack_int(x: int, out: bytearray) -> None:
    if -0x20 <= x < 0x80:
        out += struct.pack("b" if x < 0 else "B", x)
    elif 0x80 <= x <= 0xFF:
        out += b"\xcc" + struct.pack("B", x)
    elif -0x80 <= x < 0:
        out += b"\xd0" + struct.pack("b", x)
    elif 0xFF < x <= 0xFFFF:
        out += b"\xcd" + struct.pack(">H", x)
    elif -0x8000 <= x < -0x80:
        out += b"\xd1" + struct.pack(">h", x)
    elif 0xFFFF < x <= 0xFFFFFFFF:
        out += b"\xce" + struct.pack(">I", x)
    elif -0x80000000 <= x < -0x8000:
        out += b"\xd2" + struct.pack(">i", x)
    elif 0xFFFFFFFF < x <= 0xFFFFFFFFFFFFFFFF:
        out += b"\xcf" + struct.pack(">Q", x)
    elif -0x8000000000000000 <= x < -0x80000000:
        out += b"\xd3" + struct.pack(">q", x)
    else:
        raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _pack_len(n: int, out: bytearray, fix: int | None, fix_max: int,
              codes: tuple[tuple[int, bytes, str], ...]) -> None:
    """A length header: the fix form below ``fix_max``, else the first of
    ``codes`` (limit, marker, struct format) that holds ``n``."""
    if fix is not None and n < fix_max:
        out.append(fix | n)
        return
    for limit, marker, fmt in codes:
        if n <= limit:
            out += marker + struct.pack(fmt, n)
            return
    raise ValueError(f"length {n} too large for msgpack")


def _pack(obj, out: bytearray) -> None:
    if obj is None:
        out += b"\xc0"
    elif obj is True:
        out += b"\xc3"
    elif obj is False:
        out += b"\xc2"
    elif isinstance(obj, int):
        _pack_int(obj, out)
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), out, 0xA0, 32, ((0xFF, b"\xd9", "B"),
                                              (0xFFFF, b"\xda", ">H"),
                                              (0xFFFFFFFF, b"\xdb", ">I")))
        out += data
    elif isinstance(obj, (bytes, bytearray, memoryview)):
        data = bytes(obj)
        _pack_len(len(data), out, None, 0, ((0xFF, b"\xc4", "B"),
                                             (0xFFFF, b"\xc5", ">H"),
                                             (0xFFFFFFFF, b"\xc6", ">I")))
        out += data
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), out, 0x90, 16, ((0xFFFF, b"\xdc", ">H"),
                                             (0xFFFFFFFF, b"\xdd", ">I")))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), out, 0x80, 16, ((0xFFFF, b"\xde", ">H"),
                                             (0xFFFFFFFF, b"\xdf", ">I")))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__!r} object")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = memoryview(data), 0

    def take(self, n: int) -> memoryview:
        if self.pos + n > len(self.data):
            raise ValueError("truncated msgpack document")
        view = self.data[self.pos:self.pos + n]
        self.pos += n
        return view

    def fmt(self, fmt: str):
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


# marker -> (kind, struct format of its length or value)
_SIZED = {0xD9: ("str", "B"), 0xDA: ("str", ">H"), 0xDB: ("str", ">I"),
          0xC4: ("bin", "B"), 0xC5: ("bin", ">H"), 0xC6: ("bin", ">I"),
          0xDC: ("array", ">H"), 0xDD: ("array", ">I"),
          0xDE: ("map", ">H"), 0xDF: ("map", ">I")}
_NUMBERS = {0xCC: "B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q", 0xD0: "b",
            0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}


def _unpack(r: _Reader):
    b = r.take(1)[0]
    if b <= 0x7F:
        return b
    if b >= 0xE0:
        return b - 0x100
    if 0x80 <= b <= 0x8F:
        return _unpack_map(r, b & 0x0F)
    if 0x90 <= b <= 0x9F:
        return [_unpack(r) for _ in range(b & 0x0F)]
    if 0xA0 <= b <= 0xBF:
        return str(r.take(b & 0x1F), "utf-8")
    if b == 0xC0:
        return None
    if b in (0xC2, 0xC3):
        return b == 0xC3
    if b in _NUMBERS:
        return r.fmt(_NUMBERS[b])
    if b in _SIZED:
        kind, fmt = _SIZED[b]
        n = r.fmt(fmt)
        if kind == "str":
            return str(r.take(n), "utf-8")
        if kind == "bin":
            return bytes(r.take(n))
        if kind == "array":
            return [_unpack(r) for _ in range(n)]
        return _unpack_map(r, n)
    raise ValueError(f"msgpack type 0x{b:02x} is outside the checkpoint format")


def _unpack_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _unpack(r)
        out[k] = _unpack(r)
    return out


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the subset above."""
    r = _Reader(data)
    obj = _unpack(r)
    if r.pos != len(r.data):
        raise ValueError("trailing bytes after the msgpack document")
    return obj


# ---------------------------------------------------------------- the tree

def _array(t: torch.Tensor) -> dict:
    t = t.detach().cpu().contiguous()
    if t.dtype in _BY_NAME:
        name, raw = _BY_NAME[t.dtype]
        data = t.view(raw).numpy().tobytes()
    else:
        a = t.numpy()
        name, data = a.dtype.str, a.tobytes()
    return {_ARRAY: True, "dtype": name, "shape": list(t.shape), "data": data}


def _encode(obj):
    if isinstance(obj, torch.Tensor):
        return _array(obj)
    if isinstance(obj, np.ndarray):
        return {_ARRAY: True, "dtype": obj.dtype.str, "shape": list(obj.shape),
                "data": obj.tobytes()}
    if isinstance(obj, (np.integer, np.floating)):
        return {_SCALAR: True, "dtype": obj.dtype.str, "value": obj.item()}
    if isinstance(obj, tuple) and hasattr(obj, "_fields"):  # NamedTuple
        return {_NAMEDTUPLE: type(obj).__name__,
                "fields": {f: _encode(v) for f, v in zip(obj._fields, obj)}}
    if isinstance(obj, tuple):
        return {_TUPLE: True, "items": [_encode(v) for v in obj]}
    if isinstance(obj, list):
        return [_encode(v) for v in obj]
    if isinstance(obj, dict):
        return {str(k): _encode(v) for k, v in obj.items()}
    return obj


def _tensor(name: str, shape: list, data: bytes) -> torch.Tensor:
    if name in _FROM_NAME:
        dt, raw = _FROM_NAME[name]
        return torch.from_numpy(np.frombuffer(data, raw).copy()).view(dt).reshape(shape)
    return torch.from_numpy(np.frombuffer(data, np.dtype(name)).copy()).reshape(shape)


def _decode(obj):
    if isinstance(obj, dict):
        if obj.get(_ARRAY):
            return _tensor(obj["dtype"], obj["shape"], obj["data"])
        if obj.get(_SCALAR):
            return np.dtype(obj["dtype"]).type(obj["value"])
        if _NAMEDTUPLE in obj:  # decoded as a plain dict, as the reference
            return {f: _decode(v) for f, v in obj["fields"].items()}
        if obj.get(_TUPLE):
            return tuple(_decode(v) for v in obj["items"])
        return {k: _decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_decode(v) for v in obj]
    return obj


def save_pytree(path: str, tree: PyTree, metadata: dict | None = None) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(_compress(packb(_encode(tree))))
    if metadata is not None:
        with open(path + ".meta.json", "w") as f:
            json.dump(metadata, f, indent=2, default=str)


def load_pytree(path: str) -> PyTree:
    with open(path, "rb") as f:
        packed = _decompress(f.read())
    return _decode(unpackb(packed))


def _lora_engine(trainer):
    """The trainer's engine when it exchanges LoRA adapters, else None."""
    engine = getattr(trainer, "engine", None)
    return engine if getattr(engine, "adapters", None) is not None else None


def save_trainer(path: str, trainer, extra: dict | None = None) -> None:
    """Checkpoint a FedAvg/Astraea trainer: params (the reference's
    layout) + round + WAN traffic, and the ``.meta.json``.  Under LoRA the
    params are the frozen backbone, so the file also holds what the rounds
    train, the adapter state (``adapters``), and the frozen A bases
    (``lora_a``): both keyed and laid out as the reference's trees."""
    meta = {"round": trainer._round, "traffic_mb": trainer.comm.megabytes}
    meta.update(extra or {})
    tree = {"params": params_to_jax(trainer.params),
            "round": trainer._round,
            "traffic_bytes": trainer.comm.total_bytes}
    engine = _lora_engine(trainer)
    if engine is not None:
        tree["adapters"] = dict(engine.adapters)
        tree["lora_a"] = dict(engine.lora_args()[1])
    save_pytree(path, tree, meta)


def load_trainer(path: str, trainer):
    """Restore what ``save_trainer`` wrote (as the reference, not the
    selection rng) into ``trainer``, on its device.  A LoRA trainer needs
    a file with its adapter state and A bases, and a full-delta trainer
    one without: either mismatch raises."""
    state = load_pytree(path)
    engine = _lora_engine(trainer)
    if (engine is not None) != ("adapters" in state):
        raise ValueError(
            "checkpoint and trainer disagree on LoRA: the file "
            f"{'holds' if 'adapters' in state else 'lacks'} an adapter state, "
            f"the trainer {'exchanges' if engine is not None else 'has no'} adapters")
    trainer.params = params_from_jax(state["params"])
    if engine is not None:
        adapters = state["adapters"]
        if set(adapters) != set(engine.adapters):
            raise ValueError(f"adapter paths {sorted(adapters)} != the mapping's "
                             f"{sorted(engine.adapters)}")
        bad = [k for k, v in engine.adapters.items() if adapters[k].shape != v.shape]
        if bad:
            raise ValueError(f"adapter shapes differ from the mapping's at {bad}")
        engine.load_lora_a(state["lora_a"])
        engine.server_state = {k: adapters[k].to(device=v.device, dtype=v.dtype)
                               .contiguous() for k, v in engine.adapters.items()}
    trainer._round = int(state["round"])
    trainer.comm.total_bytes = float(state["traffic_bytes"])
    return trainer

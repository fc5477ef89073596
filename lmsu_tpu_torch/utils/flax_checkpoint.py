"""Read the JAX package's trainer checkpoints (flax msgpack) without msgpack
or flax.

The JAX package writes a checkpoint as `flax.serialization.to_bytes` of its
state dict (lmsu_tpu/training/checkpoint.py:29-43): msgpack maps of str
keys, with array leaves packed as flax's ext types (flax/serialization.py
`_msgpack_ext_pack`):

  ext 1  ndarray: msgpack (shape, dtype name, C-order bytes)
  ext 2  complex: msgpack (real, imag)
  ext 3  numpy scalar: as ext 1, unpacked to a numpy scalar

and arrays over 2^30 bytes split into `{"__msgpack_chunked_array__": True,
"shape": {...}, "chunks": {...}}` maps. `msgpack_restore` decodes exactly
that subset of msgpack (maps, arrays, str, bin, ints, floats, nil, bool and
those ext types) into what flax's own `msgpack_restore` returns: nested
dicts and lists with numpy leaves. bfloat16 arrays, which numpy cannot hold
without flax's dtype package, are widened to float32 (exactly).

`load_model_variables` is the JAX package's (checkpoint.py:141-161): the
EMA shadow when the checkpoint has one, else the parameters, the KD layout
{"model", "proj"} unwrapped to its model, and the BatchNorm statistics.
"""

from __future__ import annotations

import struct
from typing import Any, Dict, Tuple

import numpy as np

_CHUNKED = "__msgpack_chunked_array__"


def _ndarray(data: bytes) -> np.ndarray:
    (shape, dtype, buf), _ = _decode(data, 0, raw=True)
    dtype = dtype.decode() if isinstance(dtype, bytes) else dtype
    if dtype == "bfloat16":
        bits = np.frombuffer(buf, dtype="<u2").astype(np.uint32) << 16
        return bits.view(np.float32).reshape(shape)
    return np.frombuffer(buf, dtype=np.dtype(dtype)).reshape(shape, order="C")


def _ext(code: int, data: bytes):
    if code == 1:
        return _ndarray(data)
    if code == 2:
        (re, im), _ = _decode(data, 0, raw=False)
        return complex(re, im)
    if code == 3:
        return _ndarray(data)[()]
    raise ValueError(f"unknown msgpack ext type {code}")


_FIXED = {0xc0: None, 0xc2: False, 0xc3: True}
_NUMS = {0xca: ">f", 0xcb: ">d", 0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
         0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
_LENS = {0xc4: (">B", "bin"), 0xc5: (">H", "bin"), 0xc6: (">I", "bin"),
         0xd9: (">B", "str"), 0xda: (">H", "str"), 0xdb: (">I", "str"),
         0xdc: (">H", "array"), 0xdd: (">I", "array"),
         0xde: (">H", "map"), 0xdf: (">I", "map")}
_FIXEXT = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}
_EXT = {0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}


def _decode(b: bytes, i: int, raw: bool) -> Tuple[Any, int]:
    """One msgpack object of `b` at offset i -> (object, next offset). With
    raw, str objects stay bytes (as flax reads its ndarray triples)."""
    t = b[i]
    i += 1
    if t <= 0x7f:
        return t, i
    if t >= 0xe0:
        return t - 0x100, i
    if 0xa0 <= t <= 0xbf:
        kind, n = "str", t & 0x1f
    elif 0x90 <= t <= 0x9f:
        kind, n = "array", t & 0x0f
    elif 0x80 <= t <= 0x8f:
        kind, n = "map", t & 0x0f
    elif t in _FIXED:
        return _FIXED[t], i
    elif t in _NUMS:
        fmt = _NUMS[t]
        return struct.unpack_from(fmt, b, i)[0], i + struct.calcsize(fmt)
    elif t in _LENS:
        fmt, kind = _LENS[t]
        n = struct.unpack_from(fmt, b, i)[0]
        i += struct.calcsize(fmt)
    elif t in _FIXEXT or t in _EXT:
        if t in _FIXEXT:
            n = _FIXEXT[t]
        else:
            n = struct.unpack_from(_EXT[t], b, i)[0]
            i += struct.calcsize(_EXT[t])
        code = struct.unpack_from(">b", b, i)[0]
        return _ext(code, bytes(b[i + 1:i + 1 + n])), i + 1 + n
    else:
        raise ValueError(f"msgpack type byte 0x{t:02x} is not in the subset flax writes")
    if kind == "bin":
        return bytes(b[i:i + n]), i + n
    if kind == "str":
        s = bytes(b[i:i + n])
        return (s if raw else s.decode("utf-8")), i + n
    if kind == "array":
        out = []
        for _ in range(n):
            v, i = _decode(b, i, raw)
            out.append(v)
        return out, i
    out = {}
    for _ in range(n):
        k, i = _decode(b, i, raw)
        v, i = _decode(b, i, raw)
        out[k] = v
    return out, i


def _unchunk(tree):
    if isinstance(tree, dict):
        if _CHUNKED in tree:
            shape = tuple(tree["shape"][str(j)] for j in range(len(tree["shape"])))
            chunks = [tree["chunks"][str(j)] for j in range(len(tree["chunks"]))]
            return np.concatenate(chunks).reshape(shape)
        return {k: _unchunk(v) for k, v in tree.items()}
    return tree


def msgpack_restore(data: bytes):
    """flax.serialization.msgpack_restore without msgpack or flax."""
    tree, end = _decode(memoryview(data), 0, raw=False)
    if end != len(data):
        raise ValueError(f"{len(data) - end} bytes after the msgpack object")
    return _unchunk(tree)


def load_checkpoint_raw(path: str) -> Dict[str, Any]:
    """A JAX-package checkpoint as nested dicts of numpy arrays."""
    with open(path, "rb") as f:
        return msgpack_restore(f.read())


def load_model_variables(path: str) -> Dict[str, Any]:
    """{'params', 'batch_stats'} of a JAX-package trainer checkpoint, plain
    or KD ({'model', 'proj'}) layout, the EMA shadow where there is one."""
    state = load_checkpoint_raw(path)["state"]
    params = state.get("ema_params") or state["params"]
    if isinstance(params, dict) and set(params) == {"model", "proj"}:
        params = params["model"]
    return {"params": params, "batch_stats": state["batch_stats"]}


def is_torch_file(path: str) -> bool:
    """True for a file torch.save wrote (a zip archive, 'PK'); a flax msgpack
    checkpoint opens with a map."""
    with open(path, "rb") as f:
        return f.read(2) == b"PK"

"""msgpack tree checkpoints, with a packer of their own.

Port of ``repro.checkpoint.msgpack_ckpt``, same on-disk format.  Layout:
``<dir>/step_<k>.msgpack``, each file one self-describing tree:

* arrays      -> {"__nd__": shape, "dtype": str, "data": bytes}
* NamedTuples -> {"__nt__": "module.QualName", "data": [fields...]}
* plain tuple -> {"__tuple__": [items...]}
* None        -> {"__none__": true}

An array of more bytes than a msgpack bin holds (2^32 - 1) has no
encoding in the reference's format; its ``"data"`` is then a list of bins
of at most ``BIN_CHUNK`` bytes each, in order (the port's one extension:
a file whose every array fits a bin is the reference's, byte for byte,
and the reference reads it).

Tensors go to host numpy one at a time as the file is written
(``restore`` returns numpy; the caller puts the leaves back on its device,
byte-exact).  numpy has no bfloat16 without ``ml_dtypes``, so a bf16 leaf
is written as the reference writes one, ``"dtype": "bfloat16"`` over its
raw 2-byte words, and restores as a CPU ``torch.bfloat16`` tensor through
a 16-bit view.  ``save`` streams the packed tree into the file (one
leaf's host copy at a time) and ``restore`` decodes from a memory map
(one copy of each leaf), so a checkpoint of tens of GB needs about its
own size in host memory, not three times it.  ``save`` writes atomically
(tmp + rename) and rotates old checkpoints (``keep=0`` keeps every step).

The encoder is ``packb``/``unpackb`` below, not the ``msgpack`` package:
the subset this format needs -- maps with str keys, arrays, str, bin,
int, float64, bool and nil -- written as ``msgpack.packb(...,
use_bin_type=True)`` writes it (smallest encoding of each int, str8 for
strings, float64 for floats), and read as ``msgpack.unpackb(...,
raw=False)`` reads it.
"""
from __future__ import annotations

import importlib
import mmap
import os
import re
import struct
from typing import Any

import numpy as np
import torch

# the most bytes one msgpack bin holds, and the bytes of each bin of a
# larger array's list
BIN_MAX = 0xFFFFFFFF
BIN_CHUNK = 1 << 31

# ---------------------------------------------------------------------------
# the msgpack subset
# ---------------------------------------------------------------------------

def _pack_int(x: int, out: list) -> None:
    if 0 <= x < 0x80:
        out.append(struct.pack("B", x))
    elif -0x20 <= x < 0:
        out.append(struct.pack("b", x))
    elif 0 <= x <= 0xFF:
        out.append(struct.pack(">BB", 0xCC, x))
    elif -0x80 <= x < 0:
        out.append(struct.pack(">Bb", 0xD0, x))
    elif 0 <= x <= 0xFFFF:
        out.append(struct.pack(">BH", 0xCD, x))
    elif -0x8000 <= x < 0:
        out.append(struct.pack(">Bh", 0xD1, x))
    elif 0 <= x <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", 0xCE, x))
    elif -0x80000000 <= x < 0:
        out.append(struct.pack(">Bi", 0xD2, x))
    elif 0 <= x <= 0xFFFFFFFFFFFFFFFF:
        out.append(struct.pack(">BQ", 0xCF, x))
    elif -0x8000000000000000 <= x < 0:
        out.append(struct.pack(">Bq", 0xD3, x))
    else:
        raise OverflowError(f"integer {x} does not fit msgpack's 64 bits")


def _pack_len(n: int, fix: int | None, fix_max: int, codes: tuple, out: list) -> None:
    """A length header: the fix form below ``fix_max``, else the 8-, 16-
    or 32-bit form (``codes``; None where msgpack has no 8-bit form)."""
    if fix is not None and n < fix_max:
        out.append(struct.pack("B", fix | n))
    elif codes[0] is not None and n <= 0xFF:
        out.append(struct.pack(">BB", codes[0], n))
    elif n <= 0xFFFF:
        out.append(struct.pack(">BH", codes[1], n))
    elif n <= 0xFFFFFFFF:
        out.append(struct.pack(">BI", codes[2], n))
    else:
        raise ValueError(f"object of length {n} is too large for msgpack")


def _pack(obj, out: list) -> None:
    if obj is None:
        out.append(b"\xc0")
    elif obj is True:
        out.append(b"\xc3")
    elif obj is False:
        out.append(b"\xc2")
    elif isinstance(obj, int):
        _pack_int(int(obj), out)
    elif isinstance(obj, float):
        out.append(struct.pack(">Bd", 0xCB, obj))
    elif isinstance(obj, str):
        data = obj.encode("utf-8")
        _pack_len(len(data), 0xA0, 32, (0xD9, 0xDA, 0xDB), out)
        out.append(data)
    elif isinstance(obj, (bytes, _Raw)):
        data = obj.buffer() if isinstance(obj, _Raw) else obj
        _pack_len(len(data), None, 0, (0xC4, 0xC5, 0xC6), out)
        out.append(data)
    elif isinstance(obj, (list, tuple)):
        _pack_len(len(obj), 0x90, 16, (None, 0xDC, 0xDD), out)
        for item in obj:
            _pack(item, out)
    elif isinstance(obj, dict):
        _pack_len(len(obj), 0x80, 16, (None, 0xDE, 0xDF), out)
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    else:
        raise TypeError(f"cannot pack {type(obj)}")


def packb(obj) -> bytes:
    """``msgpack.packb(obj, use_bin_type=True)`` for the subset above."""
    out: list = []
    _pack(obj, out)
    return b"".join(out)


# first byte -> (struct format of the length or value, what follows)
_FIXED = {0xCC: ">B", 0xCD: ">H", 0xCE: ">I", 0xCF: ">Q",
          0xD0: ">b", 0xD1: ">h", 0xD2: ">i", 0xD3: ">q", 0xCB: ">d"}
_SIZED = {0xD9: (">B", "str"), 0xDA: (">H", "str"), 0xDB: (">I", "str"),
          0xC4: (">B", "bin"), 0xC5: (">H", "bin"), 0xC6: (">I", "bin"),
          0xDC: (">H", "array"), 0xDD: (">I", "array"),
          0xDE: (">H", "map"), 0xDF: (">I", "map")}


class _Raw:
    """An array's raw bytes, taken (as a flat uint8 view of its host copy)
    only when the packer writes them."""

    def __init__(self, obj):
        self.obj = obj

    def buffer(self) -> memoryview:
        arr = self.obj
        if isinstance(arr, torch.Tensor):
            arr = arr.detach().cpu().contiguous()
            if arr.dtype == torch.bfloat16:
                arr = arr.view(torch.int16)
            arr = arr.numpy()
        return memoryview(np.ascontiguousarray(arr).reshape(-1).view(np.uint8))


def _unpack(buf: memoryview, pos: int, views: bool = False):
    b = buf[pos]
    pos += 1
    if b < 0x80:
        return b, pos
    if b >= 0xE0:
        return b - 0x100, pos
    if 0xA0 <= b <= 0xBF:
        kind, n = "str", b & 0x1F
    elif 0x90 <= b <= 0x9F:
        kind, n = "array", b & 0x0F
    elif 0x80 <= b <= 0x8F:
        kind, n = "map", b & 0x0F
    elif b == 0xC0:
        return None, pos
    elif b == 0xC2:
        return False, pos
    elif b == 0xC3:
        return True, pos
    elif b in _FIXED:
        fmt = _FIXED[b]
        size = struct.calcsize(fmt)
        return struct.unpack_from(fmt, buf, pos)[0], pos + size
    elif b in _SIZED:
        fmt, kind = _SIZED[b]
        n = struct.unpack_from(fmt, buf, pos)[0]
        pos += struct.calcsize(fmt)
    else:
        raise ValueError(f"msgpack type byte 0x{b:02x} is outside the subset")
    if kind == "str":
        return str(buf[pos:pos + n], "utf-8"), pos + n
    if kind == "bin":
        return (buf[pos:pos + n] if views else bytes(buf[pos:pos + n])), pos + n
    if kind == "array":
        items = []
        for _ in range(n):
            item, pos = _unpack(buf, pos, views)
            items.append(item)
        return items, pos
    out = {}
    for _ in range(n):
        k, pos = _unpack(buf, pos, views)
        out[k], pos = _unpack(buf, pos, views)
    return out, pos


def unpackb(data: bytes):
    """``msgpack.unpackb(data, raw=False)`` for the subset above."""
    buf = memoryview(data)
    obj, pos = _unpack(buf, 0)
    if pos != len(buf):
        raise ValueError(f"{len(buf) - pos} trailing bytes after the object")
    return obj


# ---------------------------------------------------------------------------
# the tree codec
# ---------------------------------------------------------------------------

def _is_namedtuple(obj) -> bool:
    return isinstance(obj, tuple) and hasattr(type(obj), "_fields")


def _tree_encode(obj, lazy: bool = False):
    """The tree as the msgpack subset, dict keys sorted (the reference's
    file for the same tree, byte for byte); an array's bytes as ``bytes``,
    or with ``lazy`` as a ``_Raw`` the packer reads when it writes them."""
    def enc(v):
        return _tree_encode(v, lazy)

    def one(arr):
        return _Raw(arr) if lazy else _Raw(arr).buffer().tobytes()

    def data(arr):
        """One bin, or a list of bins past ``BIN_MAX`` bytes (flat slices
        of ``arr``, each taken to the host only when it is written)."""
        if isinstance(arr, torch.Tensor):
            size, flat = arr.element_size(), arr.reshape(-1)
        else:
            size, flat = arr.itemsize, np.ascontiguousarray(arr).reshape(-1)
        if flat.shape[0] * size <= BIN_MAX:
            return one(arr)
        step = BIN_CHUNK // size
        return [one(flat[a:a + step]) for a in range(0, flat.shape[0], step)]

    if isinstance(obj, torch.Tensor):
        # numpy's name of the dtype; a bf16 tensor's raw 2-byte words are
        # written as the reference writes an ml_dtypes bfloat16 array
        dtype = ("bfloat16" if obj.dtype == torch.bfloat16
                 else str(torch.empty(0, dtype=obj.dtype).numpy().dtype))
        return {"__nd__": list(obj.shape), "dtype": dtype, "data": data(obj)}
    if isinstance(obj, np.ndarray):
        return {"__nd__": list(obj.shape), "dtype": str(obj.dtype), "data": data(obj)}
    if isinstance(obj, (np.bool_, bool)):
        return bool(obj)
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    if obj is None:
        return {"__none__": True}
    if _is_namedtuple(obj):
        cls = type(obj)
        return {"__nt__": f"{cls.__module__}.{cls.__qualname__}",
                "data": [enc(v) for v in obj]}
    if isinstance(obj, tuple):
        return {"__tuple__": [enc(v) for v in obj]}
    if isinstance(obj, list):
        return [enc(v) for v in obj]
    if isinstance(obj, dict):
        # keys sorted, as the reference's jax.device_get of the tree leaves them
        return {k: enc(obj[k]) for k in sorted(obj)}
    if isinstance(obj, (int, float, str, bytes)):
        return obj
    raise TypeError(f"cannot serialize {type(obj)}")


def _nt_class(qualname: str):
    module, _, name = qualname.rpartition(".")
    cls = importlib.import_module(module)
    for part in name.split("."):  # nested QualNames
        cls = getattr(cls, part)
    return cls


def _tree_decode(obj):
    if isinstance(obj, dict):
        if "__nd__" in obj:
            bf16 = obj["dtype"] == "bfloat16"
            dtype = np.dtype(np.int16 if bf16 else obj["dtype"])
            if isinstance(obj["data"], list):  # an array past one bin, in chunks
                raw = np.empty(sum(len(c) for c in obj["data"]), np.uint8)
                at = 0
                for chunk in obj["data"]:
                    raw[at:at + len(chunk)] = np.frombuffer(chunk, np.uint8)
                    at += len(chunk)
                arr = raw.view(dtype).reshape(obj["__nd__"])
            else:
                arr = np.frombuffer(obj["data"], dtype=dtype).reshape(obj["__nd__"]).copy()
            return torch.from_numpy(arr).view(torch.bfloat16) if bf16 else arr
        if "__none__" in obj:
            return None
        if "__nt__" in obj:
            return _nt_class(obj["__nt__"])(*[_tree_decode(v) for v in obj["data"]])
        if "__tuple__" in obj:
            return tuple(_tree_decode(v) for v in obj["__tuple__"])
        return {k: _tree_decode(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_tree_decode(v) for v in obj]
    return obj


def save(ckpt_dir: str, step: int, tree: Any, *, keep: int = 3) -> str:
    os.makedirs(ckpt_dir, exist_ok=True)
    path = os.path.join(ckpt_dir, f"step_{step}.msgpack")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        _pack(_tree_encode(tree, lazy=True), _Writer(f))
    os.replace(tmp, path)
    _rotate(ckpt_dir, keep)
    return path


class _Writer:
    """The packer's output list, written straight to a file."""

    def __init__(self, f):
        self.append = f.write


def _steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for fn in os.listdir(ckpt_dir):
        m = re.fullmatch(r"step_(\d+)\.msgpack", fn)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def _rotate(ckpt_dir: str, keep: int) -> None:
    steps = _steps(ckpt_dir)
    for s in steps[:-keep] if keep > 0 else []:
        os.remove(os.path.join(ckpt_dir, f"step_{s}.msgpack"))


def latest_step(ckpt_dir: str) -> int | None:
    steps = _steps(ckpt_dir)
    return steps[-1] if steps else None


def restore(ckpt_dir: str, step: int | None = None) -> Any:
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    path = os.path.join(ckpt_dir, f"step_{step}.msgpack")
    if os.path.getsize(path) == 0:
        raise ValueError(f"{path} is empty")
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as mm:
        buf = memoryview(mm)
        raw, pos = _unpack(buf, 0, views=True)  # bins: views into the map
        if pos != len(buf):
            raise ValueError(f"{len(buf) - pos} trailing bytes after the object")
        tree = _tree_decode(raw)  # copies every array out of the map
        del raw
        buf.release()
    return tree

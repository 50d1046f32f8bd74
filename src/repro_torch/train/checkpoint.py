"""Fault-tolerant ``.rpck`` checkpoints, readable by both packages.

PyTorch counterpart of ``repro.train.checkpoint``, same file format: the
magic ``RPCK1`` (zstd) or ``RPCK2`` (zlib), a little-endian ``<Q``
length, then the compressed msgpack payload
``{"meta": {..., "step"}, "trees": {name: {"a/b/c": {"dtype", "shape",
"data"}}}}``. Keys are '/'-joined paths in sorted key order (as JAX
flattens a dict); bf16 is stored as its uint16 bits with dtype
``"bfloat16"``, other dtypes by numpy's ``dtype.str``. A checkpoint
saved by either package restores in the other.

The writer compresses with zlib (``RPCK2``). Reading ``RPCK1`` needs
``zstandard``; without it ``restore`` raises ``MissingCodecError``
rather than skip the file. Writes are atomic (tmp file, fsync, rename);
``restore`` takes the newest *valid* file, skipping corrupt or truncated
ones. msgpack comes from the port's own codec (``_msgpack``).
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from . import _msgpack

try:  # zstd is optional, as in the reference
    import zstandard
except ImportError:
    zstandard = None

PyTree = Any

_MAGIC = b"RPCK1"       # zstd-compressed payload
_MAGIC_ZLIB = b"RPCK2"  # zlib-compressed payload
_NAME = re.compile(r"ckpt_(\d+)\.rpck")


class MissingCodecError(RuntimeError):
    """A checkpoint needs a codec this environment lacks. Distinct from
    corruption: ``restore`` must not skip such a file (that would roll
    training back to an older checkpoint)."""


def _flatten(tree: PyTree, path: str = "") -> Dict[str, torch.Tensor]:
    """{'/'-joined path: leaf}, keys sorted at every level."""
    if not isinstance(tree, dict):
        return {path: tree}
    flat = {}
    for key in sorted(tree):
        flat.update(_flatten(tree[key], f"{path}/{key}" if path else key))
    return flat


def _pack_tensor(t: torch.Tensor) -> Dict:
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return {"dtype": "bfloat16", "shape": list(t.shape),
                "data": t.view(torch.int16).numpy().tobytes()}
    a = t.numpy()
    return {"dtype": a.dtype.str, "shape": list(a.shape),
            "data": a.tobytes()}


def _unpack_tensor(d: Dict) -> torch.Tensor:
    if d["dtype"] == "bfloat16":
        a = np.frombuffer(d["data"], dtype=np.int16).reshape(d["shape"])
        return torch.from_numpy(a.copy()).view(torch.bfloat16)
    a = np.frombuffer(d["data"], dtype=np.dtype(d["dtype"]))
    return torch.from_numpy(a.reshape(d["shape"]).copy())


def save(ckpt_dir: str, step: int, trees: Dict[str, PyTree],
         meta: Optional[Dict] = None) -> str:
    """Write ``trees`` (name -> nested dict of tensors) as
    ``ckpt_<step>.rpck``, atomically; returns its path."""
    os.makedirs(ckpt_dir, exist_ok=True)
    payload = {
        "meta": {**(meta or {}), "step": int(step)},
        "trees": {name: {k: _pack_tensor(v)
                         for k, v in _flatten(tree).items()}
                  for name, tree in trees.items()},
    }
    comp = zlib.compress(_msgpack.packb(payload), 6)
    blob = _MAGIC_ZLIB + struct.pack("<Q", len(comp)) + comp
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.rpck")
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)  # atomic publish
    return path


def _load_file(path: str) -> Dict:
    with open(path, "rb") as f:
        blob = f.read()
    if blob.startswith(_MAGIC):
        codec = "zstd"
    elif blob.startswith(_MAGIC_ZLIB):
        codec = "zlib"
    else:
        raise ValueError("bad magic")
    (n,) = struct.unpack("<Q", blob[5:13])
    comp = blob[13:13 + n]
    if len(comp) != n:
        raise ValueError("truncated checkpoint")
    if codec == "zstd":
        if zstandard is None:
            raise MissingCodecError(
                "checkpoint was written with zstd but zstandard is not "
                "installed in this environment")
        raw = zstandard.ZstdDecompressor().decompress(comp)
    else:
        raw = zlib.decompress(comp)
    return _msgpack.unpackb(raw)


def _files(ckpt_dir: str):
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(fn for fn in os.listdir(ckpt_dir) if _NAME.fullmatch(fn))


def latest_step(ckpt_dir: str) -> Optional[int]:
    files = _files(ckpt_dir)
    return int(_NAME.fullmatch(files[-1]).group(1)) if files else None


def restore(ckpt_dir: str, templates: Dict[str, PyTree], device="cpu"
            ) -> Optional[Tuple[int, Dict[str, PyTree], Dict]]:
    """(step, {name: tree}, meta) of the newest valid checkpoint, or None.
    Each tree takes the structure of its template (leaves need only a
    ``shape``) and the stored dtypes, on ``device``. A file that fails to
    load, lacks a tree or a key, or holds another shape is skipped;
    ``MissingCodecError`` is raised."""
    for fn in reversed(_files(ckpt_dir)):
        try:
            payload = _load_file(os.path.join(ckpt_dir, fn))
        except MissingCodecError:
            raise  # not corruption: skipping would lose training progress
        except Exception:
            continue  # partial or corrupt: fall back to an older one
        out = {}
        for name, template in templates.items():
            flat = payload["trees"].get(name, {})
            want = {k: tuple(v.shape) for k, v in _flatten(template).items()}
            if any(k not in flat or tuple(flat[k]["shape"]) != shape
                   for k, shape in want.items()):
                break
            out[name] = _unflatten(
                {k: _unpack_tensor(flat[k]).to(device) for k in want})
        else:
            return payload["meta"]["step"], out, payload["meta"]
    return None


def _unflatten(flat: Dict[str, torch.Tensor]) -> PyTree:
    tree: Dict = {}
    for path, leaf in flat.items():
        *parents, last = path.split("/")
        node = tree
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = leaf
    return tree


def prune(ckpt_dir: str, keep: int = 3) -> None:
    """Delete all but the newest ``keep`` checkpoints."""
    for fn in _files(ckpt_dir)[:-keep]:
        os.remove(os.path.join(ckpt_dir, fn))

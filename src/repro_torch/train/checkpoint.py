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
ones. msgpack comes from the port's own codec (``_msgpack``). DTensor
trees are saved as full tensors, so a checkpoint holds no trace of the
mesh that wrote it, and ``restore`` places it on any mesh (or none).
"""
from __future__ import annotations

import os
import re
import struct
import zlib
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard

from ..launch.sharding import placements
from ..models.common import tree_get
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


def is_writer() -> bool:
    """Whether this process writes checkpoints: rank 0 of an initialised
    process group, or the only process."""
    return not dist.is_initialized() or dist.get_rank() == 0


def save(ckpt_dir: str, step: int, trees: Dict[str, PyTree],
         meta: Optional[Dict] = None) -> str:
    """Write ``trees`` (name -> nested dict of tensors) as
    ``ckpt_<step>.rpck``, atomically; returns its path. DTensor leaves are
    written as their full tensors: every rank calls ``save`` (each leaf
    is gathered, one at a time), rank 0 alone packs and writes the file,
    and the ranks meet at a barrier after it."""
    writer, sharded = is_writer(), False
    packed = {}
    for name, tree in trees.items():
        packed[name] = {}
        for k, v in _flatten(tree).items():
            if isinstance(v, DTensor):
                v, sharded = v.full_tensor(), True   # a collective
            if writer:
                packed[name][k] = _pack_tensor(v)
    payload = {"meta": {**(meta or {}), "step": int(step)}, "trees": packed}
    path = os.path.join(ckpt_dir, f"ckpt_{step:08d}.rpck")
    if is_writer():
        _write(ckpt_dir, path, payload)
    if sharded:
        dist.barrier()
    return path


def _write(ckpt_dir: str, path: str, payload: Dict) -> None:
    os.makedirs(ckpt_dir, exist_ok=True)
    comp = zlib.compress(_msgpack.packb(payload), 6)
    blob = _MAGIC_ZLIB + struct.pack("<Q", len(comp)) + comp
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
        f.flush()
        os.fsync(f.fileno())
    os.rename(tmp, path)  # atomic publish


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


def restore(ckpt_dir: str, templates: Dict[str, PyTree], device="cpu",
            mesh=None, specs: Optional[Dict[str, PyTree]] = None
            ) -> Optional[Tuple[int, Dict[str, PyTree], Dict]]:
    """(step, {name: tree}, meta) of the newest valid checkpoint, or None.
    Each tree takes the structure of its template (leaves need only a
    ``shape``) and the stored dtypes, on ``device``. With a ``mesh``,
    the leaves become DTensors on it, placed by ``specs`` ({name: spec
    tree}, ``launch.sharding``): the elastic re-mesh, since the file
    holds full tensors whatever mesh saved them. Every rank reads the
    file, unpacks it leaf by leaf on the CPU and moves only its own shard
    to ``device``, so no rank holds a whole sharded tree there. A file
    that fails to load, lacks a tree or a key, or holds another shape is
    skipped; ``MissingCodecError`` is raised."""
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
            spec_tree = specs[name] if mesh is not None else None
            tree = _unflatten({k: _place(_unpack_tensor(flat[k]), device,
                                         mesh, spec_tree, k)
                               for k in want})
            out[name] = tree
        else:
            return payload["meta"]["step"], out, payload["meta"]
    return None


def _place(t: torch.Tensor, device, mesh, spec_tree, path: str):
    """CPU tensor ``t`` on ``device``; with a ``mesh``, this rank's shard
    of it as a DTensor placed by the spec at ``path`` of ``spec_tree``
    (split as ``distribute_tensor`` splits: torch.chunk along each
    sharded dim, in mesh-dim order). A None spec keeps ``t`` whole."""
    spec = tree_get(spec_tree, path) if mesh is not None else None
    if spec is None:
        return t.to(device)
    places = placements(spec, mesh)
    local = t
    for i, (p, c) in enumerate(zip(places, mesh.get_coordinate())):
        if isinstance(p, Shard):
            parts = torch.chunk(local, mesh.size(i), dim=p.dim)
            local = parts[c] if c < len(parts) else local.narrow(p.dim, 0, 0)
    return DTensor.from_local(local.to(device, copy=True), mesh, places,
                              run_check=False, shape=t.shape,
                              stride=t.stride())


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

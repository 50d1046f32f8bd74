"""AdamW's ops: the CUDA kernels ``csrc/adamw.cu`` on CUDA tensors, their
plain versions (``ref.py``) on CPU tensors.

``adamw_sumsq`` is the clip's pass: the global norm of the gradient
leaves and the clip's factor, from one launch a leaf, which sums the
squares of each chunk of ``SUMSQ_CHUNK`` elements into that chunk's fixed
slot of one workspace (``sumsq_slots``), and one launch that sums the
slots in a fixed order; the two scalars stay on the card. ``adamw_step``
is one leaf's update in place, one launch that reads p, g, m and v and
writes p, m and v. Neither reads anything back to the host.
``adamw_sumsq.launches`` counts the calls that launched the clip's pass,
``adamw_step.launches`` the leaves updated by a launch.

The kernels take contiguous tensors on one CUDA device, p and g float32
or bfloat16, m, v and the scalars float32, and raise on anything else.
``train.optimizer.adamw_update`` calls them for plain CUDA leaves, and
``adamw_step`` for each DTensor leaf's local shard (the norm then comes
from the mesh's reduction); CPU tensors take the plain versions. The
kernels replace no Pallas kernel.
"""
from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import torch

from .. import _build
from .ref import adamw_step_ref, clip_scale_ref, sumsq_ref

SUMSQ_CHUNK = 16384   # elements a block of the clip's pass sums (csrc)
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # p and g (csrc: Dtype)


def _bind(lib):
    """(sumsq entry, finalize entry, step entry) of the loaded library,
    typed once."""
    if not hasattr(lib, "_adamw_fns"):
        ptr, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int,
                              ctypes.c_longlong, ctypes.c_float)
        sumsq = lib.adamw_sumsq_launch
        sumsq.argtypes = [ptr, i32, i64, ptr, i64, ptr]
        sumsq.restype = i32
        finalize = lib.adamw_finalize_launch
        finalize.argtypes = [ptr, i64, f32, ptr, ptr]
        finalize.restype = i32
        step = lib.adamw_step_launch
        step.argtypes = [ptr, i32, ptr, i32] + [ptr] * 6 + [f32] * 6 + [
            i64, i32, ptr]
        step.restype = i32
        lib._adamw_fns = sumsq, finalize, step
    return lib._adamw_fns


def sumsq_slots(sizes: Sequence[int]) -> Tuple[List[Tuple[int, int]], int]:
    """The clip's plan for leaves of ``sizes`` elements: ([(first slot,
    slots) of each leaf], slots in all). Chunk c of leaf i, its elements
    [c, c + 1) * ``SUMSQ_CHUNK``, sums into slot first_i + c. The plan
    depends on the sizes alone."""
    plan, total = [], 0
    for n in sizes:
        slots = -(-n // SUMSQ_CHUNK)
        plan.append((total, slots))
        total += slots
    return plan, total


def _admit(name, t, dtypes):
    if t.dtype not in dtypes:
        raise ValueError(f"{name} kernel takes "
                         + "/".join(str(d) for d in dtypes)
                         + f", got {t.dtype}")
    if not t.is_contiguous():
        raise ValueError(f"{name} kernel takes contiguous tensors only, got "
                         f"strides {t.stride()} for shape {tuple(t.shape)}")


def admit_sumsq(leaves) -> None:
    """Raise ValueError unless the clip's kernels take these gradient
    leaves: contiguous, float32 or bfloat16, on one CUDA device."""
    for g in leaves:
        _admit("adamw_sumsq", g, DTYPES)
    _build.require_cuda(*leaves)


def adamw_sumsq(leaves: Sequence[torch.Tensor], clip: float
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(norm, scale): the global norm of the gradient ``leaves``, sqrt of
    the sum of every leaf's squares in fp32, and the clip's factor
    min(clip / max(norm, 1e-9), 1), as 0-d fp32 tensors: the plain version
    on CPU tensors, the kernels on CUDA tensors (or ValueError), whose sum
    runs in a fixed order, bitwise the same from call to call."""
    leaves = list(leaves)
    if all(g.device.type == "cpu" for g in leaves):
        norm = torch.sqrt(sumsq_ref(leaves))
        return norm, clip_scale_ref(norm, clip)
    admit_sumsq(leaves)
    plan, total = sumsq_slots([g.numel() for g in leaves])
    dev = leaves[0].device
    partial = torch.empty((max(total, 1),), dtype=torch.float32, device=dev)
    out = torch.empty((2,), dtype=torch.float32, device=dev)
    lib = _build.load("adamw")
    sumsq, finalize, _ = _bind(lib)
    stream = _build.stream_ptr(leaves[0])
    with _build.on_device(leaves[0]):
        for g, (first, slots) in zip(leaves, plan):
            if slots:
                _build.check(lib, "adamw", sumsq(
                    g.data_ptr(), DTYPES[g.dtype], g.numel(),
                    partial.data_ptr() + 4 * first, slots, stream))
        _build.check(lib, "adamw", finalize(
            partial.data_ptr(), total, clip, out.data_ptr(), stream))
    adamw_sumsq.launches += 1
    return out[0], out[1]


def admit_step(p, g, m, v, scale, lr, bc1, bc2) -> None:
    """Raise ValueError unless the step kernel takes these tensors: p and g
    float32 or bfloat16, m and v float32, all of one shape, contiguous;
    scale, lr, bc1 and bc2 float32 scalars; all on one CUDA device."""
    for t, dtypes in ((p, DTYPES), (g, DTYPES), (m, (torch.float32,)),
                      (v, (torch.float32,))):
        _admit("adamw_step", t, dtypes)
    if not p.shape == g.shape == m.shape == v.shape:
        raise ValueError("adamw_step shape mismatch: " + ", ".join(
            str(tuple(t.shape)) for t in (p, g, m, v)))
    for t in (scale, lr, bc1, bc2):
        if t.dtype != torch.float32 or t.numel() != 1:
            raise ValueError(f"adamw_step takes float32 scalars for scale, "
                             f"lr and the bias corrections, got {t.dtype} "
                             f"{tuple(t.shape)}")
    _build.require_cuda(p, g, m, v, scale, lr, bc1, bc2)


def adamw_step(cfg, p, g, m, v, scale, lr, bc1, bc2) -> None:
    """One leaf's AdamW update in place: p (its dtype), m and v (fp32) from
    the gradient g, ``scale`` (the clip's factor), ``lr`` and the bias
    corrections ``bc1``, ``bc2`` (fp32 scalars); ``cfg`` gives b1, b2, eps
    and weight_decay. The plain version on CPU tensors, the kernel on CUDA
    tensors (or ValueError), which gives the plain version's bits."""
    ins = (p, g, m, v, scale, lr, bc1, bc2)
    _build.refuse_grad("adamw_step", ins, "call it under torch.no_grad()")
    if all(t.device.type == "cpu" for t in ins):
        adamw_step_ref(cfg, *ins)
        return
    admit_step(*ins)
    if p.numel() == 0:
        return
    lib = _build.load("adamw")
    with _build.on_device(p):
        rc = _bind(lib)[2](
            p.data_ptr(), DTYPES[p.dtype], g.data_ptr(), DTYPES[g.dtype],
            *(t.data_ptr() for t in (m, v, scale, lr, bc1, bc2)),
            cfg.b1, 1 - cfg.b1, cfg.b2, 1 - cfg.b2, cfg.eps,
            cfg.weight_decay, p.numel(), _build.sm_count(p.device.index),
            _build.stream_ptr(p))
    _build.check(lib, "adamw", rc)
    adamw_step.launches += 1


adamw_sumsq.launches = 0
adamw_step.launches = 0

"""Three-term roofline of one step, per device, on NVIDIA H100 SXM.

PyTorch counterpart of the jax-free parts of ``repro.roofline.analysis``,
with the same formulas:

    compute term    = FLOPs            / peak FLOP/s
    memory term     = HBM bytes        / HBM bandwidth
    collective term = collective bytes / link bandwidth

The counts are per device (``roofline.count`` counts rank 0's local
tensors), so no term divides by the number of chips.

Constants, from NVIDIA's H100 SXM data sheet (dense, no sparsity, at the
card's full 700 W):
  * 989 TFLOP/s bf16 on the tensor cores;
  * 3.35 TB/s of HBM3.
The link: the production meshes (16 x 16 and 2 x 16 x 16 devices) are 32
and 64 nodes of 8 H100s (DGX H100 layout). A 16-wide "model" axis spans
two nodes and every data-parallel axis spans many, so each collective's
ring crosses the inter-node network, where each GPU has one ConnectX-7
NIC of 400 Gb/s, 50 GB/s each way; NVLink's 450 GB/s each way inside a
node is not what bounds such a ring. ``collective_s`` divides by the
NIC's 50 GB/s.

The reference's ``from_compiled``, ``parse_collectives`` and
``xla_cost_reference`` read XLA artifacts; their place is taken by
``roofline.count``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

PEAK_FLOPS = 989e12          # bf16 dense per H100 SXM (data sheet)
HBM_BW = 3.35e12             # bytes/s per H100 SXM (data sheet)
LINK_BW = 50e9               # bytes/s per GPU: one 400 Gb/s NIC each way
HBM_BYTES = 80e9             # HBM per H100 SXM (data sheet: 80 GB)

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())


@dataclasses.dataclass
class Roofline:
    flops: float                 # matmul-class FLOPs of one device
    hbm_bytes: float             # bytes moved by one device
    collective_bytes: float      # collective result bytes of one device

    @property
    def compute_s(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def memory_s(self) -> float:
        return self.hbm_bytes / HBM_BW

    @property
    def collective_s(self) -> float:
        return self.collective_bytes / LINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def total_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    def as_dict(self) -> Dict:
        return {
            "flops": self.flops, "hbm_bytes": self.hbm_bytes,
            "collective_bytes": self.collective_bytes,
            "compute_s": self.compute_s, "memory_s": self.memory_s,
            "collective_s": self.collective_s,
            "bottleneck": self.bottleneck,
        }


def model_flops(n_params: int, tokens: int, active_params: int = 0,
                training: bool = True) -> float:
    """MODEL_FLOPS = 6*N*D (training) or 2*N*D (inference); MoE uses
    active params."""
    n = active_params or n_params
    mult = 6 if training else 2
    return mult * n * tokens

"""The yardstick's arithmetic: the card's peaks, the least work of each
kernel the cells run, the model FLOPs of a step, and how many calls of
each kernel a unit of a cell makes (the last two from the family's own
counts, ``bench/families/<family>.py``).

Least work counts what the operation needs, whatever implements it:
each input byte read once and each output byte written once, the
products over the (query, key) pairs a causal mask keeps. A kernel's
least time is max(FLOPs / peak FLOP/s, bytes / peak bytes/s), so a share
of it can never pass 100% unless the work is overcounted or the time
undercounted. These formulas are frozen here: a program change cannot
move them.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from .reference.model import family, padded_vocab

# NVIDIA H100 SXM data sheet, dense, at the full 700 W
PEAK_FLOPS = 989e12          # bf16 tensor-core FLOP/s
PEAK_BYTES = 3.35e12         # HBM3 bytes/s
BF16, FP32 = 2, 4

Work = Tuple[float, float]   # (FLOPs, bytes)


def least_seconds(flops: float, nbytes: float) -> float:
    return max(flops / PEAK_FLOPS, nbytes / PEAK_BYTES)


def causal_pairs(s: int) -> int:
    """(query, key) pairs a causal mask keeps in an s x s score matrix."""
    return s * (s + 1) // 2


def flash_fwd(b: int, s: int, h: int, kv: int, hd: int) -> Work:
    """Causal attention forward: S = Q K^T and O = P V over the kept
    pairs; q, k, v read and o written once, bf16."""
    flops = 4.0 * b * h * hd * causal_pairs(s)
    nbytes = BF16 * (2 * b * s * h * hd + 2 * b * s * kv * hd)
    return flops, nbytes


def flash_bwd(b: int, s: int, h: int, kv: int, hd: int) -> Work:
    """Causal attention backward from the forward's row log-sum-exp:
    five products over the kept pairs (S again, dP = dO V^T, dV = P^T dO,
    dQ = dS K, dK = dS^T Q); q, k, v, o, do and the fp32 lse read, dq,
    dk, dv written once."""
    flops = 10.0 * b * h * hd * causal_pairs(s)
    nbytes = (BF16 * (4 * b * s * h * hd + 4 * b * s * kv * hd)
              + FP32 * b * h * s)
    return flops, nbytes


def mlp_fwd(m: int, k: int, f: int) -> Work:
    """SwiGLU y = (silu(x W1) * x W3) W2, x [m, k]: three products of
    2 m k f; x, W1, W3, W2 read and y written once, bf16."""
    return 6.0 * m * k * f, BF16 * (2 * m * k + 3 * k * f)


def mlp_bwd(m: int, k: int, f: int) -> Work:
    """Its backward from the forward's g = x W1 and u = x W3: six
    products of 2 m k f (dh, dW2, dx's two, dW1, dW3); x, the weights
    and dy read, dx and the weights' gradients written once, bf16."""
    return 12.0 * m * k * f, BF16 * (3 * m * k + 6 * k * f)


def ssd_fwd(b: int, s: int, h: int, g: int, n: int, p: int,
            chunk: int) -> Work:
    """The chunked SSD scan's forward: per chunk of L rows, C B^T over the
    causal triangle once per group, (M) x over it per head, and per head
    the chunk state B^T (w x) and the inter-chunk term C S_prev (two
    L x N x P products). x, B, C read and y written in bf16, dt and A read
    and the final state written in fp32, once."""
    flops = 0.0
    for start in range(0, s, chunk):
        rows = min(chunk, s - start)
        tri = rows * (rows + 1) / 2
        flops += 2.0 * b * (tri * (g * n + h * p) + 2 * h * rows * n * p)
    nbytes = (BF16 * (2 * b * s * h * p + 2 * b * s * g * n)
              + FP32 * (b * s * h + h + b * h * n * p))
    return flops, nbytes


def ssd_bwd(b: int, s: int, h: int, g: int, n: int, p: int,
            chunk: int) -> Work:
    """The SSD scan's backward, a frozen copy of the program's
    ``kernels/ssd_scan/ops.py::bwd_work`` as of this benchmark: per
    (batch, chunk) of L rows, over the lower triangle of the L x L
    scores: C B^T and the intra-chunk dB and dC products once per group,
    dM = dy x^T and M^T dy once per head; per head the four L x N x P
    products of the state terms. The chunk states are not counted: the
    forward keeps them. Bytes: x, dy and dx in bf16, dt and ddt in fp32,
    A and dA, and B, C, dB and dC in bf16, each once."""
    flops = 0.0
    for start in range(0, s, chunk):
        rows = min(chunk, s - start)
        tri = rows * (rows + 1) / 2
        flops += 2.0 * b * (tri * (3 * g * n + 2 * h * p)
                            + 4 * h * rows * n * p)
    nbytes = (3 * 2 * b * s * h * p + 2 * 4 * b * s * h + 2 * 4 * h
              + 4 * 2 * b * s * g * n)
    return flops, nbytes


def attention_flops(b: int, h: int, hd: int, queries: int,
                    before: int) -> float:
    """Forward FLOPs of causal attention's score and value products for b
    sequences of ``queries`` new tokens after ``before`` cached ones."""
    pairs = queries * before + causal_pairs(queries)
    return 4.0 * b * h * hd * pairs


# ---------------------------------------------------------------------------
# model FLOPs: the family's counts (``bench/families/<family>.py``)
# ---------------------------------------------------------------------------

def matmul_params(cfg: dict) -> int:
    """Weights a token meets in a matrix product: the unembedding and the
    family's layers. The embedding is a row gather, and norms, conv taps
    and the SSM's per-head vectors are elementwise: none is counted."""
    return cfg["d_model"] * padded_vocab(cfg) + family(cfg).matmul_params(cfg)


def train_step_flops(cfg: dict, b: int, s: int) -> float:
    """Model FLOPs of one training step on b x s tokens: 3 x the forward
    (forward, and twice it in the backward); the forward is 2 x
    ``matmul_params`` a token and the family's sequence mixing
    (attention's products over the kept pairs, the SSM recurrence).
    Remat's recompute is not counted."""
    return 3.0 * (2.0 * matmul_params(cfg) * b * s
                  + family(cfg).mix_flops(cfg, b, s, 0))


def serve_call_flops(cfg: dict, b: int, prompt: int, new: int) -> float:
    """Model FLOPs of one generate call: the forward over the prompt and
    over each generated token but the last (which no step reads), each
    token mixing with the ones before it."""
    mix = family(cfg).mix_flops
    flops = (2.0 * matmul_params(cfg) * b * (prompt + new - 1)
             + mix(cfg, b, prompt, 0))
    for t in range(1, new):
        flops += mix(cfg, b, 1, prompt + t - 1)
    return flops


def kernel_calls(cfg: dict, traffic: dict) -> Dict[str, List[Tuple[int, Work]]]:
    """{op: [(calls, least work of one call)]} of one unit of a cell: a
    training step under remat "full" (each kernel forward twice, the
    second in the backward's recompute, and its backward once) or one
    generate call (the prefill at batch x prompt, then one decode step a
    generated token, the last one included). Ops: flash_fwd, flash_bwd,
    mlp_fwd, mlp_bwd, ssd_fwd, ssd_bwd; the family says which it runs."""
    return family(cfg).kernel_calls(cfg, traffic)

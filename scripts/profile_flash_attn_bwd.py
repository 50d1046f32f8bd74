"""Device time of each launch of the flash attention backward
(``csrc/flash_attn_bwd.cu``: flash_bwd_delta, flash_bwd_main,
flash_bwd_convert) at the training shapes chip_smoke.py times: olmo_1b
(B=4 S=2048 H=16 hd=128 causal), granite_moe_1b_a400m (B=4 S=2048 H=16
KV=8 hd=64 causal), whisper_base's decoder (causal 448), encoder
(non-causal 1500) and cross-attention (non-causal 448 x 1500) at B=4, and
llava_next_34b (B=1 S=640 H=56 KV=8 hd=128 causal); bf16 random inputs
from a seed.

    PYTHONPATH=src python scripts/profile_flash_attn_bwd.py [--reps 10]

Needs a CUDA GPU (builds the kernels at first use). Prints the card's
name and power limit, then for each shape the mean device ms of each
launch over ``--reps`` backward calls (torch.profiler), their sum, and the
five-product bound at 989 TFLOP/s (bf16) or 3.35 TB/s, whichever is
larger. It times the launches alone: the host's work before the first
launch, which a CUDA-event timing of the whole call includes, is not
counted.
"""
import argparse
import re
import subprocess
import sys

import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import get_config
from repro_torch.kernels.flash_attn import FlashAttention

PEAK_BF16_FLOPS = 989e12   # H100 SXM data sheet, dense bf16
PEAK_BYTES = 3.35e12       # H100 SXM data sheet, HBM3


def shapes():
    """(label, b, sq, skv, h, kv, hd, causal) of each timed shape."""
    ol, gm = get_config("olmo_1b"), get_config("granite_moe_1b_a400m")
    wh, ll = get_config("whisper_base"), get_config("llava_next_34b")
    frames, toks, rows = wh.enc_frames, 448, 64 + ll.img_tokens
    w = (wh.n_heads, wh.n_kv_heads, wh.hd)
    return (("olmo_1b", 4, 2048, 2048, ol.n_heads, ol.n_kv_heads, ol.hd,
             True),
            ("granite_moe_1b_a400m", 4, 2048, 2048, gm.n_heads,
             gm.n_kv_heads, gm.hd, True),
            ("whisper_base decoder", 4, toks, toks, *w, True),
            ("whisper_base encoder", 4, frames, frames, *w, False),
            ("whisper_base cross", 4, toks, frames, *w, False),
            ("llava_next_34b", 1, rows, rows, ll.n_heads, ll.n_kv_heads,
             ll.hd, True))


def bound_ms(b, sq, skv, h, kv, hd, causal):
    """The five products over the (query, key) pairs the mask keeps, and
    q, dO, dq, k, v, dk, dv read or written once (bf16)."""
    pairs = (sum(min(skv, i + (skv - sq) + 1) for i in range(sq)) if causal
             else sq * skv)
    flops = 10.0 * b * h * hd * pairs
    nbytes = 2.0 * b * hd * (3 * sq * h + 4 * skv * kv)
    return max(flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES) * 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=10)
    reps = ap.parse_args(argv).reps
    if not torch.cuda.is_available():
        print("needs a CUDA GPU", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    gen = torch.Generator(device="cuda").manual_seed(0)

    def rnd(*shape):
        return torch.randn(shape, generator=gen,
                           device="cuda").to(torch.bfloat16)
    for label, b, sq, skv, h, kv, hd, causal in shapes():
        q = rnd(b, sq, h, hd).requires_grad_()
        k, v = (rnd(b, skv, kv, hd).requires_grad_() for _ in range(2))
        do = rnd(b, sq, h, hd)
        y = FlashAttention.apply(q, k, v, causal)
        torch.autograd.grad(y, (q, k, v), do, retain_graph=True)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                torch.autograd.grad(y, (q, k, v), do, retain_graph=True)
            torch.cuda.synchronize()
        per = {}
        for e in prof.key_averages():
            m = re.search(r"flash_bwd_([a-z]+)", e.key)
            if m:
                per[m.group(1)] = (per.get(m.group(1), 0.0)
                                   + e.self_device_time_total / 1e3 / reps)
        print(f"{label} B={b} Sq={sq} Skv={skv} H={h} KV={kv} hd={hd} "
              f"{'causal' if causal else 'non-causal'}: " + ", ".join(
                  f"{n} {ms:.4f}" for n, ms in per.items())
              + f"; sum {sum(per.values()):.4f} ms; bound "
              f"{bound_ms(b, sq, skv, h, kv, hd, causal):.4f} ms", flush=True)
        del q, k, v, do, y
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

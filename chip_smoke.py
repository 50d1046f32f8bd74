#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device  -- require CUDA; print the card's name and power limit; set
                fp32 matmuls to full precision (no TF32).
  2. build   -- compile every CUDA kernel from ``src/repro_torch/csrc``.
  3. kernels -- each kernel against its plain PyTorch version on the card at
                the main path's shapes (granite_8b), with its time, the plain
                version's time, a library yardstick's time and its bound.
  4. numerics-- granite_8b at full width and 2 layers: the card's bf16 kernel
                path (prefill logits, then one decode step) against the port's
                plain path on the CPU in fp32, on the same weights.
  5. serve   -- a full-width, full-depth granite_8b Engine serves 4 requests
                of 512 prompt tokens, 32 greedy new tokens each; the kernels'
                launch counters must show that the path went through them.
The last two lines of output are a JSON ``kernels`` line and the JSON result
line. Exits non-zero, printing no result, without a GPU or without the repo.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.flash_attn import attention_ref, flash_attention  # noqa: E402
from repro_torch.kernels.fused_mlp import fused_mlp, fused_mlp_ref  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.models.common import tree_map  # noqa: E402
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402

# H100 SXM data sheet: dense bf16 tensor rate and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
BF16 = torch.bfloat16
SEED = 0

# Tolerances, stated with their reasons:
# kernel vs plain (both on the card, same bf16 inputs): the plain version is
# exact fp32 math rounded once to bf16; the kernels also round P (flash) or
# h (fused_mlp) to bf16 before the second product and sum in another order
# (fused_mlp: fp32 atomics in a run-dependent order). Outputs are O(1), so
# bf16's 2^-8 relative step bounds the gap: the repo's bf16 tolerance.
KERNEL_ATOL = KERNEL_RTOL = 2e-2
# bf16 card path vs fp32 CPU path through 2 full-width layers: ~10 rounded
# bf16 operations per layer (2^-9 relative each) compound to ~1% of the
# logits' RMS; 3% leaves room without hiding a wrong kernel (which is O(1)).
NUMERICS_REL_RMS = 3e-2


def phase(name):
    print(f"== {name}", flush=True)


def cuda_ms(fn, reps: int, flush: torch.Tensor) -> float:
    """Median device time of ``fn`` in ms (CUDA events around each call);
    the 64 MB ``flush`` buffer is rewritten between calls so that L2 holds
    none of the inputs, as on the main path, where other layers run
    between two calls."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def compare(name, got, want):
    """Max abs and relative error; raises beyond the kernel tolerance."""
    got, want = got.float(), want.float()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-3)).max())
    bad = int((err > KERNEL_ATOL + KERNEL_RTOL * want.abs()).sum())
    ok = bad == 0 and bool(torch.isfinite(got).all())
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"outside atol={KERNEL_ATOL} rtol={KERNEL_RTOL}: {bad} "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(BF16)


def check_flash(gen, flush):
    """Flash kernel vs attention_ref; returns the kernel's JSON entry."""
    cfg = get_config("granite_8b")
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    cases = [  # (label, b, sq, skv, h, kv, hd, causal, layout)
        ("prefill B=4 S=512 causal", 4, 512, 512, h, kv, hd, True, "bshd"),
        ("ragged S=500 causal", 4, 500, 500, h, kv, hd, True, "bshd"),
        ("non-causal S=512", 4, 512, 512, h, kv, hd, False, "bshd"),
        ("end-aligned Sq=100 Skv=300 hd=64, Pallas layout", 2, 100, 300, 8,
         2, 64, True, "pallas"),
    ]
    main = None
    for label, b, sq, skv, nh, nkv, d, causal, layout in cases:
        if layout == "bshd":
            q = randn(gen, b, sq, nh, d)
            k, v = randn(gen, b, skv, nkv, d), randn(gen, b, skv, nkv, d)
        else:
            q = randn(gen, b * nh, sq, d)
            k, v = randn(gen, b * nkv, skv, d), randn(gen, b * nkv, skv, d)
        out = flash_attention(q, k, v, causal=causal)
        ref = attention_ref(q, k, v, causal=causal)
        torch.cuda.synchronize()
        err = compare(f"flash_attention [{label}]", out, ref)
        if main is None:
            main = (q, k, v, b, sq, skv, nh, nkv, d, err)
    q, k, v, b, sq, skv, nh, nkv, d, err = main
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=True), 20, flush)
    plain = cuda_ms(lambda: attention_ref(q, k, v, causal=True), 5, flush)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), 20, flush)
    pairs = sum(min(skv, i + (skv - sq) + 1) for i in range(sq))
    flops = 4.0 * b * nh * d * pairs
    nbytes = 2.0 * (2 * b * sq * nh * d + 2 * b * skv * nkv * d)
    bms, by = bound_ms(flops, nbytes)
    print(f"  flash_attention B={b} S={sq} H={nh} KV={nkv} hd={d}: kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
          f"{bms:.4f} ms ({by})", flush=True)
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn/flash_attn.py:73",
            "launches": None, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "library": "F.scaled_dot_product_attention(is_causal=True, "
                       "enable_gqa=True)",
            "shape": f"B={b} S={sq} H={nh} KV={nkv} hd={d} causal bf16"}


def check_fused_mlp(gen, flush):
    """fused_mlp kernel vs fused_mlp_ref at prefill and decode shapes;
    returns the kernel's JSON entry (prefill) with the decode case nested."""
    cfg = get_config("granite_8b")
    k, f = cfg.d_model, cfg.d_ff
    w1 = randn(gen, k, f, scale=k ** -0.5)
    w3 = randn(gen, k, f, scale=k ** -0.5)
    w2 = randn(gen, f, k, scale=f ** -0.5)
    entries = {}
    for label, m in (("prefill", 2048), ("decode", 4)):
        x = randn(gen, m, k)
        out = fused_mlp(x, w1, w3, w2)
        ref = fused_mlp_ref(x, w1, w3, w2)
        torch.cuda.synchronize()
        err = compare(f"fused_mlp [{label} M={m} K={k} F={f}]", out, ref)
        ms = cuda_ms(lambda: fused_mlp(x, w1, w3, w2), 10, flush)
        plain = cuda_ms(lambda: fused_mlp_ref(x, w1, w3, w2), 3, flush)
        lib = cuda_ms(lambda: (F.silu(x @ w1) * (x @ w3)) @ w2, 10, flush)
        bms, by = bound_ms(6.0 * m * k * f, 2.0 * (2 * m * k + 3 * k * f))
        print(f"  fused_mlp {label} M={m}: kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, cuBLAS chain {lib:.4f} ms, bound {bms:.4f} "
              f"ms ({by})", flush=True)
        entries[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                          "bound_ms": bms, "bound_by": by, "library_ms": lib,
                          "shape": f"M={m} K={k} F={f} bf16"}
    return {"name": "fused_mlp", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_mlp.cu",
            "replaces": "src/repro/kernels/fused_mlp/fused_mlp.py:52",
            "launches": None, **entries["prefill"],
            "library": "cuBLAS chain: (silu(x@w1) * (x@w3)) @ w2, 3 matmuls",
            "decode": entries["decode"]}


def rel_rms(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


def check_numerics():
    """granite_8b at full width, 2 layers: card bf16 kernel path vs the
    port's plain path on the CPU in fp32, on the same weights."""
    cfg = get_config("granite_8b").with_(n_layers=2)
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    cpu_params = tree_map(lambda _, t: t.cpu(), params)
    cpu_cfg = cfg.with_(compute_dtype="float32")
    card = tree_map(lambda p, t: t if "norm" in p else t.to(BF16), params)
    toks = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab, (2, 64)).astype(np.int32))
    launches = (flash_attention.launches, fused_mlp.launches)
    with torch.inference_mode():
        want, cpu_cache = model_zoo.prefill(cpu_cfg, cpu_params, toks, 80)
        got, cache = model_zoo.prefill(cfg, card, toks.cuda(), 80)
        nxt = torch.argmax(want, dim=-1).to(torch.int32)
        want_d, _ = model_zoo.decode_step(cpu_cfg, cpu_params, cpu_cache, nxt)
        got_d, _ = model_zoo.decode_step(cfg, card, cache, nxt.cuda())
    torch.cuda.synchronize()
    if (flash_attention.launches - launches[0] != cfg.n_layers
            or fused_mlp.launches - launches[1] != 2 * cfg.n_layers):
        raise RuntimeError("the card path did not run the kernels")
    for label, g, w in (("prefill", got, want), ("decode", got_d, want_d)):
        r = rel_rms(g.cpu(), w)
        ok = r <= NUMERICS_REL_RMS and bool(torch.isfinite(g).all())
        print(f"  granite_8b 2 layers {label} logits {tuple(g.shape)}: "
              f"rel RMS {r:.3e} (limit {NUMERICS_REL_RMS}), max abs "
              f"{float((g.cpu().float() - w).abs().max()):.3e}, argmax "
              f"agree {int((g.argmax(-1).cpu() == w.argmax(-1)).sum())}/"
              f"{g.shape[0]} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{label} logits disagree with the fp32 path")
    del params, card


def serve(n_layers: int):
    """Full-width granite_8b Engine on the card: 4 x 512-token prompts, 32
    greedy new tokens. Returns the kernels' launch counts of that run."""
    cfg = get_config("granite_8b").with_(n_layers=n_layers,
                                         param_dtype="bfloat16")
    batch, prompt_len, new = 4, 512, 32
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    scfg = ServeConfig(max_seq=prompt_len + new, max_new_tokens=new)
    eng = Engine(cfg, params, scfg=scfg, device="cuda")
    torch.cuda.synchronize()
    print(f"  granite_8b {n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.params_count(eng.params) / 1e9:.3f} B params, "
          f"weights {torch.cuda.memory_allocated() / 2**30:.2f} GiB, set up "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    Engine(cfg, eng.params, ServeConfig(max_seq=prompt_len + 2,
                                        max_new_tokens=2)).generate(prompts)

    flash_attention.launches = 0
    fused_mlp.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "fused_mlp": fused_mlp.launches}

    want = {"flash_attention": n_layers, "fused_mlp": n_layers * (1 + new)}
    if launches != want:
        raise RuntimeError(f"launch counts {launches}, expected {want}")
    if out.shape != (batch, new) or not ((out >= 0) & (out < cfg.vocab)).all():
        raise RuntimeError(f"bad tokens: shape {out.shape}")
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng._prefill(eng.params,
                                 {"tokens": torch.as_tensor(prompts).cuda()})
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("prefill logits are not finite")
    t_decode = total - t_prefill
    print(f"  served {batch} x {prompt_len} prompt tokens + {new} new: total "
          f"{total:.3f} s; prefill {t_prefill:.4f} s "
          f"({batch * prompt_len / t_prefill:.1f} tok/s); decode "
          f"{t_decode:.4f} s ({batch * new / t_decode:.1f} tok/s, "
          f"{t_decode / new * 1e3:.2f} ms/step); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  launches {launches} (expected {want})", flush=True)
    print(f"  first tokens: {out[:, :8].tolist()}", flush=True)
    profile(eng, prompts)
    return launches


def profile(eng, prompts, top: int = 8):
    """Where the device time goes: torch.profiler over one prefill and over
    3 decode steps of the served model (run after the counted main path)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    tokens = torch.as_tensor(prompts).cuda()
    with torch.inference_mode():
        logits, cache = eng._prefill(eng.params, {"tokens": tokens})
        tok = torch.argmax(logits, -1).to(torch.int32)
        for label, steps in (("prefill", None), ("decode x3", 3)):
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CPU,
                                           ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if steps is None:
                    eng._prefill(eng.params, {"tokens": tokens})
                else:
                    for _ in range(steps):
                        logits, cache = eng._decode(eng.params, cache, tok)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            evts = [e for e in prof.key_averages()  # kernels, memsets, copies
                    if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in evts) / 1e3
            print(f"  profile {label}: wall {wall:.2f} ms, device busy "
                  f"{busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
                  f"{100 * (1 - busy / wall):.1f}%", flush=True)
            for e in sorted(evts, key=lambda e: -e.self_device_time_total)[
                    :top]:
                print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
                      f"{100 * e.self_device_time_total / 1e3 / busy:5.1f}% "
                      f"x{e.count:<5d} {e.key[:90]}", flush=True)


def main():
    phase("device")
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs a CUDA GPU", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"  torch {torch.__version__} CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}; TF32 off for fp32 matmuls and "
          "convolutions", flush=True)

    phase("build")
    t0 = time.perf_counter()
    secs = _build.build_all()
    print(f"  built {list(secs)} in {time.perf_counter() - t0:.1f} s "
          f"(per source {secs})", flush=True)
    for name in secs:
        for line in _build.build_log(name).splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")

    phase("kernels")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    entries = [check_flash(gen, flush), check_fused_mlp(gen, flush)]
    del flush
    torch.cuda.empty_cache()

    phase("numerics")
    check_numerics()
    torch.cuda.empty_cache()

    phase("serve")
    launches = serve(get_config("granite_8b").n_layers)
    for e in entries:
        e["launches"] = launches[e["name"]]

    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

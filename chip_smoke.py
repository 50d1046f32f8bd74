#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one NVIDIA GPU and check it.

    python3 chip_smoke.py

Phases, each raising on failure:
  1. device  -- require CUDA; print the card's name and power limit; set
                fp32 matmuls to full precision (no TF32).
  2. build   -- compile every CUDA kernel from ``src/repro_torch/csrc``, one
                nvcc per source, all at once; print ptxas registers/spills
                and a SASS census (HGMMA = wgmma, UTMALDG = TMA loads).
  3. kernels -- each kernel against its plain PyTorch version on the card at
                the main paths' shapes (flash_attention and fused_mlp at
                granite_8b's, ssd_scan at mamba2_780m's; flash also at
                granite_moe_1b_a400m's prefill, hd 64 GQA 16/8 4 x 2048, at
                whisper_base's encoder (non-causal, 4 x 1500, hd 64) and
                cross-attention (non-causal, Sq 128, Skv 1500) and at
                llava_next_34b's prefill (GQA 56/8, 4 x 512), and fused_mlp
                at deepseek_moe_16b's shared experts, K 2048 F 2816, and at
                llava_next_34b's K 7168 F 20480, M 2048 and 4), with its
                time, the plain version's
                time, a library yardstick's time and its bound; also flash
                at head dims 80/96 (stablelm_3b, phi3), fused_mlp at M
                4/100/2048 (both regimes, a ragged M), ssd_scan at chunk 64,
                grouped, in the Pallas layout and at zamba2_1_2b's geometry;
                fused_mlp's and ssd_scan's bitwise determinism; the device
                time of each of ssd_scan's three kernel launches
                (torch.profiler); and each kernel at the registry's smoke
                shapes (flash hd 16, fused_mlp K 64 / F 128, ssd_scan P 16 /
                N 16), which its op zero-pads to the kernel's native sizes,
                with each call's launch counted; then the decode attention
                kernel (``check_decode_attn``) at olmo_1b's, granite_8b's,
                llava_next_34b's and other decode shapes: output, the
                cache row it writes (bitwise), two calls bitwise equal,
                and its time (events, and alone by the profiler); then
                the Mamba-2 chain's two kernels (``check_ssm_chain``:
                conv_silu and gated_rmsnorm) against their plain versions
                in fp32 at mamba2_780m's and zamba2_1_2b's widths, 4 x
                2048, at the smoke widths and a 2-token prompt, two calls
                bitwise equal, timed beside the torch chain and the bytes
                bound; then AdamW's two passes (``check_adamw``) over the
                leaves of the benchmark's olmo_1b.train (1.281 B params)
                and deepseek_moe_16b.train (1.688 B): p, m and v bitwise
                the plain version's at the same scalars, the norm against
                a float64 sum, two calls bitwise equal, timed beside the
                plain torch update and the bytes bound.
  4. numerics-- at full width, the card's bf16 kernel path (prefill logits,
                then one decode step) against the port's plain path on the
                CPU in fp32, on the same weights: granite_8b, stablelm_3b
                (head dim 80, vocab 50304 padded to 50688), phi3_mini_3_8b
                (head dim 96, vocab 32064 padded to 32256), mamba2_780m,
                granite_moe_1b_a400m and deepseek_moe_16b at 2 layers,
                zamba2_1_2b at 6 (its shared block fires once), whisper_base
                at full depth (6 + 6, 2 x (1500 frames + 64 tokens)),
                llava_next_34b at 2 layers, batch 1 (also its forward with
                576 image embeddings prepended); each kernel's launches per
                step are checked; for the MoE pair, the share of (token,
                choice) routes that differ per layer is printed, and the
                logits limit is calibrated per arch.
  5. serve   -- full-width bf16 Engines (``SERVE``): full-depth granite_8b
                serves 4 requests of 512 prompt tokens, mamba2_780m (cut to
                24 of 48 layers), zamba2_1_2b (cut to 19 of 38 layers, its
                shared block 3 times) and full-depth granite_moe_1b_a400m
                (24 layers) 4 of 2048, full-depth deepseek_moe_16b (28
                layers, ~31 GiB of weights) 4 of 512, full-depth
                whisper_base 4 of (1500 frames + 128 tokens), full-depth
                llava_next_34b (60 layers, 64.06 GiB of weights) 4 of 512,
                32 greedy new tokens each; each path's launch counters,
                zeroed just before
                it, must show that it went through its kernels (flash's
                also split by regime: causal, non-causal Sq = Skv,
                non-causal Sq != Skv); the decode
                step's weight-read bound is printed beside its time; then
                each is profiled over one prefill and 3 decode steps.
  6. train   -- the training half: (a) each kernel's autograd Function
                (kernel forward; its backward the backward kernels,
                csrc/flash_attn_bwd.cu, csrc/fused_mlp_bwd.cu and
                csrc/ssd_scan_bwd.cu) at the
                train shapes (flash and fused_mlp at olmo_1b's, SSDScan at
                mamba2_780m's, flash also at granite_moe_1b_a400m's, in
                whisper_base's three regimes
                at B=4: the encoder's non-causal 1500 x 1500, the decoder's
                causal 448 and its cross-attention 448 x 1500, at
                llava_next_34b's, at hd 80 and 96 and at the smoke hd 16;
                SSDScan also at the smoke P 16, FusedMLP at the smoke K 64,
                F 128): its output against the plain version, its
                gradients against autograd of the plain version (SSDScan:
                of the chunked form ``ssd_chunked``), two backward calls
                bit-identical, with the backward's time (flash: also
                its three launches' device time alone, by torch.profiler)
                beside the explicit-torch backward's (``attention_bwd``,
                ``fused_mlp_bwd``, ``ssd_scan_bwd``), plain autograd's and
                a library yardstick's; (b) one train
                step's loss, gradient norm and every gradient leaf on the
                card in bf16 through the kernels against the port's CPU
                fp32 path, at full width: olmo_1b, mamba2_780m,
                granite_moe_1b_a400m (also its aux, and two card steps
                bitwise equal) and llava_next_34b (1 x (576 image
                embeddings + 64 tokens)) at 2 layers, zamba2_1_2b at 6,
                whisper_base at full depth (2 x (1500 frames + 448
                tokens)), all but olmo at S = 512; (c) full-width olmo_1b,
                granite_moe_1b_a400m and whisper_base at full depth,
                mamba2_780m (24 of 48 layers) and zamba2_1_2b (19 of 38)
                (``TRAIN``; fp32 params and AdamW moments, bf16 compute,
                remat "full") train 8 steps of 4 x 2048 tokens each
                (whisper_base 4 x (1500 frames + 448 tokens)) through the
                port's Trainer: finite, decreasing loss (and the MoE's
                aux), every kernel of the model in every step (forward and
                remat recompute; flash also by regime), step time,
                tokens/s, peak memory, model-FLOP share (active params;
                whisper_base's encoder on its frames, its decoder on its
                tokens), a profiled step and its forward/backward/optimizer
                split; (d) checkpoint: a failed run resumes bitwise from
                its checkpoint, which also restores on the CPU.
  7. mesh    -- the mesh path on this one card: a one-rank NCCL process
                group and a (1, 1) (data, model) mesh. olmo_1b (full
                width, 2 layers, 4 x 2048, 2 steps) trains through the
                Trainer with the mesh (params and ZeRO moments DTensors,
                the kernels behind local_map) and without: losses, params
                and moments bitwise equal (else held to TRAIN_LIMITS), the
                same kernel launches; one granite_8b decode step (full
                width, 2 layers, batch 4, cache_specs placements) bitwise
                equal to the meshless step; olmo_1b_smoke's mesh Trainer saves, and
                its checkpoint restores without a mesh and through a mesh
                Trainer, bitwise;
                ``pipeline_forward`` with one stage over 6 microbatches,
                the stage the fused MLP at granite_8b's width, equal to
                ``sequential_reference``. The MoE (``MESH_MOE_TRAIN``,
                ``MESH_MOE_DECODE``): granite_moe_1b_a400m and
                deepseek_moe_16b at full width, 2 layers, 4 x 2048, 2
                Trainer steps with and without the mesh (tp plan,
                moe_shards 1; the three local_calls of each MoE layer),
                held as olmo_1b is (bitwise, else TRAIN_LIMITS; deepseek,
                which has none, bitwise), the same flash and fused_mlp
                launches, and one decode step of each, bitwise. World size
                1 shows the mesh path runs and equals the meshless one; it
                shows nothing of collectives across cards.
  8. dryrun  -- the port's dry-run (``launch.dryrun.run_and_save``) of
                ``DRYRUN``'s cells on this machine's CPU, fake tensors on
                the fake 16 x 16 and 2 x 16 x 16 meshes: granite_8b
                long_500k skipped, the others ok, FLOPs > 0, model FLOPs
                at most the counted FLOPs of all chips, no kernel launch;
                each cell's roofline, peak against this card's memory and
                seconds.
  9. mapping -- the Fast-OverlaPIM mapper (numpy, on the host CPU): lowers
                the 20 full-size scenarios of ``list_scenarios()`` (layers
                and MACs of each); answers the full-size requests of
                ``scripts/mapping_frontier_hashes.py`` (resnet18,
                granite_8b:prefill@2048, mamba2_780m:prefill@2048,
                deepseek_moe_16b:decode@1024; grid explorer, budget 4)
                through ``MappingService`` on a fresh journal, printing
                each winner, ``evaluated``, wall time and the sha256 of
                its ``frontier_json``; replays each from the memo and from
                a fresh service over the same journal (evaluated 0, the
                same bytes); one HTTP round trip equal to the in-process
                answer; one ``distributed=2`` request (forked workers,
                after the CUDA context and torch's thread pool exist,
                under a watchdog) equal to the serial one. Prints the host
                CPU's model: these are host times, not card times.
 10. launchers -- ``launch.train`` (2 steps) and ``launch.serve`` with
                their defaults (the smoke config on cuda) for olmo_1b,
                mamba2_780m, zamba2_1_2b, granite_moe_1b_a400m and
                deepseek_moe_16b, and ``launch.serve`` for whisper_base and
                llava_next_34b, each through its kernels.
The depth cuts of mamba2_780m and zamba2_1_2b (``SERVE``, ``TRAIN``) keep the
run within the time it took before the MoE paths came. The last two lines of
output are a JSON ``kernels`` line and the JSON result line. Exits non-zero,
printing no result, without a GPU or without the repo.
"""
from __future__ import annotations

import json
import multiprocessing
import os
import platform
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.distributed.device_mesh import init_device_mesh

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, os.path.join(ROOT, "scripts"))

from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import adamw as adamw_kernels  # noqa: E402
from repro_torch.kernels import counters as kernel_counters  # noqa: E402
from repro_torch.kernels.decode_attn import (decode_attention,  # noqa: E402
                                             decode_attention_ref,
                                             rope_table)
from repro_torch.kernels.decode_attn.ops import split_plan  # noqa: E402
from calibrate_train_numerics import (leaf_rel_rms,  # noqa: E402
                                      record_routes, route_flips)
from mapping_frontier_hashes import REQUESTS as MAPPING_REQUESTS  # noqa: E402
from mapping_frontier_hashes import frontier_sha256  # noqa: E402
from repro_torch.data.synthetic import DataConfig  # noqa: E402
from repro_torch.kernels.flash_attn import (FlashAttention,  # noqa: E402
                                            attention_ref, flash_attention)
from repro_torch.kernels.flash_attn.ops import REGIMES, attention_bwd  # noqa: E402
from repro_torch.kernels.fused_mlp import (FusedMLP, fused_mlp,  # noqa: E402
                                           fused_mlp_ref)
from repro_torch.kernels.fused_mlp.ops import bwd_plan as fused_mlp_bwd_plan  # noqa: E402
from repro_torch.kernels.fused_mlp.ops import fused_mlp_bwd, regime  # noqa: E402
from repro_torch.kernels.fused_mlp.ops import padded_dims as padded_mlp_dims  # noqa: E402
from repro_torch.kernels.ssd_scan import (SSDScan, from_pallas_layout,  # noqa: E402
                                          ssd_ref, ssd_scan, ssd_scan_bwd,
                                          to_pallas_layout)
from repro_torch.kernels.ssd_scan.ops import bwd_work as ssd_bwd_work  # noqa: E402
from repro_torch.kernels.ssm_chain import (conv_silu,  # noqa: E402
                                           conv_silu_ref, gated_rmsnorm,
                                           gated_rmsnorm_ref)
from repro_torch.launch import serve as serve_launcher  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch import sharding  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.launch.steps import make_decode_step  # noqa: E402
from repro_torch.pipeline.overlap_pipeline import (  # noqa: E402
    pipeline_forward, sequential_reference)
from repro_torch.launch import train as train_launcher  # noqa: E402
from repro_torch.models import model_zoo  # noqa: E402
from repro_torch.launch.steps import value_and_grad  # noqa: E402
from repro_torch.models.common import (keeps_fp32, tree_get,  # noqa: E402
                                       tree_map)
from repro_torch.models.ssm import ssd_chunked  # noqa: E402
from repro_torch.serve import (MappingHTTPServer, MappingRequest,  # noqa: E402
                               MappingService)
from repro_torch.serve.engine import Engine, ServeConfig  # noqa: E402
from repro_torch.train import checkpoint as ckpt_lib  # noqa: E402
from repro_torch.train.optimizer import (OptimizerConfig,  # noqa: E402
                                         adamw_update, global_norm,
                                         lr_schedule)
from repro_torch.train.trainer import Trainer, TrainerConfig  # noqa: E402
from repro_torch.workloads import describe_scenario, list_scenarios  # noqa: E402

# H100 SXM data sheet: dense bf16 tensor rate, float32 rate outside the
# tensor cores, and HBM3 bandwidth.
PEAK_BF16_FLOPS = 989e12
PEAK_FP32_FLOPS = 67e12
PEAK_BYTES = 3.35e12
BF16 = torch.bfloat16
SEED = 0

# Tolerances, stated with their reasons:
# kernel vs plain (both on the card, same bf16 inputs): the plain version is
# exact fp32 math rounded once to bf16; the kernels also round P (flash) or
# h (fused_mlp) to bf16 before the second product and sum in another (fixed)
# order: wgmma's, and for fused_mlp decode the split of the reduction over
# a cluster, added in rank order. Outputs are O(1), so bf16's 2^-8 relative
# step bounds the gap: the repo's bf16 tolerance.
KERNEL_ATOL = KERNEL_RTOL = 2e-2
# ssd_scan vs ssd_ref (same bf16 x/B/C, fp32 dt/A): both sum in fp32 and
# round y to bf16 once, in another order, so they differ by about one bf16
# step (2^-8 relative) of y; the repo's bf16 tolerance above holds, tighter
# than its bf16 SSD tolerance (5e-2, tests/test_kernels.py:148).
SSD_ATOL = SSD_RTOL = 2e-2
# bf16 card path vs fp32 CPU path through 2 full-width layers: ~10 rounded
# bf16 operations per layer (2^-9 relative each) compound to ~1% of the
# logits' RMS; 3% leaves room without hiding a wrong kernel (which is O(1)).
# whisper_base (6 + 6 layers, 2 x (1500 frames + 64 tokens)) and
# llava_next_34b (2 layers, 1 x 64 tokens, and its forward with 576 image
# embeddings) keep this limit: scripts/calibrate_train_numerics.py --no-step
# at those settings (CPU bf16 vs fp32, same weights) measured prefill and
# decode logits rel RMS 8.206e-3 and 9.030e-3 (whisper), 6.925e-3, 6.862e-3
# and 6.631e-3 for the forward (llava), within the ~1% above.
NUMERICS_REL_RMS = 3e-2
# The moe family's limits, from scripts/calibrate_train_numerics.py
# --no-step at the same setting (full width, 2 layers, 2 x 512 tokens; CPU
# bf16 vs fp32, same weights): prefill and decode logits rel RMS, and the
# share of (token, choice) routes that differ per layer in the prefill and
# the decode step. A route that flips between the two (a near-tie in the
# fp32 router under bf16 activations, or a queue position a flip moved past
# the capacity) changes that token's output by O(gate), so the logits
# spread over 2 layers is larger than rounding alone would give, and
# varies with the data; each limit is ~4x the larger calibrated spread. A
# wrong kernel or a wrong dispatch is O(1).
CALIBRATED = {  # arch: (prefill rel RMS, decode rel RMS, routes differ)
    "granite_moe_1b_a400m": (5.445e-3, 5.677e-3, [0.0199, 0.0313],
                             [0.0, 0.0]),
    "deepseek_moe_16b": (7.092e-3, 7.169e-3, [0.0171, 0.0327], [0.0, 0.0]),
}
LOGITS_REL_RMS = {"granite_moe_1b_a400m": 2.3e-2, "deepseek_moe_16b": 2.9e-2}
# Gradients of a kernel's Function (kernel forward, backward kernels) vs
# autograd of its plain version, same bf16 inputs: the fused MLP's backward
# rounds g, u, h, dg and du to bf16 where autograd of the fp32 plain version
# does not (one bf16 step, ~3.5e-3 relative RMS on the CPU,
# tests/test_torch_kernels.py::test_functions_match_autograd_of_plain_bf16;
# its kernels' rounding emulated at olmo_1b's K:F in
# tests/test_torch_mlp_grad.py::test_bwd_kernel_rounding_at_olmo_ratio);
# flash's rounds P and dS to bf16 before its products, as its explicit torch
# version attention_bwd does (~3e-3 relative RMS, at most 7e-3 of the
# largest gradient there). Each gradient is scaled by
# its largest magnitude, so it is O(1) like the outputs the repo's bf16
# tolerance was set for, and held to that tolerance.
GRAD_ATOL = GRAD_RTOL = 2e-2
# One train step, card bf16 kernel path vs CPU fp32 plain path, olmo_1b at
# full width and 2 layers, 2 x 256 tokens. scripts/calibrate_train_numerics.py
# (bf16 plain path vs fp32, both on the CPU, same setting) measured: loss
# rel diff 6.0e-7, grad_norm rel diff 2.7e-5, worst leaf (layers/attn/wk)
# rel RMS 1.28e-2; the card path, which rounds at other places (P in flash,
# the backwards' bf16 products), gave 1.08e-5, 1.43e-5 and 1.20e-2 on an
# H100. The per-leaf limit is the check that finds a wrong kernel: a dropped
# or wrong gradient term is O(1) on its leaf. The loss at random init is
# about ln(vocab) whatever the layers compute, and one leaf moves the
# global norm little, so those two limits only catch a broken loss or a
# gross fault; each sits about 10x above the larger spread seen.
# SSDScan's gradients vs autograd of the fp32 chunked form, same inputs,
# each scaled by its largest magnitude: the backward reads no kernel output,
# so the two differ by fp32 sums in another order, and dx, dB, dC (bf16, as
# x, B, C) by at most one bf16 step where those sums round to neighbouring
# values: below 2^-7 = 7.8e-3 of the largest magnitude. Measured on an H100
# at mamba2_780m's train shape (PERF.md), the explicit torch backward: dx
# 1.19e-3, dB 5.78e-3, dC 5.81e-3 (one step at the top binade), ddt 7.9e-6,
# dA 2.3e-5 to 3.2e-5. The backward kernels (csrc/ssd_scan_bwd.cu) also
# feed M and dS to their products as bf16, and the state side as bf16
# hi/lo: a CPU emulation of that rounding
# (tests/test_torch_ssd_grad.py::test_ssd_bwd_kernel_rounding_at_mamba2_geometry)
# puts dx, dB, dC at ~3e-3 and ddt, dA below 1e-5 of the exact gradient.
SSD_GRAD_BF16 = 8e-3    # one bf16 step of the largest magnitude
SSD_GRAD_FP32 = 1e-4    # ~4x the larger fp32 error measured
TRAIN_LOSS_REL = 1e-4
TRAIN_GNORM_REL = 3e-4
TRAIN_LEAF_REL_RMS = 5e-2   # ~4x the worst calibrated leaf
# The ssm and hybrid steps, at full width and S = 512 (the real chunk of
# 256), set by the same rule (loss and grad_norm ~10x, each leaf ~4x the
# spread) from the same script's bf16-vs-fp32 spread on the CPU: mamba2_780m
# at 2 layers, 2 x 512 tokens: loss rel 9.4e-6, grad_norm rel 2.2e-4, worst
# leaf (layers/ssm/wC) 2.1e-2; zamba2_1_2b at 6 layers: 5.5e-5, 1.7e-4 and
# 4.2e-2 (shared_attn/attn/wk). Both sit above olmo_1b's spread (more bf16
# roundings a layer, and six layers), so olmo's limits would leave little
# or no room: zamba2's loss and worst leaf alone are at half and 85% of
# them. A wrong kernel is still O(1) on its leaves.
# granite_moe_1b_a400m at 2 layers, 2 x 512 tokens, same rule: loss rel
# 8.1e-6, grad_norm rel 5.3e-5, aux rel 5.3e-6, worst leaf
# (layers/moe/router) 5.0e-2, with 2-3% of the prefill routes differing
# per layer (above). The router leaf is the one routing flips move most:
# its gradient is the gates' and the aux term's only.
# whisper_base at full depth (6 + 6 layers), 2 x (1500 frames + 448
# tokens), same rule, from the same script run on the GPU machine's CPU:
# loss rel 5.1e-5, grad_norm rel 2.0e-3, worst leaf
# (decoder/self_attn/wq) 1.46e-2. llava_next_34b at 2 layers, 1 x (576
# image embeddings + 64 tokens): loss rel 7.4e-5, grad_norm rel 9.3e-6,
# worst leaf (layers/attn/wq) 1.30e-2; its grad_norm limit is olmo_1b's
# (about 30x its spread), as the card's spread on olmo_1b's grad_norm
# sat at half the CPU calibration's and its loss spread 18x above it.
TRAIN_LIMITS = {  # arch: (loss rel, grad_norm rel, leaf rel RMS)
    "olmo_1b": (TRAIN_LOSS_REL, TRAIN_GNORM_REL, TRAIN_LEAF_REL_RMS),
    "mamba2_780m": (1e-4, 2.5e-3, 9e-2),
    "zamba2_1_2b": (6e-4, 2e-3, 1.7e-1),
    "granite_moe_1b_a400m": (1e-4, 6e-4, 2e-1),
    "whisper_base": (5e-4, 2e-2, 6e-2),
    "llava_next_34b": (7e-4, TRAIN_GNORM_REL, 5e-2),
}
TRAIN_AUX_REL = 1e-4    # ~20x the calibrated aux spread


T0 = time.perf_counter()
# (arch, batch, prompt tokens, depth) of the serve phase: full width, 32
# greedy new tokens each; depth None is full depth. The run's time is held
# to what it was before the MoE paths came (PERF.md), so two earlier paths
# run at half depth: mamba2_780m at 24 of 48 layers, zamba2_1_2b at 19 of
# 38 (its shared block fires 3 times), here and in ``TRAIN``.
SERVE = (("granite_8b", 4, 512, None), ("mamba2_780m", 4, 2048, 24),
         ("zamba2_1_2b", 4, 2048, 19),
         ("granite_moe_1b_a400m", 4, 2048, None),
         ("deepseek_moe_16b", 4, 512, None),
         # 4 x (1500 frames + 128 prompt tokens), encoder and decoder 6 each
         ("whisper_base", 4, 128, None),
         # full depth: 60 layers, 34.39 B params, 64.06 GiB of bf16 weights
         ("llava_next_34b", 4, 512, None))
# (arch, depth, batch, tokens a row) of the full-width numerics checks: the
# card's bf16 path against the CPU's fp32 path, serving and one step;
# whisper_base's depth is the decoder's (its 6 encoder layers run in full,
# on 1500 frames), llava_next_34b also runs its forward with 576 image
# embeddings prepended
NUMERICS = (("granite_8b", 2, 2, 64), ("stablelm_3b", 2, 2, 256),
            ("phi3_mini_3_8b", 2, 2, 256), ("mamba2_780m", 2, 2, 512),
            ("zamba2_1_2b", 6, 2, 512), ("granite_moe_1b_a400m", 2, 2, 512),
            ("deepseek_moe_16b", 2, 2, 512), ("whisper_base", 6, 2, 64),
            ("llava_next_34b", 2, 1, 64))
# whisper_base's decoder context in training: its published text context
# (arXiv:2212.04356), beside its 1500 encoder frames
WHISPER_TRAIN_TOKENS = 448
# llava_next_34b's text tokens in its one-step check, beside its 576 image
# embeddings: enough that the CPU fp32 reference takes well under a minute
LLAVA_TRAIN_TOKENS = 64
# (arch, depth, batch, tokens a row) of the one-step train numerics;
# whisper_base's depth is the decoder's (6 encoder layers on 1500 frames),
# llava_next_34b's step prepends 576 image embeddings (its 24 x 24 base
# grid), and its fp32 state at full depth (~550 GB) fits no card
TRAIN_NUMERICS = (("olmo_1b", 2, 2, 256), ("mamba2_780m", 2, 2, 512),
                  ("zamba2_1_2b", 6, 2, 512),
                  ("granite_moe_1b_a400m", 2, 2, 512),
                  ("whisper_base", 6, 2, WHISPER_TRAIN_TOKENS),
                  ("llava_next_34b", 2, 1, LLAVA_TRAIN_TOKENS))
# (arch, depth, tokens a row) of the full-width training runs, 8 steps of
# batch 4; None is full depth; whisper_base's rows also hold 1500 frames
TRAIN = (("olmo_1b", None, 2048), ("mamba2_780m", 24, 2048),
         ("zamba2_1_2b", 19, 2048), ("granite_moe_1b_a400m", None, 2048),
         ("whisper_base", None, WHISPER_TRAIN_TOKENS))


def phase(name):
    print(f"== {name} (at {time.perf_counter() - T0:.1f} s)", flush=True)


def clocked(label, fn, *args, **kw):
    """``fn(*args, **kw)``, printing its wall time (the run's budget)."""
    t0 = time.perf_counter()
    out = fn(*args, **kw)
    print(f"  [{label}: {time.perf_counter() - t0:.1f} s]", flush=True)
    return out


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


def compare(name, got, want, atol=KERNEL_ATOL, rtol=KERNEL_RTOL):
    """Max abs and relative error; raises beyond the tolerance."""
    got, want = got.detach().float(), want.detach().float()
    err = (got - want).abs()
    max_abs = float(err.max())
    max_rel = float((err / want.abs().clamp_min(1e-3)).max())
    bad = int((err > atol + rtol * want.abs()).sum())
    ok = bad == 0 and bool(torch.isfinite(got).all())
    print(f"  {name}: max_abs={max_abs:.3e} max_rel={max_rel:.3e} "
          f"outside atol={atol} rtol={rtol}: {bad} "
          f"-> {'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise RuntimeError(f"{name}: kernel disagrees with its plain version")
    return max_abs


def randn(gen, *shape, scale=1.0):
    return (torch.randn(shape, generator=gen, device="cuda") * scale).to(BF16)


def flash_times(q, k, v, flush, causal=True):
    """ms of the flash kernel, the plain version and SDPA on bshd inputs,
    and the bound for the (query, key) pairs the mask keeps (causal:
    end-aligned)."""
    b, sq, nh, d = q.shape
    skv, nkv = k.shape[1], k.shape[2]
    ms = cuda_ms(lambda: flash_attention(q, k, v, causal=causal), 20, flush)
    plain = cuda_ms(lambda: attention_ref(q, k, v, causal=causal), 5, flush)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=causal, enable_gqa=True), 20, flush)
    pairs = (sum(min(skv, i + (skv - sq) + 1) for i in range(sq)) if causal
             else sq * skv)
    flops = 4.0 * b * nh * d * pairs
    nbytes = 2.0 * (2 * b * sq * nh * d + 2 * b * skv * nkv * d)
    bms, by = bound_ms(flops, nbytes)
    mask = "causal" if causal else "non-causal"
    sizes = f"S={sq}" if sq == skv else f"Sq={sq} Skv={skv}"
    print(f"  flash_attention B={b} {sizes} H={nh} KV={nkv} hd={d} {mask}: "
          f"kernel {ms:.4f} ms, plain {plain:.4f} ms, SDPA {lib:.4f} ms, "
          f"bound {bms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    return {"ms": ms, "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib,
            "library": f"F.scaled_dot_product_attention(is_causal={causal}, "
                       "enable_gqa=True)",
            "shape": f"B={b} {sizes} H={nh} KV={nkv} hd={d} {mask} bf16"}


def check_flash(gen, flush):
    """Flash kernel vs attention_ref; returns the kernel's JSON entry
    (granite_8b's prefill shape) with granite_moe_1b_a400m's prefill shape
    (hd 64, GQA 16/8, 4 x 2048) nested under "moe", whisper_base's
    encoder (non-causal, S 1500) and cross-attention (non-causal, Sq 128,
    Skv 1500) under "whisper", and llava_next_34b's prefill (GQA 56/8)
    under "llava"."""
    cfg = get_config("granite_8b")
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
    gm = get_config("granite_moe_1b_a400m")
    wh = get_config("whisper_base")
    lv = get_config("llava_next_34b")
    cases = [  # (timed as, label, b, sq, skv, h, kv, hd, causal, layout)
        ("main", "prefill B=4 S=512 causal", 4, 512, 512, h, kv, hd, True,
         "bshd"),
        (None, "ragged S=500 causal", 4, 500, 500, h, kv, hd, True, "bshd"),
        (None, "non-causal S=512", 4, 512, 512, h, kv, hd, False, "bshd"),
        (None, "end-aligned Sq=100 Skv=300 hd=64, Pallas layout", 2, 100,
         300, 8, 2, 64, True, "pallas"),
        ("moe", f"granite_moe_1b_a400m prefill B=4 S=2048 H={gm.n_heads} "
         f"KV={gm.n_kv_heads} hd={gm.hd} causal", 4, 2048, 2048, gm.n_heads,
         gm.n_kv_heads, gm.hd, True, "bshd"),
        ("whisper encoder", f"whisper_base encoder B=4 S={wh.enc_frames} "
         f"H={wh.n_heads} KV={wh.n_kv_heads} hd={wh.hd} non-causal", 4,
         wh.enc_frames, wh.enc_frames, wh.n_heads, wh.n_kv_heads, wh.hd,
         False, "bshd"),
        ("whisper cross", f"whisper_base cross-attention B=4 Sq=128 "
         f"Skv={wh.enc_frames} hd={wh.hd} non-causal", 4, 128, wh.enc_frames,
         wh.n_heads, wh.n_kv_heads, wh.hd, False, "bshd"),
        ("llava", f"llava_next_34b prefill B=4 S=512 H={lv.n_heads} "
         f"KV={lv.n_kv_heads} hd={lv.hd} causal", 4, 512, 512, lv.n_heads,
         lv.n_kv_heads, lv.hd, True, "bshd"),
    ]
    for arch in ("stablelm_3b", "phi3_mini_3_8b"):
        c = get_config(arch)
        cases.append((None, f"{arch} B=2 S=512 H={c.n_heads} "
                      f"KV={c.n_kv_heads} hd={c.hd} causal", 2, 512, 512,
                      c.n_heads, c.n_kv_heads, c.hd, True, "bshd"))
    timed = {}
    for key, label, b, sq, skv, nh, nkv, d, causal, layout in cases:
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
        del out, ref
        if key:
            timed[key] = {"max_abs_err": err,
                          **flash_times(q, k, v, flush, causal)}
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/flash_attn.cu",
            "replaces": "src/repro/kernels/flash_attn/flash_attn.py:73",
            "launches": None, **timed["main"],
            "moe": {"path": "granite_moe_1b_a400m prefill", "launches": None,
                    **timed["moe"]},
            "whisper": {"path": "whisper_base serve (encoder once, then per "
                                "decoder layer causal self and non-causal "
                                "cross)", "launches": None,
                        "launches_by_regime": None,
                        "encoder": {"launches": None,
                                    **timed["whisper encoder"]},
                        "cross": {"launches": None,
                                  **timed["whisper cross"]}},
            "llava": {"path": "llava_next_34b prefill", "launches": None,
                      **timed["llava"]}}


def mlp_case(gen, flush, k, f, cases):
    """fused_mlp kernel vs fused_mlp_ref at K x F for each (label, M) in
    ``cases``: error, two calls bit-identical, and (except "ragged") the
    kernel's, plain version's and cuBLAS chain's ms and the bound.
    Returns {label: entry}."""
    w1 = randn(gen, k, f, scale=k ** -0.5)
    w3 = randn(gen, k, f, scale=k ** -0.5)
    w2 = randn(gen, f, k, scale=f ** -0.5)
    entries = {}
    for label, m in cases:
        x = randn(gen, m, k)
        out = fused_mlp(x, w1, w3, w2)
        ref = fused_mlp_ref(x, w1, w3, w2)
        again = fused_mlp(x, w1, w3, w2)
        torch.cuda.synchronize()
        err = compare(f"fused_mlp [{label} M={m} K={k} F={f}, "
                      f"{regime(m)} kernels]", out, ref)
        same = torch.equal(out, again)
        print(f"  fused_mlp [{label} M={m}] two calls bit-identical: {same}",
              flush=True)
        if not same:
            raise RuntimeError("fused_mlp is not deterministic")
        if label == "ragged":
            continue
        ms = cuda_ms(lambda: fused_mlp(x, w1, w3, w2), 10, flush)
        plain = cuda_ms(lambda: fused_mlp_ref(x, w1, w3, w2), 3, flush)
        lib = cuda_ms(lambda: (F.silu(x @ w1) * (x @ w3)) @ w2, 10, flush)
        bms, by = bound_ms(6.0 * m * k * f, 2.0 * (2 * m * k + 3 * k * f))
        print(f"  fused_mlp {label} M={m} K={k} F={f}: kernel {ms:.4f} ms, "
              f"plain {plain:.4f} ms, cuBLAS chain {lib:.4f} ms, bound "
              f"{bms:.4f} ms ({by})", flush=True)
        entries[label] = {"max_abs_err": err, "ms": ms, "plain_ms": plain,
                          "bound_ms": bms, "bound_by": by, "library_ms": lib,
                          "shape": f"M={m} K={k} F={f} bf16"}
    return entries


def check_fused_mlp(gen, flush):
    """fused_mlp kernel vs fused_mlp_ref at granite_8b's prefill and
    decode shapes, at deepseek_moe_16b's shared experts' (K 2048, F 2 x
    1408) and at llava_next_34b's (K 7168, F 20480), prefill M 2048 and
    decode M 4; returns the kernel's JSON entry (granite_8b prefill) with
    its decode case and the deepseek and llava cases nested."""
    cfg = get_config("granite_8b")
    dense = mlp_case(gen, flush, cfg.d_model, cfg.d_ff,
                     (("prefill", 2048), ("decode", 4), ("ragged", 100)))
    ds = get_config("deepseek_moe_16b")
    moe = mlp_case(gen, flush, ds.d_model, ds.n_shared_experts * ds.d_ff,
                   (("prefill", 2048), ("decode", 4)))
    lv = get_config("llava_next_34b")
    llava = mlp_case(gen, flush, lv.d_model, lv.d_ff,
                     (("prefill", 2048), ("decode", 4)))
    return {"name": "fused_mlp", "route": "cuda",
            "source": "src/repro_torch/csrc/fused_mlp.cu",
            "replaces": "src/repro/kernels/fused_mlp/fused_mlp.py:52",
            "launches": None, **dense["prefill"],
            "library": "cuBLAS chain: (silu(x@w1) * (x@w3)) @ w2, 3 matmuls",
            "decode": dense["decode"],
            "moe": {"path": "deepseek_moe_16b shared experts",
                    "launches": None, **moe["prefill"],
                    "decode": moe["decode"]},
            "llava": {"path": "llava_next_34b serve", "launches": None,
                      **llava["prefill"], "decode": llava["decode"]}}


def ssd_inputs(gen, b, s, h, g, n, p):
    """Model-layout SSD inputs as the model path makes them: bf16 x, B, C;
    fp32 dt = softplus(.) > 0 and A = -exp(.) < 0."""
    x = randn(gen, b, s, h, p)
    dt = F.softplus(torch.randn((b, s, h), generator=gen, device="cuda"))
    a = -torch.exp(torch.randn((h,), generator=gen, device="cuda") * 0.2)
    return x, dt, a, randn(gen, b, s, g, n), randn(gen, b, s, g, n)


def check_ssd(gen, flush):
    """ssd_scan kernel vs ssd_ref (y and final state) at mamba2_780m's
    prefill shape, a grouped case, the Pallas layout, two chunk sizes and
    zamba2_1_2b's geometry; two calls bit-identical; each of the op's
    kernel launches timed by torch.profiler; returns the kernel's JSON
    entry (main shape)."""
    cfg = get_config("mamba2_780m")
    b, s, h, p = 4, 2048, cfg.ssm_heads, cfg.ssm_head_dim
    g, n, chunk = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk
    zcfg = get_config("zamba2_1_2b")
    main = ssd_inputs(gen, b, s, h, g, n, p)
    cases = [  # (label, inputs, chunk, Pallas layout)
        (f"mamba2_780m B={b} S={s} H={h} P={p} N={n} G={g} chunk {chunk}",
         main, chunk, False),
        ("same inputs, chunk 64", main, 64, False),
        ("grouped G=2 B=2 S=512 H=8 N=64 chunk 256",
         ssd_inputs(gen, 2, 512, 8, 2, 64, p), 256, False),
        ("Pallas layout BH=8 S=512 N=128 chunk 128",
         to_pallas_layout(*ssd_inputs(gen, 1, 512, 8, 8, 128, p)), 128, True),
        (f"zamba2_1_2b B=2 S=1024 H={zcfg.ssm_heads} N={zcfg.ssm_state} "
         f"G={zcfg.ssm_groups} chunk {zcfg.ssm_chunk}",
         ssd_inputs(gen, 2, 1024, zcfg.ssm_heads, zcfg.ssm_groups,
                    zcfg.ssm_state, zcfg.ssm_head_dim), zcfg.ssm_chunk, False),
    ]
    errs, y_main = [], None
    for label, args, ck, pallas in cases:
        y, state = ssd_scan(*args, chunk=ck)
        if pallas:
            want_y, want_state = ssd_ref(*args)
        else:
            want_y, want_state = from_pallas_layout(
                *ssd_ref(*to_pallas_layout(*args)), args[0].shape[0])
        torch.cuda.synchronize()
        errs.append(compare(f"ssd_scan y [{label}]", y, want_y,
                            SSD_ATOL, SSD_RTOL))
        compare(f"ssd_scan state [{label}]", state, want_state, SSD_ATOL,
                SSD_RTOL)
        if y_main is None:
            y_main = y
        elif ck == 64:
            compare("ssd_scan y chunk 64 vs chunk 256", y, y_main, SSD_ATOL,
                    SSD_RTOL)
        del y, state, want_y, want_state
    y, state = ssd_scan(*main, chunk=chunk)
    y2, state2 = ssd_scan(*main, chunk=chunk)
    same = torch.equal(y, y2) and torch.equal(state, state2)
    print(f"  ssd_scan [main shape] two calls bit-identical (y and state): "
          f"{same}", flush=True)
    if not same:
        raise RuntimeError("ssd_scan is not deterministic")
    del y, state, y2, state2
    launch_ms = ssd_launch_profile(main, chunk)
    ms = cuda_ms(lambda: ssd_scan(*main, chunk=chunk), 10, flush)
    ref_in = to_pallas_layout(*main)
    plain = cuda_ms(lambda: ssd_ref(*ref_in), 2, flush)
    lib = cuda_ms(lambda: ssd_chunked(*main, chunk), 5, flush)
    flops = 2.0 * b * h * s * ((chunk + 1) / 2 * (n + p) + 2 * n * p)
    nbytes = (2 * 2 * b * s * h * p + 2 * 2 * b * s * g * n + 4 * b * s * h
              + 4 * h + 4 * b * h * n * p)
    bms, by = bound_ms(flops, nbytes)
    print(f"  ssd_scan B={b} S={s} H={h} P={p} N={n} chunk {chunk}: kernel "
          f"{ms:.4f} ms, plain {plain:.4f} ms, torch chain (ssd_chunked) "
          f"{lib:.4f} ms, bound {bms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    return {"name": "ssd_scan", "route": "cuda",
            "source": "src/repro_torch/csrc/ssd_scan.cu",
            "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:63",
            "launches": None, "max_abs_err": max(errs), "ms": ms,
            "plain_ms": plain, "bound_ms": bms, "bound_by": by,
            "library_ms": lib, "launch_device_ms": launch_ms,
            "library": "torch chain, not one call: "
                       "repro_torch.models.ssm.ssd_chunked (einsums and a "
                       "loop over chunks); no single PyTorch call computes "
                       "the SSD scan",
            "shape": f"B={b} S={s} H={h} P={p} N={n} G={g} chunk {chunk}, "
                     "bf16 x/B/C, fp32 dt/A"}


def ssd_launch_profile(args, chunk):
    """Device time of each kernel launch of one ssd_scan call (the C entry
    issues three: chunk states, state passing, chunk scan), by
    torch.profiler; returns {kernel name: ms}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    ssd_scan(*args, chunk=chunk)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        ssd_scan(*args, chunk=chunk)
        torch.cuda.synchronize()
    evts = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    total = sum(e.device_time_total for e in evts) / 1e3
    print(f"  ssd_scan one call, profiled: {len(evts)} device launches, "
          f"{total:.4f} ms", flush=True)
    for e in evts:
        print(f"    {e.device_time_total / 1e3:9.4f} ms  {e.name[:100]}",
              flush=True)
    names = [re.search(r"ssd_\w+(<\d+>)?", e.name) for e in evts]
    return {m.group(0) if m else e.name[:60]: e.device_time_total / 1e3
            for m, e in zip(names, evts)}


def kernel_device_ms(fn, pattern: str, reps: int, flush: torch.Tensor):
    """Mean device time in ms of the kernels whose names match
    ``pattern`` in one call of ``fn``, by torch.profiler over ``reps``
    calls, ``flush`` rewritten before each (L2 cold): the kernel alone,
    without the host time that CUDA events around a call also hold."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    fn()
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            flush.zero_()
            fn()
        torch.cuda.synchronize()
    return sum(e.device_time_total for e in prof.events()
               if e.device_type == DeviceType.CUDA
               and re.search(pattern, e.name)) / 1e3 / reps


def decode_inputs(gen, b, s, h, kv, hd, rope=True):
    """The decode kernel's inputs as a decode step makes them: the new
    token's bf16 q [B,1,H,hd] and k/v [B,1,KV,hd], a filled bf16 cache
    [B,S,KV,hd], and the RoPE table of the cache's length."""
    cfg = get_config("granite_8b").with_(n_heads=h, n_kv_heads=kv,
                                         head_dim=hd)
    return (randn(gen, b, 1, h, hd), randn(gen, b, 1, kv, hd),
            randn(gen, b, 1, kv, hd), randn(gen, b, s, kv, hd),
            randn(gen, b, s, kv, hd),
            rope_table(cfg, s, "cuda") if rope else None)


def decode_times(args, pos, flush):
    """ms of the decode kernel at position ``pos`` (read on the card, as
    the caches hold it; CUDA events, and its launches alone by the
    profiler), the plain version and SDPA over the same keys (no RoPE, no
    cache write), and the bound: the keys [0, pos] of K and V read once,
    q, the new k and v and the RoPE row read, the output and the cache
    row written."""
    q, k, v, ck, cv, tab = args
    b, _, h, hd = q.shape
    kv, keys = ck.shape[2], pos + 1
    at = torch.tensor(pos, dtype=torch.int32, device="cuda")
    ms = cuda_ms(lambda: decode_attention(*args[:5], at, tab), 50, flush)
    alone = kernel_device_ms(lambda: decode_attention(*args[:5], at, tab),
                             r"decode_attn", 20, flush)
    plain = cuda_ms(lambda: decode_attention_ref(*args[:5], at, tab), 10,
                    flush)
    qt = q.transpose(1, 2)
    kt, vt = (c[:, :keys].transpose(1, 2) for c in (ck, cv))
    lib = cuda_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, enable_gqa=True), 50, flush)
    flops = 4.0 * b * h * hd * keys
    nbytes = (2.0 * (2 * b * keys * kv * hd + 2 * b * h * hd
                     + 2 * b * kv * hd + 2 * b * kv * hd)
              + (4.0 * hd if tab is not None else 0.0))
    bms, by = bound_ms(flops, nbytes)
    splits = split_plan(b, kv, ck.shape[1], _build.sm_count(0))[0]
    shape = (f"B={b} S_max={ck.shape[1]} pos={pos} H={h} KV={kv} hd={hd}"
             f"{' RoPE' if tab is not None else ''} bf16, {splits} "
             f"split{'s' if splits > 1 else ''}")
    print(f"  decode_attention {shape}: kernel {ms:.4f} ms (alone "
          f"{alone:.4f}), plain {plain:.4f} ms, SDPA {lib:.4f} ms, bound "
          f"{bms:.4f} ms ({by}; {flops / 1e9:.3f} GFLOP, "
          f"{nbytes / 1e6:.2f} MB; alone at "
          f"{100 * bms / max(alone, 1e-9):.1f}% of it)", flush=True)
    return {"ms": ms, "alone_ms": alone, "plain_ms": plain,
            "bound_ms": bms, "bound_by": by, "library_ms": lib,
            "library": "F.scaled_dot_product_attention(enable_gqa=True) "
                       "over keys [0, pos], no RoPE, no cache write",
            "shape": shape}


def check_decode_attn(gen, flush):
    """The decode kernel vs its plain version at the serving paths'
    shapes: olmo_1b's decode (B 32, KV 16, hd 128) at positions 639 and
    511, granite_8b's (B 4, KV 8, G 4, split), llava_next_34b's (B 1, G
    7), granite_moe_1b_a400m's and whisper_base's hd 64 (whisper without
    RoPE), stablelm_3b's hd 80, phi3's hd 96 and the smoke configs' hd
    16, and granite_8b's at pos 300, where the splits past pos are empty;
    each with ``pos`` a 0-d int32 on the card, as the caches hold it:
    each output within the kernel tolerance, the cache row written at
    pos bitwise the plain version's and every other slot untouched, the
    position unchanged, two calls bitwise equal; the first three timed.
    Returns the kernel's JSON entry."""
    cases = [  # (timed as, label, b, s_max, h, kv, hd, pos, rope)
        ("main", "olmo_1b decode pos 639", 32, 640, 16, 16, 128, 639, True),
        ("olmo_pos_511", "olmo_1b decode pos 511", 32, 640, 16, 16, 128,
         511, True),
        ("granite", "granite_8b decode pos 575", 4, 640, 32, 8, 128, 575,
         True),
        (None, "llava_next_34b decode", 1, 640, 56, 8, 128, 600, True),
        (None, "granite_moe_1b_a400m decode", 4, 640, 16, 8, 64, 320, True),
        (None, "whisper_base decoder, no RoPE", 4, 448, 8, 8, 64, 200,
         False),
        (None, "stablelm_3b decode", 2, 640, 32, 32, 80, 639, True),
        (None, "phi3_mini decode", 2, 640, 32, 32, 96, 0, True),
        (None, "smoke hd 16", 4, 40, 4, 4, 16, 33, True),
        (None, "granite_8b decode pos 300", 4, 640, 32, 8, 128, 300, True),
    ]
    timed, worst, empty = {}, 0.0, []
    for key, label, b, s, h, kv, hd, pos, rope in cases:
        args = decode_inputs(gen, b, s, h, kv, hd, rope)
        q, k, v, ck, cv, tab = args
        at = torch.tensor(pos, dtype=torch.int32, device="cuda")
        want_ck, want_cv = ck.clone(), cv.clone()
        want = decode_attention_ref(q, k, v, want_ck, want_cv, at, tab)
        ck2, cv2 = ck.clone(), cv.clone()
        got = decode_attention(q, k, v, ck, cv, at, tab)
        again = decode_attention(q, k, v, ck2, cv2, at, tab)
        torch.cuda.synchronize()
        worst = max(worst, compare(f"decode_attention [{label}]", got,
                                   want))
        if int(at) != pos:
            raise RuntimeError(f"decode_attention [{label}]: the kernel "
                               "moved its position")
        splits, chunk = split_plan(b, kv, s, _build.sm_count(0))
        if pos // chunk + 1 < splits:
            empty.append(f"{label} ({splits - pos // chunk - 1} of {splits})")
        if not (torch.equal(ck, want_ck) and torch.equal(cv, want_cv)):
            raise RuntimeError(f"decode_attention [{label}]: the cache "
                               "differs from the plain version's")
        if not (torch.equal(got, again) and torch.equal(ck, ck2)):
            raise RuntimeError(f"decode_attention [{label}]: two calls "
                               "differ")
        if key:
            timed[key] = {"max_abs_err": float((got.float() - want.float())
                                               .abs().max()),
                          **decode_times(args, pos, flush)}
        del args, q, k, v, ck, cv, want_ck, want_cv, ck2, cv2
    if not empty:
        raise RuntimeError("decode_attention: no case has a split past pos")
    print("  decode_attention: every cache row bitwise the plain "
          "version's, two calls bitwise equal, the position on the card "
          "unchanged; empty splits past pos in "
          + ", ".join(empty), flush=True)
    return {"name": "decode_attention", "route": "cuda",
            "source": "src/repro_torch/csrc/decode_attn.cu",
            "replaces": None, "launches": None, "max_abs_err_all": worst,
            **timed["main"], "olmo_pos_511": timed["olmo_pos_511"],
            "granite": timed["granite"]}


def chain_inputs(gen, b, s, w, gn, h, p):
    """The Mamba-2 chain's inputs as a prefill makes them: bf16
    projections xin [b,s,w], B and C [b,s,gn], dt [b,s,h], conv weights
    [4, *], the scan's y [b,s,h,p] and the gate z [b,s,w]; fp32 dt_bias,
    A_log, D and gn_scale off their init values."""
    def f32(*shape, scale=1.0, shift=0.0):
        return (torch.randn(shape, generator=gen, device="cuda") * scale
                + shift)

    conv = (randn(gen, b, s, w), randn(gen, b, s, gn), randn(gen, b, s, gn),
            randn(gen, 4, w, scale=0.5), randn(gen, 4, gn, scale=0.5),
            randn(gen, 4, gn, scale=0.5), randn(gen, b, s, h, scale=2.0),
            f32(h), f32(h, scale=0.5))
    norm = (randn(gen, b, s, h, p), conv[0], randn(gen, b, s, w),
            f32(h, shift=1.0), f32(w, scale=0.2, shift=1.0))
    return conv, norm


def chain_bytes(b, s, w, gn, h):
    """Bytes each chain kernel must move at least: (conv_silu: xin, B, C
    and dt read, xc, B, C and fp32 dt written, the weights and [H] params;
    gated_rmsnorm: y, xc and z read, the bf16 output written, D and
    gn_scale)."""
    rows = b * s
    conv = (2 * 2 * rows * (w + 2 * gn) + 2 * rows * h + 4 * rows * h
            + 2 * 4 * (w + 2 * gn) + 3 * 4 * h)
    norm = 4 * 2 * rows * w + 4 * (h + w)
    return conv, norm


def check_ssm_chain(gen, flush):
    """The Mamba-2 chain's two kernels against their plain versions in fp32
    (on the same bf16 inputs) at mamba2_780m's and zamba2_1_2b's prefill
    widths, B 4 x S 2048, at granite_4_h_small's (W 8192, H 128) at its
    cell's B 8 x S 4096, at the smoke widths and at a prompt of 2 tokens
    (shorter than the conv); two calls bitwise equal; timed at those
    sizes: the kernel (CUDA events, and alone by the profiler, L2 flushed),
    the plain version on the card (the torch chain) and the bytes bound.
    Returns the two kernels' JSON entries."""
    cases = [  # (timed as, label, b, s, w, gn, h, p)
        ("main", "mamba2_780m", 4, 2048, 3072, 128, 48, 64),
        ("zamba2_1_2b", "zamba2_1_2b", 4, 2048, 4096, 64, 64, 64),
        ("granite_4_h_small", "granite_4_h_small", 8, 4096, 8192, 128, 128,
         64),
        (None, "mamba2_780m S=2", 3, 2, 3072, 128, 48, 64),
        (None, "smoke", 4, 16, 128, 16, 8, 16),
    ]
    out = {"conv_silu": {}, "gated_rmsnorm": {}}
    worst = dict.fromkeys(out, 0.0)
    for key, label, b, s, w, gn, h, p in cases:
        conv, norm = chain_inputs(gen, b, s, w, gn, h, p)
        got = conv_silu(*conv)
        want = conv_silu_ref(*(t.float() for t in conv))
        y = gated_rmsnorm(*norm)
        want_y = gated_rmsnorm_ref(*(t.float() for t in norm))
        torch.cuda.synchronize()
        errs = [compare(f"conv_silu {name} [{label} B={b} S={s} W={w} "
                        f"GN={gn} H={h}]", g, wt)
                for name, g, wt in zip(("xc", "B", "C", "dt", "A"), got,
                                       want)]
        worst["conv_silu"] = max(worst["conv_silu"], *errs)
        worst["gated_rmsnorm"] = max(worst["gated_rmsnorm"], compare(
            f"gated_rmsnorm [{label} B={b} S={s} W={w} P={p}]", y, want_y))
        same = (all(torch.equal(g, a) for g, a in zip(got, conv_silu(*conv)))
                and torch.equal(y, gated_rmsnorm(*norm)))
        if not same:
            raise RuntimeError(f"ssm chain [{label}]: two calls differ")
        if key:
            nbytes = dict(zip(out, chain_bytes(b, s, w, gn, h)))
            for name, fn, plain, args, pat in (
                    ("conv_silu", conv_silu, conv_silu_ref, conv,
                     r"mamba2_conv_silu"),
                    ("gated_rmsnorm", gated_rmsnorm, gated_rmsnorm_ref, norm,
                     r"mamba2_gated_rmsnorm")):
                ms = cuda_ms(lambda: fn(*args), 20, flush)
                alone = kernel_device_ms(lambda: fn(*args), pat, 10, flush)
                plain_ms = cuda_ms(lambda: plain(*args), 5, flush)
                bms, by = bound_ms(0.0, nbytes[name])
                out[name][key] = {"ms": ms, "alone_ms": alone,
                                  "plain_ms": plain_ms, "bound_ms": bms,
                                  "bound_by": by, "bytes": nbytes[name],
                                  "shape": f"B={b} S={s} W={w} GN={gn} "
                                           f"H={h} P={p}"}
                print(f"  {name} [{label} B={b} S={s}]: kernel {ms:.4f} ms "
                      f"(alone {alone:.4f}, {100 * bms / alone:.1f}% of the "
                      f"bound), plain (torch chain) {plain_ms:.4f} ms, bound "
                      f"{bms:.4f} ms ({by}; {nbytes[name] / 1e6:.2f} MB)",
                      flush=True)
        del conv, norm, got, want, y, want_y
    print("  ssm chain: two calls bitwise equal in every case", flush=True)
    return [{"name": name, "route": "cuda",
             "source": "src/repro_torch/csrc/ssm_chain.cu", "replaces": None,
             "launches": None, "max_abs_err": worst[name],
             **out[name]["main"], "zamba2_1_2b": out[name]["zamba2_1_2b"],
             "granite_4_h_small": out[name]["granite_4_h_small"]}
            for name in out]


def bench_leaf_shapes(workload: str):
    """The parameter leaves' shapes of a benchmark cell's model, as the
    benchmark builds it (``bench/program.py``)."""
    from bench import manifest, program
    cell = manifest.cell(workload)
    shapes = model_zoo.param_shapes(program.model_config(cell.config,
                                                         cell.traffic))
    out = []
    tree_map(lambda _, t: out.append(tuple(t.shape)), shapes)
    return out


def check_adamw(gen, flush):
    """AdamW's two passes (``kernels.adamw``) over the leaves of the
    benchmark's olmo_1b.train and deepseek_moe_16b.train, fp32 p, g, m and
    v: each leaf's step kernel bitwise the plain version given the same
    scale, lr and bias corrections; the clip's norm within 1e-5 of a
    float64 sum and bitwise the same from call to call; timed (CUDA events
    around the clip pass and every leaf's step, and the kernels alone by
    the profiler) beside the plain torch update (``global_norm`` and the
    plain step a leaf) and the bound, 32 bytes a parameter. Returns the
    kernels' JSON entry."""
    cfg = OptimizerConfig()
    out = {}
    for key, workload in (("olmo_1b", "olmo_1b.train"),
                          ("deepseek_moe_16b", "deepseek_moe_16b.train")):
        shapes = bench_leaf_shapes(workload)
        leaves = [tuple(torch.randn(s, generator=gen, device="cuda") * sc
                        for sc in (1.0, 1e-3, 1e-4, 1e-4)) for s in shapes]
        for _, _, _, v in leaves:
            v.square_()
        n = sum(p.numel() for p, *_ in leaves)
        gs = [g for _, g, _, _ in leaves]
        want = float(np.sqrt(sum(float(torch.sum(g.double() ** 2))
                                 for g in gs)))
        norm, scale = adamw_kernels.adamw_sumsq(gs, cfg.clip_norm)
        again, _ = adamw_kernels.adamw_sumsq(gs, cfg.clip_norm)
        torch.cuda.synchronize()
        norm_rel = abs(float(norm) - want) / want
        if norm_rel > 1e-5 or not torch.equal(norm, again):
            raise RuntimeError(f"adamw_sumsq [{key}]: norm {float(norm)!r} "
                               f"vs float64 {want!r} (rel {norm_rel:.2e}), "
                               f"again {float(again)!r}")
        step = torch.tensor(3, dtype=torch.int32, device="cuda")
        t = step.to(torch.float32)
        scalars = (scale, lr_schedule(cfg, step), 1 - torch.pow(cfg.b1, t),
                   1 - torch.pow(cfg.b2, t))
        for i, (p, g, m, v) in enumerate(leaves):
            ref = [x.clone() for x in (p, m, v)]
            adamw_kernels.adamw_step(cfg, p, g, m, v, *scalars)
            adamw_kernels.adamw_step_ref(cfg, ref[0], g, ref[1], ref[2],
                                         *scalars)
            if not all(torch.equal(a, b) for a, b in zip((p, m, v), ref)):
                raise RuntimeError(f"adamw_step [{key} leaf {i} "
                                   f"{shapes[i]}]: not the plain version's "
                                   "bits")
            del ref

        def kernels():
            _, sc = adamw_kernels.adamw_sumsq(gs, cfg.clip_norm)
            for p, g, m, v in leaves:
                adamw_kernels.adamw_step(cfg, p, g, m, v, sc, *scalars[1:])

        def plain():
            norm = torch.sqrt(adamw_kernels.sumsq_ref(gs))  # global_norm
            sc = adamw_kernels.clip_scale_ref(norm, cfg.clip_norm)
            for p, g, m, v in leaves:
                adamw_kernels.adamw_step_ref(cfg, p, g, m, v, sc,
                                             *scalars[1:])

        ms = cuda_ms(kernels, 10, flush)
        alone = kernel_device_ms(kernels, r"adamw_", 5, flush)
        plain_ms = cuda_ms(plain, 3, flush)
        nbytes = 32 * n
        bms, by = bound_ms(0.0, nbytes)
        out[key] = {"ms": ms, "alone_ms": alone, "plain_ms": plain_ms,
                    "bound_ms": bms, "bound_by": by, "bytes": nbytes,
                    "params": n, "leaves": len(leaves),
                    "norm_rel_err": norm_rel}
        print(f"  adamw [{key}: {n / 1e9:.4f} B params, {len(leaves)} "
              f"leaves]: kernels {ms:.4f} ms (alone {alone:.4f}, "
              f"{100 * bms / alone:.1f}% of the bound), plain (torch) "
              f"{plain_ms:.4f} ms, bound {bms:.4f} ms ({by}; "
              f"{nbytes / 1e9:.2f} GB); every leaf bitwise the plain "
              f"version's; norm rel err {norm_rel:.2e}, two calls bitwise "
              "equal", flush=True)
        del leaves, gs, norm, again, scale, scalars
        torch.cuda.empty_cache()
    return {"name": "adamw", "route": "cuda",
            "source": "src/repro_torch/csrc/adamw.cu", "replaces": None,
            "launches": None, "max_abs_err": 0.0, **out["olmo_1b"],
            "deepseek_moe_16b": out["deepseek_moe_16b"]}


def check_smoke_shapes(gen):
    """Each kernel at the registry's smoke shapes, which its op zero-pads
    to the kernel's native sizes (flash hd 16 -> 64, fused_mlp K 64 ->
    128, ssd_scan P 16 -> 64), against its plain version: the serve
    launcher's prefill (4 x 16 tokens) and a smoke train step's forward
    (8 x 128). Each call must launch its kernel once. Returns {op: entry}
    with the worst error and the launches counted."""
    ocfg = get_config("olmo_1b", smoke=True)
    mcfg = get_config("mamba2_780m", smoke=True)
    h, hd = ocfg.n_heads, ocfg.hd
    k, f = ocfg.d_model, ocfg.d_ff
    hs, p, n, chunk = (mcfg.ssm_heads, mcfg.ssm_head_dim, mcfg.ssm_state,
                       mcfg.ssm_chunk)
    out = {}
    reset_launch_counts()
    for b, s in ((4, 16), (8, 128)):
        q, kk, v = (randn(gen, b, s, h, hd) for _ in range(3))
        err = compare(f"flash_attention [smoke B={b} S={s} H={h} hd={hd}, "
                      "padded to 64]", flash_attention(q, kk, v),
                      attention_ref(q, kk, v))
        out["flash_attention"] = max(out.get("flash_attention", 0.0), err)
        w1, w3 = (randn(gen, k, f, scale=k ** -0.5) for _ in range(2))
        w2 = randn(gen, f, k, scale=f ** -0.5)
        x = randn(gen, b * s, k)
        err = compare(f"fused_mlp [smoke M={b * s} K={k} F={f}, K padded to "
                      f"128, {regime(b * s)} kernels]",
                      fused_mlp(x, w1, w3, w2), fused_mlp_ref(x, w1, w3, w2))
        out["fused_mlp"] = max(out.get("fused_mlp", 0.0), err)
        args = ssd_inputs(gen, b, s, hs, mcfg.ssm_groups, n, p)
        y, state = ssd_scan(*args, chunk=chunk)
        want_y, want_state = from_pallas_layout(
            *ssd_ref(*to_pallas_layout(*args)), b)
        err = compare(f"ssd_scan y [smoke B={b} S={s} H={hs} P={p} N={n} "
                      f"chunk {chunk}, P padded to 64]", y, want_y,
                      SSD_ATOL, SSD_RTOL)
        compare(f"ssd_scan state [smoke B={b} S={s}]", state, want_state,
                SSD_ATOL, SSD_RTOL)
        out["ssd_scan"] = max(out.get("ssd_scan", 0.0), err)
    torch.cuda.synchronize()
    counts = launch_counts()
    print(f"  smoke-shape launches {counts} (2 calls of each op)", flush=True)
    if counts != {op: 2 if op in FWD_OPS else 0 for op in counts}:
        raise RuntimeError("a smoke-shape call did not launch its kernel")
    shapes = {"flash_attention": f"B=4 S=16 and B=8 S=128, H={h} hd={hd}",
              "fused_mlp": f"M=64 and M=1024, K={k} F={f}",
              "ssd_scan": f"B=4 S=16 and B=8 S=128, H={hs} P={p} N={n} "
                          f"chunk {chunk}"}
    return {op: {"max_abs_err": err, "launches": counts[op],
                 "shape": shapes[op] + ", padded inside the op"}
            for op, err in out.items()}


def _cuobjdump():
    """The toolkit's cuobjdump, else the copy Triton bundles, else None."""
    cand = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "cuobjdump")
    if os.path.exists(cand):
        return cand
    try:
        import triton
    except ImportError:
        return None
    cand = os.path.join(os.path.dirname(triton.__file__), "backends",
                        "nvidia", "bin", "cuobjdump")
    return cand if os.path.exists(cand) else None


def sass_census(names, ops=("HGMMA", "UTMALDG")):
    """Count wgmma (HGMMA) and TMA load (UTMALDG) instructions in each
    built library's SASS: a diagnostic of which Hopper paths were
    reached, not a check."""
    tool = _cuobjdump()
    if tool is None:
        print("  SASS census: not available (no cuobjdump)", flush=True)
        return
    for name in names:
        sass = subprocess.run([tool, "-sass", str(_build.library(name))],
                              capture_output=True, text=True).stdout
        counts = {op: sum(op in line for line in sass.splitlines())
                  for op in ops}
        print(f"  SASS census {name}: {counts}", flush=True)


def rel_rms(got, want):
    return float((got.float() - want.float()).norm() / want.float().norm())


FWD_OPS = ("flash_attention", "fused_mlp", "ssd_scan")   # with a smoke check
CHAIN_OPS = ("conv_silu", "gated_rmsnorm")   # forward-only: serving alone
BWD_OPS = ("flash_attention_bwd", "fused_mlp_bwd",   # the backward kernels
           "ssd_scan_bwd")


def launch_counts():
    return {"flash_attention": flash_attention.launches,
            "fused_mlp": fused_mlp.launches, "ssd_scan": ssd_scan.launches,
            "decode_attention": decode_attention.launches,
            "conv_silu": conv_silu.launches,
            "gated_rmsnorm": gated_rmsnorm.launches,
            "flash_attention_bwd": flash_attention.bwd_launches,
            "fused_mlp_bwd": fused_mlp.bwd_launches,
            "ssd_scan_bwd": ssd_scan.bwd_launches}


def reset_launch_counts():
    kernel_counters.reset()


def fused_mlps(cfg):
    """SwiGLU MLPs a token passes through (the fused MLP kernel's calls per
    step): one per dense (and vlm) layer, one per MoE layer with a shared
    expert (the routed experts are torch products), one per firing of the
    hybrid's shared block; none in a GELU model (whisper_base)."""
    if cfg.mlp != "swiglu":
        return 0
    if cfg.is_ssm_family:
        return cfg.n_layers // cfg.attn_every if cfg.family == "hybrid" else 0
    if cfg.family == "moe":
        return cfg.n_layers if cfg.n_shared_experts else 0
    return cfg.n_layers


def expected_launches(cfg, prefills: int, decode_steps: int):
    """Kernel launches for ``prefills`` prefills and ``decode_steps`` decode
    steps: flash once per attention block in prefill, fused_mlp once per
    SwiGLU MLP per step, ssd_scan and the Mamba-2 chain's two kernels
    (``CHAIN_OPS``) once per Mamba-2 layer in prefill, the
    decode kernel once per self-attention block (firing of the hybrid's
    shared block) per decode step, no backward kernel. The
    encoder-decoder's prefill runs its encoder once (enc_layers
    non-causal blocks) and each decoder layer's causal self-attention and
    non-causal cross-attention; its decode step runs the decode kernel
    for each decoder layer's self-attention (its cross-attention reads
    the cache in torch)."""
    L = cfg.n_layers
    if cfg.family == "audio":
        blocks, self_attn = cfg.enc_layers + 2 * L, L
    else:
        blocks = self_attn = L if not cfg.is_ssm_family else fused_mlps(cfg)
    ssm = L * prefills if cfg.is_ssm_family else 0
    return {"flash_attention": blocks * prefills,
            "fused_mlp": fused_mlps(cfg) * (prefills + decode_steps),
            "ssd_scan": ssm, "decode_attention": self_attn * decode_steps,
            **dict.fromkeys(CHAIN_OPS, ssm), **dict.fromkeys(BWD_OPS, 0)}


def expected_flash_regimes(cfg, prefills: int, prompt_len: int):
    """``flash_attention.launches_by_regime`` for ``prefills`` prefills of
    ``prompt_len`` tokens: the encoder-decoder's encoder blocks are
    non-causal with Sq == Skv, its cross-attention non-causal with Sq =
    prompt_len against Skv = enc_frames (Sq == Skv only where the two are
    equal, as the smoke config's 16 and the launcher's 16), its decoder's
    self-attention causal; every other model's blocks causal."""
    if cfg.family != "audio":
        n = expected_launches(cfg, prefills, 0)["flash_attention"]
        return dict(zip(REGIMES, (n, 0, 0)))
    want = dict(zip(REGIMES, (cfg.n_layers * prefills,
                              cfg.enc_layers * prefills, 0)))
    cross = REGIMES[1] if prompt_len == cfg.enc_frames else REGIMES[2]
    want[cross] += cfg.n_layers * prefills
    return want


def check_flash_regimes(arch, label, cfg, prefills: int, prompt_len: int):
    """The flash launches counted since the last reset, split by regime,
    against ``expected_flash_regimes``; returns them."""
    got = dict(flash_attention.launches_by_regime)
    want = expected_flash_regimes(cfg, prefills, prompt_len)
    if got != want:
        raise RuntimeError(f"{arch} {label}: flash launches by regime {got}, "
                           f"expected {want}")
    return got


def extra_input(cfg, batch: int):
    """The family's input beside the tokens, drawn from the seed (numpy
    fp32): encoder frames [B, enc_frames, D] for audio, image embeddings
    [B, img_tokens, D] for vlm; None for the others."""
    n = {"audio": cfg.enc_frames, "vlm": cfg.img_tokens}.get(cfg.family)
    if n is None:
        return None
    return np.random.RandomState(SEED + 1).randn(batch, n, cfg.d_model).astype(
        np.float32)


def _check_counts(arch, label, counts, want):
    if counts != want:
        raise RuntimeError(f"{arch} {label}: launch counts {counts}, expected "
                           f"{want}: the card path did not run the kernels")


def check_numerics(arch: str, n_layers: int, batch: int, seq: int):
    """``arch`` at full width and ``n_layers`` (decoder) layers: card bf16
    kernel path vs the port's plain path on the CPU in fp32, on the same
    weights: prefill logits (audio: with the encoder's frames) and one
    decode step, and for the vlm the forward with image embeddings
    prepended; each step's kernel launches checked. For the moe family,
    the share of (token, choice) routes that differ in each layer is
    printed, and the logits limit is the arch's own
    (``LOGITS_REL_RMS``)."""
    cfg = get_config(arch).with_(n_layers=n_layers)
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    cpu_params = tree_map(lambda _, t: t.cpu(), params)
    cpu_cfg = cfg.with_(compute_dtype="float32")
    card = tree_map(lambda p, t: t if keeps_fp32(p) else t.to(BF16), params)
    toks = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab, (batch, seq)).astype(np.int32))
    extra = extra_input(cfg, batch)
    frames = (torch.from_numpy(extra) if cfg.family == "audio" else None)
    with torch.inference_mode(), record_routes() as routes:
        want, cpu_cache = model_zoo.prefill(cpu_cfg, cpu_params, toks,
                                            seq + 16, frames=frames)
        reset_launch_counts()
        got, cache = model_zoo.prefill(
            cfg, card, toks.cuda(), seq + 16,
            frames=None if frames is None else frames.cuda())
        torch.cuda.synchronize()
        step_counts = [launch_counts()]
        regimes = check_flash_regimes(arch, "prefill", cfg, 1, seq)
        nxt = torch.argmax(want, dim=-1).to(torch.int32)
        want_d, _ = model_zoo.decode_step(cpu_cfg, cpu_params, cpu_cache, nxt)
        reset_launch_counts()
        got_d, _ = model_zoo.decode_step(cfg, card, cache, nxt.cuda())
        torch.cuda.synchronize()
        step_counts.append(launch_counts())
    for label, counts, want_counts in zip(
            ("prefill", "decode step"), step_counts,
            (expected_launches(cfg, 1, 0), expected_launches(cfg, 0, 1))):
        _check_counts(arch, label, counts, want_counts)
    print(f"  {arch} {n_layers} layers, batch {batch} x {seq}"
          + (f" + {cfg.enc_frames} frames" if frames is not None else "")
          + f": launches prefill {step_counts[0]} (flash by regime "
          f"{regimes}), decode step {step_counts[1]} (as expected)",
          flush=True)
    limit = LOGITS_REL_RMS.get(arch, NUMERICS_REL_RMS)
    if cfg.family == "moe":
        # routes in call order: CPU prefill, card prefill, CPU decode,
        # card decode; n_layers each
        run = [routes[i * n_layers:(i + 1) * n_layers] for i in range(4)]
        cal = CALIBRATED[arch]
        print(f"  {arch} routes that differ, card vs CPU, per layer: "
              f"prefill {route_flips(run[1], run[0])}, decode "
              f"{route_flips(run[3], run[2])} (CPU bf16 vs fp32: prefill "
              f"{cal[2]}, decode {cal[3]}); logits limit {limit} from the "
              f"calibrated rel RMS {cal[0]:.3e} / {cal[1]:.3e}, dense "
              f"limit {NUMERICS_REL_RMS}", flush=True)
    # the decoder-only LMs' padded logits are -1e9 on both sides and would
    # swamp the RMS: real vocab only; encdec masks none, so all of them
    v = cfg.padded_vocab if cfg.family == "audio" else cfg.vocab
    checks = [("prefill", got[:, :v], want[:, :v]),
              ("decode", got_d[:, :v], want_d[:, :v])]
    if cfg.family == "vlm":
        img = torch.from_numpy(extra)
        with torch.inference_mode():
            want_f, _ = model_zoo.forward(cpu_cfg, cpu_params, {
                "tokens": toks, "extra_embeds": img})
            reset_launch_counts()
            got_f, _ = model_zoo.forward(cfg, card, {
                "tokens": toks.cuda(), "extra_embeds": img.cuda()})
            torch.cuda.synchronize()
        _check_counts(arch, "forward", launch_counts(),
                      expected_launches(cfg, 1, 0))
        if got_f.shape != (batch, seq, cfg.padded_vocab):
            raise RuntimeError(f"{arch} forward logits {tuple(got_f.shape)}")
        print(f"  {arch} forward with {cfg.img_tokens} image embeddings + "
              f"{seq} tokens: launches {launch_counts()} (as expected), "
              f"logits {tuple(got_f.shape)}", flush=True)
        checks.append(("forward with image embeddings",
                       got_f[..., :v].reshape(-1, v),
                       want_f[..., :v].reshape(-1, v)))
    for label, g, w in checks:
        r = rel_rms(g.cpu(), w)
        ok = r <= limit and bool(torch.isfinite(g).all())
        print(f"  {arch} {n_layers} layers {label} logits {tuple(g.shape)}: "
              f"rel RMS {r:.3e} (limit {limit}), max abs "
              f"{float((g.cpu().float() - w).abs().max()):.3e}, argmax "
              f"agree {int((g.argmax(-1).cpu() == w.argmax(-1)).sum())}/"
              f"{g.shape[0]} -> {'ok' if ok else 'FAIL'}", flush=True)
        if not ok:
            raise RuntimeError(f"{arch} {label} logits disagree with the "
                               "fp32 path")
    del params, card


def decode_bytes(cfg, params, batch: int) -> float:
    """Bytes one decode step of ``batch`` rows must read at least.
    Decoder-only LMs: every weight but the embedding table (one row a
    token; an MoE's experts all run, each on at least min(k, B) slots).
    The encoder-decoder: the decoder's weights but its cross-attention
    wk/wv (their keys and values are cached), the unembedding, and the
    primed cross cache; the encoder and the position tables are not
    read."""
    if cfg.family != "audio":
        return sum(t.numel() * t.element_size() for p, t in _leaves(params)
                   if p != "embed")
    skip = ("decoder/cross_attn/wk", "decoder/cross_attn/wv")
    weights = sum(t.numel() * t.element_size() for p, t in _leaves(params)
                  if p.startswith("decoder/") and p not in skip
                  or p in ("unembed", "final_norm"))
    cross = 2 * cfg.n_layers * batch * cfg.enc_frames * cfg.n_kv_heads * cfg.hd
    return weights + cross * BF16.itemsize


def serve(arch: str, batch: int, prompt_len: int, new: int, n_layers=None):
    """Full-width ``arch`` Engine on the card, at full depth unless
    ``n_layers`` cuts it: ``batch`` prompts of ``prompt_len`` tokens (and,
    for the audio family, ``enc_frames`` frames each), ``new`` greedy new
    tokens. Returns the kernels' launch counts of that run."""
    cfg = get_config(arch)
    n_layers = n_layers or cfg.n_layers
    cfg = cfg.with_(param_dtype="bfloat16", n_layers=n_layers)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    scfg = ServeConfig(max_seq=prompt_len + new, max_new_tokens=new)
    eng = Engine(cfg, params, scfg=scfg, device="cuda")
    del params
    torch.cuda.synchronize()
    print(f"  {arch} {n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.params_count(eng.params) / 1e9:.3f} B params, "
          f"weights {torch.cuda.memory_allocated() / 2**30:.2f} GiB, set up "
          f"in {time.perf_counter() - t0:.1f} s", flush=True)
    prompts = np.random.RandomState(SEED).randint(
        0, cfg.vocab, (batch, prompt_len)).astype(np.int32)
    frames = extra_input(cfg, batch) if cfg.family == "audio" else None
    # warm-up on this engine: kernels built and, where it keeps one, its
    # decode graph captured before the timed call
    eng.generate(prompts, frames)

    reset_launch_counts()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = eng.generate(prompts, frames)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    launches = launch_counts()

    want = expected_launches(cfg, 1, new)
    if launches != want:
        raise RuntimeError(f"launch counts {launches}, expected {want}")
    regimes = check_flash_regimes(arch, "serve", cfg, 1, prompt_len)
    # encdec masks no padded-vocab column (as the reference): its greedy
    # ids may fall in [vocab, padded_vocab)
    top = cfg.padded_vocab if cfg.family == "audio" else cfg.vocab
    if out.shape != (batch, new) or not ((out >= 0) & (out < top)).all():
        raise RuntimeError(f"bad tokens: shape {out.shape}")
    batch_in = eng.batch(prompts, frames)
    with torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, _ = eng._prefill(eng.params, batch_in)
        torch.cuda.synchronize()
        t_prefill = time.perf_counter() - t0
    if not bool(torch.isfinite(logits).all()):
        raise RuntimeError("prefill logits are not finite")
    t_decode = total - t_prefill
    step_bytes = decode_bytes(cfg, eng.params, batch)
    print(f"  served {batch} x {prompt_len} prompt tokens"
          + (f" (+ {cfg.enc_frames} frames each)" if frames is not None
             else "")
          + f" + {new} new: total "
          f"{total:.3f} s; prefill {t_prefill:.4f} s "
          f"({batch * prompt_len / t_prefill:.1f} tok/s); decode "
          f"{t_decode:.4f} s ({batch * new / t_decode:.1f} tok/s, "
          f"{t_decode / new * 1e3:.2f} ms/step; bound "
          f"{step_bytes / PEAK_BYTES * 1e3:.2f} ms/step: "
          f"{step_bytes / 1e9:.2f} GB at 3.35 TB/s); peak memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB", flush=True)
    print(f"  launches {launches} (expected {want}: per prefill "
          f"{expected_launches(cfg, 1, 0)}, per decode step "
          f"{expected_launches(cfg, 0, 1)}); flash by regime {regimes}",
          flush=True)
    print(f"  first tokens: {out[:, :8].tolist()}", flush=True)
    if cfg.family == "audio":
        print(f"  greedy ids in the padded vocab [{cfg.vocab}, "
              f"{cfg.padded_vocab}): {int((out >= cfg.vocab).sum())} of "
              f"{out.size}", flush=True)
    profile(eng, batch_in)
    del eng, logits, batch_in
    return launches, regimes


# kernel name prefix in csrc/ -> the op whose wrapper launches it (a
# "_bwd_" kernel: that op's backward; the SSD backward's re-run of the
# forward's chunk-state and state-passing kernels counts as ssd_scan; a
# "mamba2_" kernel is named after its op)
PORT_OPS = {"ssd": "ssd_scan", "mlp": "fused_mlp", "flash": "flash_attention",
            "decode": "decode_attention"}
# the kernel an op launches once per call in a decode step: its calls on
# the device trace (fused_mlp's gate/up kernel, decode or prefill regime;
# the decode kernel's first launch, not the combine of its splits)
CALL_KERNELS = {"fused_mlp": r"::mlp_(?:decode|prefill)<true\b",
                "decode_attention": r"::decode_attn_kernel<"}


def report(prof, label, wall, top=8):
    """Print a profiler window: wall and device busy/idle, the ``top``
    device ops by self time, and the port's kernels by op. Returns the
    window's device events."""
    from torch.autograd import DeviceType
    averages = prof.key_averages()
    evts = [e for e in averages  # kernels, memsets, copies
            if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in evts) / 1e3
    print(f"  profile {label}: wall {wall:.2f} ms, device busy "
          f"{busy:.2f} ms ({100 * busy / wall:.1f}%), idle "
          f"{100 * (1 - busy / wall):.1f}%", flush=True)
    for e in sorted(evts, key=lambda e: -e.self_device_time_total)[:top]:
        print(f"    {e.self_device_time_total / 1e3:9.3f} ms "
              f"{100 * e.self_device_time_total / 1e3 / busy:5.1f}% "
              f"x{e.count:<5d} {e.key[:90]}", flush=True)
    ops = {}                    # the port's kernels, by op
    for e in evts:
        m = re.search(r"::(ssd|mlp|flash|decode|mamba2)_(bwd_|conv_silu|"
                      r"gated_rmsnorm)?", e.key)
        if m:
            op = (m.group(2) if m.group(1) == "mamba2" else
                  PORT_OPS[m.group(1)] + ("_bwd" if m.group(2) else ""))
            ms, n = ops.get(op, (0.0, 0))
            ops[op] = (ms + e.self_device_time_total / 1e3, n + e.count)
    print("    port kernels: " + (", ".join(
        f"{op} {ms:.3f} ms ({100 * ms / busy:.1f}%, {n} launches)"
        for op, (ms, n) in sorted(ops.items())) or "none"), flush=True)
    # the Functions' backwards (the backward kernels): device time of
    # every kernel launched under each autograd node
    bwd = [e for e in averages if e.key.startswith(
        "autograd::engine::evaluate_function: ") and e.key.endswith(
        ("FlashAttentionBackward", "FusedMLPBackward", "SSDScanBackward"))]
    if bwd:
        print("    Function backwards: " + ", ".join(
            f"{e.key.rsplit(' ', 1)[-1]} {e.device_time_total / 1e3:.3f} ms "
            f"({100 * e.device_time_total / 1e3 / busy:.1f}%, x{e.count})"
            for e in bwd), flush=True)
    return evts


def profile(eng, batch):
    """Where the device time goes: torch.profiler over one prefill of the
    prefill ``batch`` and over 3 decode steps of the served model (run
    after the counted main path, on the cache the engine keeps for the
    batch; replays of its decode graph where it has one). The decode
    steps' calls of the fused MLP and the
    decode kernel on the device trace (``CALL_KERNELS``) must be
    ``expected_launches``': a replay is counted where it ran, on the card.
    Device activity only: ``report`` reads nothing of the host's ops here,
    and recording them costs seconds of processing a window."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    with torch.inference_mode():
        cache = eng._caches[(batch["tokens"].shape[0], eng.scfg.max_seq)]
        logits, cache = eng._prefill(eng.params, batch, cache=cache)
        tok = torch.argmax(logits, -1).to(torch.int32)
        for label, steps in (("prefill", None), ("decode x3", 3)):
            torch.cuda.synchronize()
            with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                if steps is None:
                    eng._prefill(eng.params, batch, cache=cache)
                else:
                    for _ in range(steps):
                        logits, cache = eng._decode(eng.params, cache, tok)
                torch.cuda.synchronize()
                wall = (time.perf_counter() - t0) * 1e3
            evts = report(prof, label, wall)
    # evts and steps are the last window's: the decode steps
    want = {op: n for op, n in expected_launches(eng.cfg, 0, steps).items()
            if op in CALL_KERNELS}
    got = {op: sum(e.count for e in evts if re.search(pat, e.key))
           for op, pat in CALL_KERNELS.items()}
    if got != want:
        raise RuntimeError(f"{eng.cfg.arch_id}: {steps} decode steps ran "
                           f"{got} calls on the device trace, expected "
                           f"{want}")
    print(f"    decode steps' calls on the device trace {got}, as expected",
          flush=True)


# ---------------------------------------------------------------------------
# train
# ---------------------------------------------------------------------------

def compare_grads(name, got, want):
    """Each gradient scaled by the largest magnitude of its plain
    counterpart, held to GRAD_ATOL/GRAD_RTOL; returns the worst scaled
    error."""
    worst = 0.0
    for label, g, w in zip(("dx", "dW1", "dW3", "dW2") if len(got) == 4
                           else ("dq", "dk", "dv"), got, want):
        top = float(w.float().abs().max())
        worst = max(worst, compare(f"{name} {label} (scaled by max "
                                   f"{top:.3e})", g.float() / top,
                                   w.float() / top, GRAD_ATOL, GRAD_RTOL))
    return worst


def backward_ms(out, inputs, dy, flush, reps=5):
    """Device time of one backward through ``out``'s graph (kept)."""
    return cuda_ms(lambda: torch.autograd.grad(out, inputs, dy,
                                               retain_graph=True), reps,
                   flush)


def flash_bwd_launch_ms(y, inputs, dy, reps=5,
                        pattern=r"flash_bwd_([a-z]+)"):
    """Device time of each launch of the flash backward (csrc/
    flash_attn_bwd.cu: delta, main, convert) per backward call through
    ``y``'s graph, by torch.profiler over ``reps`` calls: the launches
    alone, without the host's work before them that an event timing of
    the call includes. Returns {launch: ms}; with ``pattern`` ".*" the
    device time of every kernel of the call, under one key."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.autograd.grad(y, inputs, dy, retain_graph=True)
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            torch.autograd.grad(y, inputs, dy, retain_graph=True)
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(pattern, e.key)
        if m:
            key = m.group(1) if m.groups() else "all"
            out[key] = (out.get(key, 0.0)
                        + e.self_device_time_total / 1e3 / reps)
    return out


def flash_train_case(gen, flush, b, sq, skv, h, kv, hd, causal,
                     timed=True):
    """FlashAttention (kernel forward, kernel backward) against the plain
    version at one shape: the forward, the gradients (autograd of the
    plain version), two backward calls bit-identical, and, when
    ``timed``, the backward kernels' time beside the explicit-torch
    backward's (``attention_bwd``, the kernels' plain version), plain
    autograd's, SDPA's backward and its bound. Returns the entry."""
    mask = "causal" if causal else "non-causal"
    sizes = f"S={sq}" if sq == skv else f"Sq={sq} Skv={skv}"
    label = f"B={b} {sizes} H={h} KV={kv} hd={hd} {mask}"
    q = randn(gen, b, sq, h, hd).requires_grad_()
    kk, v = (randn(gen, b, skv, kv, hd).requires_grad_() for _ in range(2))
    do = randn(gen, b, sq, h, hd)
    y = FlashAttention.apply(q, kk, v, causal)
    y_ref = attention_ref(q, kk, v, causal)
    torch.cuda.synchronize()
    fwd_err = compare(f"FlashAttention forward [{label}]", y, y_ref)
    got = torch.autograd.grad(y, (q, kk, v), do, retain_graph=True)
    again = torch.autograd.grad(y, (q, kk, v), do, retain_graph=True)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    print(f"  FlashAttention backward kernels [{label}]: two calls "
          f"bit-identical: {same}", flush=True)
    if not same:
        raise RuntimeError("the flash backward kernels are not "
                           "deterministic")
    want = torch.autograd.grad(y_ref, (q, kk, v), do, retain_graph=True)
    torch.cuda.synchronize()
    err = compare_grads(f"FlashAttention grads [{label}]", got, want)
    entry = {"max_abs_err": fwd_err, "grad_max_err": err,
             "shape": label + " bf16"}
    del got, again, want
    if not timed:
        del y, y_ref, q, kk, v, do
        torch.cuda.empty_cache()
        return entry
    ms = backward_ms(y, (q, kk, v), do, flush)
    launch_ms = flash_bwd_launch_ms(y, (q, kk, v), do)
    qd, kd, vd = (t.detach() for t in (q, kk, v))
    torch_ms = cuda_ms(lambda: attention_bwd(qd, kd, vd, do, causal), 3,
                       flush)
    plain = backward_ms(y_ref, (q, kk, v), do, flush, reps=2)
    del y_ref
    qt, kt, vt = (t.transpose(1, 2) for t in (q, kk, v))
    y_lib = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal,
                                           enable_gqa=True)
    lib = backward_ms(y_lib, (q, kk, v), do.transpose(1, 2), flush)
    lib_launch_ms = sum(flash_bwd_launch_ms(
        y_lib, (q, kk, v), do.transpose(1, 2), pattern=".*").values())
    # five products over the (query, key) pairs the mask keeps (S, dV, dP,
    # dQ, dK; the row sums rowsum(dO o O) = rowsum(P o dP) need no sixth);
    # q, dO and dq, k, v and dk, dv read or written once, bf16
    pairs = (sum(min(skv, i + (skv - sq) + 1) for i in range(sq)) if causal
             else sq * skv)
    bms, by = bound_ms(10.0 * b * h * hd * pairs,
                       2.0 * b * hd * (3 * sq * h + 4 * skv * kv))
    print(f"  FlashAttention backward [{label}]: kernels {ms:.4f} ms "
          f"(launches alone {sum(launch_ms.values()):.4f}: " + ", ".join(
              f"{n} {t:.4f}" for n, t in launch_ms.items()) + "), "
          f"explicit torch (attention_bwd: bf16 cuBLAS products, "
          f"materialised fp32 softmax) {torch_ms:.4f} ms, plain autograd "
          f"{plain:.4f} ms, SDPA backward {lib:.4f} ms (launches alone "
          f"{lib_launch_ms:.4f}), bound {bms:.4f} ms ({by})", flush=True)
    del y, y_lib, q, kk, v, do, qt, kt, vt, qd, kd, vd
    torch.cuda.empty_cache()
    return {**entry, "backward_ms": ms,
            "backward_launches_ms": sum(launch_ms.values()),
            "backward_launch_ms": launch_ms, "torch_backward_ms": torch_ms,
            "plain_backward_ms": plain, "library_backward_ms": lib,
            "library_backward_launches_ms": lib_launch_ms,
            "backward_bound_ms": bms, "backward_bound_by": by}


def mlp_train_case(gen, flush, m, k, f, timed=True):
    """FusedMLP (kernel forward keeping g and u, backward kernels) against
    the plain version at x [M, K], W1/W3 [K, F], W2 [F, K]: the forward,
    the gradients (autograd of the plain version), two backward calls
    bit-identical, and, when ``timed``, the backward kernels' time beside
    the explicit-torch backward's (``fused_mlp_bwd``, the kernels' plain
    version), plain autograd's, the cuBLAS chain's autograd and its bound.
    Returns the entry."""
    label = f"M={m} K={k} F={f}"
    x = randn(gen, m, k).requires_grad_()
    w1, w3 = (randn(gen, k, f, scale=k ** -0.5).requires_grad_()
              for _ in range(2))
    w2 = randn(gen, f, k, scale=f ** -0.5).requires_grad_()
    dy = randn(gen, m, k)
    args = (x, w1, w3, w2)
    y = FusedMLP.apply(*args)
    y_ref = fused_mlp_ref(*args)
    torch.cuda.synchronize()
    fwd_err = compare(f"FusedMLP forward [{label}, prefill kernels keeping "
                      "g and u]", y, y_ref)
    got = torch.autograd.grad(y, args, dy, retain_graph=True)
    again = torch.autograd.grad(y, args, dy, retain_graph=True)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    print(f"  FusedMLP backward kernels [{label}]: two calls bit-identical: "
          f"{same}", flush=True)
    if not same:
        raise RuntimeError("the fused MLP backward kernels are not "
                           "deterministic")
    want = torch.autograd.grad(y_ref, args, dy, retain_graph=True)
    torch.cuda.synchronize()
    err = compare_grads(f"FusedMLP grads [{label}]", got, want)
    entry = {"max_abs_err": fwd_err, "grad_max_err": err,
             "shape": label + " bf16"}
    del got, again, want
    if not timed:
        del y, y_ref, args, x, w1, w3, w2, dy
        torch.cuda.empty_cache()
        return entry
    ms = backward_ms(y, args, dy, flush)
    launch_ms = flash_bwd_launch_ms(y, args, dy, pattern=r"(mlp_bwd_\w+)")
    split = [p.name for p in fused_mlp_bwd_plan(
        m, *padded_mlp_dims(k, f), torch.cuda.get_device_properties(
            0).multi_processor_count) if p.stream_k]
    xd, w1d, w3d, w2d = (t.detach() for t in args)
    torch_ms = cuda_ms(lambda: fused_mlp_bwd(xd, w1d, w3d, w2d, dy), 3,
                       flush)
    plain = backward_ms(y_ref, args, dy, flush, reps=2)
    del y_ref
    y_lib = (F.silu(x @ w1) * (x @ w3)) @ w2
    lib = backward_ms(y_lib, args, dy, flush)
    # six products of 2 M K F (dh, dx's two, dW1, dW3, dW2; g and u are
    # the forward's, not recomputed); x, W1, W3, W2, dy read and dx, dW1,
    # dW3, dW2 written once
    bms, by = bound_ms(12.0 * m * k * f, 2.0 * (3 * m * k + 6 * k * f))
    print(f"  FusedMLP backward [{label}]: kernels {ms:.4f} ms (launches "
          f"alone {sum(launch_ms.values()):.4f}: " + ", ".join(
              f"{n} {t:.4f}" for n, t in launch_ms.items())
          + f"; stream-K: {', '.join(split) or 'none'}), explicit "
          f"torch (fused_mlp_bwd: bf16 cuBLAS products, g and u recomputed) "
          f"{torch_ms:.4f} ms, plain autograd {plain:.4f} ms, cuBLAS-chain "
          f"autograd {lib:.4f} ms, bound {bms:.4f} ms ({by})", flush=True)
    del y, y_lib, args, x, w1, w3, w2, dy, xd, w1d, w3d, w2d
    torch.cuda.empty_cache()
    return {**entry, "backward_ms": ms,
            "backward_launches_ms": sum(launch_ms.values()),
            "backward_launch_ms": launch_ms, "stream_k": split,
            "torch_backward_ms": torch_ms,
            "plain_backward_ms": plain, "library_backward_ms": lib,
            "backward_bound_ms": bms, "backward_bound_by": by}


def check_train_kernels(gen, flush):
    """Each kernel's autograd Function against its plain version at
    olmo_1b's train shapes (4 x 2048 tokens): flash B=4 S=2048 H=16 hd=128
    causal, fused_mlp M=8192 K=2048 F=8192; FlashAttention also at
    granite_moe_1b_a400m's (B=4 S=2048 H=16 KV=8 hd=64 causal), in
    whisper_base's three training regimes at B=4 (1500 frames, 448
    decoder tokens, H=8 hd=64: the encoder's non-causal Sq = Skv = 1500,
    the decoder's causal 448 and its non-causal cross-attention 448 x
    1500), and both at llava_next_34b's train step (1 x (576 + 64) rows:
    flash H=56 KV=8 hd=128 causal, fused_mlp K 7168 F 20480); the forward
    (the kernel) and the gradients (autograd of the
    plain version); the flash backward kernels also at head dims 80 and 96
    (stablelm_3b, phi3_mini_3_8b; 1 x 512) and at olmo_1b_smoke's hd 16,
    which the ops pad to 64 (8 x 128), and the fused MLP's at its K 64,
    F 128 (K padded to 128). Returns {op: entry} with the
    forward's error and the backward's times (the kernels or the
    Function's backward, the explicit-torch backward, plain autograd,
    library)."""
    cfg = get_config("olmo_1b")
    b, s, h, hd = 4, 2048, cfg.n_heads, cfg.hd
    k, f, m = cfg.d_model, cfg.d_ff, 4 * 2048
    out = {"flash_attention": flash_train_case(gen, flush, b, s, s, h, h,
                                               hd, True)}
    gm = get_config("granite_moe_1b_a400m")
    out["flash_attention"]["granite_moe"] = flash_train_case(
        gen, flush, b, s, s, gm.n_heads, gm.n_kv_heads, gm.hd, True)
    wh = get_config("whisper_base")
    frames, toks = wh.enc_frames, WHISPER_TRAIN_TOKENS
    out["flash_attention"]["whisper"] = {
        regime: flash_train_case(gen, flush, 4, sq, skv, wh.n_heads,
                                 wh.n_kv_heads, wh.hd, causal)
        for regime, (sq, skv, causal) in zip(REGIMES, (
            (toks, toks, True), (frames, frames, False),
            (toks, frames, False)))}

    out["fused_mlp"] = mlp_train_case(gen, flush, m, k, f)
    ll = get_config("llava_next_34b")
    rows = LLAVA_TRAIN_TOKENS + ll.img_tokens
    out["flash_attention"]["llava"] = flash_train_case(
        gen, flush, 1, rows, rows, ll.n_heads, ll.n_kv_heads, ll.hd, True)
    more = {}
    for arch, smoke, b_, s_ in (("stablelm_3b", False, 1, 512),
                                ("phi3_mini_3_8b", False, 1, 512),
                                ("olmo_1b", True, 8, 128)):
        c = get_config(arch, smoke=smoke)
        more[arch + ("_smoke" if smoke else "")] = flash_train_case(
            gen, flush, b_, s_, s_, c.n_heads, c.n_kv_heads, c.hd, True,
            timed=False)
    out["flash_attention"]["head_dims"] = more
    out["fused_mlp"]["llava"] = mlp_train_case(gen, flush, rows, ll.d_model,
                                               ll.d_ff)
    sm = get_config("olmo_1b", smoke=True)
    out["fused_mlp"]["smoke"] = mlp_train_case(gen, flush, 8 * 128,
                                               sm.d_model, sm.d_ff,
                                               timed=False)
    out["ssd_scan"] = check_ssd_train(gen, flush)
    return out


def ssd_grad_errors(label, args, dy, chunk, y):
    """SSDScan's gradients through ``y`` (its output on ``args``) against
    autograd of the chunked form ``ssd_chunked`` in fp32 on the card, each
    scaled by its largest magnitude (dx, dB, dC within SSD_GRAD_BF16, ddt
    and dA within SSD_GRAD_FP32), all finite, and two backward calls
    bit-identical. Returns ({gradient: error}, autograd's output)."""
    got = torch.autograd.grad(y, args, dy, retain_graph=True)
    again = torch.autograd.grad(y, args, dy, retain_graph=True)
    same = all(torch.equal(g, a) for g, a in zip(got, again))
    print(f"  SSDScan backward kernels [{label}]: two calls bit-identical: "
          f"{same}", flush=True)
    if not same:
        raise RuntimeError("the SSD backward kernels are not deterministic")
    del again
    y_chain, _ = ssd_chunked(*args, chunk)
    want = torch.autograd.grad(y_chain, args, dy, retain_graph=True)
    torch.cuda.synchronize()
    errs = {}
    for name, gt, w in zip(("dx", "ddt", "dA", "dB", "dC"), got, want):
        if not bool(torch.isfinite(gt).all()):
            raise RuntimeError(f"SSDScan {name} is not finite")
        top = float(w.float().abs().max())
        limit = SSD_GRAD_BF16 if gt.dtype == BF16 else SSD_GRAD_FP32
        errs[name] = compare(f"SSDScan {name} {str(gt.dtype)[6:]} (scaled "
                             f"by max {top:.3e}) [{label}]",
                             gt.float() / top, w.float() / top, limit, 0.0)
    return errs, y_chain


def ssd_bwd_bound(b, s, h, g, n, p, chunk):
    """(FLOPs, bytes, bound ms, bound by) of the SSD backward, from the
    least work ``ssd_scan.ops.bwd_work`` counts (C B^T and the intra-chunk
    dB, dC products once per group, dM and M^T dy per head, over the causal
    triangle; four L x N x P state terms per head; inputs and gradients
    once)."""
    flops, nbytes = ssd_bwd_work(b, s, h, g, n, p, chunk)
    return (flops, nbytes, *bound_ms(flops, nbytes))


def check_ssd_train(gen, flush):
    """SSDScan at mamba2_780m's train shape (B=4 S=2048 H=48 P=64 N=128,
    chunk 256): its forward (the kernel) against the plain version, its
    gradients (the backward kernels; the final state unused, as in
    training) against autograd of the chunked form ``ssd_chunked`` in fp32
    on the card (``ssd_grad_errors``); the backward kernels' time (CUDA
    events, and each launch's device time alone, by torch.profiler)
    against the explicit-torch backward's (``ssd_scan_bwd``, their plain
    version), that autograd's and plain autograd's; the same gradients
    and times at zamba2_1_2b's train shape (B=4 S=2048 H=64 N=64); and the
    gradients at mamba2_780m_smoke's P 16, N 16 (8 x 128), which the op
    pads to 64."""
    cfg = get_config("mamba2_780m")
    b, s, h, p = 4, 2048, cfg.ssm_heads, cfg.ssm_head_dim
    g, n, chunk = cfg.ssm_groups, cfg.ssm_state, cfg.ssm_chunk
    label = f"B={b} S={s} H={h} P={p} N={n} G={g} chunk {chunk}"
    args = [t.requires_grad_() for t in ssd_inputs(gen, b, s, h, g, n, p)]
    dy = randn(gen, b, s, h, p)
    y, _ = SSDScan.apply(*args, chunk)
    y_ref, _ = from_pallas_layout(*ssd_ref(*to_pallas_layout(*args)), b)
    torch.cuda.synchronize()
    fwd_err = compare(f"SSDScan forward [{label}]", y, y_ref, SSD_ATOL,
                      SSD_RTOL)
    errs, y_chain = ssd_grad_errors(label, args, dy, chunk, y)
    ms = backward_ms(y, args, dy, flush)
    launch_ms = flash_bwd_launch_ms(y, args, dy, pattern=r"\b(ssd_\w+)")
    detached = [t.detach() for t in args]
    torch_ms = cuda_ms(lambda: ssd_scan_bwd(*detached, dy, None, chunk), 2,
                       flush)
    lib = backward_ms(y_chain, args, dy, flush)
    del y_chain
    plain = backward_ms(y_ref, args, dy, flush, reps=2)
    del y_ref
    flops, nbytes, bms, by = ssd_bwd_bound(b, s, h, g, n, p, chunk)
    print(f"  SSDScan backward: kernels {ms:.4f} ms (launches alone "
          f"{sum(launch_ms.values()):.4f}: " + ", ".join(
              f"{k} {t:.4f}" for k, t in launch_ms.items()) + "), explicit "
          f"torch (ssd_scan_bwd: fp32 cuBLAS products) {torch_ms:.4f} ms, "
          f"autograd of ssd_chunked {lib:.4f} ms, plain autograd "
          f"(sequential ssd_ref) {plain:.4f} ms, bound {bms:.4f} ms ({by}; "
          f"{flops / 1e9:.2f} GFLOP at the bf16 rate, "
          f"{flops / PEAK_FP32_FLOPS * 1e3:.4f} ms at the fp32 rate; "
          f"{nbytes / 1e6:.2f} MB)", flush=True)
    del y, args, dy, detached
    torch.cuda.empty_cache()
    zc = get_config("zamba2_1_2b")
    zh, zg, zn, zp, zk = (zc.ssm_heads, zc.ssm_groups, zc.ssm_state,
                          zc.ssm_head_dim, zc.ssm_chunk)
    zlabel = f"zamba2_1_2b B={b} S={s} H={zh} P={zp} N={zn} G={zg} chunk {zk}"
    zargs = [t.requires_grad_() for t in ssd_inputs(gen, b, s, zh, zg, zn,
                                                    zp)]
    zdy = randn(gen, b, s, zh, zp)
    zy, _ = SSDScan.apply(*zargs, zk)
    zerrs, _ = ssd_grad_errors(zlabel, zargs, zdy, zk, zy)
    zms = backward_ms(zy, zargs, zdy, flush)
    zlaunch = flash_bwd_launch_ms(zy, zargs, zdy, pattern=r"\b(ssd_\w+)")
    zdet = [t.detach() for t in zargs]
    ztorch = cuda_ms(lambda: ssd_scan_bwd(*zdet, zdy, None, zk), 2, flush)
    _, _, zbms, zby = ssd_bwd_bound(b, s, zh, zg, zn, zp, zk)
    print(f"  SSDScan backward [{zlabel}]: kernels {zms:.4f} ms (launches "
          f"alone {sum(zlaunch.values()):.4f}: " + ", ".join(
              f"{k} {t:.4f}" for k, t in zlaunch.items()) + "), explicit "
          f"torch {ztorch:.4f} ms, bound {zbms:.4f} ms ({zby})", flush=True)
    zamba = {"grad_max_err": zerrs, "backward_ms": zms,
             "backward_launches_ms": sum(zlaunch.values()),
             "backward_launch_ms": zlaunch, "torch_backward_ms": ztorch,
             "backward_bound_ms": zbms, "backward_bound_by": zby,
             "shape": zlabel}
    del zy, zargs, zdy, zdet
    sm = get_config("mamba2_780m", smoke=True)
    slabel = (f"smoke B=8 S=128 H={sm.ssm_heads} P={sm.ssm_head_dim} "
              f"N={sm.ssm_state} chunk {sm.ssm_chunk}, P padded to 64")
    sargs = [t.requires_grad_() for t in ssd_inputs(
        gen, 8, 128, sm.ssm_heads, sm.ssm_groups, sm.ssm_state,
        sm.ssm_head_dim)]
    sdy = randn(gen, 8, 128, sm.ssm_heads, sm.ssm_head_dim)
    smoke_errs, _ = ssd_grad_errors(
        slabel, sargs, sdy, sm.ssm_chunk, SSDScan.apply(*sargs,
                                                        sm.ssm_chunk)[0])
    del sargs, sdy
    torch.cuda.empty_cache()
    return {"max_abs_err": fwd_err, "grad_max_err": errs, "backward_ms": ms,
            "backward_launches_ms": sum(launch_ms.values()),
            "backward_launch_ms": launch_ms, "zamba2": zamba,
            "torch_backward_ms": torch_ms, "plain_backward_ms": plain,
            "library_backward_ms": lib,
            "library_backward": "autograd of the torch chain ssd_chunked",
            "backward_bound_ms": bms, "backward_bound_by": by,
            "smoke": {"grad_max_err": smoke_errs, "shape": slabel},
            "shape": label + ", bf16 x/B/C, fp32 dt/A"}


def expected_train_launches(cfg, steps: int):
    """Kernel launches of ``steps`` train steps under remat "full": each
    attention block, SwiGLU MLP (an MoE layer's shared expert) and
    Mamba-2 layer runs its kernel in the forward and again in the
    backward's recompute (the hybrid's shared block once per firing);
    each attention block (firing), SwiGLU MLP and Mamba-2 layer runs its
    backward kernel once. The Mamba-2 chain's kernels never run in a
    train step: it records a gradient, so the chain is torch's."""
    per_step = expected_launches(cfg, 1, 0)
    want = {op: 0 if op in CHAIN_OPS else 2 * n * steps
            for op, n in per_step.items()}
    for op in ("flash_attention", "fused_mlp", "ssd_scan"):
        want[op + "_bwd"] = per_step[op] * steps
    return want


def dead_leaves(grads, grads32):
    """Gradient leaves (per layer for stacked ones) that are zero on the
    card where the CPU fp32 step's are not."""
    dead = []

    def one(path, w):
        g = tree_get(grads, path)
        stacked = path.split("/")[0] in ("layers", "encoder", "decoder")
        parts = ([(f"{path}[{i}]", g[i], w[i]) for i in range(w.shape[0])]
                 if stacked else [(path, g, w)])
        dead.extend(name for name, gi, wi in parts
                    if bool(wi.abs().sum() > 0) and not bool(
                        gi.abs().sum() > 0))
    tree_map(one, grads32)
    return dead


def check_train_numerics(arch, n_layers, batch, seq):
    """``arch`` at full width and ``n_layers`` layers: one train step's
    loss, gradient norm and every gradient leaf, card bf16 through the
    kernels vs the port's CPU fp32 path from the same weights and batch;
    every leaf is finite on the card, and non-zero wherever the CPU
    step's is."""
    cfg = get_config(arch).with_(n_layers=n_layers)
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    toks = np.random.RandomState(SEED).randint(
        0, cfg.vocab, (batch, seq + 1)).astype(np.int32)
    host = {"tokens": torch.from_numpy(toks[:, :-1].copy()),
            "labels": torch.from_numpy(toks[:, 1:].copy())}
    extra = extra_input(cfg, batch)   # the calibration script's draw
    if extra is not None:
        host["frames" if cfg.family == "audio" else "extra_embeds"] = (
            torch.from_numpy(extra))
    reset_launch_counts()
    dev = {k: v.cuda() for k, v in host.items()}
    loss, metrics, grads = value_and_grad(cfg, params, dev)
    torch.cuda.synchronize()
    counts = launch_counts()
    if counts != expected_train_launches(cfg, 1):
        raise RuntimeError(f"train step launches {counts}, expected "
                           f"{expected_train_launches(cfg, 1)}")
    if cfg.family == "moe":
        # the dispatch's backward is a gather (no atomics): the step is
        # bitwise deterministic
        again = value_and_grad(cfg, params, dev)
        same = torch.equal(again[0], loss) and _bitwise(again[2], grads)
        print(f"  {arch}: two card steps bitwise equal (loss and every "
              f"gradient): {same}", flush=True)
        if not same:
            raise RuntimeError(f"{arch} train step is not deterministic")
        del again
    t0 = time.perf_counter()
    cpu_params = tree_map(lambda _, t: t.cpu(), params)
    loss32, metrics32, grads32 = value_and_grad(
        cfg.with_(compute_dtype="float32"), cpu_params, host)
    cpu_s = time.perf_counter() - t0
    gn, gn32 = float(global_norm(grads)), float(global_norm(grads32))
    rel = leaf_rel_rms(grads, grads32)
    worst = max(rel, key=rel.get)
    loss_rel = abs(float(loss) - float(loss32)) / abs(float(loss32))
    gn_rel = abs(gn - gn32) / gn32
    lim_loss, lim_gn, lim_leaf = TRAIN_LIMITS[arch]
    rows = f"{batch} x {seq} tokens" + (
        "" if extra is None else f" + {extra.shape[1]} "
        f"{'frames' if cfg.family == 'audio' else 'image embeddings'}")
    print(f"  {arch} {n_layers} layers, {rows}: launches {counts} (as "
          f"expected); CPU fp32 step {cpu_s:.1f} s", flush=True)
    print(f"  loss card {float(loss):.6f} cpu {float(loss32):.6f} rel "
          f"{loss_rel:.3e} (limit {lim_loss}); grad_norm card "
          f"{gn:.6f} cpu {gn32:.6f} rel {gn_rel:.3e} (limit {lim_gn})",
          flush=True)
    for path, r in sorted(rel.items(), key=lambda kv: kv[1]):
        print(f"    {path}: rel RMS {r:.3e}", flush=True)
    print(f"  worst leaf {worst}: rel RMS {rel[worst]:.3e} (limit "
          f"{lim_leaf})", flush=True)
    aux_rel = 0.0
    if cfg.family == "moe":
        aux, aux32 = float(metrics["aux"]), float(metrics32["aux"])
        aux_rel = abs(aux - aux32) / abs(aux32)
        print(f"  aux card {aux:.6f} cpu {aux32:.6f} rel {aux_rel:.3e} "
              f"(limit {TRAIN_AUX_REL})", flush=True)
    dead = dead_leaves(grads, grads32)
    nonfinite = []
    tree_map(lambda path, g: None if bool(torch.isfinite(g).all())
             else nonfinite.append(path), grads)
    print(f"  leaves zero on the card but not on the CPU: {dead or 'none'}; "
          f"not finite: {nonfinite or 'none'}", flush=True)
    if (dead or nonfinite or not np.isfinite(float(loss))
            or loss_rel > lim_loss or gn_rel > lim_gn
            or rel[worst] > lim_leaf or aux_rel > TRAIN_AUX_REL):
        raise RuntimeError(f"{arch} train step on the card disagrees with "
                           "the fp32 CPU path")
    del params, grads, cpu_params, grads32
    return {"loss_rel": loss_rel, "grad_norm_rel": gn_rel,
            "worst_leaf": worst, "worst_leaf_rel_rms": rel[worst]}


def _timed(fn):
    """(device-inclusive ms, result) of ``fn()``, by CUDA events on the
    stream around it."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end), out


def _step_split(cfg, opt_cfg, params, opt, batch):
    """ms of one train step's parts, each the port's own function timed
    by ``_timed``: the forward (``model_zoo.loss_fn`` without grad), the
    backward (``launch.steps.value_and_grad`` less that forward; under
    remat "full" it includes the recompute) and the optimizer
    (``adamw_update``, which updates ``params`` and ``opt`` in place)."""
    with torch.no_grad():
        fwd, _ = _timed(lambda: model_zoo.loss_fn(cfg, params, batch))
    fwd_bwd, (_, _, grads) = _timed(lambda: value_and_grad(cfg, params,
                                                           batch))
    opt_ms, _ = _timed(lambda: adamw_update(opt_cfg, params, grads, opt))
    return {"forward": fwd, "backward": fwd_bwd - fwd, "optimizer": opt_ms}


def model_flops(cfg, params, batch: int, seq: int):
    """(6 N T model FLOPs of one train step, how N and T were counted).
    Decoder-only: N = the active params (an MoE's routed experts at their
    top_k / n_experts share), T = batch x seq tokens. Encoder-decoder:
    the encoder's layers and norm on batch x enc_frames frames, the
    decoder's layers, norm and unembedding on batch x seq tokens; its
    embedding and position tables are row gathers, not products, and
    are not counted."""
    if cfg.family != "audio":
        n = model_zoo.active_params_count(cfg, params)
        return 6.0 * n * batch * seq, (f"6 x N x T, N = {n} active params, "
                                       f"T = {batch * seq} tokens")
    sizes = {}
    tree_map(lambda path, t: sizes.__setitem__(path, t.numel()), params)
    n_enc = sum(v for k, v in sizes.items()
                if k.split("/")[0] in ("encoder", "enc_norm"))
    n_dec = sum(v for k, v in sizes.items()
                if k.split("/")[0] in ("decoder", "final_norm", "unembed"))
    frames, toks = batch * cfg.enc_frames, batch * seq
    return 6.0 * (n_enc * frames + n_dec * toks), (
        f"6 x (N_enc x frames + N_dec x tokens), N_enc = {n_enc} encoder "
        f"params on {frames} frames, N_dec = {n_dec} decoder and unembedding "
        f"params on {toks} tokens (embedding and position tables are "
        "gathers, not counted)")


def train_full(arch, steps=8, batch=4, seq=2048, n_layers=None):
    """Full-width ``arch`` through the port's Trainer (module docstring,
    phase 6c), at full depth unless ``n_layers`` cuts it. Returns the
    kernels' launch counts of the run (``launches``, and flash's by
    regime) with its step time, rates, model-FLOP share and peak
    memory."""
    cfg = get_config(arch)
    cfg = cfg.with_(n_layers=n_layers or cfg.n_layers)
    opt_cfg = OptimizerConfig(lr=1e-3, warmup_steps=2, total_steps=steps)
    tr = Trainer(cfg, opt_cfg, TrainerConfig(steps=steps, log_every=1),
                 DataConfig(batch=batch, seq=seq), device="cuda")
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    tr.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = launch_counts()
    want = expected_train_launches(cfg, steps)
    losses = [h["loss"] for h in tr.metrics_history]
    params, opt = tr.final_state
    n_params = cfg.params_count(params)
    by_regime = dict(flash_attention.launches_by_regime)
    rows = f"{batch} x {seq} tokens" + (
        f" (+ {cfg.enc_frames} frames each, {cfg.enc_layers} encoder "
        "layers)" if cfg.family == "audio" else "")
    print(f"  {arch} {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{n_params / 1e9:.4f} B params (fp32, AdamW moments fp32), bf16 "
          f"compute, remat {cfg.remat_policy!r}; {steps} steps of {rows} in "
          f"{wall:.1f} s (init included)", flush=True)
    print(f"  losses {[round(x, 4) for x in losses]}", flush=True)
    if cfg.family == "moe":
        print(f"  aux {[round(h['aux'], 6) for h in tr.metrics_history]}",
              flush=True)
    per_regime = {k: v // steps for k, v in by_regime.items()}
    print(f"  launches {launches} (expected {want}: per step "
          f"{expected_train_launches(cfg, 1)}); flash per step by regime "
          f"{per_regime}", flush=True)
    want_regimes = {k: 2 * v for k, v in expected_flash_regimes(
        cfg, 1, seq).items()}
    if launches != want or per_regime != want_regimes:
        raise RuntimeError("train launches differ: the train path did not "
                           "run the kernels in every forward and recompute")
    if (len(losses) != steps or not all(np.isfinite(losses))
            or not losses[-1] < losses[0]):
        raise RuntimeError(f"train losses {losses}: not finite and "
                           "decreasing")
    step_s = float(np.median(tr.step_seconds[1:]))
    tokens = batch * seq
    flops, counted = model_flops(cfg, params, batch, seq)
    mfu = flops / (step_s * PEAK_BF16_FLOPS)
    peak = torch.cuda.max_memory_allocated() / 2**30
    frames = (f", {batch * cfg.enc_frames / step_s:.1f} encoder frames/s"
              if cfg.family == "audio" else "")
    print(f"  step times (s) {[round(t, 4) for t in tr.step_seconds]}; "
          f"median of steps 2-{steps} {step_s:.4f} s, "
          f"{tokens / step_s:.1f} tokens/s{frames}; peak memory "
          f"{peak:.2f} GiB", flush=True)
    print(f"  model-FLOP share = {flops:.4e} / ({step_s:.4f} s x 989e12) = "
          f"{100 * mfu:.2f}% ({counted}, of {n_params} params; 989 "
          "TFLOP/s: H100 SXM data sheet, bf16 dense; remat's recompute is "
          "not counted)", flush=True)
    batch_t = tr._device_batch(tr.stream.batch_at(steps))
    split = _step_split(cfg, opt_cfg, params, opt, batch_t)
    total = sum(split.values())
    parts = ", ".join(f"{k} {v:.2f} ms ({100 * v / total:.1f}%)"
                      for k, v in split.items())
    print("  one step split (CUDA events around each part, device-"
          f"inclusive; backward = value_and_grad less the forward): {parts}",
          flush=True)
    profile_train_step(tr, params, opt, batch_t)
    del tr, params, opt, batch_t
    torch.cuda.empty_cache()
    return {"launches": launches, "launches_by_regime_per_step": per_regime,
            "step_s": step_s, "tokens_per_s": tokens / step_s,
            "model_flop_share": mfu, "peak_gib": peak, "losses": losses}


def profile_train_step(tr, params, opt, batch):
    """torch.profiler over one train step: device busy/idle and the top
    device ops."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    torch.cuda.synchronize()
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.train_step(params, opt, batch)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    report(prof, "train step", wall, top=12)


def check_checkpoint():
    """Resume and restore: olmo_1b_smoke (its 16-wide heads and K 64
    padded inside the kernels' ops) trains on the card, fails at step 9,
    and a fresh Trainer resumes from the step-8 checkpoint to step 12; the
    restored params and moments are bitwise those saved, and the last
    checkpoint restores on the CPU bitwise."""
    cfg = get_config("olmo_1b", smoke=True)
    saved = {}
    with tempfile.TemporaryDirectory() as d:
        def trainer():
            return Trainer(cfg, OptimizerConfig(lr=1e-3, warmup_steps=2,
                                                total_steps=12),
                           TrainerConfig(steps=12, ckpt_dir=d,
                                         ckpt_every=4, log_every=4),
                           DataConfig(batch=4, seq=64), device="cuda")

        t1 = trainer()
        save = t1.save

        def keep(params, opt):
            saved[t1.step] = tree_map(lambda _, t: t.clone(),
                                      {"params": params, "opt": opt})
            save(params, opt)

        t1.save = keep
        try:
            t1.run(fail_at=9)
            raise RuntimeError("the injected failure did not happen")
        except RuntimeError as e:
            if "injected failure at step 9" not in str(e):
                raise
        t2 = trainer()
        params, opt = t2.maybe_restore()
        restored = t2.step
        same = _bitwise({"params": params, "opt": opt}, saved[restored])
        t2.run()
        final = dict(zip(("params", "opt"), t2.final_state))
        res = ckpt_lib.restore(d, final, device="cpu")
        on_cpu = res is not None and res[0] == 12 and _bitwise(
            {"params": res[1]["params"], "opt": res[1]["opt"]}, final)
        print(f"  {cfg.arch_id} on the card: failed at step 9, "
              f"checkpoints {sorted(saved)}, "
              f"restored step {restored} bitwise equal "
              f"to the saved state: {same}; resumed to step {t2.step}; "
              f"step-12 checkpoint restores on the CPU bitwise: {on_cpu}",
              flush=True)
        if not (same and on_cpu and restored == 8 and t2.step == 12
                and ckpt_lib.latest_step(d) == 12):
            raise RuntimeError("checkpoint resume or restore failed")


MESH_TRAIN = ("olmo_1b", 2, 4, 2048, 2)   # arch, depth, batch, seq, steps
MESH_DECODE = ("granite_8b", 2, 4, 64)     # arch, depth, batch, prompt
MESH_PIPELINE = ("granite_8b", 6, 256)     # arch, microbatches, rows each
# the MoE on the mesh: full width, MESH_TRAIN's cut (tp plan, moe_shards 1)
MESH_MOE_TRAIN = (("granite_moe_1b_a400m", 2, 4, 2048, 2),
                  ("deepseek_moe_16b", 2, 4, 2048, 2))
MESH_MOE_DECODE = (("granite_moe_1b_a400m", 2, 4, 64),
                   ("deepseek_moe_16b", 2, 4, 64))
# (arch, shape, multi-pod, plan) of the dry-run phase: the cells of
# tests/test_dryrun_cell.py and one MoE cell
DRYRUN = (("whisper_base", "decode_32k", True, "tp"),
          ("olmo_1b", "train_4k", False, "dp"),
          ("granite_8b", "long_500k", False, "tp"),
          ("mamba2_780m", "long_500k", False, "tp"),
          ("deepseek_moe_16b", "train_4k", False, "ep"))


def _check_mesh_launches(label, cfg, plain, meshed):
    """The mesh path launched what the meshless one did: flash in every
    model here, the fused MLP where the model has SwiGLU MLPs."""
    if plain != meshed or not meshed["flash_attention"] or (
            fused_mlps(cfg) and not meshed["fused_mlp"]):
        raise RuntimeError(f"{label}: the mesh path did not run the kernels "
                           "behind local_map as the meshless path does")


def _hold(label, got, want, limit=None):
    """Bitwise, or else within ``limit`` of relative RMS; prints which
    and raises past the limit (with no limit, unless bitwise)."""
    same = _bitwise(got, want)
    worst = 0.0
    if not same:
        rel = leaf_rel_rms(got, want)
        worst = max(rel.values()) if rel else float("inf")
    print(f"  {label}: bitwise equal {same}" + (
        "" if same else f"; worst leaf rel RMS {worst:.3e} (limit {limit})"),
        flush=True)
    if not same and (limit is None or not worst <= limit):
        raise RuntimeError(f"{label}: the mesh path disagrees")
    return {"bitwise": same, "worst_leaf_rel_rms": worst}


def mesh_train(mesh, spec=MESH_TRAIN):
    """``spec`` (``MESH_TRAIN`` or one of ``MESH_MOE_TRAIN``) through the
    Trainer on the (1, 1) mesh and without one, from the same seed: the
    losses, the final params and moments (the mesh's gathered) bitwise
    equal, or within the arch's TRAIN_LIMITS if not (bitwise where it has
    none); the same flash and fused_mlp launches (on the mesh they run
    behind local_map)."""
    arch, depth, batch, seq, steps = spec
    cfg = get_config(arch).with_(n_layers=depth)
    runs = {}
    for name, m in (("meshless", None), ("mesh", mesh)):
        tr = Trainer(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                          total_steps=steps),
                     TrainerConfig(steps=steps, log_every=1),
                     DataConfig(batch=batch, seq=seq), device="cuda",
                     mesh=m)
        reset_launch_counts()
        tr.run()
        torch.cuda.synchronize()
        params, opt = tr.final_state
        runs[name] = {"losses": [h["loss"] for h in tr.metrics_history],
                      "launches": launch_counts(),
                      "state": sharding.gather({"params": params,
                                                "opt": opt}),
                      "seconds": tr.step_seconds}
        del tr, params, opt
    a, b = runs["meshless"], runs["mesh"]
    print(f"  {arch} {depth} layers, {batch} x {seq}, {steps} steps: losses "
          f"meshless {a['losses']} mesh {b['losses']}; step seconds "
          f"meshless {[round(t, 4) for t in a['seconds']]} mesh "
          f"{[round(t, 4) for t in b['seconds']]}", flush=True)
    print(f"  launches meshless {a['launches']} mesh {b['launches']}",
          flush=True)
    _check_mesh_launches(f"{arch} mesh train", cfg, a["launches"],
                         b["launches"])
    lim_loss, _, lim_leaf = TRAIN_LIMITS.get(arch, (0.0, None, None))
    loss_rel = max(abs(x - y) / abs(y)
                   for x, y in zip(b["losses"], a["losses"]))
    if loss_rel > lim_loss:
        raise RuntimeError(f"mesh losses differ by {loss_rel:.3e}")
    out = _hold("mesh train state vs meshless (params and moments)",
                b["state"], a["state"], lim_leaf)
    out.update(loss_max_rel=loss_rel, launches=b["launches"],
               losses=b["losses"])
    return out


def mesh_decode(mesh, spec=MESH_DECODE):
    """``spec`` (``MESH_DECODE`` or one of ``MESH_MOE_DECODE``): one
    decode step on the (1, 1) mesh (params, cache and tokens placed by
    param_specs, cache_specs and batch_specs) after a meshless prefill,
    against the meshless step: the same launches but the decode kernel,
    which only the meshless step runs (a DTensor cache attends in torch,
    ``gqa_decode_attend``); logits and cache bitwise, or within
    ``NUMERICS_REL_RMS``: the decode kernel keeps P in fp32 where the
    torch path rounds it to bf16 and sums in another order, so each
    layer's attention output differs in its last bits, and with it the
    keys and values the next layer writes."""
    arch, depth, batch, prompt = spec
    cfg = get_config(arch).with_(n_layers=depth)
    params = model_zoo.init_params(
        cfg, torch.Generator(device="cuda").manual_seed(SEED))
    toks = torch.from_numpy(np.random.RandomState(SEED).randint(
        0, cfg.vocab, (batch, prompt)).astype(np.int32)).cuda()
    nxt = toks[:, -1]
    step = make_decode_step(cfg)
    with torch.no_grad():
        _, cache = model_zoo.prefill(cfg, params, toks, prompt + 32)
        dcache = sharding.distribute(
            tree_map(lambda _, t: t.clone() if torch.is_tensor(t) else t,
                     cache),
            sharding.cache_specs(cfg, batch, mesh, cache), mesh)
        reset_launch_counts()
        want, cache = step(params, cache, nxt)
        torch.cuda.synchronize()
        plain = launch_counts()
        reset_launch_counts()
        got, dcache = step(
            sharding.distribute(params, sharding.param_specs(params, mesh),
                                mesh), dcache,
            sharding.distribute(nxt, sharding.batch_specs(
                cfg, batch, mesh, "decode"), mesh))
        torch.cuda.synchronize()
        meshed = launch_counts()
    spec = sharding.cache_specs(cfg, batch, mesh, cache)["layers"]["k"]
    print(f"  {arch} {depth} layers, batch {batch}, decode at position "
          f"{prompt}: cache spec {spec}; launches meshless {plain} mesh "
          f"{meshed}", flush=True)
    if ({**plain, "decode_attention": 0} != meshed
            or plain["decode_attention"] != depth
            or (fused_mlps(cfg) and not meshed["fused_mlp"])):
        raise RuntimeError(f"{arch}: the mesh decode step did not run the "
                           "kernels")
    out = _hold("mesh decode logits and cache vs meshless",
                {"logits": got.full_tensor(),
                 "cache": sharding.gather(dcache["layers"])},
                {"logits": want, "cache": cache["layers"]},
                NUMERICS_REL_RMS)
    out["launches"] = meshed
    return out


def mesh_checkpoint(mesh):
    """olmo_1b_smoke trains 2 steps through the Trainer on the mesh,
    which saves from its DTensors (rank 0 writes the full tensors); the
    checkpoint restores without a mesh on the card, and through a fresh
    mesh Trainer's ``maybe_restore``, bitwise equal to the state it
    ended with. (The full-width state would spend minutes in the zlib
    codec, which is not what this checks.)"""
    cfg = get_config("olmo_1b", smoke=True)
    with tempfile.TemporaryDirectory() as d:
        def trainer():
            return Trainer(cfg, OptimizerConfig(lr=1e-3, warmup_steps=1,
                                                total_steps=2),
                           TrainerConfig(steps=2, ckpt_dir=d, log_every=1),
                           DataConfig(batch=4, seq=64), device="cuda",
                           mesh=mesh)
        tr = trainer()
        tr.run()
        state = sharding.gather(dict(zip(("params", "opt"),
                                         tr.final_state)))
        flat = ckpt_lib.restore(d, state, device="cuda")
        again = trainer()
        back = again.maybe_restore()
    ok_flat = flat is not None and flat[0] == 2 and _bitwise(flat[1], state)
    ok_back = back is not None and again.step == 2 and _bitwise(
        sharding.gather(dict(zip(("params", "opt"), back))), state)
    print(f"  {cfg.arch_id}, 2 steps on the mesh, saved by its Trainer: "
          f"restored without a mesh bitwise: {ok_flat}; restored by a mesh "
          f"Trainer bitwise: {ok_back} (meta mesh {flat and flat[2]['mesh']})",
          flush=True)
    if not (ok_flat and ok_back):
        raise RuntimeError("mesh checkpoint does not restore bitwise")
    return {"restored_meshless_bitwise": ok_flat,
            "restored_on_mesh_bitwise": ok_back}


def mesh_pipeline():
    """``pipeline_forward`` with one stage (a 1-rank "stage" mesh) over
    ``MESH_PIPELINE``'s microbatches, the stage the fused MLP kernel at
    the arch's width, against ``sequential_reference``: bitwise, or
    within the kernels' tolerance; one launch a microbatch."""
    arch, n_micro, rows = MESH_PIPELINE
    cfg = get_config(arch)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 2)
    k, f = cfg.d_model, cfg.d_ff
    sp = {"w1": randn(gen, 1, k, f, scale=k ** -0.5),
          "w3": randn(gen, 1, k, f, scale=k ** -0.5),
          "w2": randn(gen, 1, f, k, scale=f ** -0.5)}
    x = randn(gen, n_micro, rows, k)

    def stage_fn(p, a):
        return fused_mlp(a, p["w1"], p["w3"], p["w2"])
    stage_mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("stage",))
    reset_launch_counts()
    y = pipeline_forward(stage_fn, sp, x, stage_mesh, axis="stage")
    torch.cuda.synchronize()
    launches = launch_counts()["fused_mlp"]
    want = sequential_reference(stage_fn, sp, x)
    same = torch.equal(y, want)
    print(f"  pipeline_forward, 1 stage, {n_micro} microbatches of {rows} x "
          f"{k} (fused MLP K {k} F {f}): fused_mlp launches {launches}; "
          f"equal to sequential_reference bitwise: {same}", flush=True)
    err = 0.0 if same else compare("pipeline vs sequential_reference", y,
                                   want)
    if launches != n_micro:
        raise RuntimeError("the pipeline stage did not run the kernel")
    return {"bitwise": same, "max_abs_err": err, "launches": launches}


def mesh_phase():
    """Phase 7 (module docstring): the mesh path on one card. Returns the
    results of each check."""
    torch.cuda.set_device(0)
    with tempfile.TemporaryDirectory() as d:
        dist.init_process_group("nccl", init_method="file://" + os.path.join(
            d, "rendezvous"), world_size=1, rank=0,
            device_id=torch.device("cuda", 0))
        try:
            mesh = make_host_mesh(data=1, model=1, device_type="cuda")
            out = {"train": clocked("mesh train", mesh_train, mesh),
                   "decode": clocked("mesh decode", mesh_decode, mesh),
                   "moe_train": {spec[0]: clocked(
                       f"mesh train {spec[0]}", mesh_train, mesh, spec)
                       for spec in MESH_MOE_TRAIN},
                   "moe_decode": {spec[0]: clocked(
                       f"mesh decode {spec[0]}", mesh_decode, mesh, spec)
                       for spec in MESH_MOE_DECODE},
                   "checkpoint": clocked("mesh checkpoint", mesh_checkpoint,
                                         mesh),
                   "pipeline": clocked("mesh pipeline", mesh_pipeline)}
        finally:
            dist.destroy_process_group()
    torch.cuda.empty_cache()
    return out


def dryrun_phase():
    """Phase 8 (module docstring): ``DRYRUN``'s cells through the port's
    dry-run (``run_and_save``, fake tensors on this machine's CPU): the
    long_500k cell of a full-attention arch is skipped, every other is
    ok with FLOPs > 0 and its model FLOPs no more than the counted FLOPs
    of all its chips (the counter sees the work behind local_map); no
    kernel launches. Prints each cell's roofline, its per-device peak
    against this card's memory, and its seconds."""
    total = torch.cuda.mem_get_info()[1]
    before = launch_counts()
    out = {}
    with tempfile.TemporaryDirectory() as d:
        for arch, shape, multi_pod, plan in DRYRUN:
            t0 = time.perf_counter()
            rec = dryrun.run_and_save(arch, shape, multi_pod, d, plan=plan)
            secs = time.perf_counter() - t0
            status = str(rec["status"])
            name = f"{arch} {shape} {rec['mesh']} {plan}"
            if not dryrun.cell_status(arch, shape)[0]:
                if not status.startswith("skip"):
                    raise RuntimeError(f"{name}: not skipped ({status})")
                print(f"  {name}: {status} ({secs:.1f} s)", flush=True)
                out[f"{arch}/{shape}"] = {"status": status}
                continue
            if status != "ok":
                print(rec.get("traceback", ""), flush=True)
                raise RuntimeError(f"{name}: {status[:300]}")
            r, peak = rec["roofline"], rec["memory"]["peak_bytes_per_device"]
            print(f"  {name}: {secs:.1f} s; per device flops {r['flops']:.4e}"
                  f" hbm bytes {r['hbm_bytes']:.4e} collective bytes "
                  f"{r['collective_bytes']:.4e}; compute {r['compute_s']:.4e}"
                  f" s memory {r['memory_s']:.4e} s collective "
                  f"{r['collective_s']:.4e} s -> {r['bottleneck']}; peak "
                  f"{peak / 2**30:.2f} GiB of this card's {total / 2**30:.2f}"
                  f" GiB; collectives {rec['collectives']['counts']}; model "
                  f"flops {rec['model_flops']:.4e} (useful ratio "
                  f"{rec['useful_flops_ratio']:.3f})", flush=True)
            if not (r["flops"] > 0 and rec["model_flops"]
                    <= r["flops"] * rec["n_chips"]):
                raise RuntimeError(f"{name}: counted FLOPs {r['flops']} x "
                                   f"{rec['n_chips']} chips below the model's "
                                   f"{rec['model_flops']}")
            out[f"{arch}/{shape}"] = {**{k: rec[k] for k in (
                "mesh", "plan", "n_chips", "roofline", "model_flops")},
                "peak_bytes_per_device": peak, "seconds": secs}
    if launch_counts() != before:
        raise RuntimeError("the dry-run launched a kernel")
    return out


# seconds a ``distributed=2`` request may take before its workers count as
# hung (the serial request of the same network takes about 1 s)
MAPPING_DIST_TIMEOUT_S = 120.0


def _no_wall(x):
    """``x`` with every ``wall_s`` (host clock) dropped."""
    if isinstance(x, dict):
        return {k: _no_wall(v) for k, v in x.items() if k != "wall_s"}
    if isinstance(x, list):
        return [_no_wall(v) for v in x]
    return x


def _same_answer(label, got, want):
    """MappingResponse ``got`` carries ``want``'s frontier bytes and
    winner."""
    if got.frontier_json != want.frontier_json or \
            _no_wall(got.best) != _no_wall(want.best):
        raise RuntimeError(f"{label}: the answer differs from the cold one")


def _watchdog(label, fn, timeout_s):
    """``fn()`` in a thread; past ``timeout_s`` the children it forked are
    terminated and the phase fails instead of hanging."""
    box = {}

    def run():
        try:
            box["out"] = fn()
        except BaseException as e:   # handed to the caller below
            box["err"] = e
    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(timeout_s)
    if t.is_alive():
        for child in multiprocessing.active_children():
            child.terminate()
        raise RuntimeError(f"{label}: no answer in {timeout_s:.0f} s (hung "
                           "worker processes terminated)")
    if "err" in box:
        raise box["err"]
    return box["out"]


def host_cpu() -> str:
    """The host CPU's model as /proc/cpuinfo gives it (x86 "model name";
    where that is missing or "unknown", as on a sandboxed host, its
    vendor, family and model numbers), with the machine type."""
    fields = {}
    with open("/proc/cpuinfo") as f:
        for ln in f:
            if not ln.strip():
                break                      # the first processor's block
            k, _, v = ln.partition(":")
            fields.setdefault(k.strip(), v.strip())
    if fields.get("model name", "unknown") != "unknown":
        keys = ("model name",)
    else:
        keys = ("vendor_id", "cpu family", "model", "CPU implementer",
                "CPU part")
    desc = ", ".join(f"{k} {fields[k]}" for k in keys if k in fields)
    return f"{desc or 'no model in /proc/cpuinfo'} ({platform.machine()})"


def mapping_phase():
    """Phase 9 (module docstring): the Fast-OverlaPIM mapper on this
    machine's host CPU. Returns the cold answers' hashes."""
    print(f"  host CPU {host_cpu()}, os.cpu_count() {os.cpu_count()}; every "
          "time below is host wall time on the GPU machine, not card time",
          flush=True)
    t0 = time.perf_counter()
    for name in list_scenarios():
        d = describe_scenario(name)
        macs = sum(layer.macs for layer in d.layers)
        if not d.layers or macs <= 0:
            raise RuntimeError(f"{name}: lowered to nothing")
        print(f"  {name}: {len(d.layers)} layers, {macs} MACs", flush=True)
    print(f"  lowered {len(list_scenarios())} full-size scenarios in "
          f"{time.perf_counter() - t0:.3f} s", flush=True)
    out = {}
    with tempfile.TemporaryDirectory() as root:
        def service(name):
            return MappingService(
                journal_path=os.path.join(root, f"{name}.jsonl"),
                shared_root=os.path.join(root, f"{name}_shared"))
        svc, cold = service("main"), {}
        try:
            for kw in MAPPING_REQUESTS:
                req = MappingRequest(**kw)
                t1 = time.perf_counter()
                r = cold[kw["network"]] = svc.request(req)
                wall = time.perf_counter() - t1
                if r.served_from != "search" or r.evaluated <= 0:
                    raise RuntimeError(f"{kw['network']}: cold answer served "
                                       f"from {r.served_from}")
                sha = frontier_sha256(r)
                out[kw["network"]] = {"best": r.best["arch_name"],
                                      "evaluated": r.evaluated,
                                      "wall_s": wall, "sha256": sha}
                print(f"  {kw['network']}: best {r.best['arch_name']}, "
                      f"evaluated {r.evaluated}, {wall:.3f} s, frontier "
                      f"sha256 {sha}", flush=True)
                memo = svc.request(req)
                if memo.served_from != "memo" or memo.evaluated != 0:
                    raise RuntimeError(f"{kw['network']}: replay served from "
                                       f"{memo.served_from}, evaluated "
                                       f"{memo.evaluated}")
                _same_answer(f"{kw['network']} memo replay", memo, r)
        finally:
            svc.close()
        svc = service("main")       # a restart over the same journal
        try:
            for kw in MAPPING_REQUESTS:
                r = svc.request(MappingRequest(**kw))
                if r.served_from != "journal" or r.evaluated != 0:
                    raise RuntimeError(f"{kw['network']}: restart served from "
                                       f"{r.served_from}, evaluated "
                                       f"{r.evaluated}")
                _same_answer(f"{kw['network']} journal replay", r,
                             cold[kw["network"]])
        finally:
            svc.close()
        print(f"  memo and journal replays of {len(MAPPING_REQUESTS)} "
              "requests: evaluated 0, frontiers byte-identical", flush=True)
        kw = MAPPING_REQUESTS[0]
        want = cold[kw["network"]]
        srv = MappingHTTPServer(service("http"), port=0).start()
        try:
            t1 = time.perf_counter()
            with urllib.request.urlopen(urllib.request.Request(
                    srv.url + "/v1/mapping", data=json.dumps(kw).encode(),
                    headers={"Content-Type": "application/json"}),
                    timeout=120) as resp:
                body = json.loads(resp.read())
            wall = time.perf_counter() - t1
        finally:
            srv.close()
            srv.service.close()
        if body["served_from"] != "search" or \
                _no_wall(body) != _no_wall(json.loads(want.to_json())):
            raise RuntimeError("the HTTP answer differs from the in-process "
                               "one")
        print(f"  HTTP POST /v1/mapping {kw['network']}: {wall:.3f} s, body "
              "equal to the in-process answer (wall_s aside)", flush=True)
        # the fork below happens after the CUDA context and torch's CPU
        # thread pool exist
        a = torch.randn(512, 512, device="cuda")
        torch.cuda.synchronize()
        b = torch.randn(512, 512)
        if not (bool(torch.isfinite(a @ a).all())
                and bool(torch.isfinite(b @ b).all())):
            raise RuntimeError("torch warm-up gave non-finite values")
        dist_svc = service("distributed")
        try:
            t1 = time.perf_counter()
            r = _watchdog("distributed=2", lambda: dist_svc.request(
                MappingRequest(**kw, distributed=2)), MAPPING_DIST_TIMEOUT_S)
            wall = time.perf_counter() - t1
        finally:
            dist_svc.close()
        if r.served_from != "search" or r.evaluated <= 0:
            raise RuntimeError(f"distributed=2 served from {r.served_from}")
        _same_answer("distributed=2", r, want)
        print(f"  distributed=2 {kw['network']} (2 forked workers): "
              f"{wall:.3f} s, evaluated {r.evaluated}, frontier equal to the "
              "serial one", flush=True)
    return out


def run_launchers(arch, train=True):
    """``python -m repro_torch.launch.train`` (2 steps, unless not
    ``train``) and ``...serve`` with their defaults (the smoke config, on
    cuda), in this process so that their kernel launches are counted:
    each must launch the kernels of its model, training each in every
    step's forward and recompute; a serve-only arch must launch exactly
    one prefill's and the decode steps' kernels."""
    cfg = get_config(arch, smoke=True)
    trained, t_train = None, 0.0
    if train:
        reset_launch_counts()
        t0 = time.perf_counter()
        train_launcher.main(["--arch", arch, "--steps", "2"])
        torch.cuda.synchronize()
        t_train = time.perf_counter() - t0
        trained = launch_counts()
    reset_launch_counts()
    t0 = time.perf_counter()
    serve_launcher.main(["--arch", arch])
    torch.cuda.synchronize()
    t_serve = time.perf_counter() - t0
    served = launch_counts()
    if not train:
        new = serve_launcher.DEFAULT_NEW_TOKENS
        want = expected_launches(cfg, 1, new)
        print(f"  launch.serve --arch {arch} ({cfg.arch_id} on cuda, {new} "
              f"new tokens): {t_serve:.1f} s, launches {served} (expected "
              f"{want})", flush=True)
        if served != want:
            raise RuntimeError(f"{arch}: launch.serve did not run the "
                               "kernels")
        by_regime = check_flash_regimes(arch, "launch.serve", cfg, 1,
                                        serve_launcher.DEFAULT_PROMPT_LEN)
        print(f"  flash by regime {by_regime} (as expected)", flush=True)
        return
    want = expected_train_launches(cfg, 2)
    print(f"  launch.train --arch {arch} --steps 2 ({cfg.arch_id} on cuda): "
          f"{t_train:.1f} s, launches {trained} (expected {want}); "
          f"launch.serve --arch {arch}: {t_serve:.1f} s, launches {served}",
          flush=True)
    serve_ops = FWD_OPS + (CHAIN_OPS if cfg.is_ssm_family else ())
    if (trained != want or any(served[op] == 0 for op in serve_ops
                               if want[op] or op in CHAIN_OPS)
            or any(served[op] for op in BWD_OPS)):
        raise RuntimeError(f"{arch}: a launcher did not run the kernels")


def backward_entries(train_entries, train_launches, steps):
    """The ``kernels`` JSON entries of the three backward kernels, from the
    train phase: their times and errors at the Functions' train shapes
    (olmo_1b's attention and MLP, mamba2_780m's scan) and their launches
    in the ``TRAIN`` runs (olmo_1b and mamba2_780m, whose counts were
    zeroed just before each run), with each run's launches per step."""
    fl, ss = train_entries["flash_attention"], train_entries["ssd_scan"]
    ml = train_entries["fused_mlp"]
    keys = ("backward_ms", "torch_backward_ms", "plain_backward_ms",
            "library_backward_ms", "backward_bound_ms", "grad_max_err",
            "shape")
    fkeys = keys + ("backward_launches_ms", "backward_launch_ms",
                    "library_backward_launches_ms")

    def per_step(op):
        return {arch: run[op] // steps for arch, run in train_launches.items()}

    flash = {
        "name": "flash_attention_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/flash_attn_bwd.cu",
        "replaces": "src/repro/kernels/flash_attn/flash_attn.py:73",
        "replaces_note": "the gradient of that forward-only kernel, which "
                         "the reference takes by XLA's autodiff of its "
                         "einsums",
        "launches": train_launches["olmo_1b"]["flash_attention_bwd"],
        "launches_path": f"olmo_1b train, {steps} steps, remat full",
        "launches_per_step": per_step("flash_attention_bwd"),
        "max_abs_err": fl["grad_max_err"],
        "max_abs_err_of": "dq, dk, dv scaled by their largest magnitude, "
                          "against autograd of attention_ref",
        "ms": fl["backward_ms"], "plain_ms": fl["torch_backward_ms"],
        "plain": "attention_bwd (explicit torch)",
        "plain_autograd_ms": fl["plain_backward_ms"],
        "bound_ms": fl["backward_bound_ms"],
        "bound_by": fl["backward_bound_by"],
        "library_ms": fl["library_backward_ms"],
        "library": "backward of F.scaled_dot_product_attention("
                   "is_causal=True, enable_gqa=True)",
        "shape": fl["shape"],
        "launches_alone_ms": fl["backward_launches_ms"],
        "launch_device_ms": fl["backward_launch_ms"],
        "library_launches_alone_ms": fl["library_backward_launches_ms"],
        "granite_moe": {k: fl["granite_moe"][k] for k in fkeys},
        "whisper": {r: {k: c[k] for k in fkeys}
                    for r, c in fl["whisper"].items()},
        "llava": {k: fl["llava"][k] for k in fkeys},
        "head_dims": fl["head_dims"]}
    mlp = {
        "name": "fused_mlp_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/fused_mlp_bwd.cu",
        "replaces": "src/repro/kernels/fused_mlp/fused_mlp.py:52",
        "replaces_note": "the gradient of that forward-only kernel, which "
                         "the reference takes by XLA's autodiff of "
                         "models/mlp.py's einsums",
        "launches": train_launches["olmo_1b"]["fused_mlp_bwd"],
        "launches_path": f"olmo_1b train, {steps} steps, remat full",
        "launches_per_step": per_step("fused_mlp_bwd"),
        "max_abs_err": ml["grad_max_err"],
        "max_abs_err_of": "dx, dW1, dW3, dW2 scaled by their largest "
                          "magnitude, against autograd of fused_mlp_ref",
        "ms": ml["backward_ms"], "plain_ms": ml["torch_backward_ms"],
        "plain": "fused_mlp_bwd (explicit torch)",
        "plain_autograd_ms": ml["plain_backward_ms"],
        "bound_ms": ml["backward_bound_ms"],
        "bound_by": ml["backward_bound_by"],
        "library_ms": ml["library_backward_ms"],
        "library": "autograd of the cuBLAS chain (silu(x W1) * (x W3)) W2",
        "shape": ml["shape"],
        "launches_alone_ms": ml["backward_launches_ms"],
        "launch_device_ms": ml["backward_launch_ms"],
        "stream_k": ml["stream_k"],
        "llava": {k: ml["llava"][k] for k in keys + (
            "backward_launches_ms", "backward_launch_ms", "stream_k")},
        "smoke": ml["smoke"]}
    ssd = {
        "name": "ssd_scan_bwd", "route": "cuda",
        "source": "src/repro_torch/csrc/ssd_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssd_scan/ssd_scan.py:63",
        "replaces_note": "the gradient of that forward-only kernel, which "
                         "the reference takes by XLA's autodiff of "
                         "models/ssm.py:ssd_chunked",
        "launches": train_launches["mamba2_780m"]["ssd_scan_bwd"],
        "launches_path": f"mamba2_780m train (24 of 48 layers), {steps} "
                         "steps, remat full",
        "launches_per_step": per_step("ssd_scan_bwd"),
        "max_abs_err": max(ss["grad_max_err"].values()),
        "max_abs_err_of": "dx, ddt, dA, dB, dC scaled by their largest "
                          "magnitude, against autograd of ssd_chunked (fp32)",
        "grad_max_err": ss["grad_max_err"],
        "ms": ss["backward_ms"], "plain_ms": ss["torch_backward_ms"],
        "plain": "ssd_scan_bwd (explicit torch)",
        "plain_autograd_ms": ss["plain_backward_ms"],
        "chunked_autograd_ms": ss["library_backward_ms"],
        "bound_ms": ss["backward_bound_ms"],
        "bound_by": ss["backward_bound_by"], "library_ms": None,
        "library": "none: no single PyTorch call computes the SSD scan's "
                   "gradient (chunked_autograd_ms: autograd of the torch "
                   "chain ssd_chunked)",
        "launches_alone_ms": ss["backward_launches_ms"],
        "launch_device_ms": ss["backward_launch_ms"],
        "zamba2": ss["zamba2"],
        "smoke": ss["smoke"], "shape": ss["shape"]}
    for e in (flash, mlp, ssd):
        print(f"  {e['name']}: {e['launches']} launches in {e['launches_path']}"
              f", per step {e['launches_per_step']}", flush=True)
    return [flash, mlp, ssd]


def _leaves(tree):
    """[(path, leaf)] of a nested dict."""
    out = []
    tree_map(lambda path, t: out.append((path, t)), tree)
    return out


def _bitwise(got, want):
    """Every leaf of ``got`` equals ``want``'s bitwise (same dtype)."""
    ok = []
    tree_map(lambda path, t: ok.append(
        t.dtype == tree_get(want, path).dtype and torch.equal(
            t.cpu(), tree_get(want, path).cpu())), got)
    return all(ok) and len(ok) > 0


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
            if ("registers" in line or "spill" in line
                    or "warning" in line.lower()):
                print(f"  {name}: {line.strip()}")
    sass_census(secs)

    phase("kernels")
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    entries = [clocked("flash", check_flash, gen, flush),
               clocked("fused_mlp", check_fused_mlp, gen, flush),
               clocked("ssd_scan", check_ssd, gen, flush)]
    smoke = check_smoke_shapes(gen)
    for e in entries:
        e["smoke"] = smoke[e["name"]]
    entries.append(clocked("decode_attn", check_decode_attn, gen, flush))
    entries.extend(clocked("ssm_chain", check_ssm_chain, gen, flush))
    adamw_entry = clocked("adamw", check_adamw, gen, flush)
    del flush
    torch.cuda.empty_cache()

    phase("numerics")
    for arch, depth, batch, seq in NUMERICS:
        clocked(arch, check_numerics, arch, depth, batch, seq)
        torch.cuda.empty_cache()

    phase("serve")
    # each kernel's launches come from the path that runs it
    path_of = {"flash_attention": "granite_8b", "fused_mlp": "granite_8b",
               "ssd_scan": "mamba2_780m", "decode_attention": "granite_8b",
               "conv_silu": "mamba2_780m", "gated_rmsnorm": "mamba2_780m"}
    moe_path = {"flash_attention": "granite_moe_1b_a400m",
                "fused_mlp": "deepseek_moe_16b"}
    launches, regimes = {}, {}
    for arch, batch, prompt, depth in SERVE:
        launches[arch], regimes[arch] = clocked(arch, serve, arch, batch,
                                                prompt, 32, depth)
        torch.cuda.empty_cache()
    for e in entries:
        e["launches"] = launches[path_of[e["name"]]][e["name"]]
        e["launches_path"] = path_of[e["name"]]
        e["zamba2_1_2b_serve_launches"] = launches["zamba2_1_2b"][e["name"]]
        if e["name"] in moe_path:
            e["moe"]["launches"] = launches[moe_path[e["name"]]][e["name"]]
        for arch, key in (("whisper_base", "whisper"),
                          ("llava_next_34b", "llava")):
            if key in e:
                e[key]["launches"] = launches[arch][e["name"]]
    # whisper's flash launches, counted by regime in its serve run
    wh = entries[0]["whisper"]
    wh["launches_by_regime"] = regimes["whisper_base"]
    wh["encoder"]["launches"] = regimes["whisper_base"][REGIMES[1]]
    wh["cross"]["launches"] = regimes["whisper_base"][REGIMES[2]]

    phase("train")
    t_train = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED + 1)
    flush = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    train_entries = clocked("Functions", check_train_kernels, gen, flush)
    del flush
    torch.cuda.empty_cache()
    numerics = {arch: clocked(f"{arch} step", check_train_numerics, arch,
                              depth, batch, seq)
                for arch, depth, batch, seq in TRAIN_NUMERICS}
    torch.cuda.empty_cache()
    steps = 8
    train_runs = {arch: clocked(f"{arch} train", train_full, arch,
                                steps=steps, seq=seq, n_layers=depth)
                  for arch, depth, seq in TRAIN}
    train_launches = {arch: run["launches"]
                      for arch, run in train_runs.items()}
    clocked("checkpoint", check_checkpoint)
    # flash and fused_mlp's train entries from olmo_1b, ssd_scan's from
    # mamba2_780m: the paths that each carry the kernel at its train shape
    train_path = {"flash_attention": "olmo_1b", "fused_mlp": "olmo_1b",
                  "ssd_scan": "mamba2_780m"}
    for e in entries:
        if e["name"] not in train_path:     # decode attention: serving only
            continue
        arch = train_path[e["name"]]
        e["train"] = {"launches_per_step":
                      train_launches[arch][e["name"]] // steps,
                      "path": f"{arch} train, remat full",
                      "zamba2_1_2b_launches_per_step":
                      train_launches["zamba2_1_2b"][e["name"]] // steps,
                      "granite_moe_1b_a400m_launches_per_step":
                      train_launches["granite_moe_1b_a400m"][e["name"]]
                      // steps,
                      "step_numerics": numerics[arch],
                      **train_entries.get(e["name"], {})}
    e = entries[0]
    e["moe"]["train"] = {"path": "granite_moe_1b_a400m train, remat full",
                         "step_numerics": numerics["granite_moe_1b_a400m"]}
    wh = train_runs["whisper_base"]
    e["train"]["whisper"] = {
        "path": "whisper_base train, remat full",
        "launches_per_step": wh["launches"]["flash_attention"] // steps,
        "launches_by_regime": wh["launches_by_regime_per_step"],
        "step_numerics": numerics["whisper_base"],
        **{k: wh[k] for k in ("step_s", "tokens_per_s", "model_flop_share",
                              "peak_gib")},
        "functions": e["train"].pop("whisper")}
    for e in entries[:2]:
        e["train"]["llava_next_34b_step_numerics"] = numerics[
            "llava_next_34b"]
    entries.extend(backward_entries(train_entries, train_launches, steps))
    print(f"  train phase wall {time.perf_counter() - t_train:.1f} s",
          flush=True)

    phase("mesh")
    mesh = mesh_phase()
    for e in entries[:2]:
        e["mesh"] = {"train_launches": mesh["train"]["launches"][e["name"]],
                     "decode_launches": mesh["decode"]["launches"][e["name"]],
                     "path": f"{MESH_TRAIN[0]} train and {MESH_DECODE[0]} "
                             "decode on a (1, 1) (data, model) mesh"}
    entries[1]["mesh"]["pipeline_launches"] = mesh["pipeline"]["launches"]
    for e in entries[:2]:
        e["mesh"]["moe"] = {
            arch: {"train_launches": mesh["moe_train"][arch]["launches"][
                e["name"]], "decode_launches": mesh["moe_decode"][arch][
                "launches"][e["name"]]} for arch, *_ in MESH_MOE_TRAIN}
    # the flash and fused MLP backward kernels behind local_map
    for e in entries:
        if e["name"] not in ("flash_attention_bwd", "fused_mlp_bwd"):
            continue
        e["mesh"] = {
            "train_launches": mesh["train"]["launches"][e["name"]],
            "path": f"{MESH_TRAIN[0]} train on a (1, 1) (data, model) mesh",
            "moe": {arch: mesh["moe_train"][arch]["launches"][e["name"]]
                    for arch, *_ in MESH_MOE_TRAIN}}
        if not e["mesh"]["train_launches"]:
            raise RuntimeError(f"the mesh train step ran no {e['name']} "
                               "kernel")

    phase("dryrun")
    t_dry = time.perf_counter()
    cells = dryrun_phase()
    print(f"  dryrun phase wall {time.perf_counter() - t_dry:.1f} s; cells "
          f"{json.dumps(cells)}", flush=True)

    phase("mapping")
    t_map = time.perf_counter()
    answers = mapping_phase()
    print(f"  mapping phase wall {time.perf_counter() - t_map:.1f} s (host); "
          f"answers {json.dumps(answers)}", flush=True)

    phase("launchers")
    for arch in ("olmo_1b", "mamba2_780m", "zamba2_1_2b",
                 "granite_moe_1b_a400m", "deepseek_moe_16b"):
        run_launchers(arch)
    for arch in ("whisper_base", "llava_next_34b"):  # they serve, not train
        run_launchers(arch, train=False)

    print(f"  chip_smoke wall {time.perf_counter() - T0:.1f} s", flush=True)
    print(json.dumps({"kernels": entries + [adamw_entry]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

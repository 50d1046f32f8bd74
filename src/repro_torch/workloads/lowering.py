"""Lowering LLM blocks (``ModelConfig``) into 7D ``LayerSpec`` networks.

The mapping core speaks conv/matmul loop nests (``core.workload``); the
model zoo speaks ``ModelConfig``. This module translates one decoder
*block* of each architecture family into a ``LayerSpec`` chain plus the
dependency ``Edge``s that feed overlap analysis — the same contract the
hand-written resnet/bert networks satisfy — so the overlap search, the
DSE sweeps and the mapping service answer PIM questions for LLM
inference traffic.

Conventions (DESIGN.md Section 15):

* **Phases.** ``prefill`` lowers seq x seq attention (score/context
  matmuls head-folded exactly like ``describe_bert``); ``decode`` lowers
  one q_len=1 step against a KV length ``kv_len`` — decode shapes depend
  on ``kv_len`` only, never on any prefill sequence length.
* **Tranches.** A model's ``n_layers`` identical blocks would multiply
  search cost for zero information (every block is the same subproblem),
  so one block is lowered per *tranche* of identical layers: dense/MoE/
  SSM models lower one block, hybrids (zamba2) lower one SSM block plus
  the shared attention block, whisper lowers the conv stem + one encoder
  + one decoder block. ``blocks=N`` chains N copies of the repeating
  tranche for inter-block overlap studies. Whole-model totals scale the
  per-block result by the block count (``run.py workloads`` prints both).
* **Exclusions.** Elementwise work is not lowered: norms, softmax,
  rotary embedding, activation functions, the router's top-k
  gate/select, depthwise causal convs (per-channel, MAC-free in the 7D
  sense), residual adds, and the embedding/unembed lookups that sit
  outside the lowered block. ``sum(l.macs)`` over a lowered block is
  therefore exactly the block's projection/attention/expert/scan matmul
  FLOPs — pinned by the golden accounting tests.
* **Edges.** Affine tile-to-tile reuse keeps the exact coordinate maps
  (``IdentityMap``, ``HeadFoldMap``/``HeadUnfoldMap``, grouped
  ``WeightMap`` for GQA); structure-free mappings (MoE dispatch/combine,
  KV-cache appends, SSD inter-chunk state, token<->spatial flattens) use
  the conservative ``FullMap`` (consumer waits for the producer's whole
  output) — correct, just overlap-pessimistic, and documented per edge
  below.
"""
from __future__ import annotations

import math
from typing import List, Optional, Sequence, Tuple

from ..core.overlap import (Edge, FullMap, HeadFoldMap, HeadUnfoldMap,
                            IdentityMap, WeightMap)
from ..core.workload import LayerSpec, conv, matmul
from ..models.common import ModelConfig

PHASES = ("prefill", "decode")

#: producer reference a block hands to its consumer: (layer index, how the
#: consumer's entry layers should read it — "identity" for token-aligned
#: outputs, "full" for scatter/gather-shaped ones)
Producer = Tuple[int, str]


def _edge(idx: int, kind: str) -> Edge:
    return Edge(idx, IdentityMap() if kind == "identity" else FullMap())


class NetBuilder:
    """Accumulates (layers, edges) while lowering; producers are always
    appended before their consumers, so edges can only point backward."""

    def __init__(self):
        self.layers: List[LayerSpec] = []
        self.edges: List[List[Edge]] = []

    def add(self, layer: LayerSpec, deps: Sequence[Edge] = ()) -> int:
        """Append one layer with its dependency edges; returns its index."""
        for e in deps:
            assert 0 <= e.producer < len(self.layers), e.producer
        self.layers.append(layer)
        self.edges.append(list(deps))
        return len(self.layers) - 1


def moe_capacity(cfg: ModelConfig, tokens: int) -> int:
    """Per-expert slot count of the capacity-view dispatch: each of the
    ``n_experts`` experts processes ``ceil(T/moe_shards * top_k/E *
    capacity_factor)`` tokens (the GShard einsum-dispatch shape the model
    code ablates against), never fewer than one."""
    per_shard = tokens / max(cfg.moe_shards, 1)
    cap = math.ceil(per_shard * cfg.top_k / cfg.n_experts
                    * cfg.capacity_factor)
    return max(1, cap)


def _ffn(b: NetBuilder, cfg: ModelConfig, inputs: Sequence[Producer],
         prefix: str, tokens: int, d_in: int, d_ff: int) -> List[Producer]:
    """One MLP: swiglu = gate/up in parallel + down consuming both (the
    elementwise gate multiply is excluded); gelu = ffn1 -> ffn2."""
    deps = [_edge(i, k) for i, k in inputs]
    if cfg.mlp == "swiglu":
        gate = b.add(matmul(f"{prefix}ffn_gate", tokens, d_in, d_ff), deps)
        up = b.add(matmul(f"{prefix}ffn_up", tokens, d_in, d_ff), deps)
        down = b.add(matmul(f"{prefix}ffn_down", tokens, d_ff, d_in),
                     [Edge(gate, IdentityMap()), Edge(up, IdentityMap())])
    else:
        f1 = b.add(matmul(f"{prefix}ffn1", tokens, d_in, d_ff), deps)
        down = b.add(matmul(f"{prefix}ffn2", tokens, d_ff, d_in),
                     [Edge(f1, IdentityMap())])
    return [(down, "identity")]


def _attention(b: NetBuilder, cfg: ModelConfig, inputs: Sequence[Producer],
               prefix: str, q_len: int, kv_len: int,
               kv_inputs: Optional[Sequence[Producer]] = None
               ) -> List[Producer]:
    """One (self or cross) attention sublayer, GQA-aware.

    * prefill self-attention (``q_len == kv_len``, ``kv_inputs is
      None``): the bert wiring generalized — QK reads Q through
      ``HeadFoldMap`` and K-proj as its stationary operand through a
      ``group``ed ``WeightMap``; AV likewise for V.
    * decode self-attention (``q_len == 1``): K/V projections produce
      only the newly appended token, the rest of the KV cache predates
      the request (ready at t=0) — so QK/AV depend on the fresh K/V via
      ``FullMap`` (wait for the one-token projection) and on Q/scores
      via the exact maps.
    * cross-attention (``kv_inputs`` set — whisper): K/V project the
      encoder output, exact ``WeightMap`` edges at ``kv_len`` columns.
    """
    h, kvh, hd = cfg.n_heads, max(cfg.n_kv_heads, 1), cfg.hd
    group = max(1, h // kvh)
    deps = [_edge(i, k) for i, k in inputs]
    q = b.add(matmul(f"{prefix}q_proj", q_len, cfg.d_model, h * hd), deps)
    kv_deps = ([_edge(i, k) for i, k in kv_inputs]
               if kv_inputs is not None else deps)
    kv_tokens = kv_len if kv_inputs is not None else q_len
    k = b.add(matmul(f"{prefix}k_proj", kv_tokens, cfg.d_model, kvh * hd),
              kv_deps)
    v = b.add(matmul(f"{prefix}v_proj", kv_tokens, cfg.d_model, kvh * hd),
              kv_deps)
    decode_cache = kv_inputs is None and q_len == 1 and kv_len > q_len
    if decode_cache:
        k_edge = Edge(k, FullMap())      # cache append: wait for new K
        v_edge = Edge(v, FullMap())
    else:
        k_edge = Edge(k, WeightMap(q_len, hd, "qk_weight", group))
        v_edge = Edge(v, WeightMap(q_len, hd, "av_weight", group))
    qk = b.add(matmul(f"{prefix}qk", q_len, hd, kv_len, batch=h),
               [Edge(q, HeadFoldMap(q_len, hd)), k_edge])
    av = b.add(matmul(f"{prefix}av", q_len, kv_len, hd, batch=h),
               [Edge(qk, IdentityMap()), v_edge])
    out = b.add(matmul(f"{prefix}out_proj", q_len, h * hd, cfg.d_model),
                [Edge(av, HeadUnfoldMap(q_len, hd))])
    return [(out, "identity")]


def _dense_block(b: NetBuilder, cfg: ModelConfig,
                 inputs: Sequence[Producer], prefix: str,
                 q_len: int, kv_len: int) -> List[Producer]:
    """Attention + MLP — the dense/vlm decoder block (and zamba2's shared
    attention block)."""
    attn = _attention(b, cfg, inputs, prefix, q_len, kv_len)
    return _ffn(b, cfg, attn, prefix, q_len, cfg.d_model, cfg.d_ff)


def _moe_block(b: NetBuilder, cfg: ModelConfig,
               inputs: Sequence[Producer], prefix: str,
               q_len: int, kv_len: int) -> List[Producer]:
    """Attention + router + shared experts + top-k routed expert fan-out.

    The router is a plain ``tokens x d_model x n_experts`` matmul (its
    softmax/top-k select is elementwise, excluded). Shared experts see
    every token in order (exact identity edges); each of the
    ``n_experts`` routed experts is lowered at its ``moe_capacity`` slot
    count with ``FullMap`` fan-out edges from both the router (dispatch
    waits on routing values) and the attention output (token gather).
    The combine is a scatter-add, so expert outputs re-enter downstream
    consumers as ``full`` producers (fan-in)."""
    attn = _attention(b, cfg, inputs, prefix, q_len, kv_len)
    attn_deps = [_edge(i, k) for i, k in attn]
    router = b.add(matmul(f"{prefix}router", q_len, cfg.d_model,
                          cfg.n_experts), attn_deps)
    outs: List[Producer] = []
    for s in range(cfg.n_shared_experts):
        outs += _ffn(b, cfg, attn, f"{prefix}shared{s}.", q_len,
                     cfg.d_model, cfg.d_ff)
    cap = moe_capacity(cfg, q_len)
    fan_out: List[Producer] = [(router, "full")] + \
        [(i, "full") for i, _ in attn]
    for e in range(cfg.n_experts):
        (down, _), = _ffn(b, cfg, fan_out, f"{prefix}exp{e}.", cap,
                          cfg.d_model, cfg.d_ff)
        outs.append((down, "full"))
    return outs


def _ssd_block(b: NetBuilder, cfg: ModelConfig,
               inputs: Sequence[Producer], prefix: str,
               phase: str, tokens: int) -> List[Producer]:
    """Mamba-2 SSD block as its matmul skeleton (``models/ssm.py``).

    Prefill lowers the chunked dual: five input projections (z/x/B/C/dt
    are separate matmuls in the model too), the intra-chunk score matmul
    ``C B^T`` and its application to x, the chunk-state contraction
    ``B^T (dt x)`` and the inter-chunk state readout ``C . state`` —
    each batched over ``n_chunks * ssm_heads`` (B/C are materialized
    per-head by the reference scan). Depthwise convs / cumsum decays /
    the z-gate are elementwise, excluded. Decode is the O(1) recurrence:
    projections at one token, the ``B x^T`` state outer product and the
    ``C . state`` readout. Reshapes between token space and (chunk,
    head) space are not affine in 7D, so intra-block edges past the
    score->apply identity are conservative ``FullMap``s."""
    d, di = cfg.d_model, cfg.d_inner
    h, p = cfg.ssm_heads, cfg.ssm_head_dim
    g, n = cfg.ssm_groups, cfg.ssm_state
    deps = [_edge(i, k) for i, k in inputs]
    z = b.add(matmul(f"{prefix}z_proj", tokens, d, di), deps)
    x = b.add(matmul(f"{prefix}x_proj", tokens, d, di), deps)
    bp = b.add(matmul(f"{prefix}b_proj", tokens, d, g * n), deps)
    cp = b.add(matmul(f"{prefix}c_proj", tokens, d, g * n), deps)
    dt = b.add(matmul(f"{prefix}dt_proj", tokens, d, h), deps)
    if phase == "prefill":
        c = min(cfg.ssm_chunk, tokens)
        nc = math.ceil(tokens / c)
        scores = b.add(matmul(f"{prefix}ssd_scores", c, n, c, batch=nc * h),
                       [Edge(cp, FullMap()), Edge(bp, FullMap()),
                        Edge(dt, FullMap())])
        y_diag = b.add(matmul(f"{prefix}ssd_ydiag", c, c, p, batch=nc * h),
                       [Edge(scores, IdentityMap()), Edge(x, FullMap())])
        states = b.add(matmul(f"{prefix}ssd_state", n, c, p, batch=nc * h),
                       [Edge(bp, FullMap()), Edge(x, FullMap()),
                        Edge(dt, FullMap())])
        y_off = b.add(matmul(f"{prefix}ssd_yoff", c, n, p, batch=nc * h),
                      [Edge(cp, FullMap()), Edge(states, FullMap())])
        out = b.add(matmul(f"{prefix}out_proj", tokens, di, d),
                    [Edge(y_diag, FullMap()), Edge(y_off, FullMap()),
                     Edge(z, FullMap())])
    else:
        upd = b.add(matmul(f"{prefix}ssd_state", n, 1, p, batch=h),
                    [Edge(bp, FullMap()), Edge(x, FullMap()),
                     Edge(dt, FullMap())])
        y = b.add(matmul(f"{prefix}ssd_y", 1, n, p, batch=h),
                  [Edge(cp, FullMap()), Edge(upd, FullMap())])
        out = b.add(matmul(f"{prefix}out_proj", 1, di, d),
                    [Edge(y, FullMap()), Edge(z, FullMap())])
    return [(out, "identity")]


def _whisper_frontend(b: NetBuilder, cfg: ModelConfig) -> List[Producer]:
    """Whisper conv stem: two 1D convs over the mel features (80 bins ->
    d_model channels, stride 2 halves 2*enc_frames mel frames down to
    enc_frames encoder positions), lowered as Q=1 conv ``LayerSpec``s
    chained with exact identity edges (1D conv output channel/position
    align with the encoder matmuls' C/P — ``chain_edges`` semantics)."""
    frames = 2 * cfg.enc_frames
    c1 = b.add(LayerSpec("stem.conv1", K=cfg.d_model, C=80, P=frames, Q=1,
                         R=3, S=1, pad=1))
    c2 = b.add(LayerSpec("stem.conv2", K=cfg.d_model, C=cfg.d_model,
                         P=cfg.enc_frames, Q=1, R=3, S=1, stride=2, pad=1),
               [Edge(c1, IdentityMap())])
    return [(c2, "identity")]


def _vision_frontend(b: NetBuilder, cfg: ModelConfig) -> List[Producer]:
    """LLaVA vision tower stub: a 14x14/stride-14 patch-embed conv over
    the image grid (square when ``img_tokens`` is a perfect square, else
    a 1D strip) plus the multimodal projector matmul. The spatial->token
    flatten between them is not affine in 7D -> ``FullMap``."""
    gh = math.isqrt(cfg.img_tokens)
    gh, gw = (gh, gh) if gh * gh == cfg.img_tokens else (cfg.img_tokens, 1)
    patch = b.add(LayerSpec("vision.patch_embed", K=cfg.d_model, C=3,
                            P=gh, Q=gw, R=14, S=14, stride=14))
    proj = b.add(matmul("vision.projector", cfg.img_tokens, cfg.d_model,
                        cfg.d_model), [Edge(patch, FullMap())])
    return [(proj, "full")]


def _audio_net(b: NetBuilder, cfg: ModelConfig, phase: str,
               seq: int, kv_len: int, blocks: int) -> None:
    """Whisper: prefill = conv stem -> encoder block -> cross-K/V
    projections -> decoder block(s) (self + cross attention + MLP);
    decode = one decoder step whose cross K/V come from the primed
    cache (no producer -> ready at t=0)."""
    f = cfg.enc_frames
    cross_kv: Optional[List[Producer]] = None
    if phase == "prefill":
        stem = _whisper_frontend(b, cfg)
        enc_attn = _attention(b, cfg, stem, "enc.", f, f)
        enc = _ffn(b, cfg, enc_attn, "enc.", f, cfg.d_model, cfg.d_ff)
        cross_kv = enc
    q_len = seq if phase == "prefill" else 1
    inputs: List[Producer] = []
    for i in range(blocks):
        pre = f"dec{i}." if blocks > 1 else "dec."
        self_out = _attention(b, cfg, inputs, pre + "self.", q_len,
                              q_len if phase == "prefill" else kv_len)
        if cross_kv is not None:
            cross_out = _attention(b, cfg, self_out, pre + "cross.",
                                   q_len, f, kv_inputs=cross_kv)
        else:
            # decode: cross K/V are cached — q-only edges, kv at t=0
            cq = b.add(matmul(pre + "cross.q_proj", q_len, cfg.d_model,
                              cfg.n_heads * cfg.hd),
                       [_edge(j, k) for j, k in self_out])
            qk = b.add(matmul(pre + "cross.qk", q_len, cfg.hd, f,
                              batch=cfg.n_heads),
                       [Edge(cq, HeadFoldMap(q_len, cfg.hd))])
            av = b.add(matmul(pre + "cross.av", q_len, f, cfg.hd,
                              batch=cfg.n_heads),
                       [Edge(qk, IdentityMap())])
            out = b.add(matmul(pre + "cross.out_proj", q_len,
                               cfg.n_heads * cfg.hd, cfg.d_model),
                        [Edge(av, HeadUnfoldMap(q_len, cfg.hd))])
            cross_out = [(out, "identity")]
        inputs = _ffn(b, cfg, cross_out, pre, q_len, cfg.d_model, cfg.d_ff)


def lower(cfg: ModelConfig, phase: str = "prefill", seq: int = 2048,
          kv_len: int = 1024, blocks: int = 1
          ) -> Tuple[List[LayerSpec], List[List[Edge]]]:
    """Lower ``blocks`` tranche blocks of ``cfg`` into (layers, edges).

    ``phase="prefill"`` uses ``seq`` (the prompt length); ``phase=
    "decode"`` uses ``kv_len`` (the context the step attends over) and
    is independent of ``seq`` by construction. Families: ``dense``/
    ``vlm`` -> attention+MLP blocks (vlm prefill prepends the vision
    frontend and its ``img_tokens``), ``moe`` -> attention + shared/
    routed expert fan-out, ``ssm`` -> SSD skeleton, ``hybrid`` -> one
    SSD block + the shared attention block per tranche, ``audio`` ->
    whisper stem/encoder/decoder."""
    if phase not in PHASES:
        raise ValueError(f"phase must be one of {PHASES}, got {phase!r}")
    if seq < 1 or kv_len < 1 or blocks < 1:
        raise ValueError(f"seq/kv_len/blocks must be >= 1, got "
                         f"{seq}/{kv_len}/{blocks}")
    b = NetBuilder()
    fam = cfg.family
    if fam == "audio":
        _audio_net(b, cfg, phase, seq, kv_len, blocks)
        return b.layers, b.edges
    inputs: List[Producer] = []
    if fam == "vlm" and phase == "prefill":
        inputs = _vision_frontend(b, cfg)
        seq = seq + cfg.img_tokens   # image tokens prepend the prompt
    q_len, kv = (seq, seq) if phase == "prefill" else (1, kv_len)
    for i in range(blocks):
        pre = f"b{i}." if blocks > 1 else ""
        if fam == "moe":
            inputs = _moe_block(b, cfg, inputs, pre, q_len, kv)
        elif fam == "ssm":
            inputs = _ssd_block(b, cfg, inputs, pre, phase, q_len)
        elif fam == "hybrid":
            inputs = _ssd_block(b, cfg, inputs, pre + "ssm.", phase, q_len)
            inputs = _dense_block(b, cfg, inputs, pre + "attn.", q_len, kv)
        else:                        # dense, vlm
            inputs = _dense_block(b, cfg, inputs, pre, q_len, kv)
    return b.layers, b.edges

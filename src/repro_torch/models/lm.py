"""Decoder-only language models: dense, moe, ssm, hybrid and vlm families.

PyTorch counterpart of ``repro.models.lm``: dense is GQA attention with
RoPE, RMSNorm or non-parametric LayerNorm, SwiGLU or GELU; vlm is the
dense stack with stub image embeddings prepended (``forward``'s
``extra_embeds``; prefill and decode take tokens only); moe replaces
the MLP with top-k routed experts (``mlp.moe``), whose load-balancing
aux loss the forward sums over the layers in fp32; ssm is Mamba-2
(``ssm``); the hybrid (Zamba-2) adds ONE shared attention+MLP block
(shared weights) applied after every ``attn_every``-th Mamba-2 layer,
with one KV-cache slot per invocation. Per-layer parameters are
stacked on a leading layer axis, as in the reference, and applied by a
Python loop over the layers. The audio family is ``encdec``'s.

An moe config with ``first_dense_layers`` (DeepSeekMoE) runs that many
leading layers with a dense MLP of width ``dense_d_ff`` and the MoE
after them. Its layers differ, so their feed-forward weights are stacked
apart: ``layers`` holds every layer's attention and norms, ``dense_layers``
the leading layers' ``mlp`` and ``moe_layers`` the others' ``moe``
(``_per_layer`` puts each layer's tree together).

A hybrid config with ``layer_types`` (Granite 4.0-H) runs a typed
layout instead of Zamba-2's: layer i's mixer is a Mamba-2 layer or
attention as ``layer_types[i]`` says, and every layer's feed-forward
(the MoE, or the MLP where the config has no experts) follows it.
``layers`` holds every layer's mixer norm, ``ffn_norm`` and
feed-forward; ``mamba_layers`` the Mamba-2 layers' ``ssm`` and
``attn_layers`` the attention layers' ``attn``; the cache holds Mamba-2
state for the Mamba-2 layers alone and KV for the attention layers
alone, under one ``pos``. Every family's walk dispatches on the layer's
own tree (``_per_layer`` names a typed layer's mixer norm ``ssm_norm``
or ``attn_norm``). The µP multipliers (``embedding_multiplier``,
``residual_multiplier``, ``logits_scaling``) apply in ``_embed``, every
residual branch (``_scaled``) and ``_unembed``; each is skipped at its
default of 1, so the other configs compute what they always have.

Training: ``loss_fn`` is the reference's next-token cross entropy.
When autograd records, ``forward`` recomputes each layer in the backward
(``torch.utils.checkpoint``, non-reentrant), the counterpart of the
reference's ``jax.checkpoint`` over its scan body. ``cfg.remat_policy``
maps as follows (``_remat``); the three give the same loss and
gradients:
  - ``"full"``: the whole layer is recomputed; only its input is kept
    (``jax.checkpoint`` with no policy).
  - ``"dots"``: the layer is recomputed except the outputs of 2-D
    matrix products (``aten.mm``/``aten.addmm``: the projections), which
    are kept (``dots_with_no_batch_dims_saveable``). On the card the
    fused MLP is a kernel launch, not an ``aten`` product, and is
    recomputed.
  - ``"mlp"``: the residual sublayers other than the MLP (attention,
    Mamba-2) are recomputed; each MLP keeps what its backward needs (its
    input), so it is not run again in the recompute (the reference keeps
    the MLP's hidden ``h``, ``save_only_these_names("mlp_hidden")``). In
    an MoE layer only the shared expert is such an MLP: the router and
    the routed experts are recomputed, as the reference names no hidden
    of theirs.
The MoE sublayer's aux loss is an output of the recomputed function, so
its gradient reaches the router under every policy.

Spans (``launch.spans``): each layer's sublayers run in
``model.attention``, ``model.mlp``, ``model.moe`` or ``model.ssm``
in ``forward``, ``prefill`` and ``decode_step``, the final norm and
unembedding in ``model.unembed``, and a checkpointed function run again
inside a backward (the recompute) in ``trainer.recompute``.
"""
from __future__ import annotations

import functools
from typing import Any, Callable, Dict, List, Tuple

import torch
from torch.utils.checkpoint import (checkpoint,
                                    create_selective_checkpoint_contexts)

from ..launch.spans import span
from . import parallel
from .attention import (attention, decode_attention, init_attn,
                        init_kv_cache, init_pos, prefill_into_cache)
from .common import (ModelConfig, apply_norm, dense_init, meta_generator,
                     torch_dtype, tree_get, tree_leaves, tree_map)
from .mlp import init_mlp, init_moe, mlp, moe
from .ssm import init_mamba2, init_ssm_cache, mamba2_block, mamba2_decode, \
    mamba2_prefill

PyTree = Any

def layer_params(layers: PyTree, i: int) -> PyTree:
    """Views of layer ``i`` of a layer-stacked tree (no copy)."""
    return tree_map(lambda _, t: t[i], layers)


def _stacked(tree: PyTree, n: int, batch: int) -> PyTree:
    """A tree allocated with batch ``n * batch`` viewed as [n, batch, ...]
    (one allocation for all layers)."""
    return tree_map(lambda _, t: t.view(n, batch, *t.shape[1:]), tree)


def _shared_fires(cfg: ModelConfig, shared, idx: int) -> bool:
    """Whether the hybrid's shared block runs after layer ``idx``."""
    return (shared is not None and cfg.attn_every > 0
            and idx % cfg.attn_every == cfg.attn_every - 1)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

FAMILIES = ("dense", "moe", "vlm", "ssm", "hybrid")
# the typed layout's layer types and their mixers' stacks (module
# docstring)
MIXER_STACKS = {"mamba": "mamba_layers", "attention": "attn_layers"}
LAYER_TYPES = tuple(MIXER_STACKS)


def _check_layout(cfg: ModelConfig):
    if cfg.family not in FAMILIES:
        raise ValueError(f"{cfg.arch_id}: family {cfg.family!r} is not a "
                         f"decoder-only LM ({FAMILIES})")
    types = cfg.layer_types
    if types and (cfg.family != "hybrid" or len(types) != cfg.n_layers
                  or not set(types) <= set(LAYER_TYPES) or cfg.attn_every
                  or cfg.first_dense_layers):
        raise ValueError(f"{cfg.arch_id}: layer_types needs the hybrid "
                         f"family, one of {LAYER_TYPES} for each of the "
                         f"{cfg.n_layers} layers, and neither attn_every "
                         f"nor first_dense_layers")
    bad = cfg.published_mismatches()
    if bad:
        raise ValueError(f"{cfg.arch_id}: the published keys disagree with "
                         f"what the port runs: {'; '.join(bad)}")
    nd = cfg.first_dense_layers
    if nd and (cfg.family != "moe" or not 0 < nd < cfg.n_layers
               or cfg.dense_d_ff <= 0):
        raise ValueError(f"{cfg.arch_id}: first_dense_layers {nd} needs the "
                         f"moe family, fewer layers than n_layers "
                         f"{cfg.n_layers} and dense_d_ff > 0")
    if not 0 <= cfg.experts_held <= cfg.n_experts:
        raise ValueError(f"{cfg.arch_id}: {cfg.experts_held} experts held "
                         f"of {cfg.n_experts}")


def _init_layer(cfg: ModelConfig, gen: torch.Generator, dtype,
                ffn: bool = True) -> Dict:
    """One layer's weights; without ``ffn``, its attention and norms only
    (the leading-dense layout draws the feed-forwards apart)."""
    def ones():
        return torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)

    if cfg.layer_types:
        p = {"mixer_norm": ones(), "ffn_norm": ones()}
    elif cfg.is_ssm_family:
        return {"ssm_norm": ones(), "ssm": init_mamba2(cfg, gen, dtype=dtype)}
    else:
        p = {"attn_norm": ones(), "attn": init_attn(cfg, gen, dtype=dtype),
             "ffn_norm": ones()}
    if not ffn:
        return p
    if cfg.family == "moe" or (cfg.layer_types and cfg.n_experts):
        p["moe"] = init_moe(cfg, gen, dtype=dtype)
    else:
        p["mlp"] = init_mlp(cfg, gen, dtype=dtype)
    return p


def _per_layer(cfg: ModelConfig, params: PyTree,
               views: Callable[[PyTree, int], List[PyTree]]) -> List[PyTree]:
    """Each layer's tree, ``views(stack, n)`` giving the ``n`` layers of a
    layer-stacked tree; in the leading-dense layout (module docstring)
    each layer's attention and norms joined with its ``mlp`` or ``moe``;
    in the typed layout each layer's norms and feed-forward joined with
    its mixer, the mixer norm named as the mixer's family names it."""
    layers = views(params["layers"], cfg.n_layers)
    if cfg.layer_types:
        mixers = {t: iter(views(params[MIXER_STACKS[t]],
                                cfg.layer_types.count(t)))
                  for t in set(cfg.layer_types)}
        out = []
        for lp, t in zip(layers, cfg.layer_types):
            norm = "ssm_norm" if t == "mamba" else "attn_norm"
            out.append({**{k: v for k, v in lp.items() if k != "mixer_norm"},
                        norm: lp["mixer_norm"], **next(mixers[t])})
        return out
    nd = cfg.first_dense_layers
    if not nd:
        return layers
    ffns = (views(params["dense_layers"], nd)
            + views(params["moe_layers"], cfg.n_layers - nd))
    return [{**a, **f} for a, f in zip(layers, ffns)]


def _cache_slots(cfg: ModelConfig) -> List[Tuple[str, int]]:
    """(cache entry, index in it) of each layer's state: its own slot of
    ``layers``; in the typed layout a Mamba-2 layer's slot of ``layers``
    and an attention layer's of ``attn``, in layer order."""
    if not cfg.layer_types:
        return [("layers", i) for i in range(cfg.n_layers)]
    seen = {t: 0 for t in LAYER_TYPES}
    out = []
    for t in cfg.layer_types:
        out.append(("layers" if t == "mamba" else "attn", seen[t]))
        seen[t] += 1
    return out


def _layer_views(stack: PyTree, n: int) -> List[PyTree]:
    return [layer_params(stack, i) for i in range(n)]


def _ffn(cfg: ModelConfig, lp: Dict, h):
    """The layer's feed-forward on normed ``h``: the MLP, or the MoE
    without its aux loss (prefill and decode drop it)."""
    if "moe" in lp:
        return moe(cfg, lp["moe"], h)[0]
    return mlp(cfg, lp["mlp"], h)


def _ffn_span(lp: Dict) -> str:
    return "model.moe" if "moe" in lp else "model.mlp"


def draw_layers(n: int, draw: Callable[[], Dict]) -> PyTree:
    """``n`` layers, each drawn by ``draw()``, stacked on a leading layer
    axis. Each layer is copied into the stacked tensors as it is drawn,
    so the draws' float32 temporaries stay one layer in size."""
    layers = None
    for i in range(n):
        lp = draw()
        if layers is None:
            layers = tree_map(lambda _, t: t.new_empty((n, *t.shape)), lp)
        tree_map(lambda path, t: tree_get(layers, path)[i].copy_(t), lp)
    return layers


def init_params(cfg: ModelConfig, gen: torch.Generator) -> PyTree:
    """Random parameters on the generator's device, layers drawn one at a
    time (``draw_layers``)."""
    _check_layout(cfg)
    dtype = torch_dtype(cfg.param_dtype)
    nd = cfg.first_dense_layers
    params = {
        "embed": dense_init(gen, cfg.padded_vocab, cfg.d_model, dtype,
                            scale=1.0),
        "unembed": dense_init(gen, cfg.d_model, cfg.padded_vocab, dtype),
        "final_norm": torch.ones((cfg.d_model,), dtype=torch.float32,
                                 device=gen.device),
        "layers": draw_layers(cfg.n_layers,
                              lambda: _init_layer(cfg, gen, dtype, not nd)),
    }
    if nd:
        params["dense_layers"] = draw_layers(nd, lambda: {"mlp": init_mlp(
            cfg, gen, d_ff=cfg.dense_d_ff, dtype=dtype)})
        params["moe_layers"] = draw_layers(
            cfg.n_layers - nd, lambda: {"moe": init_moe(cfg, gen, dtype)})
    mixers = {"mamba": lambda: {"ssm": init_mamba2(cfg, gen, dtype=dtype)},
              "attention": lambda: {"attn": init_attn(cfg, gen, dtype=dtype)}}
    for t, stack in MIXER_STACKS.items():
        if t in cfg.layer_types:
            params[stack] = draw_layers(cfg.layer_types.count(t), mixers[t])
    if cfg.family == "hybrid" and cfg.attn_every:
        ones = torch.ones((cfg.d_model,), dtype=torch.float32,
                          device=gen.device)
        params["shared_attn"] = {
            "norm": ones, "attn": init_attn(cfg, gen, dtype=dtype),
            "mlp_norm": ones.clone(), "mlp": init_mlp(cfg, gen, dtype=dtype)}
    return params


def param_shapes(cfg: ModelConfig) -> PyTree:
    """The parameter tree on the meta device: shapes and dtypes, nothing
    allocated or drawn (the dry-run's and the sharded trainer's input)."""
    return init_params(cfg, meta_generator())


# ---------------------------------------------------------------------------
# Forward (scoring)
# ---------------------------------------------------------------------------

def _vocab_mask(cfg: ModelConfig, logits):
    if cfg.padded_vocab == cfg.vocab:
        return logits
    mask = torch.arange(cfg.padded_vocab, device=logits.device) < cfg.vocab
    return logits.masked_fill(~parallel.replicate_like(mask, logits), -1e9)


def _embed(cfg: ModelConfig, params: PyTree, tokens):
    """Token embeddings in the compute dtype; on a mesh, with the tokens'
    batch sharding, replicated over "model"."""
    x = parallel.to_batch(parallel.gather_rows(params["embed"],
                                               tokens.long()))
    x = x.to(torch_dtype(cfg.compute_dtype))
    if cfg.embedding_multiplier != 1:
        x = x * cfg.embedding_multiplier
    return x


def _unembed(cfg: ModelConfig, params: PyTree, x):
    with span("model.unembed"):
        x = apply_norm(cfg, x, params["final_norm"])
        logits = x @ params["unembed"].to(x.dtype)
        if cfg.logits_scaling != 1:
            logits = logits / cfg.logits_scaling
        return _vocab_mask(cfg, logits)


def _scaled(cfg: ModelConfig, y):
    """A residual branch's output times ``residual_multiplier`` (as it is
    at the default 1)."""
    if cfg.residual_multiplier == 1:
        return y
    return y * cfg.residual_multiplier


def _shared_attn_apply(cfg: ModelConfig, shared: Dict, x, attend):
    """The hybrid's shared block: x + attend(norm(x)), then its MLP.
    ``attend`` is the pass's attention on the shared weights (full,
    prefill into a KV slot, or one decode step)."""
    with span("model.attention"):
        h = apply_norm(cfg, x, shared["norm"])
        x = x + parallel.like(_scaled(cfg, attend(h)), x)
    with span("model.mlp"):
        h = apply_norm(cfg, x, shared["mlp_norm"])
        return x + parallel.like(_scaled(cfg, mlp(cfg, shared["mlp"], h)), x)


# A residual sublayer: (kind, fn). ``kind`` is "mlp" (a dense MLP), "moe"
# (fn(x, split) -> (x, aux); ``split`` recomputes only its routed half) or
# "mix" (attention, Mamba-2); fn(x) -> x + f(norm(x)).
Sublayer = Tuple[str, Callable]


def _moe_sublayer(cfg: ModelConfig, norm, p: Dict) -> Sublayer:
    routed = {k: v for k, v in p.items() if k != "shared"}

    def fn(x, split=False):
        with span("model.moe"):
            h = apply_norm(cfg, x, norm)
            if not split:
                y, aux = moe(cfg, p, h)
                return x + _scaled(cfg, y), aux
            # "mlp" remat: the router and routed experts are recomputed,
            # the shared expert (an MLP) is not
            y, aux = checkpoint(_recomputed, functools.partial(
                moe, cfg, routed), h, use_reentrant=False)
            if "shared" in p:
                y = y + parallel.like(mlp(cfg, p["shared"], h), y)
            return x + _scaled(cfg, y), aux
    return "moe", fn


def residual(cfg: ModelConfig, norm, fn, name: str) -> Callable:
    """The residual sublayer x -> x + fn(norm(x)), in the span ``name``; on
    a mesh, fn's output is reduced to x's placements before the add."""
    def run(x):
        with span(name):
            y = _scaled(cfg, fn(apply_norm(cfg, x, norm)))
            return x + parallel.like(y, x)
    return run


def _sublayers(cfg: ModelConfig, lp: Dict, shared, idx: int
               ) -> List[Sublayer]:
    """Layer ``idx`` of ``forward`` as its residual sublayers, in order:
    its mixer (Mamba-2, with the hybrid's shared block where it fires, or
    attention), then its feed-forward, if it has one."""
    if "ssm" in lp:
        subs = [("mix", residual(cfg, lp["ssm_norm"], lambda h: mamba2_block(
            cfg, lp["ssm"], h), "model.ssm"))]
        if _shared_fires(cfg, shared, idx):
            subs += [("mix", residual(cfg, shared["norm"], lambda h: attention(
                cfg, shared["attn"], h, causal=True), "model.attention")),
                ("mlp", residual(cfg, shared["mlp_norm"], lambda h: mlp(
                    cfg, shared["mlp"], h), "model.mlp"))]
    else:
        subs = [("mix", residual(cfg, lp["attn_norm"], lambda h: attention(
            cfg, lp["attn"], h, causal=True), "model.attention"))]
    if "moe" in lp:
        subs.append(_moe_sublayer(cfg, lp["ffn_norm"], lp["moe"]))
    elif "mlp" in lp:
        subs.append(("mlp", residual(cfg, lp["ffn_norm"], lambda h: mlp(
            cfg, lp["mlp"], h), "model.mlp")))
    return subs


def _run(subs: List[Sublayer], x, mlp_policy: bool = False):
    """Apply the sublayers in order -> (x, [aux of each MoE sublayer]).
    Under ``mlp_policy`` (remat "mlp") the "mix" sublayers and the routed
    experts are checkpointed."""
    aux = []
    for kind, fn in subs:
        if kind == "moe":
            x, a = fn(x, mlp_policy)
            aux.append(a)
        elif kind == "mix" and mlp_policy:
            x = checkpoint(_recomputed, fn, x, use_reentrant=False)
        else:
            x = fn(x)
    return x, aux


def _recomputed(fn, *args):
    """``fn(*args)``, checkpointed: run again inside a backward (the
    recompute), it runs in the span ``trainer.recompute``."""
    if torch._C._current_graph_task_id() == -1:
        return fn(*args)
    with span("trainer.recompute"):
        return fn(*args)


# outputs the "dots" policy keeps: 2-D matrix products (no batch dims)
_DOTS = [torch.ops.aten.mm.default, torch.ops.aten.addmm.default]


def _remat(policy: str, subs: List[Sublayer], x):
    """Run one layer's sublayers under ``policy`` (module docstring) ->
    (x, [aux])."""
    if policy == "full":
        return checkpoint(_recomputed, _run, subs, x, use_reentrant=False)
    if policy == "dots":
        return checkpoint(_recomputed, _run, subs, x, use_reentrant=False,
                          context_fn=functools.partial(
                              create_selective_checkpoint_contexts, _DOTS))
    if policy == "mlp":
        return _run(subs, x, mlp_policy=True)
    raise ValueError(f"unknown remat_policy {policy!r}; have 'full', "
                     "'dots', 'mlp'")


def _unstacked(layers: PyTree, n: int) -> List[PyTree]:
    """The layer-stacked tree as ``n`` per-layer trees of views. Through
    ``unbind``, one backward node per leaf stacks the layers' gradients
    (indexing each layer would scatter each into a full-size zero
    tensor)."""
    flat = tree_map(lambda _, t: t.unbind(0), layers)
    return [tree_map(lambda _, ts: ts[i], flat) for i in range(n)]


def param_requires_grad(params: PyTree) -> bool:
    """Whether autograd records through ``params`` (then each layer is
    recomputed in the backward)."""
    return torch.is_grad_enabled() and any(
        t.requires_grad for t in tree_leaves(params))


def forward(cfg: ModelConfig, params: PyTree, tokens,
            extra_embeds=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """tokens [B,S] -> (logits [B,S,Vp], aux_loss scalar fp32: the MoE
    layers' load-balancing terms summed in layer order, 0 for the other
    families). ``extra_embeds`` [B,S_img,D] (the vlm's stub image
    embeddings) are cast to the compute dtype and prepended; their
    positions are dropped before the unembedding, so the logits are the
    reference's with those rows sliced off. Each layer is recomputed in
    the backward when autograd records (``_remat``)."""
    remat = param_requires_grad(params)
    x = _embed(cfg, params, tokens)
    n_extra = 0
    if extra_embeds is not None:
        n_extra = extra_embeds.shape[1]
        x = torch.cat([extra_embeds.to(x.dtype), x], dim=1)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    shared = params.get("shared_attn")
    for i, lp in enumerate(_per_layer(cfg, params, _unstacked)):
        subs = _sublayers(cfg, lp, shared, i)
        x, layer_aux = (_remat(cfg.remat_policy, subs, x) if remat
                        else _run(subs, x))
        for a in layer_aux:
            aux = aux + a
    return _unembed(cfg, params, x[:, n_extra:]), aux


def loss_fn(cfg: ModelConfig, params: PyTree,
            batch: Dict) -> Tuple[torch.Tensor, Dict]:
    """Next-token cross entropy (``repro/models/lm.py:loss_fn``): batch
    tokens [B,S], labels [B,S], optional mask [B,S] and extra_embeds
    [B,S_img,D]; logits in fp32, logsumexp minus the gold logit, masked
    mean; returns (ce + aux, {"ce", "aux"})."""
    logits, aux = forward(cfg, params, batch["tokens"],
                          batch.get("extra_embeds"))
    nll = token_nll(logits, batch["labels"])
    mask = batch.get("mask")
    mask = torch.ones_like(nll) if mask is None else mask.to(nll.dtype)
    ce = (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
    return ce + aux, {"ce": ce, "aux": aux}


def _token_nll(logits, labels):
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    return logz - logits.gather(-1, labels.long()[..., None])[..., 0]


def token_nll(logits, labels):
    """logsumexp of the fp32 logits minus the gold logit, per token. On a
    mesh, each rank takes its batch shard's rows with the whole vocab
    (the logits gathered over "model")."""
    if not parallel.is_dtensor(logits):
        return _token_nll(logits, labels)
    rows = parallel.batch_placements(labels)
    return parallel.local_call(_token_nll, rows, (
        parallel.batch_placements(logits), rows), logits, labels)


# ---------------------------------------------------------------------------
# KV/SSM caches + prefill / decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> PyTree:
    """Layer-stacked caches in compute dtype (the SSM state in fp32):
    dense, moe and vlm: KV [L, B, max_seq, KV, hd]; ssm: the Mamba-2 cache
    [L, B, ...]; hybrid: the Mamba-2 cache per layer plus the shared
    block's KV with ONE slot per invocation, ceil(L / attn_every) slots,
    as the reference lays it out; typed hybrid: the Mamba-2 cache of each
    Mamba-2 layer (``layers``) and KV of each attention layer (``attn``),
    in layer order (``_cache_slots``). ``pos``, the next decode position,
    is a 0-d int32 on ``device`` (``init_pos``)."""
    cdt = torch_dtype(cfg.compute_dtype)
    L = cfg.n_layers
    if cfg.layer_types:
        nm = cfg.layer_types.count("mamba")
        na = L - nm
        cache = {"pos": init_pos(device)}
        if nm:
            cache["layers"] = _stacked(init_ssm_cache(cfg, nm * batch, cdt,
                                                      device), nm, batch)
        if na:
            cache["attn"] = _stacked(init_kv_cache(
                na * batch, max_seq, cfg.n_kv_heads, cfg.hd, cdt, device),
                na, batch)
        return cache
    if not cfg.is_ssm_family:
        kv = init_kv_cache(L * batch, max_seq, cfg.n_kv_heads, cfg.hd, cdt,
                           device)
        return {"layers": _stacked(kv, L, batch), "pos": init_pos(device)}
    ssm = init_ssm_cache(cfg, L * batch, cdt, device)
    cache = {"layers": _stacked(ssm, L, batch), "pos": init_pos(device)}
    if cfg.family == "hybrid":
        n_slots = max(1, (L + cfg.attn_every - 1) // cfg.attn_every)
        kv = init_kv_cache(n_slots * batch, max_seq, cfg.n_kv_heads, cfg.hd,
                           cdt, device)
        cache["attn"] = _stacked(kv, n_slots, batch)
    return cache


def fresh_cache(cfg: ModelConfig, make: Callable, batch: int, ref) -> PyTree:
    """The zero cache ``make(device)`` of a prefill whose params include
    ``ref``: on its device; on a mesh (``ref`` a DTensor), DTensors placed
    by ``launch.sharding.cache_specs``, each rank allocating its shards."""
    if not parallel.is_dtensor(ref):
        return make(ref.device)
    from ..launch import sharding       # launch imports the models
    shapes = make("meta")
    mesh = ref.device_mesh
    return sharding.zeros(shapes, sharding.cache_specs(
        cfg, batch, mesh, shapes), mesh)


def prefill(cfg: ModelConfig, params: PyTree, tokens, max_seq: int,
            cache: PyTree = None) -> Tuple[torch.Tensor, PyTree]:
    """Prefill a prompt into a fresh cache (on a mesh, placed by the
    cache specs), or into ``cache`` (``init_cache``'s layout for the
    prompt's batch) in place; returns (last logits, cache). The prompt's
    slots [0, S) and the Mamba-2 state and conv buffers are overwritten
    whole, and the KV slots past S take no part in attention until a
    decode step writes them, so a reused cache leaks nothing of its last
    prompt. ``pos`` is set to S in place."""
    b, s = tokens.shape
    if cache is None:
        cache = fresh_cache(cfg, lambda dev: init_cache(cfg, b, max_seq,
                                                        device=dev),
                            b, params["embed"])
    x = _embed(cfg, params, tokens)
    shared = params.get("shared_attn")
    slots = _cache_slots(cfg)
    for i, lp in enumerate(_per_layer(cfg, params, _layer_views)):
        lc = layer_params(cache[slots[i][0]], slots[i][1])
        if "ssm" in lp:
            with span("model.ssm"):
                h = apply_norm(cfg, x, lp["ssm_norm"])
                # one scan gives the output and the decode cache
                y, _ = mamba2_prefill(cfg, lp["ssm"], h, lc)
                x = x + parallel.like(_scaled(cfg, y), x)
            if _shared_fires(cfg, shared, i):
                ac = layer_params(cache["attn"], i // cfg.attn_every)
                x = _shared_attn_apply(cfg, shared, x, lambda h: (
                    prefill_into_cache(cfg, shared["attn"], h, ac)[0]))
        else:
            with span("model.attention"):
                h = apply_norm(cfg, x, lp["attn_norm"])
                y, _ = prefill_into_cache(cfg, lp["attn"], h, lc)
                x = x + parallel.like(_scaled(cfg, y), x)
        if "ffn_norm" in lp:
            with span(_ffn_span(lp)):
                h = apply_norm(cfg, x, lp["ffn_norm"])
                x = x + parallel.like(_scaled(cfg, _ffn(cfg, lp, h)), x)
    cache["pos"].fill_(s)
    return _unembed(cfg, params, x[:, -1:, :])[:, 0, :], cache


def decode_step(cfg: ModelConfig, params: PyTree, cache: PyTree,
                tokens) -> Tuple[torch.Tensor, PyTree]:
    """tokens [B] -> (logits [B,Vp], the same cache, advanced by one
    position). One token for the whole batch; the cache tensors are
    written in place, and ``pos`` is read on its device and advanced in
    place, so the step makes no host read and a replay of it (the serving
    engine's CUDA graph) moves to the next position."""
    pos = cache["pos"]
    x = _embed(cfg, params, tokens)[:, None, :]
    shared = params.get("shared_attn")
    slots = _cache_slots(cfg)
    for i, lp in enumerate(_per_layer(cfg, params, _layer_views)):
        lc = layer_params(cache[slots[i][0]], slots[i][1])
        if "ssm" in lp:
            with span("model.ssm"):
                h = apply_norm(cfg, x, lp["ssm_norm"])
                y, _ = mamba2_decode(cfg, lp["ssm"], h, lc)
                x = x + parallel.like(_scaled(cfg, y), x)
            if _shared_fires(cfg, shared, i):
                ac = layer_params(cache["attn"], i // cfg.attn_every)
                x = _shared_attn_apply(cfg, shared, x, lambda h: (
                    decode_attention(cfg, shared["attn"], h, ac, pos)[0]))
        else:
            with span("model.attention"):
                h = apply_norm(cfg, x, lp["attn_norm"])
                y, _ = decode_attention(cfg, lp["attn"], h, lc, pos)
                x = x + parallel.like(_scaled(cfg, y), x)
        if "ffn_norm" in lp:
            with span(_ffn_span(lp)):
                h = apply_norm(cfg, x, lp["ffn_norm"])
                x = x + parallel.like(_scaled(cfg, _ffn(cfg, lp, h)), x)
    logits = _unembed(cfg, params, x)[:, 0, :]
    pos.add_(1)
    return logits, cache

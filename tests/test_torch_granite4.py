"""Granite 4.0-H in the port (``repro_torch.models``: the hybrid family's
typed layout of Mamba-2 and NoPE attention layers, each followed by the
dropless MoE over a share of the experts, and the µP multipliers)
against its plain float32 reference (``repro_torch.models.hybrid_ref``)
on the CPU, at smoke widths with seeded weights.

Everything runs in float32, so the port and the reference differ only in
the order of their sums (the port's chunked SSD against the reference's
step-by-step recurrence): logits agree within 1e-4.
"""
import dataclasses
import os
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(max(1, (os.cpu_count() or 1) // int(
    os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))))

from repro_torch.kernels.decode_attn import ref as decode_ref  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.models import (attention, hybrid_ref, lm, mlp,  # noqa: E402
                                model_zoo)
from repro_torch.models.common import ModelConfig, tree_map  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)
TYPES = ("mamba", "attention", "mamba", "mamba")
MULTIPLIERS = dict(embedding_multiplier=12.0, residual_multiplier=0.22,
                   attention_multiplier=0.0078125, logits_scaling=16.0)


def _cfg(**kw):
    """Granite 4.0-H Small's layout at smoke widths: [mamba, attention,
    mamba, mamba], GQA 2:1 with no RoPE, 8 routed experts of which 4 are
    held (top 3, softmax over the top 3), a shared expert of 2 x d_ff,
    the published multipliers, fp32."""
    base = dict(arch_id="granite_4_h_small", family="hybrid", n_layers=4,
                d_model=64, vocab=200, n_heads=4, n_kv_heads=2, d_ff=32,
                n_experts=8, experts_held=4, top_k=3, n_shared_experts=2,
                moe_norm_topk=True, moe_impl="dropless",
                router_aux_coef=0.0, use_rope=False, ssm_state=16,
                ssm_head_dim=16, ssm_chunk=8, layer_types=TYPES,
                compute_dtype="float32", **MULTIPLIERS)
    base.update(kw)
    return ModelConfig(**base)


def _params(cfg, seed=0):
    return model_zoo.init_params(cfg, torch.Generator().manual_seed(seed))


def _tokens(cfg, b=2, s=16, seed=1):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, cfg.vocab, (b, s), generator=g)


def _flat(tree):
    out = {}
    tree_map(lambda path, t: out.__setitem__(path, t), tree)
    return out


def test_the_typed_parameter_tree_and_cache():
    """Norms and the MoE stacked over every layer; Mamba-2 weights over
    the 3 Mamba-2 layers, attention over the 1 attention layer; the cache
    holds SSM state for the Mamba-2 layers and KV for the attention layer
    alone."""
    cfg = _cfg()
    shapes = {k: tuple(t.shape) for k, t in
              _flat(model_zoo.param_shapes(cfg)).items()}
    assert shapes["layers/mixer_norm"] == shapes["layers/ffn_norm"] == (4, 64)
    assert shapes["layers/moe/router"] == (4, 64, 8)
    assert shapes["layers/moe/w1"] == (4, 4, 64, 32)
    assert shapes["layers/moe/shared/w1"] == (4, 64, 64)
    assert shapes["mamba_layers/ssm/wx"] == (3, 64, 128)
    assert shapes["attn_layers/attn/wk"] == (1, 64, 32)
    assert not any(k.startswith("shared_attn") for k in shapes)
    cache = model_zoo.init_cache(cfg, 2, 24)
    assert cache["layers"]["state"].shape == (3, 2, 8, 16, 16)
    assert cache["attn"]["k"].shape == (1, 2, 24, 2, 16)
    assert set(cache) == {"layers", "attn", "pos"}


@pytest.mark.parametrize("held", [8, 4])
def test_forward_matches_the_reference(held):
    """Logits with ``logits_scaling`` 16 and every other published
    multiplier, and the training step's loss runs through the same
    layers."""
    cfg = _cfg(experts_held=held)
    params, tokens = _params(cfg), _tokens(cfg)
    logits, aux = lm.forward(cfg, params, tokens)
    want = hybrid_ref.forward(cfg, params, tokens)
    torch.testing.assert_close(logits[..., :cfg.vocab], want, **TOL)
    assert float(aux) == 0.0


def test_tied_embeddings_are_the_reference_tied():
    """The port keeps the output matrix apart; with it set to the
    embedding's transpose the port is the tied model."""
    cfg = _cfg()
    params = _params(cfg)
    params["unembed"] = params["embed"].T.clone()
    tokens = _tokens(cfg)
    want = hybrid_ref.forward(cfg, params, tokens, tied=True)
    got = lm.forward(cfg, params, tokens)[0][..., :cfg.vocab]
    torch.testing.assert_close(got, want, **TOL)


@pytest.mark.parametrize("name", sorted(MULTIPLIERS))
def test_each_multiplier_alone(name):
    """Each multiplier switched on with the others at their defaults: the
    port follows the reference, and differs from the model without it."""
    off = {k: (0.0 if k == "attention_multiplier" else 1.0)
           for k in MULTIPLIERS}
    cfg = _cfg(**{**off, name: MULTIPLIERS[name]})
    params, tokens = _params(cfg), _tokens(cfg)
    got = lm.forward(cfg, params, tokens)[0][..., :cfg.vocab]
    torch.testing.assert_close(got, hybrid_ref.forward(cfg, params, tokens),
                               **TOL)
    plain = lm.forward(cfg.with_(**off), params, tokens)[0][..., :cfg.vocab]
    assert float((got - plain).abs().max()) > 1e-3


def test_prefill_then_decode_matches_the_full_forward():
    """Prefill of 16 tokens through the typed cache, then 8 decode steps
    fed the next tokens: every step's logits are the full forward's (and
    so the reference's) at its position."""
    cfg = _cfg()
    params = _params(cfg)
    tokens = _tokens(cfg, s=24, seed=5)
    full = lm.forward(cfg, params, tokens)[0]
    torch.testing.assert_close(full[..., :cfg.vocab],
                               hybrid_ref.forward(cfg, params, tokens), **TOL)
    with torch.no_grad():
        logits, cache = model_zoo.prefill(cfg, params, tokens[:, :16], 24)
        torch.testing.assert_close(logits, full[:, 15], **TOL)
        for t in range(16, 24):
            logits, cache = model_zoo.decode_step(cfg, params, cache,
                                                  tokens[:, t])
            torch.testing.assert_close(logits, full[:, t], **TOL)
    assert int(cache["pos"]) == 24


def test_attention_scale_and_nope():
    """The attention layer at ``attention_multiplier`` with no RoPE, in
    prefill and in decode, is the reference's; the scale reaches the
    plain paths of both kernels, and the default scale (None) is
    1/sqrt(hd) bitwise."""
    cfg = _cfg()
    g = torch.Generator().manual_seed(7)
    p = {k: torch.randn(s, generator=g) * 0.2 for k, s in
         (("wq", (64, 64)), ("wk", (64, 32)), ("wv", (64, 32)),
          ("wo", (64, 64)))}
    x = torch.randn((2, 12, 64), generator=g)
    want = hybrid_ref.attention(cfg, p, x)
    torch.testing.assert_close(attention.attention(cfg, p, x), want, **TOL)
    # NoPE: a key's position does not enter its score, so the last query
    # sees the keys before it as a set
    perm = torch.cat([torch.randperm(11, generator=g), torch.tensor([11])])
    last = attention.attention(cfg, p, x[:, perm])[:, -1]
    torch.testing.assert_close(last, want[:, -1], **TOL)
    kv = {"k": torch.zeros((2, 16, 2, 16)), "v": torch.zeros((2, 16, 2, 16))}
    pos = attention.init_pos()
    attention.prefill_into_cache(cfg, p, x[:, :11], kv)
    pos.fill_(11)
    y, _ = attention.decode_attention(cfg, p, x[:, 11:], kv, pos)
    torch.testing.assert_close(y[:, 0], want[:, -1], **TOL)
    q, k, v = (torch.randn(s, generator=g) for s in
               ((2, 5, 4, 16), (2, 5, 2, 16), (2, 5, 2, 16)))
    assert torch.equal(flash_ops.flash_attention(q, k, v, True),
                       flash_ops.flash_attention(q, k, v, True, 0.25))
    assert not torch.equal(flash_ops.flash_attention(q, k, v, True),
                           flash_ops.flash_attention(q, k, v, True, 0.1))
    assert torch.equal(decode_ref.gqa_decode_attend(q[:, :1], k, v, 3),
                       decode_ref.gqa_decode_attend(q[:, :1], k, v, 3,
                                                    scale=0.25))


def test_flash_gradient_takes_the_scale():
    """``FlashAttention`` under autograd at a scale other than
    1/sqrt(hd): its plain backward is autograd's through the plain
    forward at that scale."""
    g = torch.Generator().manual_seed(9)
    q, k, v = (torch.randn(s, generator=g, dtype=torch.float64,
                           requires_grad=True)
               for s in ((1, 6, 4, 8), (1, 6, 2, 8), (1, 6, 2, 8)))
    do = torch.randn((1, 6, 4, 8), generator=g, dtype=torch.float64)
    out = flash_ops.FlashAttention.apply(q, k, v, True, 0.0078125)
    got = torch.autograd.grad(out, (q, k, v), do)
    want_out = flash_ops.attention_ref(q, k, v, True, 0.0078125)
    torch.testing.assert_close(out, want_out)
    want = torch.autograd.grad(want_out, (q, k, v), do)
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b)


def test_the_shares_add_up_to_the_uncut_layer():
    """The layer's 8 experts in 4 shares of 2: each share's routed part
    (the program's, and the reference's) plus the shared expert counted
    once equals the uncut reference layer. A share holds the router's
    first columns, so share j sees the router's columns rolled by 2 j."""
    cfg = _cfg(experts_held=8)
    layer = {k[len("layers/moe/"):]: v[1] for k, v in
             _flat(_params(cfg)).items() if k.startswith("layers/moe/")}
    moe_p = {k: v for k, v in layer.items() if "/" not in k}
    moe_p["shared"] = {k[len("shared/"):]: v for k, v in layer.items()
                       if k.startswith("shared/")}
    x = torch.randn((2, 16, 64), generator=torch.Generator().manual_seed(3))
    with torch.no_grad():
        whole = hybrid_ref.moe(cfg, moe_p, x)
        prog = ref = hybrid_ref.swiglu(moe_p["shared"], x)
        for j in range(4):
            part = {k: moe_p[k][2 * j:2 * j + 2] for k in ("w1", "w3", "w2")}
            part["router"] = moe_p["router"].roll(-2 * j, dims=1)
            y, _ = mlp.moe(cfg.with_(experts_held=2), part, x)
            prog = prog + y
            ref = ref + hybrid_ref.moe(cfg, part, x, held=2, shared=False)
    torch.testing.assert_close(prog, whole, **TOL)
    torch.testing.assert_close(ref, whole, **TOL)


def test_the_decode_step_is_left_eager():
    """The dropless MoE reads its row counts back, so the hybrid's decode
    step is never captured, on the card or not; Zamba-2's layout (no
    experts) still is. A stand-in leaf reads as a CUDA tensor here."""
    leaf = types.SimpleNamespace(is_cuda=True)
    cfg = _cfg()
    params = tree_map(lambda _, t: leaf, model_zoo.param_shapes(cfg))
    with torch.no_grad():
        assert model_zoo.reads_back(cfg)
        assert not model_zoo.decode_graph_ok(cfg, params)
        plain = cfg.with_(n_experts=0, experts_held=0, top_k=0,
                          n_shared_experts=0)
        assert not model_zoo.reads_back(plain)
        assert model_zoo.decode_graph_ok(plain, tree_map(
            lambda _, t: leaf, model_zoo.param_shapes(plain)))


@pytest.mark.parametrize("bad", [
    dict(layer_types=TYPES[:3]), dict(layer_types=("mamba", "mlp") * 2),
    dict(attn_every=2), dict(family="ssm"), dict(hidden_size=4096),
    dict(num_local_experts=72), dict(mamba_conv_bias=True),
    dict(tie_word_embeddings=True)])
def test_a_layout_or_published_key_that_disagrees_is_refused(bad):
    with pytest.raises(ValueError):
        model_zoo.param_shapes(_cfg(**bad))


def test_stated_published_keys_that_agree_are_taken():
    cfg = _cfg(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
               num_key_value_heads=2, intermediate_size=32,
               shared_intermediate_size=64, num_local_experts=8,
               num_experts_per_tok=3, vocab_size=200, mamba_n_heads=8,
               mamba_d_head=16, mamba_d_state=16, mamba_expand=2,
               mamba_n_groups=1, mamba_d_conv=4, mamba_chunk_size=8,
               rms_norm_eps=1e-6, tie_word_embeddings=False,
               attention_bias=False, mamba_proj_bias=False,
               mamba_conv_bias=False, max_position_embeddings=131072)
    assert cfg.published_mismatches() == []
    model_zoo.param_shapes(cfg)
    assert dataclasses.replace(cfg, mamba_d_state=128).published_mismatches()

"""The dense decoder family (OLMo-1B): L x [x + attn(norm(x));
x + mlp(norm(x))], causal attention with rotary positions and a SwiGLU
MLP. Its layers for the reference (``bench.reference.model``) and its
work counts (``bench.work``)."""
from __future__ import annotations

from bench import work
from bench.reference import model as ref


def layout(cfg: dict) -> list:
    L, d = cfg["n_layers"], cfg["d_model"]
    return ([("layers/attn_norm", (L, d), ("ones",))]
            + ref.attn_layout(cfg, "layers/attn", (L,))
            + [("layers/ffn_norm", (L, d), ("ones",))]
            + ref.mlp_layout(cfg, "layers/mlp", (L,)))


def sublayers(cfg: dict, dots, w, i: int) -> list:
    return [ref.residual(cfg, w["layers/attn_norm"][i],
                         lambda h: ref.attention(
                             cfg, dots, ref.block(w, "layers/attn", i), h)),
            ref.residual(cfg, w["layers/ffn_norm"][i],
                         lambda h: ref.mlp(
                             dots, ref.block(w, "layers/mlp", i), h))]


def matmul_params(cfg: dict) -> int:
    d, hd = cfg["d_model"], ref.head_dim(cfg)
    attn = d * hd * (2 * cfg["n_heads"] + 2 * cfg["n_kv_heads"])
    return cfg["n_layers"] * (attn + 3 * d * cfg["d_ff"])


def mix_flops(cfg: dict, b: int, queries: int, before: int) -> float:
    return cfg["n_layers"] * work.attention_flops(
        b, cfg["n_heads"], ref.head_dim(cfg), queries, before)


def kernel_calls(cfg: dict, traffic: dict) -> dict:
    d, f, L = cfg["d_model"], cfg["d_ff"], cfg["n_layers"]
    h, kv, hd = cfg["n_heads"], cfg["n_kv_heads"], ref.head_dim(cfg)
    b = traffic["batch"]
    if traffic["kind"] == "train":
        s = traffic["seq"]
        return {"flash_fwd": [(2 * L, work.flash_fwd(b, s, h, kv, hd))],
                "flash_bwd": [(L, work.flash_bwd(b, s, h, kv, hd))],
                "mlp_fwd": [(2 * L, work.mlp_fwd(b * s, d, f))],
                "mlp_bwd": [(L, work.mlp_bwd(b * s, d, f))]}
    s, new = traffic["prompt"], traffic["new_tokens"]
    return {"flash_fwd": [(L, work.flash_fwd(b, s, h, kv, hd))],
            "mlp_fwd": [(L, work.mlp_fwd(b * s, d, f)),
                        (L * new, work.mlp_fwd(b, d, f))]}

"""Architecture registry: ``--arch <id>`` resolution + reduced smoke variants.

The port registers the archs of the dense family: the paper's T-MUX
(three sizes), qwen1.5-4b, gemma-7b, gemma3-4b (sliding-window local
layers) and nemotron-4-340b; of the MoE family, llama4-scout-17b-a16e
and deepseek-v3-671b (MLA mixers); and of the hybrid family,
jamba-1.5-large-398b (Mamba layers beside attention, MoE on every other
layer); of the ssm family, xlstm-125m (mLSTM and sLSTM mixers); of the
vlm family, llama-3.2-vision-11b (gated cross-attention sublayers over
patch embeddings); and of the audio family, whisper-base (an encoder
stack over mel frames, cross-attended by every decoder layer).
The smoke rules are the reference's
(``repro.configs.registry.get_smoke_config``) for these archs.
"""
from __future__ import annotations

import dataclasses

from repro_torch.configs import (deepseek_v3_671b, gemma3_4b, gemma_7b,
                                 jamba_1_5_large_398b, llama4_scout_17b_a16e,
                                 llama_3_2_vision_11b, nemotron_4_340b,
                                 qwen1_5_4b, tmux_12l_768h, whisper_base,
                                 xlstm_125m)
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import MLAConfig

ARCHS: dict[str, ModelConfig] = {
    "deepseek-v3-671b": deepseek_v3_671b.CONFIG,
    "gemma-7b": gemma_7b.CONFIG,
    "gemma3-4b": gemma3_4b.CONFIG,
    "jamba-1.5-large-398b": jamba_1_5_large_398b.CONFIG,
    "llama-3.2-vision-11b": llama_3_2_vision_11b.CONFIG,
    "llama4-scout-17b-a16e": llama4_scout_17b_a16e.CONFIG,
    "nemotron-4-340b": nemotron_4_340b.CONFIG,
    "qwen1.5-4b": qwen1_5_4b.CONFIG,
    "tmux-12l-768h": tmux_12l_768h.CONFIG,
    "tmux-12l-384h": tmux_12l_768h.CONFIG_12L_384H,
    "tmux-4l-768h": tmux_12l_768h.CONFIG_4L_768H,
    "whisper-base": whisper_base.CONFIG,
    "xlstm-125m": xlstm_125m.CONFIG,
}


def get_config(arch: str, *, mux_n: int | None = None,
               mux_strategy: str | None = None) -> ModelConfig:
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; have {sorted(ARCHS)}")
    cfg = ARCHS[arch]
    if mux_n is not None or mux_strategy is not None:
        mux = dataclasses.replace(
            cfg.mux,
            **({"n": mux_n} if mux_n is not None else {}),
            **({"strategy": mux_strategy} if mux_strategy else {}))
        cfg = dataclasses.replace(cfg, mux=mux)
    return cfg


def get_smoke_config(arch: str, *, mux_n: int = 1) -> ModelConfig:
    """Reduced same-family variant: 4 layers, d_model <= 256, 4 heads,
    vocab 512, float32; a windowed arch keeps window 16 with every 2nd
    layer global; an MoE arch keeps 4 experts of width 2 * d_model, top-k
    at most 2, and its MoE layers from layer 1 at the latest; an MLA arch
    keeps q rank 64, latent 32, nope 32, rope 16 and v 32 per head; a
    Mamba arch keeps its state, conv and expansion at d_model with scan
    chunks of 16, and a hybrid one an attention layer every 4th layer
    (at most) from layer 1; an xLSTM arch keeps 4 heads at d_model, with
    scan chunks of 16 and every 2nd layer sLSTM; no activation
    checkpointing (``remat="none"``)."""
    cfg = get_config(arch)
    d = min(cfg.d_model, 256)
    heads = 4
    kv = min(cfg.n_kv_heads, heads)
    kv = heads // max(1, heads // kv)  # keep divisibility
    kw: dict = {}
    if cfg.global_every:
        kw.update(window=16, global_every=2)
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(dim=d, n_heads=heads, q_lora_rank=64,
                              kv_lora_rank=32, qk_nope_head_dim=32,
                              qk_rope_head_dim=16, v_head_dim=32)
    if cfg.moe is not None:
        kw["moe"] = dataclasses.replace(
            cfg.moe, dim=d, moe_ff=2 * d, n_experts=4,
            top_k=min(cfg.moe.top_k, 2))
        kw["moe_layer_start"] = min(cfg.moe_layer_start, 1)
    if cfg.mamba is not None:
        kw["mamba"] = dataclasses.replace(cfg.mamba, dim=d, chunk=16)
        kw["attn_every"] = min(cfg.attn_every, 4) if cfg.attn_every else 0
        kw["attn_offset"] = 1 if cfg.attn_every else 0
    if cfg.xlstm is not None:
        kw["xlstm"] = dataclasses.replace(cfg.xlstm, dim=d, n_heads=4,
                                          chunk=16)
        kw["slstm_every"] = 2
    if cfg.cross_attn_every:
        kw.update(cross_attn_every=2, context_dim=d, context_len=24)
    if cfg.encoder is not None:
        kw["encoder"] = dataclasses.replace(
            cfg.encoder, n_layers=2, d_model=d, n_heads=heads,
            n_kv_heads=heads, d_ff=2 * d, vocab=512, dtype="float32",
            param_dtype="float32")
        kw.update(context_dim=d, context_len=24)
    return dataclasses.replace(
        cfg,
        **kw,
        name=cfg.name + "-smoke",
        n_layers=4,
        d_model=d,
        n_heads=heads,
        n_kv_heads=kv,
        head_dim=64 if cfg.head_dim else 0,
        d_ff=4 * d if cfg.d_ff else 0,
        vocab=512,
        dtype="float32",
        param_dtype="float32",
        remat="none",
        mux=dataclasses.replace(cfg.mux, n=mux_n),
    )


def long_500k_supported(arch: str) -> bool:
    """Sub-quadratic decode (the reference's rule): the ssm and hybrid
    families, and a sliding-window dense arch (gemma3)."""
    cfg = get_config(arch)
    return cfg.family in ("ssm", "hybrid") or cfg.window is not None

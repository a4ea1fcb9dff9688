"""llama4-scout-17b-a16e — MoE, 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048; 16 routed experts top-1 + 1 shared expert on every layer
(interleave step 1); early-fusion multimodal in the original — the text
backbone here, as in the reference.  Training saves the matmul outputs
and recomputes the rest (``remat="dots"``, as in the reference).
[hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.moe import MoEConfig

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=8192,
    vocab=202048,
    cite="hf:meta-llama/Llama-4-Scout-17B-16E",
    moe=MoEConfig(
        dim=5120, moe_ff=8192, n_experts=16, top_k=1, n_shared_experts=1,
        activation="silu", gated=True),
    moe_every=1,
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    rope_theta=500_000.0,
    tie_embeddings=False,
    remat="dots",
)

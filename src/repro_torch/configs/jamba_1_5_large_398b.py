"""jamba-1.5-large-398b — hybrid, 72L d_model=8192 64H (GQA kv=8)
d_ff=24576 vocab=65536; Mamba+attention 1:7 interleave (1 attention layer
per 8-layer block, at offset 4), MoE 16 experts top-2 on every other
layer.  Training recomputes every layer-pattern group in the backward
(``remat="full"``, as in the reference).  [arXiv:2403.19887]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.moe import MoEConfig
from repro_torch.nn.ssm import MambaConfig

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=24576,
    vocab=65536,
    cite="arXiv:2403.19887",
    mamba=MambaConfig(dim=8192, d_state=16, d_conv=4, expand=2),
    attn_every=8,              # 1 attention : 7 Mamba per block
    attn_offset=4,
    moe=MoEConfig(
        dim=8192, moe_ff=24576, n_experts=16, top_k=2,
        activation="silu", gated=True),
    moe_every=2,               # MoE replaces the MLP on every other layer
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    remat="full",
)

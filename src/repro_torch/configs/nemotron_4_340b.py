"""nemotron-4-340b — dense, 96L d_model=18432 96H (GQA kv=8) d_ff=73728
vocab=256000; LayerNorm, squared-ReLU, no gating, untied head.  Training
recomputes every layer-pattern group in the backward (``remat="full"``, as
in the reference).  [arXiv:2402.16819]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    cite="arXiv:2402.16819",
    norm="layernorm",
    activation="squared_relu",  # Nemotron-4 uses squared ReLU
    gated_mlp=False,
    rope_theta=10_000.0,
    tie_embeddings=False,
    remat="full",               # 340B training needs aggressive remat
)

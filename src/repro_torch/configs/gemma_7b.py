"""gemma-7b — dense, 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000;
GeGLU activation, head_dim=256, tied embeddings.  [arXiv:2403.08295]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma-7b",
    family="dense",
    n_layers=28,
    d_model=3072,
    n_heads=16,
    n_kv_heads=16,
    d_ff=24576,
    vocab=256000,
    cite="arXiv:2403.08295",
    head_dim=256,              # q/k/v width 4096 despite d_model 3072
    norm="rmsnorm",
    activation="gelu",         # GeGLU
    gated_mlp=True,
    tie_embeddings=True,
)

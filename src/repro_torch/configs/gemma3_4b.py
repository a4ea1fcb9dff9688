"""gemma3-4b — dense, 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144; 5:1 local (sliding-window 1024) : global attention.  Local
layers keep a ring of ``min(1024, max_len)`` cache rows; every 6th layer
is global.  [hf:google/gemma-3-1b-pt]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="gemma3-4b",
    family="dense",
    n_layers=34,
    d_model=2560,
    n_heads=8,
    n_kv_heads=4,
    d_ff=10240,
    vocab=262144,
    cite="hf:google/gemma-3-1b-pt",
    head_dim=256,
    window=1024,               # local layers: sliding window 1024
    global_every=6,            # every 6th layer is global (5:1 local:global)
    norm="rmsnorm",
    activation="gelu",         # GeGLU
    gated_mlp=True,
    rope_theta=1_000_000.0,
    tie_embeddings=True,
)

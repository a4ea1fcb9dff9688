"""qwen1.5-4b — dense, 40L d_model=2560 20H (GQA kv=20) d_ff=6912
vocab=151936, QKV bias.  [hf:Qwen/Qwen1.5-0.5B family]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="qwen1.5-4b",
    family="dense",
    n_layers=40,
    d_model=2560,
    n_heads=20,
    n_kv_heads=20,
    d_ff=6912,
    vocab=151936,
    cite="hf:Qwen/Qwen1.5-0.5B",
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    qkv_bias=True,           # Qwen1.5 uses QKV bias
    rope_theta=1_000_000.0,
    tie_embeddings=False,
)

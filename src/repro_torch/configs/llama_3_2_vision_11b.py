"""llama-3.2-vision-11b — VLM, 40L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=128256, with a tanh-gated cross-attention sublayer on every 5th
layer.  The vision frontend (ViT + projector) is a stub: the caller
provides projected patch embeddings (B, 1600, 4096).
[hf:meta-llama/Llama-3.2-11B-Vision]"""
from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    n_layers=40,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=128256,
    cite="hf:meta-llama/Llama-3.2-11B-Vision",
    cross_attn_every=5,        # 8 gated cross-attention sublayers of 40
    context_dim=4096,          # projector output width (stub frontend)
    context_len=1600,          # patch embeddings per image tile set
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    rope_theta=500_000.0,
    tie_embeddings=False,
)

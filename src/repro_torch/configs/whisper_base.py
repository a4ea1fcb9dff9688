"""whisper-base — audio enc-dec, 6L encoder + 6L decoder, d_model=512 8H
d_ff=2048 vocab=51865.  The conv feature frontend is a stub: the caller
provides mel-frame embeddings (B, 1500, 512), which the encoder stack
consumes; the decoder cross-attends on every layer.  RoPE replaces
Whisper's learned absolute positions, as in the JAX package.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ModelConfig

_ENCODER = ModelConfig(
    name="whisper-base-encoder",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,               # unused by the encoder stack
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    causal=False,              # bidirectional encoder
)

CONFIG = ModelConfig(
    name="whisper-base",
    family="audio",
    n_layers=6,
    d_model=512,
    n_heads=8,
    n_kv_heads=8,
    d_ff=2048,
    vocab=51865,
    cite="arXiv:2212.04356",
    encoder=_ENCODER,
    cross_attn_every=1,        # the decoder cross-attends on every layer
    context_dim=512,
    context_len=1500,          # 30 s of mel frames after the conv stub
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    tie_embeddings=True,
)

"""deepseek-v3-671b — MoE, 61L d_model=7168 128H (MLA), vocab=129280,
MoE 256 routed experts top-8 (sigmoid scoring) + 1 shared, expert width
2048; the first 3 layers are dense with the model's published dense FFN
width 18432.  MLA with a compressed-latent KV cache (kv_lora_rank 512 +
rope 64 per token).  The reference's docstring also names an MTP head,
which no module of the reference implements; the port has none either.
Training recomputes every layer-pattern group in the backward
(``remat="full"``, as in the reference).  [arXiv:2412.19437]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.attention import MLAConfig
from repro_torch.nn.moe import MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    n_layers=61,
    d_model=7168,
    n_heads=128,
    n_kv_heads=128,
    d_ff=18432,                # dense layers (0-2); the experts are 2048 wide
    vocab=129280,
    cite="arXiv:2412.19437",
    mla=MLAConfig(
        dim=7168, n_heads=128, q_lora_rank=1536, kv_lora_rank=512,
        qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(
        dim=7168, moe_ff=2048, n_experts=256, top_k=8, n_shared_experts=1,
        router_scoring="sigmoid", activation="silu", gated=True),
    moe_layer_start=3,         # first 3 layers dense
    moe_every=1,
    norm="rmsnorm",
    activation="silu",
    gated_mlp=True,
    tie_embeddings=False,
    remat="full",
)

"""xlstm-125m — SSM family, 12L d_model=768 4H vocab=50304, d_ff=0 (the
mLSTM/sLSTM blocks carry their own up/down projections).  Block mix: every
3rd block is sLSTM, the rest mLSTM (xLSTM paper's mixed-ratio regime).
[arXiv:2405.04517]"""
from repro_torch.configs.base import ModelConfig
from repro_torch.nn.ssm import XLSTMConfig

CONFIG = ModelConfig(
    name="xlstm-125m",
    family="ssm",
    n_layers=12,
    d_model=768,
    n_heads=4,
    n_kv_heads=4,
    d_ff=0,
    vocab=50304,
    cite="arXiv:2405.04517",
    xlstm=XLSTMConfig(dim=768, n_heads=4, proj_factor=2.0),
    slstm_every=3,            # layers 3, 6, 9, 12 are sLSTM
    norm="layernorm",
    tie_embeddings=True,
)

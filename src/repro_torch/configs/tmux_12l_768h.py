"""T-MUX — the paper's own backbone: 12-layer, 768-hidden, 12-head
Transformer encoder (bidirectional) with DataMUX N=40, Hadamard multiplexing
and Index-Embedding demultiplexing (paper Sec 4.1, Fig 3/4).
Smaller variants from paper A2: 12L/384H and 4L/768H."""
from repro_torch.configs.base import ModelConfig, MuxConfig, replace

CONFIG = ModelConfig(
    name="tmux-12l-768h",
    family="dense",
    n_layers=12,
    d_model=768,
    n_heads=12,
    n_kv_heads=12,
    d_ff=3072,
    vocab=30522,
    cite="Murahari et al. 2022 (this paper), Sec 4.1",
    norm="layernorm",
    activation="gelu",
    gated_mlp=False,
    causal=False,              # the paper's backbone is bidirectional
    tie_embeddings=True,
    mux=MuxConfig(n=40, strategy="hadamard", demux="index_embed",
                  retrieval_alpha=0.1),
)

# Paper A2 small variants
CONFIG_12L_384H = replace(CONFIG, name="tmux-12l-384h", d_model=384,
                          n_heads=6, n_kv_heads=6, d_ff=1536,
                          mux=replace(CONFIG.mux, n=20))
CONFIG_4L_768H = replace(CONFIG, name="tmux-4l-768h", n_layers=4,
                         mux=replace(CONFIG.mux, n=20))

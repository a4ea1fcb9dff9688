"""The work counts against hand-worked FLOPs and bytes at tiny shapes."""
from perfbench.counts import kernels, peaks, step


def test_hadamard_mux():
    # x (1, 2, 3, 4) -> (1, 3, 4): 24 multiplies + 24 adds; bytes
    # (24 + 8 + 12) elements of 2
    assert kernels.hadamard_mux(1, 2, 3, 4) == (48, 88)


def test_index_embed_demux():
    # b1 n2 l3 d4 H5: zh 2*3*4*5 = 120, zp 2*2*4*5 = 80, lanes
    # 2*2*3*5*4 = 240; bytes (12 + 8 + 40 + 5 + 20 + 4 + 24) * 2
    assert kernels.index_embed_demux(1, 2, 3, 4, 5) == (440, 226)


def test_attention_pairs_and_flash():
    assert kernels.attention_pairs(3, 3, False) == 9
    assert kernels.attention_pairs(3, 3, True) == 6       # 1 + 2 + 3
    assert kernels.attention_pairs(2, 4, True) == 7       # 3 + 4
    # b1 L3 h2 hd4 causal: 4 * 1 * 2 * 6 * 4; bytes 4 * 3 * 2 * 4 * 2
    assert kernels.flash_attention(1, 3, 3, 2, 4, True) == (192, 192)


def test_bound():
    assert peaks.bound_s(989e12, 0) == 1.0
    assert peaks.bound_s(0, 3.35e12) == 1.0
    assert peaks.bound_s(989e12, 6.7e12) == 2.0


SHAPE = dict(groups=1, n=2, seq_len=3, prefix=2, d_model=4, head_dim=2,
             n_heads=2, n_kv_heads=1, d_ff=6, vocab=10, n_layers=1,
             gated_mlp=True, causal=True, demux_hidden=5, task="lm",
             n_classes=0, retrieval_alpha=0.1, dtype="bfloat16")


def test_backbone_by_hand():
    # 5 rows: q, k, v 2*5*4*(2+2)*2 = 320, o 2*5*4*4 = 160, gated MLP
    # 3*2*5*4*6 = 720, causal attention 4*2*15*2 = 240
    assert step.backbone(SHAPE, 1, 5) == 1440
    bidir = dict(SHAPE, causal=False, gated_mlp=False)
    assert step.backbone(bidir, 1, 5) == 320 + 160 + 480 + 4 * 2 * 25 * 2


def test_offline_step_by_hand():
    demux = kernels.index_embed_demux(1, 2, 3, 4, 5)[0]
    lm = 1440 + demux + 2 * 2 * 2 * 4 * 10 + 2 * 3 * 4 * 10
    assert step.offline_step(SHAPE) == lm
    cls = dict(SHAPE, task="cls", n_classes=3, retrieval_alpha=0.0)
    assert step.offline_step(cls) == 1440 + demux + 2 * 2 * 4 * 3


def test_full_cell_sizes():
    """The full cells' counts, as their descriptions give them."""
    tmux = dict(groups=32, n=40, seq_len=128, prefix=40, d_model=768,
                head_dim=64, n_heads=12, n_kv_heads=12, d_ff=3072,
                vocab=30522, n_layers=12, gated_mlp=False, causal=False,
                demux_hidden=1536, task="cls", n_classes=3,
                retrieval_alpha=0.1, dtype="bfloat16")
    assert 1.45e12 < step.offline_step(tmux) < 1.65e12
    qwen = dict(groups=2, n=8, seq_len=1024, prefix=8, d_model=2560,
                head_dim=128, n_heads=20, n_kv_heads=20, d_ff=6912,
                vocab=151936, n_layers=40, gated_mlp=True, causal=True,
                demux_hidden=5120, task="lm", n_classes=0,
                retrieval_alpha=0.1, dtype="bfloat16")
    assert 27e12 < step.offline_step(qwen) < 29.5e12


def test_paged_decode_attention_by_hand():
    # two slots: 2 rows after 3 keys (pairs 2*3 + 3 = 9), 1 row after 5
    # keys (5 + 1 = 6); h2 hd4: flops 4*2*4*15; mapped 5 + 6 = 11
    # positions of K and V (kvh1 hd4, bf16) and int32 pos, q and out of
    # b2 c2 h2 hd4
    flops, nbytes = kernels.paged_decode_attention([(2, 3), (1, 5)], 2, 1, 4,
                                                   c=2, b=2)
    assert flops == 480
    assert nbytes == 11 * (2 * 1 * 4 * 2 + 4) + 2 * 2 * 2 * 2 * 4 * 2


def test_serve_step_by_hand():
    shape = dict(SHAPE, n_layers=1)
    # rows 2 after 3 keys: proj 2*2*4*(2+2)*2 + 2*2*2*2*4 = 192, gated
    # MLP 3*2*2*4*6 = 288, attention 4*2*2*(6 + 3) = 144; one token
    # emitted: demux 2*2*4*5 + 2*5*4 = 120, logits 2*4*10 = 80
    assert step.serve_step(shape, [(2, 3)], 1) == 192 + 288 + 144 + 120 + 80

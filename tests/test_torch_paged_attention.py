"""The port's plain paged-attention decode against the JAX package's: its
gather reference over ``PAGED_SWEEP`` (f32 atol 1e-5, bf16 2e-2, live rows
only — rows with no valid key are garbage in every implementation), the
Pallas kernel in interpret mode on two cases, and the bitwise identity of a
pool that mirrors a contiguous cache with the port's contiguous decode.
Then the CUDA kernel's launch plan (every block-table entry walked by one
split, splits on K-block boundaries, shared memory within a block's) and a
float64 model of its split-K merge, held against the plain version and
the Pallas kernel in interpret mode at f32 atol 1e-5 on live rows.
Inputs come from numpy with a seed."""
import dataclasses

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels import tiling as jax_tiling
from repro.kernels.paged_attention import kernel as jax_paged_kernel
from repro.kernels.paged_attention import ref as jax_paged_ref
from repro_torch.kernels.paged_attention import kernel as paged_kernel
from repro_torch.kernels.paged_attention import ops, ref
from repro_torch.nn import attention as torch_attn

TOL = {"float32": 1e-5, "bfloat16": 2e-2}

# (b, h, kvh, hd, pool, ps, mp, c), copied from tests/test_kernels.py:
# page_size 2..16, n_rep 1..4, chunk 1..4, prime/odd pools, max_pages
# not a multiple of the K-block widths.
PAGED_SWEEP = [
    (2, 4, 2, 64, 9, 8, 4, 1),      # GQA 2x, multi-page, plain decode
    (1, 4, 4, 32, 5, 4, 3, 1),      # MHA, small pages, odd pool
    (3, 8, 2, 16, 13, 16, 2, 1),    # wide GQA group, prime pool
    (2, 4, 2, 32, 7, 4, 5, 2),      # chunked queries over small pages
    (2, 4, 1, 16, 11, 8, 3, 3),     # MQA (n_rep 4), chunk 3
    (1, 8, 4, 32, 9, 16, 2, 4),     # chunk 4 within one page
    (2, 2, 2, 48, 13, 2, 6, 2),     # page_size 2: chunk spans pages
]
WINDOWS = [(True, None), (True, 8), (False, 8)]


def paged_case(b, h, kvh, hd, pool, ps, mp, c, *, seed=0):
    """Random pool and block tables, numpy f32: each slot maps a random
    number of distinct non-trash pages, each written up to a random length;
    the query is a C-row chunk at consecutive positions."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, c, h, hd)).astype(np.float32)
    k = rng.standard_normal((pool, ps, kvh, hd)).astype(np.float32)
    v = rng.standard_normal((pool, ps, kvh, hd)).astype(np.float32)
    bt = np.full((b, mp), -1, np.int32)
    pos = np.full((pool, ps), -1, np.int32)
    for i in range(b):
        n = rng.integers(1, min(mp, pool - 1) + 1)
        bt[i, :n] = rng.choice(np.arange(1, pool), size=n, replace=False)
        for j, p in enumerate(bt[i, :n]):
            written = rng.integers(1, ps + 1)
            pos[p, :written] = j * ps + np.arange(written)
    base = rng.integers(ps - 1, mp * ps - c + 1, (b, 1))
    q_pos = (base + np.arange(c)[None, :]).astype(np.int32)
    return q, k, v, pos, bt, q_pos


def live_rows(case, *, causal, window):
    """(B, C) bool: query rows with at least one attendable key."""
    _q, _k, _v, pos, bt, q_pos = case
    k_pos = np.where(bt[:, :, None] >= 0, pos[np.maximum(bt, 0)], -1)
    k_pos = k_pos.reshape(bt.shape[0], -1)
    diff = q_pos[:, :, None] - k_pos[:, None, :]
    ok = (k_pos >= 0)[:, None, :]
    if causal:
        ok = ok & (diff >= 0)
    if window is not None:
        ok = ok & (diff < window)
    return ok.any(-1)


def _both(case, dtype):
    """The case as (jax arrays, torch tensors), floats in ``dtype``."""
    np_dt = {"float32": np.float32, "bfloat16": ml_dtypes.bfloat16}[dtype]
    jax_args = [jnp.asarray(a.astype(np_dt) if a.dtype == np.float32 else a)
                for a in case]
    torch_args = [torch.from_numpy(a).to(getattr(torch, dtype))
                  if a.dtype == np.float32 else torch.from_numpy(a)
                  for a in case]
    return jax_args, torch_args


def _close_live(got, want, live, tol):
    live = live[:, :, None, None]
    np.testing.assert_allclose(np.where(live, got, 0.0),
                               np.where(live, want, 0.0), atol=tol, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kvh,hd,pool,ps,mp,c", PAGED_SWEEP)
@pytest.mark.parametrize("causal,window", WINDOWS)
def test_plain_paged_attention_matches_jax(b, h, kvh, hd, pool, ps, mp, c,
                                           dtype, causal, window):
    case = paged_case(b, h, kvh, hd, pool, ps, mp, c)
    jax_args, torch_args = _both(case, dtype)
    scale = hd ** -0.5
    want = jax_paged_ref.paged_attention(*jax_args, scale=scale,
                                         causal=causal, window=window)
    got = ops.paged_attention(*torch_args, scale=scale, causal=causal,
                              window=window)
    assert got.dtype == getattr(torch, dtype)
    assert tuple(got.shape) == want.shape
    _close_live(got.float().numpy(), np.asarray(want, np.float32),
                live_rows(case, causal=causal, window=window), TOL[dtype])


@pytest.mark.parametrize("case_idx,causal,window,kblock",
                         [(0, True, None, 1), (4, False, 8, 2)])
def test_plain_paged_attention_matches_pallas_interpret(case_idx, causal,
                                                        window, kblock):
    """The TPU kernel run in interpret mode, as the JAX package's own tests
    run it on the CPU; the port's op with ``use_kernel=True`` on a CPU
    tensor takes its plain version."""
    case = paged_case(*PAGED_SWEEP[case_idx], seed=1)
    jax_args, torch_args = _both(case, "float32")
    hd = case[0].shape[-1]
    want = jax_paged_kernel.paged_decode_attention(
        *jax_args, scale=hd ** -0.5, causal=causal, window=window,
        kblock_pages=kblock, interpret=True)
    got = ops.paged_attention(*torch_args, scale=hd ** -0.5, causal=causal,
                              window=window, use_kernel=True,
                              kblock_pages=kblock)
    _close_live(got.numpy(), np.asarray(want),
                live_rows(case, causal=causal, window=window), TOL["float32"])


def test_paged_ref_matches_contiguous_attention():
    """A pool that mirrors a contiguous cache (page j of slot b holds
    positions [j*ps, (j+1)*ps)) reproduces the port's contiguous decode
    attention over that cache bit-for-bit."""
    b, h, hd, ps, mp = 2, 4, 32, 8, 3
    S = mp * ps
    rng = np.random.default_rng(0)
    q = torch.from_numpy(rng.standard_normal((b, 1, h, hd)).astype(np.float32))
    k = torch.from_numpy(rng.standard_normal((b, S, h, hd)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((b, S, h, hd)).astype(np.float32))
    written = 13                                   # positions 0..12 valid
    pos_c = torch.where(torch.arange(S) < written, torch.arange(S), -1)
    pos_c = pos_c.to(torch.int32).expand(b, S).contiguous()
    q_pos = torch.full((b, 1), written - 1, dtype=torch.int32)

    mask = torch_attn.make_attention_mask(q_pos, pos_c, causal=True,
                                          k_valid=pos_c >= 0)
    want = torch_attn.dot_product_attention(q, k, v, mask, hd ** -0.5)

    pool = 1 + b * mp
    bt = torch.tensor([[1 + i * mp + j for j in range(mp)] for i in range(b)],
                      dtype=torch.int32)
    rows = bt.reshape(-1).long()
    k_pages = torch.zeros((pool, ps, h, hd))
    v_pages = torch.zeros((pool, ps, h, hd))
    pos_pages = torch.full((pool, ps), -1, dtype=torch.int32)
    k_pages[rows] = k.reshape(b * mp, ps, h, hd)
    v_pages[rows] = v.reshape(b * mp, ps, h, hd)
    pos_pages[rows] = pos_c.reshape(b * mp, ps)

    got = ref.paged_attention(q, k_pages, v_pages, pos_pages, bt, q_pos,
                              scale=hd ** -0.5, causal=True)
    assert torch.equal(got, want)


def test_gather_positions_fold_unmapped_pages():
    pos_pages = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    bt = torch.tensor([[2, -1], [1, 0]], dtype=torch.int32)
    got = ref.gather_positions(pos_pages, bt)
    assert got.tolist() == [[8, 9, 10, 11, -1, -1, -1, -1],
                            [4, 5, 6, 7, 0, 1, 2, 3]]


# ---------------------------------------------------------------------------
# The CUDA kernel's split plan and its split-K merge, modelled on the CPU
# ---------------------------------------------------------------------------


SMEM_LIMIT = 232_448
NEG_INF = -1e30
LOG2E = 1.4426950408889634

# (b, c, h, kvh, hd, ps, max_pages): the tmux-12l-768h slice (C 1, C 4),
# a long context, PAGED_SWEEP's shapes with a kernel-sized head.
PLAN_SHAPES = [(8, 1, 12, 12, 64, 16, 9), (8, 4, 12, 12, 64, 16, 9),
               (8, 1, 12, 12, 64, 16, 64), (3, 3, 8, 2, 128, 8, 7),
               (2, 2, 4, 1, 64, 4, 5), (1, 1, 4, 4, 32, 4, 33),
               (64, 1, 32, 8, 128, 16, 256), (2, 1, 4, 2, 64, 8, 1)]


def check_plan_covers(plan, shape, kblock, dtype):
    """Every block-table entry is walked by exactly one split, each split's
    run starts on a K-block boundary, no split is empty, S <= 8; every
    query row is in exactly one row group of <= 16 rows (8 with two
    vectors per lane), within the rows its instantiation holds; every row
    of a page is in exactly one ring stage (a box of <= 256 rows); the lane
    group holds the whole (16-byte padded) key row; the block's shared
    memory fits."""
    b, c, h, kvh, hd, ps, mp = shape
    assert 1 <= plan.splits <= 8
    assert plan.grid == (plan.splits, kvh, b * plan.groups)
    assert plan.entries % kblock == 0
    runs = [plan.split_entries(s, mp) for s in range(plan.splits)]
    walked = [e for r in runs for e in r]
    assert sorted(walked) == list(range(mp)) and len(set(walked)) == mp
    assert all(len(r) > 0 and r.start % kblock == 0 for r in runs)
    assert plan.rows == c * (h // kvh)
    rows = [r for g in range(plan.groups) for r in plan.group_range(g)]
    assert rows == list(range(plan.rows))
    assert all(0 < len(plan.group_range(g)) <= plan.group_rows
               <= plan.reg_rows <= 16 // plan.vpl for g in range(plan.groups))
    boxes = plan.boxes(ps)
    assert [o for r in boxes for o in r] == list(range(ps))
    assert all(len(r) <= plan.box_rows <= 256 for r in boxes)
    vecs = -(-hd * dtype.itemsize // 16)
    assert plan.lanes & (plan.lanes - 1) == 0 and plan.lanes <= 32
    assert plan.lanes * plan.vpl >= vecs > plan.lanes * plan.vpl // 2
    assert plan.smem <= SMEM_LIMIT and plan.stages >= 3
    assert plan.smem == paged_kernel.smem_bytes(
        plan.group_rows, hd, plan.box_rows, dtype.itemsize, plan.stages,
        min(plan.entries, mp))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kblock", [1, 2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_paged_plan_covers_every_entry_once(shape, kblock, dtype):
    """``check_plan_covers`` at the kernel's earlier shapes, f32 hd 128 at
    kblock 4 included (its 3-stage ring of whole K-blocks overflowed PR
    15's budget; a stage is now one page)."""
    plan = paged_kernel.plan(*shape, kblock, dtype)
    check_plan_covers(plan, shape, kblock, dtype)


# (b, c, h, kvh, hd, ps, max_pages, kblock): query rows R = C * n_rep of
# 17 (tmux-12l-768h at prefill_chunk 17), 64 (C 16 x n_rep 4), 256 (C 32 x
# n_rep 8, jamba's grouping); head dims 36 (72 bf16 bytes: no TMA), 80,
# 192 (nemotron-4-340b) and 256 (gemma); pages of 512 rows; kblock 16 at
# the slice's width (it raised before) and at the reference's limit.
WIDE_SHAPES = [(8, 17, 12, 12, 64, 16, 9, 16), (8, 16, 16, 4, 64, 16, 9, 1),
               (4, 32, 64, 8, 128, 16, 16, 2), (2, 3, 4, 2, 36, 16, 8, 4),
               (2, 2, 8, 2, 80, 16, 12, 1), (2, 1, 96, 8, 192, 16, 8, 1),
               (2, 4, 8, 4, 256, 16, 8, 4), (2, 1, 4, 2, 64, 512, 8, 1),
               (2, 2, 4, 2, 256, 512, 8, 1), (1, 1, 4, 4, 64, 16, 200, 64)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", WIDE_SHAPES)
def test_paged_plan_takes_the_reference_shapes(case, dtype):
    """Shapes the reference's kernel takes and the earlier plan refused."""
    *shape, kblock = case
    plan = paged_kernel.plan(*shape, kblock, dtype)
    check_plan_covers(plan, shape, kblock, dtype)
    hd, ps = shape[4], shape[5]
    assert plan.body == ("tma" if hd * dtype.itemsize % 16 == 0 else "copy")
    assert plan.vpl == (2 if hd * dtype.itemsize > 512 else 1)
    if ps > 256:
        assert len(plan.boxes(ps)) >= 2
    # a misaligned pool takes the copy body, the same split and groups
    other = paged_kernel.plan(*shape, kblock, dtype, aligned=False)
    assert other.body == "copy" and other.splits == plan.splits
    assert other.groups == plan.groups


@pytest.mark.parametrize("itemsize", [2, 4])
@pytest.mark.parametrize("hd", [64, 128, 192, 256])
@pytest.mark.parametrize("ps", [1, 8, 16, 64, 256, 512])
def test_validate_kblock_accepts_what_the_reference_accepts(ps, hd,
                                                            itemsize):
    """The port's copy of ``repro.kernels.tiling.validate_kblock`` accepts
    exactly the same kblock_pages, 1..64, at every page size, head dim and
    itemsize of the grid."""
    def accepts(fn, kb):
        try:
            fn(kb, ps, hd, itemsize=itemsize)
        except ValueError:
            return False
        return True

    ours = [accepts(paged_kernel.validate_kblock, kb) for kb in range(1, 65)]
    theirs = [accepts(jax_tiling.validate_kblock, kb) for kb in range(1, 65)]
    assert ours == theirs


def test_config_takes_prefill_chunk_17_at_kblock_16():
    """The served config of the chip run: tmux-12l-768h, paged, every
    kernel on, prefill_chunk 17, kblock_pages 16 (the earlier check refused
    kblock >= 10 at bf16 hd 64 ps 16)."""
    from repro_torch.configs import base as torch_base
    from repro_torch.configs.registry import get_config

    cfg = get_config("tmux-12l-768h")
    serving = torch_base.ServingConfig(paged=True, page_size=16,
                                       use_kernel=True, fuse_demux=True,
                                       prefill_chunk=17, kblock_pages=16)
    cfg = dataclasses.replace(cfg, serving=serving,
                              mux=dataclasses.replace(cfg.mux,
                                                      use_kernel=True))
    assert cfg.serving.kblock_pages == 16
    plan = paged_kernel.plan(8, 17, cfg.n_heads, cfg.n_kv_heads,
                             cfg.head_dim_, 16, 9, 16, cfg.compute_dtype)
    assert (plan.rows, plan.groups, plan.splits) == (17, 2, 1)


def test_paged_plan_at_the_slice():
    """B 8 x 12 KV heads is 96 clusters: 5 splits of 2 entries fill the
    card with 480 blocks; a long context takes the most splits that keep
    ~4 blocks per SM."""
    plan = paged_kernel.plan(8, 1, 12, 12, 64, 16, 9, 1, torch.bfloat16)
    assert (plan.splits, plan.entries, plan.stages) == (5, 2, 4)
    plan = paged_kernel.plan(8, 1, 12, 12, 64, 16, 64, 1, torch.bfloat16)
    assert plan.splits == 6 and plan.entries == 11
    plan = paged_kernel.plan(1, 1, 4, 4, 64, 16, 64, 1, torch.bfloat16)
    assert plan.splits == 8      # few (slot, head) pairs: the most splits
    assert paged_kernel.plan(8, 1, 12, 12, 64, 16, 9, 1, torch.bfloat16,
                             sms=16).splits == 1


@pytest.mark.parametrize("kw,exc,match", [
    (dict(dtype=torch.float16), TypeError, "float16"),
    (dict(h=6, kvh=4), ValueError, "do not group"),
    (dict(hd=0), ValueError, "head_dim 0"),
    (dict(hd=272), ValueError, "head_dim 272"),
    (dict(kblock=0), ValueError, "kblock_pages must be >= 1"),
    (dict(kblock=8192), ValueError, "kblock_pages to <=")])  # > 12 MiB
def test_paged_plan_raises_on_what_the_kernel_does_not_take(kw, exc, match):
    args = dict(b=2, c=1, h=4, kvh=2, hd=64, ps=16, max_pages=8, kblock=1,
                dtype=torch.bfloat16) | kw
    with pytest.raises(exc, match=match):
        paged_kernel.plan(**args)


@pytest.mark.parametrize("kw", [
    dict(hd=20), dict(hd=48),              # 2.5 and 6 loads per key row
    dict(c=5, h=16, kvh=4),                # 20 query rows
    dict(kblock=64)])                      # a 64-page K-block
def test_paged_plan_takes_what_it_refused(kw):
    """The earlier refusals (not a power of two of 16-byte loads, more than 16
    query rows, a K-block beyond its ring's budget) now plan, and the plan
    covers every row and entry once."""
    args = dict(b=2, c=1, h=4, kvh=2, hd=64, ps=16, max_pages=8, kblock=1,
                dtype=torch.bfloat16) | kw
    plan = paged_kernel.plan(**args)
    shape = tuple(args[k] for k in ("b", "c", "h", "kvh", "hd", "ps",
                                    "max_pages"))
    check_plan_covers(plan, shape, args["kblock"], args["dtype"])


def split_merge_model(q, k_pages, v_pages, pos_pages, bt, q_pos, *, scale,
                      causal, window, kblock, itemsize):
    """The CUDA kernel's algorithm in plain PyTorch (float64): per (slot,
    KV head), each split of the plan walks its entries, each mapped page
    in the plan's boxes (ring stages); key row `row` of a box goes to the
    online-softmax stream of consumer warp (row // KPW) % 4, lane group
    row % KPW (KPW = 32 / the plan's lanes per key row), in log2 space
    with NEG_INF = -1e30; unmapped entries are neither read nor counted.
    Row groups only partition the query rows, whose streams are
    independent, so the model takes every row at once.  Streams merge by
    exp2(m - M) weights and the output is acc / max(l, 1e-30)."""
    b, c, h, hd = q.shape
    kvh, ps, mp = k_pages.shape[2], k_pages.shape[1], bt.shape[1]
    n_rep, rows = h // kvh, c * (h // kvh)
    plan = paged_kernel.plan(b, c, h, kvh, hd, ps, mp, kblock,
                             torch.float32 if itemsize == 4
                             else torch.bfloat16)
    kpw = 32 // plan.lanes
    # q as (B, KVH, R, hd), row r = c * n_rep + rep, scaled into log2 space
    qs = (q.double().reshape(b, c, kvh, n_rep, hd).permute(0, 2, 1, 3, 4)
          .reshape(b, kvh, rows, hd) * scale * LOG2E)
    qp = q_pos.long().repeat_interleave(n_rep, dim=1)           # (B, R)
    n_streams = plan.splits * 4 * kpw
    m = torch.full((b, kvh, n_streams, rows), NEG_INF, dtype=torch.float64)
    lsum = torch.zeros_like(m)
    acc = torch.zeros((b, kvh, n_streams, rows, hd), dtype=torch.float64)
    for s in range(plan.splits):
        for e in plan.split_entries(s, mp):
            page = bt[:, e].long()                               # (B,)
            live = page >= 0
            pg = page.clamp(min=0)
            for box in plan.boxes(ps):
                for o in box:
                    row = o - box.start
                    sid = (s * 4 + (row // kpw) % 4) * kpw + row % kpw
                    kp = torch.where(live, pos_pages[pg, o].long(), -1)
                    kk = k_pages[pg, o].double()         # (B, KVH, hd)
                    vv = v_pages[pg, o].double()
                    sc = torch.einsum("bhrd,bhd->bhr", qs, kk)
                    diff = qp - kp[:, None]              # (B, R)
                    keep = (kp[:, None] >= 0) & (diff >= 0 if causal
                                                 else True)
                    if window is not None:
                        keep = keep & (diff < window)
                    sc = torch.where(keep[:, None, :], sc, NEG_INF)
                    m_old = m[:, :, sid]
                    m_new = torch.maximum(m_old, sc)
                    alpha = torch.exp2(m_old - m_new)
                    p = torch.exp2(sc - m_new)
                    upd = live[:, None, None]
                    lsum[:, :, sid] = torch.where(
                        upd, lsum[:, :, sid] * alpha + p, lsum[:, :, sid])
                    acc[:, :, sid] = torch.where(
                        upd[..., None], acc[:, :, sid] * alpha[..., None]
                        + p[..., None] * vv[:, :, None, :], acc[:, :, sid])
                    m[:, :, sid] = torch.where(upd, m_new, m_old)
    mx = m.amax(dim=2, keepdim=True)
    w = torch.exp2(m - mx)
    o = (w[..., None] * acc).sum(2) / (w * lsum).sum(2).clamp(
        min=1e-30)[..., None]                                    # (B,KVH,R,hd)
    return (o.reshape(b, kvh, c, n_rep, hd).permute(0, 2, 1, 3, 4)
            .reshape(b, c, h, hd))


def unmapped_split_case(b, h, kvh, hd, ps, mp, c, *, seed=0):
    """paged_case with a run of 4 unmapped entries in the middle of every
    slot's table (a whole split at 4 entries or fewer per split) and every
    unreferenced page, page 0 too, planted with 1e4 keys and values whose
    positions would pass every mask."""
    q, k, v, pos, bt, q_pos = paged_case(b, h, kvh, hd, 1 + b * mp, ps, mp,
                                         c, seed=seed)
    rng = np.random.default_rng(seed + 1)
    pool = k.shape[0]
    free = list(rng.permutation(np.arange(1, pool)))
    bt[:] = -1
    pos[:] = np.arange(ps)                  # planted pages: valid-looking
    mid = (mp - 4) // 2
    for i in range(b):
        for j in list(range(mid)) + list(range(mid + 4, mp)):
            if rng.random() < 0.8:
                bt[i, j] = free.pop()
                pos[bt[i, j]] = j * ps + np.arange(ps)
    used = set(bt[bt >= 0].tolist())
    for p in range(pool):
        if p not in used:
            k[p], v[p] = 1e4, 1e4
    q_pos[:] = mp * ps - c + np.arange(c)
    return q, k, v, pos, bt, q_pos


# (b, h, kvh, hd, ps, mp, c, causal, window, kblock): n_rep 1 and 4,
# chunks, causal and windowed, kblock 1 / 2 / 4.
MERGE_CASES = [
    (2, 4, 4, 64, 4, 12, 1, True, None, 1),
    (2, 8, 2, 32, 4, 12, 2, True, 8, 1),
    (3, 4, 1, 16, 8, 9, 3, True, None, 2),
    (2, 4, 4, 64, 4, 12, 4, False, 6, 4),
    (1, 8, 2, 64, 8, 16, 1, False, None, 2),
]


@pytest.mark.parametrize("case", MERGE_CASES)
@pytest.mark.parametrize("layout", ["random", "unmapped split"])
def test_split_merge_model_matches_ref(case, layout):
    """The kernel's split-K merge, modelled in float64, against the plain
    gather version on live rows, NaN-free everywhere, on random tables
    with -1 entries and on tables whose middle splits are all unmapped
    next to pages planted with 1e4."""
    b, h, kvh, hd, ps, mp, c, causal, window, kblock = case
    if layout == "random":
        arrays = paged_case(b, h, kvh, hd, 1 + b * mp, ps, mp, c)
    else:
        arrays = unmapped_split_case(b, h, kvh, hd, ps, mp, c)
        plan = paged_kernel.plan(b, c, h, kvh, hd, ps, mp, kblock,
                                 torch.float32)
        assert plan.splits > 1
        assert any(all(arrays[4][:, e].max() < 0
                       for e in plan.split_entries(s, mp))
                   for s in range(plan.splits))
    t = [torch.from_numpy(a) for a in arrays]
    scale = hd ** -0.5
    got = split_merge_model(*t, scale=scale, causal=causal, window=window,
                            kblock=kblock, itemsize=4)
    want = ref.paged_attention(*t, scale=scale, causal=causal, window=window)
    assert bool(torch.isfinite(got).all())
    _close_live(got.float().numpy(), want.numpy(),
                live_rows(arrays, causal=causal, window=window),
                TOL["float32"])


@pytest.mark.parametrize("case_idx", [0, 2])
def test_split_merge_model_matches_pallas_interpret(case_idx):
    """The same model against the TPU kernel in interpret mode."""
    b, h, kvh, hd, ps, mp, c, causal, window, kblock = MERGE_CASES[case_idx]
    arrays = unmapped_split_case(b, h, kvh, hd, ps, mp, c, seed=2)
    jax_args, torch_args = _both(arrays, "float32")
    want = jax_paged_kernel.paged_decode_attention(
        *jax_args, scale=hd ** -0.5, causal=causal, window=window,
        kblock_pages=kblock, interpret=True)
    got = split_merge_model(*torch_args, scale=hd ** -0.5, causal=causal,
                            window=window, kblock=kblock, itemsize=4)
    _close_live(got.float().numpy(), np.asarray(want),
                live_rows(arrays, causal=causal, window=window),
                TOL["float32"])


# (b, h, kvh, hd, pool, ps, mp, c, kblock) the port's kernel refused
# before: 20 query rows (C 5 x n_rep 4), 64 (C 16 x n_rep 4), kblock 8 at
# hd 128 ps 16 (f32: past the earlier ring budget), head dims 80, 192, 256.
NEW_SHAPES = [
    (2, 16, 4, 32, 9, 8, 4, 5, 1),
    (1, 16, 4, 32, 9, 8, 4, 16, 2),
    (2, 4, 2, 128, 9, 16, 4, 1, 8),
    (2, 4, 2, 80, 9, 8, 4, 2, 1),
    (2, 8, 2, 192, 7, 4, 3, 1, 1),
    (2, 4, 1, 256, 7, 4, 3, 2, 1),
]


@pytest.mark.parametrize("case", NEW_SHAPES)
def test_plain_paged_matches_pallas_at_new_shapes(case):
    """The port's op (its plain version on a CPU tensor) against the TPU
    kernel in interpret mode, f32, live rows."""
    *shape, kblock = case
    arrays = paged_case(*shape, seed=3)
    jax_args, torch_args = _both(arrays, "float32")
    hd = shape[3]
    want = jax_paged_kernel.paged_decode_attention(
        *jax_args, scale=hd ** -0.5, causal=True, window=None,
        kblock_pages=kblock, interpret=True)
    got = ops.paged_attention(*torch_args, scale=hd ** -0.5, causal=True,
                              use_kernel=True, kblock_pages=kblock)
    _close_live(got.numpy(), np.asarray(want),
                live_rows(arrays, causal=True, window=None), TOL["float32"])


@pytest.mark.parametrize("case", NEW_SHAPES)
def test_split_merge_model_at_new_shapes(case):
    """The kernel's streams and merge at the new shapes (row groups, lane
    groups padded past the key row, two vectors per lane at f32 hd 256)
    against the plain version."""
    b, h, kvh, hd, pool, ps, mp, c, kblock = case
    arrays = paged_case(b, h, kvh, hd, pool, ps, mp, c, seed=4)
    t = [torch.from_numpy(a) for a in arrays]
    got = split_merge_model(*t, scale=hd ** -0.5, causal=True, window=None,
                            kblock=kblock, itemsize=4)
    want = ref.paged_attention(*t, scale=hd ** -0.5, causal=True)
    assert bool(torch.isfinite(got).all())
    _close_live(got.float().numpy(), want.numpy(),
                live_rows(arrays, causal=True, window=None), TOL["float32"])

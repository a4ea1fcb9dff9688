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
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("kblock", [1, 2, 4])
@pytest.mark.parametrize("shape", PLAN_SHAPES)
def test_paged_plan_covers_every_entry_once(shape, kblock, dtype):
    """Every block-table entry is walked by exactly one split, each split's
    run starts on a K-block boundary, no split is empty, S <= 8, and the
    block's shared memory fits."""
    b, c, h, kvh, hd, ps, mp = shape
    ring = 3 * paged_kernel.stage_bytes(kblock, ps, hd,
                                        dtype.itemsize)
    if ring > paged_kernel.KBLOCK_STAGE_BUDGET:   # f32, hd 128, kblock 4
        with pytest.raises(ValueError, match="kblock_pages to <="):
            paged_kernel.plan(b, c, h, kvh, hd, ps, mp, kblock, dtype)
        return
    plan = paged_kernel.plan(b, c, h, kvh, hd, ps, mp, kblock, dtype)
    assert 1 <= plan.splits <= 8 and plan.grid == (plan.splits, kvh, b)
    assert plan.entries % kblock == 0
    runs = [plan.split_entries(s, mp) for s in range(plan.splits)]
    walked = [e for r in runs for e in r]
    assert sorted(walked) == list(range(mp)) and len(set(walked)) == mp
    assert all(len(r) > 0 and r.start % kblock == 0 for r in runs)
    assert plan.smem <= SMEM_LIMIT and plan.stages >= 3
    assert plan.rows == c * (h // kvh)


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
    (dict(hd=20), ValueError, "head_dim 20"),
    (dict(hd=48), ValueError, "power of two"),      # 6 loads per row
    (dict(c=5, h=16, kvh=4), ValueError, "prefill_chunk"),   # 20 rows
    (dict(kblock=64), ValueError, "kblock_pages to <="),
    (dict(dtype=torch.float16), TypeError, "float16"),
    (dict(h=6, kvh=4), ValueError, "do not group")])
def test_paged_plan_raises_on_what_the_kernel_does_not_take(kw, exc, match):
    args = dict(b=2, c=1, h=4, kvh=2, hd=64, ps=16, max_pages=8, kblock=1,
                dtype=torch.bfloat16) | kw
    with pytest.raises(exc, match=match):
        paged_kernel.plan(**args)


def split_merge_model(q, k_pages, v_pages, pos_pages, bt, q_pos, *, scale,
                      causal, window, kblock, itemsize):
    """The CUDA kernel's algorithm in plain PyTorch (float64): per (slot,
    KV head), each split of the plan walks its entries; key row `row` of a
    K-block goes to the online-softmax stream of consumer warp (row // KPW)
    % 4, lane group row % KPW (G = hd * itemsize / 16 lanes per row, KPW =
    32 / G), in log2 space with NEG_INF = -1e30; unmapped entries are
    neither read nor counted.  Streams merge by exp2(m - M) weights and
    the output is acc / max(l, 1e-30)."""
    b, c, h, hd = q.shape
    kvh, ps, mp = k_pages.shape[2], k_pages.shape[1], bt.shape[1]
    n_rep, rows = h // kvh, c * (h // kvh)
    plan = paged_kernel.plan(b, c, h, kvh, hd, ps, mp, kblock,
                             torch.float32 if itemsize == 4
                             else torch.bfloat16)
    kpw = 32 // (hd * itemsize // 16)
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
            j = (e - s * plan.entries) % kblock
            page = bt[:, e].long()                               # (B,)
            live = page >= 0
            pg = page.clamp(min=0)
            for o in range(ps):
                row = j * ps + o
                sid = (s * 4 + (row // kpw) % 4) * kpw + row % kpw
                kp = torch.where(live, pos_pages[pg, o].long(), -1)
                kk = k_pages[pg, o].double()                     # (B,KVH,hd)
                vv = v_pages[pg, o].double()
                sc = torch.einsum("bhrd,bhd->bhr", qs, kk)
                diff = qp - kp[:, None]                          # (B, R)
                keep = (kp[:, None] >= 0) & (diff >= 0 if causal else True)
                if window is not None:
                    keep = keep & (diff < window)
                sc = torch.where(keep[:, None, :], sc, NEG_INF)
                m_old = m[:, :, sid]
                m_new = torch.maximum(m_old, sc)
                alpha, p = torch.exp2(m_old - m_new), torch.exp2(sc - m_new)
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

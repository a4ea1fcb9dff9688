"""The port's plain paged-attention decode against the JAX package's: its
gather reference over ``PAGED_SWEEP`` (f32 atol 1e-5, bf16 2e-2, live rows
only — rows with no valid key are garbage in every implementation), the
Pallas kernel in interpret mode on two cases, and the bitwise identity of a
pool that mirrors a contiguous cache with the port's contiguous decode.
Inputs come from numpy with a seed."""
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.kernels.paged_attention import kernel as jax_paged_kernel
from repro.kernels.paged_attention import ref as jax_paged_ref
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

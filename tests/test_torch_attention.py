"""The port's ``Attention`` against the JAX package's: full sequence,
prefill into a cache, and contiguous single-token decode with a scalar or a
(B,) cache index; GQA (n_kv_heads < n_heads), causal and bidirectional.
Weights and inputs come from numpy with a seed; f32, atol 1e-5."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.nn import attention as jax_attn
from repro_torch.nn import attention as torch_attn

ATOL = 1e-5
B, D, H, HD = 2, 32, 4, 8


def _setup(kv_heads, causal, seed=0):
    rng = np.random.default_rng(seed)
    jcfg = jax_attn.AttnConfig(dim=D, n_heads=H, n_kv_heads=kv_heads,
                               head_dim=HD, qkv_bias=True, causal=causal)
    tcfg = torch_attn.AttnConfig(dim=D, n_heads=H, n_kv_heads=kv_heads,
                                 head_dim=HD, qkv_bias=True, causal=causal)
    module = torch_attn.Attention(tcfg, device="cpu")
    params = {}
    for name in ("wq", "wk", "wv", "wo"):
        layer = getattr(module, name)
        out_dim, in_dim = layer.weight.shape
        w = rng.standard_normal((in_dim, out_dim)).astype(np.float32) \
            / np.sqrt(in_dim)
        params[name] = {"w": jnp.asarray(w)}
        with torch.no_grad():
            layer.weight.copy_(torch.from_numpy(w.T.copy()))
            if layer.bias is not None:
                b = 0.1 * rng.standard_normal(out_dim).astype(np.float32)
                layer.bias.copy_(torch.from_numpy(b))
                params[name]["b"] = jnp.asarray(b)
    return jcfg, params, module, rng


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                               atol=ATOL, rtol=0)


CASES = pytest.mark.parametrize("kv_heads,causal", [(4, True), (2, True),
                                                    (1, False), (2, False)])


@CASES
def test_full_sequence(kv_heads, causal):
    jcfg, params, module, rng = _setup(kv_heads, causal)
    x = rng.standard_normal((B, 11, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(11), (B, 11)).astype(np.int32)
    want, _ = jax_attn.Attention.apply(params, jnp.asarray(x), jcfg,
                                       positions=jnp.asarray(pos))
    got, cache = module(torch.from_numpy(x), positions=torch.from_numpy(pos))
    assert cache is None
    _close(got, want)


@CASES
@pytest.mark.parametrize("vector_index", [False, True])
def test_prefill_then_decode(kv_heads, causal, vector_index):
    """Prefill 6 positions into a 10-row cache, then decode 3 tokens; the
    outputs and the cache's K/V/pos match the reference at every step."""
    jcfg, params, module, rng = _setup(kv_heads, causal)
    max_len, lp = 10, 6
    x = rng.standard_normal((B, lp, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(lp), (B, lp)).astype(np.int32)
    jcache = jax_attn.Attention.init_cache(jcfg, B, max_len, jnp.float32)
    tcache = torch_attn.Attention.init_cache(module.cfg, B, max_len,
                                             torch.float32)
    want, jcache = jax_attn.Attention.apply(
        params, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
        cache=jcache)
    with torch.no_grad():
        got, tcache = module(torch.from_numpy(x),
                             positions=torch.from_numpy(pos), cache=tcache)
    _close(got, want)
    for t in range(lp, lp + 3):
        xt = rng.standard_normal((B, 1, D)).astype(np.float32)
        ci = np.full((B,), t, np.int32) if vector_index else np.int32(t)
        pos_t = np.broadcast_to(np.asarray(ci).reshape(-1, 1), (B, 1))
        want, jcache = jax_attn.Attention.apply(
            params, jnp.asarray(xt), jcfg, positions=jnp.asarray(pos_t),
            cache=jcache, cache_index=jnp.asarray(ci))
        with torch.no_grad():
            got, tcache = module(torch.from_numpy(xt),
                                 positions=torch.from_numpy(pos_t.copy()),
                                 cache=tcache,
                                 cache_index=torch.from_numpy(
                                     np.asarray(ci)))
        _close(got, want)
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(tcache[key].numpy(),
                                   np.asarray(jcache[key]), atol=ATOL)


def test_decode_at_distinct_slot_positions():
    """A (B,) cache index writes each slot at its own position."""
    jcfg, params, module, rng = _setup(2, True, seed=1)
    jcache = jax_attn.Attention.init_cache(jcfg, B, 8, jnp.float32)
    tcache = torch_attn.Attention.init_cache(module.cfg, B, 8, torch.float32)
    for step in range(3):
        ci = np.array([step, step + 2], np.int32)
        xt = rng.standard_normal((B, 1, D)).astype(np.float32)
        want, jcache = jax_attn.Attention.apply(
            params, jnp.asarray(xt), jcfg,
            positions=jnp.asarray(ci[:, None]), cache=jcache,
            cache_index=jnp.asarray(ci))
        with torch.no_grad():
            got, tcache = module(torch.from_numpy(xt),
                                 positions=torch.from_numpy(ci[:, None]),
                                 cache=tcache,
                                 cache_index=torch.from_numpy(ci))
        _close(got, want)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_attention_matches_reference_and_dense(causal):
    """The online-softmax form the port switches to at >= 8192 keys, run
    here with small chunks: equal to the reference's and to dense."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((B, 40, H, HD)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(40), (B, 40)).astype(np.int32)
    want = jax_attn.chunked_dot_product_attention(
        q, k, v, pos, pos, 0.3, causal=causal, window=None, chunk=16)
    tq, tk, tv, tpos = map(torch.from_numpy, (q, k, v, pos.copy()))
    got = torch_attn.chunked_dot_product_attention(
        tq, tk, tv, tpos, tpos, 0.3, causal=causal, chunk=16)
    _close(got, want)
    mask = torch_attn.make_attention_mask(tpos, tpos, causal=causal)
    dense = torch_attn.dot_product_attention(tq, tk, tv, mask, 0.3)
    torch.testing.assert_close(got, dense, atol=ATOL, rtol=0)


def test_rope_matches_reference():
    rng = np.random.default_rng(3)
    x = rng.standard_normal((B, 5, H, HD)).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 9, 11, 13, 15]], np.int32)
    want = jax_attn.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = torch_attn.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                                1e4)
    _close(got, want)

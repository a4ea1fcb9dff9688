"""The port's flash attention path against the JAX package's, on the CPU:
the plain version (``repro_torch.kernels.attention.ref``, what the CPU runs
in place of the CUDA kernel) against the Pallas kernel in interpret mode
and against the reference's oracle; ``Attention`` with ``use_flash`` against
``Attention.apply`` with ``AttnConfig(use_flash=True)`` and no cache; and
``Backbone(use_flash=True)`` against ``Backbone.apply`` on the small qwen
config.  Inputs come from numpy with a seed.

Tolerances: the reference's kernel tests' (``tests/test_kernels.py``):
2e-5 in f32, 4e-2 in bf16 (the plain version rounds the probabilities to
bf16 before P·V, the Pallas kernel does not); 1e-5 for the attention
module in f32 and 1e-4 for the backbone's logits, as the other parity
tests."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.kernels.attention import kernel as jax_kernel
from repro.kernels.attention import ref as jax_ref
from repro.models import Backbone as JaxBackbone
from repro.nn import attention as jax_attn
from repro_torch.kernels import _build
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.nn import attention as torch_attn
from torch_parity import as_torch, bridged, configs, tokens

TOLS = {"float32": dict(rtol=2e-5, atol=2e-5),
        "bfloat16": dict(rtol=4e-2, atol=4e-2)}
JAX_DTYPES = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _qkv(shape_q, shape_k, dtype, *, seed=0, scale=1.0, shared=False):
    """q, k, v as (jax, torch) pairs of the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrays = [scale * rng.standard_normal(shape_q).astype(np.float32)]
    arrays += arrays * 2 if shared else \
        [rng.standard_normal(shape_k).astype(np.float32) for _ in range(2)]
    jx = [jnp.asarray(a).astype(JAX_DTYPES[dtype]) for a in arrays]
    tx = [torch.from_numpy(a).to(TORCH_DTYPES[dtype]) for a in arrays]
    return jx, tx


def _close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               **TOLS[dtype])


@pytest.mark.parametrize("oracle", ["pallas_interpret", "jax_ref"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,l,h,hd", [
    (1, 8, 1, 64),       # single tile
    (2, 37, 4, 64),      # ragged L
    (1, 256, 2, 128),    # exact multi-tile
    (1, 520, 2, 64),     # pad + many K blocks
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_reference(oracle, dtype, b, l, h, hd, causal):
    (jq, jk, jv), (tq, tk, tv) = _qkv((b, l, h, hd), (b, l, h, hd), dtype)
    if oracle == "pallas_interpret":
        want = jax_kernel.flash_attention(jq, jk, jv, causal=causal,
                                          interpret=True)
    else:
        want = jax_ref.flash_attention(jq, jk, jv, causal=causal)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    assert got.dtype == TORCH_DTYPES[dtype] and got.shape == (b, l, h, hd)
    _close(got, want, dtype)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("lq,lk", [(37, 45), (45, 37)])
def test_plain_flash_query_and_key_lengths_differ(causal, lq, lk):
    """Lq != Lk: the causal mask is aligned top-left (key j for query i
    when j <= i) in the kernel, the oracle and the port alike."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, lq, 2, 128), (1, lk, 2, 128),
                                      "float32", seed=3)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    for want in (jax_kernel.flash_attention(jq, jk, jv, causal=causal,
                                            interpret=True),
                 jax_ref.flash_attention(jq, jk, jv, causal=causal)):
        _close(got, want, "float32")


def test_plain_flash_scale_override():
    (jq, _, _), (tq, _, _) = _qkv((1, 32, 2, 64), (1, 32, 2, 64), "float32",
                                  seed=1, shared=True)
    got = flash_ops.flash_attention(tq, tq, tq, causal=True, scale=0.05)
    for want in (jax_kernel.flash_attention(jq, jq, jq, causal=True,
                                            scale=0.05, interpret=True),
                 jax_ref.flash_attention(jq, jq, jq, causal=True,
                                         scale=0.05)):
        _close(got, want, "float32")


def test_plain_flash_long_context_numerics():
    """Large-magnitude logits (8 * randn queries) stay finite and agree."""
    (jq, _, _), (tq, _, _) = _qkv((1, 128, 1, 64), (1, 128, 1, 64),
                                  "float32", seed=2, scale=8.0, shared=True)
    got = flash_ops.flash_attention(tq, tq, tq, causal=True)
    assert bool(torch.isfinite(got).all())
    want = jax_kernel.flash_attention(jq, jq, jq, causal=True,
                                      interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)


def test_ops_on_cpu_takes_the_plain_version():
    _, (tq, tk, tv) = _qkv((1, 8, 1, 64), (1, 8, 1, 64), "float32")
    _build.LAUNCHES.clear()
    flash_ops.flash_attention(tq, tk, tv)
    assert not _build.LAUNCHES


# ---------------------------------------------------------------------------
# Attention with use_flash
# ---------------------------------------------------------------------------

D, H, KV, HD = 32, 4, 2, 64   # GQA n_rep 2, the kernel's head dim


def _attention(causal, use_flash, seed=0):
    rng = np.random.default_rng(seed)
    jcfg = jax_attn.AttnConfig(dim=D, n_heads=H, n_kv_heads=KV, head_dim=HD,
                               qkv_bias=True, causal=causal,
                               use_flash=use_flash)
    tcfg = torch_attn.AttnConfig(dim=D, n_heads=H, n_kv_heads=KV,
                                 head_dim=HD, qkv_bias=True, causal=causal,
                                 use_flash=use_flash)
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
                bias = 0.1 * rng.standard_normal(out_dim).astype(np.float32)
                layer.bias.copy_(torch.from_numpy(bias))
                params[name]["b"] = jnp.asarray(bias)
    x = rng.standard_normal((2, 19, D)).astype(np.float32)
    pos = np.broadcast_to(np.arange(19), (2, 19)).astype(np.int32)
    return jcfg, params, module, x, pos


def _count_flash_calls(monkeypatch) -> list:
    calls = []
    real = flash_ops.flash_attention

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("causal", [True, False])
def test_attention_use_flash_matches_reference(causal, monkeypatch):
    """Causal: both packages take their flash branch (the reference runs
    its Pallas kernel in interpret mode); bidirectional: both take the
    plain branch, as the reference's guard says."""
    calls = _count_flash_calls(monkeypatch)
    jcfg, params, module, x, pos = _attention(causal, use_flash=True)
    want, cache = jax_attn.Attention.apply(params, jnp.asarray(x), jcfg,
                                           positions=jnp.asarray(pos))
    assert cache is None
    with torch.no_grad():
        got, tcache = module(torch.from_numpy(x),
                             positions=torch.from_numpy(pos))
    assert tcache is None
    assert len(calls) == (1 if causal else 0)
    if causal:
        assert calls[0] == dict(causal=True, scale=HD ** -0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_attention_prefill_never_takes_flash(monkeypatch):
    """A cache makes the call a prefill: the plain branch, even with
    use_flash, as in the reference."""
    calls = _count_flash_calls(monkeypatch)
    jcfg, params, module, x, pos = _attention(True, use_flash=True)
    jcache = jax_attn.Attention.init_cache(jcfg, 2, 24, jnp.float32)
    tcache = torch_attn.Attention.init_cache(module.cfg, 2, 24,
                                             torch.float32)
    want, _ = jax_attn.Attention.apply(params, jnp.asarray(x), jcfg,
                                       positions=jnp.asarray(pos),
                                       cache=jcache)
    with torch.no_grad():
        got, _ = module(torch.from_numpy(x), positions=torch.from_numpy(pos),
                        cache=tcache)
    assert not calls
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


# ---------------------------------------------------------------------------
# Backbone(use_flash=True)
# ---------------------------------------------------------------------------

def _jax_with_flash(monkeypatch):
    """Make the reference's config hand ``use_flash=True`` to every layer
    (no caller in the JAX package does), so its backbone runs the Pallas
    kernel in interpret mode."""
    real = jax_base.ModelConfig.attn_config

    def attn_config(self, *, window=None, use_flash=False):
        return real(self, window=window, use_flash=True)
    monkeypatch.setattr(jax_base.ModelConfig, "attn_config", attn_config)


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("use_kernel", [False, True])
@pytest.mark.parametrize("jax_flash", [False, True])
def test_backbone_use_flash_matches_reference(n, use_kernel, jax_flash,
                                              monkeypatch):
    """The port with ``use_flash`` against the reference's forward with
    its plain attention and, with its flash branch forced on, its Pallas
    kernel: logits within 1e-4; one flash call per layer."""
    jcfg, tcfg = configs("qwen", n, mux={"use_kernel": use_kernel})
    params, plain_model = bridged(jcfg, tcfg)
    model = type(plain_model)(tcfg, device="cpu", use_flash=True)
    model.load_state_dict(plain_model.state_dict())
    assert all(layer.attn.cfg.use_flash for layer in model.layers)
    assert not any(layer.attn.cfg.use_flash for layer in plain_model.layers)
    toks = tokens(tcfg, 2, 12)
    if jax_flash:
        _jax_with_flash(monkeypatch)
    want = JaxBackbone.apply(params, jnp.asarray(toks), jcfg)
    calls = _count_flash_calls(monkeypatch)
    with torch.no_grad():
        got = model(as_torch(toks))
    assert len(calls) == tcfg.n_layers
    assert float(got["aux"]) == 0.0
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4, rtol=0)


def test_bidirectional_backbone_ignores_use_flash(monkeypatch):
    """T-MUX is bidirectional: ``use_flash`` leaves it on the plain path."""
    jcfg, tcfg = configs("tmux", 2)
    params, plain_model = bridged(jcfg, tcfg)
    model = type(plain_model)(tcfg, device="cpu", use_flash=True)
    model.load_state_dict(plain_model.state_dict())
    calls = _count_flash_calls(monkeypatch)
    toks = tokens(tcfg, 2, 9)
    with torch.no_grad():
        got = model(as_torch(toks))
        ref = plain_model(as_torch(toks))
    assert not calls
    assert torch.equal(got["logits"], ref["logits"])


def test_attn_config_keyword_matches_reference():
    jcfg, tcfg = configs("qwen", 2)
    for use_flash in (False, True):
        ours = tcfg.attn_config(use_flash=use_flash)
        theirs = jcfg.attn_config(use_flash=use_flash)
        for f in dataclasses.fields(ours):
            assert getattr(ours, f.name) == getattr(theirs, f.name), f.name


# ---------------------------------------------------------------------------
# Head dims the CUDA kernel took no more than 64 and 128 of before
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("oracle", ["pallas_interpret", "jax_ref"])
@pytest.mark.parametrize("hd", [32, 80, 192, 256])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_reference_at_every_head_dim(oracle, hd, causal):
    """f32, Lq 37 against Lk 45 (ragged against every tile): the plain
    version, what the CPU runs for the kernel, against the Pallas kernel
    in interpret mode and the reference's oracle, atol 1e-5."""
    (jq, jk, jv), (tq, tk, tv) = _qkv((1, 37, 2, hd), (1, 45, 2, hd),
                                      "float32", seed=5)
    if oracle == "pallas_interpret":
        want = jax_kernel.flash_attention(jq, jk, jv, causal=causal,
                                          interpret=True)
    else:
        want = jax_ref.flash_attention(jq, jk, jv, causal=causal)
    got = flash_ops.flash_attention(tq, tk, tv, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_backbone_use_flash_at_head_dim_256_with_gqa(monkeypatch):
    """A 2-layer causal backbone with 4 heads of 256 over 2 KV heads (the
    gemma head width; d_model 64, so q/k/v project up), in both packages
    on bridged weights: the port with ``use_flash`` against the reference
    with its flash branch forced on (Pallas in interpret mode), logits
    within 1e-4, one flash call per layer."""
    jcfg, tcfg = configs("qwen", 2, mux={"use_kernel": True})
    jcfg = dataclasses.replace(jcfg, head_dim=256)
    tcfg = dataclasses.replace(tcfg, head_dim=256)
    assert (tcfg.n_heads, tcfg.n_kv_heads, tcfg.head_dim_) == (4, 2, 256)
    params, plain_model = bridged(jcfg, tcfg)
    model = type(plain_model)(tcfg, device="cpu", use_flash=True)
    model.load_state_dict(plain_model.state_dict())
    toks = tokens(tcfg, 2, 12)
    _jax_with_flash(monkeypatch)
    want = JaxBackbone.apply(params, jnp.asarray(toks), jcfg)
    calls = _count_flash_calls(monkeypatch)
    with torch.no_grad():
        got = model(as_torch(toks))
    assert len(calls) == tcfg.n_layers == 2
    np.testing.assert_allclose(got["logits"].numpy(),
                               np.asarray(want["logits"]), atol=1e-4, rtol=0)

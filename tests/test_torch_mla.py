"""The port's Multi-head Latent Attention (``repro_torch.nn.attention.MLA``)
and the model that runs it, deepseek-v3-671b, against the JAX package.

* The module against ``repro.nn.attention.MLA.apply`` on bridged weights,
  f32, within 1e-5, in every mode: the cache-free forward below the
  chunked-attention threshold and at it (both packages' threshold lowered
  with ``monkeypatch``), a prefill into a latent cache, contiguous decode
  at a scalar and a per-slot ``cache_index``, paged decode, and chunked
  decode, contiguous and paged, with ragged ``chunk_lens``; the paged
  forms bitwise the contiguous ones inside the port; the gather of
  unmapped pages; the caches' layout.
* ``deepseek-v3-671b-smoke`` (4 layers, d 256, MLA latent 32 + rope 16,
  4 experts top-2 and a shared expert, layer 0 dense, f32): the config
  field for field, forward and decode steps within 1e-4, paged decode
  steps and pools against the reference's, the bridge and ``decay_mask``,
  train and eval steps; the port's versions of ``tests/test_paging.py``'s
  MLA cases and of ``tests/test_serving_fuzz.py``'s MLA + MoE fuzz; the
  counts of ``results/bench/serving_moe.json``; the JAX scheduler's
  counts and tokens; the cache bytes; the serve launcher.

Every test runs with one torch thread (the autouse fixture below).
"""
import dataclasses
import functools
import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.models import Backbone as JaxBackbone
from repro.nn import attention as jax_attention
from repro.nn.attention import MLA as JaxMLA
from repro.nn.attention import MLAConfig as JaxMLAConfig
from repro.serving import kvcache as jax_kvcache
from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeState as JaxServeState
from repro.serving.paging import PagedKVSlotAllocator as JaxPagedAllocator
from repro.serving.scheduler import ContinuousScheduler as JaxScheduler
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer
from repro_torch import data as torch_data
from repro_torch.bridge import cache_from_jax, decay_mask, params_from_jax
from repro_torch.configs import base as torch_base
from repro_torch.configs import registry as torch_registry
from repro_torch.launch import serve
from repro_torch.models import Backbone
from repro_torch.nn import attention as torch_attention
from repro_torch.nn.attention import MLA, MLAConfig
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Engine, ServeState
from repro_torch.serving.kvcache import KVSlotAllocator
from repro_torch.serving.paging import PagedKVSlotAllocator, pages_for
from repro_torch.serving.scheduler import (ContinuousScheduler, Request,
                                           poisson_trace)
from repro_torch.serving.telemetry import Tracer
from repro_torch.training.trainer import TrainConfig, Trainer
from torch_parity import as_torch, tokens

ARCH = "deepseek-v3-671b"
RESULTS = Path(__file__).resolve().parents[1] / "results" / "bench"
# A small MLA with every width distinct, so that a transposed or swapped
# reshape cannot pass: d 40, 4 heads, q rank 24, latent 16, nope 8, rope 6,
# v 12.
MLA_KW = dict(dim=40, n_heads=4, q_lora_rank=24, kv_lora_rank=16,
              qk_nope_head_dim=8, qk_rope_head_dim=6, v_head_dim=12)
B = 3
# The reference's functions, compiled once per shape (its eager op-by-op
# dispatch costs most of this file's time otherwise); the config is static.
JAX_MLA_APPLY = jax.jit(JaxMLA.apply, static_argnums=(2,))
JAX_INIT = jax.jit(JaxBackbone.init, static_argnums=(1,))
JAX_FORWARD = jax.jit(JaxBackbone.apply, static_argnums=(2,))
JAX_DECODE = jax.jit(JaxBackbone.decode_step, static_argnums=(4,))
JAX_GRADS = jax.jit(jax.value_and_grad(JaxTrainer.loss_fn, has_aux=True),
                    static_argnums=(3, 4))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _module(key=0):
    """(jax params, jax cfg, port MLA with the same weights)."""
    jcfg = JaxMLAConfig(**MLA_KW)
    params = JaxMLA.init(jax.random.PRNGKey(key), jcfg)
    model = MLA(MLAConfig(**MLA_KW))
    # the bridge reads only the layer count of the config
    state = params_from_jax({"head_layers": [{"attn": jax.tree.map(
        np.asarray, params)}]}, SimpleNamespace(n_layers=1, name="mla"))
    model.load_state_dict({k.removeprefix("layers.0.attn."): v
                           for k, v in state.items()}, strict=True)
    return params, jcfg, model.eval()


def _caches(jcfg, *, batch=B, max_len=None, pool=None):
    """(jax cache, port cache) fresh, f32: contiguous of ``max_len`` rows,
    or a pool of ``pool`` = (pages, page_size)."""
    cfg = MLAConfig(**MLA_KW)
    if pool is not None:
        return (JaxMLA.init_paged_cache(jcfg, *pool, jnp.float32),
                MLA.init_paged_cache(cfg, *pool, torch.float32))
    return (JaxMLA.init_cache(jcfg, batch, max_len, jnp.float32),
            MLA.init_cache(cfg, batch, max_len, torch.float32))


def _cache_close(got: dict, want: dict, skip_trash=False):
    assert got.keys() == want.keys()
    for k in got:
        g, w = _np(got[k]), np.asarray(want[k])
        if skip_trash:                 # duplicate trash writes may race
            g, w = g[1:], w[1:]
        if k == "pos":
            np.testing.assert_array_equal(g, w)
        else:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=0)


def _apply(params, jcfg, model, x, positions, jcache=None, tcache=None,
           jit=True, **kw):
    """One call of each package on the same inputs; returns ((want, new
    jax cache), (got, port cache)).  ``jit=False`` runs the reference
    eagerly, reading its module globals at the call."""
    jkw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(np.asarray(v)) if isinstance(v, np.ndarray)
               else v) for k, v in kw.items()}
    want = (JAX_MLA_APPLY if jit else JaxMLA.apply)(
        params, jnp.asarray(x), jcfg,
        positions=jnp.asarray(positions), cache=jcache, **jkw)
    with torch.no_grad():
        got = model(torch.from_numpy(x),
                    positions=torch.from_numpy(np.array(positions)),
                    cache=tcache, **tkw)
    return want, got


# ---------------------------------------------------------------------------
# the module against the reference, mode by mode
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """``MLAConfig`` keeps the reference's fields, defaults and derived
    widths (q/k head 192, scale, cache row 576 at the defaults)."""
    ours = {f.name: f.default for f in dataclasses.fields(MLAConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxMLAConfig)}
    assert ours == theirs
    for kw in (MLA_KW, dict(dim=7168, n_heads=128)):
        a, b = MLAConfig(**kw), JaxMLAConfig(**kw)
        assert (a.qk_head_dim, a.scale, a.cache_width) == \
            (b.qk_head_dim, b.scale, b.cache_width)
    assert MLAConfig(dim=7168, n_heads=128).cache_width == 576


@pytest.mark.parametrize("l,chunked", [(1, False), (11, False), (11, True)])
def test_forward_matches_reference(monkeypatch, l, chunked):
    """No cache: L 1, L 11 on the masked path, and L 11 at a threshold
    lowered to 8 in both packages (the chunked online softmax, chunks of 4
    keys, so the last one is ragged); positions start at 3."""
    params, jcfg, model = _module()
    calls = []
    if chunked:
        jax_real = jax_attention.chunked_dot_product_attention
        torch_real = torch_attention.chunked_dot_product_attention

        def spy(real):
            def call(*a, **k):
                calls.append(real)
                return real(*a, **k, chunk=4)
            return call
        for mod in (jax_attention, torch_attention):
            monkeypatch.setattr(mod, "CHUNKED_ATTN_THRESHOLD", 8)
        monkeypatch.setattr(jax_attention, "chunked_dot_product_attention",
                            spy(jax_real))
        monkeypatch.setattr(torch_attention, "chunked_dot_product_attention",
                            spy(torch_real))
    x = _x((2, l, MLA_KW["dim"]), 1)
    pos = np.broadcast_to(np.arange(3, 3 + l, dtype=np.int32), (2, l))
    (want, wc), (got, gc) = _apply(params, jcfg, model, x, pos,
                                   jit=not chunked)
    assert wc is None and gc is None
    _close(got, want, 1e-5)
    assert calls == ([jax_real, torch_real] if chunked else [])


def test_prefill_fills_the_latent_cache():
    """A prefill of 5 positions into a 12-row cache: the output, and
    ``ckv`` / ``krope`` / ``pos`` from row 0 (the rest untouched, pos
    -1)."""
    params, jcfg, model = _module()
    jc, tc = _caches(jcfg, max_len=12)
    x = _x((B, 5, MLA_KW["dim"]), 2)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (B, 5))
    (want, jc), (got, tc) = _apply(params, jcfg, model, x, pos, jc, tc)
    _close(got, want, 1e-5)
    _cache_close(tc, jc)
    assert (tc["pos"][:, 5:] == -1).all()


@pytest.mark.parametrize("per_slot", [False, True])
def test_decode_matches_reference(per_slot):
    """After a prefill of 5: three one-token steps in the absorbed form,
    at a scalar ``cache_index`` (every slot at 5, 6, 7) or a (B,) one
    (slots at 5 / 8 / 6, rows between unwritten), outputs and caches at
    every step."""
    params, jcfg, model = _module()
    jc, tc = _caches(jcfg, max_len=12)
    x = _x((B, 5, MLA_KW["dim"]), 2)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (B, 5))
    (_, jc), (_, tc) = _apply(params, jcfg, model, x, pos, jc, tc)
    ci = np.array([5, 8, 6], np.int32)
    for t in range(3):
        x = _x((B, 1, MLA_KW["dim"]), 10 + t)
        if per_slot:
            index, positions = ci + t, (ci + t)[:, None]
        else:
            index = 5 + t
            positions = np.full((B, 1), 5 + t, np.int32)
        (want, jc), (got, tc) = _apply(params, jcfg, model, x, positions,
                                       jc, tc, cache_index=index)
        _close(got, want, 1e-5)
        _cache_close(tc, jc)


# Block tables of 3 slots over a pool of 12 pages of 4 positions: slot 0
# on scattered pages, slot 1 on two pages, slot 2 on none (it writes the
# trash page 0 and reads nothing).
BLOCK_TABLE = np.array([[3, 7, 1, -1], [5, 2, -1, -1], [-1, -1, -1, -1]],
                       np.int32)
POOL = (12, 4)


def _paged_fill(params, jcfg, model, jc, tc, seed=3):
    """A chunk of 4 rows per slot from position 0 into both pools
    (chunk_lens 4 / 4 / 0), so the decode tests start from written
    pages."""
    x = _x((B, 4, MLA_KW["dim"]), seed)
    pos = np.broadcast_to(np.arange(4, dtype=np.int32), (B, 4))
    return _apply(params, jcfg, model, x, pos, jc, tc,
                  block_table=BLOCK_TABLE,
                  chunk_lens=np.array([4, 4, 0], np.int32))


def test_paged_decode_matches_reference():
    """One-token paged decode at per-slot positions (6 / 5 / 0, then 7 / 6
    / 1, then those rows written again): the latent row written through
    the block table, the gathered pages attended in the absorbed form;
    outputs and every pool page but the trash page."""
    params, jcfg, model = _module()
    jc, tc = _caches(jcfg, pool=POOL)
    (_, jc), (_, tc) = _paged_fill(params, jcfg, model, jc, tc)
    ci = np.array([6, 5, 0], np.int32)
    for t in range(3):
        x = _x((B, 1, MLA_KW["dim"]), 20 + t)
        index = ci + min(t, 1)
        (want, jc), (got, tc) = _apply(
            params, jcfg, model, x, index[:, None], jc, tc,
            cache_index=index, block_table=BLOCK_TABLE)
        _close(got, want, 1e-5)
        _cache_close(tc, jc, skip_trash=True)
    assert (tc["pos"][3] == torch.tensor([0, 1, 2, 3])).all()


@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("lens", [(3, 1, 2), (2, 0, 3)])
def test_chunked_decode_matches_reference(paged, lens):
    """A chunk of 3 rows per slot at positions 4 / 2 / 0 with ragged
    ``chunk_lens`` (a slot of length 0 included): rows past a slot's
    length leave the cache as it was (contiguous: the gather, where,
    scatter write; paged: the trash page with pos -1); outputs of every
    row and the caches."""
    params, jcfg, model = _module()
    if paged:
        jc, tc = _caches(jcfg, pool=POOL)
        (_, jc), (_, tc) = _paged_fill(params, jcfg, model, jc, tc)
        extra = dict(block_table=BLOCK_TABLE)
    else:
        jc, tc = _caches(jcfg, max_len=10)
        x = _x((B, 4, MLA_KW["dim"]), 3)
        pos = np.broadcast_to(np.arange(4, dtype=np.int32), (B, 4))
        (_, jc), (_, tc) = _apply(params, jcfg, model, x, pos, jc, tc)
        extra = {}
    base = np.array([4, 2, 0], np.int32)
    positions = base[:, None] + np.arange(3, dtype=np.int32)[None, :]
    x = _x((B, 3, MLA_KW["dim"]), 30)
    (want, jc), (got, tc) = _apply(
        params, jcfg, model, x, positions, jc, tc, cache_index=base,
        chunk_lens=np.array(lens, np.int32), **extra)
    _close(got, want, 1e-5)
    _cache_close(tc, jc, skip_trash=paged)


@pytest.mark.parametrize("chunk", [1, 3])
def test_paged_equals_contiguous_bitwise(chunk):
    """Inside the port, the same writes into a latent cache of 16 rows and
    into a pool of pages of 4 through a scattered block table (4 pages a
    slot, the last of slot 2 unmapped) give bitwise the same outputs: a
    prefix of 4 positions as a chunk, then one-token or 3-row chunked
    steps at per-slot positions."""
    _, jcfg, model = _module()
    cont = MLA.init_cache(model.cfg, B, 16, torch.float32)
    pool = MLA.init_paged_cache(model.cfg, 14, 4, torch.float32)
    bt = torch.tensor([[3, 7, 1, 9], [5, 2, 12, 4], [6, 13, 10, -1]],
                      dtype=torch.int32)
    # garbage on the trash page and on page 11, which no table maps
    pool["ckv_pages"][0] = 7.0
    pool["ckv_pages"][11] = -3.0
    pool["pos"][11] = 2
    rng = np.random.default_rng(4)
    step = [(np.zeros(B, np.int32), 4, np.array([4, 4, 4]))]
    start = np.array([4, 6, 2], np.int32)      # slot 2 stays below 12
    for t in range(3):
        step.append((start + t * chunk, chunk,
                     np.array([chunk, max(chunk - 1, 1), chunk])))
    with torch.no_grad():
        for base, c, lens in step:
            x = torch.from_numpy(rng.normal(
                size=(B, c, MLA_KW["dim"])).astype(np.float32))
            positions = torch.from_numpy(base[:, None] + np.arange(c)[None])
            kw = dict(cache_index=torch.from_numpy(base))
            if c > 1:
                kw["chunk_lens"] = torch.from_numpy(lens)
            a, _ = model(x, positions=positions, cache=cont, **kw)
            b, _ = model(x, positions=positions, cache=pool, block_table=bt,
                         **kw)
            assert torch.equal(a, b)


def test_unmapped_pages_gather_as_the_reference():
    """``_gather_paged_latents``: positions in page order, unmapped entries
    reading the trash page with pos -1, bitwise the reference's on a pool
    of random content."""
    rng = np.random.default_rng(5)
    cfg = MLAConfig(**MLA_KW)
    pool = {"ckv_pages": rng.normal(size=(12, 4, cfg.kv_lora_rank)),
            "krope_pages": rng.normal(size=(12, 4, cfg.qk_rope_head_dim)),
            "pos": rng.integers(-1, 9, (12, 4))}
    pool = {k: v.astype(np.int32 if k == "pos" else np.float32)
            for k, v in pool.items()}
    want = JaxMLA._gather_paged_latents(
        {k: jnp.asarray(v) for k, v in pool.items()},
        jnp.asarray(BLOCK_TABLE))
    got = MLA._gather_paged_latents(
        {k: torch.from_numpy(v) for k, v in pool.items()},
        torch.from_numpy(BLOCK_TABLE))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert (got[2][2] == -1).all() and (got[2][1, 8:] == -1).all()


def test_caches_have_the_references_layout():
    """``init_cache`` and ``init_paged_cache``: keys, shapes and dtypes of
    the reference's, zeros and pos -1."""
    jcfg = JaxMLAConfig(**MLA_KW)
    cfg = MLAConfig(**MLA_KW)
    for mine, theirs in (
            (MLA.init_cache(cfg, 2, 9), JaxMLA.init_cache(jcfg, 2, 9)),
            (MLA.init_paged_cache(cfg, 5, 4),
             JaxMLA.init_paged_cache(jcfg, 5, 4))):
        assert mine.keys() == theirs.keys()
        for k in mine:
            assert tuple(mine[k].shape) == theirs[k].shape
            assert str(mine[k].dtype).removeprefix("torch.") == \
                str(theirs[k].dtype)
            np.testing.assert_array_equal(mine[k].float().numpy(),
                                          np.asarray(theirs[k], np.float32))


def test_paged_latents_need_a_block_table_and_no_prefill():
    _, _, model = _module()
    pool = MLA.init_paged_cache(model.cfg, 4, 4, torch.float32)
    x = torch.zeros((1, 2, MLA_KW["dim"]))
    with pytest.raises(ValueError, match="block_table"):
        model(x[:, :1], positions=torch.zeros((1, 1), dtype=torch.int32),
              cache=pool, cache_index=0)
    with pytest.raises(ValueError, match="prefill"):
        model(x, positions=torch.zeros((1, 2), dtype=torch.int32),
              cache=pool)


# ---------------------------------------------------------------------------
# deepseek-v3-671b
# ---------------------------------------------------------------------------

def _cfgs(n, *, moe=None, **serving):
    """(jax cfg, torch cfg): deepseek's smoke config, ``moe`` fields
    replaced."""
    out = []
    for reg, pkg in ((jax_registry, jax_base), (torch_registry, torch_base)):
        cfg = reg.get_smoke_config(ARCH, mux_n=n)
        out.append(dataclasses.replace(
            cfg, serving=pkg.ServingConfig(**serving),
            moe=dataclasses.replace(cfg.moe, **(moe or {}))))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_params(n, seed):
    """The reference's deepseek smoke params at mux width ``n``, made once
    (they depend on neither the serving config nor the capacity)."""
    return JAX_INIT(jax.random.PRNGKey(seed),
                    jax_registry.get_smoke_config(ARCH, mux_n=n))


def _bridged(jcfg, tcfg, seed=0):
    params = _jax_params(jcfg.mux.n, seed)
    model = Backbone(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg), strict=True)
    return params, model.eval()


@pytest.mark.parametrize("smoke", [False, True])
def test_deepseek_config_matches_reference(smoke):
    """Every field the port has equals the reference's (``mla`` and
    ``moe`` included), and so do ``layer_kinds`` (every mixer MLA, the
    first 3 MLPs dense, then MoE; the smoke config's from layer 1) and
    ``layer_pattern``."""
    get = "get_smoke_config" if smoke else "get_config"
    ours = getattr(torch_registry, get)(ARCH, mux_n=2)
    theirs = getattr(jax_registry, get)(ARCH, mux_n=2)
    for f in dataclasses.fields(ours):
        if f.name in ("mux", "serving", "moe", "mla"):
            continue
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert dataclasses.asdict(ours.moe) == dataclasses.asdict(theirs.moe)
    assert dataclasses.asdict(ours.mla) == dataclasses.asdict(theirs.mla)
    keys = ("mixer", "mlp", "window")
    assert [{k: d[k] for k in keys} for d in ours.layer_kinds()] == \
        [{k: d[k] for k in keys} for d in theirs.layer_kinds()]
    assert ours.layer_pattern() == theirs.layer_pattern()
    start = 1 if smoke else 3
    assert [k["mlp"] for k in ours.layer_kinds()] == \
        ["dense"] * start + ["moe"] * (ours.n_layers - start)
    assert {k["mixer"] for k in ours.layer_kinds()} == {"mla"}
    assert ours.family == "moe"


@pytest.mark.parametrize("length", [1, 12])
def test_forward_backbone_matches_reference(length):
    """N 2, L 1 and 12: logits and the summed aux within 1e-4 of
    ``Backbone.apply``."""
    jcfg, tcfg = _cfgs(2)
    params, model = _bridged(jcfg, tcfg)
    toks = tokens(tcfg, 2, length)
    want = JAX_FORWARD(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = model(as_torch(toks))
    _close(got["logits"], want["logits"], 1e-4)
    _close(got["aux"], want["aux"], 1e-4)


def test_decode_steps_match_reference():
    """After an ``Engine.prefill`` (the latent caches filled): two
    one-token steps at per-slot positions with a lane mask, a slot's lanes
    all idle, then a chunked step of 3 rows with ragged ``chunk_lens``;
    logits within 1e-4 of the reference's ``decode_step`` at each step,
    and the latent caches through the cache bridge within 1e-5 (N 2)."""
    n = 2
    jcfg, tcfg = _cfgs(n)
    params, model = _bridged(jcfg, tcfg, seed=1)
    lp = 5
    prompts = tokens(tcfg, B, lp, seed=1)
    jeng = JaxEngine(params, jcfg, batch=B, max_len=lp + 8)
    eng = Engine(model, batch=B, max_len=lp + 8)
    _, jstate = jeng.prefill(jnp.asarray(prompts))
    _, state = eng.prefill(as_torch(prompts))
    jcache, cache = jstate.cache, state.cache
    pos = np.full(B, lp + tcfg.mux.prefix_len, np.int32)
    pos[2] += 1
    mask = np.ones((B, n), np.int32)
    mask[1] = 0
    with torch.inference_mode():
        for t in range(2):
            tok = tokens(tcfg, B, 1, seed=5 + t)[..., 0]
            want, jcache = JAX_DECODE(
                params, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg,
                index_embeds=jstate.index_embeds,
                lane_mask=jnp.asarray(mask))
            got, cache = model.decode_step(
                as_torch(tok), cache, torch.from_numpy(pos),
                index_embeds=state.index_embeds,
                lane_mask=torch.from_numpy(mask))
            _close(got, want, 1e-4)
            pos = pos + 1
        lens = np.array([3, 1, 2], np.int32)
        tok = tokens(tcfg, B, 3, seed=9)
        cmask = np.ones((B, n, 3), np.int32)
        cmask[1] = 0
        want, jcache = JAX_DECODE(
            params, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg,
            index_embeds=jstate.index_embeds, lane_mask=jnp.asarray(cmask),
            chunk_lens=jnp.asarray(lens))
        got, cache = model.decode_step(
            as_torch(tok), cache, torch.from_numpy(pos),
            index_embeds=state.index_embeds,
            lane_mask=torch.from_numpy(cmask),
            chunk_lens=torch.from_numpy(lens))
        _close(got, want, 1e-4)
    for mine, theirs in zip(cache, cache_from_jax(
            jax.tree.map(np.asarray, jcache), tcfg)):
        assert set(mine) == {"ckv", "krope", "pos"}
        _cache_close(mine, theirs)


@pytest.mark.parametrize("chunk", [1, 3])
def test_paged_decode_steps_match_reference(chunk):
    """From a primed state in both packages: paged decode steps (latent
    pools, page_size 4) with a lane mask, one-token or in chunks of 3;
    logits within 1e-4, the page tables equal and the pools, through the
    cache bridge, within 1e-5 (the trash page aside)."""
    serving = dict(paged=True, page_size=4, prefill_chunk=chunk)
    jcfg, tcfg = _cfgs(2, **serving)
    params, model = _bridged(jcfg, tcfg, seed=2)
    jeng = JaxEngine(params, jcfg, batch=2, max_len=18)
    teng = Engine(model, batch=2, max_len=18)
    jprimed, tprimed = jeng.prime(compact=True), teng.prime(compact=True)
    jalloc = JaxPagedAllocator(jcfg, 2, jeng.max_len, template=jprimed.cache)
    talloc = PagedKVSlotAllocator(tcfg, 2, teng.max_len,
                                  template=tprimed.cache)
    rng = np.random.default_rng(0)
    pos = np.asarray(jprimed.pos).copy()
    lens = np.array([chunk, max(1, chunk - 1)], np.int32)
    for step in range(4):
        shape = (2, 2, chunk) if chunk > 1 else (2, 2)
        toks = rng.integers(0, jcfg.vocab, shape).astype(np.int32)
        mask = np.ones(shape, np.float32)
        mask[1, step % 2] = 0.0
        kw = {"chunk_lens": lens} if chunk > 1 else {}
        jalloc.ensure(pos, np.ones(2, bool), lens)
        want, st = jeng.step(
            JaxServeState(cache=jalloc.cache, pos=jnp.asarray(pos),
                          index_embeds=jprimed.index_embeds),
            jnp.asarray(toks), lane_mask=jnp.asarray(mask),
            block_table=jalloc.block_table,
            **{k: jnp.asarray(v) for k, v in kw.items()})
        jalloc.adopt(st.cache)
        talloc.ensure(pos, np.ones(2, bool), lens)
        got, st = teng.step(ServeState(talloc.cache, pos.copy(),
                                       tprimed.index_embeds), toks,
                            lane_mask=mask, block_table=talloc.block_table,
                            **kw)
        talloc.adopt(st.cache)
        _close(got, want, 1e-4)
        pos += lens if chunk > 1 else 1
    assert (talloc.table.rows == jalloc.table.rows).all()
    want_cache = cache_from_jax(jax.tree.map(np.asarray, jalloc.cache), tcfg)
    for mine, theirs in zip(talloc.cache, want_cache):
        assert set(mine) == {"ckv_pages", "krope_pages", "pos"}
        _cache_close(mine, theirs, skip_trash=True)


def test_views_share_the_mla_weights_and_keep_it_off_flash():
    """A ``with_config`` view and a flash view (``use_flash=True``) hold
    every tensor of the model, none copied, and give its logits bitwise:
    MLA never goes through the flash kernel, so the flash view launches
    nothing on the CPU either way."""
    _, tcfg = _cfgs(2)
    model = Backbone(tcfg, seed=0, device="cpu").eval()
    flash = Backbone(tcfg, seed=0, device="cpu", use_flash=True).eval()
    views = [model.with_config(dataclasses.replace(
        tcfg, serving=torch_base.ServingConfig(paged=True))),
        model.with_config(tcfg, use_flash=True)]
    ptrs = {p.data_ptr() for p in model.parameters()}
    toks = as_torch(tokens(tcfg, 1, 10))
    with torch.no_grad():
        want = model(toks)["logits"]
        for view in views:
            assert {p.data_ptr() for p in view.parameters()} == ptrs
            assert all(isinstance(b.attn, MLA) for b in view.layers)
            assert torch.equal(view(toks)["logits"], want)
        assert torch.equal(flash(toks)["logits"], want)


@pytest.mark.parametrize("paged", [False, True])
def test_cache_bridge_maps_latent_caches(paged):
    """A reference deepseek cache (prefilled, or its latent pool after a
    primed import) through ``cache_from_jax``: one dict a layer in the
    port's layout (``init_cache``'s keys, shapes and dtypes), leaf for leaf
    the reference's layer."""
    serving = dict(paged=paged, page_size=4)
    jcfg, tcfg = _cfgs(2, **serving)
    params = _jax_params(2, 0)
    eng = JaxEngine(params, jcfg, batch=2, max_len=10)
    if paged:
        cache = JaxPagedAllocator(jcfg, 2, eng.max_len,
                                  template=eng.prime(compact=True).cache).cache
        mine = PagedKVSlotAllocator(tcfg, 2, 12, device="cpu").cache
    else:
        _, state = eng.prefill(np.random.default_rng(0).integers(
            0, jcfg.vocab, (2, 2, 5)).astype(np.int32))
        cache = state.cache
        mine = Backbone(tcfg, device="cpu").init_cache(2, 12)
    layers = cache_from_jax(jax.tree.map(np.asarray, cache), tcfg)
    assert len(layers) == tcfg.n_layers == len(mine)
    for got, empty in zip(layers, mine):
        assert got.keys() == empty.keys()
        for k in got:
            assert got[k].shape == empty[k].shape
            assert got[k].dtype == (torch.int32 if k == "pos"
                                    else torch.float32)
    np.testing.assert_array_equal(
        layers[2]["ckv_pages" if paged else "ckv"].numpy(),
        np.asarray(cache["blocks"][0]["ckv_pages" if paged else "ckv"][1]))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_setup(n=2, task="lm"):
    jcfg, tcfg = _cfgs(n)
    kw = dict(task=task, lr=1e-3, warmup=1, total_steps=10)
    jt, tt = JaxTrainConfig(**kw), TrainConfig(**kw)
    params = _jax_params(n, 0)
    # ``JaxTrainer.init_state`` of these params
    jstate = {"params": params,
              "opt_state": JaxTrainer.make_optimizer(jt).init(params),
              "step": jnp.zeros((), jnp.int32)}
    state = Trainer.init_state(tcfg, tt, device="cpu")
    Trainer.load_params(state, params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg))
    return jcfg, tcfg, jt, tt, jstate, state


def _retrieval_batch(tcfg, seq_len, seed, n=2):
    task = torch_data.RetrievalTask(vocab=tcfg.vocab, seq_len=seq_len)
    return next(iter(torch_data.mux_batches(task, 2, n, 1, seed=seed)))


def test_train_step_grads_match_reference():
    """Task lm with the retrieval auxiliary, N 2: loss, task and retrieval
    losses, ``moe_aux`` and every grad (the six MLA projections of each
    layer included) within 1e-4 x max(1, max|ref|)."""
    jcfg, tcfg, jt, tt, jstate, state = _train_setup()
    batch = _retrieval_batch(tcfg, 10, 0)
    rng = jax.random.PRNGKey(7)
    (jloss, jm), jg = JAX_GRADS(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        rng, jcfg, jt)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (2, 10), 0,
                                                         2)))
    loss, metrics, grads = Trainer.grads(
        state, {k: torch.as_tensor(v).long() for k, v in batch.items()},
        None, tcfg, tt, retr_index=index)

    def close(got, want):
        want = np.asarray(want, np.float32)
        err = float(np.abs(_np(got.float()) - want).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err
    close(loss, jloss)
    for k in ("task_loss", "retr_loss", "moe_aux"):
        close(metrics[k], jm[k])
    want_g = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        close(g, want_g[k].numpy())
    for name in ("wq_a", "wq_b", "wkv_a", "wk_b", "wv_b", "wo"):
        assert grads[f"layers.3.attn.{name}.weight"].abs().max() > 0, name


def test_make_train_and_eval_steps_match_reference():
    """One jitted reference train step against ``make_train_step`` (loss
    and grad norm within 1e-4 relative, ``moe_aux`` within 1e-4), then
    ``make_eval_step`` on the updated weights: losses and ``moe_aux``
    within 1e-4 relative of the reference's."""
    jcfg, tcfg, jt, tt, jstate, state = _train_setup(task="retrieval")
    batch = _retrieval_batch(tcfg, 8, 1)
    rng = jax.random.PRNGKey(1)
    jstate, jm = jax.jit(JaxTrainer.make_train_step(jcfg, jt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (2, 8), 0,
                                                         2)))
    state, m = Trainer.make_train_step(tcfg, tt)(state, batch, None,
                                                 retr_index=index)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               atol=1e-4)
    batch = _retrieval_batch(tcfg, 12, 2)
    rng = jax.random.PRNGKey(3)
    want = jax.jit(JaxTrainer.make_eval_step(jcfg, jt))(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (2, 12), 0,
                                                         2)))
    got = Trainer.make_eval_step(tcfg, tt)(state, batch, None,
                                           retr_index=index)
    for key in ("task_loss", "retr_loss", "loss", "moe_aux"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4)


def test_decay_mask_is_the_references_rule():
    """The reference decays a leaf iff ndim >= 2 on its scanned tree
    (deepseek smoke: layer 0 unscanned, layers 1-3 scanned): the scanned
    layers' norm scales are decayed, layer 0's are not, every MLA
    projection is, ``final_norm`` is not."""
    _, tcfg, _, _, jstate, state = _train_setup()
    assert tcfg.layer_pattern() == (1, 1, 3)
    rule = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2),
                        jstate["params"])
    want = {k: bool(v.flatten()[0])
            for k, v in params_from_jax(rule, tcfg).items()}
    got = decay_mask(tcfg, Trainer.params(state))
    assert got == want
    assert got["layers.1.norm1.scale"] and not got["layers.0.norm1.scale"]
    assert got["layers.0.attn.wkv_a.weight"] and \
        got["layers.2.attn.wk_b.weight"]
    assert not got["final_norm.scale"]


# ---------------------------------------------------------------------------
# serving: the cases of tests/test_paging.py and tests/test_serving_fuzz.py
# ---------------------------------------------------------------------------

def _model(n=2, seed=0, **serving):
    _, tcfg = _cfgs(n, **serving)
    return Backbone(tcfg, seed=seed, device="cpu").eval()


def _with_serving(model, **serving):
    return model.with_config(dataclasses.replace(
        model.cfg, serving=torch_base.ServingConfig(**serving)))


def _requests(spec, *, prompt_len=2, vocab=512, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, prompt_len)
                    .astype(np.int32), max_new_tokens=gen, arrival=arr)
            for i, (gen, arr) in enumerate(spec)]


def test_mla_latent_layers_are_paged():
    """Every deepseek layer is MLA with no window, so paging is total: the
    allocator pools ``ckv`` / ``krope`` latent rows, keeps no contiguous
    layer, and parks without a snapshot."""
    model = _model(paged=True, page_size=8)
    alloc = PagedKVSlotAllocator(model.cfg, 2, 32,
                                 template=Engine(model, batch=2, max_len=30)
                                 .prime(compact=True).cache)
    assert all(alloc._paged) and not alloc._has_contiguous
    for layer in alloc.cache:
        assert set(layer) == {"ckv_pages", "krope_pages", "pos"}
    # the primed prefix reached the latent pools
    prefix = alloc.table.rows[:, 0]
    assert (alloc.cache[0]["pos"][torch.from_numpy(prefix).long(), :2]
            == torch.tensor([0, 1])).all()
    assert alloc.cache[0]["ckv_pages"][torch.from_numpy(prefix).long()] \
        .abs().sum() > 0
    park = alloc.park_slot(0)
    assert park.snapshot is None
    alloc.resume_slot(0, park)


def test_mla_paged_decode_matches_contiguous_bitwise():
    """Step level: the gathered (page, offset) latent row is the contiguous
    position row, masked pool entries add exact zeros to the absorbed
    softmax — deepseek decode logits bitwise, six steps."""
    model = _model()
    paged = _with_serving(model, paged=True, page_size=8)
    eng_c = Engine(model, batch=2, max_len=30)
    eng_p = Engine(paged, batch=2, max_len=30)
    primed_c, primed_p = eng_c.prime(), eng_p.prime()
    alloc_c = KVSlotAllocator(model.cfg, 2, eng_c.max_len,
                              template=primed_c.cache)
    alloc_p = PagedKVSlotAllocator(paged.cfg, 2, eng_p.max_len,
                                   template=primed_p.cache)
    ones = torch.ones((2, 2))
    pos = primed_c.pos.numpy().copy()
    toks = torch.from_numpy(np.random.default_rng(0).integers(0, 512,
                                                              (2, 2)))
    for _ in range(6):
        la, st = eng_c.step(ServeState(alloc_c.cache, pos.copy(),
                                       primed_c.index_embeds), toks,
                            lane_mask=ones)
        alloc_c.adopt(st.cache)
        alloc_p.ensure(pos, np.ones(2, bool))
        lb, st = eng_p.step(ServeState(alloc_p.cache, pos.copy(),
                                       primed_p.index_embeds), toks,
                            lane_mask=ones, block_table=alloc_p.block_table)
        alloc_p.adopt(st.cache)
        assert torch.equal(la, lb)
        toks = la.argmax(-1)
        pos += 1


@pytest.mark.parametrize("chunk", [1, 4])
def test_mla_paged_scheduler_matches_contiguous(chunk):
    """Trace level, both ramp widths: the paged deepseek scheduler (latents
    pooled, MoE row-masked at chunk > 1) gives the contiguous scheduler's
    decode steps and tokens."""
    model = _model(prefill_chunk=chunk)
    base = _requests([(3, 0), (5, 0), (2, 1), (4, 2)])
    outs = []
    for m in (model, _with_serving(model, paged=True, page_size=8,
                                   prefill_chunk=chunk)):
        sched = ContinuousScheduler(Engine(m, batch=2, max_len=30))
        stats = sched.run([r.fresh() for r in base])
        outs.append((stats.decode_steps, stats.finished,
                     {q.rid: q.output for q in sched.finished}))
    assert outs[0] == outs[1] and outs[0][1] == len(base)


def test_mla_no_page_leak_after_trace_drains():
    """Latent pages recycle like K/V pages: after the trace drains only
    the resident prefix pages stay mapped."""
    model = _model(paged=True, page_size=4)
    sched = ContinuousScheduler(Engine(model, batch=2, max_len=30))
    stats = sched.run(_requests([(3, 0), (6, 0), (2, 1), (4, 3)]))
    assert stats.finished == 4
    table = sched.allocator.table
    keep = sched.allocator.n_prefix_pages * sched.n_slots
    assert table.pages_in_use == keep
    assert table.free_pages == table.usable_pages - keep
    assert stats.peak_pages > keep


def _check_page_conservation(sched):
    """Free list + mapped rows + parked rows partition the usable pages."""
    for c in sched.classes:
        table = c.allocator.table
        mapped = [int(p) for p in table.rows.ravel() if p >= 0]
        parked = [int(p) for g in sched.ledger if g.wclass == c.index
                  for p in g.payload.row if p >= 0]
        held = mapped + parked
        assert len(held) == len(set(held)), "page double-mapped"
        assert 0 not in held, "trash page mapped"
        free = set(table.free)
        assert not free.intersection(held), "page both free and held"
        assert len(free) + len(held) == table.usable_pages, "page lost"
        assert table.pages_in_use == len(held)


def _drive(sched, trace, *, max_steps=3000):
    """Replay like ``run`` but check the invariants after every step."""
    for r in trace:
        sched.submit(r)
    while sched._waiting() or sched.table.live_requests() or \
            len(sched.ledger):
        assert sched.stats.decode_steps < max_steps, "trace failed to drain"
        nxt = sched._next_arrival()
        if not sched.table.live_requests() and not len(sched.ledger) and \
                nxt is not None and nxt > sched.t:
            sched.t = nxt
        sched.step()
        live = sched.table.live_requests()
        assert len(live) == len(set(live)), "lane serves two requests"
        assert not set(live) & set(sched.ledger.live_requests())
        if sched.paged:
            _check_page_conservation(sched)
    assert len(sched.ledger) == 0, "parked group never resumed"
    return {q.rid: list(q.output) for q in sched.finished}


@settings(max_examples=2, deadline=None, derandomize=True)
@given(seed=st.integers(0, 10_000), chunk=st.integers(1, 3))
def test_fuzz_mla_moe_preempt_resume_invariants(seed, chunk):
    """Random two-class preempting traces on the MLA + MoE backbone: page
    conservation every step over the latent pools, parked latent rows
    surviving park/resume (paged == contiguous token for token), a clean
    telemetry lifecycle, every request its full budget, no page leaked
    after the drain."""
    model = _model(seed=1)
    rng = np.random.default_rng(seed)
    trace = [Request(
        rid=i, prompt=rng.integers(0, 512, int(rng.integers(1, 5)))
        .astype(np.int32),
        max_new_tokens=int(rng.integers(1, 6)), arrival=int(a),
        priority=int(rng.integers(0, 4)),
        slo="latency" if rng.random() < 0.4 else "batch",
    ) for i, a in enumerate(np.cumsum(rng.integers(0, 3, 5)))]
    max_len = model.cfg.mux.prefix_len + 4 * (4 + 5)
    pool = 2 * 2 * pages_for(max_len, 4) + 1

    def build(paged, tracer):
        m = _with_serving(model, paged=paged, page_size=4,
                          pool_pages=pool if paged else 0,
                          prefill_chunk=chunk, policy="slo", preempt=True)
        return ContinuousScheduler(Engine(m, batch=2, max_len=max_len),
                                   tracer=tracer)

    tr_c, tr_p = Tracer(), Tracer()
    sched_c = build(False, tr_c)
    out_c = _drive(sched_c, [r.fresh() for r in trace])
    sched_p = build(True, tr_p)
    out_p = _drive(sched_p, [r.fresh() for r in trace])
    assert tr_c.lifecycle_errors() == [] and tr_p.lifecycle_errors() == []
    for r in trace:
        assert len(out_c[r.rid]) == r.max_new_tokens
    assert out_c == out_p
    assert sched_p.stats.preemptions == sched_p.stats.resumes
    table = sched_p.allocator.table
    keep = sched_p.allocator.n_prefix_pages * 2
    assert table.pages_in_use == keep
    assert table.free_pages == table.usable_pages - keep


def test_bench_serving_moe_counts():
    """``results/bench/serving_moe.json`` through the port (deepseek smoke,
    N 2, 2 slots, 10 requests, page_size 8, pool 9, prefill_chunk 4; the
    counts depend on lengths only, the traces having no EOS): sequential
    32 steps and 42 tokens, chunked 21 steps, paged-chunked 21 steps with
    peak 5 pages and 4 slot resets, paged == contiguous tokens, every
    telemetry lifecycle clean."""
    committed = json.loads((RESULTS / "serving_moe.json").read_text())
    c = committed["config"]
    model = _model(n=c["n"])
    max_total = 2 * c["prompt_len"] + 2 * c["gen_len"] + 1
    trace = poisson_trace(c["num_requests"], rate=c["rate"],
                          prompt_len=c["prompt_len"], gen_len=c["gen_len"],
                          vocab=model.cfg.vocab, max_total=max_total,
                          seed=c["seed"])
    max_len = max_total + c["prefill_chunk"]
    pool = c["batch"] * pages_for(max_len + model.cfg.mux.prefix_len,
                                  c["page_size"]) + 1
    assert pool == c["pool_pages"] == 9
    outputs = {}
    for name, paged, chunk in (("sequential", False, 1),
                               ("chunked", False, c["prefill_chunk"]),
                               ("paged_chunked", True, c["prefill_chunk"])):
        tracer = Tracer()
        m = _with_serving(model, paged=paged, page_size=c["page_size"],
                          pool_pages=pool if paged else 0,
                          prefill_chunk=chunk)
        sched = ContinuousScheduler(Engine(m, batch=c["batch"],
                                           max_len=max_len), tracer=tracer)
        stats = sched.run([r.fresh() for r in trace])
        assert tracer.lifecycle_errors() == []
        want = committed[name]
        got = {"decode_steps": stats.decode_steps,
               "generated_tokens": stats.generated_tokens,
               "finished": stats.finished}
        if paged:
            got.update(peak_pool_pages=stats.peak_pages,
                       slot_resets=stats.slot_resets)
        assert got == {k: want[k] for k in got}, name
        outputs[name] = {q.rid: list(q.output) for q in sched.finished}
    assert (committed["sequential"]["decode_steps"],
            committed["sequential"]["generated_tokens"],
            committed["paged_chunked"]["peak_pool_pages"]) == (32, 42, 5)
    assert outputs["chunked"] == outputs["paged_chunked"]
    assert committed["paged_matches_contiguous"]


def test_scheduler_matches_reference():
    """A Poisson trace at N 2 over 2 slots on bridged weights, paged, in
    chunks of 3: decode
    steps, generated tokens, slot resets, peak pages, every TTFT and every
    output token equal the JAX scheduler's (capacity_factor 64, so no
    row's expert output is dropped and a token never hangs on a capacity
    race)."""
    jcfg, tcfg = _cfgs(2, moe={"capacity_factor": 64.0}, paged=True,
                       page_size=4, prefill_chunk=3)
    params, model = _bridged(jcfg, tcfg, seed=2)
    max_total = 24
    trace = poisson_trace(6, rate=1.0, prompt_len=4, gen_len=4,
                          vocab=tcfg.vocab, max_total=max_total, seed=0)
    jsched = JaxScheduler(JaxEngine(params, jcfg, batch=2,
                                    max_len=max_total))
    want = jsched.run([r.fresh() for r in trace])
    sched = ContinuousScheduler(Engine(model, batch=2, max_len=max_total))
    got = sched.run([r.fresh() for r in trace])
    for key in ("decode_steps", "generated_tokens", "slot_resets",
                "peak_pages", "finished"):
        assert getattr(got, key) == getattr(want, key), key
    ours = {q.rid: q for q in sched.finished}
    for q in jsched.finished:
        assert ours[q.rid].ttft == q.ttft, q.rid
        assert ours[q.rid].output == q.output, q.rid


@pytest.mark.parametrize("full", [False, True])
def test_cache_bytes_match_reference(full):
    """``cache_bytes`` and ``paged_cache_bytes`` equal the reference's
    (an MLA row is ``cache_width`` elements + a 4-byte pos); at the smoke
    size also the bytes the allocators hold.  At full width a latent row
    is 576 bf16 + 4 bytes, 1156 a layer."""
    get = "get_config" if full else "get_smoke_config"
    tcfg = getattr(torch_registry, get)(ARCH, mux_n=2)
    jcfg = getattr(jax_registry, get)(ARCH, mux_n=2)
    assert kvcache.cache_bytes(tcfg, 2, 40) == \
        jax_kvcache.cache_bytes(jcfg, 2, 40)
    assert kvcache.paged_cache_bytes(tcfg, 2, 40, pool_pages=11,
                                     page_size=8) == \
        jax_kvcache.paged_cache_bytes(jcfg, 2, 40, pool_pages=11,
                                      page_size=8)
    if full:
        assert kvcache.cache_bytes(tcfg, 1, 1) == 61 * (576 * 2 + 4)
        return
    model = Backbone(tcfg, device="cpu")
    alloc = PagedKVSlotAllocator(tcfg, 2, 40, page_size=8, pool_pages=11,
                                 device="cpu")
    assert kvcache.cache_nbytes(alloc.cache) == \
        kvcache.paged_cache_bytes(tcfg, 2, 40, pool_pages=11, page_size=8)
    assert kvcache.cache_nbytes(model.init_cache(2, 40)) == \
        kvcache.cache_bytes(tcfg, 2, 40)


def test_serve_launcher_takes_deepseek(capsys):
    sched, stats = serve.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--mux-n", "2",
         "--workload", "poisson", "--paged", "--prefill-chunk", "2",
         "--gen", "3", "--num-requests", "4", "--prompt-len", "5"])
    assert stats.finished == 4
    assert sched.engine.cfg.mla is not None
    assert all("ckv_pages" in layer for layer in sched.allocator.cache)
    assert "[serve] continuous" in capsys.readouterr().out

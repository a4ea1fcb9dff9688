"""Sliding-window attention in the port against the JAX package, on
gemma3-4b's smoke config (4 layers, d 256, window 16, every 2nd layer
global; f32, weights bridged from the reference): the window masks and the
chunked online-softmax form; the ring cache of a local layer (prefill
longer than the ring, decode past it, a JAX ring cache continued in the
port); chunked prefill against one-token steps, also with a ring that
wraps inside a chunk; the paged cache with global layers paged and local
layers ringed, bitwise equal to the contiguous cache; preemption of a slot
whose rings have wrapped, against the JAX scheduler; the byte accounting
of rings."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs.registry import get_config as jax_get
from repro.configs.registry import get_smoke_config as jax_smoke
from repro.nn import attention as jax_attn
from repro.serving import kvcache as jax_kvcache
from repro.serving.engine import Engine as JaxEngine
from repro.serving.scheduler import ContinuousScheduler as JaxScheduler
from repro_torch.bridge import cache_from_jax
from repro_torch.configs import base as torch_base
from repro_torch.configs.registry import get_config as torch_get
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.models import Backbone
from repro_torch.nn import attention as torch_attn
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Engine, ServeState
from repro_torch.serving.kvcache import KVSlotAllocator
from repro_torch.serving.paging import PagedKVSlotAllocator
from repro_torch.serving.scheduler import ContinuousScheduler, Request
from torch_parity import bridged, tokens

ARCH = "gemma3-4b"
B = 2
# greedy picks compared token for token need a top-1 margin above this in
# the reference run (asserted, as in tests/test_torch_scheduler.py)
MARGIN = 1e-3


def _cfgs(n=2, *, window=16, **serving):
    """(jax cfg, torch cfg): gemma3-4b's smoke config at ``window``."""
    out = []
    for smoke, pkg in ((jax_smoke, jax_base), (torch_smoke, torch_base)):
        cfg = smoke(ARCH, mux_n=n)
        out.append(dataclasses.replace(
            cfg, window=window, serving=pkg.ServingConfig(**serving)))
    return tuple(out)


def _with_serving(model, **serving):
    cfg = dataclasses.replace(model.cfg,
                              serving=torch_base.ServingConfig(**serving))
    out = Backbone(cfg, device="cpu").eval()
    out.load_state_dict(model.state_dict())
    return out


def _close(got, want, atol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# masks and the chunked form
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (True, 7), (False, 5)])
def test_attention_mask_with_window_matches_reference(causal, window):
    rng = np.random.default_rng(0)
    q_pos = rng.integers(0, 90, (2, 11)).astype(np.int32)
    k_pos = rng.integers(-1, 90, (2, 37)).astype(np.int32)
    valid = k_pos >= 0
    want = jax_attn.make_attention_mask(q_pos, k_pos, causal=causal,
                                        window=window, k_valid=valid)
    got = torch_attn.make_attention_mask(
        torch.from_numpy(q_pos), torch.from_numpy(k_pos), causal=causal,
        window=window, k_valid=torch.from_numpy(valid))
    assert np.array_equal(got.numpy(), np.asarray(want))


# The cases of tests/test_attention_chunked.py::test_chunked_matches_dense.
@pytest.mark.parametrize("causal,window", [(True, None), (False, None),
                                           (True, 64), (True, 7)])
@pytest.mark.parametrize("chunk", [64, 128, 100])
def test_chunked_attention_with_window_matches_reference(causal, window,
                                                         chunk):
    """The online-softmax form against the reference's and against the
    port's dense masked attention, within 1e-5."""
    b, l, h, hd = 2, 300, 4, 32
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((b, l, h, hd)).astype(np.float32)
               for _ in range(3))
    pos = np.broadcast_to(np.arange(l), (b, l)).astype(np.int32)
    want = jax_attn.chunked_dot_product_attention(
        q, k, v, pos, pos, 0.17, causal=causal, window=window, chunk=chunk)
    tq, tk, tv, tpos = map(torch.from_numpy, (q, k, v, pos.copy()))
    got = torch_attn.chunked_dot_product_attention(
        tq, tk, tv, tpos, tpos, 0.17, causal=causal, window=window,
        chunk=chunk)
    _close(got, want, 1e-5)
    mask = torch_attn.make_attention_mask(tpos, tpos, causal=causal,
                                          window=window)
    dense = torch_attn.dot_product_attention(tq, tk, tv, mask, 0.17)
    torch.testing.assert_close(got, dense, atol=1e-5, rtol=0)


# ---------------------------------------------------------------------------
# the ring cache
# ---------------------------------------------------------------------------

def test_sliding_window_ring_buffer():
    """The port's version of tests/test_serving.py::
    test_sliding_window_ring_buffer: decoding past the window, the ring
    keeps only the last ``window`` positions and the decode step still
    matches the full windowed forward (log-softmax within 1e-4)."""
    cfg = dataclasses.replace(torch_smoke(ARCH, mux_n=1), window=8,
                              global_every=0, n_layers=2)
    model = Backbone(cfg, seed=0, device="cpu").eval()
    t = 20
    toks = torch.from_numpy(tokens(cfg, 1, t).astype(np.int64))
    with torch.no_grad():
        want = model(toks)["logits"][:, -1]
        cache = model.init_cache(1, t + 1, dtype=torch.float32)
        pre = model(toks[:, :t - 1], cache=cache)
        got, cache = model.decode_step(toks[:, t - 1], pre["cache"], t - 1)
    torch.testing.assert_close(torch.log_softmax(got, -1),
                               torch.log_softmax(want, -1), atol=1e-4,
                               rtol=1e-4)
    for layer in cache:
        assert layer["k"].shape[1] == 8
        assert sorted(layer["pos"][0].tolist()) == list(range(t - 8, t))


@pytest.mark.parametrize("arch, window, global_every", [
    ("gemma-7b", None, 0),      # every layer full attention
    ("gemma3-4b", 16, 2),       # its global layers
    ("gemma3-4b", 16, 0),       # local layers whose ring is cut to max_len
])
def test_prefill_longer_than_the_cache_raises(arch, window, global_every):
    """Only a ring that holds the whole window may keep the last rows of a
    longer prompt: a layer that attends to more positions than its cache
    holds raises instead of attending over a truncated history."""
    cfg = dataclasses.replace(torch_smoke(arch, mux_n=1), window=window,
                              global_every=global_every, n_layers=2)
    model = Backbone(cfg, seed=0, device="cpu").eval()
    toks = torch.from_numpy(tokens(cfg, 1, 20).astype(np.int64))
    cache = model.init_cache(1, 10, dtype=torch.float32)
    with torch.no_grad(), pytest.raises(ValueError, match="exceeds"):
        model(toks, cache=cache)


@pytest.mark.parametrize("n", [1, 2])
def test_ring_prefill_and_decode_match_reference(n):
    """A prompt longer than the window through the engine: the reference's
    ring caches (last ``window`` positions at ``p % window``; global layers
    full) equal the port's (K/V within 1e-5, positions exactly); then that
    JAX cache, carried over by ``cache_from_jax``, continues in the port:
    decode logits within 1e-4 of the reference's for 6 steps that wrap the
    rings again."""
    jcfg, tcfg = _cfgs(n)
    params, model = bridged(jcfg, tcfg)
    max_len = 48
    prompts = tokens(tcfg, B, 37)
    jeng = JaxEngine(params, jcfg, batch=B, max_len=max_len)
    eng = Engine(model, batch=B, max_len=max_len)
    jlogits, jstate = jeng.prefill(jnp.asarray(prompts))
    logits, state = eng.prefill(torch.from_numpy(prompts).long())
    _close(logits, jlogits, 1e-4)
    jcache = cache_from_jax(jax.tree.map(np.asarray, jstate.cache), tcfg)
    rows = [min(16, eng.max_len) if k["window"] else eng.max_len
            for k in tcfg.layer_kinds()]
    assert [c["k"].shape[1] for c in state.cache] == rows
    assert rows[0] == 16 and rows[1] == eng.max_len
    for got, want in zip(state.cache, jcache):
        assert torch.equal(got["pos"], want["pos"])
        _close(got["k"], want["k"].numpy(), 1e-5)
        _close(got["v"], want["v"].numpy(), 1e-5)

    port = ServeState(cache=jcache, pos=torch.as_tensor(int(jstate.pos)),
                      index_embeds=None if jstate.index_embeds is None else
                      torch.from_numpy(np.array(jstate.index_embeds)))
    last = np.asarray(jlogits).argmax(-1).astype(np.int32)
    for _ in range(6):
        jlogits, jstate = jeng.step(jstate, jnp.asarray(last))
        logits, port = eng.step(port, torch.from_numpy(last).long())
        _close(logits, jlogits, 1e-4)
        last = np.asarray(jlogits).argmax(-1).astype(np.int32)


def test_chunked_rejects_chunk_wider_than_window():
    """The port's version of tests/test_chunked_prefill.py::
    test_chunked_rejects_chunk_wider_than_window: a chunk writes C
    distinct rows of every ring."""
    cfg = torch_smoke(ARCH, mux_n=1)      # smoke window = 16
    for chunk, ok in ((17, False), (16, True)):
        model = Backbone(dataclasses.replace(
            cfg, serving=torch_base.ServingConfig(prefill_chunk=chunk)),
            device="cpu")
        if ok:
            Engine(model, batch=1, max_len=64)
        else:
            with pytest.raises(ValueError, match="ring"):
                Engine(model, batch=1, max_len=64)


def _ramp(step, state, prompts, chunk, lens):
    """Feed each slot's prompt (slot b: its first ``lens[b]`` tokens) in
    chunks of ``chunk`` rows from the primed ``state`` (``chunk`` 1: one
    token a step for every slot); the logits of every real row, (B, N, T,
    V), zero past ``lens[b]``."""
    n_t = prompts.shape[-1]
    out = None
    for s in range(0, n_t, chunk):
        c = min(chunk, n_t - s)
        cl = np.clip(np.asarray(lens) - s, 0, c).astype(np.int32)
        if chunk == 1:
            logits, state = step(state, prompts[..., s], None)
            logits = np.asarray(logits)[..., None, :]
        else:
            logits, state = step(state, prompts[..., s:s + c], cl)
            logits = np.asarray(logits)
        if out is None:
            out = np.zeros(prompts.shape + (logits.shape[-1],), np.float32)
        live = np.arange(c)[None, :] < cl[:, None]          # (B, c)
        out[..., s:s + c, :] = np.where(live[:, None, :, None], logits, 0)
    return out


@pytest.mark.parametrize("window", [16, 4])
def test_chunked_prefill_matches_one_token_steps(window):
    """Chunks of 4 rows (window 4: the ring wraps inside every chunk) from
    the primed state, slot 1's prompt ending mid-chunk, against
    ``prefill_chunk=1`` one-token steps of the port and of the reference:
    logits of every real row within 1e-4."""
    jcfg, tcfg = _cfgs(2, window=window, prefill_chunk=4)
    params, model = bridged(jcfg, tcfg)
    prompts = tokens(tcfg, B, 22, seed=3)
    lens = [22, 19]

    def run_torch(m, chunk):
        eng = Engine(m, batch=B, max_len=40)

        def step(state, toks, cl):
            toks = torch.from_numpy(np.ascontiguousarray(toks)).long()
            logits, state = eng.step(state, toks, chunk_lens=cl)
            return logits.numpy(), state
        return _ramp(step, eng.prime(), prompts, chunk, lens)

    def run_jax():
        eng = JaxEngine(params, jcfg, batch=B, max_len=40)

        def step(state, toks, cl):
            logits, state = eng.step(state, jnp.asarray(toks))
            return np.asarray(logits), state
        return _ramp(step, eng.prime(), prompts, 1, lens)

    chunked = run_torch(model, 4)
    ones = run_torch(_with_serving(model), 1)
    ref = run_jax()
    np.testing.assert_allclose(chunked, ones, atol=1e-4, rtol=0)
    np.testing.assert_allclose(ones, ref, atol=1e-4, rtol=0)
    assert np.abs(ref).max() > 0


# ---------------------------------------------------------------------------
# rings inside the paged cache
# ---------------------------------------------------------------------------

def test_paged_allocator_keeps_local_layers_in_rings():
    """At max_len > window the allocator pages the global layers and keeps
    each local layer's per-slot ring; at max_len <= window every layer
    pages (``paged_eligible``)."""
    _, tcfg = _cfgs(2, paged=True, page_size=8)
    model = Backbone(tcfg, device="cpu").eval()
    for max_len, want in ((46, [False, True, False, True]),
                          (14, [True] * 4)):
        eng = Engine(model, batch=B, max_len=max_len)
        alloc = PagedKVSlotAllocator(tcfg, B, eng.max_len,
                                     template=eng.prime(compact=True).cache)
        assert ["k_pages" in layer for layer in alloc.cache] == want
        for layer, paged in zip(alloc.cache, want):
            if not paged:
                assert layer["k"].shape[:2] == (B, 16)


def _paged_pair(model, max_len, **serving):
    """(contiguous engine + allocator, paged engine + allocator) over the
    same weights, primed."""
    pm = _with_serving(model, paged=True, page_size=8, **serving)
    cm = _with_serving(model, **serving)
    out = []
    for m, paged in ((cm, False), (pm, True)):
        eng = Engine(m, batch=B, max_len=max_len)
        primed = eng.prime(compact=paged)
        alloc = (PagedKVSlotAllocator if paged else KVSlotAllocator)(
            m.cfg, B, eng.max_len, template=primed.cache)
        out.append((eng, alloc, primed))
    return out


@pytest.mark.parametrize("chunk", [1, 4])
def test_paged_matches_contiguous_bitwise_with_rings(chunk):
    """Global layers paged, local layers ringed, at max_len 46 + prefix 2 >
    window 16: 24 decode steps (the rings wrap) give logits bit for bit
    those of the contiguous cache, one-token and in chunks of 4."""
    _, tcfg = _cfgs(2)
    model = Backbone(tcfg, seed=1, device="cpu").eval()
    (eng_c, alloc_c, pc), (eng_p, alloc_p, pp) = _paged_pair(
        model, 46, prefill_chunk=chunk)
    assert not all("k_pages" in layer for layer in alloc_p.cache)
    n = tcfg.mux.n
    pos = pc.pos.numpy().copy()
    rng = np.random.default_rng(0)
    lens = np.full(B, chunk, np.int32)
    for _ in range(24 // chunk):
        shape = (B, n, chunk) if chunk > 1 else (B, n)
        toks = rng.integers(0, tcfg.vocab, shape).astype(np.int32)
        kw = {"chunk_lens": lens} if chunk > 1 else \
            {"lane_mask": np.ones((B, n), np.float32)}
        la, st = eng_c.step(ServeState(alloc_c.cache, pos.copy(),
                                       pc.index_embeds), toks, **kw)
        alloc_c.adopt(st.cache)
        alloc_p.ensure(pos, np.ones(B, bool), lens)
        lb, st = eng_p.step(ServeState(alloc_p.cache, pos.copy(),
                                       pp.index_embeds), toks,
                            block_table=alloc_p.block_table, **kw)
        alloc_p.adopt(st.cache)
        assert torch.equal(la, lb)
        pos += chunk
    assert pos[0] - 2 > 16


@pytest.mark.parametrize("paged", [False, True])
def test_allocator_reset_restores_rings_slot_isolated(paged):
    """Resetting slot 0 rewinds its rings to the primed template and leaves
    slot 1's rings (and pages) bitwise untouched; park/resume carries a
    slot's rings through a reset of that slot."""
    _, tcfg = _cfgs(2, paged=paged, page_size=8)
    model = Backbone(tcfg, device="cpu").eval()
    eng = Engine(model, batch=B, max_len=46)
    primed = eng.prime(compact=paged)
    alloc = (PagedKVSlotAllocator if paged else KVSlotAllocator)(
        tcfg, B, eng.max_len, template=primed.cache)
    rings = [i for i, k in enumerate(tcfg.layer_kinds()) if k["window"]]
    tmpl = [{k: t.clone() for k, t in alloc.cache[i].items()} for i in rings]
    pos = primed.pos.numpy().copy()
    rng = np.random.default_rng(0)
    for _ in range(20):                          # past the ring's 16 rows
        kw = {}
        if paged:
            alloc.ensure(pos, np.ones(B, bool))
            kw["block_table"] = alloc.block_table
        toks = rng.integers(0, tcfg.vocab, (B, 2)).astype(np.int32)
        _, st = eng.step(ServeState(alloc.cache, pos.copy(),
                                    primed.index_embeds), toks,
                         lane_mask=np.ones((B, 2), np.float32), **kw)
        alloc.adopt(st.cache)
        pos += 1
    live = [{k: t.clone() for k, t in alloc.cache[i].items()} for i in rings]
    payload = alloc.park_slot(0)
    alloc.reset_slots(np.array([True, False]))
    for i, t, lv in zip(rings, tmpl, live):
        for key, leaf in alloc.cache[i].items():
            assert torch.equal(leaf[0], t[key][0])
            assert torch.equal(leaf[1], lv[key][1])
    alloc.resume_slot(0, payload)
    for i, lv in zip(rings, live):
        for key, leaf in alloc.cache[i].items():
            assert torch.equal(leaf, lv[key])


def _slo_requests(spec, *, vocab, seed=0):
    rng = np.random.default_rng(seed)
    return [Request(rid=i, prompt=rng.integers(0, vocab, lp).astype(np.int32),
                    max_new_tokens=gen, arrival=arr, slo=slo)
            for i, (lp, gen, arr, slo) in enumerate(spec)]


class _Margins:
    """Sampling wrapper recording each greedy pick's top-1 margin."""

    def __init__(self, inner):
        self.inner = inner
        self.margins = []

    def select(self, req, lane_logits):
        top = np.sort(np.asarray(lane_logits, np.float32))[-2:]
        self.margins.append(float(top[1] - top[0]))
        return self.inner.select(req, lane_logits)


@pytest.mark.parametrize("chunk", [1, 4])
def test_preempt_with_wrapped_rings_matches_jax(chunk):
    """A latency-class arrival parks a batch-class slot whose rings have
    wrapped (prompt + 20 tokens > window 16) in the paged scheduler: decode
    steps, tokens, peak pages, preemptions and resumes equal the JAX
    scheduler's, every output token for token; the victims' outputs equal
    those of a run without preemption."""
    serving = dict(paged=True, page_size=4, prefill_chunk=chunk,
                   policy="slo")
    jcfg, tcfg = _cfgs(2, **serving)
    # weights and prompts whose greedy margins all exceed MARGIN in both
    # reference runs (the precondition asserted below)
    params, model = bridged(jcfg, tcfg, seed=4)
    reqs = _slo_requests([(3, 30, 0, "batch"), (2, 30, 0, "batch"),
                          (2, 3, 24, "latency")], vocab=tcfg.vocab, seed=2)

    def port(preempt, rs):
        m = _with_serving(model, **serving, preempt=preempt)
        sched = ContinuousScheduler(Engine(m, batch=1, max_len=64))
        stats = sched.run([r.fresh() for r in rs])
        return stats, {q.rid: q for q in sched.finished}

    jcfg_p = dataclasses.replace(jcfg, serving=dataclasses.replace(
        jcfg.serving, preempt=True))
    jsched = JaxScheduler(JaxEngine(params, jcfg_p, batch=1, max_len=64))
    jsched.sampling = _Margins(jsched.sampling)
    want = jsched.run([r.fresh() for r in reqs])
    assert min(jsched.sampling.margins) > MARGIN, \
        "precondition: clear greedy margins in the reference run"
    stats, out = port(True, reqs)
    assert stats.preemptions == 1 and stats.resumes == 1
    for key in ("decode_steps", "generated_tokens", "peak_pages",
                "preemptions", "resumes", "finished"):
        assert getattr(stats, key) == getattr(want, key), key
    for q in jsched.finished:
        assert out[q.rid].output == q.output, q.rid
    _, ref = port(False, reqs[:2])
    assert out[0].output == ref[0].output
    assert out[1].output == ref[1].output


# ---------------------------------------------------------------------------
# bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("smoke", [True, False])
def test_cache_bytes_count_rings_as_the_reference(smoke):
    """``cache_bytes`` / ``paged_cache_bytes`` (and per stream) equal the
    reference's for gemma3-4b, below and above the window; at smoke size
    they equal the bytes the allocators hold (the paged allocator's rings
    counted at ``min(window, max_len)`` rows, not ``max_len``)."""
    if smoke:
        jcfg, tcfg = jax_smoke(ARCH, mux_n=2), torch_smoke(ARCH, mux_n=2)
    else:
        jcfg = dataclasses.replace(jax_get(ARCH),
                                   mux=jax_base.MuxConfig(n=2))
        tcfg = dataclasses.replace(torch_get(ARCH),
                                   mux=torch_base.MuxConfig(n=2))
    window = tcfg.window
    for length in (window // 2, window, 3 * window):
        assert kvcache.cache_bytes(tcfg, B, length) == \
            jax_kvcache.cache_bytes(jcfg, B, length)
        assert kvcache.paged_cache_bytes(
            tcfg, B, length, pool_pages=13, page_size=8) == \
            jax_kvcache.paged_cache_bytes(jcfg, B, length, pool_pages=13,
                                          page_size=8)
        assert kvcache.cache_bytes_per_stream(tcfg, length) == \
            jax_kvcache.cache_bytes_per_stream(jcfg, length)
        assert kvcache.paged_cache_bytes_per_stream(
            tcfg, length, page_size=8) == \
            jax_kvcache.paged_cache_bytes_per_stream(jcfg, length,
                                                     page_size=8)
    if not smoke:
        return
    cfg = dataclasses.replace(tcfg, serving=torch_base.ServingConfig(
        paged=True, page_size=8, pool_pages=13))
    alloc = PagedKVSlotAllocator(cfg, B, 3 * window, device="cpu")
    assert kvcache.paged_cache_bytes(cfg, B, 3 * window, pool_pages=13,
                                     page_size=8) == \
        kvcache.cache_nbytes(alloc.cache)
    assert alloc.ring_bytes() == kvcache.cache_nbytes(
        [c for c in alloc.cache if "k" in c])
    contig = KVSlotAllocator(tcfg, B, 3 * window, device="cpu")
    assert kvcache.cache_bytes(tcfg, B, 3 * window) == \
        kvcache.cache_nbytes(contig.cache)

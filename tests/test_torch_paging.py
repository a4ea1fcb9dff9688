"""The port's paged KV cache: the page table, the pool's prefix import,
paged decode bitwise equal to contiguous decode inside the port, paged and
contiguous schedulers token-for-token, no page leak after a drain, slot
isolation of resets, the kernel's K-block validation at config time, and
paged decode steps against the JAX package's (logits atol 1e-4, pools
through the cache bridge atol 1e-5).  Small f32 configs (``SMALL``)."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serving.engine import Engine as JaxEngine
from repro.serving.engine import ServeState as JaxServeState
from repro.serving.paging import PagedKVSlotAllocator as JaxPagedAllocator
from repro_torch.bridge import cache_from_jax
from repro_torch.configs.base import ServingConfig
from repro_torch.models import Backbone
from repro_torch.serving.engine import Engine, ServeState
from repro_torch.serving.kvcache import KVSlotAllocator
from repro_torch.serving.paging import PagedKVSlotAllocator, PageTable
from repro_torch.serving.scheduler import ContinuousScheduler, Request
from torch_parity import bridged, configs

B = 2


def _model(arch="qwen", n=2, seed=0, **serving):
    """A port model on the CPU, weights from ``seed``."""
    _, tcfg = configs(arch, n, serving=serving)
    return Backbone(tcfg, seed=seed, device="cpu").eval()


def _with_serving(model, **serving):
    """The same weights under another serving config."""
    cfg = dataclasses.replace(model.cfg, serving=ServingConfig(**serving))
    out = Backbone(cfg, device="cpu").eval()
    out.load_state_dict(model.state_dict())
    return out


def _requests(spec, *, prompt_len=2, vocab=128, seed=0):
    rng = np.random.default_rng(seed)
    reqs = []
    for i, s in enumerate(spec):
        gen, arr = s if isinstance(s, tuple) else (s, 0)
        reqs.append(Request(
            rid=i, prompt=rng.integers(0, vocab, prompt_len).astype(np.int32),
            max_new_tokens=gen, arrival=arr))
    return reqs


def _outputs(model, reqs, *, max_len=30, batch=B):
    sched = ContinuousScheduler(Engine(model, batch=batch, max_len=max_len))
    stats = sched.run([r.fresh() for r in reqs])
    return sched, stats, {q.rid: q.output for q in sched.finished}


def test_page_table_alloc_free_cycle():
    t = PageTable(n_slots=2, pages_per_slot=4, pool_pages=6)
    assert t.usable_pages == 5 and t.free_pages == 5
    p0 = t.allocate(0, 0)
    p1 = t.allocate(0, 1)
    p2 = t.allocate(1, 0)
    assert p0 != p1 != p2 and 0 not in (p0, p1, p2)   # trash page reserved
    assert t.pages_in_use == 3 and t.peak_in_use == 3
    freed = t.free_slot(0, keep=1)
    assert freed == [p1]
    assert t.pages_in_use == 2 and t.free_pages == 3
    assert t.rows[0, 0] == p0 and t.rows[0, 1] == -1
    assert t.allocate(0, 1) == p1                     # LIFO reuse
    with pytest.raises(ValueError, match="already mapped"):
        t.allocate(0, 1)
    with pytest.raises(ValueError, match="sequential"):
        t.allocate(1, 3)
    with pytest.raises(ValueError, match="table width"):
        t.allocate(1, 4)
    t.allocate(1, 1)
    t.allocate(1, 2)
    with pytest.raises(RuntimeError, match="exhausted"):
        t.allocate(1, 3)


def test_pool_must_hold_prefix_pages():
    cfg = _model(paged=True, page_size=4, pool_pages=2).cfg
    with pytest.raises(ValueError, match="prefix pages"):
        PagedKVSlotAllocator(cfg, 3, 16, device="cpu")


@pytest.mark.parametrize("arch", ["tmux", "qwen"])
def test_paged_decode_matches_contiguous_bitwise(arch):
    """Step-level: with an aligned page size, paged decode logits are
    bit-for-bit the contiguous path's — the gathered pages cover the same
    positions in the same order, masked pool entries contribute exact 0."""
    model_c = _model(arch)
    model_p = _with_serving(model_c, paged=True, page_size=8)
    n = model_c.cfg.mux.n
    eng_c = Engine(model_c, batch=B, max_len=30)        # + prefix 2 = 32
    eng_p = Engine(model_p, batch=B, max_len=30)
    assert eng_c.max_len % 8 == 0
    primed_c, primed_p = eng_c.prime(), eng_p.prime(compact=True)
    alloc_c = KVSlotAllocator(model_c.cfg, B, eng_c.max_len,
                              template=primed_c.cache)
    alloc_p = PagedKVSlotAllocator(model_p.cfg, B, eng_p.max_len,
                                   template=primed_p.cache)
    ones = np.ones((B, n), np.float32)
    pos = primed_c.pos.numpy().copy()
    toks = np.random.default_rng(0).integers(0, 128, (B, n)).astype(np.int32)
    for _ in range(6):
        st = ServeState(alloc_c.cache, pos.copy(), primed_c.index_embeds)
        la, st = eng_c.step(st, toks, lane_mask=ones)
        alloc_c.adopt(st.cache)
        alloc_p.ensure(pos, np.ones(B, bool))
        st = ServeState(alloc_p.cache, pos.copy(), primed_p.index_embeds)
        lb, st = eng_p.step(st, toks, lane_mask=ones,
                            block_table=alloc_p.block_table)
        alloc_p.adopt(st.cache)
        assert torch.equal(la, lb)
        toks = la.argmax(-1).numpy().astype(np.int32)
        pos += 1


@pytest.mark.parametrize("chunk", [1, 3])
def test_paged_scheduler_matches_contiguous_outputs(chunk):
    """Trace-level: the paged scheduler reproduces the contiguous one's
    outputs token-for-token (admissions, ramps, retirements and slot
    recycles all land identically)."""
    model = _model(prefill_chunk=chunk)
    reqs = _requests([(3, 0), (5, 0), (2, 0), (4, 1), (6, 2), (3, 4)])
    _, st_c, out_c = _outputs(model, reqs)
    _, st_p, out_p = _outputs(
        _with_serving(model, paged=True, page_size=8, prefill_chunk=chunk),
        reqs)
    assert st_c.decode_steps == st_p.decode_steps
    assert st_c.generated_tokens == st_p.generated_tokens
    assert out_c == out_p


def test_no_page_leak_after_trace_drains():
    """After every request retires, all non-prefix pages are back on the
    free list (free-on-retire recycles a slot the step it drains)."""
    model = _model(paged=True, page_size=4)
    sched, stats, _ = _outputs(model, _requests(
        [(3, 0), (6, 0), (2, 1), (4, 3), (5, 8)]))
    assert stats.finished == 5
    table = sched.allocator.table
    keep = sched.allocator.n_prefix_pages * sched.n_slots
    assert table.pages_in_use == keep
    assert table.free_pages == table.usable_pages - keep
    assert stats.peak_pages > keep
    assert stats.slot_resets >= 1


def test_fuse_demux_token_stream_bitwise_unchanged():
    """The fused decode demux with the paged kernel path on (their plain
    versions on the CPU) leaves the token stream of the plain contiguous
    run unchanged, at one-token and chunked ramps."""
    model = _model()
    reqs = _requests([(3, 0), (5, 0), (2, 1), (4, 2)])
    for chunk in (1, 2):
        _, _, want = _outputs(_with_serving(model, prefill_chunk=chunk),
                              reqs)
        _, _, got = _outputs(_with_serving(
            model, paged=True, page_size=4, prefill_chunk=chunk,
            use_kernel=True, kblock_pages=2, fuse_demux=True), reqs)
        assert got == want, f"fuse_demux changed tokens at chunk={chunk}"


@pytest.mark.parametrize("paged", [False, True])
def test_allocator_reset_is_slot_isolated(paged):
    """Resetting slot 0 leaves slot 1's cache bitwise untouched and
    rewinds slot 0 to the primed state (contiguous: the template;
    paged: its non-prefix pages freed, the partial prefix page's tail
    invalidated)."""
    model = _model(paged=paged, page_size=8)
    eng = Engine(model, batch=B, max_len=30)
    primed = eng.prime(compact=paged)
    alloc = (PagedKVSlotAllocator if paged else KVSlotAllocator)(
        model.cfg, B, eng.max_len, template=primed.cache)
    n = model.cfg.mux.n
    pos = primed.pos.numpy().copy()
    rng = np.random.default_rng(0)
    for _ in range(9):                      # past the first working page
        kw = {}
        if paged:
            alloc.ensure(pos, np.ones(B, bool))
            kw["block_table"] = alloc.block_table
        toks = rng.integers(0, 128, (B, n)).astype(np.int32)
        _, st = eng.step(ServeState(alloc.cache, pos.copy(),
                                    primed.index_embeds), toks,
                         lane_mask=np.ones((B, n), np.float32), **kw)
        alloc.adopt(st.cache)
        pos += 1
    if paged:
        rows1 = alloc.table.rows[1].copy()
        keep = [{k: t[torch.as_tensor(rows1[rows1 >= 0]).long()].clone()
                 for k, t in layer.items()} for layer in alloc.cache]
        in_use = alloc.table.pages_in_use
        alloc.reset_slots(np.array([True, False]))
        assert (alloc.table.rows[1] == rows1).all()
        assert alloc.table.pages_in_use == in_use - 1   # slot 0's page 2
        for layer, before in zip(alloc.cache, keep):
            for k, t in layer.items():
                assert torch.equal(
                    t[torch.as_tensor(rows1[rows1 >= 0]).long()], before[k])
        partial = alloc.table.rows[0, alloc.n_prefix_pages - 1]
        off = model.cfg.mux.prefix_len % 8
        for layer in alloc.cache:
            assert (layer["pos"][partial, off:] == -1).all()
            assert (layer["pos"][partial, :off] >= 0).all()
    else:
        keep = [{k: t[1].clone() for k, t in layer.items()}
                for layer in alloc.cache]
        alloc.reset_slots(np.array([True, False]))
        for layer, tmpl, before in zip(alloc.cache, primed.cache, keep):
            for k, t in layer.items():
                assert torch.equal(t[1], before[k])
                assert torch.equal(t[0], tmpl[k][0])


def test_kblock_config_validation_fails_fast():
    """A K+V stage over the kernel's shared-memory budget raises at config
    construction, naming the limit and the knob to turn."""
    with pytest.raises(ValueError, match="kblock_pages must be >= 1"):
        ServingConfig(kblock_pages=0)
    with pytest.raises(ValueError, match=r"budget .* bytes.*lower "
                                         r"kblock_pages to <="):
        _model(paged=True, page_size=16, use_kernel=True, kblock_pages=64)
    _model(paged=True, page_size=16, use_kernel=True, kblock_pages=8)
    # kernel off -> the knob is inert, any value constructs
    _model(paged=True, page_size=16, kblock_pages=1 << 16)


@pytest.mark.parametrize("arch", ["tmux", "qwen"])
def test_paged_decode_steps_match_jax(arch):
    """Paged decode steps from a primed state in both packages on bridged
    weights: logits within 1e-4 and the pools, through the cache bridge,
    within 1e-5."""
    serving = dict(paged=True, page_size=4)
    jcfg, tcfg = configs(arch, 2, serving=serving)
    params, model = bridged(jcfg, tcfg)
    jeng = JaxEngine(params, jcfg, batch=B, max_len=14)
    teng = Engine(model, batch=B, max_len=14)
    jprimed, tprimed = jeng.prime(compact=True), teng.prime(compact=True)
    jalloc = JaxPagedAllocator(jcfg, B, jeng.max_len, template=jprimed.cache)
    talloc = PagedKVSlotAllocator(tcfg, B, teng.max_len,
                                  template=tprimed.cache)
    rng = np.random.default_rng(0)
    pos = np.asarray(jprimed.pos).copy()
    for step in range(7):
        toks = rng.integers(0, jcfg.vocab, (B, 2)).astype(np.int32)
        mask = np.ones((B, 2), np.float32)
        mask[1, step % 2] = 0.0
        jalloc.ensure(pos, np.ones(B, bool))
        want, st = jeng.step(
            JaxServeState(cache=jalloc.cache, pos=jnp.asarray(pos),
                          index_embeds=jprimed.index_embeds),
            jnp.asarray(toks), lane_mask=jnp.asarray(mask),
            block_table=jalloc.block_table)
        jalloc.adopt(st.cache)
        talloc.ensure(pos, np.ones(B, bool))
        got, st = teng.step(ServeState(talloc.cache, pos.copy(),
                                       tprimed.index_embeds), toks,
                            lane_mask=mask, block_table=talloc.block_table)
        talloc.adopt(st.cache)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                                   rtol=0)
        pos += 1
    assert (talloc.table.rows == jalloc.table.rows).all()
    want_cache = cache_from_jax(jax.tree.map(np.asarray, jalloc.cache), tcfg)
    for got_layer, want_layer in zip(talloc.cache, want_cache):
        assert got_layer.keys() == want_layer.keys()
        for k in got_layer:
            np.testing.assert_allclose(got_layer[k].numpy(),
                                       want_layer[k].numpy(), atol=1e-5,
                                       rtol=0)


@pytest.mark.parametrize("arch", ["tmux-12l-768h", "qwen1.5-4b"])
@pytest.mark.parametrize("paged", [False, True])
def test_cache_bridge_round_trip(arch, paged):
    """A reference smoke cache (prefilled, or its page pool after a primed
    import) through ``cache_from_jax`` and back into the reference's
    head / scanned blocks / tail layout is the same tree, leaf for leaf."""
    from repro.configs.base import ServingConfig as JaxServingConfig
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.models import Backbone as JaxBackbone
    from repro_torch.configs.registry import get_smoke_config

    jcfg = jax_smoke(arch, mux_n=2)
    jcfg = dataclasses.replace(jcfg, serving=JaxServingConfig(
        paged=paged, page_size=4))
    params = JaxBackbone.init(jax.random.PRNGKey(0), jcfg)
    eng = JaxEngine(params, jcfg, batch=B, max_len=10)
    if paged:
        cache = JaxPagedAllocator(jcfg, B, eng.max_len,
                                  template=eng.prime(compact=True).cache).cache
    else:
        _, state = eng.prefill(np.random.default_rng(0).integers(
            0, jcfg.vocab, (B, 2, 5)).astype(np.int32))
        cache = state.cache
    np_cache = jax.tree.map(np.asarray, cache)
    layers = cache_from_jax(np_cache, get_smoke_config(arch, mux_n=2))
    assert len(layers) == jcfg.n_layers
    assert set(layers[0]) == ({"k_pages", "v_pages", "pos"} if paged
                              else {"k", "v", "pos"})
    head, period, groups = jcfg.layer_pattern()
    back = {
        "head": [{k: t.numpy() for k, t in layers[i].items()}
                 for i in range(head)],
        "blocks": [{k: np.stack([layers[head + g * period + j][k].numpy()
                                 for g in range(groups)])
                    for k in layers[head + j]}
                   for j in range(period if groups else 0)],
        "tail": [{k: t.numpy() for k, t in layers[i].items()}
                 for i in range(head + period * groups, jcfg.n_layers)]}
    flat_want, tree_want = jax.tree.flatten(np_cache)
    flat_got, tree_got = jax.tree.flatten(back)
    assert tree_got == tree_want
    for got, want in zip(flat_got, flat_want):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("arch", ["tmux", "qwen"])
def test_cache_bytes_match_allocations_and_reference(arch):
    """The byte accounting equals the bytes the caches allocate and the
    reference's numbers, contiguous and paged, whole and per stream."""
    from repro.serving import kvcache as jax_kvcache
    from repro_torch.serving import kvcache

    jcfg, tcfg = configs(arch, 2)
    model = Backbone(tcfg, device="cpu")
    nbytes = kvcache.cache_bytes(tcfg, B, 20)
    assert nbytes == kvcache.cache_nbytes(model.init_cache(B, 20))
    assert nbytes == jax_kvcache.cache_bytes(jcfg, B, 20)
    paged = kvcache.paged_cache_bytes(tcfg, B, 20, pool_pages=7, page_size=4)
    assert paged == kvcache.cache_nbytes(
        model.init_cache(B, 20, page_pool=(7, 4)))
    assert paged == jax_kvcache.paged_cache_bytes(jcfg, B, 20, pool_pages=7,
                                                  page_size=4)
    assert kvcache.cache_bytes_per_stream(tcfg, 20) == \
        jax_kvcache.cache_bytes_per_stream(jcfg, 20)
    assert kvcache.paged_cache_bytes_per_stream(tcfg, 20, page_size=4) == \
        jax_kvcache.paged_cache_bytes_per_stream(jcfg, 20, page_size=4)
    primed = Engine(model, batch=B, max_len=18).prime()
    alloc = KVSlotAllocator(tcfg, B, 20, template=primed.cache)
    assert alloc.slot_bytes() == nbytes // B
    palloc = PagedKVSlotAllocator(tcfg, B, 20, template=primed.cache,
                                  page_size=4, pool_pages=7)
    assert palloc.page_bytes() * 7 == paged
    assert palloc.bytes_in_use() == \
        (palloc.table.pages_in_use + 1) * palloc.page_bytes()

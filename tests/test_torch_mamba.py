"""The port's Mamba (``repro_torch.nn.ssm.Mamba``) and the hybrid model
that runs it, jamba-1.5-large-398b, against the JAX package.

* The module against ``repro.nn.ssm.Mamba.apply`` on bridged weights, f32,
  within 1e-5, in every mode: the full scan at several lengths and scan
  chunks (a padded last chunk among them), a prefill into the cache (also
  shorter than the conv history), one-token decode, and the row-gated
  chunked decode with counts of 0, part of the chunk and all of it; the
  three Mamba contracts of ``tests/test_ssm_oracle.py`` held on the port
  alone; the profiler label; the parameter and cache layouts.
* ``jamba-1.5-large-398b-smoke`` (4 layers, d 256: Mamba + 4 experts
  top-2, attention + dense, Mamba + MoE, Mamba + dense; f32): the config
  field for field with ``layer_kinds`` / ``layer_pattern``; forward,
  prefill and decode steps (contiguous, paged, chunked at 1 and 4) within
  1e-4 of the reference; paged == contiguous bitwise with Mamba layers;
  masked reset to the template; park / resume against an uninterrupted
  run, bitwise; the port's versions of the reference's jamba cases (cache
  bytes, decode == full forward, chunked ramp parity, chunked decode
  accepted); the JAX scheduler's counts, TTFTs and tokens; the bridge of
  params (at the full model's scanned pattern too) and caches;
  ``decay_mask``; train-step grads, ``make_train_step`` and
  ``make_eval_step``; the serve launcher.

Every test runs with one torch thread (the autouse fixture below).
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro.models import Backbone as JaxBackbone
from repro.nn.ssm import Mamba as JaxMamba
from repro.nn.ssm import MambaConfig as JaxMambaConfig
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
from repro_torch.nn.ssm import Mamba, MambaConfig
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Engine, ServeState
from repro_torch.serving.kvcache import KVSlotAllocator
from repro_torch.serving.paging import PagedKVSlotAllocator
from repro_torch.serving.scheduler import ContinuousScheduler, poisson_trace
from repro_torch.training.trainer import TrainConfig, Trainer
from torch_parity import as_torch, tokens

ARCH = "jamba-1.5-large-398b"
# A small Mamba with its widths distinct: d 24, d_inner 48, state 5, conv
# 4, dt rank 2 (ceil(24 / 16)).
MAMBA_KW = dict(dim=24, d_state=5, d_conv=4, expand=2)
B = 3
# The reference's functions, compiled once per shape; the config static.
JAX_MAMBA_APPLY = jax.jit(JaxMamba.apply, static_argnums=(2,))
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


@functools.lru_cache(maxsize=None)
def _jax_module(key=0, chunk=128):
    jcfg = JaxMambaConfig(**MAMBA_KW, chunk=chunk)
    return JaxMamba.init(jax.random.PRNGKey(key), jcfg), jcfg


def _module(key=0, chunk=128):
    """(jax params, jax cfg, port Mamba with the same weights)."""
    params, jcfg = _jax_module(key, chunk)
    model = Mamba(MambaConfig(**MAMBA_KW, chunk=chunk))
    # the bridge reads only the layer count of the config
    state = params_from_jax({"head_layers": [{"mamba": jax.tree.map(
        np.asarray, params)}]}, SimpleNamespace(n_layers=1, name="mamba"))
    model.load_state_dict({k.removeprefix("layers.0.mamba."): v
                           for k, v in state.items()}, strict=True)
    return params, jcfg, model.eval()


def _caches(jcfg, batch=B):
    return (JaxMamba.init_cache(jcfg, batch, jnp.float32),
            Mamba.init_cache(MambaConfig(**MAMBA_KW, chunk=jcfg.chunk),
                             batch, torch.float32))


def _apply(params, jcfg, model, x, jcache=None, tcache=None, **kw):
    """One call of each package on the same inputs; returns ((want, new
    jax cache), (got, port cache))."""
    want = JAX_MAMBA_APPLY(params, jnp.asarray(x), jcfg, cache=jcache,
                           **{k: jnp.asarray(v) for k, v in kw.items()})
    with torch.no_grad():
        got = model(torch.from_numpy(x), cache=tcache,
                    **{k: torch.from_numpy(v) for k, v in kw.items()})
    return want, got


def _state_close(got: dict, want: dict, atol=1e-5):
    assert set(got) == set(want) == {"ssm", "conv"}
    for k in got:
        _close(got[k], want[k], atol)


# ---------------------------------------------------------------------------
# the module against the reference, mode by mode
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """``MambaConfig`` keeps the reference's fields, defaults and derived
    widths (jamba's: d_inner 16384, dt rank 512)."""
    ours = {f.name: f.default for f in dataclasses.fields(MambaConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxMambaConfig)}
    assert ours == theirs
    for kw in (MAMBA_KW, dict(dim=8192), dict(dim=7, dt_rank=3)):
        a, b = MambaConfig(**kw), JaxMambaConfig(**kw)
        assert (a.d_inner, a.dt_rank_) == (b.d_inner, b.dt_rank_)
    assert (MambaConfig(dim=8192).d_inner, MambaConfig(dim=8192).dt_rank_) \
        == (16384, 512)


def test_params_and_cache_have_the_references_layout():
    """Every parameter under the reference's name, shape and init (A_log
    = log 1..d_state per channel, D ones, conv_b zeros; ``dt_proj`` the
    only Linear with a bias); the cache's leaves, shapes and dtypes (the
    state float32 whatever the compute dtype)."""
    params, jcfg = _jax_module()
    model = Mamba(MambaConfig(**MAMBA_KW),
                  generator=torch.Generator().manual_seed(0))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k.removeprefix("layers.0.mamba."): tuple(v.shape)
            for k, v in params_from_jax(
                {"head_layers": [{"mamba": jax.tree.map(np.asarray,
                                                        params)}]},
                SimpleNamespace(n_layers=1, name="m")).items()}
    assert got == want
    assert [k for k in got if k.endswith("bias")] == ["dt_proj.bias"]
    np.testing.assert_array_equal(_np(model.A_log), np.asarray(
        params["A_log"]))
    assert (model.D == 1).all() and (model.conv_b == 0).all()
    jc = JaxMamba.init_cache(jcfg, 2, jnp.bfloat16)
    tc = Mamba.init_cache(MambaConfig(**MAMBA_KW), 2, torch.bfloat16)
    for k in ("ssm", "conv"):
        assert tuple(tc[k].shape) == jc[k].shape
        assert str(tc[k].dtype).removeprefix("torch.") == str(jc[k].dtype)
        assert not tc[k].any()


@pytest.mark.parametrize("chunk", [4, 16])
@pytest.mark.parametrize("length", [1, 7, 16, 37])
def test_full_scan_matches_reference(length, chunk):
    """No cache: the chunked scan at L 1, 7, 16 and 37 with chunks of 4
    and 16 (L 7 / 37 pad their last chunk, L 1 / 7 are shorter than a
    chunk of 16)."""
    params, jcfg, model = _module(chunk=chunk)
    x = _x((2, length, MAMBA_KW["dim"]), length)
    (want, wc), (got, gc) = _apply(params, jcfg, model, x)
    assert wc is None and gc is None
    _close(got, want, 1e-5)


@pytest.mark.parametrize("length", [1, 2, 7, 16])
def test_prefill_fills_the_cache(length):
    """A prefill into a fresh cache: the output, the final state and the
    conv history (the last d_conv - 1 rows of the conv input, left-padded
    with zeros at L 2 < d_conv - 1; L 1 is a decode step from the zero
    state, as in the reference)."""
    params, jcfg, model = _module(chunk=4)
    jc, tc = _caches(jcfg)
    x = _x((B, length, MAMBA_KW["dim"]), 10 + length)
    (want, jc), (got, tc) = _apply(params, jcfg, model, x, jc, tc)
    _close(got, want, 1e-5)
    _state_close(tc, jc)
    if length == 2:
        assert not tc["conv"][:, 0].any() and tc["conv"][:, 1:].abs().sum()


def test_decode_steps_match_reference():
    """After a prefill of 9: four one-token steps, outputs and both
    states at every step."""
    params, jcfg, model = _module(chunk=4)
    jc, tc = _caches(jcfg)
    (_, jc), (_, tc) = _apply(params, jcfg, model,
                              _x((B, 9, MAMBA_KW["dim"]), 3), jc, tc)
    for t in range(4):
        x = _x((B, 1, MAMBA_KW["dim"]), 20 + t)
        (want, jc), (got, tc) = _apply(params, jcfg, model, x, jc, tc)
        _close(got, want, 1e-5)
        _state_close(tc, jc)


@pytest.mark.parametrize("lens", [(3, 0, 2), (0, 0, 0), (3, 3, 3)])
def test_chunked_decode_matches_reference(lens):
    """Chunks of 3 rows after a prefill of 5, ``chunk_lens`` of 0, part of
    the chunk and all of it: the outputs of the valid rows and both
    states (a slot with count 0 keeps its state exactly)."""
    params, jcfg, model = _module(chunk=4)
    jc, tc = _caches(jcfg)
    (_, jc), (_, tc) = _apply(params, jcfg, model,
                              _x((B, 5, MAMBA_KW["dim"]), 4), jc, tc)
    before = {k: v.clone() for k, v in tc.items()}
    lens = np.array(lens, np.int32)
    for t in range(2):
        x = _x((B, 3, MAMBA_KW["dim"]), 30 + t)
        (want, jc), (got, tc) = _apply(params, jcfg, model, x, jc, tc,
                                       chunk_lens=lens)
        ok = np.arange(3)[None, :] < lens[:, None]
        _close(_np(got)[ok], np.asarray(want)[ok], 1e-5)
        _state_close(tc, jc)
    for b in np.flatnonzero(lens == 0):
        for k in tc:
            assert torch.equal(tc[k][b], before[k][b])


def _decode_loop(model, x, cache):
    with torch.no_grad():
        return torch.cat([model(x[:, t:t + 1], cache=cache)[0]
                          for t in range(x.shape[1])], dim=1)


@pytest.mark.parametrize("length,chunk", [(17, 8), (32, 16)])
def test_scan_matches_stepwise_decode(length, chunk):
    """``tests/test_ssm_oracle.py``'s first Mamba contract on the port
    alone: the full scan equals L one-token decode steps (here within
    1e-5; the reference allows 2e-3)."""
    model = Mamba(MambaConfig(dim=32, d_state=8, chunk=chunk),
                  generator=torch.Generator().manual_seed(0)).eval()
    x = 0.5 * torch.from_numpy(_x((2, length, 32), 5))
    with torch.no_grad():
        full, _ = model(x)
    step = _decode_loop(model, x, Mamba.init_cache(model.cfg, 2))
    torch.testing.assert_close(full, step, rtol=0, atol=1e-5)


def test_prefill_state_matches_stepwise():
    """The second contract: a prefill's final state and conv history are
    those of 12 one-token steps (within 1e-5: the in_proj GEMM of 12 rows
    and of one round differently)."""
    model = Mamba(MambaConfig(dim=32, d_state=8, chunk=8),
                  generator=torch.Generator().manual_seed(1)).eval()
    x = 0.5 * torch.from_numpy(_x((1, 12, 32), 6))
    prefill = Mamba.init_cache(model.cfg, 1)
    with torch.no_grad():
        model(x, cache=prefill)
    step = Mamba.init_cache(model.cfg, 1)
    _decode_loop(model, x, step)
    torch.testing.assert_close(prefill["ssm"], step["ssm"], rtol=0,
                               atol=1e-5)
    torch.testing.assert_close(prefill["conv"], step["conv"], rtol=0,
                               atol=1e-5)


def test_chunk_invariance():
    """The third contract: chunks of 4, 16 and 64 give the same output."""
    x = 0.5 * torch.from_numpy(_x((1, 40, 32), 7))
    outs = []
    for chunk in (4, 16, 64):
        model = Mamba(MambaConfig(dim=32, d_state=8, chunk=chunk),
                      generator=torch.Generator().manual_seed(7)).eval()
        with torch.no_grad():
            outs.append(model(x)[0])
    for out in outs[1:]:
        torch.testing.assert_close(out, outs[0], rtol=0, atol=1e-5)


def test_mamba_runs_inside_its_profiler_label():
    """Under a profiler every mode runs inside the label ``mamba``; with
    none running, no label is entered."""
    _, jcfg, model = _module(chunk=4)
    x = torch.from_numpy(_x((1, 6, MAMBA_KW["dim"]), 8))
    cache = Mamba.init_cache(model.cfg, 1)
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(x)
        model(x, cache=cache)
        model(x[:, :1], cache=cache)
        model(x[:, :3], cache=cache, chunk_lens=torch.tensor([2]))
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("mamba") == 4


# ---------------------------------------------------------------------------
# jamba-1.5-large-398b
# ---------------------------------------------------------------------------

def _cfgs(n, *, moe=None, **serving):
    """(jax cfg, torch cfg): jamba's smoke config, ``moe`` fields
    replaced."""
    from repro.configs import base as jax_base
    out = []
    for reg, pkg in ((jax_registry, jax_base), (torch_registry, torch_base)):
        cfg = reg.get_smoke_config(ARCH, mux_n=n)
        out.append(dataclasses.replace(
            cfg, serving=pkg.ServingConfig(**serving),
            moe=dataclasses.replace(cfg.moe, **(moe or {}))))
    return tuple(out)


NO_DROP = {"capacity_factor": 64.0}


@functools.lru_cache(maxsize=None)
def _jax_params(n, seed):
    """The reference's jamba smoke params at mux width ``n``, made once
    (they depend on neither the serving config nor the capacity)."""
    return JAX_INIT(jax.random.PRNGKey(seed),
                    jax_registry.get_smoke_config(ARCH, mux_n=n))


def _bridged(jcfg, tcfg, seed=0):
    params = _jax_params(jcfg.mux.n, seed)
    model = Backbone(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg), strict=True)
    return params, model.eval()


KINDS = [("mamba", "moe"), ("attn", "dense"), ("mamba", "moe"),
         ("mamba", "dense")]


@pytest.mark.parametrize("smoke", [False, True])
def test_jamba_config_matches_reference(smoke):
    """Every field the port has equals the reference's (``mamba`` and
    ``moe`` included), and so do ``layer_kinds`` (attention at i % 8 == 4,
    MoE on even layers; the smoke config's the four kinds above) and
    ``layer_pattern`` ((0, 8, 9) and (4, 1, 0))."""
    get = "get_smoke_config" if smoke else "get_config"
    ours = getattr(torch_registry, get)(ARCH, mux_n=2)
    theirs = getattr(jax_registry, get)(ARCH, mux_n=2)
    for f in dataclasses.fields(ours):
        if f.name in ("mux", "serving", "moe", "mamba"):
            continue
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert dataclasses.asdict(ours.moe) == dataclasses.asdict(theirs.moe)
    assert dataclasses.asdict(ours.mamba) == dataclasses.asdict(theirs.mamba)
    keys = ("mixer", "mlp", "window")
    assert [{k: d[k] for k in keys} for d in ours.layer_kinds()] == \
        [{k: d[k] for k in keys} for d in theirs.layer_kinds()]
    assert ours.layer_pattern() == theirs.layer_pattern()
    kinds = [(k["mixer"], k["mlp"]) for k in ours.layer_kinds()]
    if smoke:
        assert kinds == KINDS and ours.layer_pattern() == (4, 1, 0)
    else:
        assert ours.layer_pattern() == (0, 8, 9)
        assert [i for i, k in enumerate(kinds) if k[0] == "attn"] == \
            list(range(4, 72, 8))
        assert kinds[3:6] == [("mamba", "dense"), ("attn", "moe"),
                              ("mamba", "dense")]
    assert ours.family == "hybrid"


def test_the_ssm_family_is_refused_citing_item_9c():
    """The name is kept from when the ssm family was the next one to port;
    the port now runs every family of the reference, and refuses one it
    does not know, naming the six it runs."""
    with pytest.raises(ValueError, match="unknown model family 'speech'.*"
                       "dense, moe, hybrid, ssm, vlm, audio"):
        dataclasses.replace(torch_registry.get_smoke_config(ARCH),
                            family="speech")


@pytest.mark.parametrize("length", [1, 12, 37])
def test_forward_backbone_matches_reference(length):
    """N 2, L 1, 12 and 37 (39 rows with the prefix: three scan chunks of
    16, the last padded): logits and the summed aux within 1e-4 of
    ``Backbone.apply``."""
    jcfg, tcfg = _cfgs(2)
    params, model = _bridged(jcfg, tcfg)
    toks = tokens(tcfg, 2, length)
    want = JAX_FORWARD(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = model(as_torch(toks))
    _close(got["logits"], want["logits"], 1e-4)
    _close(got["aux"], want["aux"], 1e-4)


def _engines(n=2, seed=1, lp=5, extra=8, **serving):
    jcfg, tcfg = _cfgs(n, moe=NO_DROP, **serving)
    params, model = _bridged(jcfg, tcfg, seed=seed)
    return (JaxEngine(params, jcfg, batch=B, max_len=lp + extra),
            Engine(model, batch=B, max_len=lp + extra), params, model, tcfg)


def _caches_close(mine_list, jcache, tcfg, atol=1e-5):
    want = cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg)
    assert len(mine_list) == len(want) == tcfg.n_layers
    for mine, theirs, kind in zip(mine_list, want, tcfg.layer_kinds()):
        assert mine.keys() == theirs.keys()
        if kind["mixer"] == "mamba":
            assert set(mine) == {"ssm", "conv"}
        for k in mine:
            if k == "pos":
                np.testing.assert_array_equal(_np(mine[k]), _np(theirs[k]))
            else:
                _close(mine[k], _np(theirs[k]), atol)


def test_prefill_matches_reference():
    """``Engine.prefill`` of 5-token prompts (7 rows with the prefix):
    last-token logits within 1e-4, and every layer's cache (Mamba states,
    the attention layer's K/V) through the cache bridge within 1e-5."""
    jeng, eng, _, _, tcfg = _engines()
    prompts = tokens(tcfg, B, 5, seed=1)
    want, jstate = jeng.prefill(jnp.asarray(prompts))
    got, state = eng.prefill(as_torch(prompts))
    _close(got, want, 1e-4)
    _caches_close(state.cache, jstate.cache, tcfg)


def test_decode_steps_match_reference():
    """After an ``Engine.prefill``: two one-token steps at per-slot
    positions with a lane mask (a slot's lanes all idle), then a chunked
    step of 3 rows with ragged ``chunk_lens``; logits within 1e-4 of the
    reference's ``decode_step`` at each step, the caches within 1e-5."""
    n = 2
    jeng, eng, params, model, tcfg = _engines()
    jcfg = jeng.cfg
    lp = 5
    prompts = tokens(tcfg, B, lp, seed=1)
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
    _caches_close(cache, jcache, tcfg)


@pytest.mark.parametrize("chunk", [1, 4])
def test_paged_decode_steps_match_reference(chunk):
    """From a compact prime in both packages: paged decode steps (the
    attention layer pooled in pages of 4, the Mamba states contiguous)
    with a lane mask, one-token or in chunks of 4 with ragged counts;
    logits within 1e-4, the page tables equal, the Mamba states within
    1e-5 and the pool within 1e-5 (the trash page aside)."""
    serving = dict(paged=True, page_size=4, prefill_chunk=chunk)
    jcfg, tcfg = _cfgs(2, moe=NO_DROP, **serving)
    params, model = _bridged(jcfg, tcfg, seed=2)
    jeng = JaxEngine(params, jcfg, batch=2, max_len=22)
    teng = Engine(model, batch=2, max_len=22)
    jprimed, tprimed = jeng.prime(compact=True), teng.prime(compact=True)
    jalloc = JaxPagedAllocator(jcfg, 2, jeng.max_len, template=jprimed.cache)
    talloc = PagedKVSlotAllocator(tcfg, 2, teng.max_len,
                                  template=tprimed.cache)
    assert talloc._paged == [False, True, False, False]
    rng = np.random.default_rng(0)
    pos = np.asarray(jprimed.pos).copy()
    lens = np.array([chunk, max(1, chunk - 2)], np.int32)
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
    for i, (mine, theirs) in enumerate(zip(talloc.cache, want_cache)):
        assert mine.keys() == theirs.keys()
        for k in mine:
            g, w = _np(mine[k]), _np(theirs[k])
            if i == 1:                    # duplicate trash writes may race
                g, w = g[1:], w[1:]
            if k == "pos":
                np.testing.assert_array_equal(g, w)
            else:
                _close(g, w, 1e-5)


def _model(n=2, seed=0, **serving):
    _, tcfg = _cfgs(n, moe=NO_DROP, **serving)
    return Backbone(tcfg, seed=seed, device="cpu").eval()


def _with_serving(model, **serving):
    return model.with_config(dataclasses.replace(
        model.cfg, serving=torch_base.ServingConfig(**serving)))


def _step(eng, alloc, primed, pos, toks, mask, chunk):
    """One engine step through ``alloc`` (paged or not) at ``pos``."""
    kw = {}
    b = len(pos)
    if chunk > 1:
        kw["chunk_lens"] = np.full(b, chunk, np.int32)
    if isinstance(alloc, PagedKVSlotAllocator):
        alloc.ensure(pos, np.ones(b, bool), np.full(b, chunk))
        kw["block_table"] = alloc.block_table
    logits, st = eng.step(ServeState(alloc.cache, pos.copy(),
                                     primed.index_embeds), toks,
                          lane_mask=mask, **kw)
    alloc.adopt(st.cache)
    return logits


def _serving_pair(model, chunk, paged_page=8, max_len=30):
    """(engine, allocator, primed) for the contiguous and the paged
    stacks over the same weights."""
    out = []
    for paged in (False, True):
        m = _with_serving(model, paged=paged, page_size=paged_page,
                          prefill_chunk=chunk)
        eng = Engine(m, batch=2, max_len=max_len)
        primed = eng.prime(compact=paged)
        alloc = (PagedKVSlotAllocator if paged else KVSlotAllocator)(
            m.cfg, 2, eng.max_len, template=primed.cache)
        out.append((eng, alloc, primed))
    return out


@pytest.mark.parametrize("chunk", [1, 4])
def test_paged_equals_contiguous_bitwise(chunk):
    """Six steps of jamba's smoke model on the paged stack (attention
    pooled, Mamba states contiguous beside the pool) and the contiguous
    one: logits bitwise, and every Mamba state bitwise."""
    model = _model()
    (ec, ac, pc), (ep, ap, pp) = _serving_pair(model, chunk)
    pos = pc.pos.numpy().copy()
    assert np.array_equal(pos, pp.pos.numpy())
    rng = np.random.default_rng(0)
    shape = (2, 2, chunk) if chunk > 1 else (2, 2)
    for _ in range(6):
        toks = torch.from_numpy(rng.integers(0, 512, shape))
        mask = torch.ones(shape)
        la = _step(ec, ac, pc, pos, toks, mask, chunk)
        lb = _step(ep, ap, pp, pos, toks, mask, chunk)
        assert torch.equal(la, lb)
        pos += chunk
    for i in (0, 2, 3):
        for k in ("ssm", "conv"):
            assert torch.equal(ac.cache[i][k], ap.cache[i][k])


@pytest.mark.parametrize("paged", [False, True])
def test_masked_reset_restores_the_primed_template(paged):
    """After four steps, ``reset_slots`` of slot 0: its Mamba states are
    the primed template's bitwise (the state after the index-embed prefix,
    not zeros), slot 1's are untouched bitwise."""
    model = _model()
    eng, alloc, primed = _serving_pair(model, 1)[int(paged)]
    pos = primed.pos.numpy().copy()
    rng = np.random.default_rng(1)
    for _ in range(4):
        _step(eng, alloc, primed, pos,
              torch.from_numpy(rng.integers(0, 512, (2, 2))),
              torch.ones((2, 2)), 1)
        pos += 1
    live = [{k: t.clone() for k, t in alloc.cache[i].items()}
            for i in (0, 2, 3)]
    alloc.reset_slots(np.array([True, False]))
    for i, before in zip((0, 2, 3), live):
        for k in ("ssm", "conv"):
            tmpl = primed.cache[i][k]
            assert tmpl[0].abs().sum() > 0
            assert torch.equal(alloc.cache[i][k][0], tmpl[0])
            assert torch.equal(alloc.cache[i][k][1], before[k][1])
            assert not torch.equal(before[k][0], tmpl[0])


@pytest.mark.parametrize("paged", [False, True])
def test_park_resume_continues_bitwise(paged):
    """Slot 0 served 3 steps, parked, the slot reset and run 2 steps on
    other tokens, then the parked state resumed into it: its next three
    steps' logits are bitwise those of an uninterrupted run (slot 1 idle
    throughout, its lanes masked)."""
    model = _model()
    rng = np.random.default_rng(2)
    seq = [torch.from_numpy(rng.integers(0, 512, (2, 2))) for _ in range(8)]
    mask = torch.tensor([[1.0, 1.0], [0.0, 0.0]])
    runs = []
    for interrupt in (False, True):
        eng, alloc, primed = _serving_pair(model, 1)[int(paged)]
        pos = primed.pos.numpy().copy()
        out = []
        for t in range(6):
            if interrupt and t == 3:
                payload = alloc.park_slot(0)
                alloc.reset_slots(np.array([True, False]))
                gpos = primed.pos.numpy().copy()
                for g in range(2):
                    _step(eng, alloc, primed, gpos, seq[6 + g], mask, 1)
                    gpos += 1
                alloc.reset_slots(np.array([True, False]))
                alloc.resume_slot(0, payload)
            out.append(_step(eng, alloc, primed, pos, seq[t], mask, 1)[0])
            pos += 1
        runs.append(out)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_views_share_the_mamba_weights_and_keep_it_off_flash():
    """A ``with_config`` view, a narrowed model and a flash view hold the
    Mamba modules themselves; the views' logits are the model's bitwise
    (the flash view's only attention layer takes flash's plain version on
    the CPU)."""
    _, tcfg = _cfgs(2)
    model = Backbone(tcfg, seed=0, device="cpu").eval()
    views = [model.with_config(dataclasses.replace(
        tcfg, serving=torch_base.ServingConfig(paged=True))),
        model.with_config(tcfg, use_flash=True)]
    toks = as_torch(tokens(tcfg, 1, 10))
    with torch.no_grad():
        want = model(toks)["logits"]
        for view in views + [model.narrowed(2)]:
            assert all(v.mamba is m.mamba and v.attn is None
                       for v, m, k in zip(view.layers, model.layers,
                                          tcfg.layer_kinds())
                       if k["mixer"] == "mamba")
        for view in views:
            torch.testing.assert_close(view(toks)["logits"], want, rtol=0,
                                       atol=1e-5)
    assert views[1].layers[1].attn.cfg.use_flash


@pytest.mark.parametrize("paged", [False, True])
def test_cache_bridge_maps_mamba_caches(paged):
    """A reference jamba cache (prefilled, or the paged allocator's after
    a compact prime) through ``cache_from_jax``: one dict a layer in the
    port's layout (``init_cache``'s keys, shapes and dtypes), a Mamba
    layer's ``ssm`` / ``conv`` leaf for leaf the reference's."""
    jcfg, tcfg = _cfgs(2, paged=paged, page_size=4)
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
            assert got[k].dtype == empty[k].dtype
    assert set(layers[0]) == {"ssm", "conv"}
    np.testing.assert_array_equal(layers[2]["ssm"].numpy(),
                                  np.asarray(cache["head"][2]["ssm"]))


# ---------------------------------------------------------------------------
# the reference's jamba cases (tests/test_kvcache.py, test_serving.py,
# test_chunked_prefill.py) on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_cache_bytes_match_reference(full):
    """``cache_bytes`` and ``paged_cache_bytes`` equal the reference's (a
    Mamba layer: the float32 state and the conv history, per slot, whatever
    the length or the pool); at the smoke size also the bytes of the
    port's own cache and pool.  At full width a Mamba layer holds 16384 x
    16 x 4 + 3 x 16384 x 2 bytes a slot."""
    get = "get_config" if full else "get_smoke_config"
    tcfg = getattr(torch_registry, get)(ARCH, mux_n=2)
    jcfg = getattr(jax_registry, get)(ARCH, mux_n=2)
    for b, length in ((3, 24), (2, 40)):
        assert kvcache.cache_bytes(tcfg, b, length) == \
            jax_kvcache.cache_bytes(jcfg, b, length)
        assert kvcache.paged_cache_bytes(tcfg, b, length, pool_pages=13,
                                         page_size=8) == \
            jax_kvcache.paged_cache_bytes(jcfg, b, length, pool_pages=13,
                                          page_size=8)
    if full:
        mamba = kvcache._layer_bytes(tcfg, {"mixer": "mamba"}, 1, 1)
        assert mamba == 16384 * 16 * 4 + 3 * 16384 * 2
        attn = 1 * (8 * 128 * 2 * 2 + 4)
        assert kvcache.cache_bytes(tcfg, 1, 1) == 63 * mamba + 9 * attn
        return
    assert kvcache.cache_nbytes(Backbone(tcfg, device="cpu")
                                .init_cache(3, 24)) == \
        kvcache.cache_bytes(tcfg, 3, 24)
    pcfg = dataclasses.replace(tcfg, serving=torch_base.ServingConfig(
        paged=True, page_size=8, pool_pages=13))
    alloc = PagedKVSlotAllocator(pcfg, 3, 24, device="cpu")
    assert kvcache.cache_nbytes(alloc.cache) == \
        kvcache.paged_cache_bytes(tcfg, 3, 24, pool_pages=13, page_size=8)
    assert alloc.ring_bytes() == 3 * kvcache._layer_bytes(
        tcfg, {"mixer": "mamba"}, 3, 1)


def test_decode_matches_full_forward():
    """``tests/test_serving.py``'s jamba case on the port: prefill 12
    tokens, decode the 13th; its log-probabilities equal the 13-token
    forward's last position within the reference's 2e-2 (here 1e-4)."""
    model = _model()
    cfg = model.cfg
    toks = as_torch(tokens(cfg, 2, 13, seed=4))
    with torch.no_grad():
        want = model(toks)["logits"][:, :, -1]
        maxlen = cfg.mux.prefix_len + 14
        cache = model.init_cache(2, maxlen, dtype=torch.float32)
        pre = model(toks[:, :, :12], cache=cache)
        got, _ = model.decode_step(toks[:, :, 12], pre["cache"],
                                   cfg.mux.prefix_len + 12,
                                   index_embeds=pre["index_embeds"])
    torch.testing.assert_close(torch.log_softmax(got, -1),
                               torch.log_softmax(want, -1), rtol=0,
                               atol=1e-4)


LP, DECODE_STEPS = 6, 4


def _ramp(model, prompts, chunk):
    """``tests/test_chunked_prefill.py``'s ramp on the port: the prompts
    fed ``chunk`` tokens a step (one-token steps at chunk None), then
    greedy decode; returns (cache, pos, every step's logits of the last
    fed row, tokens)."""
    m = _with_serving(model, prefill_chunk=chunk or 1)
    eng = Engine(m, batch=2, max_len=30)
    primed = eng.prime()
    alloc = KVSlotAllocator(m.cfg, 2, eng.max_len, template=primed.cache)
    pos = primed.pos.numpy().copy()
    n = m.cfg.mux.n
    fed, decoded, last = 0, 0, None
    logits_out, toks = [], []
    while fed < LP or decoded < DECODE_STEPS:
        if fed < LP:
            take = min(chunk or 1, LP - fed)
            feed = prompts[:, :, fed:fed + take]
        else:
            take = 1
            feed = last[:, :, None]
            decoded += 1
        if chunk is None:
            logits = _step(eng, alloc, primed, pos, feed[:, :, 0],
                           torch.ones((2, n)), 1)
            row = logits
        else:
            t = torch.zeros((2, n, chunk), dtype=torch.long)
            t[:, :, :take] = feed
            mask = torch.zeros((2, n, chunk))
            mask[:, :, :take] = 1.0
            logits, st = eng.step(
                ServeState(alloc.cache, pos.copy(), primed.index_embeds),
                t, lane_mask=mask,
                chunk_lens=np.full(2, take, np.int32))
            alloc.adopt(st.cache)
            row = logits[:, :, take - 1]
        pos += take
        if fed < LP:
            fed += take
        last = row.argmax(-1)
        if fed >= LP:
            logits_out.append(row)
            toks.append(last)
    return alloc.cache, pos, logits_out, toks


@pytest.mark.parametrize("chunk", [2, LP])
def test_chunked_ramp_parity(chunk):
    """The ramp in chunks of 2 and 6 against one-token steps, on the same
    fed tokens: the same positions, every Mamba state and K/V row within
    2e-5, every step's last-row logits within 1e-4; greedy tokens equal
    wherever the one-token run's top-1 margin is above 1e-3 (the
    reference's own case compares tokens alone and flips on ties)."""
    model = _model()
    prompts = torch.from_numpy(np.random.default_rng(1).integers(
        0, 512, (2, 2, LP)))
    cache_ref, pos_ref, logits_ref, toks_ref = _ramp(model, prompts, None)
    cache, pos, logits, toks = _ramp(model, prompts, chunk)
    np.testing.assert_array_equal(pos, pos_ref)
    for mine, ref in zip(cache, cache_ref):
        for k in mine:
            if k == "pos":
                assert torch.equal(mine[k], ref[k])
            else:
                torch.testing.assert_close(mine[k], ref[k], rtol=2e-5,
                                           atol=2e-5)
    for got, want, tg, tw in zip(logits, logits_ref, toks, toks_ref):
        torch.testing.assert_close(got, want, rtol=0, atol=1e-4)
        top = torch.topk(want, 2, dim=-1).values
        clear = (top[..., 0] - top[..., 1]) > 1e-3
        assert torch.equal(tg[clear], tw[clear])


def test_chunked_accepts_mamba_archs():
    """``tests/test_chunked_prefill.py::test_chunked_accepts_mamba_archs``:
    jamba (mux off) builds an engine at prefill_chunk 2, and the engine
    still refuses a chunk wider than its cache."""
    _, tcfg = _cfgs(1, prefill_chunk=2)
    model = Backbone(tcfg, device="cpu")
    Engine(model, batch=1, max_len=16)          # no raise
    wide = _with_serving(model, prefill_chunk=17)
    with pytest.raises(ValueError, match="prefill_chunk"):
        Engine(wide, batch=1, max_len=16)


@pytest.mark.parametrize("paged,chunk", [(False, 1), (True, 3)])
def test_scheduler_matches_reference(paged, chunk):
    """A Poisson trace at N 2 over 2 slots on bridged weights (no-drop
    capacity), contiguous one token a step and paged in chunks of 3:
    decode steps, generated tokens, slot resets, peak pages, every TTFT
    and every output token equal the JAX scheduler's."""
    jcfg, tcfg = _cfgs(2, moe=NO_DROP, paged=paged, page_size=4,
                       prefill_chunk=chunk)
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


# ---------------------------------------------------------------------------
# bridge and training
# ---------------------------------------------------------------------------

def _tiny_full_trees():
    """The reference's param tree of the full jamba model, by structure
    only (``jax.eval_shape``: nothing allocated), as two trees of tiny
    arrays of each leaf's rank (the groups axis of a scanned leaf keeps
    its length, every other axis is 1): one whose values name each leaf's
    layer, and one holding the reference AdamW's decay rule (ndim >= 2 on
    the stacked leaf)."""
    full = jax_registry.get_config(ARCH, mux_n=2)
    shapes = jax.eval_shape(lambda key: JaxBackbone.init(key, full),
                            jax.random.PRNGKey(0))
    head, period, groups = full.layer_pattern()

    def tiny(path, s, value):
        names = [getattr(p, "key", getattr(p, "idx", None)) for p in path]
        lead = (groups,) if names[0] == "blocks" else ()
        shape = lead + (1,) * (len(s.shape) - len(lead))
        if value is None:            # the layer index
            value = (head + np.arange(groups) * period + names[1]).reshape(
                lead + (1,) * (len(shape) - 1)) if lead else -1.0
        return np.broadcast_to(np.asarray(value, np.float32), shape).copy()
    names = jax.tree_util.tree_map_with_path(
        lambda p, s: tiny(p, s, None), shapes)
    rule = jax.tree_util.tree_map_with_path(
        lambda p, s: tiny(p, s, float(len(s.shape) >= 2)), shapes)
    return full, names, rule


def test_bridge_and_decay_mask_at_the_full_scanned_pattern():
    """jamba's own pattern (head 0, period 8, 9 groups): every layer's
    Mamba, attention, MLP and MoE leaves land under ``layers.{i}`` with
    i = g * 8 + j, a Mamba layer's under ``layers.{i}.mamba`` with the
    port's names; ``decay_mask`` gives the reference's ndim rule on its
    stacked tree for every one of them (a scanned layer's ``D`` and
    ``conv_b`` are decayed)."""
    full, tree, rule = _tiny_full_trees()
    assert full.layer_pattern() == (0, 8, 9)
    state = params_from_jax(tree, full)
    layers = {}
    for name, t in state.items():
        if name.startswith("layers."):
            i = int(name.split(".")[1])
            assert float(t.flatten()[0]) == i, name
            layers.setdefault(i, set()).add(name.split(".", 2)[2])
    assert sorted(layers) == list(range(72))
    mamba = {"mamba." + k for k in (
        "in_proj.weight", "conv_w", "conv_b", "x_proj.weight",
        "dt_proj.weight", "dt_proj.bias", "A_log", "D", "out_proj.weight")}
    for i, kind in enumerate(full.layer_kinds()):
        names = layers[i]
        assert (mamba <= names) == (kind["mixer"] == "mamba"), i
        assert any(n.startswith("attn.") for n in names) == \
            (kind["mixer"] == "attn")
        assert any(n.startswith("moe.") for n in names) == \
            (kind["mlp"] == "moe")
    want = {k: bool(v.flatten()[0]) for k, v in
            params_from_jax(rule, full).items()}
    got = decay_mask(full, state)
    assert got == want
    assert got["layers.5.mamba.D"] and got["layers.5.mamba.conv_b"]
    assert not got["final_norm.scale"]


def _train_setup(n=2, task="lm"):
    jcfg, tcfg = _cfgs(n, moe=NO_DROP)
    kw = dict(task=task, lr=1e-3, warmup=1, total_steps=10)
    jt, tt = JaxTrainConfig(**kw), TrainConfig(**kw)
    params = _jax_params(n, 0)
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


def test_decay_mask_is_the_references_rule_at_smoke_size():
    """jamba smoke is unscanned ((4, 1, 0)): no layer's vectors (Mamba's
    ``D`` and ``conv_b`` among them) are decayed, every matrix is."""
    jcfg, tcfg = _cfgs(2)
    params, model = _bridged(jcfg, tcfg)
    rule = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2), params)
    want = {k: bool(v.flatten()[0])
            for k, v in params_from_jax(rule, tcfg).items()}
    got = decay_mask(tcfg, dict(model.named_parameters()))
    assert got == want
    assert not got["layers.0.mamba.D"] and got["layers.0.mamba.A_log"]
    assert got["layers.2.mamba.conv_w"]


def test_train_step_grads_match_reference():
    """Task lm with the retrieval auxiliary, N 2, 20 tokens (two scan
    chunks): loss, task and retrieval losses, ``moe_aux`` and every grad
    (every Mamba parameter of each Mamba layer) within 1e-4 x max(1,
    max|ref|)."""
    jcfg, tcfg, jt, tt, jstate, state = _train_setup()
    batch = _retrieval_batch(tcfg, 20, 0)
    rng = jax.random.PRNGKey(7)
    (jloss, jm), jg = JAX_GRADS(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        rng, jcfg, jt)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (2, 20), 0,
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
    for name in ("in_proj.weight", "conv_w", "x_proj.weight", "A_log", "D",
                 "dt_proj.bias", "out_proj.weight"):
        assert grads[f"layers.3.mamba.{name}"].abs().max() > 0, name


def test_make_train_and_eval_steps_match_reference():
    """One jitted reference train step against ``make_train_step`` (loss
    and grad norm within 1e-4 relative, ``moe_aux`` within 1e-4), then
    ``make_eval_step`` on the updated weights, plain and through a
    ``use_flash`` view: losses and ``moe_aux`` within 1e-4 relative of the
    reference's."""
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
    flash = dict(state, model=state["model"].with_config(tcfg,
                                                         use_flash=True))
    for st in (state, flash):
        got = Trainer.make_eval_step(tcfg, tt)(st, batch, None,
                                               retr_index=index)
        for key in ("task_loss", "retr_loss", "loss", "moe_aux"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-4)


@pytest.mark.parametrize("flags", [["--paged", "--prefill-chunk", "2"],
                                   ["--prefill-chunk", "4"]])
def test_serve_launcher_takes_jamba(flags, capsys):
    sched, stats = serve.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--mux-n", "2",
         "--workload", "poisson", "--gen", "3", "--num-requests", "4",
         "--prompt-len", "5", *flags])
    assert stats.finished == 4
    assert sched.engine.cfg.mamba is not None
    cache = sched.allocator.cache
    assert [set(layer) for layer in cache][0] == {"ssm", "conv"}
    assert ("k_pages" in cache[1]) == ("--paged" in flags)
    assert "[serve] continuous" in capsys.readouterr().out

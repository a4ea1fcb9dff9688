"""The port's xLSTM (``repro_torch.nn.ssm.MLSTM`` / ``SLSTM``) and the
model that runs it, xlstm-125m, against the JAX package.

* The modules against ``repro.nn.ssm.MLSTM.apply`` / ``SLSTM.apply`` on
  bridged weights, f32, within 1e-5, in every mode: the full sequence at L
  1, 7, 16 and 37, a prefill into a cache (from the zero state whatever
  the cache holds), one-token decode steps; the two xLSTM contracts of
  ``tests/test_ssm_oracle.py`` held on the port alone (the full sequence
  equals stepwise decode; a prefill's state equals the steps'); the
  reference's sLSTM gate layout; the profiler labels; the parameter and
  cache layouts.
* ``xlstm-125m-smoke`` (4 layers, d 256: mLSTM, sLSTM, mLSTM, sLSTM; f32):
  the config field for field with ``layer_kinds`` / ``layer_pattern``;
  forward, prefill and decode steps (contiguous and paged) within 1e-4 of
  the reference; paged == contiguous bitwise with no pooled layer at all;
  masked reset to the template; park / resume against an uninterrupted
  run, bitwise; cache bytes; decode == full forward; the refusal of
  chunked prefill; the JAX scheduler's counts (12 decode steps, 14
  tokens, 1 slot reset contiguous; 6 peak pages and 3 slot resets paged),
  TTFTs and tokens; the bridge of params (at the full model's scanned
  pattern too) and caches; ``decay_mask``; train-step grads,
  ``make_train_step`` and ``make_eval_step``; the serve launcher.

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
from repro.nn.ssm import MLSTM as JaxMLSTM
from repro.nn.ssm import SLSTM as JaxSLSTM
from repro.nn.ssm import XLSTMConfig as JaxXLSTMConfig
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
from repro_torch.nn.ssm import MLSTM, SLSTM, XLSTMConfig
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Engine, ServeState
from repro_torch.serving.kvcache import KVSlotAllocator
from repro_torch.serving.paging import PagedKVSlotAllocator
from repro_torch.serving.scheduler import ContinuousScheduler, poisson_trace
from repro_torch.training.trainer import TrainConfig, Trainer
from torch_parity import as_torch, tokens

ARCH = "xlstm-125m"
# A small xLSTM with its widths distinct: d 24, 4 heads; mLSTM d_inner 48
# (head_dim 12), sLSTM heads of 6, its FFN 32 wide.
XLSTM_KW = dict(dim=24, n_heads=4)
B = 3
MIXERS = {"mlstm": (MLSTM, JaxMLSTM), "slstm": (SLSTM, JaxSLSTM)}
STATE_KEYS = {"mlstm": {"C", "n", "m"}, "slstm": {"c", "n", "m", "h"}}
# The reference's functions, compiled once per shape; the config static.
JAX_APPLY = {name: jax.jit(cls.apply, static_argnums=(2,))
             for name, (_, cls) in MIXERS.items()}
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
def _jax_module(mixer, key=0):
    jcfg = JaxXLSTMConfig(**XLSTM_KW)
    return MIXERS[mixer][1].init(jax.random.PRNGKey(key), jcfg), jcfg


def _bridge_module(mixer, params):
    # the bridge reads only the layer count of the config
    state = params_from_jax({"head_layers": [{mixer: jax.tree.map(
        np.asarray, params)}]}, SimpleNamespace(n_layers=1, name=mixer))
    return {k.removeprefix(f"layers.0.{mixer}."): v for k, v in state.items()}


def _module(mixer, key=0):
    """(jax params, jax cfg, port module with the same weights)."""
    params, jcfg = _jax_module(mixer, key)
    model = MIXERS[mixer][0](XLSTMConfig(**XLSTM_KW))
    model.load_state_dict(_bridge_module(mixer, params), strict=True)
    return params, jcfg, model.eval()


def _caches(mixer, jcfg, batch=B):
    torch_cls, jax_cls = MIXERS[mixer]
    return (jax_cls.init_cache(jcfg, batch),
            torch_cls.init_cache(XLSTMConfig(**XLSTM_KW), batch))


def _apply(mixer, params, jcfg, model, x, jcache=None, tcache=None):
    """One call of each package on the same inputs; returns ((want, new
    jax cache), (got, port cache))."""
    want = JAX_APPLY[mixer](params, jnp.asarray(x), jcfg, cache=jcache)
    with torch.no_grad():
        got = model(torch.from_numpy(x), cache=tcache)
    return want, got


def _state_close(mixer, got: dict, want: dict, atol=1e-5):
    assert set(got) == set(want) == STATE_KEYS[mixer]
    for k in got:
        _close(got[k], want[k], atol)


# ---------------------------------------------------------------------------
# the modules against the reference, mode by mode
# ---------------------------------------------------------------------------

def test_config_matches_reference():
    """``XLSTMConfig`` keeps the reference's fields, defaults and derived
    widths (xlstm-125m's: d_inner 1536, head_dim 384)."""
    ours = {f.name: f.default for f in dataclasses.fields(XLSTMConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxXLSTMConfig)}
    assert ours == theirs
    for kw in (XLSTM_KW, dict(dim=768), dict(dim=30, n_heads=3,
                                             proj_factor=1.5)):
        a, b = XLSTMConfig(**kw), JaxXLSTMConfig(**kw)
        assert (a.d_inner, a.head_dim) == (b.d_inner, b.head_dim)
    assert (XLSTMConfig(dim=768).d_inner, XLSTMConfig(dim=768).head_dim) \
        == (1536, 384)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_params_and_cache_have_the_references_layout(mixer):
    """Every parameter under the reference's name and shape (mLSTM's
    Linears, ``wi`` / ``wf`` / ``wo`` the ones with a bias; sLSTM's raw
    ``wx``, ``wr``, ``b`` and its gated FFN), the biases zeros; the
    cache's leaves, shapes, float32 dtype and initial values (``m`` at
    -1e30, the rest zeros)."""
    params, jcfg = _jax_module(mixer)
    torch_cls, jax_cls = MIXERS[mixer]
    model = torch_cls(XLSTMConfig(**XLSTM_KW),
                      generator=torch.Generator().manual_seed(0))
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    want = {k: tuple(v.shape) for k, v in _bridge_module(mixer,
                                                         params).items()}
    assert got == want
    if mixer == "mlstm":
        assert sorted(k for k in got if k.endswith("bias")) == \
            ["wf.bias", "wi.bias", "wo.bias"]
        assert got["up.weight"] == (96, 24) and got["wq.weight"] == (48, 48)
    else:
        assert got["wx"] == (24, 96) and got["wr"] == (4, 6, 24)
        assert got["ffn.gate.weight"] == (32, 24)
        assert not model.b.any()
    jc = jax_cls.init_cache(jcfg, 2)
    tc = torch_cls.init_cache(XLSTMConfig(**XLSTM_KW), 2)
    assert set(tc) == set(jc) == STATE_KEYS[mixer]
    for k in tc:
        assert tuple(tc[k].shape) == jc[k].shape
        assert tc[k].dtype == torch.float32 and str(jc[k].dtype) == "float32"
        np.testing.assert_array_equal(_np(tc[k]), np.asarray(jc[k]))
    assert (tc["m"] == -1e30).all()


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
@pytest.mark.parametrize("length", [1, 7, 16, 37])
def test_full_sequence_matches_reference(mixer, length):
    """No cache: the stepwise recurrence over L 1, 7, 16 and 37."""
    params, jcfg, model = _module(mixer)
    x = _x((2, length, XLSTM_KW["dim"]), length)
    (want, wc), (got, gc) = _apply(mixer, params, jcfg, model, x)
    assert wc is None and gc is None
    _close(got, want, 1e-5)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
@pytest.mark.parametrize("length", [2, 7, 16])
def test_prefill_fills_the_cache(mixer, length):
    """A prefill (L > 1) into a cache that already holds a state: as in
    the reference, the recurrence starts from the zero state whatever the
    cache holds, and its final state fills the cache."""
    params, jcfg, model = _module(mixer)
    jc, tc = _caches(mixer, jcfg)
    warm = _x((B, 3, XLSTM_KW["dim"]), 50)
    (_, jc), (_, tc) = _apply(mixer, params, jcfg, model, warm, jc, tc)
    x = _x((B, length, XLSTM_KW["dim"]), 10 + length)
    (want, jc), (got, tc) = _apply(mixer, params, jcfg, model, x, jc, tc)
    _close(got, want, 1e-5)
    _state_close(mixer, tc, jc)
    fresh = _caches(mixer, jcfg)[1]
    with torch.no_grad():
        again, _ = model(torch.from_numpy(x), cache=fresh)
    assert torch.equal(again, got)
    for k in fresh:
        assert torch.equal(fresh[k], tc[k])


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_module_decode_steps_match_reference(mixer):
    """After a prefill of 9: four one-token steps, outputs and every state
    leaf at every step."""
    params, jcfg, model = _module(mixer)
    jc, tc = _caches(mixer, jcfg)
    (_, jc), (_, tc) = _apply(mixer, params, jcfg, model,
                              _x((B, 9, XLSTM_KW["dim"]), 3), jc, tc)
    for t in range(4):
        x = _x((B, 1, XLSTM_KW["dim"]), 20 + t)
        (want, jc), (got, tc) = _apply(mixer, params, jcfg, model, x, jc, tc)
        _close(got, want, 1e-5)
        _state_close(mixer, tc, jc)


def _decode_loop(model, x, cache):
    with torch.no_grad():
        return torch.cat([model(x[:, t:t + 1], cache=cache)[0]
                          for t in range(x.shape[1])], dim=1)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
@pytest.mark.parametrize("length", [10, 33])
def test_scan_matches_stepwise_decode(mixer, length):
    """``tests/test_ssm_oracle.py``'s xLSTM contract on the port alone: the
    full sequence equals L one-token decode steps (here within 1e-5; the
    reference allows 5e-3)."""
    torch_cls = MIXERS[mixer][0]
    cfg = XLSTMConfig(dim=32, n_heads=4, chunk=8)
    model = torch_cls(cfg, generator=torch.Generator().manual_seed(0)).eval()
    x = 0.5 * torch.from_numpy(_x((2, length, 32), 5))
    with torch.no_grad():
        full, _ = model(x)
    step = _decode_loop(model, x, torch_cls.init_cache(cfg, 2))
    torch.testing.assert_close(full, step, rtol=0, atol=1e-5)


@pytest.mark.parametrize("mixer", ["mlstm", "slstm"])
def test_prefill_state_matches_stepwise(mixer):
    """A prefill's final state is that of 12 one-token steps, within
    1e-5."""
    torch_cls = MIXERS[mixer][0]
    cfg = XLSTMConfig(dim=32, n_heads=4)
    model = torch_cls(cfg, generator=torch.Generator().manual_seed(1)).eval()
    x = 0.5 * torch.from_numpy(_x((1, 12, 32), 6))
    prefill = torch_cls.init_cache(cfg, 1)
    with torch.no_grad():
        model(x, cache=prefill)
    step = torch_cls.init_cache(cfg, 1)
    _decode_loop(model, x, step)
    for k in prefill:
        torch.testing.assert_close(prefill[k], step[k], rtol=0, atol=1e-5)


def test_slstm_gate_layout_is_the_references():
    """The reference reshapes the recurrent term head-major and adds it to
    the gate-major input term: with 4 heads, the i gate's recurrent input
    is head 0's hidden state alone.  A hidden state held only in head 1
    leaves the i gate's pre-activation at the input term's; the port
    reproduces the reference's gates on it."""
    params, jcfg, model = _module("slstm")
    d = XLSTM_KW["dim"]
    hprev = np.zeros((2, d), np.float32)
    hprev[:, 6:12] = _x((2, 6), 1)                    # head 1 only
    xt = _x((2, d), 2)
    state = (np.zeros((2, d), np.float32),) * 2 + \
        (np.full((2, d), -1e30, np.float32), hprev)
    jstate, _ = JaxSLSTM._step(params, jcfg, jnp.asarray(xt),
                               tuple(map(jnp.asarray, state)))
    with torch.no_grad():
        gx = torch.from_numpy(xt) @ model.wx + model.b
        tstate, _ = model._step(gx, tuple(map(torch.from_numpy, state)))
        gr = torch.einsum("bhd,hdk->bhk", torch.from_numpy(hprev).reshape(
            2, 4, 6), model.wr).reshape(2, 4 * d)
    assert not gr[:, :d].any() and gr[:, d:2 * d].abs().sum() > 0
    for a, b in zip(tstate, jstate):
        _close(a, b, 1e-6)


def test_xlstm_runs_inside_its_profiler_labels():
    """Under a profiler every mode runs inside the label ``mlstm`` or
    ``slstm``."""
    x = torch.from_numpy(_x((1, 6, XLSTM_KW["dim"]), 8))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof, torch.no_grad():
        for mixer in MIXERS:
            model = _module(mixer)[2]
            cache = MIXERS[mixer][0].init_cache(model.cfg, 1)
            model(x)
            model(x, cache=cache)
            model(x[:, :1], cache=cache)
    counts = {e.key: e.count for e in prof.key_averages()}
    assert counts.get("mlstm") == 3 and counts.get("slstm") == 3


# ---------------------------------------------------------------------------
# xlstm-125m
# ---------------------------------------------------------------------------

def _cfgs(n, **serving):
    """(jax cfg, torch cfg): xlstm-125m's smoke config."""
    from repro.configs import base as jax_base
    out = []
    for reg, pkg in ((jax_registry, jax_base), (torch_registry, torch_base)):
        cfg = reg.get_smoke_config(ARCH, mux_n=n)
        out.append(dataclasses.replace(cfg,
                                       serving=pkg.ServingConfig(**serving)))
    return tuple(out)


@functools.lru_cache(maxsize=None)
def _jax_params(n, seed):
    """The reference's xlstm smoke params at mux width ``n``, made once."""
    return JAX_INIT(jax.random.PRNGKey(seed),
                    jax_registry.get_smoke_config(ARCH, mux_n=n))


def _bridged(jcfg, tcfg, seed=0):
    params = _jax_params(jcfg.mux.n, seed)
    model = Backbone(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg), strict=True)
    return params, model.eval()


@pytest.mark.parametrize("smoke", [False, True])
def test_xlstm_config_matches_reference(smoke):
    """Every field the port has equals the reference's (``xlstm``
    included; ``remat`` the port's default "none" against the reference's
    "dots" in the full config), and so do ``layer_kinds`` (sLSTM at (i + 1) % 3 == 0, the
    smoke config's every 2nd layer; no MLP anywhere) and
    ``layer_pattern`` ((0, 3, 4) and (0, 2, 2): every layer scanned)."""
    get = "get_smoke_config" if smoke else "get_config"
    ours = getattr(torch_registry, get)(ARCH, mux_n=2)
    theirs = getattr(jax_registry, get)(ARCH, mux_n=2)
    for f in dataclasses.fields(ours):
        if f.name in ("mux", "serving", "xlstm"):
            continue
        if f.name == "remat" and not smoke:      # ROADMAP Queue C
            assert (ours.remat, theirs.remat) == ("none", "dots")
            continue
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert dataclasses.asdict(ours.xlstm) == dataclasses.asdict(theirs.xlstm)
    keys = ("mixer", "mlp", "window")
    assert [{k: d[k] for k in keys} for d in ours.layer_kinds()] == \
        [{k: d[k] for k in keys} for d in theirs.layer_kinds()]
    assert ours.layer_pattern() == theirs.layer_pattern()
    mixers = [k["mixer"] for k in ours.layer_kinds()]
    assert all(k["mlp"] is None for k in ours.layer_kinds())
    if smoke:
        assert mixers == ["mlstm", "slstm"] * 2
        assert ours.layer_pattern() == (0, 2, 2)
    else:
        assert [i for i, m in enumerate(mixers) if m == "slstm"] == \
            [2, 5, 8, 11]
        assert ours.layer_pattern() == (0, 3, 4)
        assert (ours.d_model, ours.xlstm.d_inner, ours.xlstm.head_dim,
                ours.vocab) == (768, 1536, 384, 50304)
    assert ours.family == "ssm"


def test_layer_rule_gives_xlstm_layers_no_mlp():
    """The reference's rule: only attention, MLA and Mamba mixers take an
    MLP when ``d_ff`` is set; xLSTM (checked before Mamba) takes none, and
    a hybrid's Mamba layers keep theirs."""
    from repro.configs import base as jax_base
    for arch, kw in ((ARCH, dict(d_ff=64)),
                     ("jamba-1.5-large-398b", dict(d_ff=64))):
        ours = dataclasses.replace(torch_registry.get_smoke_config(arch),
                                   **kw)
        theirs = dataclasses.replace(jax_registry.get_smoke_config(arch),
                                     **kw)
        assert [(k["mixer"], k["mlp"]) for k in ours.layer_kinds()] == \
            [(k["mixer"], k["mlp"]) for k in theirs.layer_kinds()]
    both = dataclasses.replace(
        torch_registry.get_smoke_config(ARCH), d_ff=64,
        mamba=torch_registry.get_smoke_config("jamba-1.5-large-398b").mamba)
    ref = dataclasses.replace(
        jax_registry.get_smoke_config(ARCH), d_ff=64,
        mamba=jax_registry.get_smoke_config("jamba-1.5-large-398b").mamba)
    assert isinstance(ref, jax_base.ModelConfig)
    assert [(k["mixer"], k["mlp"]) for k in both.layer_kinds()] == \
        [(k["mixer"], k["mlp"]) for k in ref.layer_kinds()] == \
        [("mlstm", None), ("slstm", None)] * 2


@pytest.mark.parametrize("length", [1, 12, 37])
def test_forward_backbone_matches_reference(length):
    """N 2, L 1, 12 and 37: logits within 1e-4 of ``Backbone.apply``."""
    jcfg, tcfg = _cfgs(2)
    params, model = _bridged(jcfg, tcfg)
    toks = tokens(tcfg, 2, length)
    want = JAX_FORWARD(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = model(as_torch(toks))
    _close(got["logits"], want["logits"], 1e-4)


def _engines(n=2, seed=1, lp=5, extra=8, **serving):
    jcfg, tcfg = _cfgs(n, **serving)
    params, model = _bridged(jcfg, tcfg, seed=seed)
    return (JaxEngine(params, jcfg, batch=B, max_len=lp + extra),
            Engine(model, batch=B, max_len=lp + extra), params, model, tcfg)


def _caches_close(mine_list, jcache, tcfg, atol=1e-5):
    """Every state leaf within ``atol`` x max(1, max|reference leaf|): the
    sLSTM normaliser n grows with the steps taken."""
    want = cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg)
    assert len(mine_list) == len(want) == tcfg.n_layers
    for mine, theirs, kind in zip(mine_list, want, tcfg.layer_kinds()):
        assert mine.keys() == theirs.keys() == STATE_KEYS[kind["mixer"]]
        for k in mine:
            ref = _np(theirs[k])
            _close(mine[k], ref, atol * max(1.0, float(np.abs(ref).max())))


def test_prefill_matches_reference():
    """``Engine.prefill`` of 5-token prompts (7 rows with the prefix):
    last-token logits within 1e-4, and every layer's state through the
    cache bridge within 1e-5."""
    jeng, eng, _, _, tcfg = _engines()
    prompts = tokens(tcfg, B, 5, seed=1)
    want, jstate = jeng.prefill(jnp.asarray(prompts))
    got, state = eng.prefill(as_torch(prompts))
    _close(got, want, 1e-4)
    _caches_close(state.cache, jstate.cache, tcfg)


def test_decode_steps_match_reference():
    """After an ``Engine.prefill``: three one-token steps at per-slot
    positions with a lane mask (a slot's lanes all idle); logits within
    1e-4 of the reference's ``decode_step`` at each step, the states
    within 1e-5.  A chunked step (``chunk_lens``) is refused in both
    packages with the reference's words."""
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
        for t in range(3):
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
        tok = tokens(tcfg, B, 3, seed=9)
        lens = np.array([3, 1, 2], np.int32)
        words = "no row-masked form yet; set prefill_chunk=1 for xLSTM"
        with pytest.raises(ValueError, match=words):
            JaxBackbone.decode_step(
                params, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg,
                index_embeds=jstate.index_embeds,
                chunk_lens=jnp.asarray(lens))
        with pytest.raises(ValueError, match=words):
            model.decode_step(as_torch(tok), cache, torch.from_numpy(pos),
                              index_embeds=state.index_embeds,
                              chunk_lens=torch.from_numpy(lens))
    _caches_close(cache, jcache, tcfg)


def test_paged_decode_steps_match_reference():
    """From a compact prime in both packages, the paged allocator over a
    model with no pooled layer (pages of 4, the page table only): decode
    steps with a lane mask; logits within 1e-4, the page tables equal,
    the states within 1e-5."""
    serving = dict(paged=True, page_size=4)
    jcfg, tcfg = _cfgs(2, **serving)
    params, model = _bridged(jcfg, tcfg, seed=2)
    jeng = JaxEngine(params, jcfg, batch=2, max_len=22)
    teng = Engine(model, batch=2, max_len=22)
    jprimed, tprimed = jeng.prime(compact=True), teng.prime(compact=True)
    jalloc = JaxPagedAllocator(jcfg, 2, jeng.max_len, template=jprimed.cache)
    talloc = PagedKVSlotAllocator(tcfg, 2, teng.max_len,
                                  template=tprimed.cache)
    assert talloc._paged == [False] * 4 and talloc.page_bytes() == 0
    rng = np.random.default_rng(0)
    pos = np.asarray(jprimed.pos).copy()
    for step in range(6):
        toks = rng.integers(0, jcfg.vocab, (2, 2)).astype(np.int32)
        mask = np.ones((2, 2), np.float32)
        mask[1, step % 2] = 0.0
        jalloc.ensure(pos, np.ones(2, bool))
        want, st = jeng.step(
            JaxServeState(cache=jalloc.cache, pos=jnp.asarray(pos),
                          index_embeds=jprimed.index_embeds),
            jnp.asarray(toks), lane_mask=jnp.asarray(mask),
            block_table=jalloc.block_table)
        jalloc.adopt(st.cache)
        talloc.ensure(pos, np.ones(2, bool))
        got, st = teng.step(ServeState(talloc.cache, pos.copy(),
                                       tprimed.index_embeds), toks,
                            lane_mask=mask, block_table=talloc.block_table)
        talloc.adopt(st.cache)
        _close(got, want, 1e-4)
        pos += 1
    assert (talloc.table.rows == jalloc.table.rows).all()
    assert talloc.table.peak_in_use == jalloc.table.peak_in_use
    _caches_close(talloc.cache, jalloc.cache, tcfg)


def _model(n=2, seed=0, **serving):
    _, tcfg = _cfgs(n, **serving)
    return Backbone(tcfg, seed=seed, device="cpu").eval()


def _with_serving(model, **serving):
    return model.with_config(dataclasses.replace(
        model.cfg, serving=torch_base.ServingConfig(**serving)))


def _step(eng, alloc, primed, pos, toks, mask):
    """One engine step through ``alloc`` (paged or not) at ``pos``."""
    kw = {}
    b = len(pos)
    if isinstance(alloc, PagedKVSlotAllocator):
        alloc.ensure(pos, np.ones(b, bool))
        kw["block_table"] = alloc.block_table
    logits, st = eng.step(ServeState(alloc.cache, pos.copy(),
                                     primed.index_embeds), toks,
                          lane_mask=mask, **kw)
    alloc.adopt(st.cache)
    return logits


def _serving_pair(model, paged_page=8, max_len=30):
    """(engine, allocator, primed) for the contiguous and the paged
    stacks over the same weights."""
    out = []
    for paged in (False, True):
        m = _with_serving(model, paged=paged, page_size=paged_page)
        eng = Engine(m, batch=2, max_len=max_len)
        primed = eng.prime(compact=paged)
        alloc = (PagedKVSlotAllocator if paged else KVSlotAllocator)(
            m.cfg, 2, eng.max_len, template=primed.cache)
        out.append((eng, alloc, primed))
    return out


def test_paged_equals_contiguous_bitwise():
    """Six steps of the smoke model on the paged stack (no layer pooled:
    every state contiguous beside an empty pool) and the contiguous one:
    logits bitwise, and every state leaf bitwise."""
    model = _model()
    (ec, ac, pc), (ep, ap, pp) = _serving_pair(model)
    pos = pc.pos.numpy().copy()
    assert np.array_equal(pos, pp.pos.numpy())
    rng = np.random.default_rng(0)
    for _ in range(6):
        toks = torch.from_numpy(rng.integers(0, 512, (2, 2)))
        mask = torch.ones((2, 2))
        la = _step(ec, ac, pc, pos, toks, mask)
        lb = _step(ep, ap, pp, pos, toks, mask)
        assert torch.equal(la, lb)
        pos += 1
    for a, b in zip(ac.cache, ap.cache):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k])


@pytest.mark.parametrize("paged", [False, True])
def test_masked_reset_restores_the_primed_template(paged):
    """After four steps, ``reset_slots`` of slot 0: its states are the
    primed template's bitwise (the state after the index-embed prefix,
    not zeros), slot 1's are untouched bitwise."""
    model = _model()
    eng, alloc, primed = _serving_pair(model)[int(paged)]
    pos = primed.pos.numpy().copy()
    rng = np.random.default_rng(1)
    for _ in range(4):
        _step(eng, alloc, primed, pos,
              torch.from_numpy(rng.integers(0, 512, (2, 2))),
              torch.ones((2, 2)))
        pos += 1
    live = [{k: t.clone() for k, t in layer.items()} for layer in alloc.cache]
    alloc.reset_slots(np.array([True, False]))
    for i, before in enumerate(live):
        for k in before:
            tmpl = primed.cache[i][k]
            if k != "m":
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
        eng, alloc, primed = _serving_pair(model)[int(paged)]
        pos = primed.pos.numpy().copy()
        out = []
        for t in range(6):
            if interrupt and t == 3:
                payload = alloc.park_slot(0)
                alloc.reset_slots(np.array([True, False]))
                gpos = primed.pos.numpy().copy()
                for g in range(2):
                    _step(eng, alloc, primed, gpos, seq[6 + g], mask)
                    gpos += 1
                alloc.reset_slots(np.array([True, False]))
                alloc.resume_slot(0, payload)
            out.append(_step(eng, alloc, primed, pos, seq[t], mask)[0])
            pos += 1
        runs.append(out)
    for a, b in zip(*runs):
        assert torch.equal(a, b)


def test_views_share_the_xlstm_weights():
    """A ``with_config`` view, a flash view and a narrowed model hold the
    mLSTM and sLSTM modules themselves (no attention anywhere); the views'
    logits are the model's bitwise."""
    _, tcfg = _cfgs(2)
    model = Backbone(tcfg, seed=0, device="cpu").eval()
    views = [model.with_config(dataclasses.replace(
        tcfg, serving=torch_base.ServingConfig(paged=True))),
        model.with_config(tcfg, use_flash=True)]
    toks = as_torch(tokens(tcfg, 1, 10))
    with torch.no_grad():
        want = model(toks)["logits"]
        for view in views + [model.narrowed(2)]:
            for v, m in zip(view.layers, model.layers):
                assert v.mlstm is m.mlstm and v.slstm is m.slstm
                assert v.attn is None and v.mlp is None
        for view in views:
            assert torch.equal(view(toks)["logits"], want)
    assert [type(layer.mlstm or layer.slstm).__name__
            for layer in model.layers] == ["MLSTM", "SLSTM"] * 2


@pytest.mark.parametrize("paged", [False, True])
def test_cache_bridge_maps_xlstm_caches(paged):
    """A reference xlstm cache (prefilled, or the paged allocator's after
    a compact prime) through ``cache_from_jax``: one dict a layer in the
    port's layout (``init_cache``'s keys, shapes and dtypes)."""
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
    for got, empty, kind in zip(layers, mine, tcfg.layer_kinds()):
        assert got.keys() == empty.keys() == STATE_KEYS[kind["mixer"]]
        for k in got:
            assert got[k].shape == empty[k].shape
            assert got[k].dtype == empty[k].dtype == torch.float32


# ---------------------------------------------------------------------------
# the reference's xlstm cases (tests/test_kvcache.py, test_serving.py,
# test_chunked_prefill.py) on the port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("full", [False, True])
def test_cache_bytes_match_reference(full):
    """``cache_bytes`` and ``paged_cache_bytes`` equal the reference's
    (every layer's float32 state, per slot, whatever the length or the
    pool); at the smoke size also the bytes of the port's own cache and
    paged allocator.  At full width an mLSTM layer holds 4 x (384² + 384 +
    1) x 4 bytes a slot and an sLSTM layer 4 x 768 x 4."""
    get = "get_config" if full else "get_smoke_config"
    tcfg = getattr(torch_registry, get)(ARCH, mux_n=2)
    jcfg = getattr(jax_registry, get)(ARCH, mux_n=2)
    for b, length in ((3, 24), (2, 40)):
        assert kvcache.cache_bytes(tcfg, b, length) == \
            jax_kvcache.cache_bytes(jcfg, b, length)
        assert kvcache.paged_cache_bytes(tcfg, b, length, pool_pages=13,
                                         page_size=8) == \
            jax_kvcache.paged_cache_bytes(jcfg, b, length, pool_pages=13,
                                          page_size=8) == \
            kvcache.cache_bytes(tcfg, b, length)
    if full:
        mlstm = kvcache._layer_bytes(tcfg, {"mixer": "mlstm"}, 1, 1)
        slstm = kvcache._layer_bytes(tcfg, {"mixer": "slstm"}, 1, 1)
        assert (mlstm, slstm) == (4 * (384 ** 2 + 384 + 1) * 4, 4 * 768 * 4)
        assert kvcache.cache_bytes(tcfg, 1, 1) == 8 * mlstm + 4 * slstm
        return
    assert kvcache.cache_nbytes(Backbone(tcfg, device="cpu")
                                .init_cache(3, 24)) == \
        kvcache.cache_bytes(tcfg, 3, 24)
    pcfg = dataclasses.replace(tcfg, serving=torch_base.ServingConfig(
        paged=True, page_size=8, pool_pages=13))
    alloc = PagedKVSlotAllocator(pcfg, 3, 24, device="cpu")
    assert kvcache.cache_nbytes(alloc.cache) == alloc.ring_bytes() == \
        alloc.bytes_in_use() == \
        kvcache.paged_cache_bytes(tcfg, 3, 24, pool_pages=13, page_size=8)


def test_decode_matches_full_forward():
    """``tests/test_serving.py``'s xlstm case on the port: prefill 12
    tokens, decode the 13th; its log-probabilities equal the 13-token
    forward's last position within the reference's 2e-2 (here 1e-4)."""
    model = _model()
    cfg = model.cfg
    toks = as_torch(tokens(cfg, 2, 13, seed=4))
    with torch.no_grad():
        want = model(toks)["logits"][:, :, -1]
        cache = model.init_cache(2, cfg.mux.prefix_len + 14)
        pre = model(toks[:, :, :12], cache=cache)
        got, _ = model.decode_step(toks[:, :, 12], pre["cache"],
                                   cfg.mux.prefix_len + 12,
                                   index_embeds=pre["index_embeds"])
    torch.testing.assert_close(torch.log_softmax(got, -1),
                               torch.log_softmax(want, -1), rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("n", [1, 2])
def test_engine_refuses_chunked_prefill_for_xlstm(n):
    """``tests/test_chunked_prefill.py``'s xLSTM refusal: an engine at
    prefill_chunk 2 raises naming the mixers and xLSTM, with the mux on or
    off; prefill_chunk 1 builds."""
    _, tcfg = _cfgs(n, prefill_chunk=2)
    model = Backbone(tcfg, device="cpu")
    with pytest.raises(ValueError, match=r"\['mlstm', 'slstm'\].*xLSTM"):
        Engine(model, batch=1, max_len=16)
    Engine(_with_serving(model, prefill_chunk=1), batch=1, max_len=16)


SCHED_COUNTS = {False: dict(decode_steps=12, generated_tokens=14,
                            slot_resets=1),
                True: dict(decode_steps=12, generated_tokens=14,
                           slot_resets=3, peak_pages=6)}


@pytest.mark.parametrize("paged", [False, True])
def test_scheduler_matches_reference(paged):
    """A Poisson trace (6 requests, prompt 4, 4 new tokens) at N 2 over 2
    slots on bridged weights, one token a step, contiguous and paged
    (pages of 4, no pooled layer): decode steps, generated tokens, slot
    resets, peak pages, every TTFT and every output token equal the JAX
    scheduler's, and the counts are 12 steps, 14 tokens, 1 slot reset
    contiguous; 6 peak pages and 3 slot resets paged."""
    jcfg, tcfg = _cfgs(2, paged=paged, page_size=4)
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
    for key, value in SCHED_COUNTS[paged].items():
        assert getattr(got, key) == value, key
    ours = {q.rid: q for q in sched.finished}
    for q in jsched.finished:
        assert ours[q.rid].ttft == q.ttft, q.rid
        assert ours[q.rid].output == q.output, q.rid


# ---------------------------------------------------------------------------
# bridge and training
# ---------------------------------------------------------------------------

def _tiny_full_trees():
    """The reference's param tree of the full xlstm model, by structure
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
    """xlstm-125m's own pattern (head 0, period 3, 4 groups: every layer
    scanned): every layer's leaves land under ``layers.{i}`` with i = g *
    3 + j, an mLSTM layer's under ``layers.{i}.mlstm`` and an sLSTM
    layer's under ``layers.{i}.slstm`` with the port's names; the port's
    own model has exactly these names; ``decay_mask`` gives the
    reference's ndim rule on its stacked tree for every one of them (every
    vector leaf of every layer is decayed, ``final_norm``'s not)."""
    full, tree, rule = _tiny_full_trees()
    assert full.layer_pattern() == (0, 3, 4)
    state = params_from_jax(tree, full)
    layers = {}
    for name, t in state.items():
        if name.startswith("layers."):
            i = int(name.split(".")[1])
            assert float(t.flatten()[0]) == i, name
            layers.setdefault(i, set()).add(name.split(".", 2)[2])
    assert sorted(layers) == list(range(12))
    mlstm = {"mlstm." + k for k in (
        "up.weight", "wq.weight", "wk.weight", "wv.weight", "wi.weight",
        "wi.bias", "wf.weight", "wf.bias", "wo.weight", "wo.bias",
        "down.weight")}
    slstm = {"slstm." + k for k in (
        "wx", "wr", "b", "ffn.up.weight", "ffn.gate.weight",
        "ffn.down.weight")}
    norm = {"norm1.scale", "norm1.bias"}
    for i, kind in enumerate(full.layer_kinds()):
        assert layers[i] == norm | (mlstm if kind["mixer"] == "mlstm"
                                    else slstm), i
    # the port's names at the full depth (the smoke widths: names do not
    # depend on widths)
    deep = dataclasses.replace(torch_registry.get_smoke_config(ARCH, mux_n=2),
                               n_layers=12, slstm_every=3)
    assert Backbone(deep, device="cpu").state_dict().keys() == state.keys()
    want = {k: bool(v.flatten()[0]) for k, v in
            params_from_jax(rule, full).items()}
    got = decay_mask(full, state)
    assert got == want
    assert got["layers.4.mlstm.wi.bias"] and got["layers.5.slstm.b"]
    assert got["layers.11.norm1.scale"] and not got["final_norm.scale"]


def _train_setup(n=2, task="lm"):
    jcfg, tcfg = _cfgs(n)
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
    """xlstm smoke is scanned too ((0, 2, 2)): every layer's vectors
    (``wi.bias``, sLSTM's ``b``, the norms) are decayed, as the reference
    decays its stacked leaves; ``final_norm``'s and the demux biases are
    not."""
    jcfg, tcfg = _cfgs(2)
    params, model = _bridged(jcfg, tcfg)
    rule = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2), params)
    want = {k: bool(v.flatten()[0])
            for k, v in params_from_jax(rule, tcfg).items()}
    got = decay_mask(tcfg, dict(model.named_parameters()))
    assert got == want
    assert got["layers.0.mlstm.wi.bias"] and got["layers.3.slstm.b"]
    assert not got["final_norm.bias"] and not got["demux.mlp.l0.bias"]


def test_train_step_grads_match_reference():
    """Task lm with the retrieval auxiliary, N 2, 20 tokens: loss, task
    and retrieval losses and every grad (every leaf of each mLSTM and
    sLSTM layer) within 1e-4 x max(1, max|ref|)."""
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
    for k in ("task_loss", "retr_loss"):
        close(metrics[k], jm[k])
    want_g = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        close(g, want_g[k].numpy())
    for name in ("mlstm.wq.weight", "mlstm.wi.bias", "mlstm.wf.weight",
                 "mlstm.down.weight"):
        assert grads[f"layers.2.{name}"].abs().max() > 0, name
    for name in ("slstm.wx", "slstm.wr", "slstm.b", "slstm.ffn.gate.weight"):
        assert grads[f"layers.3.{name}"].abs().max() > 0, name


def test_make_train_and_eval_steps_match_reference():
    """One jitted reference train step against ``make_train_step`` (loss
    and grad norm within 1e-4 relative), then ``make_eval_step`` on the
    updated weights, plain and through a ``use_flash`` view (no attention
    layer: the same path): losses within 1e-4 relative of the
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
        for key in ("task_loss", "retr_loss", "loss"):
            np.testing.assert_allclose(float(got[key]), float(want[key]),
                                       rtol=1e-4)


@pytest.mark.parametrize("flags", [["--paged"], []])
def test_serve_launcher_takes_xlstm(flags, capsys):
    sched, stats = serve.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--mux-n", "2",
         "--workload", "poisson", "--gen", "3", "--num-requests", "4",
         "--prompt-len", "5", *flags])
    assert stats.finished == 4
    assert sched.engine.cfg.xlstm is not None
    assert [set(layer) for layer in sched.allocator.cache] == \
        [STATE_KEYS["mlstm"], STATE_KEYS["slstm"]] * 2
    assert "[serve] continuous" in capsys.readouterr().out


def test_serve_launcher_refuses_chunked_prefill_for_xlstm():
    with pytest.raises(ValueError, match="xLSTM"):
        serve.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                    "--mux-n", "2", "--workload", "poisson",
                    "--prefill-chunk", "2", "--num-requests", "2"])

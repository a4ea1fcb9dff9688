"""The port's cross-attention (``repro_torch.nn.attention.CrossAttention``),
the block's gated cross sublayer, the encoder stack and the two models
that run them, whisper-base (audio) and llama-3.2-vision-11b (vlm),
against the JAX package.

* ``CrossAttention`` against the reference's ``precompute_kv`` / ``apply``
  on bridged weights, f32, within 1e-5: MHA and GQA, a context wider than
  the model, L 1 and 12.
* Each arch's smoke config (4 layers at d 256, a cross sublayer on layers
  0 and 2 over 24 context rows; whisper's with a 2-layer f32 encoder):
  the configs, ``layer_kinds``, ``layer_pattern`` and ``param_count``;
  ``encode_context`` within 1e-5; ``Backbone.forward`` with a context
  within 1e-4; logits that move with the context; ``Engine.generate``
  over a context (equal tokens, every step's logits within 1e-4); decode
  equal to the full forward; a chunked decode step; ``cache_bytes`` and
  ``paged_cache_bytes``; the bridge of params and context K/V and
  ``decay_mask``; LM-loss grads with a context and an eval step; the
  views; the refusals of ``Engine.prime`` (prefix demux) and
  ``ContinuousScheduler`` that the reference makes too.

The reference initialises every ``cross_gate`` to 0, so that a fresh
cross sublayer adds nothing to the logits; every test here sets the
gates to distinct nonzero values before bridging, and feeds a random
context (never zeros).  Every test runs with one torch thread.
"""
import dataclasses
import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.models import Backbone as JaxBackbone
from repro.nn.attention import AttnConfig as JaxAttnConfig
from repro.nn.attention import CrossAttention as JaxCrossAttention
from repro.serving import kvcache as jax_kvcache
from repro.serving.engine import Engine as JaxEngine
from repro.serving.scheduler import ContinuousScheduler as JaxScheduler
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer
from repro_torch import data as torch_data
from repro_torch.bridge import (cache_from_jax, cross_kv_from_jax,
                                decay_mask, params_from_jax)
from repro_torch.configs import base as torch_base
from repro_torch.configs import registry as torch_registry
from repro_torch.models import Backbone
from repro_torch.nn.attention import AttnConfig, CrossAttention
from repro_torch.serving import kvcache
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import ContinuousScheduler
from repro_torch.training.trainer import TrainConfig, Trainer
from torch_parity import as_torch, tokens

ARCHS = ["whisper-base", "llama-3.2-vision-11b"]
B = 2
# The reference's functions, compiled once per shape; the config static.
JAX_PRECOMPUTE = jax.jit(JaxCrossAttention.precompute_kv, static_argnums=(2,))
JAX_CROSS = jax.jit(JaxCrossAttention.apply, static_argnums=(3,))
JAX_INIT = jax.jit(JaxBackbone.init, static_argnums=(1,))
JAX_FORWARD = jax.jit(JaxBackbone.apply, static_argnums=(2,))
JAX_ENCODE = jax.jit(JaxBackbone.encode_context, static_argnums=(2,))
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
    return t.detach().float().numpy() if torch.is_tensor(t) \
        else np.asarray(t, np.float32)


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# CrossAttention
# ---------------------------------------------------------------------------

# (dim, heads, kv heads, head_dim, kv_dim): MHA at the model's width; GQA
# (two query heads per KV head) over a context wider than the model.
CROSS_CASES = {"mha": (32, 4, 4, 8, 32), "gqa": (32, 4, 2, 8, 40)}


def _cross_module(case):
    dim, h, kvh, hd, kv_dim = CROSS_CASES[case]
    kw = dict(dim=dim, n_heads=h, n_kv_heads=kvh, head_dim=hd)
    jcfg = JaxAttnConfig(**kw)
    params = JaxCrossAttention.init(jax.random.PRNGKey(3), jcfg,
                                    kv_dim=kv_dim)
    # the bridge reads only the layer count of the config
    state = params_from_jax({"head_layers": [{"cross": jax.tree.map(
        np.asarray, params)}]}, SimpleNamespace(n_layers=1, name="cross"))
    module = CrossAttention(AttnConfig(**kw), kv_dim=kv_dim)
    module.load_state_dict({k.removeprefix("layers.0.cross."): v
                            for k, v in state.items()}, strict=True)
    return params, jcfg, module.eval(), kv_dim


@pytest.mark.parametrize("case", sorted(CROSS_CASES))
@pytest.mark.parametrize("length", [1, 12])
def test_cross_attention_matches_reference(case, length):
    """K/V of a 9-row context within 1e-5, then the attention of L query
    rows over them within 1e-5; the parameter layout is the reference's
    (``wk`` / ``wv`` read the context's width)."""
    params, jcfg, module, kv_dim = _cross_module(case)
    dim = jcfg.dim
    assert tuple(module.wk.weight.shape) == (jcfg.n_kv_heads * 8, kv_dim)
    ctx, x = _x((B, 9, kv_dim), 1), _x((B, length, dim), 2)
    want_kv = JAX_PRECOMPUTE(params, jnp.asarray(ctx), jcfg)
    want = JAX_CROSS(params, jnp.asarray(x), want_kv, jcfg)
    with torch.no_grad():
        kv = module.precompute_kv(torch.from_numpy(ctx))
        got = module(torch.from_numpy(x), kv)
    assert kv.keys() == {"k", "v"}
    for k in kv:
        assert tuple(kv[k].shape) == (B, 9, jcfg.n_kv_heads, 8)
        _close(kv[k], want_kv[k], 1e-5)
    _close(got, want, 1e-5)


def test_cross_and_encoder_run_inside_their_profiler_labels():
    """Under a profiler the encoder stack runs inside ``encoder`` (once
    per context) and every cross-attention call inside ``cross``: each
    cross layer's K/V projection and its attention."""
    _, tcfg = _cfgs("whisper-base")
    model = Backbone(tcfg, device="cpu").eval()
    ctx = torch.from_numpy(_x((1, 24, tcfg.context_dim), 4))
    toks = as_torch(tokens(tcfg, 1, 5))
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU]) as prof, torch.no_grad():
        model(toks, context=ctx)
    counts = {e.key: e.count for e in prof.key_averages()}
    n_cross = sum(k["cross"] for k in tcfg.layer_kinds())
    assert counts.get("encoder") == 1 and counts.get("cross") == 2 * n_cross


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

def _config_fields_equal(ours, theirs, remat_set):
    """Every field the port keeps equal to the reference's; a nested
    config (the encoder) field by field the same way.  ``remat`` is the
    reference's where ``remat_set`` (a smoke config sets it), else the
    port's default "none" against the reference's "dots" (ROADMAP
    Queue C)."""
    for f in dataclasses.fields(ours):
        mine, ref = getattr(ours, f.name), getattr(theirs, f.name)
        if isinstance(mine, torch_base.ModelConfig):
            _config_fields_equal(mine, ref, remat_set=False)
        elif dataclasses.is_dataclass(mine):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        elif f.name == "remat" and not remat_set:
            assert (mine, ref) == ("none", "dots"), f.name
        else:
            assert mine == ref, f.name


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(arch, smoke):
    """The full and smoke configs field for field (the encoder's too),
    ``layer_kinds`` with its ``cross`` key, ``layer_pattern`` and
    ``param_count`` equal the reference's; llama-3.2-vision-11b's cross
    layers are 0, 5, ..., 35, whisper-base's every decoder layer."""
    get = "get_smoke_config" if smoke else "get_config"
    ours = getattr(torch_registry, get)(arch, mux_n=2)
    theirs = getattr(jax_registry, get)(arch, mux_n=2)
    _config_fields_equal(ours, theirs, remat_set=smoke)
    assert ours.layer_kinds() == theirs.layer_kinds()
    assert ours.layer_pattern() == theirs.layer_pattern()
    assert ours.param_count() == theirs.param_count()
    assert (ours.encoder is None) == (arch != "whisper-base")
    if ours.encoder is not None:
        assert ours.encoder.layer_kinds() == theirs.encoder.layer_kinds()
        assert not ours.encoder.causal
    cross = [i for i, k in enumerate(ours.layer_kinds()) if k["cross"]]
    if smoke:
        assert cross == [0, 2] and ours.context_len == 24
    elif arch == "whisper-base":
        assert cross == list(range(6)) and ours.context_len == 1500
    else:
        assert cross == list(range(0, 40, 5)) and ours.context_len == 1600
    assert ours.family == {"whisper-base": "audio",
                           "llama-3.2-vision-11b": "vlm"}[arch]


# ---------------------------------------------------------------------------
# the smoke models against the reference
# ---------------------------------------------------------------------------

def _cfgs(arch, n=2, kv=None, **serving):
    """(jax cfg, torch cfg): the arch's smoke config, ``kv`` KV heads."""
    out = []
    for reg, pkg in ((jax_registry, jax_base), (torch_registry, torch_base)):
        cfg = reg.get_smoke_config(arch, mux_n=n)
        kw = {"serving": pkg.ServingConfig(**serving)}
        if kv is not None:
            kw["n_kv_heads"] = kv
        out.append(dataclasses.replace(cfg, **kw))
    return tuple(out)


def _with_gates(params):
    """The reference's params with every ``cross_gate`` leaf set to
    distinct nonzero values (0.3, 0.45, 0.6, ...)."""
    count = [0]

    def gate(path, leaf):
        if getattr(path[-1], "key", None) != "cross_gate":
            return leaf
        start = 0.3 + 0.15 * count[0]
        count[0] += leaf.size
        return (start + 0.15 * jnp.arange(leaf.size, dtype=jnp.float32)) \
            .reshape(leaf.shape).astype(leaf.dtype)
    out = jax.tree_util.tree_map_with_path(gate, params)
    assert count[0] > 0
    return out


@functools.lru_cache(maxsize=None)
def _jax_params(arch, n=2, kv=None, seed=0):
    """The reference's smoke params, its cross gates nonzero; made once."""
    jcfg = _cfgs(arch, n, kv)[0]
    return _with_gates(JAX_INIT(jax.random.PRNGKey(seed), jcfg))


def _bridged(arch, n=2, kv=None, seed=0, **serving):
    jcfg, tcfg = _cfgs(arch, n, kv, **serving)
    params = _jax_params(arch, n, kv, seed)
    model = Backbone(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg), strict=True)
    return jcfg, tcfg, params, model.eval()


def _context(cfg, seed=0, b=B):
    return _x((b, cfg.context_len, cfg.context_dim), 100 + seed)


@pytest.mark.parametrize("arch", ARCHS)
def test_encode_context_matches_reference(arch):
    """The context through the encoder stack (whisper) and each cross
    layer's K/V projections: the reference's K/V through
    ``cross_kv_from_jax`` (its scanned entries unstacked) within 1e-5,
    keyed by the absolute index of each cross layer."""
    jcfg, tcfg, params, model = _bridged(arch)
    ctx = _context(tcfg)
    want = JAX_ENCODE(params, jnp.asarray(ctx), jcfg)
    want = cross_kv_from_jax(jax.tree.map(np.asarray, want), tcfg)
    with torch.no_grad():
        got = model.encode_context(torch.from_numpy(ctx))
    assert sorted(got) == sorted(want) == [0, 2]
    for i in got:
        assert got[i].keys() == {"k", "v"}
        for k in got[i]:
            assert got[i][k].shape == want[i][k].shape == \
                (B, 24, tcfg.n_kv_heads, tcfg.head_dim_)
            _close(got[i][k], want[i][k], 1e-5)


@pytest.mark.parametrize("arch,kv", [("whisper-base", None),
                                     ("llama-3.2-vision-11b", None),
                                     ("llama-3.2-vision-11b", 2)])
@pytest.mark.parametrize("length", [1, 12])
def test_forward_with_context_matches_reference(arch, kv, length):
    """N 2, L 1 and 12 over a 24-row context (the smoke models' MHA, and
    llama's at 2 KV heads): logits within 1e-4 of ``Backbone.apply``,
    whether the context is given or its K/V."""
    jcfg, tcfg, params, model = _bridged(arch, kv=kv)
    toks, ctx = tokens(tcfg, B, length, seed=length), _context(tcfg, length)
    want = JAX_FORWARD(params, jnp.asarray(toks), jcfg,
                       context=jnp.asarray(ctx))
    with torch.no_grad():
        got = model(as_torch(toks), context=torch.from_numpy(ctx))
        again = model(as_torch(toks), cross_kv=model.encode_context(
            torch.from_numpy(ctx)))
    _close(got["logits"], want["logits"], 1e-4)
    assert torch.equal(again["logits"], got["logits"])


@pytest.mark.parametrize("arch", ARCHS)
def test_logits_move_with_the_context(arch):
    """With the gates nonzero the context reaches the logits in both
    packages: two contexts give logits apart by more than 1e-2, and the
    port's difference is the reference's within 1e-4."""
    jcfg, tcfg, params, model = _bridged(arch)
    toks = tokens(tcfg, B, 6, seed=3)
    outs = []
    for seed in (0, 1):
        ctx = _context(tcfg, seed)
        want = JAX_FORWARD(params, jnp.asarray(toks), jcfg,
                           context=jnp.asarray(ctx))["logits"]
        with torch.no_grad():
            got = model(as_torch(toks), context=torch.from_numpy(ctx))
        outs.append((_np(got["logits"]), np.asarray(want)))
    moved = np.abs(outs[0][0] - outs[1][0]).max()
    assert moved > 1e-2
    _close(outs[0][0] - outs[1][0], outs[0][1] - outs[1][1], 1e-4)


def _engines(arch, lp=5, steps=4, **serving):
    jcfg, tcfg, params, model = _bridged(arch, **serving)
    return (JaxEngine(params, jcfg, batch=B, max_len=lp + steps + 1),
            Engine(model, batch=B, max_len=lp + steps + 1), params, model,
            jcfg, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_over_a_context_matches_reference(arch):
    """``Engine.generate`` of 5-token prompts, 4 steps, over a context:
    the reference's tokens; the prefill's and every step's logits within
    1e-4 of the reference's engine fed the same tokens; the state holds
    the context K/V, encoded once."""
    jeng, eng, _, model, _, tcfg = _engines(arch)
    prompts, ctx = tokens(tcfg, B, 5, seed=1), _context(tcfg, 2)
    want = np.asarray(jeng.generate(jnp.asarray(prompts), 4,
                                    context=jnp.asarray(ctx)))
    calls = []
    encode = model.encode_context
    model.encode_context = lambda c: calls.append(1) or encode(c)
    got = eng.generate(as_torch(prompts), 4, context=torch.from_numpy(ctx))
    assert calls == [1]
    np.testing.assert_array_equal(got.numpy(), want)
    jlogits, jstate = jeng.prefill(jnp.asarray(prompts),
                                   context=jnp.asarray(ctx))
    logits, state = eng.prefill(as_torch(prompts),
                                context=torch.from_numpy(ctx))
    assert sorted(state.cross_kv) == [0, 2]
    for t in range(4):
        _close(logits, jlogits, 1e-4)
        tok = want[..., t]
        jlogits, jstate = jeng.step(jstate, jnp.asarray(tok))
        logits, state = eng.step(state, as_torch(tok))
    _close(logits, jlogits, 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_equals_full_forward(arch):
    """On the port alone: a prefill of 4 tokens, then 5 one-token steps
    teacher-forced from the same 9-token sequence, give the full
    forward's logits at each position within 1e-4, over the same
    context."""
    _, tcfg, _, model = _bridged(arch)
    seq, ctx = as_torch(tokens(tcfg, B, 9, seed=5)), \
        torch.from_numpy(_context(tcfg, 5))
    eng = Engine(model, batch=B, max_len=9)
    with torch.no_grad():
        full = model(seq, context=ctx)["logits"]            # (B, N, 9, V)
    logits, state = eng.prefill(seq[..., :4], context=ctx)
    _close(logits, full[..., 3, :], 1e-4)
    for t in range(4, 9):
        logits, state = eng.step(state, seq[..., t])
        _close(logits, full[..., t, :], 1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_chunked_decode_step_matches_reference(arch):
    """``serving.prefill_chunk`` 4: after a prefill over the context, a
    chunk of 4 rows per slot with ragged lengths (4 and 2) at per-slot
    positions, then a one-token step; logits within 1e-4 of the
    reference's ``decode_step`` and the self-attention caches within
    1e-5."""
    jeng, eng, params, model, jcfg, tcfg = _engines(arch, lp=5, steps=8,
                                                    prefill_chunk=4)
    prompts, ctx = tokens(tcfg, B, 5, seed=6), _context(tcfg, 6)
    _, jstate = jeng.prefill(jnp.asarray(prompts), context=jnp.asarray(ctx))
    _, state = eng.prefill(as_torch(prompts), context=torch.from_numpy(ctx))
    jcache, cache = jstate.cache, state.cache
    pos = np.full(B, 5 + tcfg.mux.prefix_len, np.int32)
    pos[1] += 1
    lens = np.array([4, 2], np.int32)
    toks = tokens(tcfg, B, 4, seed=7)
    want, jcache = JAX_DECODE(
        params, jnp.asarray(toks), jcache, jnp.asarray(pos), jcfg,
        index_embeds=jstate.index_embeds, cross_kv=jstate.cross_kv,
        chunk_lens=jnp.asarray(lens))
    with torch.inference_mode():
        got, cache = model.decode_step(
            as_torch(toks), cache, torch.from_numpy(pos),
            index_embeds=state.index_embeds, cross_kv=state.cross_kv,
            chunk_lens=torch.from_numpy(lens))
        pos = pos + lens
        one = tokens(tcfg, B, 1, seed=8)[..., 0]
        want1, jcache = JAX_DECODE(
            params, jnp.asarray(one), jcache, jnp.asarray(pos), jcfg,
            index_embeds=jstate.index_embeds, cross_kv=jstate.cross_kv)
        got1, cache = model.decode_step(
            as_torch(one), cache, torch.from_numpy(pos),
            index_embeds=state.index_embeds, cross_kv=state.cross_kv)
    _close(got, want, 1e-4)
    _close(got1, want1, 1e-4)
    ref = cache_from_jax(jax.tree.map(np.asarray, jcache), tcfg)
    for mine, theirs in zip(cache, ref):
        for k in mine:
            _close(mine[k], theirs[k], 1e-5)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("full", [False, True])
def test_cache_bytes_match_reference(arch, full):
    """``cache_bytes`` and ``paged_cache_bytes`` count the context K/V of
    every slot as the reference does (the full models in bf16: 18.4 MB a
    slot for whisper-base, 52.4 MB for llama-3.2-vision-11b); at smoke
    size they are the bytes of ``init_cache`` plus those of the context
    K/V ``encode_context`` returns."""
    get = "get_config" if full else "get_smoke_config"
    ours = getattr(torch_registry, get)(arch, mux_n=2)
    theirs = getattr(jax_registry, get)(arch, mux_n=2)
    for b, length in ((1, 64), (3, 100)):
        assert kvcache.cache_bytes(ours, b, length) == \
            jax_kvcache.cache_bytes(theirs, b, length)
        assert kvcache.paged_cache_bytes(
            ours, b, length, pool_pages=9, page_size=16) == \
            jax_kvcache.paged_cache_bytes(theirs, b, length, pool_pages=9,
                                          page_size=16)
    per_slot = kvcache._cross_kv_bytes(ours, 1)
    if full:
        assert per_slot == {"whisper-base": 18_432_000,
                            "llama-3.2-vision-11b": 52_428_800}[arch]
        return
    model = Backbone(ours, device="cpu")
    with torch.no_grad():
        kv = model.encode_context(torch.from_numpy(_context(ours, b=3)))
    held = kvcache.cache_nbytes(model.init_cache(3, 40)) + sum(
        t.numel() * t.element_size() for d in kv.values() for t in d.values())
    assert held == kvcache.cache_bytes(ours, 3, 40)
    assert per_slot * 3 == sum(t.numel() * t.element_size()
                               for d in kv.values() for t in d.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_bridge_and_decay_mask_on_the_new_leaves(arch):
    """``params_from_jax`` gives every cross and encoder tensor under the
    port's name (``load_state_dict`` strict), each scanned ``cross_gate``
    its own entry of the reference's ``(groups,)`` array; ``decay_mask``
    is the reference's ndim >= 2 rule on its own tree (a scanned
    ``norm_x`` decayed, no gate decayed, the encoder's layers unscanned:
    their norms not decayed, their projections decayed)."""
    jcfg, tcfg, params, model = _bridged(arch)
    state = params_from_jax(jax.tree.map(np.asarray, params), tcfg)
    head, period, groups = tcfg.layer_pattern()
    assert (head, period, groups) == (0, 2, 2)
    gates = np.asarray(params["blocks"][0]["cross_gate"])
    assert gates.shape == (groups,) and len(set(gates.tolist())) == groups
    for g in range(groups):
        got = state[f"layers.{g * period}.cross_gate"]
        assert got.shape == () and float(got) == float(gates[g]) != 0
    names = {k for k in state if ".cross." in k or "norm_x" in k}
    assert names == {f"layers.{i}.{leaf}" for i in (0, 2) for leaf in (
        "norm_x.scale", "cross.wq.weight", "cross.wk.weight",
        "cross.wv.weight", "cross.wo.weight") + (
        ("norm_x.bias",) if tcfg.norm == "layernorm" else ())}
    rule = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2), params)
    want = {k: bool(v.flatten()[0])
            for k, v in params_from_jax(rule, tcfg).items()}
    got = decay_mask(tcfg, dict(model.named_parameters()))
    assert got == want
    assert got["layers.0.norm_x.scale"] and got["layers.2.cross.wk.weight"]
    assert not got["layers.0.cross_gate"]
    if arch == "whisper-base":
        assert any(k.startswith("encoder.layers.1.") for k in got)
        assert not got["encoder.layers.0.norm1.scale"]
        assert got["encoder.layers.0.attn.wq.weight"]
        assert not got["encoder.final_norm.scale"]
    else:
        assert not any(k.startswith("encoder.") for k in got)


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def _train_setup(arch):
    jcfg, tcfg = _cfgs(arch)
    kw = dict(task="lm", lr=1e-3, warmup=1, total_steps=10)
    jt, tt = JaxTrainConfig(**kw), TrainConfig(**kw)
    params = _jax_params(arch)
    state = Trainer.init_state(tcfg, tt, device="cpu")
    Trainer.load_params(state, params_from_jax(
        jax.tree.map(np.asarray, params), tcfg))
    return jcfg, tcfg, jt, tt, params, state


def _batch(tcfg, seq_len, seed):
    task = torch_data.RetrievalTask(vocab=tcfg.vocab, seq_len=seq_len)
    batch = next(iter(torch_data.mux_batches(task, B, 2, 1, seed=seed)))
    return {"tokens": np.asarray(batch["tokens"]),
            "context": _context(tcfg, seed)}


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_grads_with_a_context_match_reference(arch):
    """Task lm with the retrieval auxiliary, N 2, a context in the batch:
    loss, task and retrieval losses and every grad (the cross
    projections, the gates and the encoder's included) within 1e-4 x
    max(1, max|ref|); the gates' and the encoder's grads are nonzero."""
    jcfg, tcfg, jt, tt, params, state = _train_setup(arch)
    batch = _batch(tcfg, 10, 0)
    rng = jax.random.PRNGKey(7)
    (jloss, jm), jg = JAX_GRADS(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng, jcfg, jt)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (B, 10), 0,
                                                         2)))
    loss, metrics, grads = Trainer.grads(
        state, {"tokens": as_torch(batch["tokens"]),
                "context": torch.from_numpy(batch["context"])},
        None, tcfg, tt, retr_index=index)

    def close(got, want):
        want = np.asarray(want, np.float32)
        err = float(np.abs(_np(got) - want).max())
        assert err <= 1e-4 * max(1.0, float(np.abs(want).max())), err
    close(loss, jloss)
    for k in ("task_loss", "retr_loss"):
        close(metrics[k], jm[k])
    want_g = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        close(g, want_g[k].numpy())
    assert grads["layers.2.cross_gate"].abs() > 0
    assert grads["layers.0.cross.wk.weight"].abs().max() > 0
    if arch == "whisper-base":
        assert grads["encoder.layers.0.attn.wq.weight"].abs().max() > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_with_a_context_matches_reference(arch):
    """``make_eval_step`` with a context in the batch: the task and
    retrieval losses within 1e-4 relative of the reference's."""
    jcfg, tcfg, jt, tt, params, state = _train_setup(arch)
    batch = _batch(tcfg, 12, 2)
    rng = jax.random.PRNGKey(3)
    want = jax.jit(JaxTrainer.make_eval_step(jcfg, jt))(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (B, 12), 0,
                                                         2)))
    got = Trainer.make_eval_step(tcfg, tt)(state, batch, None,
                                           retr_index=index)
    for key in ("task_loss", "retr_loss", "loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# views and refusals
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_views_keep_the_cross_sublayer(arch):
    """``with_config`` (a flash view) and ``narrowed`` share the encoder
    and every cross sublayer, gate included, none copied: the flash view
    gives the model's logits over a context within 1e-5 (the flash op
    takes its plain version on the CPU; the cross-attention and the
    bidirectional encoder never reach it), and the narrowed model's
    logits still move with the context."""
    _, tcfg, _, model = _bridged(arch)
    flash = model.with_config(tcfg, use_flash=True)
    narrow = model.narrowed(1)
    for view in (flash, narrow):
        assert view.encoder is model.encoder
        for mine, theirs in zip(view.layers, model.layers):
            assert mine.cross is theirs.cross
            assert mine.norm_x is theirs.norm_x
            assert mine.cross_gate is theirs.cross_gate
        assert {p.data_ptr() for p in view.parameters()} <= \
            {p.data_ptr() for p in model.parameters()}
    assert flash.layers[0].attn.cfg.use_flash
    ctx = [torch.from_numpy(_context(tcfg, s)) for s in (0, 1)]
    toks = as_torch(tokens(tcfg, B, 7, seed=9))
    with torch.no_grad():
        want = model(toks, context=ctx[0])["logits"]
        _close(flash(toks, context=ctx[0])["logits"], want, 1e-5)
        one = as_torch(tokens(narrow.cfg, B, 7, seed=9))
        a, b = (narrow(one, context=c)["logits"] for c in ctx)
    assert (a - b).abs().max() > 1e-2


@pytest.mark.parametrize("arch", ARCHS)
def test_prime_and_scheduler_refuse_a_cross_config_as_the_reference(arch):
    """The reference runs the demux prefix without the context, so its
    ``Engine.prime`` (context given or not) and hence its
    ``ContinuousScheduler`` fail on a cross layer; the port refuses the
    same calls with the reference's words.  Without a context a forward
    is refused alike."""
    jeng, eng, params, model, jcfg, tcfg = _engines(arch)
    words = "cross-attn layer needs context kv"
    ctx = _context(tcfg)
    for kw in ({}, {"context": ctx}):
        with pytest.raises(AssertionError, match=words):
            jeng.prime(**{k: jnp.asarray(v) for k, v in kw.items()})
        with pytest.raises(ValueError, match=words):
            eng.prime(**{k: torch.from_numpy(v) for k, v in kw.items()})
    with pytest.raises(AssertionError, match=words):
        JaxScheduler(jeng)
    with pytest.raises(ValueError, match=words):
        ContinuousScheduler(eng)
    with pytest.raises(ValueError, match=words), torch.no_grad():
        model(as_torch(tokens(tcfg, B, 3)))

"""The port's Mixture-of-Experts block (``repro_torch.nn.moe``) and the
MoE family's first model, llama4-scout-17b-a16e, against the JAX package.

* The block against ``repro.nn.moe.MoE.apply`` (unsharded) on bridged
  weights, f32, within 1e-5: gated and ungated, softmax and sigmoid
  scoring, top-k 1 and 2, with and without a shared expert, no row mask,
  a partial one and an all-false one, at the default capacity and at one
  that drops tokens; the top-k tie-break; the seven row-mask and capacity
  contracts of ``tests/test_moe_masking.py`` on the port.
* ``llama4-scout-17b-a16e-smoke`` (4 layers, d 256, 4 experts top-1 and
  a shared expert, f32): the config field for field, forward logits and
  aux, decode steps with lane masks and the chunked step within 1e-4; the
  JAX ``ContinuousScheduler``'s decode steps, tokens and TTFTs, paged and
  contiguous, at prefill_chunk 1 and 4, at capacity_factor 1.25 (tokens
  dropped at decode) and 64 (none dropped); the port's paged run bitwise
  its contiguous one; one train step's loss, aux and grads within 1e-4;
  ``decay_mask``; the checkpoints; the launchers.
"""
import dataclasses
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.models import Backbone as JaxBackbone
from repro.nn.layers import MLP as JaxMLP
from repro.nn.moe import MoE as JaxMoE
from repro.nn.moe import MoEConfig as JaxMoEConfig
from repro.serving.engine import Engine as JaxEngine
from repro.serving.scheduler import ContinuousScheduler as JaxScheduler
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer
from repro_torch import data as torch_data
from repro_torch.bridge import decay_mask, params_from_jax
from repro_torch.checkpoint.io import (load_checkpoint,
                                       read_reference_checkpoint,
                                       save_checkpoint)
from repro_torch.configs import base as torch_base
from repro_torch.configs import registry as torch_registry
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import Backbone
from repro_torch.nn import moe as torch_moe
from repro_torch.nn.moe import MoE, MoEConfig
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import ContinuousScheduler, poisson_trace
from repro_torch.training.trainer import TrainConfig, Trainer
from torch_parity import as_torch, tokens

ARCH = "llama4-scout-17b-a16e"
DIM = 16
SEED = 0


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _block(cfg_kw: dict, key: int = 0):
    """(jax params, port MoE with the same weights) for one config."""
    params = JaxMoE.init(jax.random.PRNGKey(key), JaxMoEConfig(**cfg_kw))
    model = MoE(MoEConfig(**cfg_kw),
                generator=torch.Generator().manual_seed(key))
    # the bridge reads only the layer count of the config
    state = params_from_jax({"head_layers": [{"moe": jax.tree.map(
        np.asarray, params)}]}, SimpleNamespace(n_layers=1, name="block"))
    model.load_state_dict({k.removeprefix("layers.0.moe."): v
                           for k, v in state.items()}, strict=True)
    return params, model


def _np(t):
    return t.detach().numpy() if torch.is_tensor(t) else np.asarray(t)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _mask(kind, shape, seed):
    if kind == "none":
        return None
    if kind == "all-false":
        return np.zeros(shape, bool)
    m = np.random.default_rng(seed + 100).random(shape) > 0.4
    m[0, 0] = True
    return m


# ---------------------------------------------------------------------------
# the block against the reference
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("gated", [True, False])
@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
@pytest.mark.parametrize("top_k", [1, 2])
@pytest.mark.parametrize("shared", [0, 1])
@pytest.mark.parametrize("mask", ["none", "partial", "all-false"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
def test_moe_matches_reference(gated, scoring, top_k, shared, mask,
                               capacity_factor):
    """Outputs and aux within 1e-5 of ``MoE.apply`` (B 2, L 6, 4 experts):
    capacity_factor 0.5 gives 3 slots per expert at top-2 and 2 at top-1,
    so tokens are dropped."""
    kw = dict(dim=DIM, moe_ff=8, n_experts=4, top_k=top_k,
              n_shared_experts=shared, gated=gated, router_scoring=scoring,
              capacity_factor=capacity_factor)
    params, model = _block(kw)
    x = _x((2, 6, DIM), SEED)
    m = _mask(mask, (2, 6), SEED)
    want, want_aux = JaxMoE.apply(params, jnp.asarray(x), JaxMoEConfig(**kw),
                                  row_mask=None if m is None
                                  else jnp.asarray(m))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x),
                         None if m is None else torch.from_numpy(m))
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-5,
                               rtol=0)
    assert aux.dtype == torch.float32
    if mask == "all-false":
        assert float(aux) == 0.0
    if capacity_factor < 1 and mask != "all-false":
        routed = np.asarray(want) - (0 if not shared else np.asarray(
            JaxMLP.apply(params["shared"], jnp.asarray(x),
                         activation="silu")))
        dropped = np.abs(routed).max(-1) == 0
        if m is not None:
            dropped &= m
        assert dropped.any(), "precondition: the tight capacity drops"


@pytest.mark.parametrize("scoring", ["softmax", "sigmoid"])
@pytest.mark.parametrize("top_k", [1, 2, 3])
def test_top_k_ties_pick_the_references_experts(scoring, top_k):
    """Equal scores go to the lowest expert ids, as ``lax.top_k`` breaks
    ties: all-zero logits (a zero row), rows with two or three equal
    leaders, and a row whose tie sits below its leader."""
    cfg = dict(dim=DIM, moe_ff=8, n_experts=6, top_k=top_k,
               router_scoring=scoring)
    logits = np.array([[0, 0, 0, 0, 0, 0],
                       [1, 3, 0, 3, 3, -1],
                       [-2, -2, 5, 1, 1, 1],
                       [4, 4, 4, 4, 4, 4]], np.float32)
    want_w, want_ids, want_aux = JaxMoE._route(jnp.asarray(logits),
                                               JaxMoEConfig(**cfg))
    w, ids, aux = torch_moe.route(torch.from_numpy(logits), MoEConfig(**cfg))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(want_ids))
    np.testing.assert_allclose(w.numpy(), np.asarray(want_w), atol=1e-7)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)


def test_zero_rows_route_and_combine_as_the_reference():
    """A block of zero rows beside ordinary ones (a lock-step lane with no
    live token): every zero row scores all experts alike, so top-2 picks
    experts 0 and 1 and capacity drops the later ones; the whole block
    equals the reference's."""
    kw = dict(dim=DIM, moe_ff=8, n_experts=4, top_k=2, capacity_factor=1.0)
    params, model = _block(kw, key=3)
    x = _x((1, 8, DIM), 3)
    x[0, 1::2] = 0.0
    want, want_aux = JaxMoE.apply(params, jnp.asarray(x),
                                  JaxMoEConfig(**kw))
    with torch.no_grad():
        got, aux = model(torch.from_numpy(x))
        _, ids, _ = torch_moe.route(model.router(torch.from_numpy(x[0])),
                                    model.cfg)
    assert ids[1::2].tolist() == [[0, 1]] * 4
    np.testing.assert_allclose(_np(got), np.asarray(want), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6)


def test_capacity_is_the_references_arithmetic():
    """``ceil(T * k / E * cf)`` in Python floats over the padded block,
    at least 1: llama4's decode block of 8 slots over 16 experts has one
    slot per expert; the reference's boundary case 8.0005 gives 9."""
    llama4 = torch_registry.get_config(ARCH).moe
    assert torch_moe.capacity(8, llama4) == 1
    assert torch_moe.capacity(8 * 4, llama4) == 3
    assert torch_moe.capacity(520, llama4) == 41
    tight = MoEConfig(dim=DIM, moe_ff=8, n_experts=2, top_k=1,
                      capacity_factor=1.0000625)
    assert torch_moe.capacity(16, tight) == 9
    assert torch_moe.capacity(1, dataclasses.replace(
        tight, n_experts=64, capacity_factor=0.01)) == 1


def test_config_fields_match_the_references():
    """``MoEConfig`` keeps the reference's fields and defaults; a
    one-device mesh runs the unsharded block, as the reference's does; on
    a larger mesh, experts the expert-parallel size does not divide (2
    over data 4) raise a ValueError naming item 12b, before any
    collective."""
    ours = {f.name: f.default for f in dataclasses.fields(MoEConfig)}
    theirs = {f.name: f.default for f in dataclasses.fields(JaxMoEConfig)}
    assert ours == theirs
    _, model = _block(dict(dim=DIM, moe_ff=8, n_experts=2, top_k=1))
    x = torch.randn(1, 2, DIM, generator=torch.Generator().manual_seed(0))
    one = torch_moe.OnMesh(SimpleNamespace(size=lambda: 1), torch_moe.SINGLE)
    for got, want in zip(model(x, on_mesh=one), model(x)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError, match="item 12b"):
        model(torch.zeros(1, 2, DIM), on_mesh=torch_moe.OnMesh(
            SimpleNamespace(size=lambda: 4), torch_moe.MeshInfo(data_size=4)))


def test_stages_are_labelled_only_in_a_profile():
    """Under ``torch.profiler`` each stage of the block is a labelled range
    (the chip run's per-stage device time reads them); with no profiler
    running the block's output is the same."""
    from torch.profiler import ProfilerActivity, profile

    model = _port(_cfg(n_experts=4, top_k=2, n_shared_experts=1))
    x = torch.from_numpy(_x((1, 3, DIM), 7))
    with torch.no_grad():
        plain, _ = model(x)
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced, _ = model(x)
    assert {e.key for e in prof.key_averages() if e.key.startswith("moe.")} \
        == {"moe.route", "moe.dispatch", "moe.experts", "moe.combine",
            "moe.shared"}
    assert torch.equal(plain, traced)


# ---------------------------------------------------------------------------
# the row-mask and capacity contracts of tests/test_moe_masking.py
# ---------------------------------------------------------------------------

def _cfg(**kw):
    base = dict(dim=DIM, moe_ff=8, n_experts=2, top_k=1,
                capacity_factor=1.0, gated=True)
    base.update(kw)
    return MoEConfig(**base)


def _port(cfg, seed=0):
    return MoE(cfg, generator=torch.Generator().manual_seed(seed)).eval()


def _favoring_expert0(cfg, seed=0):
    """Router steered so every positive row picks expert 0: its logit is
    sum(x) > 0, every other expert's 0."""
    model = _port(cfg, seed)
    with torch.no_grad():
        model.router.weight.zero_()
        model.router.weight[0] = 1.0
    return model


def _positive_x(seed, shape):
    return torch.from_numpy(np.abs(_x(shape, seed)) + 0.1)


def test_capacity_ceil_boundary():
    """T*k/E * cf = 8.0005: 9 rows keep their routed output, not 8."""
    model = _favoring_expert0(_cfg(capacity_factor=1.0000625))
    with torch.no_grad():
        out, _ = model(_positive_x(0, (1, 16, DIM)))
    assert int((out[0].abs().amax(-1) > 0).sum()) == 9


def test_all_true_mask_is_noop_bitwise():
    model = _port(_cfg(n_experts=4, top_k=2, capacity_factor=1.25), 1)
    x = torch.from_numpy(_x((2, 8, DIM), 1))
    with torch.no_grad():
        a, aux_a = model(x)
        b, aux_b = model(x, torch.ones((2, 8), dtype=torch.bool))
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


def test_fully_masked_block_zero_aux_and_zero_output():
    model = _port(_cfg(n_experts=4, top_k=2), 2)
    x = torch.from_numpy(_x((1, 6, DIM), 2) * 50)
    with torch.no_grad():
        out, aux = model(x, torch.zeros((1, 6), dtype=torch.bool))
    assert float(aux) == 0.0
    assert not out.any()


def test_masked_rows_do_not_steal_capacity():
    """cap 4 of 8 rows, all wanting expert 0, padding ahead of the valid
    rows: unmasked, the padding takes every slot; masked, every valid row
    keeps its slot and every padding row is an exact zero."""
    model = _favoring_expert0(_cfg(), 3)
    x = _positive_x(3, (1, 8, DIM))
    mask = torch.tensor([[False] * 4 + [True] * 4])
    with torch.no_grad():
        unmasked, _ = model(x)
        masked, _ = model(x, mask)
    assert not unmasked[0, 4:].any()
    assert bool((masked[0, 4:].abs().amax(-1) > 0).all())
    assert not masked[0, :4].any()


def test_valid_rows_invariant_to_padding_content():
    model = _port(_cfg(n_experts=4, top_k=2, capacity_factor=1.25), 4)
    rng = np.random.default_rng(4)
    base = rng.normal(size=(2, 6, DIM)).astype(np.float32)
    mask = np.ones((2, 6), bool)
    mask[0, 4:] = False
    mask[1, 2:] = False
    other = base.copy()
    other[~mask] = rng.normal(size=((~mask).sum(), DIM)) * 9.
    m = torch.from_numpy(mask)
    with torch.no_grad():
        a, aux_a = model(torch.from_numpy(base), m)
        b, aux_b = model(torch.from_numpy(other), m)
    assert torch.equal(a[m], b[m]) and torch.equal(aux_a, aux_b)
    assert not a[~m].any()


def test_masked_aux_matches_compact_block():
    model = _port(_cfg(n_experts=4, top_k=2, capacity_factor=8.0), 5)
    rng = np.random.default_rng(5)
    valid = rng.normal(size=(1, 5, DIM)).astype(np.float32)
    padded = np.concatenate(
        [valid, rng.normal(size=(1, 3, DIM)).astype(np.float32)], axis=1)
    with torch.no_grad():
        _, aux_masked = model(torch.from_numpy(padded),
                              torch.tensor([[True] * 5 + [False] * 3]))
        _, aux_alone = model(torch.from_numpy(valid))
    np.testing.assert_allclose(float(aux_masked), float(aux_alone),
                               rtol=1e-6)


def test_shared_expert_runs_on_masked_rows():
    model = _port(_cfg(n_shared_experts=1), 6)
    x = torch.from_numpy(_x((1, 4, DIM), 6))
    with torch.no_grad():
        out, _ = model(x, torch.zeros((1, 4), dtype=torch.bool))
        assert torch.equal(out, model.shared(x))


# ---------------------------------------------------------------------------
# llama4-scout-17b-a16e
# ---------------------------------------------------------------------------

def _cfgs(n, *, moe=None, **serving):
    """(jax cfg, torch cfg): llama4's smoke config, ``moe`` fields
    replaced."""
    out = []
    for reg, pkg in ((jax_registry, jax_base), (torch_registry, torch_base)):
        cfg = reg.get_smoke_config(ARCH, mux_n=n)
        out.append(dataclasses.replace(
            cfg, serving=pkg.ServingConfig(**serving),
            moe=dataclasses.replace(cfg.moe, **(moe or {}))))
    return tuple(out)


def _bridged(jcfg, tcfg, seed=0):
    params = JaxBackbone.init(jax.random.PRNGKey(seed), jcfg)
    model = Backbone(tcfg, device="cpu")
    model.load_state_dict(params_from_jax(jax.tree.map(np.asarray, params),
                                          tcfg), strict=True)
    return params, model.eval()


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               atol=atol, rtol=0)


@pytest.mark.parametrize("smoke", [False, True])
def test_llama4_config_matches_reference(smoke):
    """Every field the port has equals the reference's (its MoEConfig
    included), and so do ``layer_kinds`` and ``layer_pattern``: every
    layer MoE, all of them scanned in the reference."""
    get = "get_smoke_config" if smoke else "get_config"
    ours = getattr(torch_registry, get)(ARCH, mux_n=2)
    theirs = getattr(jax_registry, get)(ARCH, mux_n=2)
    for f in dataclasses.fields(ours):
        if f.name in ("mux", "serving", "moe"):
            continue
        assert getattr(ours, f.name) == getattr(theirs, f.name), f.name
    assert dataclasses.asdict(ours.moe) == dataclasses.asdict(theirs.moe)
    keys = ("mixer", "mlp", "window")
    assert [{k: d[k] for k in keys} for d in ours.layer_kinds()] == \
        [{k: d[k] for k in keys} for d in theirs.layer_kinds()]
    assert ours.layer_pattern() == theirs.layer_pattern() == \
        (0, 1, ours.n_layers)
    assert all(k["mlp"] == "moe" for k in ours.layer_kinds())


def test_moe_layer_rule_and_families():
    """``moe_layer_start`` / ``moe_every`` place the MoE layers as the
    reference does; a family the port does not know is refused."""
    kw = dict(n_layers=7, moe_layer_start=2, moe_every=2)
    ours = dataclasses.replace(torch_registry.get_smoke_config(ARCH), **kw)
    theirs = dataclasses.replace(jax_registry.get_smoke_config(ARCH), **kw)
    assert [k["mlp"] for k in ours.layer_kinds()] == \
        [k["mlp"] for k in theirs.layer_kinds()] == \
        ["dense", "dense", "moe", "dense", "moe", "dense", "moe"]
    assert ours.layer_pattern() == theirs.layer_pattern()
    with pytest.raises(ValueError, match="unknown model family 'speech'"):
        dataclasses.replace(ours, family="speech")


@pytest.mark.parametrize("n", [1, 4])
def test_forward_matches_reference(n):
    """L 20: logits within 1e-4 and the summed aux within 1e-4 of
    ``Backbone.apply``; the router weight stays float32 in a bf16 model."""
    jcfg, tcfg = _cfgs(n)
    params, model = _bridged(jcfg, tcfg)
    toks = tokens(tcfg, 2, 20)
    want = JaxBackbone.apply(params, jnp.asarray(toks), jcfg)
    with torch.no_grad():
        got = model(as_torch(toks))
    _close(got["logits"], want["logits"], 1e-4)
    _close(got["aux"], want["aux"], 1e-4)
    assert float(got["aux"]) > 0
    bf16 = Backbone(dataclasses.replace(tcfg, dtype="bfloat16",
                                        param_dtype="bfloat16"),
                    device="cpu")
    dtypes = {k: v.dtype for k, v in bf16.state_dict().items()}
    assert {v for k, v in dtypes.items() if "router" in k} == \
        {torch.float32}
    assert dtypes["layers.0.moe.up"] == torch.bfloat16


def test_with_config_view_shares_the_experts():
    """A ``with_config`` view holds every MoE tensor of the model (none
    copied) and gives its logits and aux bitwise."""
    _, tcfg = _cfgs(2)
    model = Backbone(tcfg, seed=0, device="cpu").eval()
    view = model.with_config(dataclasses.replace(
        tcfg, serving=torch_base.ServingConfig(paged=True)))
    assert {p.data_ptr() for p in view.parameters()} == \
        {p.data_ptr() for p in model.parameters()}
    toks = as_torch(tokens(tcfg, 1, 12))
    with torch.no_grad():
        a, b = model(toks), view(toks)
    assert torch.equal(a["logits"], b["logits"])
    assert torch.equal(a["aux"], b["aux"])


@pytest.mark.parametrize("n", [1, 4])
def test_decode_steps_with_lane_masks_match_reference(n):
    """After an ``Engine.prefill``: per-slot positions and a lane mask with
    a slot whose lanes are all idle (its row leaves the MoE dispatch),
    then a chunked step of 3 rows with ragged ``chunk_lens`` and a
    (B, N, C) lane mask; logits within 1e-4 of the reference's
    ``decode_step`` at each step."""
    jcfg, tcfg = _cfgs(n, moe={"capacity_factor": 1.0})
    params, model = _bridged(jcfg, tcfg, seed=1)
    b, lp = 3, 6
    prompts = tokens(tcfg, b, lp, seed=1)
    jeng = JaxEngine(params, jcfg, batch=b, max_len=lp + 8)
    eng = Engine(model, batch=b, max_len=lp + 8)
    _, jstate = jeng.prefill(jnp.asarray(prompts))
    _, state = eng.prefill(as_torch(prompts))
    jcache, cache = jstate.cache, state.cache
    p0 = lp + tcfg.mux.prefix_len
    lanes = max(n, 1)
    mask = np.ones((b, lanes), np.int32)
    mask[1] = 0
    if lanes > 1:
        mask[2, 1] = 0
    pos = np.array([p0, p0, p0], np.int32)
    with torch.inference_mode():        # the prefilled cache's mode
        for t in range(2):
            tok = tokens(tcfg, b, 1, seed=5 + t)[..., 0]
            want, jcache = JaxBackbone.decode_step(
                params, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg,
                index_embeds=jstate.index_embeds,
                lane_mask=jnp.asarray(mask))
            got, cache = model.decode_step(
                as_torch(tok), cache, torch.from_numpy(pos),
                index_embeds=state.index_embeds,
                lane_mask=torch.from_numpy(mask))
            _close(got, want, 1e-4)
            pos = pos + 1
        c = 3
        lens = np.array([3, 1, 2], np.int32)
        tok = tokens(tcfg, b, c, seed=9)
        cmask = np.ones((b, lanes, c), np.int32)
        cmask[1] = 0
        cmask[0, 0, 2] = 0
        want, _ = JaxBackbone.decode_step(
            params, jnp.asarray(tok), jcache, jnp.asarray(pos), jcfg,
            index_embeds=jstate.index_embeds, lane_mask=jnp.asarray(cmask),
            chunk_lens=jnp.asarray(lens))
        got, _ = model.decode_step(
            as_torch(tok), cache, torch.from_numpy(pos),
            index_embeds=state.index_embeds, lane_mask=torch.from_numpy(cmask),
            chunk_lens=torch.from_numpy(lens))
        _close(got, want, 1e-4)


class _Logits:
    """Records every engine step's logits (for bitwise comparisons)."""

    def __init__(self, sched):
        self.steps = []
        inner = sched.engine.step

        def step(state, toks, **kw):
            logits, state = inner(state, toks, **kw)
            self.steps.append(logits.clone())
            return logits, state
        sched.engine.step = step


SCHED_CASES = [(paged, chunk, cf) for cf in (1.25, 64.0)
               for chunk in (1, 4) for paged in (False, True)]


@pytest.mark.parametrize("paged,chunk,cf", SCHED_CASES)
def test_scheduler_matches_reference(paged, chunk, cf):
    """A Poisson trace at N 4 over 3 slots: decode steps, generated tokens,
    slot resets, peak pages, every TTFT and every output token equal the
    JAX scheduler's.  At capacity_factor 1.25 a decode step of 3 rows has
    one slot per expert, so colliding rows drop their routed output, as in
    the reference."""
    jcfg, tcfg = _cfgs(4, moe={"capacity_factor": cf}, paged=paged,
                       page_size=4, prefill_chunk=chunk)
    params, model = _bridged(jcfg, tcfg, seed=2)
    max_total = 30
    trace = poisson_trace(12, rate=1.0, prompt_len=6, gen_len=6,
                          vocab=tcfg.vocab, max_total=max_total, seed=SEED)
    jsched = JaxScheduler(JaxEngine(params, jcfg, batch=3,
                                    max_len=max_total))
    want = jsched.run([r.fresh() for r in trace])
    sched = ContinuousScheduler(Engine(model, batch=3, max_len=max_total))
    got = sched.run([r.fresh() for r in trace])
    for key in ("decode_steps", "generated_tokens", "slot_resets",
                "peak_pages", "finished"):
        assert getattr(got, key) == getattr(want, key), key
    ours = {q.rid: q for q in sched.finished}
    for q in jsched.finished:
        assert ours[q.rid].ttft == q.ttft, q.rid
        assert ours[q.rid].output == q.output, q.rid


@pytest.mark.parametrize("chunk", [1, 4])
def test_paged_matches_contiguous_bitwise(chunk):
    """The port's paged scheduler gives its contiguous one's tokens and
    every step's logits bitwise (the MoE dispatch sees the same blocks)."""
    runs = []
    for paged in (False, True):
        _, tcfg = _cfgs(4, paged=paged, page_size=4, prefill_chunk=chunk)
        model = Backbone(tcfg, seed=3, device="cpu").eval()
        trace = poisson_trace(10, rate=1.0, prompt_len=5, gen_len=5,
                              vocab=tcfg.vocab, max_total=28, seed=SEED)
        sched = ContinuousScheduler(Engine(model, batch=3, max_len=28))
        rec = _Logits(sched)
        sched.run([r.fresh() for r in trace])
        runs.append(({q.rid: q.output for q in sched.finished}, rec.steps))
    (out_a, steps_a), (out_b, steps_b) = runs
    assert out_a == out_b
    assert len(steps_a) == len(steps_b)
    assert all(torch.equal(a, b) for a, b in zip(steps_a, steps_b))


# ---------------------------------------------------------------------------
# training and checkpoints
# ---------------------------------------------------------------------------

def _train_setup(n=4, task="lm"):
    jcfg, tcfg = _cfgs(n)
    kw = dict(task=task, lr=1e-3, warmup=1, total_steps=10)
    jt, tt = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = JaxTrainer.init_state(jax.random.PRNGKey(0), jcfg, jt)
    state = Trainer.init_state(tcfg, tt, device="cpu")
    Trainer.load_params(state, params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg))
    return jcfg, tcfg, jt, tt, jstate, state


def test_train_step_grads_match_reference():
    """Task lm with the retrieval auxiliary, N 4: loss, task and retrieval
    losses, ``moe_aux`` and every grad (router, experts, shared expert
    included) within 1e-4 x max(1, max|ref|)."""
    jcfg, tcfg, jt, tt, jstate, state = _train_setup()
    task = torch_data.RetrievalTask(vocab=tcfg.vocab, seq_len=10)
    batch = next(iter(torch_data.mux_batches(task, 2, 4, 1, seed=0)))
    rng = jax.random.PRNGKey(7)
    (jloss, jm), jg = jax.value_and_grad(JaxTrainer.loss_fn, has_aux=True)(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()},
        rng, jcfg, jt)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (2, 10), 0,
                                                         4)))
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
    assert float(metrics["moe_aux"]) > 0
    want_g = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        close(g, want_g[k].numpy())
    assert grads["layers.0.moe.router.weight"].abs().max() > 0


def test_make_train_step_matches_reference():
    """One jitted reference step against ``make_train_step``: loss and
    grad norm within 1e-4 relative, ``moe_aux`` within 1e-4."""
    jcfg, tcfg, jt, tt, jstate, state = _train_setup(task="retrieval")
    task = torch_data.RetrievalTask(vocab=tcfg.vocab, seq_len=8)
    batch = next(iter(torch_data.mux_batches(task, 2, 4, 1, seed=1)))
    rng = jax.random.PRNGKey(1)
    _, jm = jax.jit(JaxTrainer.make_train_step(jcfg, jt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (2, 8), 0,
                                                         4)))
    _, m = Trainer.make_train_step(tcfg, tt)(state, batch, None,
                                             retr_index=index)
    for key in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-4)
    np.testing.assert_allclose(float(m["moe_aux"]), float(jm["moe_aux"]),
                               atol=1e-4)


def test_eval_step_matches_reference():
    """``make_eval_step`` (task lm, retrieval on): losses and ``moe_aux``
    within 1e-4 relative of the reference's."""
    jcfg, tcfg, jt, tt, jstate, state = _train_setup()
    task = torch_data.RetrievalTask(vocab=tcfg.vocab, seq_len=12)
    batch = next(iter(torch_data.mux_batches(task, 2, 4, 1, seed=2)))
    rng = jax.random.PRNGKey(3)
    want = JaxTrainer.make_eval_step(jcfg, jt)(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (2, 12), 0,
                                                         4)))
    got = Trainer.make_eval_step(tcfg, tt)(state, batch, None,
                                           retr_index=index)
    for key in ("task_loss", "retr_loss", "loss", "moe_aux"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4)


def test_decay_mask_is_the_references_rule():
    """The reference decays a leaf iff ndim >= 2 on its scanned tree:
    every llama4 layer is scanned, so every norm scale, the f32 router and
    every expert tensor are decayed; ``final_norm`` is not."""
    _, tcfg, _, _, jstate, state = _train_setup()
    rule = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2),
                        jstate["params"])
    want = {k: bool(v.flatten()[0])
            for k, v in params_from_jax(rule, tcfg).items()}
    got = decay_mask(tcfg, Trainer.params(state))
    assert got == want
    for name in ("layers.1.norm2.scale", "layers.1.moe.router.weight",
                 "layers.1.moe.up", "layers.1.moe.gate", "layers.1.moe.down",
                 "layers.1.moe.shared.up.weight"):
        assert got[name], name
    assert not got["final_norm.scale"]


def test_checkpoint_roundtrip_and_reference_file(tmp_path):
    """A bf16 llama4 smoke state round-trips bitwise (the router float32,
    the experts bf16); and the reference's checkpoint of a trained state
    is read without JAX, bridged bitwise as the tree in memory, and
    loaded."""
    from repro.checkpoint.io import save_checkpoint as jax_save

    kw = dict(dtype="bfloat16", param_dtype="bfloat16")
    _, tcfg = _cfgs(2)
    tcfg = dataclasses.replace(tcfg, **kw)
    model = Backbone(tcfg, seed=4, device="cpu")
    path = str(tmp_path / "port.npz")
    save_checkpoint(path, {"model": model}, step=3)
    fresh = Backbone(tcfg, seed=5, device="cpu")
    (tree, meta) = load_checkpoint(path, {"model": fresh})
    assert meta["step"] == 3
    for k, v in model.state_dict().items():
        assert torch.equal(fresh.state_dict()[k], v), k
    assert fresh.layers[0].moe.router.weight.dtype == torch.float32
    assert fresh.layers[0].moe.up.dtype == torch.bfloat16

    jcfg, _ = _cfgs(2)
    jcfg = dataclasses.replace(jcfg, **kw)
    jt = JaxTrainConfig(task="lm", lr=1e-3, warmup=1)
    jstate = JaxTrainer.init_state(jax.random.PRNGKey(0), jcfg, jt)
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (2, 2, 8),
                                          0, tcfg.vocab)}
    jstate, _ = jax.jit(JaxTrainer.make_train_step(jcfg, jt))(
        jstate, batch, jax.random.PRNGKey(2))
    ref = str(tmp_path / "ref.npz")
    jax_save(ref, jax.device_get(jstate), step=1)
    tree, meta = read_reference_checkpoint(ref)
    got = params_from_jax(tree["params"], tcfg)
    want = params_from_jax(jax.tree.map(np.asarray, jstate["params"]), tcfg)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k])
    assert want["layers.0.moe.router.weight"].dtype == torch.float32
    state = Trainer.init_state(tcfg, TrainConfig(task="lm"), device="cpu")
    Trainer.load_params(state, got)
    assert torch.equal(state["model"].layers[2].moe.down.float(),
                       got["layers.2.moe.down"].float())


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_takes_llama4(capsys):
    sched, stats = serve.main(
        ["--arch", ARCH, "--smoke", "--device", "cpu", "--mux-n", "2",
         "--workload", "poisson", "--paged", "--prefill-chunk", "2",
         "--gen", "3", "--num-requests", "4", "--prompt-len", "5"])
    assert stats.finished == 4
    assert sched.engine.cfg.moe is not None
    assert "[serve] continuous" in capsys.readouterr().out


def test_train_launcher_takes_llama4(capsys):
    _, history = train_launcher.main(
        ["--arch", ARCH, "--device", "cpu", "--smoke", "--steps", "2",
         "--batch", "2", "--seq-len", "8"])
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                      for h in history)
    assert "[train] done" in capsys.readouterr().out

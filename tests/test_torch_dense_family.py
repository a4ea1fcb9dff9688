"""The rest of the dense family in the port — gemma-7b (GeGLU, hd 256),
gemma3-4b (sliding-window local layers, every 6th global) and
nemotron-4-340b (LayerNorm, squared ReLU, untied head, GQA) — against the
JAX package at smoke size (4 layers, d 256; gemma3: window 16, every 2nd
layer global; f32, weights bridged from the reference): the layer
structure the bridge and the optimizer read, the cache-free forward with
and without ``use_flash``, evaluation, lock-step decode, the continuous
paged scheduler with chunked prefill, one train step, and the launchers.
Windowed attention in detail: ``tests/test_torch_window.py``."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.models import Backbone as JaxBackbone
from repro.serving.engine import Engine as JaxEngine
from repro.serving.scheduler import ContinuousScheduler as JaxScheduler
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer
from repro_torch import data as torch_data
from repro_torch.bridge import decay_mask, opt_state_from_jax, params_from_jax
from repro_torch.configs import base as torch_base
from repro_torch.configs import registry as torch_registry
from repro_torch.kernels.attention import ops as flash_ops
from repro_torch.launch import serve
from repro_torch.launch import train as train_launcher
from repro_torch.models import Backbone
from repro_torch.serving.engine import Engine
from repro_torch.serving.scheduler import ContinuousScheduler, poisson_trace
from repro_torch.training.trainer import TrainConfig, Trainer
from torch_parity import as_torch, bridged, tokens


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


ARCHS = ["gemma-7b", "gemma3-4b", "nemotron-4-340b"]
MARGIN = 1e-3


def _cfgs(arch, n, **serving):
    """(jax cfg, torch cfg): the arch's smoke config."""
    return tuple(dataclasses.replace(
        reg.get_smoke_config(arch, mux_n=n),
        serving=pkg.ServingConfig(**serving))
        for reg, pkg in ((jax_registry, jax_base),
                         (torch_registry, torch_base)))


def _close(got, want, atol):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), atol=atol,
                               rtol=0)


# ---------------------------------------------------------------------------
# layer structure
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("smoke", [False, True])
def test_layer_kinds_and_pattern_match_reference(arch, smoke):
    """``layer_kinds`` (mixer, mlp, window per layer) and ``layer_pattern``
    — which the bridge's scan layout and ``decay_mask`` read — equal the
    reference's; ``attn_config(window=...)`` too."""
    get = "get_smoke_config" if smoke else "get_config"
    ours = getattr(torch_registry, get)(arch, mux_n=2)
    theirs = getattr(jax_registry, get)(arch, mux_n=2)
    keys = ("mixer", "mlp", "window")
    assert [{k: d[k] for k in keys} for d in ours.layer_kinds()] == \
        [{k: d[k] for k in keys} for d in theirs.layer_kinds()]
    assert ours.layer_pattern() == theirs.layer_pattern()
    for window in {k["window"] for k in ours.layer_kinds()}:
        a = ours.attn_config(window=window, use_flash=True)
        b = theirs.attn_config(window=window, use_flash=True)
        for f in dataclasses.fields(a):
            assert getattr(a, f.name) == getattr(b, f.name), f.name


def test_gemma3_has_29_local_and_5_global_layers():
    kinds = torch_registry.get_config("gemma3-4b").layer_kinds()
    local = [i for i, k in enumerate(kinds) if k["window"] == 1024]
    glob = [i for i, k in enumerate(kinds) if k["window"] is None]
    assert len(local) == 29 and glob == [5, 11, 17, 23, 29]
    assert torch_registry.get_config("gemma3-4b").layer_pattern() == \
        (0, 6, 5)
    smoke = torch_registry.get_smoke_config("gemma3-4b")
    assert (smoke.window, smoke.global_every) == (16, 2)
    assert smoke.layer_pattern() == (0, 2, 2)


# ---------------------------------------------------------------------------
# forward and evaluation
# ---------------------------------------------------------------------------

def _count_flash_calls(monkeypatch) -> list:
    calls = []
    real = flash_ops.flash_attention

    def counted(*a, **kw):
        calls.append(kw)
        return real(*a, **kw)
    monkeypatch.setattr(flash_ops, "flash_attention", counted)
    return calls


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("n,use_flash", [(1, False), (4, False), (4, True)])
def test_backbone_matches_reference(arch, n, use_flash, monkeypatch):
    """L 40 (> gemma3's window 16): logits within 1e-4 of the reference's
    ``Backbone.apply``; with ``use_flash`` (its plain version on the CPU)
    only the global layers call flash, the local ones keep the masked
    attention."""
    jcfg, tcfg = _cfgs(arch, n)
    params, model = bridged(jcfg, tcfg)
    if use_flash:
        flash = Backbone(tcfg, device="cpu", use_flash=True).eval()
        flash.load_state_dict(model.state_dict())
        model = flash
    toks = tokens(tcfg, 2, 40)
    want = JaxBackbone.apply(params, jnp.asarray(toks), jcfg)
    calls = _count_flash_calls(monkeypatch)
    with torch.no_grad():
        got = model(as_torch(toks))
    n_global = sum(k["window"] is None for k in tcfg.layer_kinds())
    assert len(calls) == (n_global if use_flash else 0)
    _close(got["logits"], want["logits"], 1e-4)


def test_with_config_view_sets_flash_and_keeps_windows(monkeypatch):
    """``with_config(cfg, use_flash=False)`` of a flash model is a view:
    every parameter shared, each layer's window kept, no flash call, and
    the logits of a plain model with the same weights."""
    _, tcfg = _cfgs("gemma3-4b", 2)
    model = Backbone(tcfg, seed=0, device="cpu", use_flash=True).eval()
    view = model.with_config(tcfg, use_flash=False)
    assert not view.use_flash and model.use_flash
    assert {p.data_ptr() for p in view.parameters()} == \
        {p.data_ptr() for p in model.parameters()}
    assert [layer.attn.cfg.window for layer in view.layers] == \
        [k["window"] for k in tcfg.layer_kinds()]
    assert not any(layer.attn.cfg.use_flash for layer in view.layers)
    plain = Backbone(tcfg, seed=0, device="cpu").eval()
    toks = as_torch(tokens(tcfg, 1, 20))
    calls = _count_flash_calls(monkeypatch)
    with torch.no_grad():
        assert torch.equal(view(toks)["logits"], plain(toks)["logits"])
    assert not calls


@pytest.mark.parametrize("arch", ARCHS)
def test_eval_step_with_flash_matches_reference(arch):
    """``make_eval_step`` (task lm, retrieval on) with ``use_flash``:
    task, retrieval and total losses within 1e-4 relative."""
    jcfg, tcfg = _cfgs(arch, 4)
    jt, tt = JaxTrainConfig(task="lm"), TrainConfig(task="lm")
    jstate = JaxTrainer.init_state(jax.random.PRNGKey(0), jcfg, jt)
    state = Trainer.init_state(tcfg, tt, device="cpu", use_flash=True)
    Trainer.load_params(state, params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg))
    task = torch_data.RetrievalTask(vocab=tcfg.vocab, seq_len=24)
    batch = next(iter(torch_data.mux_batches(task, 2, 4, 1, seed=0)))
    rng = jax.random.PRNGKey(3)
    want = JaxTrainer.make_eval_step(jcfg, jt)(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (2, 24), 0,
                                                         4)))
    got = Trainer.make_eval_step(tcfg, tt)(state, batch, None,
                                           retr_index=index)
    for key in ("task_loss", "retr_loss", "loss"):
        np.testing.assert_allclose(float(got[key]), float(want[key]),
                                   rtol=1e-4)


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_lockstep_decode_matches_reference(arch):
    """``Engine.prefill`` of a 20-token prompt (past gemma3's window) and 6
    steps fed the reference's greedy tokens: logits within 1e-4."""
    jcfg, tcfg = _cfgs(arch, 2)
    params, model = bridged(jcfg, tcfg)
    prompts = tokens(tcfg, 2, 20, seed=1)
    jeng = JaxEngine(params, jcfg, batch=2, max_len=28)
    eng = Engine(model, batch=2, max_len=28)
    jlogits, jstate = jeng.prefill(jnp.asarray(prompts))
    logits, state = eng.prefill(as_torch(prompts))
    for _ in range(6):
        _close(logits, jlogits, 1e-4)
        last = np.asarray(jlogits).argmax(-1).astype(np.int32)
        jlogits, jstate = jeng.step(jstate, jnp.asarray(last))
        logits, state = eng.step(state, as_torch(last))
    _close(logits, jlogits, 1e-4)


class _Margins:
    """Sampling wrapper recording each greedy pick's top-1 margin per
    request."""

    def __init__(self, inner):
        self.inner = inner
        self.margins: dict[int, list] = {}

    def select(self, req, lane_logits):
        top = np.sort(np.asarray(lane_logits, np.float32))[-2:]
        self.margins.setdefault(req.rid, []).append(float(top[1] - top[0]))
        return self.inner.select(req, lane_logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_paged_chunked_scheduler_matches_reference(arch):
    """A Poisson trace through the paged scheduler at prefill_chunk 3 (max
    length 33 + prefix > gemma3's window): decode steps, generated tokens,
    peak pages and TTFTs equal the JAX scheduler's; each output equals the
    reference's up to its first greedy pick with a top-1 margin below
    MARGIN."""
    serving = dict(paged=True, page_size=4, prefill_chunk=3)
    jcfg, tcfg = _cfgs(arch, 2, **serving)
    params, model = bridged(jcfg, tcfg, seed=1)
    trace = poisson_trace(8, rate=1.0, prompt_len=6, gen_len=8,
                          vocab=tcfg.vocab, max_total=33, seed=0)
    jsched = JaxScheduler(JaxEngine(params, jcfg, batch=2, max_len=33))
    jsched.sampling = _Margins(jsched.sampling)
    want = jsched.run([r.fresh() for r in trace])
    sched = ContinuousScheduler(Engine(model, batch=2, max_len=33))
    got = sched.run([r.fresh() for r in trace])
    for key in ("decode_steps", "generated_tokens", "peak_pages",
                "finished"):
        assert getattr(got, key) == getattr(want, key), key
    ours = {q.rid: q for q in sched.finished}
    compared = 0
    for q in jsched.finished:
        assert ours[q.rid].ttft == q.ttft, q.rid
        margins = jsched.sampling.margins[q.rid]
        clear = next((i for i, m in enumerate(margins) if m <= MARGIN),
                     len(margins))
        assert ours[q.rid].output[:clear] == q.output[:clear], q.rid
        compared += clear
    assert compared >= want.generated_tokens // 2


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_reference(arch):
    """One retrieval-task step from bridged weights: loss and grad norm
    within 1e-4 relative of the reference's jitted step; the port's
    ``decay_mask`` is the reference's ndim rule on its scanned tree (period
    2 for gemma3's smoke config: every layer scanned); the AdamW state
    crosses the bridge."""
    jcfg, tcfg = _cfgs(arch, 4)
    kw = dict(task="retrieval", lr=1e-3, warmup=1, total_steps=10)
    jt, tt = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = JaxTrainer.init_state(jax.random.PRNGKey(0), jcfg, jt)
    state = Trainer.init_state(tcfg, tt, device="cpu")
    Trainer.load_params(state, params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg))

    rule = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2),
                        jstate["params"])
    want_mask = {k: bool(v.flatten()[0])
                 for k, v in params_from_jax(rule, tcfg).items()}
    assert decay_mask(tcfg, Trainer.params(state)) == want_mask
    assert want_mask["layers.0.norm1.scale"]
    assert not want_mask["final_norm.scale"]

    task = torch_data.RetrievalTask(vocab=tcfg.vocab, seq_len=12)
    batch = next(iter(torch_data.mux_batches(task, 4, 4, 1, seed=0)))
    rng = jax.random.PRNGKey(1)
    jstate, jm = jax.jit(JaxTrainer.make_train_step(jcfg, jt))(
        jstate, {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index = torch.from_numpy(np.array(jax.random.randint(rng, (4, 12), 0,
                                                         4)))
    state, m = Trainer.make_train_step(tcfg, tt)(state, batch, None,
                                                 retr_index=index)
    np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                               rtol=1e-4)
    np.testing.assert_allclose(float(m["grad_norm"]),
                               float(jm["grad_norm"]), rtol=1e-4)
    opt = opt_state_from_jax(jax.tree.map(np.asarray, jstate["opt_state"]),
                             tcfg)
    assert opt["step"] == state["opt_state"]["step"] == 1
    assert set(opt["mu"]) == set(state["opt_state"]["mu"])
    for k, mu in opt["mu"].items():
        assert mu.shape == state["opt_state"]["mu"][k].shape, k


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_pages_gemma3_past_its_window(capsys):
    """``--arch gemma3-4b --paged`` at a max length past the smoke window:
    the paged allocator holds the local layers' rings beside the pool."""
    sched, stats = serve.main(
        ["--arch", "gemma3-4b", "--smoke", "--device", "cpu", "--mux-n", "2",
         "--workload", "poisson", "--paged", "--prefill-chunk", "4",
         "--gen", "4", "--num-requests", "6", "--prompt-len", "16"])
    assert stats.finished == 6
    assert sched.allocator.max_len > 16
    assert sum("k" in layer for layer in sched.allocator.cache) == 2
    assert "[serve] continuous" in capsys.readouterr().out


@pytest.mark.parametrize("arch", ["gemma-7b", "nemotron-4-340b"])
def test_train_launcher_takes_the_new_archs(arch, capsys):
    _, history = train_launcher.main(
        ["--arch", arch, "--device", "cpu", "--smoke", "--steps", "2",
         "--batch", "2", "--seq-len", "8"])
    assert len(history) == 2 and all(np.isfinite(h["loss"])
                                      for h in history)
    assert "[train] done" in capsys.readouterr().out

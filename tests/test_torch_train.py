"""The port's training half against the JAX package's, on the CPU: AdamW,
global-norm clipping and the warm-up cosine schedule on random trees; the
weight-decay mask the reference takes on its own (scanned) tree layout;
one train step per task from bridged weights (loss, grad norm, every
grad, then the optimizer fed the same grads); k steps end to end;
microbatched steps; the refusal to train through the kernels;
``SyntheticDigits``; the train launcher.

The retrieval index is the reference's draw, ``jax.random.randint(rng,
(b, l), 0, n)``, computed here and given to the port (JAX's bits cannot
be drawn in torch).  f32 unless stated."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_smoke_config as jax_smoke
from repro.data import SyntheticDigits as JaxDigits
from repro.models import Backbone as JaxBackbone
from repro.optim import AdamW as JaxAdamW
from repro.optim import apply_updates as jax_apply_updates
from repro.optim import clip_by_global_norm as jax_clip
from repro.optim import schedule as jax_schedule
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer
from repro_torch import data as torch_data
from repro_torch.bridge import decay_mask, params_from_jax
from repro_torch.configs.registry import get_smoke_config as torch_smoke
from repro_torch.launch import train as train_launcher
from repro_torch.optim import AdamW, apply_updates, clip_by_global_norm
from repro_torch.optim import schedule
from repro_torch.training.trainer import TrainConfig, Trainer
from torch_parity import configs

L = 12
GROUPS = 4


def _bf16_ulps(got: torch.Tensor, want: np.ndarray) -> float:
    """Largest |got - want| in units of the bf16 ulp at ``want``."""
    w = torch.from_numpy(np.array(want, np.float32))
    exp = torch.floor(torch.log2(w.abs().clamp(min=2.0 ** -126)))
    ulp = torch.pow(2.0, exp - 7)
    return float(((got.float() - w).abs() / ulp).max())


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"w": rng.standard_normal((8, 6)).astype(np.float32),
            "b": rng.standard_normal((6,)).astype(np.float32),
            "s": rng.standard_normal((3, 4, 5)).astype(np.float32)}


def _to_jax(tree, dtype):
    return {k: jnp.asarray(v).astype(dtype) for k, v in tree.items()}


def _to_torch(tree, dtype):
    return {k: torch.from_numpy(v).to(dtype) for k, v in tree.items()}


def _as_np(x):
    return np.array(jnp.asarray(x).astype(jnp.float32))


ADAMW_CASES = {"f32": (jnp.float32, torch.float32, None),
               "bf16": (jnp.bfloat16, torch.bfloat16, None),
               "f32 params, bf16 state": (jnp.float32, torch.float32,
                                          "bfloat16")}


@pytest.mark.parametrize("case", list(ADAMW_CASES))
def test_adamw_update_matches_reference(case):
    """Three updates with warm-up-cosine lr and weight decay on matrices:
    the updates, mu and nu within 1e-6 (f32) or one bf16 ulp, the moments
    in the reference's dtype."""
    jdt, tdt, state_dtype = ADAMW_CASES[case]
    raw = _tree(0)
    jp, tp = _to_jax(raw, jdt), _to_torch(raw, tdt)
    sched = (jax_schedule.linear_warmup_cosine(1e-2, 2, 10),
             schedule.linear_warmup_cosine(1e-2, 2, 10))
    jopt = JaxAdamW(lr=sched[0], weight_decay=0.1, state_dtype=state_dtype)
    topt = AdamW(lr=sched[1], weight_decay=0.1, state_dtype=state_dtype)
    jst, tst = jopt.init(jp), topt.init(tp)
    decay = {k: v.ndim >= 2 for k, v in tp.items()}
    for i in range(3):
        graw = _tree(10 + i)
        ju, jst = jopt.update(_to_jax(graw, jdt), jst, jp)
        tu, tst = topt.update(_to_torch(graw, tdt), tst, tp, decay)
        jp, tp = jax_apply_updates(jp, ju), apply_updates(tp, tu)
        assert tst["step"] == int(jst["step"]) == i + 1
        for k in raw:
            for got, want in ((tu[k], ju[k]), (tst["mu"][k], jst["mu"][k]),
                              (tst["nu"][k], jst["nu"][k]), (tp[k], jp[k])):
                assert str(got.dtype).removeprefix("torch.") == \
                    str(want.dtype)
                if got.dtype == torch.bfloat16:
                    assert _bf16_ulps(got, _as_np(want)) <= 1.0, k
                else:
                    np.testing.assert_allclose(got.numpy(), _as_np(want),
                                               atol=1e-6, rtol=0)


def test_adamw_in_place_step_equals_update():
    raw = _tree(1)
    opt = AdamW(lr=1e-2, weight_decay=0.1)
    p, g = _to_torch(raw, torch.float32), _to_torch(_tree(2), torch.float32)
    decay = {k: v.ndim >= 2 for k, v in p.items()}
    u, want = opt.update(g, opt.init(p), p, decay)
    state = opt.init(p)
    q = {k: v.clone() for k, v in p.items()}
    opt.step_(g, state, q, decay)
    assert state["step"] == want["step"] == 1
    for k in p:
        assert torch.equal(q[k], apply_updates(p, u)[k])
        assert torch.equal(state["mu"][k], want["mu"][k])
        assert torch.equal(state["nu"][k], want["nu"][k])


@pytest.mark.parametrize("scale", [0.01, 1.0, 30.0])
@pytest.mark.parametrize("bf16", [False, True])
def test_clip_matches_reference(scale, bf16):
    raw = _tree(3)
    raw = {k: scale * v for k, v in raw.items()}
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if bf16 else \
        (jnp.float32, torch.float32)
    jc, jn = jax_clip(_to_jax(raw, jdt), 1.0)
    tc, tn = clip_by_global_norm(_to_torch(raw, tdt), 1.0)
    assert tn.dtype == torch.float32
    np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
    for k in raw:
        assert tc[k].dtype == tdt
        if bf16:
            assert _bf16_ulps(tc[k], _as_np(jc[k])) <= 1.0
        else:
            np.testing.assert_allclose(tc[k].numpy(), _as_np(jc[k]),
                                       atol=1e-6, rtol=0)


@pytest.mark.parametrize("warmup,total,floor", [(10, 100, 0.0), (0, 50, 1e-5),
                                                (5, 5, 0.0)])
def test_schedule_matches_reference(warmup, total, floor):
    ours = schedule.linear_warmup_cosine(3e-3, warmup, total, floor)
    theirs = jax_schedule.linear_warmup_cosine(3e-3, warmup, total, floor)
    for step in range(total + 5):
        got = ours(step)
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(theirs(jnp.int32(step))),
                                   atol=1e-9, rtol=1e-6)
    assert float(schedule.constant(0.5)(7)) == 0.5


# ---------------------------------------------------------------------------
# the weight-decay mask
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["tmux-12l-768h", "qwen1.5-4b"])
@pytest.mark.parametrize("n_layers", [4, 1])
def test_decay_mask_is_the_references_ndim_rule(arch, n_layers):
    """The reference decays a leaf iff ndim >= 2 in its tree, whose scanned
    layers stack their params over groups.  Its decision, written into
    every element of a tree of its shapes and carried over the bridge,
    must equal ``decay_mask`` on the port's names: at 4 layers (scanned)
    every norm and bias vector is decayed, at 1 layer (unscanned) none."""
    jcfg = dataclasses.replace(jax_smoke(arch, mux_n=2), n_layers=n_layers)
    tcfg = dataclasses.replace(torch_smoke(arch, mux_n=2), n_layers=n_layers)
    assert tcfg.layer_pattern() == jcfg.layer_pattern()
    jt = JaxTrainConfig(task="cls", n_classes=3)
    params = JaxTrainer.init_state(jax.random.PRNGKey(0), jcfg, jt)["params"]
    rule = jax.tree.map(lambda p: np.full(p.shape, p.ndim >= 2), params)
    want = {k: bool(v.flatten()[0])
            for k, v in params_from_jax(rule, tcfg).items()}
    state = Trainer.init_state(tcfg, TrainConfig(task="cls", n_classes=3),
                               device="cpu")
    got = decay_mask(tcfg, Trainer.params(state))
    assert got == want
    vectors = [k for k in got if k.startswith("layers.")
               and Trainer.params(state)[k].ndim == 1]
    assert vectors and all(got[k] == (n_layers > 1) for k in vectors)
    assert not got["final_norm.scale"] and got["task_head.w"]


# ---------------------------------------------------------------------------
# train steps from bridged weights
# ---------------------------------------------------------------------------

def _task(name, vocab):
    if name == "cls":
        return torch_data.KeywordClassificationTask(vocab=vocab, seq_len=L,
                                                    n_classes=4)
    return torch_data.RetrievalTask(vocab=vocab, seq_len=L)


def _setup(arch, task, n=4, **tkw):
    jcfg, tcfg = configs(arch, n)
    nc = 4 if task == "cls" else 0
    kw = dict(task=task, n_classes=nc, lr=1e-3, warmup=1, total_steps=10,
              **tkw)
    jt, tt = JaxTrainConfig(**kw), TrainConfig(**kw)
    jstate = JaxTrainer.init_state(jax.random.PRNGKey(0), jcfg, jt)
    state = Trainer.init_state(tcfg, tt, device="cpu")
    Trainer.load_params(state, params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg))
    batches = list(torch_data.mux_batches(_task(task, tcfg.vocab), GROUPS, n,
                                          3, seed=0))
    return jcfg, tcfg, jt, tt, jstate, state, batches


def _index(rng, b, n):
    return torch.from_numpy(np.array(jax.random.randint(rng, (b, L), 0, n)))


def _close(got: torch.Tensor, want, tol):
    want = _as_np(want)
    err = float((got.detach().float() - torch.from_numpy(want)).abs().max())
    assert err <= tol * max(1.0, float(np.abs(want).max())), err


STEP_CASES = [("qwen", "lm"), ("qwen", "cls"), ("tmux", "retrieval")]


@pytest.mark.parametrize("arch,task", STEP_CASES)
def test_train_step_matches_reference(arch, task):
    """Loss, metrics, grad norm and every grad within 1e-5 x max(1,
    max|ref|); then, fed the reference's grads, the port's clip and AdamW
    (with ``decay_mask``) give params, mu and nu within 1e-6."""
    jcfg, tcfg, jt, tt, jstate, state, batches = _setup(arch, task)
    jbatch = {k: jnp.asarray(v) for k, v in batches[0].items()}
    rng = jax.random.PRNGKey(7)
    (jloss, jm), jg = jax.value_and_grad(JaxTrainer.loss_fn, has_aux=True)(
        jstate["params"], jbatch, rng, jcfg, jt)
    tb = {k: torch.as_tensor(v).long() for k, v in batches[0].items()}
    loss, metrics, grads = Trainer.grads(state, tb, None, tcfg, tt,
                                         retr_index=_index(rng, GROUPS, 4))
    _close(loss, jloss, 1e-5)
    for k in ("task_loss", "retr_loss", "acc", "moe_aux"):
        _close(metrics[k], jm[k], 1e-5)
    want_g = params_from_jax(jax.tree.map(np.asarray, jg), tcfg)
    assert set(grads) == set(want_g)
    for k, g in grads.items():
        _close(g, want_g[k].numpy(), 1e-5)
    _, jnorm = jax_clip(jg, jt.grad_clip)
    _, norm = clip_by_global_norm(grads, tt.grad_clip)
    _close(norm, jnorm, 1e-5)

    # the same grads into both optimizers
    jopt = JaxTrainer.make_optimizer(jt)
    jc, _ = jax_clip(jg, jt.grad_clip)
    ju, jopt_state = jopt.update(jc, jstate["opt_state"], jstate["params"])
    jparams = jax_apply_updates(jstate["params"], ju)
    params = Trainer.params(state)
    clipped, _ = clip_by_global_norm(want_g, tt.grad_clip)
    opt = Trainer.make_optimizer(tt)
    ost = opt.init(params)
    opt.step_(clipped, ost, params, decay_mask(tcfg, params))
    for got, want in ((params, jparams), (ost["mu"], jopt_state["mu"]),
                      (ost["nu"], jopt_state["nu"])):
        want = params_from_jax(jax.tree.map(np.asarray, want), tcfg)
        for k in want:
            _close(got[k], want[k].numpy(), 1e-6)


def _params_within(state, jparams, tcfg, *, lr, steps):
    """99.9% of elements within 1e-5, every element within 2 * lr * steps.
    Adam divides by sqrt(n_hat): an element whose gradient is at f32 noise
    level in either implementation moves by up to lr per step in a
    direction the noise decides, so only a bound of lr per step holds for
    every element."""
    want = params_from_jax(jax.tree.map(np.asarray, jparams), tcfg)
    got = Trainer.params(state)
    diffs = torch.cat([(got[k].detach() - want[k]).abs().flatten()
                       for k in want])
    assert float((diffs <= 1e-5).float().mean()) >= 0.999
    assert float(diffs.max()) <= 2 * lr * steps


@pytest.mark.parametrize("arch,task", [("tmux", "retrieval"),
                                       ("qwen", "lm")])
def test_k_steps_match_reference(arch, task):
    """Three steps at lr 1e-3, warm-up 1: losses within 1e-4 relative at
    each step; then the parameters (see ``_params_within``)."""
    jcfg, tcfg, jt, tt, jstate, state, batches = _setup(arch, task)
    jstep = jax.jit(JaxTrainer.make_train_step(jcfg, jt))
    step = Trainer.make_train_step(tcfg, tt)
    key = jax.random.PRNGKey(1)
    for b in batches:
        key, rng = jax.random.split(key)
        jstate, jm = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()},
                           rng)
        state, m = step(state, b, None, retr_index=_index(rng, GROUPS, 4))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(m["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=1e-4)
    assert state["step"] == state["opt_state"]["step"] == len(batches)
    _params_within(state, jstate["params"], tcfg, lr=tt.lr,
                   steps=len(batches))


@pytest.mark.parametrize("k", [2, 4])
def test_microbatched_step_matches_reference(k):
    """k chunks, each with the index the reference draws from
    ``jax.random.split(rng, k)[i]``: loss and grad norm within 1e-5
    relative of the reference's microbatched step, then the parameters."""
    jcfg, tcfg, jt, tt, jstate, state, batches = _setup(
        "qwen", "retrieval", microbatch=k)
    rng = jax.random.PRNGKey(3)
    jstate, jm = jax.jit(JaxTrainer.make_train_step(jcfg, jt))(
        jstate, {key: jnp.asarray(v) for key, v in batches[0].items()}, rng)
    index = [_index(r, GROUPS // k, 4) for r in jax.random.split(rng, k)]
    state, m = Trainer.make_train_step(tcfg, tt)(state, batches[0], None,
                                                 retr_index=index)
    for key in ("loss", "grad_norm", "retr_loss"):
        np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    _params_within(state, jstate["params"], tcfg, lr=tt.lr, steps=1)


def test_microbatch_must_divide_batch():
    _, tcfg, _, tt, _, state, batches = _setup("qwen", "lm", microbatch=3)
    with pytest.raises(ValueError, match="does not divide"):
        Trainer.make_train_step(tcfg, tt)(state, batches[0],
                                          torch.Generator())


def test_train_step_refuses_the_kernels():
    """No kernel has a backward, here as in the reference: a config that
    turns the mux kernels on, or a model with flash attention, is refused
    by name instead of trained on the plain path unannounced."""
    _, tcfg = configs("qwen", 2, mux={"use_kernel": True})
    with pytest.raises(ValueError, match="no backward"):
        Trainer.make_train_step(tcfg, TrainConfig())
    _, tcfg = configs("qwen", 2)
    state = Trainer.init_state(tcfg, TrainConfig(), device="cpu",
                               use_flash=True)
    batch = next(torch_data.mux_batches(_task("lm", tcfg.vocab), 2, 2, 1))
    with pytest.raises(ValueError, match="flash"):
        Trainer.make_train_step(tcfg, TrainConfig())(state, batch,
                                                     torch.Generator())


def test_fit_logs_like_the_reference():
    _, tcfg = configs("tmux", 4)
    tt = TrainConfig(task="retrieval", lr=1e-3, warmup=1, total_steps=5)
    seen = []
    state, history = Trainer.fit(
        tcfg, tt, torch_data.mux_batches(_task("lm", tcfg.vocab), 2, 4, 5),
        seed=0, log_every=2, device="cpu",
        callback=lambda i, m: seen.append(i))
    assert [h["step"] for h in history] == seen == [0, 2, 4]
    assert set(history[0]) == {"step", "loss", "grad_norm", "task_loss",
                               "retr_loss", "moe_aux", "acc"}
    assert all(np.isfinite(h["loss"]) for h in history)
    assert state["step"] == 5


def test_synthetic_digits_copy_gives_the_reference_samples():
    ours, theirs = torch_data.SyntheticDigits(seed=3), JaxDigits(seed=3)
    np.testing.assert_array_equal(ours.templates, theirs.templates)
    for a, b in ((ours.sample(7), theirs.sample(7)),
                 (ours.sample(5, np.random.default_rng(2)),
                  theirs.sample(5, np.random.default_rng(2)))):
        for key in b:
            assert a[key].dtype == b[key].dtype
            np.testing.assert_array_equal(a[key], b[key])


def test_train_launcher_smoke_on_cpu(tmp_path, capsys):
    path = tmp_path / "state.npz"
    state, history = train_launcher.main(
        ["--device", "cpu", "--smoke", "--steps", "3", "--ckpt", str(path)])
    out = capsys.readouterr().out
    assert "[train] done" in out and f"saved {path}" in out
    assert len(history) == 3 and all(np.isfinite(h["loss"])
                                     for h in history)
    assert state["step"] == 3 and path.exists()
    # four devices without a mesh shape: too few for the production mesh
    with pytest.raises(RuntimeError, match=r"mesh \(16, 16\) needs 256 "
                                           r"devices, have 4"):
        train_launcher.main(["--device", "cpu", "--smoke",
                             "--device-count", "4"])


def test_bridged_init_matches_reference_init_shapes():
    """The reference's JAX init and the port's init give the same names and
    shapes (a sanity check for the parity set-up above)."""
    jcfg, tcfg = configs("tmux", 4)
    ours = Trainer.params(Trainer.init_state(tcfg, TrainConfig(),
                                             device="cpu"))
    theirs = params_from_jax(jax.tree.map(
        np.asarray, JaxBackbone.init(jax.random.PRNGKey(0), jcfg)), tcfg)
    assert {k: tuple(v.shape) for k, v in ours.items()} == \
        {k: tuple(v.shape) for k, v in theirs.items()}

"""The port's evaluation path against the JAX package's, on the CPU: the
losses, the retrieval objective (the same instance index fed to both:
JAX's ``randint`` bits cannot be drawn in torch), ``make_eval_step``'s
metrics for the lm / cls / tag / retrieval tasks, the task head across the
bridge, and the port's copies of the numpy data generators.  f32; losses
and metrics within 1e-5."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import data as jax_data
from repro.core import retrieval as jax_retr
from repro.training import losses as jax_losses
from repro.training.trainer import TrainConfig as JaxTrainConfig
from repro.training.trainer import Trainer as JaxTrainer
from repro_torch import data as torch_data
from repro_torch.bridge import params_from_jax
from repro_torch.core import retrieval as torch_retr
from repro_torch.training import losses as torch_losses
from repro_torch.training.trainer import TrainConfig, Trainer
from torch_parity import configs

ATOL = 1e-5


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got.detach()), np.asarray(want),
                               atol=ATOL, rtol=1e-6)


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    logits = rng.standard_normal((2, 3, 5, 11)).astype(np.float32) * 3
    labels = rng.integers(0, 11, (2, 3, 5)).astype(np.int32)
    mask = rng.random((2, 3, 5)) < 0.6
    return rng, logits, labels, mask


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_and_accuracy(masked):
    _, logits, labels, mask = _arrays()
    m = mask if masked else None
    for fn in ("cross_entropy", "accuracy"):
        got = getattr(torch_losses, fn)(
            torch.from_numpy(logits), torch.from_numpy(labels),
            None if m is None else torch.from_numpy(m))
        want = getattr(jax_losses, fn)(jnp.asarray(logits),
                                       jnp.asarray(labels),
                                       None if m is None else jnp.asarray(m))
        assert got.dtype == torch.float32
        _close(got, want)


def test_cross_entropy_all_masked_clamps_at_one():
    _, logits, labels, _ = _arrays()
    none = np.zeros(labels.shape, bool)
    got = torch_losses.cross_entropy(torch.from_numpy(logits),
                                     torch.from_numpy(labels),
                                     torch.from_numpy(none))
    assert float(got) == 0.0 == float(jax_losses.cross_entropy(
        jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(none)))


@pytest.mark.parametrize("muxed", [False, True])
def test_lm_loss(muxed):
    _, logits, labels, _ = _arrays(1)
    if not muxed:
        logits, labels = logits[:, 0], labels[:, 0]        # (B, L, V)
    got = torch_losses.lm_loss(torch.from_numpy(logits),
                               torch.from_numpy(labels))
    want = jax_losses.lm_loss(jnp.asarray(logits), jnp.asarray(labels))
    for g, w in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("fn", ["cls_loss", "tag_loss"])
@pytest.mark.parametrize("muxed", [False, True])
def test_head_losses(fn, muxed):
    rng = np.random.default_rng(2)
    demuxed = rng.standard_normal((2, 3, 5, 8)).astype(np.float32)
    w = 0.3 * rng.standard_normal((8, 4)).astype(np.float32)
    shape = (2, 3) if fn == "cls_loss" else (2, 3, 5)
    labels = rng.integers(0, 4, shape).astype(np.int32)
    if not muxed:
        demuxed, labels = demuxed[:, 0], labels[:, 0]
    got = getattr(torch_losses, fn)(torch.from_numpy(demuxed),
                                    torch.from_numpy(w),
                                    torch.from_numpy(labels))
    want = getattr(jax_losses, fn)(jnp.asarray(demuxed), jnp.asarray(w),
                                   jnp.asarray(labels))
    for g, v in zip(got, want):
        _close(g, v)


def test_bf16_logits_are_scored_in_f32():
    _, logits, labels, _ = _arrays(3)
    tl = torch.from_numpy(logits).bfloat16()
    jl = jnp.asarray(logits).astype(jnp.bfloat16)
    got = torch_losses.cross_entropy(tl, torch.from_numpy(labels))
    assert got.dtype == torch.float32
    _close(got, jax_losses.cross_entropy(jl, jnp.asarray(labels)))


# ---------------------------------------------------------------------------
# retrieval
# ---------------------------------------------------------------------------

def _retrieval_inputs(seed=0):
    rng = np.random.default_rng(seed)
    demuxed = rng.standard_normal((2, 4, 6, 8)).astype(np.float32)
    table = rng.standard_normal((13, 8)).astype(np.float32)
    toks = rng.integers(0, 13, (2, 4, 6)).astype(np.int32)
    return demuxed, table, toks


@pytest.mark.parametrize("masked", [False, True])
def test_retrieval_loss_with_the_reference_index(masked):
    demuxed, table, toks = _retrieval_inputs()
    key = jax.random.PRNGKey(5)
    idx = np.array(jax.random.randint(key, (2, 6), 0, 4))
    valid = np.random.default_rng(1).random((2, 4, 6)) < 0.5
    want = jax_retr.retrieval_loss(
        key, jnp.asarray(demuxed), jnp.asarray(toks), jnp.asarray(table),
        valid_mask=jnp.asarray(valid) if masked else None)
    got = torch_retr.retrieval_loss(
        None, torch.from_numpy(demuxed), torch.from_numpy(toks),
        torch.from_numpy(table), index=torch.from_numpy(idx),
        valid_mask=torch.from_numpy(valid) if masked else None)
    _close(got, want)


def test_retrieval_logits_and_accuracy():
    demuxed, table, toks = _retrieval_inputs(1)
    td, tt, tk = map(torch.from_numpy, (demuxed, table, toks))
    _close(torch_retr.retrieval_logits(td, tt),
           jax_retr.retrieval_logits(jnp.asarray(demuxed),
                                     jnp.asarray(table)))
    # plant exact matches so the accuracy is neither 0 nor 1
    tk = torch.argmax(torch_retr.retrieval_logits(td, tt), -1).int()
    tk[0, 0] = (tk[0, 0] + 1) % 13
    _close(torch_retr.retrieval_accuracy(td, tk, tt),
           jax_retr.retrieval_accuracy(jnp.asarray(demuxed),
                                       jnp.asarray(tk.numpy()),
                                       jnp.asarray(table)))


def test_retrieval_loss_draws_its_index_from_the_generator():
    demuxed, table, toks = _retrieval_inputs(2)
    td, tt, tk = map(torch.from_numpy, (demuxed, table, toks))
    idx = torch_retr.retrieval_index(torch.Generator().manual_seed(9), 2, 4,
                                     6)
    assert idx.shape == (2, 6) and 0 <= int(idx.min()) and \
        int(idx.max()) < 4
    drawn = torch_retr.retrieval_loss(torch.Generator().manual_seed(9), td,
                                      tk, tt)
    assert float(drawn) == float(torch_retr.retrieval_loss(None, td, tk, tt,
                                                           index=idx))


# ---------------------------------------------------------------------------
# make_eval_step
# ---------------------------------------------------------------------------

L = 12


def _batch(task_name, cfg, seed=0):
    n = cfg.mux.n
    if task_name in ("lm", "retrieval"):
        task = torch_data.RetrievalTask(vocab=cfg.vocab, seq_len=L)
    elif task_name == "cls":
        task = torch_data.KeywordClassificationTask(vocab=cfg.vocab,
                                                    seq_len=L, n_classes=4)
    else:
        task = torch_data.TaggingTask(vocab=cfg.vocab, seq_len=L)
    if n > 1:
        return next(torch_data.mux_batches(task, 2, n, 1, seed=seed))
    return next(torch_data.batches(task, 2, 1, seed=seed))


EVAL_CASES = [("qwen", "lm", 1), ("qwen", "lm", 4), ("qwen", "cls", 4),
              ("qwen", "tag", 4), ("qwen", "retrieval", 4),
              ("tmux", "cls", 4)]


@pytest.mark.parametrize("arch,task,n", EVAL_CASES)
@pytest.mark.parametrize("use_flash", [False, True])
def test_eval_step_matches_reference(arch, task, n, use_flash):
    jcfg, tcfg = configs(arch, n)
    n_classes = {"cls": 4, "tag": 4}.get(task, 0)
    jt = JaxTrainConfig(task=task, n_classes=n_classes)
    tt = TrainConfig(task=task, n_classes=n_classes)
    jstate = JaxTrainer.init_state(jax.random.PRNGKey(0), jcfg, jt)
    state = Trainer.init_state(tcfg, tt, device="cpu", use_flash=use_flash)
    Trainer.load_params(state, params_from_jax(
        jax.tree.map(np.asarray, jstate["params"]), tcfg))
    batch = _batch(task, tcfg)
    rng = jax.random.PRNGKey(11)
    want = JaxTrainer.make_eval_step(jcfg, jt)(
        jstate["params"], {k: jnp.asarray(v) for k, v in batch.items()}, rng)
    index = None
    if n > 1:
        index = torch.from_numpy(np.array(jax.random.randint(rng, (2, L),
                                                               0, n)))
    got = Trainer.make_eval_step(tcfg, tt)(state, batch, None,
                                           retr_index=index)
    assert set(got) == set(want)
    for key in ("task_loss", "retr_loss", "acc", "loss", "moe_aux"):
        assert got[key].dtype == torch.float32
        _close(got[key], want[key])
    if n > 1:
        assert float(got["retr_loss"]) > 0
    assert not got["loss"].requires_grad


def test_task_head_crosses_the_bridge():
    jcfg, tcfg = configs("qwen", 2)
    jt = JaxTrainConfig(task="cls", n_classes=3)
    params = jax.tree.map(np.asarray, JaxTrainer.init_state(
        jax.random.PRNGKey(0), jcfg, jt)["params"])
    sd = params_from_jax(params, tcfg)
    np.testing.assert_array_equal(sd["task_head.w"].numpy(),
                                  params["task_head"]["w"])
    state = Trainer.init_state(tcfg, TrainConfig(task="cls", n_classes=3),
                               device="cpu")
    assert state["task_head"]["w"].shape == (tcfg.d_model, 3)
    Trainer.load_params(state, sd)
    np.testing.assert_array_equal(state["task_head"]["w"].numpy(),
                                  params["task_head"]["w"])
    with pytest.raises(ValueError, match="task head"):
        Trainer.load_params(Trainer.init_state(tcfg, TrainConfig(),
                                               device="cpu"), sd)


def test_init_state_task_head_draw():
    _, tcfg = configs("qwen", 2)
    tt = TrainConfig(task="tag", n_classes=5)
    a = Trainer.init_state(tcfg, tt, seed=3, device="cpu")["task_head"]["w"]
    b = Trainer.init_state(tcfg, tt, seed=3, device="cpu")["task_head"]["w"]
    assert torch.equal(a, b) and a.dtype == tcfg.pdtype
    assert 0.01 < float(a.float().std()) < 0.03
    with pytest.raises(ValueError, match="n_classes"):
        Trainer.init_state(tcfg, TrainConfig(task="cls"), device="cpu")


def test_train_configs_match_the_reference():
    assert dataclasses.asdict(TrainConfig()) == \
        dataclasses.asdict(JaxTrainConfig())


# ---------------------------------------------------------------------------
# data
# ---------------------------------------------------------------------------

TASKS = [("RetrievalTask", {}), ("KeywordClassificationTask", {}),
         ("PairMatchTask", {}), ("TaggingTask", {"entity_rate": 0.3})]


@pytest.mark.parametrize("name,kw", TASKS)
def test_data_copies_give_the_reference_arrays(name, kw):
    ours = getattr(torch_data, name)(vocab=97, seq_len=10, seed=4, **kw)
    theirs = getattr(jax_data, name)(vocab=97, seq_len=10, seed=4, **kw)
    for a, b in ((ours.sample(6), theirs.sample(6)),
                 (next(torch_data.batches(ours, 5, 1, seed=2)),
                  next(jax_data.batches(theirs, 5, 1, seed=2)))):
        assert a.keys() == b.keys()
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
            assert a[k].dtype == b[k].dtype
    for a, b in zip(torch_data.mux_batches(ours, 2, 3, 3, seed=1),
                    jax_data.mux_batches(theirs, 2, 3, 3, seed=1)):
        for k in a:
            assert a[k].shape[:2] == (2, 3)
            np.testing.assert_array_equal(a[k], b[k])

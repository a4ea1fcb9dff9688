"""Checkpoints of the port, in the reference's file format: a train state
(bf16 included, optimizer state and step) round-trips bitwise; a file the
reference's ``save_checkpoint`` writes is read without JAX and bridged to
exactly the tensors ``params_from_jax`` gives for the same tree; a failed
write leaves no file behind.  Two card tests (marked ``cuda``, skipped
without a card): a train step on the card agrees with the CPU at f32, and
an R = 1 router run on the card is bitwise the bare scheduler's.

The card tests import neither JAX nor the JAX package, so on a GPU
machine without JAX they run alone:
``PYTHONPATH=src python -m pytest -q --noconftest -m cuda
tests/test_torch_checkpoint.py``."""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import data as torch_data
from repro_torch.checkpoint import io as ckpt_io
from repro_torch.checkpoint import (load_checkpoint,
                                    read_reference_checkpoint,
                                    save_checkpoint)
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import Backbone
from repro_torch.serving.engine import Engine
from repro_torch.serving.router import ReplicaRouter
from repro_torch.serving.scheduler import ContinuousScheduler, poisson_trace
from repro_torch.training.trainer import TrainConfig, Trainer


def _cfg(dtype="float32", n=2, layers=2):
    cfg = get_smoke_config("tmux-12l-768h", mux_n=n)
    return dataclasses.replace(cfg, n_layers=layers, vocab=128, dtype=dtype,
                               param_dtype=dtype)


def _trained(cfg, device="cpu", steps=1, task="cls"):
    tcfg = TrainConfig(task=task, n_classes=3 if task == "cls" else 0,
                       lr=1e-3, warmup=1, total_steps=10)
    state = Trainer.init_state(cfg, tcfg, seed=1, device=device)
    task_gen = torch_data.KeywordClassificationTask(
        vocab=cfg.vocab, seq_len=8, n_classes=3) if task == "cls" else \
        torch_data.RetrievalTask(vocab=cfg.vocab, seq_len=8)
    step = Trainer.make_train_step(cfg, tcfg)
    g = torch.Generator(device=device).manual_seed(0)
    metrics = []
    for b in torch_data.mux_batches(task_gen, 2, cfg.mux.n, steps, seed=0):
        state, m = step(state, b, g)
        metrics.append(m)
    return tcfg, state, metrics


def _tensors(state):
    out = {f"p/{k}": v for k, v in Trainer.params(state).items()}
    for which in ("mu", "nu"):
        out.update({f"{which}/{k}": v
                    for k, v in state["opt_state"][which].items()})
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_state_roundtrip_bitwise(dtype, tmp_path):
    cfg = _cfg(dtype)
    tcfg, state, _ = _trained(cfg, steps=2)
    path = str(tmp_path / "ck" / "state.npz")
    save_checkpoint(path, state, step=state["step"], meta={"note": "x"})

    fresh = Trainer.init_state(cfg, tcfg, seed=9, device="cpu")
    fresh["opt_state"] = Trainer.make_optimizer(tcfg).init(
        Trainer.params(fresh))
    fresh["step"] = 0
    restored, meta = load_checkpoint(path, fresh)
    assert meta["step"] == 2 and meta["note"] == "x"
    assert restored["model"] is fresh["model"]
    assert restored["step"] == restored["opt_state"]["step"] == 2
    want, got = _tensors(state), _tensors(restored)
    assert want.keys() == got.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype == cfg.pdtype
        assert torch.equal(got[k], want[k]), k
    assert meta["dtypes"]["model/embed.table"] == dtype
    assert meta["dtypes"]["step"] == "int32"


def test_roundtrip_of_a_mixed_tree(tmp_path):
    tree = {"a": torch.randn(3, 5),
            "nested": {"b": torch.arange(7, dtype=torch.int32),
                       "c": torch.randn(2, 2).bfloat16()},
            "lst": [torch.ones(2), torch.zeros(1, dtype=torch.int32)],
            "n": 4, "arr": np.arange(3.0)}
    path = str(tmp_path / "mixed.npz")
    save_checkpoint(path, tree, step=42)
    like = {"a": torch.zeros(3, 5),
            "nested": {"b": torch.zeros(7, dtype=torch.int32),
                       "c": torch.zeros(2, 2, dtype=torch.bfloat16)},
            "lst": [torch.zeros(2), torch.ones(1, dtype=torch.int32)],
            "n": 0, "arr": np.zeros(3)}
    got, meta = load_checkpoint(path, like)
    assert meta["step"] == 42 and got["n"] == 4
    np.testing.assert_array_equal(got["arr"], tree["arr"])
    for a, b in ((got["a"], tree["a"]), (got["nested"]["c"],
                                         tree["nested"]["c"]),
                 (got["nested"]["b"], tree["nested"]["b"]),
                 (got["lst"][1], tree["lst"][1])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(path, dict(like, a=torch.zeros(5, 3)))
    with pytest.raises(KeyError, match="missing"):
        load_checkpoint(path, dict(like, missing=torch.zeros(1)))


def test_reads_the_references_checkpoint(tmp_path):
    """The reference's ``save_checkpoint`` of a trained bf16 state (what
    ``python -m repro.launch.train --ckpt`` writes): every param and every
    mu / nu tensor bridged from the file equals, dtype and bits, what
    ``params_from_jax`` gives for the same tree in memory.  (The
    reference's bf16 config keeps its scaled-normal Linear weights, and so
    their moments, in float32: both dtypes are held.)"""
    import jax
    import jax.numpy as jnp

    from repro.checkpoint.io import save_checkpoint as jax_save
    from repro.configs.registry import get_smoke_config as jax_smoke
    from repro.training.trainer import TrainConfig as JaxTrainConfig
    from repro.training.trainer import Trainer as JaxTrainer
    from repro_torch.bridge import opt_state_from_jax, params_from_jax

    kw = dict(n_layers=3, vocab=128, dtype="bfloat16",
              param_dtype="bfloat16")
    jcfg = dataclasses.replace(jax_smoke("tmux-12l-768h", mux_n=2), **kw)
    tcfg = dataclasses.replace(get_smoke_config("tmux-12l-768h", mux_n=2),
                               **kw)
    jt = JaxTrainConfig(task="cls", n_classes=3, lr=1e-3, warmup=1)
    state = JaxTrainer.init_state(jax.random.PRNGKey(0), jcfg, jt)
    batch = {"tokens": jax.random.randint(jax.random.PRNGKey(1), (2, 2, 8),
                                          0, 128),
             "labels": jnp.array([[0, 1], [2, 0]])}
    state, _ = jax.jit(JaxTrainer.make_train_step(jcfg, jt))(
        state, batch, jax.random.PRNGKey(2))
    path = str(tmp_path / "ref.npz")
    jax_save(path, jax.device_get(state), step=1)

    tree, meta = read_reference_checkpoint(path)
    assert meta["step"] == 1 and int(tree["step"]) == 1
    assert isinstance(tree["params"]["blocks"], list)
    mem = jax.tree.map(np.asarray, state)
    for got, want in (
            (params_from_jax(tree["params"], tcfg),
             params_from_jax(mem["params"], tcfg)),
            (opt_state_from_jax(tree["opt_state"], tcfg)["mu"],
             opt_state_from_jax(mem["opt_state"], tcfg)["mu"]),
            (opt_state_from_jax(tree["opt_state"], tcfg)["nu"],
             opt_state_from_jax(mem["opt_state"], tcfg)["nu"])):
        assert got.keys() == want.keys()
        assert {t.dtype for t in want.values()} == {torch.bfloat16,
                                                    torch.float32}
        for k in want:
            assert got[k].dtype == want[k].dtype
            assert torch.equal(got[k], want[k]), k
    assert opt_state_from_jax(tree["opt_state"], tcfg)["step"] == 1
    # and the port takes the bridged tensors as its state
    state_t = Trainer.init_state(tcfg, TrainConfig(task="cls", n_classes=3),
                                 device="cpu")
    Trainer.load_params(state_t, params_from_jax(tree["params"], tcfg))


def test_failed_write_leaves_nothing(tmp_path, monkeypatch):
    folder = tmp_path / "out"
    path = folder / "state.npz"
    save_checkpoint(str(path), {"a": torch.ones(3)}, step=1)
    before = path.read_bytes()

    def broken(f, **arrays):
        f.write(b"partial")
        raise OSError("disk full")

    monkeypatch.setattr(ckpt_io.np, "savez", broken)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(str(path), {"a": torch.zeros(3)}, step=2)
    with pytest.raises(OSError, match="disk full"):
        save_checkpoint(str(folder / "new.npz"), {"a": torch.zeros(3)})
    assert sorted(p.name for p in folder.iterdir()) == ["state.npz"]
    assert path.read_bytes() == before


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the test compares the card with "
                    "the CPU")
    return torch.device("cuda")


@pytest.mark.cuda
def test_train_step_on_card_matches_cpu(cuda):
    """f32, 3 steps of the retrieval task from the same weights and
    retrieval indices: losses within 1e-4 relative, step 1's grads within
    1e-4 x max|g| per tensor."""
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = _cfg(n=4, layers=2)
    tcfg = TrainConfig(task="retrieval", lr=1e-3, warmup=1, total_steps=10)
    states = {d: Trainer.init_state(cfg, tcfg, seed=1, device=d)
              for d in ("cpu", "cuda")}
    states["cuda"]["model"].load_state_dict(states["cpu"]["model"]
                                            .state_dict())
    task = torch_data.RetrievalTask(vocab=cfg.vocab, seq_len=16)
    batches = list(torch_data.mux_batches(task, 4, 4, 3, seed=0))
    g = torch.Generator().manual_seed(0)
    index = [torch.randint(0, 4, (4, 16), generator=g) for _ in batches]
    tb = {k: torch.as_tensor(v).long() for k, v in batches[0].items()}
    grads = {d: Trainer.grads(s, {k: v.to(d) for k, v in tb.items()}, None,
                              cfg, tcfg, retr_index=index[0])[2]
             for d, s in states.items()}
    for k, want in grads["cpu"].items():
        err = float((grads["cuda"][k].cpu() - want).abs().max())
        assert err <= 1e-4 * float(want.abs().max()), k
    steps = {d: Trainer.make_train_step(cfg, tcfg) for d in states}
    for b, ix in zip(batches, index):
        losses = {d: float(steps[d](s, b, None, retr_index=ix)[1]["loss"])
                  for d, s in states.items()}
        assert abs(losses["cuda"] - losses["cpu"]) <= \
            1e-4 * abs(losses["cpu"])


@pytest.mark.cuda
def test_single_replica_router_bitwise_on_card(cuda):
    """Kernels on (mux, fused decode demux, paged attention): an R = 1
    round-robin router gives the bare scheduler's tokens, decode steps and
    TTFTs on the card."""
    from repro_torch.configs.base import ServingConfig

    base = get_smoke_config("tmux-12l-768h", mux_n=4)
    cfg = dataclasses.replace(
        base, dtype="bfloat16", param_dtype="bfloat16",
        mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(paged=True, page_size=16, use_kernel=True,
                              fuse_demux=True))
    model = Backbone(cfg, seed=0, device=cuda).eval()
    trace = poisson_trace(24, rate=2.0, prompt_len=6, gen_len=6,
                          vocab=cfg.vocab, max_total=49, seed=0)
    sched = ContinuousScheduler(Engine(model, batch=2, max_len=49))
    bare = sched.run([r.fresh() for r in trace])
    router = ReplicaRouter.build(model, batch=2, max_len=49, replicas=1,
                                 policy="round_robin")
    routed = router.run([r.fresh() for r in trace])
    assert routed.decode_steps == bare.decode_steps
    assert {q.rid: (q.output, q.ttft) for q in router.finished} == \
        {q.rid: (q.output, q.ttft) for q in sched.finished}

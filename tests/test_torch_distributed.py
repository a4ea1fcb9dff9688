"""The port on a mesh of ``gloo`` ranks on the CPU: its counterpart of the
reference's ``tests/test_distributed.py``, without device emulation.

One module fixture spawns one 4-rank ``gloo`` group (a ``file://`` store
under the test's temporary directory, one torch thread a rank).  Each rank
runs every case and writes its results; one test per case reads them:

* the (2, 2) train step of qwen1.5-4b smoke at mux N 2, batch (4, 2, 16),
  two steps against the port's single-process steps: loss within rtol
  1e-4 and every parameter within 1e-3 (the reference's tolerances),
  gradients before the optimizer within 1e-5;
* the same at (4, 1), the data axis only, with ``microbatch=2``;
* each rank's bytes of parameters and moments equal to its specs' count;
* lock-step ``Engine.generate`` on (2, 2) (batch 2 split over data)
  against one process: tokens equal, prefill and step logits within 1e-5;
* llama4-scout smoke on (2, 2) refused, naming item 12b.

The launchers run as the reference's tests run them, on a (2, 2) mesh of
four spawned ``gloo`` ranks.
"""
import datetime
import json
import os
import subprocess
import sys
import traceback
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _max_diff(a: dict, b: dict) -> float:
    return max(float((a[k].detach().float() - b[k].detach().float())
                     .abs().max()) for k in a)


def _train_case(shape, microbatch: int) -> dict:
    """Two steps on a ``shape`` mesh and in one process, same seeds."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import mesh_info_from_mesh, state_specs
    from repro_torch.sharding.placement import state_bytes
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = get_smoke_config("qwen1.5-4b", mux_n=2)
    tcfg = TrainConfig(task="lm", lr=1e-3, warmup=2, total_steps=10,
                       microbatch=microbatch)
    mesh = make_mesh(shape, "cpu")
    mi = mesh_info_from_mesh(mesh)
    gen = np.random.default_rng(0)
    batches = [{"tokens": gen.integers(0, cfg.vocab, (4, 2, 16))}
               for _ in range(2)]
    out = {}
    for label, kw in (("one", {}), ("mesh", dict(mesh=mesh, mesh_info=mi))):
        state = Trainer.init_state(cfg, tcfg, device="cpu")
        rng = torch.Generator().manual_seed(1)
        if label == "one":
            grads = Trainer.grads(state, {"tokens": torch.as_tensor(
                batches[0]["tokens"])}, rng, cfg, tcfg)[2]
        else:
            grads = Trainer.mesh_grads(state, batches[0], rng, cfg, tcfg,
                                       mesh=mesh, mesh_info=mi)[2]
        rng = torch.Generator().manual_seed(1)
        step = Trainer.make_train_step(cfg, tcfg, **kw)
        losses = []
        for b in batches:
            state, m = step(state, b, rng)
            losses.append(float(m["loss"]))
        out[label] = dict(state=state, grads=grads, losses=losses)
    params = {s: Trainer.params(out[s]["state"]) for s in ("one", "mesh")}
    held, want = state_bytes(out["mesh"]["state"],
                             state_specs(out["mesh"]["state"], mi), mi)
    full = sum(t.numel() * t.element_size() for t in params["one"].values())
    return dict(losses_one=out["one"]["losses"],
                losses_mesh=out["mesh"]["losses"],
                param_diff=_max_diff(params["one"], params["mesh"]),
                grad_diff=_max_diff(out["one"]["grads"],
                                    out["mesh"]["grads"]),
                held_bytes=held, spec_bytes=want, unsharded_bytes=3 * full)


def _case_train_2x2() -> dict:
    return _train_case((2, 2), 0)


def _case_train_4x1() -> dict:
    return _train_case((4, 1), 2)


def _case_serve() -> dict:
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding import mesh_info_from_mesh

    cfg = get_smoke_config("qwen1.5-4b", mux_n=2)
    mesh = make_mesh((2, 2), "cpu")
    model = Backbone(cfg, seed=0, device="cpu").eval()
    prompts = torch.randint(0, cfg.vocab, (2, 2, 8),
                            generator=torch.Generator().manual_seed(3))
    runs = {}
    for label, kw in (("one", {}), ("mesh", dict(
            mesh=mesh, mesh_info=mesh_info_from_mesh(mesh)))):
        eng = Engine(model, batch=2, max_len=16, **kw)
        tokens = eng.generate(prompts, 4)
        logits0, state = eng.prefill(prompts)
        logits1, _ = eng.step(state, tokens[..., 0])
        runs[label] = (tokens, logits0, logits1)
    return dict(tokens_equal=bool(torch.equal(runs["one"][0],
                                              runs["mesh"][0])),
                shape=list(runs["mesh"][0].shape),
                logit_diff=max(float((a - b).abs().max()) for a, b in
                               zip(runs["one"][1:], runs["mesh"][1:])))


def _case_moe() -> dict:
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding import mesh_info_from_mesh
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = get_smoke_config("llama4-scout-17b-a16e", mux_n=2)
    mesh = make_mesh((2, 2), "cpu")
    mi = mesh_info_from_mesh(mesh)
    model = Backbone(cfg, device="cpu")
    moe = next(layer.moe for layer in model.layers if layer.moe is not None)
    refusals = []
    for call in (
            lambda: Trainer.make_train_step(cfg, TrainConfig(), mesh=mesh,
                                            mesh_info=mi),
            lambda: Engine(model, batch=2, max_len=8, mesh=mesh,
                           mesh_info=mi),
            lambda: moe(torch.zeros(1, 2, cfg.d_model), mesh=mesh)):
        try:
            call()
        except NotImplementedError as e:
            refusals.append(str(e))
        else:
            refusals.append(None)
    return dict(refusals=refusals)


CASES = ("train_2x2", "train_4x1", "serve", "moe")


def _worker(rank: int, store: str, out: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    results = {}
    try:
        for case in CASES:
            try:
                results[case] = globals()[f"_case_{case}"]()
            except Exception:      # reported by the case's test
                results[case] = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
        Path(out, f"rank{rank}.json").write_text(json.dumps(results))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results of every case."""
    tmp = tmp_path_factory.mktemp("mesh")
    mp.spawn(_worker, nprocs=WORLD, args=(str(tmp / "store"), str(tmp)))
    return [json.loads((tmp / f"rank{r}.json").read_text())
            for r in range(WORLD)]


def _results(ranks, case):
    out = [r[case] for r in ranks]
    for r in out:
        assert "error" not in r, r["error"]
    return out


@pytest.mark.parametrize("case", ["train_2x2", "train_4x1"])
def test_sharded_train_step_matches_single_process(ranks, case):
    """(2, 2), and (4, 1) with microbatch 2: two steps of the mesh step
    against the single-process step, on every rank."""
    results = _results(ranks, case)
    r = results[0]
    print(f"{case}: losses {r['losses_mesh']} vs {r['losses_one']}, max "
          f"|param diff| {r['param_diff']:.3g}, max |grad diff| "
          f"{r['grad_diff']:.3g}")
    for r in results:
        np.testing.assert_allclose(r["losses_mesh"], r["losses_one"],
                                   rtol=1e-4)
        assert r["param_diff"] < 1e-3, r["param_diff"]
        assert r["grad_diff"] < 1e-5, r["grad_diff"]


@pytest.mark.parametrize("case", ["train_2x2", "train_4x1"])
def test_each_rank_holds_the_bytes_its_specs_give(ranks, case):
    """Each rank's local parameter and moment storage is its specs' count,
    less than one process holds."""
    for r in _results(ranks, case):
        assert r["held_bytes"] == r["spec_bytes"]
        assert r["held_bytes"] < r["unsharded_bytes"]


def test_lockstep_serving_on_a_mesh_matches_one_process(ranks):
    for r in _results(ranks, "serve"):
        assert r["tokens_equal"] and r["shape"] == [2, 2, 5]
        assert r["logit_diff"] < 1e-5, r["logit_diff"]


def test_moe_on_a_mesh_is_refused_naming_12b(ranks):
    """The train step, the engine and the MoE block refuse a mesh of more
    than one device."""
    for r in _results(ranks, "moe"):
        assert len(r["refusals"]) == 3
        for msg in r["refusals"]:
            assert msg is not None and "item 12b" in msg


def _launch(module: str, *flags: str) -> str:
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", module, "--device", "cpu", *flags],
        capture_output=True, text=True, timeout=300, env=env, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def test_train_launcher_on_a_cpu_mesh(tmp_path):
    """Rank 0 prints the reference's lines and writes the gathered state:
    the moments whole."""
    ckpt = tmp_path / "state.npz"
    out = _launch("repro_torch.launch.train", "--arch", "gemma3-4b",
                  "--smoke", "--device-count", "4", "--mesh-shape", "2,2",
                  "--steps", "6", "--mux-n", "2", "--batch", "4",
                  "--seq-len", "16", "--ckpt", str(ckpt))
    assert "[train] mesh {'data': 2, 'model': 2}" in out
    assert "done; final loss" in out and f"saved {ckpt}" in out
    with np.load(ckpt) as data:
        assert json.loads(bytes(data["__meta__"]).decode())["step"] == 6
        assert data["opt_state/mu/embed.table"].shape == \
            data["model/embed.table"].shape


def test_serve_launcher_on_a_cpu_mesh():
    out = _launch("repro_torch.launch.serve", "--arch", "qwen1.5-4b",
                  "--smoke", "--device-count", "4", "--mesh-shape", "2,2",
                  "--mux-n", "2", "--batch", "2", "--prompt-len", "8",
                  "--gen", "4")
    assert "on mesh {'data': 2, 'model': 2}" in out and "tok/s" in out

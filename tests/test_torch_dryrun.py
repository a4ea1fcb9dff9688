"""The port's dry-run (``repro_torch.launch.dryrun``) and activation
checkpointing (``ModelConfig.remat``), against the reference and against
real CPU steps.

One fake process group of world 512 (rank 0) serves the whole file: it is
started by a module fixture and destroyed after it, so no group outlives
the file on its worker.

* On the production meshes (16, 16) and (2, 16, 16), every registered
  arch at full config and mux N 8: the rank's local elements of each
  placed parameter and AdamW moment are the reference specs' local shard
  of its leaf, except the ZeRO-1 stacked-axis departures that
  ``tests/test_torch_sharding.py`` names (the moment keeps its
  parameter's spec).
* At a (1, 1) mesh the dry-run's FLOPs and argument bytes are exactly a
  real CPU train step's (``FlopCounterMode``; the state, batch and
  retrieval draw the step holds).
* The collective bytes of the MoE shard path at a (2, 2) mesh equal the
  bytes its shapes give (router psum, the two all-to-alls, the
  pre-activation psums or reduce-scatter + all-gather, the output
  gathers, the aux means), with ``psum_scatter`` and ``ep2d`` too.
* ``remat`` "dots" and "full": gradients and loss bitwise "none"'s on the
  CPU (and the recompute did run: more FLOPs); the dry-run's
  ``temp_size_in_bytes`` orders full <= dots <= none.
* The CLI writes a record with the reference's keys, and the reference's
  ``skipped`` record for ``long_500k`` on a quadratic-attention arch.
* ``seq_parallel=True`` is refused on a mesh; the kernel ops send a meta
  tensor to the plain version and another device to an error.

``repro.launch.dryrun`` is not imported: its first lines set ``XLA_FLAGS``
for the process.
"""
import dataclasses
import functools
import json
import math
import os
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import jax
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs import registry as jax_registry
from repro.models import Backbone as JaxBackbone
from repro.nn.moe import MeshInfo as JaxMeshInfo
from repro.sharding import specs as jax_specs
from repro_torch.bridge import reference_paths
from repro_torch.configs import registry as torch_registry
from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun as D
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import make_mesh
from repro_torch.models import Backbone
from repro_torch.nn.moe import MoE, MoEConfig, OnMesh
from repro_torch.serving.engine import Engine
from repro_torch.sharding import mesh_info_from_mesh, placement, state_specs
from repro_torch.training.trainer import TrainConfig, Trainer

ROOT = Path(__file__).resolve().parents[1]
ARCHS = sorted(torch_registry.ARCHS)
WORLD = 512
REFERENCE_KEYS = ("arch", "shape", "kind", "mux_n", "instances", "n_chips",
                  "hlo_flops", "hbm_bytes", "collective_bytes", "compute_s",
                  "memory_s", "collective_s", "dominant", "params",
                  "active_params", "model_flops", "useful_flops_frac",
                  "argument_size_in_bytes", "output_size_in_bytes",
                  "temp_size_in_bytes", "generated_code_size_in_bytes",
                  "bytes_per_device", "mesh", "lower_s", "compile_s")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fake_group():
    """This process as rank 0 of a fake group of WORLD ranks, for the
    file; destroyed after it."""
    assert not dist.is_initialized()
    D.start_fake_group(WORLD)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _sub_mesh(shape, axes=("data", "model")):
    """A mesh of the first prod(shape) ranks of the fake group."""
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh("cpu", torch.arange(math.prod(shape)).reshape(shape),
                      mesh_dim_names=axes)


def _mux(cfg, n):
    return dataclasses.replace(cfg, mux=dataclasses.replace(cfg.mux, n=n))


# ---------------------------------------------------------------------------
# per-rank shards at the production meshes
# ---------------------------------------------------------------------------

def _parts(spec, sizes) -> int:
    parts = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            parts *= sizes.get(a, 1)
    return parts


@functools.lru_cache(maxsize=None)
def _full(arch):
    """(config, meta model, its AdamW moments, the reference's shape
    tree) at full config and mux N 8, built once for both meshes."""
    cfg = _mux(torch_registry.get_config(arch), 8)
    state = I.state_struct(cfg, TrainConfig(task="lm",
                                            state_dtype="float32"))
    tree = jax.eval_shape(
        lambda k: JaxBackbone.init(k, _mux(jax_registry.get_config(arch),
                                           8)), jax.random.PRNGKey(0))
    return cfg, state["model"], state["opt_state"], tree


@pytest.mark.parametrize("mesh_kind", ["pod", "multipod"])
@pytest.mark.parametrize("arch", ARCHS)
def test_local_shards_are_the_references(fake_group, arch, mesh_kind):
    cfg, model, opt, tree = _full(arch)
    state = {"model": model, "step": 0, "opt_state": {
        "mu": opt["mu"], "nu": opt["nu"], "step": 0}}
    mesh = D.build_mesh(mesh_kind)
    mi = mesh_info_from_mesh(mesh)
    placement.place_state(state, mesh, state_specs(state, mi))
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    jmi = JaxMeshInfo(**dataclasses.asdict(mi))

    def by_path(t):
        return {jax_specs._path_str(p): tuple(s) for p, s in
                jax.tree_util.tree_leaves_with_path(
                    t, is_leaf=lambda x: isinstance(x, P))}

    pspecs = jax_specs.param_specs(tree, jmi)
    mu = by_path(jax_specs.opt_state_specs({"mu": tree}, pspecs, jmi)["mu"])
    pspecs = by_path(pspecs)
    for name, (path, stacked, _) in reference_paths(
            cfg, state["params"]).items():
        numel = state["params"][name].numel()
        want_p = pspecs[path][1:] if stacked else pspecs[path]
        want_m = mu[path]
        if stacked and want_m[0] is not None:
            # ZeRO-1 chose the groups axis: the port keeps the param spec
            want_m = want_p
        elif stacked:
            want_m = want_m[1:]
        local_p = state["params"][name].to_local().numel()
        assert local_p == numel // _parts(want_p, sizes), (name, path)
        for m in ("mu", "nu"):
            local_m = state["opt_state"][m][name].to_local().numel()
            assert local_m == numel // _parts(want_m, sizes), (name, m)


# ---------------------------------------------------------------------------
# the dry-run against a real CPU step
# ---------------------------------------------------------------------------

SMOKE_SHAPE = ShapeConfig("smoke", 32, 8, "train")


@pytest.mark.parametrize("arch", ["qwen1.5-4b", "llama4-scout-17b-a16e"])
def test_dryrun_is_a_real_cpu_step_at_1x1(fake_group, arch):
    """FLOPs and argument bytes of the (1, 1) dry-run equal those of the
    same steady-state step on real CPU tensors (state, batch, draw)."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = torch_registry.get_smoke_config(arch, mux_n=2)
    mesh = make_mesh((1, 1), "cpu")
    rec = D.dry_run(cfg, SMOKE_SHAPE, mesh)
    tcfg = TrainConfig(task="lm", total_steps=1000, state_dtype="float32")
    state = Trainer.init_state(cfg, tcfg, device="cpu")
    step = Trainer.make_train_step(cfg, tcfg, mesh=mesh,
                                   mesh_info=mesh_info_from_mesh(mesh))
    g = torch.Generator().manual_seed(0)
    b = I.backbone_batch(cfg, SMOKE_SHAPE)
    batch = {"tokens": torch.randint(0, cfg.vocab, (b, 2, 32), generator=g,
                                     dtype=torch.int32)}
    index = torch.randint(0, 2, (b, 32), generator=g)
    state, _ = step(state, batch, None, retr_index=index)
    with FlopCounterMode(display=False) as fc:
        state, metrics = step(state, batch, None, retr_index=index)
    assert torch.isfinite(metrics["loss"])
    assert rec["hlo_flops"] == fc.get_total_flops() * rec["n_chips"] > 0
    params = Trainer.params(state)
    held = sum(p.numel() * p.element_size() for p in params.values())
    held += sum(t.numel() * 4 for m in ("mu", "nu")
                for t in state["opt_state"][m].values())
    held += batch["tokens"].numel() * 4 + index.numel() * 8
    assert rec["argument_size_in_bytes"] == held
    assert rec["bytes_per_device"] == held + rec["temp_size_in_bytes"]
    assert rec["temp_size_in_bytes"] > 0


# ---------------------------------------------------------------------------
# the MoE shard path's collective bytes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("variant", ["psum", "psum_scatter", "ep2d"])
def test_moe_collective_bytes_are_its_shapes(fake_group, variant):
    """A (2, 2) mesh (data 2, model 2) of 4 ranks in one node: x (B 4, L
    6, d 16) float32 through 4 experts of F 8, top 2."""
    b, l, d, f, e, k = 4, 6, 16, 8, 4, 2
    cfg = MoEConfig(dim=d, moe_ff=f, n_experts=e, top_k=k,
                    psum_scatter=variant == "psum_scatter",
                    ep2d=variant == "ep2d")
    mesh = _sub_mesh((2, 2))
    mi = mesh_info_from_mesh(mesh)
    block = MoE(cfg, generator=None, device="meta")
    x = torch.empty((b, l, d), device="meta")
    counter = D.StepCounter()
    with torch.no_grad(), counter:
        out, aux = block(x, on_mesh=OnMesh(mesh, mi, ()))
    assert out.shape == x.shape and aux.shape == ()
    t = (b // 2) * l                      # the rank's tokens: data splits B
    cap = math.ceil(t * k / e * cfg.capacity_factor)
    d_loc = d // 2                        # model splits d
    ep = 4 if variant == "ep2d" else 2
    e_loc = e // ep
    rows = ep * cap if variant != "ep2d" else 2 * cap
    want = {"all-reduce": t * e * 4 + 4,                    # router, aux
            "all-to-all": 2 * ep * e_loc * cap * d_loc * 4,
            "all-gather": t * d * 4 + b * l * d * 4}        # leave, rows
    if variant == "psum":
        want["all-reduce"] += 2 * e_loc * rows * f * 4      # up, gate
    elif variant == "psum_scatter":
        want["reduce-scatter"] = 2 * e_loc * rows * (f // 2) * 4
        want["all-gather"] += e_loc * rows * f * 4
    else:
        want["all-reduce"] += 4                             # aux over model
    assert counter.collectives == want
    assert counter.by_link == {"nvlink": sum(want.values()), "ib": 0}


# ---------------------------------------------------------------------------
# remat
# ---------------------------------------------------------------------------

REMAT_ARCHS = ["qwen1.5-4b", "llama4-scout-17b-a16e", "deepseek-v3-671b",
               "gemma3-4b", "whisper-base"]


def _grads(cfg, remat):
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(cfg, remat=remat)
    tcfg = TrainConfig(task="lm")
    state = Trainer.init_state(cfg, tcfg, seed=0, device="cpu")
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 2, 16), generator=g)}
    if cfg.context_len:
        batch["context"] = torch.randn((2, cfg.context_len, cfg.context_dim),
                                       generator=g)
    index = torch.randint(0, 2, (2, 16), generator=g)
    with FlopCounterMode(display=False) as fc:
        loss, _, grads = Trainer.grads(state, batch, None, cfg, tcfg,
                                       retr_index=index)
    return loss, grads, fc.get_total_flops()


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", REMAT_ARCHS)
def test_remat_gradients_are_bitwise_none(arch, remat):
    cfg = torch_registry.get_smoke_config(arch, mux_n=2)
    assert cfg.layer_pattern()[2] >= 2        # groups to checkpoint
    loss, grads, flops = _grads(cfg, "none")
    rloss, rgrads, rflops = _grads(cfg, remat)
    assert torch.equal(loss, rloss)
    assert grads.keys() == rgrads.keys()
    for name in grads:
        assert torch.equal(grads[name], rgrads[name]), name
    assert rflops > flops                     # the groups were recomputed


def test_remat_orders_the_dry_runs_temp_bytes(fake_group):
    cfg = torch_registry.get_smoke_config("qwen1.5-4b", mux_n=2)
    mesh = make_mesh((1, 1), "cpu")
    shape = ShapeConfig("smoke", 256, 16, "train")
    recs = {r: D.dry_run(dataclasses.replace(cfg, remat=r), shape, mesh)
            for r in ("none", "dots", "full")}
    temp = {r: rec["temp_size_in_bytes"] for r, rec in recs.items()}
    assert temp["full"] <= temp["dots"] <= temp["none"]
    assert temp["full"] < temp["none"] / 2
    flops = {r: rec["hlo_flops"] for r, rec in recs.items()}
    assert flops["none"] < flops["dots"] < flops["full"]
    assert len({rec["argument_size_in_bytes"] for rec in recs.values()}) == 1


def test_remat_is_off_without_autograd():
    """Under ``inference_mode`` (serving, eval) nothing is checkpointed:
    the forward is the plain loop's, bitwise."""
    cfg = torch_registry.get_smoke_config("qwen1.5-4b", mux_n=2)
    tokens = torch.randint(0, cfg.vocab, (2, 2, 8),
                           generator=torch.Generator().manual_seed(0))
    outs = {}
    for remat in ("none", "full"):
        model = Backbone(dataclasses.replace(cfg, remat=remat), seed=0,
                         device="cpu")
        with torch.inference_mode():
            outs[remat] = model(tokens)["logits"]
    assert torch.equal(outs["none"], outs["full"])


# ---------------------------------------------------------------------------
# the CLI
# ---------------------------------------------------------------------------

MAIN = """
import sys
from repro_torch.launch.dryrun import main
for argv in sys.argv[1:]:
    try:
        main(argv.split())
    except SystemExit as e:
        if e.code:
            raise
"""


@pytest.fixture(scope="module")
def cli_records(tmp_path_factory):
    """``main`` run twice in one subprocess (each run its own fake group):
    qwen1.5-4b's smoke train_4k on the pod mesh, and its long_500k on the
    multipod mesh.  -> (stdout, the records' directory)."""
    out_dir = tmp_path_factory.mktemp("dryrun")
    runs = [f"--arch qwen1.5-4b --shape train_4k --mesh pod --smoke "
            f"--out {out_dir}",
            f"--arch qwen1.5-4b --shape long_500k --mesh multipod "
            f"--out {out_dir}"]
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", MAIN, *runs],
                         capture_output=True, text=True, timeout=300,
                         cwd=ROOT, env=env)
    assert out.returncode == 0, out.stderr[-2000:] + out.stdout[-500:]
    return out.stdout, out_dir


def test_cli_writes_the_references_record(cli_records):
    stdout, out_dir = cli_records
    assert "[dryrun] qwen1.5-4b x train_4k x pod" in stdout
    assert "bound" in stdout
    rec = json.loads((out_dir / "qwen1_5-4b__train_4k__pod__n8.json")
                     .read_text())
    for key in REFERENCE_KEYS:
        assert key in rec, key
    assert rec["n_chips"] == 256 and rec["mesh"] == "pod"
    assert rec["roofline"]["card"] == "NVIDIA H100 80GB HBM3"
    assert rec["roofline"]["power_limit"] == "700.00 W"
    assert rec["bytes_per_device"] == rec["argument_size_in_bytes"] + \
        rec["temp_size_in_bytes"]
    assert rec["collective_bytes"]["total"] > 0


def test_cli_skips_long_500k_on_quadratic_attention(cli_records):
    stdout, out_dir = cli_records
    assert "SKIP(quadratic-attention)" in stdout
    rec = json.loads((out_dir / "qwen1_5-4b__long_500k__multipod__n8.json")
                     .read_text())
    assert rec == {"arch": "qwen1.5-4b", "shape": "long_500k",
                   "mesh": "multipod", "mux_n": 8,
                   "skipped": "quadratic-attention"}


# ---------------------------------------------------------------------------
# refusals and the kernel ops' devices
# ---------------------------------------------------------------------------

def test_seq_parallel_is_refused_on_a_mesh(fake_group):
    cfg = dataclasses.replace(
        torch_registry.get_smoke_config("qwen1.5-4b", mux_n=2),
        seq_parallel=True)
    mesh = make_mesh((1, 1), "cpu")
    mi = mesh_info_from_mesh(mesh)
    tcfg = TrainConfig(task="lm")
    with pytest.raises(ValueError, match="compute by gather"):
        Trainer.make_train_step(cfg, tcfg, mesh=mesh, mesh_info=mi)
    model = Backbone(cfg, device="meta")
    with pytest.raises(ValueError, match="compute by gather"):
        Engine(model, batch=2, max_len=8, mesh=mesh, mesh_info=mi)
    Trainer.make_train_step(cfg, tcfg)        # without a mesh: nothing
    with pytest.raises(ValueError, match="remat"):
        dataclasses.replace(cfg, remat="some")


def test_kernel_ops_take_the_plain_version_on_meta():
    from repro_torch.kernels import takes_kernel
    from repro_torch.kernels.attention.ops import flash_attention
    from repro_torch.kernels.multiplex.ops import hadamard_mux
    q = torch.empty((1, 8, 2, 64), device="meta")
    assert flash_attention(q, q, q).shape == q.shape
    x = torch.empty((1, 2, 8, 64), device="meta")
    assert hadamard_mux(x, torch.empty((2, 64), device="meta")).shape == \
        (1, 8, 64)
    assert not takes_kernel(q) and not takes_kernel(torch.empty(1))
    with pytest.raises(ValueError, match="not on mps"):
        takes_kernel(SimpleNamespace(device=torch.device("mps")))

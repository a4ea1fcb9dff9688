"""The port on a mesh of ``gloo`` ranks on the CPU: its counterpart of the
reference's ``tests/test_distributed.py`` and ``tests/test_moe_variants.py``,
without device emulation for the port.

One module fixture spawns one 4-rank ``gloo`` group (a ``file://`` store
under the test's temporary directory, one torch thread a rank).  Each rank
runs every case and writes its results; one test per case reads them.
Beside it, one subprocess runs the reference's expert-parallel MoE block
(``MoE.apply(mesh=)``, a ``shard_map`` on 4 emulated CPU devices through
``XLA_FLAGS``) and ``jax.grad`` of ``sum(out * r) + aux`` on the same
numpy inputs and weights, for every block case:

* the block at (2, 2): baseline, ``psum_scatter`` gated and ungated,
  ``ep2d`` with and without a shared expert, capacity factor 1.0 (rows
  dropped per shard: the output must differ from the unsharded block's by
  more than 1e-3), a row mask, and B 3 (the data axis goes to the
  sequence); baseline at (4, 1) and (1, 4), and B 2 at (4, 1) (the
  sequence gets the data axis, as it does in a train step's microbatch of
  2 rows).  Out and aux within 1e-5, every gradient (parameters and x)
  within 1e-4 x max(1, max|reference|), f32.  On the port's side every
  rank holds the whole x; its gradients are averaged over ``data`` and
  completed over ``model`` by ``nn.moe.complete_grads``, as
  ``Trainer.mesh_grads`` completes them;

* the (2, 2) train step of qwen1.5-4b smoke at mux N 2, batch (4, 2, 16),
  two steps against the port's single-process steps: loss within rtol
  1e-4 and every parameter within 1e-3 (the reference's tolerances),
  gradients before the optimizer within 1e-5;
* the same at (4, 1), the data axis only, with ``microbatch=2``;
* each rank's bytes of parameters and moments equal to its specs' count;
* lock-step ``Engine.generate`` on (2, 2) (batch 2 split over data)
  against one process: tokens equal, prefill and step logits within 1e-5;
* llama4-scout smoke (4 MoE layers, 4 experts top-1 and a shared expert,
  mux N 2) against a one-process oracle, built in the reference's order:
  the batch cut into its microbatches, each microbatch cut into its data
  shards' rows, the one-process step run on each shard's rows alone
  (per-shard capacity and aux), averaged.  Two (2, 2) steps at batch 4
  and two (4, 1) steps at batch 8 with ``microbatch=2`` (each microbatch
  of 4 rows one row a shard): loss within rtol 1e-4, parameters within
  1e-3,
  gradients before the optimizer within 1e-5; one (2, 2) step with
  ``ep2d`` and one with ``psum_scatter`` within 1e-4 of the baseline step;
* lock-step ``Engine.generate`` of llama4-scout and deepseek-v3-671b smoke
  (sigmoid top-2, shared experts, MLA) on (2, 2) against one ``Engine``
  per data shard's slots: tokens equal, prefill and step logits within
  1e-5; one ``ContinuousScheduler`` run of llama4-scout smoke on (2, 2),
  capacity factor 64 (nothing dropped), tokens equal to one process;
* experts the expert-parallel size does not divide raise a ValueError
  naming item 12b, from the train step, the engine and the block.

The launchers run as the reference's tests run them, on a (2, 2) mesh of
four spawned ``gloo`` ranks; the train launcher also trains llama4-scout
smoke there.
"""
import dataclasses
import datetime
import json
import os
import subprocess
import sys
import textwrap
import traceback
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

ROOT = Path(__file__).resolve().parents[1]
WORLD = 4
MOE_ARCH = "llama4-scout-17b-a16e"

# The block cases: mesh shape, MoEConfig fields over BLOCK_BASE, (B, L),
# and whether a row mask is drawn.
BLOCK_BASE = dict(dim=16, moe_ff=8, n_experts=4, top_k=2,
                  capacity_factor=8.0)
BLOCK_CASES = {
    "baseline": ((2, 2), {}, (4, 6), False),
    "psum_scatter": ((2, 2), dict(psum_scatter=True), (4, 6), False),
    "psum_scatter_ungated": ((2, 2), dict(psum_scatter=True, gated=False),
                             (4, 6), False),
    "ep2d": ((2, 2), dict(ep2d=True), (4, 6), False),
    "ep2d_shared": ((2, 2), dict(ep2d=True, n_shared_experts=1), (4, 6),
                    False),
    "data4": ((4, 1), {}, (4, 6), False),
    "model4": ((1, 4), {}, (4, 6), False),
    "drops": ((2, 2), dict(capacity_factor=1.0), (4, 6), False),
    "row_mask": ((2, 2), dict(n_shared_experts=1), (4, 6), True),
    "seq": ((2, 2), {}, (3, 8), False),
    "seq_data4": ((4, 1), {}, (2, 8), False),
}

REFERENCE = textwrap.dedent("""
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import numpy as np
    import jax, jax.numpy as jnp
    from repro.nn.moe import MoE, MoEConfig, MeshInfo

    def nest(flat):
        out = {}
        for key, v in flat.items():
            *path, leaf = key.split("/")
            node = out
            for p in path:
                node = node.setdefault(p, {})
            node[leaf] = jnp.asarray(v)
        return out

    inp = np.load(sys.argv[1])
    cases = json.loads(str(inp["cases"]))
    res = {}
    for name, c in cases.items():
        shape = tuple(c["shape"])
        mesh = jax.make_mesh(shape, ("data", "model"))
        mi = MeshInfo(data_size=shape[0], model_size=shape[1])
        cfg = MoEConfig(**c["cfg"])
        pre = name + "/w/"
        params = nest({k[len(pre):]: inp[k] for k in inp.files
                       if k.startswith(pre)})
        x, r = jnp.asarray(inp[name + "/x"]), jnp.asarray(inp[name + "/r"])
        mask = (jnp.asarray(inp[name + "/mask"]) if name + "/mask"
                in inp.files else None)

        def loss(p, x):
            out, aux = MoE.apply(p, x, cfg, mi, mesh=mesh, row_mask=mask)
            return jnp.sum(out * r) + aux, (out, aux)

        with mesh:
            (_, (out, aux)), (gp, gx) = jax.jit(jax.value_and_grad(
                loss, argnums=(0, 1), has_aux=True))(params, x)
        res[name + "/out"] = np.asarray(out)
        res[name + "/aux"] = np.asarray(aux)
        res[name + "/grad/x"] = np.asarray(gx)
        for path, g in jax.tree_util.tree_leaves_with_path(gp):
            key = "/".join(str(getattr(k, "key", k)) for k in path)
            res[name + "/grad/" + key] = np.asarray(g)
    np.savez(sys.argv[2], **res)
""")


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


# -- the MoE block against the reference's shard_map ---------------------

def _block_weights(kw: dict, gen) -> dict:
    """The reference's MoE param tree, flat ("router/w", "up", ...), drawn
    from ``gen`` at the reference's init scales."""
    e, d, f = kw["n_experts"], kw["dim"], kw["moe_ff"]
    out = {"router/w": gen.normal(size=(d, e)) * d ** -0.5,
           "up": gen.normal(size=(e, d, f)) * d ** -0.5,
           "down": gen.normal(size=(e, f, d)) * f ** -0.5}
    if kw.get("gated", True):
        out["gate"] = gen.normal(size=(e, d, f)) * d ** -0.5
    fs = kw.get("n_shared_experts", 0) * f
    if fs:
        out["shared/up/w"] = gen.normal(size=(d, fs)) * d ** -0.5
        out["shared/down/w"] = gen.normal(size=(fs, d)) * fs ** -0.5
        if kw.get("gated", True):
            out["shared/gate/w"] = gen.normal(size=(d, fs)) * d ** -0.5
    return {k: v.astype(np.float32) for k, v in out.items()}


def write_block_inputs(path: Path) -> None:
    """Every block case's config, weights, x, r and row mask, from one
    numpy seed."""
    gen = np.random.default_rng(0)
    arrays, cases = {}, {}
    for name, (shape, extra, (b, l), masked) in BLOCK_CASES.items():
        kw = dict(BLOCK_BASE, **extra)
        cases[name] = dict(shape=shape, cfg=kw)
        for k, v in _block_weights(kw, gen).items():
            arrays[f"{name}/w/{k}"] = v
        for k in ("x", "r"):
            arrays[f"{name}/{k}"] = gen.normal(
                size=(b, l, kw["dim"])).astype(np.float32)
        if masked:
            m = gen.random((b, l)) > 0.4
            m[0, 0] = True
            arrays[f"{name}/mask"] = m
    np.savez(path, cases=json.dumps(cases), **arrays)


def _to_reference(name: str, t: torch.Tensor) -> np.ndarray:
    """A port gradient in the reference's layout (its Linears (in, out))."""
    a = t.detach().numpy()
    return a.T if name.endswith(".weight") else a


def _reference_name(name: str) -> str:
    return name.replace(".weight", ".w").replace(".", "/")


def _case_blocks(inputs: str) -> dict:
    """Each block case on its mesh: out, aux and the gradients of
    ``sum(out * r) + aux``, averaged over data and completed over model;
    the unsharded block's largest distance from the output."""
    from repro_torch.bridge import params_from_jax
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.nn.moe import MoE, MoEConfig, OnMesh, complete_grads
    from repro_torch.sharding import mesh_info_from_mesh
    from repro_torch.sharding.placement import mean_over

    data = np.load(inputs)
    out = {}
    for name, c in json.loads(str(data["cases"])).items():
        mesh = make_mesh(tuple(c["shape"]), "cpu")
        mi = mesh_info_from_mesh(mesh)
        tree = {}
        pre = name + "/w/"
        for key in data.files:
            if key.startswith(pre):
                *path, leaf = key[len(pre):].split("/")
                node = tree
                for p in path:
                    node = node.setdefault(p, {})
                node[leaf] = data[key]
        model = MoE(MoEConfig(**c["cfg"]),
                    generator=torch.Generator().manual_seed(0))
        state = params_from_jax({"head_layers": [{"moe": tree}]},
                                SimpleNamespace(n_layers=1, name="block"))
        model.load_state_dict({k.removeprefix("layers.0.moe."): v
                               for k, v in state.items()}, strict=True)
        x = torch.from_numpy(data[name + "/x"]).requires_grad_(True)
        r = torch.from_numpy(data[name + "/r"])
        mask = (torch.from_numpy(data[name + "/mask"])
                if name + "/mask" in data.files else None)
        y, aux = model(x, mask, on_mesh=OnMesh(mesh, mi))
        (torch.sum(y * r) + aux).backward()
        grads = {n: p.grad for n, p in model.named_parameters()}
        grads["x"] = x.grad
        names = list(grads)
        batch = ("data",) if mi.data_size > 1 else ()
        grads = complete_grads(model, dict(zip(names, mean_over(
            [grads[n] for n in names], mesh, batch))), mesh, mi)
        with torch.no_grad():
            plain, _ = model(x, mask)
        out[name] = dict(
            out=y.detach().numpy().tolist(), aux=float(aux),
            grads={_reference_name(n): _to_reference(n, g).tolist()
                   for n, g in grads.items()},
            unsharded_diff=float((plain - y).abs().max()))
    return out


# -- MoE models on the mesh against a one-process oracle -----------------

def _moe_cfg(arch: str = MOE_ARCH, **moe):
    from repro_torch.configs.registry import get_smoke_config
    cfg = get_smoke_config(arch, mux_n=2)
    return dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))


def _oracle_step(cfg, tcfg, data: int):
    """The one-process step of an expert-parallel mesh, in the reference's
    order: the batch cut into ``tcfg``'s microbatches, each cut into the
    ``data`` shards' rows, ``Trainer.grads`` on each shard's rows alone,
    averaged, then the plain step's clip and AdamW update.  Returns (step,
    the first step's grads)."""
    from repro_torch.bridge import decay_mask
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.training.trainer import Trainer

    opt = Trainer.make_optimizer(tcfg)
    first = {}

    def step(state, tokens, index):
        k = tcfg.microbatch if tcfg.microbatch > 1 else 1
        mb = tokens.shape[0] // k
        assert mb % data == 0, "each microbatch splits over the data shards"
        n, parts = mb // data, k * data
        one = dataclasses.replace(tcfg, microbatch=0)
        loss, grads = 0.0, {}
        for i in range(k):
            for s in range(data):
                rows = slice(i * mb + s * n, i * mb + (s + 1) * n)
                l_s, _, g_s = Trainer.grads(
                    state, {"tokens": tokens[rows]}, None, cfg, one,
                    retr_index=index[rows])
                loss = loss + l_s / parts
                for name, g in g_s.items():
                    grads[name] = grads.get(name, 0.0) + g / parts
        if not first:
            first.update(grads)
        grads, _ = clip_by_global_norm(grads, tcfg.grad_clip)
        params = Trainer.params(state)
        if "opt_state" not in state:
            state["opt_state"] = opt.init(params)
            state["step"] = 0
        opt.step_(grads, state["opt_state"], params, decay_mask(cfg, params))
        state["step"] += 1
        return state, loss

    return step, first


def _moe_batches(cfg, steps: int = 2, batch: int = 4):
    gen = np.random.default_rng(0)
    return [(torch.as_tensor(gen.integers(0, cfg.vocab, (batch, 2, 16))),
             torch.as_tensor(gen.integers(0, cfg.mux.n, (batch, 16))))
            for _ in range(steps)]


def _moe_mesh_run(cfg, tcfg, mesh, mi, batches):
    """(state, losses, first step's grads) of mesh steps from seed 0."""
    from repro_torch.training.trainer import Trainer

    k = tcfg.microbatch if tcfg.microbatch > 1 else 1
    state = Trainer.init_state(cfg, tcfg, device="cpu")
    tokens, index = batches[0]
    grads = Trainer.mesh_grads(
        state, {"tokens": tokens}, None, cfg, tcfg, mesh=mesh,
        mesh_info=mi, retr_index=list(index.chunk(k)) if k > 1 else index)[2]
    step = Trainer.make_train_step(cfg, tcfg, mesh=mesh, mesh_info=mi)
    losses = []
    for tokens, index in batches:
        state, m = step(state, {"tokens": tokens}, None,
                        retr_index=list(index.chunk(k)) if k > 1 else index)
        losses.append(float(m["loss"]))
    return state, losses, grads


def _moe_train_case(shape, microbatch: int, batch: int) -> dict:
    """Two mesh steps of llama4-scout smoke against the oracle."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import mesh_info_from_mesh
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = _moe_cfg()
    tcfg = TrainConfig(task="lm", lr=1e-3, warmup=2, total_steps=10,
                       microbatch=microbatch)
    mesh = make_mesh(shape, "cpu")
    mi = mesh_info_from_mesh(mesh)
    batches = _moe_batches(cfg, batch=batch)
    state, losses, grads = _moe_mesh_run(cfg, tcfg, mesh, mi, batches)
    oracle, first = _oracle_step(cfg, tcfg, mi.data_size)
    one = Trainer.init_state(cfg, tcfg, device="cpu")
    one_losses = []
    for tokens, index in batches:
        one, loss = oracle(one, tokens, index)
        one_losses.append(float(loss))
    return dict(losses_one=one_losses, losses_mesh=losses,
                param_diff=_max_diff(Trainer.params(one),
                                     Trainer.params(state)),
                grad_diff=_max_diff(first, grads))


def _case_moe_train_2x2() -> dict:
    return _moe_train_case((2, 2), 0, 4)


def _case_moe_train_4x1() -> dict:
    return _moe_train_case((4, 1), 2, 8)


def _case_moe_variants() -> dict:
    """One (2, 2) step with ep2d and one with psum_scatter against the
    baseline step: loss, first grads and parameters."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.sharding import mesh_info_from_mesh
    from repro_torch.training.trainer import TrainConfig, Trainer

    tcfg = TrainConfig(task="lm", lr=1e-3, warmup=2, total_steps=10)
    mesh = make_mesh((2, 2), "cpu")
    mi = mesh_info_from_mesh(mesh)
    batches = _moe_batches(_moe_cfg(), steps=1)
    runs = {v: _moe_mesh_run(_moe_cfg(**({v: True} if v else {})), tcfg,
                             mesh, mi, batches)
            for v in ("", "ep2d", "psum_scatter")}
    base = runs[""]
    return {v: dict(loss_diff=abs(r[1][0] - base[1][0]),
                    grad_diff=_max_diff(base[2], r[2]),
                    param_diff=_max_diff(Trainer.params(base[0]),
                                         Trainer.params(r[0])))
            for v, r in runs.items() if v}


def _moe_serve_case(arch: str) -> dict:
    """Lock-step generate on (2, 2) against one engine per data shard."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding import mesh_info_from_mesh

    cfg = _moe_cfg(arch)
    mesh = make_mesh((2, 2), "cpu")
    mi = mesh_info_from_mesh(mesh)
    model = Backbone(cfg, seed=0, device="cpu").eval()
    prompts = torch.randint(0, cfg.vocab, (4, 2, 8),
                            generator=torch.Generator().manual_seed(3))

    def run(eng, p):
        tokens = eng.generate(p, 4)
        first, state = eng.prefill(p)
        return tokens, first, eng.step(state, tokens[..., 0])[0]

    on_mesh = run(Engine(model, batch=4, max_len=16, mesh=mesh,
                         mesh_info=mi), prompts)
    shards = [run(Engine(model, batch=2, max_len=16), prompts[s:s + 2])
              for s in (0, 2)]
    one = [torch.cat(parts) for parts in zip(*shards)]
    return dict(tokens_equal=bool(torch.equal(on_mesh[0], one[0])),
                shape=list(on_mesh[0].shape),
                logit_diff=max(float((a - b).abs().max())
                               for a, b in zip(on_mesh[1:], one[1:])))


def _case_moe_serve_llama4() -> dict:
    return _moe_serve_case(MOE_ARCH)


def _case_moe_serve_deepseek() -> dict:
    return _moe_serve_case("deepseek-v3-671b")


def _case_moe_continuous() -> dict:
    """A Poisson trace over 4 slots on (2, 2) and in one process, capacity
    factor 64: outputs by request."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import (ContinuousScheduler,
                                               poisson_trace)
    from repro_torch.sharding import mesh_info_from_mesh

    cfg = _moe_cfg(capacity_factor=64.0)
    mesh = make_mesh((2, 2), "cpu")
    model = Backbone(cfg, seed=0, device="cpu").eval()
    trace = poisson_trace(8, rate=1.0, prompt_len=5, gen_len=5,
                          vocab=cfg.vocab, max_total=28, seed=0)
    outputs = {}
    for label, kw in (("one", {}), ("mesh", dict(
            mesh=mesh, mesh_info=mesh_info_from_mesh(mesh)))):
        sched = ContinuousScheduler(Engine(model, batch=4, max_len=28, **kw))
        sched.run([r.fresh() for r in trace])
        outputs[label] = {q.rid: list(q.output) for q in sched.finished}
    return dict(finished=len(outputs["mesh"]),
                outputs_equal=outputs["one"] == outputs["mesh"])


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
    """Three experts over a data axis of 2: what stays refused."""
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.models import Backbone
    from repro_torch.nn.moe import OnMesh
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding import mesh_info_from_mesh
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = _moe_cfg(n_experts=3)
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
            lambda: moe(torch.zeros(2, 2, cfg.d_model),
                        on_mesh=OnMesh(mesh, mi))):
        try:
            call()
        except ValueError as e:
            refusals.append(str(e))
        else:
            refusals.append(None)
    return dict(refusals=refusals)


CASES = ("train_2x2", "train_4x1", "serve", "moe", "blocks",
         "moe_train_2x2", "moe_train_4x1", "moe_variants",
         "moe_serve_llama4", "moe_serve_deepseek", "moe_continuous")


def _worker(rank: int, store: str, out: str, inputs: str) -> None:
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=WORLD,
                            timeout=datetime.timedelta(seconds=120))
    results = {}
    try:
        for case in CASES:
            try:
                fn = globals()[f"_case_{case}"]
                results[case] = fn(inputs) if case == "blocks" else fn()
            except Exception:      # reported by the case's test
                results[case] = {"error": traceback.format_exc()}
    finally:
        dist.destroy_process_group()
        Path(out, f"rank{rank}.json").write_text(json.dumps(results))


@pytest.fixture(scope="module")
def mesh_runs(tmp_path_factory):
    """Every rank's results of every case, and the reference's block
    results (None and its error output if its subprocess failed).  The
    reference's subprocess runs while the ranks do."""
    tmp = tmp_path_factory.mktemp("mesh")
    inputs = tmp / "block_inputs.npz"
    write_block_inputs(inputs)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    ref = subprocess.Popen(
        [sys.executable, "-c", REFERENCE, str(inputs), str(tmp / "ref.npz")],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        mp.spawn(_worker, nprocs=WORLD, args=(str(tmp / "store"), str(tmp),
                                              str(inputs)))
        _, err = ref.communicate(timeout=600)
    finally:
        ref.kill()
    ranks = [json.loads((tmp / f"rank{r}.json").read_text())
             for r in range(WORLD)]
    if ref.returncode:
        return ranks, (None, err[-3000:])
    with np.load(tmp / "ref.npz") as data:
        return ranks, ({k: data[k] for k in data.files}, "")


@pytest.fixture(scope="module")
def ranks(mesh_runs):
    """Every rank's results of every case."""
    return mesh_runs[0]


@pytest.fixture(scope="module")
def reference(mesh_runs):
    """The reference's out, aux and grads by "case/..." key."""
    data, err = mesh_runs[1]
    assert data is not None, err
    return data


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
    """What stays refused is the reference's own impossibility: experts
    the expert-parallel size does not divide (3 over data 2) raise a
    ValueError naming the sizes and item 12b, from the train step, the
    engine and the MoE block."""
    for r in _results(ranks, "moe"):
        assert len(r["refusals"]) == 3
        for msg in r["refusals"]:
            assert msg is not None and "item 12b" in msg
            assert "n_experts 3" in msg and "size 2" in msg


@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_moe_block_matches_the_references_shard_map(ranks, reference,
                                                    case):
    """Out and aux within 1e-5 of the reference's expert-parallel block,
    every gradient within 1e-4 x max(1, max|reference|), on every rank."""
    for r in _results(ranks, "blocks"):
        got = r[case]
        np.testing.assert_allclose(np.asarray(got["out"]),
                                   reference[f"{case}/out"], atol=1e-5,
                                   rtol=0)
        np.testing.assert_allclose(got["aux"], reference[f"{case}/aux"],
                                   atol=1e-5, rtol=0)
        want = {k[len(case) + 6:] for k in reference
                if k.startswith(f"{case}/grad/")}
        assert set(got["grads"]) == want
        for name, g in got["grads"].items():
            ref = reference[f"{case}/grad/{name}"]
            tol = 1e-4 * max(1.0, float(np.abs(ref).max()))
            np.testing.assert_allclose(np.asarray(g), ref, atol=tol, rtol=0,
                                       err_msg=f"{case} grad {name}")


def test_capacity_is_per_shard(ranks, reference):
    """At capacity factor 1.0 each shard drops its own rows: the output
    differs from the unsharded block's (which drops others) by more than
    1e-3, and matches the reference's (the parity test above)."""
    for r in _results(ranks, "blocks"):
        assert r["drops"]["unsharded_diff"] > 1e-3
        np.testing.assert_allclose(np.asarray(r["drops"]["out"]),
                                   reference["drops/out"], atol=1e-5, rtol=0)


@pytest.mark.parametrize("case", ["moe_train_2x2", "moe_train_4x1"])
def test_moe_train_step_matches_the_per_shard_oracle(ranks, case):
    """(2, 2) at batch 4, and (4, 1) at batch 8 with microbatch 2: two
    expert-parallel steps of llama4-scout smoke against the one-process
    step on each microbatch's data shards' rows, averaged."""
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


@pytest.mark.parametrize("variant", ["ep2d", "psum_scatter"])
def test_moe_train_variants_match_the_baseline(ranks, variant):
    for r in _results(ranks, "moe_variants"):
        got = r[variant]
        print(f"{variant}: {got}")
        assert max(got.values()) < 1e-4, got


@pytest.mark.parametrize("case", ["moe_serve_llama4", "moe_serve_deepseek"])
def test_moe_lockstep_serving_matches_one_engine_per_shard(ranks, case):
    for r in _results(ranks, case):
        assert r["tokens_equal"] and r["shape"] == [4, 2, 5]
        assert r["logit_diff"] < 1e-5, r["logit_diff"]


def test_moe_continuous_serving_matches_one_process(ranks):
    for r in _results(ranks, "moe_continuous"):
        assert r["finished"] == 8 and r["outputs_equal"]


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


def test_train_launcher_trains_moe_on_a_cpu_mesh():
    out = _launch("repro_torch.launch.train", "--arch", MOE_ARCH, "--smoke",
                  "--device-count", "4", "--mesh-shape", "2,2", "--steps",
                  "3", "--mux-n", "2", "--batch", "4", "--seq-len", "16")
    assert "[train] mesh {'data': 2, 'model': 2}" in out
    assert "done; final loss" in out


def test_serve_launcher_on_a_cpu_mesh():
    out = _launch("repro_torch.launch.serve", "--arch", "qwen1.5-4b",
                  "--smoke", "--device-count", "4", "--mesh-shape", "2,2",
                  "--mux-n", "2", "--batch", "2", "--prompt-len", "8",
                  "--gen", "4")
    assert "on mesh {'data': 2, 'model': 2}" in out and "tok/s" in out

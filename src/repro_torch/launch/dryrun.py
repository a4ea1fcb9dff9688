"""Multi-pod dry-run — the port of ``repro.launch.dryrun``: one rank's step
of every (architecture x input shape x mesh) on ``meta`` tensors (shapes,
no storage) over a fake process group, with its FLOPs, HBM bytes,
collective bytes and per-rank memory recorded for a roofline.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen1.5-4b \\
        --shape train_4k --mesh pod [--mux-n 8] [--out results/dryrun_torch]

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --mesh pod

How it runs.  A fake process group (``torch.testing._internal.distributed
.fake_pg``: every collective returns at once and moves nothing) of world
256 (``pod``) or 512 (``multipod``) is started at rank 0, and the
production mesh (``launch.mesh.make_production_mesh``) built over it.
Then the port's own programs run as rank 0 runs them, on meta tensors:
``Trainer.make_train_step(mesh=)`` on a state placed by
``sharding.state_specs`` (train), the last-only forward on the rank's rows
of the batch (prefill), and ``Backbone.decode_step`` on the rank's rows of
a cache (decode), each the counterpart of the reference's per-device SPMD
program.  Every axis ``MeshInfo.bl_entries`` assigns divides what it
splits, and ``sanitize_spec`` keeps only sharded dims the mesh divides, so
no split is uneven and every rank's program is rank 0's up to which rows
and slices it holds.

What is counted (one ``TorchDispatchMode`` over the step), in place of
the reference's ``cost_analysis``, ``memory_analysis`` and HLO parsing:

* ``hlo_flops``: the rank's FLOPs by ``FlopCounterMode``'s formulas
  (``torch.utils.flop_counter.flop_registry``) x n_chips, as the
  reference scales its per-device count.  The mode applies the formulas
  itself: ``FlopCounterMode``'s module tracking keeps recomputed
  activations of a checkpointed step alive, and would change the peak;
* ``hbm_bytes``: for every aten op but views and allocations, the bytes of
  its distinct tensor inputs and outputs once, x n_chips.  This is an
  unfused count: eager PyTorch writes and reads back every intermediate
  that a compiler would keep in registers, so it bounds the port's own
  traffic from above where XLA's fused count bounds the reference's;
* ``collective_bytes``: the result bytes of every collective the rank
  issues, ``c10d`` and ``_c10d_functional`` alike, by op (all-gather,
  all-reduce, reduce-scatter, all-to-all) and ``total``;
* ``argument_size_in_bytes``: the rank's storage at the step's start: its
  state (under compute by gather the whole parameters the model computes
  with, its shards of the stored parameters and the AdamW moments), its
  batch and its cache; ``temp_size_in_bytes``: the peak over the step of
  the live bytes of the storages it allocates; ``bytes_per_device``:
  their sum; ``output_size_in_bytes``: the new storage the step returns.
  Nothing is compiled, so ``generated_code_size_in_bytes`` is 0 and
  ``compile_s`` 0.0.

The roofline constants are the NVIDIA H100 SXM data sheet's at its 700 W
power limit (each record names the card and the limit): 989e12 dense bf16
FLOP/s, 3.35e12 B/s of HBM, 450e9 B/s each way over NVLink within one
node of 8 cards, and 50e9 B/s (one 400 Gb/s InfiniBand NIC per card, as in
a DGX H100) for a group whose ranks span more than one node.
``collective_s`` charges each collective at the rate of the group it
crosses.  The records are predictions from meta tensors, not
measurements.  The reference lowers with its kernels off (its configs'
defaults), and so do these steps: a meta tensor takes every kernel op's
plain version (``kernels.takes_kernel``).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import sys
import time
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

from repro_torch.configs.base import INPUT_SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import (ARCHS, get_config,
                                          get_smoke_config,
                                          long_500k_supported)
from repro_torch.launch import inputs as I
from repro_torch.launch.mesh import make_mesh, make_production_mesh
from repro_torch.nn.moe import OnMesh, check_model_mesh
from repro_torch.sharding import (cache_specs, mesh_info_from_mesh,
                                  param_specs, placement, state_specs)
from repro_torch.training.trainer import TrainConfig, Trainer

# ---------------------------------------------------------------------------
# roofline constants (NVIDIA H100 SXM data sheet, 700 W)
# ---------------------------------------------------------------------------

CARD = "NVIDIA H100 80GB HBM3"
POWER_LIMIT = "700.00 W"
PEAK_FLOPS = 989e12          # dense bf16 FLOP/s per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s each way, within a node
IB_BW = 50e9                 # bytes/s, one 400 Gb/s NIC per card
NODE = 8                     # cards joined by NVLink

# the collectives the port issues: ``torch.distributed``'s (namespace
# ``c10d``) and DTensor's (``_c10d_functional``); another one raises
COLLECTIVES = {
    "allreduce_": "all-reduce", "all_reduce": "all-reduce",
    "_allgather_base_": "all-gather", "allgather_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "alltoall_base_": "all-to-all", "all_to_all_single": "all-to-all",
}
# ops of the two namespaces that move no bytes
SILENT = {"wait_tensor", "_wrap_tensor_autograd", "barrier",
          "monitored_barrier_"}
ALLOCATIONS = {"empty", "empty_like", "empty_strided", "new_empty",
               "new_empty_strided"}


# ---------------------------------------------------------------------------
# counting
# ---------------------------------------------------------------------------

def _tensors(obj):
    """Every tensor in ``obj`` (nested dicts, lists and tuples, a module's
    parameters and buffers), a DTensor as its local shard."""
    if isinstance(obj, DTensor):
        yield obj.to_local()
    elif isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, torch.nn.Module):
        yield from obj.parameters()
        yield from obj.buffers()
    elif isinstance(obj, dict):
        for v in obj.values():
            yield from _tensors(v)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            yield from _tensors(v)


def _storages(obj) -> dict:
    """{id: storage} of the distinct storages under ``obj``."""
    return {id(st): st for st in (t.untyped_storage()
                                  for t in _tensors(obj))}


def held_bytes(*objs) -> int:
    """Bytes of the distinct storages under ``objs`` (a storage shared by
    a parameter and its placed copy counts once)."""
    seen = {}
    for obj in objs:
        seen.update(_storages(obj))
    return sum(st.nbytes() for st in seen.values())


def _group_ranks(func, args, kwargs) -> list:
    """The global ranks of the group a collective op runs over."""
    from torch.distributed.distributed_c10d import _resolve_process_group
    schema = func._schema
    for i, arg in enumerate(schema.arguments):
        v = args[i] if i < len(args) else kwargs.get(arg.name)
        if arg.name == "process_group":
            return dist.get_process_group_ranks(dist.ProcessGroup.unbox(v))
        if arg.name == "group_name":
            return dist.get_process_group_ranks(_resolve_process_group(v))
    raise ValueError(f"no group in {schema}")


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


class StepCounter(TorchDispatchMode):
    """Counts what one rank's step does, moves and holds (module
    docstring): ``flops``, ``hbm_bytes``, ``collectives`` {op: result
    bytes}, ``by_link`` {"nvlink" | "ib": bytes}, ``collective_s``, and
    ``peak`` (the most bytes of storage allocated under it and alive at
    once).  Storages
    under ``held`` (the step's arguments) are alive before it and count in
    neither."""

    def __init__(self, held=()):
        super().__init__()
        self.flops = self.hbm_bytes = 0
        self.collectives: dict[str, int] = {}
        self.by_link = {"nvlink": 0, "ib": 0}
        self.collective_s = 0.0
        self.live = self.peak = 0
        self._seen = WeakIdKeyDictionary()
        for st in _storages(held).values():
            self._seen[st] = 0

    def _alloc(self, out) -> None:
        for t in _tensors(out):
            st = t.untyped_storage()
            if st in self._seen:
                continue
            n = st.nbytes()
            self._seen[st] = n
            self.live += n
            self.peak = max(self.peak, self.live)
            weakref.finalize(st, self._free, n)

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        formula = flop_registry.get(func._overloadpacket)
        if formula is not None:
            self.flops += formula(*args, **kwargs, out_val=out)
        ns, name = func.namespace, func._schema.name.split("::")[-1]
        if ns in ("c10d", "_c10d_functional"):
            if name in SILENT:
                return out
            if name not in COLLECTIVES:
                raise NotImplementedError(f"uncounted collective {func}")
            result = args[0] if ns == "c10d" else out
            n = sum(_nbytes(t) for t in _tensors(result))
            kind = COLLECTIVES[name]
            self.collectives[kind] = self.collectives.get(kind, 0) + n
            nodes = {r // NODE for r in _group_ranks(func, args, kwargs)}
            link = "nvlink" if len(nodes) == 1 else "ib"
            self.by_link[link] += n
            self.collective_s += n / (NVLINK_BW if link == "nvlink"
                                      else IB_BW)
            self._alloc(out)
            return out
        if func.is_view or name in ALLOCATIONS:
            self._alloc(out)
            return out
        ids = {}
        for t in list(_tensors(args)) + list(_tensors(kwargs)) + \
                list(_tensors(out)):
            ids[id(t)] = t
        self.hbm_bytes += sum(_nbytes(t) for t in ids.values())
        self._alloc(out)
        return out


def count_step(step, held) -> dict:
    """Run ``step()`` under the counters; ``held`` is everything the rank
    holds at its start.  -> {flops, hbm_bytes, collectives, by_link,
    collective_s, argument_bytes, temp_bytes, output_bytes}."""
    args = held_bytes(held)
    counter = StepCounter(held)
    with counter:
        out = step()
    held_ids = _storages(held)
    new = {k: st for k, st in _storages(out).items() if k not in held_ids}
    return dict(flops=counter.flops, hbm_bytes=counter.hbm_bytes,
                collectives=dict(counter.collectives),
                by_link=dict(counter.by_link),
                collective_s=counter.collective_s, argument_bytes=args,
                temp_bytes=counter.peak,
                output_bytes=sum(st.nbytes() for st in new.values()))


# ---------------------------------------------------------------------------
# step builders (inputs are meta tensors)
# ---------------------------------------------------------------------------

def _batch_rows(batch: dict, mesh, mi):
    """The reference's ``_batch_specs`` as the port splits a batch: this
    rank's rows (``placement.batch_rows`` of the tokens' batch and
    sequence length), each tensor copied so that the rank holds its rows
    alone, and the axes they are split over."""
    tokens = batch["tokens"]
    rows, axes = placement.batch_rows(mesh, mi, tokens.shape[0],
                                      tokens.shape[-1])
    return {k: v[rows].clone() for k, v in batch.items()}, rows, axes


def lower_train(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
                microbatch: int = 0) -> dict:
    """One ``Trainer.make_train_step(mesh=)`` step (task "lm", float32
    moments, the reference's ``TrainConfig``) in the steady state: the
    state placed as the step's first call places it, one step run
    uncounted (after it a parameter that ZeRO-1 updated on its moments'
    placement is stored apart from the model's compute copy), then the
    counted step."""
    mi = mesh_info_from_mesh(mesh)
    tcfg = TrainConfig(task="lm", total_steps=1000,
                       state_dtype="float32", microbatch=microbatch)
    state = I.state_struct(cfg, tcfg)
    sspecs = state_specs(state, mi)
    placement.place_state(state, mesh, sspecs)
    batch = I.train_inputs(cfg, shape)
    b, l = batch["tokens"].shape[0], batch["tokens"].shape[-1]
    k = microbatch if microbatch > 1 else 1
    index = None
    if cfg.mux.active and cfg.mux.retrieval_alpha > 0.0:
        # the retrieval draw, the whole batch's (``Trainer.mesh_grads``)
        index = [torch.empty((b // k, l), dtype=torch.int64,
                             device=I.META) for _ in range(k)]
        index = index if k > 1 else index[0]
    step = Trainer.make_train_step(cfg, tcfg, mesh=mesh, mesh_info=mi)
    params = Trainer.params(state)
    extra = dict(
        compute_copy_bytes=held_bytes(state["model"]),
        params_bytes_at_specs=sum(placement.spec_bytes(
            p.shape, p.dtype, sspecs["params"][name], mi)
            for name, p in params.items()),
        **_rows(*placement.batch_rows(mesh, mi, b // k, l)))
    step(state, batch, None, retr_index=index)
    counts = count_step(lambda: step(state, batch, None, retr_index=index),
                        (state, batch, index))
    return dict(counts, **extra)


def lower_prefill(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """The serving prefill as ``Engine.prefill`` runs it on a mesh, with no
    cache (as the reference's dry-run): the rank's rows of the batch
    through the last-only forward, the parameters whole (the engine serves
    them replicated), the next-token logits all-gathered over the row
    axes."""
    mi = mesh_info_from_mesh(mesh)
    check_model_mesh(cfg, mi)
    model = I.param_struct(cfg)
    batch, rows, axes = _batch_rows(I.prefill_inputs(cfg, shape), mesh, mi)
    on_mesh = OnMesh(mesh, mi, axes)

    def prefill_step():
        with torch.inference_mode():
            out = model(batch["tokens"], context=batch.get("context"),
                        last_only=True, on_mesh=on_mesh)
            logits = placement.gather_rows(out["logits"][..., -1, :], mesh,
                                           axes)
        return logits, out["index_embeds"]

    extra = _serve_extra(cfg, model, mi, rows, axes)
    return dict(count_step(prefill_step, (model, batch)), **extra)


def lower_decode(cfg: ModelConfig, shape: ShapeConfig, mesh) -> dict:
    """One decode step as ``Engine.step`` runs it on a mesh: the rank's rows
    of the tokens, the cache (every row over the whole sequence: the port
    does not split a cache's sequence), the index embeddings and the
    context K/V through ``Backbone.decode_step``, the parameters whole,
    the logits all-gathered over the row axes."""
    mi = mesh_info_from_mesh(mesh)
    check_model_mesh(cfg, mi)
    model = I.param_struct(cfg)
    dec = I.decode_inputs(cfg, shape, model=model)
    b = I.backbone_batch(cfg, shape)
    rows, axes = placement.batch_rows(mesh, mi, b, 1)
    mine = {k: v[rows].clone() for k, v in dec.items()
            if k in ("tokens", "index_embeds")}
    cache = [{k: v[rows].clone() for k, v in layer.items()}
             for layer in dec["cache"]]
    cross_kv = None
    if "cross_kv" in dec:
        cross_kv = {i: {k: v[rows].clone() for k, v in kv.items()}
                    for i, kv in dec["cross_kv"].items()}
    pos = shape.seq_len + cfg.mux.prefix_len - 1
    on_mesh = OnMesh(mesh, mi, axes)

    def serve_step():
        with torch.inference_mode():
            logits, _ = model.decode_step(
                mine["tokens"], cache, pos,
                index_embeds=mine.get("index_embeds"), cross_kv=cross_kv,
                on_mesh=on_mesh)
            return placement.gather_rows(logits, mesh, axes)

    spec_bytes = sum(
        placement.spec_bytes(v.shape, v.dtype, s[k], mi)
        for layer, s in zip(dec["cache"], cache_specs(dec["cache"], mi))
        for k, v in layer.items())
    extra = dict(_serve_extra(cfg, model, mi, rows, axes),
                 cache_bytes=held_bytes(cache),
                 cache_bytes_at_specs=spec_bytes)
    return dict(count_step(serve_step, (model, mine, cache, cross_kv)),
                **extra)


def _serve_extra(cfg, model, mi, rows, axes) -> dict:
    params = dict(model.named_parameters())
    pspecs = param_specs(params, mi, cfg=cfg)
    return dict(
        compute_copy_bytes=held_bytes(model),
        params_bytes_at_specs=sum(placement.spec_bytes(
            p.shape, p.dtype, pspecs[k], mi) for k, p in params.items()),
        **_rows(rows, axes))


def _rows(rows: slice, axes) -> dict:
    """The rank's rows (of a microbatch, for train) and their axes."""
    return dict(rows=[rows.start, rows.stop], row_axes=list(axes or ()))


LOWER = {"train": lower_train, "prefill": lower_prefill,
         "decode": lower_decode}


# ---------------------------------------------------------------------------
# analysis
# ---------------------------------------------------------------------------

def analyse(counts: dict, cfg: ModelConfig, shape: ShapeConfig,
            n_chips: int) -> dict:
    """The reference's record from one rank's counts (``count_step``)."""
    flops = float(counts["flops"]) * n_chips
    hbm_bytes = float(counts["hbm_bytes"]) * n_chips
    coll = {k: float(v) for k, v in counts["collectives"].items()}
    coll["total"] = sum(coll.values())
    terms = {"compute_s": flops / (n_chips * PEAK_FLOPS),
             "memory_s": hbm_bytes / (n_chips * HBM_BW),
             "collective_s": counts["collective_s"]}
    dominant = max(terms, key=terms.get)

    n_params = cfg.param_count()
    n_active = cfg.active_param_count()
    instances = I.backbone_batch(cfg, shape)
    if cfg.mux.active:
        instances *= cfg.mux.n
    tokens = instances * (shape.seq_len if shape.kind != "decode" else 1)
    model_flops = (6 if shape.kind == "train" else 2) * n_active * tokens
    args, temp = counts["argument_bytes"], counts["temp_bytes"]
    return {
        "arch": cfg.name, "shape": shape.name, "kind": shape.kind,
        "mux_n": cfg.mux.n, "instances": instances, "n_chips": n_chips,
        "hlo_flops": flops, "hbm_bytes": hbm_bytes,
        "collective_bytes": coll,
        **terms,
        "dominant": dominant.replace("_s", ""),
        "params": n_params, "active_params": n_active,
        "model_flops": model_flops,
        "useful_flops_frac": model_flops / flops if flops else 0.0,
        "argument_size_in_bytes": args,
        "output_size_in_bytes": counts["output_bytes"],
        "temp_size_in_bytes": temp,
        "generated_code_size_in_bytes": 0,
        "bytes_per_device": args + temp,
        "seq_len": shape.seq_len, "global_batch": shape.global_batch,
        "remat": cfg.remat,
        "collective_bytes_by_link": counts["by_link"],
        "compute_copy_bytes": counts["compute_copy_bytes"],
        "params_bytes_at_specs": counts["params_bytes_at_specs"],
        **{k: counts[k] for k in ("cache_bytes", "cache_bytes_at_specs")
           if k in counts},
        "rows": counts["rows"], "row_axes": counts["row_axes"],
        "predicted_from": "meta tensors (no device ran)",
        "roofline": {"card": CARD, "power_limit": POWER_LIMIT,
                     "peak_flops": PEAK_FLOPS, "hbm_bw": HBM_BW,
                     "nvlink_bw": NVLINK_BW, "ib_bw": IB_BW,
                     "node": NODE},
    }


def _record_name(arch: str, shape_name: str, mesh_kind: str,
                 mux_n: int) -> str:
    return (f"{arch.replace('.', '_')}__{shape_name}__{mesh_kind}"
            f"__n{mux_n}.json")


def _write(rec: dict, out_dir: str, name: str) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        with open(os.path.join(out_dir, name), "w") as f:
            json.dump(rec, f, indent=1)


MESHES = {"pod": (16, 16), "multipod": (2, 16, 16), "single": (1, 1)}


def start_fake_group(world: int) -> None:
    """This process as rank 0 of a fake process group of ``world``."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world)


def build_mesh(mesh_kind: str):
    """The production mesh (``pod``, ``multipod``) or the (1, 1) mesh
    (``single``) over the started group, its device type ``cpu``."""
    if mesh_kind == "single":
        return make_mesh((1, 1), "cpu")
    return make_production_mesh(multi_pod=mesh_kind == "multipod",
                                device="cpu")


def dry_run(cfg: ModelConfig, shape: ShapeConfig, mesh, *,
            microbatch: int = 0) -> dict:
    """The record of ``cfg``'s ``shape`` step on ``mesh`` (a started
    group's mesh)."""
    t0 = time.time()
    kw = {"microbatch": microbatch} if shape.kind == "train" else {}
    counts = LOWER[shape.kind](cfg, shape, mesh, **kw)
    rec = analyse(counts, cfg, shape, mesh.size())
    rec.update(lower_s=round(time.time() - t0, 1), compile_s=0.0)
    return rec


def run_one(arch: str, shape_name: str, mesh_kind: str, mux_n: int,
            out_dir: str, *, smoke: bool = False,
            prefix_pad: int = 0, seq_parallel: bool = False,
            moe_scatter: bool = False, moe_ep2d: bool = False,
            remat: str = "", microbatch: int = 0, seq_len: int = 0,
            global_batch: int = 0, mesh=None) -> dict:
    """One record, written to ``out_dir`` (if given) under the reference's
    file name; ``seq_len`` / ``global_batch`` (nonzero) replace the
    shape's.  ``mesh`` is built (``build_mesh``) unless given."""
    shape = INPUT_SHAPES[shape_name]
    if seq_len or global_batch:
        shape = ShapeConfig(
            f"{shape.name}-l{seq_len or shape.seq_len}"
            f"-b{global_batch or shape.global_batch}",
            seq_len or shape.seq_len, global_batch or shape.global_batch,
            shape.kind)
    getter = get_smoke_config if smoke else get_config
    cfg = getter(arch)
    if mux_n != cfg.mux.n or prefix_pad:
        cfg = dataclasses.replace(
            cfg, mux=dataclasses.replace(cfg.mux, n=mux_n,
                                         prefix_pad=prefix_pad))
    if seq_parallel:
        cfg = dataclasses.replace(cfg, seq_parallel=True)
    if moe_scatter and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, psum_scatter=True))
    if moe_ep2d and cfg.moe is not None:
        cfg = dataclasses.replace(
            cfg, moe=dataclasses.replace(cfg.moe, ep2d=True))
    if remat:
        cfg = dataclasses.replace(cfg, remat=remat)
    name = _record_name(arch, shape.name, mesh_kind, mux_n)
    if shape_name == "long_500k" and not long_500k_supported(arch):
        rec = {"arch": arch, "shape": shape.name, "mesh": mesh_kind,
               "mux_n": mux_n, "skipped": "quadratic-attention"}
        _write(rec, out_dir, name)
        return rec
    mesh = mesh if mesh is not None else build_mesh(mesh_kind)
    rec = dry_run(cfg, shape, mesh, microbatch=microbatch)
    rec["mesh"] = mesh_kind
    _write(rec, out_dir, name)
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(INPUT_SHAPES))
    ap.add_argument("--mesh", default="pod", choices=list(MESHES),
                    help="pod (16, 16), multipod (2, 16, 16) or single "
                         "(1, 1)")
    ap.add_argument("--mux-n", type=int, default=8,
                    help="DataMUX width (1 = vanilla baseline)")
    ap.add_argument("--prefix-pad", type=int, default=0,
                    help="pad mux prefix to a multiple")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="the reference's Megatron-SP constraint (refused "
                         "on the port's mesh: it computes by gather)")
    ap.add_argument("--moe-scatter", action="store_true",
                    help="reduce-scatter MoE pre-activation")
    ap.add_argument("--moe-ep2d", action="store_true",
                    help="experts over BOTH mesh axes, pure EP")
    ap.add_argument("--remat", default="",
                    choices=["", "none", "dots", "full"],
                    help="override the config's remat policy")
    ap.add_argument("--microbatch", type=int, default=0,
                    help="gradient-accumulation chunks")
    ap.add_argument("--seq-len", type=int, default=0,
                    help="replace the shape's sequence length")
    ap.add_argument("--global-batch", type=int, default=0,
                    help="replace the shape's global batch (instances)")
    ap.add_argument("--out", default="results/dryrun_torch")
    ap.add_argument("--all", action="store_true",
                    help="sweep every (arch x shape) on --mesh")
    ap.add_argument("--smoke", action="store_true",
                    help="use reduced configs (CI sanity, not the "
                         "deliverable)")
    args = ap.parse_args(argv)

    assigned = [a for a in ARCHS if not a.startswith("tmux")]
    combos = ([(a, s) for a in assigned for s in INPUT_SHAPES]
              if args.all else [(args.arch, args.shape)])
    failures = 0
    mesh = None
    try:
        for arch, shape in combos:
            try:
                if mesh is None and not (
                        shape == "long_500k"
                        and not long_500k_supported(arch)):
                    start_fake_group(math.prod(MESHES[args.mesh]))
                    mesh = build_mesh(args.mesh)
                rec = run_one(arch, shape, args.mesh, args.mux_n, args.out,
                              smoke=args.smoke, prefix_pad=args.prefix_pad,
                              seq_parallel=args.seq_parallel,
                              moe_scatter=args.moe_scatter,
                              moe_ep2d=args.moe_ep2d, remat=args.remat,
                              microbatch=args.microbatch,
                              seq_len=args.seq_len,
                              global_batch=args.global_batch, mesh=mesh)
                status = rec.get("skipped") and \
                    f"SKIP({rec['skipped']})" or \
                    (f"{rec['dominant']}-bound c={rec['compute_s']:.4f}s "
                     f"m={rec['memory_s']:.4f}s "
                     f"x={rec['collective_s']:.4f}s "
                     f"bytes/device={rec['bytes_per_device']} "
                     f"collective={rec['collective_bytes']['total']:.0f}")
                print(f"[dryrun] {arch} x {shape} x {args.mesh} "
                      f"n={args.mux_n}: {status}", flush=True)
            except Exception:
                failures += 1
                print(f"[dryrun] FAIL {arch} x {shape} x {args.mesh}:",
                      flush=True)
                traceback.print_exc()
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()

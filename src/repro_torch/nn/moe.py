"""Mixture-of-Experts block, the port of ``repro.nn.moe``: ``MoE.apply``
unsharded, and its expert-parallel path over a mesh (``_apply_shard`` /
``_apply_block`` under ``shard_map``) on ``torch.distributed``.

* Routing runs in float32: the router weight is float32 whatever the
  model's param dtype (the reference initialises it so), and meets a
  float32 copy of x.  Top-k keeps the reference's tie-break (the lowest
  expert id first) through a stable descending sort; ``torch.topk``
  promises no order among equal scores, and equal scores are real (a zero
  row scores every expert alike).
* Dispatch is sort-based: the (row, choice) pairs are stably sorted by
  expert id, masked rows going to a sentinel expert past every real one;
  each expert keeps its first ``cap`` pairs, and the rest land on an
  overflow row that is dropped.  ``cap`` is the reference's
  ``ceil(T * k / E * capacity_factor)`` over the block's padded rows (on
  a mesh, the shard's rows).
* The expert FFN runs in x's dtype as batched matmuls over
  (E, cap, d) buffers (the reference's ``einsum`` outside any Pallas
  kernel; this block has no TPU kernel).
* The combine adds each row's k contributions one choice at a time in
  ascending expert order (the stable sort's order), so it is deterministic
  on the card: no float atomics over repeated row indices.
* Every count is kept on the device (no ``bincount``, no ``one_hot``: both
  read a maximum back to the host), so a decode step does not wait on it.
* While a profiler runs, each stage runs under a label (``moe.route``,
  ``moe.dispatch``, ``moe.experts``, ``moe.combine``, ``moe.shared``),
  so a profile gives the device time of each (the label's device time
  counts the kernels launched inside it).  Otherwise no label is entered:
  ``record_function`` costs host time even with no profiler running.

The shared expert runs on every row, masked or not, and is added after the
routed output.  ``MeshInfo`` (the mesh's axes and sizes) is the
reference's, field for field.

Expert parallelism (``MoE.forward(on_mesh=OnMesh(...))``).  A one-device
mesh runs the unsharded block, as the reference does.  On a larger mesh
each rank runs the shard of the reference's ``shard_map``: the tokens
``MeshInfo.bl_entries`` of the whole input gives its shard (batch rows,
sequence positions) and its ``d / model`` slice of features, which it
takes from its input and whose output it gathers back, so the block's
input and output are whole on every rank.  ``OnMesh.row_axes`` names the
axes whose rows the caller has already split (the rank holds its rows of
the whole batch, as ``sharding.placement.batch_rows`` gives them).  The
collectives are the reference's, in its order: the router logits summed
over ``model``; the (ep, E/ep, cap, d_loc) buffer all-to-all over
``data`` (over the (data, model) group under ``ep2d``, data-major, with
its d-slices reassembled) and back; the expert pre-activations summed
over ``model``, or reduce-scattered over F and all-gathered once under
``psum_scatter``; the aux averaged over ``data`` (and ``model`` under
``ep2d``, and ``pod``).  Nothing crosses ``pod`` otherwise.  Each rank
slices its expert and feature shard (``MoE.param_specs``) from the full
parameters.

Gradients.  Outside the block the activations are whole and the same on
every ``model`` rank; the objective there is counted once.  So a
collective over ``model`` takes the adjoint that fits: the d-slice of x
goes back as an all-gather, the output's gather as this rank's slice, a
sum whose result every rank uses alike (the router logits) as the
identity, a replicated value entering a sharded use (the routing weights)
as a sum, the pre-activations' sum (used by each rank's slice of
``down``) as a sum, the reduce-scatter / all-gather pair as each other.
Over the batch axes (``pod``, ``data``) every collective takes its true
transpose (the all-to-all its inverse, the aux mean a mean, a gather of
rows a reduce-scatter): the training objective is the mean of the ranks'
losses, so the caller averages every gradient over those axes.  Then
each rank holds its ``model`` slice of the router's and the experts'
gradients (under ``ep2d`` its expert group's too), which a sum over
``model`` completes (``complete_grads``, from ``param_specs``).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch import nn

from repro_torch.nn import activations, initializers
from repro_torch.nn.layers import MLP, Linear, profiler_label


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    """The reference's ``MoEConfig``, field for field."""
    dim: int
    moe_ff: int                      # per-expert FFN hidden size
    n_experts: int
    top_k: int
    n_shared_experts: int = 0        # shared expert(s) of width n_shared*moe_ff
    capacity_factor: float = 1.25
    activation: str = "silu"
    gated: bool = True
    router_scoring: str = "softmax"  # or "sigmoid" (DeepSeek-V3)
    aux_loss_coef: float = 0.001
    psum_scatter: bool = False       # reduce-scatter the expert
                                     # pre-activations over F + all-gather
                                     # the activated tensor once
    ep2d: bool = False               # experts over both mesh axes: one
                                     # expert group per device, full-d
                                     # weights, no sum inside the experts


@dataclasses.dataclass(frozen=True)
class MeshInfo:
    """Static description of the active mesh for manual collectives."""
    data_axis: str = "data"
    model_axis: str = "model"
    pod_axis: Optional[str] = None
    data_size: int = 1
    model_size: int = 1
    pod_size: int = 1

    @property
    def batch_spec(self):
        if self.pod_axis:
            return (self.pod_axis, self.data_axis)
        return (self.data_axis,)

    def bl_entries(self, b: int, l: int):
        """(batch_entry, seq_entry) PartitionSpec entries for a (B, L, ...)
        activation: assign each batch-parallel mesh axis to the batch dim
        when divisible, else to the sequence dim (context parallelism),
        else replicate.  Keeps pjit/with_sharding_constraint legal for the
        small-batch long-sequence shapes (e.g. prefill_32k B=4 on data=16)."""
        bat, seq = [], []
        for name, size in ((self.pod_axis, self.pod_size),
                           (self.data_axis, self.data_size)):
            if not name or size <= 1:
                continue
            if b % size == 0:
                bat.append(name)
                b //= size
            elif l % size == 0:
                seq.append(name)
                l //= size
        return (tuple(bat) or None, tuple(seq) or None)


SINGLE = MeshInfo()


@dataclasses.dataclass(frozen=True)
class OnMesh:
    """The mesh a model call's MoE layers run their expert-parallel block
    on: ``mesh`` (a ``DeviceMesh``), ``info`` its ``MeshInfo``, and
    ``row_axes`` the mesh axes whose batch rows the caller has already
    split (the rank holds its rows of the whole batch, as
    ``sharding.placement.batch_rows`` gives them; empty: the whole
    batch)."""
    mesh: object
    info: MeshInfo
    row_axes: tuple = ()


def use_ep2d(cfg: MoEConfig, mi: MeshInfo) -> bool:
    """The reference's ``MoE._use_ep2d``: experts over (data, model) only
    where the model axis is split and divides them."""
    return (cfg.ep2d and mi.model_size > 1 and
            cfg.n_experts % (mi.data_size * mi.model_size) == 0)


def param_specs(cfg: MoEConfig, mi: MeshInfo) -> dict:
    """The reference's ``MoE.param_specs`` on its layout (router ``w``
    (d, E), experts (E, d, F) / (E, F, d)), as ``sharding.specs`` tuples:
    experts over data and features over model; under ``ep2d`` experts over
    (data, model) with full-d weights."""
    from repro_torch.sharding.specs import P
    if use_ep2d(cfg, mi):
        e = (mi.data_axis, mi.model_axis)
        specs = {"router": {"w": P(mi.model_axis, None)},
                 "up": P(e, None, None), "down": P(e, None, None)}
        if cfg.gated:
            specs["gate"] = P(e, None, None)
        return specs
    specs = {"router": {"w": P(mi.model_axis, None)},
             "up": P(mi.data_axis, mi.model_axis, None),
             "down": P(mi.data_axis, None, mi.model_axis)}
    if cfg.gated:
        specs["gate"] = P(mi.data_axis, mi.model_axis, None)
    return specs


def _flat_specs(specs: dict, prefix: str = ""):
    """(parameter name, spec) of a ``param_specs`` tree, the reference's
    Linear ``w`` under the port's name ``weight``."""
    for key, v in specs.items():
        if isinstance(v, dict):
            yield from _flat_specs(v, f"{prefix}{key}.")
        else:
            yield prefix + ("weight" if key == "w" else key), v


def complete_grads(model: nn.Module, grads: dict, mesh, mi: MeshInfo
                   ) -> dict:
    """``grads`` (by ``model.named_parameters()`` name, already averaged
    over the batch axes) with every MoE layer's gradients that
    ``param_specs`` shards over ``model`` summed over it: each rank held
    only its shard's part of them (module docstring)."""
    if mi.model_size <= 1:
        return grads
    from repro_torch.sharding.placement import sum_over
    names = [f"{prefix}.{name}" if prefix else name
             for prefix, mod in model.named_modules() if isinstance(mod, MoE)
             for name, spec in _flat_specs(param_specs(mod.cfg, mi))
             if any(mi.model_axis in (e if isinstance(e, tuple) else (e,))
                    for e in spec)]
    return {**grads, **dict(zip(names, sum_over(
        [grads[n] for n in names], mesh, (mi.model_axis,))))}


def check_mesh(cfg: MoEConfig, mi: MeshInfo) -> None:
    """Raise where the reference's expert-parallel block cannot run on
    ``mi``: experts the expert-parallel size does not divide (its reshape
    fails), or features the model axis does not divide (its ``shard_map``
    refuses the input)."""
    ep = mi.data_size * (mi.model_size if use_ep2d(cfg, mi) else 1)
    if cfg.n_experts % ep:
        raise ValueError(
            f"n_experts {cfg.n_experts} is not divisible by the "
            f"expert-parallel size {ep} (data {mi.data_size}"
            + (f" x model {mi.model_size}" if ep != mi.data_size else "")
            + "): the expert-parallel block (ROADMAP item 12b) splits the "
            "experts evenly, as the reference's does")
    if cfg.dim % mi.model_size:
        raise ValueError(
            f"dim {cfg.dim} is not divisible by the model axis "
            f"{mi.model_size}: the expert-parallel block (ROADMAP item "
            f"12b) splits the features over it")


def check_model_mesh(cfg, mi: MeshInfo) -> None:
    """``check_mesh`` for a model config's MoE layers (none: nothing); and
    ``seq_parallel`` refused on any mesh: the reference constrains the
    activations between blocks to a ``model``-sharded d, and under the
    port's compute by gather no activation is sharded over ``model``."""
    if cfg.seq_parallel:
        raise ValueError(
            "seq_parallel=True is refused on the port's mesh: under compute "
            "by gather (ROADMAP Queue C) the parameters are gathered whole "
            "and no activation is sharded over the model axis, so the "
            "reference's Megatron-SP constraint (the activations' d "
            "sharded over it) has nothing to constrain")
    if mi.data_size * mi.model_size * mi.pod_size > 1 and any(
            k["mlp"] == "moe" for k in cfg.layer_kinds()):
        check_mesh(cfg.moe, mi)


def capacity(rows: int, cfg: MoEConfig) -> int:
    """Slots per expert for a block of ``rows`` rows (padding included), in
    Python floats in the reference's order."""
    return max(1, math.ceil((rows * cfg.top_k / cfg.n_experts)
                            * cfg.capacity_factor))


def route(logits, cfg: MoEConfig, row_mask=None):
    """logits (T, E) float32 -> (top_w (T, k), top_ids (T, k), aux).

    ``row_mask`` (T,) bool marks valid rows; the load-balance statistics
    count valid rows only, so a fully masked block gives ``aux == 0.0``."""
    if cfg.router_scoring == "sigmoid":
        scores = torch.sigmoid(logits)
    else:
        scores = torch.softmax(logits, dim=-1)
    # stable: equal scores keep ascending expert order, as lax.top_k does
    top_w, top_ids = torch.sort(scores, dim=-1, descending=True, stable=True)
    top_w, top_ids = top_w[:, :cfg.top_k], top_ids[:, :cfg.top_k]
    top_w = top_w / (torch.sum(top_w, dim=-1, keepdim=True) + 1e-9)
    # Switch-style load-balance auxiliary loss.
    probs = torch.softmax(logits, dim=-1)
    one_hot = torch.zeros((*top_ids.shape, cfg.n_experts),
                          dtype=torch.float32, device=logits.device)
    one_hot.scatter_(-1, top_ids[..., None], 1.0)
    if row_mask is None:
        density = torch.mean(one_hot, dim=(0, 1))
        density_proxy = torch.mean(probs, dim=0)
    else:
        m = row_mask.to(torch.float32)
        n_valid = torch.clamp(torch.sum(m), min=1.0)
        density = torch.sum(one_hot * m[:, None, None], dim=(0, 1)) / (
            n_valid * cfg.top_k)
        density_proxy = torch.sum(probs * m[:, None], dim=0) / n_valid
    aux = cfg.n_experts * torch.sum(density * density_proxy)
    return top_w, top_ids, aux


def dispatch(top_ids, row_mask, cap: int, n_experts: int):
    """Sort-based dispatch of the T*k (row, choice) pairs -> (order, slot,
    keep), each (T*k,) in sorted order: ``order`` the stable argsort by
    expert id (masked rows under the sentinel id ``n_experts``), ``slot``
    the pair's row of the (E*cap + 1, d) buffer (``E*cap``: the overflow
    row) and ``keep`` whether the pair got a slot."""
    t, k = top_ids.shape
    flat_e = top_ids.reshape(-1)
    if row_mask is not None:
        flat_e = torch.where(row_mask.repeat_interleave(k), flat_e,
                             n_experts)
    order = torch.argsort(flat_e, stable=True)
    e_sorted = flat_e[order]
    counts = torch.zeros(n_experts + 1, dtype=torch.int64,
                         device=flat_e.device)
    counts.scatter_add_(0, flat_e, torch.ones_like(flat_e))
    start = torch.cumsum(counts, 0) - counts
    pos = torch.arange(t * k, device=flat_e.device) - start[e_sorted]
    keep = (pos < cap) & (e_sorted < n_experts)
    slot = torch.where(keep, e_sorted * cap + pos, n_experts * cap)
    return order, slot, keep


# ---------------------------------------------------------------------------
# collectives with their adjoints
# ---------------------------------------------------------------------------

def _all_reduce(t, group):
    out = t.contiguous().clone()
    dist.all_reduce(out, group=group)
    return out


def _all_gather(t, group, dim: int):
    """The group's tensors concatenated along ``dim``, in group order."""
    n = dist.get_world_size(group)
    t = t.contiguous()
    out = t.new_empty((n * t.shape[0], *t.shape[1:]))
    dist.all_gather_into_tensor(out, t, group=group)
    dim %= t.ndim
    shape = list(t.shape)
    shape[dim] *= n
    return out.view(n, *t.shape).movedim(0, dim).reshape(shape)


def _reduce_scatter(t, group, dim: int):
    """The sum over the group of ``t``, this rank's chunk along ``dim``."""
    n = dist.get_world_size(group)
    parts = torch.cat(t.chunk(n, dim=dim))     # the chunks along dim 0
    out = parts.new_empty((parts.shape[0] // n, *parts.shape[1:]))
    dist.reduce_scatter_tensor(out, parts, group=group)
    return out


def _my_chunk(t, group, dim: int):
    n = dist.get_world_size(group)
    return t.chunk(n, dim=dim)[dist.get_rank(group)].contiguous()


def _all_to_all(t, group):
    """Chunk i of dim 0 to group rank i; its own inverse."""
    out = torch.empty_like(t, memory_format=torch.contiguous_format)
    dist.all_to_all_single(out, t.contiguous(), group=group)
    return out


class _Collective(torch.autograd.Function):
    """``fwd(t)`` forward and ``bwd(g)`` backward: one collective and the
    adjoint the caller chose for it (the module docstring says which)."""

    @staticmethod
    def forward(ctx, t, fwd, bwd):
        ctx.bwd = bwd
        return fwd(t)

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


class _Shard:
    """One rank's place in the reference's ``shard_map``: its groups, its
    expert group, and the block's collectives with their adjoints.  An
    axis the mesh lacks has size 1 and no collective."""

    def __init__(self, cfg: MoEConfig, mesh, mi: MeshInfo):
        names = mesh.mesh_dim_names
        self.mesh, self.mi = mesh, mi
        self.groups = {a: mesh.get_group(a) for a in names}
        sizes = {mi.data_axis: mi.data_size, mi.model_axis: mi.model_size,
                 mi.pod_axis: mi.pod_size}
        if any(sizes.get(a, 1) != n for a, n in zip(names, mesh.shape)):
            raise ValueError(f"{mi} does not describe the mesh "
                             f"{dict(zip(names, mesh.shape))}")
        self.ep2d = use_ep2d(cfg, mi)
        self.ep = mi.data_size * (mi.model_size if self.ep2d else 1)
        self.e_loc = cfg.n_experts // self.ep
        self.model = self.groups.get(mi.model_axis)
        self.ep_group = (_ep2d_group(mesh, mi) if self.ep2d
                         else self.groups.get(mi.data_axis))
        # the reference's guard: F-slices only where the model axis
        # splits the features and divides F
        self.scatter = (cfg.psum_scatter and mi.model_size > 1
                        and not self.ep2d and cfg.moe_ff % mi.model_size == 0)
        self.specs = param_specs(cfg, mi)

    def local(self, t, spec):
        """This rank's shard of the full tensor ``t`` at ``spec``: a
        view."""
        from repro_torch.sharding.placement import part
        for d, entry in enumerate(spec):
            if entry is not None:
                sl = part(self.mesh, t.shape[d],
                          entry if isinstance(entry, tuple) else (entry,))
                t = t[(slice(None),) * d + (sl,)]
        return t

    # -- over model: the objective counted once --------------------------

    def _model_op(self, t, fwd, bwd):
        if self.model is None:
            return t
        return _Collective.apply(t, lambda u: fwd(u, self.model),
                                 lambda g: bwd(g, self.model))

    def enter(self, x):
        """x (.., d) -> this rank's (.., d / model); back: all-gather."""
        return self._model_op(x, lambda u, g: _my_chunk(u, g, -1),
                              lambda u, g: _all_gather(u, g, -1))

    def leave(self, y):
        """y (.., d / model) -> (.., d) gathered; back: this rank's
        slice (the gradient is the same on every model rank)."""
        return self._model_op(y, lambda u, g: _all_gather(u, g, -1),
                              lambda u, g: _my_chunk(u, g, -1))

    def psum_replicated(self, t):
        """Sum over model of a result every model rank uses alike."""
        return self._model_op(t, _all_reduce, lambda u, g: u)

    def to_sharded(self, t):
        """A replicated value entering each rank's own slice."""
        return self._model_op(t, lambda u, g: u.clone(), _all_reduce)

    def combine_pre(self, t):
        """The (E_loc, rows, F) pre-activation's partial sums over model
        -> summed (or this rank's summed F-slice under ``psum_scatter``);
        each rank then uses it with its own slice of ``down``."""
        if self.ep2d:
            return t
        if self.scatter:
            return self._model_op(t, lambda u, g: _reduce_scatter(u, g, 2),
                                  lambda u, g: _all_gather(u, g, 2))
        return self._model_op(t, _all_reduce, _all_reduce)

    def gather_f(self, h):
        """``psum_scatter``'s F-slices -> full F."""
        return self._model_op(h, lambda u, g: _all_gather(u, g, 2),
                              lambda u, g: _reduce_scatter(u, g, 2))

    # -- over the batch axes: true transposes -----------------------------

    def all_to_all(self, t):
        if self.ep_group is None:
            return t
        g = self.ep_group
        return _Collective.apply(t, lambda u: _all_to_all(u, g),
                                 lambda u: _all_to_all(u, g))

    def gather(self, t, axes, dim: int):
        """This rank's chunk along ``dim`` -> the whole, over ``axes``
        (the minor gathered first); back: reduce-scatter."""
        for a in reversed(axes):
            g = self.groups.get(a)
            if g is not None:
                t = _Collective.apply(
                    t, lambda u, g=g: _all_gather(u, g, dim),
                    lambda u, g=g: _reduce_scatter(u, g, dim))
        return t

    def mean_aux(self, aux):
        """The reference's pmean of aux over data (back: the mean), model
        under ep2d (the same on every model rank: back, the identity) and
        pod."""
        mi = self.mi
        for a, back_mean in ((mi.data_axis, True),
                             (mi.model_axis if self.ep2d else None, False),
                             (mi.pod_axis, True)):
            g = self.groups.get(a) if a else None
            if g is None:
                continue
            def mean(u, g=g, n=dist.get_world_size(g)):
                return _all_reduce(u, g) / n
            aux = _Collective.apply(aux, mean,
                                    mean if back_mean else (lambda u: u))
        return aux


def _ep2d_group(mesh, mi: MeshInfo):
    """The (data, model) group of this rank's pod, its ranks data-major
    (JAX's order for a multi-axis collective).  Every rank creates every
    pod's group, once per mesh."""
    groups = getattr(mesh, "_moe_ep2d_groups", None)
    if groups is None:
        ranks = mesh.mesh
        if mi.pod_axis:
            slices = [ranks[p] for p in range(ranks.shape[0])]
        else:
            slices = [ranks]
        groups = [dist.new_group(s.flatten().tolist()) for s in slices]
        mesh._moe_ep2d_groups = groups
    pod = mesh.get_local_rank(mi.pod_axis) if mi.pod_axis else 0
    return groups[pod]


class MoE(nn.Module):
    def __init__(self, cfg: MoEConfig, *, generator, device=None,
                 dtype=torch.float32):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.n_experts, cfg.dim, cfg.moe_ff
        kw = dict(generator=generator, device=device)
        self.router = Linear(d, e, stddev=d ** -0.5, dtype=torch.float32,
                             **kw)
        self.up = nn.Parameter(initializers.normal((e, d, f), d ** -0.5,
                                                   dtype=dtype, **kw))
        self.down = nn.Parameter(initializers.normal((e, f, d), f ** -0.5,
                                                     dtype=dtype, **kw))
        self.gate = nn.Parameter(initializers.normal(
            (e, d, f), d ** -0.5, dtype=dtype, **kw)) if cfg.gated else None
        self.shared = MLP(d, cfg.n_shared_experts * f, gated=cfg.gated,
                          activation=cfg.activation, dtype=dtype, **kw) \
            if cfg.n_shared_experts else None

    def forward(self, x, row_mask=None, *, on_mesh: Optional[OnMesh] = None,
                shortcut: bool = True):
        """x (B, L, d) -> (out (B, L, d), aux float32 scalar).

        ``row_mask`` (B, L) bool marks valid rows (chunked serving decode:
        rows past a slot's ``chunk_lens`` or with no live lane are
        padding).  Masked rows take no capacity slot and no part in the aux
        statistics, and their routed output is an exact zero.

        ``on_mesh`` with a mesh of more than one device runs the
        expert-parallel path (module docstring); x's rows are this rank's
        over its ``row_axes``, or the whole batch.  A one-device mesh runs
        the unsharded block, as the reference does, unless ``shortcut`` is
        False: then the shard path runs there too, its collectives issued
        over the size-1 groups."""
        if on_mesh is not None and (on_mesh.mesh.size() > 1 or not shortcut):
            check_mesh(self.cfg, on_mesh.info)
            out, aux = self._shard(x, row_mask, on_mesh.mesh, on_mesh.info,
                                   tuple(on_mesh.row_axes))
        else:
            b, l, d = x.shape
            out, aux = self._block(
                x.reshape(b * l, d),
                None if row_mask is None else row_mask.reshape(b * l).bool())
            out = out.reshape(b, l, d)
        if self.shared is not None:
            with profiler_label("moe.shared"):
                out = out + self.shared(x)
        return out, aux

    def _shard(self, x, row_mask, mesh, mi: MeshInfo, row_axes: tuple):
        """The rank's ``_apply_shard``: its tokens and d-slice of x through
        the block, the output gathered whole, the aux averaged."""
        sh = _Shard(self.cfg, mesh, mi)
        b, l, d = x.shape
        whole = b * math.prod(
            mesh.size(mesh.mesh_dim_names.index(a)) for a in row_axes)
        bat, seq = (e or () for e in mi.bl_entries(whole, l))
        if row_axes and row_axes != bat:
            raise ValueError(f"rows split over {row_axes}, but the block's "
                             f"batch of {whole} rows splits over {bat}")
        take = () if row_axes else bat
        from repro_torch.sharding.placement import part
        rows, pos = part(mesh, b, take), part(mesh, l, seq)
        xs = sh.enter(x[rows, pos])
        bl, ll, d_loc = xs.shape
        mask = None if row_mask is None else \
            row_mask[rows, pos].reshape(bl * ll).bool()
        out, aux = self._block(xs.reshape(bl * ll, d_loc), mask, sh)
        out = sh.leave(out.reshape(bl, ll, d_loc))
        out = sh.gather(sh.gather(out, seq, 1), take, 0)
        return out, sh.mean_aux(aux)

    def _block(self, x, row_mask, sh: Optional[_Shard] = None):
        """x (T, d) (a shard's (T_loc, d_loc) with ``sh``) -> (y, aux)."""
        cfg = self.cfg
        t, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        with profiler_label("moe.route"):
            if sh is None:
                logits = self.router(x.float())                # (T, E) f32
            else:
                w = sh.local(self.router.weight.t(),
                             sh.specs["router"]["w"]).t()
                logits = sh.psum_replicated(F.linear(x.float(), w))
            top_w, top_ids, aux = route(logits, cfg, row_mask)
            if sh is not None:
                top_w = sh.to_sharded(top_w)
        cap = capacity(t, cfg)
        with profiler_label("moe.dispatch"):
            order, slot, keep = dispatch(top_ids, row_mask, cap, e)
            t_sorted = order // k
            w_sorted = top_w.reshape(-1).to(x.dtype)[order]
            # Kept pairs own distinct rows; dropped ones all write the
            # overflow row, which is cut off unread.
            buf = x.new_zeros((e * cap + 1, d)).index_copy_(0, slot,
                                                            x[t_sorted])
            buf = buf[:e * cap].view(e, cap, d)
            if sh is not None:
                buf = self._exchange(buf, sh, cap)

        with profiler_label("moe.experts"):
            act = activations.get(cfg.activation)
            weights = {n: getattr(self, n) if sh is None
                       else sh.local(getattr(self, n), sh.specs[n])
                       for n in ("up", "gate", "down")
                       if getattr(self, n) is not None}
            pre = (lambda h: h) if sh is None else sh.combine_pre
            h = pre(torch.bmm(buf, weights["up"].to(x.dtype)))
            if self.gate is not None:
                h = act(pre(torch.bmm(buf, weights["gate"].to(x.dtype)))) * h
            else:
                h = act(h)
            if sh is not None and sh.scatter:
                h = sh.gather_f(h)
            out_buf = torch.bmm(h, weights["down"].to(x.dtype))
            if sh is not None:
                out_buf = self._exchange_back(out_buf, sh, cap, d)

        with profiler_label("moe.combine"):
            out_flat = torch.cat([out_buf.reshape(e * cap, d),
                                  x.new_zeros((1, d))])
            gathered = out_flat[slot] * (w_sorted
                                         * keep.to(x.dtype))[:, None]
            # Each row's k pairs by ascending sorted position (= ascending
            # expert id), summed one choice at a time.
            at = torch.empty_like(order).scatter_(
                0, order, torch.arange(t * k, device=x.device))
            at = torch.sort(at.view(t, k), dim=1).values
            y = x.new_zeros((t, d))
            for j in range(k):
                y = y + gathered[at[:, j]]
        return y, aux.to(torch.float32)

    @staticmethod
    def _exchange(buf, sh: _Shard, cap: int):
        """(E, cap, d_loc) -> this rank's experts' rows, (E_loc, ep * cap,
        d_loc), or (E_loc, data * cap, d) under ep2d with the model peers'
        d-slices of the same (expert, slot) rows reassembled."""
        d_loc = buf.shape[-1]
        buf = sh.all_to_all(buf.reshape(sh.ep, sh.e_loc, cap, d_loc))
        if sh.ep2d:
            dsz, msz = sh.mi.data_size, sh.mi.model_size
            return buf.reshape(dsz, msz, sh.e_loc, cap, d_loc).permute(
                2, 0, 3, 1, 4).reshape(sh.e_loc, dsz * cap, msz * d_loc)
        return buf.transpose(0, 1).reshape(sh.e_loc, sh.ep * cap, d_loc)

    @staticmethod
    def _exchange_back(out_buf, sh: _Shard, cap: int, d_loc: int):
        """``_exchange`` reversed: -> (E, cap, d_loc)."""
        if sh.ep2d:
            dsz, msz = sh.mi.data_size, sh.mi.model_size
            out_buf = out_buf.reshape(sh.e_loc, dsz, cap, msz, d_loc) \
                .permute(1, 3, 0, 2, 4)
        else:
            out_buf = out_buf.reshape(sh.e_loc, sh.ep, cap, d_loc) \
                .transpose(0, 1)
        out_buf = sh.all_to_all(out_buf.reshape(sh.ep, sh.e_loc, cap, d_loc))
        return out_buf.reshape(sh.e_loc * sh.ep, cap, d_loc)

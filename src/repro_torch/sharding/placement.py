"""Placing tensors on a ``DeviceMesh`` — the counterpart of the reference's
``jax.device_put(state, shardings)`` and of the collectives its jitted
steps insert.

* ``placements`` turns a spec (``sharding.specs``) into DTensor
  placements: ``Shard(d)`` on each mesh dim that dim ``d``'s entry names,
  ``Replicate()`` on the others.  A tuple entry such as ``("data",
  "model")`` shards dim ``d`` over both mesh dims, the major axis first,
  which is JAX's order and DTensor's when the names follow the mesh's.
* ``place`` / ``place_state`` hold a tensor, or a ``Trainer`` state's
  parameters and AdamW moments, at their specs: each rank keeps only its
  own shard (a copy, so no view pins the whole tensor), and a tensor it
  holds whole as it is (a parameter then shares its storage with the
  model's compute copy).
* ``batch_rows`` is the slice of a (B, L, ...) batch that this rank
  computes: the rows of its coordinate on the axes ``MeshInfo.bl_entries``
  gives the batch; an axis given to the sequence, and the model axis,
  compute the same rows on every rank.
* ``mean_over`` / ``sum_over`` all-reduce tensors to their mean or sum
  over those axes; ``gather_rows`` all-gathers row slices back into the
  whole batch.

``torch.distributed.tensor`` is imported where it is used, so importing
this module starts nothing.
"""
from __future__ import annotations

import math

import torch
import torch.distributed as dist

from repro_torch.nn.moe import MeshInfo


def placements(spec: tuple, mesh) -> list:
    """DTensor placements of ``spec`` on ``mesh``.  An axis the mesh lacks
    (``model`` on a one-axis ``--mesh-shape``) or of size 1 holds the
    whole dim: replicated."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    out = [Replicate()] * mesh.ndim
    for d, entry in enumerate(spec):
        axes = entry if isinstance(entry, tuple) else (entry,)
        dims = [names.index(a) for a in axes if a in names]
        if dims != sorted(dims):
            raise ValueError(f"spec entry {entry} does not follow the "
                             f"mesh's axis order {names}")
        for m in dims:
            if mesh.size(m) > 1:
                out[m] = Shard(d)
    return out


def local_slice(t: torch.Tensor, mesh, pls) -> torch.Tensor:
    """This rank's shard of ``t`` (the whole tensor, the same on every
    rank) at placements ``pls``: a view, chunked along each ``Shard`` mesh
    dim in mesh order, which is DTensor's order for even shards."""
    coord = mesh.get_coordinate()
    for m, pl in enumerate(pls):
        if pl.is_shard():
            t = t.chunk(mesh.size(m), dim=pl.dim)[coord[m]]
    return t


def place(t: torch.Tensor, mesh, spec: tuple):
    """A DTensor holding ``t`` (the same on every rank) at ``spec``: this
    rank's shard copied, or ``t`` itself where the rank holds it whole."""
    from torch.distributed.tensor import DTensor
    pls = placements(spec, mesh)
    local = local_slice(t, mesh, pls)
    if local.shape != t.shape:
        local = local.clone()
    return DTensor.from_local(local, mesh, pls, run_check=False,
                              shape=t.shape, stride=t.stride())


def place_state(state: dict, mesh, sspecs: dict) -> dict:
    """Hold a ``Trainer`` state with an "opt_state" at ``sspecs``
    (``specs.state_specs``), in place: "params" becomes {name: DTensor}
    of the parameters (the stored copy; the model keeps its full tensors
    as the compute copy the step gathers into) and the moments DTensors.
    Returns the state."""
    from repro_torch.training.trainer import Trainer
    with torch.no_grad():
        state["params"] = {k: place(p.detach(), mesh, sspecs["params"][k])
                           for k, p in Trainer.params(state).items()}
        opt = state["opt_state"]
        state["opt_state"] = {
            m: {k: place(t, mesh, sspecs["opt_state"][m][k])
                for k, t in opt[m].items()} for m in ("mu", "nu")}
        state["opt_state"]["step"] = opt["step"]
    return state


def state_bytes(state: dict, sspecs: dict, mi: MeshInfo) -> tuple[int, int]:
    """(bytes of storage this rank's shards of a placed state's parameters
    and moments hold, the bytes ``sspecs`` give them on one rank)."""
    trees = [(state["params"], sspecs["params"])] + [
        (state["opt_state"][m], sspecs["opt_state"][m]) for m in ("mu", "nu")]
    held = sum(t.to_local().untyped_storage().nbytes()
               for tree, _ in trees for t in tree.values())
    want = sum(spec_bytes(t.shape, t.dtype, specs[k], mi)
               for tree, specs in trees for k, t in tree.items())
    return held, want


def spec_bytes(shape, dtype: torch.dtype, spec: tuple, mi: MeshInfo) -> int:
    """Bytes one rank holds of a ``shape`` tensor at ``spec``: its elements
    over the product of the sizes of the axes the spec names."""
    sizes = {mi.data_axis: mi.data_size, mi.model_axis: mi.model_size}
    if mi.pod_axis:
        sizes[mi.pod_axis] = mi.pod_size
    parts = 1
    for entry in spec:
        for a in (entry if isinstance(entry, tuple) else (entry,)):
            parts *= sizes.get(a, 1)
    return math.prod(shape) // parts * torch.empty((), dtype=dtype) \
        .element_size()


def part(mesh, n: int, axes) -> slice:
    """This rank's chunk of ``n`` items split over the mesh axes ``axes``,
    the major first (an axis the mesh lacks holds them whole)."""
    pos, parts = 0, 1
    for a in axes:
        if a in mesh.mesh_dim_names:
            size = mesh.size(mesh.mesh_dim_names.index(a))
            pos, parts = pos * size + mesh.get_local_rank(a), parts * size
    n //= parts
    return slice(pos * n, (pos + 1) * n)


def batch_rows(mesh, mi: MeshInfo, b: int, l: int) -> tuple[slice, tuple]:
    """(the rows of a (B, L, ...) batch this rank computes, the mesh axes
    the batch is split over, major first)."""
    axes = mi.bl_entries(b, l)[0] or ()
    return part(mesh, b, axes), axes


def mean_over(tensors: list, mesh, axes: tuple) -> list:
    """The mean of each tensor over the ranks of ``axes`` (one all-reduce
    per axis and dtype over the tensors flattened together); the tensors
    themselves with no axis."""
    return sum_over(tensors, mesh, axes, mean=True)


def sum_over(tensors: list, mesh, axes: tuple, *, mean: bool = False
             ) -> list:
    """The sum (``mean``: the mean) of each tensor over the ranks of
    ``axes``, as ``mean_over``."""
    if not axes:
        return tensors
    count = math.prod(mesh.size(mesh.mesh_dim_names.index(a)) for a in axes) \
        if mean else 1
    out = list(tensors)
    # first-seen order: every rank issues the same all-reduces in turn
    for dtype in dict.fromkeys(t.dtype for t in tensors):
        idx = [i for i, t in enumerate(tensors) if t.dtype == dtype]
        flat = torch.cat([tensors[i].reshape(-1) for i in idx])
        for a in axes:
            dist.all_reduce(flat, group=mesh.get_group(a))
        flat = flat / count
        for i, piece in zip(idx, flat.split([tensors[i].numel()
                                             for i in idx])):
            out[i] = piece.view(tensors[i].shape)
    return out


def gather_rows(t: torch.Tensor, mesh, axes: tuple) -> torch.Tensor:
    """Each rank's ``batch_rows`` slice of a batch -> the whole batch, on
    every rank (the minor axis gathered first)."""
    for a in reversed(axes):
        group = mesh.get_group(a)
        parts = [torch.empty_like(t)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        t = torch.cat(parts)
    return t


def gather_state(state: dict) -> dict:
    """The plain ``Trainer`` state of a placed one, for a checkpoint: the
    model (which holds the gathered parameters) and the moments gathered
    whole.  A collective: every rank calls it."""
    out = {k: v for k, v in state.items() if k != "params"}
    opt = state["opt_state"]
    out["opt_state"] = {m: {k: t.full_tensor() for k, t in opt[m].items()}
                        for m in ("mu", "nu")}
    out["opt_state"]["step"] = opt["step"]
    return out

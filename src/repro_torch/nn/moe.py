"""Mixture-of-Experts block, the port of ``repro.nn.moe``'s unsharded path:
``MoE.apply`` with no mesh and its ``_apply_block`` at one expert group.

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
  ``ceil(T * k / E * capacity_factor)`` over the whole padded block.
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
reference's, field for field.  A one-device mesh runs the unsharded block,
as the reference does; expert parallelism over a larger mesh (its
``shard_map`` path, ``psum_scatter`` and ``ep2d``) is ROADMAP Queue A item
12b: the config keeps those fields, and such a mesh raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
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
    psum_scatter: bool = False       # expert parallelism (item 12b)
    ep2d: bool = False               # expert parallelism (item 12b)


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


def refuse_expert_parallel(cfg, mesh) -> None:
    """A ``cfg`` model with MoE layers on a mesh of more than one device
    raises: there the reference's numbers come from its expert-parallel
    ``shard_map`` path (per-shard capacity and aux), ROADMAP item 12b."""
    if mesh is not None and mesh.size() > 1 and any(
            k["mlp"] == "moe" for k in cfg.layer_kinds()):
        raise NotImplementedError(
            f"{cfg.name} has MoE layers: expert parallelism over a mesh of "
            f"more than one device is ROADMAP Queue A item 12b")


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

    def forward(self, x, row_mask=None, *, mesh=None):
        """x (B, L, d) -> (out (B, L, d), aux float32 scalar).

        ``row_mask`` (B, L) bool marks valid rows (chunked serving decode:
        rows past a slot's ``chunk_lens`` or with no live lane are
        padding).  Masked rows take no capacity slot and no part in the aux
        statistics, and their routed output is an exact zero.

        ``mesh`` (a ``DeviceMesh``) of one device runs the unsharded block,
        where every collective of the reference's sharded path is the
        identity; a larger mesh raises."""
        if mesh is not None and mesh.size() > 1:
            raise NotImplementedError(
                "expert parallelism over a mesh of more than one device is "
                "ROADMAP Queue A item 12b; the port runs the unsharded block")
        b, l, d = x.shape
        out, aux = self._block(
            x.reshape(b * l, d),
            None if row_mask is None else row_mask.reshape(b * l).bool())
        out = out.reshape(b, l, d)
        if self.shared is not None:
            with profiler_label("moe.shared"):
                out = out + self.shared(x)
        return out, aux

    def _block(self, x, row_mask):
        cfg = self.cfg
        t, d = x.shape
        e, k = cfg.n_experts, cfg.top_k
        with profiler_label("moe.route"):
            logits = self.router(x.float())                    # (T, E) f32
            top_w, top_ids, aux = route(logits, cfg, row_mask)
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

        with profiler_label("moe.experts"):
            act = activations.get(cfg.activation)
            h = torch.bmm(buf, self.up.to(x.dtype))
            if self.gate is not None:
                h = act(torch.bmm(buf, self.gate.to(x.dtype))) * h
            else:
                h = act(h)
            out_buf = torch.bmm(h, self.down.to(x.dtype))

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


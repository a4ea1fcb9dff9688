"""Per-tensor placement rules for every model family + ZeRO-1 moments —
the port of ``repro.sharding.specs``.

A spec is a tuple with one entry per tensor dim: None (replicated), a mesh
axis name, or a tuple of names (that dim split over each, the major axis
first).  The rules (``_leaf_spec``, the reference's text) are matched on
the reference's key path, which ``bridge.reference_paths`` gives for each
port tensor, and are computed on the reference's layout, then carried
over to the port's:

  * a stacked leaf (a scanned layer, one tensor per layer here) drops the
    leading entry of its stacked (groups,) axis;
  * a transposed leaf (a Linear ``weight``, (out, in) here) swaps its last
    two entries.

ZeRO-1 (``opt_state_specs``) picks the largest unsharded divisible dim on
the reference's stacked shape, as the reference does.  Where that is the
groups axis, which the port does not hold as one tensor, the port
replicates that axis: the moment keeps its parameter's spec (ROADMAP Queue
C lists the leaves).

Sharding plan (the reference's):
  * embeddings: vocab -> model axis
  * attention: head projections -> model axis (Megatron TP)
  * MLA: per-head up-projections -> model; low-rank latents replicated
  * dense FFN: hidden -> model
  * MoE: experts -> data (expert parallelism), expert FFN input-dim -> model
  * Mamba: d_inner -> model
  * xLSTM: replicated (125M; pure data parallelism)
  * mux/demux: demux MLP hidden -> model, small tables replicated
  * ZeRO-1: optimizer moments additionally shard their largest replicated
    dim over the data axis when divisible
"""
from __future__ import annotations

from repro_torch.bridge import reference_paths
from repro_torch.nn.moe import MeshInfo


def P(*entries) -> tuple:
    """A spec: one entry per dim (the reference's ``PartitionSpec``, which
    also reads a tuple of one axis as that axis)."""
    return tuple(e[0] if isinstance(e, tuple) and len(e) == 1 else e
                 for e in entries)


def mesh_info_from_mesh(mesh) -> MeshInfo:
    """``MeshInfo`` of a ``DeviceMesh`` named by ``launch.mesh``."""
    names = mesh.mesh_dim_names
    sizes = dict(zip(names, mesh.shape))
    return MeshInfo(
        data_axis="data", model_axis="model",
        pod_axis="pod" if "pod" in names else None,
        data_size=sizes.get("data", 1), model_size=sizes.get("model", 1),
        pod_size=sizes.get("pod", 1))


def batch_spec(mi: MeshInfo, *trailing):
    return P(mi.batch_spec, *trailing)


class _Leaf:
    """The rank of a leaf, which is all ``_leaf_spec`` reads of it."""

    def __init__(self, ndim: int):
        self.ndim = ndim


def _leaf_spec(s: str, leaf, mi: MeshInfo, *, moe_ep2d: bool = False) -> P:
    """Base spec for an UNSTACKED leaf, matched by path suffix."""
    model, data = mi.model_axis, mi.data_axis
    nd = leaf.ndim

    # ---- MoE ----
    if "/moe/" in s or s.startswith("moe/"):
        if moe_ep2d:   # experts over (data, model), full-d weights (§Perf A4b)
            if s.endswith("up") or s.endswith("gate") or s.endswith("down"):
                return P((data, model), None, None)
        if s.endswith("router/w"):
            return P(model, None)
        if s.endswith("up") or s.endswith("gate"):
            return P(data, model, None)
        if s.endswith("down"):
            return P(data, None, model)
        if "/shared/" in s:  # shared expert = plain MLP
            if "/up/" in s or "/gate/" in s:
                return P(None, model) if nd == 2 else P(model)
            if "/down/" in s:
                return P(model, None) if nd == 2 else P()
        return P(*([None] * nd))

    # ---- xLSTM: replicate (small model, pure DP) ----
    if "/mlstm/" in s or "/slstm/" in s:
        return P(*([None] * nd))

    # ---- Mamba ----
    if "/mamba/" in s:
        if s.endswith("in_proj/w"):
            return P(None, model)
        if s.endswith("conv_w"):
            return P(None, model)
        if s.endswith("conv_b") or s.endswith("D"):
            return P(model)
        if s.endswith("x_proj/w"):
            return P(model, None)
        if s.endswith("dt_proj/w"):
            return P(None, model)
        if s.endswith("dt_proj/b"):
            return P(model)
        if s.endswith("A_log"):
            return P(model, None)
        if s.endswith("out_proj/w"):
            return P(model, None)
        return P(*([None] * nd))

    # ---- attention (incl. MLA & cross) ----
    if "/attn/" in s or "/cross/" in s:
        if s.endswith("wq/w") or s.endswith("wk/w") or s.endswith("wv/w"):
            return P(None, model)
        if s.endswith("wq/b") or s.endswith("wk/b") or s.endswith("wv/b"):
            return P(model)
        if s.endswith("wo/w"):
            return P(model, None)
        # MLA pieces
        if s.endswith("wq_a/w") or s.endswith("wkv_a/w"):
            return P(None, None)       # low-rank latents replicated
        if s.endswith("wq_b/w") or s.endswith("wk_b/w") or \
                s.endswith("wv_b/w"):
            return P(None, model)      # per-head expansions sharded on heads
        return P(*([None] * nd))

    # ---- dense FFN ----
    if "/mlp/" in s or "/ffn/" in s:
        if "/up/" in s or "/gate/" in s:
            return P(None, model) if nd == 2 else P(model)
        if "/down/" in s:
            return P(model, None) if nd == 2 else P()
        # demux SharedMLPStack layers l0..lk handled below
    if "/mlp/l" in s or "demux" in s and "/l" in s:
        pass

    # ---- embeddings / lm head ----
    if s.endswith("embed/table"):
        return P(model, None)          # vocab-sharded
    if s.endswith("lm_head/w"):
        return P(None, model)
    if s.endswith("lm_head/b"):
        return P(model)

    # ---- DataMUX ----
    if s.startswith("mux/") or "/mux/" in s:
        if s.endswith("o"):            # ortho matrices (N, d, d)
            return P(None, None, model)
        return P(*([None] * nd))
    if "demux" in s:
        if s.endswith("l0/w"):         # (2d, hidden) first demux layer
            return P(None, model)
        if s.endswith("l0/b"):
            return P(model)
        if "/mlps/" in s:              # per-index MLPs stacked over N
            if s.endswith("l0/w"):
                return P(None, None, model)
            if s.endswith("/w") and nd == 3:
                return P(None, model, None)
            return P(*([None] * nd))
        if s.endswith("/w") and nd == 2:   # later demux layers (hidden, d)
            return P(model, None)
        if s.endswith("/b"):
            return P()
        return P(*([None] * nd))

    # ---- demux shared-MLP inside SharedMLPStack key layout (mlp/l0/w) ----
    if "/l0/w" in s and nd == 2:
        return P(None, model)
    if "/l0/b" in s:
        return P(model)
    if ("/l1/w" in s or "/l2/w" in s) and nd == 2:
        return P(model, None)

    # ---- norms, scalars, everything else: replicated ----
    return P(*([None] * nd))


def _axis_size(entry, mi: MeshInfo) -> int:
    sizes = {mi.data_axis: mi.data_size, mi.model_axis: mi.model_size}
    if mi.pod_axis:
        sizes[mi.pod_axis] = mi.pod_size
    names = entry if isinstance(entry, tuple) else (entry,)
    prod = 1
    for nm in names:
        prod *= sizes.get(nm, 1)
    return prod


def sanitize_spec(spec, shape, mi: MeshInfo) -> P:
    """Drop sharding on dims the mesh does not divide (e.g. whisper's
    51865-row vocab on a 16-way model axis) — replicate instead of failing."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, e in zip(shape, entries):
        if e is not None and dim % _axis_size(e, mi) != 0:
            e = None
        out.append(e)
    return P(*out)


def _swap(entries: tuple) -> tuple:
    """Swap the last two entries (a Linear's (in, out) <-> (out, in))."""
    return entries[:-2] + (entries[-1], entries[-2])


def _reference_layout(name, shape, paths, groups: int):
    """(reference path, its shape, stacked, transposed) of a port tensor."""
    path, stacked, transposed = paths[name]
    shape = tuple(shape)
    if transposed:
        shape = _swap(shape)
    if stacked:
        shape = (groups,) + shape
    return path, shape, stacked, transposed


def _to_port(spec: tuple, stacked: bool, transposed: bool) -> tuple:
    spec = spec[1:] if stacked else spec
    return _swap(spec) if transposed else spec


def param_specs(params, mi: MeshInfo, *, cfg, moe_ep2d: bool = False):
    """{name: spec} for ``params`` ({port name: tensor or anything with a
    ``shape``}) of a ``cfg`` model: the reference's spec of the leaf the
    name maps to, carried over to the port's layout."""
    paths = reference_paths(cfg, params)
    groups = cfg.layer_pattern()[2]
    out = {}
    for name, p in params.items():
        path, shape, stacked, transposed = _reference_layout(
            name, p.shape, paths, groups)
        base = _leaf_spec(path, _Leaf(len(shape) - stacked), mi,
                          moe_ep2d=moe_ep2d)
        if stacked:
            base = P(*((None,) + tuple(base)))
        out[name] = _to_port(sanitize_spec(base, shape, mi), stacked,
                             transposed)
    return out


def _zero1(spec: tuple, shape: tuple, mi: MeshInfo) -> tuple:
    """The reference's ZeRO-1 extension of one leaf's spec."""
    if len(shape) == 0:
        return spec
    used = set()
    for e in spec:
        for nm in (e if isinstance(e, tuple) else (e,)):
            used.add(nm)
    if mi.data_axis in used:  # already data-sharded (e.g. MoE experts)
        return spec
    entries = list(spec) + [None] * (len(shape) - len(spec))
    # pick the largest dim that is currently unsharded & divisible
    best, best_size = -1, 0
    for i, (e, dim) in enumerate(zip(entries, shape)):
        if e is None and dim % mi.data_size == 0 and dim > best_size \
                and dim >= mi.data_size * 2:
            best, best_size = i, dim
    if best >= 0:
        entries[best] = mi.data_axis
    return P(*entries)


def opt_state_specs(opt_state, pspecs, mi: MeshInfo, *, cfg,
                    zero1: bool = True):
    """Moments mirror the param specs; with ZeRO-1, the largest replicated
    dim of the reference's (stacked) leaf additionally shards over the
    data axis when divisible; on a stacked leaf's groups axis the port
    replicates instead.  ``opt_state`` is AdamW's {"mu", "nu", "step"}
    (or anything whose "mu" maps the names to shapes)."""
    paths = reference_paths(cfg, pspecs)
    groups = cfg.layer_pattern()[2]
    mu = {}
    for name, spec in pspecs.items():
        path, shape, stacked, transposed = _reference_layout(
            name, opt_state["mu"][name].shape, paths, groups)
        ref = _swap(spec) if transposed else spec
        if stacked:
            ref = (None,) + ref
        if zero1:
            ref = _zero1(ref, shape, mi)
        # carrying a stacked leaf over drops its groups entry, so a data
        # axis ZeRO-1 put there is replicated
        mu[name] = _to_port(ref, stacked, transposed)
    return {"mu": mu, "nu": dict(mu), "step": P()}


def cache_specs(cache, mi: MeshInfo):
    """Decode-cache placements for the port's per-layer cache list (the
    ``bridge.cache_from_jax`` names): the reference's rules on each layer's
    unstacked shape.  Sequence dim shards over ``model`` (flash-decode
    style); batch over (pod, data) when divisible; with a batch too small
    to split, the sequence spreads over both axes."""
    batch_axes = mi.batch_spec
    batch_div = mi.data_size * mi.pod_size

    def spec(name, shape):
        b = shape[0] if shape else 1
        bs = batch_axes if (b % batch_div == 0 and b >= batch_div) else None
        entries = [bs] + [None] * (len(shape) - 1)
        if name in ("k", "v", "ckv", "krope", "pos") and len(shape) >= 2:
            seq = shape[1]
            if bs is None and seq % (batch_div * mi.model_size) == 0:
                entries[1] = (mi.pod_axis, "data", "model") if mi.pod_axis \
                    else ("data", "model")
            elif seq % mi.model_size == 0 and seq >= mi.model_size:
                entries[1] = mi.model_axis
        elif name == "ssm" and len(shape) == 3:       # (B, d_inner, d_state)
            if shape[1] % mi.model_size == 0:
                entries[1] = mi.model_axis
        elif name == "conv" and len(shape) == 3:      # (B, k-1, d_inner)
            if shape[2] % mi.model_size == 0:
                entries[2] = mi.model_axis
        return P(*entries)

    return [{name: spec(name, tuple(leaf.shape)) for name, leaf in
             layer.items()} for layer in cache]


def state_specs(state, mi: MeshInfo, *, zero1: bool = True,
                moe_ep2d: bool = False):
    """{"params", "opt_state", "step"} specs of a ``Trainer`` state (the
    moments shaped like the params when the state has none yet)."""
    from repro_torch.training.trainer import Trainer
    cfg = state["model"].cfg
    params = Trainer.params(state)
    pspecs = param_specs(params, mi, cfg=cfg, moe_ep2d=moe_ep2d)
    opt_state = state.get("opt_state", {"mu": params})
    return {
        "params": pspecs,
        "opt_state": opt_state_specs(opt_state, pspecs, mi, cfg=cfg,
                                     zero1=zero1),
        "step": P(),
    }

"""The port's placement rules (``repro_torch.sharding``) against the
reference's ``repro.sharding.specs``: the port's ``tests/test_sharding.py``.

* ``bridge.reference_paths`` maps every port tensor of every registered
  arch (smoke config, mux N 2) onto exactly the reference's leaves.
* ``param_specs``: every tensor's spec is the reference's spec of its leaf,
  carried over (a stacked leaf's groups entry dropped, a Linear weight's
  last two entries swapped), at MeshInfo (data, model) = (2, 2), (4, 1),
  (1, 4), (2, 6) (d 256 does not divide by 6: ``sanitize_spec``) and (pod,
  data, model) = (2, 2, 2).
* ``opt_state_specs`` with ZeRO-1 on and off: the same, except where the
  reference puts the data axis on a stacked leaf's groups axis, which the
  port replicates; that set of departures is asserted exactly.
* ``cache_specs`` for qwen1.5-4b, deepseek-v3-671b and
  jamba-1.5-large-398b, contiguous and paged, per layer.
* ``MeshInfo.bl_entries`` / ``batch_spec`` on a grid of (B, L); the
  reference's ZeRO-1 check at data 4; the meshes of ``launch/mesh.py``
  (a world-1 ``gloo`` group in this process, ended after) and the DTensor
  placements of a spec.
"""
import collections
import dataclasses
import functools
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import PartitionSpec as P

from repro.configs.registry import ARCHS, get_smoke_config
from repro.models import Backbone as JaxBackbone
from repro.nn.moe import MeshInfo as JaxMeshInfo
from repro.sharding import specs as jax_specs
from repro_torch.bridge import reference_paths
from repro_torch.configs import registry as torch_registry
from repro_torch.launch import mesh as torch_mesh
from repro_torch.models import Backbone
from repro_torch.nn.moe import SINGLE, MeshInfo
from repro_torch.sharding import (batch_spec, cache_specs, opt_state_specs,
                                  param_specs, state_specs)
from repro_torch.sharding.placement import (local_slice, placements,
                                            spec_bytes)
from repro_torch.training.trainer import TrainConfig, Trainer

MESHES = {
    "2x2": dict(data_size=2, model_size=2),
    "4x1": dict(data_size=4, model_size=1),
    "1x4": dict(data_size=1, model_size=4),
    "2x6": dict(data_size=2, model_size=6),
    "pod2x2x2": dict(pod_axis="pod", pod_size=2, data_size=2, model_size=2),
}
CACHE_ARCHS = ["qwen1.5-4b", "deepseek-v3-671b", "jamba-1.5-large-398b"]
# ZeRO-1 on the reference's stacked groups axis at (2, 2), every arch at
# mux N 2: the port replicates that axis (ROADMAP Queue C)
DEPARTURES_2X2 = {("qwen1.5-4b", f"blocks/0/attn/{w}/b")
                  for w in ("wq", "wk", "wv")} | {
    ("llama4-scout-17b-a16e", "blocks/0/moe/router/w")}


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _mi(name):
    return MeshInfo(**MESHES[name]), JaxMeshInfo(**MESHES[name])


@functools.lru_cache(maxsize=None)
def _arch(arch):
    """(port config, port {name: shape}, reference {path: shape}, the
    reference's shape tree) of the smoke config at mux N 2."""
    cfg = torch_registry.get_smoke_config(arch, mux_n=2)
    ours = {k: tuple(p.shape) for k, p in
            Backbone(cfg, device="cpu").named_parameters()}
    tree = jax.eval_shape(
        lambda k: JaxBackbone.init(k, get_smoke_config(arch, mux_n=2)),
        jax.random.PRNGKey(0))
    theirs = {jax_specs._path_str(p): tuple(l.shape)
              for p, l in jax.tree_util.tree_leaves_with_path(tree)}
    return cfg, ours, theirs, tree


def _by_path(tree):
    return {jax_specs._path_str(p): tuple(s) for p, s in
            jax.tree_util.tree_leaves_with_path(
                tree, is_leaf=lambda x: isinstance(x, P))}


def _carried(spec, stacked, transposed):
    """The reference's spec of a leaf in the port's layout (a stacked
    leaf's groups axis must be replicated)."""
    if stacked:
        assert spec[0] is None, spec
        spec = spec[1:]
    return spec[:-2] + (spec[-1], spec[-2]) if transposed else spec


class _Shape:
    def __init__(self, shape):
        self.shape = shape


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_reference_paths_invert_the_bridge(arch):
    """Each port tensor names one reference leaf, every leaf is named
    once (a stacked one once per group), and the shapes agree after
    un-stacking and un-transposing."""
    cfg, ours, theirs, _ = _arch(arch)
    paths = reference_paths(cfg, ours)
    groups = cfg.layer_pattern()[2]
    named = collections.Counter(p for p, _, _ in paths.values())
    assert named == {p: groups if p.startswith("blocks/") else 1
                     for p in theirs}
    for name, (path, stacked, transposed) in paths.items():
        shape = ours[name]
        if transposed:
            shape = shape[:-2] + (shape[-1], shape[-2])
        seen = theirs[path]
        if stacked:
            assert seen[0] == groups
            seen = seen[1:]
        assert shape == seen, (name, path)


def test_reference_paths_of_a_per_index_demux_and_a_task_head():
    """A per-index demux weight (N, out, in) is the reference's (N, in,
    out) ``w``; a task head keeps its layout."""
    cfg = torch_registry.get_smoke_config("qwen1.5-4b", mux_n=2)
    cfg = dataclasses.replace(cfg, mux=dataclasses.replace(cfg.mux,
                                                           demux="mlp"))
    tcfg = TrainConfig(task="cls", n_classes=3)
    state = Trainer.init_state(cfg, tcfg, device="cpu")
    paths = reference_paths(cfg, Trainer.params(state))
    per_index = [n for n in paths if ".mlps." in n and
                 n.endswith(".weight")]
    assert per_index and all(paths[n][2] for n in per_index)
    assert paths["task_head.w"] == ("task_head/w", False, False)


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_the_references(arch, mesh):
    cfg, ours, _, tree = _arch(arch)
    mi, jmi = _mi(mesh)
    got = param_specs({k: _Shape(s) for k, s in ours.items()}, mi, cfg=cfg)
    want = _by_path(jax_specs.param_specs(tree, jmi))
    for name, (path, stacked, transposed) in reference_paths(
            cfg, ours).items():
        assert got[name] == _carried(want[path], stacked, transposed), \
            (name, path)
        assert len(got[name]) == len(ours[name])


def _departures(arch, mesh, zero1):
    """{reference path: the reference's moment spec} of the stacked leaves
    whose groups axis ZeRO-1 puts on the data axis."""
    _, _, _, tree = _arch(arch)
    _, jmi = _mi(mesh)
    pspecs = jax_specs.param_specs(tree, jmi)
    mu = _by_path(jax_specs.opt_state_specs({"mu": tree}, pspecs, jmi,
                                            zero1=zero1)["mu"])
    return {path: spec for path, spec in mu.items()
            if path.startswith("blocks/") and spec[0] is not None}, mu


@pytest.mark.parametrize("zero1", [True, False])
@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_opt_state_specs_match_the_references(arch, mesh, zero1):
    """Moments equal the reference's carried over, except exactly the
    stacked-axis departures, which keep their parameter's spec."""
    cfg, ours, _, _ = _arch(arch)
    mi, _ = _mi(mesh)
    shapes = {k: _Shape(s) for k, s in ours.items()}
    pspecs = param_specs(shapes, mi, cfg=cfg)
    got = opt_state_specs({"mu": shapes}, pspecs, mi, cfg=cfg, zero1=zero1)
    assert got["nu"] == got["mu"] and got["step"] == ()
    departures, want = _departures(arch, mesh, zero1)
    for name, (path, stacked, transposed) in reference_paths(
            cfg, ours).items():
        ref = want[path]
        if path in departures:
            # ZeRO-1 put the data axis on the groups axis: the port
            # replicates it, and the moment keeps its parameter's spec
            assert got["mu"][name] == pspecs[name]
            ref = (None,) + ref[1:]
        assert got["mu"][name] == _carried(ref, stacked, transposed), \
            (name, path)


def test_zero1_departures_are_the_stacked_axis_leaves():
    """At (2, 2) the departures are qwen1.5-4b's wq/wk/wv biases and
    llama4-scout's router weight; at (4, 1) there are none."""
    found = {m: {(arch, path) for arch in sorted(ARCHS)
                 for path in _departures(arch, m, True)[0]}
             for m in ("2x2", "4x1")}
    assert found["2x2"] == DEPARTURES_2X2
    assert found["4x1"] == set()


def _layer_specs(arch, tree):
    """The reference's cache specs per layer, in layer order, a stacked
    entry without its groups entry."""
    cfg = get_smoke_config(arch, mux_n=2)
    head, period, groups = cfg.layer_pattern()
    layers = [None] * cfg.n_layers
    for i, layer in enumerate(tree["head"]):
        layers[i] = {k: tuple(s) for k, s in layer.items()}
    for j, block in enumerate(tree["blocks"]):
        for g in range(groups):
            layers[head + g * period + j] = {k: tuple(s)[1:]
                                             for k, s in block.items()}
    for t, layer in enumerate(tree["tail"]):
        layers[head + period * groups + t] = {k: tuple(s)
                                              for k, s in layer.items()}
    return layers


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("batch", [1, 4])
@pytest.mark.parametrize("paged", [False, True])
@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_cache_specs_match_the_references(arch, paged, batch, mesh):
    cfg = torch_registry.get_smoke_config(arch, mux_n=2)
    mi, jmi = _mi(mesh)
    pool = (16, 8) if paged else None
    ours = Backbone(cfg, device="cpu").init_cache(batch, 32, page_pool=pool)
    jcfg = get_smoke_config(arch, mux_n=2)
    tree = jax.eval_shape(lambda: JaxBackbone.init_cache(
        jcfg, batch, 32, page_pool=pool))
    want = _layer_specs(arch, jax.tree.map(
        tuple, jax_specs.cache_specs(tree, jmi),
        is_leaf=lambda x: isinstance(x, P)))
    got = cache_specs(ours, mi)
    assert got == want
    if paged:
        assert any("k_pages" in layer or "ckv_pages" in layer
                   for layer in ours)


def test_zero1_extends_replicated_dims():
    """ZeRO-1: moments of replicated matrices gain a data-axis entry when a
    dim is divisible (checked on a 4-way data MeshInfo)."""
    mi = MeshInfo(data_axis="data", model_axis="model", pod_axis=None,
                  data_size=4, model_size=1, pod_size=1)
    cfg = torch_registry.get_smoke_config("tmux-4l-768h", mux_n=1)
    state = Trainer.init_state(cfg, TrainConfig(task="lm", total_steps=10),
                               device="cpu")
    sspecs = state_specs(state, mi, zero1=True)
    n_extended = 0
    for name, pspec in sspecs["params"].items():
        mspec = sspecs["opt_state"]["mu"][name]
        if mspec != pspec:
            n_extended += 1
            assert "data" in mspec
    assert n_extended > 0


@pytest.mark.parametrize("mesh", sorted(MESHES) + ["single"])
def test_bl_entries_and_batch_spec_match_the_references(mesh):
    kw = MESHES.get(mesh, {})
    mi, jmi = MeshInfo(**kw), JaxMeshInfo(**kw)
    assert dataclasses.asdict(mi) == dataclasses.asdict(jmi)
    assert mi.batch_spec == jmi.batch_spec
    assert batch_spec(mi, None, "model") == tuple(
        jax_specs.batch_spec(jmi, None, "model"))
    for b in (1, 2, 3, 4, 6, 8, 16):
        for l in (1, 2, 7, 8, 32):
            assert mi.bl_entries(b, l) == jmi.bl_entries(b, l), (b, l)
    assert {f.name: f.default for f in dataclasses.fields(MeshInfo)} == \
        {f.name: f.default for f in dataclasses.fields(JaxMeshInfo)}
    assert SINGLE == MeshInfo()


def test_meshes_and_placements():
    """``make_test_mesh`` starts a world-1 ``gloo`` group and names the
    production axes (every placement on it replicated: its axes have size
    1); the production mesh needs 256 devices; on a (2, 2) mesh a tuple
    entry shards one dim over both mesh dims, major first, and
    ``local_slice`` cuts the shard DTensor holds; ``spec_bytes`` divides
    by the axes a spec names."""
    from torch.distributed.tensor import Replicate, Shard
    assert not dist.is_initialized()
    try:
        mesh = torch_mesh.make_test_mesh("cpu")
        assert mesh.mesh_dim_names == ("data", "model")
        assert tuple(mesh.shape) == (1, 1)
        assert dist.get_backend() == "gloo"
        assert placements(("data", "model"), mesh) == [Replicate()] * 2
        with pytest.raises(RuntimeError, match=r"\(16, 16\) needs 256 "
                                               r"devices, have 1"):
            torch_mesh.make_production_mesh(device="cpu")
    finally:
        dist.destroy_process_group()
    sizes = (2, 2)
    for coord in ((0, 0), (0, 1), (1, 0), (1, 1)):
        mesh = SimpleNamespace(mesh_dim_names=("data", "model"), ndim=2,
                               size=lambda m: sizes[m],
                               get_coordinate=lambda c=coord: list(c))
        pls = placements((None, ("data", "model")), mesh)
        assert pls == [Shard(1), Shard(1)]
        t = torch.arange(3 * 8).view(3, 8)
        quarter = 2 * (2 * coord[0] + coord[1])
        assert torch.equal(local_slice(t, mesh, pls),
                           t[:, quarter:quarter + 2])
        assert placements(("model", "data"), mesh) == [Shard(1), Shard(0)]
        assert placements((None,), mesh) == [Replicate(), Replicate()]
        with pytest.raises(ValueError, match="axis order"):
            placements((("model", "data"),), mesh)
    mi = MeshInfo(data_size=2, model_size=4)
    assert spec_bytes((8, 16), torch.float32, ("data", "model"), mi) == \
        8 * 16 * 4 // 8
    assert spec_bytes((8, 16), torch.bfloat16, (None, "model"), mi) == \
        8 * 16 * 2 // 4


MOE_MESHES = {
    "2x2": dict(data_size=2, model_size=2),
    "4x1": dict(data_size=4, model_size=1),
    "1x4": dict(data_size=1, model_size=4),
    "pod2x16x16": dict(pod_axis="pod", pod_size=2, data_size=16,
                       model_size=16),
}


@pytest.mark.parametrize("mesh", sorted(MOE_MESHES))
@pytest.mark.parametrize("ep2d", [False, True])
@pytest.mark.parametrize("gated", [True, False])
def test_moe_param_specs_match_the_references(mesh, ep2d, gated):
    """``nn.moe.param_specs`` is the reference's ``MoE.param_specs``, on its
    layout: 256 experts, so that ``ep2d`` engages wherever the model axis
    is split (not at (4, 1), where both are the baseline)."""
    from repro.nn.moe import MoE as JaxMoE
    from repro.nn.moe import MoEConfig as JaxMoEConfig
    from repro_torch.nn import moe
    kw = dict(dim=64, moe_ff=32, n_experts=256, top_k=2, gated=gated,
              ep2d=ep2d)
    mi = MeshInfo(**MOE_MESHES[mesh])
    want = jax.tree.map(tuple, JaxMoE.param_specs(
        JaxMoEConfig(**kw), JaxMeshInfo(**MOE_MESHES[mesh])),
        is_leaf=lambda x: isinstance(x, P))
    got = moe.param_specs(moe.MoEConfig(**kw), mi)
    assert got == want
    assert moe.use_ep2d(moe.MoEConfig(**kw), mi) == (
        ep2d and mi.model_size > 1)

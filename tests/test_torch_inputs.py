"""The dry-run's inputs (``repro_torch.launch.inputs``) and the configs it
reads (``ShapeConfig`` / ``INPUT_SHAPES``, ``active_param_count``,
``long_500k_supported``) against the reference's ``repro.launch.inputs``
and ``repro.configs``.

* ``INPUT_SHAPES`` equal to the reference's, field for field.
* Every input struct of every registered arch x shape at mux N 8: the meta
  tensors' shapes and dtypes equal to the reference's ``jax.eval_shape``
  structs.  A decode shape builds a cache (and a cross config the context
  K/V), so it uses the smoke config; the reference's stacked layers are
  compared layer by layer.
* The model built on ``meta`` at full config holds, tensor by tensor, the
  elements of the reference's ``eval_shape`` params (through
  ``bridge.reference_paths``), and draws nothing; ``param_count``,
  ``active_param_count`` and ``long_500k_supported`` are equal.

``repro.launch.dryrun`` is not imported: its first lines set ``XLA_FLAGS``
for the process.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.configs import base as jax_base
from repro.configs import registry as jax_registry
from repro.launch import inputs as jax_inputs
from repro.models import Backbone as JaxBackbone
from repro.sharding import specs as jax_specs
from repro_torch.bridge import reference_paths
from repro_torch.configs import base as torch_base
from repro_torch.configs import registry as torch_registry
from repro_torch.launch import inputs as I

ARCHS = sorted(torch_registry.ARCHS)
MUX_N = 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread per test: at these sizes torch's thread pool
    only adds waiting, most of all when other test processes share the
    cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _configs(arch, smoke):
    """(port, reference) configs at mux N 8, as the dry-run sets them."""
    if smoke:
        return (torch_registry.get_smoke_config(arch, mux_n=MUX_N),
                jax_registry.get_smoke_config(arch, mux_n=MUX_N))
    out = []
    for cfg in (torch_registry.get_config(arch),
                jax_registry.get_config(arch)):
        out.append(dataclasses.replace(
            cfg, mux=dataclasses.replace(cfg.mux, n=MUX_N)))
    return tuple(out)


def _struct(t):
    """(shape, dtype name) of a meta tensor or a ShapeDtypeStruct."""
    if isinstance(t, torch.Tensor):
        assert t.device.type == "meta"
        return tuple(t.shape), str(t.dtype).removeprefix("torch.")
    return tuple(t.shape), np.dtype(t.dtype).name


def _per_layer(cfg, tree):
    """The reference's {head, blocks, tail} tree as one entry per layer,
    a stacked entry without its groups axis (the port's layout)."""
    head, period, groups = cfg.layer_pattern()

    def unstack(x):
        return (tuple(x.shape)[1:], np.dtype(x.dtype).name)

    def flat(x):
        return _struct(x)

    if isinstance(tree["head"], dict):           # cross K/V: {i: kv}
        layers = {}
        for i, kv in tree["head"].items():
            layers[i] = jax.tree.map(flat, kv)
        for j, kv in tree["blocks"].items():
            for g in range(groups):
                layers[head + g * period + j] = jax.tree.map(unstack, kv)
        for t, kv in tree["tail"].items():
            layers[head + period * groups + t] = jax.tree.map(flat, kv)
        return layers
    layers = [None] * cfg.n_layers
    for i, layer in enumerate(tree["head"]):
        layers[i] = jax.tree.map(flat, layer)
    for j, block in enumerate(tree["blocks"]):
        for g in range(groups):
            layers[head + g * period + j] = jax.tree.map(unstack, block)
    for t, layer in enumerate(tree["tail"]):
        layers[head + period * groups + t] = jax.tree.map(flat, layer)
    return layers


def test_input_shapes_are_the_references():
    assert [f.name for f in dataclasses.fields(torch_base.ShapeConfig)] == \
        [f.name for f in dataclasses.fields(jax_base.ShapeConfig)]
    assert {k: dataclasses.asdict(v)
            for k, v in torch_base.INPUT_SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in jax_base.INPUT_SHAPES.items()}


@pytest.mark.parametrize("shape", sorted(torch_base.INPUT_SHAPES))
@pytest.mark.parametrize("arch", ARCHS)
def test_input_structs_are_the_references(arch, shape):
    ours_shape = torch_base.INPUT_SHAPES[shape]
    ref_shape = jax_base.INPUT_SHAPES[shape]
    decode = ours_shape.kind == "decode"
    cfg, jcfg = _configs(arch, smoke=decode)
    assert I.backbone_batch(cfg, ours_shape) == \
        jax_inputs.backbone_batch(jcfg, ref_shape)
    if not decode:
        getter = "train_inputs" if ours_shape.kind == "train" \
            else "prefill_inputs"
        ours = getattr(I, getter)(cfg, ours_shape)
        ref = getattr(jax_inputs, getter)(jcfg, ref_shape)
        assert ours.keys() == ref.keys()
        for k in ref:
            assert _struct(ours[k]) == _struct(ref[k]), k
        assert ours["tokens"].dtype == torch.int32
        return
    ours = I.decode_inputs(cfg, ours_shape)
    ref = jax_inputs.decode_inputs(jcfg, ref_shape)
    assert ours.keys() == ref.keys()
    for k in ("tokens", "pos", "index_embeds"):
        if k in ref:
            assert _struct(ours[k]) == _struct(ref[k]), k
    got = [{k: _struct(v) for k, v in layer.items()}
           for layer in ours["cache"]]
    assert got == _per_layer(jcfg, ref["cache"])
    if "cross_kv" in ref:
        got = {i: {k: _struct(v) for k, v in kv.items()}
               for i, kv in ours["cross_kv"].items()}
        assert got == _per_layer(jcfg, ref["cross_kv"])
        assert got


@pytest.mark.parametrize("arch", ARCHS)
def test_meta_model_holds_the_references_params(arch):
    """At full config and the arch's own mux width, every port tensor has
    the elements of its reference leaf (a stacked leaf's per group), no
    leaf is left over, and nothing is drawn."""
    cfg = torch_registry.get_config(arch)
    jcfg = jax_registry.get_config(arch)
    model = I.param_struct(cfg)
    ours = dict(model.named_parameters())
    assert all(p.device.type == "meta" for p in ours.values())
    tree = jax.eval_shape(lambda k: JaxBackbone.init(k, jcfg),
                          jax.random.PRNGKey(0))
    theirs = {jax_specs._path_str(p): int(np.prod(leaf.shape))
              for p, leaf in jax.tree_util.tree_leaves_with_path(tree)}
    groups = cfg.layer_pattern()[2]
    held = {}
    for name, (path, stacked, _) in reference_paths(cfg, ours).items():
        held[path] = held.get(path, 0) + ours[name].numel()
        assert ours[name].numel() * (groups if stacked else 1) == \
            theirs[path], (name, path)
    assert held == theirs
    assert sum(p.numel() for p in ours.values()) == sum(theirs.values())


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_and_long_500k_are_the_references(arch):
    cfg = torch_registry.get_config(arch)
    jcfg = jax_registry.get_config(arch)
    assert cfg.param_count() == jcfg.param_count()
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert torch_registry.long_500k_supported(arch) == \
        jax_registry.long_500k_supported(arch)


def test_state_struct_is_the_first_steps_state():
    """``state_struct``: the model, AdamW's float32 moments and its step on
    ``meta``, as the first train step adds them."""
    from repro_torch.training.trainer import TrainConfig, Trainer
    cfg = torch_registry.get_smoke_config("qwen1.5-4b", mux_n=2)
    tcfg = TrainConfig(task="lm", state_dtype="float32")
    state = I.state_struct(cfg, tcfg)
    params = Trainer.params(state)
    assert state["step"] == 0 and state["opt_state"]["step"] == 0
    for m in ("mu", "nu"):
        moments = state["opt_state"][m]
        assert moments.keys() == params.keys()
        for k, p in params.items():
            assert moments[k].shape == p.shape
            assert moments[k].dtype == torch.float32
            assert moments[k].device.type == "meta"

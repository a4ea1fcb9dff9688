"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, it runs on the GPU unless asked for the CPU, its configs follow
the reference's rules, its launcher serves the continuous modes and a mesh
and refuses what it does not serve, and its weight bridge covers every
parameter."""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.configs import registry as jax_registry
from repro_torch import device as device_mod
from repro_torch.configs import base as torch_base
from repro_torch.configs import registry as torch_registry
from repro_torch.launch import serve
from repro_torch.models import Backbone

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + \
    [ROOT / "chip_smoke.py"]
FORBIDDEN = {"jax", "jaxlib", "repro"}


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_repro(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            assert name.split(".")[0] not in FORBIDDEN, \
                f"{path.name}:{node.lineno} imports {name}"


def test_importing_the_port_loads_neither_jax_nor_repro():
    code = ("import sys, repro_torch.serving.scheduler, "
            "repro_torch.serving.paging, repro_torch.launch.serve, "
            "repro_torch.bridge, repro_torch.kernels.paged_attention.ops, "
            "repro_torch.kernels.attention.ops, repro_torch.data, "
            "repro_torch.training.trainer, repro_torch.serving.router, "
            "repro_torch.launch.train, repro_torch.checkpoint, "
            "repro_torch.optim; "
            "bad = sorted(m for m in sys.modules "
            "if m.split('.')[0] in ('jax', 'jaxlib', 'repro')); "
            "print(bad)")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, check=True,
                         env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.stdout.strip() == "[]"


def test_default_device_is_the_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device_mod.resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Backbone(torch_registry.get_smoke_config("qwen1.5-4b"))
    assert device_mod.resolve_device("cpu") == torch.device("cpu")


# The archs whose reference config sets ``remat`` itself
# (``src/repro/configs/*.py``); the others take the reference's default
# "dots", where the port takes its own default "none" (ROADMAP Queue C).
REMAT_SET_BY_CONFIG = {"deepseek-v3-671b", "jamba-1.5-large-398b",
                       "nemotron-4-340b", "llama4-scout-17b-a16e"}


@pytest.mark.parametrize("arch", sorted(torch_registry.ARCHS))
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_the_reference(arch, smoke):
    """Every field the port keeps has the reference's value, for the full
    configs and the smoke rules alike; a nested model config (an encoder)
    is compared the same way, over the fields the port keeps.  ``remat``
    is the reference's where its config or smoke rule sets it, and the
    port's "none" against the reference's "dots" where both take their
    defaults."""
    pkg = "get_smoke_config" if smoke else "get_config"
    kw = {"mux_n": 3} if smoke else {}
    ours = getattr(torch_registry, pkg)(arch, **kw)
    theirs = getattr(jax_registry, pkg)(arch, **kw)

    def same_fields(ours, theirs, remat_set):
        for f in dataclasses.fields(ours):
            mine, ref = getattr(ours, f.name), getattr(theirs, f.name)
            if isinstance(mine, torch_base.ModelConfig):
                same_fields(mine, ref, remat_set=False)
            elif dataclasses.is_dataclass(mine):
                assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
            elif f.name == "remat" and not remat_set:
                assert (mine, ref) == ("none", "dots"), f.name
            else:
                assert mine == ref, f.name
    same_fields(ours, theirs, smoke or arch in REMAT_SET_BY_CONFIG)
    assert ours.head_dim_ == theirs.head_dim_
    assert ours.mux.prefix_len == theirs.mux.prefix_len
    assert [k["mlp"] for k in ours.layer_kinds()] == \
        [k["mlp"] for k in theirs.layer_kinds()]


def test_config_validation_uses_the_port_registry():
    with pytest.raises(ValueError, match="registered"):
        torch_base.MuxConfig(n=2, strategy="no-such-mux")
    with pytest.raises(ValueError, match="binary mux"):
        dataclasses.replace(torch_registry.get_smoke_config("qwen1.5-4b"),
                            mux=torch_base.MuxConfig(n=3, strategy="binary"))
    with pytest.raises(ValueError, match="unknown model family 'speech'"):
        dataclasses.replace(torch_registry.get_smoke_config("qwen1.5-4b"),
                            family="speech")
    with pytest.raises(ValueError, match="page_size"):
        torch_base.ServingConfig(page_size=0)


@pytest.mark.parametrize("flags", [["--mesh-shape", "2,2"],
                                   ["--device-count", "2"]])
def test_serve_refuses_what_it_does_not_serve(flags, capfd):
    """A (2, 2) mesh serves on four spawned ``gloo`` ranks; two devices
    without a mesh shape are too few for the production mesh, as in the
    reference."""
    argv = ["--smoke", "--device", "cpu", "--mux-n", "2", "--batch", "2",
            "--prompt-len", "3", "--gen", "2", *flags]
    if "--mesh-shape" in flags:
        assert serve.main(argv) is None
        out = capfd.readouterr().out
        assert "on mesh {'data': 2, 'model': 2}" in out
        assert "4 streams x 2 tokens" in out
    else:
        with pytest.raises(RuntimeError,
                           match=r"mesh \(16, 16\) needs 256 devices, "
                                 r"have 2"):
            serve.main(argv)


@pytest.mark.parametrize("flags", [
    ["--workload", "poisson"],
    ["--workload", "poisson", "--paged", "--prefill-chunk", "2",
     "--use-kernel", "--mux-kernel", "--fuse-demux"],
    ["--paged"]])
def test_serve_runs_continuous_flags_on_cpu(flags, capsys):
    serve.main(["--smoke", "--device", "cpu", "--mux-n", "2", "--gen", "4",
                "--num-requests", "6", *flags])
    out = capsys.readouterr().out
    if "poisson" in flags:
        assert "[serve] continuous:" in out and "FAIL" not in out
    if "--paged" in flags and "poisson" in flags:
        assert "in use after drain" in out


def test_serve_runs_lockstep_on_cpu(capsys):
    out = serve.main(["--smoke", "--device", "cpu", "--mux-n", "2",
                      "--batch", "2", "--prompt-len", "3", "--gen", "2",
                      "--mux-kernel", "--fuse-demux"])
    assert tuple(out.shape) == (2, 2, 3)
    assert "4 streams x 2 tokens" in capsys.readouterr().out


def test_bridge_rejects_a_tree_of_another_depth():
    from repro_torch.bridge import params_from_jax
    cfg = torch_registry.get_smoke_config("qwen1.5-4b")
    with pytest.raises(ValueError, match="layers"):
        params_from_jax({"head_layers": [], "blocks": [], "tail_layers": [],
                         "embed": {"table": np.zeros((4, 2), np.float32)}},
                        cfg)

"""Boundaries of the PyTorch port: it imports neither JAX nor the JAX
package, it runs on the GPU unless asked for the CPU, its configs follow
the reference's rules, its launcher serves the continuous modes and refuses
what it does not serve yet, and its weight bridge covers every parameter."""
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
            "repro_torch.bridge, repro_torch.kernels.paged_attention.ops; "
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


@pytest.mark.parametrize("arch", sorted(torch_registry.ARCHS))
@pytest.mark.parametrize("smoke", [False, True])
def test_configs_match_the_reference(arch, smoke):
    """Every field the port keeps has the reference's value, for the full
    configs and the smoke rules alike."""
    pkg = "get_smoke_config" if smoke else "get_config"
    kw = {"mux_n": 3} if smoke else {}
    ours = getattr(torch_registry, pkg)(arch, **kw)
    theirs = getattr(jax_registry, pkg)(arch, **kw)
    for f in dataclasses.fields(ours):
        mine, ref = getattr(ours, f.name), getattr(theirs, f.name)
        if dataclasses.is_dataclass(mine):
            assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
        else:
            assert mine == ref, f.name
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
    with pytest.raises(ValueError, match="dense family"):
        dataclasses.replace(torch_registry.get_smoke_config("qwen1.5-4b"),
                            family="moe")
    with pytest.raises(ValueError, match="page_size"):
        torch_base.ServingConfig(page_size=0)


@pytest.mark.parametrize("flags", [["--replicas", "2"],
                                   ["--device-count", "2"]])
def test_serve_refuses_what_it_does_not_serve(flags):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        serve.main(["--smoke", "--device", "cpu", *flags])


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

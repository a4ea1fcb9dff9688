"""Fixtures of the benchmark's CPU tests.

    python -m pytest perfbench/tests -q

(from the root of the repo; the repo's own test run does not collect
these).  ``tiny_bench`` is a copy of the benchmark in a temporary
directory with every configuration cut to a tiny float32 size, its
offline traffic to 3 batches of 2 groups x 16 tokens, its serving to 2
slots of 128 positions (chunks of 8) serving prompts of 16-48 tokens,
each limit to a tenth (the copy computes in float32, the cells in
bfloat16), and ``harness`` pointed at it.  Tests marked ``cuda`` need the card and
skip without it, deciding inside the test.
"""
import json
import shutil
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]
for p in (str(REPO / "src"), str(REPO)):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY = {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 4,
        "d_ff": 96, "vocab": 512}


def pytest_configure(config):
    config.addinivalue_line("markers", "cuda: needs a CUDA card")


@pytest.fixture
def cuda_card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def make_tiny(root: Path) -> Path:
    """A tiny copy of the benchmark under ``root``; returns its
    ``perfbench`` directory."""
    bench = root / "perfbench"
    shutil.copytree(REPO / "perfbench", bench,
                    ignore=shutil.ignore_patterns("tests", "__pycache__"))
    shutil.copy(REPO / "BENCHMARK.json", root)
    (root / "src").symlink_to(REPO / "src")
    for path in (bench / "configs").glob("*.json"):
        c = json.loads(path.read_text())
        c["model"].update(TINY)
        c["mux"].update(n=4, demux_hidden=128)
        c["dtype"] = "float32"
        c["reduced"] = sorted(TINY)
        path.write_text(json.dumps(c))
    for path in (bench / "traffic").glob("*.json"):
        t = json.loads(path.read_text())
        if t["kind"] == "offline":
            t.update(groups=2, seq_len=16, batches=3)
        else:
            t.update(prompt_min=16, prompt_max=48, output_mean=6,
                     output_max=16, backlog=8, pool_requests=64)
        path.write_text(json.dumps(t))
    for path in (bench / "cells").glob("*.json"):
        c = json.loads(path.read_text())
        c.update(reference_groups=1, trace_seconds=0.3)
        # float32 here, bfloat16 on the card: a tenth of each limit
        c["limits"] = {k: v / 10 for k, v in c["limits"].items()}
        if "serving" in c:
            c["serving"].update(slots=2, max_len=128, pool_pages=40,
                                prefill_chunk=8)
            c.update(warm_steps=3, sampled_tokens=30)
        path.write_text(json.dumps(c))
    return bench


@pytest.fixture
def tiny_bench(tmp_path, monkeypatch):
    from perfbench import harness
    bench = make_tiny(tmp_path)
    monkeypatch.setattr(harness, "BENCH", bench)
    monkeypatch.setattr(harness, "ROOT", tmp_path)
    monkeypatch.setattr(harness, "SPEC", tmp_path / "BENCHMARK.json")
    return bench

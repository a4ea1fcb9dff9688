"""Finds a cell's pieces by name and runs the cell once.

A cell (``cells/<cell>.json``) names its configuration
(``configs/<config>.json``), its traffic (``traffic/<traffic>.json``),
its driver (``drivers/<driver>.py``) and the limits of its check.  The
metrics a run reports are those of ``BENCHMARK.json`` that apply to the
cell (``end_to_end`` untraced, ``per_layer`` traced; an entry with
``workloads`` applies to the cells it lists, one without to every cell),
each read by ``metrics/<metric>.py``: ``read(run)`` returns the number,
or None where the run has nothing to read.  Adding a cell, a
configuration, a traffic mix, a driver or a metric adds files and entries
only.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import subprocess
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
SPEC = ROOT / "BENCHMARK.json"

# Top-level module names the run may not hold once its window has closed:
# JAX and the JAX package, whose name the port's begins with.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def read_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(name: str) -> dict:
    return read_json(BENCH / "cells" / f"{name}.json")


def config(name: str) -> dict:
    return read_json(BENCH / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return read_json(BENCH / "traffic" / f"{name}.json")


def benchmark() -> dict:
    return read_json(SPEC)


def load(kind: str, name: str):
    """``<kind>/<name>.py`` as a module (names may hold dots)."""
    path = BENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    mod_name = f"perfbench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metrics_for(cell_name: str, traced: bool) -> list[dict]:
    entries = benchmark()["per_layer" if traced else "end_to_end"]
    return [m for m in entries
            if "workloads" not in m or cell_name in m["workloads"]]


def workload(cell_name: str) -> dict:
    """The cell's entry in ``BENCHMARK.json``, which has to agree with its
    file."""
    spec = cell(cell_name)
    for w in benchmark()["workloads"]:
        if w["name"] == cell_name:
            for key in ("config", "traffic", "chips"):
                if w[key] != spec[key]:
                    raise ValueError(f"{cell_name}: BENCHMARK.json says "
                                     f"{key}={w[key]!r}, its file "
                                     f"{spec[key]!r}")
            return spec
    raise KeyError(f"no workload {cell_name!r} in {SPEC}")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def prepare_env() -> None:
    """The program on the path, and every build and kernel cache at a
    fixed directory inside the checkout."""
    build = ROOT / "build"
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = str(build / "cuda_cache")
    os.environ["USE_FLAX"] = "0"     # no library of the run may load JAX
    for path in (str(ROOT / "src"), str(ROOT)):
        if path not in sys.path:
            sys.path.insert(0, path)


@dataclasses.dataclass
class Run:
    """What a metric reader sees of one run."""
    shapes: dict
    setup_s: float
    window_s: float
    items: list                  # the window's answers, as the driver keeps
    segment: object = None       # trace.Segment of a traced run
    driver: object = None        # the cell's driver, for what it records


def power_limit() -> str | None:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and \
        out.stdout.strip() else None


def run_cell(name: str, seed: int, seconds: float, traced: bool, *,
             device: str = "cuda", t0: float | None = None) -> dict:
    """One run of cell ``name``: set-up, the window, the traced segment
    (``traced``), then the check.  Returns the result object, its key
    ``compared`` last."""
    import gc

    import torch

    from perfbench import trace

    t0 = time.perf_counter() if t0 is None else t0
    spec = workload(name)
    cfg, tr = config(spec["config"]), traffic(spec["traffic"])
    cuda = torch.device(device).type == "cuda"
    driver = load("drivers", spec["driver"]).Driver(spec, cfg, tr, seed,
                                                    device)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    # No cycle collection inside the timed stretches: a pause of the
    # collector is the host's, not the program's.
    gc.collect()
    gc.freeze()
    gc.disable()
    try:
        items, window_s = driver.window(seconds)
        segment = None
        if traced:
            from perfbench import port
            segment = trace.record(driver.traced_step, spec["trace_seconds"],
                                   port.launches())
    finally:
        gc.enable()
        gc.unfreeze()
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    check = driver.check(items)
    run = Run(driver.shapes, setup_s, window_s, items, segment, driver)
    metrics = {}
    for m in metrics_for(name, traced):
        value = load("metrics", m["name"]).read(run)
        if value is None:
            if not traced:
                raise RuntimeError(f"{name}: the end-to-end metric "
                                   f"{m['name']} read nothing")
            continue
        metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": spec["chips"], "memory_peak_bytes": peak}
    if cuda:
        dev["power"] = power_limit()
    result = {"correct": check["correct"], "attempted": check["attempted"],
              "failed": check["failed"], "metrics": metrics, "device": dev}
    if segment is not None:
        dev["busy_s"], dev["window_s"] = segment.busy_s, segment.window_s
        result["breakdown"] = {"device_ops": segment.device_ops(),
                               "idle_gaps": segment.idle_gaps()}
    result["compared"] = {k: {"value": v, "limit": lim}
                          for k, v, lim in check["rows"]}
    return result

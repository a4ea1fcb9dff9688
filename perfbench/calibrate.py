#!/usr/bin/env python3
"""Readings that the limits of a cell's check are set from.

    python3 perfbench/calibrate.py --workload <cell> --seeds 1,2,... \
        --control-seeds 1,2,3 [--seconds 2]

For each seed, in one process: the cell's set-up, a short window at the
cell's own load, and the check's numbers of the program against the
float32 reference (the lower readings, over ``--seeds``); for each
control seed, the reference at float8 put in the program's place, held to
the same check (the upper readings).  One JSON
line per seed, then one with, for each number, the largest program
reading, the smallest control reading and their ratio.  The benchmark's
own runs never run this.
"""
import argparse
import gc
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    harness.prepare_env()
    import torch

    spec = harness.workload(args.workload)
    cfg = harness.config(spec["config"])
    tr = harness.traffic(spec["traffic"])
    driver_cls = harness.load("drivers", spec["driver"]).Driver
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    seeds = [int(s) for s in args.seeds.split(",")]
    lower, upper = {}, {}
    for seed in seeds + sorted(controls - set(seeds)):
        t0 = time.perf_counter()
        driver = driver_cls(spec, cfg, tr, seed, args.device)
        line = {"seed": seed, "setup_s": time.perf_counter() - t0}
        items, _ = driver.window(args.seconds)
        check = driver.check(items)
        line["program"] = {k: v for k, v, _ in check["rows"]}
        line["answers"] = check["attempted"]
        if seed in seeds:
            for k, v in line["program"].items():
                lower[k] = max(lower.get(k, 0.0), v)
        if seed in controls:
            check = driver.control("fp8")
            line["control"] = {k: v for k, v, _ in check["rows"]}
            for k, v in line["control"].items():
                upper[k] = min(upper.get(k, float("inf")), v)
        line["seconds"] = time.perf_counter() - t0
        print(json.dumps(line), flush=True)
        del driver
        gc.collect()
        if args.device == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"lower": lower, "upper": upper,
                      "ratio": {k: upper[k] / lower[k] for k in upper
                                if lower.get(k)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Runs one cell of the benchmark once, on the CUDA card(s) of this machine.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

From the root of a checkout.  ``--trace 0`` reports the cell's end-to-end
metrics, ``--trace 1`` its per-layer metrics from a traced segment after
the window.  The last line of standard output is one JSON object
(``correct``, ``attempted``, ``failed``, ``metrics``, ``device``, with
``--trace 1`` ``breakdown``, and last ``compared``: each number the check
compared, with its limit); the compared numbers are also the last lines of
standard error.  With no CUDA card, fewer cards than the cell asks for,
or JAX or the JAX package loaded once the window has closed, it exits with
a code other than 0 and prints no result.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from perfbench import harness  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    harness.prepare_env()
    spec = harness.workload(args.workload)
    import torch
    torch.set_num_threads(4)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < spec["chips"]:
        print(f"perfbench: {args.workload} needs {spec['chips']} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t0=T0)
    found = harness.forbidden_modules()
    if found:
        print(f"perfbench: the run loaded {found}, which the benchmark of "
              f"the port may not load", file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, row in result["compared"].items():
        print(f"compared {name} {row['value']!r} limit {row['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Print the port's dry-run records as a markdown table.

    python3 tools/dryrun_table.py [results/dryrun_torch]

One row per arch, one column per input shape; each cell gives the pod
(16, 16) and then the multipod (2, 16, 16) record of
``repro_torch.launch.dryrun`` as "<dominant term> <its seconds> s,
<bytes_per_device as a multiple of one card's 80 GB>x, <collective bytes
per rank>".  Every number is a prediction from meta tensors; no device
ran.
"""
from __future__ import annotations

import json
import sys
from pathlib import Path

CARD_BYTES = 80e9
SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
MESHES = ("pod", "multipod")


def _cell(r: dict | None) -> str:
    if r is None:
        return "missing"
    if r.get("skipped"):
        return f"skipped ({r['skipped']})"
    term = r["dominant"]
    return (f"{term} {r[term + '_s']:.3g} s, "
            f"{r['bytes_per_device'] / CARD_BYTES:.3g}x, "
            f"{r['collective_bytes']['total'] / 1e9:.3g} GB")


def rows(directory: Path) -> list[str]:
    recs = {}
    for p in sorted(directory.glob("*.json")):
        r = json.loads(p.read_text())
        recs[(r["arch"], r["shape"], r["mesh"])] = r
    out = ["| arch | " + " | ".join(SHAPES) + " |",
           "|---|" + "---|" * len(SHAPES)]
    for arch in sorted({a for a, _, _ in recs}):
        cells = []
        for shape in SHAPES:
            pair = [_cell(recs.get((arch, shape, m))) for m in MESHES]
            cells.append(pair[0] if pair[0] == pair[1]
                         else " / ".join(pair))
        out.append(f"| {arch} | " + " | ".join(cells) + " |")
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    directory = Path(argv[0] if argv else "results/dryrun_torch")
    print("\n".join(rows(directory)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The harness finds every piece by name, a new cell and metric are
picked up as new files alone, and each cell runs end to end on the CPU at
a tiny size."""
import json
import re

import pytest

from perfbench import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_every_named_piece_loads():
    spec = harness.benchmark()
    for c in spec["configs"]:
        cfg = harness.config(c["name"])
        assert cfg["name"] == c["name"]
        assert (harness.ROOT / c["file"]).is_file()
        assert cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        cell = harness.workload(w["name"])
        harness.traffic(cell["traffic"])
        assert hasattr(harness.load("drivers", cell["driver"]), "Driver")
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert callable(harness.load("metrics", m["name"]).read)


def test_names_units_and_cells():
    spec = harness.benchmark()
    cells = {w["name"] for w in spec["workloads"]}
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    for item in spec["configs"] + spec["workloads"] + spec["end_to_end"] \
            + spec["per_layer"]:
        assert NAME.match(item["name"]), item["name"]
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
    for m in spec["per_layer"]:
        assert m["moves"] in e2e
        for w in m["workloads"]:
            moved = next(e for e in spec["end_to_end"]
                         if e["name"] == m["moves"])
            assert w in moved.get("workloads", cells)
    for w in spec["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert harness.metrics_for(w["name"], False)
        assert harness.metrics_for(w["name"], True)


HOST_READINGS = {"tmux-cls": {"mfu.offline"}, "qwen-score": {"mfu.offline"},
                 "qwen-serve": {"mfu.serve", "ttft_admit_p95_ms.serve",
                                "itl_p95_ms.serve"}}


@pytest.mark.parametrize("traced", [False, True])
@pytest.mark.parametrize("cell", ["tmux-cls", "qwen-score", "qwen-serve"])
def test_cell_runs_on_cpu(tiny_bench, cell, traced):
    seconds = 1.5 if cell == "qwen-serve" else 0.3
    result = harness.run_cell(cell, 2 ** 31 + 11, seconds, traced,
                              device="cpu")
    assert result["correct"] is True and result["failed"] == 0
    assert result["attempted"] >= 3
    want = {m["name"] for m in harness.metrics_for(cell, traced)}
    if traced:          # the CPU has no device trace: only host readings
        assert set(result["metrics"]) == HOST_READINGS[cell]
        assert "breakdown" in result
    else:
        assert set(result["metrics"]) == want
        assert all(m["value"] > 0 for m in result["metrics"].values())
    assert list(result)[-1] == "compared"
    assert set(result["compared"]) == set(harness.cell(cell)["limits"])


def test_seed_gives_the_same_inputs(tiny_bench):
    from perfbench import traffic
    spec = harness.cell("qwen-score")
    cfg, tr = harness.config(spec["config"]), harness.traffic(spec["traffic"])
    a = traffic.offline_batches(tr, cfg, 2 ** 31 + 5, "cpu")
    b = traffic.offline_batches(tr, cfg, 2 ** 31 + 5, "cpu")
    c = traffic.offline_batches(tr, cfg, 2 ** 31 + 6, "cpu")
    assert all((x["tokens"] == y["tokens"]).all() for x, y in zip(a, b))
    assert any((x["tokens"] != y["tokens"]).any() for x, y in zip(a, c))
    assert [x["tokens"].shape for x in a] == [x["tokens"].shape for x in c]


def test_new_cell_and_metric_are_new_files(tiny_bench):
    """A cell, its traffic and a per-layer metric added as new files (and
    entries in BENCHMARK.json) run with no edit to any existing file."""
    before = {p: p.read_bytes() for p in tiny_bench.rglob("*") if p.is_file()}
    (tiny_bench / "traffic" / "cls-64.json").write_text(json.dumps(
        {"kind": "offline", "task": "cls", "n_classes": 5, "groups": 2,
         "seq_len": 8, "batches": 2}))
    cell = json.loads((tiny_bench / "cells" / "tmux-cls.json").read_text())
    cell.update(name="tmux-cls-short", traffic="cls-64")
    (tiny_bench / "cells" / "tmux-cls-short.json").write_text(
        json.dumps(cell))
    (tiny_bench / "metrics" / "answers_per_s.new.py").write_text(
        "def read(run):\n    return len(run.items) / run.window_s\n")
    spec_path = harness.SPEC
    spec = json.loads(spec_path.read_text())
    spec["workloads"].append({"name": "tmux-cls-short",
                              "config": "tmux-12l-768h", "traffic": "cls-64",
                              "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if "workloads" in m:
            m["workloads"].append("tmux-cls-short")
    spec["per_layer"].append({
        "name": "answers_per_s.new", "unit": "1/s", "better": "higher",
        "source": "host_clock", "layer": "Device",
        "moves": "instances_per_s", "workloads": ["tmux-cls-short"]})
    spec_path.write_text(json.dumps(spec))
    result = harness.run_cell("tmux-cls-short", 7, 0.2, True, device="cpu")
    assert result["correct"] and result["metrics"]["answers_per_s.new"][
        "value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


def test_backlog_sizes_are_the_seeds_alike():
    from perfbench import traffic
    spec = harness.traffic("qa-backlog")
    sizes = traffic.backlog_sizes(spec)
    assert len(sizes) == spec["pool_requests"]
    assert all(spec["prompt_min"] <= p <= spec["prompt_max"] and
               1 <= o <= spec["output_max"] for p, o in sizes)
    cfg = harness.config("qwen1.5-4b-mux8")
    n = len(sizes)
    a = [next(g) for g in [traffic.backlog(spec, cfg, 1)] for _ in range(n)]
    b = [next(g) for g in [traffic.backlog(spec, cfg, 2 ** 31 + 1)]
         for _ in range(n)]
    assert sorted((len(p), o) for p, o in a) == sorted(sizes) == \
        sorted((len(p), o) for p, o in b)
    assert [len(p) for p, _ in a] != [len(p) for p, _ in b]

"""The ``serve_backlog`` driver: ``ContinuousScheduler.step`` over the
paged ``Engine``, kept full from a backlog.

Set-up makes the weights from the seed, builds the scheduler (the cell's
``serving``: slots, positions a slot, page pool, chunk, kernels) over
them, and runs ``warm_steps`` steps of the traffic.  Before every step the
closed loop tops the queue up to ``backlog`` waiting requests.  Each step
is timed on the host clock; the tokens it emitted are counted.

The driver keeps the tape a reference needs to follow a slot: the
positions, chunk rows, lane tokens and lane masks every step fed the
engine (read from ``Engine.step``'s arguments), and every token emitted
(slot, lane, step, request).  Where the program mixes the lanes of a slot
is its own scheduling, which the reference follows; everything else it
recomputes.

The check (``check``) samples, from the seed, requests finished in the
window (the longest among them) until ``sampled_tokens`` served tokens,
frees the program's state, and runs the float32 reference over each
sampled request's slot from the slot's last reset to the request's last
token: for every served token, the gap by which the reference's logit of
that token lies below its best logit (``served_gap``, the widest).
"""
from __future__ import annotations

import gc
import math
import random
import time

import numpy as np
import torch

from perfbench import port, traffic as generator, weights as weight_maker
from perfbench.reference import compare
from perfbench.reference.model import Reference, no_tf32, param_specs


class Driver:
    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.weights = weight_maker.make(
            param_specs(config["model"], config["mux"], {"task": "lm"}),
            seed, self.device, port.torch_dtype(config))
        self.cfg = port.model_config(config)
        self.sched = port.serve_scheduler(self.cfg, self.weights,
                                          cell["serving"])
        self.prefix = self.cfg.mux.prefix_len
        self.engine = self.sched.classes[0].engine
        self.tape = []         # per engine step: pos, valid, tokens, contrib
        self.emits = []        # (step, slot, lane, rid, token)
        self.steps = []        # per scheduler step: host start, end, tokens
        self.keys = np.full(cell["serving"]["slots"], self.prefix)
        self._instrument()
        self.requests = generator.backlog(traffic, config, seed)
        self.rid = 0
        m, mux = config["model"], config["mux"]
        self.shapes = dict(
            d_model=m["d_model"], head_dim=self.cfg.head_dim_,
            n_heads=m["n_heads"], n_kv_heads=m["n_kv_heads"], d_ff=m["d_ff"],
            vocab=m["vocab"], n_layers=m["n_layers"], gated_mlp=m["gated_mlp"],
            demux_hidden=mux.get("demux_hidden") or 2 * m["d_model"],
            n=mux["n"], dtype=config["dtype"],
            slots=cell["serving"]["slots"],
            chunk=cell["serving"]["prefill_chunk"])
        for _ in range(cell["warm_steps"]):
            self.step()
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.trace_from = self.trace_to = None

    # -- the tape ---------------------------------------------------------------

    def _instrument(self) -> None:
        """Record ``Engine.step``'s inputs and the scheduler's emissions;
        neither changes what they do."""
        engine_step = self.engine.step
        emit = self.sched._emit

        def recorded_step(state, tokens, lane_mask=None, block_table=None,
                          chunk_lens=None):
            pos = np.asarray(state.pos).astype(np.int64).copy()
            valid = np.asarray(chunk_lens).astype(np.int64).copy()
            contrib = np.asarray(lane_mask) > 0            # (B, N, C)
            live = contrib.any(axis=(1, 2))
            rows_keys = []
            for s in np.flatnonzero(live):
                if pos[s] == self.prefix:                  # a reset slot
                    self.keys[s] = self.prefix
                rows_keys.append((int(valid[s]), int(self.keys[s])))
                self.keys[s] += valid[s]
            self.tape.append({"pos": pos, "valid": valid, "live": live,
                              "tokens": np.asarray(tokens).copy(),
                              "contrib": contrib, "rows_keys": rows_keys})
            return engine_step(state, tokens, lane_mask=lane_mask,
                               block_table=block_table, chunk_lens=chunk_lens)

        def recorded_emit(req, lane_logits, s, lane, released):
            emit(req, lane_logits, s, lane, released)
            self.emits.append((len(self.tape) - 1, s, lane, req.rid,
                               req.output[-1]))

        self.engine.step = recorded_step
        self.sched._emit = recorded_emit

    # -- the timed path -----------------------------------------------------------

    def step(self) -> None:
        """Top the queue up to the backlog, then one scheduler step."""
        sched = self.sched
        while sched._waiting() < self.traffic["backlog"]:
            prompt, out = next(self.requests)
            req = port.request(self.rid, prompt, out)
            req.arrival = sched.t
            sched.submit(req)
            self.rid += 1
        emitted = len(self.emits)
        start = time.perf_counter()
        sched.step()
        end = time.perf_counter()
        self.steps.append({"start": start, "end": end,
                           "tokens": len(self.emits) - emitted,
                           "tape": len(self.tape) - 1})

    def window(self, seconds: float) -> tuple[list, float]:
        t0 = time.perf_counter()
        first = len(self.steps)
        while True:
            self.step()
            if self.steps[-1]["end"] - t0 >= seconds:
                break
        items = [dict(s, start=s["start"] - t0, end=s["end"] - t0)
                 for s in self.steps[first:]]
        self.window_steps = (first, len(self.steps))
        self.ttft_ms, self.itl_ms = self.latencies()
        return items, items[-1]["end"]

    def traced_step(self) -> None:
        from torch.profiler import record_function
        if self.trace_from is None:
            self.trace_from = len(self.steps)
        with record_function("bench.step"):
            self.step()
        self.trace_to = len(self.steps)

    def traced_items(self) -> list:
        if self.trace_from is None:
            return []
        return self.steps[self.trace_from:self.trace_to]

    # -- host-clock latencies -------------------------------------------------------

    def latencies(self) -> tuple[list, list]:
        """(ms from admission to first token, ms between a request's
        consecutive tokens), for tokens emitted in the window; a token's
        time is the end of the step that emitted it, an admission's the
        start of the step that admitted it."""
        lo, hi = self.window_steps
        tape_step = {s["tape"]: i for i, s in enumerate(self.steps)}
        by_rid = {}
        for t, _, _, rid, _ in self.emits:
            by_rid.setdefault(rid, []).append(tape_step[t])
        ttft, itl = [], []
        reqs = self.sched.requests
        for rid, steps in by_rid.items():
            req = reqs[rid]
            admit = req.admitted_step
            if lo <= steps[0] < hi and 0 <= admit < len(self.steps):
                ttft.append((self.steps[steps[0]]["end"] -
                             self.steps[admit]["start"]) * 1e3)
            for a, b in zip(steps, steps[1:]):
                if lo <= b < hi:
                    itl.append((self.steps[b]["end"] -
                                self.steps[a]["end"]) * 1e3)
        return ttft, itl

    # -- the check ------------------------------------------------------------------

    def sampled(self) -> list[int]:
        """Requests finished in the window: the longest, then others in an
        order drawn from the seed, until ``sampled_tokens`` served tokens."""
        lo, hi = self.window_steps
        done = [r for r in self.sched.finished
                if lo <= r.finished_step < hi]
        if not done:
            return []
        longest = max(done, key=lambda r: (len(r.output), -r.rid))
        rest = [r for r in done if r is not longest]
        random.Random(self.seed).shuffle(rest)
        picked, tokens = [longest.rid], len(longest.output)
        for r in rest:
            if tokens >= self.cell["sampled_tokens"]:
                break
            picked.append(r.rid)
            tokens += len(r.output)
        return picked

    def release(self) -> None:
        """Free the program's state: the scheduler, its engine, model and
        page pool (the weights are the benchmark's)."""
        self.requests_served = dict(self.sched.requests)
        del self.sched, self.engine
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def epoch_start(self, slot: int, step: int) -> int:
        """The engine step at which slot ``slot`` last started from its
        prefix, at or before ``step``."""
        while step > 0 and self.tape[step]["pos"][slot] != self.prefix:
            step -= 1
        return step

    def slot_stream(self, slot: int, start: int, until: int) -> tuple:
        """The rows slot ``slot`` wrote in engine steps ``start``..``until``:
        (tokens (R, N), contrib (R, N), positions (R,), {(step, row):
        index}); steps in which the slot had no live lane are left out
        (they write no page)."""
        toks, contrib, pos, where = [], [], [], {}
        for t in range(start, until + 1):
            rec = self.tape[t]
            if not rec["live"][slot]:
                continue
            for r in range(int(rec["valid"][slot])):
                where[(t, r)] = len(pos)
                toks.append(rec["tokens"][slot, :, r])
                contrib.append(rec["contrib"][slot, :, r])
                pos.append(int(rec["pos"][slot]) + r)
        dev = self.device
        return (torch.as_tensor(np.stack(toks), dtype=torch.long, device=dev),
                torch.as_tensor(np.stack(contrib), device=dev),
                torch.as_tensor(pos, dtype=torch.long, device=dev), where)

    def served(self, rids: list) -> dict:
        """{(slot, first engine step of its stream): [(engine step, lane,
        row, token)]}: the sampled requests' served tokens, grouped by the
        slot stream a reference has to follow."""
        rids = set(rids)
        groups = {}
        for t, s, lane, rid, tok in self.emits:
            if rid in rids:
                row = int(self.tape[t]["contrib"][s, lane].sum()) - 1
                groups.setdefault((s, self.epoch_start(s, t)), []).append(
                    (t, lane, row, tok))
        return groups

    def gaps(self, ref, low=None, rids=()) -> float:
        """The widest gap over the served tokens of ``rids`` by which
        ``ref``'s logit of the token lies below its best; with ``low`` (the
        reference at a lower precision), of the token ``low`` puts first."""
        widest = 0.0
        with torch.inference_mode():
            for (slot, start), toks in self.served(rids).items():
                last = max(t for t, *_ in toks)
                tokens, contrib, pos, where = self.slot_stream(slot, start,
                                                               last)
                h, index = ref.stream(tokens, contrib, pos)
                if low is not None:
                    h_low, index_low = low.stream(tokens, contrib, pos)
                for lane in sorted({lane for _, lane, _, _ in toks}):
                    mine = [(t, row, tok) for t, ln, row, tok in toks
                            if ln == lane]
                    rows = torch.tensor([where[(t, row)] for t, row, _ in mine],
                                        device=h.device)
                    logits = ref.logits(ref.demux(
                        h[None, rows], index[None, lane:lane + 1])[0, 0])
                    if low is None:
                        picked = torch.tensor([tok for *_, tok in mine],
                                              device=h.device)
                    else:
                        picked = low.logits(low.demux(
                            h_low[None, rows],
                            index_low[None, lane:lane + 1])[0, 0]).argmax(-1)
                    gap = logits.max(-1).values - \
                        logits.gather(-1, picked[:, None])[:, 0]
                    widest = max(widest, float(gap.max()))
        return widest if math.isfinite(widest) else math.inf

    def check(self, items: list) -> dict:
        self.rids = self.sampled()
        self.release()
        return self.judge(self.rids)

    def control(self, precision: str) -> dict:
        """The check's number with the reference at ``precision`` in the
        program's place (after ``check``)."""
        return self.judge(self.rids, precision)

    def judge(self, rids: list, control: str | None = None) -> dict:
        no_tf32()
        ref = Reference(self.config, self.weights, "fp32")
        low = Reference(self.config, self.weights, control) \
            if control else None
        served = sum(len(self.requests_served[r].output) for r in rids)
        gap = self.gaps(ref, low, rids) if rids else math.inf
        correct, rows = compare.verdict({"served_gap": gap},
                                        self.cell["limits"])
        return {"correct": correct, "rows": rows,
                "attempted": sum(s["tokens"] for s in
                                 self.steps[slice(*self.window_steps)]),
                "failed": 0 if correct else served, "served": served}

"""The ``offline`` driver: batches back to back through
``Trainer.make_eval_step``.

Set-up makes the weights and the traffic's distinct batches from the
seed, builds the program's evaluation state over those weights and runs
the step twice (the one shape the window uses).  The window cycles
through the batches; each answer (the step's metrics) is brought to the
host before the next batch starts, and is timed from the call until then.

The check (``check``) replays the sampled batches through the same step
and state, holding the model's output (the demuxed states, and for the
``lm`` task the logits) as the program produced it, frees the program's
state and then runs the float32 reference over every batch: each answer
of the window against the reference's losses, each sampled instance's
demuxed states and logits against the reference's.
"""
from __future__ import annotations

import gc
import math
import random
import time

import torch

from perfbench import port, traffic as generator, weights as weight_maker
from perfbench.reference import compare
from perfbench.reference.model import Reference, no_tf32, param_specs

KEYS = ("task_loss", "retr_loss", "acc", "loss")


class Driver:
    def __init__(self, cell: dict, config: dict, traffic: dict, seed: int,
                 device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.task = {"task": traffic["task"],
                     "n_classes": traffic.get("n_classes", 0)}
        self.weights = weight_maker.make(
            param_specs(config["model"], config["mux"], self.task), seed,
            self.device, port.torch_dtype(config))
        self.cfg = port.model_config(config)
        self.state, self.step = port.eval_state(
            self.cfg, self.task, self.weights,
            use_flash=config.get("use_flash", False))
        self.batches = generator.offline_batches(traffic, config, seed,
                                                 self.device)
        m, mux = config["model"], config["mux"]
        self.shapes = dict(
            groups=traffic["groups"], n=mux["n"], seq_len=traffic["seq_len"],
            prefix=self.cfg.mux.prefix_len, d_model=m["d_model"],
            head_dim=self.cfg.head_dim_, n_heads=m["n_heads"],
            n_kv_heads=m["n_kv_heads"], d_ff=m["d_ff"], vocab=m["vocab"],
            n_layers=m["n_layers"], gated_mlp=m["gated_mlp"],
            causal=m["causal"], demux_hidden=mux.get("demux_hidden") or
            2 * m["d_model"], task=self.task["task"],
            n_classes=self.task["n_classes"],
            retrieval_alpha=mux["retrieval_alpha"], dtype=config["dtype"],
            instances=traffic["groups"] * mux["n"])
        for i in range(2):                       # the window's one shape
            self.answer(i % len(self.batches))
        self.next = 0

    # -- the timed path -------------------------------------------------------

    def run_step(self, i: int) -> dict:
        """Batch ``i`` through the step: its metrics, on the card."""
        batch = self.batches[i]
        inputs = {k: v for k, v in batch.items() if k != "index"}
        return self.step(self.state, inputs, None, retr_index=batch["index"])

    @staticmethod
    def to_host(metrics: dict) -> list[float]:
        return torch.stack([metrics[k].float() for k in KEYS]).tolist()

    def answer(self, i: int) -> list[float]:
        """Batch ``i`` through the step; its metrics on the host."""
        return self.to_host(self.run_step(i))

    def window(self, seconds: float) -> tuple[list, float]:
        """Answers back to back until ``seconds`` have passed: (items,
        the window's seconds, to the end of its last answer)."""
        items, t0 = [], time.perf_counter()
        while True:
            i = self.next
            self.next = (self.next + 1) % len(self.batches)
            start = time.perf_counter()
            values = self.answer(i)
            end = time.perf_counter()
            items.append({"start": start - t0, "end": end - t0, "batch": i,
                          "answer": values,
                          "instances": self.shapes["instances"]})
            if end - t0 >= seconds:
                return items, end - t0

    def traced_step(self):
        """``answer`` of the next batch, in the profiler's ranges."""
        from torch.profiler import record_function
        i = self.next
        self.next = (self.next + 1) % len(self.batches)
        with record_function("bench.step"):
            metrics = self.run_step(i)
        with record_function("bench.to_host"):
            self.to_host(metrics)

    # -- the check -------------------------------------------------------------

    def sampled(self) -> list[int]:
        """The batches whose outputs are compared whole, drawn from the
        seed."""
        k = min(self.cell["sampled_batches"], len(self.batches))
        return sorted(random.Random(self.seed).sample(
            range(len(self.batches)), k))

    def program_outputs(self) -> dict:
        """The model's outputs in the sampled batches, as the step makes
        them (held at the model's output by a forward hook)."""
        held, outputs = {}, {}
        keep = ("demuxed", "logits") if self.task["task"] == "lm" \
            else ("demuxed",)

        def hook(module, args, out):
            held.update({k: out[k] for k in keep})

        handle = self.state["model"].register_forward_hook(hook)
        try:
            for i in self.sampled():
                self.answer(i)
                outputs[i] = dict(held)
                held.clear()
        finally:
            handle.remove()
        return outputs

    def release(self) -> None:
        """Free the program's state (the weights are the benchmark's)."""
        del self.state, self.step
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self, items: list) -> dict:
        outputs = self.program_outputs()
        self.release()
        answers = {}
        for it in items:
            answers.setdefault(it["batch"], []).append(it["answer"][:2])
        return self.judge(answers, outputs)

    def control(self, precision: str) -> dict:
        """The check's numbers with the reference at ``precision`` put in
        the program's place: its answers for every batch and its outputs
        in the sampled ones."""
        ref = Reference(self.config, self.weights, precision)
        answers, outputs = {}, {}
        sampled = self.sampled()
        with torch.inference_mode():
            for bi in range(len(self.batches)):
                losses, demuxed = self._reference_batch(ref, bi)
                answers[bi] = [losses]
                if bi in sampled:
                    outputs[bi] = {"demuxed": demuxed}
                    if self.task["task"] == "lm":
                        outputs[bi]["logits"] = ref.logits(demuxed)
        return self.judge(answers, outputs)

    def _reference_batch(self, ref, bi: int, judge=None):
        """(task loss, retrieval loss) of batch ``bi`` by ``ref`` in blocks
        of groups; ``judge(g0, demuxed block)`` sees each block.  Returns
        the whole demuxed tensor too when no judge is given."""
        batch = self.batches[bi]
        block = self.cell["reference_groups"]
        sums = [0.0, 0, 0.0, 0]
        parts = []
        for g0 in range(0, self.shapes["groups"], block):
            g = slice(g0, g0 + block)
            dm = ref.demuxed(batch["tokens"][g])
            labels = batch["labels"][g] if "labels" in batch else None
            out = ref.losses(dm, batch["tokens"][g], self.task,
                             labels=labels, index=batch["index"][g])
            sums = [a + b for a, b in zip(sums, out)]
            if judge is not None:
                judge(g0, dm)
            else:
                parts.append(dm)
        task = sums[0] / sums[1]
        retr = sums[2] / sums[3] if sums[3] else 0.0
        return (task, retr), (torch.cat(parts) if parts else None)

    def judge(self, answers: dict, outputs: dict) -> dict:
        """The numbers compared: each answer's losses against the float32
        reference's (the widest gap over the answers), and each sampled
        instance's demuxed states and logits (the widest gap over the
        instances)."""
        no_tf32()
        ref = Reference(self.config, self.weights, "fp32")
        gaps = {"task_loss_gap": 0.0, "retr_loss_gap": 0.0,
                "demux_gap": 0.0}
        if self.task["task"] == "lm":
            gaps["logit_gap"] = 0.0
        failed = 0
        limits = self.cell["limits"]
        with torch.inference_mode():
            for bi in range(len(self.batches)):
                out = outputs.get(bi)

                def judge(g0, dm, out=out):
                    if out is None:
                        return
                    g = slice(g0, g0 + dm.shape[0])
                    gaps["demux_gap"] = max(gaps["demux_gap"],
                                            compare.widest_instance_gap(
                                                out["demuxed"][g], dm))
                    if "logits" in out:
                        gaps["logit_gap"] = max(
                            gaps["logit_gap"], self._logit_gap(
                                ref, out["logits"][g], dm))

                (task, retr), _ = self._reference_batch(ref, bi, judge)
                for prog_task, prog_retr in answers.get(bi, []):
                    t = compare.scalar_gap(prog_task, task)
                    r = compare.scalar_gap(prog_retr, retr)
                    gaps["task_loss_gap"] = max(gaps["task_loss_gap"], t)
                    gaps["retr_loss_gap"] = max(gaps["retr_loss_gap"], r)
                    failed += not (t <= limits["task_loss_gap"] and
                                   r <= limits["retr_loss_gap"])
        if set(outputs) != set(self.sampled()):
            gaps["demux_gap"] = math.inf
        correct, rows = compare.verdict(gaps, limits)
        attempted = sum(len(v) for v in answers.values())
        return {"correct": correct and failed == 0, "rows": rows,
                "attempted": attempted, "failed": failed}

    @staticmethod
    def _logit_gap(ref, prog_logits, dm) -> float:
        """The widest instance gap of the logits, one instance at a time."""
        b, n = dm.shape[:2]
        if tuple(prog_logits.shape[:2]) != (b, n):
            return math.inf
        return max(compare.tensor_gap(prog_logits[g, i], ref.logits(dm[g, i]))
                   for g in range(b) for i in range(n))

#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, any failure of which ends the run with a non-zero exit:

  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc
     (sm_90a) and print each one's registers and spills (ptxas -v) and
     its HGMMA / UTMALDG count (cuobjdump -sass), failing if a Hopper
     bf16 body (TMA + wgmma) has none of either or the paged kernel no
     UTMALDG; then hold each kernel against its plain PyTorch version on
     the card (run in float32 on the same inputs), in bf16 and f32, at the
     slices' shapes (the decode demux at C = 1 and C = 4) and at ragged
     ones (flash attention also with keys past Lk planted in memory; the
     paged attention also at 64 pages per slot, with a split of the
     block table all unmapped next to planted pages, and at every limit
     the previous kernel had: 17, 64 and 256 query rows, kblock 16 against
     1, head dims 36, 80, 192 and 256, pages of 512 rows; flash attention
     also at head dims 32, 80, 96, 192 and 256 and the attention shapes of
     gemma3-4b and nemotron-4-340b), naming the body or
     split the launch plan chose, and time both with CUDA events (the
     attention kernels also beside ``scaled_dot_product_attention``, a
     yardstick the port never calls);
  3. the lock-step slice: serve ``tmux-12l-768h`` at full width and N=40 in
     bf16 (random weights from --seed) through ``Engine.generate`` with the
     fused mux, demux and decode-demux kernels on, counting each kernel's
     launches in that run; then teacher-force the same tokens through an
     engine with the kernels off and compare prefill and first-step logits;
  4. the paged slice: ``ContinuousScheduler`` serves a 160-request Poisson
     trace on the same model with the paged KV pool (page_size 16) and the
     paged decode-attention, mux and decode-demux kernels, counting their
     launches; the same trace through a contiguous scheduler with every
     kernel off must give the same decode steps and tokens, and logits
     within LOGIT_TOL for the steps no sampled token was fed back in; a
     paged run with every kernel off must give the same slot resets and
     peak pages; then a profile of one scheduler step, a short run at
     prefill_chunk=4 (the kernel's C > 1 form), and the same 40 requests
     at prefill_chunk=17 and kblock_pages=16 (two row groups, a K-block
     width the previous kernel refused) held against the plain path:
     equal steps, tokens and peak pages, teacher-forced logits within
     LOGIT_TOL and greedy tokens equal where the margin is clear;
  5. the evaluation slice: ``qwen1.5-4b`` at full width, N=8, bf16 (random
     weights from --seed), ``Backbone(use_flash=True)`` with the mux and
     demux kernels, evaluates three batches of the retrieval task (2 x 8
     sequences of 1024 tokens) through ``Trainer.make_eval_step`` (task
     "lm", retrieval alpha 0.1), counting the flash, mux and demux
     launches; the same weights on the plain path (no flash, no kernels)
     must give batch 0's logits within LOGIT_TOL and every batch's task and
     retrieval losses within EVAL_LOSS_TOL (the same retrieval index fed
     to both); then eval-step times kernels on and off in turns and a
     profile of one step;
  6. the replica router: the paged slice's model and trace through
     ``ReplicaRouter`` (batch 8 per replica, each with its own page pool,
     the mux, fused decode-demux and paged kernels on): an R = 1
     round-robin router must give the bare scheduler's tokens, decode
     steps and TTFTs; R = 2 least_loaded with the kernels must give the
     plain path's router and decode steps, tokens, dispatch and requeues,
     and teacher-forced logits within LOGIT_TOL (greedy tokens equal where
     the margin is clear), counting the kernels' launches; the second
     replica may add to ``torch.cuda.memory_allocated`` no more than its own
     cache, pool and primed prefix (+5%): the weights are held once;
  7. the training half: ``Trainer.make_train_step`` on ``tmux-12l-768h``
     at full width, bf16, the retrieval task (8 groups x 40 x 128
     tokens, lr 3e-3, warm-up 1), 10 steps with finite loss and grad norm,
     their times and peak memory, a profile of one step and of the
     optimizer update alone; a 2-layer, d 256 f32 config trained 3 steps
     on the card and on the CPU (losses within 1e-4 relative, first
     grads within 1e-4 x max|g|); the trained weights evaluated through a
     ``Backbone.with_config`` view with the mux and demux kernels against
     the plain path (losses within EVAL_LOSS_TOL, launches counted); and
     ``make_train_step`` refusing a kernel-on config;
 7b. the mesh: a world-1 ``nccl`` group and the (1, 1) mesh of
     ``launch.mesh.make_test_mesh``: three train steps of tmux-12l-768h
     at full width (bf16, the retrieval task, 8 x 40 x 128) through
     ``make_train_step(mesh=)``, the state placed by
     ``sharding.state_specs``, bitwise three plain steps (loss, every
     parameter and moment), the rank's bytes of parameters and moments
     equal to its specs' count; lock-step ``Engine.generate`` on the mesh
     (B 8, N 40, prompt 64, 16 tokens) with the mux, demux and
     decode-demux kernels bitwise the run without a mesh (tokens, prefill
     and step logits), the kernels' launches counted; train and decode
     step wall ms with and without the mesh, in turns; llama4-scout's
     expert-parallel MoE block at full width (d 5120, 16 experts of 8192
     top-1, a shared expert, bf16) through its shard path on the mesh
     (all-to-all and sums issued over the size-1 ``nccl`` groups) bitwise
     the unsharded block at a decode (B 8, L 1) and a prefill (B 8, L 40)
     block, device ms of each; kernels-on lock-step ``Engine.generate`` of
     llama4-scout (2 of 48 layers, N=8) on the mesh bitwise the run
     without it; one train step of llama4-scout at one layer on the mesh
     bitwise the plain step (loss, every parameter and moment); then
     ``launch/train.py`` and ``launch/serve.py`` with ``--mesh-shape
     1,1`` as subprocesses.  One card: no collective moves a byte, and the
     multi-rank algebra is held by the CPU tests
     (``tests/test_torch_distributed.py``);
 7c. the dry-run (``launch/dryrun.py``: one rank's step on meta tensors
     over a fake process group): (a) its CLI for deepseek-v3-671b's
     train_4k step on the (2, 16, 16) mesh and llama4-scout's decode_32k
     step on the (16, 16) mesh, each a subprocess, every record key
     present, the dominant term, bytes per device and collective bytes
     printed; (b) its (1, 1) records of tmux-12l-768h at the ``[train]``
     shape (8 x 40 x 128, task "lm") with remat "none" and "full" against
     the same step on the card through ``make_train_step(mesh=)`` on the
     world-1 ``nccl`` mesh (the plain path, as the dry-run traces it):
     the ``FlopCounterMode`` FLOPs of a step equal, the peak
     ``max_memory_allocated`` of three steps within 15% of the record's
     ``bytes_per_device``, the predicted max(compute_s, memory_s) beside
     the median step time (taken once the subprocesses are done);
  8. the sliding window: ``gemma3-4b`` at full width and depth (34 layers:
     29 local with rings of 1024 rows, 5 global), N=8, bf16 (random weights
     from --seed), served by ``ContinuousScheduler`` on the paged pool
     (page_size 16, 4 slots, max_len 2048, prefill_chunk 64) with the mux,
     both demux and the paged kernels: 14 requests of 1100-1500 prompt
     tokens (every ring wraps), 32 new tokens each; the allocator's layer
     split (global layers paged, local layers ringed), pool and ring bytes
     and peak memory; the same trace through a contiguous scheduler with
     every kernel off, replaying the kernel run's sampled tokens so that
     every step is teacher-forced, must give the same decode steps and
     tokens, every step's logits within LOGIT_TOL and the plain path's own
     greedy picks equal wherever the margin is clear; then a profile of a
     scheduler step; before it, a
     lock-step ``Engine.prefill`` of 1200-token prompts (past the rings,
     through the index-embed demux) and one step against the plain path;
  9. the rest of the dense family through flash: ``gemma3-4b`` (all 34
     layers, L 1280, past its window), ``gemma-7b`` (4 of 28 layers, L 512)
     and ``nemotron-4-340b`` (2 of 96 layers, L 256; 37 GB of bf16
     weights), N=8, B 1, evaluated through ``Trainer.make_eval_step`` with
     ``Backbone(use_flash=True)`` (flash on the global layers, at head dims
     256 and 192) and the mux and demux kernels, against a ``with_config``
     view on the same weights with every kernel off (logits within
     LOGIT_TOL, losses within EVAL_LOSS_TOL), eval-step times on and off in
     turns, peak memory under 70 GB, and a profile of each model's step;
 10. the MoE block: ``llama4-scout-17b-a16e`` at full width (d 5120, 40
     heads over 8 KV heads, 16 experts of 8192 top-1 and a shared expert,
     vocab 202048), 8 of its 48 layers (39.7 GB of bf16 weights, the
     router in float32), N=8, capacity_factor 1.25, served by
     ``ContinuousScheduler`` on the paged pool (page_size 16, 8 slots)
     with the mux, decode-demux and paged kernels: a 40-request Poisson
     trace (prompt 32, 16 new tokens) at prefill_chunk 1 and 4; a
     contiguous plain run over a ``with_config`` view replays the kernel
     run's sampled tokens and its routing (``RoutingTape``: each row the
     plain router would route otherwise must be a near-tie), giving the
     same steps and tokens and every step's logits within LOGIT_TOL, and a
     paged plain run the same peak pages; then ``make_eval_step`` (1
     group, L 512) through flash and the mux and demux kernels against the
     plain view (logits within LOGIT_TOL, task loss and ``moe_aux`` within
     EVAL_LOSS_TOL), eval-step times in turns, peak memory under 70 GB,
     and profiles of a scheduler step and an eval step with each MoE
     stage's device time;
 11. Multi-head Latent Attention: ``deepseek-v3-671b`` at full width (d
     7168, MLA over 128 heads with a latent of 512 + rope 64 per token,
     dense MLPs of 18432, 256 experts of 2048 sigmoid top-8 and a shared
     expert, vocab 129280), 4 of its 61 layers (its 3 dense layers and
     1 MoE layer: 30.8 GB of bf16 weights), N=8, served and evaluated as
     in phase 10 with the latent rows in the page pool: the mux,
     decode-demux and index-embed demux kernels on, the paged and flash
     kernels never launched (MLA attends on the plain path, as in the
     reference), the pool's bytes equal to ``paged_cache_bytes``, and the
     MLA share of the profiled steps' device time printed;
 12. the hybrid: ``jamba-1.5-large-398b`` at full width (d 8192, Mamba
     layers of d_inner 16384, state 16, dt rank 512; attention of 64
     heads over 8 KV heads of 128; 16 experts of 24576 top-2; dense MLPs
     of 24576; vocab 65536), its layers 3-5 of 72 (Mamba + dense,
     attention + MoE, Mamba + dense: 25.9 GB of bf16 weights), N=8,
     served and evaluated as in phase 10: the Mamba states contiguous
     beside the page pool, the paged kernel launched by the attention
     layer (n_rep 8), flash by it at eval, and the device time of the
     ``mamba`` label and of the MoE stages printed;
 13. xLSTM: ``xlstm-125m`` at full width and depth (12 layers: 8 mLSTM of
     d_inner 1536 over 4 heads of 384, 4 sLSTM; d 768, vocab 50304; about
     160 M parameters), N=8, bf16, served as in phase 10 at prefill_chunk
     1 with no layer in the page pool (every recurrent state contiguous,
     the pool's bytes equal to ``paged_cache_bytes``), the mux and both
     demux kernels on and neither attention kernel launched, an
     ``Engine`` at prefill_chunk 4 refused; evaluated as in phase 10 (L
     512); the device time of the ``mlstm`` and ``slstm`` labels and the
     device launches per step printed;
 14. cross-attention with an encoder: ``whisper-base`` whole (6 encoder
     and 6 decoder layers, d 512, every decoder layer cross-attending),
     N=8, bf16 (random weights from --seed, every ``cross_gate`` set
     nonzero from it: at the reference's initial 0 the sublayer adds
     nothing), over a random (8, 1500, 512) mel-frame context, served
     lock-step as the reference serves it (its prime cannot take the
     context, so it has no continuous serving for these models):
     ``Engine.generate`` of 8 x 8 streams, prompt 32, 16 tokens, with the
     mux and both demux kernels; a plain ``with_config`` view replaying
     its tokens gives every step's logits within LOGIT_TOL and the same
     greedy picks where the margin is clear; the state's context K/V are
     ``_cross_kv_bytes``; two contexts give different logits; then
     evaluated as in phase 10 with the context in the batch (flash on the
     decoder's causal layers only); profiles of a decode step, a prefill
     and an eval step with the ``cross`` and ``encoder`` labels' device
     time;
 15. ``llama-3.2-vision-11b`` whole (40 layers, d 4096, 32 heads over 8
     KV heads, a gated cross sublayer on every 5th layer; 10.2 B
     parameters, 20.4 GB of bf16) the same way over a random (8, 1600,
     4096) patch context;
 16. the image models: ``MuxMLP`` and ``MuxCNN`` at the paper's sizes
     (20x20, hidden 100, groups 20 / 84, N 4) with every registered mux
     strategy that validates at d 400, on a batch of the synthetic
     digits: logits, ``image_loss`` and every gradient on the card against
     the same weights on the CPU in f32 within 1e-4 x max(1, max|CPU|).

Phase 2 also holds the mux and both demux kernels at every shape phases
8-15 launch them (d 512, 768, 2560, 3072, 4096, 5120, 7168, 8192 and
18432), the paged kernel at gemma3-4b's chunked shape (64 rows x n_rep 2,
hd 256), llama4-scout's (n_rep 5, hd 128, C 1 and 4) and jamba's (n_rep
8, C 1 and 4) and flash attention at the seven models' shapes in phases
9, 10, 12, 14 and 15 against their plain versions.  Each phase's seconds
are printed.  The mux and demux launches of phases 3-15 record their
shapes, and the run
fails if one of them was not held in phase 2 (the launch plans are chosen
from the shape).

It prints one JSON line of per-kernel numbers, then the card's
``nvidia-smi`` name and power limit, and last a JSON line with the device.
No CUDA device, or no ``src/repro_torch`` beside this file, is a failure.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12             # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core rate
              "float32": 67e12}       # outside the tensor cores
# x max(1, max|plain|); the kernels accumulate in f32 and round their
# output (the bf16 flash kernel also rounds P to bf16 for P.V: <= 2^-9
# relative error per term)
TOL = {"bfloat16": 1e-2, "float32": 1e-4}
LOGIT_TOL = 5e-2                      # x max|plain logits|, bf16 slice
EVAL_LOSS_TOL = 1e-2                  # relative, eval losses kernels vs plain
REPLACES = {
    "hadamard_mux": "src/repro/kernels/multiplex/kernel.py:60",
    "index_embed_demux": "src/repro/kernels/demux/kernel.py:85",
    "decode_demux": "src/repro/kernels/demux/kernel.py:166",
    "paged_decode_attention": "src/repro/kernels/paged_attention/kernel.py:190",
    "flash_attention": "src/repro/kernels/attention/kernel.py:96",
}
SOURCES = {
    "hadamard_mux": "hadamard_mux.cu",
    "index_embed_demux": "index_embed_demux.cu",
    "decode_demux": "decode_demux.cu",
    "paged_decode_attention": "paged_decode_attention.cu",
    "flash_attention": "flash_attention.cu",
}


# The bf16 bodies redesigned for Hopper (TMA + wgmma): their SASS must
# hold HGMMA and UTMALDG instructions; the paged kernel's (TMA, CUDA-core
# math) UTMALDG instructions.
REDESIGNED_BODIES = tuple(
    f"flash_attention_wgmma_kernel<{w}>"
    for w in ("64, 96, 3", "128, 96, 3", "192, 48, 3", "256, 48, 3")) + (
    "demux_gemm_kernel", "demux_lane_kernel", "decode_gemm_kernel",
    "decode_lane_kernel")
TMA_BODIES = tuple(f"paged_split_kernel<{t}, {r}, {v}, 1>"
                   for t, v, rows in (("bf16", 1, (1, 4, 16)),
                                      ("float", 1, (1, 4, 16)),
                                      ("float", 2, (1, 4, 8)))
                   for r in rows)


def time_ms(fn, runs: int = 21, calls: int = 5, warmup: int = 3) -> float:
    """Device time of one call in ms: the median over ``runs`` of CUDA-event
    time of ``calls`` back-to-back calls, divided by ``calls``.  Each run is
    queued behind a sleep kernel, so the host's dispatch time overlaps it
    instead of being counted as device time.  A call above 2 ms is timed
    alone, 5 times, to keep the phase short."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    if start.elapsed_time(end) > 2.0:   # a slow call: 5 runs of one call
        runs, calls = 5, 1
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def kernel_name(mangled: str) -> str:
    """``paged_split_kernel<bf16, 16>`` from its mangled name: the last of
    the length-prefixed names, then its template arguments (types bf16 and
    float, integer literals)."""
    i = 3 if mangled.startswith("_ZN") else 2
    name = mangled
    while (m := re.match(r"\d+", mangled[i:])):
        n = int(m.group())
        name = mangled[i + m.end():i + m.end() + n]
        i += m.end() + n
    if not mangled.startswith("I", i):
        return name
    args, i = [], i + 1
    while (m := re.match(r"13__nv_bfloat16|f|Li(\d+)E", mangled[i:])):
        args.append(m.group(1) or {"f": "float"}.get(m.group(), "bf16"))
        i += m.end()
    return f"{name}<{', '.join(args)}>" if args else name


def report_build(lib, build) -> None:
    """Per kernel: ptxas's registers, spills and warnings (-Xptxas -v), and
    the counts of HGMMA (wgmma) and UTMALDG (TMA load) instructions in the
    library's SASS (cuobjdump -sass).  Fails if a redesigned bf16 body has
    none of either."""
    src = name = None
    for line in build.ptxas_log(lib).read_text().splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif m := re.search(r"Compiling entry function '(\S+)'", line):
            name, spills = kernel_name(m.group(1)), ""
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes "
                            r"spill loads", line):
            spills = f"spill stores {m.group(1)} B, loads {m.group(2)} B"
        elif m := re.search(r"Used (\d+) registers", line):
            print(f"[build] {src} {name}: {m.group(1)} registers, {spills}")
        elif "(C7" in line:
            print(f"[build] {src} ptxas: {line.split(':', 1)[-1].strip()}")
    cuobjdump = Path(build._nvcc()).with_name("cuobjdump")
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)],
                          capture_output=True, text=True, check=True).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        name = kernel_name(part.split(None, 1)[0])
        counts[name] = (len(re.findall(r"\bHGMMA\.", part)),
                        len(re.findall(r"\bUTMALDG\.", part)))
    for name, (hgmma, utma) in sorted(counts.items()):
        print(f"[build] sass {name}: HGMMA {hgmma}, UTMALDG {utma}")
    for name in REDESIGNED_BODIES:
        if not all(counts.get(name, (0, 0))):
            raise SystemExit(f"[build] FAIL: {name} has no HGMMA or no "
                             f"UTMALDG in its SASS")
    for name in TMA_BODIES:
        if not counts.get(name, (0, 0))[1]:
            raise SystemExit(f"[build] FAIL: {name} has no UTMALDG in its "
                             f"SASS")


def bound(nbytes: float, flops: float, dtype: str) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------

def check_kernels(torch, gen):
    from repro_torch.kernels.demux import kernel as demux_kernel
    from repro_torch.kernels.demux import ref as demux_ref
    from repro_torch.kernels.multiplex import kernel as mux_kernel
    from repro_torch.kernels.multiplex import ref as mux_ref
    from repro_torch.nn.layers import SharedMLPStack

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    def mlp_module(w1, b1, w2, b2, dtype):
        d = w2.shape[0]
        m = SharedMLPStack([2 * d, w1.shape[0], d], device="cuda",
                           dtype=dtype)
        with torch.no_grad():
            for layer, (w, b) in zip(m.layers(), ((w1, b1), (w2, b2))):
                layer.weight.copy_(w)
                layer.bias.copy_(b)
        return m

    both = (torch.bfloat16, torch.float32)
    bf16 = (torch.bfloat16,)
    cases = []   # (name, shape, kernel fn, plain fn, f32 plain output, bytes, flops)
    for b, n, l, d, dtypes in (
            (8, 40, 1, 768, both), (8, 40, 104, 768, both),
            (3, 5, 7, 200, both), (2, 8, 1032, 2560, both),
            # tmux-12l-768h's other in-model shapes: the scheduler's prime
            # of the 40-token prefix, chunks of 4 and 17 rows, the trained
            # weights' eval (128 tokens + the prefix)
            (8, 40, 40, 768, bf16), (8, 40, 4, 768, bf16),
            (8, 40, 17, 768, bf16), (8, 40, 168, 768, bf16),
            # the dense family's in-model shapes, in the models' dtype:
            # gemma3-4b's [window] steps (the lock-step prefill past the
            # rings, one decode step, a 64-row chunk of 4 slots) and its
            # [dense] eval, gemma-7b's and nemotron-4-340b's [dense] evals
            # (L + the 8-token prefix; the scheduler's prime is the prefix)
            (2, 8, 1208, 2560, bf16), (2, 8, 1, 2560, bf16),
            (4, 8, 8, 2560, bf16), (4, 8, 64, 2560, bf16),
            (1, 8, 1288, 2560, bf16), (1, 8, 520, 3072, bf16),
            (1, 8, 264, 18432, bf16),
            # llama4-scout-17b-a16e's [moe] shapes: a decode step of 8
            # slots, a chunk of 4 rows, the prime of the 8-token prefix,
            # the eval (512 tokens + the prefix); [mesh]'s lock-step
            # prefill of the prefix and a 32-token prompt
            (8, 8, 1, 5120, bf16), (8, 8, 4, 5120, bf16),
            (8, 8, 8, 5120, bf16), (1, 8, 520, 5120, bf16),
            (8, 8, 40, 5120, bf16),
            # deepseek-v3-671b's [mla] shapes, the same steps at d 7168
            (8, 8, 1, 7168, bf16), (8, 8, 4, 7168, bf16),
            (8, 8, 8, 7168, bf16), (1, 8, 520, 7168, bf16),
            # jamba-1.5-large-398b's [hybrid] shapes at d 8192
            (8, 8, 1, 8192, bf16), (8, 8, 4, 8192, bf16),
            (8, 8, 8, 8192, bf16), (1, 8, 520, 8192, bf16),
            # xlstm-125m's [ssm] shapes at d 768 (its comparisons run in
            # f32): a decode step of 8 slots, the prime of the 8-token
            # prefix, the eval
            (8, 8, 1, 768, both), (8, 8, 8, 768, both),
            (1, 8, 520, 768, both),
            # whisper-base's [audio] and llama-3.2-vision-11b's [vlm]
            # shapes (d 512 and 4096): the lock-step prefill of the
            # 8-token prefix and a 32-token prompt, a decode step, the eval
            (8, 8, 40, 512, bf16), (8, 8, 1, 512, bf16),
            (1, 8, 520, 512, bf16), (8, 8, 40, 4096, bf16),
            (8, 8, 1, 4096, bf16), (1, 8, 520, 4096, bf16)):
        x32, v32 = randn(b, n, l, d), randn(n, d)
        for dtype in dtypes:
            x, v = x32.to(dtype), v32.to(dtype)
            want = mux_ref.hadamard_mux(x.float(), v.float())
            s = x.element_size()
            pl = mux_kernel.plan(b, n, l, d, dtype)
            cases.append(("hadamard_mux", dict(B=b, N=n, L=l, d=d,
                                               slots=pl.slots,
                                               blocks=pl.blocks), dtype,
                          lambda x=x, v=v: mux_kernel.hadamard_mux(x, v),
                          lambda x=x, v=v: mux_ref.hadamard_mux(x, v), want,
                          s * (b * n * l * d + n * d + b * l * d),
                          2 * b * n * l * d))
    demux_shapes = (("index_embed_demux", 8, 40, 1, 768, 1536, both),
                    ("index_embed_demux", 8, 40, 104, 768, 1536, both),
                    ("index_embed_demux", 3, 5, 7, 200, 300, both),
                    ("index_embed_demux", 2, 8, 1024, 2560, 5120, both),
                    ("index_embed_demux", 3, 3, 17, 96, 160, both),
                    ("decode_demux", 8, 40, 1, 768, 1536, both),
                    ("decode_demux", 8, 40, 4, 768, 1536, both),
                    ("decode_demux", 3, 3, 3, 96, 160, both),
                    ("decode_demux", 3, 5, 7, 200, 300, both),
                    # tmux-12l-768h's 17-row chunk, its trained weights'
                    # eval
                    ("decode_demux", 8, 40, 17, 768, 1536, bf16),
                    ("index_embed_demux", 8, 40, 128, 768, 1536, bf16),
                    # nemotron-4-340b's width (d 18432, H 36864: W1 alone
                    # is 2.7 GB in bf16), the model's dtype only: its
                    # [dense] eval shape and a decode step of 4 slots
                    ("index_embed_demux", 1, 8, 256, 18432, 36864, bf16),
                    ("decode_demux", 4, 8, 1, 18432, 36864, bf16),
                    # gemma3-4b's [window] chunk: 4 slots x 64 rows
                    ("decode_demux", 4, 8, 64, 2560, 5120, both),
                    # the rest of the dense family's in-model shapes:
                    # gemma3-4b's lock-step prefill (last row only) and
                    # decode step, its [dense] eval, gemma-7b's
                    ("index_embed_demux", 2, 8, 1, 2560, 5120, bf16),
                    ("decode_demux", 2, 8, 1, 2560, 5120, bf16),
                    ("index_embed_demux", 1, 8, 1280, 2560, 5120, bf16),
                    ("index_embed_demux", 1, 8, 512, 3072, 6144, bf16),
                    # llama4-scout-17b-a16e's [moe] shapes: decode steps
                    # of one row and chunks of 4, the eval; [mesh]'s
                    # lock-step prefill demux (last row)
                    ("decode_demux", 8, 8, 1, 5120, 10240, bf16),
                    ("decode_demux", 8, 8, 4, 5120, 10240, bf16),
                    ("index_embed_demux", 1, 8, 512, 5120, 10240, bf16),
                    ("index_embed_demux", 8, 8, 1, 5120, 10240, bf16),
                    # deepseek-v3-671b's [mla] shapes (d 7168, H 14336)
                    ("decode_demux", 8, 8, 1, 7168, 14336, bf16),
                    ("decode_demux", 8, 8, 4, 7168, 14336, bf16),
                    ("index_embed_demux", 1, 8, 512, 7168, 14336, bf16),
                    # jamba-1.5-large-398b's [hybrid] shapes (d 8192, H
                    # 16384): decode steps of one row and chunks of 4, a
                    # one-row prefill demux and the eval
                    ("decode_demux", 8, 8, 1, 8192, 16384, bf16),
                    ("decode_demux", 8, 8, 4, 8192, 16384, bf16),
                    ("index_embed_demux", 8, 8, 1, 8192, 16384, bf16),
                    ("index_embed_demux", 1, 8, 512, 8192, 16384, bf16),
                    # xlstm-125m's [ssm] shapes (d 768, H 1536; in f32
                    # too): a decode step of 8 slots, a one-row prefill
                    # demux, the eval
                    ("decode_demux", 8, 8, 1, 768, 1536, both),
                    ("index_embed_demux", 8, 8, 1, 768, 1536, both),
                    ("index_embed_demux", 1, 8, 512, 768, 1536, both),
                    # whisper-base's [audio] (d 512, H 1024) and
                    # llama-3.2-vision-11b's [vlm] (d 4096, H 8192)
                    # shapes: the prefill's last row, a decode step, the
                    # eval
                    ("index_embed_demux", 8, 8, 1, 512, 1024, bf16),
                    ("decode_demux", 8, 8, 1, 512, 1024, bf16),
                    ("index_embed_demux", 1, 8, 512, 512, 1024, bf16),
                    ("index_embed_demux", 8, 8, 1, 4096, 8192, bf16),
                    ("decode_demux", 8, 8, 1, 4096, 8192, bf16),
                    ("index_embed_demux", 1, 8, 512, 4096, 8192, bf16))
    for name, b, n, l, d, hid, dtypes in demux_shapes:
        h32, p32 = randn(b, l, d), randn(b, n, d)
        w1_32, b1_32 = randn(hid, 2 * d, scale=(2 * d) ** -0.5), \
            randn(hid, scale=0.1)
        w2_32, b2_32 = randn(d, hid, scale=hid ** -0.5), randn(d, scale=0.1)
        fn = getattr(demux_kernel, name)
        for dtype in dtypes:
            h, p, w1, b1, w2, b2 = (t.to(dtype) for t in
                                    (h32, p32, w1_32, b1_32, w2_32, b2_32))
            with torch.no_grad():
                plain32 = mlp_module(w1, b1, w2, b2, torch.float32)
                plain = mlp_module(w1, b1, w2, b2, dtype)
                want = demux_ref.index_embed_demux(plain32, h.float(),
                                                   p.float())
            s = h.element_size()
            nbytes = s * (b * l * d + b * n * d + 3 * d * hid + hid + d
                          + b * n * l * d)
            flops = b * (2 * l * d * hid + 2 * n * d * hid
                         + 2 * n * l * hid * d)
            body = (demux_kernel.plan(b, l, n, d, hid, dtype).body
                    if name == "index_embed_demux" else
                    demux_kernel.decode_plan(b, l, n, d, hid, dtype).body)
            cases.append((name, dict(B=b, N=n, L=l, d=d, H=hid, body=body),
                          dtype,
                          lambda a=(h, p, w1, b1, w2, b2), fn=fn: fn(*a),
                          lambda m=plain, h=h, p=p:
                          demux_ref.index_embed_demux(m, h, p),
                          want, nbytes, flops))

    results = []
    with torch.no_grad():
        for name, shape, dtype, kern, plain, want, nbytes, flops in cases:
            got = kern()
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            dname = str(dtype).removeprefix("torch.")
            tol = TOL[dname] * max(1.0, want.abs().max().item())
            ms, plain_ms = time_ms(kern), time_ms(plain)
            bound_ms, bound_by = bound(nbytes, flops, dname)
            print(f"[kernel] {name} {shape} {dname}: max_abs_err {err:.3g} "
                  f"(tol {tol:.3g}), {ms:.4f} ms, plain {plain_ms:.4f} ms, "
                  f"bound {bound_ms:.3g} ms ({bound_by})")
            if not err <= tol:
                raise SystemExit(f"[kernel] FAIL: {name} {shape} {dname} "
                                 f"disagrees with its plain version")
            results.append(dict(name=name, shape=shape, dtype=dname,
                                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by))
    print("[kernel] no single PyTorch call computes the Hadamard mux or "
          "the index-embed demux MLP, so library_ms is null")
    # What a launch costs in this timing loop whatever the kernel does: a
    # fill of the decode-shape mux's (8, 1, 768) bf16 output.
    out = torch.empty((8, 1, 768), dtype=torch.bfloat16, device="cuda")
    print(f"[kernel] launch floor: zero_ of a (8, 1, 768) bf16 tensor "
          f"{time_ms(out.zero_):.4f} ms")
    return results


SHAPE_CHECKED = ("hadamard_mux", "index_embed_demux", "decode_demux")


def shape_key(name, dtype, shape) -> tuple:
    """(kernel, dtype, B, N, L, d, H) of a mux or demux launch: the shape
    its launch plan is chosen from (H is None for the mux)."""
    return (name, str(dtype).removeprefix("torch."), shape["B"], shape["N"],
            shape["L"], shape["d"], shape.get("H"))


def record_shapes() -> set:
    """Wraps the mux and demux kernels' wrappers so that each launch adds
    its ``shape_key`` to the returned set: the in-model shapes that phase
    2 must have held against the plain version (``check_shapes``)."""
    from repro_torch.kernels.demux import kernel as demux_kernel
    from repro_torch.kernels.multiplex import kernel as mux_kernel

    seen = set()

    def wrap(module, name):
        fn = getattr(module, name)

        def recorded(*args):
            x = args[0]
            if name == "hadamard_mux":
                b, n, l, d = x.shape
                shape = dict(B=b, N=n, L=l, d=d)
            else:
                b, l, d = x.shape
                shape = dict(B=b, N=args[1].shape[1], L=l, d=d,
                             H=args[2].shape[0])
            if x.numel():                    # an empty call launches nothing
                seen.add(shape_key(name, x.dtype, shape))
            return fn(*args)
        setattr(module, name, recorded)

    wrap(mux_kernel, "hadamard_mux")
    wrap(demux_kernel, "index_embed_demux")
    wrap(demux_kernel, "decode_demux")
    return seen


def check_shapes(seen: set, results: list) -> None:
    """Fails unless every mux and demux shape the phases launched was held
    against its plain version in phase 2."""
    held = {shape_key(r["name"], r["dtype"], r["shape"]) for r in results
            if r["name"] in SHAPE_CHECKED}
    print(f"[shapes] {len(seen)} in-model mux and demux shapes, "
          f"{len(seen & held)} of them held in phase 2")
    missing = sorted(seen - held, key=str)
    for key in missing:
        print(f"[shapes] launched in a phase, not held in phase 2: {key}")
    if missing:
        raise SystemExit("[shapes] FAIL: in-model shapes phase 2 never "
                         "checked")


def paged_inputs(torch, gen, dtype, *, b, h, kvh, hd, ps, mp, c,
                 lengths=None, hole=0, pool=None, seed=0):
    """Pool, block table and query block on the card.  With ``lengths``
    each slot holds that many positions in its first pages (the serving
    layout: full pages, the last one partial, q at the last C positions);
    with ``hole``, every slot's table is full but for ``hole`` unmapped
    entries in its middle, q at the last C positions, and every page no
    table maps holds keys and values of 1e4 at positions that would pass
    every mask; otherwise each slot maps a random number of distinct pages,
    each written up to a random length, q at random consecutive
    positions."""
    pool = pool or b * mp + 1
    q = torch.randn((b, c, h, hd), generator=gen, device="cuda")
    k = torch.randn((pool, ps, kvh, hd), generator=gen, device="cuda")
    v = torch.randn((pool, ps, kvh, hd), generator=gen, device="cuda")
    bt = torch.full((b, mp), -1, dtype=torch.int32)
    pos = torch.full((pool, ps), -1, dtype=torch.int32)
    cg = torch.Generator().manual_seed(seed)   # host-side layout choices
    pages = (1 + torch.randperm(pool - 1, generator=cg)).tolist()
    q_pos = torch.zeros((b, c), dtype=torch.int32)
    if hole:
        mid = (mp - hole) // 2
        pos[:] = torch.arange(ps, dtype=torch.int32)
        for i in range(b):
            q_pos[i] = mp * ps - c + torch.arange(c)
            for j in list(range(mid)) + list(range(mid + hole, mp)):
                p = pages.pop()
                bt[i, j] = p
                pos[p] = j * ps + torch.arange(ps)
        unused = torch.ones(pool, dtype=torch.bool)
        unused[bt[bt >= 0].long()] = False
        k[unused.cuda()] = 1e4
        v[unused.cuda()] = 1e4
        return ([t.to(dtype) for t in (q, k, v)] +
                [t.cuda() for t in (pos, bt, q_pos)])
    for i in range(b):
        if lengths is not None:
            n = -(-lengths[i] // ps)
            written = [min(ps, lengths[i] - j * ps) for j in range(n)]
            q_pos[i] = lengths[i] - c + torch.arange(c)
        else:
            n = int(torch.randint(1, min(mp, pool - 1) + 1, (1,),
                                  generator=cg))
            written = torch.randint(1, ps + 1, (n,), generator=cg).tolist()
            base = int(torch.randint(ps - 1, mp * ps - c + 1, (1,),
                                     generator=cg))
            q_pos[i] = base + torch.arange(c)
        for j in range(n):
            p = pages.pop()
            bt[i, j] = p
            pos[p, :written[j]] = j * ps + torch.arange(written[j])
    return ([t.to(dtype) for t in (q, k, v)] +
            [t.cuda() for t in (pos, bt, q_pos)])


def paged_mask(pos, bt, q_pos, causal, window):
    """(B, C, max_pages * ps) bool: the keys each query row may attend to,
    in position order (the plain version's mask)."""
    from repro_torch.kernels.paged_attention import ref as paged_ref

    k_pos = paged_ref.gather_positions(pos, bt)
    diff = q_pos[:, :, None] - k_pos[:, None, :]
    mask = (k_pos >= 0)[:, None, :].expand_as(diff)
    if causal:
        mask = mask & (diff >= 0)
    if window is not None:
        mask = mask & (diff < window)
    return mask


def check_paged_kernel(torch, gen):
    """The paged decode-attention kernel against its plain version at the
    paged slice's shapes (C = 1 and C = 4), at a ragged one, at a long
    context (64 mapped pages per slot) and with an all-unmapped split next
    to pages planted with 1e4, for kblock_pages 1, 2 and 4; each line
    names the plan's split (blocks per slot and KV head).
    ``library_ms`` is ``scaled_dot_product_attention`` on K/V already
    gathered into position order with the boolean mask (the gather is not
    timed)."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.paged_attention import ref as paged_ref
    from repro_torch.nn.attention import _repeat_kv

    g = torch.Generator().manual_seed(0)
    tmux_lengths = torch.randint(120, 138, (8,), generator=g).tolist()
    slice_kw = dict(b=8, h=12, kvh=12, hd=64, ps=16)
    shapes = [  # (label, shape and layout kwargs, causal, window, kblocks)
        ("slice C1", dict(slice_kw, mp=9, c=1, lengths=tmux_lengths),
         False, None, (1, 2, 4)),
        ("slice C4", dict(slice_kw, mp=9, c=4, lengths=tmux_lengths),
         False, None, (1,)),
        ("ragged", dict(b=3, h=8, kvh=2, hd=128, ps=8, mp=7, c=3, pool=37),
         True, 8, (1, 2, 4)),
        ("long context",
         dict(slice_kw, mp=64, c=1, lengths=[64 * 16 - 3] * 8),
         False, None, (1, 2)),
        (UNMAPPED, dict(slice_kw, mp=16, c=1, hole=8), True, None, (1, 2)),
        # shapes the earlier kernel refused (ROADMAP Queue C 1-3):
        # 17 query rows (prefill_chunk 17, two row groups) at kblock 16 and
        # 1, 64 rows (C 16 x n_rep 4), 256 (C 32 x n_rep 8, jamba's
        # grouping), head dims 36 (no TMA: the copy body), 80, 192
        # (nemotron-4-340b: 96 heads over 8) and 256 (gemma3-4b: 8 over 4),
        # pages of 512 rows
        ("rows 17", dict(slice_kw, mp=9, c=17, lengths=tmux_lengths),
         False, None, (16, 1)),
        ("rows 64", dict(slice_kw, h=16, kvh=4, mp=9, c=16,
                         lengths=tmux_lengths), False, None, (1,)),
        ("rows 256", dict(b=4, h=64, kvh=8, hd=128, ps=16, mp=9, c=32,
                          lengths=tmux_lengths[:4]), False, None, (1,)),
        ("hd 36", dict(b=8, h=8, kvh=2, hd=36, ps=16, mp=9, c=1,
                       lengths=tmux_lengths), False, None, (1,)),
        ("hd 80", dict(b=8, h=8, kvh=2, hd=80, ps=16, mp=9, c=1,
                       lengths=tmux_lengths), False, None, (1,)),
        ("hd 192", dict(b=8, h=96, kvh=8, hd=192, ps=16, mp=9, c=1,
                        lengths=tmux_lengths), False, None, (1,)),
        ("hd 256", dict(b=8, h=8, kvh=4, hd=256, ps=16, mp=9, c=1,
                        lengths=tmux_lengths), False, None, (1,)),
        ("page 512", dict(slice_kw, ps=512, mp=3, c=1,
                          lengths=[3 * 512 - 7] * 8), False, None, (1,)),
        # gemma3-4b's global layers under [window]'s chunked prefill: 64
        # query rows x n_rep 2 over KV heads of 256, 4 slots at 1100-1500
        # positions of a 2056-position table
        ("gemma3-4b C64", dict(b=4, h=8, kvh=4, hd=256, ps=16, mp=129,
                               c=64, lengths=[1137, 1262, 1391, 1500]),
         True, None, (1,)),
        # llama4-scout-17b-a16e under [moe]: 40 heads over 8 KV heads of
        # 128 (n_rep 5), 8 slots of a 9-page table, a decode row (5 query
        # rows per KV head) and a chunk of 4 (20 rows, two row groups)
        ("llama4 C1", dict(b=8, h=40, kvh=8, hd=128, ps=16, mp=9, c=1,
                           lengths=tmux_lengths), True, None, (1,)),
        ("llama4 C4", dict(b=8, h=40, kvh=8, hd=128, ps=16, mp=9, c=4,
                           lengths=tmux_lengths), True, None, (1,)),
        # jamba-1.5-large-398b under [hybrid]: 64 heads over 8 KV heads of
        # 128 (n_rep 8), 8 query rows per KV head at C 1, 32 at C 4
        ("jamba C1", dict(b=8, h=64, kvh=8, hd=128, ps=16, mp=9, c=1,
                          lengths=tmux_lengths), True, None, (1,)),
        ("jamba C4", dict(b=8, h=64, kvh=8, hd=128, ps=16, mp=9, c=4,
                          lengths=tmux_lengths), True, None, (1,)),
    ]
    results = []
    with torch.no_grad():
        for label, kw, causal, window, kblocks in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                args = paged_inputs(torch, gen, dtype, **kw)
                q, k_pages, v_pages, pos, bt, q_pos = args
                b, c, h, hd = q.shape
                scale = hd ** -0.5
                f32 = [t.float() if t.is_floating_point() else t
                       for t in args]
                want = paged_ref.paged_attention(*f32, scale=scale,
                                                 causal=causal, window=window)
                mask = paged_mask(pos, bt, q_pos, causal, window)
                live = mask.any(-1)[:, :, None, None]
                n_rep = h // k_pages.shape[2]
                kg = _repeat_kv(paged_ref.gather_pages(k_pages, bt), n_rep)
                vg = _repeat_kv(paged_ref.gather_pages(v_pages, bt), n_rep)
                lib_args = (q.transpose(1, 2), kg.transpose(1, 2).contiguous(),
                            vg.transpose(1, 2).contiguous(), mask[:, None])
                library_ms = time_ms(lambda a=lib_args: F.scaled_dot_product_attention(
                    a[0], a[1], a[2], attn_mask=a[3], scale=scale))
                plain_ms = time_ms(lambda: paged_ref.paged_attention(
                    *args, scale=scale, causal=causal, window=window))
                # Bytes the function must move: the mapped pages' K, V and
                # positions, q, the output, the block table and q_pos.
                mapped = int((bt >= 0).sum())
                s = q.element_size()
                ps = k_pages.shape[1]
                kvh = k_pages.shape[2]
                nbytes = (mapped * ps * (2 * kvh * hd * s + 4)
                          + 2 * q.numel() * s + 4 * (bt.numel() + b * c))
                flops = 4 * c * h * hd * mapped * ps
                dname = str(dtype).removeprefix("torch.")
                bound_ms, bound_by = bound(nbytes, flops, dname)
                outs = {}
                for kb in kblocks:
                    pl = paged_kernel.plan(b, c, h, kvh, hd, ps,
                                           bt.shape[1], kb, dtype)
                    if label == UNMAPPED and not (pl.splits > 1 and any(
                            bool((bt[:, list(pl.split_entries(
                                x, bt.shape[1]))] < 0).all())
                            for x in range(pl.splits))):
                        raise SystemExit(f"[kernel] FAIL: {label} kblock "
                                         f"{kb}: no split is all unmapped")

                    def kern(kb=kb):
                        return paged_kernel.paged_decode_attention(
                            *args, scale=scale, causal=causal, window=window,
                            kblock_pages=kb)
                    got = outs[kb] = kern().float()
                    torch.cuda.synchronize()
                    err = ((got - want) * live).abs().max().item()
                    tol = TOL[dname] * max(
                        1.0, (want * live).abs().max().item())
                    ms = time_ms(kern)
                    shape = dict(B=b, C=c, H=h, KVH=kvh, hd=hd, ps=ps,
                                 max_pages=bt.shape[1], mapped=mapped,
                                 kblock=kb, causal=causal, window=window,
                                 splits=pl.splits, groups=pl.groups,
                                 box_rows=pl.box_rows, body=pl.body)
                    print(f"[kernel] paged_decode_attention {label} {shape} "
                          f"{dname}: max_abs_err {err:.3g} (tol {tol:.3g}), "
                          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
                          f"sdpa on gathered K/V {library_ms:.4f} ms, "
                          f"bound {bound_ms:.3g} ms ({bound_by})")
                    if not (err <= tol and bool(torch.isfinite(got).all())):
                        raise SystemExit(
                            f"[kernel] FAIL: paged_decode_attention {label} "
                            f"kblock {kb} {dname} disagrees with its plain "
                            f"version")
                    results.append(dict(
                        name="paged_decode_attention", label=label,
                        shape=shape, dtype=dname, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms))
                # kblock_pages moves only the split boundaries: outputs at
                # every width agree to the merge's rounding (f32) or one
                # bf16 rounding of the output
                for kb in kblocks[1:]:
                    diff = ((outs[kb] - outs[kblocks[0]]) * live).abs().max()
                    scale_out = (outs[kblocks[0]] * live).abs().max().item()
                    agree = (2e-5 if dtype == torch.float32 else 2 ** -7) \
                        * max(1.0, scale_out)
                    print(f"[kernel] paged_decode_attention {label} {dname}: "
                          f"kblock {kb} vs {kblocks[0]} differ by "
                          f"{diff.item():.3g} (tol {agree:.3g})")
                    if not diff.item() <= agree:
                        raise SystemExit(f"[kernel] FAIL: paged "
                                         f"{label} {dname}: kblock {kb} and "
                                         f"{kblocks[0]} disagree")
    print("[kernel] library_ms of paged_decode_attention is "
          "scaled_dot_product_attention on K/V already gathered into "
          "position order; it excludes the gather")
    return results


UNMAPPED = "all-unmapped split, 1e4 planted"


def flash_cases(torch, gen):
    """(label, q, k, v, causal, scale) on the card, float32: the
    evaluation slice's shape (qwen1.5-4b: B 2, L 1032, H 20, hd 128), the
    reference's test shapes, Lq != Lk, a scale override, large logits and
    a long context."""
    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device="cuda")

    cases = []
    for causal in (True, False):
        q, k, v = (randn(2, 1032, 20, 128) for _ in range(3))
        cases.append(("slice", q, k, v, causal, None))
    for b, l, h, hd in ((1, 8, 1, 64), (2, 37, 4, 64), (1, 256, 2, 128),
                        (1, 520, 2, 64)):
        for causal in (True, False):
            q, k, v = (randn(b, l, h, hd) for _ in range(3))
            cases.append(("test shape", q, k, v, causal, None))
    for hd in (64, 128):
        q, k, v = randn(1, 37, 2, hd), randn(1, 45, 2, hd), randn(1, 45, 2, hd)
        for causal in (True, False):
            cases.append(("Lq 37, Lk 45", q, k, v, causal, None))
    # Lk = 200 is not a multiple of the key tile (96); PLANTED marks K and V
    # that are followed in memory by rows of 1e4.
    q, k, v = randn(1, 200, 2, 128), randn(1, 200, 2, 128), \
        randn(1, 200, 2, 128)
    for causal in (True, False):
        cases.append((PLANTED, q, k, v, causal, None))
    # every head dim up to 256 (the earlier kernel took 64 and 128): bf16
    # multiples of 8 on the wgmma body, the rest on CUDA cores
    for hd in (32, 80, 96, 192, 256):
        q, k, v = (randn(1, 300, 4, hd) for _ in range(3))
        for causal in (True, False):
            cases.append((f"hd {hd}", q, k, v, causal, None))
    # the attention shapes of the dense family's wide heads, KV repeated
    # as the flash path takes it: gemma3-4b (8 heads over 4 KV heads of
    # 256, L 1024) and nemotron-4-340b (96 heads of 192)
    for label, (b, l, h, hd) in (("gemma3-4b", (2, 1024, 8, 256)),
                                 ("nemotron-4-340b", (1, 1024, 96, 192))):
        q, k, v = (randn(b, l, h, hd) for _ in range(3))
        cases.append((label, q, k, v, True, None))
    # the same models' flash calls in the [dense] phase: the prefix of 8
    # plus the sequence, one group
    for label, (b, l, h, hd) in (("gemma3-4b eval", (1, 1288, 8, 256)),
                                 ("gemma-7b eval", (1, 520, 16, 256)),
                                 ("nemotron-4-340b eval", (1, 264, 96, 192)),
                                 ("llama4-scout eval", (1, 520, 40, 128)),
                                 ("jamba eval", (1, 520, 64, 128)),
                                 # the decoders' self-attention in
                                 # [audio] and [vlm] (llama's 8 KV heads
                                 # repeated to 32)
                                 ("whisper-base eval", (1, 520, 8, 64)),
                                 ("llama-3.2-vision eval",
                                  (1, 520, 32, 128))):
        q, k, v = (randn(b, l, h, hd) for _ in range(3))
        cases.append((label, q, k, v, True, None))
    q = randn(1, 32, 2, 64)
    cases.append(("scale 0.05", q, q, q, True, 0.05))
    q = randn(1, 128, 1, 64, scale=8.0)
    cases.append(("8 randn", q, q, q, True, None))
    return cases


PLANTED = "keys past Lk planted"


def planted(torch, t):
    """t (1, L, H, hd) as the first L rows of a buffer whose next 64 rows
    hold 1e4: keys past Lk that the kernel must not count."""
    buf = torch.full((1, t.shape[1] + 64, *t.shape[2:]), 1e4, dtype=t.dtype,
                     device=t.device)
    buf[:, :t.shape[1]] = t
    return buf[:, :t.shape[1]]


def check_flash_kernel(torch, gen):
    """The flash attention kernel against its plain version (in float32)
    in bf16 and f32, and a long context (B 1, L 8192, H 20, hd 128,
    causal) in bf16; ``library_ms`` is ``scaled_dot_product_attention``
    with ``is_causal`` on the same inputs."""
    import torch.nn.functional as F

    from repro_torch.kernels.attention import kernel as flash_kernel
    from repro_torch.kernels.attention import ref as flash_ref

    cases = [(label, q, k, v, causal, scale, dtype)
             for label, q, k, v, causal, scale in flash_cases(torch, gen)
             for dtype in (torch.bfloat16, torch.float32)]
    q, k, v = (torch.randn((1, 8192, 20, 128), generator=gen, device="cuda")
               for _ in range(3))
    cases.append(("long context", q, k, v, True, None, torch.bfloat16))
    results = []
    with torch.no_grad():
        for label, q32, k32, v32, causal, scale, dtype in cases:
            q, k, v = (t.to(dtype) for t in (q32, k32, v32))
            if label == PLANTED:
                k, v = planted(torch, k), planted(torch, v)
            want = flash_ref.flash_attention(q.float(), k.float(), v.float(),
                                             causal=causal, scale=scale)

            def kern(q=q, k=k, v=v, causal=causal, scale=scale):
                return flash_kernel.flash_attention(q, k, v, causal=causal,
                                                    scale=scale)
            got = kern()
            torch.cuda.synchronize()
            err = (got.float() - want).abs().max().item()
            dname = str(dtype).removeprefix("torch.")
            tol = TOL[dname] * max(1.0, want.abs().max().item())
            del want, got
            ms = time_ms(kern)
            plain_ms = time_ms(lambda: flash_ref.flash_attention(
                q, k, v, causal=causal, scale=scale))
            qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
            library_ms = time_ms(lambda: F.scaled_dot_product_attention(
                qt, kt, vt, is_causal=causal, scale=scale))
            b, lq, h, hd = q.shape
            lk = k.shape[1]
            # Work the inputs need: 4 * hd flops per (query, valid key)
            # pair; q, k, v read and the output written once.
            pairs = (sum(min(i + 1, lk) for i in range(lq)) if causal
                     else lq * lk)
            flops = 4 * hd * b * h * pairs
            nbytes = q.element_size() * b * h * hd * (2 * lq + 2 * lk)
            bound_ms, bound_by = bound(nbytes, flops, dname)
            shape = dict(B=b, Lq=lq, Lk=lk, H=h, hd=hd, causal=causal,
                         scale=scale, body=flash_kernel.plan(
                             b, lq, lk, h, hd, dtype).body)
            print(f"[kernel] flash_attention {label} {shape} {dname}: "
                  f"max_abs_err {err:.3g} (tol {tol:.3g}), {ms:.4f} ms, "
                  f"plain {plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, "
                  f"bound {bound_ms:.3g} ms ({bound_by})")
            if not err <= tol:
                raise SystemExit(f"[kernel] FAIL: flash_attention {label} "
                                 f"{shape} {dname} disagrees with its plain "
                                 f"version")
            results.append(dict(
                name="flash_attention", label=label, shape=shape,
                dtype=dname, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                library_ms=library_ms))
    print("[kernel] library_ms of flash_attention is "
          "scaled_dot_product_attention(is_causal=...) on the same inputs")
    return results


# ---------------------------------------------------------------------------
# Phase 3: the lock-step slice
# ---------------------------------------------------------------------------

def run_slice(torch, seed: int):
    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine

    batch, prompt_len, steps = 8, 64, 32
    base = get_config("tmux-12l-768h")
    cfg = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(fuse_demux=True))
    plain_cfg = dataclasses.replace(base, serving=ServingConfig())
    n = cfg.mux.n
    print(f"[slice] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"N={n}, {cfg.dtype}, batch {batch}, prompt {prompt_len}, "
          f"{steps} steps")
    model = Backbone(cfg, seed=seed, device="cuda").eval()
    eng = Engine(model, batch=batch, max_len=prompt_len + steps + 1)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (batch, n, prompt_len),
                            generator=gen, device="cuda")

    eng.generate(prompts, 2)          # warm-up: allocator, library handles
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    print(f"[slice] generate: {batch * n} streams x {steps} tokens in "
          f"{dt:.4f} s = {batch * n * steps / dt:.1f} streams x tokens/s "
          f"(bf16, {torch.cuda.get_device_name(0)})")
    print(f"[slice] kernel launches in that run: {launches}")
    if tuple(out.shape) != (batch, n, steps + 1):
        raise SystemExit(f"[slice] FAIL: output shape {tuple(out.shape)}")
    missing = [k for k in ("hadamard_mux", "index_embed_demux",
                           "decode_demux") if launches.get(k, 0) == 0]
    if missing:
        raise SystemExit(f"[slice] FAIL: kernels never launched: {missing}")

    plain_model = Backbone(plain_cfg, seed=seed, device="cuda").eval()
    plain_model.load_state_dict(model.state_dict())
    plain_eng = Engine(plain_model, batch=batch,
                       max_len=prompt_len + steps + 1)
    pairs = []
    for e in (eng, plain_eng):
        logits0, state = e.prefill(prompts)
        logits1, _ = e.step(state, out[..., 0])
        pairs.append((logits0.float(), logits1.float()))
    for what, got, want in (("prefill", pairs[0][0], pairs[1][0]),
                            ("first step", pairs[0][1], pairs[1][1])):
        if not bool(torch.isfinite(got).all()):
            raise SystemExit(f"[slice] FAIL: non-finite {what} logits")
        err = (got - want).abs().max().item()
        tol = LOGIT_TOL * want.abs().max().item()
        agree = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
        print(f"[slice] {what} logits, kernels on vs off: max_abs_err "
              f"{err:.4g} (tol {tol:.4g}), greedy tokens agree {agree:.4f}")
        if not err <= tol:
            raise SystemExit(f"[slice] FAIL: {what} logits disagree")
    engines = {"kernels on": eng, "kernels off": plain_eng}
    walls = {label: [] for label in engines}
    for label in ("kernels on", "kernels off") * 3:   # alternate, 3 each
        e = engines[label]
        walls[label].append(decode_step_ms(torch, e, e.prefill(prompts)[1],
                                           out[..., 0]))
    for label, e in engines.items():
        print(f"[profile] {label}: decode step wall ms (unprofiled, "
              f"alternating runs): {[round(w, 3) for w in walls[label]]}")
        profile_decode(torch, e, prompts, out[..., 0], label,
                       statistics.median(walls[label]))
    return launches


# ---------------------------------------------------------------------------
# Phase 4: the paged slice
# ---------------------------------------------------------------------------

def record_teacher_forced(sched, keep: list, pick=None,
                          every_step: bool = False) -> None:
    """Record (on the host) the logits of every engine step taken before
    any sampled token was emitted — and so before any could be fed back:
    those steps' inputs are prompt tokens only, the same in every run of
    the trace.  ``pick`` keeps a part of each step's logits.
    ``every_step`` keeps every step's, on the card in the logits' own dtype
    (for runs whose sampled tokens are replayed, ``Replay``)."""
    inner = sched.engine.step

    def step(state, tokens, **kw):
        forced = every_step or sched.stats.generated_tokens == 0
        logits, state = inner(state, tokens, **kw)
        if forced:
            part = logits if pick is None else pick(logits)
            keep.append(part.clone() if every_step else part.float().cpu())
        return logits, state
    sched.engine.step = step


def check_forced(tag: str, forced: list, pforced: list) -> None:
    """Teacher-forced logits of a kernel run against the plain run's: the
    same number of steps, each within LOGIT_TOL, finite, and greedy tokens
    equal wherever the plain top-1 margin exceeds twice that tolerance."""
    if not forced or len(forced) != len(pforced):
        raise SystemExit(f"{tag} FAIL: teacher-forced steps {len(forced)} "
                         f"vs {len(pforced)}")
    worst, clear_n, equal_n, lanes, agree = 0.0, 0, 0, 0, 0
    for i, (got, ref) in enumerate(zip(forced, pforced)):
        got, ref = got.float(), ref.float()
        err = (got - ref).abs().max().item()
        tol = LOGIT_TOL * ref.abs().max().item()
        top2 = ref.topk(2, dim=-1).values
        clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
        same = got.argmax(-1) == ref.argmax(-1)
        worst = max(worst, err / tol if tol else err)   # all lanes idle
        clear_n += int(clear.sum())
        equal_n += int(same[clear].sum())
        live = ref.abs().amax(-1) > 0
        lanes += int(live.sum())
        agree += int(same[live].sum())
        if not (err <= tol and bool(got.isfinite().all())
                and bool(same[clear].all())):
            raise SystemExit(f"{tag} FAIL: teacher-forced step {i} "
                             f"disagrees with the plain path: "
                             f"max_abs_err {err:.4g} (tol {tol:.4g}), "
                             f"greedy tokens equal on "
                             f"{int(same[clear].sum())} of "
                             f"{int(clear.sum())} clear lanes")
    print(f"{tag} {len(forced)} teacher-forced steps: logits within "
          f"{worst:.3f} of LOGIT_TOL, greedy tokens equal on {equal_n} of "
          f"{clear_n} lanes with a clear margin and on {agree} of {lanes} "
          f"live lanes")


def run_paged_slice(torch, seed: int):
    import numpy as np

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import (ContinuousScheduler,
                                               poisson_trace)

    batch, n_requests, rate, prompt_len, gen_len = 8, 160, 8.0, 16, 16
    max_total = prompt_len * 2 + gen_len * 4 + 1
    base = get_config("tmux-12l-768h")
    paged = ServingConfig(paged=True, page_size=16, use_kernel=True,
                          fuse_demux=True)
    cfg = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=paged)
    print(f"[paged] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"N={cfg.mux.n}, {cfg.dtype}, batch {batch}, page_size 16, "
          f"poisson_trace({n_requests}, rate={rate}, prompt_len="
          f"{prompt_len}, gen_len={gen_len}, max_total={max_total})")
    model = Backbone(cfg, seed=seed, device="cuda").eval()
    trace = poisson_trace(n_requests, rate=rate, prompt_len=prompt_len,
                          gen_len=gen_len, vocab=cfg.vocab,
                          max_total=max_total, seed=seed)

    def variant(serving, mux_kernel):
        c = dataclasses.replace(base, serving=serving, mux=dataclasses
                                .replace(base.mux, use_kernel=mux_kernel))
        m = Backbone(c, seed=seed, device="cuda").eval()
        m.load_state_dict(model.state_dict())
        return m

    def scheduler(m, **serving):
        if serving:
            m = variant(dataclasses.replace(m.cfg.serving, **serving),
                        m.cfg.mux.use_kernel)
        return ContinuousScheduler(Engine(m, batch=batch, max_len=max_total))

    scheduler(model).run([r.fresh() for r in trace[:16]])   # warm-up
    torch.cuda.synchronize()

    _build.LAUNCHES.clear()
    sched = scheduler(model)
    forced = []
    record_teacher_forced(sched, forced)
    t0 = time.perf_counter()
    stats = sched.run([r.fresh() for r in trace])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    alloc = sched.allocator
    print(f"[paged] {stats.finished}/{n_requests} requests, "
          f"{stats.decode_steps} decode steps, {stats.generated_tokens} "
          f"tokens in {dt:.4f} s = {stats.generated_tokens / dt:.1f} tok/s, "
          f"{dt / stats.decode_steps * 1e3:.3f} ms per step (bf16, "
          f"{torch.cuda.get_device_name(0)}); peak {stats.peak_pages}/"
          f"{alloc.table.usable_pages} pages, {stats.slot_resets} slot "
          f"resets, occupancy {stats.mean_occupancy:.3f}")
    print(f"[paged] kernel launches in that run: {launches}")
    if stats.finished != n_requests:
        raise SystemExit("[paged] FAIL: not every request finished")
    if alloc.table.pages_in_use != alloc.n_prefix_pages * batch:
        raise SystemExit(f"[paged] FAIL: {alloc.table.pages_in_use} pages in "
                         f"use after the drain, expected only the "
                         f"{alloc.n_prefix_pages * batch} prefix pages")
    want = cfg.n_layers * stats.decode_steps
    if launches.get("paged_decode_attention", 0) != want:
        raise SystemExit(f"[paged] FAIL: paged_decode_attention launched "
                         f"{launches.get('paged_decode_attention', 0)} "
                         f"times, expected {want}")
    for name in ("decode_demux", "hadamard_mux"):
        if not launches.get(name):
            raise SystemExit(f"[paged] FAIL: {name} never launched")

    plain = scheduler(variant(ServingConfig(), False))
    plain_forced = []
    record_teacher_forced(plain, plain_forced)
    pstats = plain.run([r.fresh() for r in trace])
    paged_plain = scheduler(variant(dataclasses.replace(paged,
                                                        use_kernel=False,
                                                        fuse_demux=False),
                                    False))
    ppstats = paged_plain.run([r.fresh() for r in trace])
    for what, a, b in (("decode steps", stats.decode_steps,
                        pstats.decode_steps),
                       ("generated tokens", stats.generated_tokens,
                        pstats.generated_tokens),
                       ("slot resets (paged, kernels off)",
                        stats.slot_resets, ppstats.slot_resets),
                       ("peak pages (paged, kernels off)",
                        stats.peak_pages, ppstats.peak_pages)):
        print(f"[paged] {what}: kernels on {a}, plain {b}")
        if a != b:
            raise SystemExit(f"[paged] FAIL: {what} differ")
    print(f"[paged] slot resets of the contiguous plain run: "
          f"{pstats.slot_resets} (a contiguous slot is rewound when it is "
          f"next admitted into, a paged one the step it drains)")
    steps = min(len(forced), len(plain_forced))
    if steps < 1 or len(forced) != len(plain_forced):
        raise SystemExit(f"[paged] FAIL: teacher-forced steps {len(forced)} "
                         f"vs {len(plain_forced)}")
    for i in range(steps):
        got, ref = forced[i], plain_forced[i]
        if not bool(torch.isfinite(got).all()):
            raise SystemExit(f"[paged] FAIL: non-finite logits at step {i}")
        err = (got - ref).abs().max().item()
        tol = LOGIT_TOL * ref.abs().max().item()
        live = ref.abs().amax(-1) > 0
        agree = (got.argmax(-1) == ref.argmax(-1))[live].float().mean().item()
        print(f"[paged] teacher-forced step {i}: paged kernels vs "
              f"contiguous plain logits max_abs_err {err:.4g} (tol "
              f"{tol:.4g}), greedy tokens agree {agree:.4f} on "
              f"{int(live.sum())} live lanes")
        if not err <= tol:
            raise SystemExit(f"[paged] FAIL: logits disagree at step {i}")

    profile_scheduler(torch, scheduler(model), trace)
    host_logits_ms(torch, batch, cfg)

    _build.LAUNCHES.clear()
    chunked = scheduler(model, prefill_chunk=4)
    cstats = chunked.run([r.fresh() for r in trace[:40]])
    torch.cuda.synchronize()
    claunch = dict(_build.LAUNCHES)
    ramp = [q.ramp_latency for q in chunked.finished]
    print(f"[paged] prefill_chunk=4 on the first 40 requests: "
          f"{cstats.finished}/40 finished, {cstats.decode_steps} decode "
          f"steps, ramp mean {np.mean(ramp):.2f} steps, launches {claunch}")
    if cstats.finished != 40 or claunch.get("paged_decode_attention", 0) \
            != cfg.n_layers * cstats.decode_steps:
        raise SystemExit("[paged] FAIL: the prefill_chunk=4 run")
    run_wide_chunk(torch, scheduler, variant, paged, trace[:40],
                   cfg.n_layers)
    return launches


def run_wide_chunk(torch, scheduler, variant, paged, trace, n_layers):
    """The same 40 requests at prefill_chunk=17 and kblock_pages=16 (17
    query rows per slot, two row groups in the paged kernel; a K-block
    width the earlier kernel refused), every kernel on, held against the
    same run on the plain path (paged, every kernel off): equal decode steps,
    generated tokens and peak pages; the teacher-forced steps' logits
    within LOGIT_TOL and their greedy tokens equal wherever the plain
    top-1 margin exceeds twice that tolerance."""
    from repro_torch.configs.base import ServingConfig
    from repro_torch.kernels import _build

    wide = dict(prefill_chunk=17, kblock_pages=16)
    runs = {}
    for label, sched in (
            ("kernels", scheduler(variant(dataclasses.replace(paged, **wide),
                                          True))),
            ("plain", scheduler(variant(ServingConfig(
                paged=True, page_size=paged.page_size, **wide), False)))):
        forced = []
        record_teacher_forced(sched, forced)
        _build.LAUNCHES.clear()
        stats = sched.run([r.fresh() for r in trace])
        torch.cuda.synchronize()
        runs[label] = (stats, forced, dict(_build.LAUNCHES))
    (stats, forced, launch), (pstats, pforced, plaunch) = (runs["kernels"],
                                                           runs["plain"])
    print(f"[paged] prefill_chunk=17, kblock_pages=16 on the first "
          f"{len(trace)} requests: {stats.finished} finished, "
          f"{stats.decode_steps} decode steps, {stats.generated_tokens} "
          f"tokens, peak {stats.peak_pages} pages, launches {launch}; "
          f"plain path launches {plaunch}")
    if stats.finished != len(trace) or plaunch:
        raise SystemExit("[paged] FAIL: the prefill_chunk=17 run")
    want = {"paged_decode_attention": n_layers * stats.decode_steps}
    if launch.get("paged_decode_attention") != want[
            "paged_decode_attention"] or not (launch.get("hadamard_mux")
                                              and launch.get("decode_demux")):
        raise SystemExit(f"[paged] FAIL: prefill_chunk=17 launches {launch}")
    for what in ("decode_steps", "generated_tokens", "peak_pages"):
        a, b = getattr(stats, what), getattr(pstats, what)
        print(f"[paged] prefill_chunk=17 {what}: kernels {a}, plain {b}")
        if a != b:
            raise SystemExit(f"[paged] FAIL: prefill_chunk=17 {what} differ")
    check_forced("[paged] prefill_chunk=17", forced, pforced)


def device_rows(events, steps: int) -> list[tuple[float, str]]:
    """(ms per step, name) of each kernel, copy or fill the device ran, by
    name, largest first.  Only the profiler's device events count: a CPU
    op's self device time repeats the time of the kernels it launched, so
    summing both would count that time twice."""
    from torch.autograd import DeviceType

    return sorted(((e.self_device_time_total / 1e3 / steps, e.key)
                   for e in events if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0), reverse=True)


MIXER_LABELS = ("mla", "mamba", "mlstm", "slstm", "cross", "encoder")


def device_launches(events, steps: int) -> float:
    """Kernels, copies and fills the device ran per step (the profiler's
    device events, user annotations excluded)."""
    from torch.autograd import DeviceType

    return sum(e.count for e in events if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)) / steps


def print_stages(events, steps: int, label: str) -> None:
    """Device ms per step of each profiler label of the MoE block
    (``moe.route``, ``moe.dispatch``, ``moe.experts``, ``moe.combine``,
    ``moe.shared``), of the MLA, Mamba, mLSTM and sLSTM mixers (``mla``,
    ``mamba``, ``mlstm``, ``slstm``), of the cross-attention (``cross``)
    and of the encoder stack (``encoder``): the kernels launched inside
    the label; the mixers' also as a share of the device's busy time."""
    from torch.autograd import DeviceType

    stages = sorted((e.key, e.device_time_total / 1e3 / steps, e.count)
                    for e in events if (e.key.startswith("moe.")
                                        or e.key in MIXER_LABELS)
                    and e.device_type == DeviceType.CPU)
    if stages:
        busy = sum(t for t, _ in device_rows(events, steps))
        print(f"[profile] {label}: MoE stages and mixers, device ms per "
              f"step: "
              + ", ".join(f"{key} {t:.4f} (x{count / steps:.0f})"
                          for key, t, count in stages))
        for key, t, _ in stages:
            if key in MIXER_LABELS and busy:
                print(f"[profile] {label}: {key} share of device busy time "
                      f"{t / busy:.4f} ({t:.4f} of {busy:.4f} ms)")


def profile_scheduler(torch, sched, trace, warm: int = 12, steps: int = 8,
                      label: str = "paged scheduler step"):
    """Wall time of a scheduler step in steady state (host clock around
    ``steps`` steps ending in a synchronize), then where one step's device
    time goes (torch.profiler over ``steps`` more)."""
    from torch.profiler import ProfilerActivity, profile

    for r in trace:
        sched.submit(r.fresh())
    for _ in range(warm):
        sched.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        sched.step()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / steps * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(steps):
            sched.step()
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = device_rows(events, steps)
    busy = sum(t for t, _ in rows)
    lanes = int(sched.table.lane_mask().sum())
    print(f"[profile] {label} ({lanes} live lanes after "
          f"{warm + 2 * steps} steps): {wall:.3f} ms wall (unprofiled)")
    if not busy:
        print(f"[profile] {label}: device time not measured "
              "(the profiler saw no device activity)")
        return
    print(f"[profile] {label}: device busy {busy:.3f} ms per "
          f"step, idle share {1 - busy / wall:.3f}, "
          f"{device_launches(events, steps):.0f} device launches per step")
    for t, key in rows[:10]:
        print(f"[profile]   {t:8.4f} ms  {key[:90]}")
    print_stages(events, steps, label)
    host = sorted(((e.self_cpu_time_total / 1e3 / steps, e.count / steps,
                    e.key) for e in events), reverse=True)
    print(f"[profile] {label}: host time per step by op "
          "(self, profiled):")
    for t, count, key in host[:8]:
        print(f"[profile]   {t:8.4f} ms  x{count:5.0f}  {key[:80]}")


def host_logits_ms(torch, batch: int, cfg, runs: int = 11) -> None:
    """Host wall time of the scheduler's per-step logits transfer: one
    (B, N, vocab) bf16 tensor to the host, then float32 numpy."""
    from repro_torch.serving.scheduler import _host_logits

    logits = torch.randn((batch, cfg.mux.n, cfg.vocab), device="cuda",
                         dtype=torch.bfloat16)
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _host_logits(logits)
        times.append((time.perf_counter() - t0) * 1e3)
    print(f"[profile] per-step logits to the host ({batch}x{cfg.mux.n}x"
          f"{cfg.vocab} bf16, {logits.numel() * 2 / 1e6:.1f} MB, then f32 "
          f"numpy): median {statistics.median(times):.3f} ms of {runs}")


def decode_step_ms(torch, eng, state, first, steps: int = 8) -> float:
    """Host wall time of one decode step from ``state``, averaged over
    ``steps`` steps and ending in a synchronize."""
    last = first
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(steps):
        logits, state = eng.step(state, last)
        last = logits.argmax(-1)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / steps * 1e3


def profile_decode(torch, eng, prompts, first, label: str, wall: float,
                   steps: int = 8, context=None):
    """Where the device time of a decode step goes (torch.profiler: self
    device time per kernel name, and per profiler label) and the host's
    time per op; ``wall`` is the unprofiled step time the idle share is
    taken against; ``context`` goes to the prefill."""
    from torch.profiler import ProfilerActivity, profile

    state = eng.prefill(prompts, context=context)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_step_ms(torch, eng, state, first, steps)
    events = prof.key_averages()
    rows = device_rows(events, steps)
    busy = sum(t for t, _ in rows)
    if not busy:
        print(f"[profile] {label}: device time not measured (the profiler "
              f"saw no device activity)")
        return
    print(f"[profile] {label}: decode step {wall:.3f} ms wall (median), "
          f"device busy {busy:.3f} ms per step, idle share "
          f"{1 - busy / wall:.3f}")
    for t, key in rows[:8]:
        print(f"[profile]   {t:8.4f} ms  {key[:90]}")
    print_stages(events, steps, label)
    host = sorted(((e.self_cpu_time_total / 1e3 / steps, e.count / steps,
                    e.key) for e in events), reverse=True)
    print(f"[profile] {label}: host time per step by op (self, profiled):")
    for t, count, key in host[:8]:
        print(f"[profile]   {t:8.4f} ms  x{count:5.0f}  {key[:80]}")


def profile_prefill(torch, eng, prompts, context, label: str) -> None:
    """Device time of one ``Engine.prefill`` over ``context`` (the context
    encoded, then the prompt), with the profiler labels' share."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        eng.prefill(prompts, context=context)
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(t for t, _ in device_rows(events, 1))
    if not busy:
        print(f"[profile] {label}: device time not measured (the profiler "
              f"saw no device activity)")
        return
    print(f"[profile] {label}: device busy {busy:.3f} ms, "
          f"{device_launches(events, 1):.0f} device launches")
    print_stages(events, 1, label)


# ---------------------------------------------------------------------------
# Phase 6: the replica router
# ---------------------------------------------------------------------------

def held_bytes(obj) -> int:
    """Bytes of the device tensors reachable from ``obj`` (a scheduler: its
    engine, width classes, allocators, cache or page pool, primed prefix),
    each storage once, not counting any ``nn.Module``'s weights."""
    import torch
    from torch import nn

    seen, storages, stack = set(), {}, [obj]
    while stack:
        o = stack.pop()
        if id(o) in seen or isinstance(o, (nn.Module, str, bytes, type)):
            continue
        seen.add(id(o))
        if torch.is_tensor(o):
            if o.is_cuda:
                st = o.untyped_storage()
                storages[st.data_ptr()] = st.nbytes()
        elif isinstance(o, dict):
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set)):
            stack.extend(o)
        elif hasattr(o, "__dict__"):
            stack.extend(vars(o).values())
    return sum(storages.values())


def run_router(torch, seed: int):
    """The replica router over the paged slice's model and trace: (a) R = 1
    round-robin against the bare scheduler, kernels on, bitwise; (b) R = 2
    least_loaded, kernels on against the plain path; (c) the weights held
    once."""
    import gc

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.router import ReplicaRouter
    from repro_torch.serving.scheduler import (ContinuousScheduler,
                                               poisson_trace)

    gc.collect()
    torch.cuda.empty_cache()
    batch, n_requests, rate, prompt_len, gen_len = 8, 160, 8.0, 16, 16
    max_total = prompt_len * 2 + gen_len * 4 + 1
    base = get_config("tmux-12l-768h")
    paged = ServingConfig(paged=True, page_size=16, use_kernel=True,
                          fuse_demux=True)
    cfg = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=paged)
    plain_cfg = dataclasses.replace(base, serving=ServingConfig(
        paged=True, page_size=16))
    print(f"[router] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"N={cfg.mux.n}, {cfg.dtype}, batch {batch} per replica, "
          f"page_size 16, mux + fused decode demux + paged kernels; "
          f"poisson_trace({n_requests}, rate={rate}, prompt_len="
          f"{prompt_len}, gen_len={gen_len}, max_total={max_total})")
    model = Backbone(cfg, seed=seed, device="cuda").eval()
    trace = poisson_trace(n_requests, rate=rate, prompt_len=prompt_len,
                          gen_len=gen_len, vocab=cfg.vocab,
                          max_total=max_total, seed=seed)

    def build(m, replicas, policy):
        return ReplicaRouter.build(m, batch=batch, max_len=max_total,
                                   replicas=replicas, policy=policy)

    build(model, 2, "least_loaded").run([r.fresh() for r in trace[:16]])
    torch.cuda.synchronize()

    # (a) R = 1 round-robin is the bare scheduler, bitwise, kernels on
    bare = ContinuousScheduler(Engine(model, batch=batch, max_len=max_total))
    bstats = bare.run([r.fresh() for r in trace])
    one = build(model, 1, "round_robin")
    ostats = one.run([r.fresh() for r in trace])
    same = ({q.rid: (q.output, q.ttft) for q in one.finished}
            == {q.rid: (q.output, q.ttft) for q in bare.finished})
    print(f"[router] (a) R=1 round_robin vs the bare scheduler, kernels on: "
          f"decode steps {ostats.decode_steps} / {bstats.decode_steps}, "
          f"tokens {ostats.generated_tokens} / {bstats.generated_tokens}, "
          f"every token and TTFT identical: {same}")
    if not (same and ostats.decode_steps == bstats.decode_steps
            and ostats.finished == n_requests):
        raise SystemExit("[router] FAIL: the R=1 router is not the bare "
                         "scheduler")
    del bare, one
    gc.collect()

    # (b) R = 2 least_loaded, kernels on against the plain path
    plain_model = Backbone(plain_cfg, seed=seed, device="cuda").eval()
    plain_model.load_state_dict(model.state_dict())
    runs = {}
    for label, m in (("kernels", model), ("plain", plain_model)):
        router = build(m, 2, "least_loaded")
        forced = [[] for _ in router.replicas]
        for sched, keep in zip(router.replicas, forced):
            record_teacher_forced(sched, keep)
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        t0 = time.perf_counter()
        stats = router.run([r.fresh() for r in trace])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        runs[label] = (router, stats, forced, dict(_build.LAUNCHES), dt)
    router, stats, forced, launches, dt = runs["kernels"]
    _, pstats, pforced, plaunch, pdt = runs["plain"]
    print(f"[router] (b) R=2 least_loaded: {stats.finished}/{n_requests} "
          f"requests, {stats.router_steps} router steps, "
          f"{stats.decode_steps} decode steps, {stats.generated_tokens} "
          f"tokens in {dt:.4f} s = {stats.generated_tokens / dt:.1f} tok/s, "
          f"{dt / stats.router_steps * 1e3:.3f} ms per router step (bf16, "
          f"{torch.cuda.get_device_name(0)}); plain path {pdt:.4f} s = "
          f"{pstats.generated_tokens / pdt:.1f} tok/s, "
          f"{pdt / pstats.router_steps * 1e3:.3f} ms per router step")
    for i, rep in enumerate(stats.per_replica):
        load = rep["load"]
        print(f"[router]   replica {i}: {rep['dispatched']} dispatched, "
              f"{rep['finished']} finished, {rep['decode_steps']} decode "
              f"steps, {rep['idle_steps']} idle, lane use (mean occupancy) "
              f"{rep['mean_occupancy']:.3f}, peak {rep['peak_pages']}/"
              f"{load['usable_pages']} pages")
    print(f"[router] kernel launches in that run: {launches}; plain path "
          f"{plaunch}")
    if stats.finished != n_requests or plaunch:
        raise SystemExit("[router] FAIL: the R=2 runs")
    if launches.get("paged_decode_attention") != \
            cfg.n_layers * stats.decode_steps or not (
                launches.get("hadamard_mux") and launches.get("decode_demux")):
        raise SystemExit(f"[router] FAIL: launches {launches}")
    for what in ("router_steps", "decode_steps", "generated_tokens",
                 "dispatched", "requeues"):
        a, b = getattr(stats, what), getattr(pstats, what)
        print(f"[router] {what}: kernels {a}, plain {b}")
        if a != b:
            raise SystemExit(f"[router] FAIL: {what} differ")
    for i, (got_steps, ref_steps) in enumerate(zip(forced, pforced)):
        if not got_steps or len(got_steps) != len(ref_steps):
            raise SystemExit(f"[router] FAIL: replica {i} teacher-forced "
                             f"steps {len(got_steps)} vs {len(ref_steps)}")
        worst, clear_n, equal_n, live_n, agree_n = 0.0, 0, 0, 0, 0
        for got, ref in zip(got_steps, ref_steps):
            err = (got - ref).abs().max().item()
            tol = LOGIT_TOL * ref.abs().max().item()
            top2 = ref.topk(2, dim=-1).values
            clear = (top2[..., 0] - top2[..., 1]) > 2 * tol
            same_tok = got.argmax(-1) == ref.argmax(-1)
            live = ref.abs().amax(-1) > 0
            worst = max(worst, err / tol)
            clear_n += int(clear.sum())
            equal_n += int(same_tok[clear].sum())
            live_n += int(live.sum())
            agree_n += int(same_tok[live].sum())
            if not (err <= tol and bool(torch.isfinite(got).all())
                    and bool(same_tok[clear].all())):
                raise SystemExit(f"[router] FAIL: replica {i} logits "
                                 f"disagree with the plain path")
        print(f"[router] replica {i}: {len(got_steps)} teacher-forced steps, "
              f"logits within {worst:.3f} of LOGIT_TOL, greedy tokens equal "
              f"on {equal_n} of {clear_n} lanes with a clear margin and "
              f"agree on {agree_n} of {live_n} live lanes")
    del runs, router, plain_model
    gc.collect()
    torch.cuda.empty_cache()

    # (c) the weights are held once: a second replica adds its own cache,
    # pool and primed prefix, not another copy of the weights
    grown = {}
    for r in (1, 2):
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        router = build(model, r, "least_loaded")
        torch.cuda.synchronize()
        grown[r] = (torch.cuda.memory_allocated() - before,
                    held_bytes(router.replicas[-1]))
        del router
        gc.collect()
    second = grown[2][0] - grown[1][0]
    own = grown[2][1]
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    print(f"[router] (c) memory_allocated: R=1 +{grown[1][0] / 1e6:.2f} MB, "
          f"R=2 +{grown[2][0] / 1e6:.2f} MB; the second replica adds "
          f"{second / 1e6:.2f} MB against its own cache, pool and prefix "
          f"{own / 1e6:.2f} MB (weights {weights / 1e6:.1f} MB, held once)")
    if not second <= 1.05 * own:
        raise SystemExit("[router] FAIL: the second replica holds more than "
                         "its own cache and pool")
    return launches


# ---------------------------------------------------------------------------
# Phase 7: the training half
# ---------------------------------------------------------------------------

def run_train(torch, seed: int):
    """``Trainer.make_train_step`` on tmux-12l-768h at full width, bf16, the
    retrieval warm-up task: (a) finite loss and grad norm at every step;
    (b) an f32 config's steps on the card against the CPU; (c) the trained
    weights evaluated through the mux and demux kernels against the plain
    path; (d) a kernel-on config refused."""
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.kernels import _build
    from repro_torch.training.trainer import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    groups, seq_len, steps = 8, 128, 10
    cfg = get_config("tmux-12l-768h")
    n = cfg.mux.n
    tcfg = TrainConfig(task="retrieval", lr=3e-3, warmup=1,
                       total_steps=steps)
    print(f"[train] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"N={n}, {cfg.dtype}; {steps} steps of the retrieval task, "
          f"{groups} groups x {n} x {seq_len} tokens, lr {tcfg.lr}, warmup "
          f"{tcfg.warmup}")
    state = Trainer.init_state(cfg, tcfg, seed=seed, device="cuda")
    batches = [{k: torch.as_tensor(v).long().cuda() for k, v in b.items()}
               for b in mux_batches(RetrievalTask(vocab=cfg.vocab,
                                                  seq_len=seq_len),
                                    groups=groups, n_mux=n, steps=steps + 2,
                                    seed=seed)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    step = Trainer.make_train_step(cfg, tcfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    walls, losses = [], []
    for i, b in enumerate(batches[:steps]):
        t0 = time.perf_counter()
        state, m = step(state, b, gen)
        vals = {k: float(v) for k, v in m.items()}     # waits for the step
        walls.append((time.perf_counter() - t0) * 1e3)
        losses.append(vals)
        print(f"[train] step {i}: loss {vals['loss']:.6g}, grad_norm "
              f"{vals['grad_norm']:.6g}, {walls[-1]:.3f} ms")
        if not (math.isfinite(vals["loss"])
                and math.isfinite(vals["grad_norm"])):
            raise SystemExit(f"[train] FAIL: step {i} is not finite: {vals}")
    ms = statistics.median(walls[2:])
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[train] {ms:.3f} ms per step (median of steps 2-{steps - 1}), "
          f"{groups * n / ms * 1e3:.1f} instances/s, "
          f"{groups * n * seq_len / ms * 1e3:.1f} tokens/s, peak memory "
          f"{peak_gb:.2f} GB (bf16, {torch.cuda.get_device_name(0)})")
    profile_train(torch, step, state, batches[steps], gen, ms, cfg, tcfg)

    check_train_on_card(torch, seed)

    # (c) the trained weights through the kernels, against the plain path
    kcfg = dataclasses.replace(cfg, mux=dataclasses.replace(cfg.mux,
                                                            use_kernel=True))
    ecfg = TrainConfig(task="lm")
    kernel_state = {"model": state["model"].with_config(kcfg)}
    index = [torch.randint(0, n, (groups, seq_len), generator=gen,
                           device="cuda") for _ in range(2)]
    evals = {}
    for label, st, c in (("kernels", kernel_state, kcfg),
                         ("plain", state, cfg)):
        fn = Trainer.make_eval_step(c, ecfg)
        _build.LAUNCHES.clear()
        evals[label] = [fn(st, b, None, retr_index=ix)
                        for b, ix in zip(batches[steps:], index)]
        torch.cuda.synchronize()
        evals[label + " launches"] = dict(_build.LAUNCHES)
    want = {"hadamard_mux": 2, "index_embed_demux": 2}
    print(f"[train] eval of the trained weights, kernel launches: "
          f"{evals['kernels launches']}; plain {evals['plain launches']}")
    if evals["kernels launches"] != want or evals["plain launches"]:
        raise SystemExit(f"[train] FAIL: eval launches, expected {want}")
    for i, (m, pm) in enumerate(zip(evals["kernels"], evals["plain"])):
        for key in ("task_loss", "retr_loss"):
            got, ref = float(m[key]), float(pm[key])
            rel = abs(got - ref) / abs(ref)
            print(f"[train] eval batch {i} {key}: kernels {got:.6g}, plain "
                  f"{ref:.6g}, relative diff {rel:.3g} (tol {EVAL_LOSS_TOL})")
            if not rel <= EVAL_LOSS_TOL:
                raise SystemExit(f"[train] FAIL: eval {key} disagrees")

    # (d) no kernel has a backward: a kernel-on config is refused
    try:
        Trainer.make_train_step(kcfg, tcfg)
    except ValueError as e:
        print(f"[train] (d) make_train_step on a kernel-on config raises: "
              f"{str(e)[:80]}...")
    else:
        raise SystemExit("[train] FAIL: make_train_step took a kernel-on "
                         "config")
    return evals["kernels launches"]


def profile_train(torch, step, state, batch, gen, wall, cfg, tcfg) -> None:
    """Where one train step's device time goes (torch.profiler), and the
    device operations and device time of the optimizer update alone (clip
    and AdamW over copies of the parameters and moments)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.bridge import decay_mask
    from repro_torch.optim import clip_by_global_norm
    from repro_torch.training.trainer import Trainer

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, gen)
        torch.cuda.synchronize()
    rows = device_rows(prof.key_averages(), 1)
    busy = sum(t for t, _ in rows)
    if not busy:
        print("[profile] train step: device time not measured (the profiler "
              "saw no device activity)")
    else:
        print(f"[profile] train step: {wall:.3f} ms wall (unprofiled "
              f"median), device busy {busy:.3f} ms, idle share "
              f"{1 - busy / wall:.3f}")
        for t, key in rows[:12]:
            print(f"[profile]   {t:9.4f} ms  {key[:90]}")

    params = {k: p.detach().clone() for k, p in Trainer.params(state).items()}
    grads = {k: p.clone() for k, p in params.items()}
    opt_state = {"mu": {k: t.clone() for k, t in
                        state["opt_state"]["mu"].items()},
                 "nu": {k: t.clone() for k, t in
                        state["opt_state"]["nu"].items()},
                 "step": state["opt_state"]["step"]}
    opt = Trainer.make_optimizer(tcfg)
    decay = decay_mask(cfg, params)

    def update():
        clipped, _ = clip_by_global_norm(grads, tcfg.grad_clip)
        opt.step_(clipped, opt_state, params, decay)

    walls = []
    for _ in range(6):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        update()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    host_ms = statistics.median(walls[1:])
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        update()
        torch.cuda.synchronize()
    ops = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    dev_ms = sum(e.self_device_time_total for e in ops) / 1e3
    print(f"[profile] optimizer update (clip + AdamW over {len(params)} "
          f"tensors, {sum(p.numel() for p in params.values()) / 1e6:.1f}M "
          f"params): {len(ops)} device operations, device time "
          f"{dev_ms:.3f} ms, {host_ms:.3f} ms wall (median of 5 after a "
          f"warm-up: {[round(w, 3) for w in walls[1:]]})")


def check_train_on_card(torch, seed: int) -> None:
    """(b) f32, 2 layers, d 256: 3 train steps on the card and on the CPU
    from the same weights and retrieval indices; losses within 1e-4
    relative, step 1's grads within 1e-4 x max|g| per tensor."""
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.training.trainer import TrainConfig, Trainer

    cfg = dataclasses.replace(get_smoke_config("tmux-12l-768h", mux_n=8),
                              n_layers=2)
    tcfg = TrainConfig(task="retrieval", lr=1e-3, warmup=1, total_steps=10)
    states = {d: Trainer.init_state(cfg, tcfg, seed=seed, device=d)
              for d in ("cpu", "cuda")}
    states["cuda"]["model"].load_state_dict(
        states["cpu"]["model"].state_dict())
    batches = list(mux_batches(RetrievalTask(vocab=cfg.vocab, seq_len=32),
                               groups=4, n_mux=8, steps=3, seed=seed))
    g = torch.Generator().manual_seed(seed)
    index = [torch.randint(0, 8, (4, 32), generator=g) for _ in batches]
    tb = {k: torch.as_tensor(v).long() for k, v in batches[0].items()}
    grads = {d: Trainer.grads(s, {k: v.to(d) for k, v in tb.items()}, None,
                              cfg, tcfg, retr_index=index[0])[2]
             for d, s in states.items()}
    ratio = {k: ((grads["cuda"][k].cpu() - want).abs().max()
                 / want.abs().max()).item()
             for k, want in grads["cpu"].items()}
    worst = max((r for r in ratio.values() if not math.isnan(r)),
                default=0.0)         # nan where a grad is all zero
    bad = [k for k, r in ratio.items()
           if not (r <= 1e-4 or torch.equal(grads["cuda"][k].cpu(),
                                             grads["cpu"][k]))]
    fns = {d: Trainer.make_train_step(cfg, tcfg) for d in states}
    rel = []
    for b, ix in zip(batches, index):
        got = {d: float(fns[d](s, b, None, retr_index=ix)[1]["loss"])
               for d, s in states.items()}
        rel.append(abs(got["cuda"] - got["cpu"]) / abs(got["cpu"]))
    print(f"[train] (b) f32 {cfg.n_layers} layers d {cfg.d_model}, card vs "
          f"CPU: step-1 grads within {worst:.3g} x max|g| (tol 1e-4; "
          f"{len(bad)} tensors outside), "
          f"losses' relative diffs {[f'{r:.3g}' for r in rel]} (tol 1e-4)")
    if bad or not max(rel) <= 1e-4:
        raise SystemExit("[train] FAIL: the card's f32 steps disagree with "
                         "the CPU's")


# ---------------------------------------------------------------------------
# Phase 7b: the mesh at world 1
# ---------------------------------------------------------------------------

def run_mesh(torch, seed: int):
    """tmux-12l-768h at full width on a world-1 ``nccl`` group and the
    (1, 1) mesh of ``make_test_mesh``, where every collective is the
    identity: (a) three train steps on the mesh bitwise three plain steps
    (loss, every parameter and moment), the rank's bytes of parameters and
    moments against its specs' count; (b) lock-step ``generate`` with the
    mux and demux kernels on the mesh bitwise the same run without one
    (tokens, prefill and step logits), counting the kernels' launches in
    the mesh run; (d) llama4-scout's expert parallelism
    (``run_mesh_moe``); (c) both launchers on a 1,1 mesh as subprocesses.
    The wall ms of a train and a decode step with and without the mesh, in
    turns.  Returns the mux and demux launches of (b) and (d)."""
    import gc
    import os

    import torch.distributed as dist

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.kernels import _build
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding import mesh_info_from_mesh, state_specs
    from repro_torch.sharding.placement import gather_state, state_bytes
    from repro_torch.training.trainer import TrainConfig, Trainer

    gc.collect()
    torch.cuda.empty_cache()
    mesh = make_test_mesh("cuda")
    mi = mesh_info_from_mesh(mesh)
    card = torch.cuda.get_device_name(0)
    print(f"[mesh] world {dist.get_world_size()} ({dist.get_backend()}), "
          f"mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    try:
        # (a) the train step
        groups, seq_len, steps = 8, 128, 3
        cfg = get_config("tmux-12l-768h")
        n = cfg.mux.n
        tcfg = TrainConfig(task="retrieval", lr=3e-3, warmup=1,
                           total_steps=10)
        batches = [{k: torch.as_tensor(v).long().cuda()
                    for k, v in b.items()}
                   for b in mux_batches(RetrievalTask(vocab=cfg.vocab,
                                                      seq_len=seq_len),
                                        groups=groups, n_mux=n, steps=steps,
                                        seed=seed)]
        runs = {}
        for label, kw in (("plain", {}),
                          ("mesh", dict(mesh=mesh, mesh_info=mi))):
            runs[label] = dict(
                state=Trainer.init_state(cfg, tcfg, seed=seed,
                                         device="cuda"),
                step=Trainer.make_train_step(cfg, tcfg, **kw),
                gen=torch.Generator(device="cuda").manual_seed(seed),
                losses=[], walls=[])
        for b in batches:                  # in turns: plain, mesh
            for r in runs.values():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                r["state"], m = r["step"](r["state"], b, r["gen"])
                torch.cuda.synchronize()
                r["walls"].append((time.perf_counter() - t0) * 1e3)
                r["losses"].append(m["loss"])
        plain, on_mesh = runs["plain"], runs["mesh"]
        for label, r in runs.items():
            print(f"[mesh] (a) {label} train steps: losses "
                  f"{[float(x) for x in r['losses']]}, wall ms "
                  f"{[round(w, 3) for w in r['walls']]}")
        whole = gather_state(on_mesh["state"])
        same = (all(torch.equal(a, b) for a, b in zip(plain["losses"],
                                                      on_mesh["losses"]))
                and all(torch.equal(p, q) for p, q in zip(
                    Trainer.params(plain["state"]).values(),
                    Trainer.params(on_mesh["state"]).values()))
                and all(torch.equal(plain["state"]["opt_state"][m][k],
                                    whole["opt_state"][m][k])
                        for m in ("mu", "nu")
                        for k in whole["opt_state"][m]))
        held, want = state_bytes(on_mesh["state"],
                                 state_specs(on_mesh["state"], mi), mi)
        print(f"[mesh] (a) {steps} steps on the mesh bitwise the plain "
              f"steps (loss, parameters, moments): {same}; the rank holds "
              f"{held} B of parameters and moments, its specs give {want} "
              f"B; train step wall ms (median) "
              f"{statistics.median(on_mesh['walls']):.3f} on the mesh, "
              f"{statistics.median(plain['walls']):.3f} without ({card})")
        if not same or held != want:
            raise SystemExit("[mesh] FAIL: the mesh train step differs "
                             "from the plain step or its bytes from its "
                             "specs")
        del runs, plain, on_mesh, whole
        gc.collect()
        torch.cuda.empty_cache()

        # (b) lock-step serving with the mux and demux kernels
        batch, prompt_len, gen_steps = 8, 64, 16
        base = get_config("tmux-12l-768h")
        kcfg = dataclasses.replace(
            base, mux=dataclasses.replace(base.mux, use_kernel=True),
            serving=ServingConfig(fuse_demux=True))
        model = Backbone(kcfg, seed=seed, device="cuda").eval()
        engines = {"mesh": Engine(model, batch=batch,
                                  max_len=prompt_len + gen_steps + 1,
                                  mesh=mesh, mesh_info=mi),
                   "plain": Engine(model, batch=batch,
                                   max_len=prompt_len + gen_steps + 1)}
        g = torch.Generator(device="cuda").manual_seed(seed)
        prompts = torch.randint(0, kcfg.vocab, (batch, n, prompt_len),
                                generator=g, device="cuda")
        for e in engines.values():
            e.generate(prompts, 2)                 # warm-up
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        tokens = {"mesh": engines["mesh"].generate(prompts, gen_steps)}
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        tokens["plain"] = engines["plain"].generate(prompts, gen_steps)
        logits = {}
        for label, e in engines.items():
            first, state = e.prefill(prompts)
            logits[label] = (first, e.step(state, tokens[label][..., 0])[0])
        same = (torch.equal(tokens["mesh"], tokens["plain"])
                and all(torch.equal(a, b) for a, b in zip(logits["mesh"],
                                                          logits["plain"])))
        print(f"[mesh] (b) generate {batch} x {n} streams x {gen_steps} "
              f"tokens with the mux and demux kernels, on the mesh bitwise "
              f"without it (tokens, prefill and step logits): {same}; "
              f"launches in the mesh run {launches}")
        missing = [k for k in ("hadamard_mux", "index_embed_demux",
                               "decode_demux") if not launches.get(k)]
        if not same or missing:
            raise SystemExit(f"[mesh] FAIL: mesh serving differs or never "
                             f"launched {missing}")
        walls = {label: [] for label in engines}
        for label in ("mesh", "plain") * 3:
            e = engines[label]
            walls[label].append(decode_step_ms(
                torch, e, e.prefill(prompts)[1], tokens[label][..., 0]))
        print(f"[mesh] (b) decode step wall ms (in turns): "
              + "; ".join(f"{label} {[round(w, 3) for w in ws]}"
                          for label, ws in walls.items()) + f" ({card})")
        del engines, model
        for name, count in run_mesh_moe(torch, seed, mesh, mi).items():
            launches[name] = launches.get(name, 0) + count
    finally:
        dist.destroy_process_group()

    # (c) the launchers, each its own process with a world-1 nccl group
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    for module, flags, want in (
            ("repro_torch.launch.train",
             ["--device-count", "1", "--arch", "tmux-12l-768h", "--smoke",
              "--mux-n", "8", "--steps", "3", "--batch", "4", "--seq-len",
              "32"], "done; final loss"),
            ("repro_torch.launch.serve",
             ["--arch", "tmux-12l-768h", "--smoke", "--mux-n", "8",
              "--batch", "4", "--prompt-len", "16", "--gen", "8"],
             "tok/s")):
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-m", module, "--mesh-shape",
                              "1,1", *flags], capture_output=True,
                             text=True, timeout=300, env=env)
        for line in out.stdout.splitlines():
            print(f"[mesh] (c) {line}")
        if out.returncode or want not in out.stdout:
            print(out.stderr[-3000:])
            raise SystemExit(f"[mesh] FAIL: {module} on a 1,1 mesh")
        print(f"[mesh] (c) {module} --mesh-shape 1,1: "
              f"{time.perf_counter() - t0:.1f} s")
    return launches


DRYRUN_KEYS = ("compute_s", "memory_s", "collective_s", "dominant",
               "hlo_flops", "collective_bytes", "argument_size_in_bytes",
               "temp_size_in_bytes", "bytes_per_device", "roofline")
DRYRUN_MEM_TOL = 0.15                 # |peak - bytes_per_device|, relative


def dryrun_cli(flags: list, out: Path):
    """``repro_torch.launch.dryrun`` with ``flags`` as a subprocess (its
    own fake process group), writing its record under ``out``."""
    env = dict(os.environ, PYTHONPATH=str(Path(__file__).resolve().parent
                                          / "src"))
    return subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.dryrun", *flags,
         "--out", str(out)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env)


def dryrun_record(proc, out: Path, tag: str) -> dict:
    """The one record ``proc`` (``dryrun_cli``) wrote; fails on a nonzero
    exit or a missing key."""
    stdout, stderr = proc.communicate(timeout=600)
    for line in stdout.splitlines():
        print(f"[dryrun] {tag}: {line}")
    recs = sorted(out.glob("*.json"))
    if proc.returncode or len(recs) != 1:
        print(stderr[-3000:])
        raise SystemExit(f"[dryrun] FAIL: {tag} exited {proc.returncode} "
                         f"with {len(recs)} records")
    rec = json.loads(recs[0].read_text())
    missing = [k for k in DRYRUN_KEYS if k not in rec]
    if missing:
        raise SystemExit(f"[dryrun] FAIL: {tag}'s record lacks {missing}")
    return rec


def run_dryrun(torch, seed: int):
    """The dry-run (``launch/dryrun.py``): (a) its CLI on this machine for
    deepseek-v3-671b's train_4k step on the (2, 16, 16) mesh and
    llama4-scout's decode_32k step on the (16, 16) mesh, each a
    subprocess with its own fake process group, every record key present;
    (b) its (1, 1) records of tmux-12l-768h at the ``[train]`` shape (8 x
    40 x 128, task "lm", float32 moments) with remat "none" and "full"
    against the same step on the card (``make_train_step(mesh=)`` on the
    world-1 ``nccl`` mesh, the plain path): the FLOPs of one step
    (``FlopCounterMode``) equal, the peak of ``max_memory_allocated``
    over three steps within DRYRUN_MEM_TOL of the record's
    ``bytes_per_device``; the predicted max(compute_s, memory_s) printed
    beside the median of five step times, taken once the subprocesses are
    done."""
    import gc
    import shutil

    import torch.distributed as dist
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.configs.registry import get_config
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.sharding import mesh_info_from_mesh
    from repro_torch.training.trainer import TrainConfig, Trainer

    root = Path(__file__).resolve().parent / "build" / "dryrun"
    shutil.rmtree(root, ignore_errors=True)
    groups, seq_len, arch = 8, 128, "tmux-12l-768h"
    n = get_config(arch).mux.n
    cli = {"deepseek-v3-671b train_4k multipod": [
               "--arch", "deepseek-v3-671b", "--shape", "train_4k",
               "--mesh", "multipod"],
           "llama4-scout-17b-a16e decode_32k pod": [
               "--arch", "llama4-scout-17b-a16e", "--shape", "decode_32k",
               "--mesh", "pod"]}
    for remat in ("none", "full"):
        cli[f"{arch} (1, 1) remat {remat}"] = [
            "--arch", arch, "--shape", "train_4k", "--seq-len",
            str(seq_len), "--global-batch", str(groups * n), "--mux-n",
            str(n), "--mesh", "single", "--remat", remat]
    t0 = time.perf_counter()
    procs = {}
    for i, (tag, flags) in enumerate(cli.items()):
        out = root / str(i)
        procs[tag] = (dryrun_cli(flags, out), out)

    # (b) the card's side meanwhile: the same step, remat none and full
    card = torch.cuda.get_device_name(0)
    mesh = make_test_mesh("cuda")
    mi = mesh_info_from_mesh(mesh)
    tcfg = TrainConfig(task="lm", total_steps=1000, state_dtype="float32")

    def train(remat):
        """After one step: the state, and the step on its batch."""
        gc.collect()
        torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config(arch), remat=remat)
        state = Trainer.init_state(cfg, tcfg, seed=seed, device="cuda")
        step = Trainer.make_train_step(cfg, tcfg, mesh=mesh, mesh_info=mi)
        g = torch.Generator(device="cuda").manual_seed(seed)
        batch = {"tokens": torch.randint(
            0, cfg.vocab, (groups, n, seq_len), generator=g, device="cuda",
            dtype=torch.int32)}
        index = torch.randint(0, n, (groups, seq_len), generator=g,
                              device="cuda")
        state, _ = step(state, batch, None, retr_index=index)
        return state, lambda state: step(state, batch, None,
                                         retr_index=index)

    measured = {}
    try:
        for remat in ("none", "full"):
            state, step = train(remat)
            with FlopCounterMode(display=False) as fc:
                state, m = step(state)
            del m
            gc.collect()
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for _ in range(3):
                state, m = step(state)
                loss = float(m["loss"])
                del m
            measured[remat] = dict(flops=fc.get_total_flops(),
                                   peak=torch.cuda.max_memory_allocated(),
                                   loss=loss)
            del state, step

        # (a) and (b): the records
        recs = {tag: dryrun_record(proc, out, tag)
                for tag, (proc, out) in procs.items()}
        # the step times, with the dry-run subprocesses gone
        for remat in ("none", "full"):
            state, step = train(remat)
            torch.cuda.synchronize()
            walls = []
            for _ in range(5):
                t1 = time.perf_counter()
                state, m = step(state)
                float(m["loss"])                   # waits for the step
                walls.append((time.perf_counter() - t1) * 1e3)
                del m
            measured[remat].update(ms=statistics.median(walls), walls=walls)
            del state, step
    finally:
        dist.destroy_process_group()

    print(f"[dryrun] {len(procs)} dry-run subprocesses and the card's "
          f"steps: {time.perf_counter() - t0:.1f} s")
    for tag in list(cli)[:2]:
        r = recs[tag]
        print(f"[dryrun] (a) {tag}: {r['dominant']}-bound (compute "
              f"{r['compute_s']:.6g} s, memory {r['memory_s']:.6g} s, "
              f"collective {r['collective_s']:.6g} s), bytes_per_device "
              f"{r['bytes_per_device']} ({r['bytes_per_device'] / 1e9:.1f} "
              f"GB of which the compute copy {r['compute_copy_bytes']}), "
              f"collective bytes {r['collective_bytes']['total']:.0f} "
              f"{ {k: v for k, v in r['collective_bytes'].items()} }, "
              f"traced in {r['lower_s']} s (a prediction from meta "
              f"tensors)")
    failed = []
    for remat in ("none", "full"):
        r, m = recs[f"{arch} (1, 1) remat {remat}"], measured[remat]
        flops = r["hlo_flops"] / r["n_chips"]
        rel = (m["peak"] - r["bytes_per_device"]) / r["bytes_per_device"]
        predicted = max(r["compute_s"], r["memory_s"]) * 1e3
        print(f"[dryrun] (b) {arch} remat {remat}: FLOPs dry-run {flops:.0f}"
              f", card {m['flops']} (equal: {flops == m['flops']}); peak "
              f"memory {m['peak']} B on the card against bytes_per_device "
              f"{r['bytes_per_device']} (arguments "
              f"{r['argument_size_in_bytes']} + temp "
              f"{r['temp_size_in_bytes']}): {rel:+.4f} (tol "
              f"{DRYRUN_MEM_TOL}); predicted max(compute, memory) "
              f"{predicted:.3f} ms against a median step of {m['ms']:.3f} "
              f"ms wall ({[round(w, 3) for w in m['walls']]}; loss "
              f"{m['loss']:.6g}; {card})")
        if flops != m["flops"]:
            failed.append(f"remat {remat} FLOPs")
        if not abs(rel) <= DRYRUN_MEM_TOL:
            failed.append(f"remat {remat} peak memory")
    if failed:
        raise SystemExit(f"[dryrun] FAIL: {failed}")
    return {}


MESH_MOE_LAYERS = 2                   # of llama4-scout's 48 in (d)'s serving


def profile_block(torch, calls: dict, n: int = 5) -> None:
    """Host wall ms a call and the device's busy ms a call, launches a call
    and the largest device rows of each of ``calls`` ({label: fn}), each
    profiled over ``n`` calls after one more."""
    from torch.profiler import ProfilerActivity, profile

    with torch.inference_mode():
        for label, fn in calls.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(n):
                    fn()
                torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / n
            events = prof.key_averages()
            rows = device_rows(events, n)
            print(f"[profile] (d) MoE block decode, {label}: {wall:.3f} ms "
                  f"wall a call (profiled), device busy "
                  f"{sum(t for t, _ in rows):.4f} ms, "
                  f"{device_launches(events, n):.0f} launches; largest: "
                  + "; ".join(f"{name[:60]} {t:.4f}"
                              for t, name in rows[:6]))


def run_mesh_moe(torch, seed: int, mesh, mi) -> dict:
    """(d) llama4-scout-17b-a16e's expert parallelism at full width on the
    world-1 mesh, bf16, weights from ``seed``, capacity_factor 1.25 (the
    config's): the MoE block through its shard path (``shortcut=False``:
    the all-to-all and the sums are issued over the size-1 ``nccl``
    groups; at world 1 the reference's guards make ``ep2d`` and
    ``psum_scatter`` the baseline) bitwise the unsharded block, out and
    aux, at a decode (B 8, L 1) and a prefill (B 8, L 40) block, with the
    device ms of each; kernels-on lock-step ``generate`` (B 8, N 8,
    prompt 32, 16 tokens, MESH_MOE_LAYERS layers) through ``Engine(mesh=)``
    bitwise the run without it; one train step at one layer (the retrieval
    task, 4 x 8 x 32) on the mesh bitwise the plain step (loss, every
    parameter and moment).  Returns the serving run's mux and demux
    launches."""
    import gc

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.nn.moe import MoE, OnMesh, capacity
    from repro_torch.serving.engine import Engine
    from repro_torch.sharding.placement import gather_state
    from repro_torch.training.trainer import TrainConfig, Trainer

    card = torch.cuda.get_device_name(0)
    full = get_config("llama4-scout-17b-a16e", mux_n=8)
    mcfg = full.moe
    print(f"[mesh] (d) world 1: no collective moves a byte on one card; "
          f"the multi-rank algebra (per-shard capacity, the all-to-all, "
          f"ep2d, psum_scatter, the gradients) is held by the CPU tests "
          f"(tests/test_torch_distributed.py, 4 gloo ranks)")
    gc.collect()
    torch.cuda.empty_cache()

    # the block, past the size-1 shortcut
    gen = torch.Generator(device="cuda").manual_seed(seed)
    moe = MoE(mcfg, generator=gen, device="cuda", dtype=full.pdtype).eval()
    for label, (b, l) in (("decode", (8, 1)), ("prefill", (8, 40))):
        x = torch.randn((b, l, mcfg.dim), generator=gen, device="cuda",
                        dtype=full.pdtype)
        with torch.inference_mode():
            def plain():
                return moe(x)

            def shard():
                return moe(x, on_mesh=OnMesh(mesh, mi), shortcut=False)
            want, got = plain(), shard()
            same = all(torch.equal(a, b) for a, b in zip(got, want))
            times = {"plain": [], "shard": []}
            for fn, key in ((plain, "plain"), (shard, "shard")) * 2:
                times[key].append(time_ms(fn))
        print(f"[mesh] (d) MoE block {label} (B {b}, L {l}; capacity "
              f"{capacity(b * l, mcfg)} per expert): shard path bitwise the "
              f"unsharded block (out, aux): {same}; device ms shard "
              f"{[round(t, 4) for t in times['shard']]}, unsharded "
              f"{[round(t, 4) for t in times['plain']]} (in turns; {card})")
        if not same:
            raise SystemExit(f"[mesh] FAIL: the MoE shard path differs from "
                             f"the unsharded block at the {label} block")
        if label == "decode":
            profile_block(torch, {"unsharded": plain, "shard": shard})
    del moe, x
    gc.collect()
    torch.cuda.empty_cache()

    # kernels-on lock-step serving through Engine(mesh=)
    batch, prompt_len, gen_steps = 8, 32, 16
    base = dataclasses.replace(full, n_layers=MESH_MOE_LAYERS)
    kcfg = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(fuse_demux=True))
    model = Backbone(kcfg, seed=seed, device="cuda").eval()
    n = kcfg.mux.n
    engines = {"mesh": Engine(model, batch=batch,
                              max_len=prompt_len + gen_steps + 1,
                              mesh=mesh, mesh_info=mi),
               "plain": Engine(model, batch=batch,
                               max_len=prompt_len + gen_steps + 1)}
    prompts = torch.randint(0, kcfg.vocab, (batch, n, prompt_len),
                            generator=gen, device="cuda")
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    tokens = {"mesh": engines["mesh"].generate(prompts, gen_steps)}
    torch.cuda.synchronize()
    launches = dict(_build.LAUNCHES)
    tokens["plain"] = engines["plain"].generate(prompts, gen_steps)
    logits = {}
    for label, e in engines.items():
        first, state = e.prefill(prompts)
        logits[label] = (first, e.step(state, tokens[label][..., 0])[0])
    same = (torch.equal(tokens["mesh"], tokens["plain"])
            and all(torch.equal(a, b) for a, b in zip(logits["mesh"],
                                                      logits["plain"])))
    print(f"[mesh] (d) llama4-scout {MESH_MOE_LAYERS} of {full.n_layers} "
          f"layers: generate {batch} x {n} streams x {gen_steps} tokens with "
          f"the mux and demux kernels, on the mesh bitwise without it "
          f"(tokens, prefill and step logits): {same}; launches in the mesh "
          f"run {launches}")
    missing = [k for k in ("hadamard_mux", "index_embed_demux",
                           "decode_demux") if not launches.get(k)]
    if not same or missing:
        raise SystemExit(f"[mesh] FAIL: llama4-scout serving on the mesh "
                         f"differs or never launched {missing}")
    del engines, model, logits
    gc.collect()
    torch.cuda.empty_cache()

    # one train step at one layer, the plain step's results kept on the
    # host while the mesh step runs
    cfg = dataclasses.replace(full, n_layers=1)
    tcfg = TrainConfig(task="retrieval", lr=3e-3, warmup=1, total_steps=10)
    batch = {k: torch.as_tensor(v).long().cuda() for k, v in next(iter(
        mux_batches(RetrievalTask(vocab=cfg.vocab, seq_len=32), groups=4,
                    n_mux=n, steps=1, seed=seed))).items()}
    kept, nbytes = None, 0
    for label, kw in (("plain", {}), ("mesh", dict(mesh=mesh,
                                                   mesh_info=mi))):
        torch.cuda.reset_peak_memory_stats()
        state = Trainer.init_state(cfg, tcfg, seed=seed, device="cuda")
        step = Trainer.make_train_step(cfg, tcfg, **kw)
        rng = torch.Generator(device="cuda").manual_seed(seed)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state, m = step(state, batch, rng)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        opt = state["opt_state"] if label == "plain" else \
            gather_state(state)["opt_state"]
        tensors = {"loss": m["loss"], **{
            f"param {k}": v for k, v in Trainer.params(state).items()}, **{
            f"{mom} {k}": v for mom in ("mu", "nu")
            for k, v in opt[mom].items()}}
        peak = torch.cuda.max_memory_allocated() / 1e9
        if label == "plain":
            nbytes = sum(t.numel() * t.element_size()
                         for t in tensors.values())
            kept = {k: t.detach().cpu() for k, t in tensors.items()}
            print(f"[mesh] (d) llama4-scout at 1 layer: plain train step "
                  f"{wall:.1f} ms wall (the first), loss {float(m['loss'])}, "
                  f"peak {peak:.2f} GB; parameters and moments "
                  f"{nbytes / 1e9:.2f} GB kept on the host")
        else:
            same = kept.keys() == tensors.keys() and all(
                torch.equal(kept[k].cuda(), t) for k, t in tensors.items())
            print(f"[mesh] (d) llama4-scout at 1 layer: mesh train step "
                  f"{wall:.1f} ms wall (the first: placement included), loss "
                  f"{float(m['loss'])}, peak {peak:.2f} GB; bitwise the plain "
                  f"step (loss, {len(tensors) - 1} parameters and moments): "
                  f"{same}")
            if not same:
                raise SystemExit("[mesh] FAIL: the llama4-scout train step "
                                 "on the mesh differs from the plain step")
        del state, step, opt, tensors, m
        gc.collect()
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# Phase 5: the evaluation slice
# ---------------------------------------------------------------------------

def eval_step_ms(torch, step, state, batches, index) -> float:
    """Host wall ms of one eval step, averaged over ``batches``."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for batch, ix in zip(batches, index):
        step(state, batch, None, retr_index=ix)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / len(batches) * 1e3


def run_eval(torch, seed: int):
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.core.retrieval import retrieval_index
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.kernels import _build
    from repro_torch.training.trainer import TrainConfig, Trainer

    gc.collect()                 # the serving phases' models and caches
    torch.cuda.empty_cache()
    groups, steps, seq_len = 2, 3, 1024
    base = get_config("qwen1.5-4b", mux_n=8)
    cfg = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True))
    tcfg = TrainConfig(task="lm")
    n = cfg.mux.n
    print(f"[eval] {cfg.name}: {cfg.n_layers} layers, d={cfg.d_model}, "
          f"{cfg.n_heads} heads of {cfg.head_dim_}, vocab {cfg.vocab}, N={n}, "
          f"{cfg.dtype}; {steps} batches of RetrievalTask(seq_len={seq_len}) "
          f"x {groups} groups through Trainer.make_eval_step(task='lm', "
          f"retrieval alpha {cfg.mux.retrieval_alpha})")
    state = Trainer.init_state(cfg, tcfg, seed=seed, device="cuda",
                               use_flash=True)
    model = state["model"].eval()
    batches = [{k: torch.as_tensor(v).long().cuda() for k, v in b.items()}
               for b in mux_batches(RetrievalTask(vocab=cfg.vocab,
                                                  seq_len=seq_len),
                                    groups=groups, n_mux=n, steps=steps,
                                    seed=seed)]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    index = [retrieval_index(gen, groups, n, seq_len) for _ in batches]
    step = Trainer.make_eval_step(cfg, tcfg)
    step(state, batches[0], None, retr_index=index[0])   # warm-up
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()

    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    metrics = [step(state, b, None, retr_index=ix)
               for b, ix in zip(batches, index)]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"[eval] {steps} eval steps in {dt:.4f} s: "
          f"{groups * n * steps / dt:.2f} instances/s, "
          f"{groups * n * seq_len * steps / dt:.1f} tokens/s, "
          f"{dt / steps * 1e3:.3f} ms per step (bf16, "
          f"{torch.cuda.get_device_name(0)}); peak memory {peak_gb:.2f} GB")
    print(f"[eval] kernel launches in that run: {launches}")
    want = {"flash_attention": cfg.n_layers * steps, "hadamard_mux": steps,
            "index_embed_demux": steps}
    if launches != want:
        raise SystemExit(f"[eval] FAIL: launches {launches}, expected {want}")
    for i, m in enumerate(metrics):
        vals = {k: float(v) for k, v in m.items()}
        print(f"[eval] batch {i}: " + ", ".join(
            f"{k} {v:.6g}" for k, v in vals.items()))
        if not all(map(math.isfinite, vals.values())):
            raise SystemExit(f"[eval] FAIL: non-finite metrics {vals}")

    with torch.inference_mode():
        logits = model(batches[0]["tokens"])["logits"]
        shape = (groups, n, seq_len, cfg.vocab)
        if tuple(logits.shape) != shape:
            raise SystemExit(f"[eval] FAIL: logits {tuple(logits.shape)}, "
                             f"expected {shape}")
        fwd = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            model(batches[0]["tokens"])
            torch.cuda.synchronize()
            fwd.append((time.perf_counter() - t0) * 1e3)
    print(f"[eval] forward alone (flash + kernels): "
          f"{[round(t, 3) for t in fwd]} ms")

    plain = Trainer.init_state(base, tcfg, seed=seed, device="cuda")
    plain["model"].load_state_dict(model.state_dict())
    plain["model"].eval()
    plain_step = Trainer.make_eval_step(base, tcfg)
    _build.LAUNCHES.clear()
    plain_metrics = [plain_step(plain, b, None, retr_index=ix)
                     for b, ix in zip(batches, index)]
    with torch.inference_mode():
        plain_logits = plain["model"](batches[0]["tokens"])["logits"]
    torch.cuda.synchronize()
    if _build.LAUNCHES:
        raise SystemExit(f"[eval] FAIL: the plain path launched "
                         f"{dict(_build.LAUNCHES)}")
    err = max((logits[:, i].float() - plain_logits[:, i].float())
              .abs().max().item() for i in range(n))
    tol = LOGIT_TOL * plain_logits.abs().max().item()
    agree = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean()
    print(f"[eval] batch 0 logits, flash + kernels vs plain: max_abs_err "
          f"{err:.4g} (tol {tol:.4g}), greedy tokens agree "
          f"{agree.item():.4f}")
    if not err <= tol:
        raise SystemExit("[eval] FAIL: logits disagree")
    del logits, plain_logits
    for i, (m, pm) in enumerate(zip(metrics, plain_metrics)):
        for key in ("task_loss", "retr_loss"):
            got, ref = float(m[key]), float(pm[key])
            rel = abs(got - ref) / abs(ref)
            print(f"[eval] batch {i} {key}: flash + kernels {got:.6g}, "
                  f"plain {ref:.6g}, relative diff {rel:.3g} "
                  f"(tol {EVAL_LOSS_TOL})")
            if not rel <= EVAL_LOSS_TOL:
                raise SystemExit(f"[eval] FAIL: batch {i} {key} disagrees")

    torch.cuda.empty_cache()
    walls = {"flash + kernels": [], "plain": []}
    runs = {"flash + kernels": (step, state), "plain": (plain_step, plain)}
    for label in ("flash + kernels", "plain") * 2:     # in turns
        fn, st = runs[label]
        walls[label].append(eval_step_ms(torch, fn, st, batches, index))
    for label, w in walls.items():
        print(f"[eval] eval step wall ms, {label} (in turns): "
              f"{[round(t, 3) for t in w]}")
    del plain, plain_step
    gc.collect()
    torch.cuda.empty_cache()
    profile_eval(torch, step, state, batches[0], index[0],
                 statistics.median(walls["flash + kernels"]))
    return launches


def profile_eval(torch, step, state, batch, index, wall: float,
                 label: str = "eval step") -> None:
    """Where one eval step's device time goes (torch.profiler), with the
    flash kernel's share; ``wall`` is the unprofiled step time."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        step(state, batch, None, retr_index=index)
        torch.cuda.synchronize()
    events = prof.key_averages()
    rows = device_rows(events, 1)
    busy = sum(t for t, _ in rows)
    if not busy:
        print(f"[profile] {label}: device time not measured (the "
              f"profiler saw no device activity)")
        return
    flash = sum(t for t, key in rows if "flash_attention" in key)
    print(f"[profile] {label}: {wall:.3f} ms wall (unprofiled median), "
          f"device busy {busy:.3f} ms, idle share {1 - busy / wall:.3f}, "
          f"{device_launches(events, 1):.0f} device launches, "
          f"flash_attention {flash:.3f} ms = {flash / busy:.3f} of busy")
    for t, key in rows[:12]:
        print(f"[profile]   {t:9.4f} ms  {key[:90]}")
    print_stages(events, 1, label)


# ---------------------------------------------------------------------------
# Phase 8: gemma3-4b's sliding-window layers inside the paged pool
# ---------------------------------------------------------------------------

def last_row(logits):
    """A chunked step's last row per lane, (B, N, V); one-token steps'
    logits as they are."""
    return logits[..., -1, :] if logits.dim() == 4 else logits


class Replay:
    """Sampling of a plain run that replays a kernel run: each pick returns
    the token the kernel run chose for that request at that index, so both
    runs feed the same tokens through every step.  Each pick records the
    plain path's own greedy token and its top-1 margin."""

    def __init__(self, inner, outputs: dict):
        self.inner, self.outputs = inner, outputs
        self.picks: dict[int, list] = {}  # rid -> [(own, replayed, clear)]

    def select(self, req, lane_logits):
        import numpy as np

        own = self.inner.select(req, lane_logits)
        x = np.asarray(lane_logits, np.float32)
        top = np.sort(x)[-2:]
        clear = top[1] - top[0] > 2 * LOGIT_TOL * np.abs(x).max()
        tok = self.outputs[req.rid][len(req.output)]
        self.picks.setdefault(req.rid, []).append((own, tok, bool(clear)))
        return tok


def check_replay(tag: str, replay: Replay) -> None:
    """Each request's tokens of the kernel run equal the plain path's own
    greedy picks wherever the plain top-1 margin is clear (above twice
    LOGIT_TOL x max|logit|); so a plain run left to itself would have given
    each request's tokens up to its first unclear pick."""
    clear_n = equal_n = upto = picks = 0
    for rid, rows in sorted(replay.picks.items()):
        picks += len(rows)
        for own, tok, clear in rows:
            clear_n += clear
            equal_n += clear and own == tok
        upto += next((i for i, (_, _, c) in enumerate(rows) if not c),
                     len(rows))
        if any(clear and own != tok for own, tok, clear in rows):
            raise SystemExit(f"{tag} FAIL: request {rid}'s tokens differ "
                             f"from the plain path's at a clear margin")
    print(f"{tag} sampled tokens, kernels vs plain (replayed): "
          f"{equal_n} of {clear_n} picks with a clear margin equal, of "
          f"{picks} picks; {upto} tokens compared up to each request's "
          f"first unclear pick")


def run_window(torch, seed: int):
    """gemma3-4b at full width and depth (34 layers: 29 local with a
    1024-row ring, 5 global), N = 8, bf16, weights from ``seed``, served by
    ``ContinuousScheduler`` on the paged pool (page_size 16, 4 slots,
    max_len 2048, prefill_chunk 64) with the mux, both demux and the paged
    kernels: 14 requests of 1100-1500 prompt tokens (every ring wraps) and
    32 new tokens each.  The same trace through a contiguous scheduler
    over a ``with_config`` view with every kernel off, replaying the
    kernel run's sampled tokens (``Replay``), must give the same decode
    steps and tokens, every step's logits within LOGIT_TOL and the plain
    path's own greedy picks equal where the margin is clear.  Before it, a
    lock-step ``Engine.prefill`` of prompts longer than the rings (through
    the index-embed demux, which continuous serving never runs: its
    prompts ramp through decode steps) against the same view.  Returns the
    launches of the lock-step run and the scheduler's run, summed."""
    import gc

    import numpy as np

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvcache import cache_nbytes, paged_cache_bytes
    from repro_torch.serving.scheduler import ContinuousScheduler, Request

    gc.collect()
    torch.cuda.empty_cache()
    batch, max_len, chunk, n_requests, gen_len = 4, 2048, 64, 14, 32
    base = get_config("gemma3-4b", mux_n=8)
    cfg = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(paged=True, page_size=16, use_kernel=True,
                              fuse_demux=True, prefill_chunk=chunk))
    kinds = cfg.layer_kinds()
    rng = np.random.default_rng(seed)
    trace = [Request(rid=i, prompt=rng.integers(
        0, cfg.vocab, int(rng.integers(1100, 1501))).astype(np.int32),
        max_new_tokens=gen_len, arrival=3 * i) for i in range(n_requests)]
    lens = [len(r.prompt) for r in trace]
    n_global = sum(k["window"] is None for k in kinds)
    print(f"[window] {cfg.name}: {cfg.n_layers} layers "
          f"({cfg.n_layers - n_global} local, window {cfg.window}; "
          f"{n_global} global), "
          f"d={cfg.d_model}, {cfg.n_heads} heads of {cfg.head_dim_} over "
          f"{cfg.n_kv_heads} KV heads, vocab {cfg.vocab}, N={cfg.mux.n}, "
          f"{cfg.dtype}; batch {batch}, max_len {max_len}, page_size 16, "
          f"prefill_chunk {chunk}; {n_requests} requests, prompts "
          f"{min(lens)}-{max(lens)} tokens, {gen_len} new tokens each, "
          f"arrivals every 3 steps")
    torch.cuda.reset_peak_memory_stats()
    model = Backbone(cfg, seed=seed, device="cuda").eval()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    plain = model.with_config(dataclasses.replace(
        base, serving=ServingConfig(prefill_chunk=chunk)))

    # Lock-step: Engine.prefill of 1200-token prompts (the local layers'
    # rings keep the last 1024 positions) through the index-embed demux,
    # then one decode step, kernels on against the plain view.
    gen = torch.Generator(device="cuda").manual_seed(seed)
    prompts = torch.randint(0, cfg.vocab, (2, cfg.mux.n, 1200),
                            generator=gen, device="cuda")
    lock = {}
    for label, m in (("kernels", model), ("plain", plain)):
        eng = Engine(m, batch=2, max_len=prompts.shape[-1] + 2)
        _build.LAUNCHES.clear()
        logits0, state = eng.prefill(prompts)
        first = logits0.argmax(-1) if label == "kernels" else first
        logits1, _ = eng.step(state, first)
        torch.cuda.synchronize()
        lock[label] = (logits0.float(), logits1.float(),
                       dict(_build.LAUNCHES))
    want = {"index_embed_demux": 1, "hadamard_mux": 2, "decode_demux": 1}
    print(f"[window] lock-step prefill of (2, 8, 1200) prompts and one "
          f"step: launches {lock['kernels'][2]}, plain {lock['plain'][2]}")
    if lock["kernels"][2] != want or lock["plain"][2]:
        raise SystemExit(f"[window] FAIL: lock-step launches, expected "
                         f"{want}")
    lock_launches = lock["kernels"][2]
    for i, what in enumerate(("prefill", "first step")):
        got, ref = lock["kernels"][i], lock["plain"][i]
        err = (got - ref).abs().max().item()
        tol = LOGIT_TOL * ref.abs().max().item()
        agree = (got.argmax(-1) == ref.argmax(-1)).float().mean().item()
        print(f"[window] lock-step {what} logits, kernels vs plain: "
              f"max_abs_err {err:.4g} (tol {tol:.4g}), greedy tokens agree "
              f"{agree:.4f}")
        if not (err <= tol and bool(got.isfinite().all())):
            raise SystemExit(f"[window] FAIL: lock-step {what} logits "
                             f"disagree")
    del lock, state, eng

    def scheduler(m):
        return ContinuousScheduler(Engine(m, batch=batch, max_len=max_len))

    warm = [dataclasses.replace(r, prompt=r.prompt[:200], max_new_tokens=2,
                                arrival=0) for r in trace[:2]]
    scheduler(model).run([r.fresh() for r in warm])          # warm-up
    torch.cuda.synchronize()

    _build.LAUNCHES.clear()
    sched = scheduler(model)
    forced = []
    record_teacher_forced(sched, forced, pick=last_row, every_step=True)
    t0 = time.perf_counter()
    stats = sched.run([r.fresh() for r in trace])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    alloc = sched.allocator
    paged = ["k_pages" in layer for layer in alloc.cache]
    pool = alloc.page_bytes() * alloc.pool_pages
    rings = alloc.ring_bytes()
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    kept_gb = sum(t.numel() * t.element_size() for t in forced) / 1e9
    print(f"[window] layer split the allocator chose: {sum(paged)} global "
          f"layers paged ({alloc.pool_pages} pages of 16), "
          f"{paged.count(False)} local layers in rings of "
          f"{alloc.cache[paged.index(False)]['k'].shape[1]} rows x {batch} "
          f"slots; pool {pool / 1e6:.2f} MB, rings {rings / 1e6:.2f} MB, "
          f"weights {weights / 1e9:.3f} GB, peak memory {peak_gb:.2f} GB, "
          f"of which {kept_gb:.2f} GB are every step's logits kept for the "
          f"comparison ({torch.cuda.get_device_name(0)})")
    print(f"[window] {stats.finished}/{n_requests} requests, "
          f"{stats.decode_steps} decode steps, {stats.generated_tokens} "
          f"tokens in {dt:.4f} s = {stats.generated_tokens / dt:.1f} tok/s, "
          f"{dt / stats.decode_steps * 1e3:.3f} ms per step (bf16); peak "
          f"{stats.peak_pages}/{alloc.table.usable_pages} pages, "
          f"{stats.slot_resets} slot resets")
    print(f"[window] kernel launches in that run: {launches}")
    want_split = [k["window"] is None for k in kinds]
    if paged != want_split or n_global != 5:
        raise SystemExit(f"[window] FAIL: layer split {paged}")
    if cache_nbytes(alloc.cache) != paged_cache_bytes(
            cfg, batch, alloc.max_len, pool_pages=alloc.pool_pages,
            page_size=16) or pool + rings != cache_nbytes(alloc.cache):
        raise SystemExit("[window] FAIL: the cache's bytes disagree with "
                         "paged_cache_bytes")
    if min(lens) + cfg.mux.prefix_len <= cfg.window:
        raise SystemExit("[window] FAIL: a prompt leaves its rings unwrapped")
    if stats.finished != n_requests:
        raise SystemExit("[window] FAIL: not every request finished")
    if alloc.table.pages_in_use != alloc.n_prefix_pages * batch:
        raise SystemExit("[window] FAIL: pages leaked after the drain")
    if launches.get("paged_decode_attention", 0) != \
            n_global * stats.decode_steps:
        raise SystemExit(f"[window] FAIL: paged_decode_attention launched "
                         f"{launches.get('paged_decode_attention', 0)} "
                         f"times, expected {n_global * stats.decode_steps}")
    for name in ("hadamard_mux", "decode_demux"):
        if not launches.get(name):
            raise SystemExit(f"[window] FAIL: {name} never launched")

    # The plain run replays the kernel run's sampled tokens, so every step,
    # the chunked ones that read wrapped rings included, is teacher-forced.
    psched = scheduler(plain)
    psched.sampling = Replay(psched.sampling,
                             {q.rid: list(q.output) for q in sched.finished})
    pforced = []
    record_teacher_forced(psched, pforced, pick=last_row, every_step=True)
    _build.LAUNCHES.clear()
    pstats = psched.run([r.fresh() for r in trace])
    torch.cuda.synchronize()
    if _build.LAUNCHES:
        raise SystemExit(f"[window] FAIL: the plain path launched "
                         f"{dict(_build.LAUNCHES)}")
    for what in ("finished", "decode_steps", "generated_tokens"):
        a, b = getattr(stats, what), getattr(pstats, what)
        print(f"[window] {what}: paged kernels {a}, contiguous plain {b}")
        if a != b:
            raise SystemExit(f"[window] FAIL: {what} differ")
    check_forced("[window]", forced, pforced)
    check_replay("[window]", psched.sampling)
    del forced, pforced, psched, sched
    gc.collect()
    profile_scheduler(torch, scheduler(model), trace, warm=6, steps=4,
                      label="window scheduler step")
    for name, count in lock_launches.items():
        launches[name] = launches.get(name, 0) + count
    return launches


# ---------------------------------------------------------------------------
# Phase 9: evaluation through flash at head dims 256 and 192
# ---------------------------------------------------------------------------

DENSE_EVAL = (  # (arch, layers or None for all, sequence length)
    ("gemma3-4b", None, 1280),
    ("gemma-7b", 4, 512),
    ("nemotron-4-340b", 2, 256),
)


def run_dense(torch, seed: int):
    """Each of gemma3-4b (all 34 layers, L 1280 past its window), gemma-7b
    (4 of 28 layers) and nemotron-4-340b (2 of 96) at full width, N = 8,
    bf16, weights from ``seed``, evaluated on one batch of the retrieval
    task (B 1) through ``Trainer.make_eval_step`` with
    ``Backbone(use_flash=True)`` and the mux and demux kernels: flash runs
    on the global layers only; a ``with_config`` view on the same weights
    with flash and the kernels off must give logits within LOGIT_TOL and
    losses within EVAL_LOSS_TOL; eval-step times on and off in turns; peak
    memory under 70 GB."""
    import gc

    from repro_torch.configs.registry import get_config
    from repro_torch.core.retrieval import retrieval_index
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.training.trainer import TrainConfig, Trainer

    tcfg = TrainConfig(task="lm")
    total = {}
    for arch, layers, seq_len in DENSE_EVAL:
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = get_config(arch, mux_n=8)
        reduced = []
        if layers:
            reduced.append(f"{layers} of {base.n_layers} layers")
            base = dataclasses.replace(base, n_layers=layers)
        reduced.append("batch 1 group")
        cfg = dataclasses.replace(
            base, mux=dataclasses.replace(base.mux, use_kernel=True))
        n = cfg.mux.n
        n_global = sum(k["window"] is None for k in cfg.layer_kinds())
        model = Backbone(cfg, seed=seed, device="cuda", use_flash=True).eval()
        weights = sum(p.numel() * p.element_size()
                      for p in model.parameters())
        print(f"[dense] {cfg.name}: {cfg.n_layers} layers ({n_global} "
              f"through flash), d={cfg.d_model}, {cfg.n_heads} heads of "
              f"{cfg.head_dim_} over {cfg.n_kv_heads} KV heads, "
              f"{cfg.norm}, {cfg.activation}, vocab {cfg.vocab}, N={n}, "
              f"{cfg.dtype}, {weights / 1e9:.2f} GB of weights; one batch "
              f"of RetrievalTask(seq_len={seq_len}); reduced: "
              f"{', '.join(reduced)}")
        state = {"model": model}
        plain = {"model": model.with_config(base, use_flash=False)}
        batch = {k: torch.as_tensor(v).long().cuda() for k, v in next(iter(
            mux_batches(RetrievalTask(vocab=cfg.vocab, seq_len=seq_len),
                        groups=1, n_mux=n, steps=1, seed=seed))).items()}
        gen = torch.Generator(device="cuda").manual_seed(seed)
        index = retrieval_index(gen, 1, n, seq_len)
        step = Trainer.make_eval_step(cfg, tcfg)
        plain_step = Trainer.make_eval_step(base, tcfg)
        step(state, batch, None, retr_index=index)           # warm-up
        torch.cuda.synchronize()
        _build.LAUNCHES.clear()
        metrics = step(state, batch, None, retr_index=index)
        torch.cuda.synchronize()
        launches = dict(_build.LAUNCHES)
        want = {"flash_attention": n_global, "hadamard_mux": 1,
                "index_embed_demux": 1}
        print(f"[dense] {cfg.name} kernel launches in one eval step: "
              f"{launches}")
        if launches != want:
            raise SystemExit(f"[dense] FAIL: launches {launches}, expected "
                             f"{want}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        _build.LAUNCHES.clear()
        plain_metrics = plain_step(plain, batch, None, retr_index=index)
        with torch.inference_mode():
            plain_logits = plain["model"](batch["tokens"])["logits"]
        torch.cuda.synchronize()
        if _build.LAUNCHES:
            raise SystemExit(f"[dense] FAIL: the plain path launched "
                             f"{dict(_build.LAUNCHES)}")
        with torch.inference_mode():
            logits = model(batch["tokens"])["logits"]
        err = max((logits[:, i].float() - plain_logits[:, i].float())
                  .abs().max().item() for i in range(n))
        tol = LOGIT_TOL * plain_logits.abs().max().item()
        agree = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean()
        finite = bool(logits.isfinite().all())
        print(f"[dense] {cfg.name} logits {tuple(logits.shape)}, flash + "
              f"kernels vs plain: max_abs_err {err:.4g} (tol {tol:.4g}), "
              f"greedy tokens agree {agree.item():.4f}")
        if not (err <= tol and finite):
            raise SystemExit(f"[dense] FAIL: {cfg.name} logits disagree")
        del logits, plain_logits
        for key in ("task_loss", "retr_loss"):
            got, ref = float(metrics[key]), float(plain_metrics[key])
            rel = abs(got - ref) / abs(ref)
            print(f"[dense] {cfg.name} {key}: flash + kernels {got:.6g}, "
                  f"plain {ref:.6g}, relative diff {rel:.3g} "
                  f"(tol {EVAL_LOSS_TOL})")
            if not rel <= EVAL_LOSS_TOL:
                raise SystemExit(f"[dense] FAIL: {cfg.name} {key} disagrees")
        walls = {"flash + kernels": [], "plain": []}
        runs = {"flash + kernels": (step, state), "plain": (plain_step,
                                                           plain)}
        for label in ("flash + kernels", "plain") * 2:     # in turns
            fn, st = runs[label]
            walls[label].append(eval_step_ms(torch, fn, st, [batch],
                                             [index]))
        peak_gb = torch.cuda.max_memory_allocated() / 1e9
        print(f"[dense] {cfg.name} eval step wall ms (in turns): "
              + ", ".join(f"{label} {[round(t, 3) for t in w]}"
                          for label, w in walls.items())
              + f"; peak memory {peak_gb:.2f} GB")
        if not peak_gb < 70:
            raise SystemExit(f"[dense] FAIL: {cfg.name} peak memory "
                             f"{peak_gb:.2f} GB")
        profile_eval(torch, step, state, batch, index,
                     statistics.median(walls["flash + kernels"]),
                     label=f"{cfg.name} eval step")
        del state, plain, model, step, plain_step
    return total


# ---------------------------------------------------------------------------
# Phase 10: the MoE block in llama4-scout-17b-a16e
# ---------------------------------------------------------------------------

MOE_LAYERS = 8                        # of llama4-scout's 48 (39.7 GB of bf16)


class RoutingTape:
    """The routing of each MoE layer call, recorded in a kernel run and
    replayed in a plain run of the same calls (``install`` wraps
    ``repro_torch.nn.moe.route`` and ``dispatch``).

    ``record``: each call's expert ids and keep flags per (row, choice)
    and its valid rows.  ``replay``: each call takes the recorded call's
    expert ids (weighted by the plain router's own scores of them), so the
    plain run follows the kernel run's routing as it follows its sampled
    tokens, and every later step stays teacher-forced; the plain router's
    own ids and the keep flags they would give are compared with the
    recorded ones.  A valid row whose own ids differ must be a near-tie:
    the gap between consecutive ones of its top k + 1 router logits is at
    most 2 x LOGIT_TOL x max|router logits| (the margin below which the
    kernels' bf16 rounding, held to LOGIT_TOL on the logits, may reorder
    the choice; the same rule ``Replay`` applies to sampled tokens).  A
    row whose ids agree but whose keep flag differs lost or gained its
    capacity slot to such a row, and may occur only in a call that has
    one."""

    def __init__(self, tag: str = "[moe]"):
        self.tag = tag
        self.mode, self.calls, self.at = None, [], 0
        self.rows = self.id_rows = self.keep_rows = self.calls_differing = 0
        self.worst = 0.0                  # largest gap / threshold of a diff
        self._own = None

    def install(self):
        from repro_torch.nn import moe

        real_route, real_dispatch = moe.route, moe.dispatch

        def route(logits, cfg, row_mask=None):
            import torch
            top_w, top_ids, aux = real_route(logits, cfg, row_mask)
            if self.mode == "record":
                self.calls.append({"ids": top_ids.clone()})
            elif self.mode == "replay":
                rec = self.calls[self.at]
                if rec["ids"].shape != top_ids.shape:
                    raise SystemExit(f"{self.tag} FAIL: MoE call {self.at} has "
                                     f"{tuple(top_ids.shape)} rows x choices "
                                     f"in the plain run, "
                                     f"{tuple(rec['ids'].shape)} in the "
                                     f"kernel run")
                scores = (torch.sigmoid(logits) if cfg.router_scoring ==
                          "sigmoid" else torch.softmax(logits, dim=-1))
                w = scores.gather(1, rec["ids"])
                top_w = w / (w.sum(-1, keepdim=True) + 1e-9)
                self._own = (top_ids, logits)
                top_ids = rec["ids"]
            return top_w, top_ids, aux

        def dispatch(top_ids, row_mask, cap, n_experts):
            import torch
            out = real_dispatch(top_ids, row_mask, cap, n_experts)
            if self.mode is None:
                return out

            def pair_keep(order, keep):
                flags = torch.zeros_like(keep).scatter_(0, order, keep)
                return flags.view(top_ids.shape)
            if self.mode == "record":
                self.calls[-1]["keep"] = pair_keep(out[0], out[2])
                return out
            rec = self.calls[self.at]
            own_ids, logits = self._own
            own = real_dispatch(own_ids, row_mask, cap, n_experts)
            own_keep = pair_keep(own[0], own[2])
            valid = (torch.ones(len(own_ids), dtype=torch.bool,
                                device=own_ids.device) if row_mask is None
                     else row_mask)
            ids_differ = (own_ids != rec["ids"]).any(1) & valid
            keep_differ = (own_keep != rec["keep"]).any(1) & valid \
                & ~ids_differ
            k = own_ids.shape[1]
            top = torch.sort(logits, dim=-1, descending=True).values[
                :, :k + 1]
            gap = (top[:, :-1] - top[:, 1:]).amin(-1)
            limit = 2 * LOGIT_TOL * logits.abs().amax(-1)
            n_ids, n_keep = int(ids_differ.sum()), int(keep_differ.sum())
            self.rows += int(valid.sum())
            self.id_rows += n_ids
            self.keep_rows += n_keep
            self.calls_differing += bool(n_ids)
            if n_ids:
                ratio = (gap / limit)[ids_differ].max().item()
                self.worst = max(self.worst, ratio)
                if not ratio <= 1.0:
                    raise SystemExit(
                        f"{self.tag} FAIL: MoE call {self.at}: a row routed "
                        f"differently from the kernel run is not a near-tie "
                        f"(router gap {ratio:.3f} x the threshold)")
            if n_keep and not n_ids:
                raise SystemExit(f"{self.tag} FAIL: MoE call {self.at}: keep flags "
                                 f"differ with no row routed differently")
            self.at += 1
            return out

        self._real = (real_route, real_dispatch)
        moe.route, moe.dispatch = route, dispatch

    def uninstall(self):
        from repro_torch.nn import moe

        moe.route, moe.dispatch = self._real

    def start(self, mode: str) -> None:
        if mode == "record":
            self.calls = []
        self.mode, self.at = mode, 0
        self.rows = self.id_rows = self.keep_rows = self.calls_differing = 0
        self.worst = 0.0

    def finish(self, tag: str) -> None:
        """After a replay: every recorded call was replayed; print the
        counts."""
        if self.mode == "replay" and self.at != len(self.calls):
            raise SystemExit(f"{tag} FAIL: the plain run made {self.at} MoE "
                             f"calls, the kernel run {len(self.calls)}")
        if self.mode == "replay" and self.calls:
            print(f"{tag} routing, plain router vs the kernel run's: "
                  f"{self.id_rows} of {self.rows} valid rows chose other "
                  f"experts (in {self.calls_differing} of {self.at} MoE "
                  f"calls), each a near-tie (largest gap "
                  f"{self.worst:.3f} x the threshold 2 x LOGIT_TOL x "
                  f"max|router logits|); {self.keep_rows} more rows' keep "
                  f"flags moved with them")
        self.mode = None


def run_moe(torch, seed: int):
    """llama4-scout-17b-a16e at full width (d 5120, 40 heads over 8 KV
    heads, 16 experts of 8192 top-1 and a shared expert, vocab 202048),
    8 of its 48 layers, N = 8, bf16, weights from ``seed``, the config's
    own capacity_factor 1.25, through ``serve_and_eval``."""
    from repro_torch.configs.registry import get_config

    full = get_config("llama4-scout-17b-a16e", mux_n=8)
    base = dataclasses.replace(full, n_layers=MOE_LAYERS)

    def describe(model, weights, router):
        moe = base.moe
        print(f"[moe] {base.name}: d={base.d_model}, {base.n_heads} heads of "
              f"{base.head_dim_} over {base.n_kv_heads} KV heads, "
              f"{moe.n_experts} experts of {moe.moe_ff} top-{moe.top_k} "
              f"({moe.router_scoring}, capacity_factor "
              f"{moe.capacity_factor}) + {moe.n_shared_experts} shared, "
              f"vocab {base.vocab}, N={base.mux.n}, {base.dtype} (router "
              f"{sorted(map(str, router))}), {weights / 1e9:.2f} GB of "
              f"weights; reduced: {MOE_LAYERS} of {full.n_layers} layers")

    return serve_and_eval(torch, seed, base, "[moe]", describe)


# ---------------------------------------------------------------------------
# Phase 11: MLA in deepseek-v3-671b
# ---------------------------------------------------------------------------

MLA_LAYERS = 4            # of deepseek's 61: its 3 dense layers and 1 MoE


def run_mla(torch, seed: int):
    """deepseek-v3-671b at full width (d 7168, MLA over 128 heads: q rank
    1536, latent 512 + rope 64 per token, nope 128, v 128; dense layers of
    18432; 256 experts of 2048 sigmoid top-8 and a shared expert; vocab
    129280), 4 of its 61 layers (the 3 dense ones and 1 MoE), N = 8,
    bf16, weights from ``seed``, through ``serve_and_eval``: the
    latent rows in the page pool, the mux, decode-demux and index-embed
    demux kernels on, and neither the paged nor the flash kernel
    launched (MLA attends on the plain path, as in the reference)."""
    from repro_torch.configs.registry import get_config

    full = get_config("deepseek-v3-671b", mux_n=8)
    base = dataclasses.replace(full, n_layers=MLA_LAYERS)

    def describe(model, weights, router):
        m, moe = base.mla, base.moe
        mla = sum(p.numel() for n, p in model.named_parameters()
                  if ".attn." in n) // base.n_layers
        kinds = [f"{k['mixer']}+{k['mlp']}" for k in base.layer_kinds()]
        print(f"[mla] {base.name}: d={base.d_model}, MLA over {m.n_heads} "
              f"heads (q rank {m.q_lora_rank}, latent {m.kv_lora_rank} + "
              f"rope {m.qk_rope_head_dim} = {m.cache_width} per token, "
              f"nope {m.qk_nope_head_dim}, v {m.v_head_dim}; "
              f"{mla / 1e6:.1f} M parameters a layer), dense MLP "
              f"{base.d_ff}, {moe.n_experts} experts of {moe.moe_ff} "
              f"top-{moe.top_k} ({moe.router_scoring}, capacity_factor "
              f"{moe.capacity_factor}) + {moe.n_shared_experts} shared, "
              f"vocab {base.vocab}, N={base.mux.n}, {base.dtype} (router "
              f"{sorted(map(str, router))}), {weights / 1e9:.2f} GB of "
              f"weights; layers {kinds}; reduced: {MLA_LAYERS} of "
              f"{full.n_layers} layers")

    return serve_and_eval(torch, seed, base, "[mla]", describe)


# ---------------------------------------------------------------------------
# Phase 12: Mamba beside attention in jamba-1.5-large-398b
# ---------------------------------------------------------------------------

HYBRID_LAYERS = (3, 6)    # jamba's layers 3-5 of 72: Mamba + dense,
                          # attention + MoE, Mamba + dense (25.9 GB)


def run_hybrid(torch, seed: int):
    """jamba-1.5-large-398b at full width (d 8192; Mamba of d_inner 16384,
    state 16, conv 4, dt rank 512; attention of 64 heads over 8 KV heads
    of 128; 16 experts of 24576 top-2; dense MLPs of 24576; vocab 65536),
    its layers 3-5 of 72 as a 3-layer config whose ``layer_kinds`` are the
    full model's, N = 8, bf16, weights from ``seed``, through
    ``serve_and_eval``: the Mamba states contiguous beside the page
    pool, the paged kernel (n_rep 8) and at eval flash launched by the
    attention layer, Mamba on the plain path (the reference's is plain
    jnp).  The smallest prefix of the model that holds its attention layer
    (layers 0-4, three MoE layers) is about 66 GB of weights, past what the
    card holds beside the float32 draw."""
    from repro_torch.configs.registry import get_config

    full = get_config("jamba-1.5-large-398b", mux_n=8)
    first, stop = HYBRID_LAYERS
    base = dataclasses.replace(full, n_layers=stop - first,
                               attn_offset=full.attn_offset - first,
                               moe_layer_start=1)
    if base.layer_kinds() != full.layer_kinds()[first:stop]:
        raise SystemExit(f"[hybrid] FAIL: the cut's layer kinds "
                         f"{base.layer_kinds()} are not the full model's "
                         f"layers {first}-{stop - 1}")

    def describe(model, weights, router):
        m, moe = base.mamba, base.moe
        n_mamba = sum(k["mixer"] == "mamba" for k in base.layer_kinds())
        mamba = sum(p.numel() for n, p in model.named_parameters()
                    if ".mamba." in n) // n_mamba
        kinds = [f"{k['mixer']}+{k['mlp']}" for k in base.layer_kinds()]
        print(f"[hybrid] {base.name}: d={base.d_model}, Mamba (d_inner "
              f"{m.d_inner}, state {m.d_state}, conv {m.d_conv}, dt rank "
              f"{m.dt_rank_}, scan chunk {m.chunk}; {mamba / 1e6:.1f} M "
              f"parameters a layer), attention {base.n_heads} heads of "
              f"{base.head_dim_} over {base.n_kv_heads} KV heads, dense MLP "
              f"{base.d_ff}, {moe.n_experts} experts of {moe.moe_ff} "
              f"top-{moe.top_k} ({moe.router_scoring}, capacity_factor "
              f"{moe.capacity_factor}), vocab {base.vocab}, N={base.mux.n}, "
              f"{base.dtype} (router {sorted(map(str, router))}), "
              f"{weights / 1e9:.2f} GB of weights; layers {kinds} (the full "
              f"model's {first}-{stop - 1})")
        print(f"[hybrid] reduced: layers {first}-{stop - 1} of "
              f"{full.n_layers}")

    return serve_and_eval(torch, seed, base, "[hybrid]", describe)


def serve_and_eval(torch, seed: int, base, tag: str, describe,
                   chunks=(1, 4), counts=None, profile: bool = True):
    """A model ``base`` at full width, N = 8, in its dtype (bf16 but for
    ``[ssm]``), weights from ``seed``; ``describe(model, weights,
    router)`` prints what it is, ``counts``, when given, takes each
    chunk's (decode steps, tokens, peak pages), and ``profile`` False
    skips the two profiles.  Serving:
    ``ContinuousScheduler`` on the paged pool (page_size 16, 8 slots) with
    the mux, decode-demux and (for attention layers) paged kernels serves
    a 40-request Poisson trace (prompt 32, 16 new tokens) at each
    prefill_chunk of ``chunks``; a contiguous plain run over a
    ``with_config`` view replays the kernel run's sampled tokens and, for
    MoE layers, its routing (``RoutingTape``): equal decode steps and
    tokens, every step's logits within LOGIT_TOL, greedy picks equal where
    clear; a paged plain run (tokens replayed) gives the same steps and
    peak pages; the pool (with the recurrent states) holds
    ``paged_cache_bytes`` bytes; a model with no attention layer launches
    neither attention kernel.  Evaluation: ``make_eval_step``
    through a ``use_flash`` view (flash on attention layers) and the mux
    and demux kernels (1 group, L 512) against the plain view with the
    routing replayed: logits within LOGIT_TOL, task and retrieval losses
    (and ``moe_aux`` with MoE layers) within EVAL_LOSS_TOL.  Peak memory
    under 70 GB; eval-step times on and off in turns; profiles of a
    scheduler step and an eval step with the MoE stages' and the mixers'
    device time."""
    import gc

    from repro_torch.configs.base import ServingConfig
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.nn.moe import capacity
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvcache import cache_nbytes, paged_cache_bytes
    from repro_torch.serving.scheduler import (ContinuousScheduler,
                                               poisson_trace)

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch, n_requests, rate, prompt_len, gen_len = 8, 40, 8.0, 32, 16
    max_total = prompt_len * 2 + gen_len * 4 + 1
    moe = base.moe
    kinds = base.layer_kinds()
    n_attn = sum(k["mixer"] == "attn" for k in kinds)
    n_moe = sum(k["mlp"] == "moe" for k in kinds)
    kernels = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(paged=True, page_size=16, use_kernel=True,
                              fuse_demux=True))
    model = Backbone(kernels, seed=seed, device="cuda").eval()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    router = {p.dtype for n, p in model.named_parameters() if "router" in n}
    describe(model, weights, router)
    # The weights are drawn in float32 and then cast, so the draw of the
    # largest tensor (an expert stack) sets a peak of its own.
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    print(f"{tag} peak memory while the weights were drawn {init_peak:.2f} "
          f"GB (float32 draws, then the cast)")
    if n_moe and router != {torch.float32}:
        raise SystemExit(f"{tag} FAIL: the router weight is not float32")
    trace = poisson_trace(n_requests, rate=rate, prompt_len=prompt_len,
                          gen_len=gen_len, vocab=base.vocab,
                          max_total=max_total, seed=seed)
    print(f"{tag} poisson_trace({n_requests}, rate={rate}, prompt_len="
          f"{prompt_len}, gen_len={gen_len}, max_total={max_total}), batch "
          f"{batch}, page_size 16"
          + (f"; capacity per expert at a decode step of {batch} rows: "
             f"{capacity(batch, moe)}, at a chunk of 4 rows: "
             f"{capacity(4 * batch, moe)}" if n_moe else ""))
    tape = RoutingTape(tag)
    tape.install()

    def scheduler(m, chunk):
        m = m.with_config(dataclasses.replace(
            m.cfg, serving=dataclasses.replace(m.cfg.serving,
                                               prefill_chunk=chunk)))
        return ContinuousScheduler(Engine(m, batch=batch, max_len=max_total))

    plain = model.with_config(dataclasses.replace(
        base, serving=ServingConfig()))
    paged_plain = model.with_config(dataclasses.replace(
        base, serving=ServingConfig(paged=True, page_size=16)))
    scheduler(model, 1).run([r.fresh() for r in trace[:8]])   # warm-up
    torch.cuda.synchronize()
    launches = {}
    for chunk in chunks:
        tape.start("record")
        _build.LAUNCHES.clear()
        sched = scheduler(model, chunk)
        forced = []
        record_teacher_forced(sched, forced, pick=last_row, every_step=True)
        t0 = time.perf_counter()
        stats = sched.run([r.fresh() for r in trace])
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        tape.finish(tag)
        run_launches = dict(_build.LAUNCHES)
        alloc = sched.allocator
        print(f"{tag} prefill_chunk {chunk}: {stats.finished}/{n_requests} "
              f"requests, {stats.decode_steps} decode steps, "
              f"{stats.generated_tokens} tokens in {dt:.4f} s = "
              f"{stats.generated_tokens / dt:.1f} tok/s, "
              f"{dt / stats.decode_steps * 1e3:.3f} ms per step ({base.dtype}"
              f", {torch.cuda.get_device_name(0)}); peak {stats.peak_pages}/"
              f"{alloc.table.usable_pages} pages; {len(tape.calls)} MoE "
              f"calls; kernel launches {run_launches}")
        if stats.finished != n_requests:
            raise SystemExit(f"{tag} FAIL: not every request finished")
        if alloc.table.pages_in_use != alloc.n_prefix_pages * batch:
            raise SystemExit(f"{tag} FAIL: pages leaked after the drain")
        pool_bytes = cache_nbytes(alloc.cache)
        want_bytes = paged_cache_bytes(base, batch, alloc.max_len,
                                       pool_pages=alloc.pool_pages,
                                       page_size=alloc.page_size)
        print(f"{tag} prefill_chunk {chunk}: pool {pool_bytes} bytes "
              f"({alloc.pool_pages} pages of {alloc.page_size}, "
              f"{alloc.page_bytes()} bytes a page over {len(kinds)} "
              f"layers), paged_cache_bytes {want_bytes}")
        if pool_bytes != want_bytes:
            raise SystemExit(f"{tag} FAIL: the pool's bytes are not "
                             f"paged_cache_bytes'")
        if run_launches.get("paged_decode_attention", 0) != \
                n_attn * stats.decode_steps:
            raise SystemExit(f"{tag} FAIL: paged_decode_attention launched "
                             f"{run_launches.get('paged_decode_attention')} "
                             f"times, expected "
                             f"{n_attn * stats.decode_steps}")
        for name in ("hadamard_mux", "decode_demux"):
            if not run_launches.get(name):
                raise SystemExit(f"{tag} FAIL: {name} never launched")
        if not n_attn and (run_launches.get("paged_decode_attention") or
                           run_launches.get("flash_attention")):
            raise SystemExit(f"{tag} FAIL: a model with no attention layer "
                             f"launched an attention kernel")
        if len(tape.calls) != n_moe * (stats.decode_steps + 1):
            raise SystemExit(f"{tag} FAIL: {len(tape.calls)} MoE calls, "
                             f"expected one per MoE layer and step and the "
                             f"prime's")
        for name, count in run_launches.items():
            launches[name] = launches.get(name, 0) + count
        if counts is not None:
            counts[chunk] = (stats.decode_steps, stats.generated_tokens,
                             stats.peak_pages)

        outputs = {q.rid: list(q.output) for q in sched.finished}
        tape.start("replay")           # the prime's MoE calls too
        _build.LAUNCHES.clear()
        psched = scheduler(plain, chunk)
        psched.sampling = Replay(psched.sampling, outputs)
        pforced = []
        record_teacher_forced(psched, pforced, pick=last_row,
                              every_step=True)
        pstats = psched.run([r.fresh() for r in trace])
        torch.cuda.synchronize()
        tape.finish(f"{tag} prefill_chunk {chunk}")
        ppsched = scheduler(paged_plain, chunk)
        ppsched.sampling = Replay(ppsched.sampling, outputs)
        ppstats = ppsched.run([r.fresh() for r in trace])
        torch.cuda.synchronize()
        if _build.LAUNCHES:
            raise SystemExit(f"{tag} FAIL: the plain path launched "
                             f"{dict(_build.LAUNCHES)}")
        for what, a, b in (
                ("decode steps (contiguous plain)", stats.decode_steps,
                 pstats.decode_steps),
                ("generated tokens (contiguous plain)",
                 stats.generated_tokens, pstats.generated_tokens),
                ("decode steps (paged plain)", stats.decode_steps,
                 ppstats.decode_steps),
                ("peak pages (paged plain)", stats.peak_pages,
                 ppstats.peak_pages)):
            print(f"{tag} prefill_chunk {chunk} {what}: kernels {a}, "
                  f"plain {b}")
            if a != b:
                raise SystemExit(f"{tag} FAIL: prefill_chunk {chunk} {what} "
                                 f"differ")
        check_forced(f"{tag} prefill_chunk {chunk}", forced, pforced)
        check_replay(f"{tag} prefill_chunk {chunk}", psched.sampling)
        del forced, pforced, sched, psched, ppsched
        gc.collect()
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    if profile:
        profile_scheduler(torch, scheduler(model, 1), trace, warm=8,
                          steps=4, label=f"{tag[1:-1]} scheduler step")

    for name, count in eval_against_plain(
            torch, seed, tag, base, kernels, model, plain, tape,
            n_attn=n_attn, n_moe=n_moe, peaks=(init_peak, serve_peak),
            profile=profile).items():
        launches[name] = launches.get(name, 0) + count
    tape.uninstall()
    del model, plain, paged_plain
    return launches


def eval_against_plain(torch, seed: int, tag: str, base, kernels, model,
                       plain, tape, *, n_attn: int, n_moe: int, peaks=(),
                       profile: bool = True, context=None) -> dict:
    """Evaluation half of ``serve_and_eval``: ``make_eval_step`` (1 group,
    L 512, task lm with the retrieval auxiliary) through a ``use_flash``
    view of ``model`` under ``kernels`` (flash on the ``n_attn`` causal
    attention layers, the mux and demux kernels) against the ``plain``
    view, the plain run replaying the kernel run's routing (``tape``):
    logits within LOGIT_TOL, task and retrieval losses (and ``moe_aux``
    with ``n_moe`` MoE layers) within EVAL_LOSS_TOL.  ``context``, when
    given, is the batch's (1, Lc, context_dim) context.  Eval-step times
    on and off in turns; peak memory (with ``peaks``, the phase's earlier
    ones) under 70 GB; a profile of the step unless ``profile`` is
    False.  Returns the kernel launches of one eval step and one
    forward."""
    from repro_torch.configs.base import ServingConfig
    from repro_torch.core.retrieval import retrieval_index
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.kernels import _build
    from repro_torch.training.trainer import TrainConfig, Trainer

    launches = {}
    seq_len = 512
    tcfg = TrainConfig(task="lm")
    flash = model.with_config(dataclasses.replace(
        kernels, serving=ServingConfig()), use_flash=True)
    state, pstate = {"model": flash}, {"model": plain}
    batch_ = {k: torch.as_tensor(v).long().cuda() for k, v in next(iter(
        mux_batches(RetrievalTask(vocab=base.vocab, seq_len=seq_len),
                    groups=1, n_mux=base.mux.n, steps=1,
                    seed=seed))).items()}
    if context is not None:
        batch_["context"] = context
    index = retrieval_index(torch.Generator(device="cuda").manual_seed(seed),
                            1, base.mux.n, seq_len)
    step = Trainer.make_eval_step(flash.cfg, tcfg)
    plain_step = Trainer.make_eval_step(plain.cfg, tcfg)
    step(state, batch_, None, retr_index=index)                # warm-up
    torch.cuda.synchronize()
    tape.start("record")
    _build.LAUNCHES.clear()
    metrics = step(state, batch_, None, retr_index=index)
    with torch.inference_mode():
        logits = flash(batch_["tokens"],
                       context=batch_.get("context"))["logits"]
    torch.cuda.synchronize()
    eval_launches = dict(_build.LAUNCHES)
    tape.finish(tag)
    # flash on the attention layers only: MLA never goes through it
    want = {"flash_attention": 2 * n_attn, "hadamard_mux": 2,
            "index_embed_demux": 2}
    want = {name: count for name, count in want.items() if count}
    print(f"{tag} eval (1 group, L {seq_len}): kernel launches in one eval "
          f"step and one forward {eval_launches}")
    if eval_launches != want:
        raise SystemExit(f"{tag} FAIL: eval launches {eval_launches}, "
                         f"expected {want}")
    for name, count in eval_launches.items():
        launches[name] = launches.get(name, 0) + count
    tape.start("replay")
    plain_metrics = plain_step(pstate, batch_, None, retr_index=index)
    with torch.inference_mode():
        plain_logits = plain(batch_["tokens"],
                             context=batch_.get("context"))["logits"]
    torch.cuda.synchronize()
    tape.finish(f"{tag} eval")
    n = base.mux.n
    err = max((logits[:, i].float() - plain_logits[:, i].float())
              .abs().max().item() for i in range(n))
    tol = LOGIT_TOL * plain_logits.abs().max().item()
    agree = (logits.argmax(-1) == plain_logits.argmax(-1)).float().mean()
    print(f"{tag} eval logits {tuple(logits.shape)}, flash + kernels vs "
          f"plain: max_abs_err {err:.4g} (tol {tol:.4g}), greedy tokens "
          f"agree {agree.item():.4f}")
    if not (err <= tol and bool(logits.isfinite().all())):
        raise SystemExit(f"{tag} FAIL: eval logits disagree")
    del logits, plain_logits
    for key in ("task_loss", "retr_loss") + (("moe_aux",) if n_moe else ()):
        got, ref = float(metrics[key]), float(plain_metrics[key])
        rel = abs(got - ref) / abs(ref)
        print(f"{tag} eval {key}: flash + kernels {got:.6g}, plain "
              f"{ref:.6g}, relative diff {rel:.3g} (tol {EVAL_LOSS_TOL})")
        if not (rel <= EVAL_LOSS_TOL and math.isfinite(got)):
            raise SystemExit(f"{tag} FAIL: eval {key} disagrees")
    walls = {"flash + kernels": [], "plain": []}
    runs = {"flash + kernels": (step, state), "plain": (plain_step, pstate)}
    for label in ("flash + kernels", "plain") * 2:           # in turns
        fn, st = runs[label]
        walls[label].append(eval_step_ms(torch, fn, st, [batch_], [index]))
    peak_gb = max(*peaks, torch.cuda.max_memory_allocated() / 1e9)
    print(f"{tag} eval step wall ms (in turns): "
          + ", ".join(f"{label} {[round(t, 3) for t in w]}"
                      for label, w in walls.items())
          + f"; peak memory of the phase {peak_gb:.2f} GB (earlier in "
          f"the phase {[round(p, 2) for p in peaks]} GB)")
    if not peak_gb < 70:
        raise SystemExit(f"{tag} FAIL: peak memory {peak_gb:.2f} GB")
    if profile:
        profile_eval(torch, step, state, batch_, index,
                     statistics.median(walls["flash + kernels"]),
                     label=f"{tag[1:-1]} eval step")
    del state, pstate, flash
    return launches


# ---------------------------------------------------------------------------
# Phase 13: mLSTM and sLSTM in xlstm-125m
# ---------------------------------------------------------------------------

def run_ssm(torch, seed: int):
    """xlstm-125m at full width and depth (12 layers: 8 mLSTM of d_inner
    1536 over 4 heads of 384, 4 sLSTM with their GeGLU FFN of 1024; d 768,
    vocab 50304; about 160 M parameters), N = 8, weights from ``seed``:
    no layer in the page pool (every state contiguous), the mux,
    decode-demux and index-embed demux kernels on, neither attention
    kernel launched, the xLSTM mixers on the plain path (the reference's
    are plain jnp); an ``Engine`` at prefill_chunk 4 must be refused,
    naming xLSTM, as the reference refuses it.

    The comparisons of ``serve_and_eval`` (prefill_chunk 1) run in
    float32: with random weights the model is too sensitive to rounding
    for any two bf16 runs to agree within LOGIT_TOL (the reference itself
    in bf16 is about 20% of max|logit| off its float32 logits; here the
    plain path's one decode step in bf16 against float32 on the same
    weights is printed).  The model in bf16 then serves the trace and
    evaluates with the kernels on, for its times and profiles (the
    float32 runs are not profiled): the same counts as the float32 run,
    finite logits and losses."""
    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.core.retrieval import retrieval_index
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import (ContinuousScheduler,
                                               poisson_trace)
    from repro_torch.training.trainer import TrainConfig, Trainer

    base = get_config("xlstm-125m", mux_n=8)
    f32 = dataclasses.replace(base, dtype="float32", param_dtype="float32")

    def describe(model, weights, router):
        x = base.xlstm
        kinds = [k["mixer"] for k in base.layer_kinds()]
        per = {name: sum(p.numel() for n, p in model.named_parameters()
                         if f".{name}." in n) // kinds.count(name)
               for name in ("mlstm", "slstm")}
        print(f"[ssm] {base.name}: d={base.d_model}, {base.n_layers} layers "
              f"({kinds.count('mlstm')} mLSTM of d_inner {x.d_inner} over "
              f"{x.n_heads} heads of {x.head_dim}, {per['mlstm'] / 1e6:.2f} "
              f"M parameters a layer; {kinds.count('slstm')} sLSTM, "
              f"{per['slstm'] / 1e6:.2f} M a layer, at layers "
              f"{[i for i, k in enumerate(kinds) if k == 'slstm']}), vocab "
              f"{base.vocab}, N={base.mux.n}, "
              f"{sum(p.numel() for p in model.parameters()) / 1e6:.1f} M "
              f"parameters ({weights / 1e9:.3f} GB in {model.cfg.dtype}); "
              f"nothing cut")
        wide = model.with_config(dataclasses.replace(
            model.cfg, serving=dataclasses.replace(model.cfg.serving,
                                                   prefill_chunk=4)))
        try:
            Engine(wide, batch=8, max_len=64)
        except ValueError as e:
            if "xLSTM" not in str(e):
                raise
            print(f"[ssm] prefill_chunk 4 refused: {e}")
        else:
            raise SystemExit("[ssm] FAIL: an Engine at prefill_chunk 4 was "
                             "not refused")

    counts = {}
    launches = serve_and_eval(torch, seed, f32, "[ssm]", describe,
                              chunks=(1,), counts=counts, profile=False)

    # bf16: the same trace and eval with the kernels on, for times.
    batch, gen_len, prompt_len = 8, 16, 32
    max_total = prompt_len * 2 + gen_len * 4 + 1
    kernels = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(paged=True, page_size=16, fuse_demux=True))
    model = Backbone(kernels, seed=seed, device="cuda").eval()
    plain = model.with_config(dataclasses.replace(
        base, serving=ServingConfig()))
    wide = Backbone(f32, seed=seed, device="cuda").eval()
    with torch.no_grad():
        for p, q in zip(wide.parameters(), model.parameters()):
            p.copy_(q.float())             # the bf16 weights, in float32
    toks = torch.randint(0, base.vocab, (batch, base.mux.n), device="cuda",
                         generator=torch.Generator(device="cuda")
                         .manual_seed(seed))
    step0 = []
    for m in (plain, wide):
        eng = Engine(m, batch=batch, max_len=max_total)
        logits, _ = eng.step(eng.prime(), toks)
        step0.append(logits.float())
    err = (step0[0] - step0[1]).abs().max().item()
    top = step0[1].abs().max().item()
    print(f"[ssm] one decode step on the plain path, bf16 against float32 "
          f"on the same (bf16) weights: max_abs_err {err:.4g} of max|logit| "
          f"{top:.4g} ({err / top:.4f}; LOGIT_TOL {LOGIT_TOL})")
    del wide, step0
    trace = poisson_trace(40, rate=8.0, prompt_len=prompt_len,
                          gen_len=gen_len, vocab=base.vocab,
                          max_total=max_total, seed=seed)

    def scheduler():
        return ContinuousScheduler(Engine(model, batch=batch,
                                          max_len=max_total))
    scheduler().run([r.fresh() for r in trace[:8]])             # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    sched = scheduler()
    forced = []
    record_teacher_forced(sched, forced, pick=last_row, every_step=True)
    t0 = time.perf_counter()
    stats = sched.run([r.fresh() for r in trace])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    run_launches = dict(_build.LAUNCHES)
    finite = all(bool(f.isfinite().all()) for f in forced)
    print(f"[ssm] bf16 prefill_chunk 1: {stats.finished}/{len(trace)} "
          f"requests, {stats.decode_steps} decode steps, "
          f"{stats.generated_tokens} tokens in {dt:.4f} s = "
          f"{stats.generated_tokens / dt:.1f} tok/s, "
          f"{dt / stats.decode_steps * 1e3:.3f} ms per step "
          f"({torch.cuda.get_device_name(0)}); peak {stats.peak_pages} "
          f"pages; kernel launches {run_launches}; logits finite {finite}")
    got = (stats.decode_steps, stats.generated_tokens, stats.peak_pages)
    if got != counts[1] or not finite:
        raise SystemExit(f"[ssm] FAIL: bf16 counts {got} (float32 "
                         f"{counts[1]}) or non-finite logits")
    if run_launches.get("paged_decode_attention") or \
            run_launches.get("flash_attention"):
        raise SystemExit("[ssm] FAIL: an attention kernel was launched")
    for name, count in run_launches.items():
        launches[name] = launches.get(name, 0) + count
    del forced
    profile_scheduler(torch, scheduler(), trace, warm=8, steps=4,
                      label="ssm bf16 scheduler step")

    seq_len = 512
    tcfg = TrainConfig(task="lm")
    flash = model.with_config(dataclasses.replace(
        kernels, serving=ServingConfig()), use_flash=True)
    state, pstate = {"model": flash}, {"model": plain}
    batch_ = {k: torch.as_tensor(v).long().cuda() for k, v in next(iter(
        mux_batches(RetrievalTask(vocab=base.vocab, seq_len=seq_len),
                    groups=1, n_mux=base.mux.n, steps=1,
                    seed=seed))).items()}
    index = retrieval_index(torch.Generator(device="cuda").manual_seed(seed),
                            1, base.mux.n, seq_len)
    step = Trainer.make_eval_step(flash.cfg, tcfg)
    plain_step = Trainer.make_eval_step(plain.cfg, tcfg)
    _build.LAUNCHES.clear()
    metrics = step(state, batch_, None, retr_index=index)
    plain_metrics = plain_step(pstate, batch_, None, retr_index=index)
    torch.cuda.synchronize()
    for name, count in _build.LAUNCHES.items():
        launches[name] = launches.get(name, 0) + count
    print(f"[ssm] bf16 eval (1 group, L {seq_len}): launches "
          f"{dict(_build.LAUNCHES)}; "
          + ", ".join(f"{k} kernels {float(metrics[k]):.6g} plain "
                      f"{float(plain_metrics[k]):.6g}"
                      for k in ("task_loss", "retr_loss")))
    if not all(math.isfinite(float(m[k])) for m in (metrics, plain_metrics)
               for k in ("task_loss", "retr_loss")):
        raise SystemExit("[ssm] FAIL: bf16 eval losses not finite")
    walls = {"kernels": [], "plain": []}
    runs = {"kernels": (step, state), "plain": (plain_step, pstate)}
    for label in ("kernels", "plain") * 2:                     # in turns
        fn, st = runs[label]
        walls[label].append(eval_step_ms(torch, fn, st, [batch_], [index]))
    print("[ssm] bf16 eval step wall ms (in turns): "
          + ", ".join(f"{label} {[round(t, 3) for t in w]}"
                      for label, w in walls.items())
          + f"; peak memory of the phase "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    profile_eval(torch, step, state, batch_, index,
                 statistics.median(walls["kernels"]),
                 label="ssm bf16 eval step")
    return launches


# ---------------------------------------------------------------------------
# Phases 14 and 15: cross-attention in whisper-base and llama-3.2-vision-11b
# ---------------------------------------------------------------------------

def run_cross(torch, seed: int, arch: str, tag: str):
    """``arch`` (whisper-base or llama-3.2-vision-11b) whole, at full width
    and depth, N = 8, bf16, weights from ``seed`` and every ``cross_gate``
    set to a nonzero value drawn from it (the reference starts them at 0,
    where the cross sublayer adds nothing), over a random context of the
    config's (context_len, context_dim) per slot.  The reference serves a
    cross config lock-step only (its prime runs the demux prefix without
    the context), and so does this phase: ``Engine.generate`` of B 8 x N 8
    streams, prompt 32, 16 new tokens, with the mux, index-embed and
    decode demux kernels on; a plain run over a ``with_config`` view
    replays the kernel run's tokens (every step's logits within LOGIT_TOL,
    greedy picks equal where the margin is clear); the context K/V the
    state holds are ``_cross_kv_bytes``; two contexts give different
    logits.  Then ``eval_against_plain`` with the context in the batch
    (flash on the decoder's causal self-attention only: the encoder is
    bidirectional and the cross-attention plain, as in the reference);
    profiles of a decode step and an eval step with the device time of
    the ``cross`` and ``encoder`` labels."""
    import gc

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine
    from repro_torch.serving.kvcache import _cross_kv_bytes

    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    batch, prompt_len, steps = 8, 32, 16
    base = get_config(arch, mux_n=8)
    kernels = dataclasses.replace(
        base, mux=dataclasses.replace(base.mux, use_kernel=True),
        serving=ServingConfig(fuse_demux=True))
    kinds = base.layer_kinds()
    cross = [i for i, k in enumerate(kinds) if k["cross"]]
    model = Backbone(kernels, seed=seed, device="cuda").eval()
    weights = sum(p.numel() * p.element_size() for p in model.parameters())
    enc = base.encoder
    print(f"{tag} {base.name}: d={base.d_model}, {base.n_layers} layers, "
          f"{base.n_heads} heads over {base.n_kv_heads} KV heads of "
          f"{base.head_dim_}, cross-attention on layers {cross} over a "
          f"context of {base.context_len} x {base.context_dim}"
          + (f", an encoder of {enc.n_layers} bidirectional layers (d "
             f"{enc.d_model})" if enc is not None else "")
          + f", vocab {base.vocab}, N={base.mux.n}, "
          f"{sum(p.numel() for p in model.parameters()) / 1e9:.4f} B "
          f"parameters ({weights / 1e9:.2f} GB in {base.dtype}; "
          f"param_count {base.param_count() / 1e9:.4f} B); nothing cut")
    init_peak = torch.cuda.max_memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    print(f"{tag} peak memory while the weights were drawn {init_peak:.2f} "
          f"GB (float32 draws, then the cast)")
    gen = torch.Generator(device="cuda").manual_seed(seed)
    gates = 0.25 + 0.5 * torch.rand(len(cross), generator=gen,
                                    device="cuda")
    with torch.no_grad():
        for i, g in zip(cross, gates):
            model.layers[i].cross_gate.fill_(g)
    print(f"{tag} cross gates set from the seed: "
          f"{[round(g, 4) for g in gates.tolist()]}")
    prompts = torch.randint(0, base.vocab, (batch, base.mux.n, prompt_len),
                            generator=gen, device="cuda")
    ctx, ctx2 = (torch.randn((batch, base.context_len, base.context_dim),
                             generator=gen, device="cuda") for _ in range(2))
    plain = model.with_config(dataclasses.replace(
        base, serving=ServingConfig()))
    max_len = prompt_len + steps + 1
    eng = Engine(model, batch=batch, max_len=max_len)
    peng = Engine(plain, batch=batch, max_len=max_len)

    eng.generate(prompts, 2, context=ctx)           # warm-up
    torch.cuda.synchronize()
    _build.LAUNCHES.clear()
    t0 = time.perf_counter()
    out = eng.generate(prompts, steps, context=ctx)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = dict(_build.LAUNCHES)
    streams = batch * base.mux.n
    print(f"{tag} generate: {streams} streams x {steps} tokens in {dt:.4f} "
          f"s = {streams * steps / dt:.1f} streams x tokens/s, encoding "
          f"included ({base.dtype}, {torch.cuda.get_device_name(0)}); "
          f"kernel launches {launches}")
    want = {"hadamard_mux": steps + 1, "index_embed_demux": 1,
            "decode_demux": steps}
    if tuple(out.shape) != (batch, base.mux.n, steps + 1) or \
            launches != want:
        raise SystemExit(f"{tag} FAIL: output {tuple(out.shape)}, launches "
                         f"{launches} (expected {want})")

    # The plain path replays the kernel run's tokens, teacher-forced.
    forced, pforced = [], []
    for e, keep in ((eng, forced), (peng, pforced)):
        logits, state = e.prefill(prompts, context=ctx)
        keep.append(logits.clone())
        for t in range(steps):
            logits, state = e.step(state, out[..., t])
            keep.append(logits.clone())
    check_forced(f"{tag} generate", forced, pforced)
    held = sum(t.numel() * t.element_size()
               for kv in state.cross_kv.values() for t in kv.values())
    want_bytes = _cross_kv_bytes(base, batch)
    print(f"{tag} context K/V held by the serving state: {held} bytes "
          f"({len(state.cross_kv)} layers, {held / batch / 1e6:.1f} MB a "
          f"slot), _cross_kv_bytes {want_bytes}")
    if held != want_bytes:
        raise SystemExit(f"{tag} FAIL: the context K/V are not "
                         f"_cross_kv_bytes")
    first = {}
    for name, c in (("context A", ctx), ("context B", ctx2)):
        first[name] = peng.prefill(prompts, context=c)[0].float()
    moved = (first["context A"] - first["context B"]).abs().max().item()
    top = first["context A"].abs().max().item()
    print(f"{tag} prefill logits over two contexts (plain path): max|diff| "
          f"{moved:.4g} of max|logit| {top:.4g} ({moved / top:.4f})")
    if not (moved > 0 and math.isfinite(moved)):
        raise SystemExit(f"{tag} FAIL: the logits do not depend on the "
                         f"context")
    del forced, pforced, first, state
    serve_peak = torch.cuda.max_memory_allocated() / 1e9

    walls = {"kernels on": [], "kernels off": []}
    engines = {"kernels on": eng, "kernels off": peng}
    for label in ("kernels on", "kernels off") * 2:   # in turns
        e = engines[label]
        walls[label].append(decode_step_ms(
            torch, e, e.prefill(prompts, context=ctx)[1], out[..., 0]))
    print(f"{tag} decode step wall ms (in turns): "
          + ", ".join(f"{label} {[round(t, 3) for t in w]}"
                      for label, w in walls.items()))
    profile_decode(torch, eng, prompts, out[..., 0],
                   f"{tag[1:-1]} decode step",
                   statistics.median(walls["kernels on"]), context=ctx)
    profile_prefill(torch, eng, prompts, ctx, f"{tag[1:-1]} prefill")

    tape = RoutingTape(tag)
    tape.install()
    n_attn = sum(k["mixer"] == "attn" for k in kinds)
    for name, count in eval_against_plain(
            torch, seed, tag, base, kernels, model, plain, tape,
            n_attn=n_attn, n_moe=0, peaks=(init_peak, serve_peak),
            context=ctx[:1]).items():
        launches[name] = launches.get(name, 0) + count
    tape.uninstall()
    del model, plain, eng, peng
    return launches


def run_audio(torch, seed: int):
    return run_cross(torch, seed, "whisper-base", "[audio]")


def run_vlm(torch, seed: int):
    return run_cross(torch, seed, "llama-3.2-vision-11b", "[vlm]")


# ---------------------------------------------------------------------------
# Phase 16: the image models
# ---------------------------------------------------------------------------

def run_image(torch, seed: int):
    """``MuxMLP`` and ``MuxCNN`` at the paper's sizes (20x20, 10 classes,
    hidden 100, groups 20 / 84, N 4) with every registered mux strategy
    that validates at d 400, f32, weights from ``seed``, on a batch of
    the port's synthetic digits (32 groups): logits, ``image_loss`` and
    every parameter's gradient on the card against the same weights and
    batch on the CPU within 1e-4 x max(1, max|CPU|); the image mux runs
    the strategies' plain ``combine`` (no kernel launch), as the
    reference's does."""
    import numpy as np

    from repro_torch.core.strategies import get_mux, list_mux_strategies
    from repro_torch.data.images import SyntheticDigits
    from repro_torch.kernels import _build
    from repro_torch.models import image

    n, groups = 4, 32
    data = SyntheticDigits(seed=seed).sample(
        groups * n, np.random.default_rng(seed))
    imgs = torch.from_numpy(data["images"].reshape(groups, n, 20, 20))
    labels = torch.from_numpy(data["labels"].reshape(groups, n))
    names = []
    for name in list_mux_strategies():
        try:
            get_mux(name).validate(image.ImageMuxConfig(n=n), 400)
        except ValueError as e:
            print(f"[image] {name}: skipped ({e})")
            continue
        names.append(name)
    print(f"[image] strategies that validate at d 400, N {n}: {names}")
    _build.LAUNCHES.clear()
    worst = 0.0
    for name in names:
        cfg = image.ImageMuxConfig(n=n, strategy=name)
        for cls in (image.MuxMLP, image.MuxCNN):
            cpu = cls(cfg, seed=seed, device="cpu")
            card = cls(cfg, seed=seed, device="cpu").to("cuda")
            outs, times = [], []
            for m, dev in ((cpu, "cpu"), (card, "cuda")):
                t0 = time.perf_counter()
                logits = m(imgs.to(dev))
                loss, acc = image.image_loss(logits, labels.to(dev))
                grads = torch.autograd.grad(loss, list(m.parameters()),
                                            allow_unused=True)
                if dev == "cuda":
                    torch.cuda.synchronize()
                times.append((time.perf_counter() - t0) * 1e3)
                outs.append([logits.detach(), loss.detach()]
                            + [g for g in grads if g is not None])
            if len(outs[0]) != len(outs[1]):
                raise SystemExit(f"[image] FAIL: {cls.__name__} {name}: "
                                 f"the card and the CPU differ in which "
                                 f"parameters have a gradient")
            ratio = max((a.cpu() - w).abs().max().item()
                        / max(1.0, w.abs().max().item())
                        for w, a in zip(*outs))
            worst = max(worst, ratio)
            print(f"[image] {cls.__name__} {name}: loss "
                  f"{outs[1][1].item():.6f}, accuracy {acc.item():.4f}, "
                  f"{len(outs[0]) - 2} gradients; "
                  f"card vs CPU max err {ratio:.3g} x max(1, max|CPU|) (tol "
                  f"1e-4); first forward + backward {times[1]:.1f} ms on the "
                  f"card, {times[0]:.1f} ms on the CPU (host clock, build "
                  f"included)")
            if not (ratio <= 1e-4 and bool(outs[1][0].isfinite().all())):
                raise SystemExit(f"[image] FAIL: {cls.__name__} {name} "
                                 f"disagrees with the CPU")
    if _build.LAUNCHES:
        raise SystemExit(f"[image] FAIL: the image models launched "
                         f"{dict(_build.LAUNCHES)}")
    print(f"[image] {2 * len(names)} models held, worst {worst:.3g} of the "
          f"tolerance scale")
    return {}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"[env] {smi}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    lib = _build.build(verbose=True)
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")
    report_build(lib, _build)

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = (check_kernels(torch, gen) + check_paged_kernel(torch, gen)
               + check_flash_kernel(torch, gen))
    seen = record_shapes()
    by_phase = {}
    for phase, run in (("slice", run_slice), ("paged", run_paged_slice),
                       ("eval", run_eval), ("router", run_router),
                       ("train", run_train), ("mesh", run_mesh),
                       ("dryrun", run_dryrun),
                       ("window", run_window),
                       ("dense", run_dense), ("moe", run_moe),
                       ("mla", run_mla), ("hybrid", run_hybrid),
                       ("ssm", run_ssm), ("audio", run_audio),
                       ("vlm", run_vlm), ("image", run_image)):
        t0 = time.perf_counter()
        by_phase[phase] = run(torch, args.seed)
        print(f"[time] phase [{phase}]: {time.perf_counter() - t0:.1f} s")
    check_shapes(seen, results)
    launches = dict(by_phase["slice"])
    launches["paged_decode_attention"] = by_phase["paged"][
        "paged_decode_attention"]
    launches["flash_attention"] = by_phase["eval"]["flash_attention"]

    # One entry per kernel, at the bf16 shape its slice runs most often
    # (L = 1 prefill demux, C = 1 decode demux, L = 1 decode-step mux, the
    # paged slice's C = 1 decode with kblock_pages = 1, the evaluation
    # slice's causal flash attention); launches come from the lock-step
    # slice for the mux and demux kernels, from the paged slice for the
    # paged attention and from the evaluation slice for the flash
    # attention; ``launches_by_phase`` has every phase's count.
    entries = []
    for name in SOURCES:
        if name == "paged_decode_attention":
            r = next(r for r in results if r["name"] == name
                     and r["dtype"] == "bfloat16" and r["label"] == "slice C1"
                     and r["shape"]["kblock"] == 1)
        elif name == "flash_attention":
            r = next(r for r in results if r["name"] == name
                     and r["dtype"] == "bfloat16" and r["label"] == "slice"
                     and r["shape"]["causal"])
        else:
            r = next(r for r in results if r["name"] == name
                     and r["dtype"] == "bfloat16" and r["shape"]["L"] == 1)
        entries.append(dict(
            name=name, route="cuda",
            source=f"src/repro_torch/csrc/{SOURCES[name]}",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=r.get("library_ms"),
            shape=r["shape"], launches_by_phase={
                phase: counts.get(name, 0)
                for phase, counts in by_phase.items()}))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, any failure of which ends the run with a non-zero exit:

  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc
     (sm_90a), then hold each kernel against its plain PyTorch version on
     the card (run in float32 on the same inputs), in bf16 and f32, at the
     slices' shapes and at ragged ones, and time both with CUDA events (the
     paged attention kernel also beside ``scaled_dot_product_attention`` on
     K/V already gathered, a yardstick the port never calls);
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
     peak pages; then a profile of one scheduler step and a short run at
     prefill_chunk=4 (the kernel's C > 1 form).

It prints one JSON line of per-kernel numbers, then the card's
``nvidia-smi`` name and power limit, and last a JSON line with the device.
No CUDA device, or no ``src/repro_torch`` beside this file, is a failure.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12             # H100 SXM
PEAK_FLOPS = {"bfloat16": 989e12,     # dense tensor-core rate
              "float32": 67e12}       # outside the tensor cores
TOL = {"bfloat16": 1e-2, "float32": 1e-4}   # x max(1, max|plain|)
LOGIT_TOL = 5e-2                      # x max|plain logits|, bf16 slice
REPLACES = {
    "hadamard_mux": "src/repro/kernels/multiplex/kernel.py:60",
    "index_embed_demux": "src/repro/kernels/demux/kernel.py:85",
    "decode_demux": "src/repro/kernels/demux/kernel.py:166",
    "paged_decode_attention": "src/repro/kernels/paged_attention/kernel.py:190",
}
SOURCES = {
    "hadamard_mux": "hadamard_mux.cu",
    "index_embed_demux": "index_embed_demux.cu",
    "decode_demux": "decode_demux.cu",
    "paged_decode_attention": "paged_decode_attention.cu",
}


def time_ms(fn, runs: int = 21, calls: int = 5, warmup: int = 3) -> float:
    """Device time of one call in ms: the median over ``runs`` of CUDA-event
    time of ``calls`` back-to-back calls, divided by ``calls``.  Each run is
    queued behind a sleep kernel, so the host's dispatch time overlaps it
    instead of being counted as device time."""
    import torch
    for _ in range(warmup):
        fn()
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

    cases = []   # (name, shape, kernel fn, plain fn, f32 plain output, bytes, flops)
    for b, n, l, d in ((8, 40, 1, 768), (8, 40, 104, 768), (3, 5, 7, 200)):
        x32, v32 = randn(b, n, l, d), randn(n, d)
        for dtype in (torch.bfloat16, torch.float32):
            x, v = x32.to(dtype), v32.to(dtype)
            want = mux_ref.hadamard_mux(x.float(), v.float())
            s = x.element_size()
            cases.append(("hadamard_mux", dict(B=b, N=n, L=l, d=d), dtype,
                          lambda x=x, v=v: mux_kernel.hadamard_mux(x, v),
                          lambda x=x, v=v: mux_ref.hadamard_mux(x, v), want,
                          s * (b * n * l * d + n * d + b * l * d),
                          2 * b * n * l * d))
    demux_shapes = (("index_embed_demux", 8, 40, 1, 768, 1536),
                    ("index_embed_demux", 8, 40, 104, 768, 1536),
                    ("index_embed_demux", 3, 5, 7, 200, 300),
                    ("decode_demux", 8, 40, 1, 768, 1536),
                    ("decode_demux", 3, 5, 7, 200, 300))
    for name, b, n, l, d, hid in demux_shapes:
        h32, p32 = randn(b, l, d), randn(b, n, d)
        w1_32, b1_32 = randn(hid, 2 * d, scale=(2 * d) ** -0.5), \
            randn(hid, scale=0.1)
        w2_32, b2_32 = randn(d, hid, scale=hid ** -0.5), randn(d, scale=0.1)
        fn = getattr(demux_kernel, name)
        for dtype in (torch.bfloat16, torch.float32):
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
            cases.append((name, dict(B=b, N=n, L=l, d=d, H=hid), dtype,
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
    return results


def paged_inputs(torch, gen, dtype, *, b, h, kvh, hd, ps, mp, c,
                 lengths=None, pool=None, seed=0):
    """Pool, block table and query block on the card.  With ``lengths``
    each slot holds that many positions in its first pages (the serving
    layout: full pages, the last one partial, q at the last C positions);
    without, each slot maps a random number of distinct pages, each
    written up to a random length, q at random consecutive positions."""
    pool = pool or b * mp + 1
    q = torch.randn((b, c, h, hd), generator=gen, device="cuda")
    k = torch.randn((pool, ps, kvh, hd), generator=gen, device="cuda")
    v = torch.randn((pool, ps, kvh, hd), generator=gen, device="cuda")
    bt = torch.full((b, mp), -1, dtype=torch.int32)
    pos = torch.full((pool, ps), -1, dtype=torch.int32)
    cg = torch.Generator().manual_seed(seed)   # host-side layout choices
    pages = (1 + torch.randperm(pool - 1, generator=cg)).tolist()
    q_pos = torch.zeros((b, c), dtype=torch.int32)
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


def check_paged_kernel(torch, gen):
    """The paged decode-attention kernel against its plain version at the
    paged slice's shapes (C = 1 and C = 4) and at a ragged one, for
    kblock_pages 1, 2 and 4; ``library_ms`` is
    ``scaled_dot_product_attention`` on K/V already gathered into position
    order with the boolean mask (the gather is not timed)."""
    import torch.nn.functional as F

    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    from repro_torch.kernels.paged_attention import ref as paged_ref
    from repro_torch.nn.attention import _repeat_kv

    g = torch.Generator().manual_seed(0)
    tmux_lengths = torch.randint(120, 138, (8,), generator=g).tolist()
    shapes = [  # (label, shape kwargs, lengths, causal, window, kblocks)
        ("slice C1", dict(b=8, h=12, kvh=12, hd=64, ps=16, mp=9, c=1),
         tmux_lengths, False, None, (1, 2, 4)),
        ("slice C4", dict(b=8, h=12, kvh=12, hd=64, ps=16, mp=9, c=4),
         tmux_lengths, False, None, (1,)),
        ("ragged", dict(b=3, h=8, kvh=2, hd=128, ps=8, mp=7, c=3, pool=37),
         None, True, 8, (1, 2, 4)),
    ]
    results = []
    with torch.no_grad():
        for label, kw, lengths, causal, window, kblocks in shapes:
            for dtype in (torch.bfloat16, torch.float32):
                args = paged_inputs(torch, gen, dtype, lengths=lengths, **kw)
                q, k_pages, v_pages, pos, bt, q_pos = args
                b, c, h, hd = q.shape
                scale = hd ** -0.5
                f32 = [t.float() if t.is_floating_point() else t
                       for t in args]
                want = paged_ref.paged_attention(*f32, scale=scale,
                                                 causal=causal, window=window)
                k_pos = paged_ref.gather_positions(pos, bt)
                diff = q_pos[:, :, None] - k_pos[:, None, :]
                mask = (k_pos >= 0)[:, None, :].expand_as(diff)
                if causal:
                    mask = mask & (diff >= 0)
                if window is not None:
                    mask = mask & (diff < window)
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
                for kb in kblocks:
                    def kern(kb=kb):
                        return paged_kernel.paged_decode_attention(
                            *args, scale=scale, causal=causal, window=window,
                            kblock_pages=kb)
                    got = kern().float()
                    torch.cuda.synchronize()
                    err = ((got - want) * live).abs().max().item()
                    tol = TOL[dname] * max(
                        1.0, (want * live).abs().max().item())
                    ms = time_ms(kern)
                    shape = dict(B=b, C=c, H=h, KVH=kvh, hd=hd, ps=ps,
                                 max_pages=bt.shape[1], mapped=mapped,
                                 kblock=kb, causal=causal, window=window)
                    print(f"[kernel] paged_decode_attention {label} {shape} "
                          f"{dname}: max_abs_err {err:.3g} (tol {tol:.3g}), "
                          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, "
                          f"sdpa on gathered K/V {library_ms:.4f} ms, "
                          f"bound {bound_ms:.3g} ms ({bound_by})")
                    if not err <= tol:
                        raise SystemExit(
                            f"[kernel] FAIL: paged_decode_attention {label} "
                            f"kblock {kb} {dname} disagrees with its plain "
                            f"version")
                    results.append(dict(
                        name="paged_decode_attention", label=label,
                        shape=shape, dtype=dname, max_abs_err=err, ms=ms,
                        plain_ms=plain_ms, bound_ms=bound_ms,
                        bound_by=bound_by, library_ms=library_ms))
    print("[kernel] library_ms of paged_decode_attention is "
          "scaled_dot_product_attention on K/V already gathered into "
          "position order; it excludes the gather")
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

def record_teacher_forced(sched, keep: list) -> None:
    """Record (on the host) the logits of every engine step taken before
    any sampled token was emitted — and so before any could be fed back:
    those steps' inputs are prompt tokens only, the same in every run of
    the trace."""
    inner = sched.engine.step

    def step(state, tokens, **kw):
        forced = sched.stats.generated_tokens == 0
        logits, state = inner(state, tokens, **kw)
        if forced:
            keep.append(logits.float().cpu())
        return logits, state
    sched.engine.step = step


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
    return launches


def profile_scheduler(torch, sched, trace, warm: int = 12, steps: int = 8):
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
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.key)
                   for e in events if e.self_device_time_total > 0),
                  reverse=True)
    busy = sum(t for t, _ in rows)
    lanes = int(sched.table.lane_mask().sum())
    print(f"[profile] paged scheduler step ({lanes} live lanes after "
          f"{warm + 2 * steps} steps): {wall:.3f} ms wall (unprofiled)")
    if not busy:
        print("[profile] paged scheduler step: device time not measured "
              "(the profiler saw no device activity)")
        return
    print(f"[profile] paged scheduler step: device busy {busy:.3f} ms per "
          f"step, idle share {1 - busy / wall:.3f}")
    for t, key in rows[:10]:
        print(f"[profile]   {t:8.4f} ms  {key[:90]}")
    host = sorted(((e.self_cpu_time_total / 1e3 / steps, e.count / steps,
                    e.key) for e in events), reverse=True)
    print("[profile] paged scheduler step: host time per step by op "
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
                   steps: int = 8):
    """Where the device time of a decode step goes (torch.profiler: self
    device time per kernel name) and the host's time per op; ``wall`` is
    the unprofiled step time the idle share is taken against."""
    from torch.profiler import ProfilerActivity, profile

    state = eng.prefill(prompts)[1]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        decode_step_ms(torch, eng, state, first, steps)
    events = prof.key_averages()
    rows = sorted(((e.self_device_time_total / 1e3 / steps, e.key)
                   for e in events if e.self_device_time_total > 0),
                  reverse=True)
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
    host = sorted(((e.self_cpu_time_total / 1e3 / steps, e.count / steps,
                    e.key) for e in events), reverse=True)
    print(f"[profile] {label}: host time per step by op (self, profiled):")
    for t, count, key in host[:8]:
        print(f"[profile]   {t:8.4f} ms  x{count:5.0f}  {key[:80]}")


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
    _build.build(verbose=True)
    print(f"[build] kernels built in {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    results = check_kernels(torch, gen) + check_paged_kernel(torch, gen)
    launches = run_slice(torch, args.seed)
    launches["paged_decode_attention"] = run_paged_slice(
        torch, args.seed)["paged_decode_attention"]

    # One entry per kernel, at the bf16 shape its slice runs most often
    # (L = 1 prefill demux, C = 1 decode demux, L = 1 decode-step mux, the
    # paged slice's C = 1 decode with kblock_pages = 1); launches come from
    # the lock-step slice for the mux and demux kernels (the mux and the
    # decode demux count again in the paged slice) and from the paged
    # slice for the paged attention.
    entries = []
    for name in SOURCES:
        if name == "paged_decode_attention":
            r = next(r for r in results if r["name"] == name
                     and r["dtype"] == "bfloat16" and r["label"] == "slice C1"
                     and r["shape"]["kblock"] == 1)
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
            shape=r["shape"]))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

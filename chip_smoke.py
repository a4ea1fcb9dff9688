#!/usr/bin/env python3
"""Runs the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py [--seed 0]

Phases, any failure of which ends the run with a non-zero exit:

  1. environment: the card's name and power limit, torch and CUDA versions;
  2. build the CUDA kernels from ``src/repro_torch/csrc`` with nvcc
     (sm_90a), then hold each kernel against its plain PyTorch version on
     the card (run in float32 on the same inputs), in bf16 and f32, at the
     slice's shapes and at a ragged one, and time both with CUDA events;
  3. the slice: serve ``tmux-12l-768h`` at full width and N=40 in bf16
     (random weights from --seed) through ``Engine.generate`` with the
     fused mux, demux and decode-demux kernels on, counting each kernel's
     launches in that run; then teacher-force the same tokens through an
     engine with the kernels off and compare prefill and first-step logits.

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
                  f"bound {bound_ms:.4f} ms ({bound_by})")
            if not err <= tol:
                raise SystemExit(f"[kernel] FAIL: {name} {shape} {dname} "
                                 f"disagrees with its plain version")
            results.append(dict(name=name, shape=shape, dtype=dname,
                                max_abs_err=err, ms=ms, plain_ms=plain_ms,
                                bound_ms=bound_ms, bound_by=bound_by))
    print("[kernel] no single PyTorch call computes the Hadamard mux or "
          "the index-embed demux MLP, so library_ms is null")
    return results


# ---------------------------------------------------------------------------
# Phase 3: the slice
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
    missing = [k for k in REPLACES if launches.get(k, 0) == 0]
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
    results = check_kernels(torch, gen)
    launches = run_slice(torch, args.seed)

    # One entry per kernel, at the bf16 shape the slice runs most often
    # (L = 1 prefill demux, C = 1 decode demux, L = 1 decode-step mux).
    entries = []
    for name, src in (("hadamard_mux", "hadamard_mux.cu"),
                      ("index_embed_demux", "index_embed_demux.cu"),
                      ("decode_demux", "decode_demux.cu")):
        r = next(r for r in results if r["name"] == name
                 and r["dtype"] == "bfloat16" and r["shape"]["L"] == 1)
        entries.append(dict(
            name=name, route="cuda", source=f"src/repro_torch/csrc/{src}",
            replaces=REPLACES[name], launches=launches[name],
            max_abs_err=r["max_abs_err"], ms=r["ms"],
            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, shape=r["shape"]))
    print(json.dumps({"kernels": entries}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

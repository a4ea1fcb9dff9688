#!/usr/bin/env python3
"""Times this checkout's bf16 Hadamard mux, paged decode attention and
flash attention beside an earlier version of the same three kernels, on
one card, in turns (earlier, this, this, earlier), on the same inputs.

    git show <commit>:src/repro_torch/csrc/hadamard_mux.cu > DIR/...
    (likewise paged_decode_attention.cu, flash_attention.cu, hopper.cuh)
    python3 tools/compare_kernels.py DIR

DIR holds the earlier sources; they are built with their own
``hopper.cuh``.  Their C entry points are the ones they had before this
checkout's launch plans for the mux and the paged kernel:

    hadamard_mux_launch(x, v, out, dtype, B, N, L, d, stream)
    paged_decode_attention_launch(q, k_pages, v_pages, pos_pages,
        block_table, q_pos, out, dtype, B, C, H, KVH, hd, ps, max_pages,
        kblock, scale, causal, window, splits, entries, stages, P, stream)
    flash_attention_launch(q, k, v, out, dtype, B, Lq, Lk, H, hd, scale,
        causal, body, q_tile, k_tile, stages, threads, smem, stream)

(the paged kernel's splits and entries as this checkout's plan makes them
for a single row group, its ring 4 K-block stages, as its own plan chose
at these shapes; the flash kernel's plan is this checkout's at hd 64 and
128, which the earlier source was built for).

Shapes: the mux at the decode shape (B 8, N 40, L 1, d 768), the
lock-step prefill's L 104 and the eval shape (B 2, N 8, L 1032, d 2560);
the paged attention at chip_smoke.py's slice (C 1 at kblock 1, 2, 4; C 4),
long-context (64 pages per slot) and all-unmapped-split layouts; flash
attention at the eval slice (B 2, L 1032, H 20, hd 128, causal and not)
and at L 8192.  Each time is chip_smoke.py's ``time_ms``; the two
versions' outputs must agree within the bf16 tolerance (the paged
kernel's on live query rows).
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
SOURCES = ("hadamard_mux.cu", "paged_decode_attention.cu",
           "flash_attention.cu")


def load_earlier(directory: Path, build) -> ctypes.CDLL:
    objs = [directory / (name + ".o") for name in SOURCES]
    procs = [subprocess.Popen([build._nvcc(), *build.NVCC_FLAGS, "-c",
                               str(directory / name), "-o", str(obj)])
             for name, obj in zip(SOURCES, objs)]
    if any(p.wait() for p in procs):
        raise SystemExit("[compare] FAIL: the earlier sources do not build")
    lib = directory / "libearlier.so"
    subprocess.run([build._nvcc(), "-shared", *map(str, objs), "-o",
                    str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    P, I, LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    dll.hadamard_mux_launch.argtypes = [P, P, P, I, LL, I, I, I, P]
    dll.paged_decode_attention_launch.argtypes = [P] * 7 + [I] * 9 + [
        ctypes.c_float, I, I, I, I, I, LL, P]
    dll.flash_attention_launch.argtypes = [P] * 4 + [I] * 6 + [
        ctypes.c_float, I] + [I] * 5 + [LL, P]
    for fn in (dll.hadamard_mux_launch, dll.paged_decode_attention_launch,
               dll.flash_attention_launch):
        fn.restype = I
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("earlier", type=Path, help="directory of the earlier "
                    "hadamard_mux.cu, paged_decode_attention.cu, "
                    "flash_attention.cu and hopper.cuh")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as flash_kernel
    from repro_torch.kernels.multiplex import kernel as mux_kernel
    from repro_torch.kernels.paged_attention import kernel as paged_kernel
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"[compare] {smi}")
    earlier = load_earlier(args.earlier.resolve(), _build)
    stream = _build.stream_of
    gen = torch.Generator(device="cuda").manual_seed(0)
    bf16 = torch.bfloat16

    def mux_earlier(x, v):
        b, n, l, d = x.shape
        out = torch.empty((b, l, d), dtype=x.dtype, device=x.device)
        err = earlier.hadamard_mux_launch(
            x.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b, n, l, d,
            stream(x))
        _build.raise_on_error("earlier hadamard_mux", err)
        return out

    def paged_earlier(q, k, v, pos, bt, q_pos, causal, kb):
        out = torch.empty_like(q)
        b, c, h, hd = q.shape
        pl = paged_kernel.plan(b, c, h, k.shape[2], hd, k.shape[1],
                               bt.shape[1], kb, bf16)
        assert pl.groups == 1
        err = earlier.paged_decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            bt.data_ptr(), q_pos.data_ptr(), out.data_ptr(), 1, b, c, h,
            k.shape[2], hd, k.shape[1], bt.shape[1], kb, hd ** -0.5,
            int(causal), -1, pl.splits, pl.entries, 4, k.shape[0],
            stream(q))
        _build.raise_on_error("earlier paged_decode_attention", err)
        return out

    def flash_earlier(q, k, v, causal):
        b, lq, h, hd = q.shape
        p = flash_kernel.plan(b, lq, k.shape[1], h, hd, bf16)
        out = torch.empty_like(q)
        err = earlier.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
            lq, k.shape[1], h, hd, hd ** -0.5, int(causal),
            flash_kernel.BODIES[p.body], p.q_tile, p.k_tile, p.stages,
            p.threads, p.smem_bytes, stream(q))
        _build.raise_on_error("earlier flash_attention", err)
        return out

    cases = []   # (label, earlier fn, this fn, live rows or None)
    for b, n, l, d in ((8, 40, 1, 768), (8, 40, 104, 768),
                       (2, 8, 1032, 2560)):
        x = torch.randn((b, n, l, d), generator=gen, device="cuda").to(bf16)
        v = torch.randn((n, d), generator=gen, device="cuda").to(bf16)
        pl = mux_kernel.plan(b, n, l, d, bf16)
        cases.append((f"hadamard_mux B{b} N{n} L{l} d{d} (slots {pl.slots}, "
                      f"{pl.blocks} blocks of {pl.threads})",
                      lambda x=x, v=v: mux_earlier(x, v),
                      lambda x=x, v=v: mux_kernel.hadamard_mux(x, v), None))
    g = torch.Generator().manual_seed(0)
    tmux_lengths = torch.randint(120, 138, (8,), generator=g).tolist()
    slice_kw = dict(b=8, h=12, kvh=12, hd=64, ps=16)
    for label, kw, causal, kblocks in (
            ("slice C1", dict(slice_kw, mp=9, c=1, lengths=tmux_lengths),
             False, (1, 2, 4)),
            ("slice C4", dict(slice_kw, mp=9, c=4, lengths=tmux_lengths),
             False, (1,)),
            ("long context", dict(slice_kw, mp=64, c=1,
                                  lengths=[64 * 16 - 3] * 8), False, (1, 2)),
            (smoke.UNMAPPED, dict(slice_kw, mp=16, c=1, hole=8), True,
             (1,))):
        a = smoke.paged_inputs(torch, gen, bf16, **kw)
        live = smoke.paged_mask(*a[3:], causal, None).any(-1)[..., None,
                                                              None]
        for kb in kblocks:
            splits = paged_kernel.plan(8, kw["c"], 12, 12, 64, 16, kw["mp"],
                                       kb, bf16).splits
            cases.append((
                f"paged_decode_attention {label} kblock {kb} "
                f"(splits {splits})",
                lambda a=a, c=causal, kb=kb: paged_earlier(*a, c, kb),
                lambda a=a, c=causal, kb=kb:
                paged_kernel.paged_decode_attention(
                    *a, scale=0.125, causal=c, kblock_pages=kb), live))
    for b, l, causal in ((2, 1032, True), (2, 1032, False), (1, 8192, True)):
        q, k, v = (torch.randn((b, l, 20, 128), generator=gen,
                               device="cuda").to(bf16) for _ in range(3))
        cases.append((f"flash_attention B{b} L{l} H20 hd128 causal {causal}",
                      lambda q=q, k=k, v=v, c=causal:
                      flash_earlier(q, k, v, c),
                      lambda q=q, k=k, v=v, c=causal:
                      flash_kernel.flash_attention(q, k, v, causal=c), None))

    with torch.no_grad():
        for label, old, new, live in cases:
            a, c = old().float(), new().float()
            torch.cuda.synchronize()
            if live is not None:
                a, c = a * live, c * live
            err = (a - c).abs().max().item()
            tol = 2 * smoke.TOL["bfloat16"] * max(1.0, a.abs().max().item())
            del a, c
            times = {"earlier": [], "this": []}
            for who in ("earlier", "this", "this", "earlier"):
                times[who].append(smoke.time_ms(old if who == "earlier"
                                                else new))
            t_old = statistics.median(times["earlier"])
            t_new = statistics.median(times["this"])
            print(f"[compare] {label}: earlier {t_old:.4f} ms "
                  f"{times['earlier']}, this {t_new:.4f} ms "
                  f"{times['this']}, earlier / this {t_old / t_new:.2f}; "
                  f"outputs differ by {err:.3g} (tol {tol:.3g})")
            if not err <= tol:
                raise SystemExit(f"[compare] FAIL: {label}: the two "
                                 f"versions disagree")
    return 0


if __name__ == "__main__":
    sys.exit(main())

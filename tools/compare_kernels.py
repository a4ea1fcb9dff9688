#!/usr/bin/env python3
"""Times this checkout's bf16 decode demux and paged decode attention
beside an earlier version of the same two kernels, on one card, in turns
(earlier, this, this, earlier), on the same inputs.

    git show <commit>:src/repro_torch/csrc/decode_demux.cu > DIR/...
    (likewise demux_tile.cuh and paged_decode_attention.cu)
    python3 tools/compare_kernels.py DIR

DIR holds the earlier sources.  Their C entry points are the ones they had
before the launch plans of these two kernels moved to Python:

    decode_demux_launch(h, p, w1, b1, w2, b2, out, dtype, B, C, N, d, H,
                        stream)
    paged_decode_attention_launch(q, k_pages, v_pages, pos_pages,
                                  block_table, q_pos, out, dtype, B, C, H,
                                  KVH, hd, ps, max_pages, kblock, scale,
                                  causal, window, stream)

Shapes: the decode demux at the serving slices' B 8 N 40 d 768 H 1536
(C 1 and C 4) and a ragged B 3 N 3 C 3 d 96 H 160; the paged attention at
chip_smoke.py's slice (C 1 at kblock 1, 2, 4; C 4), long-context (64 pages
per slot) and all-unmapped-split layouts.  Each time is chip_smoke.py's
``time_ms``; the two versions' outputs must agree within the bf16
tolerance (the paged kernel's on live query rows).
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


def load_earlier(directory: Path, build) -> ctypes.CDLL:
    objs = []
    for name in ("decode_demux.cu", "paged_decode_attention.cu"):
        obj = directory / (name + ".o")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-c",
                        str(directory / name), "-o", str(obj)], check=True)
        objs.append(str(obj))
    lib = directory / "libearlier.so"
    subprocess.run([build._nvcc(), "-shared", *objs, "-o", str(lib)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.decode_demux_launch.argtypes = [P] * 7 + [I] * 6 + [P]
    dll.paged_decode_attention_launch.argtypes = [P] * 7 + [I] * 9 + [
        ctypes.c_float, I, I, P]
    for fn in (dll.decode_demux_launch, dll.paged_decode_attention_launch):
        fn.restype = I
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("earlier", type=Path, help="directory of the earlier "
                    "decode_demux.cu, demux_tile.cuh, "
                    "paged_decode_attention.cu")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.demux import kernel as demux_kernel
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

    def demux_earlier(h, p, w1, b1, w2, b2):
        b, rows, d = h.shape
        n, hidden = p.shape[1], w1.shape[0]
        out = torch.empty((b, n, rows, d), dtype=h.dtype, device=h.device)
        err = earlier.decode_demux_launch(
            h.data_ptr(), p.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), 1, b, rows, n, d,
            hidden, stream(h))
        _build.raise_on_error("earlier decode_demux", err)
        return out

    def paged_earlier(q, k, v, pos, bt, q_pos, causal, kb):
        out = torch.empty_like(q)
        b, c, h, hd = q.shape
        err = earlier.paged_decode_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), pos.data_ptr(),
            bt.data_ptr(), q_pos.data_ptr(), out.data_ptr(), 1, b, c, h,
            k.shape[2], hd, k.shape[1], bt.shape[1], kb, hd ** -0.5,
            int(causal), -1, stream(q))
        _build.raise_on_error("earlier paged_decode_attention", err)
        return out

    cases = []   # (label, earlier fn, this fn, live rows or None)
    for b, n, c, d, hid in ((8, 40, 1, 768, 1536), (8, 40, 4, 768, 1536),
                            (3, 3, 3, 96, 160)):
        ops = [torch.randn(s, generator=gen, device="cuda") * sc for s, sc in
               (((b, c, d), 1.0), ((b, n, d), 1.0),
                ((hid, 2 * d), (2 * d) ** -0.5), ((hid,), 0.1),
                ((d, hid), hid ** -0.5), ((d,), 0.1))]
        ops = [t.to(bf16) for t in ops]
        body = demux_kernel.decode_plan(b, c, n, d, hid, bf16).body
        cases.append((f"decode_demux B{b} N{n} C{c} d{d} H{hid} "
                      f"(body {body})",
                      lambda ops=ops: demux_earlier(*ops),
                      lambda ops=ops: demux_kernel.decode_demux(*ops), None))
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

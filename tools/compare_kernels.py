#!/usr/bin/env python3
"""Times this checkout's bf16 flash attention and index-embed demux beside
an earlier version of the same two kernels, on one card, in turns
(earlier, this, this, earlier), on the same inputs.

    git show <commit>:src/repro_torch/csrc/flash_attention.cu > DIR/...
    (likewise index_embed_demux.cu and demux_tile.cuh)
    python3 tools/compare_kernels.py DIR

DIR holds the earlier sources.  Their C entry points are the ones they had
before the launch plans moved to Python:

    flash_attention_launch(q, k, v, out, dtype, B, Lq, Lk, H, hd, scale,
                           causal, stream)
    index_embed_demux_launch(h, p, w1, b1, w2, b2, out, dtype, B, L, N, d,
                             H, stream)

Shapes: flash attention at the evaluation slice's (B 2, L 1032, H 20, hd
128; causal and not) and at L 8192 (causal); the index-embed demux at
chip_smoke.py's four shapes.  Each time is chip_smoke.py's ``time_ms``;
the two versions' outputs must agree within the bf16 tolerance.
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
    for name in ("flash_attention.cu", "index_embed_demux.cu"):
        obj = directory / (name + ".o")
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-c",
                        str(directory / name), "-o", str(obj)], check=True)
        objs.append(str(obj))
    lib = directory / "libearlier.so"
    subprocess.run([build._nvcc(), "-shared", *objs, "-o", str(lib)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    P, I = ctypes.c_void_p, ctypes.c_int
    dll.flash_attention_launch.argtypes = [P] * 4 + [I] * 6 + [
        ctypes.c_float, I, P]
    dll.index_embed_demux_launch.argtypes = [P] * 7 + [I] * 6 + [P]
    for fn in (dll.flash_attention_launch, dll.index_embed_demux_launch):
        fn.restype = I
    return dll


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("earlier", type=Path, help="directory of the earlier "
                    "flash_attention.cu, index_embed_demux.cu, "
                    "demux_tile.cuh")
    args = ap.parse_args(argv)

    import torch
    if not torch.cuda.is_available():
        print("compare_kernels: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels.attention import kernel as flash_kernel
    from repro_torch.kernels.demux import kernel as demux_kernel
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

    def flash_earlier(q, k, v, causal):
        out = torch.empty_like(q)
        b, lq, h, hd = q.shape
        err = earlier.flash_attention_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), 1, b,
            lq, k.shape[1], h, hd, hd ** -0.5, int(causal), stream(q))
        _build.raise_on_error("earlier flash_attention", err)
        return out

    def demux_earlier(h, p, w1, b1, w2, b2):
        b, rows, d = h.shape
        n, hidden = p.shape[1], w1.shape[0]
        out = torch.empty((b, n, rows, d), dtype=h.dtype, device=h.device)
        err = earlier.index_embed_demux_launch(
            h.data_ptr(), p.data_ptr(), w1.data_ptr(), b1.data_ptr(),
            w2.data_ptr(), b2.data_ptr(), out.data_ptr(), 1, b, rows, n, d,
            hidden, stream(h))
        _build.raise_on_error("earlier index_embed_demux", err)
        return out

    cases = []
    for b, l, causal in ((2, 1032, True), (2, 1032, False), (1, 8192, True)):
        q, k, v = (torch.randn((b, l, 20, 128), generator=gen,
                               device="cuda").to(bf16) for _ in range(3))
        cases.append((f"flash_attention B{b} L{l} H20 hd128 causal={causal}",
                      lambda q=q, k=k, v=v, c=causal: flash_earlier(q, k, v,
                                                                    c),
                      lambda q=q, k=k, v=v, c=causal:
                      flash_kernel.flash_attention(q, k, v, causal=c)))
    for b, n, l, d, hid in ((8, 40, 1, 768, 1536), (8, 40, 104, 768, 1536),
                            (3, 5, 7, 200, 300), (2, 8, 1024, 2560, 5120)):
        ops = [torch.randn(s, generator=gen, device="cuda") * sc for s, sc in
               (((b, l, d), 1.0), ((b, n, d), 1.0),
                ((hid, 2 * d), (2 * d) ** -0.5), ((hid,), 0.1),
                ((d, hid), hid ** -0.5), ((d,), 0.1))]
        ops = [t.to(bf16) for t in ops]
        body = demux_kernel.plan(b, l, n, d, hid, bf16).body
        cases.append((f"index_embed_demux B{b} N{n} L{l} d{d} H{hid} "
                      f"(body {body})",
                      lambda ops=ops: demux_earlier(*ops),
                      lambda ops=ops: demux_kernel.index_embed_demux(*ops)))

    with torch.no_grad():
        for label, old, new in cases:
            a, c = old().float(), new().float()
            torch.cuda.synchronize()
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

"""Serving launcher of the PyTorch port.

Lock-step multiplexed decode (the fixed-(B, N) grid):

    PYTHONPATH=src python -m repro_torch.launch.serve --mux-n 40 --batch 8 \
        --prompt-len 64 --gen 32 --mux-kernel --fuse-demux

Continuous batching over a Poisson trace (``--workload poisson``), on the
paged KV pool with the paged decode-attention kernel and chunked prefill:

    PYTHONPATH=src python -m repro_torch.launch.serve --mux-n 40 --batch 8 \
        --workload poisson --num-requests 160 --rate 8 --prompt-len 16 \
        --gen 16 --paged --use-kernel --mux-kernel --fuse-demux

It takes the flags of ``repro.launch.serve`` (``--paged``, ``--page-size``,
``--pool-pages``, ``--use-kernel``, ``--kblock-pages``, ``--prefill-chunk``,
``--policy``, ``--preempt``, ``--slo-mix``, ``--report``, ``--width-set``,
``--width-policy``, ``--max-preemptions``, ``--trace``, ``--metrics``,
``--baseline``).  The replica router (``--replicas`` > 1) and multi-device
meshes raise ``NotImplementedError`` naming the ROADMAP item that ports
them.  Two flags are the port's own: ``--device`` (the GPU unless ``cpu`` is
asked for) and ``--mux-kernel`` (``MuxConfig.use_kernel``: the fused CUDA
mux and demux).  Weights and prompts are random, drawn from ``--seed``.
"""
import argparse
import dataclasses
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tmux-12l-768h")
    ap.add_argument("--mux-n", type=int, default=8)
    ap.add_argument("--batch", type=int, default=None,
                    help="backbone slots (default 4)")
    ap.add_argument("--prompt-len", type=int, default=None,
                    help="prompt tokens (default 16)")
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device-count", type=int, default=0)
    ap.add_argument("--mesh-shape", default="")
    ap.add_argument("--workload", choices=["none", "poisson"], default="none")
    ap.add_argument("--num-requests", type=int, default=24)
    ap.add_argument("--rate", type=float, default=2.0)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--paged", action="store_true")
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--pool-pages", type=int, default=0)
    ap.add_argument("--prefill-chunk", type=int, default=1)
    ap.add_argument("--use-kernel", action="store_true",
                    help="paged decode attention through its kernel")
    ap.add_argument("--kblock-pages", type=int, default=1)
    ap.add_argument("--fuse-demux", action="store_true",
                    help="fused decode demux epilogue (all N lanes of a "
                         "slot in one kernel block)")
    ap.add_argument("--policy", default="fifo")
    ap.add_argument("--preempt", action="store_true")
    ap.add_argument("--slo-mix", type=float, default=0.0)
    ap.add_argument("--report", action="store_true")
    ap.add_argument("--width-set", default="")
    ap.add_argument("--width-policy", default="static")
    ap.add_argument("--max-preemptions", type=int, default=0)
    ap.add_argument("--replicas", type=int, default=1)
    ap.add_argument("--router-policy", default="round_robin")
    ap.add_argument("--router-sync", action="store_true")
    ap.add_argument("--trace", default="")
    ap.add_argument("--metrics", default="")
    ap.add_argument("--baseline", action="store_true")
    # the port's own
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' runs the "
                         "plain PyTorch path)")
    ap.add_argument("--mux-kernel", action="store_true",
                    help="fused CUDA mux and demux (MuxConfig.use_kernel)")
    return ap


def _unported(args) -> str:
    """The first requested feature the port does not serve yet, or ''."""
    if args.replicas > 1:
        return "--replicas > 1: the replica router is ROADMAP Queue A item 8"
    if args.device_count > 1 or args.multi_pod or "," in args.mesh_shape:
        return ("a multi-device mesh: distribution is ROADMAP Queue A "
                "item 12")
    return ""


def _make_tracer(args):
    """A live ``Tracer`` when a telemetry sink is requested, else None (the
    scheduler then runs with its no-op default)."""
    if not (args.trace or args.metrics):
        return None
    from repro_torch.serving.telemetry import Tracer
    return Tracer()


def _export_telemetry(args, tracer) -> None:
    if tracer is None:
        return
    if args.trace:
        n = tracer.export_chrome(args.trace)
        print(f"[serve] trace: {n} traceEvents -> {args.trace}")
    if args.metrics:
        n = tracer.metrics.write_jsonl(args.metrics)
        print(f"[serve] metrics: {n} per-step snapshots -> {args.metrics}")


def _fmt_ttft(v) -> str:
    """-1 means no request produced a first token: print n/a."""
    return "n/a" if v is None or v < 0 else f"{v:.1f}"


def _report_lines(stats) -> list:
    """``--report`` text: TTFT percentiles and per-SLO-class completion."""
    lines = [f"[serve] ttft: p50 {_fmt_ttft(stats.ttft_p50)} / p99 "
             f"{_fmt_ttft(stats.ttft_p99)} steps from arrival to first token"]
    if not stats.per_class:
        lines.append("[serve]   (no SLO classes configured; per-class "
                     "attainment skipped)")
    for name, c in stats.per_class.items():
        lines.append(
            f"[serve]   {name:>8}: {c['finished']} finished, "
            f"ttft p50 {_fmt_ttft(c['ttft_p50'])} "
            f"p99 {_fmt_ttft(c['ttft_p99'])} "
            f"(deadline {c['ttft_deadline']}, hit "
            f"{100 * c['deadline_hit_rate']:.0f}%), "
            f"{c['preempted']} preemptions")
    return lines


def _run_lockstep(args, cfg, model):
    import torch

    from repro_torch.serving.engine import Engine
    eng = Engine(model, batch=args.batch,
                 max_len=args.prompt_len + args.gen + 1)
    n = max(cfg.mux.n, 1)
    pshape = (args.batch, n, args.prompt_len) if cfg.mux.active \
        else (args.batch, args.prompt_len)
    gen = torch.Generator(device=model.device).manual_seed(args.seed)
    prompts = torch.randint(0, cfg.vocab, pshape, generator=gen,
                            device=model.device)
    t0 = time.perf_counter()
    out = eng.generate(prompts, args.gen)
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    dt = time.perf_counter() - t0
    streams = args.batch * n
    print(f"[serve] {streams} streams x {args.gen} tokens in {dt:.2f}s "
          f"({streams * args.gen / dt:.0f} tok/s)")
    return out


def _run_workload(args, cfg, model):
    """Replay a Poisson trace through the continuous scheduler; returns
    (scheduler, stats)."""
    import numpy as np
    import torch

    from repro_torch.serving.engine import Engine
    from repro_torch.serving.scheduler import (ContinuousScheduler,
                                               poisson_trace,
                                               static_batch_steps)
    n = max(cfg.mux.n, 1)
    max_total = args.prompt_len * 2 + args.gen * 4 + 1
    tracer = _make_tracer(args)
    sched = ContinuousScheduler(
        Engine(model, batch=args.batch, max_len=max_total), tracer=tracer)
    trace = poisson_trace(
        args.num_requests, rate=args.rate, prompt_len=args.prompt_len,
        gen_len=args.gen, vocab=cfg.vocab, max_total=max_total,
        seed=args.seed, slo_mix=args.slo_mix)
    t0 = time.perf_counter()
    stats = sched.run(trace)
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    dt = time.perf_counter() - t0
    sv = cfg.serving
    print(f"[serve] workload={args.workload}: {args.num_requests} requests "
          f"over {args.batch * n} lanes ({args.batch} slots x {n})"
          + (f", paged (page_size={sv.page_size})" if sv.paged else "")
          + (f", kernel (kblock_pages={sv.kblock_pages})"
             if sv.use_kernel else "")
          + (", fuse_demux" if sv.fuse_demux else "")
          + (f", prefill_chunk={sv.prefill_chunk}"
             if sv.prefill_chunk > 1 else "")
          + (f", policy={sv.policy}" if sv.policy != "fifo" else "")
          + (", preempt" if sv.preempt else "")
          + (f", width_set={','.join(map(str, sv.width_set))} "
             f"({sv.width_policy})" if sv.width_set else ""))
    print(f"[serve] continuous: {stats.decode_steps} decode steps, "
          f"{stats.generated_tokens} tokens in {dt:.2f}s "
          f"({stats.generated_tokens / max(dt, 1e-9):.0f} tok/s), "
          f"occupancy {stats.mean_occupancy:.2f}, "
          f"{stats.slot_resets} slot resets")
    if stats.preemptions or stats.resumes:
        print(f"[serve] preempt-and-swap: {stats.preemptions} slots parked, "
              f"{stats.resumes} resumed")
    if stats.per_width:
        print(f"[serve] width classes ({sched.engine.variant_compiles} "
              f"variants):")
        for w, pw in sorted(stats.per_width.items()):
            print(f"[serve]   n={w}: {pw['count']} finished, "
                  f"{pw['tokens']} tokens, ttft mean "
                  f"{_fmt_ttft(pw['ttft_mean'])} "
                  f"p99 {_fmt_ttft(pw['ttft_p99'])}")
    ramp = [q.ramp_latency for q in sched.finished]
    if ramp:
        print(f"[serve] ramp: mean {np.mean(ramp):.2f} steps from admission "
              f"to first token (max {max(ramp)})")
    if args.report:
        for line in _report_lines(stats):
            print(line)
    if sv.paged:
        load = stats.final_load
        print(f"[serve] pool: peak {stats.peak_pages}/{load.usable_pages} "
              f"pages ({sched.allocator.page_bytes()} B/page), "
              f"{load.pages_in_use} in use after drain")
    if args.baseline:
        static = static_batch_steps(trace, args.batch, n)
        print(f"[serve] static baseline: {static} decode steps "
              f"(continuous saves "
              f"{100 * (1 - stats.decode_steps / static):.0f}% on this "
              f"trace)" if static else "[serve] static baseline: n/a")
    _export_telemetry(args, tracer)
    if stats.finished != args.num_requests:
        raise SystemExit(f"[serve] FAIL: only {stats.finished}/"
                         f"{args.num_requests} requests completed")
    return sched, stats


def main(argv=None):
    args = build_parser().parse_args(argv)
    missing = _unported(args)
    if missing:
        raise NotImplementedError(f"the PyTorch port does not serve {missing}")
    workload = args.workload == "poisson"
    if args.batch is None:
        args.batch = 2 if workload else 4
    if args.prompt_len is None:
        args.prompt_len = 4 if workload else 16

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import Backbone

    getter = get_smoke_config if args.smoke else get_config
    cfg = getter(args.arch, mux_n=args.mux_n)
    width_set = tuple(int(w) for w in args.width_set.split(",") if w)
    cfg = dataclasses.replace(
        cfg, mux=dataclasses.replace(cfg.mux, use_kernel=args.mux_kernel),
        serving=ServingConfig(
            paged=args.paged, page_size=args.page_size,
            pool_pages=args.pool_pages, use_kernel=args.use_kernel,
            kblock_pages=args.kblock_pages, fuse_demux=args.fuse_demux,
            prefill_chunk=args.prefill_chunk, policy=args.policy,
            preempt=args.preempt, max_preemptions=args.max_preemptions,
            width_set=width_set, width_policy=args.width_policy,
            replicas=args.replicas, router_policy=args.router_policy,
            router_sync=args.router_sync))
    model = Backbone(cfg, seed=args.seed, device=args.device).eval()
    print(f"[serve] {cfg.name} N={cfg.mux.n} on {model.device}"
          + (" (mux kernel)" if args.mux_kernel else "")
          + (", fuse_demux" if args.fuse_demux else ""))
    if workload:
        return _run_workload(args, cfg, model)
    return _run_lockstep(args, cfg, model)


if __name__ == "__main__":
    main()

"""Serving launcher of the PyTorch port: lock-step multiplexed decode.

    PYTHONPATH=src python -m repro_torch.launch.serve --mux-n 40 --batch 8 \
        --prompt-len 64 --gen 32 --mux-kernel --fuse-demux

It takes the flags of ``repro.launch.serve``.  The port serves the
lock-step grid on one device so far: the continuous scheduler
(``--workload poisson``), the paged cache (``--paged``) and the replica
router (``--replicas`` > 1) raise ``NotImplementedError`` naming the ROADMAP
item that ports them, and the mesh flags accept one device only.  Two flags
are the port's own: ``--device`` (the GPU unless ``cpu`` is asked for) and
``--mux-kernel`` (``MuxConfig.use_kernel``: the fused CUDA mux and demux).
Weights and prompts are random, drawn from ``--seed``.
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
    if args.workload == "poisson":
        return ("--workload poisson: the continuous scheduler is ROADMAP "
                "Queue A item 8")
    if args.paged:
        return "--paged: the paged KV pool is ROADMAP Queue A item 7"
    if args.replicas > 1:
        return "--replicas > 1: the replica router is ROADMAP Queue A item 8"
    if args.device_count > 1 or args.multi_pod or "," in args.mesh_shape:
        return ("a multi-device mesh: distribution is ROADMAP Queue A "
                "item 12")
    return ""


def main(argv=None):
    args = build_parser().parse_args(argv)
    missing = _unported(args)
    if missing:
        raise NotImplementedError(f"the PyTorch port does not serve {missing}")
    args.batch = 4 if args.batch is None else args.batch
    args.prompt_len = 16 if args.prompt_len is None else args.prompt_len

    import torch

    from repro_torch.configs.base import ServingConfig
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.models import Backbone
    from repro_torch.serving.engine import Engine

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


if __name__ == "__main__":
    main()

"""Training launcher of the PyTorch port — ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch tmux-12l-768h \
        --mux-n 40 --steps 50 --batch 8 --seq-len 128 --ckpt state.npz

Trains on the retrieval warm-up task (``RetrievalTask``) when the mux is
active, else the LM task, at lr 3e-3 with ``steps // 10`` warm-up steps,
as the reference does; ``--ckpt`` saves the final train state
(``checkpoint.save_checkpoint``).  Weights come from ``--seed`` and the
retrieval index from a generator seeded with ``--seed + 2``
(``Trainer.fit``).

With ``--mesh-shape``, ``--device-count`` or ``--multi-pod`` it trains on
a device mesh (``Trainer.make_train_step(mesh=)``: the state placed by the
reference's specs, the batch split over the data axis), one rank per
device, rank 0 printing:

    PYTHONPATH=src python -m repro_torch.launch.train --device cpu \
        --arch qwen1.5-4b --smoke --device-count 4 --mesh-shape 2,2 \
        --steps 20 --mux-n 4

On the CPU, ``--device-count`` ``gloo`` ranks are spawned (by default as
many as the mesh needs); on the card, one ``nccl`` rank per GPU; under
``torchrun`` its ranks.  Without ``--mesh-shape`` the mesh is the
production (16, 16), which too few devices refuse.  Two flags are the
port's own: ``--device`` (the GPU unless ``cpu`` is asked for) and
``--seed``.
"""
import argparse
import math


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--arch", default="tmux-12l-768h")
    ap.add_argument("--mux-n", type=int, default=8)
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8, help="backbone batch")
    ap.add_argument("--seq-len", type=int, default=32)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--device-count", type=int, default=0)
    ap.add_argument("--mesh-shape", default="")
    ap.add_argument("--ckpt", default="")
    # the port's own
    ap.add_argument("--device", default=None,
                    help="torch device (default: the GPU; 'cpu' trains on "
                         "the CPU)")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    if args.device_count or args.mesh_shape or args.multi_pod:
        from repro_torch.launch.mesh import mesh_plan, run_ranks
        shape, _ = mesh_plan(args)
        run_ranks(train_on_mesh, args, world=math.prod(shape),
                  device=args.device)
        return None

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.training.trainer import TrainConfig, Trainer

    getter = get_smoke_config if args.smoke else get_config
    cfg = getter(args.arch, mux_n=args.mux_n)
    tcfg = TrainConfig(task="retrieval" if cfg.mux.active else "lm",
                       lr=3e-3, warmup=args.steps // 10,
                       total_steps=args.steps)
    state = Trainer.init_state(cfg, tcfg, seed=args.seed, device=args.device)
    n_params = sum(p.numel() for p in Trainer.params(state).values())
    print(f"[train] {cfg.name} N={cfg.mux.n} params {n_params / 1e6:.1f}M "
          f"on {state['model'].device}")

    task = RetrievalTask(vocab=cfg.vocab, seq_len=args.seq_len)
    every = max(1, args.steps // 10)

    def log(i, m):
        print(f"  step {i:4d}  loss {m['loss']:.4f}  "
              f"gnorm {m['grad_norm']:.2f}")

    state, history = Trainer.fit(
        cfg, tcfg, mux_batches(task, args.batch, max(cfg.mux.n, 1),
                               args.steps),
        seed=args.seed, state=state, log_every=every, callback=log)
    print(f"[train] done; final loss {history[-1]['loss']:.4f}")
    if args.ckpt:
        save_checkpoint(args.ckpt, state, step=args.steps)
        print(f"[train] saved {args.ckpt}")
    return state, history


def train_on_mesh(args, device: str) -> None:
    """One rank of a mesh run (``launch.mesh.run_ranks``)."""
    import torch
    import torch.distributed as dist

    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.configs.registry import get_config, get_smoke_config
    from repro_torch.data import RetrievalTask, mux_batches
    from repro_torch.launch.mesh import make_mesh, mesh_plan
    from repro_torch.sharding import mesh_info_from_mesh, state_specs
    from repro_torch.sharding.placement import gather_state, state_bytes
    from repro_torch.training.trainer import TrainConfig, Trainer

    shape, axes = mesh_plan(args)
    mesh = make_mesh(shape, device, axes)
    mi = mesh_info_from_mesh(mesh)
    print(f"[train] mesh {dict(zip(mesh.mesh_dim_names, mesh.shape))}")
    getter = get_smoke_config if args.smoke else get_config
    cfg = getter(args.arch, mux_n=args.mux_n)
    tcfg = TrainConfig(task="retrieval" if cfg.mux.active else "lm",
                       lr=3e-3, warmup=args.steps // 10,
                       total_steps=args.steps)
    state = Trainer.init_state(cfg, tcfg, seed=args.seed, device=device)
    n_params = sum(p.numel() for p in Trainer.params(state).values())
    print(f"[train] {cfg.name} N={cfg.mux.n} params {n_params / 1e6:.1f}M "
          f"on {mesh.size()} x {device.split(':')[0]}")
    step = Trainer.make_train_step(cfg, tcfg, mesh=mesh, mesh_info=mi)
    rng = torch.Generator(device=device).manual_seed(args.seed + 2)
    task = RetrievalTask(vocab=cfg.vocab, seq_len=args.seq_len)
    every = max(1, args.steps // 10)
    for i, batch in enumerate(mux_batches(task, args.batch,
                                          max(cfg.mux.n, 1), args.steps)):
        state, m = step(state, batch, rng)
        if i % every == 0 or i == args.steps - 1:
            print(f"  step {i:4d}  loss {float(m['loss']):.4f}  "
                  f"gnorm {float(m['grad_norm']):.2f}")
    print(f"[train] done; final loss {float(m['loss']):.4f}")
    held, want = state_bytes(state, state_specs(state, mi), mi)
    print(f"[train] rank 0 holds {held} B of parameters and moments; its "
          f"specs give {want} B")
    if args.ckpt:
        whole = gather_state(state)
        if dist.get_rank() == 0:
            save_checkpoint(args.ckpt, whole, step=args.steps)
            print(f"[train] saved {args.ckpt}")


if __name__ == "__main__":
    main()

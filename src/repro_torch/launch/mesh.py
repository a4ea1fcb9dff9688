"""Device meshes and the process groups under them — the port of
``repro.launch.mesh``, over ``torch.distributed``.

Functions, not module constants, so importing this module touches no
process group.  A mesh needs a process group whose world is the mesh's
size: the launchers start one rank per device (``run_ranks``), each with
its own group, before building the mesh.  Every group is started with a
``timeout`` (``TIMEOUT``), so a rank that hangs fails its peers instead of
holding them forever.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import tempfile

import torch
import torch.distributed as dist

from repro_torch.device import resolve_device

TIMEOUT = datetime.timedelta(seconds=120)
AXES = ("data", "model")
POD_AXES = ("pod", "data", "model")


def production_shape(multi_pod: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of the production mesh: (data 16, model 16), and
    a leading pod axis of 2 with ``multi_pod``."""
    if multi_pod:
        return (2, 16, 16), POD_AXES
    return (16, 16), AXES


def check_world(shape: tuple, world: int) -> None:
    """Raise unless ``world`` devices are enough for a ``shape`` mesh."""
    need = math.prod(shape)
    if world < need:
        raise RuntimeError(f"mesh {shape} needs {need} devices, have "
                           f"{world}")


def make_mesh(shape: tuple, device=None, axes: tuple = AXES):
    """A mesh of ``shape`` over the started process group's ranks, its axes
    the first ``len(shape)`` of ``axes``: one rank per device."""
    from torch.distributed.device_mesh import init_device_mesh
    device = resolve_device(device)
    return init_device_mesh(device.type, tuple(shape),
                            mesh_dim_names=tuple(axes[:len(shape)]))


def make_production_mesh(*, multi_pod: bool = False, device=None):
    """(data 16, model 16), or (pod 2, data 16, model 16) with
    ``multi_pod``, over the process group's first 256 (512) ranks."""
    shape, axes = production_shape(multi_pod)
    check_world(shape, dist.get_world_size() if dist.is_initialized()
                else 1)
    return make_mesh(shape, device, axes)


def make_test_mesh(device=None):
    """A one-device mesh with the production axis names.  Without a
    process group it first starts one of world 1 (``gloo`` on the CPU,
    ``nccl`` on the card) over an in-memory store."""
    device = resolve_device(device)
    if not dist.is_initialized():
        start_group(0, 1, device, store=dist.HashStore())
    return make_mesh((1, 1), device)


def start_group(rank: int, world: int, device, *, init_method=None,
                store=None) -> None:
    """Start this process's group: ``nccl`` on the card (``device`` made
    the current one first), ``gloo`` on the CPU, with ``TIMEOUT``."""
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(torch.cuda.current_device()
                              if device.index is None else device.index)
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=init_method, store=store, rank=rank,
                            world_size=world, timeout=TIMEOUT)


def _run(fn, args, rank: int, world: int, device: str, **group) -> None:
    """Start this rank's group, run ``fn(args, device)`` (stdout only on rank
    0) and end the group."""
    with contextlib.ExitStack() as stack:
        if rank:
            sink = stack.enter_context(open(os.devnull, "w"))
            stack.enter_context(contextlib.redirect_stdout(sink))
        start_group(rank, world, device, **group)
        try:
            fn(args, device)
        finally:
            dist.destroy_process_group()


def _rank_main(rank: int, world: int, init_method: str, device: str, fn,
               args) -> None:
    """One spawned rank: its card (``cuda:rank``), or one torch thread on
    the CPU."""
    if device == "cuda":
        device = f"cuda:{rank}"
    else:
        torch.set_num_threads(1)
    _run(fn, args, rank, world, device, init_method=init_method)


def run_ranks(fn, args, *, world: int, device) -> None:
    """Run ``fn(args, device)`` on ``world`` ranks, each with a process group
    of that world: under ``torchrun`` (its environment gives the rank) this
    process is one of them; world 1 runs here; otherwise ``world`` spawned
    processes meet over a ``file://`` store in a temporary directory.
    ``fn`` must be importable by name (the ranks are spawned)."""
    device = resolve_device(device).type
    if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
        rank = int(os.environ["RANK"])
        dev = device
        if device == "cuda":
            dev = f"cuda:{int(os.environ.get('LOCAL_RANK', rank))}"
        _run(fn, args, rank, int(os.environ["WORLD_SIZE"]), dev,
             init_method="env://")
    elif world == 1:
        _run(fn, args, 0, 1, "cuda:0" if device == "cuda" else device,
             store=dist.HashStore())
    else:
        import torch.multiprocessing as mp
        with tempfile.TemporaryDirectory() as tmp:
            mp.spawn(_rank_main, nprocs=world, args=(
                world, f"file://{os.path.join(tmp, 'store')}", device, fn,
                args))


def mesh_plan(args) -> tuple[tuple, tuple]:
    """(shape, axis names) of a launcher's mesh from its ``--mesh-shape``,
    ``--multi-pod``, ``--device-count`` and ``--device``: the given shape
    (axes data, model), else the production mesh.  Raises, as the
    reference does, when the devices are too few: ``--device-count`` of
    them (on the CPU, by default as many as the mesh needs; on the card at
    most the cards present), or ``torchrun``'s world."""
    if args.mesh_shape:
        shape = tuple(int(x) for x in args.mesh_shape.split(","))
        axes = AXES
    else:
        shape, axes = production_shape(args.multi_pod)
    if "WORLD_SIZE" in os.environ:
        have = int(os.environ["WORLD_SIZE"])
    elif resolve_device(args.device).type == "cpu":
        have = args.device_count or math.prod(shape)
    else:
        cards = torch.cuda.device_count()
        have = min(args.device_count or cards, cards)
    check_world(shape, have)
    return shape, axes

"""Process bootstrap: joining a process group, or starting one.

Port of ``tsdf_tpu/parallel/distributed.py``. A run on several cards is one
process per rank: ``initialize`` joins the group that ``torchrun`` (or
another launcher) describes in the environment, and ``launch`` starts the
ranks of one host itself, each in a spawned process that joins a group
through a ``FileStore`` in a temporary directory. Recovery is
checkpoint-restart, as in the JAX package: a failed rank fails the run.
Every group is made with a finite timeout (``mesh.GROUP_TIMEOUT``), so a
rank that waits on a collective no other rank joins raises instead of
hanging.
"""

from __future__ import annotations

import os
import queue
import tempfile
import time
import traceback
from typing import Optional

import torch
import torch.distributed as dist

from .mesh import GROUP_TIMEOUT, make_mesh

# a launch whose ranks have not all returned after this long is killed
JOIN_TIMEOUT_S = 600.0


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    backend: Optional[str] = None,
) -> None:
    """Join the process group; a no-op in a single-process run or when a
    group exists.

    Arguments default from ``torchrun``'s environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (the coordinator, ``host:port`` or an init-method URL),
    ``WORLD_SIZE`` and ``RANK``. The backend defaults to NCCL, under which
    the rank takes the card ``LOCAL_RANK`` (or its rank) first; with no
    card visible that raises, and a group on the CPU needs
    ``backend="gloo"``.
    """
    if dist.is_initialized():
        return
    if num_processes is None:
        num_processes = int(os.environ.get("WORLD_SIZE", "1"))
    if num_processes <= 1 and coordinator_address is None:
        return
    if process_id is None:
        process_id = int(os.environ.get("RANK", "0"))
    if coordinator_address is None:
        coordinator_address = "env://"
    elif "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    backend = backend or "nccl"
    if backend == "nccl":
        _need_card("initialize(backend='nccl')", "backend='gloo'")
        local = int(os.environ.get("LOCAL_RANK", process_id))
        torch.cuda.set_device(local % torch.cuda.device_count())
    dist.init_process_group(
        backend, init_method=coordinator_address, world_size=num_processes,
        rank=process_id, timeout=GROUP_TIMEOUT)


def global_mesh(n_rays: int = 1):
    """A ("b", "r") mesh over every rank of the process group."""
    return make_mesh(n_rays=n_rays)


def is_coordinator() -> bool:
    """True on rank 0, and in a run without a process group."""
    return not dist.is_initialized() or dist.get_rank() == 0


def _need_card(what: str, instead: str) -> None:
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"{what} needs a CUDA card and none is visible; pass {instead} "
            "to run on the CPU")


def _rank_device(device: str, rank: int) -> torch.device:
    """The device of ``rank`` for ``launch``'s ``device``: "cpu", "cuda"
    (rank r on card r) or one named card, such as "cuda:0", for every
    rank."""
    d = torch.device(device)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", rank)
    return d


def _rank_main(fn, rank, world, store_path, backend, device, args, results):
    try:
        dev = _rank_device(device, rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        if store_path is None:
            store = dist.HashStore()
        else:
            store = dist.FileStore(store_path, world)
        dist.init_process_group(backend, store=store, rank=rank,
                                world_size=world, timeout=GROUP_TIMEOUT)
        try:
            out = fn(dev, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # reported to the launcher, which fails the run
        results.put((rank, False, traceback.format_exc()))


def launch(fn, world_size: int, args=(), *, backend: Optional[str] = None,
           device: str = "cuda") -> list:
    """Run ``fn(device, *args)`` on ``world_size`` ranks of a new process
    group and return the ranks' results, in rank order.

    One rank runs in this process; more are spawned processes (``fn`` and
    ``args`` must pickle, and ``fn`` must be importable by name) that join
    through a ``FileStore`` in a temporary directory. ``backend`` defaults
    to NCCL on CUDA devices and gloo on the CPU; ``device`` as in
    :func:`_rank_device`, the cards by default: with no card visible that
    raises, and ranks on the CPU need ``device="cpu"``. A rank that raises,
    or a run that takes more than ``JOIN_TIMEOUT_S``, kills every rank and
    raises RuntimeError with the rank's traceback; ``GROUP_TIMEOUT`` turns
    a collective that some rank never joins into such a failure.
    """
    if torch.device(device).type == "cuda":
        _need_card(f"launch(device={device!r})", "device='cpu'")
    backend = backend or (
        "nccl" if torch.device(device).type == "cuda" else "gloo")
    if world_size == 1:
        results = queue.SimpleQueue()
        _rank_main(fn, 0, 1, None, backend, device, args, results)
        _, ok, out = results.get()
        if not ok:
            raise RuntimeError(f"rank 0 failed:\n{out}")
        return [out]
    ctx = torch.multiprocessing.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="tsdf_group_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [
            ctx.Process(target=_rank_main, daemon=True, args=(
                fn, rank, world_size, store, backend, device, args, results))
            for rank in range(world_size)
        ]
        for p in procs:
            p.start()
        got: dict = {}
        failure = None
        deadline = time.monotonic() + JOIN_TIMEOUT_S
        try:
            while len(got) < world_size and failure is None:
                try:
                    rank, ok, out = results.get(timeout=0.2)
                except queue.Empty:
                    dead = [i for i, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and i not in got]
                    if dead:
                        failure = (f"rank {dead[0]} exited with code "
                                   f"{procs[dead[0]].exitcode}")
                    elif time.monotonic() > deadline:
                        failure = (f"the ranks did not finish within "
                                   f"{JOIN_TIMEOUT_S:.0f} s")
                    continue
                if ok:
                    got[rank] = out
                else:
                    failure = f"rank {rank} failed:\n{out}"
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic())
                       if failure is None else 0.1)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    if failure is not None:
        raise RuntimeError(failure)
    return [got[r] for r in range(world_size)]

"""Start a group of ranks for the decomposed model and give each its device.

``spawn(fn, ny, nx, backend, device)`` runs ``fn(rank, *args)`` in
ny·nx fresh processes, each a member of one ``torch.distributed`` group,
and returns their results in rank order. ``rank`` is a ``Rank``: the
place on the grid, the device, and ``rank.mesh(iy, jx)`` for the
``DomainMesh`` of a domain. A process started by ``torchrun`` (or any
launcher that sets RANK, WORLD_SIZE, MASTER_ADDR and MASTER_PORT) joins
its group with ``init_from_env(ny, nx, backend)`` instead.

The backend is always the caller's choice: ``"nccl"`` moves CUDA
tensors between cards and refuses two ranks on one card, so it needs a
card for each rank; ``"gloo"`` runs anywhere, and moves the halo bands
of CUDA tensors through host memory. The device is
``cuda:{rank % device_count}`` unless the caller asks for ``"cpu"``.

The ranks meet through a ``FileStore`` in a temporary directory, so
that concurrent groups (test workers) never contend for a port. A rank
that raises fails the whole group: the parent stops the others and
raises with that rank's traceback; so it does when the group outlasts
``timeout`` seconds.
"""
from __future__ import annotations

import multiprocessing as mp
import multiprocessing.connection
import os
import pickle
import shutil
import tempfile
import time
import traceback
from typing import Any, Callable, List, NamedTuple, Sequence

import torch
import torch.distributed as dist

from .mesh import DomainMesh


class Rank(NamedTuple):
    rank: int
    world: int
    ny: int
    nx: int
    backend: str
    device: torch.device

    def mesh(self, iy: int, jx: int) -> DomainMesh:
        return DomainMesh(self.ny, self.nx, iy, jx)


def rank_device(rank: int, backend: str, world: int, device="cuda"):
    """The device of ``rank``: ``cuda:{rank % device_count}`` or the CPU."""
    if backend not in ("gloo", "nccl"):
        raise ValueError(f"backend {backend!r}: name 'gloo' or 'nccl'")
    if str(device) == "cpu":
        if backend == "nccl":
            raise ValueError("nccl moves CUDA tensors only: use gloo on "
                             "the CPU")
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA card here: pass device=\"cpu\"")
    count = torch.cuda.device_count()
    if backend == "nccl" and world > count:
        raise ValueError(f"nccl needs a card for each rank: {world} ranks, "
                         f"{count} card(s) (NCCL refuses two ranks on one "
                         "card); use gloo")
    return torch.device("cuda", rank % count)


def _join(rank, world, ny, nx, backend, device, **init):
    if ny * nx != world:
        raise ValueError(f"a {ny}x{nx} grid needs {ny * nx} ranks, got "
                         f"{world}")
    dev = rank_device(rank, backend, world, device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend, rank=rank, world_size=world,
                            **({"device_id": dev} if backend == "nccl"
                               else {}), **init)
    return Rank(rank, world, ny, nx, backend, dev)


def init_from_env(ny: int, nx: int, backend: str, device="cuda") -> Rank:
    """Join the group that a launcher such as torchrun describes in the
    environment (RANK, WORLD_SIZE, MASTER_ADDR, MASTER_PORT)."""
    return _join(int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"]),
                 ny, nx, backend, device, init_method="env://")


def _child(fn, args, rank, world, ny, nx, backend, device, rundir):
    # one thread a rank: the ranks of a group share the host's cores
    torch.set_num_threads(1)
    try:
        store = dist.FileStore(os.path.join(rundir, "store"), world)
        ctx = _join(rank, world, ny, nx, backend, device, store=store)
        out = fn(ctx, *args)
        dist.barrier()
    except BaseException:
        # written before this process leaves the group, so before the
        # ranks that fail only because it left
        with open(os.path.join(rundir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise
    dist.destroy_process_group()
    with open(os.path.join(rundir, f"rank{rank}.out"), "wb") as fh:
        pickle.dump(out, fh)


def spawn(fn: Callable[..., Any], ny: int, nx: int, backend: str,
          device="cuda", args: Sequence = (),
          timeout: float = 600.0) -> List[Any]:
    """Run ``fn(rank, *args)`` on a ny x nx grid of ranks, one process
    each (started with the ``spawn`` method: ``fn`` and ``args`` must
    pickle, and ``fn`` must be importable from its module); return the
    ranks' results, which must pickle, in rank order."""
    world = ny * nx
    rank_device(0, backend, world, device)          # refuse early
    rundir = tempfile.mkdtemp(prefix="regcm_ranks_")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_child,
                         args=(fn, tuple(args), r, world, ny, nx, backend,
                               str(device), rundir),
                         name=f"rank{r}")
             for r in range(world)]
    try:
        for p in procs:
            p.start()
        t_end = time.monotonic() + timeout
        while True:
            if any(p.exitcode not in (None, 0) for p in procs):
                raise RuntimeError(_failure(rundir, procs))
            if all(p.exitcode == 0 for p in procs):
                break
            if time.monotonic() > t_end:
                raise TimeoutError(f"the {ny}x{nx} group did not finish "
                                   f"within {timeout:.0f} s")
            mp.connection.wait([p.sentinel for p in procs
                                if p.exitcode is None], timeout=0.5)
        out = []
        for r in range(world):
            with open(os.path.join(rundir, f"rank{r}.out"), "rb") as fh:
                out.append(pickle.load(fh))
        return out
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(rundir, ignore_errors=True)


def _failure(rundir, procs):
    """The traceback of the rank that failed first (the others may have
    failed only because it left the group)."""
    codes = {r: p.exitcode for r, p in enumerate(procs)}
    errs = sorted((os.path.getmtime(os.path.join(rundir, f)), f)
                  for f in os.listdir(rundir) if f.endswith(".err"))
    if not errs:
        return f"a rank died without a traceback; exit codes {codes}"
    with open(os.path.join(rundir, errs[0][1])) as fh:
        tb = fh.read()
    return (f"{errs[0][1][:-4]} failed first (exit codes {codes}):\n{tb}")

"""The 2-D (y, x) domain decomposition over a group of ranks.

The reference's only parallelism is a 2-D cartesian MPI decomposition
with halo exchanges (``set_nproc``, ``Main/mpplib/mod_mppparam.F90:1053``;
``exchange``, ``:209-261``). The JAX package maps it onto a device mesh
and lets GSPMD insert the halo collectives; PyTorch has no partitioner,
so here every rank holds one (ly, lx) block of each (..., iy, jx) field
and the stencils read across block edges through ``parallel.halo``.
Ranks are numbered row-major over the grid: rank = py·nx + px.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist


def factor2d(n: int, aspect: float = 1.0) -> Tuple[int, int]:
    """Factor n ranks into (ny, nx) honouring a domain aspect ratio,
    like set_nproc's cpus_per_dim factorisation
    (Main/mpplib/mod_mppparam.F90:1053-1200)."""
    best = (1, n)
    best_score = float("inf")
    for ny in range(1, n + 1):
        if n % ny:
            continue
        nx = n // ny
        score = abs(math.log((nx / ny) / aspect))
        if score < best_score:
            best_score = score
            best = (ny, nx)
    return best


class DomainMesh:
    """A (ny, nx) grid of ranks over an (iy, jx) domain.

    ``rank`` is the caller's place on the grid; by default its rank in
    ``group`` (``torch.distributed`` must be initialised). A mesh given
    a ``rank`` and no initialised group is detached: it describes that
    rank's block (``local``, offsets) but cannot exchange or gather.

    The blocks are equal, ly = iy/ny by lx = jx/nx, and at least 4 by
    4: the WAF kernel's domain-edge overrides reach 2 rows inward and
    must stay within the rank that owns the edge
    (``regcm_tpu/dynamics/pallas_kernels.py:369-373``)."""

    def __init__(self, ny: int, nx: int, iy: int, jx: int, group=None,
                 rank: Optional[int] = None):
        if iy % ny or jx % nx:
            raise ValueError(f"the {iy}x{jx} domain does not divide evenly "
                             f"over a {ny}x{nx} grid of ranks")
        ly, lx = iy // ny, jx // nx
        if ly < 4 or lx < 4:
            raise ValueError(f"blocks of {ly}x{lx} points: the "
                             "decomposition needs at least 4x4 per rank")
        self.ny, self.nx, self.iy, self.jx = ny, nx, iy, jx
        self.ly, self.lx = ly, lx
        self.group = group
        self.attached = rank is None
        if self.attached:
            if not dist.is_initialized():
                raise RuntimeError("DomainMesh: torch.distributed is not "
                                   "initialised (or pass rank= for a "
                                   "detached mesh)")
            if dist.get_world_size(group) != ny * nx:
                raise ValueError(f"a {ny}x{nx} grid needs {ny * nx} ranks, "
                                 f"the group has "
                                 f"{dist.get_world_size(group)}")
            rank = dist.get_rank(group)
            self.backend = dist.get_backend(group)
        else:
            self.backend = None
        if not 0 <= rank < ny * nx:
            raise ValueError(f"rank {rank} is not on a {ny}x{nx} grid")
        self.rank = rank
        self.py, self.px = divmod(rank, nx)
        self.y0, self.x0 = self.py * ly, self.px * lx

    def __repr__(self):
        return (f"DomainMesh({self.ny}x{self.nx} over {self.iy}x{self.jx}, "
                f"rank {self.rank} at ({self.py}, {self.px}), block "
                f"[{self.y0}:{self.y0 + self.ly}, "
                f"{self.x0}:{self.x0 + self.lx}], "
                f"backend {self.backend})")

    def peer(self, py: int, px: int) -> int:
        """Global rank of the grid point (py, px), for point-to-point
        operations."""
        r = py * self.nx + px
        return r if self.group is None else dist.get_global_rank(self.group,
                                                                 r)

    def staged(self, t: torch.Tensor) -> bool:
        """Whether ``t`` must go through a host copy to be sent: gloo
        moves CPU tensors only."""
        return self.backend == "gloo" and t.device.type != "cpu"

    def _need_group(self, what):
        if not self.attached:
            raise RuntimeError(f"DomainMesh.{what}: this mesh is detached "
                               "(built with rank=) and has no group")

    def local(self, a):
        """This rank's block of a global (..., iy, jx) array or tensor
        (a contiguous copy for a tensor)."""
        if tuple(a.shape[-2:]) != (self.iy, self.jx):
            raise ValueError(f"expected a (..., {self.iy}, {self.jx}) "
                             f"array, got {tuple(a.shape)}")
        b = a[..., self.y0:self.y0 + self.ly, self.x0:self.x0 + self.lx]
        return b.contiguous() if isinstance(b, torch.Tensor) \
            else np.ascontiguousarray(b)

    def gather(self, t: torch.Tensor, dst: Optional[int] = None):
        """The global (..., iy, jx) tensor from every rank's block: on
        every rank, or on rank ``dst`` alone (None elsewhere)."""
        self._need_group("gather")
        src = t.contiguous()
        if self.staged(src):
            src = src.cpu()
        parts = [torch.empty_like(src) for _ in range(self.ny * self.nx)]
        if dst is None:
            dist.all_gather(parts, src, group=self.group)
        else:
            dist.gather(src, parts if self.rank == dst else None,
                        dst=self.peer(*divmod(dst, self.nx)),
                        group=self.group)
            if self.rank != dst:
                return None
        rows = [torch.cat(parts[py * self.nx:(py + 1) * self.nx], dim=-1)
                for py in range(self.ny)]
        return torch.cat(rows, dim=-2).to(t.device)

    def all_reduce(self, t: torch.Tensor, op=dist.ReduceOp.MAX):
        """``t`` reduced over every rank (a new tensor on t's device)."""
        self._need_group("all_reduce")
        buf = t.detach().clone()
        if self.staged(buf):
            buf = buf.cpu()
        dist.all_reduce(buf, op=op, group=self.group)
        return buf.to(t.device)

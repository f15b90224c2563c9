"""Stencil helpers for (..., y, x) tensors (torch twin of
``regcm_tpu/dynamics/stencil.py``).

``shift`` reads the neighbour at (y+dy, x+dx) with a constant fill
outside the domain; ``shifte`` replicates the edge instead. Periodic
directions (tropical band: x; CRM: x and y) wrap with ``torch.roll``.

Under a ``DomainMesh`` (``topology(mesh=...)``) each tensor is one
rank's block of the domain: a shift first extends the block by |dy|
rows and |dx| columns on the side it reads from (``parallel.halo``,
y before x so that a diagonal shift gets its corner), then slices, so
that every rank computes its block of the undecomposed result.
"""
from __future__ import annotations

import contextlib
import functools

import torch

from ..parallel.halo import halo_expand, halo_expand2d

# Topology flags: the reference's set_nproc builds an x-periodic (band,
# i_band=1) or doubly periodic (CRM, i_crm=1) topology
# (Main/mpplib/mod_mppparam.F90:1131 dim_period).
_PX = False
_PY = False
_MESH = None          # the DomainMesh of a decomposed run, or None


@contextlib.contextmanager
def topology(periodic_x: bool = False, periodic_y: bool = False,
             mesh=None):
    """Set the stencil topology for code run within this context."""
    global _PX, _PY, _MESH
    if mesh is not None and (periodic_x or periodic_y):
        raise NotImplementedError("periodic topologies are not decomposed")
    old = (_PX, _PY, _MESH)
    _PX, _PY, _MESH = bool(periodic_x), bool(periodic_y), mesh
    try:
        yield
    finally:
        _PX, _PY, _MESH = old


def with_topology(fn):
    """Method decorator: run the body under the core's grid topology
    (core.periodic_x/periodic_y/mesh attributes)."""
    @functools.wraps(fn)
    def wrapped(self, *a, **k):
        with topology(getattr(self, "periodic_x", False),
                      getattr(self, "periodic_y", False),
                      getattr(self, "mesh", None)):
            return fn(self, *a, **k)
    return wrapped


def periodic_x() -> bool:
    return _PX


def periodic_y() -> bool:
    return _PY


def mesh():
    """The DomainMesh of the current topology, or None."""
    return _MESH


def _wrap(a, dy, dx):
    """Roll the periodic axes; return the remaining (dy, dx)."""
    if _PX and dx != 0:
        a = torch.roll(a, -dx, dims=-1)
        dx = 0
    if _PY and dy != 0:
        a = torch.roll(a, -dy, dims=-2)
        dy = 0
    return a, dy, dx


def _span(n, d):
    """(destination, source) slices of out[i] = a[i+d] inside [0, n)."""
    return slice(max(-d, 0), n - max(d, 0)), slice(max(d, 0), n - max(-d, 0))


def _decomposed(a, dy, dx, mode):
    """shift/shifte of a rank's block: extend it from the neighbours on
    the side each offset reads from, then slice."""
    ly, lx = a.shape[-2], a.shape[-1]
    if dy:
        a = halo_expand(a, _MESH, -2, max(-dy, 0), max(dy, 0), mode)
    if dx:
        a = halo_expand(a, _MESH, -1, max(-dx, 0), max(dx, 0), mode)
    y, x = max(dy, 0), max(dx, 0)
    return a[..., y:y + ly, x:x + lx]


def shift(a, dy: int, dx: int, fill=0.0):
    """out[..., y, x] = a[..., y+dy, x+dx]; out-of-range → fill (wraps on
    a periodic axis)."""
    if dy == 0 and dx == 0:
        return a
    if _MESH is not None:
        if fill != 0.0:
            raise NotImplementedError("a decomposed shift fills with zeros")
        return _decomposed(a, dy, dx, "zero")
    a, dy, dx = _wrap(a, dy, dx)
    if dy == 0 and dx == 0:
        return a
    ny, nx = a.shape[-2], a.shape[-1]
    (ydst, ysrc), (xdst, xsrc) = _span(ny, dy), _span(nx, dx)
    out = torch.full_like(a, fill)
    out[..., ydst, xdst] = a[..., ysrc, xsrc]
    return out


def shifte(a, dy: int, dx: int):
    """Shift with edge replication (periodic axes wrap instead)."""
    if dy == 0 and dx == 0:
        return a
    if _MESH is not None:
        return _decomposed(a, dy, dx, "edge")
    a, dy, dx = _wrap(a, dy, dx)
    ny, nx = a.shape[-2], a.shape[-1]
    if dy != 0:
        iy = torch.clamp(torch.arange(ny, device=a.device) + dy, 0, ny - 1)
        a = a.index_select(-2, iy)
    if dx != 0:
        ix = torch.clamp(torch.arange(nx, device=a.device) + dx, 0, nx - 1)
        a = a.index_select(-1, ix)
    return a


def halo_pad(a, h: int, wrap: bool = True):
    """``a`` (..., ly, lx) extended by h on each side: the edge values
    replicated at a domain edge, wrapped around a periodic axis (with
    ``wrap``), the neighbouring ranks' values under a mesh."""
    if _MESH is not None:
        return halo_expand2d(a, _MESH, h, "edge")
    ny, nx = a.shape[-2], a.shape[-1]

    def index(n, periodic):
        i = torch.arange(-h, n + h, device=a.device)
        return i % n if periodic and wrap else torch.clamp(i, 0, n - 1)
    return a.index_select(-2, index(ny, _PY)).index_select(-1, index(nx, _PX))


def kshift(a, dk: int, fill=0.0):
    """Shift along the level axis (axis -3): out[k] = a[k+dk]."""
    if dk == 0:
        return a
    dst, src = _span(a.shape[-3], dk)
    out = torch.full_like(a, fill)
    out[..., dst, :, :] = a[..., src, :, :]
    return out


def cross2dot(pc):
    """4-point average of a cross field to dot points with the
    reference's edge handling (psc2psd, mod_mppparam.F90:13811-13862):
    interior 4-pt, edges 2-pt, corners 1-pt."""
    return 0.25 * (pc + shifte(pc, -1, 0) + shifte(pc, 0, -1)
                   + shifte(pc, -1, -1))


def dot2cross(pd):
    """4-point average of a dot field to cross points (mkslice,
    Main/mod_slice.F90:186-193)."""
    return 0.25 * (pd + shift(pd, 0, 1) + shift(pd, 1, 0) + shift(pd, 1, 1))

"""Halo exchange between the ranks of a ``DomainMesh``.

Counterpart of ``regcm_tpu/parallel/halo.py``, which moves width-h
bands with ``lax.ppermute`` inside ``shard_map``; here they move with
``torch.distributed.batch_isend_irecv``, as the reference's nonblocking
``exchange_lrbt`` does (``Main/mpplib/mod_mppparam.F90:209-261``).

``halo_expand`` extends a rank's block along one of its two trailing
axes by ``before`` rows from the previous rank and ``after`` rows from
the next. At a non-periodic domain edge the halo is zeros (``mode
"zero"``, the fill of ``stencil.shift``) or the edge row repeated
(``"edge"``, that of ``stencil.shifte``). ``halo_expand2d`` extends y,
then x: the x exchange sends the already extended rows, which fills the
corners.

Under ``gloo`` the bands of a CUDA tensor are copied to host tensors,
sent, received and copied back, since gloo's point-to-point operations
take CPU tensors only; under ``nccl`` they move as CUDA tensors. The
mesh's backend picks the path.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

# exchanges (halo_expand calls that sent or received a band) and bytes
# this rank sent, since the last reset
exchanges = 0
bytes_sent = 0


def _edge(a, axis, at, width, mode):
    """The halo beyond the domain edge: zeros or the edge row repeated."""
    row = a.narrow(axis, at, 1)
    if mode == "edge":
        return row.expand(*[width if d == axis else -1
                            for d in range(a.dim())])
    if mode == "zero":
        return torch.zeros_like(row).expand(
            *[width if d == axis else -1 for d in range(a.dim())])
    raise ValueError(f"halo mode {mode!r}: 'zero' or 'edge'")


def halo_expand(a: torch.Tensor, mesh, axis: int, before: int, after: int,
                mode: str = "zero", periodic: bool = False):
    """``a`` (..., ly, lx) extended along ``axis`` (-2: y, -1: x) by
    ``before`` rows in front and ``after`` behind, filled from the
    neighbouring ranks (wrapping around a periodic axis)."""
    global exchanges, bytes_sent
    axis = axis % a.dim()
    if axis not in (a.dim() - 2, a.dim() - 1):
        raise ValueError("halo_expand: axis must be one of the two "
                         "trailing (y, x) axes")
    on_y = axis == a.dim() - 2
    n, idx = (mesh.ny, mesh.py) if on_y else (mesh.nx, mesh.px)
    la = a.shape[axis]
    if max(before, after) > la:
        raise ValueError(f"halo of {max(before, after)} exceeds the block "
                         f"extent {la}")

    def peer(i):
        if not (0 <= i < n or periodic):
            return None
        i %= n
        return mesh.peer(i, mesh.px) if on_y else mesh.peer(mesh.py, i)
    prev, nxt = peer(idx - 1), peer(idx + 1)
    lead = trail = None
    if n == 1 and periodic:               # the block wraps onto itself
        lead = a.narrow(axis, la - before, before)
        trail = a.narrow(axis, 0, after)
        prev = nxt = None
    host = mesh.staged(a)
    ops, recvs = [], []

    def send(band, to, tag):
        global bytes_sent
        band = band.contiguous()
        if host:
            band = band.cpu()
        ops.append(dist.P2POp(dist.isend, band, to, mesh.group, tag))
        bytes_sent += band.numel() * band.element_size()

    def recv(width, frm, tag):
        shape = list(a.shape)
        shape[axis] = width
        buf = torch.empty(shape, dtype=a.dtype,
                          device="cpu" if host else a.device)
        ops.append(dist.P2POp(dist.irecv, buf, frm, mesh.group, tag))
        recvs.append(buf)
        return len(recvs) - 1

    # The order is the same on every rank, so that two ranks that are
    # each other's previous and next (a periodic pair) match their
    # messages in turn: tag 0 travels forward, tag 1 backward.
    r_lead = r_trail = None
    if before:
        if nxt is not None:
            send(a.narrow(axis, la - before, before), nxt, 0)
        if prev is not None:
            r_lead = recv(before, prev, 0)
    if after:
        if prev is not None:
            send(a.narrow(axis, 0, after), prev, 1)
        if nxt is not None:
            r_trail = recv(after, nxt, 1)
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
        exchanges += 1
    got = [b.to(a.device) if host else b for b in recvs]
    if r_lead is not None:
        lead = got[r_lead]
    if r_trail is not None:
        trail = got[r_trail]
    if before and lead is None:
        lead = _edge(a, axis, 0, before, mode)
    if after and trail is None:
        trail = _edge(a, axis, la - 1, after, mode)
    parts = [p for p in (lead if before else None, a,
                         trail if after else None) if p is not None]
    return torch.cat(parts, dim=axis) if len(parts) > 1 else a


def halo_expand2d(a: torch.Tensor, mesh, h: int, mode: str = "zero",
                  periodic_x: bool = False, periodic_y: bool = False):
    """Extend the trailing (y, x) axes by h on each side; the corners
    come from the x exchange of the y-extended rows."""
    a = halo_expand(a, mesh, -2, h, h, mode, periodic=periodic_y)
    return halo_expand(a, mesh, -1, h, h, mode, periodic=periodic_x)


def extend_block(a, y0: int, x0: int, ly: int, lx: int, h: int,
                 mode: str = "zero"):
    """The halo-extended block of a global (..., iy, jx) tensor: the
    (..., ly+2h, lx+2h) window at (y0-h, x0-h) of the global tensor
    padded by h with zeros or edge values. The reference that
    ``halo_expand2d`` reproduces across ranks."""
    pad = torch.nn.functional.pad
    lead = a.shape[:-2]
    flat = a.reshape((-1, 1) + tuple(a.shape[-2:]))
    if mode == "edge":
        padded = pad(flat, (h, h, h, h), mode="replicate")
    elif mode == "zero":
        padded = pad(flat, (h, h, h, h))
    else:
        raise ValueError(f"halo mode {mode!r}: 'zero' or 'edge'")
    padded = padded.reshape(tuple(lead) + tuple(padded.shape[-2:]))
    return padded[..., y0:y0 + ly + 2 * h, x0:x0 + lx + 2 * h].contiguous()

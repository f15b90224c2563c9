"""Semi-Lagrangian tracer advection (isladvec=1), torch twin of
``regcm_tpu/dynamics/sladvection.py`` (the reference's
``Main/mod_sladvection.F90``: trajcalc_x :121, slhadv_x3d/x4d :335-470;
McGregor 1993 3rd-order departure points, the Bermejo-Staniforth
quasi-monotone limiter per iqmsl).

Each step: departure displacements from a 3rd-order Taylor series of the
cross-point advective velocity, split into an integer cell offset
(|offset| ≤ 1, which the model's CFL limit guarantees; the reference
stops beyond it, here the offset is clipped) and a fractional weight;
the upstream value is rebuilt with the reference's mixed cubic/bilinear
4×4 stencil, optionally clipped to the bilinear box's extremes (QMSL).
The tendency is (upstream − var)/dt on the coupled field, as
``slhadv_x``. The departure points become flat (y, x) indices read by
``torch.gather``.

Under a ``DomainMesh`` the departure points are formed in the whole
domain's coordinates and clipped to its edges, as on one rank, then
turned into indices of the rank's block extended by ``HALO`` rows and
columns (|offset| ≤ 1 plus the stencil's two points beyond it): the
advected fields are extended once a step (``extend``) and gathered
there, so every column reads the values one rank would.
"""
from __future__ import annotations

from typing import Dict

import torch

from ..parallel.halo import halo_expand2d
from .stencil import dot2cross, shifte

# the departure stencil's reach beyond a point: the offset (|n| ≤ 1) and
# the two points the cubic reads past it (xnnm2, xnnp1)
HALO = 3


def extend(var, mesh):
    """``var`` (..., ly, lx) extended by ``HALO`` from the neighbouring
    ranks (the block itself without a mesh), the source ``slhadv`` reads.
    The halo beyond a domain edge is never read: the departure points
    are clipped inside the domain."""
    return var if mesh is None else halo_expand2d(var, mesh, HALO)


def sl_weights(ud, vd, msfx, dx, dt, iy, jx,
               mesh=None) -> Dict[str, torch.Tensor]:
    """Departure-point flat indices and interpolation weights on the
    cross grid (trajcalc_x). ud/vd: decoupled dot winds (kz, ly, lx), the
    whole (iy, jx) domain or, under ``mesh``, the rank's block; the
    indices address the plane of ``extend``'s source."""
    uadv = dot2cross(ud) / msfx[None]
    vadv = dot2cross(vd) / msfx[None]
    dtsq = dt * dt
    dtcb = dtsq * dt

    def displacement(a, ap1, am1):
        g1 = 0.5 * (ap1 - am1) / dx
        g2 = (ap1 - 2.0 * a + am1) / (dx * dx)
        return (-a * dt + 0.5 * dtsq * a * g1
                - dtcb * a * (g1 * g1 + a * g2) / 6.0)

    xdis = displacement(uadv, shifte(uadv, 0, 1), shifte(uadv, 0, -1))
    ydis = displacement(vadv, shifte(vadv, 1, 0), shifte(vadv, -1, 0))

    def split(dis):
        n = torch.clamp(dis / dx, -1.999, 1.999)
        npart = torch.trunc(n)
        alfa = torch.abs(npart - n)
        sn = torch.where(n >= 0.0, 1, -1)
        return npart.long(), alfa, sn

    xnp, alfax, xsn = split(xdis)
    ynp, betay, ysn = split(ydis)
    dev = ud.device
    kz, ly, lx = ud.shape
    y0, x0, h = (0, 0, 0) if mesh is None else (mesh.y0, mesh.x0, HALO)
    jj = torch.arange(x0, x0 + lx, device=dev)[None, None, :]
    ii = torch.arange(y0, y0 + ly, device=dev)[None, :, None]
    clipx = lambda a: torch.clamp(a, 0, jx - 2)
    clipy = lambda a: torch.clamp(a, 0, iy - 2)
    xndp = clipx(jj + xnp)
    xnnm1 = clipx(xndp + xsn)
    x = dict(xndp=xndp, xnnm1=xnnm1, xnnm2=clipx(xnnm1 + xsn),
             xnnp1=clipx(xndp - xsn))
    yndp = clipy(ii + ynp)
    ynnm1 = clipy(yndp + ysn)
    y = dict(yndp=yndp, ynnm1=ynnm1, ynnm2=clipy(ynnm1 + ysn),
             ynnp1=clipy(yndp - ysn))
    # the (row, column) pairs the stencil reads, as flat indices of the
    # (ly + 2h, lx + 2h) plane whose corner is the point (y0 - h, x0 - h)
    wx = lx + 2 * h
    pairs = {(yk, xk): ((y[yk] - (y0 - h)) * wx
                        + (x[xk] - (x0 - h))).reshape(kz, ly * lx)
             for yk, xk in (("ynnp1", "xnnm1"), ("ynnp1", "xndp"),
                            ("ynnm2", "xnnm1"), ("ynnm2", "xndp"),
                            ("yndp", "xnnm2"), ("yndp", "xnnm1"),
                            ("yndp", "xndp"), ("yndp", "xnnp1"),
                            ("ynnm1", "xnnm2"), ("ynnm1", "xnnm1"),
                            ("ynnm1", "xndp"), ("ynnm1", "xnnp1"))}

    def cubic(a):
        return (-(a * (1.0 - a * a)) / 6.0,
                (a * (1.0 + a) * (2.0 - a)) / 2.0,
                ((1.0 - a * a) * (2.0 - a)) / 2.0,
                -(a * (1.0 - a) * (2.0 - a)) / 6.0)

    am2, am1w, a0, ap1w = cubic(alfax)
    bm2, bm1w, b0, bp1w = cubic(betay)
    return dict(alffbl=alfax, am2=am2, am1=am1w, a0=a0, ap1=ap1w,
                bm2=bm2, bm1=bm1w, b0=b0, bp1=bp1w, pairs=pairs)


def slhadv(var, w: Dict[str, torch.Tensor], dt, qmsl: bool = True,
           src=None):
    """SL horizontal advective tendency of a coupled cross field
    (slhadv_x3d/x4d). var: (kz, ly, lx) or (n, kz, ly, lx); ``src`` its
    ``extend``-ed form (``var`` itself by default, as without a mesh)."""
    src = var if src is None else src
    flat = src.reshape(src.shape[:-2] + (-1,))

    def g(yk, xk):
        idx = w["pairs"][(yk, xk)].expand(flat.shape[:-1] + (-1,))
        return torch.gather(flat, -1, idx).reshape(var.shape)
    al = w["alffbl"]
    # bilinear on the outer y rows (:355-360)
    bl1 = al * g("ynnp1", "xnnm1") + (1.0 - al) * g("ynnp1", "xndp")
    bl2 = al * g("ynnm2", "xnnm1") + (1.0 - al) * g("ynnm2", "xndp")
    # cubic in x on the two inner y rows
    cb1 = (w["am2"] * g("yndp", "xnnm2") + w["am1"] * g("yndp", "xnnm1")
           + w["a0"] * g("yndp", "xndp") + w["ap1"] * g("yndp", "xnnp1"))
    cb2 = (w["am2"] * g("ynnm1", "xnnm2") + w["am1"] * g("ynnm1", "xnnm1")
           + w["a0"] * g("ynnm1", "xndp") + w["ap1"] * g("ynnm1", "xnnp1"))
    tbadp = (w["bm2"] * bl2 + w["bm1"] * cb2 + w["b0"] * cb1
             + w["bp1"] * bl1)
    if qmsl:
        c00 = g("yndp", "xndp")
        c01 = g("ynnm1", "xndp")
        c10 = g("yndp", "xnnm1")
        c11 = g("ynnm1", "xnnm1")
        tbmax = torch.maximum(torch.maximum(c00, c01),
                              torch.maximum(c10, c11))
        tbmin = torch.minimum(torch.minimum(c00, c01),
                              torch.minimum(c10, c11))
        tbadp = torch.clamp(tbadp, tbmin, tbmax)
    return (tbadp - var) / dt

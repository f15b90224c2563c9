"""K4 and K5a: fused WAF advection of the MOLOCH field stack.

``waf_advect(pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx, dtrdz)``
advects every field of pp_fields (nf, kz, iy, jx) by one WAF pass
(``wafone``, ``Main/mod_moloch.F90:1098-1361``): vertical, meridional,
then zonal sweeps, each with the superbee limiter. um = u·rmu and
vm = v·rmv (kz, iy, jx) are the map-scaled face winds, s (kz+1, iy, jx)
the generalized vertical velocity, fmz (kz, iy, jx) / fmzf (kz+1, iy, jx)
the vertical metric, mx2 and m_ci (iy, jx) the squared map factor and
the interior mask. The signature of the TPU kernel
``regcm_tpu/dynamics/pallas_kernels.py`` ``waf_advect``. A CPU tensor
goes to the plain PyTorch version ``waf_advect_plain``; a CUDA tensor
launches the hand-written kernel ``csrc/waf_advect.cu`` or raises.

``waf_advect_sharded(mesh, ...)`` (K5a, the TPU's ``waf_advect_sharded``)
takes one rank's (ly, lx) block of each input on a ``DomainMesh``,
extends it by a 2-wide halo from the neighbouring ranks and runs the
halo form of the same kernel (``waf_advect_halo``; plain version
``waf_advect_sharded_plain``), whose domain-edge rows and columns key on
global indices. The blocks it returns make up ``waf_advect``'s result
bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from ..dynamics.stencil import shift, shifte, topology
from ..parallel.halo import halo_expand2d
from . import _build

# kernel launches since the last reset (plain-version calls not
# counted): unsharded (K4) and halo form (K5a)
launches = 0
launches_sharded = 0

H = 2                    # halo width of the halo form

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIG = [_P] * 10 + [_I] * 9 + [_D, _D, _P]


def build():
    """Compile and load the CUDA library (once per process). -fmad=false
    keeps the upwind and limiter thresholds on the plain version's
    roundings."""
    return _build.load("waf_advect", {"waf_advect_f32": _SIG,
                                      "waf_advect_f64": _SIG},
                       extra_flags=["-fmad=false"])


def _limiter(amu, f_up2, f_up1, f_c, f_d):
    """Superbee WAF flux weight (wafone limiter, mod_moloch.F90:1120-1135),
    with the reference's division guard and sign(0) -> 1."""
    is_ = torch.sign(amu)
    is_ = torch.where(is_ == 0.0, 1.0, is_)
    den = f_c - f_d
    r = (f_up1 - f_up2) / torch.where(
        torch.abs(den) < 1e-15, torch.sign(den) * 1e-15 + 1e-30, den)
    b = torch.clamp(torch.maximum(r, torch.clamp(2.0 * r, max=1.0)),
                    0.0, 2.0)
    return is_ + amu * b - is_ * b


def _edge(a, g, n, dim):
    """The domain-edge override of wafone (:1166-1180) along ``dim``
    (-2: rows, -1: columns) keyed on the global index ``g`` of each row
    or column: 0 takes 1, n-2 and n-1 take n-3; beyond the domain 0."""
    d = (lambda k: shift(a, k, 0)) if dim == -2 else \
        (lambda k: shift(a, 0, k))
    if dim == -2:
        g = g[:, None]
    return torch.where(g == 0, d(1), torch.where(
        g == n - 2, d(-1), torch.where(
            g == n - 1, d(-2), torch.where((g >= 0) & (g < n), a, 0.0))))


def _waf_window(pp, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx, dtrdz, iy, jx,
                y0, x0, h):
    """One WAF pass over a (..., ly+2h, lx+2h) window of the (iy, jx)
    domain whose first row and column are global (y0-h, x0-h); returns
    the (..., ly, lx) interior. Op for op ``MolochCore._wafone``
    (regcm_tpu/dynamics/moloch.py:639-712) with leading batch axes on pp
    in place of ``jax.vmap``, the edge overrides keyed on global rows
    and columns as in the TPU kernel (pallas_kernels.py:234-255)."""
    kz = fmz.shape[0]
    gy = torch.arange(pp.shape[-2], device=pp.device) + (y0 - h)
    gx = torch.arange(pp.shape[-1], device=pp.device) + (x0 - h)
    # ---- vertical (interfaces K = 1..kz-1, between layer K-1 above and
    #      K below) — wafone :1115-1160
    amu = s[1:kz] * dtrdz
    above = pp[..., :-1, :, :]
    below = pp[..., 1:, :, :]
    below2 = torch.cat([pp[..., 2:, :, :], pp[..., -1:, :, :]], dim=-3)
    above2 = torch.cat([pp[..., :1, :, :], pp[..., :-2, :, :]], dim=-3)
    pos = amu >= 0.0
    f1 = torch.where(pos, below, above2)
    f2 = torch.where(pos, below2, above)
    zphi = _limiter(amu, f2, f1, above, below)
    wfw = 0.5 * s[1:kz] * ((1.0 + zphi) * below + (1.0 - zphi) * above)
    zero = torch.zeros_like(wfw[..., :1, :, :])
    zwf = torch.cat([zero, wfw, zero], dim=-3)   # (kz+1) interface fluxes
    fmzf_abv = fmzf[:kz]
    fmzf_blw = fmzf[1:]
    rfm_m = dtrdz * fmz / fmzf_blw
    rfm_p = dtrdz * fmz / torch.where(fmzf_abv == 0.0, 1.0, fmzf_abv)
    rfm_p[0] = 0.0            # fresh tensor: the top layer has no upper flux
    zdv = (s[:kz] * rfm_p - s[1:] * rfm_m) * pp
    wz = pp - zwf[..., :kz, :, :] * rfm_p + zwf[..., 1:, :, :] * rfm_m + zdv
    wz = _edge(wz, gy, iy, -2)

    # ---- meridional (:1278-1310)
    amu = vm * dtrdx
    wz_m1 = shift(wz, -1, 0)
    wz_m2 = shift(wz, -2, 0)
    wz_p1 = shift(wz, 1, 0)
    pos = amu > 0.0
    f1 = torch.where(pos, wz_m1, wz_p1)
    f2 = torch.where(pos, wz_m2, wz)
    zphi = _limiter(amu, f2, f1, wz, wz_m1)
    zpby = 0.5 * vm * ((1.0 + zphi) * wz_m1 + (1.0 - zphi) * wz)
    rfmn = dtrdx * 2.0 * fmz / (fmz + shifte(fmz, 1, 0))
    rfms = dtrdx * 2.0 * fmz / (fmz + shifte(fmz, -1, 0))
    vmn = shift(vm, 1, 0)
    zdv = (vmn * rfmn - vm * rfms) * pp
    p0 = wz + mx2 * (zpby * rfms - shift(zpby, 1, 0) * rfmn + zdv)
    p0 = _edge(p0, gx, jx, -1)

    # ---- zonal (:1330-1360)
    amu = um * dtrdx
    p0_m1 = shift(p0, 0, -1)
    p0_m2 = shift(p0, 0, -2)
    p0_p1 = shift(p0, 0, 1)
    pos = amu > 0.0
    f1 = torch.where(pos, p0_m1, p0_p1)
    f2 = torch.where(pos, p0_m2, p0)
    zphi = _limiter(amu, f2, f1, p0, p0_m1)
    zpbw = 0.5 * um * ((1.0 + zphi) * p0_m1 + (1.0 - zphi) * p0)
    rfme = dtrdx * 2.0 * fmz / (fmz + shifte(fmz, 0, 1))
    rfmw = dtrdx * 2.0 * fmz / (fmz + shifte(fmz, 0, -1))
    ume = shift(um, 0, 1)
    zdv = (ume * rfme - um * rfmw) * pp
    out = p0 + mx2 * (zpbw * rfmw - shift(zpbw, 0, 1) * rfme + zdv)
    out = torch.where(m_ci > 0.5, out, pp)
    ny, nx = out.shape[-2] - 2 * h, out.shape[-1] - 2 * h
    return out[..., h:h + ny, h:h + nx]


def waf_advect_plain(pp, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx, dtrdz):
    """One WAF pass over the whole domain in PyTorch."""
    with topology():          # the window's own shifts, never a halo
        return _waf_window(pp, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx,
                           dtrdz, pp.shape[-2], pp.shape[-1], 0, 0, 0)


def waf_advect_sharded_plain(pp, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx,
                             dtrdz, iy, jx, y0, x0):
    """The halo form in PyTorch: inputs are a block at global offset
    (y0, x0) of the (iy, jx) domain extended by 2 on each side (see
    ``waf_advect_halo``); returns the block's result."""
    with topology():
        return _waf_window(pp, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx,
                           dtrdz, iy, jx, y0, x0, H)


def _check(pp, um, vm, s, fmz, fmzf, mx2, m_ci):
    if pp.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"waf_advect: dtype {pp.dtype} not supported "
                        "(float32 or float64)")
    if pp.dim() != 4:
        raise ValueError(f"waf_advect: expected pp (nf, kz, iy, jx), got "
                         f"shape {tuple(pp.shape)}")
    nf, kz, iy, jx = pp.shape
    if iy < 4 or jx < 4 or kz < 2:
        raise ValueError(f"waf_advect: need kz >= 2, iy >= 4, jx >= 4, got "
                         f"{(kz, iy, jx)}")
    if nf * kz > 65535:
        raise ValueError(f"waf_advect: nf·kz = {nf * kz} exceeds the grid's "
                         "z extent (65535)")
    want = dict(um=(kz, iy, jx), vm=(kz, iy, jx), s=(kz + 1, iy, jx),
                fmz=(kz, iy, jx), fmzf=(kz + 1, iy, jx), mx2=(iy, jx),
                m_ci=(iy, jx))
    args = dict(um=um, vm=vm, s=s, fmz=fmz, fmzf=fmzf, mx2=mx2, m_ci=m_ci)
    for name, a in args.items():
        if tuple(a.shape) != want[name]:
            raise ValueError(f"waf_advect: {name} must be {want[name]}, got "
                             f"{tuple(a.shape)}")
    for a in (pp, *args.values()):
        if a.dtype != pp.dtype or a.device != pp.device:
            raise ValueError("waf_advect: inputs must share dtype and device")
        if not a.is_contiguous():
            raise ValueError("waf_advect: inputs must be contiguous")
    if pp.device.type not in ("cpu", "cuda"):
        raise ValueError(f"waf_advect: device {pp.device} not supported")


def _launch(args, ly, lx, hh, iy, jx, y0, x0, dtrdx, dtrdz):
    """Run the CUDA kernels on the checked inputs; returns (nf, kz, ly, lx)."""
    pp = args[0]
    nf, kz = pp.shape[:2]
    lib = build()
    out = torch.empty((nf, kz, ly, lx), dtype=pp.dtype, device=pp.device)
    wz = torch.empty_like(pp)         # the vertical sweep, kernel scratch
    fn = lib.waf_advect_f64 if pp.dtype == torch.float64 \
        else lib.waf_advect_f32
    with torch.cuda.device(pp.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(*(a.data_ptr() for a in args), out.data_ptr(), wz.data_ptr(),
                nf, kz, ly, lx, hh, iy, jx, y0, x0, float(dtrdx),
                float(dtrdz), stream)
    _build.check_status(rc, "waf_advect")
    return out


def waf_advect(pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx, dtrdz):
    """Advect the field stack; returns (nf, kz, iy, jx)."""
    global launches
    args = (pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci)
    _check(*args)
    if pp_fields.device.type == "cpu":
        return waf_advect_plain(*args, dtrdx, dtrdz)
    iy, jx = pp_fields.shape[-2:]
    out = _launch(args, iy, jx, 0, iy, jx, 0, 0, dtrdx, dtrdz)
    launches += 1
    return out


def waf_advect_halo(pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx,
                    dtrdz, iy, jx, y0, x0):
    """The halo form on one rank: every input is the rank's block at
    global offset (y0, x0) of the (iy, jx) domain extended by 2 rows and
    columns on each side (zeros beyond the domain for pp, um, vm, s, mx2
    and m_ci, edge values for fmz and fmzf); returns the block's
    (nf, kz, ly, lx) result."""
    global launches_sharded
    args = (pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci)
    _check(*args)
    ly, lx = pp_fields.shape[-2] - 2 * H, pp_fields.shape[-1] - 2 * H
    if not (0 <= y0 and y0 + ly <= iy and 0 <= x0 and x0 + lx <= jx):
        raise ValueError(f"waf_advect_halo: a {ly}x{lx} block at "
                         f"({y0}, {x0}) is not inside {iy}x{jx}")
    if pp_fields.device.type == "cpu":
        return waf_advect_sharded_plain(*args, dtrdx, dtrdz, iy, jx, y0, x0)
    out = _launch(args, ly, lx, H, iy, jx, y0, x0, dtrdx, dtrdz)
    launches_sharded += 1
    return out


def waf_advect_sharded(mesh, pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci,
                       dtrdx, dtrdz):
    """K5a: advect this rank's block of the field stack on ``mesh``. The
    inputs are the rank's (ly, lx) blocks; the halos of the zero-filled
    and of the edge-filled inputs move in one exchange each."""
    kz = fmz.shape[0]
    zero = [pp_fields, um, vm, s, mx2[None], m_ci[None]]
    edge = [fmz, fmzf]
    ext = []
    for group, mode in ((zero, "zero"), (edge, "edge")):
        flat = torch.cat([a.reshape((-1,) + tuple(a.shape[-2:]))
                          for a in group])
        big = halo_expand2d(flat, mesh, H, mode)
        sizes = [a.numel() // (a.shape[-2] * a.shape[-1]) for a in group]
        ext += list(torch.split(big, sizes))
    pp_e, um_e, vm_e, s_e, mx2_e, mci_e, fmz_e, fmzf_e = ext
    nf = pp_fields.shape[0]
    return waf_advect_halo(
        pp_e.reshape((nf, kz) + tuple(pp_e.shape[-2:])), um_e, vm_e, s_e,
        fmz_e, fmzf_e, mx2_e[0], mci_e[0], dtrdx, dtrdz, mesh.iy, mesh.jx,
        mesh.y0, mesh.x0)

"""K4: fused WAF advection of the MOLOCH field stack.

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
"""
from __future__ import annotations

import ctypes

import torch

from ..dynamics.stencil import shift, shifte
from . import _build

# kernel launches since the last reset (plain-version calls not counted)
launches = 0

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_SIG = [_P] * 9 + [_I, _I, _I, _I, _D, _D, _P]


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


def waf_advect_plain(pp, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx, dtrdz):
    """One WAF pass in PyTorch, op for op ``MolochCore._wafone``
    (regcm_tpu/dynamics/moloch.py:639-712) with leading batch axes on pp
    in place of ``jax.vmap``."""
    kz = fmz.shape[0]
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
    # edge rows copy the interior (:1166-1180); wz is fresh: in place
    wz[..., 0, :] = wz[..., 1, :]
    wz[..., -2:, :] = wz[..., -3:-2, :]

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
    p0[..., :, 0] = p0[..., :, 1]                 # p0 is fresh: in place
    p0[..., :, -2:] = p0[..., :, -3:-2]

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
    return torch.where(m_ci > 0.5, out, pp)


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


def waf_advect(pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci, dtrdx, dtrdz):
    """Advect the field stack; returns (nf, kz, iy, jx)."""
    global launches
    _check(pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci)
    if pp_fields.device.type == "cpu":
        return waf_advect_plain(pp_fields, um, vm, s, fmz, fmzf, mx2, m_ci,
                                dtrdx, dtrdz)
    if pp_fields.device.type != "cuda":
        raise ValueError(f"waf_advect: device {pp_fields.device} not "
                         "supported")
    nf, kz, iy, jx = pp_fields.shape
    if nf * kz > 65535:
        raise ValueError(f"waf_advect: nf·kz = {nf * kz} exceeds the grid's "
                         "z extent (65535)")
    lib = build()
    out = torch.empty_like(pp_fields)
    fn = lib.waf_advect_f64 if pp_fields.dtype == torch.float64 \
        else lib.waf_advect_f32
    with torch.cuda.device(pp_fields.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(pp_fields.data_ptr(), um.data_ptr(), vm.data_ptr(),
                s.data_ptr(), fmz.data_ptr(), fmzf.data_ptr(),
                mx2.data_ptr(), m_ci.data_ptr(), out.data_ptr(),
                nf, kz, iy, jx, float(dtrdx), float(dtrdz), stream)
    _build.check_status(rc, "waf_advect")
    launches += 1
    return out

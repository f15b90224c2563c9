"""Holtslag PBL scheme (ibltyp=1), torch twin of
``regcm_tpu/physics/pbl/holtslag.py``.

``Main/pbllib/mod_pbl_holtbl.F90`` (``holtbl`` :129, ``blhnew`` :1132):
nonlocal K-profile diffusion with counter-gradient heat transport,
Blackadar free-atmosphere mixing and implicit vertical diffusion of u,
v, T (as surface-referenced potential temperature), qv and cloud water.
The five implicit solves go through kernel K1 (``kernels.pbl_tridiag``);
with chemistry, ``tracer_diffusion`` solves the tracers with the scalar
coefficients through a second K1 call, with ns = ntr.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...utils import constants as c

from ...kernels.pbl_tridiag import pbl_tridiag, pbl_tridiag_sharded

# constants (mod_pbl_holtbl.F90:63-76)
KZO = 1.0
SZKM = 1600.0
FAK = 8.5
SFFRAC = 0.1
BETAM = 15.0
BETAS = 5.0
BETAH = 15.0
CCON = FAK * SFFRAC * c.vonkar
GVK = c.egrav * c.vonkar
BINM = BETAM * SFFRAC
BINH = BETAH * SFFRAC
PINK = 2.0
KZFRAC = 0.8
ONET = 1.0 / 3.0


class HoltslagOut(NamedTuple):
    uten: torch.Tensor       # coupled dot tendencies
    vten: torch.Tensor
    tten: torch.Tensor       # coupled cross
    qvten: torch.Tensor
    qcten: torch.Tensor
    zpbl: torch.Tensor       # PBL height (m)
    kpbl: torch.Tensor       # PBL top level index (float)
    # the scalar diffusion coefficients, which the chemistry tracers'
    # solve reuses (the chi block, mod_pbl_holtbl.F90:985-1095)
    alphak: torch.Tensor
    betak_q: torch.Tensor


def _tridiag_implicit_many(fs, alphaks, betaks, dt, sfc_extras,
                           mesh=None):
    """Solve several implicit-diffusion systems of identical shape in
    one K1 call (K5c on a rank's block of ``mesh``): coefficients as
    holtbl builds them (mod_pbl_holtbl.F90:566-660), systems stacked on
    a leading axis."""
    f = torch.stack(fs)                       # (ns, kz, iy, jx)
    al = torch.stack(alphaks)
    be = torch.stack(betaks)
    kz = f.shape[1]
    se = torch.stack([torch.broadcast_to(torch.as_tensor(
        s, dtype=f.dtype, device=f.device), f.shape[2:])
        for s in sfc_extras])
    bkp = torch.cat([be[:, 1:], torch.zeros_like(be[:, :1])], dim=1)
    c1 = dt * al * bkp
    c3 = dt * al * be
    c3[:, 0] = 0.0                            # fresh tensor: local write
    c2 = 1.0 + c1 + c3
    rhs = f.clone()
    rhs[:, kz - 1] = rhs[:, kz - 1] + se
    x = pbl_tridiag(c1, c2, c3, rhs) if mesh is None \
        else pbl_tridiag_sharded(mesh, c1, c2, c3, rhs)
    return tuple(x[i] for i in range(len(fs)))


def tracer_diffusion(chi, alphak, betak_q, dt, mesh=None):
    """The implicit vertical diffusion of the chemistry tracers (holtbl's
    chi tridiagonal block, mod_pbl_holtbl.F90:985-1095) with the scalar
    coefficients, no surface flux (the dry deposition is settling_tend's
    with ichdrdepo=1): one K1 call with ns = ntr (K5c on a rank's block
    of ``mesh``). chi (ntr, kz, iy, jx) decoupled; returns the
    predicted field."""
    ntr = chi.shape[0]
    return torch.stack(_tridiag_implicit_many(
        list(chi), [alphak] * ntr, [betak_q] * ntr, dt, [0.0] * ntr,
        mesh=mesh))


def _find_zpbl(ri, za, kmxpbl, ricr, kz):
    """PBL top from the bulk Richardson profile (blhnew :1147-1255)."""
    zpbl = za[kz - 1]
    kpbl = torch.full_like(zpbl, float(kz - 1))
    for k in range(kz - 1, 0, -1):
        k2 = k - 1
        cond = (ri[k] < ricr) & (ri[k2] >= ricr) & (k >= kmxpbl + 1)
        zc = za[k] + (za[k2] - za[k]) \
            * ((ricr - ri[k]) / (ri[k2] - ri[k] + 1e-30))
        zpbl = torch.where(cond, zc, zpbl)
        kpbl = torch.where(cond, float(k), kpbl)
    ri_top = torch.gather(ri, 0, kmxpbl[None])[0]
    za_top = torch.gather(za, 0, kmxpbl[None])[0]
    cap = ri_top < ricr
    zpbl = torch.where(cap, za_top, zpbl)
    kpbl = torch.where(cap, kmxpbl.to(zpbl.dtype), kpbl)
    return zpbl, kpbl


def holtbl(tpatm, tatm, patm, patmf, qv, qc, ux, vx, udd, vdd,
           za, dzq, rhox2d, uvdrag, hfx, qfx, tg, coriol,
           psb, psdotb, kmxpbl, dt, ricr=0.25, zhnew_fac=0.25,
           cross2dot_fn=None, m_di=None, m_ci=None,
           mesh=None) -> HoltslagOut:
    """One Holtslag PBL step. 3-D inputs (kz, iy, jx) decoupled; udd/vdd
    decoupled dot winds; kmxpbl (iy, jx) int64. Returns coupled
    tendencies. With a ``DomainMesh`` the inputs are one rank's block
    and the implicit solve goes through K5c."""
    kz = tpatm.shape[0]
    rdt = 1.0 / dt

    hydf = c.egrav / (patmf[1:] - patmf[:-1])
    thvx = tpatm * (1.0 + c.ep1 * qv)
    dza = za[:-1] - za[1:]
    rhohf = (patm[1:] - patm[:-1]) / (c.egrav * dza)
    govrth = c.egrav / tpatm[kz - 1]

    # Blackadar free-atmosphere diffusivity (holtbl :180-212)
    rc = 0.257 * dzq ** 0.175
    kzmax = KZFRAC * dza * dzq[1:] * rdt
    vv = ux ** 2 + vx ** 2
    ss = ((ux[:-1] - ux[1:]) ** 2 + (vx[:-1] - vx[1:]) ** 2) \
        / (dza * dza) + 1.0e-9
    ri_fa = govrth[None] * (thvx[:-1] - thvx[1:]) / (ss * dza)
    kzm_i = torch.where(ri_fa >= rc[1:], KZO,
                        KZO + torch.sqrt(ss) * (rc[1:] - ri_fa)
                        * SZKM / rc[1:])
    kzm_i = torch.minimum(kzm_i, kzmax)
    kzm = torch.cat([torch.zeros_like(kzm_i[:1]), kzm_i], dim=0)

    # surface layer (holtbl :236-300)
    uflxsfx = uvdrag * ux[kz - 1]
    vflxsfx = uvdrag * vx[kz - 1]
    ustr = torch.sqrt(torch.sqrt(uflxsfx ** 2 + vflxsfx ** 2)
                      / torch.clamp(rhox2d, min=1e-3))
    ustr = torch.clamp(ustr, min=1e-4)
    xhfx = hfx / (c.cpd * rhox2d)
    xqfx = qfx / rhox2d
    hfxv = xhfx + 0.61 * tpatm[kz - 1] * xqfx
    hfxv = hfxv + torch.sign(hfxv) * 1.0e-5 + \
        torch.where(hfxv == 0.0, hfxv.new_tensor(1.0e-5), 0.0)
    pfcor = torch.clamp(torch.abs(coriol), min=2.546e-5)

    # theta_v at 10 m (ifaholtth10=1 default + one iteration)
    sh10 = qv[kz - 1] / (qv[kz - 1] + 1.0)
    zakz = za[kz - 1]
    th10_0 = (0.25 * tpatm[kz - 1] + 0.75 * tg) * (1.0 + c.ep1 * sh10)
    oblen = -(th10_0 * ustr ** 3) / (GVK * hfxv)
    th10_it = torch.where(
        oblen >= zakz,
        thvx[kz - 1] + hfxv / (c.vonkar * ustr)
        * (torch.log(zakz * 0.1) + 5.0 / oblen * (zakz - 10.0)),
        torch.where((oblen < zakz) & (oblen > 10.0),
                    thvx[kz - 1] + hfxv / (c.vonkar * ustr)
                    * (torch.log(torch.abs(oblen) * 0.1)
                       + 5.0 / oblen * (oblen - 10.0)
                       + 6.0 * torch.log(zakz
                                         / torch.clamp(oblen, min=1e-3))),
                    thvx[kz - 1] + hfxv / (c.vonkar * ustr)
                    * 6.0 * torch.log(zakz * 0.1)))
    th10 = torch.where(hfxv > 0.0, thvx[kz - 1], th10_it)
    obklen = -(th10 * ustr ** 3) / (GVK * hfxv)

    # -- blhnew: PBL height (mod_pbl_holtbl.F90:1147-1255)
    ki = torch.arange(kz, device=za.device)[:, None, None]
    valid = ki >= kmxpbl[None]
    ri = torch.where(valid,
                     c.egrav * (thvx - th10[None]) * za
                     / (th10[None] * torch.clamp(vv, min=1e-10)), 0.0)
    zpbl, kpbl = _find_zpbl(ri, za, kmxpbl, ricr, kz)
    # convective correction with thermal excess
    unstable = hfxv > 0.0
    xfmt0 = torch.abs(1.0 - BINM * zpbl / obklen) ** ONET
    wsc0 = ustr * xfmt0
    therm = torch.where(unstable,
                        (xhfx + c.ep1 * tpatm[kz - 1] * xqfx) * FAK
                        / torch.clamp(wsc0, min=1e-6), 0.0)
    sh = qv / (qv + 1.0)
    tkv = tpatm * (1.0 + c.ep1 * sh)
    tlv = th10 + therm
    ri2_k = c.egrav * (tkv - tlv[None]) * za \
        / (th10[None] * torch.clamp(vv, min=1e-10))
    ri2_sfc = -c.egrav * therm * za[kz - 1] \
        / (th10 * torch.clamp(vv[kz - 1], min=1e-10))
    ri2 = torch.where(valid, ri2_k, 0.0)
    ri2[kz - 1] = ri2_sfc                     # fresh tensor: local write
    zpbl2, kpbl2 = _find_zpbl(ri2, za, kmxpbl, ricr, kz)
    zpbl = torch.where(unstable, zpbl2, zpbl)
    kpbl = torch.where(unstable, kpbl2, kpbl)
    # mechanical mixing depth floor
    phpblm = torch.maximum(0.07 * ustr / pfcor, za[kz - 1])
    zpbl = torch.maximum(zpbl, phpblm)

    # -- K profiles + counter-gradient inside the PBL (blhnew :1258-1355)
    zm = za
    zp = torch.minimum(torch.cat([za[:1], za[:-1]], dim=0), zpbl[None])
    z = 0.5 * (zm + zp)
    zh = z / zpbl[None]
    zl = z / obklen[None]
    inpbl = (zm < zpbl[None]) & (ki >= 1)
    zzh = torch.where(zh <= 1.0, (1.0 - zh) ** PINK, 0.0)
    zzhnew = torch.where(zh <= 1.0, (1.0 - zh) * zhnew_fac, 0.0)
    fak1 = (ustr * zpbl * c.vonkar)[None]
    # stable/neutral
    pblk_s = torch.where(zl <= 1.0,
                         fak1 * zh * zzh / (1.0 + BETAS * zl),
                         fak1 * zh * zzh / (BETAS + zl))
    pblk1_s = torch.where(zl <= 1.0,
                          fak1 * zh * zzhnew / (1.0 + BETAS * zl),
                          fak1 * zh * zzhnew / (BETAS + zl))
    kvm_s = torch.clamp(pblk_s, min=KZO)
    kvq_s = torch.clamp(pblk1_s, min=KZO)
    verystable = zl <= 0.1
    kvm_s = torch.where(verystable, 0.0, kvm_s)
    kvh_s = kvm_s
    kvq_s = torch.where(verystable, 0.0, kvq_s)
    # unstable, outer layer (zh >= sffrac)
    xfmt = torch.abs(1.0 - BINM * zpbl / obklen) ** ONET
    fht = torch.sqrt(torch.abs(1.0 - BINH * zpbl / obklen))
    wsc = ustr * xfmt
    pr_o = (xfmt / torch.clamp(fht, min=1e-6)) + CCON
    fak2 = (wsc * zpbl * c.vonkar)[None]
    pblk_o = fak2 * zh * zzh
    pblk1_o = fak2 * zh * zzhnew
    therm2 = (FAK / torch.clamp(zpbl * wsc, min=1e-6))
    cgh_o = (hfxv * therm2)[None] * torch.ones_like(zh)
    # unstable, surface layer (zh < sffrac)
    fml = torch.abs(1.0 - BETAM * zl) ** ONET
    pblk_i = fak1 * zh * zzh * fml
    pblk1_i = fak1 * zh * zzhnew * fml
    pr_i = fml / torch.sqrt(torch.abs(1.0 - BETAH * zl))
    outer = zh >= SFFRAC
    pblk_u = torch.where(outer, pblk_o, pblk_i)
    pblk1_u = torch.where(outer, pblk1_o, pblk1_i)
    pr_u = torch.where(outer, pr_o[None] * torch.ones_like(zh), pr_i)
    cgh_u = torch.where(outer, cgh_o, 0.0)
    kvm_u = torch.clamp(pblk_u, min=KZO)
    kvh_u = torch.clamp(pblk_u / pr_u, min=KZO)
    kvq_u = torch.clamp(pblk1_u, min=KZO)
    uns3 = unstable[None] & inpbl
    stb3 = (~unstable[None]) & inpbl
    kvm = torch.where(uns3, kvm_u, torch.where(stb3, kvm_s, kzm))
    kvh = torch.where(uns3, kvh_u, torch.where(stb3, kvh_s, kzm))
    kvq = torch.where(uns3, kvq_u, torch.where(stb3, kvq_s, kzm))
    cgh = torch.where(uns3, cgh_u, 0.0)

    # -- implicit diffusion
    def iface_coef(kv):
        return torch.cat([torch.zeros_like(kv[:1]), rhohf * kv[1:] / dza],
                         dim=0)

    akzz1 = iface_coef(kvm)
    akzz2 = hydf
    c2d = cross2dot_fn if cross2dot_fn is not None else (lambda a: a)
    betak_d = c2d(akzz1)
    alphak_d = c2d(akzz2)
    drgdot = c2d(uvdrag[None])[0]
    uflxsf = drgdot * udd[kz - 1]
    vflxsf = drgdot * vdd[kz - 1]
    betak_t = iface_coef(kvh)
    betak_q = iface_coef(kvq)
    up, vp, tp, qp, qcp = _tridiag_implicit_many(
        [udd, vdd, tpatm, qv, qc],
        [alphak_d, alphak_d, akzz2, akzz2, akzz2],
        [betak_d, betak_d, betak_t, betak_q, betak_q], dt,
        [-dt * alphak_d[kz - 1] * uflxsf,
         -dt * alphak_d[kz - 1] * vflxsf,
         dt * akzz2[kz - 1] * hfx * c.rcpd,
         dt * akzz2[kz - 1] * qfx, 0.0], mesh=mesh)
    uten = (up - udd) * rdt * psdotb[None]
    vten = (vp - vdd) * rdt * psdotb[None]
    if m_di is not None:
        uten = uten * m_di
        vten = vten * m_di

    # temperature (on tpatm, scaled back by sf = tatm·psb/tpatm)
    sf = (tatm * psb[None]) / tpatm
    tten = (tp - tpatm) * rdt * sf
    qvten = (qp - qv) * rdt * psb[None]
    qcten = (qcp - qc) * rdt * psb[None]

    # counter-gradient heat term (holtbl :926-975)
    sfk = tatm / tpatm
    ttnp = torch.cat([torch.zeros_like(kvh[:1]),
                      sfk[1:] * c.cpd * rhohf * kvh[1:] * cgh[1:]], dim=0)
    ttnp_p1 = torch.cat([ttnp[1:], torch.zeros_like(ttnp[:1])], dim=0)
    dtt = torch.where(ki == kz - 1,
                      -psb[None] * hydf * ttnp * c.rcpd,
                      psb[None] * hydf * (ttnp_p1 - ttnp) * c.rcpd)
    tten = tten + dtt
    if m_ci is not None:
        tten = tten * m_ci
        qvten = qvten * m_ci
        qcten = qcten * m_ci
    return HoltslagOut(uten=uten, vten=vten, tten=tten, qvten=qvten,
                       qcten=qcten, zpbl=zpbl, kpbl=kpbl, alphak=akzz2,
                       betak_q=betak_q)

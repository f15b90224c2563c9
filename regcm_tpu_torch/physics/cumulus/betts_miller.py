"""Betts-Miller cumulus convection (icup=3), torch twin of
``regcm_tpu/physics/cumulus/betts_miller.py``.

``Main/cumlib/mod_cu_bm.F90`` (``bmpara`` :134-926): convective
adjustment toward reference T/q profiles for deep and shallow convection
(Betts 1986; Betts and Miller 1986; Kain's table-free variant). Deep: a
moist-adiabat reference temperature below the freezing level, a
saturation-pressure-deficit humidity reference, a two-pass enthalpy
correction and the entropy-change closure with the prognostic cloud
efficiency ``cldefi``. Shallow: the mixing-line reference with an
RH-drop cloud top.

Columns are (ncol, kz) tensors, TOP-DOWN like the reference (index 0 =
model top). The below-freezing and mixing-line recursions are loops over
the levels on (ncol,) planes; ``_tpfc`` is a fixed 12-step secant solve.
Every sum over levels runs in level order (``level_sum``). As in the JAX
package, the reference's ``exit shallow`` (:832, :844), which aborts all
remaining points in gather order, is applied per point.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...dynamics.hydrostatic import level_sum
from ...utils import constants as c

# parameters (:137-191)
H3000 = 3000.0
STRESH = 1.10
STABS = 1.0
STABD = 0.90
RHF = 0.20
PMN = 6500.0
EPSDN = 1.05
EPSTH = 6.0
PBM = 30000.0
PQM = 20000.0
PONE = 2500.0
PFRZ = 15000.0
PSHU = 45000.0
ZNO = 750.0
ZSH = 3999.0
FSL = 1.00
FSS = 0.60
EFIMN = 0.20
EFMNT = 0.70
FCC1 = 0.50
FCP = 1.0 - FCC1
DSPBFL, DSP0FL, DSPTFL = -3875.0, -5875.0, -1875.0
DSPBFS, DSP0FS, DSPTFS = -3875.0, -5875.0, -1875.0
DSPBSL, DSP0SL, DSPTSL = DSPBFL * FSL, DSP0FL * FSL, DSPTFL * FSL
DSPBSS, DSP0SS, DSPTSS = DSPBFS * FSS, DSP0FS * FSS, DSPTFS * FSS
EPSNTP = 1.0e-3
EFIFC = 5.0
AVGEFI = (EFIMN + 1.0) * 0.5
DSPC = -3000.0
EPSP = 1.0e-7
STEFI = AVGEFI
SLOPBL = (DSPBFL - DSPBSL) / (1.0 - EFIMN)
SLOP0L = (DSP0FL - DSP0SL) / (1.0 - EFIMN)
SLOPTL = (DSPTFL - DSPTSL) / (1.0 - EFIMN)
SLOPBS = (DSPBFS - DSPBSS) / (1.0 - EFIMN)
SLOP0S = (DSP0FS - DSP0SS) / (1.0 - EFIMN)
SLOPTS = (DSPTFS - DSPTSS) / (1.0 - EFIMN)
SLOPE = (1.0 - EFMNT) / (1.0 - EFIMN)
A23M4L = c.c3les * (c.tzero - c.c4les) * c.wlhv
CPRLG = c.cpd / (c.rhoh2o * c.egrav * c.wlhv)
TREL = 3000.0
RHMIN, RHMAX = 0.01, 1.01    # mod_params.F90:331-332


class BMOut(NamedTuple):
    tten: torch.Tensor      # (ncol, kz) top-down T tendency (K/s)
    qten: torch.Tensor      # qv tendency (kg/kg/s)
    prate: torch.Tensor     # precip rate (mm/s = kg/m2/s)
    cldefi: torch.Tensor    # updated cloud efficiency memory
    kbot: torch.Tensor
    ktop: torch.Tensor


def _esliq(t):
    """Saturation vapour pressure, the KF liquid form (:342)."""
    return c.aliq * torch.exp((c.bliq * t - c.cliq) / (t - c.dliq))


def _tlcl(t, q, p):
    """LCL temperature from the dew point (:286-291); p in Pa."""
    ee = p * q / (0.622 + q)
    tdpt = 1.0 / (c.rtzero - c.rwat * c.rwlhv
                  * torch.log(torch.clamp(ee, min=1e-10) / 611.0))
    tdpt = torch.minimum(tdpt, t)
    return tdpt - (0.212 + 1.571e-3 * (tdpt - c.tzero)
                   - 4.36e-4 * (t - c.tzero)) * (t - tdpt)


def _tpfc(press, thetae, tgs, ape):
    """T on the moist adiabat thetae at pressure press (tpfc, :886-924):
    a secant iteration of fixed 12 steps with masked updates."""
    rl461 = c.wlhv / c.rwat
    rl1004 = c.wlhv / c.cpd
    rp = thetae / ape

    def f(tt):
        es = 611.0 * torch.exp(rl461 * (c.rtzero - 1.0 / tt))
        qs = 0.622 * es / torch.clamp(press - es, min=1.0)
        return tt * torch.exp(rl1004 * qs / tt) - rp

    fo = f(tgs)
    t1 = tgs - 0.5 * fo
    tguess = tgs
    for _ in range(12):
        f1 = f(t1)
        done = f1.abs() < 0.1
        denom = torch.where((f1 - fo).abs() < 1e-12, 1e-12, f1 - fo)
        dtx = f1 * (t1 - tguess) / denom
        tguess = torch.where(done, tguess, t1)
        fo = torch.where(done, fo, f1)
        t1 = torch.where(done, t1, t1 - dtx)
    return t1


def bmpara(t, q, pas, pasf, z0, psf, landmask, cldefi, dt) -> BMOut:
    """Betts-Miller adjustment on (ncol, kz) TOP-DOWN columns.

    t (K), q (mixing ratio), pas (Pa mid-level), pasf (Pa, kz+1
    interfaces), z0 heights (m), psf surface pressure (Pa), landmask
    (1=land), cldefi: persistent cloud efficiency; dt: timestep (s).
    """
    ncol, kz = t.shape
    dev = t.device
    ii = torch.arange(kz, device=dev)[None, :]
    tauk = dt / TREL
    cthrs = (0.00635 / 86400.0) * dt / CPRLG
    xsm = torch.where(landmask > 0.5, 0.0, 1.0).to(t.dtype)  # 1 = water
    takek = lambda a, k: torch.gather(a, 1, k[:, None])[:, 0]

    ape = (pas / c.stdp) ** (-c.rovcp)             # 1/Exner (:254)
    tds = (pasf[:, 1:] - pasf[:, :-1]) / pasf[:, -1:]
    lb = kz - 2                                     # 0-based kzm1 (:240)

    # -- maximum-buoyancy source level in the lowest 300 hPa (:281-301)
    inlow = pas >= (psf[:, None] - PBM)
    tthbt = t * ape
    tlcl = _tlcl(t, q, pas)
    tthes = tthbt * torch.exp(c.wlhvocp * q / tlcl)
    tthes_m = torch.where(inlow, tthes, -1e30)
    ksrc = torch.argmax(tthes_m, dim=1)
    thesp = takek(tthes_m, ksrc)
    thbt = takek(tthbt, ksrc)
    psp = torch.where(thesp > 0.0,
                      c.stdp * (takek(tlcl, ksrc) / thbt) ** c.cpovr,
                      9.5e4)
    thesp = torch.clamp(thesp, min=0.0)

    # -- cloud base: the level just below psp (:305-328)
    ii1 = ii[:, :-1]
    condb = (pas[:, :-1] < psp[:, None]) & (pas[:, :-1] >= PQM)
    kbot = torch.where(condb, ii1 + 1, -1).amax(dim=1)
    kbot = torch.where(kbot < 0, kz - 1, kbot)
    # a base at least 25 hPa above the surface
    pbot = takek(pas, kbot)
    need = (pbot >= psf - PONE) | (kbot >= kz - 1)
    cond2 = pas[:, :-1] < (psf[:, None] - PONE)
    kbot2 = torch.where(cond2, ii1, -1).amax(dim=1)
    kbot = torch.where(need & (kbot2 >= 0), kbot2, kbot)
    kbot = torch.clamp(kbot, 2, kz - 2)

    # -- cloud top: the buoyancy scan from the bottom (:337-357): ktop is
    # l+1 of the highest level with thesp > ths-1.5 that has buoyancy at
    # or below it
    es_env = _esliq(t)
    qs_env = 0.622 * es_env / torch.clamp(pas - es_env, min=1.0)
    ths = t * ape * torch.exp(c.wlhvocp * qs_env / t)
    lmask = ii <= kbot[:, None]
    buoy = lmask & (thesp[:, None] > ths)
    near = lmask & (thesp[:, None] > ths - 1.5)
    buoy_below = torch.flip(torch.cumsum(torch.flip(buoy, [1]), dim=1),
                            [1]) > 0
    hit = near & buoy_below
    ktop = torch.where(hit.any(dim=1),
                       torch.argmax(hit.to(torch.int32), dim=1) + 1, kbot)
    ktop = torch.minimum(ktop, kbot)                 # (:389-391)

    # -- dsp profiles from cldefi (:361-371)
    efi = cldefi
    dspb = ((efi - EFIMN) * SLOPBS + DSPBSS) * xsm \
        + ((efi - EFIMN) * SLOPBL + DSPBSL) * (1.0 - xsm)
    dsp0 = ((efi - EFIMN) * SLOP0S + DSP0SS) * xsm \
        + ((efi - EFIMN) * SLOP0L + DSP0SL) * (1.0 - xsm)
    dspt = ((efi - EFIMN) * SLOPTS + DSPTSS) * xsm \
        + ((efi - EFIMN) * SLOPTL + DSPTSL) * (1.0 - xsm)

    zbot = takek(z0, kbot)
    cldhgt = takek(z0, ktop) - zbot
    cldefi = torch.where(cldhgt < ZNO,
                         AVGEFI * xsm + STEFI * (1.0 - xsm), cldefi)
    deep = cldhgt >= ZSH

    # ==== deep convection (:408-615) ====================================
    tref_ma = _tpfc(pas, thesp[:, None], t, ape)    # moist-adiabat T
    therk = tref_ma * ape
    pk = pas
    pkt = takek(pk, ktop)
    lbv = torch.full_like(ktop, lb)
    pkb = takek(pk, lbv)

    # the below-freezing-level reference recursion, ivi from lb-1 down
    # to 0 (:453-470); it stops where trefk(ivi+1) <= 274.16
    trefk = t.clone()
    trefk_next = takek(t, lbv)
    l0 = lbv.clone()
    pk0 = pkb
    stopped = torch.zeros((ncol,), dtype=torch.bool, device=dev)
    for ivi in range(kz - 2, -1, -1):
        new = ((therk[:, ivi] - therk[:, ivi + 1]) * STABD
               + trefk_next * ape[:, ivi + 1]) / ape[:, ivi]
        inloop = (ivi >= ktop) & (ivi <= lb - 1) & ~stopped
        trig = inloop & (trefk_next <= 274.16)
        stopped = stopped | trig
        take_new = inloop & ~trig
        trefk[:, ivi] = torch.where(take_new, new, t[:, ivi])
        l0 = torch.where(take_new, ivi, l0)
        pk0 = torch.where(take_new, pk[:, ivi], pk0)
        trefk_next = torch.where(take_new, new, trefk_next)
    # above the freezing level: linear theta interpolation (:471-478)
    dthem = takek(therk, l0) - takek(trefk, l0) * takek(ape, l0)
    rdp0t = 1.0 / torch.clamp(pk0 - pkt, min=1.0)
    above = ii < l0[:, None]
    trefk = torch.where(above & (ii >= ktop[:, None]),
                        (therk - (pk - pkt[:, None]) * dthem[:, None]
                         * rdp0t[:, None]) / ape, trefk)

    # deep reference humidity (:482-508)
    frzdeep = (pkb - pk0) > PFRZ
    dsp_up = ((pk0[:, None] - pk) * dspt[:, None]
              + (pk - pkt[:, None]) * dsp0[:, None]) \
        / torch.clamp(pk0 - pkt, min=1.0)[:, None]
    dsp_dn = ((pkb[:, None] - pk) * dsp0[:, None]
              + (pk - pk0[:, None]) * dspb[:, None]) \
        / torch.clamp(pkb - pk0, min=1.0)[:, None]
    dsp = torch.where(ii < l0[:, None], dsp_up, dsp_dn)
    dsp = torch.where(frzdeep[:, None], dsp, DSPC)
    psk = torch.where(pk > PQM, pk + dsp, pk)
    pskc = torch.clamp(psk, min=1000.0)
    apesk = (pskc / c.stdp) ** (-c.rovcp)
    thsk = trefk * ape
    qrefk = torch.where(
        pk > PQM,
        c.pq0 / pskc * torch.exp(c.c3les * (thsk - c.tzero * apesk)
                                 / (thsk - c.c4les * apesk)), q)

    # enthalpy conservation, two passes (:512-549)
    lay = (ii >= ktop[:, None]) & (ii <= lb)
    tds_top = takek(tds, ktop)
    lqm_cond = pk <= PQM
    above_q = lay & (ii > ktop[:, None]) & lqm_cond
    below_q = lay & (ii > ktop[:, None]) & ~lqm_cond
    for _ in range(2):
        sumde = level_sum(torch.where(
            lay, ((t - trefk) * c.cpd + (q - qrefk) * c.wlhv) * tds, 0.0).T)
        sumdp = level_sum(torch.where(lay, tds, 0.0).T)
        hcorr = sumde / torch.clamp(sumdp - tds_top, min=1e-10)
        # above lqm (p <= 200 hPa): T only; below: T and q
        trefk = torch.where(above_q, trefk + hcorr[:, None] * c.rcpd,
                            trefk)
        tskl = trefk * ape / apesk
        dhdt = qrefk * A23M4L / (tskl - c.c4les) ** 2 + c.cpd
        trefk = torch.where(below_q, hcorr[:, None] / dhdt + trefk, trefk)
        thskl = trefk * ape
        qrefk = torch.where(
            below_q,
            c.pq0 / pskc * torch.exp(c.c3les * (thskl - c.tzero * apesk)
                                     / (thskl - c.c4les * apesk)), qrefk)

    # heating/moistening/precip (:556-567)
    diftl = (trefk - t) * tauk
    difql = (qrefk - q) * tauk
    avrgtl = 2.0 * t + diftl
    dentpy = 2.0 * level_sum(torch.where(
        lay, (diftl * c.cpd + difql * c.wlhv) * tds / avrgtl, 0.0).T)
    sumdp = level_sum(torch.where(lay, tds, 0.0).T)
    avrgt = level_sum(torch.where(lay, avrgtl * tds, 0.0).T) \
        / (2.0 * torch.clamp(sumdp, min=1e-10))
    preck = level_sum(torch.where(lay, tds * diftl, 0.0).T)

    swap = deep & ((dentpy < EPSNTP) | (preck <= 0.0))   # (:568-580)
    deep_ok = deep & ~swap

    # the swap branch: efficiency reset, cloud shrunk to shallow depth
    cldefi = torch.where(swap, EFIMN * xsm + STEFI * (1.0 - xsm), cldefi)
    ztop_sw = zbot + ZSH - 1e-6
    cond_sw = z0 >= ztop_sw[:, None]
    ktop_sw = torch.where(cond_sw & (ii <= lb), ii + 1, 0).amax(dim=1)
    ktop_sw = torch.minimum(ktop_sw, kbot - 2)
    ktop = torch.where(swap, ktop_sw, ktop)
    cldhgt = torch.where(swap, takek(z0, torch.clamp(ktop, 0, kz - 1))
                         - zbot, cldhgt)

    # deep closure (:584-614)
    pthrs = cthrs / psf
    drheat = (preck * xsm + torch.clamp(preck - pthrs, min=EPSP)
              * (1.0 - xsm)) * c.cpd / torch.clamp(avrgt, min=1.0)
    efi_new = EFIFC * dentpy / torch.clamp(drheat, min=1e-10)
    efi_new = (cldefi * FCP + efi_new * FCC1) * xsm + (1.0 - xsm)
    efi_new = torch.clamp(efi_new, EFIMN, 1.0)
    cldefi = torch.where(deep_ok, efi_new, cldefi)
    fefi = EFMNT + SLOPE * (cldefi - EFIMN)
    preck_f = preck * fefi
    pratec = torch.where(deep_ok,
                         (psf * preck_f * CPRLG) * 100.0 / dt, 0.0)
    dlay = deep_ok[:, None] & lay
    tten = torch.where(dlay, diftl * fefi[:, None] / dt, 0.0)
    qten = torch.where(dlay, difql * fefi[:, None] / dt, 0.0)

    # ==== shallow convection (:624-864) =================================
    shal = (cldhgt >= ZNO) & (ktop <= kbot - 2) & (cldhgt < ZSH) \
        & ~deep_ok
    qsatk = 0.622 * es_env / torch.clamp(pas - es_env, min=1.0)

    # kdp: the model level nearest to pk(k)-65 hPa (:666-680); the
    # descending Fortran scan keeps the last strict improvement, so the
    # smallest k wins and ties favour the larger k
    pdp = pk - PMN
    dist = (pk[:, None, :] - pdp[:, :, None]).abs()[:, :, : kz - 1]
    kdp = (kz - 2) - torch.argmin(torch.flip(dist, [2]), dim=2)
    kdp = torch.where(kdp == ii, kdp - 1, kdp)
    kdp = torch.clamp(kdp, min=0)

    # shallow first-guess top: the level just above zbot+ZSH (:687-706)
    ztop_s = zbot + ZSH - 1e-6
    ltpk_s = torch.where(z0 >= ztop_s[:, None], ii, 0).amax(dim=1)
    ptpk = takek(pk, ltpk_s)
    lshu = torch.where(pk <= PSHU, ii + 1, 0).amax(dim=1)
    ltpk_s = torch.where(ptpk <= PSHU, lshu, ltpk_s)
    ltpk_s = torch.clamp(ltpk_s, 0, kz - 2)

    # RH-drop top ltsh (:712-716): the last l in [ltpk+1, kbot-1] with
    # rh(kdp(l)) + RHF < rh(l)
    rh = torch.clamp(q / torch.clamp(qsatk, min=1e-12), RHMIN, RHMAX)
    rh_kdp = torch.gather(rh, 1, kdp)
    cond_rh = (rh_kdp + RHF < rh) & (ii >= ltpk_s[:, None] + 1) \
        & (ii <= kbot[:, None] - 1)
    ltsh = torch.where(cond_rh, ii, -1).amax(dim=1)
    ltsh = torch.where(ltsh < 0, kbot, ltsh)
    ktop_sh = ltsh
    ltp1 = ltsh
    cldhgt_sh = takek(z0, ktop_sh) - zbot
    shal = shal & ~((cldhgt_sh < ZNO) | (ktop_sh > kbot - 2))

    # mixing-line slope (:727-744)
    t_top = takek(t, ltp1)
    thtpk = t_top * takek(ape, ltp1)
    tlcl_t = _tlcl(t_top, takek(q, ltp1), takek(pas, ltp1))
    ptpk2 = c.stdp * (tlcl_t / thtpk) ** c.cpovr
    dpmix = ptpk2 - psp
    dpmix = torch.where(dpmix.abs() < H3000, -H3000, dpmix)
    smix = (thtpk - thbt) / dpmix * STABS

    trefk_s = t.clone()
    tref_next = takek(t, torch.clamp(kbot + 1, max=kz - 1))
    for ivi in range(kz - 2, -1, -1):
        new = ((pk[:, ivi] - pk[:, ivi + 1]) * smix
               + tref_next * ape[:, ivi + 1]) / ape[:, ivi]
        inloop = (ivi >= ltp1) & (ivi <= kbot)
        trefk_s[:, ivi] = torch.where(inloop, new, t[:, ivi])
        tref_next = trefk_s[:, ivi]

    lay_s = (ii >= ltp1[:, None]) & (ii <= kbot[:, None])
    sumdt = level_sum(torch.where(lay_s, (t - trefk_s) * tds, 0.0).T)
    sumdp_s = level_sum(torch.where(lay_s, tds, 0.0).T)
    rdpsum = 1.0 / torch.clamp(sumdp_s, min=1e-10)
    tcorr = sumdt * rdpsum
    trefk_s = torch.where(lay_s, trefk_s + tcorr[:, None], trefk_s)
    fpk = trefk_s
    fptk = takek(fpk, ltp1)

    # humidity profile sums (:765-788)
    dpkl = fpk - fptk[:, None]
    rtbar = 2.0 / (trefk_s + t)
    psum = level_sum(torch.where(lay_s, dpkl * tds, 0.0).T) * rdpsum
    qsum = level_sum(torch.where(lay_s, q * tds, 0.0).T) * rdpsum
    otsum = level_sum(torch.where(lay_s, tds * rtbar, 0.0).T)
    rotsum = 1.0 / torch.clamp(otsum, min=1e-10)
    potsum = level_sum(torch.where(lay_s, dpkl * rtbar * tds, 0.0).T) * rotsum
    qotsum = level_sum(torch.where(lay_s, q * rtbar * tds, 0.0).T) * rotsum
    dst = level_sum(torch.where(lay_s, (trefk_s - t) * rtbar * tds, 0.0).T) \
        * rotsum * (c.cpd / c.wlhv)

    shal = shal & (dst <= 0.0)                        # (:792-795)
    dstq = dst * EPSDN
    den = potsum - psum
    shal = shal & (-den / torch.where(psum == 0.0, 1.0, psum) >= 0.00005)
    dqref = (qotsum - dstq - qsum) / torch.where(den == 0.0, 1.0, den)
    shal = shal & (dqref >= 0.0)                      # (:815-818)
    qrftp = qsum - dqref * psum
    qrfkl = (fpk - fptk[:, None]) * dqref[:, None] + qrftp[:, None]
    qnew = (qrfkl - q) * tauk + q
    shal = shal & ~(lay_s & (qnew > qsatk * STRESH)).any(dim=1)
    # thvref: the reference profile inside the layer, the environment
    # outside (:656-657)
    thv_env = t * ape * (q * c.ep1 + 1.0)
    thvref = torch.where(lay_s, trefk_s * ape * (qrfkl * c.ep1 + 1.0),
                         thv_env)
    # impossible slopes (:840-846): l runs ltp1..lbtk, reading thvref(l-1)
    prv = torch.cat([thvref[:, :1], thvref[:, :-1]], dim=1)
    dtdeta = (prv - thvref) / torch.clamp(tds, min=1e-10)
    shal = shal & ~(lay_s & (dtdeta < EPSTH)).any(dim=1)

    slay = shal[:, None] & lay_s
    tten = torch.where(slay, (trefk_s - t) / TREL, tten)
    qten = torch.where(slay, (qrfkl - q) / TREL, qten)
    ktop = torch.where(shal, ktop_sh, torch.where(deep_ok, ktop, kbot))

    return BMOut(tten=tten, qten=qten,
                 prate=torch.clamp(pratec, min=0.0),
                 cldefi=cldefi, kbot=kbot, ktop=ktop)


def model_cumulus_cloud(kbot, ktop, kz, ds_km, dtype=torch.float64):
    """Convective cloud fraction from the cloud's extent
    (model_cumulus_cloud, Main/cumlib/mod_cu_common.F90:128-147,
    icumcloud<=1): 1 - (1-clfrcv)^(1/kclth) for ktop..kbot, clfrcv
    resolution-dependent (mod_params.F90:2441-2448); a (ncol, kz)
    tensor of ``dtype``."""
    afracl, afracs = 0.25, 0.75
    dlargc, dsmalc = 100.0, 10.0
    dxtemc = min(max(ds_km, dsmalc), dlargc)
    clfrcv = afracl + (afracs - afracl) \
        * ((dlargc - dxtemc) / (dlargc - dsmalc)) ** 2
    clfrcv = min(max(clfrcv, afracl), 1.0)
    ii = torch.arange(kz, device=kbot.device)[None, :]
    kclth = (kbot - ktop + 1)[:, None]
    inlay = (ii >= ktop[:, None]) & (ii <= kbot[:, None]) & (kclth >= 2)
    frac = 1.0 - (1.0 - clfrcv) ** (1.0 / torch.clamp(kclth, min=1).to(
        dtype))
    return torch.where(inlay, frac, 0.0)


def clwfromt(t):
    """In-cloud liquid water content g/m3 (Share/clwfromt.inc, Lemus et
    al. 1997)."""
    tcel = t - c.tzero
    clw = 0.127 + 6.78e-3 * tcel + 1.29e-4 * tcel ** 2 \
        + 8.68e-7 * tcel ** 3
    return torch.where(tcel < -50.0, 0.001, clw)

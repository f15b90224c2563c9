"""Mellor-Yamada-Janjic level-2.5 PBL (ibltyp=4), torch twin of
``regcm_tpu/physics/pbl/myj.py`` (``Main/pbllib/mod_pbl_myj.F90:177``,
Janjic 2002, NCEP Office Note 437).

Prognoses q² = 2·TKE on the kz model layers: mixing length from the
Blackadar/Janjic blend (``mixlen`` :522), production and dissipation by
the two-Newton-iteration equilibrium update (``prodq2`` :655), exchange
coefficients from the level-2.5 stability functions (``difcof`` :783),
then implicit vertical diffusion of q², the scalars (a θ_e-like moist
entropy variable, specific humidity, cloud water and ice) and momentum
(``vdifq``/``vdifh``/``vdifv`` :836-996), each elimination a loop over
levels on (iy, jx) planes. The JAX package's documented deviation is
kept: the surface exchange conductances come from the stored drag
(akms = akhs = uvdrag/ρ_sfc) and ustar from the drag law.

k=0 is the model top; layer arrays (kz, iy, jx); ``z`` interface
heights (kz+1, iy, jx) above sea level; gm/gh/el/akm/akh on the kz-1
interior interfaces (the bottom of layer k is interface k+1).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ...dynamics.hydrostatic import level_sum
from ...utils import constants as c
from ...utils.thermo import pfqsat

MYJTKEMIN = 1.0e-3
# constants (mod_pbl_myj.F90:49-158)
EPSQ2 = 0.2
EPS1 = 1.0e-12
EPS2 = 0.0
EPSL = 0.32
EPSRU = 1.0e-7
EPSRS = 1.0e-7
EPSTRB = 1.0e-24
FH = 1.01
ALPH = 0.30
BETA = 1.0 / 273.0
EL0MAX = 1000.0
EL0MIN = 1.0
ELFC = 0.23 * 0.5
A1 = 0.659888514560862645
AXX = 0.6574209922667784586
B1 = 11.87799326209552761
B2 = 7.226971804046074028
C1 = 0.000830955950095854396
ELZ0 = 0.0
ESQ = 5.0
SEAFC = 0.98
BTG = BETA * c.egrav
RB1 = 1.0 / B1
ADNH = 9.0 * A1 * AXX * AXX * (12.0 * A1 + 3.0 * B2) * BTG * BTG
ADNM = 18.0 * A1 * A1 * AXX * (B2 - 3.0 * AXX) * BTG
ANMH = -9.0 * A1 * AXX * AXX * BTG * BTG
ANMM = -3.0 * A1 * AXX * (3.0 * AXX + 3.0 * B2 * C1 + 18.0 * A1 * C1
                          - B2) * BTG
BDNH = 3.0 * AXX * (7.0 * A1 + B2) * BTG
BDNM = 6.0 * A1 * A1
BEQH = AXX * B1 * BTG + 3.0 * AXX * (7.0 * A1 + B2) * BTG
BEQM = -A1 * B1 * (1.0 - 3.0 * C1) + 6.0 * A1 * A1
BNMH = -AXX * BTG
BNMM = A1 * (1.0 - 3.0 * C1)
BSHH = 9.0 * A1 * AXX * AXX * BTG
BSHM = 18.0 * A1 * A1 * AXX * C1
BSMH = -3.0 * A1 * AXX * (3.0 * AXX + 3.0 * B2 * C1 + 12.0 * A1 * C1
                          - B2) * BTG
CESH = AXX
CESM = A1 * (1.0 - 3.0 * C1)
AEQH = 9.0 * A1 * AXX * AXX * B1 * BTG * BTG \
    + 9.0 * A1 * AXX * AXX * (12.0 * A1 + 3.0 * B2) * BTG * BTG
AEQM = 3.0 * A1 * AXX * B1 * (3.0 * AXX + 3.0 * B2 * C1
                              + 18.0 * A1 * C1 - B2) * BTG \
    + 18.0 * A1 * A1 * AXX * (B2 - 3.0 * AXX) * BTG
REQU = -AEQH / AEQM
EPSGH = 1.0e-9
EPSGM = REQU * EPSGH
UBRYL = (18.0 * REQU * A1 * A1 * AXX * B2 * C1 * BTG
         + 9.0 * A1 * AXX * AXX * B2 * BTG * BTG) \
    / (REQU * ADNM + ADNH)
UBRY = (1.0 + EPSRS) * UBRYL
UBRY3 = 3.0 * UBRY
AUBH = 27.0 * A1 * AXX * AXX * B2 * BTG * BTG - ADNH * UBRY3
AUBM = 54.0 * A1 * A1 * AXX * B2 * C1 * BTG - ADNM * UBRY3
BUBH = (9.0 * A1 * AXX + 3.0 * AXX * B2) * BTG - BDNH * UBRY3
BUBM = 18.0 * A1 * A1 * C1 - BDNM * UBRY3
CUBR = 1.0 - UBRY3
RCUBR = 1.0 / CUBR


class MYJOut(NamedTuple):
    uten: torch.Tensor
    vten: torch.Tensor
    tten: torch.Tensor
    qvten: torch.Tensor
    qcten: torch.Tensor
    qiten: torch.Tensor
    tkepbl: torch.Tensor    # (kz, iy, jx) updated TKE = q²/2
    kpbl: torch.Tensor
    zpbl: torch.Tensor
    thz0: torch.Tensor      # updated surface-layer state
    qz0: torch.Tensor


def _mixlen(u, v, t, the, q, cwm, q2, z, elocp):
    """Level 2.5 mixing length (mixlen, mod_pbl_myj.F90:522-651)."""
    kz = t.shape[0]
    km1 = kz - 1
    karr = torch.arange(km1, device=t.device)[:, None, None]

    # PBL top: the largest interior k with q2 <= epsq2·fh scanning up
    # from the bottom (:542-553); none: the top (0)
    low = q2[:km1] <= EPSQ2 * FH
    lpbl = torch.where(
        low.any(dim=0),
        (km1 - 1) - torch.argmax(torch.flip(low, [0]).to(torch.int32),
                                 dim=0), 0)
    zpbl = torch.gather(z, 0, (lpbl + 1)[None])[0] - z[kz]

    dth = the[:-1] - the[1:]
    rdz = 2.0 / (z[:km1] - z[2:])
    gml = ((u[:-1] - u[1:]) ** 2 + (v[:-1] - v[1:]) ** 2) * rdz * rdz
    gm = torch.clamp(gml, min=EPSGM)
    tem = 0.5 * (t[:-1] + t[1:])
    thm = 0.5 * (the[:-1] + the[1:])
    a = thm * c.ep1
    b = (elocp / tem - 1.0 - c.ep1) * thm
    ghl = (dth * ((q[:-1] + q[1:] + cwm[:-1] + cwm[1:]) * (0.5 * c.ep1)
                  + 1.0)
           + (q[:-1] - q[1:] + cwm[:-1] - cwm[1:]) * a
           + (cwm[:-1] - cwm[1:]) * b) * rdz
    gh = torch.where(torch.abs(ghl) <= EPSGH, EPSGH, ghl)

    # elm: the stability-limited mixing length (:586-608)
    stable_cap = (gh >= EPSGH) & (gm / gh <= REQU)
    aubr = (AUBM * gm + AUBH * gh) * gh
    bubr = BUBM * gm + BUBH * gh
    qol2st = (-0.5 * bubr + torch.sqrt(torch.clamp(
        bubr * bubr * 0.25 - aubr * CUBR, min=0.0))) * RCUBR
    elm_st = torch.sqrt(torch.clamp(
        q2[:km1] / torch.clamp(qol2st, min=EPS1), min=0.0))
    aden = (ADNM * gm + ADNH * gh) * gh
    bden = BDNM * gm + BDNH * gh
    qol2un = -0.5 * bden + torch.sqrt(torch.clamp(
        bden * bden * 0.25 - aden, min=0.0))
    elm_un = torch.sqrt(torch.clamp(q2[:km1] / (qol2un + EPSRU), min=0.0))
    elm = torch.where(gh >= EPSGH,
                      torch.where(stable_cap, EPSL,
                                  torch.clamp(elm_st, min=EPSL)),
                      torch.clamp(elm_un, min=EPSL))

    # Blackadar asymptotic length from the q-weighted height integral,
    # summed in level order
    kall = torch.arange(kz, device=t.device)[:, None, None]
    q1 = torch.where(kall >= lpbl[None], torch.sqrt(q2), 0.0)
    qdzl = (q1[:-1] + q1[1:]) * (z[1:kz] - z[2:])
    szq = level_sum((z[1:kz] + z[2:] - 2.0 * z[kz][None]) * qdzl)
    sq = level_sum(qdzl)
    el0 = torch.clamp(ALPH * szq * 0.5 / torch.clamp(sq, min=1e-20),
                      EL0MIN, EL0MAX)

    # the free atmosphere above the PBL top, the surface-layer blend in it
    el_above = torch.minimum((z[:km1] - z[2:]) * ELFC, elm)
    vkrmz = (z[1:kz] - z[kz][None]) * c.vonkar
    el_in = torch.minimum(vkrmz / (vkrmz / el0[None] + 1.0), elm)
    el = torch.where(karr < lpbl[None], el_above, el_in)
    rel = el / torch.clamp(elm, min=1e-20)
    # 1-2-1 smoothing inside the PBL (:647-650)
    relm = torch.cat([rel[:1], rel[:-1]], dim=0)
    relp = torch.cat([rel[1:], rel[-1:]], dim=0)
    srel = torch.minimum(((relm + relp) * 0.5 + rel) * 0.5, rel)
    smooth = (karr > lpbl[None]) & (karr <= kz - 3)
    el = torch.where(smooth, torch.clamp(srel * elm, min=EPSL), el)
    return gm, gh, el, lpbl, zpbl


def _prodq2(dt, ustar, gm, gh, el, q2):
    """TKE production and dissipation (prodq2, mod_pbl_myj.F90:655-779)."""
    aequ = (AEQM * gm + AEQH * gh) * gh
    bequ = BEQM * gm + BEQH * gh
    eqol2 = -0.5 * bequ + torch.sqrt(torch.clamp(
        bequ * bequ * 0.25 - aequ, min=0.0))
    noturb = ((gm + gh * gh <= EPSTRB)
              | ((gh >= EPSGH) & (gm / gh <= REQU))
              | (eqol2 <= EPS2))
    anum = (ANMM * gm + ANMH * gh) * gh
    bnum = BNMM * gm + BNMH * gh
    aden = (ADNM * gm + ADNH * gh) * gh
    bden = BDNM * gm + BDNH * gh
    arhs = -(anum * bden - bnum * aden) * 2.0
    brhs = -anum * 4.0
    crhs = -bnum * 2.0
    dloq1 = el / torch.sqrt(torch.clamp(q2[:-1], min=1e-20))
    eqol2s = torch.clamp(eqol2, min=EPS1)
    eloq21 = 1.0 / eqol2s
    eloq11 = torch.sqrt(eloq21)
    eloq31 = eloq21 * eloq11
    eloq41 = eloq21 * eloq21
    eloq51 = eloq21 * eloq31
    rden1 = 1.0 / (aden * eloq41 + bden * eloq21 + 1.0)
    rhsp1 = (arhs * eloq51 + brhs * eloq31 + crhs * eloq11) \
        * rden1 * rden1
    eloq12 = torch.clamp(
        eloq11 + (dloq1 - eloq11) * torch.exp(rhsp1 * dt), min=EPS1)
    eloq22 = eloq12 * eloq12
    eloq32 = eloq22 * eloq12
    eloq42 = eloq22 * eloq22
    eloq52 = eloq22 * eloq32
    rden2 = 1.0 / (aden * eloq42 + bden * eloq22 + 1.0)
    rhs2 = -(anum * eloq42 + bnum * eloq22) * rden2 + RB1
    rhsp2 = (arhs * eloq52 + brhs * eloq32 + crhs * eloq12) \
        * rden2 * rden2
    rhst2 = rhs2 / rhsp2
    eloq13 = torch.clamp(
        eloq12 - rhst2 + (rhst2 + dloq1 - eloq12) * torch.exp(rhsp2 * dt),
        min=EPS1)
    q2new = torch.clamp(el * el / (eloq13 * eloq13), min=EPSQ2)
    el_new = torch.where(q2new == EPSQ2, EPSL, el)
    q2i = torch.where(noturb, EPSQ2, q2new)
    el_i = torch.where(noturb, EPSL, el_new)
    q2out = torch.cat(
        [q2i, torch.clamp(B1 ** (2.0 / 3.0) * ustar * ustar,
                          min=EPSQ2)[None]], dim=0)
    return q2out, el_i


def _difcof(gm, gh, el, q2, z):
    """Exchange coefficients (difcof, mod_pbl_myj.F90:783-832)."""
    eloq2 = el * el / torch.clamp(q2[:-1], min=1e-20)
    eloq4 = eloq2 * eloq2
    aden = (ADNM * gm + ADNH * gh) * gh
    bden = BDNM * gm + BDNH * gh
    besm = BSMH * gh
    besh = BSHM * gm + BSHH * gh
    rden = 1.0 / (aden * eloq4 + bden * eloq2 + 1.0)
    esm = (besm * eloq2 + CESM) * rden
    esh = (besh * eloq2 + CESH) * rden
    rdz = 2.0 / (z[:-2] - z[2:])
    elqdz = el * torch.sqrt(torch.clamp(q2[:-1], min=0.0)) * rdz
    return elqdz * esm, elqdz * esh


def _vdifq(dt, q2, el, z):
    """Implicit TKE diffusion (vdifq, mod_pbl_myj.F90:836-877)."""
    kz = q2.shape[0]
    km2 = kz - 2
    dtoz = 2.0 * dt / (z[:km2] - z[2:kz])
    akq = torch.sqrt(0.5 * (q2[:km2] + q2[1:km2 + 1])) \
        * (el[:km2] + el[1:km2 + 1]) * (0.5 * ESQ) \
        / (z[1:km2 + 1] - z[2:kz])
    cr = -dtoz * akq
    cm = [dtoz[0] * akq[0] + 1.0]
    rs = [q2[0]]
    for k in range(1, km2):
        cf = -dtoz[k] * akq[k - 1] / cm[-1]
        cm.append(-cr[k - 1] * cf + (akq[k - 1] + akq[k]) * dtoz[k] + 1.0)
        rs.append(-rs[-1] * cf + q2[k])

    # the reference's dtozs spans zhk(kzm1)-zhk(kzp1): the two lowest
    # layers
    dtozs = 2.0 * dt / (z[kz - 2] - z[kz])
    akqs = torch.sqrt(0.5 * (q2[kz - 2] + q2[kz - 1])) \
        * (el[kz - 2] + ELZ0) * (0.5 * ESQ) / (z[kz - 1] - z[kz])
    cf = -dtozs * akq[km2 - 1] / cm[km2 - 1]
    q2_bot = (dtozs * akqs * q2[kz - 1] - rs[km2 - 1] * cf
              + q2[kz - 2]) / ((akq[km2 - 1] + akqs) * dtozs
                               - cr[km2 - 1] * cf + 1.0)
    out = [q2_bot]
    for k in range(km2 - 1, -1, -1):
        out.append((-cr[k] * out[-1] + rs[k]) / cm[k])
    return torch.cat([torch.stack(out[::-1]), q2[kz - 1:]], dim=0)


def _vdifh(dt, sz0_list, rkhs_dens, clow_list, species, rkh, zhk, rho):
    """Implicit ρ-weighted scalar diffusion (vdifh,
    mod_pbl_myj.F90:881-948); ct=0, so the counter-gradient terms
    vanish. species: list of (kz, iy, jx); sz0/clow the per-species
    surface values."""
    kz = species[0].shape[0]
    km1 = kz - 1
    dtoz = dt / (zhk[:km1] - zhk[1:kz])
    cr = -dtoz * rkh
    cm = [dtoz[0] * rkh[0] + rho[0]]
    rs = [[s[0] * rho[0]] for s in species]
    for k in range(1, km1):
        cf = -dtoz[k] * rkh[k - 1] / cm[-1]
        cm.append(-cr[k - 1] * cf + (rkh[k - 1] + rkh[k]) * dtoz[k]
                  + rho[k])
        for r, s in zip(rs, species):
            r.append(-r[-1] * cf + s[k] * rho[k])

    dtozs = dt / (zhk[kz - 1] - zhk[kz])
    rkhh = rkh[km1 - 1]
    cf = -dtozs * rkhh / cm[km1 - 1]
    cmb = cr[km1 - 1] * cf
    outs = []
    for r, s, sz0, cl in zip(rs, species, sz0_list, clow_list):
        rkss = rkhs_dens * cl
        cmsb = -cmb + (rkhh + rkss) * dtozs + rho[kz - 1]
        rssb = -r[km1 - 1] * cf + s[kz - 1] * rho[kz - 1]
        col = [(dtozs * rkss * sz0 + rssb) / cmsb]
        for k in range(km1 - 1, -1, -1):
            col.append((-cr[k] * col[-1] + r[k]) / cm[k])
        outs.append(torch.stack(col[::-1]))
    return outs


def _vdifv(dt, uz0, vz0, rkms_dens, u, v, rkm, z, rho):
    """Implicit momentum diffusion (vdifv, mod_pbl_myj.F90:952-996)."""
    kz = u.shape[0]
    km1 = kz - 1
    dtoz = dt / (z[:km1] - z[1:kz])
    cr = -dtoz * rkm
    cm = [dtoz[0] * rkm[0] + rho[0]]
    ru = [u[0] * rho[0]]
    rv = [v[0] * rho[0]]
    for k in range(1, km1):
        cf = -dtoz[k] * rkm[k - 1] / cm[-1]
        cm.append(-cr[k - 1] * cf + (rkm[k - 1] + rkm[k]) * dtoz[k]
                  + rho[k])
        ru.append(-ru[-1] * cf + u[k] * rho[k])
        rv.append(-rv[-1] * cf + v[k] * rho[k])

    dtozs = dt / (z[kz - 1] - z[kz])
    rkmh = rkm[km1 - 1]
    cf = -dtozs * rkmh / cm[km1 - 1]
    rcmvb = 1.0 / ((rkmh + rkms_dens) * dtozs - cr[km1 - 1] * cf
                   + rho[kz - 1])
    dtozak = dtozs * rkms_dens
    uc = [(dtozak * uz0 - ru[km1 - 1] * cf + u[kz - 1] * rho[kz - 1])
          * rcmvb]
    vc = [(dtozak * vz0 - rv[km1 - 1] * cf + v[kz - 1] * rho[kz - 1])
          * rcmvb]
    for k in range(km1 - 1, -1, -1):
        uc.append((-cr[k] * uc[-1] + ru[k]) / cm[k])
        vc.append((-cr[k] * vc[-1] + rv[k]) / cm[k])
    return torch.stack(uc[::-1]), torch.stack(vc[::-1])


def myjpbl(t, qv, qc, qi, u, v, zq, ht, patm, patmf, tke, tg, q2m,
           uvdrag, lndmsk, thz0, qz0, dt, five_species: bool = False,
           first: bool = False):
    """One MYJ PBL step over the whole grid (myjpbl,
    mod_pbl_myj.F90:177-518). qv/qc/qi are mixing ratios; tke the
    (kz, …) PBL TKE (q²/2); thz0/qz0 the persistent surface-layer state.
    Returns the uncoupled tendencies (MYJOut)."""
    kz = t.shape[0]
    elocp = c.wlhv / c.cpd          # eliwv/cpd (reference elocp)
    rdt = 1.0 / dt

    zint = zq + (ht * c.regrav)[None]
    exner = (patm / c.stdp) ** c.rovcp
    ape = 1.0 / exner
    th = t * ape
    cwm = qc + qi if five_species else qc + 0.0
    the = (cwm * (-elocp / t) + 1.0) * th
    qk = qv / (1.0 + qv)                     # specific humidity
    q2 = 2.0 * torch.clamp(tke, min=MYJTKEMIN)

    rho = patm / (c.rgas * t * (1.0 + c.ep1 * qk - cwm))
    rhoxsf = patmf[kz] / (c.rgas * t[kz - 1])
    akms = uvdrag / rhoxsf
    akhs = akms
    spd = torch.sqrt(u[kz - 1] ** 2 + v[kz - 1] ** 2)
    ustar = torch.clamp(torch.sqrt(uvdrag * spd / rhoxsf), min=0.07)

    gm, gh, el, lpbl, zpbl = _mixlen(u, v, t, the, qk, cwm, q2, zint,
                                     elocp)
    q2, el = _prodq2(dt, ustar, gm, gh, el, q2)
    akm, akh = _difcof(gm, gh, el, q2, zint)
    q2 = _vdifq(dt, q2, el, zint)
    q2 = torch.clamp(q2, min=EPSQ2)
    tke_new = 0.5 * q2

    # surface-layer state (:351-434)
    psfc = patmf[kz]
    rexnsfc = (c.stdp / psfc) ** c.rovcp
    thsk = tg * rexnsfc
    tha = t[kz - 1] * ape[kz - 1]
    qsfc_lnd = q2m / (1.0 + q2m)
    qsfc_ocn = SEAFC * pfqsat(tg, psfc)
    # land relaxes toward the lowest layer's theta; the first step sets
    # instead of blending (:362-368)
    blend = (lambda old, new: new) if first \
        else (lambda old, new: 0.5 * (old + new))
    land = lndmsk > 0.5
    thz0_new = torch.where(land, blend(thz0, tha), thsk)
    qz0_new = torch.where(land, blend(qz0, qsfc_lnd), qsfc_ocn)
    zero = torch.zeros_like(tg)

    # scalar diffusion (:436-483)
    akh_dens = akh * 0.5 * (rho[:-1] + rho[1:])
    akhs_dens = akhs * rho[kz - 1]
    extra = [qi] if five_species else []
    species = [the, qk, qc] + extra
    sz0 = [thz0_new, qz0_new, zero] + [zero] * len(extra)
    clow = [torch.ones_like(tg), torch.full_like(tg, c.minqq), zero] \
        + [zero] * len(extra)
    outs = _vdifh(dt, sz0, akhs_dens, clow, species, akh_dens, zint, rho)
    the_n, qk_n, qc_n = outs[0], outs[1], outs[2]
    qi_n = outs[3] if five_species else qi
    cwm_n = qc_n + qi_n if five_species else qc_n + 0.0

    thnew = the_n + cwm_n * elocp * ape
    tten = (thnew - th) * rdt * exner
    dqdt = (qk_n - qk) * rdt
    qvten = dqdt / (1.0 - qk_n) ** 2
    qcten = (qc_n - qc) * rdt
    qiten = (qi_n - qi) * rdt if five_species else torch.zeros_like(qc)

    # momentum diffusion (:488-509)
    akm_dens = akm * 0.5 * (rho[:-1] + rho[1:])
    akms_dens = akms * rho[kz - 1]
    u_n, v_n = _vdifv(dt, zero, zero, akms_dens, u, v, akm_dens, zint,
                      rho)
    return MYJOut(
        uten=(u_n - u) * rdt, vten=(v_n - v) * rdt,
        tten=tten, qvten=qvten, qcten=qcten, qiten=qiten,
        tkepbl=tke_new, kpbl=lpbl, zpbl=zpbl,
        thz0=thz0_new, qz0=qz0_new)

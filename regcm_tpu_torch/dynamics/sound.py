"""MM5-type non-hydrostatic extensions (idynamic=2), torch twin of
``regcm_tpu/dynamics/sound.py``.

``NHBaseState``/``make_base_state``: the constant reference atmosphere
``atm0`` (``Share/mod_nhinterp.F90`` base state), built with numpy on the
whole grid; ``HydroCore`` turns it into tensors and, under a mesh, cuts it
to the rank's block.

``sound``: the semi-implicit acoustic solver of ``Main/mod_sound.F90``
(``sound`` :163-718): ``istep = max(int(2·dtsec/dtsmax), 4)`` substeps
of the forward u/v update and the Ikawa vertically implicit (β-off-
centred) tridiagonal solve for w and pp, with the dp'/dt heating of T.
The column sweeps are loops over levels on (y, x) planes. The terms that
do not change from one substep to the next (the tridiagonal matrix, its
upward-sweep factors, the radiative top's response) are formed once a
call.

With ``ifupr=1`` the Klemp-Durran radiative top reads the whole top
plane: the mean response coefficients are sums over every interior
point, and the top w is a 13x13 window over the edge-replicated top
field. Under a mesh both keep the single domain's order of operations:
the two planes are gathered and summed whole on every rank, and the
window is 169 multiply-adds in a fixed order over a block extended by a
6-wide halo, so a decomposed run stays bit-identical to one rank.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils import constants as c
from . import stencil
from .stencil import cross2dot, halo_pad, shift

XGAMMA = 1.0 / (1.0 - c.rovcp)       # cp/cv


class NHBaseState(NamedTuple):
    """atm0: the time-constant NH reference atmosphere (SI; ps0 in cb
    like the prognostic coupling). numpy arrays of the whole grid from
    ``make_base_state``; tensors of the rank's block in ``HydroCore``."""
    ps0: object      # reference p* = ps0_surface - ptop (cb), (iy, jx)
    psfull: object   # reference surface pressure (Pa)
    pr0: object      # reference pressure at half levels (Pa)
    pf0: object      # at interfaces (Pa), (kz+1, ...)
    t0: object       # reference temperature (K)
    rho0: object     # reference density
    rhof0: object    # at interfaces
    dprddx: object   # 4-point base-pressure x-difference at dot (Pa)
    dprddy: object
    dpsdxm: object   # (dps0/dx)/(ps0·8dx·msfx) (1/m), (iy, jx)
    dpsdym: object


def make_base_state(grid, ptop_cb: float, base_ps_pa: float = 101325.0,
                    logp_lrate: float = 47.70) -> NHBaseState:
    """Reference atmosphere on sigma levels (mod_nhinterp base state),
    float64 numpy on the whole grid: T0(p) = stdt + logp_lrate·log(p/p00)
    capped at tiso; surface pressure from the terrain by hydrostatic
    integration of that profile."""
    z = np.asarray(grid.ht) / c.egrav
    p = np.full(z.shape, base_ps_pa)
    for _ in range(8):
        t_here = np.maximum(c.stdt + logp_lrate * np.log(p / base_ps_pa),
                            c.tiso)
        tbar = 0.5 * (c.stdt + t_here)
        p = base_ps_pa * np.exp(-c.egrav * z / (c.rgas * tbar))
    psfull = p
    ps0 = (p - ptop_cb * 1000.0) / 1000.0
    sig = np.asarray(grid.hsigma)[:, None, None]
    sigf = np.asarray(grid.sigma)[:, None, None]
    pr0 = sig * (psfull - ptop_cb * 1000.0)[None] + ptop_cb * 1000.0
    pf0 = sigf * (psfull - ptop_cb * 1000.0)[None] + ptop_cb * 1000.0
    t0 = np.maximum(c.stdt + logp_lrate * np.log(pr0 / base_ps_pa), c.tiso)
    t0f = np.maximum(c.stdt + logp_lrate * np.log(
        np.maximum(pf0, 100.0) / base_ps_pa), c.tiso)
    rho0 = pr0 / (c.rgas * t0)
    rhof0 = pf0 / (c.rgas * t0f)
    # dot-point 4-point differences of pr0, zero on the first row and
    # column
    a = pr0
    dprddx = (a + np.roll(a, 1, axis=1) - np.roll(a, 1, axis=2)
              - np.roll(np.roll(a, 1, axis=1), 1, axis=2))
    dprddx[:, :, 0] = 0.0
    dprddx[:, 0, :] = 0.0
    dprddy = (a + np.roll(a, 1, axis=2) - np.roll(a, 1, axis=1)
              - np.roll(np.roll(a, 1, axis=1), 1, axis=2))
    dprddy[:, :, 0] = 0.0
    dprddy[:, 0, :] = 0.0
    # dpsdxm/dpsdym (mod_params.F90:2640-2673): centred ps0 gradient
    # / (ps0·8dx·msfx), zero on the outer rows and columns
    msfx = np.asarray(grid.msfx)
    dx8 = 8.0 * grid.ds
    dpsdxm = (np.roll(psfull, -1, axis=1) - np.roll(psfull, 1, axis=1)) \
        / (psfull * dx8 * msfx)
    dpsdym = (np.roll(psfull, -1, axis=0) - np.roll(psfull, 1, axis=0)) \
        / (psfull * dx8 * msfx)
    dpsdxm[:, 0] = dpsdxm[:, -1] = 0.0
    dpsdym[0, :] = dpsdym[-1, :] = 0.0
    return NHBaseState(ps0=ps0, psfull=psfull, pr0=pr0, pf0=pf0, t0=t0,
                       rho0=rho0, rhof0=rhof0, dprddx=dprddx, dprddy=dprddy,
                       dpsdxm=dpsdxm, dpsdym=dpsdym)


def upper_radiation_tables(msfx, dx: float):
    """The Klemp-Durran radiative top's constant tables (init_sound,
    Main/mod_sound.F90:103-140), float64 numpy: the (13, 13, 7, 7)
    spectral-to-window geometry and the (7, 7) effective wavenumbers, from
    the mean map factor of the whole grid's interior."""
    fi = np.ones(13)
    fi[0] = fi[12] = 0.5
    fk = np.full(7, 2.0)
    fk[0] = fk[6] = 1.0
    ii = np.arange(-6, 7)
    kkv = np.arange(7)
    geom = (fi[:, None, None, None] * fi[None, :, None, None]
            * fk[None, None, :, None] * fk[None, None, None, :] / 144.0
            * np.cos(2.0 * np.pi * kkv[None, None, :, None]
                     * ii[:, None, None, None] / 12.0)
            * np.cos(2.0 * np.pi * kkv[None, None, None, :]
                     * ii[None, :, None, None] / 12.0))
    xmsf = float(np.mean(np.asarray(msfx)[1:-1, 1:-1]))
    dxmsfb = 2.0 / (dx * dx) / xmsf
    xkeff = dxmsfb * np.sin(np.pi * kkv[:, None] / 12.0) \
        * np.cos(np.pi * kkv[None, :] / 12.0)
    xleff = dxmsfb * np.sin(np.pi * kkv[None, :] / 12.0) \
        * np.cos(np.pi * kkv[:, None] / 12.0)
    return geom, np.sqrt(xkeff ** 2 + xleff ** 2)


def _whole_sums(planes):
    """Σ over the whole domain of each (y, x) plane of ``planes``
    (n, ly, lx): the rank's blocks are gathered and every rank sums the
    whole planes, so the order of summation is the single domain's."""
    m = stencil.mesh()
    if m is not None:
        planes = m.gather(planes)
    return [torch.sum(p) for p in planes]


def _up(a):
    """a[k-1] at level k (level 0 repeated)."""
    return torch.cat([a[:1], a[:-1]], dim=0)


def _dn(a):
    """a[k+1] at level k (the last level repeated)."""
    return torch.cat([a[1:], a[-1:]], dim=0)


def sound(core, base: NHBaseState, s, uten, vten, ppten, wten,
          tdec_b, qv_b_dec, dt):
    """Acoustic substep integration (Main/mod_sound.F90:163-718).

    core: HydroCore (masks, metrics, the radiative top's tables); base:
    its NHBaseState of tensors; s: HydroState (b-level inputs, the
    a-level T adjusted); *ten: the long step's total coupled tendencies.
    Returns (u_c, v_c, pp_c, w_c, t_a_new, t_b_new), the c-level fields
    COUPLED (×psdotb / ×psb) for the caller's Asselin filter."""
    kz = core.kz
    bet = core.cfg.nonhydro.nhbet
    xkd = core.cfg.nonhydro.nhxkd
    ifupr = int(core.cfg.nonhydro.ifupr)
    bp = 0.5 * (1.0 + bet)
    bm = 0.5 * (1.0 - bet)
    bpxbp = bp * bp
    bpxbm = bp * bm
    cs = float(np.sqrt(XGAMMA * c.rgas * 300.0))
    dtsmax = core.dx / cs / (1.0 + xkd)
    istep = max(int(core.dtsec * 2.0 / dtsmax), 4)
    dts = dt / istep

    psb = s.ps_b
    rpsb = 1.0 / psb
    psdotb = cross2dot(psb)
    m_ci = core.m_ci
    m_di = core.m_di
    msfd = core.msfd
    msfx = core.msfx
    dsig = core.dsig3
    pr0 = base.pr0
    rho0 = base.rho0
    t0 = base.t0
    ps0pa = base.psfull - core.ptop * 1000.0     # reference p* in Pa

    # decoupled short-step prognostics
    u = s.u_b / psdotb[None]
    v = s.v_b / psdotb[None]
    pp = s.pp_b * rpsb[None]
    w = s.w_b * rpsb[None]
    qvd = s.qx_b[0] * rpsb[None]
    t_a = s.t_a
    t_b = s.t_b
    # actual pressure and density at time level 1 (atm1 through b here)
    pr1 = pr0 + pp
    tv1 = torch.clamp(tdec_b, min=100.0) * (1.0 + c.ep1 * qv_b_dec)
    rho1 = pr1 / (c.rgas * tv1)

    uten_d = uten * dts
    vten_d = vten * dts
    ppten_d = ppten * rpsb[None] * dts
    wten_d = wten * rpsb[None] * dts

    # -- terms that hold for every substep
    p0_up = _up(pr0)
    p0_dn = _dn(pr0)
    rho_d = 0.25 * (rho1 + shift(rho1, 0, -1) + shift(rho1, -1, 0)
                    + shift(rho1, -1, -1))
    chh = 0.5 * dts / (torch.clamp(rho_d, min=1e-3) * core.dx) / msfd[None]
    cc = XGAMMA * pr1 * dts / (core.dx * msfx[None])
    cdd = XGAMMA * pr1 * rho0 * c.egrav * dts / (ps0pa[None] * dsig)
    cj = 0.5 * rho0 * c.egrav * dts
    dp0x = shift(pr0, 0, 1) - shift(pr0, 0, -1)
    dp0y = shift(pr0, 1, 0) - shift(pr0, -1, 0)
    tk = (0.5 * ps0pa[None] * t0) / (XGAMMA * pr0
                                     * torch.clamp(tdec_b, min=100.0))
    rofac_i = (dsig[:-1] * rho0[1:] + dsig[1:] * rho0[:-1]) \
        / (dsig[:-1] * rho1[1:] + dsig[1:] * rho1[:-1])
    ca = c.egrav * dts / (pr0[1:] - pr0[:-1]) * rofac_i
    g1 = 1.0 - dsig[:-1] * tk[1:]
    g2 = 1.0 + dsig[1:] * tk[:-1]
    cdd_up, cdd_dn = cdd[:-1], cdd[1:]
    cj_up, cj_dn = cj[:-1], cj[1:]
    Cm = -ca * (cdd_up - cj_up) * g2 * bpxbp           # couples w[K-1]
    Bm = 1.0 + ca * (g1 * (cdd_dn - cj_dn)
                     + g2 * (cdd_up + cj_up)) * bpxbp
    Am = -ca * (cdd_dn + cj_dn) * g1 * bpxbp           # couples w[K+1]
    dhx = shift(core.ht, 0, 1) - shift(core.ht, 0, -1)
    dhy = shift(core.ht, 1, 0) - shift(core.ht, -1, 0)
    # upward sweep's factors: e[k] for k = kz-2 .. 0 from e[kz-1] = 0
    e = [None] * kz
    den = [None] * kz
    e[kz - 1] = torch.zeros_like(psb)
    for K in range(kz - 1, 0, -1):
        i = K - 1
        den[i] = Am[i] * e[K] + Bm[i]
        e[i] = -Cm[i] / den[i]
    from .hydrostatic import cpmf
    cpm = cpmf(torch.clamp(qvd, min=0.0))
    heat = psb[None] / (cpm * rho1) * m_ci
    if ifupr == 1:
        # Klemp-Durran radiative top (mod_sound.F90:486-562): the
        # window's weights from the domain-mean response coefficients
        denom1 = (cdd[0] + cj[0]) * bp
        astore = denom1 * e[0] + (cj[0] - cdd[0]) * bp
        ensq = c.egrav * c.egrav / c.cpd / torch.clamp(tdec_b[0], min=100.0)
        asum, rsum = _whole_sums(torch.stack(
            [astore * m_ci, rho1[0] * torch.sqrt(ensq) * m_ci]))
        abar = asum / core.upr_npts
        rhon = rsum / core.upr_npts
        resp = core.upr_xkleff / (rhon - abar * core.upr_xkleff)
        tmask = (core.upr_geom * resp).sum(dim=(-2, -1))
        weights = [[tmask[a, b] for b in range(13)] for a in range(13)]

    pi_corr = torch.zeros_like(pp)
    ly, lx = psb.shape
    for it in range(istep):
        pp_eff = pp + xkd * pi_corr if it > 0 else pp
        # dpp/dp0 proxy (atmc%t in the reference, :263-269)
        dppdp0 = (_up(pp_eff) - _dn(pp_eff)) / (p0_up - p0_dn)

        # advance u, v (:276-311)
        dppdp0_d = 0.25 * (dppdp0 + shift(dppdp0, 0, -1)
                           + shift(dppdp0, -1, 0) + shift(dppdp0, -1, -1))
        dppx = (pp_eff + shift(pp_eff, -1, 0) - shift(pp_eff, 0, -1)
                - shift(pp_eff, -1, -1))
        dppy = (pp_eff + shift(pp_eff, 0, -1) - shift(pp_eff, -1, 0)
                - shift(pp_eff, -1, -1))
        u = u + (-chh * (dppx - base.dprddx * dppdp0_d)
                 + uten_d / psdotb[None]) * m_di
        v = v + (-chh * (dppy - base.dprddy * dppdp0_d)
                 + vten_d / psdotb[None]) * m_di

        # divergence-driven pp tendency (:340-440)
        vmsf = v * msfd[None]
        umsf = u * msfd[None]
        divd = ((shift(vmsf, 1, 1) + shift(vmsf, 1, 0)
                 - shift(vmsf, 0, 1) - vmsf)
                + (shift(umsf, 1, 1) + shift(umsf, 0, 1)
                   - shift(umsf, 1, 0) - umsf)) / msfx[None]
        # slant-flow terms pxup/pyvp (:352-415)
        u4 = u + shift(u, 0, 1) + shift(u, 1, 0) + shift(u, 1, 1)
        v4 = v + shift(v, 0, 1) + shift(v, 1, 0) + shift(v, 1, 1)
        pxup = 0.125 * dp0x * (_up(u4) - _dn(u4)) / (p0_up - p0_dn)
        pyvp = 0.125 * dp0y * (_up(v4) - _dn(v4)) / (p0_up - p0_dn)
        ptend = ppten_d - 0.5 * cc * (divd - 2.0 * (pxup + pyvp))

        # implicit w (Ikawa; :380-470): interfaces K = 1..kz-1
        wo = w
        rhs = (w[1:kz] + wten_d[1:kz]
               + ca * (bpxbm * ((cdd_up - cj_up) * g2 * wo[:kz - 1]
                                - ((cdd_up + cj_up) * g2
                                   + (cdd_dn - cj_dn) * g1) * wo[1:kz]
                                + (cdd_dn + cj_dn) * g1 * wo[2:])
                       + (pp[1:] * g1 - pp[:-1] * g2)
                       + (g1 * ptend[1:] - g2 * ptend[:-1]) * bp))
        # explicit pp partial update (:457-466)
        pi_old = pp
        pp = pp + ptend + (cj * (wo[1:] + wo[:-1])
                           + cdd * (wo[1:] - wo[:-1])) * bm

        # surface w from the flow over the terrain (:330-340)
        uk, vk = u[kz - 1], v[kz - 1]
        u4k = uk + shift(uk, 0, 1) + shift(uk, 1, 0) + shift(uk, 1, 1)
        v4k = vk + shift(vk, 0, 1) + shift(vk, 1, 0) + shift(vk, 1, 1)
        w_sfc = 0.5 * 0.25 * c.regrav * (v4k * dhy + u4k * dhx) \
            / (core.dx * msfx)

        # tridiagonal sweep: upward (:470-480), then downward
        fe = [None] * kz
        fe[kz - 1] = w_sfc
        for K in range(kz - 1, 0, -1):
            i = K - 1
            fe[i] = (rhs[i] - fe[K] * Am[i]) / den[i]

        # top boundary: w[0] = 0 rigid lid (ifupr=0) or the radiative
        # condition: the 13x13 window over the edge-replicated estore
        if ifupr == 1:
            estore = (pp[0] + fe[0] * denom1) * m_ci
            ep = halo_pad(estore, 6, wrap=False)
            w_top = torch.zeros_like(estore)
            for a in range(13):
                for b in range(13):
                    w_top = w_top + ep[a:a + ly, b:b + lx] * weights[a][b]
            w_top = w_top * m_ci
        else:
            w_top = torch.zeros_like(w_sfc)
        wl = [w_top]
        for k in range(kz):
            wl.append(e[k] * wl[-1] + fe[k])
        w = torch.stack(wl)

        # new pressure (:640-668) and the dp'/dt temperature correction
        dpp = (cj * (w[1:] + w[:-1]) + cdd * (w[1:] - w[:-1])) * bp
        pp = pp + dpp
        pi_corr = pp - pi_old - ppten_d
        dpterm = (pp - pi_old) * heat
        t_b = t_b + core.gnu1 * dpterm
        t_a = t_a + dpterm

    u_c = u * psdotb[None]
    v_c = v * psdotb[None]
    pp_c = pp * psb[None]
    w_c = torch.where(torch.abs(w) < c.dlowval, 0.0, w) * psb[None]
    return u_c, v_c, pp_c, w_c, t_a, t_b

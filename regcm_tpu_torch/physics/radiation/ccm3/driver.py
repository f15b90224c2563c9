"""CCM3 radiation driver (``colmod3``/``radctl``), torch twin of
``regcm_tpu/physics/radiation/ccm3/driver.py``.

Builds the column inputs from the physics slice (cloud particle sizes,
cloud emissivity, ozone profile, trace-gas mixing ratios), runs the SW
delta-Eddington and LW absorptivity/emissivity solvers, and returns MKS
heating rates and surface/TOA fluxes; with chemistry's aerosol direct
effect (``aermmr``/``aertab``) the aerosol optical depths join the SW
delta-Eddington and the grey dust transmission the LW absorptivities.
References:
``Main/radlib/mod_rad_colmod3.F90:207-795``,
``mod_rad_radiation.F90:879-1089``, ``mod_rad_o3blk.F90:108-138``.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ....chem.optics import (FIVEOTHREE, QABSLW_DUST, lw_dust_path,
                             sw_aerosol_mixture)
from . import tables as tb

from . import lw as lwmod
from .sw import radcsw

KABSL = 0.090361           # longwave liquid absorption coeff (m²/g)
REIMAX = 30.0
RIRNGE = 20.0
PIRNGE = 0.4
PICEMN = 0.4
MINUS10 = 263.15
CFTOTMAX = 1.0


class RadResult(NamedTuple):
    heatrt: torch.Tensor     # qrs+qrl (K/s), (kz, iy, jx)
    swabs_sfc: torch.Tensor  # fsns (W/m²)
    lwnet_sfc: torch.Tensor  # net downward LW at the surface (W/m²)
    flwds: torch.Tensor      # surface downward LW (W/m²)
    flns: torch.Tensor       # surface net upward LW (W/m²)
    fsds: torch.Tensor       # surface downward SW (W/m²)
    solin: torch.Tensor      # TOA incident (W/m²)
    fsnt: torch.Tensor       # TOA net SW absorbed (W/m²)
    flnt: torch.Tensor       # TOA net LW outgoing (W/m²)
    fsntc: torch.Tensor
    flntc: torch.Tensor
    sols: torch.Tensor
    soll: torch.Tensor
    solsd: torch.Tensor
    solld: torch.Tensor
    totcf: torch.Tensor      # total cloud fraction (max-random)


def o3prof_interfaces(pf_pa):
    """Ozone vmr on model interfaces from the annual climatology
    (o3data → intlinprof; mod_rad_o3blk.F90:108-138): linear-in-p
    interpolation with end clamping."""
    o3ann, pp = tb.o3_annual_profile()     # ordered surface → top
    f = lambda a: torch.as_tensor(a[::-1].copy(), dtype=pf_pa.dtype,
                                  device=pf_pa.device)
    o3r, ppr = f(o3ann), f(pp)             # ascending pressure
    i = torch.clamp(torch.searchsorted(ppr, pf_pa.contiguous()) - 1, 0, 29)
    w = torch.clamp((pf_pa - ppr[i]) / (ppr[i + 1] - ppr[i]), 0.0, 1.0)
    return o3r[i] + w * (o3r[i + 1] - o3r[i])


def _columns(fn, args3, args2, argsc, col_chunk):
    """Run ``fn`` on column chunks of at most ``col_chunk`` columns and
    reassemble (the reference bounds its (ncol, kz+1, kz+1) arrays by
    the per-rank patch size the same way)."""
    kz, iy, jx = args3[0].shape
    ncol = iy * jx
    flat3 = [a.reshape(a.shape[0], ncol) for a in args3]
    flat2 = [a.reshape(ncol) for a in args2]
    flatc = [a.reshape(a.shape[0], ncol) for a in argsc]
    parts = []
    for lo in range(0, ncol, col_chunk):
        hi = min(lo + col_chunk, ncol)
        cut3 = [a[:, lo:hi, None] for a in flat3]
        cut2 = [a[lo:hi, None] for a in flat2]
        cutc = [a[:, lo:hi, None] for a in flatc]
        parts.append(fn(cut3, cut2, cutc))
    res = RadResult(*(torch.cat([p[0][n].reshape(p[0][n].shape[:-2] + (-1,))
                                 for p in parts], dim=-1)
                      .reshape(p0.shape[:-2] + (iy, jx))
                      for n, p0 in enumerate(parts[0][0])))
    cache = None
    if parts[0][1] is not None:
        cache = {k: torch.cat([p[1][k][:, :, 0] for p in parts], dim=1)
                 .reshape(-1, iy, jx) for k in parts[0][1]}
    return res, cache


def ccm3_radiation(tb3, qvb3, qcb3, qib3, pb3, pf3, rhb3, dzq,
                   cldfrc, cldlwc, coszrs, tg, lndocn, xlat,
                   aldirs, aldifs, aldirl, aldifl, albvs, albvl,
                   emiss, ghg, eccf=1.0, solcon=1367.0,
                   five_species=False, col_chunk=16384,
                   cache=None, want_cache=False, aermmr=None, aertab=None):
    """Full CCM3 column radiation on a (kz, iy, jx) grid slice.

    cldlwc g/m³ in-cloud, dzq layer thickness (m), pb3/pf3 Pa, ghg the
    dict of ``tables.ghg_mmr``. Returns ``(RadResult, cache_out)`` in MKS.

    cache/want_cache: the ``getabetot`` dtabem amortisation
    (Main/mod_rad_interface.F90:62-65). With ``cache`` (abstot
    ((kz+1)², iy, jx), absnxt (4·kz, iy, jx), emstot (kz+1, iy, jx)) the
    LW absorptivity/emissivity build is skipped; ``want_cache`` returns
    the freshly built tensors in that layout (the cache always holds the
    gas-only tensors: the aerosol modification is applied per call).

    aermmr (ntr, kz, iy, jx) decoupled mixing ratios and aertab
    (``chem.optics.AerosolOptics``): the aerosol direct effect, the
    aeroppt external mixture in the SW and the grey dust LW transmission
    applied to abstot/absnxt/emstot as radclw does with aertrlw
    (mod_rad_radiation.F90:2007-2015)."""
    kz, iy, jx = tb3.shape
    ncol = iy * jx
    if col_chunk and ncol > col_chunk:
        ckeys = ("abstot", "absnxt", "emstot")

        ntr_a = 0 if aermmr is None else aermmr.shape[0]

        def one(a3, a2, ac):
            am = None
            if aermmr is not None:       # the last of ac, (ntr·kz, n, 1)
                am = ac[-1].reshape(ntr_a, kz, -1, 1)
                ac = ac[:-1]
            ch = dict(zip(ckeys, ac)) if cache is not None else None
            return ccm3_radiation(*a3, *a2, ghg, eccf=eccf, solcon=solcon,
                                  five_species=five_species, col_chunk=0,
                                  cache=ch, want_cache=want_cache,
                                  aermmr=am, aertab=aertab)
        argsc = [cache[k] for k in ckeys] if cache is not None else []
        if aermmr is not None:
            argsc.append(aermmr.reshape(ntr_a * kz, iy, jx))
        return _columns(one, (tb3, qvb3, qcb3, qib3, pb3, pf3, rhb3, dzq,
                              cldfrc, cldlwc),
                        (coszrs, tg, lndocn, xlat, aldirs, aldifs, aldirl,
                         aldifl, albvs, albvl, emiss), argsc, col_chunk)
    col = lambda a: a.reshape(kz, ncol).T          # (ncol, kz) top-down
    coli = lambda a: a.reshape(kz + 1, ncol).T
    c2 = lambda a: a.reshape(ncol)
    dev = tb3.device

    t = col(tb3)
    q = torch.clamp(col(qvb3), min=1.0e-9)
    ql = col(qcb3)
    qi = col(qib3) if five_species else torch.zeros_like(ql)
    pmid = col(pb3) * 10.0                         # dynes/cm²
    pint = coli(pf3) * 10.0
    pmln = torch.log(pmid)
    piln = torch.log(pint)
    ps = pint[:, -1]

    # cloud fraction with maximum-random overlap of adjacent layers
    # (colmod3 :528-551), masked outside [kmaxcld, kz-ncld]
    cfrc = col(cldfrc)
    clwp = col(cldlwc) * col(dzq)                  # g/m²
    karr = torch.arange(kz, device=dev)[None, :]
    inwin = (karr >= 2) & (karr <= kz - 2)
    clwp = torch.where(inwin, clwp, 0.0)
    cfrc_km1 = torch.cat([cfrc[:, :1], cfrc[:, :-1]], dim=1)
    cld = torch.where((clwp > 0.0) & inwin,
                      torch.clamp(cfrc_km1 + cfrc - cfrc_km1 * cfrc,
                                  max=CFTOTMAX), 0.0)

    # cloud drop sizes (colmod3 :600-640)
    land = c2(lndocn) > 0.5
    rel = torch.where(land[:, None], t.new_tensor(8.5), 11.0) \
        * torch.ones_like(t)
    weight = torch.clamp((pmid / ps[:, None] - PICEMN) / PIRNGE, 0.0, 1.0)
    rei = REIMAX - RIRNGE * weight
    if five_species:
        fice = torch.where(qi > 1.0e-11, qi / (ql + qi), 0.0)
    else:
        fice = torch.clamp((MINUS10 - t) / 20.0, 0.0, 1.0)
    # cloud emissivity → effective cloud (colmod3 :700-712)
    kabs = KABSL * (1.0 - fice) + (0.005 + 1.0 / rei) * fice
    emis = 1.0 - torch.exp(-torch.clamp(1.66 * kabs * clwp, max=25.0))
    effcld_lay = cld * emis

    # ozone profile on interfaces → layer vmr (colmod3 :569-576)
    o3_int = o3prof_interfaces(coli(pf3))
    o3vmr = 0.5 * (o3_int[:, 1:] + o3_int[:, :-1])
    o3mmr = (tb.AMO3 / tb.AMD) * o3vmr

    # radinp (mod_rad_radiation.F90:4093-4184): CO2/H2O paths
    cldp = torch.cat([cld, torch.zeros_like(cld[:, :1])], dim=1)
    plh2o0 = tb.RGSSLP * q[:, :1] * pint[:, :1] ** 2
    plh2o = torch.cat(
        [plh2o0, plh2o0 + torch.cumsum(
            tb.RGSSLP * (pint[:, 1:] ** 2 - pint[:, :-1] ** 2) * q, dim=1)],
        dim=1)
    cpwpl = (tb.AMCO2 / tb.AMD) * 0.5 / (tb.EGRAVGTS * tb.SSLP)
    plco2 = ghg["co2vmr"] * cpwpl * pint ** 2

    # ---- aerosol optical properties (aeroppt) --------------------------
    aer_sw = aer_ucum = None
    if aermmr is not None and aertab is not None:
        amc = torch.clamp(aermmr, min=0.0).reshape(
            aermmr.shape[0], kz, ncol).transpose(1, 2)   # (ntr, ncol, kz)
        pint_pa = coli(pf3)
        aer_sw = sw_aerosol_mixture(amc, pint_pa, aertab)
        aer_ucum = lw_dust_path(amc, pint_pa, aertab.lw_mask)

    # ---- shortwave -----------------------------------------------------
    czen = torch.where(c2(coszrs) < 1.0e-3, 0.0, c2(coszrs))
    sw = radcsw(pint, q, o3mmr, cld, clwp, rel, rei, fice,
                eccf, czen, c2(aldirs), c2(aldifs), c2(aldirl),
                c2(aldifl), c2(albvs), c2(albvl),
                ghg["co2mmr"], solcon * 1000.0, aer=aer_sw)

    # ---- longwave ------------------------------------------------------
    tp = lwmod.radtpl(c2(tg), t, pmln, q, piln, pint, plh2o)
    if cache is None:
        plos, plol = lwmod.radoz2(o3vmr, pint)
        xptrop = (25000.0 - 15000.0
                  * torch.cos(c2(xlat) * math.pi / 180.0) ** 2) * 10.0
        n2o, ch4, cfc11, cfc12 = lwmod.trcmix(
            c2(xlat), xptrop, pmid,
            dict(ch40=ghg["ch40"], n2o0=ghg["n2o0"],
                 cfc110=ghg["cfc110"], cfc120=ghg["cfc120"]))
        paths = lwmod.trcpth(t, pint, cfc11, cfc12, n2o, ch4, q,
                             ghg["co2mmr"])
        emplnk, abplnk1, abplnk2 = lwmod.trcplk(tp["tint"], tp["tlayr"],
                                                tp["tplnke"])
        em = lwmod.radems(pint, tp, plh2o, plco2, plos, plol, paths,
                          emplnk, ghg["co2vmr"])
        abstot, absnxt = lwmod.radabs(pint, pmid, piln, pmln, tp, em,
                                      plh2o, plco2, plos, plol, paths,
                                      abplnk1, abplnk2, ghg["co2vmr"])
        emsgastot = em["emsgastot"]
    else:
        # dtabem-cached tensors (grid layout → column layout)
        abstot = cache["abstot"].reshape((kz + 1) * (kz + 1), ncol).T \
            .reshape(ncol, kz + 1, kz + 1)
        absnxt = cache["absnxt"].reshape(kz * 4, ncol).T \
            .reshape(ncol, kz, 4)
        emsgastot = cache["emstot"].reshape(kz + 1, ncol).T
    cache_out = None
    if want_cache:
        cache_out = dict(
            abstot=abstot.reshape(ncol, -1).T.reshape(-1, iy, jx),
            absnxt=absnxt.reshape(ncol, -1).T.reshape(-1, iy, jx),
            emstot=emsgastot.T.reshape(kz + 1, iy, jx))
    if aer_ucum is not None:
        # grey dust LW (aertrlw application, radclw :2007-2015)
        trkk = torch.exp(-FIVEOTHREE * QABSLW_DUST
                         * torch.abs(aer_ucum[:, None, :]
                                     - aer_ucum[:, :, None]))
        abstot = 1.0 - (1.0 - abstot) * trkk
        emsgastot = 1.0 - (1.0 - emsgastot) * trkk[:, :, 0]
        trlay = torch.exp(-FIVEOTHREE * QABSLW_DUST
                          * (aer_ucum[:, 1:] - aer_ucum[:, :-1]))
        pi_a, pi_b = pint[:, :-1], pint[:, 1:]
        p1 = 0.5 * (pmid + pi_b)
        p2 = 0.5 * (pmid + pi_a)
        rdpnmsq = 1.0 / (pi_b ** 2 - pi_a ** 2)
        uinpl = torch.stack([(pi_b ** 2 - p1 ** 2) * rdpnmsq,
                             -(pi_a ** 2 - p2 ** 2) * rdpnmsq,
                             -(pi_a ** 2 - p1 ** 2) * rdpnmsq,
                             (pi_b ** 2 - p2 ** 2) * rdpnmsq], dim=2)
        absnxt = 1.0 - (1.0 - absnxt) * trlay[:, :, None] ** uinpl
    effcldp = torch.cat([effcld_lay, torch.zeros_like(effcld_lay[:, :1])],
                        dim=1)
    lwr = lwmod.radclw(c2(tg), c2(emiss), effcldp, tp,
                       emsgastot, abstot, absnxt, pint)

    # total cloud fraction (radctl :980-995, max-random overlap)
    pair_max = torch.maximum(cldp[:, :-1], cldp[:, 1:])
    totcf = 1.0 - torch.prod(
        (1.0 - pair_max) / torch.clamp(1.0 - cldp[:, :-1], min=1e-10), dim=1)

    un = lambda a: a.T.reshape(kz, iy, jx)
    u2 = lambda a: (a * 1.0e-3).reshape(iy, jx)    # cgs → W/m²
    res = RadResult(
        heatrt=un(sw.qrs + lwr.qrl),
        swabs_sfc=u2(sw.fsns),
        lwnet_sfc=-u2(lwr.flns),
        flwds=u2(lwr.flwds), flns=u2(lwr.flns), fsds=u2(sw.fsds),
        solin=u2(sw.solin), fsnt=u2(sw.fsnt), flnt=u2(lwr.flnt),
        fsntc=u2(sw.fsntc), flntc=u2(lwr.flntc),
        sols=sw.sols.reshape(iy, jx), soll=sw.soll.reshape(iy, jx),
        solsd=sw.solsd.reshape(iy, jx), solld=sw.solld.reshape(iy, jx),
        totcf=totcf.reshape(iy, jx))
    return res, cache_out

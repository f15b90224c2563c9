"""CCM3 shortwave: 19-interval delta-Eddington solver, torch twin of
``regcm_tpu/physics/radiation/ccm3/sw.py``.

``radcsw`` / ``radded`` / ``radclr``
(``Main/radlib/mod_rad_radiation.F90:1155-2541``; Briegleb 1992).
Arrays are (ncol, levels); the spectral loop is unrolled, the
layer-adding recursions are loops over the vertical axis batched over
columns. Layer 0 is the extra layer above the model top; interface
kz+1 is the surface. Fluxes cgs, pressures dynes/cm².
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ....dynamics.hydrostatic import level_sum
from . import tables as tb


def _el(w, g):
    return torch.sqrt(3.0 * (1.0 - w) * (1.0 - w * g))


def _delta_eddington(wtot, ftot, tautot, gtot, czen):
    """Scaled delta-Eddington layer solution (radded,
    mod_rad_radiation.F90:2650-2700): rdir, rdif, tdir, tdif, explay.

    Solved in float64 whatever the inputs' dtype (the reference's
    precision), the results in the inputs' dtype: alp and gam share the
    removable singularity 1 − lm²·μ² = 0, which their combinations
    cancel; in float32 the cancellation leaves garbage of 1e20 and more
    (a layer with lm = μ = 1 exactly, the night columns' guarded μ, and
    near it), which radiation steps of configuration E at 140×802×18
    turned into a non-finite state."""
    dtype = wtot.dtype
    if dtype != torch.float64:
        out = _delta_eddington(*(a.double() for a in (wtot, ftot, tautot,
                                                        gtot, czen)))
        return tuple(a.to(dtype) for a in out)
    ts = (1.0 - wtot * ftot) * tautot
    ws = (1.0 - ftot) * wtot / (1.0 - wtot * ftot)
    gs = (gtot - ftot) / (1.0 - ftot)
    lm = _el(ws, gs)
    denom = 1.0 - (lm * lm) * (czen * czen)
    denom = torch.where(torch.abs(denom) < 1e-12,
                        torch.sign(denom) * 1e-12 + 1e-30, denom)
    alp = 0.75 * ws * czen * (1.0 + gs * (1.0 - ws)) / denom
    gam = 0.5 * ws * (3.0 * gs * (1.0 - ws) * czen * czen + 1.0) / denom
    ue = 1.5 * (1.0 - ws * gs) / lm
    extins = torch.exp(-torch.clamp(lm * ts, max=tb.MXARG))
    ne = (ue + 1.0) ** 2 / extins - (ue - 1.0) ** 2 * extins
    rdif = (ue + 1.0) * (ue - 1.0) * (1.0 / extins - extins) / ne
    tdif = 4.0 * ue / ne
    explay = torch.exp(-torch.clamp(ts / czen, max=tb.MXARG))
    apg = alp + gam
    amg = alp - gam
    rdir = amg * (tdif * explay - 1.0) + apg * rdif
    tdir = apg * tdif + (amg * rdif - (apg - 1.0)) * explay
    return (torch.clamp(rdir, min=0.0), torch.clamp(rdif, min=0.0),
            torch.clamp(tdir, min=0.0), torch.clamp(tdif, min=0.0), explay)


def _add_down(rdir, rdif, tdir, tdif, explay):
    """Adding method downwards (radded :2705-2730, :2825-2850): layer
    arrays (ncol, n) → interface arrays (ncol, n+1)."""
    one = torch.ones_like(rdir[:, 0])
    zero = torch.zeros_like(rdir[:, 0])
    exptdn_km1, tottrn_km1, rdndif_km1 = one, one, zero
    e, t, r = [one], [one], [zero]
    for k in range(rdir.shape[1]):
        exptdn_k = exptdn_km1 * explay[:, k]
        exptdn_k = torch.where(exptdn_k < 1e-20, 0.0, exptdn_k)
        rdenom = 1.0 / (1.0 - torch.clamp(rdif[:, k] * rdndif_km1,
                                          max=tb.VERYNEARONE))
        rdirexp = rdir[:, k] * exptdn_km1
        tdnmexp = tottrn_km1 - exptdn_km1
        tottrn_k = exptdn_km1 * tdir[:, k] + tdif[:, k] \
            * (tdnmexp + rdndif_km1 * rdirexp) * rdenom
        rdndif_k = rdif[:, k] + (rdndif_km1 * tdif[:, k]) \
            * (tdif[:, k] * rdenom)
        exptdn_km1, tottrn_km1, rdndif_km1 = exptdn_k, tottrn_k, rdndif_k
        e.append(exptdn_k)
        t.append(tottrn_k)
        r.append(rdndif_k)
    st = lambda lst: torch.stack(lst, dim=1)
    return st(e), st(t), st(r)


def _add_up(rdir, rdif, tdir, tdif, explay, diralb, difalb):
    """Adding from the surface upwards (radcsw :1540-1560): rupdir,
    rupdif at interfaces 0..n."""
    n = rdir.shape[1]
    rupdir_kp1, rupdif_kp1 = diralb, difalb
    rd, rf = [None] * n + [diralb], [None] * n + [difalb]
    for k in range(n - 1, -1, -1):
        rdenom = 1.0 / (1.0 - rdif[:, k] * rupdif_kp1)
        rupdir_k = rdir[:, k] + tdif[:, k] * (
            rupdir_kp1 * explay[:, k]
            + rupdif_kp1 * (tdir[:, k] - explay[:, k])) * rdenom
        rupdif_k = rdif[:, k] + rupdif_kp1 * tdif[:, k] ** 2 * rdenom
        rupdir_kp1, rupdif_kp1 = rupdir_k, rupdif_k
        rd[k] = rupdir_k
        rf[k] = rupdif_k
    return torch.stack(rd, dim=1), torch.stack(rf, dim=1)


def _fluxes(exptdn, tottrn, rdndif, rupdir, rupdif):
    rdenom = 1.0 / (1.0 - rdndif * rupdif)
    fluxup = (exptdn * rupdir + (tottrn - exptdn) * rupdif) * rdenom
    fluxdn = exptdn + (tottrn - exptdn
                       + exptdn * rupdir * rdndif) * rdenom
    return fluxup, fluxdn


class SWResult(NamedTuple):
    qrs: torch.Tensor        # solar heating rate (K/s), (ncol, kz)
    fsns: torch.Tensor       # surface absorbed solar (cgs)
    fsnt: torch.Tensor       # top-of-model net absorbed
    fsntc: torch.Tensor      # clear-sky TOA net
    fsnsc: torch.Tensor      # clear-sky surface absorbed
    fsds: torch.Tensor       # surface downwelling
    solin: torch.Tensor      # solar incident
    solout: torch.Tensor     # reflected at TOA
    sols: torch.Tensor       # sfc direct  < 0.7 µm (MKS)
    soll: torch.Tensor       # sfc direct  > 0.7 µm (MKS)
    solsd: torch.Tensor      # sfc diffuse < 0.7 µm (MKS)
    solld: torch.Tensor      # sfc diffuse > 0.7 µm (MKS)
    abv: torch.Tensor        # vegetation-weighted sfc absorption (MKS)
    sol: torch.Tensor        # incident visible at sfc (MKS)


def radcsw(pint, h2ommr, o3mmr, cld, clwp, rel, rei, fice, eccf,
           czen, adirsw, adifsw, adirlw, adiflw, asw, alw,
           co2mmr, scon, aer=None):
    """Shortwave driver (radcsw, mod_rad_radiation.F90:1155-1821).
    pint (ncol, kz+1) dynes/cm²; cld/clwp/... (ncol, kz) (clwp g/m²);
    czen cosine zenith; aer the aerosol external mixture
    (``chem.optics.SWAerosol``, the aeroppt optical depths) or None."""
    ncol, kz = h2ommr.shape
    day = czen > 0.0
    dayf = day.to(h2ommr.dtype)
    czen_s = torch.where(day, czen, 1.0)      # guard divisions at night

    solin = scon * eccf * czen * dayf
    pflx = torch.cat([torch.zeros_like(pint[:, :1]), pint], dim=1)

    # optical paths incl. the extra layer 0
    tmp1 = 0.5 / (tb.EGRAVGTS * tb.SSLP)
    sqrco2 = math.sqrt(co2mmr)
    zenfac = torch.sqrt(czen_s)
    xptop = pflx[:, 1]
    h2ostr0 = torch.sqrt(1.0 / h2ommr[:, 0])
    pthh2o0 = xptop ** 2 * tmp1 + (xptop * tb.REGRAVGTS) \
        * (h2ostr0 * zenfac * tb.DELTA)
    uh2o0 = h2ommr[:, 0] * pthh2o0
    uco2_0 = zenfac * sqrco2 * (xptop * tb.REGRAVGTS)
    uo2_0 = zenfac * tb.O2MMR * xptop * tb.REGRAVGTS
    uo3_0 = o3mmr[:, 0] * xptop * tb.REGRAVGTS

    pdel = pflx[:, 2:] - pflx[:, 1:-1]
    path = pdel * tb.REGRAVGTS
    h2ostr = torch.sqrt(1.0 / h2ommr)
    pthh2o = (pflx[:, 2:] ** 2 - pflx[:, 1:-1] ** 2) * tmp1 \
        + pdel * h2ostr * zenfac[:, None] * (tb.DELTA * tb.REGRAVGTS)
    uh2o = torch.cat([uh2o0[:, None], h2ommr * pthh2o], dim=1)
    uco2 = torch.cat([uco2_0[:, None], zenfac[:, None] * sqrco2 * path],
                     dim=1)
    uo2 = torch.cat([uo2_0[:, None], zenfac[:, None] * tb.O2MMR * path],
                    dim=1)
    uo3 = torch.cat([uo3_0[:, None], o3mmr * path], dim=1)

    # total column absorber amounts (model layers, clear sky)
    uth2o = torch.sum(uh2o[:, 1:], dim=1)
    uto3 = torch.sum(uo3[:, 1:], dim=1)
    utco2 = torch.sum(uco2[:, 1:], dim=1)
    uto2 = torch.sum(uo2[:, 1:], dim=1)

    zero1 = torch.zeros_like(czen)
    out = dict(fsnt=zero1, fsns=zero1, solout=zero1, fsnsc=zero1,
               fsntc=zero1, sols=zero1, soll=zero1, solsd=zero1,
               solld=zero1, abv=zero1, sol=zero1)
    totfld = torch.zeros_like(pint)
    fswdn_sfc = zero1

    def pad0(a, v):
        return torch.cat([torch.full_like(a[:, :1], v), a], dim=1)

    for ns in range(tb.NSPI):
        isl = int(tb.INDXSL[ns])
        # cloud optics for this interval (Slingo/Ebert-Curry)
        tmp1l = tb.ABARL[isl] + tb.BBARL[isl] / rel
        tmp2l = 1.0 - tb.CBARL[isl] - tb.DBARL[isl] * rel
        tmp3l = tb.FBARL[isl] * rel
        tmp1i = tb.ABARI[isl] + tb.BBARI[isl] / rei
        tmp2i = 1.0 - tb.CBARI[isl] - tb.DBARI[isl] * rei
        tmp3i = tb.FBARI[isl] * rei
        tauxcl = pad0((clwp * cld * (1.0 - fice) * tmp1l)
                      / (1.0 + (1.0 - 0.85) * ((1.0 - cld)
                                               * (clwp * tmp1l
                                                  * (1.0 - fice)))), 0.0)
        tauxci = pad0((clwp * cld * fice * tmp1i)
                      / (1.0 + (1.0 - 0.78) * ((1.0 - cld)
                                               * (clwp * tmp1i * fice))),
                      0.0)
        gcl_lay = tb.EBARL[isl] + tmp3l
        gci_lay = tb.EBARI[isl] + tmp3i
        wcl = pad0(torch.clamp(tmp2l, max=tb.VERYNEARONE), tb.VERYNEARONE)
        gcl = pad0(gcl_lay, 0.850)
        fcl = pad0(gcl_lay * gcl_lay, 0.725)
        wci = pad0(torch.clamp(tmp2i, max=tb.VERYNEARONE), tb.VERYNEARONE)
        gci = pad0(gci_lay, 0.850)
        fci = pad0(gci_lay * gci_lay, 0.725)

        if 0.5 * (tb.WAVMIN[ns] + tb.WAVMAX[ns]) < 0.7:
            diralb, difalb, aveg, visible = adirsw, adifsw, asw, True
        else:
            diralb, difalb, aveg, visible = adirlw, adiflw, alw, False
        trayoslp = tb.RAYTAU[ns] / tb.SSLP

        # radded: per-layer delta-Eddington (layers 0..kz)
        tauray = trayoslp * (pflx[:, 1:] - pflx[:, :-1])
        taugab = tb.ABH2O[ns] * uh2o + tb.ABO3[ns] * uo3 \
            + tb.ABCO2[ns] * uco2 + tb.ABO2[ns] * uo2
        tautot = tauxcl + tauxci + tauray + taugab
        taucsc = tauxcl * wcl + tauxci * wci
        wtau = tb.WRAY * tauray
        gsum = wtau * tb.GRAY + gcl * tauxcl * wcl + gci * tauxci * wci
        fsum = wtau * tb.FRAY + fcl * tauxcl * wcl + fci * tauxci * wci
        if aer is not None:
            # the aerosol's τ, ω·τ, g·ω·τ and g²·ω·τ join the layers'
            tautot = tautot + aer.tauxar[..., ns]
            taucsc = taucsc + aer.tauasc[..., ns]
            gsum = gsum + aer.gtota[..., ns]
            fsum = fsum + aer.ftota[..., ns]
        wt = wtau + taucsc
        wtot = torch.clamp(wt / tautot, max=tb.VERYNEARONE)
        gtot = gsum / wt
        ftot = fsum / wt
        rdir, rdif, tdir, tdif, explay = _delta_eddington(
            wtot, ftot, tautot, gtot, czen_s[:, None])
        exptdn, tottrn, rdndif = _add_down(rdir, rdif, tdir, tdif, explay)
        rupdir, rupdif = _add_up(rdir, rdif, tdir, tdif, explay,
                                 diralb, difalb)
        fluxup, fluxdn = _fluxes(exptdn, tottrn, rdndif, rupdir, rupdif)
        flxdiv = (fluxdn[:, :-1] - fluxdn[:, 1:]) \
            + (fluxup[:, 1:] - fluxup[:, :-1])

        psf = 1.0
        for fac in (tb.PH2O[ns], tb.PCO2[ns], tb.PO2[ns]):
            if abs(fac) > 1e-30:
                psf *= fac
        solflx = solin * tb.FRCSOL[ns] * psf
        out["fsnt"] = out["fsnt"] + solflx * (fluxdn[:, 1] - fluxup[:, 1])
        out["fsns"] = out["fsns"] + solflx * (fluxdn[:, -1] - fluxup[:, -1])
        out["solout"] = out["solout"] + solflx * fluxup[:, 0]
        netsfc = solflx * (fluxdn[:, -1] - fluxup[:, -1])
        direct = exptdn[:, -1] * solflx * 1e-3
        diffuse = (fluxdn[:, -1] - exptdn[:, -1]) * solflx * 1e-3
        if visible:
            out["sols"] = out["sols"] + direct
            out["solsd"] = out["solsd"] + diffuse
        else:
            out["soll"] = out["soll"] + direct
            out["solld"] = out["solld"] + diffuse
        out["abv"] = out["abv"] \
            + netsfc * (1.0 - aveg) / (1.0 - diralb) * 1e-3
        totfld = totfld + solflx[:, None] * flxdiv
        fswdn_sfc = fswdn_sfc + solflx * fluxdn[:, -1]
        if ns == 7:                 # ns==8 1-based: incident visible
            out["sol"] = solflx * fluxdn[:, -1] * 1e-3

        # radclr: 2-effective-layer clear-sky column (ozone layer, rest)
        taugab0 = tb.ABO3[ns] * uto3
        explay0 = torch.exp(-torch.clamp(taugab0 / czen_s, max=tb.MXARG))
        tdif0 = torch.exp(-torch.clamp(1.66 * taugab0, max=tb.MXARG))
        tauray1 = trayoslp * pflx[:, -1]
        taugab1 = tb.ABH2O[ns] * uth2o + tb.ABCO2[ns] * utco2 \
            + tb.ABO2[ns] * uto2
        tautot1 = tauray1 + taugab1
        wsc1 = tb.WRAY * tauray1
        gsc1 = tb.GRAY * tb.WRAY * tauray1
        fsc1 = tb.FRAY * tb.WRAY * tauray1
        if aer is not None:
            # the column's aerosol in the clear-sky layer 1, summed in
            # level order
            col = lambda a: level_sum(a[..., ns].transpose(0, 1))
            tautot1 = tautot1 + col(aer.tauxar)
            wsc1 = wsc1 + col(aer.tauasc)
            gsc1 = gsc1 + col(aer.gtota)
            fsc1 = fsc1 + col(aer.ftota)
        wtot1 = torch.clamp(wsc1 / tautot1, max=tb.VERYNEARONE)
        gtot1 = gsc1 / (wtot1 * tautot1)
        ftot1 = fsc1 / (wtot1 * tautot1)
        lay1 = _delta_eddington(wtot1, ftot1, tautot1, gtot1, czen_s)
        # gate layer 1 on transmission through the ozone layer
        live = explay0 > tb.TRMIN
        lay1 = [torch.where(live, a, 0.0) for a in lay1]
        zero = torch.zeros_like(explay0)
        cl = [torch.stack([a0, a1], dim=1) for a0, a1 in
              zip((zero, zero, explay0, tdif0, explay0), lay1)]
        cexptdn, ctottrn, crdndif = _add_down(*cl)
        crupdir, crupdif = _add_up(*cl, diralb, difalb)
        cfluxup, cfluxdn = _fluxes(cexptdn, ctottrn, crdndif,
                                   crupdir, crupdif)
        out["fsntc"] = out["fsntc"] + solflx * (cfluxdn[:, 0]
                                                - cfluxup[:, 0])
        out["fsnsc"] = out["fsnsc"] + solflx * (cfluxdn[:, 2]
                                                - cfluxup[:, 2])

    qrs = -(tb.GOCP * totfld[:, 1:]) / (pint[:, :-1] - pint[:, 1:])
    qrs = qrs * dayf[:, None]
    msk = lambda a: a * dayf
    return SWResult(
        qrs=qrs, fsns=msk(out["fsns"]), fsnt=msk(out["fsnt"]),
        fsntc=msk(out["fsntc"]), fsnsc=msk(out["fsnsc"]),
        fsds=msk(fswdn_sfc), solin=solin, solout=msk(out["solout"]),
        sols=msk(out["sols"]), soll=msk(out["soll"]),
        solsd=msk(out["solsd"]), solld=msk(out["solld"]),
        abv=msk(out["abv"]), sol=msk(out["sol"]))

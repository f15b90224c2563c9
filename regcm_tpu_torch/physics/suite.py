"""Physics suite: ordered column-physics orchestration, torch twin of
``regcm_tpu/physics/suite.py``.

``physical_parametrizations`` (``Main/mod_tendency.F90:1682-1820``):
deep cumulus on the dtcum alarm (icup 1 Kuo, 2 Grell, 3 Betts-Miller, 4
Emanuel, 5 Tiedtke, 6 Kain-Fritsch or 0 none, each dense over the grid
and blended by the land mask when icup_lnd and icup_ocn differ; the
sigma-p cores hand Kuo the qv vertical advection, which returns on every
step to the columns Kuo leaves alone, and Kain-Fritsch reads a
running-mean w updated on every step) → the icldfrac cloud fraction
(schemes 0-6) and the resolved microphysics (ipptls 1 SUBEX, 2 the
5-species Nogherotto-Tompkins, 3 WSM5, 0 none) → CCM3 radiation on the
dtrad alarm (LW absorptivities on dtabem) → the surface on the dtsrf
alarm: the ocean fluxes (iocnflx 1 BATS, 2 Zeng, 3 COARE), BATS1e over
land (batched over the nsg×nsg subcells when nsg > 1; any other
land_scheme runs the force-restore ground of ``surface_fluxes``), then
the slab ocean, the diurnal skin SST, sea ice and the Hostetler lake,
each overriding its points → the PBL (ibltyp 1 Holtslag, 2 the UW TCM
with its TKE tendency handed back to the core, 3 GFS, 4 MYJ with its
TKE and surface layer kept in the state, 0 none) → shallow convection on
every step when an icup is negative, on the total tendencies → with
ichem=1 the chemistry (tractend2, ``chem.tend``), the tracers' Holtslag
diffusion (a second K1 call, ns = ntr) and Emanuel's tracer transport
(K2's tracer form); the aerosol direct effect (idirect >= 2, dust sets)
feeds CCM3. Returns the physics tendencies for the dynamical core,
coupled by ``atms["cpl"]`` (p* for the sigma-p cores, 1 for the
uncoupled MOLOCH prognostics), plus persistent-state updates (the
tracer tendency as ``_chiten``). ``validate_physics`` refuses at
construction what the JAX package refuses and what the port leaves out
(RRTMG; Tiedtke's tracer transport, the gas-phase mechanisms).
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..core.state import HydroState, BdyState, StepFlags
from ..device import resolve_device
from ..chem import require_species
from ..chem.optics import dust_optics_tables
from ..chem.tend import build_chem
from ..dynamics.hydrostatic import level_sum
from ..dynamics.stencil import cross2dot
from ..utils import constants as c
from .cloud.fractions import cldfrac_dispatch
from .cumulus.betts_miller import bmpara, clwfromt, model_cumulus_cloud
from .cumulus.emanuel import cupeman, ELCRIT_LND, ELCRIT_OCN, EPMAX
from .cumulus.grell import cup
from .cumulus.kain_fritsch import KFParams, KFTables, kfpara
from .cumulus.kuo import build_kuo_tables, kuo
from .cumulus.shallow import shallcu
from .cumulus.tiedtke import ctracer, ntiedtke
from .micro.nogtom import nogtom
from .micro.subex import subex, combine_clouds
from .micro.wsm5 import wsm5
from .pbl.gfs import moninq
from .pbl.holtslag import holtbl, tracer_diffusion
from .radiation.ccm3.driver import ccm3_radiation
from .radiation.ccm3.tables import ghg_mmr
from .radiation.ghg import ghg_concentrations
from .radiation.simple import radiation, surface_albedo
from .surface.bats import (bats_albedo, fseas_fn, soil_static,
                           soil_static_tensors, vecbats)
from .surface.dcsst import dcsst
from .surface.fluxes import surface_fluxes
from .surface.lake import init_lake, lake_layers, lakedrv
from .surface.seaice import seaice
from .surface.slab import update_slabocean
from .uw_dispatch import run_myj, run_uwtcm

# Selector values this port implements: those of the JAX package. An
# unimplemented selector is a hard error at model build, never a silent
# no-op (the reference's cross-check-and-die in mod_params). lakemod,
# islab_ocean, idcsst and iseaice switch their model on at 1, as in the
# JAX package.
SUPPORTED = dict(
    # |icup|: none, Kuo, Grell, Betts-Miller, Emanuel, Tiedtke,
    # Kain-Fritsch; a negative value adds shallow convection
    icup_lnd={0, 1, 2, 3, 4, 5, 6}, icup_ocn={0, 1, 2, 3, 4, 5, 6},
    ibltyp={0, 1, 2, 3, 4},        # none, Holtslag, UW TCM, GFS, MYJ
    ipptls={0, 1, 2, 3},           # none, SUBEX, Nogherotto-Tompkins, WSM5
    iocnflx={1, 2, 3},             # BATS, Zeng, COARE
    icldfrac={0, 1, 2, 3, 4, 5, 6},
    irrtm={0},                     # CCM3 (RRTMG: ROADMAP item 15)
)
# the dynamical cores refuse what they leave out (HydroCore: chemistry
# on the NH core; MolochCore: periodic domains)


def validate_physics(cfg):
    """Raise for any option the JAX package refuses or this port leaves
    out; each message names the scheme and its ROADMAP item."""
    p = cfg.physics
    for name, ok in SUPPORTED.items():
        val = getattr(p, name)
        if name.startswith("icup"):
            val = abs(val)
        if val not in ok:
            what = " (RRTMG, ROADMAP.md item 15)" if name == "irrtm" else ""
            raise NotImplementedError(
                f"physicsparam {name}={val}{what} is not ported to "
                f"regcm_tpu_torch (supported: {sorted(ok)}); refusing to "
                "run with a silently disabled scheme")
    land = str(p.extras.get("land_scheme", "bats1e"))
    if cfg.dim.nsg > 1:
        if cfg.core.idynamic == 3:
            raise ValueError(
                "dimparam nsg>1 (subgrid surface) is not wired for the "
                "MOLOCH core (idynamic=3), in the JAX package either")
        if int(p.ichem) != 0:
            raise ValueError(
                "ichem=1 with nsg>1 subgrid surface is not wired, in the "
                "JAX package either")
        if land != "bats1e":
            raise ValueError("nsg>1 requires the BATS1e land scheme")
    if int(p.ichem) != 0:
        _validate_chemistry(cfg)
    icups = (max(p.icup_lnd, 0), max(p.icup_ocn, 0))
    if 1 in icups:
        if cfg.core.idynamic == 3:
            raise ValueError(
                "icup=1 (Kuo) requires the sigma-p cores' deferred qv "
                "vertical advection and is not available with the "
                "MOLOCH core (idynamic=3)")
        if icups[0] != icups[1]:
            raise ValueError(
                "icup=1 (Kuo) cannot be mixed with a different scheme on "
                "the other surface type (deferred qv vadv contract)")
    if cfg.core.idynamic == 3 and p.ibltyp == 2:
        raise ValueError(
            "ibltyp=2 (UW TCM) needs the MOLOCH WAF TKE advection path, "
            "which neither package wires (ROADMAP.md item 12); use ibltyp "
            "0/1/3/4 with idynamic=3")
    rad = str(p.extras.get("rad_scheme", "ccm3"))
    if rad not in ("ccm3", "broadband"):
        raise ValueError(f"rad_scheme={rad!r} is not a radiation scheme")


def _validate_chemistry(cfg):
    """The chemistry refusals, the JAX package's: an unknown chemsimtype or
    none, the NH core, ichdrdepo=2, a PBL other than Holtslag, a
    microphysics other than SUBEX."""
    p = cfg.physics
    require_species(cfg.chem.chemsimtype)     # raises for unknown or none
    if cfg.core.idynamic == 2:
        raise ValueError(
            "ichem=1 tracer advection is not wired for the MM5-NH core "
            "(idynamic=2), in the JAX package either; use idynamic 1 or 3")
    if int(cfg.chem.ichdrdepo) == 2:
        raise ValueError(
            "chemparam ichdrdepo=2 (deposition through the BL flux) is not "
            "implemented, in the JAX package either; use ichdrdepo=1")
    if p.ibltyp != 1:
        raise ValueError("ichem=1 tracer PBL mixing is implemented for "
                         "ibltyp=1 (Holtslag) only, as in the JAX package")
    if p.ipptls != 1:
        raise ValueError(
            "ichem=1 wet scavenging needs the SUBEX removal-rate "
            "diagnostics (ipptls=1), as in the JAX package")


class PhysicsSuite:
    """Callable plugged into HydroCore (core.physics)."""

    def __init__(self, cfg, grid, device="cuda", dtype=torch.float64,
                 mesh=None):
        validate_physics(cfg)
        device = resolve_device(device)
        self.cfg = cfg
        self.grid = grid
        # the rank's block of a decomposed domain: the static fields are
        # sliced to it and Holtslag solves through K5c
        self.mesh = mesh
        loc = (lambda a: a) if mesh is None else mesh.local
        self.ricr = 0.25      # ricr_lnd/ocn default (mod_params.F90:485)
        self.idynamic = cfg.core.idynamic
        # the land/ocean cumulus split (icup_lnd/icup_ocn,
        # Main/mpplib/mod_runparams.F90:109-153); a negative icup adds
        # shallow convection everywhere (mod_tendency.F90:316)
        p = cfg.physics
        self.icup_lnd = max(p.icup_lnd, 0)
        self.icup_ocn = max(p.icup_ocn, 0)
        self.shallow = p.icup_lnd < 0 or p.icup_ocn < 0
        icups = (self.icup_lnd, self.icup_ocn)
        # Kuo takes the qv vertical advection from the sigma-p cores
        # (mod_tendency.F90:1371-1373); the suite gives it back on every
        # step to the columns Kuo leaves alone
        self.kuo_defer = 1 in icups
        # minorig: lowest Emanuel origin level (mod_params.F90:2352-2355)
        hs = grid.hsigma
        kl = [k for k in range(len(hs)) if hs[k] <= 0.950]
        self.minorig = grid.kz - (max(kl) + 1) if kl else 1
        # Tiedtke's static marker-level profile (hsigma·stdp)
        self.tiedtke_pref = np.asarray(grid.hsigma) * c.stdp
        # GHG scenario concentrations at the run start year
        year = cfg.restart.mdate0 // 1000000
        self.ghg = ghg_concentrations(
            cfg.physics.scenario, float(year),
            int(cfg.physics.extras.get("ghg_year_const", 1950)))
        self.rad_scheme = str(cfg.physics.extras.get("rad_scheme", "ccm3"))
        self.ghg_mmr = ghg_mmr(dict(
            co2=self.ghg["co2ppm"], ch4=self.ghg["ch4ppb"],
            n2o=self.ghg["n2oppb"],
            cfc11=float(cfg.physics.extras.get("cfc11ppt",
                                               self.ghg["cfc11ppt"])),
            cfc12=float(cfg.physics.extras.get("cfc12ppt",
                                               self.ghg["cfc12ppt"]))))
        self.solcon = float(cfg.physics.extras.get("fixedsolarval",
                                                   1367.0))
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        self.xlat = f(loc(grid.xlat))
        # interactive chemistry (tractend2; ichem=1) and, for the dust
        # sets with idirect >= 2, the aerosol direct effect in CCM3 (the
        # aeroppt tables of the external dust mixture)
        self.chem = build_chem(cfg, grid, device, dtype, mesh)
        self.aertab = None
        if self.chem is not None:
            ndust = len(self.chem.spec.indices("dust"))
            if int(cfg.chem.idirect) >= 2 and ndust == self.chem.ntr > 0:
                self.aertab = dust_optics_tables(self.chem.ntr, device,
                                                 dtype)
        # BATS1e static fields from the DOMAIN landuse/texture
        # (defaults: short grass over land, ocean class 15, loam); with
        # nsg > 1 per subcell too (Share/mod_dynparam.F90 nsg, BATS
        # batched over nnsg, the rdnnsg averaging of
        # Main/mod_lm_interface.F90:542-545); another land_scheme runs
        # the force-restore ground of surface_fluxes over land
        self.land_scheme = str(p.extras.get("land_scheme", "bats1e"))
        self.nnsg = max(int(cfg.dim.nsg), 1) ** 2
        if self.land_scheme == "bats1e":
            lveg = np.asarray(grid.extras.get(
                "lveg", np.where(grid.lndocn > 0.5, 2, 15)))
            ltex = np.asarray(grid.extras.get(
                "ltex", np.full((grid.iy, grid.jx), 6)))
            self.bats_ss_np = soil_static(loc(lveg), loc(ltex))
            self.bats_ss = soil_static_tensors(self.bats_ss_np, device,
                                               dtype)
            if self.nnsg > 1:
                shp = (self.nnsg, grid.iy, grid.jx)
                lvs = loc(np.asarray(grid.extras.get(
                    "lveg_sub", np.broadcast_to(lveg, shp))))
                lts = loc(np.asarray(grid.extras.get(
                    "ltex_sub", np.broadcast_to(ltex, shp))))
                # the per-subcell land mask (ocean/lake classes 14/15)
                self.lnd_sub = f((lvs != 14) & (lvs != 15))
                self.bats_ss_sub_np = soil_static(lvs, lts)
                self.bats_ss_sub = soil_static_tensors(
                    self.bats_ss_sub_np, device, dtype)
        # Hostetler lake (lakemod=1, mod_ocn_lake.F90): the static depth
        # index, extinction and mask from the DOMAIN lake depth
        # (grid.extras["dhlake"], m)
        self.lakemod = int(p.lakemod)
        if self.lakemod == 1:
            dh = np.asarray(grid.extras.get(
                "dhlake", np.zeros((grid.iy, grid.jx))))
            _, eta, idep = init_lake(dh, grid.xlat,
                                     np.full(dh.shape, 288.0),
                                     lake_layers(p))
            self.lake_eta = f(loc(eta))
            self.lake_idep = torch.as_tensor(loc(idep), device=device)
            self.lakmsk = f(loc((dh >= 2.0) & (grid.lndocn < 0.5)))
        lnd = loc(np.asarray(grid.lndocn))
        ncol = lnd.size
        self.elcrit = f(np.where(lnd.reshape(ncol) > 0.5,
                                 ELCRIT_LND, ELCRIT_OCN))
        self.epmax = torch.full((ncol,), EPMAX, dtype=dtype, device=device)
        # Grell: the highest departure level (hsigma > skbmax,
        # mod_params.F90:2283-2285)
        self.grell_kbmax = int((np.asarray(grid.hsigma) > 0.4).sum()) - 1
        if self.kuo_defer:
            # Kuo's heating/moistening weight tables (mod_params.F90:
            # 2217-2276) and the 700 hPa level
            tw, vq = build_kuo_tables(grid.sigma, grid.hsigma, grid.dsigma,
                                      grid.ptop)
            self.kuo_tabs = (f(tw), f(vq))
            self.kuo_sig = tuple(f(getattr(grid, k)) for k in
                                 ("sigma", "hsigma", "dsigma"))
            self.k700 = int(np.argmax(np.asarray(grid.hsigma) * 95.0 + 5.0
                                      > 70.0)) + 1
        # Kain-Fritsch: the saturation-point tables and the kfparam and
        # cloud-fraction constants; its trigger reads the running-mean w
        # in the state (wavg), updated on every step
        self.uses_kf = 6 in icups
        if self.uses_kf:
            kfn = cfg.kf
            cld = cfg.raw.get("cldparam", {}) if cfg.raw else {}
            self.kf_tab = KFTables.build(cfg.ptop_cb * 1000.0, device,
                                         dtype=dtype)
            self.kf_par = KFParams(
                entrate=float(kfn.kf_entrate),
                convrate=float(kfn.kf_convrate),
                min_pef=float(kfn.kf_min_pef), max_pef=float(kfn.kf_max_pef),
                dpp=float(kfn.kf_dpp), min_dtcape=float(kfn.kf_min_dtcape),
                max_dtcape=float(kfn.kf_max_dtcape),
                tkemax=float(kfn.kf_tkemax),
                wthreshold=float(kfn.kf_wthreshold),
                k2_const=float(cld.get("k2_const", 500.0)),
                kfac_shal=float(cld.get("kfac_shal", 0.07)),
                kfac_deep=float(cld.get("kfac_deep", 0.14)))

    # -- deep cumulus dispatch (cu_interface :335-369 and the
    #    icup_lnd/icup_ocn split of Main/mpplib/mod_runparams.F90:109-153)
    def _cumulus(self, core, atms, s, flags, dyn, dt):
        """The configured deep scheme(s) dense over the grid, land and
        ocean tendencies blended by the mask; uncoupled cross-grid
        fields (K/s, kg/kg/s, m/s²) and the persistent-state updates."""
        zero3 = torch.zeros_like(atms["tb3"])
        empty = dict(tten=zero3, qvten=zero3, utenx=zero3, vtenx=zero3,
                     prate=torch.zeros_like(atms["psb"]), cldfra=zero3,
                     cldlwc=zero3, qcten=zero3, qiten=zero3, qdetr=zero3,
                     state={})
        if self.kuo_defer and dyn is not None:
            # columns that do not convect get the deferred qv vertical
            # advection back (mod_cu_kuo.F90:270-282), on every step
            rcpl = 1.0 / atms.get("cpl", atms["psb"])
            empty["qvten"] = dyn["qv_vadv"] * rcpl[None]
        if not flags.do_cum or (self.icup_lnd == 0 and self.icup_ocn == 0):
            return empty
        out_l = self._cumulus_one(self.icup_lnd, core, atms, s, dyn, dt) \
            if self.icup_lnd else empty
        if self.icup_ocn == self.icup_lnd:
            return out_l
        out_o = self._cumulus_one(self.icup_ocn, core, atms, s, dyn, dt) \
            if self.icup_ocn else empty
        lm2 = core.grid_lndocn > 0.5
        out = {k: torch.where(lm2, out_l[k], out_o[k])
               for k in empty if k != "state"}
        cur = dict(cbmf=s.cbmf, cldefi=s.cldefi)
        out["state"] = {
            k: torch.where(lm2, out_l["state"].get(k, cur[k]),
                           out_o["state"].get(k, cur[k]))
            for k in set(out_l["state"]) | set(out_o["state"])}
        return out

    def _cumulus_one(self, icup, core, atms, s, dyn, dt):
        """One deep-convection scheme on the whole grid."""
        kz = core.kz
        tb3 = torch.clamp(atms["tb3"], min=150.0)
        iy, jx = tb3.shape[1], tb3.shape[2]
        ncol = iy * jx
        rho = atms["rhob3"]
        zero3 = torch.zeros_like(tb3)
        res = dict(utenx=zero3, vtenx=zero3, qcten=zero3, qiten=zero3,
                   qdetr=zero3, state={})
        flipc = lambda a: torch.flip(a, [0]).reshape(a.shape[0], ncol).T
        unflip = lambda a: torch.flip(a.T.reshape(kz, iy, jx), [0])
        colc = lambda a: a.reshape(a.shape[0], ncol).T
        uncol = lambda a: a.T.reshape(kz, iy, jx)
        rcpl = (1.0 / atms.get("cpl", atms["psb"]))[None]
        conv_lwc = lambda cldfra: torch.where(
            cldfra > 0.0, 0.3e-3 * 1000.0 * rho, 0.0)
        if icup == 1:
            # Kuo (cupara, Main/cumlib/mod_cu_kuo.F90:75): triggered by
            # the moisture convergence; convecting columns get the Kuo
            # tendencies, the others the deferred qv vertical advection
            tw, vq = self.kuo_tabs
            out = kuo(tb3, atms["qvb3"], atms["pb3"] * 1e-3,
                      atms["psb"] + core.ptop, dyn["qvhadv"],
                      *self.kuo_sig, tw, vq, core.ptop, self.k700)
            res.update(tten=out.tten,
                       qvten=torch.where(out.active[None], out.qvten,
                                         dyn["qv_vadv"] * rcpl),
                       prate=out.prate, cldfra=zero3, cldlwc=zero3)
            return res
        if icup == 2:
            # Grell (cuparan, Main/cumlib/mod_cu_grell.F90:207) on the
            # current and the large-scale-forced state
            if dyn is not None:
                tn3 = tb3 + dyn["tdyn"] * rcpl * dt
                qo3 = atms["qvb3"] + dyn["qvdyn"] * rcpl * dt
            else:
                tn3, qo3 = tb3, atms["qvb3"]
            out = cup(flipc(tb3), flipc(atms["qvb3"]), flipc(tn3),
                      flipc(qo3), flipc(atms["pb3"]) * 0.01,
                      atms["ps2d"].reshape(ncol) * 0.01,
                      (core.ht / c.egrav).reshape(ncol),
                      flipc(torch.sqrt(atms["ubx3"] ** 2
                                       + atms["vbx3"] ** 2)),
                      dt, igcc=self.cfg.physics.igcc,
                      kbmax=self.grell_kbmax)
            cldfra = unflip(out.cldfrc)
            res.update(tten=unflip(out.outt), qvten=unflip(out.outq),
                       prate=out.pratec.reshape(iy, jx), cldfra=cldfra,
                       cldlwc=conv_lwc(cldfra))
            return res
        if icup == 3:
            # Betts-Miller (bmpara, Main/cumlib/mod_cu_bm.F90:134):
            # top-down columns, no flip
            out = bmpara(colc(tb3), colc(atms["qvb3"]), colc(atms["pb3"]),
                         colc(atms["pf3"]),
                         colc(atms["za"] + (core.ht / c.egrav)[None]),
                         atms["ps2d"].reshape(ncol),
                         core.grid_lndocn.reshape(ncol),
                         s.cldefi.reshape(ncol), dt)
            cldfra = uncol(model_cumulus_cloud(
                out.kbot, out.ktop, kz, float(self.cfg.geo.ds), tb3.dtype))
            res.update(tten=uncol(out.tten), qvten=uncol(out.qten),
                       prate=out.prate.reshape(iy, jx), cldfra=cldfra,
                       cldlwc=torch.where(cldfra > 0.001, clwfromt(tb3),
                                          0.0),
                       state=dict(cldefi=out.cldefi.reshape(iy, jx)))
            return res
        if icup == 6:
            # Kain-Fritsch (kfdrv/kfpara, Main/cumlib/mod_cu_kf.F90),
            # bottom-up columns; ipptls > 1 feeds back the mixed-phase
            # species (f_qi); the qr/qs tendencies ride the qcten/qiten
            # slots, as in the JAX package
            f_qi = self.cfg.physics.ipptls > 1
            ql0 = flipc(atms["qcb3"])
            qi0 = flipc(atms["qhb3"][2]) if f_qi and core.nqx == 5 \
                else torch.zeros_like(ql0)
            if self.cfg.physics.ibltyp == 2:
                tkec = 0.5 * (s.tke_b[:-1] + s.tke_b[1:])
            else:
                tkec = torch.full_like(tb3, self.kf_par.tkemax)
            wavg = atms.get("_wavg", s.wavg)
            out = kfpara(
                self.kf_tab, self.kf_par, flipc(tb3), flipc(atms["qvb3"]),
                flipc(atms["ubx3"]), flipc(atms["vbx3"]), flipc(atms["za"]),
                flipc(atms["pb3"]), flipc(rho), flipc(atms["dzq"]),
                flipc(wavg), flipc(tkec), ql0, qi0, float(core.dtsec),
                float(self.cfg.ds_m), f_qi=f_qi)
            cldfra = unflip(out.cldfra)
            res.update(tten=unflip(out.dtdt), qvten=unflip(out.dqdt),
                       prate=out.prate.reshape(iy, jx), cldfra=cldfra,
                       cldlwc=conv_lwc(cldfra),
                       qcten=unflip(out.dqcdt + out.dqrdt),
                       qiten=unflip(out.dqidt + out.dqsdt))
            return res
        if icup == 4:
            # Emanuel (cupemandrv, Main/cumlib/mod_cu_em.F90:107); with
            # chemistry and ichcumtra=1 its own tracer transport
            # (chemcutran, :454, :605-1150) on the bottom-up tracers
            qmix = atms["qvb3"]
            qspec = qmix / (1.0 + qmix)
            qs_spec = atms["qsb3"] / (1.0 + atms["qsb3"])
            tra = None
            if self.chem is not None and self.cfg.chem.ichcumtra == 1:
                chi_u = torch.clamp(s.chi_b * atms["rpsb"][None], min=0.0)
                tra = torch.flip(chi_u.reshape(self.chem.ntr, kz, ncol)
                                 .permute(2, 1, 0), [1])  # (ncol, kz, ntr)
            out = cupeman(
                flipc(tb3), flipc(qspec), flipc(qs_spec),
                flipc(atms["ubx3"]), flipc(atms["vbx3"]),
                flipc(atms["pb3"]) * 0.01, flipc(atms["pf3"]) * 0.01,
                s.cbmf.reshape(ncol), dt, self.elcrit, self.epmax,
                max(self.minorig - 1, 1), tra=tra)
            cldfra = unflip(out.cldfra)
            res.update(
                tten=unflip(out.ft),
                qvten=unflip(out.fq / (1.0 - flipc(qspec)) ** 2),
                utenx=unflip(out.fu), vtenx=unflip(out.fv),
                prate=out.precip.reshape(iy, jx),
                cldfra=cldfra,
                cldlwc=conv_lwc(cldfra),
                state=dict(cbmf=out.cbmf.reshape(iy, jx) * core.m_ci))
            if tra is not None:
                # applied on this alarm step alone, and only when Emanuel
                # covers both surfaces (the land/ocean blend keeps only
                # the common keys, as in the JAX package)
                res["_emftra"] = out.ftra     # (ncol, kz, ntr) bottom-up
            return res
        # "new Tiedtke" (ntiedtke, Main/cumlib/mod_cu_tiedtke.F90:4508,
        # driver tiedtkedrv :207-434): specific-humidity basis in,
        # mixing-ratio tendencies out (:380-391); the detrained
        # condensate rides qcten/qiten (and qdetr, staged into nogtom,
        # :392). Columns (ncol, kz) are transposed views: level-major.
        # provisional state from the dynamic tendencies (cucall
        # :601-609) and ZERO surface fluxes: the reference calls the BL
        # after CU (:700-704), so the surface-flux shallow trigger is off
        if dyn is not None:
            tq = dyn["qvdyn"] * rcpl
            tt = dyn["tdyn"] * rcpl
        else:
            tq = tt = zero3
        tb3p = tb3 + tt * dt
        qvb3p = torch.clamp(atms["qvb3"] + tq * dt, min=c.minqq)
        qspec = qvb3p / (1.0 + qvb3p)
        qc_spec = atms["qcb3"] / (1.0 + qvb3p)
        za_c = colc(atms["za"])
        zf_mid = 0.5 * (za_c[:, :-1] + za_c[:, 1:])
        zf = torch.cat([2.0 * za_c[:, :1] - zf_mid[:, :1], zf_mid,
                        torch.zeros_like(za_c[:, :1])], dim=1)
        zfl = torch.zeros((ncol, kz + 1), dtype=tb3.dtype, device=tb3.device)
        # the JAX package passes the model dt as Tiedtke's dtcum
        # (physics/suite.py:467), and so does the port
        out = ntiedtke(
            colc(tb3p), colc(qspec), colc(atms["ubx3"]),
            colc(atms["vbx3"]), colc(qc_spec), zfl, zfl,
            colc(atms["pb3"]), colc(atms["pf3"]),
            za_c * c.egrav, zf * c.egrav, colc(tq / (1.0 + qvb3p) ** 2),
            colc(tt), core.grid_lndocn.reshape(ncol) > 0.5,
            float(core.dtsec), float(self.cfg.ds_m), self.tiedtke_pref,
            omega=colc(atms["omega_pa"]),
            lmfmid=bool(self.cfg.tiedtke.lmfmid),
            lmfsmooth=bool(self.cfg.tiedtke.lmfsmooth))
        qcten = out.lten
        qiten = torch.zeros_like(out.iten)
        if self.cfg.physics.ipptls == 2:
            qiten = out.iten          # :398-409
        else:
            qcten = qcten + out.iten  # :415-421
        cldfra = uncol(out.cldfra)
        res.update(
            tten=uncol(out.tten),
            qvten=uncol(out.qten / (1.0 - colc(qspec)) ** 2),
            utenx=uncol(out.uten), vtenx=uncol(out.vten),
            prate=out.prate.reshape(iy, jx),
            cldfra=cldfra,
            cldlwc=conv_lwc(cldfra),
            qcten=uncol(qcten), qiten=uncol(qiten),
            qdetr=uncol(out.qdetr))
        if self.chem is not None:
            # the tracer-transport fluxes for the chemistry hook's ctracer
            # (on this alarm step alone, and only when Tiedtke covers both
            # surfaces: the land/ocean blend keeps only the common keys,
            # as in the JAX package)
            res["_tdk"] = out
        return res

    def _chemistry(self, core, atms, s, cu, fcc, remrat, strappt, precip,
                   hout, cpl, dt, sfupd):
        """The tracer tendency (``sfupd["_chiten"]``, coupled) and the
        accumulated emission and deposition (``chemdiag``, kg/m²): the
        chemistry, the tracers' Holtslag diffusion with the scalar
        coefficients (holtbl's chi block, mod_pbl_holtbl.F90:985-1095,
        through K1 at ns = ntr; no surface flux, the dry deposition being
        the chemistry's with ichdrdepo=1) and Emanuel's or Tiedtke's
        tracer transport on their alarm steps."""
        kz = core.kz
        m_ci = core.m_ci
        zero_r = torch.zeros_like(atms["tb3"])
        chiten, cdiag = self.chem(
            core, atms, s, fcc, cu["cldfra"],
            remrat if remrat is not None else zero_r,
            strappt if strappt is not None else zero_r,
            cu["prate"] * m_ci, dt, ls_prate=precip)
        chib3 = torch.clamp(s.chi_b * atms["rpsb"][None], min=0.0)
        chip = tracer_diffusion(chib3, hout.alphak, hout.betak_q, dt,
                                mesh=self.mesh)
        chiten = chiten + (chip - chib3) / dt * cpl[None] * m_ci
        if "_emftra" in cu:
            iy, jx = chib3.shape[-2:]
            ft3 = torch.flip(cu["_emftra"], [1])    # (ncol, kz, ntr) top-down
            chiten = chiten + ft3.permute(2, 1, 0).reshape(
                self.chem.ntr, kz, iy, jx) * cpl[None] * m_ci
        if "_tdk" in cu:
            # Tiedtke's convective tracer transport (ctracer,
            # mod_cu_tiedtke.F90:7549; lmftrac) on the top-down columns
            iy, jx = chib3.shape[-2:]
            ncol = iy * jx
            qtrac = chib3.reshape(self.chem.ntr, kz, ncol).permute(2, 1, 0)
            ct = ctracer(qtrac, cu["_tdk"],
                         atms["pf3"].reshape(kz + 1, ncol).T,
                         float(core.dtsec))
            chiten = chiten + ct.permute(2, 1, 0).reshape(
                self.chem.ntr, kz, iy, jx) * cpl[None] * m_ci
        sfupd["_chiten"] = chiten
        zf = torch.zeros_like(s.chemdiag[0])
        sfupd["chemdiag"] = torch.stack([
            s.chemdiag[n] + cdiag.get(k, zf) * core.dtsec
            for n, k in enumerate(("emflx", "ddflx", "wdflx"))])

    # -- nsg > 1: the subcells' batch and the averages back to the cell
    def _sub(self, a):
        """A cell field broadcast over the nnsg subcells."""
        return a[None].expand((self.nnsg,) + tuple(a.shape))

    def _mean_land(self, a):
        """The mean over a cell's land subcells (subcells summed in
        order, so that a block of a decomposed run adds as the whole
        domain does)."""
        nl = torch.clamp(level_sum(self.lnd_sub), min=1.0)
        return level_sum(a * self.lnd_sub) / nl

    # -- surface model (dtsrf alarm; mod_tendency.F90:1786-1795): ocean
    #    fluxes, BATS1e, slab ocean, diurnal SST, sea ice, lake
    def _surface(self, core, atms, s, bdy, tb3, qvb3, za, precip, cuprate,
                 swabs, lwnet, sfupd):
        """The surface fluxes, drag and ground temperature after the
        surface models in the JAX package's order; their persistent
        state goes into ``sfupd``."""
        kz = core.kz
        p = self.cfg.physics
        dtsrf = self.cfg.time.dtsrf
        lnd = core.grid_lndocn
        ps2d = atms["ps2d"]
        u1, v1, t1, q1, z1 = (atms["ubx3"][kz - 1], atms["vbx3"][kz - 1],
                              tb3[kz - 1], qvb3[kz - 1], za[kz - 1])
        rhox = ps2d / (c.rgas * t1)
        slab = p.islab_ocean == 1
        # with the slab ocean the prognostic SST lives in tg over the
        # ocean points (sfs%tg2 aliasing, mod_slabocean.F90:79)
        sst = s.tg if slab else core.sst
        if p.idcsst == 1 and not slab:
            # the ocean fluxes see the prognostic skin temperature once it
            # is spun up (dcsst, mod_ocn_zeng.F90:101-105)
            sst = torch.where(s.dcsst[2] > 100.0, s.dcsst[2], sst)
        sf = surface_fluxes(u1, v1, t1, q1, z1, rhox, ps2d, s.tg, sst, lnd,
                            swabs, lwnet, precip, dtsrf, iocnflx=p.iocnflx)
        hfx, qfx, uvdrag, tg = sf.hfx, sf.qfx, sf.uvdrag, sf.tg
        if self.land_scheme == "bats1e":
            # full BATS1e over the land points (vecbats,
            # Main/batslib/mod_bats_common.F90:318)
            args = (t1, q1 / (1.0 + q1), u1, v1, z1, rhox, ps2d,
                    precip + cuprate * core.m_ci, swabs, -lwnet, swabs,
                    atms["coszrs"])
            if self.nnsg > 1:
                # batched over the subcells, each with its landuse and
                # texture; the subgrid skin T is carried as tgbrd, as in
                # the JAX package; fluxes averaged back to the cell
                # (rdnnsg, mod_lm_interface.F90:542-545)
                bo = vecbats(*(self._sub(a) for a in args), s.bats[0],
                             s.bats, self.bats_ss_sub, self.lnd_sub, dtsrf)
                mean_l = self._mean_land
                lfrac = level_sum(self.lnd_sub) / self.nnsg
                anyl = lfrac > 0.0
                blend = lambda ln, oc: torch.where(
                    anyl, lfrac * ln + (1.0 - lfrac) * oc, oc)
                hfx = blend(mean_l(bo.sent), hfx)
                qfx = blend(torch.clamp(mean_l(bo.evpr), min=0.0), qfx)
                uvdrag = blend(mean_l(bo.drag), uvdrag)
                tg = blend(mean_l(bo.tgrd), tg)
            else:
                bo = vecbats(*args, s.tg, s.bats, self.bats_ss, lnd, dtsrf)
                lmm = lnd > 0.5
                hfx = torch.where(lmm, bo.sent, hfx)
                qfx = torch.where(lmm, torch.clamp(bo.evpr, min=0.0), qfx)
                uvdrag = torch.where(lmm, bo.drag, uvdrag)
                tg = torch.where(lmm, bo.tgrd, tg)
            sfupd["bats"] = bo.bats
        ocean = lnd < 0.5
        if slab:
            # update_slabocean (mod_slabocean.F90:95): the mixed-layer
            # budget restoring toward the forcing SST; the SOM q-flux
            # adjustment (qflb0) only where the boundary carries one
            sp = self.cfg.slaboc
            qadj = 0.0
            if sp.do_qflux_adj and bdy is not None \
                    and getattr(bdy, "qflb0", None) is not None:
                qadj = bdy.qflb0
            tg, _ = update_slabocean(
                tg, core.sst, ocean, swabs, -lwnet, hfx, qfx, dtsrf,
                mixed_layer_depth=sp.mixed_layer_depth,
                do_restore_sst=sp.do_restore_sst,
                sst_restore_timescale=sp.sst_restore_timescale,
                qflux_adj=qadj)
        if p.idcsst == 1 and not slab:
            # Zeng-Beljaars diurnal warm layer and cool skin
            # (mod_ocn_zeng.F90:293-377)
            spd = torch.sqrt(u1 ** 2 + v1 ** 2)
            ustar = torch.sqrt(torch.clamp(uvdrag, min=1e-6)
                               * torch.clamp(spd, min=0.1) / rhox)
            dco = dcsst(core.sst, swabs, -lwnet, hfx, qfx, ustar, rhox,
                        s.dcsst, lnd, dtsrf)
            tg = torch.where(ocean, dco.tskin, tg)
            sfupd["dcsst"] = dco.dcsst
        if p.iseaice == 1:
            # frozen ocean points override the open-water fluxes (seaice,
            # mod_ocn_bats.F90:105; vecocn, mod_ocn_common.F90:62)
            si = seaice(t1, q1, u1, v1, z1, rhox, ps2d, precip, swabs,
                        -lwnet, sst, s.seaice, lnd, dtsrf)
            im = si.icemask > 0.5
            hfx = torch.where(im, si.sent, hfx)
            qfx = torch.where(im, si.evpr, qfx)
            uvdrag = torch.where(im, si.drag, uvdrag)
            tg = torch.where(im, si.tg, tg)
            sfupd["seaice"] = si.ice
        if self.lakemod == 1:
            # lake points override the ocean fluxes (lakedrv,
            # mod_ocn_lake.F90:203; llake, mod_ocn_common.F90:61)
            lk = lakedrv(t1, q1, u1, v1, z1, swabs, lwnet, precip, s.hfx,
                         s.qfx, rhox, ps2d, s.tlak, s.lakhi, s.lakice,
                         s.laksnow, s.laksnag, tg, self.lake_eta,
                         self.lake_idep, self.lakmsk, self.xlat, dtsrf)
            m = self.lakmsk > 0.5
            hfx = torch.where(m, lk.sent, hfx)
            qfx = torch.where(m, torch.clamp(lk.evpr, min=0.0), qfx)
            uvdrag = torch.where(m, lk.drag, uvdrag)
            tg = torch.where(m, lk.tg, tg)
            sfupd.update(tlak=lk.tlak, lakhi=lk.lakhi, lakice=lk.lakice,
                         laksnow=lk.laksnow, laksnag=lk.laksnag)
        sfupd.update(hfx=hfx, qfx=qfx, uvdrag=uvdrag, tg=tg)
        return hfx, qfx, uvdrag, tg

    # -- GFS PBL inputs: bottom-up columns, the kinematic surface fluxes,
    #    the interface pressures and geopotentials (pbl_gfs,
    #    Main/pbllib/mod_pbl_gfs.F90:98-179)
    def _gfs(self, atms, s, tb3, qvb3, qcb3, pb3, za, dzq, hfx, qfx,
             uvdrag, tg, dt):
        """The GFS tendencies on the cross grid: du, dv (uncoupled), T,
        qv and qc (to be coupled)."""
        kz, iy, jx = tb3.shape
        ncol = iy * jx
        flipc = lambda a: torch.flip(a, [0]).reshape(kz, ncol).T
        unflip = lambda a: torch.flip(a.T.reshape(kz, iy, jx), [0])
        ps2 = atms["ps2d"].reshape(ncol)
        ta = tb3[kz - 1].reshape(ncol)
        qa = qvb3[kz - 1].reshape(ncol)
        ua = atms["ubx3"][kz - 1].reshape(ncol)
        va = atms["vbx3"][kz - 1].reshape(ncol)
        pa = pb3[kz - 1].reshape(ncol)
        spd1 = torch.sqrt(ua ** 2 + va ** 2)
        rrhox = c.rgas * ta * (1.0 + c.ep1 * qa) / pa
        cpm = c.cpd * (1.0 + 0.8 * qa)
        heat = hfx.reshape(ncol) / cpm * rrhox    # (:128)
        evap = qfx.reshape(ncol) * rrhox
        # stress = ustar² from the stored drag (uvdrag = ρ·Cd·V)
        stress = uvdrag.reshape(ncol) * spd1 * rrhox
        # the surface bulk Richardson number (BATS form,
        # mod_ocn_bats.F90:47)
        zaa = za[kz - 1].reshape(ncol)
        rbsoil = zaa * c.egrav * (1.0 - tg.reshape(ncol) / ta) \
            / (spd1 ** 2 + 0.01)
        prsl = flipc(pb3) * 1e-3                  # cb
        t1 = flipc(tb3)
        dz1 = flipc(dzq)
        z1 = flipc(za)
        # interface pressures, summed up the column in level order, and
        # geopotentials (:156-179)
        delk = prsl / (c.rgas * c.regrav) * dz1 / t1
        p0 = ps2 * 1e-3
        prsi = [p0]
        acc = delk[:, 0]
        prsi.append(p0 - acc)
        for k in range(1, kz):
            acc = acc + delk[:, k]
            prsi.append(p0 - acc)
        prsi = torch.stack(prsi, dim=1)
        phii = torch.cat(
            [torch.zeros_like(z1[:, :1]),
             (z1[:, 1:] - z1[:, :1]) * c.egrav,
             ((z1[:, -1] - z1[:, 0]) * c.egrav
              + dz1[:, -1] * c.egrav)[:, None]], dim=1)
        phil = torch.cat(
            [0.5 * (z1[:, 1:] + z1[:, :-1] - 2.0 * z1[:, :1]) * c.egrav,
             (2.0 * phii[:, kz - 1] - 0.5
              * (z1[:, -1] + z1[:, -2] - 2.0 * z1[:, 0]) * c.egrav)[:, None]],
            dim=1)
        prslk = (prsl * 1000.0 / c.stdp) ** c.rovcp
        psk = (ps2 / c.stdp) ** c.rovcp
        q1s = flipc(qvb3 / (1.0 + qvb3))
        qcs = flipc(qcb3 / (1.0 + qcb3))
        thr = flipc(s.heatrt) / prslk
        out = moninq(flipc(atms["ubx3"]), flipc(atms["vbx3"]), t1, q1s, qcs,
                     prsl, prsi, delk, prslk, psk, phil, phii, thr, heat,
                     evap, stress, rbsoil, spd1, dt)
        return (unflip(out.du), unflip(out.dv), unflip(out.tau),
                unflip(out.rtgq / (1.0 - q1s) ** 2),
                unflip(out.rtgc / (1.0 - qcs) ** 2))

    def __call__(self, core, atms, s: HydroState, bdy: BdyState,
                 flags: StepFlags, dt, dyn=None):
        kz = core.kz
        psb = atms["psb"]
        # tendency coupling factor: p* for the hydrostatic core (coupled
        # prognostics), 1 for MOLOCH (mod_moloch.F90:1546)
        cpl = atms.get("cpl", psb)
        mo = self.idynamic == 3     # MOLOCH: cross winds, uncoupled
        tb3 = torch.clamp(atms["tb3"], min=150.0)
        qvb3 = atms["qvb3"]
        qcb3 = atms["qcb3"]
        pb3 = atms["pb3"]
        pf3 = atms["pf3"]
        rho = atms["rhob3"]
        rh = atms["rhb3"]
        za = atms["za"]
        dzq = atms["dzq"]
        ps2d = atms["ps2d"]
        m_ci = core.m_ci
        lnd = core.grid_lndocn
        lmm = lnd > 0.5
        sfupd: Dict[str, torch.Tensor] = {}

        if self.uses_kf:
            # the running-mean w of the KF trigger, on every step (avg_ww,
            # mod_cu_interface.F90:256-268): weight 1/max(int(max(dtcum,
            # 3600)/dt), 1), w from -ω/(ρg)
            w1 = 1.0 / max(int(max(self.cfg.time.dtcum, 3600.0)
                               / core.dtsec), 1)
            w_now = -atms["omega_pa"] / (rho * c.egrav)
            sfupd["wavg"] = (1.0 - w1) * s.wavg + w1 * w_now
            atms["_wavg"] = sfupd["wavg"]

        # -- cumulus on the syncro_cum alarm; tendencies held in state
        #    between calls (mod_cu_interface.F90:288); with Kuo on every
        #    step (the deferred qv advection), its tendencies not held
        if self.kuo_defer or flags.do_cum:
            cu = self._cumulus(core, atms, s, flags, dyn, dt)
            if not self.kuo_defer:
                sfupd["cuten"] = torch.stack(
                    [cu["tten"], cu["qvten"], cu["utenx"], cu["vtenx"],
                     cu["cldfra"], cu["cldlwc"], cu["qcten"], cu["qiten"],
                     cu["qdetr"]])
                sfupd["cuprate"] = cu["prate"]
            sfupd.update(cu["state"])
        else:
            cu = dict(tten=s.cuten[0], qvten=s.cuten[1],
                      utenx=s.cuten[2], vtenx=s.cuten[3],
                      cldfra=s.cuten[4], cldlwc=s.cuten[5],
                      qcten=s.cuten[6], qiten=s.cuten[7],
                      qdetr=s.cuten[8], prate=s.cuprate)
        pfac = cpl[None] * m_ci
        tphy = cu["tten"] * pfac
        qvphy = cu["qvten"] * pfac
        qcphy = cu["qcten"] * pfac
        qiphy = cu["qiten"] * pfac
        qrphy = qsphy = torch.zeros_like(tb3)
        sfupd["rainc"] = s.rainc + cu["prate"] * m_ci * core.dtsec

        # -- cloud fraction + resolved microphysics
        #    (mod_tendency.F90:1715-1740)
        fcc = cldfrac_dispatch(
            self.cfg.physics.icldfrac, tb3, pb3, qvb3, qcb3, rh,
            atms["qsb3"], core.rh0[None], ps2d, float(self.cfg.geo.ds),
            landmask=lnd)
        cldlwc, cldfra = combine_clouds(fcc, qcb3, rho, tb3,
                                        cu["cldfra"], cu["cldlwc"])
        ipptls = self.cfg.physics.ipptls
        mic_remrat = mic_strappt = None
        if ipptls == 1:
            out = subex(tb3, pb3, pf3, qvb3, qcb3, rh, rho, fcc, cpl, dt,
                        core.qck1, core.cgul, core.cevap, core.caccr)
            tphy = tphy + out.tten * m_ci
            qvphy = qvphy + out.qvten * m_ci
            qcphy = qcphy + out.qcten * m_ci
            precip = out.precip * m_ci
            # chemistry's removal-rate diagnostics (remrat 1/s, rembc
            # mm/hr → mm/s, mod_che_tend.F90:124-127)
            mic_remrat = out.remrat
            mic_strappt = out.rembc / 3600.0
        elif ipptls == 2:
            # Nogherotto-Tompkins 5-species implicit microphysics
            # (nogtom, Main/microlib/mod_micro_nogtom.F90:358); Tiedtke's
            # detrainment staged in, zero under the other schemes
            qhb3 = atms["qhb3"]
            out = nogtom(tb3, torch.stack([qvb3, qhb3[0], qhb3[1],
                                           qhb3[2], qhb3[3]]),
                         pb3, pf3, rho, cldfra, cu["qdetr"], s.heatrt,
                         atms["omega_pa"], lnd, core.dtsec)
            tphy = tphy + out.tten * pfac
            qvphy = qvphy + out.qxten[0] * pfac
            qcphy = qcphy + out.qxten[1] * pfac
            qrphy = qrphy + out.qxten[2] * pfac
            qiphy = qiphy + out.qxten[3] * pfac
            qsphy = qsphy + out.qxten[4] * pfac
            precip = (out.rainnc + out.snownc) * m_ci
        elif ipptls == 3:
            # WSM5 (mod_micro_interface.F90 → wsm5, Main/microlib/
            # mod_micro_wsm5.F90:214) on bottom-up columns; the
            # tendencies are (new − old)·p*/dt (wsm5:296-307)
            iy, jx = tb3.shape[1], tb3.shape[2]
            ncol = iy * jx
            colb = lambda a: torch.flip(a, [0]).reshape(kz, ncol).T
            uncolb = lambda a: torch.flip(a.T.reshape(kz, iy, jx), [0])
            qhb3 = atms["qhb3"]
            out = wsm5(colb(tb3), colb(qvb3), colb(qhb3[0]), colb(qhb3[2]),
                       colb(qhb3[1]), colb(qhb3[3]), colb(pb3), colb(dzq),
                       colb(rho), colb(atms["qsb3"]), colb(rh), core.dtsec)
            wfac = cpl[None] / core.dtsec * m_ci
            tphy = tphy + (uncolb(out.t) - tb3) * wfac
            qvphy = qvphy + (uncolb(out.qv) - qvb3) * wfac
            qcphy = qcphy + (uncolb(out.qc) - qhb3[0]) * wfac
            qrphy = qrphy + (uncolb(out.qr) - qhb3[1]) * wfac
            qiphy = qiphy + (uncolb(out.qi) - qhb3[2]) * wfac
            qsphy = qsphy + (uncolb(out.qs) - qhb3[3]) * wfac
            precip = out.rain.reshape(iy, jx) * m_ci
        else:
            precip = torch.zeros_like(psb)
        sfupd["rainnc"] = s.rainnc + precip * core.dtsec

        # -- radiation (dtrad alarm; mod_tendency.F90:1744-1782)
        heatrt = s.heatrt
        if flags.do_rad:
            coszrs = atms["coszrs"]
            alb = surface_albedo(coszrs, lnd)
            if self.land_scheme == "bats1e":
                # BATS two-band direct/diffuse land albedo, the bulk
                # zenith formula over the ocean; with nsg > 1 per subcell,
                # averaged over the land subcells (mod_lm_interface.F90:437)
                if self.nnsg > 1:
                    mean_l = self._mean_land
                    swdr, lwdr, swdf, lwdf = (mean_l(a) for a in bats_albedo(
                        self._sub(coszrs), s.bats[0], s.bats[6],
                        s.bats[4], s.bats[5], self.bats_ss_sub,
                        self.lnd_sub))
                    ss_e = self.bats_ss_sub
                    emis_land = mean_l(ss_e["lndemiss"] - ss_e["seasemi"]
                                       * fseas_fn(s.bats[0]))
                else:
                    swdr, lwdr, swdf, lwdf = bats_albedo(
                        coszrs, s.bats[0], s.bats[6], s.bats[4], s.bats[5],
                        self.bats_ss, lnd)
                    emis_land = self.bats_ss["lndemiss"] \
                        - self.bats_ss["seasemi"] * fseas_fn(s.bats[0])
                alb_s = (torch.where(lmm, swdr, alb),
                         torch.where(lmm, swdf, alb),
                         torch.where(lmm, lwdr, alb),
                         torch.where(lmm, lwdf, alb),
                         torch.where(lmm, self.bats_ss["albvgs"], alb),
                         torch.where(lmm, self.bats_ss["albvgl"], alb))
                emis = torch.where(lmm, emis_land, 0.985)
            else:
                alb_s = (alb,) * 6
                emis = torch.full_like(psb, 0.985)
            eccf = atms.get("eccf", 1.0)
            solcon = atms.get("solcon", self.solcon)
            if self.rad_scheme == "ccm3":
                abem_cache = None if flags.do_abem else dict(
                    abstot=s.abstot, absnxt=s.absnxt, emstot=s.emstot)
                five = core.nqx == 5
                aer = {}
                if self.aertab is not None:
                    aer = dict(aermmr=torch.clamp(s.chi_b, min=0.0)
                               * atms["rpsb"][None], aertab=self.aertab)
                rad, abem_out = ccm3_radiation(
                    tb3, qvb3, qcb3,
                    atms["qhb3"][2] if five else torch.zeros_like(qcb3),
                    pb3, pf3, rh,
                    dzq, cldfra, cldlwc, coszrs, s.tg, lnd, self.xlat,
                    *alb_s, emis, self.ghg_mmr, eccf=eccf, solcon=solcon,
                    five_species=five, cache=abem_cache,
                    want_cache=flags.do_abem, **aer)
                if abem_out is not None:
                    sfupd.update(abem_out)
            else:
                rad = radiation(tb3, qvb3, pf3, pb3, cldfra, cldlwc,
                                coszrs, s.tg, alb, eccf=eccf,
                                co2ppm=self.ghg["co2ppm"],
                                ch4ppb=self.ghg["ch4ppb"],
                                n2oppb=self.ghg["n2oppb"])
            heatrt = rad.heatrt * m_ci
            swabs = rad.swabs_sfc
            lwnet = rad.lwnet_sfc
            sfupd["swsfc"] = swabs
            sfupd["lwsfc"] = lwnet
        else:
            swabs = s.swsfc
            lwnet = s.lwsfc

        # -- surface model (dtsrf alarm; :1786-1795)
        hfx, qfx, uvdrag, tg = s.hfx, s.qfx, s.uvdrag, s.tg
        if flags.do_srf:
            hfx, qfx, uvdrag, tg = self._surface(
                core, atms, s, bdy, tb3, qvb3, za, precip, cu["prate"],
                swabs, lwnet, sfupd)

        # -- PBL (:1799-1819)
        utenx, vtenx = cu["utenx"], cu["vtenx"]
        uphy = vphy = 0.0
        if self.cfg.physics.ibltyp == 1:
            # Holtslag (holtbl, Main/pbllib/mod_pbl_holtbl.F90)
            tp3 = tb3 * (ps2d / pb3) ** c.rovcp
            # kmxpbl: highest allowed PBL level (p > 600 hPa, mkslice
            # Main/mod_slice.F90:342-352); argmax on an int cast keeps
            # the first occurrence
            above = pb3 > 60000.0
            first_above = torch.argmax(above.to(torch.int32), dim=0)
            kmx = torch.where(torch.any(above, dim=0),
                              torch.clamp(first_above - 1, min=0), kz - 2)
            hout = holtbl(
                tp3, tb3, pb3, pf3, qvb3, qcb3,
                atms["ubx3"], atms["vbx3"],
                atms["ubx3"] if mo else atms["ubd3"],
                atms["vbx3"] if mo else atms["vbd3"],
                za, dzq, ps2d / (c.rgas * tb3[kz - 1]), uvdrag, hfx, qfx,
                tg, core.coriol, cpl,
                torch.ones_like(cpl) if mo else cross2dot(psb),
                kmx, dt, ricr=self.ricr,
                cross2dot_fn=None if mo else cross2dot,
                m_di=None if mo else core.m_di, m_ci=m_ci, mesh=self.mesh)
            tphy = tphy + hout.tten
            qvphy = qvphy + hout.qvten
            qcphy = qcphy + hout.qcten
            if mo:
                utenx = utenx + hout.uten
                vtenx = vtenx + hout.vten
            else:
                uphy, vphy = hout.uten, hout.vten
        elif self.cfg.physics.ibltyp == 2:
            # UW TCM (uwtcm, Main/pbllib/mod_pbl_uwtcm.F90:137):
            # prognostic-TKE moist turbulence from the b-level TKE; its
            # TKE tendency goes back to the core through "_tkephy"
            out = run_uwtcm(self, core, atms, s, dt)
            tphy = tphy + out["tten"] * pfac
            qvphy = qvphy + out["qvten"] * pfac
            qcphy = qcphy + out["qcten"] * pfac
            if core.nqx == 5:
                qiphy = qiphy + out["qiten"] * pfac
            utenx = utenx + out["uten"]
            vtenx = vtenx + out["vten"]
            sfupd["_tkephy"] = out["tketen"]
        elif self.cfg.physics.ibltyp == 4:
            # MYJ (myjpbl, Main/pbllib/mod_pbl_myj.F90:177): level-2.5 TKE
            # kept as per-layer persistent state, not advected
            out = run_myj(self, core, atms, s, flags, dt)
            tphy = tphy + out["tten"] * pfac
            qvphy = qvphy + out["qvten"] * pfac
            qcphy = qcphy + out["qcten"] * pfac
            if core.nqx == 5:
                qiphy = qiphy + out["qiten"] * pfac
            utenx = utenx + out["uten"]
            vtenx = vtenx + out["vten"]
            sfupd["tke_a"] = out["tke_a"]
            sfupd["pbl0"] = out["pbl0"]
        elif self.cfg.physics.ibltyp == 3:
            # GFS Hong-Pan PBL (pbl_gfs, Main/pbllib/mod_pbl_gfs.F90:98)
            du, dv, tt, qq, qc = self._gfs(atms, s, tb3, qvb3, qcb3, pb3,
                                           za, dzq, hfx, qfx, uvdrag, tg,
                                           dt)
            tphy = tphy + tt * pfac
            qvphy = qvphy + qq * pfac
            qcphy = qcphy + qc * pfac
            utenx = utenx + du
            vtenx = vtenx + dv

        # -- shallow convection (any icup < 0; mod_tendency.F90:316) on
        #    the total (dynamics + physics) tendencies, on every step
        if self.shallow and dyn is not None:
            ncol = tb3.shape[1] * tb3.shape[2]
            flipc = lambda a: torch.flip(a, [0]).reshape(kz, ncol).T
            unflip = lambda a: torch.flip(a.T.reshape(tb3.shape), [0])
            rcpl = (1.0 / cpl)[None]
            out = shallcu(flipc(tb3), flipc(qvb3),
                          flipc((dyn["tdyn"] + tphy) * rcpl),
                          flipc((dyn["qvdyn"] + qvphy) * rcpl),
                          flipc(pb3) * 0.01, ps2d.reshape(ncol) * 0.01,
                          (core.ht / c.egrav).reshape(ncol), dt)
            tphy = tphy + unflip(out.outts) * cpl[None] * m_ci
            qvphy = qvphy + unflip(out.outqs) * cpl[None] * m_ci

        # -- chemistry (tractend2 call site, mod_tendency.F90:1821)
        if self.chem is not None:
            self._chemistry(core, atms, s, cu, fcc, mic_remrat, mic_strappt,
                            precip, hout, cpl, dt, sfupd)

        # couple the accumulated cross-grid wind tendencies onto the
        # momentum grid in one pass (uvcross2dot ×p*_dot for the B grid,
        # tenxtouvten for MOLOCH's C grid)
        du, dv = core.couple_uvten(utenx, vtenx, cpl)
        # hydrometeor tendencies on the species axis (qc[, qr, qi, qs])
        qhphy = torch.stack([qcphy, qrphy, qiphy, qsphy]) \
            if core.nqx == 5 else qcphy[None]
        return (tphy, qvphy, qhphy, uphy + du, vphy + dv, cldfra, heatrt,
                sfupd)

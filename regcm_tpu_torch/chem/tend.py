"""Chemistry tendency orchestration — the ``tractend2`` equivalent
(``Main/chemlib/mod_che_tend.F90:63-583``), torch twin of
``regcm_tpu/chem/tend.py``.

Called from inside ``PhysicsSuite`` at the reference's call site (tend →
physical_parametrizations → tractend2): the surface-layer met fields (10
m wind, aerodynamic resistance), the natural emission fluxes (dust, sea
salt, pollen), settling and dry deposition of the aerosol tracers, SO2's
gas dry deposition (Zhang 2003 resistances), wet scavenging, the aqueous
and gas-phase sulfur chemistry and the carbonaceous aging. For the
``igaschem`` sets the CBMZ or CB6r2 gas-phase solver runs on every
chemistry call, and for DCCB the SNA equilibrium repartition after it.
Returns the coupled tracer tendency ``chiten`` and the emission and
deposition fluxes.

Surface-layer simplifications follow the reference's own CLM45 branch
(mod_che_tend.F90:253-291): temp10 from the lapse rate, rh10 from the
lowest model level — documented deviations of the JAX package from the
BATS-deltk path, kept.

With a ``DomainMesh`` the static fields (landuse, soil texture, pollen
potential, oxidant climatology) are built on the whole grid and cut to
the rank's block; every operation is column-local.
"""
from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from ..physics.surface.bats import _depth, fseas_fn
from ..utils import constants as c
from . import require_species
from .carbon import aging_tend
from .cbmz_driver import Cb6Driver, CbmzDriver
from .deposition import (CDEPUV, CIEXSOL, CROUGH, CXMOPOR, aerodyresis,
                         drydep_aero, settling_tend, wetdep_tend)
from .drydep_gas import GAS_ROW, gas_drydep_velocity
from .dust import DustEmission
from .oxclim import IOX_H2O2, IOX_OH, load_oxidants
from .pollen import pollen_emission
from .seasalt import SeasaltEmission
from .sna import SnaDriver
from .sox import chemsox
from .species import ChemSpec

ZOCE = 0.0004      # ocean roughness (m), zoce of mod_constants

class ChemTend:
    """Chemistry tendency operator bound to one grid (or a rank's block of
    it, ``mesh``) and configuration."""

    def __init__(self, cfg, grid, spec: ChemSpec, device="cpu",
                 dtype=torch.float64, mesh=None):
        self.cfg = cfg
        self.spec = spec
        self.ntr = spec.ntr
        ch = cfg.chem
        self.ichsursrc = int(ch.ichsursrc)
        self.ichdrdepo = int(ch.ichdrdepo)
        self.ichremlsc = int(ch.ichremlsc)
        self.ichremcvc = int(ch.ichremcvc)
        self.ichdustemd = int(ch.ichdustemd)
        self.rdstemfac = float(ch.rdstemfac)
        loc = (lambda a: a) if mesh is None else mesh.local
        f = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                      device=device)
        # landuse class map (ivegcov: ocean/lake classes 14/15 → 0,
        # tractend2 :168-178)
        lveg = np.asarray(grid.extras.get(
            "lveg", np.where(np.asarray(grid.lndocn) > 0.5, 2, 15)),
            dtype=np.int32)
        ivegcov = loc(np.where((lveg == 14) | (lveg == 15), 0, lveg))
        self.ivegcov = torch.as_tensor(ivegcov, device=device)
        self.water = torch.as_tensor(ivegcov == 0, device=device)
        # effective roughness by class (crough; water zoce)
        self.zeff = f(np.where(ivegcov > 0,
                               CROUGH[np.clip(ivegcov - 1, 0, 21)], ZOCE))
        # soil-water normalisation 1/(depuv·1e-3·2650·(1−porosity))
        # (tractend2 :236-240, the Fecan gravimetric conversion)
        iex = CIEXSOL[np.clip(ivegcov - 1, 0, 21)]
        xmo = CXMOPOR[np.clip(iex - 1, 0, 11)]
        self.soilw_fac = f(1.0 / (CDEPUV * 1.0e-3 * 2650.0
                                  * np.maximum(1.0 - xmo, 1e-6)))
        iy, jx = grid.iy, grid.jx
        # -- dust (only when dust tracers are active)
        self.idust = spec.indices("dust")
        self.dust = None
        if self.idust:
            # texture fractions (dustsotex): the DOMAIN's fractional field
            # when present, else one-hot dominant class
            if "texfrac" in grid.extras:
                tex = np.asarray(grid.extras["texfrac"])
            else:
                ltex = np.asarray(grid.extras.get(
                    "ltex", np.full((iy, jx), 6)), dtype=np.int32)
                tex = np.zeros((12, iy, jx))
                np.put_along_axis(tex, np.clip(ltex - 1, 0, 11)[None],
                                  1.0, axis=0)
            emitmask = ((ivegcov == 8) | (ivegcov == 11)).astype(float)
            self.dust = DustEmission(spec.bin_size, loc(tex), emitmask,
                                     ichdustemd=self.ichdustemd,
                                     rdstemfac=self.rdstemfac,
                                     device=device, dtype=dtype)
        # -- sea salt
        self.isslt = spec.indices("sslt")
        self.seasalt = SeasaltEmission() if self.isslt else None
        # -- pollen: the emission potential map (chemsrc), zero without
        # a CHEMISS inventory
        self.ipollen = spec.indices("pollen")
        self.pollen_src = f(loc(np.asarray(grid.extras.get(
            "pollen_src", np.zeros((iy, jx))))))
        # -- sulfur
        self.iso2 = spec.iso2
        self.iso4 = spec.iso4
        self.oxcl = None
        if spec.ioxclim:
            ox = load_oxidants(cfg, grid, np.asarray(grid.hsigma))
            self.oxcl = (f(loc(ox[IOX_OH])), f(loc(ox[IOX_H2O2])))
        # -- gas dry deposition
        self.gasdep = [(i, n) for i, n in enumerate(spec.names)
                       if spec.kind[i] in ("so2", "gas") and n in GAS_ROW]
        # lcov for the gas scheme (water → class 14, >20 → 20)
        self.lcov_gas = torch.as_tensor(
            np.where(ivegcov == 0, 14, np.minimum(ivegcov, 20)),
            dtype=torch.long, device=device)
        # -- per-tracer aerosol parameters: safe (nonzero) diameters and
        # densities for the dense deposition algebra, the results masked
        # to the aerosol tracers
        amask = spec.aerosol_mask
        self.aer_mask = torch.as_tensor(amask, device=device)
        self.bin_diam = f(np.where(amask, spec.bin_diam, 1.0))
        self.rhop = f(np.where(amask, spec.rhop, 1000.0))
        self.sol = f(np.where(amask, spec.sol, 0.0))
        self.aging_pairs = list(spec.aging_pairs)
        # -- gas phase (CBMZ or CB6r2)
        self.cbmz = None
        if spec.igaschem:
            mk = Cb6Driver if spec.simtype == "CB6" else CbmzDriver
            self.cbmz = mk(cfg, spec)
        # -- SNA thermodynamic equilibrium (DCCB iisoropia)
        self.sna = SnaDriver(spec) if getattr(spec, "isna", 0) else None

    def __call__(self, core, atms, s, cldfra_ls, cum_cldfra, remrat, rembc,
                 conv_prate, dt, ls_prate=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """(chiten coupled (ntr, kz, iy, jx), diagnostics: the emission,
        dry- and wet-deposition fluxes in kg/m²/s)."""
        kz = core.kz
        psb = atms["psb"]
        # tendency coupling factor: p* for the sigma-p cores, 1 for
        # MOLOCH (tractend2's idynamic==3 branches)
        cpl = atms.get("cpl", psb)
        tb3 = atms["tb3"]
        rho = atms["rhob3"]
        dzq = atms["dzq"]
        za = atms["za"]
        chib = s.chi_b                      # coupled p*·chi

        # -- surface-layer fields (tractend2 preliminary block)
        zak = za[kz - 1]
        fact = torch.log(zak / 10.0) / torch.log(
            zak / torch.clamp(self.zeff, min=1e-6))
        u10 = atms["ubx3"][kz - 1] * (1.0 - fact)
        v10 = atms["vbx3"][kz - 1] * (1.0 - fact)
        wid10 = torch.sqrt(u10 ** 2 + v10 ** 2)
        # CLM45-branch simplifications (mod_che_tend.F90:276-280)
        temp10 = tb3[kz - 1] + c.lrate * (zak - 10.0)
        rh10 = atms["rhb3"][kz - 1]
        tsurf = s.tg
        srad = s.swsfc
        # gravimetric soil water from the BATS 10 cm store (bats[6])
        soilw = s.bats[6] * self.soilw_fac
        # vegetation and snow fractions from the BATS pack
        bats1e = getattr(core.physics, "land_scheme", "") == "bats1e"
        if bats1e:
            ss = core.physics.bats_ss
            lncl = torch.clamp(ss["mfcv"] - ss["seasf"] * fseas_fn(s.bats[0]),
                               0.0, 1.0)
            _, _, _, scvk, _ = _depth(s.bats[4], s.bats[5], lncl, ss["rough"])
        else:
            lncl = torch.full_like(psb, 0.1)
            scvk = torch.zeros_like(psb)
        # the reference zeroes snow for the gas-drydep scheme
        # (drydep_gas :845 snow(:) = d_zero)
        snow_mm = torch.zeros_like(psb)
        vegfrac = lncl
        snowfrac = scvk

        ustar, xra = aerodyresis(self.zeff, wid10, temp10, tsurf, rh10, srad,
                                 self.water)

        chiten = torch.zeros_like(chib)
        diag: Dict[str, torch.Tensor] = {}
        emflx = torch.zeros((self.ntr,) + tuple(psb.shape), dtype=chib.dtype,
                            device=chib.device)
        sfc_fac = cpl / (dzq[kz - 1] * rho[kz - 1])
        tot_pr = conv_prate + (ls_prate if ls_prate is not None else 0.0)

        # -- natural emissions (sfflux equivalents). chiten is a fresh
        # tensor of this call throughout, so its in-place adds are local
        if self.ichsursrc:
            if self.dust is not None:
                rsfrow = self.dust(ustar, self.zeff, soilw, wid10,
                                   rho[kz - 1], vegfrac, snowfrac)
                for b, itr in enumerate(self.idust):
                    chiten[itr, kz - 1] += rsfrow[b] * sfc_fac
                    emflx[itr] += rsfrow[b]
            if self.seasalt is not None:
                ss_ = self.seasalt(wid10, self.water.to(chib.dtype))
                for b, itr in enumerate(self.isslt):
                    chiten[itr, kz - 1] += ss_[b] * sfc_fac
                    emflx[itr] += ss_[b]
            if self.ipollen:
                pe = pollen_emission(self.pollen_src, ustar, wid10, rh10,
                                     tot_pr)
                itr = self.ipollen[0]
                chiten[itr, kz - 1] += pe * sfc_fac
                emflx[itr] += pe
            diag["emflx"] = emflx

        # -- settling + dry deposition (aerosol tracers)
        if self.ichdrdepo:
            dd = drydep_aero(self.bin_diam, self.rhop, tb3, rho, atms["pb3"],
                             self.ivegcov, ustar, xra)
            am = self.aer_mask[:, None, None, None]
            pdepv = torch.where(am, dd.pdepv, 0.0)
            ddepv = torch.where(am[:, 0], dd.ddepv, 0.0)
            st_ten, ddflx = settling_tend(chib, cpl, pdepv, ddepv, dzq, rho,
                                          core.twt1, core.twt2, dt)
            chiten = chiten + st_ten
            diag["ddflx"] = ddflx
            # gas dry deposition (drydep_gas, Zhang 2003 resistances)
            if self.gasdep:
                vdg = gas_drydep_velocity(
                    [n for _, n in self.gasdep], self.lcov_gas,
                    atms.get("mpos", 6.5), ustar, xra, tot_pr * 3600.0,
                    snow_mm, srad, tsurf, temp10, rh10,
                    atms.get("coszrs", torch.zeros_like(psb)))
                rdz = 1.0 / dzq[kz - 1]
                for gi, (itr, _) in enumerate(self.gasdep):
                    kd = vdg[gi] * rdz
                    kav = torch.clamp(chib[itr, kz - 1], min=0.0) / dt
                    ddrem = torch.where(kd * dt < 25.0,
                                        kav * (1.0 - torch.exp(-kd * dt)),
                                        0.0)
                    chiten[itr, kz - 1] -= ddrem
        else:
            pdepv = torch.zeros((self.ntr, kz) + tuple(psb.shape),
                                dtype=chib.dtype, device=chib.device)

        # -- wet deposition (wetdepa; aerosol tracers only)
        kcumtop = torch.full(tuple(psb.shape), -1, dtype=torch.long,
                             device=psb.device)
        if self.ichremlsc or self.ichremcvc or self.iso2 is not None:
            has = (cum_cldfra > 1e-3).to(torch.int32)
            anyc = has.any(dim=0)
            kcumtop = torch.where(anyc, torch.argmax(has, dim=0), -1)
            kcumbot = torch.where(
                anyc, kz - 1 - torch.argmax(torch.flip(has, [0]), dim=0), -1)
        wl = atms["qcb3"] * rho * 1000.0          # g/m³
        if self.ichremlsc or self.ichremcvc:
            wt_ten, wflx = wetdep_tend(
                chib, cpl, tb3, wl, cldfra_ls, cum_cldfra, remrat, kcumtop,
                kcumbot, rembc, conv_prate, pdepv, self.bin_diam, self.rhop,
                self.sol, dzq, rho, dt, ichremlsc=self.ichremlsc,
                ichremcvc=self.ichremcvc)
            am = self.aer_mask[:, None, None, None]
            chiten = chiten + torch.where(am, wt_ten, 0.0)
            diag["wdflx"] = wflx

        rpsb = atms.get("rpsb")
        unc = (lambda a: a * rpsb) if rpsb is not None else (lambda a: a)
        # -- sulfur chemistry (chemsox)
        if self.iso2 is not None and self.iso4 is not None \
                and self.oxcl is not None:
            out = chemsox(unc(chib[self.iso2]), unc(chib[self.iso4]), rho,
                          tb3, atms.get("coszrs", torch.zeros_like(psb)),
                          wl, cldfra_ls, cum_cldfra, kcumtop,
                          rembc * 3600.0, self.oxcl[0], self.oxcl[1], dt)
            chiten[self.iso2] += out.so2_ten * cpl[None]
            chiten[self.iso4] += out.so4_ten * cpl[None]
            diag["so2_wash"] = out.washout_so2

        # -- carbonaceous aging (aging_carb)
        if self.aging_pairs:
            uc = chib * rpsb[None] if rpsb is not None else chib
            chiten = chiten + aging_tend(uc, self.aging_pairs, dt) * cpl[None]

        # -- CBMZ gas-phase solver (chemistry, on dtchsolv)
        if self.cbmz is not None:
            chiten = chiten + self.cbmz(atms, s, chib, cpl, dt)

        # -- SNA equilibrium repartition (aerodriver,
        #    mod_che_isorropia.F90:64-161, iisoropia==1)
        if self.sna is not None:
            chiten = chiten + self.sna(atms, s, chib, cpl, dt)

        return chiten * core.m_ci[None, None], diag


def build_chem(cfg, grid, device="cpu", dtype=torch.float64, mesh=None):
    """Set-up-time chemistry factory (mod_che_start start_chem): None when
    ichem=0, a ChemTend for a supported chemsimtype; raises otherwise."""
    if cfg.physics.ichem == 0:
        return None
    return ChemTend(cfg, grid, require_species(cfg.chem.chemsimtype),
                    device=device, dtype=dtype, mesh=mesh)

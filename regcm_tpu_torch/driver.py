"""Model driver, torch twin of ``regcm_tpu/driver.py`` for the main path.

``Model(cfg, device=..., dtype=...).run(n)`` initialises the dynamical
core that ``cfg.core.idynamic`` names (1: hydrostatic, 2: MM5
non-hydrostatic, 3: MOLOCH) with the physics suite the configuration
selects and steps it with the reference's alarms
(``Main/mod_regcm_interface.F90``, ``Main/mpplib/mod_timer.F90``):
cumulus every dtcum, surface every dtsrf, radiation every dtrad and the
LW absorptivities every dtabem. It runs on the CUDA card unless the
caller passes ``device="cpu"``. Without ICBC input the run starts from a
resting standard atmosphere (the NH core: from its reference atmosphere,
``nh_initial_state``) and holds the boundary at the initial state;
``init_from_icbc(reader)`` cold-starts from the ICBC record at mdate1
and ``run_icbc(n)`` steps with the boundary-input alarm every ibdyfrq
hours (``update_boundary``), as the reference's ``bdyin`` does.

``save_restart``/``load_restart`` write and read the JAX package's SAV
format (``io.restart``), so that a restarted run continues the
uninterrupted one bit for bit; ``attach_icbc`` re-attaches the boundary
input after a load. ``open_output`` and ``run_with_output`` write the
ATM, SRF, RAD, STS, LAK, SUB, SLABOC, CHE and OPT streams
(``io.output``) to NetCDF or to a Zarr store. ``globdatparam ensemble_run`` perturbs the
topography and the ICBC records (``utils.ensemble``), and ``attach_som``
feeds a SOM q-flux file to the slab ocean. With chemistry (ichem=1,
the aerosol and the gas-phase chemsimtypes) the state carries the
tracers; on every cumulus alarm the columns whose scheme does not move
tracers itself get the well-mixed convective transport
(``chem.cumtran``). ``set_chem_bc(reader)`` attaches the chemical
boundary input (a CHBC file of ``preproc.chem_icbc``): on the sigma-p
cores the lateral boundary then relaxes the tracers toward its records,
without one toward clean air, as in the JAX package.

``Model(cfg, mesh=DomainMesh(...))`` runs any of the cores decomposed over a
(y, x) grid of ranks, one ``Model`` in each rank's process
(``parallel.launch``): the rank holds its block of the state; the
initial state, the ICBC records and the solar zenith angles are formed
on the whole grid and cut to it; ``check_finite`` and ``decoupled`` look
at the whole domain; rank 0 writes the restart and NetCDF output files of
the whole domain, and each rank its block's chunks of a Zarr store.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional

import numpy as np
import torch

from .chem import chem_ntr
from .chem.cumtran import cumtran
from .config.params import RegCMConfig
from .core.grid import ModelGrid, build_grid
from .core.state import (BdyState, HydroState, StepFlags, bdy_from_numpy,
                         bdy_from_state, sliced, species_count,
                         state_from_numpy, zeros_hydro)
from .device import resolve_device
from .dynamics import stencil
from .dynamics.hydrostatic import HydroCore, fix_cross_pad
from .dynamics.moloch import (MolochBdy, MolochCore, MolochState,
                              moloch_bdy_from_numpy, moloch_state_from_numpy)
from .dynamics.sound import make_base_state
from .physics.surface.bats import bats_init_state
from .physics.surface.lake import init_lake, lake_layers
from .utils import constants as c
from .utils.calendar import Date
from .utils.ensemble import randify
from .utils.sun import coszrs as _coszrs, solar_state
from .utils.thermo import pfwsat


def _zeros(grid: ModelGrid, cfg: RegCMConfig, device, dtype) -> HydroState:
    """The zero state sized for the configuration's species, lake layers
    and subgrid."""
    return zeros_hydro(grid.kz, grid.iy, grid.jx, device=device,
                       dtype=dtype, nqx=species_count(cfg.physics.ipptls),
                       nlak=lake_layers(cfg.physics),
                       nnsg=max(int(cfg.dim.nsg), 1) ** 2, ntr=chem_ntr(cfg))


def standard_atmosphere_state(grid: ModelGrid, cfg: RegCMConfig,
                              device="cuda", dtype=torch.float64,
                              perturb: float = 0.0,
                              seed: int = 0) -> HydroState:
    """Cold start from a resting standard atmosphere (synthetic ICBC),
    with an optional white-noise T perturbation drawn from
    ``numpy.random.default_rng(seed)``."""
    device = resolve_device(device)
    iy, jx, kz = grid.iy, grid.jx, grid.kz
    ptop = grid.ptop
    ps = np.full((iy, jx), 101.325 - ptop)  # p* (cb)
    p = grid.hsigma[:, None, None] * ps[None] + ptop      # cb
    t = c.stdt * (p / 101.325) ** (c.rgas * c.lrate * c.regrav)
    z = (c.stdt - t) / c.lrate
    t = np.where(z > 10769.0, 218.15, t)
    if perturb > 0.0:
        rng = np.random.default_rng(seed)
        t = t + perturb * rng.standard_normal(t.shape) \
            * grid.m_cross_int[None]
    # 50% RH w.r.t. the model's own saturation (subsaturated everywhere)
    qsat = pfwsat(torch.as_tensor(t), torch.as_tensor(p * 1000.0)).numpy()
    qv = np.minimum(np.maximum(0.5 * qsat, c.minqq), 0.015)
    nqx = species_count(cfg.physics.ipptls)
    s = _zeros(grid, cfg, device, dtype)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    qx = torch.cat([f(qv * ps[None])[None],
                    torch.zeros((nqx - 1,) + qv.shape, dtype=dtype,
                                device=device)])
    return s._replace(ps_a=f(ps), ps_b=f(ps), t_a=f(t * ps[None]),
                      t_b=f(t * ps[None]), qx_a=qx, qx_b=qx.clone(),
                      tg=f(t[-1]))


def nh_initial_state(grid: ModelGrid, cfg: RegCMConfig, device="cuda",
                     dtype=torch.float64, perturb: float = 0.0,
                     seed: int = 0) -> HydroState:
    """Cold start of the MM5 NH core (idynamic=2) on the whole grid: T the
    reference atmosphere's t0, pp = w = 0 (the nhinterp base-state
    contract, a rest state of the NH equations), qv 30% of saturation
    capped at 0.01, with an optional white-noise T perturbation drawn
    from ``numpy.random.default_rng(seed)``."""
    device = resolve_device(device)
    base = make_base_state(grid, float(grid.ptop),
                           logp_lrate=cfg.nonhydro.logp_lrate)
    ps = base.ps0
    t0 = base.t0
    if perturb > 0.0:
        rng = np.random.default_rng(seed)
        t0 = t0 + perturb * rng.standard_normal(t0.shape) \
            * grid.m_cross_int[None]
    qv = np.minimum(0.3 * pfwsat(torch.as_tensor(t0),
                                 torch.as_tensor(base.pr0)).numpy(), 0.01)
    nqx = species_count(cfg.physics.ipptls)
    s = _zeros(grid, cfg, device, dtype)
    f = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
    qx = torch.cat([f(qv * ps[None])[None],
                    torch.zeros((nqx - 1,) + qv.shape, dtype=dtype,
                                device=device)])
    return s._replace(ps_a=f(ps), ps_b=f(ps), t_a=f(t0 * ps[None]),
                      t_b=f(t0 * ps[None]), qx_a=qx, qx_b=qx.clone(),
                      tg=f(t0[-1]))


def moloch_bdy_from_state(s: MolochState) -> MolochBdy:
    """Fixed MOLOCH boundary values equal to the current state."""
    z3 = torch.zeros_like(s.t)
    return MolochBdy(pai0=s.pai, pait=z3, t0=s.t, tt=z3,
                     qv0=s.qx[0], qvt=z3, u0=s.u, ut=z3, v0=s.v, vt=z3)


def _as_state(st, cls, from_numpy, mesh, device, dtype):
    """A ``cls`` of tensors on (device, dtype) from either form: numpy
    arrays of the whole domain (such as the JAX package's state after
    ``jax.device_get``) through ``from_numpy``, which cuts them to the
    rank's block under a mesh; or tensors, of the rank's block or of the
    whole domain, which a mesh then cuts."""
    if not isinstance(st[0], torch.Tensor):
        return from_numpy(st, device, dtype, mesh=mesh)
    if mesh is not None and tuple(st[0].shape[-2:]) == (mesh.iy, mesh.jx):
        st = sliced(st, mesh)
    return cls(*(None if v is None else v.to(device=device, dtype=dtype)
                 for v in st))


class Model:
    """Top-level model object (RCM_initialize/run equivalent)."""

    def __init__(self, cfg: RegCMConfig, grid: Optional[ModelGrid] = None,
                 device="cuda", dtype=torch.float64, physics=None,
                 initial_state=None, bdy=None, mesh=None):
        if cfg.core.idynamic not in (1, 2, 3):
            raise ValueError(
                f"coreparam idynamic={cfg.core.idynamic} is not a core "
                "(1 hydrostatic, 2 MM5 non-hydrostatic, 3 MOLOCH)")
        self.cfg = cfg
        self.grid = grid or build_grid(cfg)
        # O'Brien (2010) ensemble perturbation (mod_ensemble.F90 via
        # mod_ncio.F90:176-940): multiplicative noise on the topography
        # at set-up and on every ICBC field read, drawn on the whole
        # domain from one generator in the JAX package's order
        self._perturb_rng = None
        pp = cfg.perturb
        if cfg.globdat.ensemble_run and any(
                getattr(pp, f"lperturb_{n}") for n in
                ("topo", "ts", "ps", "t", "q", "u", "v")):
            self._perturb_rng = np.random.default_rng(pp.extras.get("seed"))
            if pp.lperturb_topo and grid is None:
                # the stored geopotential; the diffusion's topography
                # factor keeps the unperturbed base, as in the JAX package
                self.grid = dataclasses.replace(self.grid, ht=randify(
                    self.grid.ht, pp.perturb_frac_topo, self._perturb_rng))
        if mesh is not None and (mesh.iy, mesh.jx) != (self.grid.iy,
                                                       self.grid.jx):
            raise ValueError(f"{mesh} does not cover the "
                             f"{self.grid.iy}x{self.grid.jx} grid")
        self.mesh = mesh
        self.device = resolve_device(device)
        self.dtype = dtype
        self.idynamic = cfg.core.idynamic
        if physics is False:        # explicit opt-out (dynamics only)
            physics = None
        elif physics is None:
            from .physics.suite import PhysicsSuite
            physics = PhysicsSuite(cfg, self.grid, self.device, dtype,
                                   mesh=mesh)
        self.dtsec = cfg.dtsec
        if self.idynamic == 3:
            self.core = MolochCore(self.grid, cfg, device=self.device,
                                   dtype=dtype, physics=physics, mesh=mesh)
            if initial_state is None:
                initial_state = self.core.initial_state()
            self.state = _as_state(initial_state, MolochState,
                                   moloch_state_from_numpy, mesh,
                                   self.device, dtype)
        else:
            self.core = HydroCore(self.grid, cfg, device=self.device,
                                  dtype=dtype, physics=physics, mesh=mesh)
            if initial_state is None:   # on the whole grid, then cut
                start = nh_initial_state if self.idynamic == 2 \
                    else standard_atmosphere_state
                initial_state = start(self.grid, cfg,
                                      "cpu" if mesh else self.device, dtype)
            self.state = _as_state(initial_state, HydroState,
                                   state_from_numpy, mesh, self.device, dtype)
            if self.idynamic == 1:
                self.state = self.core.init_split_storage(self.state)
        tg0 = self.state.tg.cpu().numpy()
        tg0 = np.where(tg0 > 100.0, tg0, 288.0)
        if getattr(physics, "land_scheme", "") == "bats1e":
            # initbats cold start: slmo soil water, Tg-initialised
            # leaf/subsoil temperatures (mod_bats_common.F90); column by
            # column (per subcell with nsg > 1), on the rank's block
            ss = physics.bats_ss_sub_np if physics.nnsg > 1 \
                else physics.bats_ss_np
            b0 = bats_init_state(ss, self._local(self.grid.lndocn), tg0)
            self.state = self.state._replace(bats=torch.as_tensor(
                b0, dtype=dtype, device=self.device))
        if cfg.physics.lakemod == 1:
            # initlake (mod_ocn_lake.F90:96): the cold-start lake profile,
            # column by column on the rank's block
            dh = np.asarray(self.grid.extras.get(
                "dhlake", np.zeros((self.grid.iy, self.grid.jx))))
            tlak0, _, _ = init_lake(self._local(dh),
                                    self._local(np.asarray(self.grid.xlat)),
                                    tg0, lake_layers(cfg.physics))
            self.state = self.state._replace(tlak=torch.as_tensor(
                tlak0, dtype=dtype, device=self.device))
        # the cached solar forcing's day, and the date it was computed at
        self._solar_key = self._solar_date = None
        if bdy is None:
            bdy = moloch_bdy_from_state(self.state) if self.idynamic == 3 \
                else bdy_from_state(self.state)
        elif self.idynamic == 3:
            bdy = _as_state(bdy, MolochBdy, moloch_bdy_from_numpy, mesh,
                            self.device, dtype)
        else:
            bdy = _as_state(bdy, BdyState, bdy_from_numpy, mesh,
                            self.device, dtype)
        self.bdy = bdy
        self._som_qflx = None        # the SOM file's monthly q-flux
        self.start_date = Date.from_int(cfg.restart.mdate1,
                                        cfg.globdat.calendar)
        self.date = self.start_date
        self.xbctime = 0.0
        self.nstep = 0
        # tracer convective transport (cumtran, mod_tendency.F90:595-603)
        # on the cumulus alarm, for the columns whose scheme does not
        # move tracers itself (Emanuel, Tiedtke: mod_che_cumtran.F90:
        # 56-68); the mask on the rank's block
        self._dotran = None
        if chem_ntr(cfg) > 0 and cfg.chem.ichcumtra == 1:
            land = np.asarray(self.grid.lndocn) > 0.5
            icup = np.where(land, abs(cfg.physics.icup_lnd),
                            abs(cfg.physics.icup_ocn))
            dotran = ~np.isin(icup, (4, 5))
            if dotran.any():
                self._dotran = torch.as_tensor(self._local(dotran),
                                               device=self.device)
                self._dsig = torch.as_tensor(self.grid.dsigma, dtype=dtype,
                                             device=self.device)

    # -- ICBC-driven runs (init/bdyin/bdyval, Main/mod_init.F90 and
    # Main/mod_bdycod.F90:654). Every rank reads the whole record and
    # forms the whole domain's fields on the host (the couplings below
    # read neighbours), then keeps its block.
    def _host(self, a):
        """A record's field (of any byte order) as a host tensor in the
        working dtype."""
        return torch.as_tensor(np.asarray(a, np.float64), dtype=self.dtype)

    def _block(self, t):
        """A whole-domain host tensor as the rank's block on the device."""
        return self._local(t).to(self.device)

    def _maybe_perturb(self, rec):
        """randify each enabled ICBC field of the whole domain on read
        (mod_ncio.F90:863-940), in the order ts, ps, t, q, u, v."""
        if self._perturb_rng is None:
            return rec
        pp = self.cfg.perturb
        out = dict(rec)
        for name, key in (("ts", "ts"), ("ps", "ps"), ("t", "t"),
                          ("q", "qv"), ("u", "u"), ("v", "v")):
            if getattr(pp, "lperturb_" + name) and key in out:
                out[key] = randify(out[key],
                                   getattr(pp, "perturb_frac_" + name),
                                   self._perturb_rng)
        return out

    def _icbc_to_state_fields(self, rec):
        """An ICBC record coupled into the hydrostatic prognostics (p*,
        p*-coupled u, v at dot points, T, qv), and the surface T."""
        rec = self._maybe_perturb(rec)
        T = self._host
        with stencil.topology(self.core.periodic_x, self.core.periodic_y):
            ps = fix_cross_pad(T(rec["ps"]) / 1000.0 - self.grid.ptop)
            psd = stencil.cross2dot(ps)
        t = T(rec["t"]) * ps[None]
        qv = torch.clamp(T(rec["qv"]), min=c.minqq) * ps[None]
        u = T(rec["u"]) * psd[None]
        v = T(rec["v"]) * psd[None]
        return tuple(self._block(a) for a in (ps, u, v, t, qv,
                                               T(rec["ts"])))

    def _icbc_to_moloch_fields(self, rec):
        """An ICBC sigma-level record on the MOLOCH zita levels."""
        rec = self._maybe_perturb(rec)
        f = self.core.fields_from_sigma(rec["ps"], rec["t"], rec["qv"],
                                        rec["u"], rec["v"], self.grid.sigma)
        return {k: self._block(v) for k, v in f.items()}

    def init_from_icbc(self, reader):
        """Cold start from the ICBC record at the current date (mod_init
        cold start), then the first boundary pair."""
        rec, _ = reader.record_at(self.date)
        if self.idynamic == 3:
            f = self._icbc_to_moloch_fields(rec)
            qx = torch.cat([f["qv"][None],
                            torch.zeros_like(self.state.qx[1:])])
            self.state = self.state._replace(
                u=f["u"], v=f["v"], pai=f["pai"], t=f["t"], qx=qx,
                tg=self._block(self._host(rec["ts"])))
        else:
            ps, u, v, t, qv, ts = self._icbc_to_state_fields(rec)
            qx = torch.cat([qv[None], torch.zeros_like(self.state.qx_a[1:])])
            # the NH core as the JAX package starts it: the record's p*
            # taken for the base state's, pp and w as they were (the
            # reference's nhinterp is not modelled)
            self.state = self.state._replace(
                ps_a=ps, ps_b=ps, u_a=u, u_b=u, v_a=v, v_b=v, t_a=t,
                t_b=t, qx_a=qx, qx_b=qx, tg=ts)
            if self.idynamic == 1:
                self.state = self.core.init_split_storage(self.state)
        self._icbc = reader
        self.update_boundary()

    def set_chem_bc(self, reader):
        """Attach a CHBC reader (chem_icbc output): the lateral chemical
        boundaries relax toward its records instead of clean air
        (mod_che_bdyco.F90 chebdy/nudge_chi)."""
        self._chbc = reader
        if getattr(self, "bdy", None) is not None \
                and getattr(self, "_icbc", None) is not None:
            self.update_boundary()

    def _chbc_pair(self, d0, d1, ps0, ps1, dtbdy):
        """The coupled (chi0, chit) boundary pair from the CHBC reader (the
        rank's block of each record); (None, None) without one."""
        reader = getattr(self, "_chbc", None)
        if reader is None or self.core.ntr == 0:
            return None, None
        c0, _ = reader.record_at(d0)
        c1, _ = reader.record_at(d1)
        chi0 = self._block(self._host(c0)) * ps0[None, None]
        chi1 = self._block(self._host(c1)) * ps1[None, None]
        return chi0, (chi1 - chi0) / dtbdy

    def update_boundary(self):
        """bdyin: the records at the current date and ibdyfrq hours on
        form the boundary values b0 and their tendency bt (held constant
        past the file's last record)."""
        reader = self._icbc
        rec0, i0 = reader.record_at(self.date)
        dtbdy = self.cfg.globdat.ibdyfrq * 3600.0
        d1 = self.date.add_seconds(dtbdy)
        rec1, i1 = reader.record_at(d1)
        if i1 == i0:
            dtbdy = 1.0
        if self.idynamic == 3:
            f0 = self._icbc_to_moloch_fields(rec0)
            f1 = self._icbc_to_moloch_fields(rec1)
            pairs = dict(pai0="pai", t0="t", qv0="qv", u0="u", v0="v")
            rdt = 1.0 / dtbdy
            tend = lambda d: d * rdt
            cls = MolochBdy
        else:
            f0, f1 = (dict(zip(("ps", "u", "v", "t", "qv"),
                               self._icbc_to_state_fields(r)))
                      for r in (rec0, rec1))
            pairs = dict(ps0="ps", t0="t", qv0="qv", u0="u", v0="v")
            tend = lambda d: d / dtbdy
            cls = BdyState
        kw = {}
        for b0, k in pairs.items():
            kw[b0] = f0[k]
            kw[b0[:-1] + "t"] = tend(f1[k] - f0[k])
        if cls is BdyState:
            kw["chi0"], kw["chit"] = self._chbc_pair(
                self.date, d1, f0["ps"], f1["ps"], dtbdy)
        if cls is BdyState and self._som_qflx is not None:
            kw["qflb0"] = self._som_value()
        self.bdy = cls(**kw)
        self.xbctime = 0.0

    def run_icbc(self, nsteps: int):
        """Step ``nsteps`` times with the boundary-input alarm every
        ibdyfrq hours; returns (last diags, wall seconds) as ``run``."""
        dtbdy = self.cfg.globdat.ibdyfrq * 3600.0
        t0 = time.time()
        diags = None
        for _ in range(nsteps):
            diags = self.step()
            if self.xbctime >= dtbdy:
                self.update_boundary()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return diags, time.time() - t0

    def step(self):
        """Advance one step (forward-Euler dt first, then leapfrog 2·dt:
        mod_tendency.F90:610-616; MOLOCH is forward in time with dt). The
        NH core steps through ``HydroCore.step_nh``."""
        dt = self.dtsec if (self.nstep == 0 or self.idynamic == 3) \
            else 2.0 * self.dtsec
        flags = self._flags()
        sol = self._solar()
        g = self.grid
        if int(self.cfg.physics.ifixsolar) == 1:
            mu = np.ones((g.iy, g.jx))       # overhead sun everywhere
        else:
            mu = _coszrs(self.date, g.xlat, g.xlon, decl=sol.declin)
        mu = torch.as_tensor(self._local(np.asarray(mu)), dtype=self.dtype,
                             device=self.device)
        # third slot: fractional month position (mid-month nodes)
        mpos = self.date.month + (self.date.day - 15) / 30.0
        step = self.core.step_nh if self.idynamic == 2 else self.core.step
        self.state, diags = step(self.state, self.bdy, self.xbctime, dt,
                                 flags, mu, (sol.eccf, sol.solcon, mpos))
        if self._dotran is not None and flags.do_cum:
            s = self.state
            if self.idynamic == 3:
                (chib,) = cumtran((s.chi_b,), s.cuten[4], self._dsig,
                                  self._dotran)
                self.state = s._replace(chi_b=chib)
            else:
                chia, chib = cumtran((s.chi_a, s.chi_b), s.cuten[4],
                                     self._dsig, self._dotran)
                self.state = s._replace(chi_a=chia, chi_b=chib)
        self.nstep += 1
        self.xbctime += self.dtsec
        self.date = self.date.add_seconds(self.dtsec)
        self.last_diags = diags     # the ATM stream's omega
        return diags

    def _local(self, a):
        """The rank's block of a whole-domain (..., iy, jx) array or tensor
        (the array itself without a mesh)."""
        return a if self.mesh is None else self.mesh.local(a)

    def _solar(self):
        """Daily-cached solar forcing (solar1 on the alarm_day cadence,
        Main/mod_sun.F90:318-326)."""
        if self._solar_key != (self.date.year, self.date.month,
                               self.date.day):
            self._set_solar(self.date)
        return self._solar_val

    def _set_solar(self, date):
        """The day's solar forcing, computed at ``date`` (the solar
        constant moves within the day, so a SAV file keeps the date)."""
        ph = self.cfg.physics
        self._solar_val = solar_state(
            date, year_offset=int(ph.year_offset),
            ifixsolar=int(ph.ifixsolar),
            fixedsolarval=float(ph.fixedsolarval),
            isolconst=int(ph.isolconst))
        self._solar_key = (date.year, date.month, date.day)
        self._solar_date = date

    def _flags(self) -> StepFlags:
        """Physics cadence flags (syncro_rad/srf/cum alarms,
        Main/mpplib/mod_runparams.F90:51-75)."""
        tp = self.cfg.time
        elapsed = self.nstep * self.dtsec

        def hit(interval):
            if interval <= 0:
                return False
            return self.nstep == 0 or (elapsed % interval) < self.dtsec
        do_rad = hit(tp.dtrad_sec)
        return StepFlags(do_rad=do_rad, do_srf=hit(tp.dtsrf),
                         do_cum=hit(max(tp.dtcum, self.dtsec)),
                         first=(self.nstep == 0),
                         do_abem=do_rad and hit(tp.dtabem_sec))

    def run(self, nsteps: int, log_every: int = 0):
        """Step ``nsteps`` times, printing the scalar diagnostics every
        ``log_every`` steps (0: never); returns (last diags, wall seconds)
        with the device synchronised at the end."""
        t0 = time.time()
        diags = None
        for n in range(nsteps):
            diags = self.step()
            if log_every and (n + 1) % log_every == 0:
                d = {k: float(v) for k, v in diags.items()
                     if torch.as_tensor(v).dim() == 0}
                print(f"step {self.nstep} {self.date}: "
                      + " ".join(f"{k}={v:.6g}" for k, v in d.items()))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return diags, time.time() - t0

    # -- checkpoint/resume (mod_savefile; the JAX package's SAV format) --
    def save_restart(self, path: str):
        """Write the state, the boundary pair, the date, the step count
        and the boundary clock to the SAV file ``path``. Under a mesh
        every rank sends its blocks and rank 0 writes."""
        from .io.restart import write_savefile

        def whole(nt):
            if self.mesh is None:
                return nt
            return type(nt)(*(v if v is None or v.numel() == 0
                              else self.mesh.gather(v, dst=0) for v in nt))
        state, bdy = whole(self.state), whole(self.bdy)
        if self.mesh is None or self.mesh.rank == 0:
            write_savefile(path, state, self.date, self.nstep, self.xbctime,
                           bdy=bdy, solar_date=self._solar_date)
        if self.mesh is not None:
            torch.distributed.barrier(self.mesh.group)

    def load_restart(self, path: str):
        """Continue from the SAV file ``path`` (written by either package):
        every rank reads it and keeps its block. Fields the file lacks
        (the zero-size tracers) keep the model's template; the boundary
        pair is the file's; the day's solar forcing is computed at the
        file's solar date (without one, at the next step's date)."""
        from .io.restart import read_savefile
        fields, date, nstep, xbctime, bdy_fields, solar = \
            read_savefile(path)
        g = (self.grid.iy, self.grid.jx)
        cur = self.state
        st = type(cur)(*(
            fields[k] if k in fields
            else np.zeros(tuple(v.shape[:-2]) + g)
            for k, v in cur._asdict().items()))
        cls, from_numpy = (MolochState, moloch_state_from_numpy) \
            if self.idynamic == 3 else (HydroState, state_from_numpy)
        st = _as_state(st, cls, from_numpy, self.mesh, self.device,
                       self.dtype)
        self.state = st._replace(**{k: v for k, v in cur._asdict().items()
                                    if k not in fields})
        self.date = date
        self.nstep = nstep
        self.xbctime = xbctime
        self._solar_key = self._solar_date = None
        if solar is not None:
            self._set_solar(solar)
        if bdy_fields:
            cls, from_numpy = (MolochBdy, moloch_bdy_from_numpy) \
                if self.idynamic == 3 else (BdyState, bdy_from_numpy)
            b = cls(**{k: bdy_fields.get(k) for k in cls._fields})
            self.bdy = _as_state(b, cls, from_numpy, self.mesh, self.device,
                                 self.dtype)

    def attach_icbc(self, reader):
        """Re-attach the ICBC input after a restart: the SAV holds the
        current boundary pair and clock, so the next update comes at the
        next ibdyfrq alarm."""
        self._icbc = reader

    # -- SOM q-flux (open_som/read_som, Main/mod_ncio.F90:753-770,
    # 1130-1169) ------------------------------------------------------------
    def attach_som(self, path: str):
        """Attach a SOM monthly q-flux file, the slab ocean's
        ``do_qflux_adj`` heat-flux adjustment: the 12 monthly records are
        mid-month nodes, and the month-interpolated value goes into
        ``bdy.qflb0`` at every boundary update."""
        from .io.ncio import read_nc
        q = np.asarray(read_nc(path)["qflx"], dtype=np.float64)
        if q.shape[0] != 12:
            raise ValueError(f"SOM file {path}: expected 12 monthly qflx "
                             f"records, got {q.shape[0]}")
        iy, jx = self.grid.iy, self.grid.jx
        if q.shape[-2:] != (iy, jx):
            # an interior-extent file: edge-replicated to the full grid
            q = np.pad(q, ((0, 0), (0, iy - q.shape[-2]),
                           (0, jx - q.shape[-1])), mode="edge")
        self._som_qflx = torch.as_tensor(self._local(q), dtype=self.dtype,
                                         device=self.device)
        if self.bdy is not None and hasattr(self.bdy, "qflb0"):
            self.bdy = self.bdy._replace(qflb0=self._som_value())

    def _som_value(self):
        """Mid-month linear interpolation of the monthly qflx (som_search's
        month bracketing, mod_ncio.F90:1080-1128)."""
        d = self.date
        pos = d.month + (d.day - 15) / 30.0          # mid-month nodes
        m0 = int(np.floor(pos)) if pos >= 1 else 12
        w = pos - np.floor(pos)
        i0, i1 = (m0 - 1) % 12, m0 % 12
        return (1.0 - w) * self._som_qflx[i0] + w * self._som_qflx[i1]

    # -- output streams (output(), Main/mod_output.F90:73) ---------------
    def open_output(self, outdir: Optional[str] = None, append: bool = False,
                    backend: Optional[str] = None):
        """Open the output streams in ``outdir`` (outparam dirout by
        default); ``append`` continues a restarted run's files;
        ``backend`` "netcdf" or "zarr" (outparam backend by default)."""
        from .io.output import OutputStreams
        outdir = outdir or self.cfg.out.dirout
        backend = backend or self.cfg.out.backend
        self.streams = OutputStreams(self, outdir, self.cfg.terrain.domname,
                                     append=append, backend=backend)
        return self.streams

    def run_with_output(self, nsteps: int):
        """Step with the output alarms: ATM every atmfrq hours, SRF, LAK,
        SUB and SLABOC every srffrq, RAD every radfrq, CHE and OPT every
        chemfrq; STS accumulates every step and writes at each day
        boundary. A run that has written no record yet writes the initial
        one first."""
        if not hasattr(self, "streams"):
            self.open_output()
        o = self.cfg.out
        every = lambda hours: max(int(hours * 3600.0 / self.dtsec), 1)
        atm_every, srf_every, rad_every, che_every = (
            every(o.atmfrq), every(o.srffrq), every(o.radfrq),
            every(o.chemfrq))
        st = self.streams
        if st.atm.nrec == 0:
            for w in (st.write_atm, st.write_srf, st.write_rad,
                      st.write_lak, st.write_che, st.write_opt,
                      st.write_slaboc):
                w()
        for _ in range(nsteps):
            self.step()
            st.sts_accumulate()
            if self.nstep % atm_every == 0:
                st.write_atm()
            if self.nstep % srf_every == 0:
                st.write_srf()
                st.write_lak()
                st.write_sub()
            if self.nstep % rad_every == 0:
                st.write_rad()
            if self.nstep % che_every == 0:
                st.write_che()
                st.write_opt()
            if self.nstep % srf_every == 0:
                st.write_slaboc()
        return st

    def check_finite(self) -> bool:
        """Whether every field is finite (on every rank)."""
        ok = torch.stack([torch.isfinite(x).all() for x in self.state])
        ok = ok.all().to(torch.int32)
        if self.mesh is not None:
            ok = self.mesh.all_reduce(ok, torch.distributed.ReduceOp.MIN)
        return bool(ok)

    def decoupled(self) -> Dict[str, np.ndarray]:
        """Physical-unit prognostics on the host (of the whole domain,
        on every rank)."""
        out = self.core.decoupled(self.state)
        if self.mesh is not None:
            out = {k: self.mesh.gather(v) for k, v in out.items()}
        return {k: v.cpu().numpy() for k, v in out.items()}

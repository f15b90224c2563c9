"""What the ranks of ``tests/test_torch_parallel.py`` run.

Each function here runs in a process of a ``torch.distributed`` group
started by ``regcm_tpu_torch.parallel.launch.spawn`` (gloo, CPU): the
decomposed runs of both cores and, on one rank each, the undecomposed
references they are held to. The settings (``HYDRO``, ``ICBC``) are
applied to either package's ``RegCMConfig``, so the JAX references in
the test modules use them too. This module imports neither ``jax`` nor
the JAX package, so the ranks never load them.
"""
import numpy as np
import torch

from . import _torch_chem_settings as C
from . import _torch_surface_settings as S

# every (dy, dx) of the MOLOCH step's shift/shifte (dynamics/moloch.py)
# and of cross2dot/dot2cross, and the 2-wide reach of the WAF halo
SHIFTS = [(0, 1), (1, 0), (0, -1), (-1, 0), (1, -1), (-1, 1), (1, 1),
          (-1, -1), (0, 2), (2, 0), (0, -2), (-2, 0)]
MOLOCH_FIELDS = ("pai", "t", "u", "v", "w", "qx")
# the chemistry on 2x2 ranks: AERO with configuration E's physics (the
# band, Emanuel's tracer transport, the tracers' K5c solve), DUST with
# the direct effect and the well-mixed transport over land
CHEM = ("AERO", "DUST")
MODEL_STEPS = 6


def field(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape)


def hill(iy, jx, seed=5):
    """Seeded Gaussian hill, ~800 m, on the (iy-1, jx-1) cross grid."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(iy - 1), np.arange(jx - 1),
                         indexing="ij")
    return 800.0 * np.exp(-(((yy - 7.0) / 3.5) ** 2
                            + ((xx - 9.0) / 4.0) ** 2)) \
        + 20.0 * rng.random((iy - 1, jx - 1))


def moloch_cfg(iy=16, jx=16, kz=14):
    """``dryrun_multichip``'s MOLOCH settings (``__graft_entry__.py``
    :223-243) on the port's ``RegCMConfig()``."""
    from regcm_tpu_torch.config.params import RegCMConfig
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = iy, jx, kz
    cfg.geo.ds = 10.0
    cfg.time.dt = 60.0
    cfg.core.idynamic = 3
    return cfg


def dryrun_moloch(mesh=None, device="cpu", steps=3):
    """``dryrun_multichip``'s MOLOCH trajectory: the perturbed (0.2 K)
    rest state on flat terrain, three full-physics steps with every
    alarm on step 0 and surface and cumulus after, cos(zenith) 0.4,
    eccf 1.0343, solar constant 1361.8. Returns the prognostics of the
    whole domain (on every rank of a mesh)."""
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.core.state import StepFlags
    from regcm_tpu_torch.driver import moloch_bdy_from_state
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    from regcm_tpu_torch.physics.suite import PhysicsSuite
    cfg = moloch_cfg()
    grid = build_grid(cfg)
    core = MolochCore(grid, cfg, device=device, dtype=torch.float64,
                      physics=PhysicsSuite(cfg, grid, device, torch.float64,
                                           mesh=mesh), mesh=mesh)
    st = core.initial_state(perturb=0.2)
    bdy = moloch_bdy_from_state(st)
    mu = torch.full_like(st.tg, 0.4)
    xt = 0.0
    for n in range(steps):
        flags = StepFlags(do_rad=True, do_srf=True, do_cum=True,
                          do_abem=True, first=True) if n == 0 \
            else StepFlags(do_rad=False, do_srf=True, do_cum=True)
        st, diags = core.step(st, bdy, xt, cfg.dtsec, flags, mu,
                              (1.0343, 1361.8))
        xt += cfg.dtsec
    out = {k: getattr(st, k) for k in MOLOCH_FIELDS}
    if mesh is not None:
        out = {k: mesh.gather(v) for k, v in out.items()}
    out = {k: v.numpy() for k, v in out.items()}
    out["diags"] = {k: float(v) for k, v in diags.items()}
    return out


def model_run(mesh=None, device="cpu", dtype=torch.float64):
    """``Model`` with the default physics on the 16x16x14 hill for
    ``MODEL_STEPS`` steps (cumulus at 0 and 5, surface and radiation at
    0) from the 0.3 K perturbed rest state: the decoupled fields of the
    whole domain and whether they stayed finite."""
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    cfg = moloch_cfg()
    grid = build_grid(cfg, ht=hill(cfg.dim.iy, cfg.dim.jx))
    m = Model(cfg, grid=grid, device=device, dtype=dtype, mesh=mesh)
    m.run(MODEL_STEPS)
    return dict(dec=m.decoupled(), finite=m.check_finite())


# the hydrostatic settings of the JAX package's sharding gates, rebuilt
# on RegCMConfig(): dryrun_multichip's dynamics (__graft_entry__.py
# :104-130) and full physics with every alarm at step 0 (:136-215), and
# tests/test_parallel.py:62-160's 18x24x14 pair; each starts from the
# perturbed standard atmosphere with a 10 m/s jet and qv lifted off the
# minqq floor. "record": the steps after which the state is kept.
HYDRO = {
    "dryrun_dyn": dict(iy=16, jx=16, ipptls=0, perturb=0.3, seed=0,
                       physics=False, first=True, record=(3,)),
    "dryrun_phys": dict(iy=16, jx=16, perturb=0.2, seed=3, physics=True,
                        solar=(1.0343, 1361.8), record=(1, 3)),
    "parallel_dyn": dict(iy=18, jx=24, ds=60.0, dt=120.0, ipptls=0,
                         perturb=0.2, seed=3, physics=False, first=False,
                         record=(10,)),
    "parallel_phys": dict(iy=18, jx=24, ds=60.0, dt=120.0, ipptls=1,
                          perturb=0.2, seed=3, physics=True, solar=None,
                          record=(1, 4)),
    # parallel_dyn with the semi-Lagrangian moisture advection, without
    # and with the QMSL limiter (ROADMAP item 10e)
    "parallel_sl0": dict(iy=18, jx=24, ds=60.0, dt=120.0, ipptls=0,
                         isladvec=1, iqmsl=0, perturb=0.2, seed=3,
                         physics=False, first=False, record=(10,)),
    "parallel_sl1": dict(iy=18, jx=24, ds=60.0, dt=120.0, ipptls=0,
                         isladvec=1, iqmsl=1, perturb=0.2, seed=3,
                         physics=False, first=False, record=(10,)),
    # tests/test_parallel.py:237-264's band pair: x-periodic, Mercator
    # about the equator, 18x32x14, six dynamics steps
    "parallel_band": dict(iy=18, jx=32, ds=60.0, dt=120.0, ipptls=0,
                          band=True, perturb=0.2, seed=7, physics=False,
                          first=False, record=(6,)),
}


def hydro_setup(cfg, name):
    """Apply a HYDRO setting's overrides (kz 14) to ``cfg``, a
    RegCMConfig of either package, and return it."""
    st = HYDRO[name]
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = st["iy"], st["jx"], 14
    if "ds" in st:
        cfg.geo.ds = st["ds"]
        cfg.time.dt = st["dt"]
    for name in ("ipptls", "isladvec", "iqmsl"):
        if name in st:
            setattr(cfg.physics, name, st[name])
    if st.get("band"):
        cfg.geo.i_band = 1
        cfg.geo.iproj, cfg.geo.clat = "NORMER", 0.0
    return cfg


def hydro_flags(name, n):
    """The StepFlags fields of step ``n`` of a HYDRO setting: every alarm
    on step 0 and surface and cumulus after (physics), or the dynamics
    settings' constant flags."""
    st = HYDRO[name]
    if not st["physics"]:
        return dict(first=st["first"])
    if n == 0:
        return dict(do_rad=True, do_srf=True, do_cum=True, do_abem=True,
                    first=True)
    return dict(do_rad=False, do_srf=True, do_cum=True)


def hydro_run(name, mesh=None, device="cpu"):
    """A HYDRO setting's trajectory through ``HydroCore.step`` (f64): the
    whole domain's state fields after each recorded step (on every rank
    of a mesh), zero-size fields left out. The start is built on the
    whole grid and cut to the rank's block."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.core.state import StepFlags, bdy_from_state, sliced
    from regcm_tpu_torch.driver import Model, standard_atmosphere_state
    from regcm_tpu_torch.dynamics.stencil import cross2dot
    st = HYDRO[name]
    cfg = hydro_setup(RegCMConfig(), name)
    grid = build_grid(cfg)
    m = Model(cfg, grid=grid, device=device, dtype=torch.float64,
              physics=None if st["physics"] else False, mesh=mesh)
    s = standard_atmosphere_state(grid, cfg, "cpu", torch.float64,
                                  perturb=st["perturb"], seed=st["seed"])
    u = 10.0 * cross2dot(s.ps_a)[None] * torch.ones_like(s.u_a)
    qv = torch.maximum(s.qx_a[0], 1e-5 * s.ps_a[None])
    qx = torch.cat([qv[None], s.qx_a[1:]])
    s = s._replace(u_a=u, u_b=u, qx_a=qx, qx_b=qx)
    if st["physics"]:
        s = s._replace(tg=s.t_a[-1] / s.ps_a)
    s = sliced(s, mesh)
    s = s._replace(**{k: v.to(device) for k, v in s._asdict().items()})
    if st["physics"]:
        s = s._replace(bats=m.state.bats)
    s = m.core.init_split_storage(s)
    bdy = bdy_from_state(s)
    mu = torch.full_like(s.tg, 0.4)
    xt, dt = 0.0, cfg.dtsec
    out = {}
    for n in range(max(st["record"])):
        flags = StepFlags(**hydro_flags(name, n))
        if st["physics"]:
            s, _ = m.core.step(s, bdy, xt, dt, flags, mu, st["solar"])
        else:
            s, _ = m.core.step(s, bdy, xt, dt, flags)
        xt += cfg.dtsec
        dt = 2.0 * cfg.dtsec
        if n + 1 in st["record"]:
            out[n + 1] = _whole(s, mesh)
    return out


def _whole(nt, mesh):
    """Field name -> the whole domain's numpy array of a NamedTuple of
    tensors (gathered under a mesh); None and zero-size fields left
    out."""
    f = {k: v for k, v in nt._asdict().items()
         if v is not None and v.numel()}
    if mesh is not None:
        f = {k: mesh.gather(v) for k, v in f.items()}
    return {k: v.cpu().numpy() for k, v in f.items()}


# the ICBC-driven runs, rebuilt on RegCMConfig(): tests/test_preproc.py
# :82-99's pipeline (terrain, DOMAIN file, ICBC file, a 500 m hill, an
# 8 m/s jet) and tests/test_moloch.py:104-131's MOLOCH start (the model
# grid flat under the records of a 1500 m hill, a 10 m/s jet), each with
# hourly boundary records over a one-day window, so that the run crosses
# the update after step 24 (dt 150 s) or 60 (dt 60 s). The records'
# jet strengthens by ``djet`` m/s a record, so that the boundary moves.
# "record": the steps after which the fields are kept.
ICBC = {
    "hydro": dict(iy=20, jx=28, kind="gauss", height=500.0, jet=8.0,
                  djet=1.0, record=(25,)),
    "moloch": dict(idynamic=3, iy=20, jx=24, kz=20, ds=20.0, dt=60.0,
                   kind="gauss", height=1500.0, jet=10.0, djet=1.0,
                   record=(4, 61)),
}


def icbc_setup(cfg, kind):
    """Apply an ICBC setting's overrides to ``cfg`` (a RegCMConfig of
    either package) and return it."""
    st = ICBC[kind]
    cfg.dim.iy, cfg.dim.jx = st["iy"], st["jx"]
    cfg.core.idynamic = st.get("idynamic", 1)
    if "kz" in st:
        cfg.dim.kz = st["kz"]
        cfg.geo.ds = st["ds"]
        cfg.time.dt = st["dt"]
    cfg.globdat.gdate2 = 1990060200
    cfg.globdat.ibdyfrq = 1
    return cfg


def icbc_model(kind, paths, mesh=None, device="cpu", init=True):
    """The port's Model of an ICBC setting (f64) on the grid of the files
    in ``paths`` (``icbc``, and ``domain`` where the setting has one),
    cold-started from the ICBC file unless ``init`` is false."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    cfg = icbc_setup(RegCMConfig(), kind)
    grid = build_grid_from_domain(cfg, paths["domain"]) \
        if "domain" in paths else None
    m = Model(cfg, grid=grid, device=device, dtype=torch.float64, mesh=mesh)
    if init:
        m.init_from_icbc(ICBCReader(paths["icbc"], cfg.globdat.calendar))
    return m


# restart chains: the ICBC hydrostatic run writes a SAV after step 22,
# and a fresh Model loaded from it runs to the run's step 25, past the
# hourly update after step 24 and the radiation step 24; MOLOCH at
# dryrun_multichip's size from noon, saved at step 3 and run to 6, with
# radiation at 4 and surface and cumulus every two steps
HYDRO_SAV_STEP = 22
MOLOCH_CHAIN = (3, 6)


def _clock(m):
    return (m.nstep, m.xbctime, m.date.to_seconds())


def icbc_run(kind, paths, mesh=None, device="cpu", workdir=None):
    """An ICBC setting driven by the port's Model from the files in
    ``paths``: the whole domain's state and boundary after
    ``init_from_icbc`` ("init", "bdy0"), then after each recorded step of
    ``run_icbc`` the state, boundary, decoupled fields, step count and
    boundary clocks (on every rank of a mesh). Given a ``workdir``, the
    hydrostatic run is also a restart chain: it writes a SAV there after
    HYDRO_SAV_STEP, and "restart" holds a fresh Model loaded from it
    (the reader re-attached) and run to the last recorded step."""
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    m = icbc_model(kind, paths, mesh, device)
    out = dict(init=_whole(m.state, mesh), bdy0=_whole(m.bdy, mesh))
    chain = workdir is not None and kind == "hydro"
    sav = f"{workdir}/{kind}_{'single' if mesh is None else 'mesh'}_SAV.nc"
    for n in ICBC[kind]["record"]:
        if chain and m.nstep < HYDRO_SAV_STEP <= n:
            m.run_icbc(HYDRO_SAV_STEP - m.nstep)
            m.save_restart(sav)
        m.run_icbc(n - m.nstep)
        out[n] = dict(state=_whole(m.state, mesh), bdy=_whole(m.bdy, mesh),
                      dec=m.decoupled(), finite=m.check_finite(),
                      nstep=m.nstep, xbctime=m.xbctime, clock=_clock(m))
    if chain:
        b = icbc_model(kind, paths, mesh, device, init=False)
        b.load_restart(sav)
        b.attach_icbc(ICBCReader(paths["icbc"], b.cfg.globdat.calendar))
        b.run_icbc(m.nstep - HYDRO_SAV_STEP)
        out["restart"] = dict(state=_whole(b.state, mesh),
                              bdy=_whole(b.bdy, mesh), clock=_clock(b))
    return out


def moloch_chain_model(mesh=None):
    """The MOLOCH restart chain's model (f64, on the rank's block)."""
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    cfg = moloch_cfg()
    cfg.restart.mdate1 = 1990060112         # the sun up over the domain
    cfg.time.dtrad = 4.0                    # minutes: steps 0 and 4
    cfg.time.dtsrf = cfg.time.dtcum = 120.0
    grid = build_grid(cfg, ht=hill(cfg.dim.iy, cfg.dim.jx))
    st = MolochCore(grid, cfg, device="cpu").initial_state(perturb=0.3,
                                                             seed=1)
    return Model(cfg, grid=grid, device="cpu", initial_state=st, mesh=mesh)


def moloch_chain(workdir, mesh=None):
    """The MOLOCH restart chain: run A to MOLOCH_CHAIN's end with a SAV at
    its middle step, run B loaded from the SAV to the same end; the whole
    domain's state, boundary and clocks of each (on every rank)."""
    mid, end = MOLOCH_CHAIN
    sav = f"{workdir}/moloch_{'single' if mesh is None else 'mesh'}_SAV.nc"
    a = moloch_chain_model(mesh)
    a.run(mid)
    a.save_restart(sav)
    a.run(end - mid)
    b = moloch_chain_model(mesh)
    b.load_restart(sav)
    b.run(end - mid)
    return {k: dict(state=_whole(m.state, mesh), bdy=_whole(m.bdy, mesh),
                    clock=_clock(m)) for k, m in (("a", a), ("b", b))}


# the output streams: the hydrostatic core at 16x16x14 (dt 150 s, the
# dynamics alone), a record every two steps on ATM, SRF and RAD over four
# steps, then the day's STS statistics so far
OUTPUT_STEPS = 4


def output_run(workdir, backend, mesh=None):
    """run_with_output on one rank or 2x2 into its own directory; returns
    the directory."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model
    cfg = RegCMConfig()
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = 16, 16, 14
    cfg.out.atmfrq = cfg.out.srffrq = cfg.out.radfrq = \
        2 * cfg.time.dt / 3600.0
    m = Model(cfg, grid=build_grid(cfg, ht=hill(16, 16)), device="cpu",
              physics=False, mesh=mesh)
    d = f"{workdir}/out_{backend}_{'single' if mesh is None else 'mesh'}"
    m.open_output(d, backend=backend)
    m.run_with_output(OUTPUT_STEPS)
    m.streams.write_sts()
    m.streams.close()
    return d


def ensemble_cfg(cfg):
    """The ICBC hydrostatic setting (a RegCMConfig of either package)
    with every ensemble perturbation, 1% each, seed 1234."""
    icbc_setup(cfg, "hydro")
    cfg.globdat.ensemble_run = True
    for n in ("topo", "ts", "ps", "t", "q", "u", "v"):
        setattr(cfg.perturb, f"lperturb_{n}", True)
        setattr(cfg.perturb, f"perturb_frac_{n}", 0.01)
    cfg.perturb.extras["seed"] = 1234
    return cfg


def ensemble_run(icbc_paths, mesh=None):
    """An ensemble member from the ICBC file on its own (flat) grid, the
    dynamics alone: the whole domain's state and boundary after the cold
    start and 3 steps, and its mass budget (summed over the ranks)."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.utils.service import mass_budget
    cfg = ensemble_cfg(RegCMConfig())
    m = Model(cfg, device="cpu", physics=False, mesh=mesh)
    m.init_from_icbc(ICBCReader(icbc_paths["hydro"]["icbc"],
                                cfg.globdat.calendar))
    m.run_icbc(3)
    b = mass_budget(m.state, m.grid, m.grid.dsigma, mesh)
    return dict(state=_whole(m.state, mesh), bdy=_whole(m.bdy, mesh),
                mass={k: float(v) for k, v in b.items()})


# the undecomposed runs the 2x2 group is held to, each run on one rank of
# the group (after the decomposed work) so that both sides use the same
# CPU kernels
SINGLE = [("icbc", "moloch"), ("icbc", "hydro"), ("dryrun", None),
          ("model", None)] + [("hydro", name) for name in HYDRO] \
    + [("periodic", kind) for kind in S.PERIODIC] \
    + [("moloch_chain", None)] \
    + [("output", b) for b in ("netcdf", "zarr")] + [("ensemble", None)] \
    + [("chem", name) for name in CHEM]


def chem_run(name, mesh=None):
    """A chemistry setting of ``_torch_chem_settings`` from the port's own
    start (f64, the whole domain's fields); on a mesh with the rank's
    halo exchanges."""
    from regcm_tpu_torch.parallel import halo
    halo.exchanges = 0
    out = C.port_run(name, C.port_start(name), mesh=mesh)
    out["exchanges"] = halo.exchanges
    return out


def single(kind, arg, icbc_paths, workdir):
    if kind == "icbc":
        return icbc_run(arg, icbc_paths[arg], workdir=workdir)
    if kind == "periodic":
        return S.periodic_run(arg)
    if kind == "hydro":
        return hydro_run(arg)
    if kind == "moloch_chain":
        return moloch_chain(workdir)
    if kind == "output":
        return output_run(workdir, arg)
    if kind == "ensemble":
        return ensemble_run(icbc_paths)
    if kind == "chem":
        return chem_run(arg)
    return dryrun_moloch() if kind == "dryrun" else model_run()


def two_by_two(rank, iy, jx, k5_inputs, icbc_paths, workdir):
    """Everything the 2x2 group checks, in one group: halo extensions,
    a gather to rank 0, every MOLOCH shift, K5a/b/c on the rank's
    blocks, the MOLOCH dryrun trajectory with the halo counters, the
    MOLOCH Model run, the hydrostatic settings, both ICBC-driven runs,
    the periodic runs of ``_torch_surface_settings.PERIODIC``, the
    restart chains, the output streams on both backends, an ensemble
    member (files under ``workdir``) and the chemistry settings CHEM;
    then this rank's share of the undecomposed references (SINGLE)."""
    from regcm_tpu_torch.dynamics.stencil import (cross2dot, dot2cross,
                                                  shift, shifte, topology)
    from regcm_tpu_torch.kernels import pbl_tridiag as k1
    from regcm_tpu_torch.kernels import tridiag_w as k3
    from regcm_tpu_torch.kernels import waf_advect as k4
    from regcm_tpu_torch.parallel import halo

    out = dict(halo=halo_blocks(rank, iy, jx))
    mesh = rank.mesh(iy, jx)
    a = torch.as_tensor(mesh.local(field((3, iy, jx), seed=1)))
    on0 = mesh.gather(a, dst=0)
    out["gathered"] = None if on0 is None else on0.numpy()
    sh = {}
    with topology(mesh=mesh):
        for dy, dx in SHIFTS:
            sh[("shift", dy, dx)] = shift(a, dy, dx).numpy()
            sh[("shifte", dy, dx)] = shifte(a, dy, dx).numpy()
        sh["cross2dot"] = cross2dot(a).numpy()
        sh["dot2cross"] = dot2cross(a).numpy()
    out["shifts"] = sh

    waf, dtrdx, dtrdz, tw, pb = k5_inputs
    kmesh = rank.mesh(*waf[0].shape[-2:])
    T = lambda x: torch.as_tensor(kmesh.local(x))
    out["k5"] = dict(
        waf=k4.waf_advect_sharded(kmesh, *map(T, waf), dtrdx, dtrdz).numpy(),
        tw=k3.tridiag_w_sharded(kmesh, *map(T, tw)).numpy(),
        pb=k1.pbl_tridiag_sharded(kmesh, *map(T, pb)).numpy())

    halo.exchanges = halo.bytes_sent = 0
    out["dryrun"] = dryrun_moloch(mesh)
    out["dryrun_halo"] = (halo.exchanges, halo.bytes_sent)
    out["model"] = model_run(mesh)
    out["hydro"] = {}
    for name, st in HYDRO.items():
        halo.exchanges = 0
        out["hydro"][name] = hydro_run(name, rank.mesh(st["iy"], st["jx"]))
        out["hydro"][name]["exchanges"] = halo.exchanges
    out["icbc"] = {kind: icbc_run(kind, icbc_paths[kind],
                                  rank.mesh(st["iy"], st["jx"]),
                                  workdir=workdir)
                   for kind, st in ICBC.items()}
    out["periodic"] = {}
    for kind, st in S.PERIODIC.items():
        halo.exchanges = 0
        pmesh = rank.mesh(*S.SHAPE[:2]) if kind == "band_slab" \
            else rank.mesh(st["iy"], st["jx"])
        out["periodic"][kind] = S.periodic_run(kind, pmesh)
        out["periodic"][kind]["exchanges"] = halo.exchanges
    out["moloch_chain"] = moloch_chain(workdir, rank.mesh(16, 16))
    omesh = rank.mesh(16, 16)
    out["output"] = {b: output_run(workdir, b, omesh)
                     for b in ("netcdf", "zarr")}
    out["ensemble"] = ensemble_run(icbc_paths, rank.mesh(
        ICBC["hydro"]["iy"], ICBC["hydro"]["jx"]))
    out["chem"] = {name: chem_run(name, rank.mesh(*C.SHAPE[:2]))
                   for name in CHEM}
    out["single"] = {case: single(*case, icbc_paths, workdir)
                     for n, case in enumerate(SINGLE)
                     if n % rank.world == rank.rank}
    return out


def halo_blocks(rank, iy, jx):
    """halo_expand2d of the rank's block of a seeded (3, iy, jx) field,
    for both fills, with and without a periodic x axis."""
    from regcm_tpu_torch.parallel.halo import halo_expand2d
    mesh = rank.mesh(iy, jx)
    a = torch.as_tensor(mesh.local(field((3, iy, jx))))
    return {(mode, per): halo_expand2d(a, mesh, 2, mode,
                                       periodic_x=per).numpy()
            for mode in ("zero", "edge") for per in (False, True)}


def fail_on(rank, which):
    """Raise on rank ``which``; the others wait for it at a barrier."""
    if rank.rank == which:
        raise ValueError(f"rank {which} fails on purpose")
    import torch.distributed as dist
    dist.barrier()

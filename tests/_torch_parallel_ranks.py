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

# every (dy, dx) of the MOLOCH step's shift/shifte (dynamics/moloch.py)
# and of cross2dot/dot2cross, and the 2-wide reach of the WAF halo
SHIFTS = [(0, 1), (1, 0), (0, -1), (-1, 0), (1, -1), (-1, 1), (1, 1),
          (-1, -1), (0, 2), (2, 0), (0, -2), (-2, 0)]
MOLOCH_FIELDS = ("pai", "t", "u", "v", "w", "qx")
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
}


def hydro_setup(cfg, name):
    """Apply a HYDRO setting's overrides (kz 14) to ``cfg``, a
    RegCMConfig of either package, and return it."""
    st = HYDRO[name]
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = st["iy"], st["jx"], 14
    if "ds" in st:
        cfg.geo.ds = st["ds"]
        cfg.time.dt = st["dt"]
    if "ipptls" in st:
        cfg.physics.ipptls = st["ipptls"]
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


def icbc_run(kind, paths, mesh=None, device="cpu"):
    """An ICBC setting driven by the port's Model from the files in
    ``paths`` (``icbc``, and ``domain`` for the grid where the setting
    has one): the whole domain's state and boundary after
    ``init_from_icbc`` ("init", "bdy0"), then after each recorded step of
    ``run_icbc`` the state, boundary, decoupled fields, step count and
    boundary clock (on every rank of a mesh)."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.driver import Model
    from regcm_tpu_torch.preproc.icbc import ICBCReader
    from regcm_tpu_torch.preproc.terrain import build_grid_from_domain
    cfg = icbc_setup(RegCMConfig(), kind)
    grid = build_grid_from_domain(cfg, paths["domain"]) \
        if "domain" in paths else None
    m = Model(cfg, grid=grid, device=device, dtype=torch.float64, mesh=mesh)
    m.init_from_icbc(ICBCReader(paths["icbc"], cfg.globdat.calendar))
    out = dict(init=_whole(m.state, mesh), bdy0=_whole(m.bdy, mesh))
    for n in ICBC[kind]["record"]:
        m.run_icbc(n - m.nstep)
        out[n] = dict(state=_whole(m.state, mesh), bdy=_whole(m.bdy, mesh),
                      dec=m.decoupled(), finite=m.check_finite(),
                      nstep=m.nstep, xbctime=m.xbctime)
    return out


# the undecomposed runs the 2x2 group is held to, each run on one rank of
# the group (after the decomposed work) so that both sides use the same
# CPU kernels
SINGLE = [("icbc", "moloch"), ("icbc", "hydro"), ("dryrun", None),
          ("model", None)] + [("hydro", name) for name in HYDRO]


def single(kind, arg, icbc_paths):
    if kind == "icbc":
        return icbc_run(arg, icbc_paths[arg])
    if kind == "hydro":
        return hydro_run(arg)
    return dryrun_moloch() if kind == "dryrun" else model_run()


def two_by_two(rank, iy, jx, k5_inputs, icbc_paths):
    """Everything the 2x2 group checks, in one group: halo extensions,
    a gather to rank 0, every MOLOCH shift, K5a/b/c on the rank's
    blocks, the MOLOCH dryrun trajectory with the halo counters, the
    MOLOCH Model run, the hydrostatic settings and both ICBC-driven runs;
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
                                  rank.mesh(st["iy"], st["jx"]))
                   for kind, st in ICBC.items()}
    out["single"] = {case: single(*case, icbc_paths)
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

"""What the ranks of ``tests/test_torch_parallel.py`` run.

Each function here runs in a process of a ``torch.distributed`` group
started by ``regcm_tpu_torch.parallel.launch.spawn`` (gloo, CPU), or in
the test process itself for the single-rank reference. This module
imports neither ``jax`` nor the JAX package, so the ranks never load
them.
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


def two_by_two(rank, iy, jx, k5_inputs):
    """Everything the 2x2 group checks, in one group: halo extensions,
    a gather to rank 0, every MOLOCH shift, K5a/b/c on the rank's
    blocks, the dryrun trajectory with the halo counters, and the Model
    run."""
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

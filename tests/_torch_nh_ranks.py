"""The MM5 non-hydrostatic core's settings of ``tests/test_torch_nh.py``
and what the ranks of its 2x2 group run.

``NH`` is applied to either package's ``RegCMConfig``, so the JAX side
of the tests uses the same settings. This module imports neither ``jax``
nor the JAX package, so the ranks never load them.
"""
import numpy as np

from ._torch_parallel_ranks import hill

# 16x20x14 over the test hill, ds 10 km, dt 30 s, the radiative top
# (ifupr=1, the default); "dyn": the dynamics alone (no saturation
# adjustment, whose threshold branches turn roundoff into 1e-8
# differences of qc), 10 steps; "phys": Model with the default physics
# for 3 steps (every alarm at step 0)
NH = dict(iy=16, jx=20, kz=14, ds=10.0, dt=30.0, perturb=0.3, seed=1,
          dyn_steps=10, phys_steps=3)
STATE_FIELDS = ("u_a", "v_a", "t_a", "qx_a", "pp_a", "w_a", "u_b", "v_b",
                "t_b", "qx_b", "pp_b", "w_b")


def nh_cfg(cfg, dyn=False, **physics):
    """Apply NH's overrides (and ``physics`` ones) to ``cfg``, a
    RegCMConfig of either package, and return it."""
    cfg.core.idynamic = 2
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = NH["iy"], NH["jx"], NH["kz"]
    cfg.geo.ds = NH["ds"]
    cfg.time.dt = NH["dt"]
    if dyn:
        cfg.physics.ipptls = 0
    for k, v in physics.items():
        setattr(cfg.physics, k, v)
    return cfg


def nh_hill(iy=NH["iy"], jx=NH["jx"]):
    return hill(iy, jx)


def whole(nt, mesh, names=STATE_FIELDS):
    """The named fields of a NamedTuple of tensors as the whole domain's
    numpy arrays (gathered under a mesh)."""
    f = {k: getattr(nt, k) for k in names}
    if mesh is not None:
        f = {k: mesh.gather(v) for k, v in f.items()}
    return {k: v.cpu().numpy() for k, v in f.items()}


def dyn_run(mesh=None, device="cpu", steps=NH["dyn_steps"], **physics):
    """The dynamics-only setting through ``HydroCore.step_nh`` (f64) from
    the port's ``nh_initial_state`` with constant StepFlags and the
    boundary held at the start; the whole domain's state fields and the
    last step's diagnostics."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.core.state import StepFlags, bdy_from_state, sliced
    from regcm_tpu_torch.driver import nh_initial_state
    from regcm_tpu_torch.dynamics.hydrostatic import HydroCore
    cfg = nh_cfg(RegCMConfig(), dyn=True, **physics)
    grid = build_grid(cfg, ht=nh_hill())
    core = HydroCore(grid, cfg, device=device, mesh=mesh)
    s = nh_initial_state(grid, cfg, "cpu", perturb=NH["perturb"],
                         seed=NH["seed"])
    s = sliced(s, mesh)
    s = s._replace(**{k: v.to(device) for k, v in s._asdict().items()})
    bdy = bdy_from_state(s)
    xt, dt = 0.0, cfg.dtsec
    for _ in range(steps):
        s, diags = core.step_nh(s, bdy, xt, dt, StepFlags())
        xt += cfg.dtsec
        dt = 2.0 * cfg.dtsec
    out = whole(s, mesh)
    out["diags"] = {k: float(v) for k, v in diags.items()}
    return out


def phys_run(mesh=None, device="cpu", initial_state=None,
             steps=NH["phys_steps"]):
    """``Model`` with the default physics on the NH setting for ``steps``
    steps from ``nh_initial_state`` (the port's, or ``initial_state``);
    the whole domain's state fields, and whether they stayed finite."""
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import Model, nh_initial_state
    cfg = nh_cfg(RegCMConfig())
    grid = build_grid(cfg, ht=nh_hill())
    if initial_state is None:
        initial_state = nh_initial_state(grid, cfg, "cpu",
                                         perturb=NH["perturb"],
                                         seed=NH["seed"])
    m = Model(cfg, grid=grid, device=device, initial_state=initial_state,
              mesh=mesh)
    m.run(steps)
    out = whole(m.state, mesh)
    out["finite"] = m.check_finite()
    return out


def two_by_two(rank):
    """Both settings on this rank's block of a 2x2 grid (the halo
    counters read over the dynamics), then the undecomposed runs they are
    held to on rank 0, so that both sides use the same CPU kernels."""
    from regcm_tpu_torch.parallel import halo
    mesh = rank.mesh(NH["iy"], NH["jx"])
    halo.exchanges = halo.bytes_sent = 0
    out = dict(dyn=dyn_run(mesh))
    out["exchanges"] = halo.exchanges
    out["phys"] = phys_run(mesh)
    if rank.rank == 0:
        out["single"] = dict(dyn=dyn_run(), phys=phys_run())
    return out


def max_rel(got, want):
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))


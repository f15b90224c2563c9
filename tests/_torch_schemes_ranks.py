"""The Model-level settings of ``tests/test_torch_model_schemes.py`` and
what the ranks of its 2x2 group run.

``setup`` applies a setting to either package's ``RegCMConfig``, and
``terrain`` gives both packages' ``build_grid`` the same hill with land
and water points. This module imports neither ``jax`` nor the JAX
package, so the ranks never load them.
"""
import numpy as np

# 14x16x14, three steps with every alarm on every step (ALARMS, given to
# both packages' Model in place of its alarm clock: the JAX package then
# compiles one step per setting, the costliest part of these tests):
# "hydro": configuration A (Emanuel over land, Tiedtke over water, UW
# TCM, Nogherotto-Tompkins) on the hydrostatic core at ds 50 km;
# "nh": A on the MM5 non-hydrostatic core at ds 10 km; "moloch": B's
# physics (no deep convection, Nogherotto-Tompkins, Holtslag) on MOLOCH
# at ds 3 km
A = dict(icup_lnd=4, icup_ocn=5, ibltyp=2, ipptls=2, icldfrac=0)
B = dict(icup_lnd=0, icup_ocn=0, ibltyp=1, ipptls=2, icldfrac=0)
SETTINGS = dict(
    hydro=dict(idynamic=1, ds=50.0, dt=150.0, physics=A),
    nh=dict(idynamic=2, ds=10.0, dt=30.0, physics=A),
    moloch=dict(idynamic=3, ds=3.0, dt=30.0, physics=B),
)
# the cumulus settings of tests/test_torch_cumulus.py, the same way (and
# dtcum = dt): configuration C (Grell over land, Emanuel over water,
# Holtslag, SUBEX) on the hydrostatic core; Kuo; Betts-Miller over land
# with shallow convection everywhere (icup_ocn=-3: no deep scheme over
# water); Kain-Fritsch with the UW TCM and Nogherotto-Tompkins (the TKE
# and mixed-phase inputs); Grell on MOLOCH. The 2x2 group runs C too.
# Their start is moistened to 1.9 times the rest state's qv (95% of
# saturation): at 1.8 the relative humidity sits exactly on SUBEX's
# ocean threshold rh0 = 0.9, where its cloud fraction is a roundoff
# (1e-14) and the in-cloud water qc/fcc rains out or not by the last bit.
C = dict(icup_lnd=2, icup_ocn=4, ibltyp=1, ipptls=1, icldfrac=0)
CUMULUS = dict(
    C=dict(idynamic=1, ds=50.0, dt=150.0, physics=C),
    kuo=dict(idynamic=1, ds=50.0, dt=150.0,
             physics=dict(C, icup_lnd=1, icup_ocn=1)),
    bm=dict(idynamic=1, ds=50.0, dt=150.0,
            physics=dict(C, icup_lnd=3, icup_ocn=-3)),
    kf=dict(idynamic=1, ds=50.0, dt=150.0,
            physics=dict(icup_lnd=6, icup_ocn=6, ibltyp=2, ipptls=2,
                         icldfrac=0)),
    grell_moloch=dict(idynamic=3, ds=3.0, dt=30.0,
                      physics=dict(C, icup_ocn=2)),
)
for _st in CUMULUS.values():
    _st["qvfac"] = 1.9
ALARMS = dict(do_rad=True, do_srf=True, do_cum=True, first=False,
              do_abem=True)
SHAPE = (14, 16, 14)            # iy, jx, kz
STEPS = 3
PERTURB, SEED = 0.3, 1
STATE_FIELDS = {1: ("u_a", "v_a", "t_a", "qx_a", "tke_a", "ps_a"),
                2: ("u_a", "v_a", "t_a", "qx_a", "tke_a", "pp_a", "w_a"),
                3: ("u", "v", "w", "t", "pai", "qx")}


def setup(cfg, name):
    """Apply setting ``name`` to ``cfg`` (either package's RegCMConfig)
    and return it."""
    st = SETTINGS[name] if name in SETTINGS else CUMULUS[name]
    cfg.core.idynamic = st["idynamic"]
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = SHAPE
    cfg.geo.ds = st["ds"]
    cfg.time.dt = st["dt"]
    if name in CUMULUS:
        cfg.time.dtcum = st["dt"]
    for k, v in st["physics"].items():
        setattr(cfg.physics, k, v)
    return cfg


def terrain(cfg):
    """(ht, landmask) of a 500 m hill whose lower ground is water (the
    port's synthetic_topo, numpy arithmetic shared with the JAX
    package's)."""
    from regcm_tpu_torch.preproc.terrain import synthetic_topo
    topo, _, mask = synthetic_topo(cfg, kind="gauss", height=500.0)
    return topo, mask


def port_grid(name):
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    cfg = setup(RegCMConfig(), name)
    ht, mask = terrain(cfg)
    return cfg, build_grid(cfg, ht=ht, landmask=mask)


def qv_factor(name):
    """The factor ``moisten`` raises qv by in setting ``name``."""
    return CUMULUS[name]["qvfac"] if name in CUMULUS else 1.8


def port_start(name):
    """The port's initial state of setting ``name`` on the whole grid."""
    import torch
    from regcm_tpu_torch.driver import (nh_initial_state,
                                        standard_atmosphere_state)
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    cfg, grid = port_grid(name)
    if cfg.core.idynamic == 3:
        s = MolochCore(grid, cfg, device="cpu", dtype=torch.float64
                       ).initial_state(perturb=PERTURB, seed=SEED)
        return s._replace(qx=torch.as_tensor(
            moisten(s, 3, qv_factor(name)).qx))
    start = nh_initial_state if cfg.core.idynamic == 2 \
        else standard_atmosphere_state
    s = start(grid, cfg, "cpu", torch.float64, perturb=PERTURB, seed=SEED)
    s = moisten(s._replace(**{k: v.numpy() for k, v in s._asdict().items()}),
                cfg.core.idynamic, qv_factor(name))
    return s._replace(**{k: torch.as_tensor(v) for k, v in
                         s._asdict().items()})


def moisten(s, idynamic, qvfac=1.8):
    """A start that forms clouds and precipitation within three steps:
    qv raised to ``qvfac`` times its value (1.8: about 90% of
    saturation), cloud
    water in the layers between 250 K and 290 K and ice between 220 K
    and 265 K (where the state carries them: qv and qc alone under
    SUBEX), on the state ``s`` (a NamedTuple of numpy arrays of either
    package); returns the state with those fields replaced."""
    if idynamic == 3:
        cpl = 1.0
        t = np.asarray(s.t)
        qx0 = np.asarray(s.qx)
    else:
        cpl = np.asarray(s.ps_a)[None]
        t = np.asarray(s.t_a) / cpl
        qx0 = np.asarray(s.qx_a)
    qv = qvfac * qx0[0] / cpl
    qc = np.where((t > 250.0) & (t < 290.0), 1.0e-4, 0.0)
    qi = np.where((t > 220.0) & (t < 265.0), 3.0e-5, 0.0)
    z = np.zeros_like(qv)
    qx = np.stack([qv, qc, z, qi, z][:qx0.shape[0]]) * cpl
    if idynamic == 3:
        return s._replace(qx=qx)
    return s._replace(qx_a=qx, qx_b=qx.copy())


def port_run(name, initial_state=None, mesh=None, steps=STEPS):
    """``Model`` of setting ``name`` (f64, CPU) for ``steps`` steps; the
    whole domain's state fields, the decoupled fields and the alarms of
    each step."""
    import torch
    from regcm_tpu_torch.driver import Model
    cfg, grid = port_grid(name)
    if initial_state is None:
        initial_state = port_start(name)
    from regcm_tpu_torch.core.state import StepFlags
    m = Model(cfg, grid=grid, device="cpu", dtype=torch.float64,
              initial_state=initial_state, mesh=mesh)
    m._flags = lambda: StepFlags(**ALARMS)
    flags = []
    for _ in range(steps):
        flags.append(m._flags())
        m.step()
    fields = {k: getattr(m.state, k)
              for k in STATE_FIELDS[cfg.core.idynamic]}
    if mesh is not None:
        fields = {k: mesh.gather(v) for k, v in fields.items()}
    return dict(state={k: v.numpy() for k, v in fields.items()},
                dec=m.decoupled(), flags=flags, finite=m.check_finite())


def two_by_two(rank):
    """Configurations A and C on the hydrostatic core on this rank's
    block of a 2x2 grid, then on rank 0 the undecomposed runs they are
    held to, so that both sides use the same CPU kernels."""
    iy, jx, _ = SHAPE
    out = dict(run=port_run("hydro", mesh=rank.mesh(iy, jx)),
               run_c=port_run("C", mesh=rank.mesh(iy, jx)))
    if rank.rank == 0:
        out["single"] = port_run("hydro")
        out["single_c"] = port_run("C")
    return out


def max_rel(got, want):
    return float(np.max(np.abs(got - want))
                 / max(float(np.max(np.abs(want))), 1e-300))

"""The Model settings of ``tests/test_torch_chem_model.py``,
``tests/test_torch_gas_chem_model.py`` and the 2x2 chemistry runs of
``tests/test_torch_parallel.py``'s rank group.

Each setting applies to either package's ``RegCMConfig``; ``grid`` gives
both packages' ``build_grid`` the same hill with land and water points,
the land marked desert (landuse 8, as the JAX package's
``tests/test_chem.py`` does) so that dust emits. ``start`` forms a
setting's initial state from the package's own rest state: moistened,
a 10 m/s westerly, and a seeded tracer profile peaking at the surface in
every tracer, so that emission, deposition, transport and the chemistry
all act within the run. ``jax_run`` runs the JAX package (in a spawned
process) and ``port_run`` the port, from the same numpy state, with
every alarm on every step. This module imports neither ``jax`` nor the
JAX package at its top, so the ranks never load them.
"""
import numpy as np

from . import _torch_schemes_ranks as R

SHAPE = (14, 16, 14)            # iy, jx, kz
STEPS = 3
QVFAC = 1.9                     # 95% of saturation, off SUBEX's rh0
WIND = 10.0                     # m/s westerly
ALARMS = R.ALARMS
SIMS = ("DUST", "DU12", "SSLT", "DUSS", "CARB", "SULF", "SUCA", "AERO",
        "POLLEN")
# The nine chemsimtypes on the hydrostatic core: seven with the cheapest
# physics the chemistry accepts (Holtslag, SUBEX; no cumulus, the
# broadband radiation: the JAX package compiles one step a setting, the
# costliest part of these tests); AERO with configuration E's physics
# (the tropical band: Emanuel and its tracer transport, CCM3, COARE and
# the slab ocean); DUST with the aerosol direct effect (idirect=2, CCM3)
# and Grell over land beside Emanuel over water, so that the land columns
# take the well-mixed convective transport (cumtran) and the sea columns
# none (the land/ocean blend drops Emanuel's, as in the JAX package).
# Then DUST on MOLOCH with the default physics (Emanuel's transport
# there too).
CHEAP = dict(icup_lnd=0, icup_ocn=0, ibltyp=1, ipptls=1, icldfrac=0)
SETTINGS = {sim: dict(idynamic=1, ds=50.0, dt=150.0, sim=sim, physics=CHEAP,
                      extras=dict(rad_scheme="broadband"))
            for sim in SIMS}
SETTINGS.update(
    AERO=dict(idynamic=1, ds=50.0, dt=150.0, sim="AERO",
              geo=dict(i_band=1, iproj="NORMER", clat=0.0),
              physics=dict(icup_lnd=4, icup_ocn=4, ibltyp=1, ipptls=1,
                           iocnflx=3, islab_ocean=1, icldfrac=0)),
    DUST=dict(idynamic=1, ds=50.0, dt=150.0, sim="DUST", idirect=2,
              physics=dict(icup_lnd=2, icup_ocn=4, ibltyp=1, ipptls=1,
                           icldfrac=0)),
    dust_moloch=dict(idynamic=3, ds=3.0, dt=30.0, sim="DUST",
                     physics=dict(icldfrac=0)),
)
# The gas phase (at noon, the sun up over the domain, so that photolysis
# runs): CBMZ and CB6 with the cheap physics and the saturation adjustment
# off (subexparam conf=0: the well-conditioned trajectory of the repo's
# dry comparisons, on which the gas phase is held without the spread
# runs that SUBEX's roundoff flips need at noon); DCCB with configuration F's
# physics (E's, the tropical band, with the gas phase and the SNA
# equilibrium: Emanuel's tracer transport through K2's tracer form at ntr
# = 50); AERO under Tiedtke over both surfaces with lmfsmooth (ctracer);
# CBMZ on MOLOCH (K4's stack at nf = 5 + nqx + 37).
# The gas-phase settings run at GAS_SHAPE: the Ros2 solver takes ~45
# iterations a step from its zeroed radicals, and at 14x16x14 three steps
# of one setting took 52 s of the port and ~180 s of the JAX package on
# one CPU thread each. At GAS_SHAPE a JAX step of a gas setting still
# costs ~40 CPU-s (the dense Jacobian of every cell each iteration): CB6
# and CBMZ on MOLOCH run two steps in the tests (``steps``), every alarm
# on each.
GAS = ("CBMZ", "CB6", "DCCB", "tiedtke_aero", "cbmz_moloch")
GAS_SHAPE = (8, 10, 14)
NOON = 1990060112
SETTINGS.update(
    CBMZ=dict(SETTINGS["SULF"], sim="CBMZ", mdate1=NOON, shape=GAS_SHAPE,
              conf=0.0),
    CB6=dict(SETTINGS["SULF"], sim="CB6", mdate1=NOON, shape=GAS_SHAPE,
             conf=0.0, steps=2),
    DCCB=dict(SETTINGS["AERO"], sim="DCCB", mdate1=NOON, shape=GAS_SHAPE),
    tiedtke_aero=dict(idynamic=1, ds=50.0, dt=150.0, sim="AERO",
                      shape=SHAPE,
                      physics=dict(icup_lnd=5, icup_ocn=5, ibltyp=1,
                                   ipptls=1, icldfrac=0),
                      extras=dict(rad_scheme="broadband"),
                      tiedtke=dict(lmfsmooth=True)),
    cbmz_moloch=dict(SETTINGS["dust_moloch"], sim="CBMZ", mdate1=NOON,
                     shape=GAS_SHAPE, steps=2),
)
# the state fields compared beside the decoupled ones
STATE = {1: ("chi_a", "chi_b", "chemdiag", "tg", "rainc", "rainnc"),
         3: ("chi_b", "chemdiag", "tg", "rainc", "rainnc")}


def setup(cfg, name):
    """Apply setting ``name`` to ``cfg`` (either package's RegCMConfig)
    and return it."""
    st = SETTINGS[name]
    cfg.core.idynamic = st["idynamic"]
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = st.get("shape", SHAPE)
    cfg.geo.ds = st["ds"]
    cfg.time.dt = st["dt"]
    cfg.time.dtcum = st["dt"]
    for k, v in st.get("geo", {}).items():
        setattr(cfg.geo, k, v)
    for k, v in st["physics"].items():
        setattr(cfg.physics, k, v)
    cfg.physics.extras.update(st.get("extras", {}))
    for k, v in st.get("tiedtke", {}).items():
        setattr(cfg.tiedtke, k, v)
    if "mdate1" in st:
        cfg.restart.mdate1 = st["mdate1"]
    if "conf" in st:
        cfg.subex.conf = st["conf"]
    cfg.physics.ichem = 1
    cfg.chem.chemsimtype = st["sim"]
    cfg.chem.idirect = st.get("idirect", 0)
    return cfg


def grid(build_grid, cfg):
    """The setting's grid from either package's ``build_grid``: the hill,
    its land a desert."""
    ht, mask = R.terrain(cfg)
    g = build_grid(cfg, ht=ht, landmask=mask)
    g.extras["lveg"] = np.where(np.asarray(g.lndocn) > 0.5, 8, 15)
    return g


def tracers(ntr, kz, iy, jx, seed=7):
    """A seeded tracer profile (ntr, kz, iy, jx), kg/kg: 1e-8 at the
    surface falling off over four levels, with 50% noise."""
    rng = np.random.default_rng(seed)
    prof = np.exp(-((np.arange(kz) - (kz - 1)) / 4.0) ** 2)
    return 1.0e-8 * prof[None, :, None, None] \
        * (1.0 + 0.5 * rng.uniform(0.0, 1.0, (ntr, kz, iy, jx)))


def start(s, idynamic):
    """The setting's initial state from a package's rest state ``s``
    (NamedTuple of numpy arrays): moistened, a westerly, the tracers."""
    import torch
    from regcm_tpu_torch.dynamics.stencil import cross2dot
    s = R.moisten(s, idynamic, QVFAC)
    if idynamic == 3:
        ntr, kz, iy, jx = np.asarray(s.chi_b).shape
        return s._replace(u=np.full_like(np.asarray(s.u), WIND),
                          chi_b=tracers(ntr, kz, iy, jx))
    ps = np.asarray(s.ps_a)
    psd = cross2dot(torch.as_tensor(ps)).numpy()
    u = WIND * psd[None] * np.ones_like(np.asarray(s.u_a))
    ntr, kz, iy, jx = np.asarray(s.chi_a).shape
    chi = tracers(ntr, kz, iy, jx) * ps[None, None]
    return s._replace(u_a=u, u_b=u, chi_a=chi, chi_b=chi)


def fields(state, dec, idynamic):
    """The compared fields: decoupled ps, t, qv, qc, u, v (and w), each
    tracer and the chemistry's accumulators."""
    f = {k: np.asarray(dec[k]) for k in ("ps", "t", "qv", "qc", "u", "v")}
    if idynamic == 3:
        f["w"] = np.asarray(dec["w"])
    for k in STATE[idynamic]:
        a = np.asarray(state[k])
        if k.startswith("chi") or k == "chemdiag":
            for n in range(a.shape[-4 if k != "chemdiag" else -3]):
                f[f"{k}{n}"] = a[n] if k != "chemdiag" else a[:, n]
        else:
            f[k] = a
    return f


def jax_run(names):
    """The JAX package's Model of each setting of ``names`` for its
    steps (``steps``, STEPS by default) from its own start: that start (numpy), the alarms, the
    compared fields and finiteness, by name. Runs in a spawned process,
    which has not read the conftest's settings. XLA compiles with most
    of its optimisations off: half the compile time, which is most of a
    run's."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_disable_most_optimizations", True)
    import jax.numpy as jnp
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.core.state import StepFlags
    from regcm_tpu.driver import Model, standard_atmosphere_state
    from regcm_tpu.dynamics.moloch import MolochCore
    out = {}
    for name in names:
        cfg = setup(RegCMConfig(), name)
        g = grid(build_grid, cfg)
        idyn = cfg.core.idynamic
        s0 = jax_start(name)
        m = Model(cfg, grid=g, dtype=jnp.float64,
                  initial_state=jax.tree_util.tree_map(jnp.asarray, s0))
        m._flags = lambda: StepFlags(**ALARMS)
        flags = []
        for _ in range(SETTINGS[name].get("steps", STEPS)):
            flags.append(tuple(m._flags()))
            m.step()
        state = {k: np.asarray(getattr(m.state, k)) for k in STATE[idyn]}
        dec = {k: np.asarray(v) for k, v in m.decoupled().items()}
        out[name] = dict(start=s0, flags=flags, finite=bool(m.check_finite()),
                         fields=fields(state, dec, idyn))
    return out


def jax_start(name):
    """The JAX package's start of setting ``name`` (numpy): its rest
    state (f64) with ``start`` applied."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.driver import standard_atmosphere_state
    from regcm_tpu.dynamics.moloch import MolochCore
    cfg = setup(RegCMConfig(), name)
    g = grid(build_grid, cfg)
    kw = dict(perturb=R.PERTURB, seed=R.SEED)
    if cfg.core.idynamic == 3:
        s0 = MolochCore(g, cfg, dtype=jnp.float64).initial_state(**kw)
    else:
        s0 = standard_atmosphere_state(g, cfg, jnp.float64, **kw)
    return start(jax.device_get(s0), cfg.core.idynamic)


def port_model(name, initial_state, mesh=None, device="cpu", conf=None):
    """The port's ``Model`` of setting ``name`` (f64, on ``device``) from
    ``initial_state`` (numpy, whole domain), every alarm on every step;
    ``conf`` the saturation adjustment's subexparam conf (0: off)."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.core.state import StepFlags
    from regcm_tpu_torch.driver import Model
    cfg = setup(RegCMConfig(), name)
    if conf is not None:
        cfg.subex.conf = conf
    m = Model(cfg, grid=grid(build_grid, cfg), device=device,
              dtype=torch.float64, initial_state=initial_state, mesh=mesh)
    m._flags = lambda: StepFlags(**ALARMS)
    return m


def port_run(name, initial_state, mesh=None, steps=STEPS, device="cpu",
             conf=None):
    """The port's run of setting ``name``: the alarms, the compared
    fields of the whole domain (numpy) and finiteness."""
    m = port_model(name, initial_state, mesh=mesh, device=device, conf=conf)
    flags = []
    for _ in range(steps):
        flags.append(tuple(m._flags()))
        m.step()
    state = {k: getattr(m.state, k) for k in STATE[m.idynamic]}
    if mesh is not None:
        state = {k: mesh.gather(v) for k, v in state.items()}
    return dict(flags=flags, finite=m.check_finite(),
                fields=fields({k: v.cpu().numpy() for k, v in state.items()},
                              m.decoupled(), m.idynamic))


def port_start(name):
    """The port's own start of setting ``name`` (numpy, whole domain), for
    runs held to the port alone."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import standard_atmosphere_state
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    cfg = setup(RegCMConfig(), name)
    g = grid(build_grid, cfg)
    kw = dict(perturb=R.PERTURB, seed=R.SEED)
    if cfg.core.idynamic == 3:
        s = MolochCore(g, cfg, device="cpu").initial_state(**kw)
    else:
        s = standard_atmosphere_state(g, cfg, "cpu", torch.float64, **kw)
    s = s._replace(**{k: v.cpu().numpy() for k, v in s._asdict().items()})
    return start(s, cfg.core.idynamic)


def perturbed(name, s, seed):
    """``s`` with T, the winds, the water species and the tracers changed
    by a relative 1e-15 (seeded): the spread that roundoff alone opens
    over the run (the dust emission's threshold factor 1 − uth² turns the
    last bits of the wind into relative differences of 1e-6 and more;
    the saturation adjustment's negative-water fix turns a roundoff sign
    of qc into 1e-8 after one step, which with the raindrop evaporation
    on moves one column's large-scale rain by 4e-4 after three in the
    DUST setting, a flip that perturbing T and the winds alone does not
    reach)."""
    moloch = SETTINGS[name]["idynamic"] == 3
    names = ("t", "u", "v", "qx", "chi_b") if moloch \
        else ("t_a", "u_a", "u_b", "v_a", "v_b", "qx_a", "qx_b", "chi_a",
              "chi_b")
    rng = np.random.default_rng(seed)
    return s._replace(**{k: np.asarray(getattr(s, k)) * (
        1.0 + 1e-15 * rng.standard_normal(np.asarray(getattr(s, k)).shape))
        for k in names})


def rel_rms(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


def port_job(name, seed=None):
    """The port's run of setting ``name`` from its own start (``port_start``,
    the JAX package's ``jax_start`` bit for bit, which the tests check;
    perturbed with ``seed`` if given), on one torch thread, with that
    start: a spawned worker's job."""
    import torch
    torch.set_num_threads(1)
    s0 = port_start(name)
    if seed is not None:
        s0 = perturbed(name, s0, seed)
    out = port_run(name, s0, steps=SETTINGS[name].get("steps", STEPS))
    out["start"] = s0
    return out


def gas_group(name):
    """``gas_ranks`` on a 2x2 gloo group (the ranks on PyTorch's generic
    CPU kernels, so that a column computes alike wherever it falls in a
    block): a spawned worker's job."""
    import os
    from regcm_tpu_torch.parallel import launch
    os.environ["ATEN_CPU_CAPABILITY"] = "default"
    return launch.spawn(gas_ranks, 2, 2, "gloo", "cpu", args=(name,),
                        timeout=900)


def gas_ranks(rank, name="CBMZ"):
    """Setting ``name`` on one rank of a 2x2 group from the port's own
    start, with the rank's halo exchanges; rank 0 then runs the whole
    domain on one rank, the reference the group is held to."""
    import torch
    from regcm_tpu_torch.parallel import halo
    torch.set_num_threads(1)
    s0 = port_start(name)
    halo.exchanges = 0
    iy, jx, _ = SETTINGS[name].get("shape", SHAPE)
    out = dict(mesh=port_run(name, s0, mesh=rank.mesh(iy, jx)),
               exchanges=halo.exchanges)
    if rank.rank == 0:
        out["single"] = port_run(name, s0)
    return out


# a compared field that is zero everywhere in the reference, or within
# this bound of zero (MOLOCH's large-scale rain over three steps), is held
# to it: the saturation adjustment can leave roundoff-sized rain (2e-22
# mm) in one column on other CPU kernels or on the card
ZERO_FLOOR = 1e-15


"""The Model settings of ``tests/test_torch_surface.py`` and
``tests/test_torch_pbl_micro.py``, and the periodic runs of the 2x2 group
of ``tests/test_torch_parallel.py``.

Each setting applies to either package's ``RegCMConfig``; ``grid`` gives
both packages' ``build_grid`` the same hill with land and water points
and the setting's lake and subgrid landuse. ``jax_run`` runs the JAX
package (in a spawned process) and ``port_run`` the port, from the same
numpy state and with every alarm on every step. This module imports
neither ``jax`` nor the JAX package at its top, so the ranks never load
them.
"""
import numpy as np

from . import _torch_schemes_ranks as R

SHAPE = (14, 16, 14)            # iy, jx, kz
STEPS = 3
QVFAC = 1.9                     # 95% of saturation, off SUBEX's rh0
ALARMS = R.ALARMS
# (i) RegCM4's tropical band on the hydrostatic core: Mercator about the
# equator, x-periodic, Emanuel, Holtslag, SUBEX, COARE over the ocean and
# the slab ocean restoring toward the SST; (ii) MOLOCH at 3 km with Zeng,
# the diurnal skin SST, sea ice under a patch of 270 K sea, the lake
# (30 layers) in a 20 m deep patch of water, WSM5 and GFS; (iii) the MM5
# NH core with MYJ, the BATS ocean fluxes and BATS on 2x2 subcells a
# cell (nsg=2) of four landuse classes. The JAX package refuses nsg > 1
# on MOLOCH, so (iii) runs on the NH core.
SETTINGS = dict(
    band_slab=dict(idynamic=1, ds=50.0, dt=150.0,
                   geo=dict(i_band=1, iproj="NORMER", clat=0.0),
                   physics=dict(icup_lnd=4, icup_ocn=4, ibltyp=1,
                                ipptls=1, iocnflx=3, islab_ocean=1,
                                icldfrac=0)),
    moloch_sfc=dict(idynamic=3, ds=3.0, dt=30.0,
                    physics=dict(icup_lnd=0, icup_ocn=0, ibltyp=3,
                                 ipptls=3, iocnflx=2, idcsst=1, iseaice=1,
                                 lakemod=1, icldfrac=0),
                    extras=dict(lake_ndpmax=30), cold_sst=270.0),
    nh_myj=dict(idynamic=2, ds=10.0, dt=30.0, nsg=2,
                physics=dict(icup_lnd=4, icup_ocn=4, ibltyp=4, ipptls=1,
                             iocnflx=1, icldfrac=0)),
)
# the state fields held beside the decoupled ones
SURFACE_FIELDS = dict(
    band_slab=("tg", "hfx", "qfx", "uvdrag", "rainc"),
    moloch_sfc=("tg", "hfx", "qfx", "tlak", "lakice", "seaice", "dcsst",
                "rainnc"),
    nh_myj=("tg", "hfx", "qfx", "tke_a", "pbl0", "bats", "rainc"),
)


def setup(cfg, name):
    """Apply setting ``name`` to ``cfg`` (either package's RegCMConfig)
    and return it."""
    st = SETTINGS[name]
    cfg.core.idynamic = st["idynamic"]
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = SHAPE
    cfg.dim.nsg = st.get("nsg", 1)
    cfg.geo.ds = st["ds"]
    cfg.time.dt = st["dt"]
    cfg.time.dtcum = st["dt"]
    for k, v in st.get("geo", {}).items():
        setattr(cfg.geo, k, v)
    for k, v in st["physics"].items():
        setattr(cfg.physics, k, v)
    cfg.physics.extras.update(st.get("extras", {}))
    return cfg


def water_patches(mask):
    """(lake, cold sea) masks of a land mask of the cross points (iy-1,
    jx-1): the first third of the water points in row order hold a 20 m
    lake, the rest of the water is the sea."""
    water = np.argwhere(mask < 0.5)
    lake = np.zeros(mask.shape, bool)
    for y, x in water[:len(water) // 3]:
        lake[y, x] = True
    return lake, (mask < 0.5) & ~lake


def subgrid_landuse(grid):
    """Four landuse classes a land cell on the nnsg = 4 subcells
    (deciduous forest, short grass, desert, the cell's own), the ocean
    class over water; ``grid`` of either package, returned."""
    lveg = np.asarray(grid.extras.get(
        "lveg", np.where(np.asarray(grid.lndocn) > 0.5, 2, 15)))
    grid.extras["lveg_sub"] = np.stack([np.where(lveg != 15, 5, 15),
                                        np.where(lveg != 15, 2, 15),
                                        np.where(lveg != 15, 8, 15), lveg])
    return grid


def grid(build_grid, cfg, name):
    """The setting's grid from either package's ``build_grid``."""
    ht, mask = R.terrain(cfg)
    kw = {}
    if cfg.physics.lakemod == 1:
        kw["dhlake"] = np.where(water_patches(mask)[0], 20.0, 0.0)
    g = build_grid(cfg, ht=ht, landmask=mask, **kw)
    return subgrid_landuse(g) if cfg.dim.nsg > 1 else g


def sea_surface(name, mask, sst):
    """The core's SST with the setting's cold patch (a numpy array)."""
    cold = SETTINGS[name].get("cold_sst")
    sst = np.array(sst, dtype=float)
    if cold is not None:
        sea = np.zeros(sst.shape, bool)
        sea[:-1, :-1] = water_patches(mask)[1]
        sst[sea] = cold
    return sst


def fields(state, dec, name, idynamic):
    """The compared fields: decoupled ps, t, qv, u, v (and w), each
    hydrometeor, and the setting's surface and PBL state."""
    f = {k: np.asarray(dec[k]) for k in ("ps", "t", "qv", "u", "v")}
    if idynamic == 3:
        f["w"] = np.asarray(dec["w"])
    qx = np.asarray(state["qx" if idynamic == 3 else "qx_a"])
    for n, q in enumerate(("qc", "qr", "qi", "qs")[:qx.shape[0] - 1],
                          start=1):
        f[q] = qx[n]
    if idynamic == 2:
        f["pp"] = np.asarray(state["pp_a"])
    for k in SURFACE_FIELDS[name]:
        f[k] = np.asarray(state[k])
    return f


def _state_keys(name, idynamic):
    keys = R.STATE_FIELDS[idynamic] + SURFACE_FIELDS[name]
    return tuple(dict.fromkeys(keys))


def jax_run(name):
    """The JAX package's Model of setting ``name`` for STEPS steps from its
    own moistened initial state: that state (numpy), the alarms, the
    compared fields and finiteness. Runs in a spawned process, which has
    not read the conftest's settings."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    import jax.numpy as jnp
    from regcm_tpu.config.params import RegCMConfig
    from regcm_tpu.core.grid import build_grid
    from regcm_tpu.core.state import StepFlags
    from regcm_tpu.driver import (Model, nh_initial_state,
                                  standard_atmosphere_state)
    from regcm_tpu.dynamics.moloch import MolochCore
    cfg = setup(RegCMConfig(), name)
    g = grid(build_grid, cfg, name)
    kw = dict(perturb=R.PERTURB, seed=R.SEED)
    idyn = cfg.core.idynamic
    if idyn == 3:
        s0 = MolochCore(g, cfg, dtype=jnp.float64).initial_state(**kw)
    elif idyn == 2:
        m0 = Model(cfg, grid=g, dtype=jnp.float64)
        s0 = nh_initial_state(m0.core, **kw)
    else:
        s0 = standard_atmosphere_state(g, cfg, jnp.float64, **kw)
    s0 = R.moisten(jax.device_get(s0), idyn, QVFAC)
    m = Model(cfg, grid=g, dtype=jnp.float64,
              initial_state=jax.tree_util.tree_map(jnp.asarray, s0))
    m.core.sst = jnp.asarray(sea_surface(name, R.terrain(cfg)[1],
                                         m.core.sst))
    m._flags = lambda: StepFlags(**ALARMS)
    flags = []
    for _ in range(STEPS):
        flags.append(tuple(m._flags()))
        m.step()
    state = {k: np.asarray(getattr(m.state, k))
             for k in _state_keys(name, idyn)}
    dec = {k: np.asarray(v) for k, v in m.decoupled().items()}
    return dict(start=s0, flags=flags, finite=bool(m.check_finite()),
                fields=fields(state, dec, name, idyn))


def port_run(name, initial_state, mesh=None, steps=STEPS, device="cpu"):
    """``Model`` of setting ``name`` (f64, on ``device``) from
    ``initial_state`` (a numpy state of the whole domain): the alarms,
    the compared fields of the whole domain (numpy) and finiteness."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.core.state import StepFlags
    from regcm_tpu_torch.driver import Model
    cfg = setup(RegCMConfig(), name)
    g = grid(build_grid, cfg, name)
    m = Model(cfg, grid=g, device=device, dtype=torch.float64,
              initial_state=initial_state, mesh=mesh)
    sst = sea_surface(name, R.terrain(cfg)[1], np.full((g.iy, g.jx), 288.0))
    m.core.sst = torch.as_tensor(sst if mesh is None else mesh.local(sst),
                                 device=m.core.sst.device)
    m._flags = lambda: StepFlags(**ALARMS)
    flags = []
    for _ in range(steps):
        flags.append(tuple(m._flags()))
        m.step()
    state = {k: getattr(m.state, k) for k in _state_keys(name, m.idynamic)}
    if mesh is not None:
        state = {k: mesh.gather(v) for k, v in state.items()}
    return dict(flags=flags, finite=m.check_finite(),
                fields=fields({k: v.cpu().numpy() for k, v in state.items()},
                              m.decoupled(), name, m.idynamic))


def perturbed(name, start, seed):
    """``start`` with T changed by a relative 1e-15 (seeded): the spread
    that roundoff alone opens over the run."""
    tname = "t" if SETTINGS[name]["idynamic"] == 3 else "t_a"
    t0 = np.asarray(getattr(start, tname))
    rng = np.random.default_rng(seed)
    return start._replace(**{tname: t0 * (1.0 + 1e-15 * rng.standard_normal(
        t0.shape))})


def rel_rms(got, want):
    got, want = np.asarray(got, float), np.asarray(want, float)
    return float(np.sqrt(np.mean((got - want) ** 2))
                 / (np.sqrt(np.mean(want ** 2)) + 1e-30))


def check_active(name, run):
    """The setting's surface and PBL schemes acted in the run: the slab
    SST moved off the forcing SST, ice formed on the cold sea, the lake
    profile and the skin SST are set, the MYJ TKE left its start and
    the subcells' ground temperatures parted."""
    f = run["fields"]
    if name == "band_slab":
        # at every sea point, off its 288 K (BATS alone moves tg over land)
        from regcm_tpu_torch.config.params import RegCMConfig
        sea = R.terrain(setup(RegCMConfig(), name))[1] < 0.5
        assert np.abs(f["tg"][:-1, :-1] - 288.0)[sea].min() > 0.0
    elif name == "moloch_sfc":
        assert f["seaice"][0].max() > 0.0
        assert np.abs(f["tlak"]).max() > 0.0
        assert f["dcsst"][2].max() > 100.0
    elif name == "nh_myj":
        assert np.abs(f["tke_a"] - 1.0e-3).max() > 0.0
        assert f["bats"].ndim == 4


def port_start(name):
    """The port's own moistened start of setting ``name`` (numpy, whole
    domain), for runs held to the port alone."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import (nh_initial_state,
                                        standard_atmosphere_state)
    from regcm_tpu_torch.dynamics.moloch import MolochCore
    cfg = setup(RegCMConfig(), name)
    g = grid(build_grid, cfg, name)
    kw = dict(perturb=R.PERTURB, seed=R.SEED)
    if cfg.core.idynamic == 3:
        s = MolochCore(g, cfg, device="cpu").initial_state(**kw)
    else:
        start = nh_initial_state if cfg.core.idynamic == 2 \
            else standard_atmosphere_state
        s = start(g, cfg, "cpu", torch.float64, **kw)
    s = s._replace(**{k: v.numpy() for k, v in s._asdict().items()})
    return R.moisten(s, cfg.core.idynamic, QVFAC)


# The decomposed periodic runs of the 2x2 group, each held to one rank:
# setting (i) above with full physics; the band on the MM5 NH core,
# dynamics only (18x32x14, Mercator about the equator, ds 50 km, dt 60
# s); the CRM, doubly periodic, on the hydrostatic core with the default
# physics (16x16x14, ds 4 km, dt 20 s). The last two start from the rest
# state perturbed by 0.3 K with a 10 m/s westerly.
PERIODIC = dict(
    band_slab=dict(steps=STEPS),
    band_nh=dict(idynamic=2, iy=18, jx=32, ds=50.0, dt=60.0,
                 geo=dict(i_band=1, iproj="NORMER", clat=0.0),
                 physics=False, steps=6),
    crm=dict(idynamic=1, iy=16, jx=16, ds=4.0, dt=20.0,
             geo=dict(i_crm=1), physics=True, steps=4),
)


def periodic_run(kind, mesh=None, device="cpu"):
    """A PERIODIC run of the port (f64, on ``device``) on one rank or the
    rank's block of ``mesh``: the whole domain's decoupled and state
    fields (numpy) and finiteness."""
    import torch
    from regcm_tpu_torch.config.params import RegCMConfig
    from regcm_tpu_torch.core.grid import build_grid
    from regcm_tpu_torch.driver import (Model, nh_initial_state,
                                        standard_atmosphere_state)
    from regcm_tpu_torch.dynamics.stencil import cross2dot
    if kind == "band_slab":
        r = port_run(kind, port_start(kind), mesh=mesh, device=device)
        return dict(finite=r["finite"], fields=r["fields"])
    st = PERIODIC[kind]
    cfg = RegCMConfig()
    cfg.core.idynamic = st["idynamic"]
    cfg.dim.iy, cfg.dim.jx, cfg.dim.kz = st["iy"], st["jx"], 14
    cfg.geo.ds = st["ds"]
    cfg.time.dt = st["dt"]
    for k, v in st["geo"].items():
        setattr(cfg.geo, k, v)
    g = build_grid(cfg)
    start = nh_initial_state if cfg.core.idynamic == 2 \
        else standard_atmosphere_state
    s = start(g, cfg, "cpu", torch.float64, perturb=0.3, seed=2024)
    u = 10.0 * cross2dot(s.ps_a)[None] * torch.ones_like(s.u_a)
    s = s._replace(u_a=u, u_b=u)
    m = Model(cfg, grid=g, device=device, dtype=torch.float64,
              initial_state=s, mesh=mesh,
              physics=None if st["physics"] else False)
    m.run(st["steps"])
    keys = ("t_a", "qx_a", "ps_a", "u_a", "v_a", "pp_a", "w_a", "tg")
    state = {k: getattr(m.state, k) for k in keys}
    if mesh is not None:
        state = {k: mesh.gather(v) for k, v in state.items()}
    f = {k: v.cpu().numpy() for k, v in state.items()}
    f.update({"dec_" + k: v for k, v in m.decoupled().items()})
    return dict(finite=m.check_finite(), fields=f)

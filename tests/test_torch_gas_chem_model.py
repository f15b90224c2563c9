"""``Model`` with the gas-phase chemistry, in f64 on the CPU, from
configurations rebuilt on ``RegCMConfig()`` plus overrides
(``tests/_torch_chem_settings``, at noon so that photolysis runs),
against the JAX package's Model with every alarm on every step, three
steps (two for CB6 and MOLOCH): CBMZ and CB6 on the hydrostatic core
(the saturation adjustment off); DCCB (CBMZ, the aerosols and the SNA
equilibrium) with configuration F's physics on the tropical band
(Emanuel's tracer transport through K2's tracer form at 50 tracers, the
tracers' K1 solve, CCM3, COARE, the slab ocean); AERO under Tiedtke
over both surfaces with lmfsmooth (ctracer through the suite); CBMZ on
MOLOCH (37 tracers in K4's stack). Each field (the dynamics, every
tracer at each time level, the emission and deposition totals) within
the golden gate (rel-RMS 1e-7) or four times the largest of three
seeds' roundoff spreads (run only where a field is past the gate), and
a field within 1e-15 of zero in the JAX package's run within 1e-15 of
zero. Each setting's chemistry acts (ozone moves, the SNA aerosol forms,
Tiedtke convects). CBMZ on 2x2 ranks equals one rank at 1e-12.

Every run starts with the module in a spawned process on one torch
thread, four at a time: the JAX package's (XLA with most optimisations
off) and the port's, each from its own package's start (held equal bit
for bit), and the 2x2 group's, so that the test process only
compares."""
import multiprocessing as mp
from concurrent.futures import ProcessPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from . import _torch_chem_settings as S  # noqa: E402
from ._torch_jax_child import use_suite_cache  # noqa: E402

SEEDS = range(3)
# the settings held to the JAX package's Model (each JAX run of a gas
# setting costs 70-180 CPU-s)
JAX = ("DCCB", "CB6", "tiedtke_aero", "cbmz_moloch", "CBMZ")


@pytest.fixture(scope="module")
def jobs():
    """Every run of the module, started at once in spawned processes (four
    at a time: the other test files run beside them)."""
    with ProcessPoolExecutor(4, mp_context=mp.get_context("spawn"),
                             initializer=use_suite_cache) as pool:
        jax = {n: pool.submit(S.jax_run, (n,)) for n in JAX}
        yield dict(group=pool.submit(S.gas_group, "CBMZ"), jax=jax,
                   port={n: pool.submit(S.port_job, n) for n in S.GAS},
                   pool=pool)


@pytest.fixture(scope="module", autouse=True)
def started(request):
    """Start the jobs with the module."""
    request.getfixturevalue("jobs")


# the compared fields in groups, a test each: the dynamics and the state
# fields, each half of the tracers at each time level (MOLOCH keeps one),
# and the emission and deposition totals
GROUPS = {1: ("state", "chi_a:0", "chi_a:1", "chi_b:0", "chi_b:1",
              "chemdiag"),
          3: ("state", "chi_b:0", "chi_b:1", "chemdiag")}
CASES = [(n, g) for n in JAX for g in GROUPS[S.SETTINGS[n]["idynamic"]]]


def _in_group(name, key, group):
    from regcm_tpu_torch.chem.species import build_species
    ntr = build_species(S.SETTINGS[name]["sim"]).ntr
    for head in ("chi_a", "chi_b", "chemdiag"):
        if key.startswith(head) and key[len(head):].isdigit():
            n = int(key[len(head):])
            if head == "chemdiag":
                return group == head
            return group == f"{head}:{int(2 * n >= ntr)}"
    return group == "state"


def _spreads(name, jobs):
    """The three seeds' runs of setting ``name``, run at its first call
    (only where a field is past the golden gate)."""
    cache = jobs.setdefault("spreads", {})
    if name not in cache:
        cache[name] = [f.result() for f in [
            jobs["pool"].submit(S.port_job, name, seed) for seed in SEEDS]]
    return cache[name]


def _field_check(name, group, jobs):
    got = jobs["port"][name].result()
    want = jobs["jax"][name].result()[name]
    assert got["finite"] and want["finite"]
    assert got["flags"] == want["flags"]
    for k, v in want["start"]._asdict().items():     # the same start
        assert np.array_equal(np.asarray(getattr(got["start"], k)),
                              np.asarray(v)), k
    keys = [k for k in want["fields"] if _in_group(name, k, group)]
    assert keys
    for k in keys:
        w, g = want["fields"][k], got["fields"][k]
        if np.abs(w).max() <= S.ZERO_FLOOR:
            assert np.abs(g).max() <= S.ZERO_FLOOR, (name, k)
            continue
        err = S.rel_rms(g, w)
        if err < 1e-7:
            continue
        s = max(S.rel_rms(p["fields"][k], g) for p in _spreads(name, jobs))
        assert err < 4.0 * s, (name, k, err, s)


@pytest.mark.parametrize("name,group", CASES)
def test_gas_chemistry_matches_jax(name, group, jobs):
    """A gas setting against the JAX package's Model, each field of the
    group within the golden gate or four times the largest of three
    seeds' spreads (DCCB's and Tiedtke's fields up to 2.5 times their
    spread, at noon)."""
    _field_check(name, group, jobs)


def _index(name, tracer):
    from regcm_tpu_torch.chem.species import build_species
    return build_species(S.SETTINGS[name]["sim"]).names.index(tracer)


@pytest.mark.parametrize("name", [n for n in S.GAS if n != "DCCB"])
def test_gas_setting_runs(name, jobs):
    """CBMZ, CB6, AERO under Tiedtke and CBMZ on MOLOCH on the port:
    its steps with every alarm, finite, every tracer finite and
    non-negative at the end."""
    got = jobs["port"][name].result()
    assert got["finite"]
    assert len(got["flags"]) == S.SETTINGS[name].get("steps", S.STEPS)
    for k, v in got["fields"].items():
        assert np.isfinite(v).all(), k
        if k.startswith("chi_b"):
            assert float(v.min()) >= 0.0, k


@pytest.mark.parametrize("name,ozone", [("CBMZ", "O3"), ("CB6", "OZN"),
                                        ("DCCB", "O3"),
                                        ("cbmz_moloch", "O3")])
def test_gas_chemistry_moves_ozone(name, ozone, jobs):
    """The photochemistry acts: ozone moves by more than 1% somewhere in
    the noon steps."""
    got = jobs["port"][name].result()
    n = _index(name, ozone)
    o3, o3_0 = got["fields"][f"chi_b{n}"], np.asarray(got["start"].chi_b)[n]
    # on the sigma-p cores both are coupled to p*, which moves by far less
    rel = np.abs(o3 / np.where(o3_0 != 0, o3_0, 1.0) - 1.0)
    assert float(rel.max()) > 0.01, float(rel.max())


def test_dccb_forms_the_sna_aerosol(jobs):
    """DCCB's SNA equilibrium: ammonium and nitrate aerosol appear from
    the seeded ammonia, sulfate and nitric acid."""
    got = jobs["port"]["DCCB"].result()
    for tracer in ("ANH4", "ANO3"):
        n = _index("DCCB", tracer)
        new = got["fields"][f"chi_b{n}"]
        old = np.asarray(got["start"].chi_b)[n]
        assert float((new - old).max()) > 0.0, tracer


def test_tiedtke_convects_with_tracers(jobs):
    """Tiedtke over both surfaces convects in the AERO setting (its
    ctracer then moves the tracers, held to the JAX package's above)."""
    got = jobs["port"]["tiedtke_aero"].result()
    assert float(got["fields"]["rainc"].max()) > 0.0


def test_gas_mesh_matches_single_rank(jobs):
    """CBMZ on 2x2 gloo ranks, three steps with every alarm: every
    compared field of the whole domain within 1e-12 of one rank, and
    every rank exchanged halos."""
    res = jobs["group"].result()
    got, want = res[0]["mesh"], res[0]["single"]
    assert got["finite"] and want["finite"] and got["flags"] == want["flags"]
    for k, w in want["fields"].items():
        err = float(np.abs(got["fields"][k] - w).max()) / max(
            float(np.abs(w).max()), 1e-300)
        assert err <= 1e-12, (k, err)
    assert all(r["exchanges"] > 0 for r in res)

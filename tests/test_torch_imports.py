"""Import hygiene of the PyTorch port and the kernel wrappers' refusals."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from regcm_tpu_torch.kernels import emanuel_mixing as k2  # noqa: E402
from regcm_tpu_torch.kernels import pbl_tridiag as k1  # noqa: E402
from regcm_tpu_torch.kernels import tridiag_w as k3  # noqa: E402
from regcm_tpu_torch.kernels import waf_advect as k4  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


MODULES = [
    "regcm_tpu_torch.driver", "regcm_tpu_torch.physics.suite",
    "regcm_tpu_torch.dynamics.moloch", "regcm_tpu_torch.kernels.pbl_tridiag",
    "regcm_tpu_torch.kernels.emanuel_mixing",
    "regcm_tpu_torch.kernels.tridiag_w", "regcm_tpu_torch.kernels.waf_advect",
    "regcm_tpu_torch.parallel.mesh", "regcm_tpu_torch.parallel.halo",
    "regcm_tpu_torch.parallel.launch", "regcm_tpu_torch.io.ncio",
    "regcm_tpu_torch.preproc.terrain", "regcm_tpu_torch.preproc.icbc",
    "regcm_tpu_torch.physics.pbl.gfs", "regcm_tpu_torch.physics.pbl.myj",
    "regcm_tpu_torch.physics.micro.wsm5",
    "regcm_tpu_torch.physics.surface.coare",
    "regcm_tpu_torch.physics.surface.lake",
    "regcm_tpu_torch.physics.surface.seaice",
    "regcm_tpu_torch.physics.surface.dcsst",
    "regcm_tpu_torch.physics.surface.slab",
    "tests._torch_parallel_ranks", "tests._torch_surface_settings"]
# one interpreter loads torch and numpy, then forks a child for each
# module, which imports it and reports what of jax and the JAX package
# its sys.modules then holds; the parent reports its own before the
# first fork
_CHILDREN = """
import importlib, json, os, sys
import numpy, torch

def bad():
    return sorted(m for m in sys.modules if m == "jax"
                  or m.startswith("jax.") or m == "regcm_tpu"
                  or m.startswith("regcm_tpu."))

out = {"": bad()}
for module in json.loads(sys.argv[1]):
    r, w = os.pipe()
    pid = os.fork()
    if pid == 0:
        os.close(r)
        try:
            importlib.import_module(module)
            msg = bad()
        except BaseException as e:
            msg = ["import failed: " + repr(e)]
        os.write(w, json.dumps(msg).encode())
        os._exit(0)
    os.close(w)
    with os.fdopen(r) as f:
        out[module] = json.loads(f.read() or '["no report"]')
    os.waitpid(pid, 0)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def imported():
    """module -> what of jax and the JAX package a fresh import of it
    loads, "" -> what the forking interpreter held before."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    proc = subprocess.run([sys.executable, "-c", _CHILDREN,
                           json.dumps(MODULES)], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr + proc.stdout
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("module", MODULES)
def test_port_imports_no_jax(module, imported):
    """In an interpreter that holds only torch and numpy, the module pulls
    in neither jax nor any module of the JAX package (regcm_tpu or
    regcm_tpu.*)."""
    assert imported[""] == []
    assert imported[module] == []


def _tridiag(dtype=torch.float64, shape=(2, 5, 3, 4)):
    c1 = torch.rand(shape, dtype=torch.float64) * 0.3
    c3 = torch.rand(shape, dtype=torch.float64) * 0.3
    rhs = torch.rand(shape, dtype=torch.float64)
    return [a.to(dtype) for a in (c1, 1.0 + c1 + c3, c3, rhs)]


def _mixing(ncol=6, L=12):
    rng = np.random.default_rng(0)
    lev = [torch.as_tensor(rng.uniform(0.1, 1.0, (ncol, L)))
           for _ in range(13)]
    col = [torch.as_tensor(rng.uniform(-1.0, 1.0, ncol)) for _ in range(2)]
    ints = [torch.full((ncol,), 2), torch.full((ncol,), 8)]
    return lev, col, ints, torch.ones((ncol, L), dtype=torch.bool)


def test_pbl_tridiag_refuses_wrong_dtype():
    with pytest.raises(TypeError):
        k1.pbl_tridiag(*_tridiag(torch.float16))
    args = _tridiag()
    args[0] = args[0].to(torch.float32)
    with pytest.raises(ValueError):
        k1.pbl_tridiag(*args)


def test_pbl_tridiag_refuses_non_contiguous_and_bad_shape():
    args = _tridiag(shape=(2, 5, 4, 4))
    args[3] = args[3].transpose(2, 3)
    with pytest.raises(ValueError):
        k1.pbl_tridiag(*args)
    with pytest.raises(ValueError):
        k1.pbl_tridiag(*(a[0] for a in _tridiag()))


def test_emanuel_mixing_refuses_wrong_dtype():
    lev, col, ints, cloud = _mixing()
    with pytest.raises(TypeError):
        k2.emanuel_mixing(*(a.to(torch.float16) for a in lev), *col, *ints,
                          cloud)
    with pytest.raises(ValueError):
        k2.emanuel_mixing(*lev, *col, *ints, cloud.to(torch.float64))
    with pytest.raises(ValueError):
        k2.emanuel_mixing(*lev, *col, *(a.double() for a in ints), cloud)


def test_emanuel_mixing_refuses_non_contiguous():
    lev, col, ints, cloud = _mixing(ncol=12, L=12)
    lev[4] = lev[4].T
    with pytest.raises(ValueError):
        k2.emanuel_mixing(*lev, *col, *ints, cloud)


def test_emanuel_mixing_refuses_too_many_levels():
    lev, col, ints, cloud = _mixing(L=k2.MAX_LEVELS + 1)
    with pytest.raises(ValueError):
        k2.emanuel_mixing(*lev, *col, *ints, cloud)


def _w(dtype=torch.float64, shape=(5, 3, 4)):
    wexpl = torch.rand(shape, dtype=torch.float64)
    zm = torch.rand(shape, dtype=torch.float64) * 0.3
    zp = torch.rand(shape, dtype=torch.float64) * 0.3
    wbot = torch.rand(shape[1:], dtype=torch.float64)
    return [a.to(dtype) for a in (wexpl, zm, zp, wbot)]


def test_tridiag_w_refuses_wrong_dtype():
    with pytest.raises(TypeError):
        k3.tridiag_w(*_w(torch.float16))
    args = _w()
    args[1] = args[1].to(torch.float32)
    with pytest.raises(ValueError):
        k3.tridiag_w(*args)


def test_tridiag_w_refuses_non_contiguous_and_bad_shape():
    args = _w(shape=(5, 4, 4))
    args[0] = args[0].transpose(1, 2)
    with pytest.raises(ValueError):
        k3.tridiag_w(*args)
    args = _w()
    with pytest.raises(ValueError):
        k3.tridiag_w(*args[:3], args[3][:2])
    with pytest.raises(ValueError):
        k3.tridiag_w(*(a[0] for a in _w()))


def _waf(dtype=torch.float64, nf=3, kz=4, iy=6, jx=7):
    r = lambda *s: torch.rand(s, dtype=torch.float64).to(dtype)
    return [r(nf, kz, iy, jx), r(kz, iy, jx), r(kz, iy, jx),
            r(kz + 1, iy, jx), r(kz, iy, jx) + 1.0, r(kz + 1, iy, jx) + 1.0,
            r(iy, jx) + 1.0, r(iy, jx)]


def test_waf_advect_refuses_wrong_dtype():
    with pytest.raises(TypeError):
        k4.waf_advect(*_waf(torch.float16), 0.1, 0.01)
    args = _waf()
    args[4] = args[4].to(torch.float32)
    with pytest.raises(ValueError):
        k4.waf_advect(*args, 0.1, 0.01)


def test_waf_advect_refuses_non_contiguous_and_bad_shape():
    args = _waf(iy=7)
    args[1] = args[1].transpose(1, 2)
    with pytest.raises(ValueError):
        k4.waf_advect(*args, 0.1, 0.01)
    args = _waf()
    args[3] = args[3][1:]                  # s needs kz+1 interfaces
    with pytest.raises(ValueError):
        k4.waf_advect(*args, 0.1, 0.01)
    with pytest.raises(ValueError):
        k4.waf_advect(*_waf(iy=3), 0.1, 0.01)

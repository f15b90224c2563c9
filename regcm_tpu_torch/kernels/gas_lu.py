"""K6: the batched LU factorisation and solves of the gas-phase Ros2.

``lu_factor_solve(p, b)`` factors each cell's stage matrix P (ncell, N, N)
with partial pivoting and solves P x = b (ncell, N); ``lu_solve(lu, piv,
b)`` solves with that factorisation again. They stand in for the JAX
package's ``jax.scipy.linalg.lu_factor``/``lu_solve`` in
``regcm_tpu/chem/kinetics.py`` ``_integrate`` (XLA, outside any Pallas
kernel). A CPU tensor goes to the plain versions (``torch.linalg.lu_factor``
and ``lu_solve``, LAPACK's getrf and getrs); a CUDA tensor launches the
hand-written kernels of ``csrc/gas_lu.cu`` (a warp a cell) or raises. The
pivots are the plain version's on the CPU (1-based, LAPACK's) and the
kernel's on the card (0-based): pass ``lu_solve`` what ``lu_factor_solve``
of the same device returned. On the card ``p`` is factored in place.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the last reset (plain-version calls not counted):
# factorisations (each with its first solve) and second solves
launches = 0
launches_solve = 0

MAX_N = 96               # csrc MAX_N: three columns a lane

_P = ctypes.c_void_p
_SIG = [_P, _P, _P, ctypes.c_longlong, ctypes.c_int, _P]


def build():
    """Compile and load the CUDA library (once per process)."""
    return _build.load("gas_lu", {
        "gas_lu_factor_solve_f32": _SIG, "gas_lu_factor_solve_f64": _SIG,
        "gas_lu_solve_f32": _SIG, "gas_lu_solve_f64": _SIG})


def lu_factor_solve_plain(p, b):
    """(LU, pivots, x) by LAPACK's getrf and getrs."""
    lu, piv = torch.linalg.lu_factor(p)
    return lu, piv, torch.linalg.lu_solve(lu, piv, b[..., None])[..., 0]


def lu_solve_plain(lu, piv, b):
    return torch.linalg.lu_solve(lu, piv, b[..., None])[..., 0]


def _check(mat, b, what):
    if mat.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{what}: dtype {mat.dtype} not supported (float32 "
                        "or float64)")
    if mat.dim() != 3 or mat.shape[1] != mat.shape[2] \
            or tuple(b.shape) != tuple(mat.shape[:2]):
        raise ValueError(f"{what}: expected (ncell, N, N) and (ncell, N), "
                         f"got {tuple(mat.shape)} and {tuple(b.shape)}")
    if b.dtype != mat.dtype or b.device != mat.device:
        raise ValueError(f"{what}: the matrices and b must share dtype and "
                         "device")
    if mat.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{what}: device {mat.device} not supported")
    if mat.device.type == "cuda":
        if mat.shape[1] > MAX_N:
            raise ValueError(f"{what}: N={mat.shape[1]} > {MAX_N}")
        if not (mat.is_contiguous() and b.is_contiguous()):
            raise ValueError(f"{what}: inputs must be contiguous")


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def lu_factor_solve(p, b):
    """(LU, pivots, x): the factorisation of each P (ncell, N, N) and the
    solution of P x = b."""
    global launches
    _check(p, b, "lu_factor_solve")
    if p.device.type == "cpu":
        return lu_factor_solve_plain(p, b)
    lib = build()
    ncell, n = b.shape
    piv = torch.empty((ncell, n), dtype=torch.int32, device=p.device)
    x = b.clone()
    fn = lib.gas_lu_factor_solve_f64 if p.dtype == torch.float64 \
        else lib.gas_lu_factor_solve_f32
    with torch.cuda.device(p.device):
        rc = fn(p.data_ptr(), piv.data_ptr(), x.data_ptr(), ncell, n,
                _stream(p))
    _build.check_status(rc, "lu_factor_solve")
    launches += 1
    return p, piv, x


def lu_solve(lu, piv, b):
    """x of LU x = b with a factorisation of ``lu_factor_solve``."""
    global launches_solve
    _check(lu, b, "lu_solve")
    if lu.device.type == "cpu":
        return lu_solve_plain(lu, piv, b)
    if piv.dtype != torch.int32 or tuple(piv.shape) != tuple(b.shape):
        raise ValueError("lu_solve: the kernel's pivots are (ncell, N) int32")
    lib = build()
    ncell, n = b.shape
    x = b.clone()
    fn = lib.gas_lu_solve_f64 if lu.dtype == torch.float64 \
        else lib.gas_lu_solve_f32
    with torch.cuda.device(lu.device):
        rc = fn(lu.data_ptr(), piv.data_ptr(), x.data_ptr(), ncell, n,
                _stream(lu))
    _build.check_status(rc, "lu_solve")
    launches_solve += 1
    return x

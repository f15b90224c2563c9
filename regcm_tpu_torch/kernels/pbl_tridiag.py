"""K1: batched tridiagonal solve of the Holtslag implicit diffusion.

``pbl_tridiag(c1, c2, c3, rhs)`` solves
−c3·x[k−1] + c2·x[k] − c1·x[k+1] = rhs over (ns, kz, iy, jx) columns,
the signature of the TPU kernel ``regcm_tpu/dynamics/pallas_kernels.py``
``pbl_tridiag``. A CPU tensor goes to the plain PyTorch recurrence
``pbl_tridiag_plain``; a CUDA tensor launches the hand-written kernel
``csrc/pbl_tridiag.cu`` or raises.

``pbl_tridiag_sharded(mesh, ...)`` (K5c, the TPU's
``pbl_tridiag_sharded``) solves one rank's (y, x) block of a
``DomainMesh``: the same kernel on the block, with no halo.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the last reset (plain-version calls not
# counted): unsharded (K1) and on a rank's block (K5c)
launches = 0
launches_sharded = 0

_P = ctypes.c_void_p
_SIG = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
        _P]
# the longest column the kernel takes (csrc/pbl_tridiag.cu MAX_LEVELS:
# the column's inputs sit in shared memory)
MAX_LEVELS = 200


def build():
    """Compile and load the CUDA library (once per process)."""
    return _build.load("pbl_tridiag", {"pbl_tridiag_f32": _SIG,
                                       "pbl_tridiag_f64": _SIG})


def pbl_tridiag_plain(c1, c2, c3, rhs):
    """Thomas recurrence in PyTorch, op for op the holtbl
    ``_tridiag_implicit`` sweeps (forward elimination into ce/cf, then
    back-substitution)."""
    kz = rhs.shape[1]
    ce_m1 = torch.zeros_like(rhs[:, 0])
    cf_m1 = torch.zeros_like(rhs[:, 0])
    ce, cf = [], []
    for k in range(kz):
        denom = c2[:, k] - c3[:, k] * ce_m1
        ce_m1 = c1[:, k] / denom
        cf_m1 = (rhs[:, k] + c3[:, k] * cf_m1) / denom
        ce.append(ce_m1)
        cf.append(cf_m1)
    x = [None] * kz
    x[kz - 1] = cf[kz - 1]
    for k in range(kz - 2, -1, -1):
        x[k] = ce[k] * x[k + 1] + cf[k]
    return torch.stack(x, dim=1)


def _check(c1, c2, c3, rhs):
    args = (c1, c2, c3, rhs)
    if rhs.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"pbl_tridiag: dtype {rhs.dtype} not supported "
                        "(float32 or float64)")
    if rhs.dim() != 4:
        raise ValueError(f"pbl_tridiag: expected (ns, kz, iy, jx), got "
                         f"shape {tuple(rhs.shape)}")
    for a in args:
        if a.dtype != rhs.dtype or a.shape != rhs.shape \
                or a.device != rhs.device:
            raise ValueError("pbl_tridiag: c1, c2, c3 and rhs must share "
                             "dtype, shape and device")
        if not a.is_contiguous():
            raise ValueError("pbl_tridiag: inputs must be contiguous")


def _solve(c1, c2, c3, rhs):
    """The checked solve; returns (x, whether the kernel launched)."""
    _check(c1, c2, c3, rhs)
    if rhs.device.type == "cpu":
        return pbl_tridiag_plain(c1, c2, c3, rhs), False
    ns, kz, iy, jx = rhs.shape
    if kz > MAX_LEVELS:
        raise ValueError(f"pbl_tridiag: the kernel takes columns of at most "
                         f"MAX_LEVELS = {MAX_LEVELS} levels, got {kz}")
    if rhs.device.type != "cuda":
        raise ValueError(f"pbl_tridiag: device {rhs.device} not supported")
    lib = build()
    out = torch.empty_like(rhs)
    fn = lib.pbl_tridiag_f64 if rhs.dtype == torch.float64 \
        else lib.pbl_tridiag_f32
    with torch.cuda.device(rhs.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(c1.data_ptr(), c2.data_ptr(), c3.data_ptr(),
                rhs.data_ptr(), out.data_ptr(), ns, kz, iy * jx, stream)
    _build.check_status(rc, "pbl_tridiag")
    return out, True


def pbl_tridiag(c1, c2, c3, rhs):
    """Solve the batched tridiagonal systems; returns x (ns, kz, iy, jx)."""
    global launches
    out, launched = _solve(c1, c2, c3, rhs)
    launches += launched
    return out


def pbl_tridiag_sharded(mesh, c1, c2, c3, rhs):
    """K5c: the solve on this rank's (ly, lx) block of ``mesh``."""
    global launches_sharded
    if tuple(rhs.shape[-2:]) != (mesh.ly, mesh.lx):
        raise ValueError(f"pbl_tridiag_sharded: expected the rank's "
                         f"{mesh.ly}x{mesh.lx} block, got "
                         f"{tuple(rhs.shape)}")
    out, launched = _solve(c1, c2, c3, rhs)
    launches_sharded += launched
    return out

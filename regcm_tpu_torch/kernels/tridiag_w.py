"""K3: the MOLOCH implicit vertical-velocity solve.

``tridiag_w(wexpl, zm, zp, w_bot)`` runs the upward and downward sweeps
of ``sound`` (``Main/mod_moloch.F90:838-905``) over every (y, x) column:
wexpl, zm, zp are (kz-1, iy, jx) at the interior interfaces ordered top
to bottom, w_bot (iy, jx) the surface value; it returns w at the
interior interfaces. The signature of the TPU kernel
``regcm_tpu/dynamics/pallas_kernels.py`` ``tridiag_w``. A CPU tensor
goes to the plain PyTorch sweeps ``tridiag_w_plain``; a CUDA tensor
launches the hand-written kernel ``csrc/tridiag_w.cu`` or raises.

``tridiag_w_sharded(mesh, ...)`` (K5b, the TPU's ``tridiag_w_sharded``)
solves one rank's (y, x) block of a ``DomainMesh``: the columns are
independent, so it is the same kernel on the block, with no halo.
"""
from __future__ import annotations

import ctypes

import torch

from . import _build

# kernel launches since the last reset (plain-version calls not
# counted): unsharded (K3) and on a rank's block (K5b)
launches = 0
launches_sharded = 0

_P = ctypes.c_void_p
_SIG = [_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong, _P]
# the longest column the kernel takes (csrc/tridiag_w.cu MAX_LEVELS: the
# column's inputs sit in shared memory)
MAX_LEVELS = 200


def build():
    """Compile and load the CUDA library (once per process)."""
    return _build.load("tridiag_w", {"tridiag_w_f32": _SIG,
                                     "tridiag_w_f64": _SIG})


def tridiag_w_plain(wexpl, zm, zp, w_bot):
    """The two sweeps in PyTorch, op for op the ``lax.scan`` bodies of
    ``MolochCore._sound`` (regcm_tpu/dynamics/moloch.py:566-588)."""
    n = wexpl.shape[0]
    w_below = w_bot
    wwkw_below = torch.zeros_like(w_bot)
    wprov, wwkw = [None] * n, [None] * n
    for i in range(n - 1, -1, -1):
        zrapp = 1.0 / (1.0 + zm[i] + zp[i] - zm[i] * wwkw_below)
        w_below = zrapp * (wexpl[i] + zm[i] * w_below)
        wwkw_below = zrapp * zp[i]
        wprov[i], wwkw[i] = w_below, wwkw_below
    w_above = torch.zeros_like(w_bot)
    out = []
    for i in range(n):
        w_above = wprov[i] + wwkw[i] * w_above
        out.append(w_above)
    return torch.stack(out)


def _check(wexpl, zm, zp, w_bot):
    if wexpl.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"tridiag_w: dtype {wexpl.dtype} not supported "
                        "(float32 or float64)")
    if wexpl.dim() != 3:
        raise ValueError(f"tridiag_w: expected (n, iy, jx), got shape "
                         f"{tuple(wexpl.shape)}")
    for a in (zm, zp):
        if a.shape != wexpl.shape:
            raise ValueError("tridiag_w: wexpl, zm and zp must share a "
                             "shape")
    if w_bot.shape != wexpl.shape[1:]:
        raise ValueError(f"tridiag_w: w_bot must be {tuple(wexpl.shape[1:])}"
                         f", got {tuple(w_bot.shape)}")
    for a in (wexpl, zm, zp, w_bot):
        if a.dtype != wexpl.dtype or a.device != wexpl.device:
            raise ValueError("tridiag_w: inputs must share dtype and device")
        if not a.is_contiguous():
            raise ValueError("tridiag_w: inputs must be contiguous")


def _solve(wexpl, zm, zp, w_bot):
    """The checked solve; returns (out, whether the kernel launched)."""
    _check(wexpl, zm, zp, w_bot)
    if wexpl.device.type == "cpu":
        return tridiag_w_plain(wexpl, zm, zp, w_bot), False
    n, iy, jx = wexpl.shape
    if n > MAX_LEVELS:
        raise ValueError(f"tridiag_w: the kernel takes columns of at most "
                         f"MAX_LEVELS = {MAX_LEVELS} levels, got {n}")
    if wexpl.device.type != "cuda":
        raise ValueError(f"tridiag_w: device {wexpl.device} not supported")
    lib = build()
    out = torch.empty_like(wexpl)
    fn = lib.tridiag_w_f64 if wexpl.dtype == torch.float64 \
        else lib.tridiag_w_f32
    with torch.cuda.device(wexpl.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = fn(wexpl.data_ptr(), zm.data_ptr(), zp.data_ptr(),
                w_bot.data_ptr(), out.data_ptr(), n, iy * jx, stream)
    _build.check_status(rc, "tridiag_w")
    return out, True


def tridiag_w(wexpl, zm, zp, w_bot):
    """Implicit-w solve; returns w at the interior interfaces, (n, iy, jx)."""
    global launches
    out, launched = _solve(wexpl, zm, zp, w_bot)
    launches += launched
    return out


def tridiag_w_sharded(mesh, wexpl, zm, zp, w_bot):
    """K5b: the solve on this rank's (ly, lx) block of ``mesh``."""
    global launches_sharded
    if tuple(w_bot.shape) != (mesh.ly, mesh.lx):
        raise ValueError(f"tridiag_w_sharded: expected the rank's "
                         f"{mesh.ly}x{mesh.lx} block, got "
                         f"{tuple(w_bot.shape)}")
    out, launched = _solve(wexpl, zm, zp, w_bot)
    launches_sharded += launched
    return out

"""Prognostic state as NamedTuples of tensors.

Same field names, shapes and meaning as ``regcm_tpu/core/state.py``:
p*-coupled leapfrog ``_a`` (time n) and ``_b`` (filtered n-1) levels,
3-D fields (kz, iy, jx), tracers (nqx, kz, iy, jx), 2-D (iy, jx).
``state_from_numpy`` / ``state_to_numpy`` carry a state across from (or
back to) the JAX package after ``jax.device_get``; given a ``DomainMesh``,
``state_from_numpy`` and ``bdy_from_numpy`` cut the whole domain's fields
to the rank's block.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from ..device import resolve_device

# tracer indices (mod_runparams.F90:38-42, 0-based)
IQV = 0
IQC = 1


def species_count(ipptls: int) -> int:
    """nqx: 2 water species (qv, qc) for SUBEX, 5 (qv, qc, qr, qi, qs)
    for the 5-species schemes (Main/mod_params.F90:1359-1363)."""
    return 5 if ipptls in (2, 3) else 2


class StepFlags(NamedTuple):
    """Per-step physics cadence flags (syncro_rad/srf/cum alarms,
    Main/mpplib/mod_runparams.F90:51-75); plain bools that pick
    branches eagerly."""
    do_rad: bool = False
    do_srf: bool = False
    do_cum: bool = True
    first: bool = False
    # LW absorptivity/emissivity refresh on the dtabem alarm
    do_abem: bool = True


class HydroState(NamedTuple):
    """Hydrostatic-core leapfrog state (idynamic=1)."""
    ps_a: torch.Tensor
    ps_b: torch.Tensor
    u_a: torch.Tensor
    u_b: torch.Tensor
    v_a: torch.Tensor
    v_b: torch.Tensor
    t_a: torch.Tensor
    t_b: torch.Tensor
    qx_a: torch.Tensor
    qx_b: torch.Tensor
    pp_a: torch.Tensor
    pp_b: torch.Tensor
    w_a: torch.Tensor
    w_b: torch.Tensor
    dstor: torch.Tensor
    hstor: torch.Tensor
    tg: torch.Tensor
    rainnc: torch.Tensor
    rainc: torch.Tensor
    heatrt: torch.Tensor
    qfx: torch.Tensor
    hfx: torch.Tensor
    uvdrag: torch.Tensor
    swsfc: torch.Tensor
    lwsfc: torch.Tensor
    cbmf: torch.Tensor
    cldefi: torch.Tensor
    cuten: torch.Tensor
    cuprate: torch.Tensor
    wavg: torch.Tensor
    tke_a: torch.Tensor
    tke_b: torch.Tensor
    pbl0: torch.Tensor
    tlak: torch.Tensor
    lakhi: torch.Tensor
    lakice: torch.Tensor
    laksnow: torch.Tensor
    laksnag: torch.Tensor
    bats: torch.Tensor
    seaice: torch.Tensor
    dcsst: torch.Tensor
    abstot: torch.Tensor
    absnxt: torch.Tensor
    emstot: torch.Tensor
    chi_a: torch.Tensor
    chi_b: torch.Tensor
    chemdiag: torch.Tensor


class BdyState(NamedTuple):
    """Lateral boundary values: b0 and the time tendency bt."""
    ps0: torch.Tensor
    pst: torch.Tensor
    t0: torch.Tensor
    tt: torch.Tensor
    qv0: torch.Tensor
    qvt: torch.Tensor
    u0: torch.Tensor
    ut: torch.Tensor
    v0: torch.Tensor
    vt: torch.Tensor
    chi0: Optional[torch.Tensor] = None
    chit: Optional[torch.Tensor] = None
    qflb0: Optional[torch.Tensor] = None


def zeros_hydro(kz: int, iy: int, jx: int, device="cuda",
                dtype=torch.float64, nqx: int = 2, nlak: int = 1,
                nnsg: int = 1, ntr: int = 0) -> HydroState:
    """Zero state with ``nqx`` water species: 2 (qv, qc) for SUBEX, 5 (qv,
    qc, qr, qi, qs) for the 5-species schemes; two split modes, ``nlak``
    lake layers, ``ntr`` chemistry tracers, the BATS pack per subcell
    (10, nnsg, iy, jx) when ``nnsg`` > 1."""
    device = resolve_device(device)

    def full(shape, v=0.0):
        return torch.full(shape, v, dtype=dtype, device=device)
    z2 = full((iy, jx))
    z3 = full((kz, iy, jx))
    z4 = full((nqx, kz, iy, jx))
    zs = full((2, iy, jx))
    zw = full((kz + 1, iy, jx))
    return HydroState(
        ps_a=z2, ps_b=z2, u_a=z3, u_b=z3, v_a=z3, v_b=z3,
        t_a=z3, t_b=z3, qx_a=z4, qx_b=z4,
        pp_a=z3, pp_b=z3, w_a=zw, w_b=zw, dstor=zs, hstor=zs,
        tg=z2, rainnc=z2, rainc=z2, heatrt=z3, qfx=z2, hfx=z2,
        uvdrag=z2, swsfc=z2, lwsfc=z2, cbmf=z2,
        cldefi=full((iy, jx), 0.6),
        cuten=full((9, kz, iy, jx)),
        cuprate=z2, wavg=z3,
        tke_a=full((kz + 1, iy, jx), 1.0e-3),
        tke_b=full((kz + 1, iy, jx), 1.0e-3),
        pbl0=full((2, iy, jx)),
        tlak=full((nlak, iy, jx)),
        lakhi=full((iy, jx), 0.01),
        lakice=z2, laksnow=z2, laksnag=z2,
        bats=full((10, nnsg, iy, jx) if nnsg > 1 else (10, iy, jx)),
        seaice=full((4, iy, jx)),
        dcsst=full((3, iy, jx)),
        abstot=full(((kz + 1) * (kz + 1), iy, jx)),
        absnxt=full((4 * kz, iy, jx)),
        emstot=full((kz + 1, iy, jx)),
        chi_a=full((ntr, kz, iy, jx)),
        chi_b=full((ntr, kz, iy, jx)),
        chemdiag=full((3, ntr, iy, jx)))


def bdy_from_state(s: HydroState) -> BdyState:
    """Fixed boundary values equal to the current state (synthetic runs)."""
    z3 = torch.zeros_like(s.t_a)
    z2 = torch.zeros_like(s.ps_a)
    return BdyState(
        ps0=s.ps_a, pst=z2,
        t0=s.t_a, tt=z3,
        qv0=s.qx_a[IQV], qvt=z3,
        u0=s.u_a, ut=z3, v0=s.v_a, vt=z3)


def tensors_from(cls, nt, device, dtype):
    """A ``cls`` NamedTuple of tensors on (device, dtype) from any
    NamedTuple with the same fields (None fields stay None)."""
    device = resolve_device(device)
    return cls(**{k: (None if getattr(nt, k) is None else
                      torch.tensor(np.asarray(getattr(nt, k)),
                                      dtype=dtype, device=device))
                  for k in cls._fields})


def sliced(nt, mesh):
    """The NamedTuple ``nt`` of global (..., iy, jx) arrays or tensors cut
    to the rank's block of ``mesh`` (unchanged without a mesh; None fields
    stay None)."""
    if mesh is None:
        return nt
    return nt._replace(**{
        k: mesh.local(v if isinstance(v, torch.Tensor) else np.asarray(v))
        for k, v in nt._asdict().items() if v is not None})


def state_from_numpy(s, device="cuda", dtype=torch.float64,
                     mesh=None) -> HydroState:
    """HydroState of tensors from any NamedTuple with the same fields
    (e.g. the JAX package's state after ``jax.device_get``); with a
    ``DomainMesh`` the global arrays are cut to the rank's block."""
    return tensors_from(HydroState, sliced(s, mesh), device, dtype)


def bdy_from_numpy(b, device="cuda", dtype=torch.float64,
                   mesh=None) -> BdyState:
    """BdyState of tensors from any NamedTuple with the same fields (cut
    to the rank's block of ``mesh``)."""
    return tensors_from(BdyState, sliced(b, mesh), device, dtype)


def state_to_numpy(s: HydroState) -> dict:
    """Field name → numpy array (host copy)."""
    return {k: v.detach().cpu().numpy() for k, v in s._asdict().items()
            if v is not None}

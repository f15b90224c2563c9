"""Tracer convective transport — the well-mixed redistribution of
``Main/chemlib/mod_che_cumtran.F90`` (cumtran1 :73, cumtran2 :118),
torch twin of ``regcm_tpu/chem/cumtran.py``.

On every syncro_cum alarm (mod_tendency.F90:595-603), columns whose
active cumulus scheme does not transport tracers itself (anything but
Emanuel/Tiedtke, init_cumtran :56-68) blend each tracer toward its
sigma-weighted column mean over the cumulus-cloud depth, weighted by the
convective cloud fraction:

    chi(k) ← chi(k)·(1−f(k)) + f(k)·⟨chi⟩        k ∈ [kctop, kz]

with ⟨chi⟩ = Σ chi·Δσ / Σ Δσ over the same span (added in level order,
``level_sum``) and f = convcldfra. The cloud-top index comes from the
held convective cloud fraction, clamped to level 4 (1-based) as the
reference does — here 0-based index 3.
"""
from __future__ import annotations

import torch

from ..dynamics.hydrostatic import level_sum


def cumtran(chis, cucldfra, dsigma, dotran):
    """Redistribute tracers in convective columns.

    chis: tuple of (ntr, kz, iy, jx) tracer tensors (the leapfrog pair
    of the hydrostatic core — cumtran2 —, a 1-tuple for MOLOCH —
    cumtran1); cucldfra (kz, iy, jx) held cumulus cloud fraction; dsigma
    (kz,); dotran (iy, jx) bool mask of the columns whose scheme needs
    the external transport. Returns the tuple updated."""
    kz = cucldfra.shape[0]
    karr = torch.arange(kz, device=cucldfra.device)[:, None, None]
    cloudy = cucldfra > 0.0
    has_cloud = cloudy.any(dim=0)
    # top-down index of the first cloudy level, clamped (:92)
    kctop = torch.clamp(torch.argmax(cloudy.to(torch.int32), dim=0), min=3)
    span = (karr >= kctop[None]) & has_cloud[None] & dotran[None]
    ds = dsigma[:, None, None]
    deltas = level_sum(torch.where(span, ds, 0.0))
    f = torch.where(span, cucldfra, 0.0)
    out = []
    for chi in chis:
        chibar = level_sum(torch.movedim(
            torch.where(span[None], chi * ds[None], 0.0), 1, 0)) \
            / torch.clamp(deltas, min=1e-10)[None]
        out.append(torch.where(span[None],
                               chi * (1.0 - f[None])
                               + f[None] * chibar[:, None], chi))
    return tuple(out)

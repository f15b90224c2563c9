"""Slab (mixed-layer) ocean (islab_ocean=1), torch twin of
``regcm_tpu/physics/surface/slab.py``.

``Main/mod_slabocean.F90`` (``update_slabocean`` :95-163): the SST from
the mixed-layer energy budget ``C_ml dSST/dt = FSW − FLW − H − L·E +
Qflux``, with a restoring term toward the boundary SST
(``do_restore_sst``, ``(SSTbc − SST)·C_ml/τ``) and the climatological
q-flux adjustment ``qflux_adj``; ``C_ml = mixed_layer_depth·4e6`` J/m²/K
(:77). A dense masked update over the ocean points.
"""
from __future__ import annotations

import torch

from ...utils import constants as c


def update_slabocean(sst, sstbc, ocmask, fsw, flw_up, hfx, qfx, dtocean,
                     mixed_layer_depth=50.0, do_restore_sst=True,
                     sst_restore_timescale=5.0, qflux_adj=0.0):
    """Advance the SST one surface step; returns (sst_new, qflux_sst).

    sst the prognostic SST (K); sstbc the forcing SST of the restoring
    term (``xtsb%b1``); ocmask the ocean points (bool); fsw net surface SW
    (+down) and flw_up net surface LW cooling (+up, W/m2); hfx, qfx the
    sensible flux (W/m2) and evaporation (kg/m2/s), + upward; dtocean
    the surface step (s)."""
    mlcp = mixed_layer_depth * 4.0e6
    if do_restore_sst:
        qflux_sst = (sstbc - sst) * mlcp / (sst_restore_timescale * 86400.0)
    else:
        qflux_sst = torch.zeros_like(sst)
    hflx = fsw - flw_up - hfx - c.wlhv * qfx
    net_hflx = hflx + qflux_adj + qflux_sst
    sst_new = torch.where(ocmask, sst + dtocean * net_hflx / mlcp, sst)
    return sst_new, torch.where(ocmask, qflux_sst, 0.0)

"""Whole-grid dispatch glue of the TKE PBL schemes (the UW TCM and MYJ),
torch twin of ``regcm_tpu/physics/uw_dispatch.py``.

Maps the PhysicsSuite slice dict onto the column scheme's inputs, the
way ``mod_pbl_interface.F90:100-185`` stages ``mod_2_pbl``.
"""
from __future__ import annotations

import math

import torch

from .pbl.myj import myjpbl
from .pbl.uwtcm import UWParams, uwtcm


def _ptrop_index(pb3, xlat):
    """Tropopause level index: largest k with p < ptrop(lat)
    (mod_slice.F90:330-340; ptrop map from mod_init.F90:936)."""
    ptrop = 250.0e2 - 150.0e2 * torch.cos(xlat * (math.pi / 180.0)) ** 2
    cnt = torch.sum((pb3 < ptrop[None]).to(torch.int64), dim=0)
    return torch.clamp(cnt - 1, min=1)


def run_uwtcm(suite, core, atms, s, dt):
    """One UW TCM step of the suite: the uncoupled tendencies and the
    physics TKE tendency."""
    kz = core.kz
    ex = suite.cfg.physics.extras
    p = UWParams(atwo=float(ex.get("atwo", 15.0)),
                 rstbl=float(ex.get("rstbl", 1.5)),
                 czero=float(ex.get("czero", 5.869)),
                 nuk=float(ex.get("nuk", 5.0)))
    qib3 = atms["qhb3"][2] if core.nqx == 5 \
        else torch.zeros_like(atms["qcb3"])
    ktr = _ptrop_index(atms["pb3"], suite.xlat)
    out = uwtcm(
        atms["tb3"], atms["qvb3"], atms["qcb3"], qib3,
        atms["ubx3"], atms["vbx3"], atms["za"], atms["zq"],
        atms["dzq"], atms["pb3"], atms["pf3"], s.tke_b,
        s.heatrt, s.tg, atms["qvb3"][kz - 1], s.qfx, s.hfx,
        s.uvdrag, core.grid_lndocn, ktr, dt, p=p,
        diffuse_ice=(core.nqx == 5))
    return dict(tten=out.tten, qvten=out.qvten, qcten=out.qcten,
                qiten=out.qiten, uten=out.uten, vten=out.vten,
                tketen=out.tketen)


def run_myj(suite, core, atms, s, flags, dt):
    """One MYJ step of the suite: the uncoupled tendencies and the
    persistent state, the PBL TKE in ``tke_a[:kz]`` (not advected by the
    core) and the surface-layer thz0/qz0 in ``pbl0``."""
    kz = core.kz
    qib3 = atms["qhb3"][2] if core.nqx == 5 \
        else torch.zeros_like(atms["qcb3"])
    out = myjpbl(
        atms["tb3"], atms["qvb3"], atms["qcb3"], qib3,
        atms["ubx3"], atms["vbx3"], atms["zq"], core.ht,
        atms["pb3"], atms["pf3"], s.tke_a[:kz], s.tg,
        atms["qvb3"][kz - 1], s.uvdrag, core.grid_lndocn,
        s.pbl0[0], s.pbl0[1], dt,
        five_species=(core.nqx == 5), first=flags.first)
    return dict(tten=out.tten, qvten=out.qvten, qcten=out.qcten,
                qiten=out.qiten, uten=out.uten, vten=out.vten,
                tke_a=torch.cat([out.tkepbl, s.tke_a[kz:]]),
                pbl0=torch.stack([out.thz0, out.qz0]))

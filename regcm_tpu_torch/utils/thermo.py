"""Moist thermodynamics helpers (torch twin of ``regcm_tpu/utils/thermo.py``).

Flatau et al. (1992) saturation vapour pressure (``Share/pfesat.inc``),
saturation mixing ratio / specific humidity and the latent-heat and
moist-heat-capacity helpers. Elementwise on tensors of any shape;
the result keeps the input dtype.
"""
from __future__ import annotations

import torch

from ..utils import constants as c

# Flatau et al. (1992) polynomial coefficients — water (0..100 C)
_AW = (6.11213476, 0.444007856, 0.143064234e-01, 0.264461437e-03,
       0.305903558e-05, 0.196237241e-07, 0.892344772e-10,
       -0.373208410e-12, 0.209339997e-15)
# ice (-75..0 C)
_AI = (6.11123516, 0.503109514, 0.188369801e-01, 0.420547422e-03,
       0.614396778e-05, 0.602780717e-07, 0.387940929e-09,
       0.149436277e-11, 0.262655803e-14)


def _poly8(td, a):
    r = a[8]
    for k in range(7, -1, -1):
        r = a[k] + td * r
    return r


def pfesat(t):
    """Saturation vapour pressure (Pa) over water/ice."""
    td = torch.clamp(t - c.tzero, -75.0, 100.0)
    return torch.where(td >= 0.0, _poly8(td, _AW), _poly8(td, _AI)) * 100.0


def pfwsat(t, p, e=None):
    """Saturation mixing ratio (kg/kg dry air)."""
    es = pfesat(t) if e is None else e
    return c.ep2 * (es / (p - es))


def pfqsat(t, p, e=None):
    """Saturation specific humidity (kg/kg)."""
    ws = pfwsat(t, p, e)
    return ws / (1.0 + ws)


def pfqsdt(t, p):
    """d(qsat)/dT at constant p (Clausius-Clapeyron form)."""
    es = pfesat(t)
    qs = pfqsat(t, p, es)
    # one branch a tensor of t's dtype: where() on two Python scalars
    # would return the default dtype
    lh = torch.where(t > c.tzero, t.new_tensor(c.wlhv), c.wlhs)
    return qs * lh / (c.rwat * t * t)


def wlh(t):
    """Latent heat with the SUBEX temperature dependence."""
    return torch.where(t > c.tzero, c.wlhv - 2369.0 * (t - c.tzero), c.wlhs)


def cpmf(q):
    """Specific heat of moist air (Share/cpmf.inc): cpd(1-q) + cpv·q."""
    return c.cpd * (1.0 - q) + c.cpv * q

"""Shallow convection (negative icup), torch twin of
``regcm_tpu/physics/cumulus/shallow.py``.

``Main/cumlib/mod_cu_shallow.F90`` (``shallcu`` :42, ``shallow``
:98-894): a Grell/Arakawa-Schubert-type non-precipitating shallow
cumulus. Two static controls, on the current state and on the
large-scale-forced state, and a cloud-modified state from the
unit-mass-flux response give the mass flux ``xmb = -f/xk``, with
``f = (AA_forced - AA_current)/dt`` and ``xk = (AA_modified -
AA_current)/mbdt``. With ``c0 = 0`` (:36) the scheme only redistributes
T and qv.

Columns are (ncol, kz) tensors, bottom-up. The level searches are masked
reductions, the ``kbloop`` cloud-base retry an exhaustive scan over the
candidate departure levels, and the in-cloud MSE and moisture cascades
(``entrs``/``precip``) and the height build loops over the levels on
(ncol,) planes; the cloud work function sums in level order
(``level_sum``). The reference's quirks stand, as in the JAX package:
the ``entrs`` layer "thickness" ``½(z[k-1]+z[k+1])`` (a sum, :605) and
the zeroed ``della(kbeg)`` (:653).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ...dynamics.hydrostatic import level_sum
from ...utils import constants as c
# the hydrostatic height build (heipre, :704-717) is Grell's
from .grell import _first_true, _heights as _heipre, _mid, _take

RADS = 50.0          # :34  entrainment radius, rate xx = 0.2/rads
PCUT = 400.0         # :35  hPa, full rainout threshold (moot, c0=0)
C0 = 0.0             # :36  autoconversion (zero: no shallow precip)
DEPTH_MAX = 3000.0   # :610 shallow cloud depth cap (m)

_HT1 = c.wlhv / c.cpd
_BE = c.ep2 * _HT1 / c.c287
_AE = _BE / c.tzero + math.log(c.c1es)


class ShallowOut(NamedTuple):
    outts: torch.Tensor     # (ncol, kz) bottom-up T tendency (K/s)
    outqs: torch.Tensor     # qv tendency (kg/kg/s)
    xmb: torch.Tensor       # cloud-base mass flux (kg/m2/s)


def _qes(t, p):
    """Local saturation mixing ratio (:245-250); p in hPa."""
    e = torch.exp(_AE - _BE / t)
    q = c.ep2 * e / (100.0 * p - (1.0 - c.ep2) * e)
    return torch.clamp(q, min=c.minqq)


def _entrs(kbcon, he, hes, z, hkb, xx):
    """In-cloud MSE and cloud top (entrs, :583-615). Returns (hc, ktop,
    active); ktop < 2 is inactive (the reference returns)."""
    ncol, kz = he.shape
    ii = torch.arange(kz, device=he.device)[None, :]
    hesmid = _mid(hes)
    hc = torch.where(ii <= kbcon[:, None], hkb[:, None], hesmid)
    zkbc1 = _take(z, torch.clamp(kbcon + 1, max=kz - 1))
    hc_prev = hkb
    ktop = torch.ones((ncol,), dtype=torch.int64, device=he.device)
    stopped = torch.zeros((ncol,), dtype=torch.bool, device=he.device)
    for k in range(1, kz - 1):
        # the reference's dz is the sum ½(z[k-1]+z[k+1]) (:605)
        dz = 0.5 * (z[:, k - 1] + z[:, k + 1])
        hc_k = (hc_prev * (1.0 - 0.5 * dz * xx) + xx * dz * he[:, k]) \
            / (1.0 + 0.5 * xx * dz)
        inloop = (k > kbcon) & ~stopped
        hc_k = torch.where(inloop, hc_k, hc[:, k])
        dby = hc_k - hesmid[:, k]
        depth = z[:, k] - zkbc1
        trig = inloop & ((dby < 0.0) | (depth > DEPTH_MAX))
        ktop = torch.where(trig, k - 1, ktop)
        stopped = stopped | trig
        hc_prev = torch.where(inloop, hc_k, hc_prev)
        hc[:, k] = hc_k
    return hc, ktop, (ktop >= 2) & stopped


def _zunc(kbeg, ktop, kz, dtype):
    """Normalized updraft mass flux (zunc, :765-799) with entnet=0:
    zu=1 for kbeg <= k <= ktop, 0 below kbeg."""
    ii = torch.arange(kz, device=kbeg.device)[None, :]
    return ((ii >= kbeg[:, None]) & (ii <= ktop[:, None])).to(dtype)


def _precip_qrc(kb, kbcon, ktop, xx, hc, hes, t, qe, qes, z, p, qkb):
    """In-cloud moisture cascade (precip, :811-892) with c0=0: the
    updraft water+vapour qrc equals the plume qc."""
    ncol, kz = t.shape
    ii = torch.arange(kz, device=t.device)[None, :]
    hesmid = _mid(hes)
    qrc = torch.where(ii <= kb[:, None], _mid(qe), qes)
    qrc = torch.where((ii >= kb[:, None]) & (ii <= kbcon[:, None]),
                      qkb[:, None], qrc)
    qc_prev = qkb
    for k in range(1, kz):
        attop = k == ktop
        dh = torch.where(attop, hc[:, k] - hes[:, k],
                         hc[:, k] - hesmid[:, k])
        dz = torch.where(attop, 0.5 * (z[:, k] - z[:, k - 1]),
                         0.5 * (z[:, min(k + 1, kz - 1)] - z[:, k - 1]))
        agamma = _HT1 * (c.wlhv / (c.rwat * t[:, k] ** 2)) * qe[:, k]
        qc_k = (qc_prev * (1.0 - xx * dz * 0.5) + xx * dz * qe[:, k]) \
            / (1.0 + 0.5 * dz * xx)
        qrch = qes[:, k] + (1.0 / c.wlhv) * (agamma / (1.0 + agamma)) * dh
        qrc_k = (qc_k - qrch) / (1.0 + C0 * dz) + qrch
        qrc_k = torch.where(attop, (qc_k - qes[:, k]) / (1.0 + C0 * dz)
                            + qes[:, k], qrc_k)
        qrc_k = torch.where(attop & (p[:, k] < PCUT), qes[:, k], qrc_k)
        inloop = (k > kbcon) & (k <= ktop)
        qrc_k = torch.where(inloop, qrc_k, qrc[:, k])
        qc_prev = torch.where(inloop, qrc_k, qc_prev)   # qc(k)=qrc(k)
        qrc[:, k] = qrc_k
    return qrc


def _nxt(a):
    return torch.cat([a[:, 1:], a[:, -1:]], dim=1)


def _prv(a):
    return torch.cat([a[:, :1], a[:, :-1]], dim=1)


def _cloudws(hc, qes, hes, zu, z, t, kbcon, ktop):
    """Cloud work function (cloudws, :553-578)."""
    kz = t.shape[1]
    ii = torch.arange(kz, device=t.device)[None, :]
    g1 = _HT1 * (c.wlhv / (c.rwat * t ** 2)) * qes
    dt2 = 0.5 * (t + _nxt(t))
    dg = 0.5 * (g1 + _nxt(g1))
    dh = 0.5 * (hes + _nxt(hes))
    dz = _nxt(z) - z
    aa = dz * (c.egrav / (c.cpd * dt2)) * zu * ((hc - dh) / (1.0 + dg))
    lay = (ii >= kbcon[:, None]) & (ii <= ktop[:, None])
    return level_sum(torch.where(lay, aa, 0.0).T)


def _static_control(t, qe_in, p, psurf, z1, kbmax, xx):
    """One full static control: environment, cloud base and top,
    in-cloud profiles, cloud work function (:243-351)."""
    ncol, kz = t.shape
    ii = torch.arange(kz, device=t.device)[None, :]
    qes = _qes(t, p)
    qe = torch.minimum(qe_in, qes)
    tv = t + c.ep1 * qe * t
    z = _heipre(p, tv, z1, psurf)
    he = c.egrav * z + c.cpd * t + c.wlhv * qe
    hes = c.egrav * z + c.cpd * t + c.wlhv * qes
    he = torch.minimum(he, hes)
    het = _mid(he)

    # kbhe = argmin hes (minim from 1, :273-275); k22 = the LAST argmax
    # of het in [0, kbhe] (maxim uses >=, :746-761)
    kbhe = torch.argmin(hes, dim=1)
    hmask = torch.where(ii <= kbhe[:, None], het, -1e30)
    k22_0 = kz - 1 - torch.argmax(torch.flip(hmask, [1]), dim=1)

    # kbloop (:280-303): the smallest k22 >= k22_0 whose hkb reaches free
    # convection below kz-1; inactive if none <= kbmax
    hemid = het
    hesmid = _mid(hes)
    # cand[n, j, k]: hkb(j) >= hesmid(k) for k >= j (j the candidate)
    cand = (hemid[:, :, None] >= hesmid[:, None, :]) \
        & (ii[:, None, :] >= ii[:, :, None]) \
        & (ii[:, None, :] <= kz - 3)
    okj = cand.any(dim=2) & (ii >= k22_0[:, None]) & (ii <= kbmax)
    k22 = _first_true(okj, ii, kz - 1)
    act = okj.any(dim=1)
    cand_sel = torch.gather(
        cand, 1, k22[:, None, None].expand(ncol, 1, kz))[:, 0, :]
    kbcon = torch.clamp(torch.where(cand_sel, ii, 10 ** 6).amin(dim=1),
                        max=kz - 2)

    hkb = _take(hemid, k22)
    qkb = _take(_mid(qe), k22)

    hc, ktop, topok = _entrs(kbcon, he, hes, z, hkb, xx)
    act = act & topok
    ktop = torch.clamp(ktop, 2, kz - 3)
    zu = _zunc(k22, ktop, kz, t.dtype)
    qrc = _precip_qrc(k22, kbcon, ktop, xx, hc, hes, t, qe, qes, z, p,
                      qkb)
    ax = _cloudws(hc, qes, hes, zu, z, t, kbcon, ktop)
    aa = torch.clamp(ax, min=0.0)
    act = act & (ax > 0.0)
    return dict(qes=qes, qe=qe, z=z, he=he, hes=hes, hc=hc, qrc=qrc,
                zu=zu, k22=k22, kbcon=kbcon, ktop=ktop, hkb=hkb,
                qkb=qkb, aa=aa, act=act)


def _kerhels(var, xx, zu, vkb, vc, p, z, kb, kbeg, ktop, mbdt, cd,
             clamp):
    """Unit-mass-flux response della and modified field xvar (kerhels,
    :621-702). kb = kbcon (the detrainment floor), kbeg = k22."""
    kz = var.shape[1]
    ii = torch.arange(kz, device=var.device)[None, :]
    dv1 = 0.5 * (var + _nxt(var))
    dv2 = var
    dv3 = 0.5 * (var + _prv(var))
    zu2 = _prv(zu)
    dz = 0.5 * (_nxt(z) - _prv(z))
    detup = (0.5 * (_prv(vc) + vc) - dv2) * xx * cd * dz * zu2
    detup = torch.where(ii <= kb[:, None], 0.0, detup)
    dp = 50.0 * (_prv(p) - _nxt(p))
    della = (zu * (dv1 - dv2) + zu2 * (dv2 - dv3) + detup) * c.egrav / dp
    interior = (ii >= kbeg[:, None] + 1) & (ii <= ktop[:, None] - 1)
    della = torch.where(interior, della, 0.0)
    # cloud top (:679-684)
    tk = lambda a: _take(a, ktop)
    tkm = lambda a: _take(a, ktop - 1)
    dptop = 100.0 * (tkm(p) - tk(p))
    dtop = tkm(zu) * (tk(vc) - 0.5 * (tk(var) + tkm(var))) \
        * c.egrav / dptop
    della = torch.where(ii == ktop[:, None], dtop[:, None], della)
    xvar = della * mbdt + var
    if clamp:
        bad = (xvar <= 0.0) & (ii <= ktop[:, None])
        xvar = torch.where(bad, c.minqq, xvar)
        della = torch.where(bad, 0.0, della)
    xvkb = _take(della, torch.clamp(kbeg, min=0)) * mbdt + vkb
    return della, xvar, xvkb


def shallcu(t, q, tten, qvten, p, psur, ter, dtime, dtcum=None
            ) -> ShallowOut:
    """Shallow convection on (ncol, kz) BOTTOM-UP columns.

    t/q: current decoupled T (K) and qv (kg/kg); tten/qvten: decoupled
    accumulated tendencies (K/s, kg/kg/s) defining the forced state
    (tns/qns, :65-69); p (hPa), psur (hPa), ter terrain (m); dtime:
    leapfrog dt (s); dtcum: the cumulus call interval (defaults to dt).
    """
    ncol, kz = t.shape
    if dtcum is None:
        dtcum = dtime
    xx = 0.2 / RADS
    mbdt = dtcum * 5.0e-3
    kbmax = (kz * 3) // 4 - 3 - 1          # 0-based (:52)
    z1 = torch.clamp(ter, min=1.0e-5)
    cd = xx        # cdd(k)=1·xx (:222); detup gets r·cd

    tns = t + tten * dtime
    qns = q + qvten * dtime

    # ---- pass 1: the current state
    s1 = _static_control(t, q, p, psur, z1, kbmax, xx)
    act = s1["act"]
    aa1 = s1["aa"]

    # the kernel state (lloop==1 block, :368-477)
    hh, xhe, xhkb = _kerhels(s1["he"], xx, s1["zu"], s1["hkb"], s1["hc"],
                             p, s1["z"], s1["kbcon"], s1["k22"],
                             s1["ktop"], mbdt, cd, False)
    dq, xqe, xqkb = _kerhels(s1["qe"], xx, s1["zu"], s1["qkb"],
                             s1["qrc"], p, s1["z"], s1["kbcon"],
                             s1["k22"], s1["ktop"], mbdt, cd, True)
    xt = (mbdt / c.cpd) * (hh - c.wlhv * dq) + t
    dellt = (1.0 / c.cpd) * (hh - c.wlhv * dq)
    dellq = dq

    # the modified state's environment (:406-426)
    xqe = torch.clamp(xqe, min=c.minqq)
    xqes = _qes(xt, p)
    xqe = torch.minimum(xqe, xqes)
    xtv = xt + c.ep1 * xqe * xt
    xz = _heipre(p, xtv, z1, psur)
    xhes = c.egrav * xz + c.cpd * xt + c.wlhv * xqes
    xhe = torch.minimum(xhe, xhes)
    xhc, ktopx, xok = _entrs(s1["kbcon"], xhe, xhes, xz, xhkb, xx)
    ktopx = torch.clamp(ktopx, 2, kz - 3)
    xzu = _zunc(s1["k22"], ktopx, kz, t.dtype)
    xax = _cloudws(xhc, xqes, xhes, xzu, xz, xt, s1["kbcon"], ktopx)
    xa = torch.where(xok, torch.clamp(xax, min=0.0), 0.0)
    act = act & ~((xa < c.dlowval) & (aa1 < c.dlowval))
    xk = (xa - aa1) / mbdt
    xk = torch.where(xk > 0.0, -1.0, xk)

    # ---- pass 2: the large-scale-forced state (:181-205, 479-490)
    s2 = _static_control(tns, qns, p, psur, z1, kbmax, xx)
    aold = aa1
    aa2 = torch.where(s2["act"], s2["aa"], 0.0)
    f = torch.where((aold < c.dlowval) | (aa2 < c.dlowval), 0.0,
                    (aa2 - aold) / dtcum)
    xmb = torch.where(xk.abs() > c.dlowval, -f / xk, 0.0)
    xmb = torch.clamp(xmb, min=0.0)
    act = act & (s1["k22"] <= kbmax)
    xmb = torch.where(act, xmb, 0.0)

    # ---- feedback (araouts, :508-551)
    outtes = dellt * xmb[:, None] * 86400.0
    bad = ((outtes > 500.0) | (outtes < -200.0)).any(dim=1)
    xmb = torch.where(bad, 0.0, xmb)
    return ShallowOut(outts=dellt * xmb[:, None],
                      outqs=dellq * xmb[:, None], xmb=xmb)

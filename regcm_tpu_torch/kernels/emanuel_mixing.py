"""K2: Emanuel buoyancy-sorting mixing matrices, reduced per level.

``emanuel_mixing(h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph, unk,
vnk, icb, ict, cloud)`` returns the eight (ncol, L) terms that the
Emanuel tendency stage consumes (mod_cu_em.F90:723-840, 975-1100):

  wdtrain_mix  g·Σ_{i<j} max(elij−(1−ep_j)clw_j, 0)·ment(i,j)   (per j)
  amp1_e       Σ_{k<=i, j>i} ment(k,j)
  ad           Σ_{k<i, j>=i} ment(k,j)
  mentii/qentii  diagonals ment(i,i), qent(i,i)
  sum_q/u/v    Σ_i ment(i,j)·(Xent(i,j)[−awat]−X_j)

in the columns-first layout that ``cupeman`` uses; row i of the (L, L)
mixing matrices is the draught, column j the level. It replaces the TPU
kernel ``regcm_tpu/dynamics/pallas_kernels.py`` ``emanuel_mixing``
(body ``regcm_tpu/physics/cumulus/emanuel.py`` ``_mixing_body``). A CPU
tensor goes to ``emanuel_mixing_plain``; a CUDA tensor launches the
hand-written kernel ``csrc/emanuel_mixing.cu`` or raises.

The tracer form (``tra`` (ncol, L, ntr) and ``trank`` (ncol, ntr), the
chemistry tracers and their values at the parcel origin level) also
returns ``sum_tra`` (ncol, L, ntr), the tracer mixing contraction of
``_mixing_body(tra=, trank=)``, from the same kernel pass; at most
``MAX_TRACERS`` tracers.
"""
from __future__ import annotations

import ctypes

import torch

from ..utils import constants as c

from . import _build

# kernel launches since the last reset (plain-version calls not counted),
# and those of them in the tracer form
launches = 0
launches_tracers = 0

KEYS = ("wdtrain_mix", "amp1_e", "ad", "mentii", "qentii",
        "sum_q", "sum_u", "sum_v")
MAX_LEVELS = 64          # one 64-bit validity mask per row in the kernel
# the tracer form's sums sit in shared memory (csrc MAX_TRA, past 48 KB
# by the launch's opt-in); the largest chemsimtype, CB6, has 51 tracers
MAX_TRACERS = 64

_P = ctypes.c_void_p
_D = ctypes.c_double
# 13 level arrays, unk, vnk, icb, ict, cloud, out, ncol, L, stream and
# the constants rwat, cpd, cpv, egrav
_SIG = [_P] * 18 + [_P, ctypes.c_int, ctypes.c_int, _P, _D, _D, _D, _D]
# the tracer form: tra, trank, sum_tra, ntr after those
_SIG_TRA = _SIG + [_P, _P, _P, ctypes.c_int]


def build():
    """Compile and load the CUDA library (once per process)."""
    # -fmad=false: no contraction to FMA, so each (i, j) pair rounds
    # like the plain version and the validity thresholds agree
    return _build.load("emanuel_mixing", {
        "emanuel_mixing_f32": _SIG, "emanuel_mixing_f64": _SIG,
        "emanuel_mixing_tra_f32": _SIG_TRA,
        "emanuel_mixing_tra_f64": _SIG_TRA}, extra_flags=["-fmad=false"])


def emanuel_mixing_plain(h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph,
                         unk, vnk, icb, ict, cloud, counts=None, tra=None,
                         trank=None):
    """The (i, j) mixing-matrix algebra (cupeman :723-840) reduced to its
    per-level contractions, on materialised (ncol, L, L) tensors; op for
    op ``_mixing_body`` with ``_LayCF`` (i on axis 1, j on axis 2), the
    tracer contraction ``sum_tra`` too when ``tra``/``trank`` are given.

    ``counts``, if a dict, receives the number of (i, j) pairs that take
    each data-dependent branch (``redo``, ``valid``, ``valid_gt`` = valid
    with j > i, ``c_cond``, ``use_min``), from which the work these
    inputs need is counted."""
    A = lambda x: x[:, :, None]
    B = lambda x: x[:, None, :]
    S = lambda x: x[:, None, None]
    L = h.shape[1]
    dev = h.device
    iota = torch.arange(L, device=dev)
    iota_i = iota[None, :, None]
    iota_j = iota[None, None, :]
    eye3 = iota_i == iota_j
    jgti = iota_i < iota_j                       # j > i

    bf2 = 1.0 + B(lv) * B(lv) * B(qs) / (c.rwat * B(t) * B(t) * c.cpd)
    anum = B(h) - A(hp) + (c.cpv - c.cpd) * B(t) * (A(qti) - B(q))
    denom = A(h) - A(hp) + (c.cpd - c.cpv) * (A(q) - A(qti)) * B(t)
    dei = torch.where(torch.abs(denom) < 0.01, 0.01, denom)
    sij = torch.where(eye3, 1.0, anum / dei)
    altem = (sij * A(q) + (1.0 - sij) * A(qti) - B(qs)) / bf2
    cwat = B(clw * (1.0 - ep))
    redo = ((sij < 0.0) | (sij > 1.0) | (altem > cwat)) & jgti
    anum2 = anum - B(lv) * (A(qti) - B(qs) - cwat * bf2)
    denom2 = denom + B(lv) * (A(q) - A(qti))
    denom2 = torch.where(torch.abs(denom2) < 0.01, 0.01, denom2)
    sij2 = anum2 / denom2
    altem2 = sij2 * A(q) + (1.0 - sij2) * A(qti) - B(qs) \
        - (bf2 - 1.0) * cwat
    sij = torch.where(redo, sij2, sij)
    altem = torch.where(redo, altem2, altem)
    valid = (sij > 0.0) & (sij < 0.9)
    jrange = (iota_j >= S(icb)) & (iota_j <= S(ict))
    valid = valid & A(cloud) & jrange
    qent = torch.where(valid, sij * A(q) + (1.0 - sij) * A(qti), B(q))
    uent = torch.where(valid, sij * A(u) + (1.0 - sij) * S(unk), B(u))
    vent = torch.where(valid, sij * A(v) + (1.0 - sij) * S(vnk), B(v))
    elij = torch.where(valid, torch.clamp(altem, min=0.0), 0.0)
    ment = torch.where(valid, A(m) / (1.0 - torch.clamp(sij, 0.0, 0.899)),
                       0.0)
    nent = torch.sum(valid.to(h.dtype), dim=2)
    sij_pre = sij       # traent/qent use the pre-clip mixing fraction
    sij = torch.clamp(sij, 0.0, 1.0)

    # no-entrainment detrainment fallback (:770-786)
    noent = (nent < 0.5) & cloud
    diag_set = A(noent) & eye3

    def set_diag(mask, ment, qent, uent, vent, elij):
        return (torch.where(mask, A(m), ment),
                torch.where(mask, A(qti), qent),
                torch.where(mask, S(unk), uent),
                torch.where(mask, S(vnk), vent),
                torch.where(mask, A(clw), elij))

    ment, qent, uent, vent, elij = set_diag(diag_set, ment, qent, uent,
                                            vent, elij)

    # equal-probability normalisation of ment (:790-840)
    anum_s = h - hp - lv * (qti - qs)
    denom_s = h - hp + lv * (q - qti)
    denom_s = torch.where(torch.abs(denom_s) < 0.01, 0.01, denom_s)
    scrit = anum_s / denom_s
    alt = qti - qs + scrit * (q - qti)
    scrit = torch.clamp(torch.where(alt < 0.0, 1.0, scrit), min=0.0)
    sij_f = torch.where(A(cloud) & jrange, sij, 0.0)
    zpad = torch.zeros_like(sij_f[:, :, :1])
    sijp1 = torch.cat([sij_f[:, :, 1:], zpad], dim=2)
    sijm1 = torch.cat([zpad, sij_f[:, :, :-1]], dim=2)
    scrit_a = A(scrit)
    smid_gt = torch.minimum(sij, scrit_a)
    # the reference's running smin over accepted j>i pairs equals the
    # exclusive prefix-min over earlier candidate smids (:805-810)
    c_cond = valid & jgti & (sijp1 < smid_gt)
    cand = torch.where(c_cond, smid_gt, 1.0)
    prefmin = torch.cummin(torch.cat([torch.ones_like(cand[:, :, :1]),
                                      cand[:, :, :-1]], dim=2), dim=2)[0]
    use_min = c_cond & (smid_gt < prefmin)
    if counts is not None:
        for key, mask in (("redo", redo), ("valid", valid),
                          ("valid_gt", valid & jgti), ("c_cond", c_cond),
                          ("use_min", use_min)):
            counts[key] = int(mask.sum())
    sjmax_gt = torch.where(use_min,
                           torch.minimum(torch.minimum(sijp1, sij), scrit_a),
                           smid_gt)
    sjmin_gt = torch.where(use_min,
                           torch.minimum(torch.maximum(sijm1, sij), scrit_a),
                           smid_gt)
    sjmax_le = torch.maximum(sijp1, scrit_a)
    smid_le = torch.maximum(sij, scrit_a)
    sjmin_le = torch.maximum(torch.where(iota_j > 0, sijm1, 0.0), scrit_a)
    smid = torch.where(jgti, smid_gt, smid_le)
    sjmax = torch.where(jgti, sjmax_gt, sjmax_le)
    sjmin = torch.where(jgti, sjmin_gt, sjmin_le)
    wgt = (torch.abs(sjmax - smid) + torch.abs(sjmin - smid)) * B(dph)
    has_ent = A(nent > 0.5)
    ment_n = torch.where(valid & has_ent, ment * wgt, ment)
    asij = torch.clamp(torch.sum(torch.where(valid, wgt, 0.0), dim=2),
                       min=1.0e-21)
    ment = torch.where(has_ent, ment_n / A(asij), ment_n)

    # post-normalisation fallback (:830-847)
    bsum = torch.sum(ment, dim=2)
    fb = (nent > 0.5) & (bsum < 1.0e-18) & cloud
    fbd = A(fb) & eye3
    ment, qent, uent, vent, elij = set_diag(fbd, ment, qent, uent, vent,
                                            elij)
    diag_set = diag_set | fbd

    # reductions
    awat = torch.clamp(elij - (1.0 - B(ep)) * B(clw), min=0.0)
    awat_k = torch.where(jgti, awat, 0.0)
    wdtrain_mix = c.egrav * torch.sum(awat_k * ment, dim=1)
    # amp1_e(i) = Σ_{k<=i, j>i} ment(k,j); ad(i) = Σ_{k<i, j>=i}
    suf_j = torch.flip(torch.cumsum(torch.flip(ment, [2]), dim=2), [2])
    ski = torch.cat([suf_j[:, :, 1:], torch.zeros_like(suf_j[:, :, :1])],
                    dim=2)
    amp1_e = torch.diagonal(torch.cumsum(ski, dim=1), dim1=1, dim2=2)
    pre_k = torch.cumsum(ment, dim=1)            # Σ_{k'<=k} ment(k', j)
    dji = torch.cat([torch.zeros_like(pre_k[:, :1]), pre_k[:, :-1]], dim=1)
    ad = torch.diagonal(torch.flip(torch.cumsum(torch.flip(dji, [2]),
                                                dim=2), [2]),
                        dim1=1, dim2=2)
    out = dict(
        wdtrain_mix=wdtrain_mix, amp1_e=amp1_e.contiguous(),
        ad=ad.contiguous(),
        mentii=torch.diagonal(ment, dim1=1, dim2=2).contiguous(),
        qentii=torch.diagonal(qent, dim1=1, dim2=2).contiguous(),
        sum_q=torch.sum(ment * (qent - awat_k - B(q)), dim=1),
        sum_u=torch.sum(ment * (uent - B(u)), dim=1),
        sum_v=torch.sum(ment * (vent - B(v)), dim=1))
    if tra is not None:
        # tracer mixing contraction (:751-753, :839-843, :1061-1077):
        # traent(k,i) = sij·tra_k + (1-sij)·tra_nk on valid pairs, tra_nk
        # on the no-entrainment diagonal → Σ_k ment·(traent − tra_i) as
        # one contraction a tracer plus two tracer-independent columns
        w1 = torch.where(valid, ment * sij_pre, 0.0)
        w2c = torch.sum(torch.where(valid, ment * (1.0 - sij_pre), 0.0)
                        + torch.where(diag_set, ment, 0.0), dim=1)
        mentc = torch.sum(ment, dim=1)
        sums = [torch.sum(w1 * A(tra[:, :, n]), dim=1)
                for n in range(tra.shape[-1])]
        out["sum_tra"] = (torch.stack(sums, dim=-1)
                          + w2c[:, :, None] * trank[:, None, :]
                          - mentc[:, :, None] * tra)
    return out


def _check(levels, cols, ints, cloud):
    ref = levels[0]
    if ref.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"emanuel_mixing: dtype {ref.dtype} not supported "
                        "(float32 or float64)")
    if ref.dim() != 2:
        raise ValueError("emanuel_mixing: level arrays must be (ncol, L), "
                         f"got shape {tuple(ref.shape)}")
    ncol, L = ref.shape
    if L > MAX_LEVELS:
        raise ValueError(f"emanuel_mixing: L={L} > {MAX_LEVELS} levels")
    for a in levels:
        if a.dtype != ref.dtype or a.shape != ref.shape \
                or a.device != ref.device:
            raise ValueError("emanuel_mixing: level arrays must share "
                             "dtype, shape and device")
    for a in cols:
        if a.dtype != ref.dtype or a.shape != (ncol,) \
                or a.device != ref.device:
            raise ValueError("emanuel_mixing: unk/vnk must be (ncol,) of "
                             "the level arrays' dtype and device")
    for a in ints:
        if a.dtype not in (torch.int32, torch.int64) \
                or a.shape != (ncol,) or a.device != ref.device:
            raise ValueError("emanuel_mixing: icb/ict must be (ncol,) "
                             "integer tensors on the same device")
    if cloud.dtype != torch.bool or cloud.shape != ref.shape \
            or cloud.device != ref.device:
        raise ValueError("emanuel_mixing: cloud must be a bool (ncol, L) "
                         "tensor on the same device")
    for a in (*levels, *cols, *ints, cloud):
        if not a.is_contiguous():
            raise ValueError("emanuel_mixing: inputs must be contiguous")


def _check_tra(ref, tra, trank):
    if (tra is None) != (trank is None):
        raise ValueError("emanuel_mixing: tra and trank go together")
    if tra is None:
        return
    ncol, L = ref.shape
    if tra.dim() != 3 or tuple(tra.shape[:2]) != (ncol, L):
        raise ValueError(f"emanuel_mixing: tra must be (ncol, L, ntr) = "
                         f"({ncol}, {L}, ntr), got {tuple(tra.shape)}")
    ntr = tra.shape[2]
    if not 1 <= ntr <= MAX_TRACERS:
        raise ValueError(f"emanuel_mixing: ntr={ntr} tracers, the kernel "
                         f"takes 1 to {MAX_TRACERS}")
    if tuple(trank.shape) != (ncol, ntr):
        raise ValueError("emanuel_mixing: trank must be (ncol, ntr), got "
                         f"{tuple(trank.shape)}")
    for a in (tra, trank):
        if a.dtype != ref.dtype or a.device != ref.device \
                or not a.is_contiguous():
            raise ValueError("emanuel_mixing: tra/trank must be contiguous "
                             "of the level arrays' dtype and device")


def emanuel_mixing(h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph,
                   unk, vnk, icb, ict, cloud, tra=None, trank=None):
    """Reduced Emanuel mixing terms; returns a dict of (ncol, L) tensors
    keyed by ``KEYS``, and ``sum_tra`` (ncol, L, ntr) with ``tra``."""
    global launches, launches_tracers
    levels = (h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph)
    _check(levels, (unk, vnk), (icb, ict), cloud)
    _check_tra(h, tra, trank)
    if h.device.type == "cpu":
        return emanuel_mixing_plain(*levels, unk, vnk, icb, ict, cloud,
                                    tra=tra, trank=trank)
    if h.device.type != "cuda":
        raise ValueError(f"emanuel_mixing: device {h.device} not supported")
    lib = build()
    ncol, L = h.shape
    out = torch.empty((len(KEYS), ncol, L), dtype=h.dtype, device=h.device)
    icb32 = icb.to(torch.int32)
    ict32 = ict.to(torch.int32)
    cld8 = cloud.to(torch.uint8)
    f64 = h.dtype == torch.float64
    args = [*(a.data_ptr() for a in levels), unk.data_ptr(), vnk.data_ptr(),
            icb32.data_ptr(), ict32.data_ptr(), cld8.data_ptr(),
            out.data_ptr(), ncol, L]
    consts = [c.rwat, c.cpd, c.cpv, c.egrav]
    with torch.cuda.device(h.device):
        stream = torch.cuda.current_stream().cuda_stream
        if tra is None:
            fn = lib.emanuel_mixing_f64 if f64 else lib.emanuel_mixing_f32
            rc = fn(*args, stream, *consts)
        else:
            sum_tra = torch.empty_like(tra)
            fn = lib.emanuel_mixing_tra_f64 if f64 \
                else lib.emanuel_mixing_tra_f32
            rc = fn(*args, stream, *consts, tra.data_ptr(), trank.data_ptr(),
                    sum_tra.data_ptr(), tra.shape[2])
    _build.check_status(rc, "emanuel_mixing")
    launches += 1
    launches_tracers += tra is not None
    res = {k: out[n] for n, k in enumerate(KEYS)}
    if tra is not None:
        res["sum_tra"] = sum_tra
    return res

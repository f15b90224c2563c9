// Emanuel (1991) buoyancy-sorting mixing matrices, reduced to the eight
// per-level terms the tendency stage consumes (cupeman,
// mod_cu_em.F90:723-840 and :975-1100), one convective column per warp.
//
// Replaces the TPU kernel regcm_tpu/dynamics/pallas_kernels.py
// emanuel_mixing (body regcm_tpu/physics/cumulus/emanuel.py _mixing_body
// in the columns-last layout).
//
// Bound: memory. A column reads 13 level profiles and writes 8, while
// the plain form materialises about ten (ncol, L, L) matrices in HBM;
// the work per (i, j) pair is a few dozen flops (at 36864 columns of 41
// levels ~2.1 G operations, 32 us at 67 TFLOP/s, against 38.6 us for
// the bytes). So nothing L x L may touch device memory, and the pair
// work must run on busy lanes with nothing serial beyond it.
//
// Layout: one warp walks the draught rows i of its column in order; its
// lanes run over the levels j, lane l holding j = l and j = l + 32 (the
// second slot only when 32 < L <= 64). Nothing L x L is kept anywhere:
// each row's (i, j) pairs live in the lanes' registers while the row is
// processed.
//   - The column's profiles sit in the warp's slice of shared memory
//     (14 x 64 values), read by lane j as level j and broadcast as row i;
//     registers hold only the row's pair state and the lane's sums, so a
//     thread fits in 64 registers and an SM runs 32 warps.
//   - The row quantities come from warp operations: nent from
//     __ballot_sync/__popc of the validity bits, asij and bsum from
//     __shfl_xor_sync butterflies (every lane gets the same bits).
//   - The exclusive running minimum of the normalisation loop (smin,
//     mod_cu_em.F90:798-821) is a warp min-scan over the c_cond
//     candidates, exact in any order, skipped in a slot with no
//     candidate (the minimum is then 1 throughout); sij at j+1 and j-1
//     come from shuffles.
//   - The column sums wd, sq, su, sv and the triangular sums amp1_e(j)
//     = sum_{r<=j} suf_r(j+1) and ad(j) = sum_{r<j} suf_r(j), with
//     suf_r(c) = sum_{c'>=c} ment(r, c') a warp suffix scan of row r,
//     accumulate in lane j's registers as i advances (O(L^2) a column).
//   - Work with nothing to add is skipped, warp-uniformly: a row outside
//     the cloud has no valid pair and ment = 0 throughout, so the warp
//     only stores its diagonal (mentii = 0, qentii = q_i); the second
//     slot's pairs are skipped when the cloud top and the row both lie
//     below level 32 (no valid pair, no diagonal there).
// wd, sq, su, sv add the rows in the plain version's order; asij, bsum
// and the triangular sums are taken in another order, within roundoff.
// Timed on the card (NVIDIA H100 80GB HBM3, 700 W): the divisions of
// the pair stage and the number of warps an SM holds set the time, not
// the bytes.
// Built with -fmad=false: the validity thresholds (sij > 0, sij < 0.9,
// redo) must round as the plain version does.
//
// The tracer form (emanuel_mixing_tra_*, chemistry's Emanuel transport,
// cupeman's traent/ftra, mod_cu_em.F90:751-753, :839-843, :1061-1077)
// also returns sum_tra(j, n) = sum_i w1(i, j) tra(i, n) + w2c(j) tra_nk(n)
// - mentc(j) tra(j, n), with w1 = ment sij on valid pairs, w2c = sum_i of
// ment (1 - sij) on valid pairs and of ment on the no-entrainment
// diagonal, mentc = sum_i ment; sij is the mixing fraction before its
// clip. It has no TPU kernel: the JAX package computes it in XLA beside
// its Pallas kernel (regcm_tpu/physics/cumulus/emanuel.py _mixing_body).
// It is formed in the same pass as the eight terms, from the row's final
// ment and sij in the lanes' registers, so the L x L pair algebra is not
// done twice. Lane j keeps its ntr sums sum_i w1 tra_i in its warp's
// slice of dynamic shared memory ((ntr, 32 NS) values, lanes on
// neighbouring words), the row's tracer values are broadcast loads, and
// the tracers loop inside the column. Its bound is the bytes as well: 2 L
// ntr values a column more (tra in, sum_tra out).
#include <cuda_runtime.h>

namespace {

constexpr int WPB = 2;                 // warps (columns) a block
constexpr int MIN_BLOCKS = 16;         // 64 registers: 32 warps an SM
// the tracer form's limit: its sums take WPB * ntr * 32 NS values of
// dynamic shared memory (up to 64 KB in f64 at 64 levels), beside the
// 14 KB of static; past the default 48 KB the launch opts in to more
// (cudaFuncAttributeMaxDynamicSharedMemorySize; 227 KB a block on sm_90).
// Each tracer's sums are its own, so the limit changes no number.
constexpr int MAX_TRA = 64;
constexpr size_t DEFAULT_SMEM = 48 * 1024;
constexpr unsigned FULL = 0xffffffffu;

struct Consts {
    double rwat, cpd, cpv, egrav;
};

template <typename T>
__device__ __forceinline__ T dmin(T a, T b) { return a < b ? a : b; }
template <typename T>
__device__ __forceinline__ T dmax(T a, T b) { return a > b ? a : b; }
template <typename T>
__device__ __forceinline__ T clampv(T x, T lo, T hi) {
    return dmin(dmax(x, lo), hi);
}
template <typename T>
__device__ __forceinline__ T fix01(T d) {
    return (d < T(0) ? -d : d) < T(0.01) ? T(0.01) : d;
}

// sum over the warp; every lane gets the same bits
template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) x = x + __shfl_xor_sync(FULL, x, d);
    return x;
}

// the row values of the column, one copy per warp in shared memory
enum { R_H, R_HP, R_Q, R_QTI, R_QS, R_LV, R_M, R_CLW, R_U, R_V, R_T, R_DPH,
       R_BF2, R_CWAT, NROW };
enum { O_WD, O_AMP1, O_AD, O_MENTII, O_QENTII, O_SUMQ, O_SUMU, O_SUMV };

// NS levels a lane: j = lane + 32 s, s < NS. TRA: the tracer form, which
// also contracts the (i, j) mixing weights with ntr tracer profiles
template <typename T, int NS, bool TRA>
__global__ void __launch_bounds__(WPB * 32, MIN_BLOCKS)
emanuel_mixing_kernel(
    const T* __restrict__ h, const T* __restrict__ hp,
    const T* __restrict__ q, const T* __restrict__ qs,
    const T* __restrict__ t, const T* __restrict__ lv,
    const T* __restrict__ qti, const T* __restrict__ clw,
    const T* __restrict__ ep, const T* __restrict__ m,
    const T* __restrict__ u, const T* __restrict__ v,
    const T* __restrict__ dph, const T* __restrict__ unk,
    const T* __restrict__ vnk, const int* __restrict__ icb,
    const int* __restrict__ ict, const unsigned char* __restrict__ cloud,
    T* __restrict__ out, int ncol, int L, Consts k,
    const T* __restrict__ tra, const T* __restrict__ trank,
    T* __restrict__ sum_tra, int ntr) {
    __shared__ T rows[WPB][NROW][32 * NS];
    __shared__ bool crow[WPB][32 * NS];
    // the tracer form's sums sum_i w1(i, j) tra(i, n), lane j's own
    // entries of its warp's (ntr, 32 NS) slice
    extern __shared__ __align__(16) unsigned char tra_smem[];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int col = blockIdx.x * WPB + w;
    if (col >= ncol) return;                 // a whole warp
    const long long off = (long long)col * L;
    const long long pl = (long long)ncol * L;
    const T rwat = T(k.rwat), cpd = T(k.cpd);
    const T cpvmcpd = T(k.cpv - k.cpd), cpdmcpv = T(k.cpd - k.cpv);
    T (*rv)[32 * NS] = rows[w];

    // the column's levels, as rows (i) and as levels (j) alike
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        const int j = lane + 32 * s;
        if (j < L) {
            const long long o = off + j;
            const T lvo = lv[o], qso = qs[o], to = t[o], clwo = clw[o];
            rv[R_H][j] = h[o];
            rv[R_HP][j] = hp[o];
            rv[R_Q][j] = q[o];
            rv[R_QTI][j] = qti[o];
            rv[R_QS][j] = qso;
            rv[R_LV][j] = lvo;
            rv[R_M][j] = m[o];
            rv[R_CLW][j] = clwo;
            rv[R_U][j] = u[o];
            rv[R_V][j] = v[o];
            rv[R_T][j] = to;
            rv[R_DPH][j] = dph[o];
            rv[R_BF2][j] = T(1) + lvo * lvo * qso / (rwat * to * to * cpd);
            rv[R_CWAT][j] = clwo * (T(1) - ep[o]);
            crow[w][j] = cloud[o] != 0;
        }
    }
    __syncwarp();
    const int icb_c = icb[col], ict_c = ict[col];
    const T unk_c = unk[col], vnk_c = vnk[col];

    T wd[NS], sq[NS], su[NS], sv[NS], amp1[NS], ad[NS];
#pragma unroll
    for (int s = 0; s < NS; ++s)
        wd[s] = sq[s] = su[s] = sv[s] = amp1[s] = ad[s] = T(0);
    // the tracer form: w2c(j) = sum_i of ment (1 - sij) on valid pairs and
    // ment on the no-entrainment diagonal, mentc(j) = sum_i ment(i, j)
    T w2c[NS], mentc[NS];
    T* acc = reinterpret_cast<T*>(tra_smem) + (long long)w * ntr * 32 * NS;
    const long long toff = off * ntr;         // (col, level 0, tracer 0)
#pragma unroll
    for (int s = 0; s < NS; ++s) {
        w2c[s] = mentc[s] = T(0);
        if (TRA)
            for (int n = 0; n < ntr; ++n) acc[n * 32 * NS + lane + 32 * s] = T(0);
    }

    for (int i = 0; i < L; ++i) {
        const T q_i = rv[R_Q][i];
        if (!crow[w][i]) {      // no valid pair, ment(i, .) = 0
            if (lane == (i & 31)) {
                out[O_MENTII * pl + off + i] = T(0);
                out[O_QENTII * pl + off + i] = q_i;
            }
            continue;
        }
        const T h_i = rv[R_H][i], hp_i = rv[R_HP][i], qti_i = rv[R_QTI][i];
        const T qs_i = rv[R_QS][i], lv_i = rv[R_LV][i], m_i = rv[R_M][i];
        const T clw_i = rv[R_CLW][i], u_i = rv[R_U][i], v_i = rv[R_V][i];

        // the second level slot holds no valid pair and no diagonal when
        // the cloud top and the row are below it: its ment is 0 throughout
        const bool act1 = ict_c >= 32 || i >= 32;
        // mixing fractions sij (with the redo branch), altem, validity;
        // sij_f (clipped, 0 outside [icb, ict])
        T U[NS], V[NS], Q[NS];
        bool val[NS];
        int nent = 0;
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int j = lane + 32 * s;
            U[s] = V[s] = Q[s] = T(0);
            val[s] = false;
            if (j < L && (s == 0 || act1)) {
                const T q_j = rv[R_Q][j], t_j = rv[R_T][j];
                const T qs_j = rv[R_QS][j], lv_j = rv[R_LV][j];
                const T bf2 = rv[R_BF2][j], cwat = rv[R_CWAT][j];
                const T anum = rv[R_H][j] - hp_i
                    + cpvmcpd * t_j * (qti_i - q_j);
                const T denom = h_i - hp_i
                    + cpdmcpv * (q_i - qti_i) * t_j;
                T sij = (i == j) ? T(1) : anum / fix01(denom);
                T altem = (sij * q_i + (T(1) - sij) * qti_i - qs_j) / bf2;
                const bool redo = ((sij < T(0)) || (sij > T(1))
                                   || (altem > cwat)) && (j > i);
                if (redo) {
                    const T anum2 = anum - lv_j * (qti_i - qs_j
                                                   - cwat * bf2);
                    const T denom2 = fix01(denom + lv_j * (q_i - qti_i));
                    sij = anum2 / denom2;
                    altem = sij * q_i + (T(1) - sij) * qti_i - qs_j
                        - (bf2 - T(1)) * cwat;
                }
                const bool jrange = (j >= icb_c) && (j <= ict_c);
                val[s] = (sij > T(0)) && (sij < T(0.9)) && jrange;
                U[s] = sij;
                V[s] = altem;
                Q[s] = jrange ? clampv(sij, T(0), T(1)) : T(0);
            }
            nent += __popc(__ballot_sync(FULL, val[s]));
        }
        const bool noent = nent == 0;
        const bool has_ent = nent > 0;

        // critical mixing fraction of row i (:790-797)
        T scrit;
        {
            const T anum_s = h_i - hp_i - lv_i * (qti_i - qs_i);
            const T denom_s = fix01(h_i - hp_i + lv_i * (q_i - qti_i));
            scrit = anum_s / denom_s;
            const T alt = qti_i - qs_i + scrit * (q_i - qti_i);
            if (alt < T(0)) scrit = T(1);
            scrit = dmax(scrit, T(0));
        }

        // sij_f at j+1 and j-1 (0 beyond the column)
        T qp[NS], qm[NS];
        const T q1first = NS == 2 ? __shfl_sync(FULL, Q[NS - 1], 0) : T(0);
        const T q0last = __shfl_sync(FULL, Q[0], 31);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            qp[s] = __shfl_down_sync(FULL, Q[s], 1);
            qm[s] = __shfl_up_sync(FULL, Q[s], 1);
        }
        if (lane == 31) {
            qp[0] = q1first;
            qp[NS - 1] = T(0);
        }
        if (lane == 0) {
            qm[0] = T(0);
            qm[NS - 1] = NS == 2 ? q0last : T(0);
        }

        // the running smin over accepted j > i pairs (:798-821): an
        // exclusive min-scan over j of the c_cond candidates
        T cand[NS], pre[NS];
        bool ccond[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int j = lane + 32 * s;
            ccond[s] = false;
            cand[s] = T(1);
            if (val[s] && j > i) {
                const T smid_gt = dmin(clampv(U[s], T(0), T(1)), scrit);
                ccond[s] = qp[s] < smid_gt;
                if (ccond[s]) cand[s] = smid_gt;
            }
            T x = cand[s];
            if (__any_sync(FULL, ccond[s])) {    // else 1 throughout
#pragma unroll
                for (int d = 1; d < 32; d <<= 1) {
                    const T y = __shfl_up_sync(FULL, x, d);
                    if (lane >= d) x = dmin(x, y);
                }
            }
            pre[s] = x;                      // inclusive, within slot s
        }
        {
            const T tot0 = __shfl_sync(FULL, pre[0], 31);
#pragma unroll
            for (int s = 0; s < NS; ++s) {
                T e = __shfl_up_sync(FULL, pre[s], 1);
                if (lane == 0) e = T(1);
                pre[s] = s == 1 ? dmin(e, tot0) : e;    // exclusive
            }
        }

        // equal-probability weights of the valid pairs
        T wgt[NS];
        T wsum = T(0);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int j = lane + 32 * s;
            wgt[s] = T(0);
            if (val[s]) {
                const T sij = clampv(U[s], T(0), T(1));
                T smid, sjmax, sjmin;
                if (j > i) {
                    const T smid_gt = dmin(sij, scrit);
                    const bool use_min = ccond[s] && (smid_gt < pre[s]);
                    smid = smid_gt;
                    sjmax = use_min ? dmin(dmin(qp[s], sij), scrit)
                                    : smid_gt;
                    sjmin = use_min ? dmin(dmax(qm[s], sij), scrit)
                                    : smid_gt;
                } else {
                    smid = dmax(sij, scrit);
                    sjmax = dmax(qp[s], scrit);
                    sjmin = dmax(qm[s], scrit);
                }
                const T delp = sjmax - smid, delm = sjmin - smid;
                wgt[s] = ((delp < T(0) ? -delp : delp)
                          + (delm < T(0) ? -delm : delm)) * rv[R_DPH][j];
            }
            wsum = wsum + wgt[s];
        }
        const T asij = dmax(warp_sum(wsum), T(1.0e-21));

        // normalised ment and its row sum (:822-829)
        T ment[NS];
        T msum = T(0);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int j = lane + 32 * s;
            ment[s] = T(0);
            if (val[s]) {
                const T ment0 = m_i / (T(1) - clampv(U[s], T(0),
                                                     T(0.899)));
                ment[s] = has_ent ? (ment0 * wgt[s]) / asij : ment0;
            } else if (j == i && noent) {
                ment[s] = m_i;
            }
            msum = msum + ment[s];
        }
        const T bsum = warp_sum(msum);
        // post-normalisation fallback (:830-847)
        const bool fb = has_ent && (bsum < T(1.0e-18));
        const bool diag_over = noent || fb;

        // entrained properties and the row's summands
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int j = lane + 32 * s;
            if (fb && j == i) ment[s] = m_i;
            if (j >= L || (s == 1 && !act1)) continue;
            const T q_j = rv[R_Q][j], u_j = rv[R_U][j], v_j = rv[R_V][j];
            T qent, uent, vent, elij;
            if (val[s]) {
                const T sij = U[s];
                qent = sij * q_i + (T(1) - sij) * qti_i;
                uent = sij * u_i + (T(1) - sij) * unk_c;
                vent = sij * v_i + (T(1) - sij) * vnk_c;
                elij = dmax(V[s], T(0));
            } else {
                qent = q_j;
                uent = u_j;
                vent = v_j;
                elij = T(0);
            }
            if (j == i && diag_over) {
                qent = qti_i;
                uent = unk_c;
                vent = vnk_c;
                elij = clw_i;
            }
            const T awat = dmax(elij - rv[R_CWAT][j], T(0));
            const T awat_k = (j > i) ? awat : T(0);
            wd[s] = wd[s] + awat_k * ment[s];
            sq[s] = sq[s] + ment[s] * (qent - awat_k - q_j);
            su[s] = su[s] + ment[s] * (uent - u_j);
            sv[s] = sv[s] + ment[s] * (vent - v_j);
            if (TRA) {
                // traent(i, j) = sij tra_i + (1 - sij) tra_nk on valid
                // pairs (sij before the clip), tra_nk on the diagonal
                // that detrains like the no-entrainment case
                const T w1 = val[s] ? ment[s] * U[s] : T(0);
                w2c[s] = w2c[s]
                    + ((val[s] ? ment[s] * (T(1) - U[s]) : T(0))
                       + ((j == i && diag_over) ? ment[s] : T(0)));
                mentc[s] = mentc[s] + ment[s];
                if (val[s]) {
                    const T* tr_i = tra + toff + (long long)i * ntr;
                    T* a = acc + lane + 32 * s;
                    for (int n = 0; n < ntr; ++n)
                        a[n * 32 * NS] = a[n * 32 * NS] + w1 * tr_i[n];
                }
            }
            if (j == i) {
                out[O_MENTII * pl + off + j] = ment[s];
                out[O_QENTII * pl + off + j] = qent;
            }
        }

        // suffix sums of the row, suf(j) = sum_{c >= j} ment(i, c)
        T suf[NS];
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            T x = ment[s];
#pragma unroll
            for (int d = 1; d < 32; d <<= 1) {
                const T y = __shfl_down_sync(FULL, x, d);
                if (lane + d < 32) x = x + y;
            }
            suf[s] = x;
        }
        if (NS == 2) suf[0] = suf[0] + __shfl_sync(FULL, suf[NS - 1], 0);
        const T s1first = NS == 2 ? __shfl_sync(FULL, suf[NS - 1], 0)
                                  : T(0);
#pragma unroll
        for (int s = 0; s < NS; ++s) {
            const int j = lane + 32 * s;
            T next = __shfl_down_sync(FULL, suf[s], 1);   // suf(j + 1)
            if (lane == 31) next = s + 1 < NS ? s1first : T(0);
            if (j < L) {
                if (i <= j) amp1[s] = amp1[s] + next;
                if (i < j) ad[s] = ad[s] + suf[s];
            }
        }
    }

#pragma unroll
    for (int s = 0; s < NS; ++s) {
        const int j = lane + 32 * s;
        if (j >= L) continue;
        out[O_WD * pl + off + j] = T(k.egrav) * wd[s];
        out[O_AMP1 * pl + off + j] = amp1[s];
        out[O_AD * pl + off + j] = ad[s];
        out[O_SUMQ * pl + off + j] = sq[s];
        out[O_SUMU * pl + off + j] = su[s];
        out[O_SUMV * pl + off + j] = sv[s];
        if (TRA) {
            // sum_tra(j) = sum_i w1 tra_i + w2c tra_nk - mentc tra_j
            const T* tr_j = tra + toff + (long long)j * ntr;
            const T* tr_k = trank + (long long)col * ntr;
            T* o = sum_tra + toff + (long long)j * ntr;
            for (int n = 0; n < ntr; ++n)
                o[n] = (acc[n * 32 * NS + lane + 32 * s] + w2c[s] * tr_k[n])
                    - mentc[s] * tr_j[n];
        }
    }
}

template <typename T, int NS, bool TRA>
int launch_ns(const void* const* lev, const void* unk, const void* vnk,
              const void* icb, const void* ict, const void* cloud,
              void* out, int ncol, int L, Consts k, const void* tra,
              const void* trank, void* sum_tra, int ntr, void* stream) {
    const int blocks = (ncol + WPB - 1) / WPB;
    const size_t smem = TRA ? (size_t)WPB * ntr * 32 * NS * sizeof(T) : 0;
    // the opt-in past 48 KB, once per instantiation and largest size
    static size_t opted = DEFAULT_SMEM;
    if (smem > opted) {
        const cudaError_t e = cudaFuncSetAttribute(
            emanuel_mixing_kernel<T, NS, TRA>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
        opted = smem;
    }
    emanuel_mixing_kernel<T, NS, TRA><<<blocks, WPB * 32, smem,
                                        (cudaStream_t)stream>>>(
        (const T*)lev[0], (const T*)lev[1], (const T*)lev[2],
        (const T*)lev[3], (const T*)lev[4], (const T*)lev[5],
        (const T*)lev[6], (const T*)lev[7], (const T*)lev[8],
        (const T*)lev[9], (const T*)lev[10], (const T*)lev[11],
        (const T*)lev[12], (const T*)unk, (const T*)vnk,
        (const int*)icb, (const int*)ict, (const unsigned char*)cloud,
        (T*)out, ncol, L, k, (const T*)tra, (const T*)trank, (T*)sum_tra,
        ntr);
    return (int)cudaGetLastError();
}

template <typename T, bool TRA>
int launch_l(const void* const* lev, const void* unk, const void* vnk,
             const void* icb, const void* ict, const void* cloud, void* out,
             int ncol, int L, Consts k, const void* tra, const void* trank,
             void* sum_tra, int ntr, void* stream) {
    return L > 32
        ? launch_ns<T, 2, TRA>(lev, unk, vnk, icb, ict, cloud, out, ncol, L,
                               k, tra, trank, sum_tra, ntr, stream)
        : launch_ns<T, 1, TRA>(lev, unk, vnk, icb, ict, cloud, out, ncol, L,
                               k, tra, trank, sum_tra, ntr, stream);
}

template <typename T>
int launch(const void* const* lev, const void* unk, const void* vnk,
           const void* icb, const void* ict, const void* cloud, void* out,
           int ncol, int L, Consts k, const void* tra, const void* trank,
           void* sum_tra, int ntr, void* stream) {
    if (ncol == 0) return 0;
    if (L < 1 || L > 64 || ntr < 0 || ntr > MAX_TRA)
        return (int)cudaErrorInvalidValue;
    return ntr > 0
        ? launch_l<T, true>(lev, unk, vnk, icb, ict, cloud, out, ncol, L, k,
                            tra, trank, sum_tra, ntr, stream)
        : launch_l<T, false>(lev, unk, vnk, icb, ict, cloud, out, ncol, L, k,
                             tra, trank, sum_tra, ntr, stream);
}

}  // namespace

#define EM_ARGS                                                           \
    const void *h, const void *hp, const void *q, const void *qs,        \
        const void *t, const void *lv, const void *qti, const void *clw, \
        const void *ep, const void *m, const void *u, const void *v,     \
        const void *dph, const void *unk, const void *vnk,               \
        const void *icb, const void *ict, const void *cloud, void *out,  \
        int ncol, int L, void *stream, double rwat, double cpd,          \
        double cpv, double egrav

extern "C" {
int emanuel_mixing_f32(EM_ARGS) {
    const void* lev[13] = {h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph};
    return launch<float>(lev, unk, vnk, icb, ict, cloud, out, ncol, L,
                         Consts{rwat, cpd, cpv, egrav}, nullptr, nullptr,
                         nullptr, 0, stream);
}
int emanuel_mixing_f64(EM_ARGS) {
    const void* lev[13] = {h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph};
    return launch<double>(lev, unk, vnk, icb, ict, cloud, out, ncol, L,
                          Consts{rwat, cpd, cpv, egrav}, nullptr, nullptr,
                          nullptr, 0, stream);
}
// the tracer form: tra (ncol, L, ntr) and trank (ncol, ntr) in, sum_tra
// (ncol, L, ntr) out beside the eight terms; 1 <= ntr <= MAX_TRA
int emanuel_mixing_tra_f32(EM_ARGS, const void* tra, const void* trank,
                           void* sum_tra, int ntr) {
    const void* lev[13] = {h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph};
    if (ntr < 1) return (int)cudaErrorInvalidValue;
    return launch<float>(lev, unk, vnk, icb, ict, cloud, out, ncol, L,
                         Consts{rwat, cpd, cpv, egrav}, tra, trank, sum_tra,
                         ntr, stream);
}
int emanuel_mixing_tra_f64(EM_ARGS, const void* tra, const void* trank,
                           void* sum_tra, int ntr) {
    const void* lev[13] = {h, hp, q, qs, t, lv, qti, clw, ep, m, u, v, dph};
    if (ntr < 1) return (int)cudaErrorInvalidValue;
    return launch<double>(lev, unk, vnk, icb, ict, cloud, out, ncol, L,
                          Consts{rwat, cpd, cpv, egrav}, tra, trank, sum_tra,
                          ntr, stream);
}
}

// Fused WAF advection of a stack of fields (wafone,
// mod_moloch.F90:1098-1361): a vertical, then a meridional, then a zonal
// sweep, each with the superbee flux limiter, for every field f and
// level k of pp (nf, kz, ly, lx):
//
//   wz  = vertical sweep of pp[f]         (zwf at interfaces 1..kz-1)
//   wz  rows 0 <- 1, iy-2 and iy-1 <- iy-3 (domain-edge override)
//   p0  = wz + mx2·(meridional flux divergence of wz)
//   p0  cols 0 <- 1, jx-2 and jx-1 <- jx-3
//   out = m_ci > 0.5 ? p0 + mx2·(zonal flux divergence of p0) : pp
//
// Fields and winds read 0 outside the domain (``shift``); the metric
// fmz reads its edge value (``shifte``). um = u·rmu and vm = v·rmv are
// the map-scaled face winds, s the generalized vertical velocity at the
// kz+1 interfaces, fmz/fmzf the vertical metric at centres/interfaces.
//
// One source, two forms. Unsharded (K4): the inputs are the whole
// (iy, jx) domain, hh = 0. Halo form (K5a, one rank of a decomposed
// domain): the inputs are the rank's (ly, lx) block at global offset
// (y0, x0) extended by hh = 2 rows and columns on each side, filled
// from the neighbouring blocks (zeros beyond the domain for the fields,
// winds, s, mx2 and m_ci; edge values for fmz and fmzf); the output is
// the (ly, lx) block. Every domain test (the edge overrides, the zero
// fill, fmz's clamp) is made on global rows and columns, so both forms
// do the same arithmetic on the same values and agree bit for bit.
//
// Replaces the TPU kernels regcm_tpu/dynamics/pallas_kernels.py
// waf_advect and waf_advect_sharded -> _waf_call -> _waf_kernel
// (+ _limiter): one y-slab of full x rows per grid step, padded to 8x128
// tiles, the fields DMA'd into VMEM one after the other, the global
// offsets of the block in SMEM (off_ref).
//
// Bound: memory. Each call reads pp and writes out (nf·kz·ly·lx values
// each), reads um, vm, fmz (kz planes), s, fmzf (kz+1 planes) and mx2,
// m_ci (one plane): at nf=7, 192x192x41 in f32 about 115 MB, ~34 us at
// 3.35 TB/s, against ~1 GFLOP (~16 us at 67 TFLOP/s f32). On the card a
// kernel of this kind is held far above that bound by instructions and
// latency: four limiters and ten IEEE divisions a point, each a long
// dependent chain, and the field-independent terms that a kernel per
// field repeats for every field. Timed variants of four earlier designs
// (one block per level, a block marching down k with a shared-memory
// tile, the same with a group of fields, one warp marching in y) put
// them at 0.36-0.54 ms at that shape on an NVIDIA H100 80GB HBM3 at
// 700 W; this design takes ~0.20 ms there.
//
// Two kernels, launched one after the other on the caller's stream:
//   vertical: one thread per (column of the input window, group of up to
//     GV fields, chunk of levels) marches down the levels with each
//     field's pp at k-1..k+2 and the group's s and fmzf at k, k+1 and fmz
//     at k in registers, fetching level k+1's values while level k is
//     computed. It carries each field's flux through interface k+1 into
//     level k+1 as that level's upper face, and computes the metric
//     ratios and the zdv factor once a level for the group: each pp
//     value is read once and each vertical flux computed once, with no
//     halo recomputation. It writes wz (the y-edge override applied: a
//     domain-edge row takes its source row's column) over the input
//     window to a scratch tensor shaped like pp. The levels are cut into
//     chunks when the columns alone would leave the card short of warps;
//     a chunk starts by computing its upper interface's flux from the
//     same values.
//   horizontal: one warp per (28-column strip, YS rows, level, group of
//     up to G fields). Its 32 lanes are the strip's columns and a 2-wide
//     x-halo on each side; the warp marches down the rows with wz at
//     rows r-1..r+2 and the meridional face flux through the top of row
//     r in registers, so each meridional face flux is computed once and
//     carried to the next row, and it fetches row r+1's values while row
//     r is computed. The terms that do not depend on the field (the
//     metric ratios rfmn, rfms, rfme, rfmw: four of the ten divisions;
//     the face winds; the zdv factors; mx2; the mask) are computed once a
//     row for the warp's fields. The zonal stencil and the x-edge
//     override (a domain-edge column takes its source column's p0) are
//     warp shuffles, and each zonal face flux is computed once, by the
//     lane east of it, and shuffled to its west neighbour. No shared
//     memory, no block barrier: every warp runs on its own.
// The round trip of wz through device memory (one write and one read of
// pp's size, ~84 MB at the flagship shape in f32) is the price of
// computing every vertical flux once with no halo.
// Built with -fmad=false: the upwind choices (amu >= 0, amu > 0) and the
// limiter's |den| < 1e-15 guard are thresholds, and an FMA contraction
// the plain version does not make could flip them. Every expression
// keeps the plain version's order (a factor shared by several fields
// or points is the same subexpression, computed once), so the kernel is
// bit-identical to the plain version.
#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int VT = 256;         // vertical kernel: threads a block
constexpr int GV = 4;           // vertical: fields a thread, at most
constexpr int H2 = 2;           // horizontal: x-halo lanes a side
constexpr int XO = 32 - 2 * H2; // horizontal: output columns a warp
constexpr int YS = 8;           // horizontal: rows a warp marches
constexpr int G = 2;            // horizontal: fields a warp, at most
constexpr int HW = 4;           // horizontal: warps a block

// superbee WAF weight (wafone limiter, :1120-1135); sign(0) -> 1
template <typename T>
__device__ __forceinline__ T limiter(T amu, T f_up2, T f_up1, T f_c,
                                     T f_d) {
    T is = amu < T(0) ? T(-1) : T(1);
    T den = f_c - f_d;
    T sden = den > T(0) ? T(1) : (den < T(0) ? T(-1) : T(0));
    T dd = fabs(den) < T(1e-15) ? sden * T(1e-15) + T(1e-30) : den;
    T r = (f_up1 - f_up2) / dd;
    T b = fmax(r, fmin(T(2) * r, T(1)));
    b = fmin(fmax(b, T(0)), T(2));
    return is + amu * b - is * b;
}

// vertical flux at an interior interface K, from s there and pp at
// K-2 (clamped), K-1, K and K+1 (clamped)
template <typename T>
__device__ __forceinline__ T zwf(T sK, T above2, T above, T below,
                                 T below2, T dtrdz) {
    T amu = sK * dtrdz;
    bool pos = amu >= T(0);
    T f1 = pos ? below : above2;
    T f2 = pos ? below2 : above;
    T zphi = limiter(amu, f2, f1, above, below);
    return T(0.5) * sK * ((T(1) + zphi) * below + (T(1) - zphi) * above);
}

// horizontal face flux from the upwind pair (m2, m1 | c, p1)
template <typename T>
__device__ __forceinline__ T face_flux(T wind, T m2, T m1, T c, T p1,
                                       T dtrdx) {
    T amu = wind * dtrdx;
    bool pos = amu > T(0);
    T f1 = pos ? m1 : p1;
    T f2 = pos ? m2 : c;
    T zphi = limiter(amu, f2, f1, c, m1);
    return T(0.5) * wind * ((T(1) + zphi) * m1 + (T(1) - zphi) * c);
}

// the domain's shape and this block's place in it
struct Geo {
    int ly, lx;      // output block
    int hh;          // halo width of the inputs (0 or 2)
    int iy, jx;      // global domain
    int y0, x0;      // global offset of the block
};

// offset of the block's local point (r, c), -hh <= r < ly + hh, in an
// input plane
__device__ __forceinline__ int at(const Geo& g, int r, int c) {
    return (r + g.hh) * (g.lx + 2 * g.hh) + (c + g.hh);
}

// the row or column whose value a domain-edge row or column takes
__device__ __forceinline__ int edge_src(int gi, int n) {
    return gi == 0 ? 1 : (gi >= n - 2 ? n - 3 : gi);
}

// wz over the input window: thread = (window point, group of up to GV
// fields, chunk of levels)
template <typename T>
__global__ void __launch_bounds__(VT)
waf_vertical(const T* __restrict__ pp, const T* __restrict__ s,
             const T* __restrict__ fmz, const T* __restrict__ fmzf,
             T* __restrict__ wzs, int nf, int kz, int nchunk, int kchunk,
             Geo g, T dtrdz) {
    const int wx = g.lx + 2 * g.hh;
    const int plane = (g.ly + 2 * g.hh) * wx;
    const int ngv = (nf + GV - 1) / GV;
    const long long id = (long long)blockIdx.x * VT + threadIdx.x;
    if (id >= (long long)ngv * nchunk * plane) return;
    const int e = (int)(id % plane);
    const int gc = (int)(id / plane);
    const int grp = gc % ngv;
    const int k0 = gc / ngv * kchunk;
    const int k1 = min(k0 + kchunk, kz);
    const int f0 = grp * GV, nv = min(GV, nf - f0);
    const long long fstride = (long long)kz * plane;
    const int lr = e / wx - g.hh, lc = e % wx - g.hh;
    const int gy = g.y0 + lr, gx = g.x0 + lc;
    T* dst = wzs + ((long long)f0 * kz + k0) * plane + e;
    if (gy < 0 || gy >= g.iy || gx < 0 || gx >= g.jx) {
        for (int j = 0; j < nv; ++j)
            for (int k = k0; k < k1; ++k)
                dst[j * fstride + (long long)(k - k0) * plane] = T(0);
        return;
    }
    const int q = at(g, edge_src(gy, g.iy) - g.y0, lc);
    const T* col = pp + (long long)f0 * fstride + q;
    auto lev = [plane](int k) { return (long long)k * plane; };
    const T* sk = s + lev(k0) + q;           // s, fmzf at k; fmz at k
    const T* fk = fmzf + lev(k0) + q;
    const T* zk = fmz + lev(k0) + q;
    T sup = sk[0], sdn = sk[plane], fa = fk[0], fb = fk[plane], fz = zk[0];
    // each field's pp at max(k-1,0), k, min(k+1,kz-1), min(k+2,kz-1) and
    // its flux through interface k (the upper face of level k)
    T a[GV], b[GV], c[GV], d[GV], zup[GV];
#pragma unroll
    for (int j = 0; j < GV; ++j) {
        a[j] = b[j] = c[j] = d[j] = zup[j] = T(0);
        if (j >= nv) continue;
        const T* cj = col + j * fstride;
        a[j] = cj[lev(max(k0 - 1, 0))];
        b[j] = cj[lev(k0)];
        c[j] = cj[lev(min(k0 + 1, kz - 1))];
        d[j] = cj[lev(min(k0 + 2, kz - 1))];
        if (k0 > 0)
            zup[j] = zwf(sup, cj[lev(max(k0 - 2, 0))], a[j], b[j], c[j],
                         dtrdz);
    }
    const T* pn = col + lev(min(k0 + 3, kz - 1));   // the next pp fetched
    for (int k = k0; k < k1; ++k) {
        sk += plane; fk += plane; zk += plane;
        T nd[GV], ns = T(0), nfb = T(0), nfz = T(0);
        const bool more = k + 1 < k1;
        if (more) {                           // level k+1's new values
            ns = sk[plane];
            nfb = fk[plane];
            nfz = zk[0];
        }
#pragma unroll
        for (int j = 0; j < GV; ++j)
            nd[j] = more && j < nv ? pn[j * fstride] : T(0);
        if (k + 4 < kz) pn += plane;
        // the level's field-independent terms, once for the group
        const T rfm_m = dtrdz * fz / fb;
        const T rfm_p = k == 0 ? T(0)
            : dtrdz * fz / (fa == T(0) ? T(1) : fa);
        const T cz = sup * rfm_p - sdn * rfm_m;   // zdv = cz·pp
#pragma unroll
        for (int j = 0; j < GV; ++j) {
            if (j >= nv) break;
            const T zdn = k + 1 < kz ? zwf(sdn, a[j], b[j], c[j], d[j], dtrdz)
                                     : T(0);
            dst[j * fstride] = b[j] - zup[j] * rfm_p + zdn * rfm_m
                + cz * b[j];
            a[j] = b[j]; b[j] = c[j]; c[j] = d[j]; d[j] = nd[j];
            zup[j] = zdn;
        }
        dst += plane;
        sup = sdn; sdn = ns;
        fa = fb; fb = nfb;
        fz = nfz;
    }
}

// the meridional and zonal sweeps: warp = (strip, rows, level, fields)
template <typename T>
__global__ void __launch_bounds__(HW * 32)
waf_horizontal(const T* __restrict__ pp, const T* __restrict__ wzs,
               const T* __restrict__ um, const T* __restrict__ vm,
               const T* __restrict__ fmz, const T* __restrict__ mx2,
               const T* __restrict__ mci, T* __restrict__ out, int nf,
               int kz, int nsx, int nsy, Geo g, T dtrdx, T dtrdx2) {
    const int lane = threadIdx.x & 31;
    const int ngrp = (nf + G - 1) / G;
    const int item = blockIdx.x * HW + (threadIdx.x >> 5);
    if (item >= kz * nsy * nsx * ngrp) return;             // whole warp
    const int grp = item % ngrp;
    const int rest = item / ngrp;
    const int sx = rest % nsx;
    const int sy = rest / nsx % nsy;
    const int k = rest / (nsx * nsy);
    const int f0 = grp * G, ng = min(G, nf - f0);
    const int xs = sx * XO, ys = sy * YS, ye = min(ys + YS, g.ly);
    const int lc = xs - H2 + lane;
    const int gx = g.x0 + lc;
    const bool colok = gx >= 0 && gx < g.jx && lc >= -g.hh
        && lc < g.lx + g.hh;
    const int src = colok ? edge_src(gx, g.jx) - g.x0 - (xs - H2) : lane;
    const int cxl = min(max(gx, 0), g.jx - 1) - g.x0;
    const bool xface = lc >= 0 && lc <= g.lx && gx < g.jx;
    const bool xout = lane >= H2 && lane < H2 + XO && lc < g.lx;
    const long long plane =
        (long long)(g.ly + 2 * g.hh) * (g.lx + 2 * g.hh);
    const long long ko = (long long)k * plane;
    const long long fstride = (long long)kz * plane;
    const T* ppk = pp + (long long)f0 * fstride + ko;
    const T* wzk = wzs + (long long)f0 * fstride + ko;
    const long long ostride = (long long)kz * g.ly * g.lx;
    T* outk = out + (long long)f0 * ostride + (long long)k * g.ly * g.lx;
    auto clampy = [&](int lr) {
        return min(max(g.y0 + lr, 0), g.iy - 1) - g.y0;
    };
    auto load_wz = [&](int lr, T* w) {
        const int gy = g.y0 + lr;
        const bool ok = colok && gy >= 0 && gy < g.iy && lr >= -g.hh
            && lr < g.ly + g.hh;
        const int q = ok ? at(g, lr, lc) : 0;
#pragma unroll
        for (int j = 0; j < G; ++j)
            w[j] = ok && j < ng ? wzk[j * fstride + q] : T(0);
    };
    T w_m1[G], w_0[G], w_p1[G], w_p2[G], fq[G];
    T vq, fzs, fzc;
    {
        T w_m2[G];
        load_wz(ys - 2, w_m2);
        load_wz(ys - 1, w_m1);
        load_wz(ys, w_0);
        load_wz(ys + 1, w_p1);
        const bool ok = g.y0 + ys < g.iy && colok;
        vq = ok ? vm[ko + at(g, ys, lc)] : T(0);
#pragma unroll
        for (int j = 0; j < G; ++j)
            fq[j] = ok ? face_flux(vq, w_m2[j], w_m1[j], w_0[j], w_p1[j],
                                   dtrdx) : T(0);
        fzs = fmz[ko + at(g, clampy(ys - 1), cxl)];
        fzc = fmz[ko + at(g, clampy(ys), cxl)];
    }
    // row lr's loads are fetched while row lr-1 is computed
    T n_w[G], n_pq[G], n_vn, n_fzn, n_mq, n_u;
    bool n_msk;
    auto fetch = [&](int lr) {
        const int gy = g.y0 + lr;
        load_wz(lr + 2, n_w);
        const int qc = at(g, lr, lc);
        n_vn = gy + 1 < g.iy && colok ? vm[ko + at(g, lr + 1, lc)] : T(0);
        n_fzn = fmz[ko + at(g, clampy(lr + 1), cxl)];
        n_mq = colok ? mx2[qc] : T(0);
        n_msk = colok && mci[qc] > T(0.5);
        n_u = xface ? um[ko + qc] : T(0);
#pragma unroll
        for (int j = 0; j < G; ++j)
            n_pq[j] = colok && j < ng ? ppk[j * fstride + qc] : T(0);
    };
    fetch(ys);
    for (int lr = ys; lr < ye; ++lr) {
        const int gy = g.y0 + lr;
        T pqs[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
            w_p2[j] = n_w[j];
            pqs[j] = n_pq[j];
        }
        const T vn = n_vn, fzn = n_fzn, mq = n_mq, u = n_u;
        const bool msk = n_msk;
        if (lr + 1 < ye) fetch(lr + 1);
        const bool okn = gy + 1 < g.iy && colok;
        const int qc = at(g, lr, lc);
        T rfmn = T(0), rfms = T(0), cy = T(0);
        if (colok) {
            rfmn = dtrdx2 * fzc / (fzc + fzn);
            rfms = dtrdx2 * fzc / (fzc + fzs);
            cy = vn * rfmn - vq * rfms;
        }
        const T ue = __shfl_down_sync(FULL, u, 1);
        const T fze = __shfl_down_sync(FULL, fzc, 1);
        const T fzw = __shfl_up_sync(FULL, fzc, 1);
        T rfme = T(0), rfmw = T(0), cx = T(0);
        if (xout) {
            rfme = dtrdx2 * fzc / (fzc + fze);
            rfmw = dtrdx2 * fzc / (fzc + fzw);
            cx = ue * rfme - u * rfmw;
        }
#pragma unroll
        for (int j = 0; j < G; ++j) {
            if (j >= ng) break;
            const T fn = okn ? face_flux(vn, w_m1[j], w_0[j], w_p1[j],
                                         w_p2[j], dtrdx) : T(0);
            const T pq = pqs[j];
            T p0 = colok ? w_0[j] + mq * (fq[j] * rfms - fn * rfmn
                                          + cy * pq) : T(0);
            p0 = __shfl_sync(FULL, p0, src);
            if (!colok) p0 = T(0);
            const T pm2 = __shfl_up_sync(FULL, p0, 2);
            const T pm1 = __shfl_up_sync(FULL, p0, 1);
            const T pp1 = __shfl_down_sync(FULL, p0, 1);
            const T fx = xface ? face_flux(u, pm2, pm1, p0, pp1, dtrdx)
                               : T(0);
            const T fxe = __shfl_down_sync(FULL, fx, 1);
            if (xout) {
                const T o = p0 + mq * (fx * rfmw - fxe * rfme + cx * pq);
                outk[j * ostride + (long long)lr * g.lx + lc] =
                    msk ? o : pq;
            }
            w_m1[j] = w_0[j]; w_0[j] = w_p1[j]; w_p1[j] = w_p2[j];
            fq[j] = fn;
        }
        vq = vn;
        fzs = fzc; fzc = fzn;
    }
}

template <typename T>
int launch(const void* pp, const void* um, const void* vm, const void* s,
           const void* fmz, const void* fmzf, const void* mx2,
           const void* mci, void* out, void* wzs, int nf, int kz, int ly,
           int lx, int hh, int iy, int jx, int y0, int x0, double dtrdx,
           double dtrdz, void* stream) {
    if (nf == 0 || kz == 0) return 0;
    const long long plane = (long long)(ly + 2 * hh) * (lx + 2 * hh);
    if (plane > 2147483647LL) return (int)cudaErrorInvalidValue;
    int dev = 0, nsm = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(&nsm, cudaDevAttrMultiProcessorCount,
                                     dev);
    if (err != cudaSuccess) return (int)err;
    Geo g{ly, lx, hh, iy, jx, y0, x0};
    cudaStream_t st = (cudaStream_t)stream;
    // vertical: enough threads to fill the card (2048 an SM), in chunks
    // of at least 8 levels
    const long long cols = (long long)((nf + GV - 1) / GV) * plane;
    int nchunk = (int)min((long long)max(1, kz / 8),
                          (2048LL * nsm + cols - 1) / cols);
    nchunk = max(nchunk, 1);
    const int kchunk = (kz + nchunk - 1) / nchunk;
    nchunk = (kz + kchunk - 1) / kchunk;
    const long long vthreads = cols * nchunk;
    waf_vertical<T><<<(unsigned)((vthreads + VT - 1) / VT), VT, 0, st>>>(
        (const T*)pp, (const T*)s, (const T*)fmz, (const T*)fmzf, (T*)wzs,
        nf, kz, nchunk, kchunk, g, T(dtrdz));
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const int nsx = (lx + XO - 1) / XO, nsy = (ly + YS - 1) / YS;
    const long long warps = (long long)kz * nsy * nsx * ((nf + G - 1) / G);
    if (warps + HW > 2147483647LL) return (int)cudaErrorInvalidValue;
    waf_horizontal<T><<<(unsigned)((warps + HW - 1) / HW), HW * 32, 0,
                        st>>>(
        (const T*)pp, (const T*)wzs, (const T*)um, (const T*)vm,
        (const T*)fmz, (const T*)mx2, (const T*)mci, (T*)out, nf, kz, nsx,
        nsy, g, T(dtrdx), T(dtrdx * 2.0));
    return (int)cudaGetLastError();
}

}  // namespace

// unsharded: (ly, lx) = (iy, jx), hh = y0 = x0 = 0; halo form: hh = 2.
// wzs: scratch shaped like pp
extern "C" {
int waf_advect_f32(const void* pp, const void* um, const void* vm,
                   const void* s, const void* fmz, const void* fmzf,
                   const void* mx2, const void* mci, void* out, void* wzs,
                   int nf, int kz, int ly, int lx, int hh, int iy, int jx,
                   int y0, int x0, double dtrdx, double dtrdz,
                   void* stream) {
    return launch<float>(pp, um, vm, s, fmz, fmzf, mx2, mci, out, wzs, nf,
                         kz, ly, lx, hh, iy, jx, y0, x0, dtrdx, dtrdz,
                         stream);
}
int waf_advect_f64(const void* pp, const void* um, const void* vm,
                   const void* s, const void* fmz, const void* fmzf,
                   const void* mx2, const void* mci, void* out, void* wzs,
                   int nf, int kz, int ly, int lx, int hh, int iy, int jx,
                   int y0, int x0, double dtrdx, double dtrdz,
                   void* stream) {
    return launch<double>(pp, um, vm, s, fmz, fmzf, mx2, mci, out, wzs, nf,
                          kz, ly, lx, hh, iy, jx, y0, x0, dtrdx, dtrdz,
                          stream);
}
}

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
// 3.35 TB/s, against ~1 GFLOP (~16 us at 67 TFLOP/s f32).
// Layout: one block per (field, level, 8-row x 32-column tile).
// Threads of a warp take neighbouring x, so global loads coalesce.
// Phase 1 computes the vertical-sweep value wz on the tile plus a halo
// of 2 in y and x into shared memory (the y-edge override is applied by
// evaluating the overriding row); phase 2 the meridional result p0 on
// the tile rows plus the x-halo (x-edge override likewise); phase 3 the
// zonal result and the mask. The levels k-2..k+2 that the vertical
// sweep needs are re-read by the neighbouring level blocks from L2; the
// halo recomputation costs (12·36)/(8·32) = 1.7 wz evaluations a point.
// Built with -fmad=false: the upwind choices (amu >= 0, amu > 0) and the
// limiter's |den| < 1e-15 guard are thresholds, and an FMA contraction
// the plain version does not make could flip them.
#include <cuda_runtime.h>

namespace {

constexpr int TX = 32;
constexpr int TY = 8;
constexpr int H = 2;
constexpr int WX = TX + 2 * H;
constexpr int WY = TY + 2 * H;

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

// vertical flux at interface K of the column at plane offset q
template <typename T>
__device__ __forceinline__ T zwf_at(const T* __restrict__ pp,
                                    const T* __restrict__ s, int K,
                                    int kz, long long q, long long plane,
                                    T dtrdz) {
    if (K <= 0 || K >= kz) return T(0);
    T sK = s[K * plane + q];
    T amu = sK * dtrdz;
    T above = pp[(K - 1) * plane + q];
    T below = pp[K * plane + q];
    T below2 = pp[min(K + 1, kz - 1) * plane + q];
    T above2 = pp[max(K - 2, 0) * plane + q];
    bool pos = amu >= T(0);
    T f1 = pos ? below : above2;
    T f2 = pos ? below2 : above;
    T zphi = limiter(amu, f2, f1, above, below);
    return T(0.5) * sK * ((T(1) + zphi) * below + (T(1) - zphi) * above);
}

// vertical-sweep value of level k at plane offset q
template <typename T>
__device__ __forceinline__ T wz_at(const T* __restrict__ pp,
                                   const T* __restrict__ s,
                                   const T* __restrict__ fmz,
                                   const T* __restrict__ fmzf, int k,
                                   int kz, long long q, long long plane,
                                   T dtrdz) {
    T fz = fmz[k * plane + q];
    T rfm_m = dtrdz * fz / fmzf[(k + 1) * plane + q];
    T fa = fmzf[k * plane + q];
    T rfm_p = k == 0 ? T(0) : dtrdz * fz / (fa == T(0) ? T(1) : fa);
    T p = pp[k * plane + q];
    T zdv = (s[k * plane + q] * rfm_p - s[(k + 1) * plane + q] * rfm_m) * p;
    return p - zwf_at(pp, s, k, kz, q, plane, dtrdz) * rfm_p
        + zwf_at(pp, s, k + 1, kz, q, plane, dtrdz) * rfm_m + zdv;
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
__device__ __forceinline__ long long at(const Geo& g, int r, int c) {
    return (long long)(r + g.hh) * (g.lx + 2 * g.hh) + (c + g.hh);
}

template <typename T>
__global__ void __launch_bounds__(TX * TY)
waf_kernel(const T* __restrict__ pp, const T* __restrict__ um,
           const T* __restrict__ vm, const T* __restrict__ s,
           const T* __restrict__ fmz, const T* __restrict__ fmzf,
           const T* __restrict__ mx2, const T* __restrict__ mci,
           T* __restrict__ out, int kz, Geo g, T dtrdx, T dtrdx2,
           T dtrdz) {
    __shared__ T wz_s[WY][WX];
    __shared__ T p0_s[TY][WX];
    const long long plane =
        (long long)(g.ly + 2 * g.hh) * (g.lx + 2 * g.hh);
    const int fk = blockIdx.z;                 // f·kz + k
    const int k = fk % kz;
    const T* ppf = pp + (long long)(fk - k) * plane;   // field f
    const int tx0 = blockIdx.x * TX;           // tile origin, local
    const int ty0 = blockIdx.y * TY;
    const int tid = threadIdx.y * TX + threadIdx.x;
    const long long ko = (long long)k * plane;

    // -- phase 1: vertical sweep on the tile + 2-wide halo
    for (int e = tid; e < WY * WX; e += TX * TY) {
        int r = e / WX, cc = e - r * WX;
        int lr = ty0 - H + r, lc = tx0 - H + cc;
        int gy = g.y0 + lr, gx = g.x0 + lc;
        T val = T(0);
        if (gy >= 0 && gy < g.iy && gx >= 0 && gx < g.jx && lr >= -g.hh
            && lr < g.ly + g.hh && lc >= -g.hh && lc < g.lx + g.hh) {
            int ry = gy == 0 ? 1 : (gy >= g.iy - 2 ? g.iy - 3 : gy);
            val = wz_at(ppf, s, fmz, fmzf, k, kz, at(g, ry - g.y0, lc),
                        plane, dtrdz);
        }
        wz_s[r][cc] = val;
    }
    __syncthreads();

    // -- phase 2: meridional sweep on the tile rows + x-halo
    for (int e = tid; e < TY * WX; e += TX * TY) {
        int r = e / WX, cc = e - r * WX;
        int lr = ty0 + r, lc = tx0 - H + cc;
        int gy = g.y0 + lr, gx = g.x0 + lc;
        T val = T(0);
        if (lr < g.ly && gx >= 0 && gx < g.jx && lc >= -g.hh
            && lc < g.lx + g.hh) {
            int rx = (gx == 0 ? 1 : (gx >= g.jx - 2 ? g.jx - 3 : gx))
                - g.x0;
            int cr = rx - (tx0 - H);
            int wr = r + H;
            T wm2 = wz_s[wr - 2][cr], wm1 = wz_s[wr - 1][cr];
            T w0 = wz_s[wr][cr], wp1 = wz_s[wr + 1][cr];
            T wp2 = wz_s[wr + 2][cr];
            long long q = at(g, lr, rx);
            T vmq = vm[ko + q];
            T zpby = face_flux(vmq, wm2, wm1, w0, wp1, dtrdx);
            T vmn = T(0), zpbn = T(0);
            if (gy + 1 < g.iy) {
                vmn = vm[ko + at(g, lr + 1, rx)];
                zpbn = face_flux(vmn, wm1, w0, wp1, wp2, dtrdx);
            }
            T fz = fmz[ko + q];
            T fzn = fmz[ko + at(g, min(gy + 1, g.iy - 1) - g.y0, rx)];
            T fzs = fmz[ko + at(g, max(gy - 1, 0) - g.y0, rx)];
            T rfmn = dtrdx2 * fz / (fz + fzn);
            T rfms = dtrdx2 * fz / (fz + fzs);
            T zdv = (vmn * rfmn - vmq * rfms) * ppf[ko + q];
            val = w0 + mx2[q] * (zpby * rfms - zpbn * rfmn + zdv);
        }
        p0_s[r][cc] = val;
    }
    __syncthreads();

    // -- phase 3: zonal sweep, mask, store
    const int lr = ty0 + threadIdx.y;
    const int lc = tx0 + threadIdx.x;
    if (lr >= g.ly || lc >= g.lx) return;
    const int gx = g.x0 + lc;
    const int c = threadIdx.x + H;
    const int r = threadIdx.y;
    T pm2 = p0_s[r][c - 2], pm1 = p0_s[r][c - 1], pc = p0_s[r][c];
    T pp1 = p0_s[r][c + 1], pp2 = p0_s[r][c + 2];
    long long q = at(g, lr, lc);
    T pq = ppf[ko + q];
    T umq = um[ko + q];
    T zpbw = face_flux(umq, pm2, pm1, pc, pp1, dtrdx);
    T ume = T(0), zpbe = T(0);
    if (gx + 1 < g.jx) {
        ume = um[ko + q + 1];
        zpbe = face_flux(ume, pm1, pc, pp1, pp2, dtrdx);
    }
    T fz = fmz[ko + q];
    T fze = fmz[ko + at(g, lr, min(gx + 1, g.jx - 1) - g.x0)];
    T fzw = fmz[ko + at(g, lr, max(gx - 1, 0) - g.x0)];
    T rfme = dtrdx2 * fz / (fz + fze);
    T rfmw = dtrdx2 * fz / (fz + fzw);
    T zdv = (ume * rfme - umq * rfmw) * pq;
    T o = pc + mx2[q] * (zpbw * rfmw - zpbe * rfme + zdv);
    out[(long long)fk * g.ly * g.lx + (long long)lr * g.lx + lc] =
        mci[q] > T(0.5) ? o : pq;
}

template <typename T>
int launch(const void* pp, const void* um, const void* vm, const void* s,
           const void* fmz, const void* fmzf, const void* mx2,
           const void* mci, void* out, int nf, int kz, int ly, int lx,
           int hh, int iy, int jx, int y0, int x0, double dtrdx,
           double dtrdz, void* stream) {
    if (nf == 0 || kz == 0) return 0;
    Geo g{ly, lx, hh, iy, jx, y0, x0};
    dim3 block(TX, TY);
    dim3 grid((lx + TX - 1) / TX, (ly + TY - 1) / TY, nf * kz);
    waf_kernel<T><<<grid, block, 0, (cudaStream_t)stream>>>(
        (const T*)pp, (const T*)um, (const T*)vm, (const T*)s,
        (const T*)fmz, (const T*)fmzf, (const T*)mx2, (const T*)mci,
        (T*)out, kz, g, T(dtrdx), T(dtrdx * 2.0), T(dtrdz));
    return (int)cudaGetLastError();
}

}  // namespace

// unsharded: (ly, lx) = (iy, jx), hh = y0 = x0 = 0; halo form: hh = 2
extern "C" {
int waf_advect_f32(const void* pp, const void* um, const void* vm,
                   const void* s, const void* fmz, const void* fmzf,
                   const void* mx2, const void* mci, void* out, int nf,
                   int kz, int ly, int lx, int hh, int iy, int jx, int y0,
                   int x0, double dtrdx, double dtrdz, void* stream) {
    return launch<float>(pp, um, vm, s, fmz, fmzf, mx2, mci, out, nf, kz,
                         ly, lx, hh, iy, jx, y0, x0, dtrdx, dtrdz, stream);
}
int waf_advect_f64(const void* pp, const void* um, const void* vm,
                   const void* s, const void* fmz, const void* fmzf,
                   const void* mx2, const void* mci, void* out, int nf,
                   int kz, int ly, int lx, int hh, int iy, int jx, int y0,
                   int x0, double dtrdx, double dtrdz, void* stream) {
    return launch<double>(pp, um, vm, s, fmz, fmzf, mx2, mci, out, nf, kz,
                          ly, lx, hh, iy, jx, y0, x0, dtrdx, dtrdz,
                          stream);
}
}

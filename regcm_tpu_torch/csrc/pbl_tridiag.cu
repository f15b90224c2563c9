// Batched tridiagonal (Thomas) solve of the Holtslag implicit vertical
// diffusion (mod_pbl_holtbl.F90:566-660):
//
//   -c3[k] x[k-1] + c2[k] x[k] - c1[k] x[k+1] = rhs[k],  k = 0..kz-1
//
// for every (system s, y, x) column of (ns, kz, iy, jx) row-major arrays:
// forward elimination into ce, cf (k = 0 .. kz-1), then back
// substitution x[k] = ce[k]·x[k+1] + cf[k] from x[kz-1] = cf[kz-1].
//
// Replaces the TPU kernel regcm_tpu/dynamics/pallas_kernels.py
// pbl_tridiag / _pbl_tridiag_kernel (Pallas, by=8 x bx=128 VMEM tiles
// padded with identity systems, the column's ce and cf in VMEM scratch).
//
// Bound: memory. Each column reads 4·kz values and writes kz, with ~8
// flops a level, far below the card's flop/byte balance: at
// (5,41,192,192) in f32 151 MB, ~45 us at 3.35 TB/s.
//
// What held the first design back (one thread a column walking k in
// device memory, blocks of 128 threads):
//   - ce went to a scratch tensor and cf to the output in the forward
//     sweep, and both came back in the back substitution: 4·kz more
//     values a column (at (5,41,192,192) 60 MB, more than the L2 holds);
//   - every level's loads were made in that level's iteration, so a
//     column paid about 2·kz device-memory latencies in series, and the
//     8,160 columns of test_001 filled only 64 blocks on 132 SMs.
//
// This design: a warp owns 32 neighbouring columns of the flattened
// (s, y, x) columns, lane l column l, and walks them as one thread a
// column, with the column's values in the warp's slots of shared memory
// (level k of lane l at word k·32 + l: conflict-free).
//   - Loads: the levels come in chunks of CHUNK, each an asynchronous
//     copy group (cp.async) into the slots: 16-byte pieces spread over
//     the lanes where the plane and the pointers allow it, else one
//     element a lane, so any plane (37x45) and any alignment is taken;
//     a column past the end is zero-filled, solved as the identity
//     (c2 = 1) and never stored. The copies of AHEAD chunks are in
//     flight while the sweep walks the current one, started between the
//     sweep's dependent steps: a column waits on about one device-memory
//     latency, not 2·kz, and a warp keeps AHEAD chunks of bytes in
//     flight.
//   - The forward sweep reads a chunk's inputs into registers, runs its
//     CHUNK levels as straight-line code (the carried chain is a
//     multiply-add and the IEEE division) and writes ce over c1's slots
//     and cf over rhs's; the back substitution reads them back a chunk
//     at a time and stores x. The column's scratch never leaves the SM:
//     device memory sees each input read once and x written once, the
//     bound's bytes.
//   - A block is one warp, so test_001's 8,160 columns give 255 blocks
//     on 132 SMs (blocks of two and four warps timed the same).
//   - Every column runs the same operations in the same order whatever
//     its block, warp, lane, copy path or position at the edge, so a
//     rank's block (K5c) gives the unsharded K1's bits.
// Shared memory is 4·kz·32 values a block (21 KB at kz = 41 in f32);
// columns of up to MAX_LEVELS levels are taken (200 KB in f64, through
// cudaFuncSetAttribute), longer ones refused with cudaErrorInvalidValue
// (the wrapper raises first).
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int WARP = 32;
constexpr int MAX_LEVELS = 200;   // kernels/pbl_tridiag.py MAX_LEVELS
constexpr int CHUNK = 8;          // levels a copy group
constexpr int AHEAD = 3;          // copy groups in flight ahead

// asynchronous copies into shared memory; an invalid source is not
// read and fills zeros (src-size 0)
template <int BYTES>
__device__ __forceinline__ void copy_async(void* dst, const void* src,
                                           bool valid) {
    unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    if constexpr (BYTES == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
                     :: "r"(s), "l"(src), "n"(BYTES),
                        "r"(valid ? BYTES : 0) : "memory");
}

__device__ __forceinline__ void commit_group() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// the oldest groups have landed once at most N newer ones are pending;
// the lanes then see each other's copies
template <int N>
__device__ __forceinline__ void wait_groups() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
    __syncwarp();
}

// where a lane's copies go: the first row of a chunk it copies and the
// rows between its copies, its column offset in the warp's row, whether
// its source column exists and the source's offset at level 0; with
// 16-byte pieces (vec) PPR lanes share a level row, else a lane copies
// its own column of every row
struct Lane {
    int row0, rows, off;
    bool valid;
    long long src;
};

template <typename T>
__device__ __forceinline__ Lane copy_lane(long long col0, long long ncols,
                                          int kz, long long plane, int lane,
                                          bool vec) {
    constexpr int V = 16 / sizeof(T);     // columns a piece
    constexpr int PPR = WARP / V;         // pieces a level row
    Lane l;
    l.row0 = vec ? lane / PPR : 0;
    l.rows = vec ? WARP / PPR : 1;
    l.off = vec ? (lane % PPR) * V : lane;
    l.valid = col0 + l.off < ncols;
    const long long cc = l.valid ? col0 + l.off : 0;
    const long long s = cc / plane;
    l.src = s * kz * plane + (cc - s * plane);
    return l;
}

// the lane's copies of levels lo+r, r < cnt, of the four inputs into
// the warp's slots sm
template <int BYTES, typename T>
__device__ __forceinline__ void copy_rows(
    T* sm, const T* __restrict__ c1, const T* __restrict__ c2,
    const T* __restrict__ c3, const T* __restrict__ rhs, int kz,
    long long plane, const Lane& l, int lo, int cnt) {
    const int stride = kz * WARP;
    for (int r = l.row0; r < cnt; r += l.rows) {
        const int k = lo + r;
        const long long o = l.src + (long long)k * plane;
        T* d = sm + k * WARP + l.off;
        copy_async<BYTES>(d, c1 + o, l.valid);
        copy_async<BYTES>(d + stride, c2 + o, l.valid);
        copy_async<BYTES>(d + 2 * stride, c3 + o, l.valid);
        copy_async<BYTES>(d + 3 * stride, rhs + o, l.valid);
    }
}

// chunk c (levels c·CHUNK .. min((c+1)·CHUNK, kz)-1); always one
// commit group, empty past the last chunk
template <typename T>
__device__ __forceinline__ void copy_chunk(
    T* sm, const T* __restrict__ c1, const T* __restrict__ c2,
    const T* __restrict__ c3, const T* __restrict__ rhs, int kz,
    long long plane, const Lane& l, int c, bool vec) {
    const int lo = c * CHUNK;
    if (lo < kz) {
        const int cnt = min(CHUNK, kz - lo);
        if (vec)
            copy_rows<16>(sm, c1, c2, c3, rhs, kz, plane, l, lo, cnt);
        else
            copy_rows<sizeof(T)>(sm, c1, c2, c3, rhs, kz, plane, l, lo,
                                  cnt);
    }
    commit_group();
}

// one level of the forward elimination
template <typename T>
__device__ __forceinline__ void fwd_level(T c1k, T c2k, T c3k, T rk,
                                          T& ce_m1, T& cf_m1) {
    const T denom = c2k - c3k * ce_m1;
    ce_m1 = c1k / denom;
    cf_m1 = (rk + c3k * cf_m1) / denom;
}

template <typename T>
__global__ void __launch_bounds__(WARP)
pbl_tridiag_kernel(const T* __restrict__ c1, const T* __restrict__ c2,
                   const T* __restrict__ c3, const T* __restrict__ rhs,
                   T* __restrict__ out, int kz, long long plane,
                   long long ncols, int vec) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int lane = threadIdx.x;
    const long long col0 = (long long)blockIdx.x * WARP;
    const long long col = col0 + lane;
    const bool valid = col < ncols;
    T* sm = reinterpret_cast<T*>(smem);
    T* s_c1 = sm + lane;                    // c1, then ce
    T* s_c2 = s_c1 + kz * WARP;
    T* s_c3 = s_c2 + kz * WARP;
    T* s_rhs = s_c3 + kz * WARP;            // rhs, then cf
    const int nchunks = (kz + CHUNK - 1) / CHUNK;
    const Lane l = copy_lane<T>(col0, ncols, kz, plane, lane, vec);

    for (int c = 0; c < AHEAD; ++c)
        copy_chunk(sm, c1, c2, c3, rhs, kz, plane, l, c, vec);
    T ce_m1 = T(0), cf_m1 = T(0);
    for (int c = 0; c < nchunks; ++c) {
        copy_chunk(sm, c1, c2, c3, rhs, kz, plane, l, c + AHEAD, vec);
        wait_groups<AHEAD>();               // chunk c has landed
        const int lo = c * CHUNK;
        if (lo + CHUNK <= kz) {
            T a1[CHUNK], a2[CHUNK], a3[CHUNK], ar[CHUNK];
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
                a1[j] = s_c1[(lo + j) * WARP];
                a2[j] = valid ? s_c2[(lo + j) * WARP] : T(1);
                a3[j] = s_c3[(lo + j) * WARP];
                ar[j] = s_rhs[(lo + j) * WARP];
            }
#pragma unroll
            for (int j = 0; j < CHUNK; ++j) {
                fwd_level(a1[j], a2[j], a3[j], ar[j], ce_m1, cf_m1);
                s_c1[(lo + j) * WARP] = ce_m1;
                s_rhs[(lo + j) * WARP] = cf_m1;
            }
        } else {
            for (int k = lo; k < kz; ++k) {
                fwd_level(s_c1[k * WARP], valid ? s_c2[k * WARP] : T(1),
                          s_c3[k * WARP], s_rhs[k * WARP], ce_m1, cf_m1);
                s_c1[k * WARP] = ce_m1;
                s_rhs[k * WARP] = cf_m1;
            }
        }
    }

    const long long cc = valid ? col : col0;
    const long long s = cc / plane;
    T* o = out + (s * kz + kz - 1) * plane + (cc - s * plane);
    T x = cf_m1;                            // x[kz-1] = cf[kz-1]
    if (valid) *o = x;
    int k = kz - 2;
    for (; k >= CHUNK - 1; k -= CHUNK) {
        T e[CHUNK], f[CHUNK];
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            e[j] = s_c1[(k - j) * WARP];
            f[j] = s_rhs[(k - j) * WARP];
        }
#pragma unroll
        for (int j = 0; j < CHUNK; ++j) {
            x = e[j] * x + f[j];
            o -= plane;
            if (valid) *o = x;
        }
    }
    for (; k >= 0; --k) {
        x = s_c1[k * WARP] * x + s_rhs[k * WARP];
        o -= plane;
        if (valid) *o = x;
    }
}

template <typename T>
static int launch(const void* c1, const void* c2, const void* c3,
                  const void* rhs, void* out, int ns, int kz,
                  long long plane, void* stream) {
    const long long ncols = (long long)ns * plane;
    if (ncols == 0 || kz == 0) return 0;
    if (kz < 0 || kz > MAX_LEVELS) return (int)cudaErrorInvalidValue;
    // 16-byte pieces: whole pieces of every level row, aligned
    const bool vec = plane % (16 / sizeof(T)) == 0
        && ((uintptr_t)c1 | (uintptr_t)c2 | (uintptr_t)c3 | (uintptr_t)rhs)
               % 16 == 0;
    const size_t bytes = (size_t)4 * kz * WARP * sizeof(T);
    if (bytes > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            pbl_tridiag_kernel<T>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
        if (e != cudaSuccess) return (int)e;
    }
    const long long blocks = (ncols + WARP - 1) / WARP;
    pbl_tridiag_kernel<T><<<(unsigned)blocks, WARP, bytes,
                            (cudaStream_t)stream>>>(
        (const T*)c1, (const T*)c2, (const T*)c3, (const T*)rhs, (T*)out,
        kz, plane, ncols, (int)vec);
    return (int)cudaGetLastError();
}

}  // namespace

extern "C" {
int pbl_tridiag_f32(const void* c1, const void* c2, const void* c3,
                    const void* rhs, void* out, int ns, int kz,
                    long long plane, void* stream) {
    return launch<float>(c1, c2, c3, rhs, out, ns, kz, plane, stream);
}
int pbl_tridiag_f64(const void* c1, const void* c2, const void* c3,
                    const void* rhs, void* out, int ns, int kz,
                    long long plane, void* stream) {
    return launch<double>(c1, c2, c3, rhs, out, ns, kz, plane, stream);
}
}

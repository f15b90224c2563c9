// Batched dense LU with partial pivoting and the triangular solves of the
// gas-phase Rosenbrock solver (regcm_tpu_torch/chem/kinetics.py): every
// grid cell factors its own stage matrix P = I/(h gamma) - J (N x N, N
// the mechanism's variable species: 58 for CBMZ, 76 for CB6r2) once an
// iteration and solves two right-hand sides with it.
//
// It stands in for jax.scipy.linalg.lu_factor/lu_solve of the JAX
// package's Ros2 (regcm_tpu/chem/kinetics.py:122-127), which computes them
// in XLA outside any Pallas kernel; the plain version is
// torch.linalg.lu_factor/lu_solve (getrf and getrs), which took 45.8 ms
// for one chunk's 65,536 stage matrices of 58 species in f32, against
// 5.3 ms for this kernel (chip_smoke.py phase 20a; NVIDIA H100 80GB HBM3,
// 700 W).
//
// Layout: one warp a matrix. The matrix (row-major in global memory, N x N
// contiguous a cell) is staged in the warp's slice of shared memory with an
// odd row stride, so that a column read by 32 lanes (one row a lane) and a
// row read (one column a lane) are both free of bank conflicts; lane l owns
// columns and rows l + 32 s, s < NS. Each elimination step k:
//   - the pivot: the row of the largest |a(i, k)|, i >= k, the first one on
//     ties (LAPACK's idamax), by a warp arg-max;
//   - the row swap, one column a lane;
//   - the multipliers l(i) = a(i, k) / a(k, k), one row a lane;
//   - the rank-1 update a(i, j) -= l(i) a(k, j), one column a lane, the
//     rows in order (each entry's updates in the order of k, as getf2's).
// The solves: the row interchanges in order, then the unit-lower forward
// and the upper backward substitutions, one row a lane, the unknowns in
// shared memory. Nothing depends on the batch: a cell's numbers are the
// same wherever it sits in the batch, so a decomposed run stays
// bit-identical to one card.
//
// Bound: the bytes. A factorisation with its first solve reads P and b and
// writes the LU, the pivots and x (2 N^2 + 3 N values a cell), and does
// about 2/3 N^3 + 2 N^2 flops: 8.9 GFLOP for 65,536 cells at N = 58,
// 0.13 ms at 67 TFLOP/s, against 1.81 GB in f32, 0.54 ms at 3.35 TB/s
// (chip_smoke.py k6_bound).
#include <cuda_runtime.h>

namespace {

constexpr int MAX_N = 96;           // three columns a lane
constexpr unsigned FULL = 0xffffffffu;
constexpr size_t DEFAULT_SMEM = 48 * 1024;

__host__ __device__ constexpr int stride_of(int n) { return n | 1; }

template <typename T>
__device__ __forceinline__ T absv(T x) { return x < T(0) ? -x : x; }

// the warp's matrix into shared memory (coalesced over the N x N block)
template <typename T>
__device__ __forceinline__ void stage(const T* __restrict__ g, T* a, int n,
                                      int ld, int lane) {
    const int nn = n * n;
    for (int e = lane; e < nn; e += 32) a[(e / n) * ld + e % n] = g[e];
    __syncwarp();
}

// x <- P x, then L y = x (unit lower), then U x = y
template <typename T>
__device__ __forceinline__ void solve_in_smem(const T* a, const int* pv,
                                              T* x, int n, int ld, int lane) {
    if (lane == 0)
        for (int k = 0; k < n; ++k) {
            const int p = pv[k];
            if (p != k) { const T t = x[k]; x[k] = x[p]; x[p] = t; }
        }
    __syncwarp();
    for (int k = 0; k < n; ++k) {
        const T xk = x[k];
        for (int i = k + 1 + lane; i < n; i += 32)
            x[i] = x[i] - a[i * ld + k] * xk;
        __syncwarp();
    }
    for (int k = n - 1; k >= 0; --k) {
        const T xk = x[k] / a[k * ld + k];
        __syncwarp();
        if (lane == 0) x[k] = xk;
        for (int i = lane; i < k; i += 32) x[i] = x[i] - a[i * ld + k] * xk;
        __syncwarp();
    }
}

// factor P (in place into lu), pivots (0-based) into piv, and solve for b
// (in place)
template <typename T, int WPB>
__global__ void __launch_bounds__(WPB * 32)
lu_factor_solve_kernel(T* __restrict__ lu, int* __restrict__ piv,
                       T* __restrict__ b, long long ncell, int n) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long cell = (long long)blockIdx.x * WPB + w;
    if (cell >= ncell) return;               // a whole warp
    const int ld = stride_of(n);
    T* a = reinterpret_cast<T*>(smem) + (size_t)w * (n * ld + n);
    T* x = a + n * ld;
    int* pv = reinterpret_cast<int*>(reinterpret_cast<T*>(smem)
                                     + (size_t)WPB * (n * ld + n)) + w * n;
    T* g = lu + cell * n * n;
    stage(g, a, n, ld, lane);
    for (int k = 0; k < n; ++k) {
        // the pivot row: the largest |a(i, k)|, the first on ties
        T best = T(-1);
        int bi = n;
        for (int i = k + lane; i < n; i += 32) {
            const T v = absv(a[i * ld + k]);
            if (v > best) { best = v; bi = i; }
        }
#pragma unroll
        for (int d = 16; d > 0; d >>= 1) {
            const T ob = __shfl_xor_sync(FULL, best, d);
            const int oi = __shfl_xor_sync(FULL, bi, d);
            if (ob > best || (ob == best && oi < bi)) { best = ob; bi = oi; }
        }
        const int p = bi < n ? bi : k;
        if (lane == 0) pv[k] = p;
        if (p != k)
            for (int j = lane; j < n; j += 32) {
                const T t = a[k * ld + j];
                a[k * ld + j] = a[p * ld + j];
                a[p * ld + j] = t;
            }
        __syncwarp();
        const T d = a[k * ld + k];
        for (int i = k + 1 + lane; i < n; i += 32)
            a[i * ld + k] = a[i * ld + k] / d;
        __syncwarp();
        for (int j = k + 1 + lane; j < n; j += 32) {
            const T u = a[k * ld + j];
            for (int i = k + 1; i < n; ++i)
                a[i * ld + j] = a[i * ld + j] - a[i * ld + k] * u;
        }
        __syncwarp();
    }
    for (int e = lane; e < n * n; e += 32) g[e] = a[(e / n) * ld + e % n];
    for (int k = lane; k < n; k += 32) {
        piv[cell * n + k] = pv[k];
        x[k] = b[cell * n + k];
    }
    __syncwarp();
    solve_in_smem(a, pv, x, n, ld, lane);
    for (int k = lane; k < n; k += 32) b[cell * n + k] = x[k];
}

// solve with a factorisation of lu_factor_solve_kernel, b in place
template <typename T, int WPB>
__global__ void __launch_bounds__(WPB * 32)
lu_solve_kernel(const T* __restrict__ lu, const int* __restrict__ piv,
                T* __restrict__ b, long long ncell, int n) {
    extern __shared__ __align__(16) unsigned char smem[];
    const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const long long cell = (long long)blockIdx.x * WPB + w;
    if (cell >= ncell) return;
    const int ld = stride_of(n);
    T* a = reinterpret_cast<T*>(smem) + (size_t)w * (n * ld + n);
    T* x = a + n * ld;
    int* pv = reinterpret_cast<int*>(reinterpret_cast<T*>(smem)
                                     + (size_t)WPB * (n * ld + n)) + w * n;
    stage(lu + cell * n * n, a, n, ld, lane);
    for (int k = lane; k < n; k += 32) {
        pv[k] = piv[cell * n + k];
        x[k] = b[cell * n + k];
    }
    __syncwarp();
    solve_in_smem(a, pv, x, n, ld, lane);
    for (int k = lane; k < n; k += 32) b[cell * n + k] = x[k];
}

// a block's warps (cells): 4, or fewer where four matrices would not fit
// in the shared memory a block may have (227 KB on sm_90; f64 at N = 96
// takes 75 KB a warp)
constexpr size_t MAX_SMEM = 200 * 1024;

template <typename T>
size_t smem_bytes(int wpb, int n) {
    return (size_t)wpb * ((size_t)(n * stride_of(n) + n) * sizeof(T)
                          + n * sizeof(int));
}

template <typename T>
int warps_a_block(int n) {
    return smem_bytes<T>(4, n) <= MAX_SMEM ? 4
        : smem_bytes<T>(2, n) <= MAX_SMEM ? 2 : 1;
}

// the opt-in past 48 KB of dynamic shared memory, once per kernel and size
template <typename K>
int opt_in(K kernel, size_t smem, size_t* opted) {
    if (smem <= *opted) return 0;
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    *opted = smem;
    return 0;
}

template <typename T, int WPB>
int factor_solve_w(void* lu, void* piv, void* b, long long ncell, int n,
                   void* stream) {
    static size_t opted = DEFAULT_SMEM;
    const size_t smem = smem_bytes<T>(WPB, n);
    if (int e = opt_in(lu_factor_solve_kernel<T, WPB>, smem, &opted)) return e;
    const long long blocks = (ncell + WPB - 1) / WPB;
    lu_factor_solve_kernel<T, WPB><<<(unsigned)blocks, WPB * 32, smem,
                                     (cudaStream_t)stream>>>(
        (T*)lu, (int*)piv, (T*)b, ncell, n);
    return (int)cudaGetLastError();
}

template <typename T, int WPB>
int solve_w(const void* lu, const void* piv, void* b, long long ncell, int n,
            void* stream) {
    static size_t opted = DEFAULT_SMEM;
    const size_t smem = smem_bytes<T>(WPB, n);
    if (int e = opt_in(lu_solve_kernel<T, WPB>, smem, &opted)) return e;
    const long long blocks = (ncell + WPB - 1) / WPB;
    lu_solve_kernel<T, WPB><<<(unsigned)blocks, WPB * 32, smem,
                              (cudaStream_t)stream>>>(
        (const T*)lu, (const int*)piv, (T*)b, ncell, n);
    return (int)cudaGetLastError();
}

template <typename T>
int factor_solve(void* lu, void* piv, void* b, long long ncell, int n,
                 void* stream) {
    if (ncell == 0) return 0;
    if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    switch (warps_a_block<T>(n)) {
        case 4: return factor_solve_w<T, 4>(lu, piv, b, ncell, n, stream);
        case 2: return factor_solve_w<T, 2>(lu, piv, b, ncell, n, stream);
        default: return factor_solve_w<T, 1>(lu, piv, b, ncell, n, stream);
    }
}

template <typename T>
int solve(const void* lu, const void* piv, void* b, long long ncell, int n,
          void* stream) {
    if (ncell == 0) return 0;
    if (n < 1 || n > MAX_N) return (int)cudaErrorInvalidValue;
    switch (warps_a_block<T>(n)) {
        case 4: return solve_w<T, 4>(lu, piv, b, ncell, n, stream);
        case 2: return solve_w<T, 2>(lu, piv, b, ncell, n, stream);
        default: return solve_w<T, 1>(lu, piv, b, ncell, n, stream);
    }
}

}  // namespace

extern "C" {
// lu (ncell, n, n): P in, its LU out (unit-lower L below the diagonal, U
// on and above); piv (ncell, n) int32: the 0-based row interchanged with
// row k at step k; b (ncell, n): the right-hand side in, the solution out
int gas_lu_factor_solve_f32(void* lu, void* piv, void* b, long long ncell,
                            int n, void* stream) {
    return factor_solve<float>(lu, piv, b, ncell, n, stream);
}
int gas_lu_factor_solve_f64(void* lu, void* piv, void* b, long long ncell,
                            int n, void* stream) {
    return factor_solve<double>(lu, piv, b, ncell, n, stream);
}
int gas_lu_solve_f32(const void* lu, const void* piv, void* b,
                     long long ncell, int n, void* stream) {
    return solve<float>(lu, piv, b, ncell, n, stream);
}
int gas_lu_solve_f64(const void* lu, const void* piv, void* b,
                     long long ncell, int n, void* stream) {
    return solve<double>(lu, piv, b, ncell, n, stream);
}
}

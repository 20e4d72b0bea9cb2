// Packed row gather out[i, :] = mat[idx[i], :], for Hopper (sm_90a).
// Replaces the TPU kernel `dma_row_gather` (spark_rapids_tpu/ops/
// pallas_gather.py), reached there through `pallas_gather_rows`.
//
// Bound: bytes. The function reads the index (4 bytes a row), each
// distinct row that an in-range index names, row 0 once (what every
// out-of-range slot copies), and writes every output row: for n indices
// into (cap, L) u32 rows that is at most 4n + 4L * (min(n, cap) + 1 + n).
// q3's stream payload (L = 8, 2,097,152 slots, some 0.8 M of them in
// range) moves about 96 MB, 29 us at 3.35 TB/s.
//
// Design. What bounds a gather on Hopper is how many random row reads a
// thread keeps in flight and how few instructions each costs, so:
//   - a thread owns whole rows: ROWS of them per step, every index
//     loaded first (the next step's while this step's rows move), then
//     the loads of every row of both matrices, then the stores, so 2 *
//     ROWS random reads are in flight per thread (a copy of one matrix's
//     rows before the other's loads would wait twice);
//   - the widths the main paths pack are compile-time (row_gather_fixed:
//     (la, lb) = (4, 0), (4, 4), (3, 0), (3, 4), (3, 2), (2, 2), (3, 6):
//     q3's and q19's payloads with LONG or INT keys), so a row moves in 16-,
//     8- or 4-byte pieces with no division; any other width, or a matrix
//     off the pieces' alignment, takes row_gather_any, one word at a time;
//   - a slot whose index is outside [0, cap) loads nothing: each block
//     reads row 0 once into shared memory, its first `nv` lanes of `a`
//     (the validity words) zeroed, and stores that copy there;
//   - offsets are 32-bit when every one fits (I = int), else 64-bit;
//   - one wave of blocks, a grid-stride loop; both matrices (the u32 lanes
//     `a` and the f64 lanes viewed as u32 `b`) ride one launch.
// Asking L2 for a small matrix first (a bulk prefetch), 8 or 2 rows a
// thread and evict-first stores measured no faster at the main paths'
// shapes (PERF.md, Findings). ops/row_gather.plan() picks the kernel on
// the host.

#include <cuda_runtime.h>

#define THREADS 256
#define ROWS 4

template <int V> struct Vec;
template <> struct Vec<1> { typedef unsigned type; };
template <> struct Vec<2> { typedef uint2 type; };
template <> struct Vec<4> { typedef uint4 type; };

template <int V>
__device__ __forceinline__ void unpack(typename Vec<V>::type v,
                                       unsigned* w);
template <> __device__ __forceinline__ void unpack<1>(unsigned v,
                                                      unsigned* w) {
    w[0] = v;
}
template <> __device__ __forceinline__ void unpack<2>(uint2 v, unsigned* w) {
    w[0] = v.x; w[1] = v.y;
}
template <> __device__ __forceinline__ void unpack<4>(uint4 v, unsigned* w) {
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
}

template <int V>
__device__ __forceinline__ typename Vec<V>::type pack(const unsigned* w);
template <> __device__ __forceinline__ unsigned pack<1>(const unsigned* w) {
    return w[0];
}
template <> __device__ __forceinline__ uint2 pack<2>(const unsigned* w) {
    return make_uint2(w[0], w[1]);
}
template <> __device__ __forceinline__ uint4 pack<4>(const unsigned* w) {
    return make_uint4(w[0], w[1], w[2], w[3]);
}

// row 0 of both matrices, validity lanes zeroed, into shared memory
__device__ __forceinline__ void stage_row0(unsigned* row0, long long cap,
                                           const unsigned* a, int la,
                                           const unsigned* b, int lb,
                                           int nv) {
    for (int k = threadIdx.x; k < la + lb; k += blockDim.x) {
        unsigned v = 0u;
        if (cap > 0 && k >= nv) v = k < la ? a[k] : b[k - la];
        row0[k] = v;
    }
    __syncthreads();
}

// One matrix's part of ROWS rows into registers: a load for each row in
// range, the staged row 0 for the others.
template <int L, int V, typename I>
__device__ __forceinline__ void load_rows(const unsigned* __restrict__ m,
                                          const unsigned* row0, const I* s,
                                          const bool* ok,
                                          unsigned (*w)[L > 0 ? L : 1]) {
    if (L == 0) return;
    typedef typename Vec<V>::type T;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (ok[k]) {
            const T* src = reinterpret_cast<const T*>(m + s[k] * L);
#pragma unroll
            for (int p = 0; p < L / V; ++p) unpack<V>(__ldg(src + p),
                                                      w[k] + p * V);
        } else {
#pragma unroll
            for (int q = 0; q < L; ++q) w[k][q] = row0[q];
        }
    }
}

template <int L, int V, typename I>
__device__ __forceinline__ void store_rows(unsigned* __restrict__ o,
                                           unsigned (*w)[L > 0 ? L : 1],
                                           const I* r, I n) {
    if (L == 0) return;
    typedef typename Vec<V>::type T;
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        if (r[k] < n) {
            T* dst = reinterpret_cast<T*>(o + r[k] * L);
#pragma unroll
            for (int p = 0; p < L / V; ++p) dst[p] = pack<V>(w[k] + p * V);
        }
    }
}

// The index of rows r0, r0 + stride, ... (-1 past n).
template <typename I>
__device__ __forceinline__ void load_idx(const int* __restrict__ idx, I r0,
                                         I stride, I n, int* iv) {
#pragma unroll
    for (int k = 0; k < ROWS; ++k) {
        const I r = r0 + k * stride;
        iv[k] = r < n ? __ldg(idx + r) : -1;
    }
}

template <int LA, int VA, int LB, int VB, typename I>
__global__ void __launch_bounds__(THREADS)
row_gather_fixed(const int* __restrict__ idx, I n, I cap,
                 const unsigned* __restrict__ a, unsigned* __restrict__ oa,
                 const unsigned* __restrict__ b, unsigned* __restrict__ ob,
                 int nv) {
    __shared__ unsigned row0[LA + LB];
    const I stride = (I)gridDim.x * THREADS;
    I r0 = (I)blockIdx.x * THREADS + threadIdx.x;
    int iv[ROWS];
    load_idx(idx, r0, stride, n, iv);   // in flight while row 0 is staged
    stage_row0(row0, cap, a, LA, b, LB, nv);
    for (; r0 < n; r0 += ROWS * stride) {
        I r[ROWS], s[ROWS];
        bool ok[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            r[k] = r0 + k * stride;
            ok[k] = iv[k] >= 0 && (I)iv[k] < cap;
            s[k] = ok[k] ? (I)iv[k] : 0;
        }
        load_idx(idx, r0 + ROWS * stride, stride, n, iv);   // the next step's
        // every row load of both matrices before the first store, so that
        // 2 * ROWS random reads are in flight per thread
        unsigned wa[ROWS][LA > 0 ? LA : 1], wb[ROWS][LB > 0 ? LB : 1];
        load_rows<LA, VA, I>(a, row0, s, ok, wa);
        load_rows<LB, VB, I>(b, row0 + LA, s, ok, wb);
        store_rows<LA, VA, I>(oa, wa, r, n);
        store_rows<LB, VB, I>(ob, wb, r, n);
    }
}

template <typename I>
__global__ void __launch_bounds__(THREADS)
row_gather_any(const int* __restrict__ idx, I n, I cap,
               const unsigned* __restrict__ a, int la,
               unsigned* __restrict__ oa, const unsigned* __restrict__ b,
               int lb, unsigned* __restrict__ ob, int nv) {
    extern __shared__ unsigned row0[];
    const I stride = (I)gridDim.x * THREADS;
    I r0 = (I)blockIdx.x * THREADS + threadIdx.x;
    int iv[ROWS];
    load_idx(idx, r0, stride, n, iv);
    stage_row0(row0, cap, a, la, b, lb, nv);
    for (; r0 < n; r0 += ROWS * stride) {
        I r[ROWS], s[ROWS];
        bool ok[ROWS];
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            r[k] = r0 + k * stride;
            ok[k] = iv[k] >= 0 && (I)iv[k] < cap;
            s[k] = ok[k] ? (I)iv[k] : 0;
        }
        load_idx(idx, r0 + ROWS * stride, stride, n, iv);
#pragma unroll
        for (int k = 0; k < ROWS; ++k) {
            if (r[k] >= n) continue;
            for (int q = 0; q < la; ++q)
                oa[r[k] * la + q] = ok[k] ? __ldg(a + s[k] * la + q)
                                          : row0[q];
            for (int q = 0; q < lb; ++q)
                ob[r[k] * lb + q] = ok[k] ? __ldg(b + s[k] * lb + q)
                                          : row0[la + q];
        }
    }
}

// The fixed-width kernels, by the kind numbers of ops/row_gather.FIXED:
// X(kind, la, words of a's pieces, lb, words of b's pieces); kind 0 is
// row_gather_any.
#define FIXED_KINDS(X) \
    X(1, 4, 4, 0, 1) X(2, 4, 4, 4, 4) X(3, 3, 1, 2, 2) X(4, 3, 1, 6, 2) \
    X(5, 3, 1, 0, 1) X(6, 3, 1, 4, 4) X(7, 2, 2, 2, 2)

template <typename I>
static const void* kernel_of(int kind) {
#define KERNEL_OF(k, la, va, lb, vb)                                  \
    if (kind == k) return (const void*)row_gather_fixed<la, va, lb, vb, I>;
    FIXED_KINDS(KERNEL_OF)
#undef KERNEL_OF
    return kind == 0 ? (const void*)row_gather_any<I> : nullptr;
}

// Blocks of `kind` (64-bit offsets when `wide`) resident on one SM, and
// the card's SM count: what ops/row_gather.grid_shape needs.
extern "C" int row_gather_limits(int kind, int wide, int* blocks_per_sm,
                                 int* sms) {
    const void* k = wide ? kernel_of<long long>(kind) : kernel_of<int>(kind);
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            blocks_per_sm, k, THREADS, 0);
    return (int)e;
}

template <typename I>
static void launch(int kind, int grid, cudaStream_t st, const int* idx,
                   I n, I cap, const unsigned* a, int la, unsigned* oa,
                   const unsigned* b, int lb, unsigned* ob, int nv) {
#define LAUNCH(k, la_, va, lb_, vb)                                   \
    if (kind == k) {                                                   \
        row_gather_fixed<la_, va, lb_, vb, I><<<grid, THREADS, 0, st>>>( \
            idx, n, cap, a, oa, b, ob, nv);                            \
        return;                                                        \
    }
    FIXED_KINDS(LAUNCH)
#undef LAUNCH
    row_gather_any<I><<<grid, THREADS, (size_t)(la + lb) * sizeof(unsigned),
                        st>>>(idx, n, cap, a, la, oa, b, lb, ob, nv);
}

// idx: n i32; a: cap x la u32, oa: n x la; b: cap x lb u32 (lb may be 0,
// then b and ob are unused), ob: n x lb; nv: validity lanes of a to zero
// for out-of-range indices; kind, wide and grid from ops/row_gather.plan.
// Returns the launch's CUDA error (0 = none).
extern "C" int row_gather_run(int kind, int wide, int grid, const void* idx,
                              long long n, long long cap, const void* a,
                              int la, void* oa, const void* b, int lb,
                              void* ob, int nv, void* stream) {
    if (n <= 0 || la + lb <= 0) return 0;
    if (kernel_of<int>(kind) == nullptr || grid <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (wide)
        launch<long long>(kind, grid, st, (const int*)idx, n, cap,
                          (const unsigned*)a, la, (unsigned*)oa,
                          (const unsigned*)b, lb, (unsigned*)ob, nv);
    else
        launch<int>(kind, grid, st, (const int*)idx, (int)n, (int)cap,
                    (const unsigned*)a, la, (unsigned*)oa,
                    (const unsigned*)b, lb, (unsigned*)ob, nv);
    return (int)cudaGetLastError();
}

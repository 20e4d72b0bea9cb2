// Table-resident dictionary gather out[i, l] = table[clamp(idx[i, l]), l]
// for Hopper (sm_90a). Replaces the TPU kernel `dg` (tools/exp_gather.py,
// the inline pallas_call in main(): jnp.take_along_axis over an int32
// (4096, 128) table held whole in VMEM), which the JAX package's
// columnar/encoded.dict_take serves as the `dict_gather` family: a
// per-dictionary table (a literal's hit mask, precomputed hashes) read by
// each row's code.
//
// Bound: bytes. Each index (4 bytes) is read once, each output element
// (1 or 4 bytes) written once, and the table read once: rows * L *
// (4 + elt) + n * L * elt bytes. At dg's shape that is 2M * 8 + 2 MB =
// 18.9 MB, 5.6 us at 3.35 TB/s; a 1-byte take over 8,388,608 codes moves
// 42 MB, 12.5 us.
//
// Design. The work per element is one dependent read, so the kernel lives
// on how many index bytes it keeps in flight and how few instructions it
// spends per element. A thread takes four consecutive elements: one
// 16-byte load of four codes, four table reads, one 4-byte (1-byte table)
// or 16-byte (4-byte table) store, and UNROLL such quads are loaded before
// the first is used. ops/dict_gather.plan() picks the kernel and its grid
// on the host, from the card's limits read once per process:
//   dict_gather_flat: lane counts of a power of two, so an element's lane
//     is its flat position masked (shifts and masks, no division), with a
//     persistent grid of one wave. A one-lane table (the only shape
//     dict_take passes) of up to STAGE_BYTES (Q19's hit masks hold at
//     most 150 entries) is staged whole in shared memory by every block
//     (STAGED); a larger one, or a multi-lane table, is read through the
//     read-only path and stays in L2 (dg's 2 MB table is far below its 50
//     MB; staging four of its lanes a block in 64 KB tiles was slower). An
//     index pointer that is not 16-byte aligned (a view such as x[1:])
//     gets a scalar head up to the boundary; the wrapper allocates the
//     output at the same phase, and a scalar tail takes the rest;
//   dict_gather_scalar: any other lane count, one element a thread, the
//     table in global memory.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define UNROLL 4

enum { KIND_SCALAR = 0, KIND_FLAT = 1 };

template <typename T> struct Quad;      // four elements in one store
template <> struct Quad<uint8_t> { typedef unsigned type; };
template <> struct Quad<uint32_t> { typedef uint4 type; };

__device__ __forceinline__ unsigned pack4(uint8_t a, uint8_t b, uint8_t c,
                                          uint8_t d) {
    return (unsigned)a | ((unsigned)b << 8) | ((unsigned)c << 16) |
           ((unsigned)d << 24);
}

__device__ __forceinline__ uint4 pack4(uint32_t a, uint32_t b, uint32_t c,
                                       uint32_t d) {
    return make_uint4(a, b, c, d);
}

__device__ __forceinline__ int clamp_code(int c, int n) {
    return c < 0 ? 0 : (c >= n ? n - 1 : c);
}

// the flat element space of (rows, L = 1 << lshift) indices: elements
// [0, head) and [head + 4 * nvec, total) one at a time, the nvec quads
// between them four at a time
template <typename T, bool STAGED>
__global__ void __launch_bounds__(THREADS)
dict_gather_flat(const T* __restrict__ table, int n, int lshift,
                 const int* __restrict__ idx, long long total,
                 long long head, long long nvec, T* __restrict__ out) {
    extern __shared__ __align__(16) unsigned char smem_raw[];
    T* tile = reinterpret_cast<T*>(smem_raw);
    typedef typename Quad<T>::type Q;
    const long long gid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
    const long long stride = (long long)gridDim.x * blockDim.x;
    const long long lmask = (1ll << lshift) - 1;
    const int4* iv = reinterpret_cast<const int4*>(idx + head);
    Q* ov = reinterpret_cast<Q*>(out + head);
    int4 c[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
        const long long v = gid + u * stride;
        if (v < nvec) c[u] = __ldg(iv + v);
    }
    if (STAGED) {   // one lane: the whole table
        for (int k = threadIdx.x; k < n; k += blockDim.x) tile[k] = table[k];
        __syncthreads();
    }
    // the value of element p, whose code is `code`
    auto value = [&](int code, long long p) -> T {
        const int cc = clamp_code(code, n);
        if (STAGED) return tile[cc];
        return __ldg(&table[((long long)cc << lshift) | (p & lmask)]);
    };
    const long long tail0 = head + 4 * nvec;
    for (long long p = gid; p < head; p += stride) out[p] = value(idx[p], p);
    for (long long p = tail0 + gid; p < total; p += stride)
        out[p] = value(idx[p], p);
    for (long long v0 = gid; v0 < nvec; v0 += UNROLL * stride) {
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long v = v0 + u * stride;
            if (v < nvec) {
                const long long p = head + 4 * v;
                ov[v] = pack4(value(c[u].x, p), value(c[u].y, p + 1),
                              value(c[u].z, p + 2), value(c[u].w, p + 3));
            }
        }
#pragma unroll
        for (int u = 0; u < UNROLL; ++u) {
            const long long v = v0 + (UNROLL + u) * stride;
            if (v < nvec) c[u] = __ldg(iv + v);
        }
    }
}

// one element a thread, 64-bit index math: lane counts that are not a
// power of two
template <typename T>
__global__ void __launch_bounds__(THREADS)
dict_gather_scalar(const T* __restrict__ table, int n, int L,
                   const int* __restrict__ idx, long long total,
                   T* __restrict__ out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += stride) {
        const long long i = t / L;
        const int l = (int)(t - i * L);
        out[t] = __ldg(&table[(long long)clamp_code(idx[t], n) * L + l]);
    }
}

// The card's SM count, read once per process by the wrapper. Returns the
// CUDA error.
extern "C" int dict_gather_sms(int* sms) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
        err = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    return (int)err;
}

template <typename T>
static int launch(int kind, int staged, const void* table, int n, int L,
                  int shift, const void* idx, long long rows, void* out,
                  long long head, long long nvec, int grid, int smem,
                  cudaStream_t s) {
    const T* tb = (const T*)table;
    const int* ix = (const int*)idx;
    T* o = (T*)out;
    const long long total = rows * L;
    if (kind == KIND_FLAT && staged) {
        dict_gather_flat<T, true><<<grid, THREADS, smem, s>>>(
            tb, n, shift, ix, total, head, nvec, o);
    } else if (kind == KIND_FLAT) {
        dict_gather_flat<T, false><<<grid, THREADS, 0, s>>>(
            tb, n, shift, ix, total, head, nvec, o);
    } else {
        dict_gather_scalar<T><<<grid, THREADS, 0, s>>>(tb, n, L, ix, total,
                                                       o);
    }
    return (int)cudaGetLastError();
}

// table: n x L elements of `elt` bytes (1 or 4), row-major; idx: rows x L
// i32; out: rows x L elements of `elt` bytes. `kind`, `staged`, `shift`
// (log2 L for the flat kernel), the head/quads split, the grid and the
// shared memory come from ops/dict_gather.plan(). Returns the launch's
// CUDA error (0 = none).
extern "C" int dict_gather_run(int kind, int staged, const void* table,
                               int n, int L, int elt, int shift,
                               const void* idx, long long rows, void* out,
                               long long head, long long nvec, int grid,
                               int smem, void* stream) {
    if (rows <= 0 || L <= 0) return 0;
    if (n <= 0 || grid <= 0) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (elt == 1)
        return launch<uint8_t>(kind, staged, table, n, L, shift, idx, rows,
                               out, head, nvec, grid, smem, s);
    if (elt == 4)
        return launch<uint32_t>(kind, staged, table, n, L, shift, idx, rows,
                                out, head, nvec, grid, smem, s);
    return (int)cudaErrorInvalidValue;
}

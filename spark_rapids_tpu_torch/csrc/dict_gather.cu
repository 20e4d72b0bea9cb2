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
// Design: the TPU kernel keeps the table in VMEM because every index
// reads a different row of it. A block here stages its part of the table
// in shared memory the same way, then streams indices in and results out
// with one thread per element, so neighbouring threads read and write
// neighbouring addresses. dg's whole table (2 MB) is more than one SM's
// 227 KB, so a block takes a group of `lb` lanes (a power of two: 8 lanes
// x 4096 rows x 4 B = 128 KB for dg) and a range of rows; a one-lane
// dictionary table that fits is staged whole. The tile is row-major
// (tile[code * lb + lane]): a warp covers 32 / lb output rows of lb
// lanes, the lanes of one row fall in lb distinct banks, and only rows
// whose codes agree modulo 32 / lb can collide (a few-way conflict at
// worst on random codes; identical codes broadcast). Lane-major order
// would put every lane at the same bank offset when n is a multiple of
// 32, leaving the bank to the code alone. A table larger than the opt-in
// shared-memory budget is read from global memory through the read-only
// path in the same kernel (STAGED = false): the mode is a template
// parameter the launcher picks from the caller's `lb` (0 = global).

#include <cuda_runtime.h>
#include <stdint.h>

template <typename T, bool STAGED>
__global__ void dict_gather(const T* __restrict__ table, long long n, int L,
                            const int* __restrict__ idx, long long rows,
                            T* __restrict__ out, int lb) {
    if (STAGED) {
        extern __shared__ __align__(16) unsigned char smem_raw[];
        T* tile = reinterpret_cast<T*>(smem_raw);
        const int l0 = blockIdx.y * lb;
        const int w = min(lb, L - l0);          // lanes of this group
        const long long staged = n * w;
        for (long long k = threadIdx.x; k < staged; k += blockDim.x) {
            const long long r = k / w;
            const int j = (int)(k - r * w);
            tile[r * lb + j] = table[r * L + l0 + j];
        }
        __syncthreads();
        const long long per = (rows + gridDim.x - 1) / gridDim.x;
        const long long r0 = (long long)blockIdx.x * per;
        const long long r1 = min(rows, r0 + per);
        if (r0 >= r1) return;
        const long long count = (r1 - r0) * w;
        for (long long t = threadIdx.x; t < count; t += blockDim.x) {
            const long long q = t / w;
            const int j = (int)(t - q * w);
            const long long o = (r0 + q) * L + l0 + j;
            long long c = idx[o];
            c = c < 0 ? 0 : (c >= n ? n - 1 : c);
            out[o] = tile[c * lb + j];
        }
    } else {
        const long long total = rows * L;
        const long long step = (long long)gridDim.x * blockDim.x;
        for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
             t < total; t += step) {
            const long long i = t / L;
            const int l = (int)(t - i * L);
            long long c = idx[t];
            c = c < 0 ? 0 : (c >= n ? n - 1 : c);
            out[t] = __ldg(&table[c * L + l]);
        }
    }
}

// The opt-in shared-memory budget of one block on the current device
// (232,448 bytes on an H100). Returns the CUDA error (0 = none).
extern "C" int dict_gather_smem_optin(int* bytes) {
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return (int)err;
    return (int)cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

template <typename T>
static int launch(const void* table, long long n, int L, const void* idx,
                  long long rows, void* out, int lb, cudaStream_t s) {
    int dev = 0, sms = 132;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    const T* tb = (const T*)table;
    const int* ix = (const int*)idx;
    T* o = (T*)out;
    if (lb > 0) {
        const size_t smem = (size_t)n * lb * sizeof(T);
        const int threads = 512;
        const long long groups = (L + lb - 1) / lb;
        // blocks of this tile one SM holds (at most 4 of 512 threads)
        int budget = 0;
        cudaDeviceGetAttribute(&budget,
                               cudaDevAttrMaxSharedMemoryPerMultiprocessor,
                               dev);
        long long per_sm = smem ? (long long)budget / (long long)smem : 4;
        per_sm = per_sm < 1 ? 1 : (per_sm > 4 ? 4 : per_sm);
        long long row_blocks = sms * per_sm / groups;
        const long long by_rows = (rows + threads - 1) / threads;
        if (row_blocks > by_rows) row_blocks = by_rows;
        if (row_blocks < 1) row_blocks = 1;
        // raised once per instance to the whole opt-in budget (the
        // caller keeps `smem` within it), not on every launch
        static bool raised = false;
        if (smem > 48 * 1024 && !raised) {
            int optin = 0;
            cudaDeviceGetAttribute(&optin,
                                   cudaDevAttrMaxSharedMemoryPerBlockOptin,
                                   dev);
            cudaError_t err = cudaFuncSetAttribute(
                dict_gather<T, true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
            if (err != cudaSuccess) return (int)err;
            raised = true;
        }
        dim3 grid((unsigned)row_blocks, (unsigned)groups);
        dict_gather<T, true><<<grid, threads, smem, s>>>(tb, n, L, ix, rows,
                                                        o, lb);
    } else {
        const long long total = rows * L;
        long long blocks = (total + 255) / 256;
        if (blocks > (long long)sms * 16) blocks = (long long)sms * 16;
        dict_gather<T, false><<<(unsigned)blocks, 256, 0, s>>>(
            tb, n, L, ix, rows, o, 0);
    }
    return (int)cudaGetLastError();
}

// table: n x L elements of `elt` bytes (1 or 4), row-major; idx: rows x L
// i32; out: rows x L elements of `elt` bytes. lb > 0 stages lb lanes of
// the table per block in shared memory (n * lb * elt bytes must fit the
// opt-in budget); lb = 0 reads the table from global memory. Returns the
// launch's CUDA error (0 = none).
extern "C" int dict_gather_run(const void* table, long long n, int L,
                               int elt, const void* idx, long long rows,
                               void* out, int lb, void* stream) {
    if (rows <= 0 || L <= 0) return 0;
    if (n <= 0 || lb < 0 || lb > L) return (int)cudaErrorInvalidValue;
    cudaStream_t s = (cudaStream_t)stream;
    if (elt == 1)
        return launch<uint8_t>(table, n, L, idx, rows, out, lb, s);
    if (elt == 4)
        return launch<uint32_t>(table, n, L, idx, rows, out, lb, s);
    return (int)cudaErrorInvalidValue;
}

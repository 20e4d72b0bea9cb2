// Packed row gather out[i, :] = mat[idx[i], :], for Hopper (sm_90a).
// Replaces the TPU kernel `dma_row_gather` (spark_rapids_tpu/ops/
// pallas_gather.py), reached there through `pallas_gather_rows`.
//
// Bound: bytes. The index (4 bytes a row) and each gathered row are read
// once and each output row written once: for an (n, L) u32 gather that is
// 4n + 2 * 4nL bytes. A lineitem row of q3 packs into L = 8 words (one
// validity word, two for the LONG key, one INT, four for two DOUBLEs), so
// a million gathered rows move 68 MB, 20 us at 3.35 TB/s.
//
// Design: the TPU kernel walks index tiles through SMEM and keeps a window
// of per-row DMAs in flight, because a TPU's XLA gather is loop-bound.
// On Hopper a gather is a plain load: thread t copies word (t % L) of
// output row (t / L), so a warp covers 32 consecutive output words — the
// stores coalesce, the loads of one source row are contiguous, and many
// warps in flight hide the random-row latency. Two matrices ride one
// launch: the u32 matrix `a` and the f64 matrix viewed as u32 lanes `b`,
// so the JAX wrapper's concatenation and split never copy the data.
// An index outside [0, cap) reads row 0 and the first `nv` lanes of `a`
// (the validity words) come back zero: the engine's out-of-range contract,
// applied in the kernel instead of in a pass before and one after.

#include <cuda_runtime.h>

__global__ void row_gather(const int* __restrict__ idx, long long n,
                           long long cap, const unsigned* __restrict__ a,
                           int la, unsigned* __restrict__ oa,
                           const unsigned* __restrict__ b, int lb,
                           unsigned* __restrict__ ob, int nv) {
    const int L = la + lb;
    const long long total = n * L;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         t < total; t += step) {
        const long long r = t / L;
        const int k = (int)(t - r * L);
        const long long i = idx[r];
        const bool ok = i >= 0 && i < cap;
        const long long s = ok ? i : 0;
        if (k < la) {
            unsigned v = cap > 0 ? a[s * la + k] : 0u;
            if (!ok && k < nv) v = 0u;
            oa[r * la + k] = v;
        } else {
            const int kk = k - la;
            ob[r * lb + kk] = cap > 0 ? b[s * lb + kk] : 0u;
        }
    }
}

// idx: n i32; a: cap x la u32, oa: n x la; b: cap x lb u32 (lb may be 0,
// then b and ob are unused), ob: n x lb; nv: validity lanes of a to zero
// for out-of-range indices. Returns the launch's CUDA error (0 = none).
extern "C" int row_gather_run(const void* idx, long long n, long long cap,
                              const void* a, int la, void* oa,
                              const void* b, int lb, void* ob, int nv,
                              void* stream) {
    const long long total = n * (long long)(la + lb);
    if (total <= 0) return 0;
    long long blocks = (total + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    row_gather<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const int*)idx, n, cap, (const unsigned*)a, la, (unsigned*)oa,
        (const unsigned*)b, lb, (unsigned*)ob, nv);
    return (int)cudaGetLastError();
}

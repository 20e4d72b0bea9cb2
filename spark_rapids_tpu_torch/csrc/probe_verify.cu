// Fused probe-verify-emit of the hash join, for Hopper (sm_90a). Replaces
// the TPU kernel `_probe_kernel_body` (spark_rapids_tpu/ops/pallas_join.py,
// launched by `fused_probe_verify`).
//
// For each flat candidate slot i < out_cap (the layout of
// ops/join.expand_candidates): find the owner stream row j, derive the
// build position lo[j] + (i - start[j]), verify the u32 key lanes and
// both validity lanes, and emit (verified, stream_idx, build_pos,
// build_row). Slots at or beyond the candidate total give
// (0, -1, -1, -1).
//
// Bound: bytes. Each slot writes 13 bytes; its owner's prefix, range
// start, key lanes and validity are read once per stream row, and each
// candidate's build lanes, validity and permutation entry once per slot.
// At q3's shape (about 2M slots, 2M stream rows, two lanes a key) that is
// roughly 100 MB, some 30 us at 3.35 TB/s.
//
// Design: the TPU kernel forward-fills the owner row with a cummax over
// sequential grid steps, carrying the running maximum in SMEM. Hopper
// blocks run in no order, so nothing can be carried: one thread owns one
// slot and finds its owner by a binary search over the inclusive i32
// prefix of the per-row counts (computed by the wrapper, as
// candidate_fill_inputs computes the TPU kernel's inputs). Neighbouring
// slots mostly share an owner, so a warp's searches walk the same prefix
// entries and its loads broadcast; the prefix (8 MB at 2M rows) stays in
// the 50 MB L2. The i32 prefix is exact while the candidate total is
// below 2^31, the same bound as the TPU kernel's.

#include <cuda_runtime.h>

__global__ void probe_verify(const int* __restrict__ cum,
                             const int* __restrict__ lo, long long n_stream,
                             const long long* __restrict__ total,
                             const int* __restrict__ bk,
                             const unsigned char* __restrict__ bvalid,
                             long long build_cap,
                             const int* __restrict__ sk,
                             const unsigned char* __restrict__ svalid,
                             int n_lanes, const int* __restrict__ perm,
                             long long out_cap,
                             unsigned char* __restrict__ verified,
                             int* __restrict__ s_idx,
                             int* __restrict__ b_pos,
                             int* __restrict__ b_row) {
    const long long t = *total;
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < out_cap; i += step) {
        // owner: the first row whose inclusive prefix exceeds i
        long long a = 0, b = i < t ? n_stream : 0;
        while (a < b) {
            const long long mid = (a + b) >> 1;
            if ((long long)cum[mid] <= i) a = mid + 1; else b = mid;
        }
        const long long j = a;
        if (i >= t || j >= n_stream) {
            verified[i] = 0;
            s_idx[i] = -1;
            b_pos[i] = -1;
            b_row[i] = -1;
            continue;
        }
        const long long start = j > 0 ? cum[j - 1] : 0;
        const int bp = (int)(lo[j] + (i - start));
        const long long safe = bp < 0 ? 0 : (bp >= build_cap ? build_cap - 1
                                                              : bp);
        bool ok = bvalid[safe] != 0 && svalid[j] != 0;
        for (int l = 0; l < n_lanes; ++l)
            ok = ok && bk[safe * n_lanes + l] == sk[j * n_lanes + l];
        verified[i] = ok ? 1 : 0;
        s_idx[i] = (int)j;
        b_pos[i] = bp;
        b_row[i] = (bp >= 0 && bp < build_cap) ? perm[safe] : -1;
    }
}

// cum, lo: n_stream i32; total: one i64 on the device; bk: build_cap x
// n_lanes i32, bvalid: build_cap bytes; sk: n_stream x n_lanes i32,
// svalid: n_stream bytes; perm: build_cap i32; outputs: out_cap each.
// Returns the launch's CUDA error (0 = none).
extern "C" int probe_verify_run(const void* cum, const void* lo,
                                long long n_stream, const void* total,
                                const void* bk, const void* bvalid,
                                long long build_cap, const void* sk,
                                const void* svalid, int n_lanes,
                                const void* perm, long long out_cap,
                                void* verified, void* s_idx, void* b_pos,
                                void* b_row, void* stream) {
    if (out_cap <= 0) return 0;
    if (build_cap <= 0 || n_lanes <= 0) return (int)cudaErrorInvalidValue;
    long long blocks = (out_cap + 255) / 256;
    if (blocks > 132 * 16) blocks = 132 * 16;
    probe_verify<<<(int)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const int*)cum, (const int*)lo, n_stream, (const long long*)total,
        (const int*)bk, (const unsigned char*)bvalid, build_cap,
        (const int*)sk, (const unsigned char*)svalid, n_lanes,
        (const int*)perm, out_cap, (unsigned char*)verified, (int*)s_idx,
        (int*)b_pos, (int*)b_row);
    return (int)cudaGetLastError();
}

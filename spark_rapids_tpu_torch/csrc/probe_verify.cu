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
// Bound: bytes. Every count is read once; lo, the key lanes and validity
// of each stream row that owns a slot once; each candidate's build lanes,
// validity and permutation entry once per distinct build row; each slot
// writes 13 bytes. At q3's shape (2,097,152 stream rows and slots, two
// lanes a key) that is some 51 MB, about 15 us at 3.35 TB/s.
//
// Design: the counts are scanned and the slots emitted in one launch (the
// single-pass prefix scan with decoupled look-back of Merrill and
// Garland); the wrapper runs no prefix sum. The TPU kernel carries the
// owner row through sequential grid steps; Hopper blocks run in no
// order, so:
//   - probe_scan_emit runs one wave of blocks (ops/probe_verify.grid). A
//     block takes the chunk of `per` tiles of TILE stream rows that an
//     atomic ticket gives it, so it only ever waits on chunks that running
//     blocks hold. It sums the chunk's counts (16-byte loads, two tiles in
//     flight), keeping the sums of its first MAX_PER tiles, publishes the
//     chunk's sum, looks back one warp of 32 predecessors at a time for
//     its exclusive offset, and publishes its inclusive prefix (the last
//     chunk also the total);
//   - it then walks its tiles, skipping a tile with no candidate without
//     reading it again (Q19's 736 slots lie in a few of 2,048 tiles): it
//     scans a tile's counts in shared memory and writes the tile's slots
//     below out_cap. A slot's owner is found by a binary search of the
//     tile's prefix in shared memory (log2 TILE steps); a thread takes
//     SLOTS slots at once, all their loads (the owner's lo, then its
//     validity and key lanes and the build side's lanes, validity and
//     perm) issued before the first store and none conditional on
//     another's value; the four outputs are stored coalesced. The build
//     side's random reads cost most of the emit (PERF.md);
//   - the slots [total, out_cap) go in pieces of TAIL_PIECE to blocks
//     that finish their own slots once the total is out; a block never
//     waits for it (a grid-wide wait could deadlock when not every block
//     is resident): the block that publishes the total takes pieces until
//     none is left. The last block to finish returns the scratch to zero
//     for the next launch on its stream.
// The prefix is 64-bit (saturating at 2^56), so it is exact for any
// count; the slot arithmetic is 32-bit, as out_cap < 2^31.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256
#define PER 16                   // counts a thread holds of a tile
#define TILE (THREADS * PER)
#define SLOTS 2                  // slots a thread emits at once
#define MAX_PER 16               // tiles of a chunk whose sums are kept
#define WARPS (THREADS / 32)

// chunk status words: flag in the top two bits, a saturating value below
#define ST_AGG (1ull << 62)
#define ST_INCL (2ull << 62)
#define ST_VALUE ((1ull << 62) - 1)
#define SAT (1ll << 56)

// scratch words: [0] chunk ticket, [1] the total (ST_INCL once out),
// [2] tail piece ticket, [3] blocks done, [4 + t] chunk t's status
#define SCRATCH_HEAD 4
#define TAIL_PIECE 8192          // tail slots a block writes per ticket

__device__ __forceinline__ long long sat_add(long long a, long long b) {
    const long long s = a + b;
    return s > SAT ? SAT : s;
}

__device__ __forceinline__ unsigned long long load_status(
        const unsigned long long* p) {
    return *(volatile const unsigned long long*)p;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
    *(volatile unsigned long long*)p = v;
}

// Lanes of a key: compile-time for one and two lanes (INT, LONG keys),
// else the run-time count.
template <int L> struct Lanes {
    static __device__ __forceinline__ int n(int) { return L; }
};
template <> struct Lanes<0> {
    static __device__ __forceinline__ int n(int rt) { return rt; }
};

// The counts of rows base + tid * PER ... + PER - 1 (0 past n_stream).
__device__ __forceinline__ void load_counts(const int* __restrict__ counts,
                                            int base, int n_stream,
                                            bool vec, int* c) {
    if (vec && base + TILE <= n_stream) {
        const int4* p = reinterpret_cast<const int4*>(counts + base) +
                        threadIdx.x * (PER / 4);
#pragma unroll
        for (int q = 0; q < PER / 4; ++q) {
            const int4 v = __ldg(p + q);
            c[4 * q] = v.x; c[4 * q + 1] = v.y;
            c[4 * q + 2] = v.z; c[4 * q + 3] = v.w;
        }
    } else {
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            const int r = base + threadIdx.x * PER + q;
            c[q] = r < n_stream ? __ldg(counts + r) : 0;
        }
    }
}

// The block's sum of `v` (every thread gets it); `red` holds WARPS words.
__device__ __forceinline__ long long block_sum(long long v, long long* red) {
#pragma unroll
    for (int d = 16; d > 0; d >>= 1) v += __shfl_xor_sync(0xffffffffu, v, d);
    __syncthreads();                  // red's last readers are done
    if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
    __syncthreads();
    long long s = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w];
    return s;
}

// The chunk's exclusive offset: warp 0 publishes `agg`, looks back over
// the predecessors' words and publishes the inclusive prefix.
__device__ __forceinline__ long long look_back(
        unsigned long long* __restrict__ scratch, int chunk, int n_chunks,
        long long agg) {
    unsigned long long* status = scratch + SCRATCH_HEAD;
    const int lane = threadIdx.x & 31;
    const long long agg_s = agg < SAT ? agg : SAT;
    long long off = 0;
    if (chunk == 0) {
        if (lane == 0) store_status(status, ST_INCL | agg_s);
    } else {
        if (lane == 0) store_status(status + chunk, ST_AGG | agg_s);
        int pred = chunk - 1;
        for (;;) {
            const int t = pred - lane;
            unsigned long long s = t >= 0 ? load_status(status + t)
                                          : ST_INCL;
            while (__any_sync(0xffffffffu, (s >> 62) == 0)) {
                if ((s >> 62) == 0) s = load_status(status + t);
            }
            const unsigned incl = __ballot_sync(0xffffffffu,
                                                (s >> 62) == 2);
            // lanes up to the nearest inclusive word (or all 32)
            const int stop = incl ? __ffs(incl) - 1 : 31;
            long long v = lane <= stop ? (long long)(s & ST_VALUE) : 0;
#pragma unroll
            for (int d = 16; d > 0; d >>= 1)
                v = sat_add(v, __shfl_xor_sync(0xffffffffu, v, d));
            off = sat_add(off, v);
            if (incl) break;
            pred -= 32;
        }
        if (lane == 0)
            store_status(status + chunk, ST_INCL | sat_add(off, agg_s));
    }
    if (lane == 0 && chunk == n_chunks - 1)
        store_status(scratch + 1, ST_INCL | sat_add(off, agg_s));
    return off;
}

template <int L>
__global__ void __launch_bounds__(THREADS)
probe_scan_emit(const int* __restrict__ counts, const int* __restrict__ lo,
                int n_stream, int per, int n_chunks,
                const int* __restrict__ bk,
                const unsigned char* __restrict__ bvalid, int build_cap,
                const int* __restrict__ sk,
                const unsigned char* __restrict__ svalid, int n_lanes_rt,
                const int* __restrict__ perm, int out_cap,
                unsigned char* __restrict__ verified, int* __restrict__ s_idx,
                int* __restrict__ b_pos, int* __restrict__ b_row,
                unsigned long long* __restrict__ scratch) {
    const int nl = Lanes<L>::n(n_lanes_rt);
    // a tile's exclusive prefix, saturating at INT_MAX (an emitted slot's
    // local position is below out_cap < 2^31), with excl[TILE] = its sum
    __shared__ int excl[TILE + 1];
    __shared__ long long red[WARPS];
    __shared__ long long wsum[MAX_PER][WARPS];
    __shared__ long long s_offset;
    __shared__ long long s_piece;
    __shared__ unsigned long long s_total;
    __shared__ int s_chunk;

    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    if (tid == 0) s_chunk = (int)atomicAdd(scratch, 1ull);
    __syncthreads();
    const int chunk = s_chunk;
    const int first = chunk * per * TILE;
    const bool vec = ((uintptr_t)counts & 15) == 0;

    // the chunk's sum, each of its first MAX_PER tiles' sums by warp (so
    // that the emit skips an empty tile without reading it again); the
    // counts of its last tile stay in c
    int c[PER];
    long long mine = 0;
#pragma unroll 2
    for (int k = 0; k < per; ++k) {
        load_counts(counts, first + k * TILE, n_stream, vec, c);
        long long t = 0;
#pragma unroll
        for (int q = 0; q < PER; ++q) t += c[q];
        mine += t;
        if (per > 1 && k < MAX_PER) {
#pragma unroll
            for (int d = 16; d > 0; d >>= 1)
                t += __shfl_xor_sync(0xffffffffu, t, d);
            if (lane == 0) wsum[k][warp] = t;
        }
    }
    const long long agg = block_sum(mine, red);
    if (warp == 0) {
        const long long off = look_back(scratch, chunk, n_chunks, agg);
        if (lane == 0) s_offset = off;
    }
    __syncthreads();
    long long E = s_offset;           // the next tile's first slot
    int held = per - 1;               // the tile whose counts c holds

    for (int k = 0; agg > 0 && k < per && E < out_cap; ++k) {
        const int base = first + k * TILE;
        if (per > 1 && k < MAX_PER) {
            long long t = 0;
#pragma unroll
            for (int w = 0; w < WARPS; ++w) t += wsum[k][w];
            if (t == 0) continue;
        }
        if (k != held) {
            load_counts(counts, base, n_stream, vec, c);
            held = k;
        }
        // the tile's exclusive scan: the threads' sums, then their rows
        long long sum = 0;
#pragma unroll
        for (int q = 0; q < PER; ++q) sum += c[q];
        long long x = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
            const long long y = __shfl_up_sync(0xffffffffu, x, d);
            if (lane >= d) x += y;
        }
        __syncthreads();              // the last tile's readers are done
        if (lane == 31) red[warp] = x;
        __syncthreads();
        long long run = x - sum, tile_sum = 0;
#pragma unroll
        for (int w = 0; w < WARPS; ++w) {
            if (w < warp) run += red[w];
            tile_sum += red[w];
        }
        if (tile_sum == 0) continue;
#pragma unroll
        for (int q = 0; q < PER; ++q) {
            excl[tid * PER + q] = (int)(run < INT32_MAX ? run : INT32_MAX);
            run += c[q];
        }
        if (tid == 0)
            excl[TILE] = (int)(tile_sum < INT32_MAX ? tile_sum : INT32_MAX);
        __syncthreads();
        // local slots [0, emit): those below out_cap
        const int emit = (int)(tile_sum < out_cap - E ? tile_sum
                                                      : out_cap - E);
        for (int p0 = tid; p0 < emit; p0 += SLOTS * THREADS) {
            // owners and build positions, then every load of the lot
            // (none conditional on another's value), then the stores
            int j[SLOTS], bp[SLOTS], safe[SLOTS], row[SLOTS];
            bool live[SLOTS];
            unsigned char bv[SLOTS], sv[SLOTS];
            int bkv[SLOTS][L > 0 ? L : 1], skv[SLOTS][L > 0 ? L : 1];
#pragma unroll
            for (int s = 0; s < SLOTS; ++s) {
                const int p = p0 + s * THREADS;
                live[s] = p < emit;
                // owner: the last row whose exclusive prefix is <= p
                int r = 0;
#pragma unroll
                for (int step = TILE / 2; step >= 1; step >>= 1)
                    if (excl[r + step] <= p) r += step;
                j[s] = live[s] ? base + r : base;
                bp[s] = (int)((unsigned)__ldg(lo + j[s]) +
                              (unsigned)(p - excl[r]));
                safe[s] = bp[s] < 0 ? 0
                        : (bp[s] >= build_cap ? build_cap - 1 : bp[s]);
            }
#pragma unroll
            for (int s = 0; s < SLOTS; ++s) {
                bv[s] = __ldg(bvalid + safe[s]);
                sv[s] = __ldg(svalid + j[s]);
                row[s] = __ldg(perm + safe[s]);
                if (L > 0) {
#pragma unroll
                    for (int l = 0; l < (L > 0 ? L : 1); ++l) {
                        bkv[s][l] = __ldg(bk + (long long)safe[s] * L + l);
                        skv[s][l] = __ldg(sk + (long long)j[s] * L + l);
                    }
                }
            }
#pragma unroll
            for (int s = 0; s < SLOTS; ++s) {
                if (!live[s]) continue;
                bool ok = bv[s] != 0 && sv[s] != 0;
                if (L > 0) {
#pragma unroll
                    for (int l = 0; l < (L > 0 ? L : 1); ++l)
                        ok = ok && bkv[s][l] == skv[s][l];
                } else {
                    for (int l = 0; l < nl; ++l)
                        ok = ok && __ldg(bk + (long long)safe[s] * nl + l) ==
                                       __ldg(sk + (long long)j[s] * nl + l);
                }
                const int i = (int)E + p0 + s * THREADS;
                verified[i] = ok ? 1 : 0;
                s_idx[i] = j[s];
                b_pos[i] = bp[s];
                b_row[i] = (bp[s] >= 0 && bp[s] < build_cap) ? row[s] : -1;
            }
        }
        E += tile_sum;
    }

    // The slots past the total, in pieces taken from a ticket once the
    // total is out. No block waits for it: the block that publishes it
    // takes pieces until none is left, and others help if they finish
    // after it. The last block to finish returns the scratch to zero.
    if (tid == 0) s_total = load_status(scratch + 1);
    __syncthreads();
    if (s_total & ST_INCL) {
        const long long total = (long long)(s_total & ST_VALUE);
        const long long tail0 = total < out_cap ? total : out_cap;
        for (;;) {
            if (tid == 0) s_piece = (long long)atomicAdd(scratch + 2, 1ull);
            __syncthreads();
            const long long start = tail0 + s_piece * TAIL_PIECE;
            __syncthreads();
            if (start >= out_cap) break;
            const long long end = start + TAIL_PIECE < out_cap
                                      ? start + TAIL_PIECE : out_cap;
            for (long long i = start + tid; i < end; i += THREADS) {
                verified[i] = 0;
                s_idx[i] = -1;
                b_pos[i] = -1;
                b_row[i] = -1;
            }
        }
    }
    if (tid == 0) {
        __threadfence();
        s_piece = (long long)atomicAdd(scratch + 3, 1ull);
    }
    __syncthreads();
    if (s_piece == n_chunks - 1) {
        for (int t = tid; t < n_chunks; t += THREADS)
            scratch[SCRATCH_HEAD + t] = 0ull;
        if (tid < SCRATCH_HEAD) scratch[tid] = 0ull;
    }
}

// Blocks of probe_scan_emit (one- or two-lane keys, or any count) that one
// SM holds, and the card's SM count: what ops/probe_verify.grid needs.
extern "C" int probe_verify_limits(int n_lanes, int* blocks_per_sm,
                                   int* sms) {
    const void* k = n_lanes == 1 ? (const void*)probe_scan_emit<1>
                  : n_lanes == 2 ? (const void*)probe_scan_emit<2>
                                 : (const void*)probe_scan_emit<0>;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                          THREADS, 0);
    return (int)e;
}

// counts, lo: n_stream i32; bk: build_cap x n_lanes i32, bvalid: build_cap
// bytes; sk: n_stream x n_lanes i32, svalid: n_stream bytes; perm:
// build_cap i32; outputs: out_cap each; scratch: SCRATCH_HEAD + n_chunks
// zero u64 words (the launch leaves them so); per and n_chunks (at least
// 1) from ops/probe_verify.grid. One launch. Returns its CUDA error (0 =
// none).
extern "C" int probe_verify_run(const void* counts, const void* lo,
                                int n_stream, int per, int n_chunks,
                                const void* bk, const void* bvalid,
                                int build_cap, const void* sk,
                                const void* svalid, int n_lanes,
                                const void* perm, int out_cap,
                                void* verified, void* s_idx, void* b_pos,
                                void* b_row, void* scratch, void* stream) {
    if (out_cap <= 0) return 0;
    if (build_cap <= 0 || n_lanes <= 0 || n_stream < 0 || per <= 0 ||
        n_chunks <= 0 || (long long)n_chunks * per * TILE < n_stream ||
        (long long)(n_chunks - 1) * per * TILE >= (n_stream > 0 ? n_stream
                                                                : 1))
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
#define PV_ARGS (const int*)counts, (const int*)lo, n_stream, per, n_chunks, \
        (const int*)bk, (const unsigned char*)bvalid, build_cap, \
        (const int*)sk, (const unsigned char*)svalid, n_lanes, \
        (const int*)perm, out_cap, (unsigned char*)verified, (int*)s_idx, \
        (int*)b_pos, (int*)b_row, (unsigned long long*)scratch
    if (n_lanes == 1)
        probe_scan_emit<1><<<n_chunks, THREADS, 0, st>>>(PV_ARGS);
    else if (n_lanes == 2)
        probe_scan_emit<2><<<n_chunks, THREADS, 0, st>>>(PV_ARGS);
    else
        probe_scan_emit<0><<<n_chunks, THREADS, 0, st>>>(PV_ARGS);
#undef PV_ARGS
    return (int)cudaGetLastError();
}

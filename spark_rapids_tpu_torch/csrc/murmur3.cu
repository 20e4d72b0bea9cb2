// Spark's Murmur3Hash over fixed-width key columns, for Hopper (sm_90a):
// h = seed; for each column, h = valid ? murmur3(value, h) : h, for one
// seed or two from one read of the keys. Replaces the TPU kernels
// `_two_word_kernel` (`murmur3_long_lanes`) and `_one_word_kernel`
// (`murmur3_int_lanes`) of spark_rapids_tpu/ops/pallas_kernels.py, and
// with them the seed plane, the dtype conversions and the per-column
// selects that spark_rapids_tpu/ops/hashing.py's murmur3_batch and
// murmur3_column build around those kernels.
//
// Bound: bytes. A row reads each key (1 to 8 bytes) and its validity byte
// once and writes one u32 per seed, some 20 integer operations a key and
// seed: far below the H100's operations-per-byte line. q3's stream keys
// (2,097,152 LONG keys, one seed) move 27.3 MB, 8.1 us at 3.35 TB/s; its
// build pair (524,288 keys, two seeds) 8.9 MB, 2.7 us.
//
// Design. The TPU kernels stream (256, 128) tiles of u32 planes through
// VMEM and take the running hash as a plane of its own, so the chain of a
// multi-column key and Spark's null rule live outside them, one XLA pass
// each. Here the chain stays in registers:
//   - the initial seed is a scalar argument (no seed plane), each column a
//     descriptor (data, validity, element kind), and the kernel widens,
//     sign-extends and normalises floats itself (-0.0 to 0.0, a NaN f64
//     to 0x7FF8000000000000), as the plain version does;
//   - a thread takes ROWS (4) consecutive rows: every load of them (seed
//     planes, each column's keys and validity) goes out in 16-, 8-, 4-,
//     2- or 1-byte pieces before the first mix, the next chunk's loads
//     before this chunk's mix, and the results leave in 16-byte stores;
//     loads and stores are streaming (evict-first: nothing is read
//     twice); a key's mix_k1 serves both seeds;
//   - the columns (C of at most MAX_COLS) and the seeds (S, 1 or 2) are
//     compile-time, so a one-column key holds no registers for four; a
//     longer key list continues in a further launch that takes the
//     running hashes as per-row seed planes (the TPU kernels' own
//     interface, also served here: one column, no validity, a seed plane);
//   - the body starts at `head`, chosen on the host so that the most
//     bytes a row load in whole pieces; a pointer off its pieces' alignment
//     (a view such as x[1:]) loads one element at a time, and the head
//     rows and the ragged tail take one row a thread;
//   - one wave of blocks, a grid-stride loop. ops/murmur3_lanes.plan()
//     picks head, pieces and grid on the host.
// At q3's and Q19's key shapes this runs within 6 % of a device copy of
// the same bytes. 2, 8 or 16 rows a thread, 128 or 512 threads a block,
// cached loads and stores, or no prefetch measured no faster; a block
// for every 1,024 rows instead of one wave was 4 % faster at Q19's
// stream keys and 2 % slower at q3's (PERF.md, Findings).

#include <cuda_runtime.h>

#define THREADS 256
#define ROWS 4
#define MAX_COLS 4

// element kinds, as ops/murmur3_lanes.KINDS numbers them
enum { K_BOOL, K_I8, K_I16, K_I32, K_F32, K_I64, K_F64, K_COUNT };

__host__ __device__ constexpr int width_of(int kind) {
    return kind <= K_I8 ? 1 : kind == K_I16 ? 2 : kind <= K_F32 ? 4 : 8;
}

struct M3Col {
    const unsigned char* data;   // n elements of `kind`
    const unsigned char* valid;  // n bool bytes, or null: every row valid
    int kind;
    int vec;                     // bit 0: data in pieces; bit 1: validity
};

struct M3Args {
    M3Col col[MAX_COLS];
    const unsigned* seed_in[2];  // per-row running hashes, or null
    unsigned* out[2];
    unsigned seed[2];            // the initial hash where seed_in is null
    int vec_io;                  // bit s: seed_in[s] in pieces; 2 + s: out
    long long head, body_end, n; // [head, body_end) in chunks of ROWS
};

#define C1 0xCC9E2D51u
#define C2 0x1B873593u

__device__ __forceinline__ unsigned rotl32(unsigned x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ unsigned mix_k1(unsigned k1) {
    return rotl32(k1 * C1, 15) * C2;
}

__device__ __forceinline__ unsigned mix_h1(unsigned h1, unsigned k1) {
    return rotl32(h1 ^ k1, 13) * 5u + 0xE6546B64u;
}

__device__ __forceinline__ unsigned fmix(unsigned h, unsigned length) {
    h ^= length;
    h ^= h >> 16;
    h *= 0x85EBCA6Bu;
    h ^= h >> 13;
    h *= 0xC2B2AE35u;
    return h ^ (h >> 16);
}

// B bytes at p, aligned to min(B, 16), into the words w (little-endian)
template <int B>
__device__ __forceinline__ void load_pieces(const unsigned char* p,
                                            unsigned* w) {
    if constexpr (B >= 16) {
#pragma unroll
        for (int k = 0; k < B / 16; ++k) {
            const uint4 q = __ldcs(reinterpret_cast<const uint4*>(p) + k);
            w[4 * k] = q.x;
            w[4 * k + 1] = q.y;
            w[4 * k + 2] = q.z;
            w[4 * k + 3] = q.w;
        }
    } else if constexpr (B == 8) {
        const uint2 q = __ldcs(reinterpret_cast<const uint2*>(p));
        w[0] = q.x;
        w[1] = q.y;
    } else if constexpr (B == 4) {
        w[0] = __ldcs(reinterpret_cast<const unsigned*>(p));
    } else if constexpr (B == 2) {
        w[0] = __ldcs(reinterpret_cast<const unsigned short*>(p));
    } else {
        w[0] = __ldcs(p);
    }
}

// R elements of W bytes at p, one element at a time (p is only aligned to
// its element), packed into the words w as load_pieces packs them
template <int R, int W>
__device__ __forceinline__ void load_elements(const unsigned char* p,
                                              unsigned* w) {
    if constexpr (W >= 4) {
#pragma unroll
        for (int k = 0; k < R * W / 4; ++k)
            w[k] = __ldcs(reinterpret_cast<const unsigned*>(p) + k);
    } else {
        constexpr int PER = 4 / W;
        unsigned x[R];
#pragma unroll
        for (int i = 0; i < R; ++i)
            x[i] = W == 1 ? (unsigned)__ldcs(p + i)
                          : (unsigned)__ldcs(
                                reinterpret_cast<const unsigned short*>(p) +
                                i);
#pragma unroll
        for (int k = 0; k < (R + PER - 1) / PER; ++k) w[k] = 0;
#pragma unroll
        for (int i = 0; i < R; ++i) w[i / PER] |= x[i] << (8 * W * (i % PER));
    }
}

template <int R, int W>
__device__ __forceinline__ void load_rows(const unsigned char* p, bool vec,
                                          unsigned* w) {
    if (vec)
        load_pieces<R * W>(p, w);
    else
        load_elements<R, W>(p, w);
}

template <int R>
__device__ __forceinline__ void load_keys(const M3Col& c, long long r0,
                                          bool vec, unsigned* w) {
    switch (width_of(c.kind)) {
    case 1: load_rows<R, 1>(c.data + r0, vec, w); break;
    case 2: load_rows<R, 2>(c.data + 2 * r0, vec, w); break;
    case 4: load_rows<R, 4>(c.data + 4 * r0, vec, w); break;
    default: load_rows<R, 8>(c.data + 8 * r0, vec, w); break;
    }
}

__device__ __forceinline__ unsigned byte_at(const unsigned* w, int i) {
    return (w[i / 4] >> (8 * (i % 4))) & 0xFFu;
}

__device__ __forceinline__ unsigned half_at(const unsigned* w, int i) {
    return (w[i / 2] >> (16 * (i % 2))) & 0xFFFFu;
}

// hashInt of x into every seed's hash of row i, where the row is valid
template <int R, int S>
__device__ __forceinline__ void mix_int(unsigned (&h)[S][R], int i,
                                        unsigned x, bool ok) {
    const unsigned k = mix_k1(x);
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const unsigned nh = fmix(mix_h1(h[s][i], k), 4u);
        h[s][i] = ok ? nh : h[s][i];
    }
}

// hashLong of (hi, lo) likewise
template <int R, int S>
__device__ __forceinline__ void mix_long(unsigned (&h)[S][R], int i,
                                         unsigned lo, unsigned hi, bool ok) {
    const unsigned k0 = mix_k1(lo), k1 = mix_k1(hi);
#pragma unroll
    for (int s = 0; s < S; ++s) {
        const unsigned nh = fmix(mix_h1(mix_h1(h[s][i], k0), k1), 8u);
        h[s][i] = ok ? nh : h[s][i];
    }
}

// one column's R keys (raw words w, validity words v) into the hashes
template <int R, int S>
__device__ __forceinline__ void mix_column(int kind, const unsigned* w,
                                           const unsigned* v, bool all_valid,
                                           unsigned (&h)[S][R]) {
#define OK(i) (all_valid || byte_at(v, i) != 0u)
    switch (kind) {
    case K_BOOL:
#pragma unroll
        for (int i = 0; i < R; ++i)
            mix_int<R, S>(h, i, byte_at(w, i) != 0u ? 1u : 0u, OK(i));
        break;
    case K_I8:
#pragma unroll
        for (int i = 0; i < R; ++i)
            mix_int<R, S>(h, i, (unsigned)(int)(signed char)byte_at(w, i),
                          OK(i));
        break;
    case K_I16:
#pragma unroll
        for (int i = 0; i < R; ++i)
            mix_int<R, S>(h, i, (unsigned)(int)(short)half_at(w, i), OK(i));
        break;
    case K_I32:
#pragma unroll
        for (int i = 0; i < R; ++i) mix_int<R, S>(h, i, w[i], OK(i));
        break;
    case K_F32:
        // -0.0 hashes as 0.0; a NaN keeps its bits
#pragma unroll
        for (int i = 0; i < R; ++i)
            mix_int<R, S>(h, i, (w[i] << 1) == 0u ? 0u : w[i], OK(i));
        break;
    case K_I64:
#pragma unroll
        for (int i = 0; i < R; ++i)
            mix_long<R, S>(h, i, w[2 * i], w[2 * i + 1], OK(i));
        break;
    default:  // K_F64: -0.0 hashes as 0.0, every NaN as 0x7FF8000000000000
#pragma unroll
        for (int i = 0; i < R; ++i) {
            unsigned lo = w[2 * i], hi = w[2 * i + 1];
            const unsigned mag = hi & 0x7FFFFFFFu;
            if ((mag | lo) == 0u) hi = 0u;
            if (mag > 0x7FF00000u || (mag == 0x7FF00000u && lo != 0u)) {
                hi = 0x7FF80000u;
                lo = 0u;
            }
            mix_long<R, S>(h, i, lo, hi, OK(i));
        }
        break;
    }
#undef OK
}

template <int R>
__device__ __forceinline__ void store_rows(unsigned* p, bool vec,
                                           const unsigned* h) {
    if constexpr (R % 4 == 0) {
        if (vec) {
#pragma unroll
            for (int k = 0; k < R / 4; ++k)
                __stcs(reinterpret_cast<uint4*>(p) + k,
                       make_uint4(h[4 * k], h[4 * k + 1], h[4 * k + 2],
                                  h[4 * k + 3]));
            return;
        }
    }
#pragma unroll
    for (int i = 0; i < R; ++i) p[i] = h[i];
}

// a thread's R rows in registers: the running hashes, each column's raw
// key words and validity bytes
template <int C, int S, int R>
struct Rows {
    unsigned h[S][R];
    unsigned w[C][2 * R];
    unsigned v[C][(R + 3) / 4];
};

// every load of rows [r0, r0 + R)
template <int C, int S, int R>
__device__ __forceinline__ void load(const M3Args& a, long long r0, bool vec,
                                     Rows<C, S, R>& x) {
#pragma unroll
    for (int s = 0; s < S; ++s) {
        if (a.seed_in[s] != nullptr) {
            load_rows<R, 4>(
                reinterpret_cast<const unsigned char*>(a.seed_in[s] + r0),
                vec && (a.vec_io >> s & 1), x.h[s]);
        } else {
#pragma unroll
            for (int i = 0; i < R; ++i) x.h[s][i] = a.seed[s];
        }
    }
#pragma unroll
    for (int c = 0; c < C; ++c) {
        load_keys<R>(a.col[c], r0, vec && (a.col[c].vec & 1), x.w[c]);
        if (a.col[c].valid != nullptr)
            load_rows<R, 1>(a.col[c].valid + r0, vec && (a.col[c].vec & 2),
                            x.v[c]);
    }
}

// the chain over the loaded rows, then their stores
template <int C, int S, int R>
__device__ __forceinline__ void finish(const M3Args& a, long long r0,
                                       bool vec, Rows<C, S, R>& x) {
#pragma unroll
    for (int c = 0; c < C; ++c)
        mix_column<R, S>(a.col[c].kind, x.w[c], x.v[c],
                         a.col[c].valid == nullptr, x.h);
#pragma unroll
    for (int s = 0; s < S; ++s)
        store_rows<R>(a.out[s] + r0, vec && (a.vec_io >> (2 + s) & 1),
                      x.h[s]);
}

template <int C, int S>
__global__ void __launch_bounds__(THREADS)
    m3_rows(const __grid_constant__ M3Args a) {
    const long long t = (long long)blockIdx.x * THREADS + threadIdx.x;
    const long long step = (long long)gridDim.x * THREADS;
    const long long chunks = (a.body_end - a.head) / ROWS;
    // the next chunk's loads are in flight while this one mixes and stores
    if (t < chunks) {
        Rows<C, S, ROWS> cur, nxt;
        load(a, a.head + t * ROWS, true, cur);
        for (long long k = t; k < chunks; k += step) {
            if (k + step < chunks)
                load(a, a.head + (k + step) * ROWS, true, nxt);
            finish(a, a.head + k * ROWS, true, cur);
            cur = nxt;
        }
    }
    // the head rows and the ragged tail, one a thread
    if (t < a.head + (a.n - a.body_end)) {
        const long long r = t < a.head ? t : a.body_end + (t - a.head);
        Rows<C, S, 1> x;
        load(a, r, false, x);
        finish(a, r, false, x);
    }
}

#define SHAPES(X) X(1, 1) X(1, 2) X(2, 1) X(2, 2) X(3, 1) X(3, 2) \
    X(4, 1) X(4, 2)

static const void* kernel_of(int ncols, int nseeds) {
#define KERNEL_OF(c, s) \
    if (ncols == c && nseeds == s) return (const void*)m3_rows<c, s>;
    SHAPES(KERNEL_OF)
#undef KERNEL_OF
    return nullptr;
}

// Blocks of the (ncols, nseeds) kernel resident on one SM, and the card's
// SM count: what ops/murmur3_lanes.grid_shape needs.
extern "C" int m3_limits(int ncols, int nseeds, int* blocks_per_sm,
                         int* sms) {
    const void* k = kernel_of(ncols, nseeds);
    if (k == nullptr) return (int)cudaErrorInvalidValue;
    int dev = 0;
    cudaError_t e = cudaGetDevice(&dev);
    if (e == cudaSuccess)
        e = cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess)
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, k,
                                                          THREADS, 0);
    return (int)e;
}

// ncols key columns (data[c], valid[c] or null, kinds[c], vec[c]) of n
// rows into nseeds u32 outputs out[s], each chain starting from seeds[s]
// or, where seed_in[s] is not null, from that per-row plane; rows, head,
// body_end, vec, vec_io and grid from ops/murmur3_lanes.plan (`rows` must
// be this source's ROWS). Returns the launch's CUDA error (0 = none).
extern "C" int m3_run(int ncols, int nseeds, const void* const* data,
                      const void* const* valid, const int* kinds,
                      const int* vec, const void* const* seed_in,
                      void* const* out, const unsigned* seeds, int vec_io,
                      long long n, int rows, long long head,
                      long long body_end, int grid, void* stream) {
    if (n <= 0) return 0;
    if (kernel_of(ncols, nseeds) == nullptr || rows != ROWS || grid <= 0 ||
        head < 0 || head > body_end || body_end > n ||
        (body_end - head) % ROWS != 0)
        return (int)cudaErrorInvalidValue;
    M3Args a = {};
    for (int c = 0; c < ncols; ++c) {
        if (kinds[c] < 0 || kinds[c] >= K_COUNT)
            return (int)cudaErrorInvalidValue;
        a.col[c].data = (const unsigned char*)data[c];
        a.col[c].valid = (const unsigned char*)valid[c];
        a.col[c].kind = kinds[c];
        a.col[c].vec = vec[c];
    }
    for (int s = 0; s < nseeds; ++s) {
        a.seed_in[s] = (const unsigned*)seed_in[s];
        a.out[s] = (unsigned*)out[s];
        a.seed[s] = seeds[s];
    }
    a.vec_io = vec_io;
    a.head = head;
    a.body_end = body_end;
    a.n = n;
    cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(c, s)                                                 \
    if (ncols == c && nseeds == s)                                   \
        m3_rows<c, s><<<grid, THREADS, 0, st>>>(a);
    SHAPES(LAUNCH)
#undef LAUNCH
    return (int)cudaGetLastError();
}

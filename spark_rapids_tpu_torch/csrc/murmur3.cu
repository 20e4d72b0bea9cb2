// Spark's murmur3_x86_32 per row with a per-row running-hash seed, for
// Hopper (sm_90a). Replaces the TPU kernels `_two_word_kernel`
// (`murmur3_long_lanes`) and `_one_word_kernel` (`murmur3_int_lanes`) of
// spark_rapids_tpu/ops/pallas_kernels.py.
//
// Bound: bytes. Each row reads its value (8 or 4 bytes) and its u32 seed
// and writes one u32: 16 or 12 bytes a row against some 20 integer
// operations, far below the H100's operations-per-byte line. At the q3
// build side (524,288 i64 keys) that is 8.4 MB, 2.5 us at 3.35 TB/s.
//
// Design: the TPU kernel streams (256, 128) tiles of two u32 planes (the
// i64 bitcast outside the kernel) through VMEM, one grid step per tile.
// Here one thread owns one row in a grid-stride loop: the i64 load is one
// 8-byte access (the low and high words come from registers), neighbouring
// threads read neighbouring rows, and all arithmetic is u32 wrap-around as
// Spark's Java int arithmetic is.

#include <cuda_runtime.h>

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

__global__ void m3_long(const unsigned long long* __restrict__ data,
                        const unsigned* __restrict__ seed,
                        unsigned* __restrict__ out, long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        const unsigned long long v = data[i];
        unsigned h = mix_h1(seed[i], mix_k1((unsigned)v));
        h = mix_h1(h, mix_k1((unsigned)(v >> 32)));
        out[i] = fmix(h, 8u);
    }
}

__global__ void m3_int(const unsigned* __restrict__ data,
                       const unsigned* __restrict__ seed,
                       unsigned* __restrict__ out, long long n) {
    const long long step = (long long)gridDim.x * blockDim.x;
    for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         i < n; i += step) {
        out[i] = fmix(mix_h1(seed[i], mix_k1(data[i])), 4u);
    }
}

static int blocks_for(long long n, int threads) {
    long long b = (n + threads - 1) / threads;
    // grid-stride beyond 16 blocks per SM of an H100
    return (int)(b < 132 * 16 ? b : 132 * 16);
}

// data: n i64 (m3_long) or n i32 (m3_int); seed, out: n u32. Returns the
// launch's CUDA error (0 = none).
extern "C" int m3_long_run(const void* data, const void* seed, void* out,
                           long long n, void* stream) {
    if (n <= 0) return 0;
    m3_long<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const unsigned long long*)data, (const unsigned*)seed,
        (unsigned*)out, n);
    return (int)cudaGetLastError();
}

extern "C" int m3_int_run(const void* data, const void* seed, void* out,
                          long long n, void* stream) {
    if (n <= 0) return 0;
    m3_int<<<blocks_for(n, 256), 256, 0, (cudaStream_t)stream>>>(
        (const unsigned*)data, (const unsigned*)seed, (unsigned*)out, n);
    return (int)cudaGetLastError();
}

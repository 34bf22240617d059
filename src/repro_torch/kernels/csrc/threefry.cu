// threefry2x32: the hash under the JAX key stream (src/repro_torch/core/prng.py).
//
// No TPU kernel is replaced: JAX computes threefry with XLA's own lowering
// (jax/_src/prng.py, _threefry2x32_lowering), not with Pallas.  The port
// draws the JAX package's noise from it, seed for seed, and the horizon draws
// a K = 1e6 row a round, so it is a kernel of its own.
//
// One call: the key (two uint32 words in device memory, so a carried key is
// advanced on the device with no host sync) is folded by up to four host
// integers (fold_in: the key hashes the counter (d >> 32, d & 0xffffffff)),
// once a block, into shared memory; then thread i hashes counter offset + i,
// split into (hi, lo) words, into the pair (a, b), and the mode's epilogue
// writes the output:
//   kKeys     (n, 2) uint32 pairs (a, b): split(key, n) is offset 0, and a
//             fold_in is one pair at offset d;
//   kBits     a ^ b, the 32 bits of jax.random.bits (partitionable mode);
//   kSortKey  (a ^ b) ^ 0x80000000 as int32: unsigned order as signed, the
//             sort keys of one round of jax.random.permutation;
//   kUniform  float32 in [minval, maxval): the top 23 bits as the mantissa of
//             a float in [1, 2), minus 1, times (maxval - minval) plus
//             minval in one fused multiply-add (one rounding, as XLA fuses
//             jax.random.uniform's), then max with minval;
//   kGumbel   -logf(-logf(u)), u uniform in [FLT_MIN, 1) (jax.random.gumbel,
//             mode "low").
// The plain version is threefry_ref in kernels/ref.py (int64 words, every sum
// taken & 0xffffffff).
//
// Bound on the H100: a hash is 20 rounds of add, rotate (one funnel shift)
// and xor plus 5 key injections of two adds and the two first adds: 32 adds,
// 20 funnel shifts and 20 xors, 72 32-bit integer operations a counter, and
// the output is 4 or 8 bytes a counter.  An SM issues 128 lanes a clock; the
// funnel shifts and xors (SHF, LOP3) run only on its ALU pipe, 64 lanes a
// clock, while an add may issue on the ALU pipe (IADD3) or the FMA pipe
// (IMAD).  So a hash takes at least max(72 / 128, 40 / 64) = 0.625 of an SM
// clock; the bits epilogue's xor makes it 41 / 64.  At 1e6 counters on 132
// SMs at 1.98 GHz that is about 2.5 us, against 4 MB written, about 1.2 us at
// 3.35 TB/s: operations bound it (chip_smoke.py's THREEFRY_OPS and
// THREEFRY_LANES count each epilogue; scripts/threefry_sass.py shows which
// pipe nvcc gives each add).
#include <cfloat>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPath = 4;

enum Mode : int { kKeys = 0, kBits = 1, kSortKey = 2, kUniform = 3, kGumbel = 4 };

struct Path {
    int n;
    uint64_t d[kMaxPath];
};

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

// 20 rounds, JAX's rotations and key schedule.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    x0 += ks[0];
    x1 += ks[1];
#pragma unroll
    for (int i = 0; i < 5; ++i) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = x0 ^ rotl(x1, rot[i & 1][j]);
        }
        x0 += ks[(i + 1) % 3];
        x1 += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
    }
}

__device__ __forceinline__ float uniform(uint32_t bits, float minval, float maxval) {
    const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
    return fmaxf(minval, __fmaf_rn(f, maxval - minval, minval));
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const uint32_t* key, Path path,
                                                            uint64_t offset, int64_t n, float minval, float maxval,
                                                            void* out) {
    // out may be the key itself for one pair (a carried key advanced in
    // place): the one block reads it here, before any thread writes
    __shared__ uint32_t sk[2];
    if (threadIdx.x == 0) {
        uint32_t k0 = key[0], k1 = key[1];
        for (int j = 0; j < path.n; ++j) {
            uint32_t a = static_cast<uint32_t>(path.d[j] >> 32), b = static_cast<uint32_t>(path.d[j]);
            threefry2x32(k0, k1, a, b);
            k0 = a;
            k1 = b;
        }
        sk[0] = k0;
        sk[1] = k1;
    }
    __syncthreads();
    const uint32_t k0 = sk[0], k1 = sk[1];
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
        const uint64_t c = offset + static_cast<uint64_t>(i);
        uint32_t a = static_cast<uint32_t>(c >> 32), b = static_cast<uint32_t>(c);
        threefry2x32(k0, k1, a, b);
        if constexpr (kMode == kKeys) {
            reinterpret_cast<uint2*>(out)[i] = make_uint2(a, b);
        } else if constexpr (kMode == kBits) {
            static_cast<uint32_t*>(out)[i] = a ^ b;
        } else if constexpr (kMode == kSortKey) {
            static_cast<uint32_t*>(out)[i] = (a ^ b) ^ 0x80000000u;
        } else if constexpr (kMode == kUniform) {
            static_cast<float*>(out)[i] = uniform(a ^ b, minval, maxval);
        } else {
            static_cast<float*>(out)[i] = -logf(-logf(uniform(a ^ b, FLT_MIN, 1.0f)));
        }
    }
}

template <int kMode>
cudaError_t launch(const uint32_t* key, const Path& path, uint64_t offset, int64_t n, float minval, float maxval,
                   void* out, cudaStream_t stream) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;  // 16 blocks of 256 threads an SM, then grid-stride
    if (blocks < 1) blocks = 1;
    threefry_kernel<kMode><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(key, path, offset, n, minval,
                                                                                   maxval, out);
    return cudaGetLastError();
}

}  // namespace

// The folds of ``key`` are d0..d3 (the first n_path of them).  Returns a
// cudaError_t (0: launched).
extern "C" int repro_threefry(const void* key, int n_path, int64_t d0, int64_t d1, int64_t d2, int64_t d3,
                              int64_t offset, int64_t n, int mode, float minval, float maxval, void* out,
                              cudaStream_t stream) {
    if (n_path < 0 || n_path > kMaxPath || n < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    Path path{n_path, {static_cast<uint64_t>(d0), static_cast<uint64_t>(d1), static_cast<uint64_t>(d2),
                       static_cast<uint64_t>(d3)}};
    const uint32_t* k = static_cast<const uint32_t*>(key);
    const uint64_t off = static_cast<uint64_t>(offset);
    cudaError_t err;
    switch (mode) {
        case kKeys: err = launch<kKeys>(k, path, off, n, minval, maxval, out, stream); break;
        case kBits: err = launch<kBits>(k, path, off, n, minval, maxval, out, stream); break;
        case kSortKey: err = launch<kSortKey>(k, path, off, n, minval, maxval, out, stream); break;
        case kUniform: err = launch<kUniform>(k, path, off, n, minval, maxval, out, stream); break;
        case kGumbel: err = launch<kGumbel>(k, path, off, n, minval, maxval, out, stream); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}

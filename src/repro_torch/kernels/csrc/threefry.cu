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
//             mode "low");
//   kNormal   sqrt(2) * erf_inv(u), u uniform in [nextafter(-1, 0), 1)
//             (jax.random.normal): erf_inv is XLA's float32 one (Giles'
//             polynomial in w = -log1p(-u * u), two branches), its
//             multiply-adds fused as the CPU backend fuses them (a float64
//             product and sum, rounded once to float32).
// Two more entries:
//   repro_threefry_rows         J Gumbel rows of n under J keys (a (J, 2)
//             tensor), each folded by the same path: row j is block row j,
//             the key folded once a block (a job's Gumbel row,
//             gumbel(fold_in(key_j, t), (n,)), in one launch for J jobs);
//   repro_threefry_categorical  jax.random.categorical over (B, V) logits:
//             argmax_v of gumbel[b * V + v] + logits[b, v], ties to the
//             lowest v, the noise never written.  A row is a cluster of
//             kCluster blocks (Hopper's thread block clusters): each block
//             reduces its columns, then block 0 reads the others' winners from
//             their shared memory (distributed shared memory).  bfloat16
//             logits take JAX's bfloat16 Gumbel: 8 random bits (the low byte
//             of a ^ b), the mantissa their top 7, every operation rounded
//             to bfloat16.
// The original layout (JAX's jax_threefry_partitionable=False), a second
// counter layout of each entry: a draw of m 32-bit words hashes the counter
// pairs (j, j + h), h = ceil(m / 2), j < h (the second counter 0 where j + h
// = m, the odd draw's padding), word j the pair's first output and word j + h
// its second, and a value's 32 bits are its word (no xor).  Thread j hashes
// pair j and writes both words through the mode's epilogue, those of them
// that lie in the launch's words (a launch may write a block of a larger
// draw: normal's large leaves); split(key, n) is the draw of 2n words, key i
// words 2i and 2i + 1 (kKeys writes single words).  The rows entry takes
// each row as a draw of its own; categorical hashes each value's pair and
// keeps its word (bfloat16: value i is byte i % 4 of word i / 4 of a draw of
// ceil(B * V / 4) words).
// The plain version is threefry_ref in kernels/ref.py (int32 words, every sum
// wrapping as uint32 sums do).
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
#include <cmath>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

namespace cg = cooperative_groups;

constexpr int kThreads = 256;
constexpr int kMaxPath = 4;
constexpr int kCluster = 8;       // blocks a categorical row
constexpr int kCatThreads = 512;  // threads a categorical block

enum Mode : int { kKeys = 0, kBits = 1, kSortKey = 2, kUniform = 3, kGumbel = 4, kNormal = 5 };

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

// The key folded by the path, once a block, into shared memory (thread 0
// reads the key before any thread of the block writes).
__device__ __forceinline__ void fold_key(const uint32_t* key, const Path& path, uint32_t* sk) {
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
}

__device__ __forceinline__ float uniform(uint32_t bits, float minval, float maxval) {
    const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
    return fmaxf(minval, __fmaf_rn(f, maxval - minval, minval));
}

// c + p * w rounded once, as a float64 product (exact) and sum
__device__ __forceinline__ float fma64(float p, float w, float c) {
    return static_cast<float>(static_cast<double>(c) + static_cast<double>(p) * static_cast<double>(w));
}

// XLA's float32 erf_inv (ErfInv32): Giles' single-precision polynomial
__device__ __forceinline__ float erf_inv(float x) {
    constexpr float lt[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f, 0.00021858087f,
                             -0.00125372503f, -0.00417768164f, 0.246640727f,    1.50140941f};
    constexpr float gt[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f, 0.00573950773f,
                             -0.0076224613f,   0.00943887047f,  1.00167406f,    2.83297682f};
    float w = -log1pf(-(x * x));
    const bool small = w < 5.0f;
    w = small ? w - 2.5f : sqrtf(w) - 3.0f;
    float p = small ? lt[0] : gt[0];
#pragma unroll
    for (int i = 1; i < 9; ++i) p = fma64(p, w, small ? lt[i] : gt[i]);
    return p * x;
}

template <int kMode>
__device__ __forceinline__ void write(void* out, int64_t i, uint32_t a, uint32_t b, float minval, float maxval) {
    if constexpr (kMode == kKeys) {
        reinterpret_cast<uint2*>(out)[i] = make_uint2(a, b);
    } else if constexpr (kMode == kBits) {
        static_cast<uint32_t*>(out)[i] = a ^ b;
    } else if constexpr (kMode == kSortKey) {
        static_cast<uint32_t*>(out)[i] = (a ^ b) ^ 0x80000000u;
    } else if constexpr (kMode == kUniform) {
        static_cast<float*>(out)[i] = uniform(a ^ b, minval, maxval);
    } else if constexpr (kMode == kGumbel) {
        static_cast<float*>(out)[i] = -logf(-logf(uniform(a ^ b, FLT_MIN, 1.0f)));
    } else {
        static_cast<float*>(out)[i] = 1.41421354f * erf_inv(uniform(a ^ b, -0.99999994f, 1.0f));
    }
}

// A value's output from its word in the original layout (kKeys: the word).
template <int kMode>
__device__ __forceinline__ void write_word(void* out, int64_t i, uint32_t y, float minval, float maxval) {
    if constexpr (kMode == kKeys) {
        static_cast<uint32_t*>(out)[i] = y;
    } else {
        write<kMode>(out, i, y, 0u, minval, maxval);
    }
}

// The original layout's pair j of a draw of m words (h = ceil(m / 2)):
// (y0, y1) = threefry2x32 of (j, j + h), the second counter 0 past the end.
__device__ __forceinline__ void orig_pair(uint32_t k0, uint32_t k1, uint64_t j, uint64_t h, uint64_t m, uint32_t& y0,
                                          uint32_t& y1) {
    y0 = static_cast<uint32_t>(j);
    y1 = j + h < m ? static_cast<uint32_t>(j + h) : 0u;
    threefry2x32(k0, k1, y0, y1);
}

// Word w of a draw of m words in the original layout (one hash of its pair).
__device__ __forceinline__ uint32_t orig_word(uint32_t k0, uint32_t k1, uint64_t w, uint64_t m) {
    const uint64_t h = (m + 1) / 2;
    uint32_t y0, y1;
    orig_pair(k0, k1, w < h ? w : w - h, h, m, y0, y1);
    return w < h ? y0 : y1;
}

// One launch's words [w_lo, w_hi) of an original-layout draw of m words:
// the pairs [p_lo, p_hi) hold them.
struct Orig {
    uint64_t m, h, w_lo, w_hi, p_lo, p_hi;
};

template <int kMode>
__global__ void __launch_bounds__(kThreads) threefry_orig_kernel(const uint32_t* key, Path path, Orig o, float minval,
                                                                 float maxval, void* out) {
    __shared__ uint32_t sk[2];
    fold_key(key, path, sk);
    const uint32_t k0 = sk[0], k1 = sk[1];
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    const int64_t n_pairs = static_cast<int64_t>(o.p_hi - o.p_lo);
    for (int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; t < n_pairs; t += stride) {
        const uint64_t j = o.p_lo + static_cast<uint64_t>(t), w1 = j + o.h;
        const bool in0 = j >= o.w_lo && j < o.w_hi, in1 = w1 < o.m && w1 >= o.w_lo && w1 < o.w_hi;
        if (!in0 && !in1) continue;
        uint32_t y0, y1;
        orig_pair(k0, k1, j, o.h, o.m, y0, y1);
        if (in0) write_word<kMode>(out, static_cast<int64_t>(j - o.w_lo), y0, minval, maxval);
        if (in1) write_word<kMode>(out, static_cast<int64_t>(w1 - o.w_lo), y1, minval, maxval);
    }
}

template <int kMode>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const uint32_t* key, Path path,
                                                            uint64_t offset, int64_t n, float minval, float maxval,
                                                            void* out) {
    // out may be the key itself for one pair (a carried key advanced in
    // place): the one block reads it in fold_key, before any thread writes
    __shared__ uint32_t sk[2];
    fold_key(key, path, sk);
    const uint32_t k0 = sk[0], k1 = sk[1];
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
        const uint64_t c = offset + static_cast<uint64_t>(i);
        uint32_t a = static_cast<uint32_t>(c >> 32), b = static_cast<uint32_t>(c);
        threefry2x32(k0, k1, a, b);
        write<kMode>(out, i, a, b, minval, maxval);
    }
}

// Row blockIdx.y: the Gumbel draws of counters 0 .. n-1 under
// keys[blockIdx.y] folded by the path; kOrig: the row's draw of n in the
// original layout, thread j writing values j and j + h.
template <bool kOrig>
__global__ void __launch_bounds__(kThreads) threefry_rows_kernel(const uint32_t* keys, Path path, int64_t n,
                                                                 float* out) {
    __shared__ uint32_t sk[2];
    const int64_t row = blockIdx.y;
    fold_key(keys + 2 * row, path, sk);
    const uint32_t k0 = sk[0], k1 = sk[1];
    float* base = out + row * n;
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    const int64_t h = kOrig ? (n + 1) / 2 : n;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < h; i += stride) {
        if constexpr (kOrig) {
            uint32_t y0, y1;
            orig_pair(k0, k1, static_cast<uint64_t>(i), h, n, y0, y1);
            write<kGumbel>(base, i, y0, 0u, 0.0f, 1.0f);
            if (i + h < n) write<kGumbel>(base, i + h, y1, 0u, 0.0f, 1.0f);
        } else {
            const uint64_t c = static_cast<uint64_t>(i);
            uint32_t a = static_cast<uint32_t>(c >> 32), b = static_cast<uint32_t>(c);
            threefry2x32(k0, k1, a, b);
            write<kGumbel>(base, i, a, b, 0.0f, 1.0f);
        }
    }
}

__device__ __forceinline__ float bf16_round(float x) {  // to bfloat16, nearest even (x finite or inf)
    uint32_t u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return x;  // NaN stays NaN
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
}

// (v, i) beats (w, j): a NaN beats any number (JAX's and torch's argmax
// take the first NaN), a larger value beats a smaller, equal values go to
// the lower index
__device__ __forceinline__ bool beats(float v, int64_t i, float w, int64_t j) {
    const bool vn = v != v, wn = w != w;
    if (vn != wn) return vn;
    if (!vn && v != w) return v > w;
    return i < j;
}

template <bool kBf16, bool kOrig>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kCatThreads)
    categorical_kernel(const uint32_t* key, Path path, const void* logits, int64_t V, int32_t* out) {
    __shared__ uint32_t sk[2];
    __shared__ float warp_v[kCatThreads / 32];
    __shared__ int64_t warp_i[kCatThreads / 32];
    __shared__ float block_v;
    __shared__ int64_t block_i;
    cg::cluster_group cluster = cg::this_cluster();
    fold_key(key, path, sk);
    const uint32_t k0 = sk[0], k1 = sk[1];
    const int64_t row = blockIdx.y;
    const unsigned rank = cluster.block_rank();
    float best = -INFINITY;
    int64_t at = V;  // no column yet: any column beats it
    for (int64_t v = static_cast<int64_t>(rank) * kCatThreads + threadIdx.x; v < V;
         v += static_cast<int64_t>(kCluster) * kCatThreads) {
        const uint64_t c = static_cast<uint64_t>(row * V + v);
        uint32_t a, b = 0u;  // the value's bits are a ^ b
        if constexpr (kOrig) {
            const uint64_t n = static_cast<uint64_t>(gridDim.y) * static_cast<uint64_t>(V);
            a = kBf16 ? orig_word(k0, k1, c / 4, (n + 3) / 4) >> (8 * (c % 4)) : orig_word(k0, k1, c, n);
        } else {
            a = static_cast<uint32_t>(c >> 32);
            b = static_cast<uint32_t>(c);
            threefry2x32(k0, k1, a, b);
        }
        float s;
        if constexpr (kBf16) {
            const uint32_t bits8 = (a ^ b) & 0xffu;
            const float f = __uint_as_float(((bits8 >> 1) << 16) | 0x3f800000u) - 1.0f;  // exact in bfloat16
            const float u = fmaxf(FLT_MIN, bf16_round(f + FLT_MIN));
            const float g = -bf16_round(logf(-bf16_round(logf(u))));
            const uint16_t lb = static_cast<const uint16_t*>(logits)[row * V + v];
            s = bf16_round(g + __uint_as_float(static_cast<uint32_t>(lb) << 16));
        } else {
            s = -logf(-logf(uniform(a ^ b, FLT_MIN, 1.0f))) + static_cast<const float*>(logits)[row * V + v];
        }
        if (beats(s, v, best, at)) {
            best = s;
            at = v;
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int64_t oi = __shfl_down_sync(0xffffffffu, at, off);
        if (beats(ov, oi, best, at)) {
            best = ov;
            at = oi;
        }
    }
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    if (lane == 0) {
        warp_v[warp] = best;
        warp_i[warp] = at;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        for (int w = 1; w < kCatThreads / 32; ++w) {
            if (beats(warp_v[w], warp_i[w], best, at)) {
                best = warp_v[w];
                at = warp_i[w];
            }
        }
        block_v = best;
        block_i = at;
    }
    cluster.sync();  // every block's winner is in its shared memory
    if (rank == 0 && threadIdx.x == 0) {
        for (unsigned r = 1; r < kCluster; ++r) {
            const float rv = *cluster.map_shared_rank(&block_v, r);
            const int64_t ri = *cluster.map_shared_rank(&block_i, r);
            if (beats(rv, ri, best, at)) {
                best = rv;
                at = ri;
            }
        }
        out[row] = static_cast<int32_t>(at);
    }
    cluster.sync();  // no block leaves while block 0 reads its shared memory
}

int blocks_for(int64_t n, int64_t rows) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    int64_t cap = (132 * 16) / (rows > 0 ? rows : 1);  // 16 blocks of 256 threads an SM, then grid-stride
    if (cap < 1) cap = 1;
    if (blocks > cap) blocks = cap;
    return static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <int kMode>
cudaError_t launch(const uint32_t* key, const Path& path, uint64_t offset, int64_t n, int64_t total, float minval,
                   float maxval, void* out, cudaStream_t stream) {
    if (total == 0) {
        threefry_kernel<kMode><<<blocks_for(n, 1), kThreads, 0, stream>>>(key, path, offset, n, minval, maxval, out);
        return cudaGetLastError();
    }
    // the original layout: the words [w_lo, w_hi) of a draw of m (a key is two)
    const uint64_t per = kMode == kKeys ? 2 : 1;
    Orig o;
    o.m = per * static_cast<uint64_t>(total);
    o.h = (o.m + 1) / 2;
    o.w_lo = per * offset;
    o.w_hi = o.w_lo + per * static_cast<uint64_t>(n);
    // the pairs of the words below h, and of those from h on
    const uint64_t a_hi = o.w_hi < o.h ? o.w_hi : o.h, b_lo = (o.w_lo > o.h ? o.w_lo : o.h) - o.h;
    const bool a = o.w_lo < a_hi, b = o.w_hi > o.h;
    o.p_lo = a ? o.w_lo : b_lo;
    o.p_hi = b ? o.w_hi - o.h : a_hi;
    if (a && b && b_lo < o.p_lo) o.p_lo = b_lo;
    if (a && b && a_hi > o.p_hi) o.p_hi = a_hi;
    const int64_t pairs = static_cast<int64_t>(o.p_hi - o.p_lo);
    threefry_orig_kernel<kMode><<<blocks_for(pairs, 1), kThreads, 0, stream>>>(key, path, o, minval, maxval, out);
    return cudaGetLastError();
}

Path make_path(int n_path, int64_t d0, int64_t d1, int64_t d2, int64_t d3) {
    return Path{n_path, {static_cast<uint64_t>(d0), static_cast<uint64_t>(d1), static_cast<uint64_t>(d2),
                         static_cast<uint64_t>(d3)}};
}

}  // namespace

// The folds of ``key`` are d0..d3 (the first n_path of them).  ``total``
// 0: the partitionable layout, counters offset .. offset + n - 1; else the
// original layout, values offset .. offset + n - 1 of a draw of ``total``
// (keys for kKeys), at most 2**32 - 1 words.  Returns a cudaError_t (0:
// launched).
extern "C" int repro_threefry(const void* key, int n_path, int64_t d0, int64_t d1, int64_t d2, int64_t d3,
                              int64_t offset, int64_t n, int64_t total, int mode, float minval, float maxval,
                              void* out, cudaStream_t stream) {
    if (n_path < 0 || n_path > kMaxPath || n < 0 || total < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (total > 0 && (offset < 0 || offset + n > total || (mode == kKeys ? 2 : 1) * total > INT64_C(0xffffffff)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    const Path path = make_path(n_path, d0, d1, d2, d3);
    const uint32_t* k = static_cast<const uint32_t*>(key);
    const uint64_t off = static_cast<uint64_t>(offset);
    cudaError_t err;
    switch (mode) {
        case kKeys: err = launch<kKeys>(k, path, off, n, total, minval, maxval, out, stream); break;
        case kBits: err = launch<kBits>(k, path, off, n, total, minval, maxval, out, stream); break;
        case kSortKey: err = launch<kSortKey>(k, path, off, n, total, minval, maxval, out, stream); break;
        case kUniform: err = launch<kUniform>(k, path, off, n, total, minval, maxval, out, stream); break;
        case kGumbel: err = launch<kGumbel>(k, path, off, n, total, minval, maxval, out, stream); break;
        case kNormal: err = launch<kNormal>(k, path, off, n, total, minval, maxval, out, stream); break;
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(err);
}

// ``rows`` Gumbel rows of ``n`` under the (rows, 2) keys, each folded by
// d0..d3; ``out`` is (rows, n) float32; ``original``: each row's draw in the
// original layout.
extern "C" int repro_threefry_rows(const void* keys, int64_t rows, int n_path, int64_t d0, int64_t d1, int64_t d2,
                                   int64_t d3, int64_t n, int original, void* out, cudaStream_t stream) {
    if (n_path < 0 || n_path > kMaxPath || n < 0 || rows < 0 || rows > 65535 || (original && n > INT64_C(0xffffffff)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0 || rows == 0) return 0;
    const Path path = make_path(n_path, d0, d1, d2, d3);
    const uint32_t* k = static_cast<const uint32_t*>(keys);
    if (original) {
        const dim3 grid(blocks_for((n + 1) / 2, rows), static_cast<unsigned>(rows));
        threefry_rows_kernel<true><<<grid, kThreads, 0, stream>>>(k, path, n, static_cast<float*>(out));
    } else {
        const dim3 grid(blocks_for(n, rows), static_cast<unsigned>(rows));
        threefry_rows_kernel<false><<<grid, kThreads, 0, stream>>>(k, path, n, static_cast<float*>(out));
    }
    return static_cast<int>(cudaGetLastError());
}

// ``out[b]`` (int32) = argmax_v gumbel(key folded by d0..d3, (B, V))[b, v]
// + logits[b, v]; ``bf16`` says the logits are bfloat16 (else float32);
// ``original``: the noise in the original layout.
extern "C" int repro_threefry_categorical(const void* key, int n_path, int64_t d0, int64_t d1, int64_t d2,
                                          int64_t d3, const void* logits, int64_t B, int64_t V, int bf16,
                                          int original, void* out, cudaStream_t stream) {
    if (n_path < 0 || n_path > kMaxPath || B < 0 || B > 65535 || V < 1 || V > INT32_MAX ||
        (original && (bf16 ? (B * V + 3) / 4 : B * V) > INT64_C(0xffffffff)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const Path path = make_path(n_path, d0, d1, d2, d3);
    const uint32_t* k = static_cast<const uint32_t*>(key);
    const dim3 grid(kCluster, static_cast<unsigned>(B));
    int32_t* o = static_cast<int32_t*>(out);
    if (bf16 && original) {
        categorical_kernel<true, true><<<grid, kCatThreads, 0, stream>>>(k, path, logits, V, o);
    } else if (bf16) {
        categorical_kernel<true, false><<<grid, kCatThreads, 0, stream>>>(k, path, logits, V, o);
    } else if (original) {
        categorical_kernel<false, true><<<grid, kCatThreads, 0, stream>>>(k, path, logits, V, o);
    } else {
        categorical_kernel<false, false><<<grid, kCatThreads, 0, stream>>>(k, path, logits, V, o);
    }
    return static_cast<int>(cudaGetLastError());
}

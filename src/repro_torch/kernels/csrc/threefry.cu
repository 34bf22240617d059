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
// once a block, into shared memory; then counter offset + i (kPer of them a
// thread), split into (hi, lo) words, is hashed into the pair (a, b), and
// the mode's epilogue writes the output:
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
//             lowest v, the noise never written: the B x V values over
//             every SM, the rows' winners met by atomics and written by the
//             block that ends last (categorical_kernel, below).  bfloat16
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
// ceil(B * V / 4) words).  A draw of kBlock = 2**32 - 1 words or more is
// JAX's blocked draw (_threefry_random_bits_original): with nblocks, rem =
// divmod(m, kBlock), the key is split into nblocks + 1 keys (the original
// layout's split: a draw of 2 (nblocks + 1) words), block b < nblocks is the
// draw of kBlock words under key b (an odd count: its last pair is padded)
// and the last block the draw of rem words under the last key, the blocks
// concatenated; a launch's words may span blocks (the draw kernel's
// blockIdx.y is the block), and the rows and categorical entries refuse
// such a draw (a row or a logits array of 16 GB or more).
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
//
// The draw kernels (threefry_kernel, threefry_orig_kernel) as redesigned from
// a profile on the H100 (scripts/threefry_times.py --probes; PERF.md, section
// 6).  A draw of 1e6 values spent its time in four parts: a kernel
// node's own cost (1.3 us), the stores of a grid of twice the threads an SM
// holds, one 4-byte store a thread an iteration (1.9 us above the node), the
// prologue (thread 0 of each of 2112 blocks hashing the key's folds in
// series while the block waits at a barrier: 0.9 us for two folds) and the
// loop's instructions (127 a counter where the hash needs 72: 64-bit index
// arithmetic, loop control, the path read from local memory).  So:
//   * a thread takes kPer = 4 counters (pairs in the original layout), their
//     hashes unrolled side by side on 32-bit counters (one 64-bit add a
//     group; a group whose low words would wrap takes a loop of its own),
//     and writes each run of four values as one 16-byte store where the
//     output is aligned (4-byte stores took twice the time);
//   * the key is folded once a block: warp 0 reads and folds it (every lane
//     the same hashes, the path's folds unrolled from kernel parameters, no
//     local memory), the block waits once;
//   * each is a programmatic dependent launch: its grid may launch while the
//     kernel before it on the stream ends, and every thread waits on
//     griddepcontrol.wait (that grid done, its writes visible) before it
//     reads or writes memory, so stream order holds (a key advanced in place
//     by the launch before is read after it is written);
//   * normal's erf_inv branches on w < 5 and reads each side's coefficients
//     from constant memory as float64, each multiply-add one float64 fused
//     multiply-add: the product of two float32 is exact in float64, so the
//     result is the same double as the product then the sum, without the
//     conversion of a selected float32 coefficient (conversions run 16 a
//     clock an SM) or the float64 multiply.
// The counters a thread (8 and 16 were slower in the original layout), the
// programmatic launch and the 16-byte stores were chosen by timing variants of
// this file on the H100 (PERF.md, section 6).
//
// The rows and categorical kernels as redesigned from a profile on the H100
// (PERF.md, section 6: scripts/threefry_times.py --probes, and
// scripts/threefry_sass.py).  Rows hashed one counter a thread with scalar
// stores and no programmatic launch; it now takes the draw kernels' design,
// its groups shifted a row so that rows of odd n store vectors too.
// Categorical put a row on a cluster of 8 blocks of 512 threads: 32 blocks on
// 132 SMs at B = 4, a hash for each bfloat16 value of the original layout
// (where one gives 8 values), two logf and four roundings a bfloat16 value,
// 2-byte loads; now every SM takes the flat B x V values in groups of one
// 16-byte load, bfloat16 Gumbels come from a table, a hash gives both its
// words' values, and the rows meet across blocks by 64-bit atomics.
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxPath = 4;
constexpr int kPer = 4;  // counters (pairs in the original layout) a thread of a draw kernel
constexpr uint64_t kBlock = UINT64_C(0xffffffff);  // the most words of one original-layout draw

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

__device__ __forceinline__ float uniform(uint32_t bits, float minval, float maxval) {
    const float f = __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f;
    return fmaxf(minval, __fmaf_rn(f, maxval - minval, minval));
}

// XLA's float32 erf_inv coefficients (ErfInv32: Giles' for w < 5, then for w
// >= 5), widened to float64 exactly: in constant memory, so that each
// multiply-add reads its coefficient as an operand (no conversion, no move)
__constant__ double kErfInvCoef[2][9] = {
    {2.81022636e-08f, 3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f, 0.00021858087f, -0.00125372503f,
     -0.00417768164f, 0.246640727f, 1.50140941f},
    {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f, 0.00573950773f, -0.0076224613f,
     0.00943887047f, 1.00167406f, 2.83297682f}};

// Giles' polynomial in w with coefficients kErfInvCoef[kBranch], each
// multiply-add c + p * w rounded once to float32 from a float64 fused
// multiply-add (the float64 product of two float32 is exact, so it is the
// same double as the product then the sum)
template <int kBranch>
__device__ __forceinline__ float giles(float w) {
    const double wd = static_cast<double>(w);
    double p = kErfInvCoef[kBranch][0];
    float pf = 0.0f;
#pragma unroll
    for (int i = 1; i < 9; ++i) {
        pf = static_cast<float>(__fma_rn(p, wd, kErfInvCoef[kBranch][i]));
        p = static_cast<double>(pf);
    }
    return pf;
}

// XLA's float32 erf_inv (ErfInv32): Giles' single-precision polynomial in w
// = -log1p(-x * x), w - 2.5 below 5 and sqrt(w) - 3 above (a branch, so that
// each side's coefficients are constants)
__device__ __forceinline__ float erf_inv(float x) {
    const float w = -log1pf(-(x * x));
    return (w < 5.0f ? giles<0>(w - 2.5f) : giles<1>(sqrtf(w) - 3.0f)) * x;
}

// A value's 32 output bits from its 32 random bits (keys and bits: the bits).
template <int kMode>
__device__ __forceinline__ uint32_t value(uint32_t bits, float minval, float maxval) {
    if constexpr (kMode == kKeys || kMode == kBits) {
        return bits;
    } else if constexpr (kMode == kSortKey) {
        return bits ^ 0x80000000u;
    } else if constexpr (kMode == kUniform) {
        return __float_as_uint(uniform(bits, minval, maxval));
    } else if constexpr (kMode == kGumbel) {
        return __float_as_uint(-logf(-logf(uniform(bits, FLT_MIN, 1.0f))));
    } else {
        return __float_as_uint(1.41421354f * erf_inv(uniform(bits, -0.99999994f, 1.0f)));
    }
}

template <int kMode>
__device__ __forceinline__ void write(void* out, int64_t i, uint32_t a, uint32_t b, float minval, float maxval) {
    if constexpr (kMode == kKeys) {
        reinterpret_cast<uint2*>(out)[i] = make_uint2(a, b);
    } else {
        static_cast<uint32_t*>(out)[i] = value<kMode>(a ^ b, minval, maxval);
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

// A kernel's key: the launch's key folded by the path, once a block.
// Warp 0 reads the key and folds it (every lane the same hashes, so no lane
// diverges; the folds unrolled over the path's parameters), the block waits
// once.  With ``split`` (a blocked original-layout draw) the folded key is
// then split into split.n keys and the block takes key split.b: words 2b and
// 2b + 1 of the original layout's draw of 2n words.
struct Split {
    uint64_t n, b;  // n = 0: no split
};

__device__ __forceinline__ void draw_key(const uint32_t* key, const Path& path, Split split, uint32_t& k0,
                                         uint32_t& k1) {
    __shared__ uint32_t sk[2];
    if (threadIdx.x < 32) {
        uint32_t a0 = key[0], a1 = key[1];
#pragma unroll
        for (int j = 0; j < kMaxPath; ++j) {
            if (j < path.n) {
                uint32_t a = static_cast<uint32_t>(path.d[j] >> 32), b = static_cast<uint32_t>(path.d[j]);
                threefry2x32(a0, a1, a, b);
                a0 = a;
                a1 = b;
            }
        }
        if (split.n) {
            const uint32_t f0 = a0, f1 = a1;
            a0 = orig_word(f0, f1, 2 * split.b, 2 * split.n);
            a1 = orig_word(f0, f1, 2 * split.b + 1, 2 * split.n);
        }
        if (threadIdx.x == 0) {
            sk[0] = a0;
            sk[1] = a1;
        }
    }
    __syncthreads();
    k0 = sk[0];
    k1 = sk[1];
}

// The output's kPer values from index i of n (kVec: at a 16-byte aligned
// address, as four-value vectors): whole groups store without a check.
template <bool kVec>
__device__ __forceinline__ void store_group(void* out, int64_t i, int64_t n, const uint32_t (&v)[kPer]) {
    uint32_t* o = static_cast<uint32_t*>(out) + i;
    if (i + kPer <= n) {
        if constexpr (kVec) {
#pragma unroll
            for (int j = 0; j < kPer; j += 4) *reinterpret_cast<uint4*>(o + j) = make_uint4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        } else {
#pragma unroll
            for (int j = 0; j < kPer; ++j) o[j] = v[j];
        }
    } else {
#pragma unroll
        for (int j = 0; j < kPer; ++j)
            if (i + j < n) o[j] = v[j];
    }
}

// The partitionable layout: counters offset .. offset + n - 1, thread group g
// hashing counters offset + kPer g .. (kVec: out 16-byte aligned).
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads) threefry_kernel(const uint32_t* key, Path path, uint64_t offset,
                                                            int64_t n, float minval, float maxval, void* out) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    // out may be the key itself for one pair (a carried key advanced in
    // place): warp 0 reads it in draw_key, before the barrier, and the one
    // write comes after it
    uint32_t k0, k1;
    draw_key(key, path, Split{0, 0}, k0, k1);
    const int64_t groups = (n + kPer - 1) / kPer, stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups; g += stride) {
        const int64_t i = g * kPer;
        const uint64_t c = offset + static_cast<uint64_t>(i);
        const uint32_t lo = static_cast<uint32_t>(c), hi = static_cast<uint32_t>(c >> 32);
        uint32_t a[kPer], b[kPer];
        if (lo <= 0xffffffffu - (kPer - 1)) {  // the group's low words do not wrap
#pragma unroll
            for (int j = 0; j < kPer; ++j) {
                a[j] = hi;
                b[j] = lo + j;
                threefry2x32(k0, k1, a[j], b[j]);
            }
        } else {
#pragma unroll 1
            for (int j = 0; j < kPer; ++j) {
                a[j] = static_cast<uint32_t>((c + j) >> 32);
                b[j] = static_cast<uint32_t>(c + j);
                threefry2x32(k0, k1, a[j], b[j]);
            }
        }
        if constexpr (kMode == kKeys) {
#pragma unroll
            for (int j = 0; j < kPer; ++j)
                if (i + j < n) write<kKeys>(out, i + j, a[j], b[j], minval, maxval);
        } else {
            uint32_t v[kPer];
#pragma unroll
            for (int j = 0; j < kPer; ++j) v[j] = value<kMode>(a[j] ^ b[j], minval, maxval);
            store_group<kVec>(out, i, n, v);
        }
    }
}

// One launch of the original layout: the words [w_lo, w_hi) of a draw of
// total words (2 a key for kKeys), out[0] being word w_lo; blocks of kBlock
// words under split keys where total >= kBlock (nblocks full ones), the
// launch's draw block b_lo + blockIdx.y.
struct Orig {
    uint64_t total, w_lo, w_hi, nblocks, b_lo;
};

// Thread group g of a draw block takes its pairs p_lo + kPer g ..: pair j
// hashes (j, j + h) and writes word j (half A) and word j + h (half B), each
// where it lies in the launch's words (kVec: both halves' stores at 16-byte
// aligned addresses).
template <int kMode, bool kVec>
__global__ void __launch_bounds__(kThreads) threefry_orig_kernel(const uint32_t* key, Path path, Orig o, float minval,
                                                                 float maxval, void* out) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const uint64_t b = o.b_lo + blockIdx.y, base = b * kBlock;  // the draw block and its first word
    uint32_t k0, k1;
    draw_key(key, path, Split{o.nblocks ? o.nblocks + 1 : 0, b}, k0, k1);
    const uint64_t m = o.nblocks == 0 ? o.total : b < o.nblocks ? kBlock : o.total - o.nblocks * kBlock;
    const uint64_t h = (m + 1) / 2;
    // the block's words of the launch, local to the draw block: [lo, hi)
    const uint64_t lo = (o.w_lo > base ? o.w_lo : base) - base, hi = (o.w_hi < base + m ? o.w_hi : base + m) - base;
    if (hi <= lo) return;
    // half A: words [lo, min(hi, h)) are pairs [lo, min(hi, h)); half B: words
    // [max(lo, h), hi) are pairs [max(lo, h) - h, hi - h)
    const uint64_t a_lo = lo, a_hi = hi < h ? hi : h, b_lo = (lo > h ? lo : h) - h, b_hi = hi > h ? hi - h : 0;
    // the pairs to hash: both halves' ranges as one where they overlap, else
    // each apart (a range of words across the halves hashes only its pairs)
    uint64_t r0_lo = a_lo, r0_hi = a_hi, r1_lo = b_lo, r1_hi = b_hi;
    if (a_hi <= a_lo) r0_lo = r0_hi = 0;
    if (b_hi <= b_lo) r1_lo = r1_hi = 0;
    if (r0_hi > r0_lo && r1_hi > r1_lo && r1_lo <= r0_hi && r0_lo <= r1_hi) {
        r0_lo = r0_lo < r1_lo ? r0_lo : r1_lo;
        r0_hi = r0_hi > r1_hi ? r0_hi : r1_hi;
        r1_lo = r1_hi = 0;
    }
    const int64_t g0 = static_cast<int64_t>((r0_hi - r0_lo + kPer - 1) / kPer);
    const int64_t groups = g0 + static_cast<int64_t>((r1_hi - r1_lo + kPer - 1) / kPer);
    // out index of local word w: w + shift (base - w_lo, as two's complement)
    const int64_t shift = static_cast<int64_t>(base - o.w_lo);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups; g += stride) {
        const uint32_t j0 = static_cast<uint32_t>(g < g0 ? r0_lo + static_cast<uint64_t>(g) * kPer
                                                         : r1_lo + static_cast<uint64_t>(g - g0) * kPer);  // < 2**31
        uint32_t y0[kPer], y1[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) {
            y0[j] = j0 + j;
            y1[j] = j0 + j + h < m ? static_cast<uint32_t>(j0 + j + h) : 0u;
            threefry2x32(k0, k1, y0[j], y1[j]);
        }
        uint32_t v[kPer];
        // half A: words j0 .. j0 + kPer - 1 where they lie in [a_lo, a_hi)
        if (j0 + kPer > a_lo && j0 < a_hi) {
#pragma unroll
            for (int j = 0; j < kPer; ++j) v[j] = value<kMode>(y0[j], minval, maxval);
            if (j0 >= a_lo && j0 + kPer <= a_hi) {
                store_group<kVec>(out, static_cast<int64_t>(j0) + shift, INT64_MAX, v);
            } else {
#pragma unroll
                for (int j = 0; j < kPer; ++j)
                    if (j0 + j >= a_lo && j0 + j < a_hi) static_cast<uint32_t*>(out)[j0 + j + shift] = v[j];
            }
        }
        // half B: words j0 + h .. where pairs j0 .. lie in [b_lo, b_hi)
        if (j0 + kPer > b_lo && j0 < b_hi) {
#pragma unroll
            for (int j = 0; j < kPer; ++j) v[j] = value<kMode>(y1[j], minval, maxval);
            const int64_t at = static_cast<int64_t>(j0 + h) + shift;
            if (j0 >= b_lo && j0 + kPer <= b_hi) {
                store_group<kVec>(out, at, INT64_MAX, v);
            } else {
#pragma unroll
                for (int j = 0; j < kPer; ++j)
                    if (j0 + j >= b_lo && j0 + j < b_hi) static_cast<uint32_t*>(out)[at + j] = v[j];
            }
        }
    }
}

// The rows kernel: row blockIdx.y is the Gumbel draw of n under
// keys[blockIdx.y] folded by the path (kOrig: the row's draw of n in the
// original layout).  As the draw kernel: thread group g takes kPer counters
// (pairs), hashed side by side, and stores them as one 16-byte vector where
// the output is aligned.  A row of n floats starts at any 4-byte offset (n
// may be odd), so each row's groups are shifted by the row's offset from
// 16-byte alignment, s: group g takes counters (pairs) kPer g - s .., the
// first group the s values before the row's first aligned one.  In the
// original layout the second half, word j + h of pair j, stores vectors too
// where h is a multiple of 4.
template <bool kOrig>
__global__ void __launch_bounds__(kThreads) threefry_rows_kernel(const uint32_t* keys, Path path, int64_t n,
                                                                 float* out) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    const int64_t row = blockIdx.y;
    uint32_t k0, k1;
    draw_key(keys + 2 * row, path, Split{0, 0}, k0, k1);
    float* base = out + row * n;
    const int s = static_cast<int>((reinterpret_cast<uintptr_t>(base) / 4) % kPer);
    const int64_t h = kOrig ? (n + 1) / 2 : n;  // pairs, or counters
    const int64_t groups = (h + s + kPer - 1) / kPer, stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups; g += stride) {
        const int64_t i0 = g * kPer - s;  // the group's first counter (pair); -s .. -1 lie before the row
        const bool whole = i0 >= 0 && i0 + kPer <= h;
        uint32_t a[kPer], b[kPer];
        if constexpr (kOrig) {
#pragma unroll
            for (int j = 0; j < kPer; ++j) {  // pairs below 2**31: 32-bit counters
                const uint32_t p = static_cast<uint32_t>(i0 + j);
                a[j] = p;
                b[j] = i0 + j + h < n ? static_cast<uint32_t>(i0 + j + h) : 0u;
                threefry2x32(k0, k1, a[j], b[j]);
            }
        } else {
            const uint64_t c = static_cast<uint64_t>(i0 < 0 ? 0 : i0);
            const uint32_t lo = static_cast<uint32_t>(c), hi = static_cast<uint32_t>(c >> 32);
            if (i0 >= 0 && lo <= 0xffffffffu - (kPer - 1)) {  // the group's low words do not wrap
#pragma unroll
                for (int j = 0; j < kPer; ++j) {
                    a[j] = hi;
                    b[j] = lo + j;
                    threefry2x32(k0, k1, a[j], b[j]);
                }
            } else {
#pragma unroll 1
                for (int j = 0; j < kPer; ++j) {
                    const uint64_t cj = static_cast<uint64_t>(i0 + j);
                    a[j] = static_cast<uint32_t>(cj >> 32);
                    b[j] = static_cast<uint32_t>(cj);
                    threefry2x32(k0, k1, a[j], b[j]);
                }
            }
        }
        uint32_t v[kPer];
#pragma unroll
        for (int j = 0; j < kPer; ++j) v[j] = value<kGumbel>(kOrig ? a[j] : a[j] ^ b[j], 0.0f, 1.0f);
        if (whole) {
            store_group<true>(base, i0, INT64_MAX, v);
        } else {
#pragma unroll
            for (int j = 0; j < kPer; ++j)
                if (i0 + j >= 0 && i0 + j < h) reinterpret_cast<uint32_t*>(base)[i0 + j] = v[j];
        }
        if constexpr (kOrig) {  // the second half: word p + h of pair p, where p + h < n
#pragma unroll
            for (int j = 0; j < kPer; ++j) v[j] = value<kGumbel>(b[j], 0.0f, 1.0f);
            if (whole && i0 + kPer + h <= n && h % kPer == 0) {
                store_group<true>(base, i0 + h, INT64_MAX, v);
            } else {
#pragma unroll
                for (int j = 0; j < kPer; ++j)
                    if (i0 + j >= 0 && i0 + j + h < n) reinterpret_cast<uint32_t*>(base)[i0 + j + h] = v[j];
            }
        }
    }
}

__device__ __forceinline__ float bf16_round(float x) {  // to bfloat16, nearest even (x finite or inf)
    uint32_t u = __float_as_uint(x);
    if ((u & 0x7fffffffu) > 0x7f800000u) return x;  // NaN stays NaN
    u += 0x7fffu + ((u >> 16) & 1u);
    return __uint_as_float(u & 0xffff0000u);
}

// The categorical kernel: the B x V values are one flat run, value c = b V +
// v (the counter of the partitionable layout and the index into the draw of
// the original one, as JAX's gumbel(key, (B, V)) has it), cut into groups
// of kCatGroup values (kCatGroup / 4 original-layout pairs, both their
// words), a group a thread, every block at once.  A value's score is its
// Gumbel draw plus its logit; each thread keeps its best (row, column,
// score), the block meets on them, one 64-bit atomicMax a row and block
// puts the winners into g_best, and the block that draws the last ticket
// writes each row's index and resets g_best and the ticket for the next
// launch (a replayed graph).  The key orders as the argmax: the score's bits
// made monotone (every NaN above +inf, -0.0 as +0.0) above the complement of
// the column (ties to the lowest).  Calls on one device run in stream order
// (each kernel waits on griddepcontrol.wait before it touches memory): calls
// on two streams at once would share the scratch.
//
// bfloat16 logits take JAX's bfloat16 Gumbel, a function of the top 7 of a
// value's 8 random bits: a table of its 128 values in shared memory, built
// by each block with JAX's arithmetic (two logf, four roundings to
// bfloat16); a value then costs its share of a hash, a byte, a table read,
// the add with its rounding and the key.
constexpr int kMaxRows = 65535;  // categorical rows (B) a launch
__device__ unsigned long long g_best[kMaxRows];
__device__ unsigned int g_ticket;

template <bool kBf16>
constexpr int kCatGroup = kBf16 ? 8 : 4;  // values a 16-byte load (original layout: a half's words)

// A score's bits made monotone: every NaN above +inf, -0.0 as +0.0.
__device__ __forceinline__ uint32_t cat_ord(float score) {
    const uint32_t u = __float_as_uint(score);
    if ((u & 0x7fffffffu) > 0x7f800000u) return 0xffffffffu;  // NaN beats every number
    if ((u & 0x7fffffffu) == 0u) return 0x80000000u;          // -0.0 ties with +0.0
    return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// A thread's best value so far (row -1: none).  A thread meets a row's
// values in increasing column order, so a later value wins only by a
// larger score: ties stay with the lowest column.
struct Best {
    int64_t row;
    uint32_t ord, col;
};

__device__ __forceinline__ uint64_t cat_key(const Best& t) {
    return t.row < 0 ? 0 : (static_cast<uint64_t>(t.ord) << 32) | static_cast<uint32_t>(~t.col);
}

__device__ __forceinline__ void take(Best& t, int64_t row, uint32_t col, uint32_t ord, bool& wrote) {
    if (row != t.row) {
        if (t.row >= 0) {
            atomicMax(&g_best[t.row], static_cast<unsigned long long>(cat_key(t)));
            wrote = true;
        }
        t = Best{row, ord, col};
    } else if (ord > t.ord) {
        t.ord = ord;
        t.col = col;
    }
}

// kCatGroup values c0 .. c0 + kCatGroup - 1, those in [lo, hi) taken:
// bits[j] the random bits of value c0 + j (bfloat16: its 8).
template <bool kBf16>
__device__ __forceinline__ void take_run(Best& t, bool& wrote, int64_t c0, int64_t lo, int64_t hi,
                                         const uint32_t (&bits)[kCatGroup<kBf16>], const void* logits,
                                         int64_t V, double inv_v, const float* table) {
    constexpr int G = kCatGroup<kBf16>;
    const int64_t first = c0 > lo ? c0 : lo;
    if (first >= (c0 + G < hi ? c0 + G : hi)) return;
    int64_t row = static_cast<int64_t>(static_cast<double>(first) * inv_v);  // first / V, then exact
    if (row * V > first) --row;
    if ((row + 1) * V <= first) ++row;
    const int64_t col0 = first - row * V;
    const bool whole = c0 >= lo && c0 + G <= hi;
    float l[G];
    if constexpr (kBf16) {
        const uint16_t* p = static_cast<const uint16_t*>(logits) + c0;
        if (whole && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
            const uint4 q = *reinterpret_cast<const uint4*>(p);
            const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
            for (int j = 0; j < G; ++j) l[j] = __uint_as_float(j % 2 ? w[j / 2] & 0xffff0000u : w[j / 2] << 16);
        } else {
#pragma unroll
            for (int j = 0; j < G; ++j)
                l[j] = c0 + j >= lo && c0 + j < hi ? __uint_as_float(static_cast<uint32_t>(p[j]) << 16) : 0.0f;
        }
    } else {
        const float* p = static_cast<const float*>(logits) + c0;
        if (whole && reinterpret_cast<uintptr_t>(p) % 16 == 0) {
            const float4 q = *reinterpret_cast<const float4*>(p);
            l[0] = q.x;
            l[1] = q.y;
            l[2] = q.z;
            l[3] = q.w;
        } else {
#pragma unroll
            for (int j = 0; j < G; ++j) l[j] = c0 + j >= lo && c0 + j < hi ? p[j] : 0.0f;
        }
    }
    uint32_t ord[G];
#pragma unroll
    for (int j = 0; j < G; ++j) {
        if constexpr (kBf16) {
            ord[j] = cat_ord(bf16_round(table[bits[j] >> 1] + l[j]));
        } else {
            ord[j] = cat_ord(-logf(-logf(uniform(bits[j], FLT_MIN, 1.0f))) + l[j]);
        }
    }
    if (whole && col0 + G <= V) {  // the group in one row: its best, then one take
        uint32_t best = ord[0], at = 0;
#pragma unroll
        for (int j = 1; j < G; ++j) {
            if (ord[j] > best) {
                best = ord[j];
                at = j;
            }
        }
        take(t, row, static_cast<uint32_t>(col0) + at, best, wrote);
        return;
    }
    int64_t col = col0;
#pragma unroll
    for (int j = 0; j < G; ++j) {
        if (c0 + j < lo || c0 + j >= hi) continue;
        if (col == V) {
            ++row;
            col = 0;
        }
        take(t, row, static_cast<uint32_t>(col), ord[j], wrote);
        ++col;
    }
}

// A block's threads' best values into g_best: a warp whose threads hold one
// row meets by shuffles, the warps' winners meet in thread 0 by runs of one
// row, one atomicMax a run; a warp across rows (a row shorter than its
// values, or a row's end) puts each thread's own.
__device__ __forceinline__ void block_put(const Best& t, bool& wrote, int32_t* warp_row, uint64_t* warp_key) {
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int64_t lead = __shfl_sync(0xffffffffu, t.row, 0);
    if (__all_sync(0xffffffffu, t.row == lead || t.row < 0)) {
        uint64_t k = cat_key(t);
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const uint64_t o = __shfl_down_sync(0xffffffffu, k, off);
            k = o > k ? o : k;
        }
        if (lane == 0) {
            warp_row[warp] = static_cast<int32_t>(lead);
            warp_key[warp] = k;
        }
    } else {
        if (t.row >= 0) {
            atomicMax(&g_best[t.row], static_cast<unsigned long long>(cat_key(t)));
            wrote = true;
        }
        if (lane == 0) warp_row[warp] = -1;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
        int32_t row = -1;
        uint64_t k = 0;
        for (int w = 0; w < kThreads / 32; ++w) {
            if (warp_row[w] < 0) continue;
            if (warp_row[w] != row) {
                if (row >= 0) atomicMax(&g_best[row], static_cast<unsigned long long>(k));
                row = warp_row[w];
                k = warp_key[w];
            } else if (warp_key[w] > k) {
                k = warp_key[w];
            }
        }
        if (row >= 0) atomicMax(&g_best[row], static_cast<unsigned long long>(k));
        wrote = true;
    }
    __syncthreads();  // warp_row and warp_key free again
}

template <bool kBf16, bool kOrig>
__global__ void __launch_bounds__(kThreads) categorical_kernel(const uint32_t* key, Path path, const void* logits,
                                                               int64_t B, int64_t V, double inv_v, int shift,
                                                               int32_t* out) {
    constexpr int G = kCatGroup<kBf16>;
    __shared__ float table[128];
    __shared__ int32_t warp_row[kThreads / 32];
    __shared__ uint64_t warp_key[kThreads / 32];
    __shared__ bool last;
    asm volatile("griddepcontrol.wait;" ::: "memory");
    if (kBf16 && threadIdx.x < 128) {  // JAX's bfloat16 Gumbel of mantissa threadIdx.x
        const float f = __uint_as_float((threadIdx.x << 16) | 0x3f800000u) - 1.0f;  // exact in bfloat16
        const float u = fmaxf(FLT_MIN, bf16_round(f + FLT_MIN));
        table[threadIdx.x] = -bf16_round(logf(-bf16_round(logf(u))));
    }
    uint32_t k0, k1;
    draw_key(key, path, Split{0, 0}, k0, k1);  // its barrier also publishes the table
    const int64_t n = B * V, stride = static_cast<int64_t>(gridDim.x) * kThreads;
    Best t{-1, 0, 0};
    bool wrote = false;
    if constexpr (!kOrig) {
        // group g: values G g - shift .. (16-byte aligned loads), one hash each
        const int64_t groups = (n + shift + G - 1) / G;
        for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups; g += stride) {
            const int64_t c0 = g * G - shift;
            const uint64_t c = static_cast<uint64_t>(c0 < 0 ? 0 : c0);
            const uint32_t lo = static_cast<uint32_t>(c), hi = static_cast<uint32_t>(c >> 32);
            uint32_t bits[G];
            if (c0 >= 0 && lo <= 0xffffffffu - (G - 1)) {  // the group's low words do not wrap
#pragma unroll
                for (int j = 0; j < G; ++j) {
                    uint32_t a = hi, b = lo + j;
                    threefry2x32(k0, k1, a, b);
                    bits[j] = kBf16 ? (a ^ b) & 0xffu : a ^ b;
                }
            } else {
#pragma unroll 1
                for (int j = 0; j < G; ++j) {
                    const uint64_t cj = static_cast<uint64_t>(c0 + j);
                    uint32_t a = static_cast<uint32_t>(cj >> 32), b = static_cast<uint32_t>(cj);
                    threefry2x32(k0, k1, a, b);
                    bits[j] = kBf16 ? (a ^ b) & 0xffu : a ^ b;
                }
            }
            take_run<kBf16>(t, wrote, c0, 0, n, bits, logits, V, inv_v, table);
        }
        block_put(t, wrote, warp_row, warp_key);
    } else {
        // the draw of m words (bfloat16: a word holds 4 values) in pairs (j, j
        // + h); group g: pairs P g - shift .., both words of each, so the
        // first half's values load aligned (the second's where h allows).
        // Each half keeps a best of its own: the halves lie in other rows.
        constexpr int P = kBf16 ? 2 : 4;  // pairs a group: G values a half
        constexpr int per = kBf16 ? 4 : 1;  // values a word
        const int64_t m = (n + per - 1) / per, h = (m + 1) / 2;
        const int64_t groups = (h + shift + P - 1) / P;
        Best tb{-1, 0, 0};
        for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; g < groups; g += stride) {
            const int64_t j0 = g * P - shift;
            uint32_t y0[P], y1[P];
#pragma unroll
            for (int j = 0; j < P; ++j) {  // pairs below 2**31: 32-bit counters
                y0[j] = static_cast<uint32_t>(j0 + j);
                y1[j] = j0 + j + h < m ? static_cast<uint32_t>(j0 + j + h) : 0u;
                threefry2x32(k0, k1, y0[j], y1[j]);
            }
            uint32_t bits[G];
#pragma unroll
            for (int j = 0; j < G; ++j) bits[j] = kBf16 ? (y0[j / 4] >> (8 * (j % 4))) & 0xffu : y0[j];
            const int64_t a_hi = per * h < n ? per * h : n;
            take_run<kBf16>(t, wrote, per * j0, 0, a_hi, bits, logits, V, inv_v, table);  // words j0 ..
#pragma unroll
            for (int j = 0; j < G; ++j) bits[j] = kBf16 ? (y1[j / 4] >> (8 * (j % 4))) & 0xffu : y1[j];
            take_run<kBf16>(tb, wrote, per * (j0 + h), per * h, n, bits, logits, V, inv_v, table);  // j0 + h ..
        }
        block_put(t, wrote, warp_row, warp_key);
        block_put(tb, wrote, warp_row, warp_key);
    }
    // the ticket: every block's atomics are done before the last block reads
    if (wrote) __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&g_ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    for (int64_t r = threadIdx.x; r < B; r += kThreads) {
        const unsigned long long k = atomicExch(&g_best[r], 0ull);  // read at L2 and reset
        out[r] = static_cast<int32_t>(~static_cast<uint32_t>(k));
    }
    if (threadIdx.x == 0) atomicExch(&g_ticket, 0u);
}

// A draw kernel's grid: a thread a group of counters (or pairs) in the
// largest row, every block at once (a cap only past gridDim's limit, where the
// threads stride).
unsigned draw_blocks(int64_t groups) {
    int64_t blocks = (groups + kThreads - 1) / kThreads;
    if (blocks > INT32_MAX) blocks = INT32_MAX;
    return static_cast<unsigned>(blocks < 1 ? 1 : blocks);
}

// A programmatic dependent launch of a draw kernel (the kernel waits on
// griddepcontrol.wait before it touches memory).
template <typename Kernel, typename... Args>
cudaError_t draw_launch(Kernel kernel, dim3 grid, cudaStream_t stream, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = dim3(kThreads);
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    const cudaError_t last = cudaGetLastError();
    return err != cudaSuccess ? err : last;
}

template <int kMode, bool kVec>
cudaError_t launch_part(const uint32_t* key, const Path& path, uint64_t offset, int64_t n, float minval,
                        float maxval, void* out, cudaStream_t stream) {
    const dim3 grid(draw_blocks((n + kPer - 1) / kPer));
    return draw_launch(threefry_kernel<kMode, kVec>, grid, stream, key, path, offset, n, minval, maxval, out);
}

template <int kMode, bool kVec>
cudaError_t launch_orig(const uint32_t* key, const Path& path, const Orig& o, uint64_t pairs, unsigned rows,
                        float minval, float maxval, void* out, cudaStream_t stream) {
    const dim3 grid(draw_blocks(static_cast<int64_t>((pairs + kPer - 1) / kPer)), rows);
    return draw_launch(threefry_orig_kernel<kMode, kVec>, grid, stream, key, path, o, minval, maxval, out);
}

template <int kMode>
cudaError_t launch(const uint32_t* key, const Path& path, uint64_t offset, int64_t n, int64_t total, float minval,
                   float maxval, void* out, cudaStream_t stream) {
    const bool aligned = reinterpret_cast<uintptr_t>(out) % 16 == 0;
    if (total == 0) {
        return kMode != kKeys && aligned
                   ? launch_part<kMode, true>(key, path, offset, n, minval, maxval, out, stream)
                   : launch_part<kMode, false>(key, path, offset, n, minval, maxval, out, stream);
    }
    // the original layout: the words [w_lo, w_hi) of a draw of total words (a key is two)
    const uint64_t per = kMode == kKeys ? 2 : 1;
    Orig o;
    o.total = per * static_cast<uint64_t>(total);
    o.w_lo = per * offset;
    o.w_hi = o.w_lo + per * static_cast<uint64_t>(n);
    o.nblocks = o.total / kBlock;  // JAX blocks a draw of kBlock words or more
    o.b_lo = o.nblocks ? o.w_lo / kBlock : 0;
    const unsigned rows = o.nblocks ? static_cast<unsigned>((o.w_hi - 1) / kBlock - o.b_lo + 1) : 1;
    // the most pairs a draw block of the launch hashes, and (one draw) whether
    // both halves' groups store at 16-byte aligned addresses
    const uint64_t m = o.nblocks ? kBlock : o.total, h = (m + 1) / 2;
    uint64_t pairs = h;
    bool vec = false;
    if (!o.nblocks) {
        // as the kernel: one range of pairs where the halves' overlap (its
        // groups' stores aligned alike), else two, stored value by value
        const uint64_t a_hi = o.w_hi < h ? o.w_hi : h, b_lo = (o.w_lo > h ? o.w_lo : h) - h;
        const uint64_t b_hi = o.w_hi > h ? o.w_hi - h : 0;
        const bool has_a = a_hi > o.w_lo, has_b = b_hi > b_lo;
        const bool one = !has_a || !has_b || (b_lo <= a_hi && o.w_lo <= b_hi);
        const uint64_t p_lo = has_a ? (has_b && b_lo < o.w_lo ? b_lo : o.w_lo) : b_lo;
        const uint64_t p_hi = has_b ? (has_a && a_hi > b_hi ? a_hi : b_hi) : a_hi;
        pairs = one ? p_hi - p_lo : (a_hi - o.w_lo) + (b_hi - b_lo);
        const uint64_t word = reinterpret_cast<uintptr_t>(out) / 4;  // out's address in words
        vec = one && aligned && (word + p_lo - o.w_lo) % 4 == 0 && (word + p_lo + h - o.w_lo) % 4 == 0;
    } else if (o.w_hi - o.w_lo < h) {
        pairs = o.w_hi - o.w_lo;  // the grid's size only: its threads stride over a block's pairs
    }
    return vec ? launch_orig<kMode, true>(key, path, o, pairs, rows, minval, maxval, out, stream)
               : launch_orig<kMode, false>(key, path, o, pairs, rows, minval, maxval, out, stream);
}

template <bool kBf16, bool kOrig>
cudaError_t launch_categorical(const uint32_t* key, const Path& path, const void* logits, int64_t B, int64_t V,
                               int32_t* out, cudaStream_t stream) {
    // group g's first value (pair) is shifted so that its 16-byte load is aligned
    const int64_t n = B * V, e = static_cast<int64_t>(reinterpret_cast<uintptr_t>(logits) / (kBf16 ? 2 : 4));
    int shift;
    int64_t groups;
    if (!kOrig) {
        constexpr int G = kCatGroup<kBf16>;
        shift = static_cast<int>(e % G);
        groups = (n + shift + G - 1) / G;
    } else if (kBf16) {  // 2 pairs a group: 8 values a half from two words
        const int64_t h = ((n + 3) / 4 + 1) / 2;
        shift = e % 4 == 0 ? static_cast<int>((e / 4) % 2) : 0;
        groups = (h + shift + 1) / 2;
    } else {  // 4 pairs a group
        const int64_t h = (n + 1) / 2;
        shift = static_cast<int>(e % 4);
        groups = (h + shift + 3) / 4;
    }
    return draw_launch(categorical_kernel<kBf16, kOrig>, dim3(draw_blocks(groups)), stream, key, path, logits, B, V,
                       1.0 / static_cast<double>(V), shift, out);
}

Path make_path(int n_path, int64_t d0, int64_t d1, int64_t d2, int64_t d3) {
    return Path{n_path, {static_cast<uint64_t>(d0), static_cast<uint64_t>(d1), static_cast<uint64_t>(d2),
                         static_cast<uint64_t>(d3)}};
}

}  // namespace

// The folds of ``key`` are d0..d3 (the first n_path of them).  ``total``
// 0: the partitionable layout, counters offset .. offset + n - 1; else the
// original layout, values offset .. offset + n - 1 of a draw of ``total``
// (keys for kKeys: a split, at most 2**32 - 1 words; more words of the other
// modes are drawn in blocks under split keys).  Returns a cudaError_t (0:
// launched).
extern "C" int repro_threefry(const void* key, int n_path, int64_t d0, int64_t d1, int64_t d2, int64_t d3,
                              int64_t offset, int64_t n, int64_t total, int mode, float minval, float maxval,
                              void* out, cudaStream_t stream) {
    if (n_path < 0 || n_path > kMaxPath || n < 0 || total < 0) return static_cast<int>(cudaErrorInvalidValue);
    if (total > 0 && (offset < 0 || offset + n > total || (mode == kKeys && 2 * total > INT64_C(0xffffffff)) ||
                      total / static_cast<int64_t>(kBlock) >= 65535))
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
// original layout (fewer than 2**32 - 1 words: no blocked draw).
extern "C" int repro_threefry_rows(const void* keys, int64_t rows, int n_path, int64_t d0, int64_t d1, int64_t d2,
                                   int64_t d3, int64_t n, int original, void* out, cudaStream_t stream) {
    if (n_path < 0 || n_path > kMaxPath || n < 0 || rows < 0 || rows > 65535 ||
        (original && n >= static_cast<int64_t>(kBlock)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0 || rows == 0) return 0;
    const Path path = make_path(n_path, d0, d1, d2, d3);
    const uint32_t* k = static_cast<const uint32_t*>(keys);
    float* o = static_cast<float*>(out);
    const int64_t h = original ? (n + 1) / 2 : n;
    const dim3 grid(draw_blocks((h + 2 * kPer - 2) / kPer), static_cast<unsigned>(rows));  // a row's most groups
    return static_cast<int>(original ? draw_launch(threefry_rows_kernel<true>, grid, stream, k, path, n, o)
                                     : draw_launch(threefry_rows_kernel<false>, grid, stream, k, path, n, o));
}

// ``out[b]`` (int32) = argmax_v gumbel(key folded by d0..d3, (B, V))[b, v]
// + logits[b, v]; ``bf16`` says the logits are bfloat16 (else float32);
// ``original``: the noise in the original layout (fewer than 2**32 - 1 words).
extern "C" int repro_threefry_categorical(const void* key, int n_path, int64_t d0, int64_t d1, int64_t d2,
                                          int64_t d3, const void* logits, int64_t B, int64_t V, int bf16,
                                          int original, void* out, cudaStream_t stream) {
    if (n_path < 0 || n_path > kMaxPath || B < 0 || B > kMaxRows || V < 1 || V > INT32_MAX ||
        (original && (bf16 ? (B * V + 3) / 4 : B * V) >= static_cast<int64_t>(kBlock)))
        return static_cast<int>(cudaErrorInvalidValue);
    if (B == 0) return 0;
    const Path path = make_path(n_path, d0, d1, d2, d3);
    const uint32_t* k = static_cast<const uint32_t*>(key);
    int32_t* o = static_cast<int32_t*>(out);
    cudaError_t err;
    if (bf16 && original) {
        err = launch_categorical<true, true>(k, path, logits, B, V, o, stream);
    } else if (bf16) {
        err = launch_categorical<true, false>(k, path, logits, B, V, o, stream);
    } else if (original) {
        err = launch_categorical<false, true>(k, path, logits, B, V, o, stream);
    } else {
        err = launch_categorical<false, false>(k, path, logits, B, V, o, stream);
    }
    return static_cast<int>(err);
}

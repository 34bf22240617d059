// Exact block top-k on Hopper: the device pieces shared by every selection
// kernel (round_select.cu, and gumbel_topk.cu's top-k of given scores and
// fused Gumbel top-k).
//
// Order: value descending, then index ascending -- the order lax.top_k
// returns.  A (value, index) pair is packed into one uint64 key whose
// unsigned order is exactly that order, so a sort needs one compare.
//
// Scheme: a CTA loads a chunk of Chunk keys into shared memory, bitonic-sorts
// it descending and keeps the first KP (KP = next power of two >= k).  Chunks
// of sorted candidate lists are then merged and cut again until one list is
// left.  Lists are written in alternating order (even: descending, odd:
// ascending), so a cut's bitonic sort starts at sequences of 2*KP and skips
// the log2(KP) levels that sorted each list, and a cut over fewer keys than
// Chunk sorts only the next power of two that holds them.  Exact by containment: a member of the global top-k has fewer than k
// keys above it anywhere, so it survives every cut (the argument of
// src/repro/core/selection/sampling.py merge_topk_candidates).  Every key is
// distinct (the index is in it), so the result does not depend on the sort's
// stability or on the order in which CTAs run.
//
// Chunk is a template parameter: the select kernel uses kChunk = 8192; the
// top-k kernels of gumbel_topk.cu take 2048, 4096, 8192 or 16384 (the launch
// tile), up to 128 KB of the 227 KB of shared memory a CTA may have.  A chunk
// must hold at least two lists (2 * KP <= Chunk), so each cut divides the
// number of lists by Chunk / KP >= 2.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace repro_topk {

constexpr int kChunk = 8192;     // keys per CTA of the select kernel: 64 KB of dynamic shared memory
constexpr int kThreads = 1024;   // threads per CTA
constexpr int kMaxKP = 2048;     // largest list kept per chunk (k <= 2048)
constexpr uint64_t kPadKey = 0;  // below every real key (see make_key)

// Monotone float -> uint32 map, then the index complemented in the low word so
// that, among equal values, the lower index has the larger key.
static __device__ __forceinline__ uint64_t make_key(float v, uint32_t idx) {
    uint32_t u = __float_as_uint(v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<uint64_t>(u) << 32) | static_cast<uint64_t>(~idx);
}

static __device__ __forceinline__ float key_value(uint64_t key) {
    uint32_t u = static_cast<uint32_t>(key >> 32);
    u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
    return __uint_as_float(u);
}

static __device__ __forceinline__ int32_t key_index(uint64_t key) {
    return static_cast<int32_t>(~static_cast<uint32_t>(key));
}

// Bitonic sort of n (a power of two) keys in shared memory, descending.  The
// runs of first_size/2 keys must already be sorted, run r descending if r is
// even and ascending if odd (first_size = 2: no order assumed).  Every thread
// of the block calls it; it ends with a barrier.
static __device__ __forceinline__ void block_sort_desc(uint64_t* s, int n, int first_size) {
    for (int size = first_size; size <= n; size <<= 1) {
        for (int stride = size >> 1; stride > 0; stride >>= 1) {
            __syncthreads();
            for (int t = threadIdx.x; t < (n >> 1); t += blockDim.x) {
                const int lo = 2 * t - (t & (stride - 1));
                const int hi = lo + stride;
                const uint64_t a = s[lo];
                const uint64_t b = s[hi];
                const bool desc = (lo & size) == 0;
                if (desc ? (a < b) : (a > b)) {
                    s[lo] = b;
                    s[hi] = a;
                }
            }
        }
    }
    __syncthreads();
}

// After block_sort_desc: either write the first KP keys as this CTA's sorted
// candidate list, or (the last cut) decode the first k into (vals, idx).
static __device__ __forceinline__ void emit_topk(const uint64_t* s, bool final_cut, int KP, int k, uint64_t* cand_out,
                                          float* vals, int32_t* idx) {
    if (final_cut) {
        for (int t = threadIdx.x; t < k; t += blockDim.x) {
            vals[t] = key_value(s[t]);
            idx[t] = key_index(s[t]);
        }
    } else {
        const bool ascending = (blockIdx.x & 1u) != 0;  // list b: odd lists ascending
        uint64_t* dst = cand_out + static_cast<int64_t>(blockIdx.x) * KP;
        for (int t = threadIdx.x; t < KP; t += blockDim.x) dst[t] = s[ascending ? KP - 1 - t : t];
    }
}

// One cut over sorted candidate lists: CTA b merges keys [b*Chunk,
// (b+1)*Chunk) of cand_in (n_in keys in all, a multiple of KP, padded with
// kPadKey to a power of two) and emits its top KP.
// static: each source that includes this header gets its own copy
template <int Chunk>
static __global__ void __launch_bounds__(kThreads) merge_cut_kernel(const uint64_t* __restrict__ cand_in, int64_t n_in,
                                                             uint64_t* __restrict__ cand_out, int KP, int k,
                                                             float* __restrict__ vals, int32_t* __restrict__ idx,
                                                             int final_cut) {
    extern __shared__ uint64_t s[];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * Chunk;
    int n = 2 * KP;
    while (n < Chunk && n < n_in - base) n <<= 1;
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const int64_t i = base + j;
        s[j] = i < n_in ? cand_in[i] : kPadKey;
    }
    block_sort_desc(s, n, 2 * KP);
    emit_topk(s, final_cut != 0, KP, k, cand_out, vals, idx);
}

// Cut the n_lists sorted lists in cand_a down to one, ping-ponging with
// cand_b; the last cut writes (vals, idx).  Needs 2 * KP <= Chunk.  Returns
// the first launch error.
template <int Chunk>
inline cudaError_t merge_cuts(uint64_t* cand_a, uint64_t* cand_b, int64_t n_lists, int KP, int k, float* vals,
                              int32_t* idx, cudaStream_t stream) {
    const size_t smem = sizeof(uint64_t) * Chunk;
    cudaError_t err = cudaFuncSetAttribute(merge_cut_kernel<Chunk>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int64_t per_cta = Chunk / KP;
    uint64_t* in = cand_a;
    uint64_t* out = cand_b;
    while (n_lists > 1) {
        const int64_t n_groups = (n_lists + per_cta - 1) / per_cta;
        merge_cut_kernel<Chunk><<<static_cast<unsigned>(n_groups), kThreads, smem, stream>>>(
            in, n_lists * KP, out, KP, k, vals, idx, n_groups == 1 ? 1 : 0);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
        n_lists = n_groups;
        uint64_t* tmp = in;
        in = out;
        out = tmp;
    }
    return cudaSuccess;
}

}  // namespace repro_topk

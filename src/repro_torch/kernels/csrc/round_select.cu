// The fused round's select pass: allocation epilogue + Gumbel perturbation +
// exact top-k.
//
// Replaces the TPU kernel src/repro/kernels/round_fused.py
// fused_select_kernel_call (_select_kernel, line 76, with the streaming top-k
// of src/repro/kernels/gumbel_topk.py streaming_topk_body, line 28).
//   from_w: p = clip(sigma + residual * min(w, cap) / denom, sigma, 1),
//           capped = (p_raw >= 1 - 1e-6) & use_cap, both masked by active;
//   from_p: p is given.
//   Then s = log(max(p, 1e-20)) + g, -inf where inactive, and the top k of s
//   in lax.top_k order (value descending, index ascending).
//
// Bound on the H100: bytes.  from_w reads w and g and writes p and capped:
// 13 MB at K = 1e6, about 3.9 us at 3.35 TB/s.  The TPU kernel keeps a
// running top-k across a sequential grid by extracting the tile max k times
// per tile (about k*K = 1e9 compare-and-select steps per round at k = 1000),
// which has no parallel counterpart worth porting.  Here the first pass
// computes the prelude and, in the same CTA, bitonic-sorts its 8192 keys in
// shared memory and keeps the top KP; log-depth merges of the candidate
// lists (block_topk.cuh) leave the final k.  The first pass's sort (91
// barrier-separated stages over 64 KB of shared memory per CTA) dominates; the
// design is not yet at its byte bound (see PERF.md).
//
// The scalars (sigma, residual, cap, denom, use_cap) are read from a device
// buffer, so the caller never waits on the host for them.  Compiled with
// --fmad=false so that every product and sum rounds as the plain PyTorch
// version's does.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "block_topk.cuh"

namespace {

using namespace repro_topk;

// 1 - 1e-6 rounded once, as the plain version's comparison with the Python
// float rounds it.
constexpr float kCapThresh = static_cast<float>(1.0 - 1e-6);

template <bool FROM_W>
__global__ void __launch_bounds__(kThreads) select_chunk_kernel(
    const float* __restrict__ w, const float* __restrict__ g, const float* __restrict__ active,
    const float* __restrict__ scal, int64_t K, float* __restrict__ p_out, uint8_t* __restrict__ capped_out,
    uint64_t* __restrict__ cand_out, int KP, int k, float* __restrict__ vals, int32_t* __restrict__ idx,
    int final_cut) {
    extern __shared__ uint64_t s[];
    float sigma = 0.f, residual = 0.f, cap = 0.f, denom = 1.f;
    bool use_cap = false;
    if (FROM_W) {
        sigma = scal[0];
        residual = scal[1];
        cap = scal[2];
        denom = scal[3];
        use_cap = scal[4] > 0.f;
    }
    const int64_t base = static_cast<int64_t>(blockIdx.x) * kChunk;
    for (int j = threadIdx.x; j < kChunk; j += blockDim.x) {
        const int64_t i = base + j;
        uint64_t key = kPadKey;
        if (i < K) {
            const bool act = active == nullptr || active[i] > 0.f;
            float p;
            if (FROM_W) {
                const float p_raw = sigma + residual * fminf(w[i], cap) / denom;
                bool cp = (p_raw >= kCapThresh) && use_cap;
                p = fminf(fmaxf(p_raw, sigma), 1.f);
                if (active != nullptr) {
                    p = p * active[i];
                    cp = cp && act;
                }
                p_out[i] = p;
                capped_out[i] = cp ? 1 : 0;
            } else {
                p = w[i];
            }
            const float score = act ? logf(fmaxf(p, 1e-20f)) + g[i] : -CUDART_INF_F;
            key = make_key(score, static_cast<uint32_t>(i));
        }
        s[j] = key;
    }
    block_sort_desc(s, kChunk, 2);
    emit_topk(s, final_cut != 0, KP, k, cand_out, vals, idx);
}

template <bool FROM_W>
cudaError_t launch_select(const float* w, const float* g, const float* active, const float* scal, int64_t K,
                          float* p_out, uint8_t* capped_out, uint64_t* cand_a, uint64_t* cand_b, int KP, int k,
                          float* vals, int32_t* idx, cudaStream_t stream) {
    const size_t smem = sizeof(uint64_t) * kChunk;
    cudaError_t err = cudaFuncSetAttribute(select_chunk_kernel<FROM_W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int64_t n_chunks = (K + kChunk - 1) / kChunk;
    select_chunk_kernel<FROM_W><<<static_cast<unsigned>(n_chunks), kThreads, smem, stream>>>(
        w, g, active, scal, K, p_out, capped_out, cand_a, KP, k, vals, idx, n_chunks == 1 ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return merge_cuts<kChunk>(cand_a, cand_b, n_chunks, KP, k, vals, idx, stream);
}

}  // namespace

// Scratch: cand_a holds ceil(K/8192)*KP keys, cand_b ceil(ceil(K/8192)/(8192/KP))*KP.
extern "C" int repro_round_select(const void* w, const void* g, const void* active, const void* scal, int64_t K,
                                  int from_w, void* p_out, void* capped_out, void* cand_a, void* cand_b, int KP,
                                  int k, void* vals, void* idx, void* stream) {
    if (KP < k || KP > repro_topk::kMaxKP || (KP & (KP - 1)) != 0 || k < 1 || K < k) return static_cast<int>(cudaErrorInvalidValue);
    const auto* w_ = static_cast<const float*>(w);
    const auto* g_ = static_cast<const float*>(g);
    const auto* a_ = static_cast<const float*>(active);
    const auto* s_ = static_cast<const float*>(scal);
    auto* ca = static_cast<uint64_t*>(cand_a);
    auto* cb = static_cast<uint64_t*>(cand_b);
    auto* v_ = static_cast<float*>(vals);
    auto* i_ = static_cast<int32_t*>(idx);
    auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err = from_w
        ? launch_select<true>(w_, g_, a_, s_, K, static_cast<float*>(p_out), static_cast<uint8_t*>(capped_out), ca, cb,
                              KP, k, v_, i_, st)
        : launch_select<false>(w_, g_, a_, s_, K, nullptr, nullptr, ca, cb, KP, k, v_, i_, st);
    return static_cast<int>(err);
}

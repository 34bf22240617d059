// Exact top-k of a (K,) float32 row: of given scores, or of the Gumbel-
// perturbed log-probabilities computed in registers.
//
// Replaces two TPU kernels:
//   repro_gumbel_topk       -- src/repro/kernels/gumbel_topk.py
//     gumbel_topk_kernel_call (_kernel, line 72): the top k of given scores,
//     positions >= K masked;
//   repro_fused_gumbel_topk -- src/repro/kernels/e3cs_tiles.py
//     fused_gumbel_topk_kernel_call (_fused_kernel, line 41):
//     s = log(max(p, 1e-20)) - log(-log(clip(u, 1e-20, 1 - 1e-7))), -inf
//     where p <= 0, then the top k of s.  The scores never reach HBM.
// Both return (vals, idx) in lax.top_k order (value descending, index
// ascending).  The Pallas kernels keep a running top-k across a sequential
// grid by extracting the tile max k times per tile; here the first pass
// builds the keys, bitonic-sorts a chunk of them per CTA in shared memory and
// keeps the top KP, and log-depth cuts of the candidate lists
// (block_topk.cuh) leave the final k.  The chunk (2048, 4096, 8192 or 16384
// keys) is the launch tile the autotuner sweeps; the result does not depend
// on it.
//
// Bound on the H100: bytes.  The top-k of scores reads 4 MB at K = 1e6 and
// writes 8 KB, about 1.2 us at 3.35 TB/s; the fused kernel reads p and u, 8
// MB, about 2.4 us.  The first pass's shared-memory sort dominates, as in
// round_select.cu: the design is not at its byte bound (see PERF.md).
//
// Fewer than k positive p: the masked positions score -inf, which is still a
// key above every padding key, so the result is filled with -inf at the
// lowest such indices, as the plain version's lax.top_k order gives (the
// Pallas kernel fills with -1e30 and index 0).
//
// logf, never __logf, and no --use_fast_math: the perturbation rounds as the
// plain PyTorch version's torch.log does on the card.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "block_topk.cuh"

namespace {

using namespace repro_topk;

// clip bounds of the uniform variate, rounded once to float32 as the plain
// version's clamp rounds its Python floats
constexpr float kUMin = static_cast<float>(1e-20);
constexpr float kUMax = static_cast<float>(1.0 - 1e-7);

template <int Chunk, bool FUSED>
__global__ void __launch_bounds__(kThreads) topk_chunk_kernel(
    const float* __restrict__ a, const float* __restrict__ u, int64_t K, uint64_t* __restrict__ cand_out, int KP,
    int k, float* __restrict__ vals, int32_t* __restrict__ idx, int final_cut) {
    extern __shared__ uint64_t s[];
    const int64_t base = static_cast<int64_t>(blockIdx.x) * Chunk;
    for (int j = threadIdx.x; j < Chunk; j += blockDim.x) {
        const int64_t i = base + j;
        uint64_t key = kPadKey;
        if (i < K) {
            float score;
            if (FUSED) {
                const float p = a[i];
                const float g = -logf(-logf(fminf(fmaxf(u[i], kUMin), kUMax)));
                score = p > 0.f ? logf(fmaxf(p, 1e-20f)) + g : -CUDART_INF_F;
            } else {
                score = a[i];
            }
            key = make_key(score, static_cast<uint32_t>(i));
        }
        s[j] = key;
    }
    block_sort_desc(s, Chunk, 2);
    emit_topk(s, final_cut != 0, KP, k, cand_out, vals, idx);
}

template <int Chunk, bool FUSED>
cudaError_t launch_topk(const float* a, const float* u, int64_t K, uint64_t* cand_a, uint64_t* cand_b, int KP, int k,
                        float* vals, int32_t* idx, cudaStream_t stream) {
    const size_t smem = sizeof(uint64_t) * Chunk;
    cudaError_t err = cudaFuncSetAttribute(topk_chunk_kernel<Chunk, FUSED>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
    const int64_t n_chunks = (K + Chunk - 1) / Chunk;
    topk_chunk_kernel<Chunk, FUSED><<<static_cast<unsigned>(n_chunks), kThreads, smem, stream>>>(
        a, u, K, cand_a, KP, k, vals, idx, n_chunks == 1 ? 1 : 0);
    err = cudaGetLastError();
    if (err != cudaSuccess) return err;
    return merge_cuts<Chunk>(cand_a, cand_b, n_chunks, KP, k, vals, idx, stream);
}

template <bool FUSED>
int dispatch(const void* a, const void* u, int64_t K, int chunk, void* cand_a, void* cand_b, int KP, int k,
             void* vals, void* idx, void* stream) {
    if (KP < k || KP > kMaxKP || (KP & (KP - 1)) != 0 || 2 * KP > chunk || k < 1 || K < k || K > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    const auto* a_ = static_cast<const float*>(a);
    const auto* u_ = static_cast<const float*>(u);
    auto* ca = static_cast<uint64_t*>(cand_a);
    auto* cb = static_cast<uint64_t*>(cand_b);
    auto* v_ = static_cast<float*>(vals);
    auto* i_ = static_cast<int32_t*>(idx);
    auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    switch (chunk) {
        case 2048: err = launch_topk<2048, FUSED>(a_, u_, K, ca, cb, KP, k, v_, i_, st); break;
        case 4096: err = launch_topk<4096, FUSED>(a_, u_, K, ca, cb, KP, k, v_, i_, st); break;
        case 8192: err = launch_topk<8192, FUSED>(a_, u_, K, ca, cb, KP, k, v_, i_, st); break;
        case 16384: err = launch_topk<16384, FUSED>(a_, u_, K, ca, cb, KP, k, v_, i_, st); break;
        default: err = cudaErrorInvalidValue;
    }
    return static_cast<int>(err);
}

}  // namespace

// Scratch: cand_a holds ceil(K/chunk)*KP keys, cand_b
// ceil(ceil(K/chunk)/(chunk/KP))*KP.
extern "C" int repro_gumbel_topk(const void* scores, int64_t K, int chunk, void* cand_a, void* cand_b, int KP, int k,
                                 void* vals, void* idx, void* stream) {
    return dispatch<false>(scores, nullptr, K, chunk, cand_a, cand_b, KP, k, vals, idx, stream);
}

extern "C" int repro_fused_gumbel_topk(const void* p, const void* u, int64_t K, int chunk, void* cand_a, void* cand_b,
                                       int KP, int k, void* vals, void* idx, void* stream) {
    return dispatch<true>(p, u, K, chunk, cand_a, cand_b, KP, k, vals, idx, stream);
}

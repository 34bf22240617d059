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
// grid by extracting the tile max k times per tile; here both run the radix
// select of radix_topk.cuh, whose passes build each key from the row where
// they read it (the fused kernel perturbs it again in registers) and
// otherwise read the candidate buffer.  tile, the keys a CTA takes per step
// of the row walks (2048 to 16384, the launch tile the autotuner sweeps),
// sets the grid; the result does not depend on it.
//
// Bound on the H100: bytes.  The top-k of scores reads 4 MB at K = 1e6 and
// writes 8 KB, about 1.2 us at 3.35 TB/s; the fused kernel reads p and u, 8
// MB, about 2.4 us.  The select makes about one compare a key in a fixed 9
// launches, each a few microseconds of latency at this size (see PERF.md).
//
// Fewer than k positive p: the masked positions score -inf, an ordinary key,
// so the result is filled with -inf at the lowest such indices, as the plain
// version's lax.top_k order gives (the Pallas kernel fills with -1e30 and
// index 0).
//
// logf, never __logf, and no --use_fast_math: the perturbation rounds as the
// plain PyTorch version's torch.log does on the card.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "radix_topk.cuh"

namespace {

using namespace repro_topk;

// clip bounds of the uniform variate, rounded once to float32 as the plain
// version's clamp rounds its Python floats
constexpr float kUMin = static_cast<float>(1e-20);
constexpr float kUMax = static_cast<float>(1.0 - 1e-7);

// given scores
struct ScoresSrc {
    const float* a;

    __device__ void load() {}
    __device__ __forceinline__ float score(int64_t i, bool) const { return a[i]; }
    __device__ __forceinline__ void score4(int64_t i, float s[4], bool) const {
        const float4 v = *reinterpret_cast<const float4*>(a + i);
        s[0] = v.x;
        s[1] = v.y;
        s[2] = v.z;
        s[3] = v.w;
    }
};

// log p perturbed by Gumbel(u), -inf where p <= 0
struct FusedSrc {
    const float* p;
    const float* u;

    static __device__ __forceinline__ float perturb(float pi, float ui) {
        const float g = -logf(-logf(fminf(fmaxf(ui, kUMin), kUMax)));
        return pi > 0.f ? logf(fmaxf(pi, 1e-20f)) + g : -CUDART_INF_F;
    }
    __device__ void load() {}
    __device__ __forceinline__ float score(int64_t i, bool) const { return perturb(p[i], u[i]); }
    __device__ __forceinline__ void score4(int64_t i, float s[4], bool) const {
        const float4 p4 = *reinterpret_cast<const float4*>(p + i);
        const float4 u4 = *reinterpret_cast<const float4*>(u + i);
        s[0] = perturb(p4.x, u4.x);
        s[1] = perturb(p4.y, u4.y);
        s[2] = perturb(p4.z, u4.z);
        s[3] = perturb(p4.w, u4.w);
    }
};

bool aligned(const void* a) { return reinterpret_cast<uintptr_t>(a) % 16 == 0; }

template <class Src>
int run(const Src& src, bool vec, int64_t K, int tile, int k, int digit_bits, int n_bins, int n_passes, int64_t cap,
        void* scratch, void* vals, void* idx, void* stream) {
    if (!launch_ok(K, k, tile, digit_bits, n_bins, n_passes, cap)) return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(radix_topk(src, K, k, tile, vec, static_cast<uint64_t*>(scratch), cap,
                                       static_cast<float*>(vals), static_cast<int32_t*>(idx),
                                       static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Scratch: kHeaderWords + k + 2 * cap uint64 words (radix_topk.cuh).
extern "C" int repro_gumbel_topk(const void* scores, int64_t K, int tile, int k, int digit_bits, int n_bins,
                                 int n_passes, int64_t cap, void* scratch, void* vals, void* idx, void* stream) {
    const ScoresSrc src{static_cast<const float*>(scores)};
    return run(src, aligned(scores), K, tile, k, digit_bits, n_bins, n_passes, cap, scratch, vals, idx, stream);
}

extern "C" int repro_fused_gumbel_topk(const void* p, const void* u, int64_t K, int tile, int k, int digit_bits,
                                       int n_bins, int n_passes, int64_t cap, void* scratch, void* vals, void* idx,
                                       void* stream) {
    const FusedSrc src{static_cast<const float*>(p), static_cast<const float*>(u)};
    return run(src, aligned(p) && aligned(u), K, tile, k, digit_bits, n_bins, n_passes, cap, scratch, vals, idx,
               stream);
}

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
// which has no parallel counterpart worth porting.  Here the select is the
// radix select of radix_topk.cuh: its pass 0 computes this prelude, writes p
// and capped and counts the first digit of every key in the same walk; the
// later passes recompute the score from the row where they read it (the
// prelude is deterministic) and otherwise read the candidate buffer: about
// one compare a key in a fixed 9 launches, each a few microseconds of latency
// at this size (see PERF.md).
//
// The scalars (sigma, residual, cap, denom, use_cap) are read from a device
// buffer, so the caller never waits on the host for them.  Compiled with
// --fmad=false so that every product and sum rounds as the plain PyTorch
// version's does.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "radix_topk.cuh"

namespace {

using namespace repro_topk;

// 1 - 1e-6 rounded once, as the plain version's comparison with the Python
// float rounds it.
constexpr float kCapThresh = static_cast<float>(1.0 - 1e-6);
// keys a CTA takes per step of the row walks
constexpr int kSelectTile = 4096;

template <bool FROM_W>
struct SelectSrc {
    const float* w;  // from_p: p
    const float* g;
    const float* active;
    const float* scal;
    float* p_out;
    uint8_t* capped_out;
    float sigma, residual, cap, denom;
    bool use_cap;

    __device__ void load() {
        if (FROM_W) {
            sigma = scal[0];
            residual = scal[1];
            cap = scal[2];
            denom = scal[3];
            use_cap = scal[4] > 0.f;
        }
    }

    // the score of one client, with its p and capped
    __device__ __forceinline__ float eval(float wi, float gi, float ai, float& p, bool& cp) const {
        const bool act = active == nullptr || ai > 0.f;
        cp = false;
        if (FROM_W) {
            const float p_raw = sigma + residual * fminf(wi, cap) / denom;
            cp = (p_raw >= kCapThresh) && use_cap;
            p = fminf(fmaxf(p_raw, sigma), 1.f);
            if (active != nullptr) {
                p = p * ai;
                cp = cp && act;
            }
        } else {
            p = wi;
        }
        return act ? logf(fmaxf(p, 1e-20f)) + gi : -CUDART_INF_F;
    }

    __device__ __forceinline__ float score(int64_t i, bool store) const {
        float p;
        bool cp;
        const float s = eval(w[i], g[i], active != nullptr ? active[i] : 1.f, p, cp);
        if (FROM_W && store) {
            p_out[i] = p;
            capped_out[i] = cp ? 1 : 0;
        }
        return s;
    }

    __device__ __forceinline__ void score4(int64_t i, float s[4], bool store) const {
        const float4 w4 = *reinterpret_cast<const float4*>(w + i);
        const float4 g4 = *reinterpret_cast<const float4*>(g + i);
        const float4 a4 = active != nullptr ? *reinterpret_cast<const float4*>(active + i) : make_float4(1.f, 1.f, 1.f, 1.f);
        float p[4];
        bool cp[4];
        s[0] = eval(w4.x, g4.x, a4.x, p[0], cp[0]);
        s[1] = eval(w4.y, g4.y, a4.y, p[1], cp[1]);
        s[2] = eval(w4.z, g4.z, a4.z, p[2], cp[2]);
        s[3] = eval(w4.w, g4.w, a4.w, p[3], cp[3]);
        if (FROM_W && store) {
            *reinterpret_cast<float4*>(p_out + i) = make_float4(p[0], p[1], p[2], p[3]);
            *reinterpret_cast<uchar4*>(capped_out + i) = make_uchar4(cp[0], cp[1], cp[2], cp[3]);
        }
    }
};

bool aligned(const void* a, unsigned n) { return reinterpret_cast<uintptr_t>(a) % n == 0; }

}  // namespace

// Scratch: kHeaderWords + k + 2 * cap uint64 words (radix_topk.cuh).
extern "C" int repro_round_select(const void* w, const void* g, const void* active, const void* scal, int64_t K,
                                  int from_w, void* p_out, void* capped_out, int k, int digit_bits, int n_bins,
                                  int n_passes, int64_t cap, void* scratch, void* vals, void* idx, void* stream) {
    if (!launch_ok(K, k, kSelectTile, digit_bits, n_bins, n_passes, cap)) return static_cast<int>(cudaErrorInvalidValue);
    const bool vec = aligned(w, 16) && aligned(g, 16) && aligned(active, 16) &&
                     (!from_w || (aligned(p_out, 16) && aligned(capped_out, 4)));
    auto* sc = static_cast<uint64_t*>(scratch);
    auto* v_ = static_cast<float*>(vals);
    auto* i_ = static_cast<int32_t*>(idx);
    auto st = static_cast<cudaStream_t>(stream);
    cudaError_t err;
    if (from_w) {
        SelectSrc<true> src{static_cast<const float*>(w), static_cast<const float*>(g),
                            static_cast<const float*>(active), static_cast<const float*>(scal),
                            static_cast<float*>(p_out), static_cast<uint8_t*>(capped_out)};
        err = radix_topk(src, K, k, kSelectTile, vec, sc, cap, v_, i_, st);
    } else {
        SelectSrc<false> src{static_cast<const float*>(w), static_cast<const float*>(g),
                             static_cast<const float*>(active), nullptr, nullptr, nullptr};
        err = radix_topk(src, K, k, kSelectTile, vec, sc, cap, v_, i_, st);
    }
    return static_cast<int>(err);
}

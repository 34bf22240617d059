// The fused round's tail pass: observe-decode + Eq. 16/17 update + staleness
// rings + loss cache.
//
// Replaces the TPU kernel src/repro/kernels/round_fused.py
// round_tail_kernel_call (_make_tail_kernel, line 242).  Per client i:
//   decode obs (kind x: float bits; lag: int32 lags; bits: 1-bit packed;
//   crumbs: 2-bit packed, code 3 -> DEAD_LAG) into x and, async, lag;
//   xhat = mask*x / max(p, 1e-12); step = min(residual*eta*xhat / K, 1),
//   frozen (0) where capped or inactive -> logw_pre = logw + step;
//   loss = mask > 0 ? 1 - x : loss;
//   credit ring (S slots): arriving = credit[0]; credit[s] = credit[s+1] +
//   mask * (lag == s+1) * decay[s]; under late feedback the feedback ring
//   shifts the same way with the clamped buffered step of that schedule.
// The re-centring needs a max over all clients: each CTA writes the masked
// max of its logw_pre to block_max and the wrapper reduces those (torch.max),
// as the JAX package reduces its per-tile maxes outside the kernel.
//
// Bound on the H100: bytes.  Sync, kind x: reads obs, mask, p, logw, loss
// (4 B each) and capped (1 B), writes logw_pre and loss: 29 MB at K = 1e6,
// about 8.7 us at 3.35 TB/s.  Async lag, S = 2, late feedback: 77 MB, about
// 23 us.  Design: one thread per client column, no shared state between
// threads.  A thread reads its column's S ring slots into registers before
// it writes the shifted slots, and no thread touches another's column, so
// both rings are updated IN PLACE (half the ring traffic of a copy).  No float
// atomics: the max is a per-CTA value.  Compiled with --fmad=false so every
// product and sum rounds as the plain PyTorch version's does.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxS = 4;  // deepest staleness ring compiled; the wrapper raises above it
constexpr int kDeadLag = -1;
constexpr int kLagDeadCode = 3;

enum ObsKind : int { kKindX = 0, kKindLag = 1, kKindBits = 2, kKindCrumbs = 3 };

struct Decay {
    float d[kMaxS];
};

__global__ void __launch_bounds__(kThreads) round_tail_kernel(
    const void* __restrict__ obs, int kind, const float* __restrict__ mask, const float* __restrict__ p,
    const uint8_t* __restrict__ capped, const float* __restrict__ logw, const float* __restrict__ loss,
    const float* __restrict__ active, float* __restrict__ credit, float* __restrict__ fb,
    const float* __restrict__ residual_ptr, float eta, float K_glob, Decay decay, int S, int late_fb,
    float* __restrict__ x_out, int32_t* __restrict__ lag_out, float* __restrict__ logw_out,
    float* __restrict__ loss_out, float* __restrict__ arriving, float* __restrict__ arr_fb,
    float* __restrict__ block_max, int64_t K) {
    const int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    float mval = -CUDART_INF_F;
    if (i < K) {
        float x = 0.f;
        int lag = 0;
        bool has_lag = false;
        switch (kind) {
            case kKindX:
                x = static_cast<const float*>(obs)[i];
                break;
            case kKindLag:
                lag = static_cast<const int32_t*>(obs)[i];
                has_lag = true;
                break;
            case kKindBits:
                x = float((static_cast<const uint8_t*>(obs)[i >> 3] >> (i & 7)) & 1u);
                break;
            default: {  // kKindCrumbs
                const int code = (static_cast<const uint8_t*>(obs)[i >> 2] >> (2 * (i & 3))) & 3u;
                lag = code == kLagDeadCode ? kDeadLag : code;
                has_lag = true;
            }
        }
        if (has_lag) {
            x = lag == 0 ? 1.f : 0.f;  // deadline-based selector feedback
            lag_out[i] = lag;
        }
        if (x_out != nullptr) x_out[i] = x;

        const float re = *residual_ptr * eta;
        const float m = mask[i];
        const float pc = fmaxf(p[i], 1e-12f);
        const float xhat = m * x / pc;
        const float step = fminf(re * xhat / K_glob, 1.f);
        const bool frozen = capped[i] != 0 || (active != nullptr && active[i] == 0.f);
        const float lp = logw[i] + (frozen ? 0.f : step);
        logw_out[i] = lp;
        if (active == nullptr || active[i] > 0.f) mval = lp;
        loss_out[i] = m > 0.f ? 1.f - x : loss[i];

        if (S > 0) {
            float c[kMaxS];
            float f[kMaxS];
#pragma unroll
            for (int s = 0; s < kMaxS; ++s) {
                if (s < S) {
                    c[s] = credit[s * K + i];
                    f[s] = late_fb ? fb[s * K + i] : 0.f;
                }
            }
            arriving[i] = c[0];
            if (late_fb) arr_fb[i] = f[0];
#pragma unroll
            for (int s = 0; s < kMaxS; ++s) {
                if (s < S) {
                    const float sched = m * (lag == s + 1 ? 1.f : 0.f) * decay.d[s];
                    const float c_next = s + 1 < S ? c[s + 1 < kMaxS ? s + 1 : s] : 0.f;
                    credit[s * K + i] = c_next + sched;
                    if (late_fb) {
                        float row = fminf(re * (sched / pc) / K_glob, 1.f);
                        row = frozen ? 0.f : row;
                        const float f_next = s + 1 < S ? f[s + 1 < kMaxS ? s + 1 : s] : 0.f;
                        fb[s * K + i] = f_next + row;
                    }
                }
            }
        }
    }
    // per-CTA masked max of logw_pre
    for (int off = 16; off > 0; off >>= 1) mval = fmaxf(mval, __shfl_down_sync(0xffffffffu, mval, off));
    __shared__ float warp_max[kThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = mval;
    __syncthreads();
    if (threadIdx.x == 0) {
        float b = warp_max[0];
        for (int j = 1; j < kThreads / 32; ++j) b = fmaxf(b, warp_max[j]);
        block_max[blockIdx.x] = b;
    }
}

}  // namespace

// block_max holds ceil(K/256) floats.  x_out may be null (kind x: the caller
// keeps its obs row as x); lag_out is used for kinds lag and crumbs; credit,
// arriving (S > 0) and fb, arr_fb (late_fb) are null when absent.
extern "C" int repro_round_tail(const void* obs, int kind, const void* mask, const void* p, const void* capped,
                                const void* logw, const void* loss, const void* active, void* credit, void* fb,
                                const void* residual, float eta, float K_glob, float d0, float d1, float d2, float d3,
                                int S, int late_fb, void* x_out, void* lag_out, void* logw_out, void* loss_out,
                                void* arriving, void* arr_fb, void* block_max, int64_t K, void* stream) {
    if (S < 0 || S > kMaxS || kind < kKindX || kind > kKindCrumbs) return static_cast<int>(cudaErrorInvalidValue);
    if (K == 0) return 0;
    const Decay decay{{d0, d1, d2, d3}};
    const int64_t blocks = (K + kThreads - 1) / kThreads;
    round_tail_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        obs, kind, static_cast<const float*>(mask), static_cast<const float*>(p), static_cast<const uint8_t*>(capped),
        static_cast<const float*>(logw), static_cast<const float*>(loss), static_cast<const float*>(active),
        static_cast<float*>(credit), static_cast<float*>(fb), static_cast<const float*>(residual), eta, K_glob, decay,
        S, late_fb, static_cast<float*>(x_out), static_cast<int32_t*>(lag_out), static_cast<float*>(logw_out),
        static_cast<float*>(loss_out), static_cast<float*>(arriving), static_cast<float*>(arr_fb),
        static_cast<float*>(block_max), K);
    return static_cast<int>(cudaGetLastError());
}

// The tiled E3CS weight update, Eqs. 16/17, with a max per tile.
//
// Replaces the TPU kernel src/repro/kernels/e3cs_tiles.py
// e3cs_update_kernel_call (_update_kernel, line 93).  Per client i:
//   xhat = mask*x / max(p, 1e-12)                  (Eq. 16)
//   step = min(scale * xhat, 1)                    (Eq. 17 exponent, clamped)
//   new  = logw + (frozen > 0 ? 0 : step)
// and, per tile of `tile` clients, tmax[t] = the max of new over the tile.
// The caller re-centres with new - max(tmax), as the JAX package does
// outside its kernel.
//
// Bound on the H100: bytes.  Reads logw, p, mask, x, frozen (20 MB at K =
// 1e6), writes new (4 MB): about 7.2 us at 3.35 TB/s.  Design: one CTA per
// tile, its threads striding over the tile with coalesced loads; each thread
// keeps a running max in a register, then a warp-shuffle tree and the warps
// in order give the tile's max.  No float atomics and no padding: positions
// past K are never read.  scale is read from a device pointer, so the caller
// never waits on the host for it.  Compiled with --fmad=false so every
// product and sum rounds as the plain PyTorch version's does.
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) e3cs_update_kernel(
    const float* __restrict__ logw, const float* __restrict__ p, const float* __restrict__ mask,
    const float* __restrict__ x, const float* __restrict__ frozen, const float* __restrict__ scale_ptr, int64_t K,
    int64_t tile, float* __restrict__ out, float* __restrict__ tmax) {
    const float scale = *scale_ptr;
    const int64_t lo = static_cast<int64_t>(blockIdx.x) * tile;
    const int64_t hi = lo + tile < K ? lo + tile : K;
    float m = -CUDART_INF_F;
    for (int64_t i = lo + threadIdx.x; i < hi; i += kThreads) {
        const float xhat = mask[i] * x[i] / fmaxf(p[i], 1e-12f);
        const float step = fminf(scale * xhat, 1.f);
        const float v = logw[i] + (frozen[i] > 0.f ? 0.f : step);
        out[i] = v;
        m = fmaxf(m, v);
    }
    for (int off = 16; off > 0; off >>= 1) m = fmaxf(m, __shfl_down_sync(0xffffffffu, m, off));
    __shared__ float warp_max[kThreads / 32];
    if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
    __syncthreads();
    if (threadIdx.x == 0) {
        float b = warp_max[0];
        for (int j = 1; j < kThreads / 32; ++j) b = fmaxf(b, warp_max[j]);
        tmax[blockIdx.x] = b;
    }
}

}  // namespace

// All rows are (K,) float32; scale is one float32 on the device; out is (K,)
// and tmax ceil(K / tile) floats.
extern "C" int repro_e3cs_update(const void* logw, const void* p, const void* mask, const void* x, const void* frozen,
                                 const void* scale, int64_t K, int64_t tile, void* out, void* tmax, void* stream) {
    if (K < 1 || tile < 1 || (K + tile - 1) / tile > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
    const int64_t n_tiles = (K + tile - 1) / tile;
    e3cs_update_kernel<<<static_cast<unsigned>(n_tiles), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(logw), static_cast<const float*>(p), static_cast<const float*>(mask),
        static_cast<const float*>(x), static_cast<const float*>(frozen), static_cast<const float*>(scale), K, tile,
        static_cast<float*>(out), static_cast<float*>(tmax));
    return static_cast<int>(cudaGetLastError());
}

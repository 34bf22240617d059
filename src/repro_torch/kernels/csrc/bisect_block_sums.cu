// Capped sums of one bisection block: s_b = sum_j min(w_j, caps_b) for every
// candidate cap of the block in one pass over the weights.
//
// Replaces the TPU kernel src/repro/kernels/bisect_tiles.py
// bisect_block_sums_kernel_call (_kernel, line 59).  That kernel carries one
// output block across a sequential grid; here CTAs run in no order, so the
// reduction is two passes with no float atomics and a fixed order (the result
// is the same run to run):
//   1. one CTA per tile of `tile` clients (123 CTAs at K = 1e6, tile 8192):
//      each thread reads its share of the tile once, with 16-byte loads, and
//      keeps one accumulator per cap in registers; a warp-shuffle tree, then
//      the warps in order, give the tile's (n_caps,) partial sums;
//   2. one CTA per cap sums the (n_tiles, n_caps) partials across tiles: a
//      strided per-thread sum, then the same shuffle tree.
// The caps stay on the device (the caller derives them from its bracket on
// the device): the kernel reads them by pointer.  float and double are both
// instantiated; double accumulates in double, as the JAX package's float64
// reference does.  The accumulators are a template array of 1, 3, 7, 15, 31
// or 63 (2^b - 1 caps for a block of b halvings); caps past n_caps are 0 and
// add min(w, 0) = 0 for the non-negative weights.
//
// Bound on the H100: bytes.  At K = 1e6 and 15 caps (block = 4) it reads
// 4.0 MB of weights, about 1.2 us at 3.35 TB/s; the 2 * 15 * 1e6 min and add
// operations take about 0.45 us at 67 TFLOP/s.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCaps = 63;

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
    using type = float4;
    static __device__ __forceinline__ void each(const float4& v, float (&e)[4]) {
        e[0] = v.x; e[1] = v.y; e[2] = v.z; e[3] = v.w;
    }
    static constexpr int n = 4;
};
template <>
struct Vec16<double> {
    using type = double2;
    static __device__ __forceinline__ void each(const double2& v, double (&e)[2]) {
        e[0] = v.x; e[1] = v.y;
    }
    static constexpr int n = 2;
};

template <typename T, int NC>
__device__ __forceinline__ void add_capped(T (&acc)[NC], const T* caps, T v) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] += caps[c] < v ? caps[c] : v;
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) tile_sums_kernel(
    const T* __restrict__ w, const T* __restrict__ caps, int n_caps, int64_t K, int64_t tile, int vec,
    T* __restrict__ partial) {
    __shared__ T s_caps[NC];
    __shared__ T s_warp[kWarps][NC];
    for (int c = threadIdx.x; c < NC; c += kThreads) s_caps[c] = c < n_caps ? caps[c] : T(0);
    __syncthreads();

    T acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = T(0);
    const int64_t lo = static_cast<int64_t>(blockIdx.x) * tile;
    const int64_t hi = lo + tile < K ? lo + tile : K;
    int64_t rest = lo;
    if (vec) {
        using V = typename Vec16<T>::type;
        constexpr int VN = Vec16<T>::n;
        const int64_t nv = (hi - lo) / VN;
        const V* wv = reinterpret_cast<const V*>(w + lo);
#pragma unroll 4
        for (int64_t j = threadIdx.x; j < nv; j += kThreads) {
            T e[VN];
            Vec16<T>::each(wv[j], e);
#pragma unroll
            for (int q = 0; q < VN; ++q) add_capped(acc, s_caps, e[q]);
        }
        rest = lo + nv * VN;
    }
    for (int64_t i = rest + threadIdx.x; i < hi; i += kThreads) add_capped(acc, s_caps, w[i]);

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
        const T v = warp_sum(acc[c]);
        if (lane == 0) s_warp[warp][c] = v;
    }
    __syncthreads();
    for (int c = threadIdx.x; c < n_caps; c += kThreads) {
        T s = s_warp[0][c];
#pragma unroll
        for (int j = 1; j < kWarps; ++j) s += s_warp[j][c];
        partial[static_cast<int64_t>(blockIdx.x) * n_caps + c] = s;
    }
}

template <typename T>
__global__ void __launch_bounds__(kThreads) cross_tile_kernel(
    const T* __restrict__ partial, int64_t n_tiles, int n_caps, T* __restrict__ out) {
    __shared__ T s_warp[kWarps];
    const int c = blockIdx.x;
    T v = T(0);
    for (int64_t t = threadIdx.x; t < n_tiles; t += kThreads) v += partial[t * n_caps + c];
    v = warp_sum(v);
    if ((threadIdx.x & 31) == 0) s_warp[threadIdx.x >> 5] = v;
    __syncthreads();
    if (threadIdx.x == 0) {
        T s = s_warp[0];
#pragma unroll
        for (int j = 1; j < kWarps; ++j) s += s_warp[j];
        out[c] = s;
    }
}

template <typename T, int NC>
void launch_tiles(const T* w, const T* caps, int n_caps, int64_t K, int64_t tile, int vec, T* partial,
                  int64_t n_tiles, cudaStream_t stream) {
    tile_sums_kernel<T, NC><<<static_cast<unsigned>(n_tiles), kThreads, 0, stream>>>(w, caps, n_caps, K, tile, vec,
                                                                                      partial);
}

template <typename T>
int launch(const void* w_, const void* caps_, void* partial_, void* out_, int64_t K, int64_t tile, int n_caps,
           int vec, cudaStream_t stream) {
    const T* w = static_cast<const T*>(w_);
    const T* caps = static_cast<const T*>(caps_);
    T* partial = static_cast<T*>(partial_);
    const int64_t n_tiles = (K + tile - 1) / tile;
    if (n_tiles > 0) {
        if (n_caps <= 1) launch_tiles<T, 1>(w, caps, n_caps, K, tile, vec, partial, n_tiles, stream);
        else if (n_caps <= 3) launch_tiles<T, 3>(w, caps, n_caps, K, tile, vec, partial, n_tiles, stream);
        else if (n_caps <= 7) launch_tiles<T, 7>(w, caps, n_caps, K, tile, vec, partial, n_tiles, stream);
        else if (n_caps <= 15) launch_tiles<T, 15>(w, caps, n_caps, K, tile, vec, partial, n_tiles, stream);
        else if (n_caps <= 31) launch_tiles<T, 31>(w, caps, n_caps, K, tile, vec, partial, n_tiles, stream);
        else launch_tiles<T, kMaxCaps>(w, caps, n_caps, K, tile, vec, partial, n_tiles, stream);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    cross_tile_kernel<T><<<static_cast<unsigned>(n_caps), kThreads, 0, stream>>>(partial, n_tiles, n_caps,
                                                                                  static_cast<T*>(out_));
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w: (K,) non-negative weights, zero padding allowed; caps: (n_caps,) >= 0 of
// the same type; partial: ceil(K / tile) * n_caps scratch; out: (n_caps,).
// vec = 1 promises that w and every tile start are 16-byte aligned.
extern "C" int repro_bisect_block_sums(const void* w, const void* caps, void* partial, void* out, int64_t K,
                                       int64_t tile, int n_caps, int is_double, int vec, void* stream) {
    if (n_caps < 1 || n_caps > kMaxCaps || tile < 1 || K < 0 || (K + tile - 1) / tile > 0x7fffffff) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_double ? launch<double>(w, caps, partial, out, K, tile, n_caps, vec, s)
                     : launch<float>(w, caps, partial, out, K, tile, n_caps, vec, s);
}

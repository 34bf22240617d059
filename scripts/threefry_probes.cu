// Probes of the threefry kernel's cost, for `python scripts/threefry_times.py
// --probes`: kernels that each keep one part of a draw of n values and drop
// the rest, so that their times, against one another and against the
// library's entries, say what a draw's time is made of.  Self-contained (the
// hash is repeated here), built by that script with the library's flags.
//
//   probe_empty    one block of 32 threads that does nothing: a kernel
//                  node's own cost in a captured graph;
//   probe_store    the library's grid (n / 256 blocks, at most 132 x 16,
//                  grid-stride), a 4-byte store a value: the stores alone;
//   probe_fold     probe_store after the library's prologue: thread 0 of
//                  each block folds the key by the path, the block waits at
//                  a barrier;
//   probe_hash     the library's loop, a 64-bit counter a value, hashed,
//                  its uniform epilogue, stored only where it is negative
//                  (never): the hashing without the stores;
//   probe_hash32   probe_hash with a 32-bit counter (no 64-bit index);
//   probe_wide     `per` values a thread (4 or 8), as many threads as that
//                  needs (one wave at n = 1e6), 32-bit counters, the key
//                  folded by every warp on its own (no barrier), values
//                  stored as 16-byte vectors (store = 1) or not (store = 0);
//   probe_read     a categorical's logits read as 16-byte vectors over
//                  every SM, nothing hashed or written: the read alone;
//   probe_normal   the normal epilogue's parts on the library's grid:
//                  part 0 the uniform only, 1 erf_inv's multiply-adds as a
//                  float64 product and sum (the library's), 2 as one
//                  float64 fused multiply-add (the same bits: the product
//                  of two float32 is exact in float64), 3 as float32 fused
//                  multiply-adds (other bits: a cost only).
// Every probe takes `pdl`: 1 launches it as a programmatic dependent launch
// (the kernel waits on griddepcontrol.wait before it touches memory).
#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

__device__ __forceinline__ void hash(uint32_t k0, uint32_t k1, uint32_t& x0, uint32_t& x1) {
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

__device__ __forceinline__ void wait_prior(int pdl) {
    if (pdl) asm volatile("griddepcontrol.wait;" ::: "memory");
}

__device__ __forceinline__ void fold(const uint32_t* key, int n_path, uint64_t d0, uint64_t d1, uint32_t& k0,
                                     uint32_t& k1) {
    k0 = key[0];
    k1 = key[1];
    for (int j = 0; j < n_path; ++j) {
        const uint64_t d = j == 0 ? d0 : d1;
        uint32_t a = static_cast<uint32_t>(d >> 32), b = static_cast<uint32_t>(d);
        hash(k0, k1, a, b);
        k0 = a;
        k1 = b;
    }
}

__device__ __forceinline__ float unit(uint32_t bits) { return __uint_as_float((bits >> 9) | 0x3f800000u) - 1.0f; }

__global__ void empty_kernel(int pdl) { wait_prior(pdl); }

__global__ void __launch_bounds__(kThreads) store_kernel(int64_t n, float* out, int pdl) {
    wait_prior(pdl);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride)
        out[i] = static_cast<float>(i);
}

__global__ void __launch_bounds__(kThreads) fold_kernel(const uint32_t* key, int n_path, uint64_t d0, uint64_t d1,
                                                        int64_t n, float* out, int pdl) {
    wait_prior(pdl);
    __shared__ uint32_t sk[2];
    if (threadIdx.x == 0) fold(key, n_path, d0, d1, sk[0], sk[1]);
    __syncthreads();
    const uint32_t k = sk[0] ^ sk[1];
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride)
        out[i] = __uint_as_float(static_cast<uint32_t>(i) ^ k);
}

template <bool k32>
__global__ void __launch_bounds__(kThreads) hash_kernel(const uint32_t* key, int n_path, uint64_t d0, uint64_t d1,
                                                        int64_t n, float* out, int pdl) {
    wait_prior(pdl);
    __shared__ uint32_t sk[2];
    if (threadIdx.x == 0) fold(key, n_path, d0, d1, sk[0], sk[1]);
    __syncthreads();
    const uint32_t k0 = sk[0], k1 = sk[1];
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
        uint32_t a, b;
        if (k32) {
            a = 0u;
            b = static_cast<uint32_t>(i);
        } else {
            const uint64_t c = static_cast<uint64_t>(i);
            a = static_cast<uint32_t>(c >> 32);
            b = static_cast<uint32_t>(c);
        }
        hash(k0, k1, a, b);
        const float u = unit(a ^ b);
        if (u < 0.0f) out[i] = u;
    }
}

template <int kPer>
__global__ void __launch_bounds__(kThreads) wide_kernel(const uint32_t* key, int n_path, uint64_t d0, uint64_t d1,
                                                        int64_t n, float* out, int store, int pdl) {
    wait_prior(pdl);
    uint32_t k0, k1;
    fold(key, n_path, d0, d1, k0, k1);
    const uint32_t base = (static_cast<uint32_t>(blockIdx.x) * kThreads + threadIdx.x) * kPer;
    float v[kPer];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
        uint32_t a = 0u, b = base + j;
        hash(k0, k1, a, b);
        v[j] = unit(a ^ b);
    }
    if (static_cast<int64_t>(base) + kPer <= n) {
        if (store) {
#pragma unroll
            for (int j = 0; j < kPer; j += 4)
                *reinterpret_cast<float4*>(out + base + j) = make_float4(v[j], v[j + 1], v[j + 2], v[j + 3]);
        } else {
#pragma unroll
            for (int j = 0; j < kPer; ++j)
                if (v[j] < 0.0f) out[base + j] = v[j];
        }
    } else {
        for (int j = 0; j < kPer && base + j < n; ++j)
            if (store || v[j] < 0.0f) out[base + j] = v[j];
    }
}

__device__ __forceinline__ float fma_part(int part, float p, float w, float c) {
    if (part == 1) return static_cast<float>(static_cast<double>(c) + static_cast<double>(p) * static_cast<double>(w));
    if (part == 2) return static_cast<float>(__fma_rn(static_cast<double>(p), static_cast<double>(w), static_cast<double>(c)));
    return __fmaf_rn(p, w, c);
}

template <int kPart>
__global__ void __launch_bounds__(kThreads) normal_kernel(const uint32_t* key, int n_path, uint64_t d0, uint64_t d1,
                                                          int64_t n, float* out, int pdl) {
    constexpr float lt[9] = {2.81022636e-08f,  3.43273939e-07f, -3.5233877e-06f, -4.39150654e-06f, 0.00021858087f,
                             -0.00125372503f, -0.00417768164f, 0.246640727f,    1.50140941f};
    constexpr float gt[9] = {-0.000200214257f, 0.000100950558f, 0.00134934322f, -0.00367342844f, 0.00573950773f,
                             -0.0076224613f,   0.00943887047f,  1.00167406f,    2.83297682f};
    wait_prior(pdl);
    __shared__ uint32_t sk[2];
    if (threadIdx.x == 0) fold(key, n_path, d0, d1, sk[0], sk[1]);
    __syncthreads();
    const uint32_t k0 = sk[0], k1 = sk[1];
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n; i += stride) {
        const uint64_t c = static_cast<uint64_t>(i);
        uint32_t a = static_cast<uint32_t>(c >> 32), b = static_cast<uint32_t>(c);
        hash(k0, k1, a, b);
        const float x = fmaxf(-0.99999994f, __fmaf_rn(unit(a ^ b), 1.0f + 0.99999994f, -0.99999994f));
        if (kPart == 0) {
            out[i] = x;
            continue;
        }
        float w = -log1pf(-(x * x));
        const bool small = w < 5.0f;
        w = small ? w - 2.5f : sqrtf(w) - 3.0f;
        float p = small ? lt[0] : gt[0];
#pragma unroll
        for (int k = 1; k < 9; ++k) p = fma_part(kPart, p, w, small ? lt[k] : gt[k]);
        out[i] = 1.41421354f * (p * x);
    }
}

// probe_read: bytes of logits read as 16-byte vectors, one a thread, over
// every SM, each thread's largest word stored only where it is negative
// (never, for the timed positive-float bits): a categorical's read alone
__global__ void __launch_bounds__(kThreads) read_kernel(const uint4* in, int64_t n16, float* out, int pdl) {
    wait_prior(pdl);
    const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
    uint32_t best = 0;
    for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n16; i += stride) {
        const uint4 v = in[i];
        best = max(best, max(max(v.x & 0x7fff7fffu, v.y & 0x7fff7fffu), max(v.z & 0x7fff7fffu, v.w & 0x7fff7fffu)));
    }
    if (best == 0xffffffffu) out[threadIdx.x] = 0.0f;
}

int library_blocks(int64_t n) {
    int64_t blocks = (n + kThreads - 1) / kThreads;
    if (blocks > 132 * 16) blocks = 132 * 16;
    return static_cast<int>(blocks < 1 ? 1 : blocks);
}

template <typename Kernel, typename... Args>
int go(Kernel kernel, unsigned blocks, unsigned threads, void* stream, int pdl, Args... args) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(blocks);
    cfg.blockDim = dim3(threads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = pdl ? 1 : 0;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" int probe_empty(int pdl, void* stream) { return go(empty_kernel, 1, 32, stream, pdl, pdl); }

extern "C" int probe_read(const void* in, int64_t bytes, void* out, int pdl, void* stream) {
    const int64_t n16 = bytes / 16;
    return go(read_kernel, static_cast<unsigned>((n16 + kThreads - 1) / kThreads), kThreads, stream, pdl,
              static_cast<const uint4*>(in), n16, static_cast<float*>(out), pdl);
}

extern "C" int probe_store(int64_t n, void* out, int pdl, void* stream) {
    return go(store_kernel, library_blocks(n), kThreads, stream, pdl, n, static_cast<float*>(out), pdl);
}

extern "C" int probe_fold(const void* key, int n_path, int64_t d0, int64_t d1, int64_t n, void* out, int pdl,
                          void* stream) {
    return go(fold_kernel, library_blocks(n), kThreads, stream, pdl, static_cast<const uint32_t*>(key), n_path,
              static_cast<uint64_t>(d0), static_cast<uint64_t>(d1), n, static_cast<float*>(out), pdl);
}

extern "C" int probe_hash(const void* key, int n_path, int64_t d0, int64_t d1, int64_t n, int k32, void* out,
                          int pdl, void* stream) {
    const auto* k = static_cast<const uint32_t*>(key);
    auto* o = static_cast<float*>(out);
    if (k32) return go(hash_kernel<true>, library_blocks(n), kThreads, stream, pdl, k, n_path,
                       static_cast<uint64_t>(d0), static_cast<uint64_t>(d1), n, o, pdl);
    return go(hash_kernel<false>, library_blocks(n), kThreads, stream, pdl, k, n_path, static_cast<uint64_t>(d0),
              static_cast<uint64_t>(d1), n, o, pdl);
}

extern "C" int probe_wide(const void* key, int n_path, int64_t d0, int64_t d1, int64_t n, int per, int store,
                          void* out, int pdl, void* stream) {
    if (n > INT64_C(0xffffffff) || reinterpret_cast<uintptr_t>(out) % 16 != 0) return cudaErrorInvalidValue;
    const auto* k = static_cast<const uint32_t*>(key);
    auto* o = static_cast<float*>(out);
    const unsigned blocks = static_cast<unsigned>((n + kThreads * per - 1) / (kThreads * per));
    if (per == 4) return go(wide_kernel<4>, blocks, kThreads, stream, pdl, k, n_path, static_cast<uint64_t>(d0),
                            static_cast<uint64_t>(d1), n, o, store, pdl);
    if (per == 8) return go(wide_kernel<8>, blocks, kThreads, stream, pdl, k, n_path, static_cast<uint64_t>(d0),
                            static_cast<uint64_t>(d1), n, o, store, pdl);
    return cudaErrorInvalidValue;
}

extern "C" int probe_normal(const void* key, int n_path, int64_t d0, int64_t d1, int64_t n, int part, void* out,
                            int pdl, void* stream) {
    const auto* k = static_cast<const uint32_t*>(key);
    auto* o = static_cast<float*>(out);
    const auto a = static_cast<uint64_t>(d0), b = static_cast<uint64_t>(d1);
    const unsigned blocks = library_blocks(n);
    switch (part) {
        case 0: return go(normal_kernel<0>, blocks, kThreads, stream, pdl, k, n_path, a, b, n, o, pdl);
        case 1: return go(normal_kernel<1>, blocks, kThreads, stream, pdl, k, n_path, a, b, n, o, pdl);
        case 2: return go(normal_kernel<2>, blocks, kThreads, stream, pdl, k, n_path, a, b, n, o, pdl);
        case 3: return go(normal_kernel<3>, blocks, kThreads, stream, pdl, k, n_path, a, b, n, o, pdl);
        default: return cudaErrorInvalidValue;
    }
}

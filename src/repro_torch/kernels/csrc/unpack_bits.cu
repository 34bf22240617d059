// Packed outcome rows -> per-client rows, for the staged round's replay path.
//
// Replaces the TPU kernels src/repro/kernels/unpack_bits.py:
//   unpack_bits_kernel_call   (_kernel, line 48):       1 bit per client, 8 per byte
//   unpack_crumbs_kernel_call (_crumb_kernel, line 101): 2 bits per client, 4 per byte
// Little-endian within a byte: client 8b+j is bit j of byte b (2-bit: client
// 4b+j is bits 2j..2j+1).  Crumb code 3 is the dead sentinel; the caller maps
// it to DEAD_LAG, as the JAX package does.
//
// Bound on the H100: bytes.  1 byte in, 32 bytes out for 8 clients (bits) or
// 16 bytes out for 4 clients (crumbs): at K = 1e6 about 4.1 MB and 4.3 MB, so
// about 1.2 us and 1.3 us at 3.35 TB/s.  No arithmetic worth counting.
// Design: the output is written in slots of 4 clients, one 16-byte vector
// each (float4 or int4), one thread per slot, so every warp store instruction
// writes 512 contiguous bytes and a K = 1e6 call runs 250,000 threads (the
// first port ran one thread per packed byte: half as many threads for the
// bits, each with two stores 32 bytes apart).  A slot reads its byte alone
// (bits: byte q/2, nibble q%2; two neighbouring lanes share a byte): byte
// loads take a row at any byte offset, as the trace's rows and a mesh rank's
// column slab start.  A thread takes kVecs slots kThreads apart, with all its
// loads issued before its first store, so more than one load is in flight
// (kVecs chosen by scripts/unpack_times.py --variants; PERF.md, section 6).
// A bit becomes 1.0f or 0.0f as bit * 0x3f800000 (the bits of 1.0f), with
// no conversion instruction.  The ragged slot (K % 4 clients) is written
// element by element; nothing is written past out[K-1].
// At K = 1e6 an ordinary launch of this kernel is about 1.1 us of streaming
// above the cost of a kernel node (1.3-1.6 us for a one-byte call in a
// PyTorch-captured graph), so the kernel is a programmatic dependent launch:
// the grid may be launched while the kernel before it on the stream ends, and
// waits for it (griddepcontrol.wait: that grid done, its writes visible)
// before it reads or writes memory, which saves 0.3-0.4 us a call (PERF.md,
// section 6).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kVecs = 2;  // slots a thread

// Slot q holds clients 4q .. 4q+3.  field(byte, q) puts their four codes in
// the low bits of one word; code(f, j) is client 4q+j's value.
template <bool kBits>
struct Rows;

template <>
struct Rows<true> {
    using Out = float;
    using Vec = float4;
    static __device__ __forceinline__ int64_t byte_of(int64_t q) { return q >> 1; }
    static __device__ __forceinline__ unsigned field(unsigned byte, int64_t q) {
        return byte >> ((static_cast<unsigned>(q) & 1u) * 4u);
    }
    static __device__ __forceinline__ float code(unsigned f, int j) {
        return __uint_as_float(((f >> j) & 1u) * 0x3f800000u);
    }
    static __device__ __forceinline__ float4 vec(unsigned f) {
        return make_float4(code(f, 0), code(f, 1), code(f, 2), code(f, 3));
    }
};

template <>
struct Rows<false> {
    using Out = int32_t;
    using Vec = int4;
    static __device__ __forceinline__ int64_t byte_of(int64_t q) { return q; }
    static __device__ __forceinline__ unsigned field(unsigned byte, int64_t) { return byte; }
    static __device__ __forceinline__ int32_t code(unsigned f, int j) {
        return static_cast<int32_t>((f >> (2 * j)) & 3u);
    }
    static __device__ __forceinline__ int4 vec(unsigned f) {
        return make_int4(code(f, 0), code(f, 1), code(f, 2), code(f, 3));
    }
};

template <bool kBits, int V>
__device__ __forceinline__ void unpack_slots(const uint8_t* __restrict__ packed,
                                             typename Rows<kBits>::Out* __restrict__ out, int64_t K) {
    using R = Rows<kBits>;
    const int64_t n_full = K >> 2;         // slots of 4 clients
    const int64_t n_slots = (K + 3) >> 2;  // and the ragged one
    const int64_t q0 = static_cast<int64_t>(blockIdx.x) * (kThreads * V) + threadIdx.x;
    unsigned byte[V];
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const int64_t q = q0 + v * kThreads;
        byte[v] = q < n_slots ? __ldg(packed + R::byte_of(q)) : 0u;
    }
#pragma unroll
    for (int v = 0; v < V; ++v) {
        const int64_t q = q0 + v * kThreads;
        const unsigned f = R::field(byte[v], q);
        if (q < n_full) {
            reinterpret_cast<typename R::Vec*>(out)[q] = R::vec(f);
        } else if (q < n_slots) {
            for (int j = 0; 4 * q + j < K; ++j) out[4 * q + j] = R::code(f, j);
        }
    }
}

template <bool kBits, int V>
__global__ void __launch_bounds__(kThreads) unpack_kernel(
    const uint8_t* __restrict__ packed, typename Rows<kBits>::Out* __restrict__ out, int64_t K) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    unpack_slots<kBits, V>(packed, out, K);
}

unsigned unpack_ctas(int64_t K, int V) {
    const int64_t per_cta = static_cast<int64_t>(kThreads) * V;
    return static_cast<unsigned>(((K + 3) / 4 + per_cta - 1) / per_cta);
}

// packed: ceil(K / (kBits ? 8 : 4)) bytes at any address; out: (K,) at a
// 16-byte aligned address (the wrapper's own allocation).
template <bool kBits, int V>
int launch_unpack(const void* packed, void* out, int64_t K, void* stream) {
    if (K < 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
    if (K == 0) return 0;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(unpack_ctas(K, V));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = static_cast<cudaStream_t>(stream);
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, unpack_kernel<kBits, V>, static_cast<const uint8_t*>(packed),
                                               static_cast<typename Rows<kBits>::Out*>(out), K);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
}

}  // namespace

extern "C" int repro_unpack_bits(const void* packed, void* out, int64_t K, void* stream) {
    return launch_unpack<true, kVecs>(packed, out, K, stream);
}

extern "C" int repro_unpack_crumbs(const void* packed, void* out, int64_t K, void* stream) {
    return launch_unpack<false, kVecs>(packed, out, K, stream);
}

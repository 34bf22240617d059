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
// Design: one thread per packed byte.  A full byte stores its 8 floats as two
// float4 (its 4 codes as one int4), so a warp writes contiguous 16-byte words;
// the ragged tail byte (K % 8, K % 4) stores element by element.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void unpack_bits_kernel(const uint8_t* __restrict__ packed, float* __restrict__ out, int64_t K) {
    const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t base = b * 8;
    if (base >= K) return;
    const unsigned v = packed[b];
    if (base + 8 <= K) {
        float4* o = reinterpret_cast<float4*>(out + base);
        o[0] = make_float4(float(v & 1u), float((v >> 1) & 1u), float((v >> 2) & 1u), float((v >> 3) & 1u));
        o[1] = make_float4(float((v >> 4) & 1u), float((v >> 5) & 1u), float((v >> 6) & 1u), float((v >> 7) & 1u));
    } else {
        for (int j = 0; base + j < K; ++j) out[base + j] = float((v >> j) & 1u);
    }
}

__global__ void unpack_crumbs_kernel(const uint8_t* __restrict__ packed, int32_t* __restrict__ out, int64_t K) {
    const int64_t b = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
    const int64_t base = b * 4;
    if (base >= K) return;
    const unsigned v = packed[b];
    if (base + 4 <= K) {
        reinterpret_cast<int4*>(out + base)[0] =
            make_int4(int(v & 3u), int((v >> 2) & 3u), int((v >> 4) & 3u), int((v >> 6) & 3u));
    } else {
        for (int j = 0; base + j < K; ++j) out[base + j] = int((v >> (2 * j)) & 3u);
    }
}

}  // namespace

extern "C" int repro_unpack_bits(const void* packed, void* out, int64_t K, void* stream) {
    const int64_t n_bytes = (K + 7) / 8;
    if (n_bytes == 0) return 0;
    const int64_t blocks = (n_bytes + kThreads - 1) / kThreads;
    unpack_bits_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<float*>(out), K);
    return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_unpack_crumbs(const void* packed, void* out, int64_t K, void* stream) {
    const int64_t n_bytes = (K + 3) / 4;
    if (n_bytes == 0) return 0;
    const int64_t blocks = (n_bytes + kThreads - 1) / kThreads;
    unpack_crumbs_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const uint8_t*>(packed), static_cast<int32_t*>(out), K);
    return static_cast<int>(cudaGetLastError());
}

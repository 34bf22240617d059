// The replay decode of src/repro_torch/kernels/csrc/unpack_bits.cu in other
// forms, for `python scripts/unpack_times.py --variants`: the kernel source is
// included as it is, and one entry launches it with 1, 2, 4 or 8 slots a
// thread, either as the library does (launch = 1: a programmatic dependent
// launch) or as an ordinary launch (launch = 0; its griddepcontrol.wait is
// then a no-op), or as a programmatic dependent launch that also lets the
// grid after it launch at once (launch = 2: griddepcontrol.launch_dependents
// after its wait; that grid still waits for this one to end).  Built by that
// script with the library's flags.
#include "unpack_bits.cu"

namespace {

template <bool kBits, int V>
__global__ void __launch_bounds__(kThreads) unpack_kernel_trigger(
    const uint8_t* __restrict__ packed, typename Rows<kBits>::Out* __restrict__ out, int64_t K) {
    asm volatile("griddepcontrol.wait;" ::: "memory");
    asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
    unpack_slots<kBits, V>(packed, out, K);
}

template <bool kBits, int V>
int launch_one(int launch, const void* packed, void* out, int64_t K, void* stream) {
    using Out = typename Rows<kBits>::Out;
    if (launch == 1) return launch_unpack<kBits, V>(packed, out, K, stream);
    if (K < 1 || (launch != 0 && launch != 2)) return static_cast<int>(cudaErrorInvalidValue);
    const auto s = static_cast<cudaStream_t>(stream);
    const auto* p = static_cast<const uint8_t*>(packed);
    if (launch == 0) {
        unpack_kernel<kBits, V><<<unpack_ctas(K, V), kThreads, 0, s>>>(p, static_cast<Out*>(out), K);
        return static_cast<int>(cudaGetLastError());
    }
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(unpack_ctas(K, V));
    cfg.blockDim = dim3(kThreads);
    cfg.stream = s;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr[0].val.programmaticStreamSerializationAllowed = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t err = cudaLaunchKernelEx(&cfg, unpack_kernel_trigger<kBits, V>, p, static_cast<Out*>(out), K);
    const cudaError_t last = cudaGetLastError();
    return static_cast<int>(err != cudaSuccess ? err : last);
}

template <bool kBits>
int launch_variant(int vecs, int launch, const void* packed, void* out, int64_t K, void* stream) {
    switch (vecs) {
        case 1: return launch_one<kBits, 1>(launch, packed, out, K, stream);
        case 2: return launch_one<kBits, 2>(launch, packed, out, K, stream);
        case 4: return launch_one<kBits, 4>(launch, packed, out, K, stream);
        case 8: return launch_one<kBits, 8>(launch, packed, out, K, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

}  // namespace

extern "C" int repro_unpack_variant(int bits, int vecs, int launch, const void* packed, void* out, int64_t K,
                                    void* stream) {
    return bits ? launch_variant<true>(vecs, launch, packed, out, K, stream)
                : launch_variant<false>(vecs, launch, packed, out, K, stream);
}

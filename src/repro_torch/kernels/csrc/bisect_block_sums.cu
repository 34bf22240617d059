// Capped sums of one bisection block: s_b = sum_j min(w_j, caps_b) for every
// candidate cap of the block in one pass over the weights.
//
// Replaces the TPU kernel src/repro/kernels/bisect_tiles.py
// bisect_block_sums_kernel_call (_kernel, line 59).  That kernel carries one
// output block across a sequential grid; here CTAs run in no order, so the
// reduction across tiles ends in the last CTA to finish, in a fixed order and
// with no float atomics: the result is the same bit for bit run to run, eager
// or replayed from a CUDA graph.  One launch a call:
//   1. one 256-thread CTA per tile of `tile` clients (123 CTAs at K = 1e6,
//      tile 8192): each thread reads its share of the tile with 16-byte loads,
//      the loop unrolled 8 times (all eight of its loads at tile 8192); one
//      accumulator per cap in registers, one min and one add per (client,
//      cap); a warp folds its lanes' accumulators (at each of the five steps a
//      lane keeps half its values and trades the other half with its partner:
//      NP - 1 shuffles for NP accumulators, not 5 * NP), then the warps in
//      order give the tile's (n_caps,) partial sums, stored cap-major;
//   2. thread 0 takes a ticket after a barrier with one acquire-release
//      integer atomic that wraps to 0 on the last ticket (atom.inc); the CTA
//      that draws it sums the (n_caps, n_tiles) partials in tile order (a warp
//      a cap: each lane a strided run of tiles, coalesced, then the shuffle
//      tree) and writes out.
// The tickets are a static device array, so nothing is allocated or zeroed on
// the stream: a call is one stream operation, also in a CUDA graph.  The
// wrapper gives each (device, stream) a slot for its eager calls and each
// graph capture a slot of its own (repro_stream_capture_id); calls that may
// run at the same time never share one.
// The caps stay on the device (the caller derives them from its bracket on
// the device): the kernel reads them by pointer.  float and double are both
// instantiated; double accumulates in double, as the JAX package's float64
// reference does.  The accumulators are a template array of 1, 3, 7, 15, 31
// or 63 (2^b - 1 caps for a block of b halvings); 256 threads hold 63 without
// spilling (float), and 512 were slower at 15 (PERF.md, section 6).
// Caps past n_caps are 0 and add min(w, 0) = 0 for the non-negative weights.
//
// Bound on the H100, the larger of:
//   bytes: 4 bytes a client read once (4.0 MB at K = 1e6), about 1.2 us at
//     3.35 TB/s;
//   operations the function needs: with the caps sorted (the caller's are
//     evenly spaced), s_b = sum_{w < c_b} w + c_b * #{w >= c_b}, so a client
//     costs a binary search of the caps and two adds, K * (ceil(log2(n_caps +
//     1)) + 2) instructions at 33.5e12 a second (128 lanes a clock on each of
//     132 SMs): 0.24 us at 63 caps, so the bytes bound it at every cap count.
// This per-cap algorithm issues more: one FMNMX and one FADD per (client,
// cap), 2 * K * n_caps instructions, an issue floor of its own of about 0.9 us
// at 15 caps and 3.8 us at 63.
// At 3 and 15 caps the call is latency: the launch, the walk, the ticket and
// the last CTA's sum, one after the other.  The one launch saves a second
// launch, but inside a CUDA graph the card overlaps a second launch with the
// first kernel's end, while the ticket's atomic round trip and the last CTA's
// reads of the partials overlap nothing (PERF.md, section 6).  The
// acquire-release atomic takes the place of a __threadfence per writer, which
// was slower.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCaps = 63;
constexpr int kTicketSlots = 65536;  // eager streams and graph captures of a device
__device__ unsigned int g_tickets[kTicketSlots];

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

__device__ __forceinline__ float cap_min(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double cap_min(double a, double b) { return fmin(a, b); }

template <typename T, int NC>
__device__ __forceinline__ void add_capped(T (&acc)[NC], const T* caps, T v) {
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] += cap_min(caps[c], v);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T v) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
    return v;
}

// One step of a warp's fold at lane offset OFF, N values a lane: the lane
// keeps the upper half of its values if its OFF bit is set, else the lower,
// and adds its partner's copy of the half it keeps.  After the steps that
// halve N down to 1, plain butterfly steps add the rest of the warp.
template <int N, int OFF, typename T, int NP>
__device__ __forceinline__ void fold_step(T (&v)[NP], int lane) {
    if constexpr (OFF > 0) {
        if constexpr (N > 1) {
            constexpr int H = N / 2;
            const bool upper = (lane & OFF) != 0;
#pragma unroll
            for (int j = 0; j < H; ++j) {
                const T send = upper ? v[j] : v[j + H];
                const T keep = upper ? v[j + H] : v[j];
                v[j] = keep + __shfl_xor_sync(0xffffffffu, send, OFF);
            }
            fold_step<H, OFF / 2>(v, lane);
        } else {
            v[0] += __shfl_xor_sync(0xffffffffu, v[0], OFF);
            fold_step<1, OFF / 2>(v, lane);
        }
    }
}

__host__ __device__ constexpr int log2_of(int n) { return n <= 1 ? 0 : 1 + log2_of(n / 2); }

// The warp's sums of NC accumulators (NC + 1 a power of two, at most 64) into
// s_row[c]: folded in runs of at most 32, after which lane l holds the sum of
// accumulator l >> (5 - log2(run)) of its run.
template <typename T, int NC>
__device__ __forceinline__ void warp_sums_to(const T (&acc)[NC], T* s_row, int lane) {
    constexpr int NP = NC + 1;
    static_assert((NP & (NP - 1)) == 0 && NP <= 64, "2^b - 1 caps, b <= 6");
    constexpr int RUN = NP < 32 ? NP : 32;
    constexpr int SHIFT = 5 - log2_of(RUN);
#pragma unroll
    for (int r = 0; r < NP; r += RUN) {
        T v[RUN];
#pragma unroll
        for (int j = 0; j < RUN; ++j) v[j] = r + j < NC ? acc[r + j] : T(0);
        fold_step<RUN, 16>(v, lane);
        const int c = r + (lane >> SHIFT);
        if ((lane & ((1 << SHIFT) - 1)) == 0 && c < NC) s_row[c] = v[0];
    }
}

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads) block_sums_kernel(
    const T* __restrict__ w, const T* __restrict__ caps, int n_caps, int64_t K, int64_t tile, int vec,
    T* __restrict__ partial, T* __restrict__ out, int slot) {
    static_assert(NC <= kThreads, "one writer thread a cap");
    __shared__ T s_caps[NC];
    __shared__ T s_warp[kWarps][NC];
    __shared__ bool s_last;
    for (int c = threadIdx.x; c < NC; c += kThreads) s_caps[c] = c < n_caps ? caps[c] : T(0);
    __syncthreads();

    T acc[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[c] = T(0);
    const int64_t lo = static_cast<int64_t>(blockIdx.x) * tile;
    const int64_t hi = lo + tile < K ? lo + tile : K;
    int64_t rest = lo;
    if (vec && hi > lo) {
        using V = typename Vec16<T>::type;
        constexpr int VN = Vec16<T>::n;
        const int64_t nv = (hi - lo) / VN;
        const V* wv = reinterpret_cast<const V*>(w + lo);
        // unrolled 8 times: a thread's eight 16-byte loads (its whole share of
        // an 8192-float tile) in one block that the compiler schedules with
        // the arithmetic; the eight written out ahead of it were slower
#pragma unroll 8
        for (int64_t j = threadIdx.x; j < nv; j += kThreads) {
            T e[VN];
            Vec16<T>::each(__ldg(wv + j), e);
#pragma unroll
            for (int q = 0; q < VN; ++q) add_capped(acc, s_caps, e[q]);
        }
        rest = lo + nv * VN;
    }
#pragma unroll 4
    for (int64_t i = rest + threadIdx.x; i < hi; i += kThreads) add_capped(acc, s_caps, __ldg(w + i));

    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    warp_sums_to(acc, s_warp[warp], lane);
    __syncthreads();
    // the tile's partial, cap-major: partial[c * n_tiles + tile]
    const int64_t n_tiles = gridDim.x;
    if (threadIdx.x < n_caps) {
        T s = s_warp[0][threadIdx.x];
#pragma unroll
        for (int j = 1; j < kWarps; ++j) s += s_warp[j][threadIdx.x];
        partial[threadIdx.x * n_tiles + blockIdx.x] = s;
    }

    // the ticket: an acquire-release atomic after the barrier publishes the
    // CTA's partial (the barrier orders the writers' stores before it) and,
    // in the last CTA, makes every other CTA's partial visible.  atom.inc
    // stores old >= gridDim.x - 1 ? 0 : old + 1, so the last ticket leaves 0
    // for the next call with no store of its own
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned int ticket;
        asm volatile("atom.acq_rel.gpu.global.inc.u32 %0, [%1], %2;"
                     : "=r"(ticket) : "l"(g_tickets + slot), "r"(gridDim.x - 1) : "memory");
        s_last = ticket == gridDim.x - 1;
    }
    __syncthreads();
    if (!s_last) return;
    // the last CTA sums the partials across tiles in tile order: warp w takes
    // caps w, w + kWarps, ..., each lane the tiles lane, lane + 32, ... of a
    // cap's row (coalesced), then the shuffle tree.  Steps of 4 tiles a lane,
    // the same count in every lane (no remainder loop): a step's
    // 4 * kCapsPerWarp loads are in flight together.
    constexpr int kCapsPerWarp = (NC + kWarps - 1) / kWarps;
    T s[kCapsPerWarp];
#pragma unroll
    for (int i = 0; i < kCapsPerWarp; ++i) s[i] = T(0);
    for (int64_t t0 = lane; t0 < n_tiles; t0 += 4 * 32) {
#pragma unroll
        for (int u = 0; u < 4; ++u) {
            const int64_t t = t0 + 32 * u;
#pragma unroll
            for (int i = 0; i < kCapsPerWarp; ++i) {
                const int c = warp + i * kWarps;
                if (c < n_caps && t < n_tiles) s[i] += __ldcg(partial + c * n_tiles + t);
            }
        }
    }
#pragma unroll
    for (int i = 0; i < kCapsPerWarp; ++i) {
        const T total = warp_sum(s[i]);
        const int c = warp + i * kWarps;
        if (lane == 0 && c < n_caps) out[c] = total;
    }
}

template <typename T, int NC>
void launch_nc(const T* w, const T* caps, int n_caps, int64_t K, int64_t tile, int vec, T* partial, T* out,
               unsigned n_ctas, int slot, cudaStream_t stream) {
    block_sums_kernel<T, NC><<<n_ctas, kThreads, 0, stream>>>(w, caps, n_caps, K, tile, vec, partial, out, slot);
}

template <typename T>
int launch(const void* w_, const void* caps_, void* partial_, void* out_, int64_t K, int64_t tile, int n_caps,
           int vec, int slot, cudaStream_t stream) {
    const T* w = static_cast<const T*>(w_);
    const T* caps = static_cast<const T*>(caps_);
    T* partial = static_cast<T*>(partial_);
    T* out = static_cast<T*>(out_);
    // K = 0 still takes one CTA: its empty tile sums to 0 and it writes out
    const int64_t n_tiles = K > 0 ? (K + tile - 1) / tile : 1;
    const unsigned n = static_cast<unsigned>(n_tiles);
    if (n_caps <= 1) launch_nc<T, 1>(w, caps, n_caps, K, tile, vec, partial, out, n, slot, stream);
    else if (n_caps <= 3) launch_nc<T, 3>(w, caps, n_caps, K, tile, vec, partial, out, n, slot, stream);
    else if (n_caps <= 7) launch_nc<T, 7>(w, caps, n_caps, K, tile, vec, partial, out, n, slot, stream);
    else if (n_caps <= 15) launch_nc<T, 15>(w, caps, n_caps, K, tile, vec, partial, out, n, slot, stream);
    else if (n_caps <= 31) launch_nc<T, 31>(w, caps, n_caps, K, tile, vec, partial, out, n, slot, stream);
    else launch_nc<T, kMaxCaps>(w, caps, n_caps, K, tile, vec, partial, out, n, slot, stream);
    return static_cast<int>(cudaGetLastError());
}

}  // namespace

// w: (K,) non-negative weights, zero padding allowed; caps: (n_caps,) >= 0 of
// the same type; partial: max(ceil(K / tile), 1) * n_caps scratch; out:
// (n_caps,).  vec = 1 promises that w and every tile start are 16-byte
// aligned.  slot: the launch's ticket, 0 <= slot < repro_bisect_ticket_slots();
// no two launches that may run at the same time share one.
extern "C" int repro_bisect_block_sums(const void* w, const void* caps, void* partial, void* out, int64_t K,
                                       int64_t tile, int n_caps, int is_double, int vec, int slot, void* stream) {
    if (n_caps < 1 || n_caps > kMaxCaps || tile < 1 || K < 0 || (K + tile - 1) / tile > 0x7fffffff ||
        slot < 0 || slot >= kTicketSlots) {
        return static_cast<int>(cudaErrorInvalidValue);
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    return is_double ? launch<double>(w, caps, partial, out, K, tile, n_caps, vec, slot, s)
                     : launch<float>(w, caps, partial, out, K, tile, n_caps, vec, slot, s);
}

// The number of ticket slots a device has.
extern "C" int repro_bisect_ticket_slots() { return kTicketSlots; }

// out[0] = 1 and out[1] = the capture's id while `stream` is capturing a CUDA
// graph, else out[0] = 0: the wrapper keys a captured launch's ticket slot by
// its capture.
extern "C" int repro_stream_capture_id(void* stream, unsigned long long* out) {
    cudaStreamCaptureStatus status = cudaStreamCaptureStatusNone;
    unsigned long long id = 0;
    const cudaError_t err = cudaStreamGetCaptureInfo(static_cast<cudaStream_t>(stream), &status, &id);
    out[0] = status == cudaStreamCaptureStatusActive ? 1 : 0;
    out[1] = id;
    return static_cast<int>(err);
}

// Exact top-k on Hopper by radix select: the engine shared by every
// selection kernel (round_select.cu, and gumbel_topk.cu's top-k of given
// scores and fused Gumbel top-k).
//
// Order: value descending, then index ascending -- the order lax.top_k
// returns.  A (value, index) pair is packed into one uint64 key whose
// unsigned order is exactly that order, so every decision is one compare of
// distinct keys.
//
// Scheme: AIR top-k (Zhang et al., "Parallel Top-K Algorithms on GPU: A
// Comprehensive Study and New Methods", SC '23; RAFT's select_k).  The k-th
// largest key is fixed most significant digit first, kDigitBits = 11 bits
// (2048 bins) a pass, kPasses = 6 passes for the 64 bits at most.  S_j is the
// set of keys whose digits 0..j equal the chosen ones.
//   pass 0      counts the digit-0 histogram of every key.
//   pass j > 0  reads S_{j-1}: the row (j = 1), the candidate buffer pass j-1
//               wrote, or, when S_{j-1} did not fit the buffer, the row again,
//               filtered by its first j-1 digits.  A key whose digit j-1 is
//               above the chosen one is in the top k and takes an output
//               slot.  A key whose digit j-1 equals it is in S_j: it is counted
//               in the digit-j histogram and, when |S_j| fits the buffer,
//               written there (|S_j| is known before the pass starts).
//   Each pass ends in its last CTA (an atomic ticket after __threadfence):
//   it scans the histogram from the top, fixes the chosen digit, the keys
//   still needed and |S_j|, and marks the select done when the chosen bin
//   holds exactly the keys still needed; every later pass returns at once.
//   gather      reads S_d of the pass d that ended the select, as pass d+1
//               would, and gives a slot to each key whose digit d is at or
//               above the chosen one: with the slots taken before, exactly k
//               keys, those at or above the k-th.
//   rank        each of the k keys counts the keys above it (k^2 compares
//               from shared memory, kRankLanes lanes a key) and writes
//               (value, index) at that rank: the keys are distinct, so the
//               ranks are a permutation.
// Ties: the digits run on into the index word, so equal values end on the
// lowest indices, as lax.top_k orders them.  The launches are a memset of the
// state and histograms, the 6 passes, the gather and the rank, whatever the
// data: a call can be captured in a CUDA graph and nothing is read back to
// the host.  The result depends on neither the order of the atomics and CTAs
// nor the tile (the keys a CTA takes per step of the row walks).
//
// Bound: bytes.  Pass 0 and pass 1 read the row, later passes and the gather
// the candidate buffer (a few thousand keys for Gumbel-perturbed scores, which
// end after 2-3 passes); each pass is a few microseconds of latency (walk,
// histogram merge, ticket, scan) rather than bandwidth at K = 1e6.
#pragma once

#include <algorithm>
#include <cstdint>
#include <cuda_runtime.h>

namespace repro_topk {

constexpr int kDigitBits = 11;                                // bits a pass resolves
constexpr int kBins = 1 << kDigitBits;                        // histogram bins a pass
constexpr int kPasses = (64 + kDigitBits - 1) / kDigitBits;   // passes for a 64-bit key: 6
constexpr int kThreads = 256;                                 // threads a CTA
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 2048;                                   // keys the rank step holds in shared memory
constexpr int kRankLanes = 32;                                // lanes (a warp) that rank one key
constexpr int kStateWords = 16;                               // uint64 words of SelectState, padded
// state and histograms: zeroed on the stream at the start of every call
constexpr int64_t kHeaderWords = kStateWords + int64_t(kPasses) * kBins / 2;
constexpr size_t kPassSmem = sizeof(uint32_t) * kWarps * kBins;  // per-warp histograms: 64 KB

static_assert(kThreads * 8 == kBins, "the threshold scan gives each thread 8 bins");

// The lowest bit of digit j, and its width (11 bits; the last digit 9).
__host__ __device__ constexpr int digit_shift(int j) {
    return 64 - kDigitBits * (j + 1) > 0 ? 64 - kDigitBits * (j + 1) : 0;
}
__host__ __device__ constexpr int digit_width(int j) { return 64 - kDigitBits * j - digit_shift(j); }

// Monotone float -> uint32 map, then the index complemented in the low word so
// that, among equal values, the lower index has the larger key.
static __device__ __forceinline__ uint64_t make_key(float v, uint32_t idx) {
    uint32_t u = __float_as_uint(v);
    u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
    return (static_cast<uint64_t>(u) << 32) | static_cast<uint64_t>(~idx);
}

static __device__ __forceinline__ float key_value(uint64_t key) {
    uint32_t u = static_cast<uint32_t>(key >> 32);
    u = (u & 0x80000000u) ? (u & 0x7FFFFFFFu) : ~u;
    return __uint_as_float(u);
}

static __device__ __forceinline__ int32_t key_index(uint64_t key) {
    return static_cast<int32_t>(~static_cast<uint32_t>(key));
}

struct SelectState {
    uint64_t prefix;          // the chosen digits, in place
    uint32_t count[kPasses];  // |S_j|: the keys of the chosen bin of pass j
    uint32_t needed;          // keys still needed from the chosen bin
    uint32_t done;            // 1 + the pass that ended the select; 0 while it runs
    uint32_t ticket;          // CTAs of the running pass that have finished
    uint32_t n_out;           // output slots taken
    uint32_t n_buf[kPasses];  // keys pass j wrote to candidate buffer j % 2
};
static_assert(sizeof(SelectState) <= sizeof(uint64_t) * kStateWords, "state overflows its words");

// The caller's scratch, kHeaderWords + k + 2 * cap uint64 words: state,
// histograms, k output slots, two candidate buffers of cap keys.
struct Scratch {
    SelectState* st;
    uint32_t* hist;
    uint64_t* slots;
    uint64_t* buf[2];
    int64_t cap;
};

inline Scratch scratch_at(uint64_t* base, int k, int64_t cap) {
    Scratch sc;
    sc.st = reinterpret_cast<SelectState*>(base);
    sc.hist = reinterpret_cast<uint32_t*>(base + kStateWords);
    sc.slots = base + kHeaderWords;
    sc.buf[0] = sc.slots + k;
    sc.buf[1] = sc.buf[0] + cap;
    sc.cap = cap;
    return sc;
}

// Append key at dst[atomicAdd(counter, 1)], one atomic a warp.
static __device__ __forceinline__ void append(uint64_t* dst, uint32_t* counter, uint64_t key, int64_t limit) {
    const unsigned mask = __activemask();
    const int lane = threadIdx.x & 31;
    const int leader = __ffs(mask) - 1;
    uint32_t base = 0;
    if (lane == leader) base = atomicAdd(counter, static_cast<uint32_t>(__popc(mask)));
    base = __shfl_sync(mask, base, leader);
    const int64_t pos = static_cast<int64_t>(base) + __popc(mask & ((1u << lane) - 1u));
    if (pos < limit) dst[pos] = key;
}

// Visit the key of every position of the row: CTA b takes the steps b, b +
// grid, ... of tile keys; a thread loads 16 B (float4) at a time when vec.
// store: the source also writes its per-client products (round_select's p
// and capped, pass 0 only).
template <class Src, class F>
static __device__ __forceinline__ void walk_row(const Src& src, int64_t K, int tile, bool vec, bool store, F&& f) {
    for (int64_t lo = static_cast<int64_t>(blockIdx.x) * tile; lo < K; lo += static_cast<int64_t>(gridDim.x) * tile) {
        const int64_t hi = lo + tile < K ? lo + tile : K;
        int64_t tail = lo;
        if (vec) {
            const int64_t n4 = (hi - lo) >> 2;
#pragma unroll 4
            for (int64_t v = threadIdx.x; v < n4; v += kThreads) {
                const int64_t i = lo + 4 * v;
                float s[4];
                src.score4(i, s, store);
#pragma unroll
                for (int c = 0; c < 4; ++c) f(make_key(s[c], static_cast<uint32_t>(i + c)));
            }
            tail = lo + 4 * n4;
        }
        for (int64_t i = tail + threadIdx.x; i < hi; i += kThreads) f(make_key(src.score(i, store), static_cast<uint32_t>(i)));
    }
}

// One launch of the select: pass 0..kPasses-1, or the gather (pass ==
// kPasses).  Src gives score(i, store) and score4(i, s, store), after load().
template <class Src>
static __global__ void __launch_bounds__(kThreads) radix_pass_kernel(Src src, int64_t K, int pass, int tile, int k,
                                                                     Scratch sc, int vec) {
    extern __shared__ __align__(16) uint32_t wh[];  // kWarps histograms of kBins
    __shared__ uint32_t warp_sum[kWarps];
    __shared__ bool last;
    SelectState* st = sc.st;
    const bool gather = pass == kPasses;
    const uint32_t done = st->done;
    if (gather ? done == 0 : (pass > 0 && done != 0)) return;
    // j: this launch reads S_{j-1}, as pass j does; the gather reads S_d as pass d + 1 would
    const int j = gather ? static_cast<int>(done) : pass;
    const uint64_t prefix = st->prefix;
    const bool from_buf = j >= 2 && st->count[j - 2] <= sc.cap;
    const int64_t n_in = from_buf ? static_cast<int64_t>(st->count[j - 2]) : K;
    const bool to_buf = !gather && j >= 1 && st->count[j - 1] <= sc.cap;
    const int oshift = j >= 1 ? digit_shift(j - 1) : 0;
    const int fshift = j >= 2 ? digit_shift(j - 2) : 0;
    const uint64_t ph = j >= 1 ? prefix >> oshift : 0;
    const int dshift = digit_shift(gather ? 0 : pass);
    const uint32_t dmask = (1u << digit_width(gather ? 0 : pass)) - 1u;
    const bool has_work = from_buf ? static_cast<int64_t>(blockIdx.x) * kThreads < n_in : true;

    uint32_t* my_hist = wh + (threadIdx.x >> 5) * kBins;
    if (!gather && has_work) {
        for (int i = threadIdx.x; i < kWarps * kBins / 4; i += kThreads) {
            reinterpret_cast<uint4*>(wh)[i] = make_uint4(0u, 0u, 0u, 0u);
        }
        __syncthreads();
    }
    auto visit = [&](uint64_t key) {
        if (j == 0) {
            atomicAdd(&my_hist[static_cast<uint32_t>(key >> dshift) & dmask], 1u);
            return;
        }
        if (!from_buf && j >= 2 && ((key ^ prefix) >> fshift) != 0) return;  // not in S_{j-1}
        const uint64_t hi = key >> oshift;
        if (hi > ph || (gather && hi == ph)) {
            append(sc.slots, &st->n_out, key, k);
        } else if (hi == ph && !gather) {
            atomicAdd(&my_hist[static_cast<uint32_t>(key >> dshift) & dmask], 1u);
            if (to_buf) append(sc.buf[j & 1], &st->n_buf[j], key, sc.cap);
        }
    };
    if (has_work) {
        Src s = src;
        s.load();
        if (from_buf) {
            const uint64_t* in = sc.buf[(j - 1) & 1];
            for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n_in;
                 i += static_cast<int64_t>(gridDim.x) * kThreads) {
                visit(in[i]);
            }
        } else {
            walk_row(s, K, tile, vec != 0, pass == 0, visit);
        }
    }
    if (gather) return;

    // add this CTA's histograms into the pass's global one, skipping zero bins
    uint32_t* hist = sc.hist + static_cast<int64_t>(pass) * kBins;
    if (has_work) {
        __syncthreads();
        for (int b = threadIdx.x; b < kBins; b += kThreads) {
            uint32_t c = 0;
#pragma unroll
            for (int w = 0; w < kWarps; ++w) c += wh[w * kBins + b];
            if (c != 0) atomicAdd(&hist[b], c);
        }
    }
    __threadfence();
    __syncthreads();
    if (threadIdx.x == 0) last = atomicAdd(&st->ticket, 1u) == gridDim.x - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();

    // the last CTA: thread t holds bins top - 7 .. top, top = kBins - 1 - 8t
    const uint32_t needed = pass == 0 ? static_cast<uint32_t>(k) : st->needed;
    const int top = kBins - 1 - 8 * static_cast<int>(threadIdx.x);
    uint32_t c[8];
    uint32_t sum = 0;
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        c[q] = __ldcg(&hist[top - q]);
        sum += c[q];
    }
    // inclusive scan of the threads' sums: shuffles in a warp, then the warps' totals
    const int lane = threadIdx.x & 31;
    uint32_t incl = sum;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
        const uint32_t y = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += y;
    }
    if (lane == 31) warp_sum[threadIdx.x >> 5] = incl;
    __syncthreads();
    for (int w = 0; w < static_cast<int>(threadIdx.x >> 5); ++w) incl += warp_sum[w];
    const uint32_t before = incl - sum;
    if (before < needed && needed <= incl) {
        uint32_t above = before, cnt = 0;
        int bin = top;
        bool found = false;
#pragma unroll
        for (int q = 0; q < 8; ++q) {
            if (!found && above + c[q] >= needed) {
                found = true;
                bin = top - q;
                cnt = c[q];
            } else if (!found) {
                above += c[q];
            }
        }
        const uint32_t rest = needed - above;
        st->prefix = prefix | (static_cast<uint64_t>(bin) << dshift);
        st->count[pass] = cnt;
        st->needed = rest;
        if (cnt == rest) st->done = static_cast<uint32_t>(pass) + 1u;
    }
    if (threadIdx.x == 0) st->ticket = 0;
}

// The k gathered keys, in any order, to (vals, idx) in key order.
static __global__ void __launch_bounds__(kThreads) rank_kernel(const uint64_t* __restrict__ slots, int k,
                                                               float* __restrict__ vals, int32_t* __restrict__ idx) {
    __shared__ uint64_t s[kMaxK];
    for (int i = threadIdx.x; i < k; i += kThreads) s[i] = slots[i];
    __syncthreads();
    const int key_no = (blockIdx.x * kThreads + threadIdx.x) / kRankLanes;
    const int sub = threadIdx.x % kRankLanes;
    const uint64_t mine = key_no < k ? s[key_no] : 0;
    int rank = 0;
    for (int i = sub; i < k; i += kRankLanes) rank += s[i] > mine ? 1 : 0;
#pragma unroll
    for (int off = kRankLanes / 2; off > 0; off >>= 1) rank += __shfl_xor_sync(0xffffffffu, rank, off);
    if (sub == 0 && key_no < k) {
        vals[rank] = key_value(mine);
        idx[rank] = key_index(mine);
    }
}

// The whole select on stream: the top k of src's K keys into (vals, idx).
// scratch: kHeaderWords + k + 2 * cap uint64 words.  The grid of the row
// passes is the steps of tile keys, at most the CTAs every SM holds at once.
// Returns the first error.
template <class Src>
inline cudaError_t radix_topk(const Src& src, int64_t K, int k, int tile, bool vec, uint64_t* scratch, int64_t cap,
                              float* vals, int32_t* idx, cudaStream_t stream) {
    static int per_sm = 0;  // resident CTAs an SM holds (occupancy)
    int dev = 0, sms = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess) {
        err = cudaFuncSetAttribute(radix_pass_kernel<Src>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   static_cast<int>(kPassSmem));
    }
    if (err == cudaSuccess && per_sm == 0) {
        err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, radix_pass_kernel<Src>, kThreads, kPassSmem);
    }
    if (err != cudaSuccess) return err;
    const int64_t steps = (K + tile - 1) / tile;
    const auto grid = static_cast<unsigned>(std::min<int64_t>(steps, static_cast<int64_t>(std::max(per_sm, 1)) * sms));
    // passes 0 and 1 always walk the row; the later ones and the gather most
    // often read a short buffer or return at once: one CTA an SM
    const unsigned late_grid = std::min(grid, static_cast<unsigned>(sms));
    const Scratch sc = scratch_at(scratch, k, cap);
    err = cudaMemsetAsync(scratch, 0, sizeof(uint64_t) * kHeaderWords, stream);
    if (err != cudaSuccess) return err;
    for (int pass = 0; pass <= kPasses; ++pass) {
        radix_pass_kernel<Src><<<pass < 2 ? grid : late_grid, kThreads, kPassSmem, stream>>>(src, K, pass, tile, k,
                                                                                             sc, vec ? 1 : 0);
        err = cudaGetLastError();
        if (err != cudaSuccess) return err;
    }
    rank_kernel<<<static_cast<unsigned>((kRankLanes * k + kThreads - 1) / kThreads), kThreads, 0, stream>>>(
        sc.slots, k, vals, idx);
    return cudaGetLastError();
}

// The checks every entry makes before a launch: the engine's constants as the
// wrapper states them must be the compiled ones.
inline bool launch_ok(int64_t K, int k, int tile, int digit_bits, int n_bins, int n_passes, int64_t cap) {
    return digit_bits == kDigitBits && n_bins == kBins && n_passes == kPasses && k >= 1 && k <= kMaxK && K >= k &&
           K <= 0x7fffffff && tile > 0 && tile % 4 == 0 && cap >= 1;
}

}  // namespace repro_topk

// CTC forward-backward (log-space alpha and beta) for Hopper (sm_90a).
//
// Replaces the two Pallas TPU kernels of openeat_tpu/ops/ctc_loss.py:
//   K1 _ctc_dp_kernel_batched (launched by _ctc_pallas_batched): the
//      alpha and beta histories of a batch tile kept in VMEM;
//   K2 _ctc_dp_kernel (launched by _ctc_pallas): one utterance per grid
//      cell, for T x S too tall for a batch tile.
// Same function in both: label_logp [B, T, S] (S = 2L+1 blank-interleaved
// labels), input lengths, label-sequence lengths s_len = 2L+1 and the
// skip mask allow2 [B, S] give loss[b] = -logZ and gamma = alpha + beta -
// logZ [B, T, S] (NEG_INF at t >= len), which the caller scatters into
// the [B, T, V] gradient.
//
// Bound: latency. The work is a chain of dependent steps per utterance
// of a few operations per label position; the bytes (label_logp read
// once, gamma written once) take well under a microsecond at the
// training shapes, so the kernels are bound by the chain of steps, not
// by bytes or operations. openeat_ctc_chain_step below times one step of
// that chain (one lae3, the add, one warp-wide named barrier) with no
// memory traffic, so a run can state the chain's bound: steps x that
// time.
//
// K1 is one block an utterance, K2 a cluster of two. Both run alpha and
// beta at once: the two recursions are independent (only gamma needs
// both, and logZ), so the chain is len steps rather than 2 x len. A
// recursion is W warps; lane l of warp k owns the P consecutive label
// positions s = (32 k + l) P + p, p < P, and takes the neighbours it does
// not own from the next lane down (alpha: s-1, s-2) or up (beta: s+1,
// s+2) by shuffles. The P lae3 of a
// lane are written phase by phase (lae3_p), though ptxas still orders
// them one after the other (their SASS). alpha_step and beta_step are
// that step, shared by both kernels. Neither recursion walks past len:
// alpha is frozen and beta held there, and gamma is NEG_INF.
//
// K1's counterpart (ctc_dp_pair_kernel, W = 1, S <= 128) keeps both [T, S]
// histories in shared memory. First all K1_WARPS warps copy the
// utterance's label_logp rows with cp.async into both histories, which
// alpha (warp 0) and beta (warp 1) then overwrite in place, reading each
// frame's row a step before they replace it, so no step waits on device
// memory. When both are done and logZ is known, all warps write gamma =
// alpha + beta - logZ, NEG_INF at t >= len, as
// openeat_tpu/ops/ctc_loss.py:324-329 does. Designs measured slower on the
// H100 (PERF.md): groups of S threads stepping on named barriers
// with their neighbours in shared memory; label_logp staged through rings
// of frame chunks by the recursing warps themselves; beta's history read
// back from device memory for the gamma pass; more than 4 positions a
// lane.
//
// K2's counterpart (ctc_dp_global_kernel, the T x S whose histories do
// not fit shared memory, S <= 1024) is a cluster of two blocks an
// utterance, each on its own SM: alpha in one, beta in the other, each on
// warps 0..W-1 (so that warps 0..3, and 4..7, sit on SM sub-partitions
// 0..3), W = ceil(S / 32P) <= K2_MAX_W, with P the fewest positions a lane
// from 1 up, in powers of two, that allow it (S = 241: W = 8 of P = 1;
// S = 1001: 8 of 4). A step is issue-bound at these widths (the exact expf/logf are
// about 75 instructions a position), so few positions a lane, more warps,
// and each recursion an SM of its own interleave best (PERF.md: P =
// 1, 2, 4, 8, and both recursions in one block, measured). Warp k hands
// the two values at its edge to warp k+1 (alpha) or k-1 (beta) through a
// step-parity slot in shared memory, under a named barrier of the
// recursion's 32 W threads: no step syncs the whole block. Warp W, the
// producer, streams the utterance's label_logp into the block's
// shared-memory ring of K2_CHUNK-frame chunks, many frames ahead: forward
// order for alpha, backward for beta. It copies with cp.async of 4 bytes
// (rows of S x 4 bytes and utterance offsets are not 16-byte multiples,
// so TMA does not take them), whose completion
// cp.async.mbarrier.arrive.noinc reports to a full mbarrier per slot; the
// consumers free a slot on its empty mbarrier. A recursing warp waits at
// most once per chunk, a frame ahead, on a barrier only, and fetches the
// next frame and stores its history row after handing on its edge, while
// its recursion's warps meet at the barrier. Alpha stores its rows into
// gamma and beta into a workspace of the same shape; neither reads them
// back. Alpha's block writes the loss; after the cluster's barrier each
// block writes gamma = (alpha + beta) - logZ over half of the utterance
// (16-byte accesses where they line up).
//
// Arithmetic follows the JAX kernels term for term, the same in both:
// NEG_INF = -1e30 as the log of zero (never -inf, since -inf - -inf is
// NaN), the lae3 guard (ms = 0 where m <= NEG_INF), alpha frozen past
// the input length (an input length above T walks all T frames), the
// final alpha row taken at t = len-1, logZ over the ends s_len-1 and
// max(s_len-2, 0) counted once each, beta reset at len-1 and held past
// it. expf/logf, no fast math: both kernels agree with
// openeat_torch/ops/ctc_loss.py:ctc_dp_plain bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr unsigned ALL = 0xffffffffu;
constexpr int K1_MAX_P = 4;      // K1: label positions per lane
constexpr int PAIR_MAX_S = 32 * K1_MAX_P;
constexpr int K1_WARPS = 8;      // K1's block; warps 0 and 1 recur
constexpr int MAX_S = 1024;      // K2: S <= MAX_S
constexpr int K2_MAX_W = 8;                 // warps a recursion
constexpr int K2_WARPS = K2_MAX_W + 1;      // + the ring's producer
constexpr int K2_CHUNK = 8;                 // frames a ring slot
constexpr int K2_MAX_SLOTS = 8;
constexpr int K2_RING_BYTES = 96 * 1024;

static_assert(MAX_S <= 32 * 4 * K2_MAX_W, "P = 4 must cover MAX_S");

__device__ __forceinline__ float lae3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  const float ms = (m <= NEG_INF) ? 0.0f : m;
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return (m <= NEG_INF) ? NEG_INF : out;
}

// lae3 of P independent triples, one phase at a time over q, so that the
// P chains interleave; each element is the same operations as lae3
template <int P>
__device__ __forceinline__ void lae3_p(const float (&a)[P], const float (&b)[P],
                                       const float (&c)[P], float (&out)[P]) {
  float m[P], ms[P], ea[P], eb[P], ec[P], sm[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    m[q] = fmaxf(a[q], fmaxf(b[q], c[q]));
    ms[q] = (m[q] <= NEG_INF) ? 0.0f : m[q];
  }
#pragma unroll
  for (int q = 0; q < P; ++q) ea[q] = expf(a[q] - ms[q]);
#pragma unroll
  for (int q = 0; q < P; ++q) eb[q] = expf(b[q] - ms[q]);
#pragma unroll
  for (int q = 0; q < P; ++q) ec[q] = expf(c[q] - ms[q]);
#pragma unroll
  for (int q = 0; q < P; ++q) sm[q] = ea[q] + eb[q] + ec[q];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const float o = ms[q] + logf(sm[q]);
    out[q] = (m[q] <= NEG_INF) ? NEG_INF : o;
  }
}

// alpha's neighbours from lane l-1: its positions s0 - 1 and s0 - 2
template <int P>
__device__ __forceinline__ void alpha_from_below(const float (&alpha)[P],
                                                 float& up1, float& up2) {
  up1 = __shfl_up_sync(ALL, alpha[P - 1], 1);
  up2 = __shfl_up_sync(ALL, alpha[P > 1 ? P - 2 : 0], P > 1 ? 1 : 2);
}

// one alpha step: alpha <- lae3(alpha[s], alpha[s-1], alpha[s-2] where
// the skip is legal) + label_logp; up1, up2 are alpha[s0-1], alpha[s0-2]
template <int P>
__device__ __forceinline__ void alpha_step(float (&alpha)[P],
                                           const float (&lp_t)[P],
                                           const bool (&on)[P],
                                           const bool (&skip_in)[P], int s0,
                                           float up1, float up2) {
  float a1[P], a2[P], l3[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int s = s0 + q;
    a1[q] = s < 1 ? NEG_INF : q >= 1 ? alpha[q - 1] : up1;
    a2[q] = !skip_in[q] ? NEG_INF
            : q >= 2    ? alpha[q - 2]
            : q == 1    ? up1
                        : up2;
  }
  lae3_p<P>(alpha, a1, a2, l3);
#pragma unroll
  for (int q = 0; q < P; ++q) alpha[q] = on[q] ? l3[q] + lp_t[q] : NEG_INF;
}

// beta's neighbours from lane l+1: its bn0 at s0 + P and s0 + P + 1
template <int P>
__device__ __forceinline__ void beta_from_above(const float (&bn0)[P],
                                                float& dn1, float& dn2) {
  dn1 = __shfl_down_sync(ALL, bn0[0], 1);
  dn2 = __shfl_down_sync(ALL, bn0[P > 1 ? 1 : 0], P > 1 ? 1 : 2);
}

// one beta step: beta <- lae3(bn0[s], bn0[s+1], bn0[s+2] where the skip
// is legal), bn0 = beta + label_logp of the frame after
template <int P>
__device__ __forceinline__ void beta_step(float (&beta)[P],
                                          const float (&bn0)[P],
                                          const bool (&on)[P],
                                          const bool (&skip_out)[P], int s0,
                                          int s_n, float dn1, float dn2) {
  float b1[P], b2[P], l3[P];
#pragma unroll
  for (int q = 0; q < P; ++q) {
    const int s = s0 + q;
    b1[q] = s + 1 >= s_n ? NEG_INF : q + 1 < P ? bn0[q + 1] : dn1;
    b2[q] = !skip_out[q] ? NEG_INF
            : q + 2 < P  ? bn0[q + 2]
            : q + 2 == P ? dn1
                         : dn2;
  }
  lae3_p<P>(bn0, b1, b2, l3);
#pragma unroll
  for (int q = 0; q < P; ++q) beta[q] = on[q] ? l3[q] : NEG_INF;
}

// Between the W warps of a K2 recursion: warp k of alpha hands its top
// two positions (32P - 1 and 32P - 2 of the warp: lane 31's last two, or
// lanes 31 and 30 at P = 1) to lane 0 (and lane 1 at P = 1) of warp k+1;
// warp k of beta hands its bottom two bn0 (lane 0's first two, or lanes
// 0 and 1) to lane 31 (and 30) of warp k-1. A warp's first position, 32Pk,
// is even, a blank, which takes no skip: alpha's second value (and beta's
// for lane 30) is never read, and is handed on only to keep one rule.
template <int P>
__device__ __forceinline__ void alpha_hand_on(float (&e)[2],
                                              const float (&alpha)[P],
                                              int lane) {
  if (lane == 31) {
    e[0] = alpha[P - 1];
    if (P > 1) e[1] = alpha[P > 1 ? P - 2 : 0];
  }
  if (P == 1 && lane == 30) e[1] = alpha[0];
}
template <int P>
__device__ __forceinline__ void beta_hand_on(float (&e)[2],
                                             const float (&bn0)[P],
                                             int lane) {
  if (lane == 0) {
    e[0] = bn0[0];
    if (P > 1) e[1] = bn0[P > 1 ? 1 : 0];
  }
  if (P == 1 && lane == 1) e[1] = bn0[0];
}
// the pair a warp is handed: lane `both` takes x <- e[0], y <- e[1], and
// (at P = 1) lane `second` y <- e[0]; all lanes read it, a broadcast, so
// that no branch is taken
__device__ __forceinline__ void take_edge(const float (&e)[2], bool both,
                                          bool second, float& x, float& y) {
  const float2 v = *reinterpret_cast<const float2*>(e);
  x = both ? v.x : x;
  y = both ? v.y : second ? v.x : y;
}

// all `count` threads of barrier `id` (a multiple of 32: whole warps)
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4 bytes from src to dst in shared memory, asynchronously
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// returns once every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem_addr(bar))
      : "memory");
}

// the barrier arrives once every earlier cp.async of this thread has
// landed; it counts as one of the arrivals the barrier was set up for
__device__ __forceinline__ void mbar_arrive_on_copies(uint64_t* bar) {
  asm volatile(
      "cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
          smem_addr(bar))
      : "memory");
}

// returns once the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// every thread of the thread-block cluster; what each wrote before, in
// any memory, is seen by all after
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n\t"
      "barrier.cluster.wait.acquire.aligned;" ::
          : "memory");
}

// K1's counterpart. All K1_WARPS warps first copy the utterance's
// label_logp rows into both histories; then warp 0 runs alpha and warp 1
// beta, each overwriting its history in place (a lane reads frame t of
// its own columns before it writes step t there); then all warps write
// gamma. S <= 32 x P: one warp a recursion.
template <int P>
__global__ void __launch_bounds__(K1_WARPS * 32)
    ctc_dp_pair_kernel(const float* __restrict__ label_logp,
                       const int* __restrict__ in_lens,
                       const int* __restrict__ s_lens,
                       const unsigned char* __restrict__ allow2, int t_len,
                       int s_n, float* __restrict__ loss,
                       float* __restrict__ gamma) {
  extern __shared__ float smem[];
  __shared__ float ends[2];
  float* ahist = smem;                         // label_logp, then alpha
  float* bhist = ahist + (size_t)t_len * s_n;  // label_logp, then beta

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int b = blockIdx.x;
  const int n = max(0, min(in_lens[b], t_len));  // frames to walk
  const int slen = s_lens[b];
  const int end1 = slen - 1;
  const int end2 = max(slen - 2, 0);
  const float* lp = label_logp + (size_t)b * t_len * s_n;
  const unsigned char* a2row = allow2 + (size_t)b * s_n;

  // the n frames into both histories at once: one round trip to device
  // memory for the whole block, before the first step
  for (int i = threadIdx.x; i < n * s_n; i += blockDim.x) {
    cp_async4(ahist + i, lp + i);
    cp_async4(bhist + i, lp + i);
  }
  if (threadIdx.x == 0) {
    ends[0] = NEG_INF;
    ends[1] = NEG_INF;
  }
  cp_async_wait_all();
  __syncthreads();

  const int s0 = lane * P;
  if (warp == 0 && n >= 1) {
    // ---- alpha over frames 0..n-1
    bool on[P], skip_in[P];
    float alpha[P];
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int s = s0 + q;
      on[q] = s < s_n;
      skip_in[q] = on[q] && s >= 2 && a2row[s] != 0;  // s-2 -> s
      alpha[q] = (on[q] && s < 2 && s < slen) ? ahist[s] : NEG_INF;
      if (on[q]) ahist[s] = alpha[q];
    }
    float lp_t[P];  // frame t's label_logp, read a step ahead
#pragma unroll
    for (int q = 0; q < P; ++q) {
      lp_t[q] = (on[q] && n > 1) ? ahist[(size_t)s_n + s0 + q] : 0.0f;
    }
    for (int t = 1; t < n; ++t) {
      float* row = ahist + (size_t)t * s_n + s0;
      float lp_ahead[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        lp_ahead[q] = (on[q] && t + 1 < n) ? row[s_n + q] : 0.0f;
      }
      float up1, up2;
      alpha_from_below<P>(alpha, up1, up2);
      alpha_step<P>(alpha, lp_t, on, skip_in, s0, up1, up2);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (on[q]) row[q] = alpha[q];
        lp_t[q] = lp_ahead[q];
      }
    }
    // logZ's ends s_len-1 and max(s_len-2, 0) at step n-1, each once
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int s = s0 + q;
      if (on[q] && s == end1) ends[0] = alpha[q];
      if (on[q] && s == end2 && end2 != end1) ends[1] = alpha[q];
    }
  } else if (warp == 1 && n >= 1) {
    // ---- beta over frames n-1..0: frame i from label_logp frame i+1
    bool on[P], skip_out[P];
    float beta[P], lp_next[P];
    float* last = bhist + (size_t)(n - 1) * s_n + s0;
#pragma unroll
    for (int q = 0; q < P; ++q) {
      const int s = s0 + q;
      on[q] = s < s_n;
      skip_out[q] = on[q] && s + 2 < s_n && a2row[s + 2] != 0;  // s -> s+2
      beta[q] = (on[q] && (s == end1 || s == end2)) ? 0.0f : NEG_INF;
      lp_next[q] = on[q] ? last[q] : 0.0f;
      if (on[q]) last[q] = beta[q];
    }
    for (int i = n - 2; i >= 0; --i) {
      float* row = bhist + (size_t)i * s_n + s0;
      float bn0[P];
#pragma unroll
      for (int q = 0; q < P; ++q) {
        bn0[q] = on[q] ? beta[q] + lp_next[q] : NEG_INF;
        lp_next[q] = on[q] ? row[q] : 0.0f;  // frame i, read before step i
      }
      float dn1, dn2;
      beta_from_above<P>(bn0, dn1, dn2);
      beta_step<P>(beta, bn0, on, skip_out, s0, s_n, dn1, dn2);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        if (on[q]) row[q] = beta[q];
      }
    }
  }
  __syncthreads();  // both histories and the ends

  const float logz = lae3(ends[0], ends[1], NEG_INF);
  if (threadIdx.x == 0) loss[b] = -logz;
  float* gb = gamma + (size_t)b * t_len * s_n;
  for (int i = threadIdx.x; i < t_len * s_n; i += blockDim.x) {
    gb[i] = (i < n * s_n) ? ahist[i] + bhist[i] - logz : NEG_INF;
  }
}

// K2's ring: alpha's (dir 0) carries frames 0, 1, .., n-1 and beta's (dir
// 1) frames n-1, n-2, .., 1, in that order. Item j of a ring is in
// chunk c = j / K2_CHUNK, held in slot c % slots; a chunk is its frames'
// rows as they lie in label_logp, lowest frame first.
struct Ring {
  float* base;  // [slots][K2_CHUNK * s_n]
  uint64_t* full;
  uint64_t* empty;
  int slots, s_n, n, dir;  // dir 0: forward (alpha), 1: backward (beta)

  __device__ __forceinline__ int items() const {
    return dir ? max(n - 1, 0) : n;
  }
  // the lowest frame of chunk c, and how many frames it holds
  __device__ __forceinline__ int chunk_lo(int c) const {
    return dir ? max(1, n - (c + 1) * K2_CHUNK) : c * K2_CHUNK;
  }
  __device__ __forceinline__ int chunk_frames(int c) const {
    return dir ? n - c * K2_CHUNK - chunk_lo(c)
               : min(K2_CHUNK, n - c * K2_CHUNK);
  }
  __device__ __forceinline__ float* slot(int c) const {
    return base + (size_t)(c % slots) * K2_CHUNK * s_n;
  }
  // a consumer's place: its item's row, the item's chunk, the items left
  // in that chunk after it, the chunk's slot and the parity of its turn
  // in that slot
  struct Cursor {
    const float* row;
    int c, left, slot, parity;
  };
  __device__ __forceinline__ Cursor start() const {
    return {nullptr, -1, 0, slots - 1, 1};
  }
  // the next item's row; opening a chunk waits for it and frees the one
  // before, so a consumer waits at most once per chunk
  __device__ __forceinline__ const float* next(Cursor& cur) const {
    if (cur.left == 0) {
      const int c = ++cur.c;
      const int prev = cur.slot;
      if (++cur.slot == slots) {
        cur.slot = 0;
        cur.parity ^= 1;
      }
      mbar_wait(full + cur.slot, cur.parity);
      if (c > 0) mbar_arrive(empty + prev);
      cur.left = chunk_frames(c) - 1;
      cur.row = base + (size_t)(cur.slot * K2_CHUNK + (dir ? cur.left : 0)) *
                           s_n;
    } else {
      --cur.left;
      cur.row += dir ? -s_n : s_n;
    }
    return cur.row;
  }
  // producer: chunk c from the utterance's label_logp into its slot
  __device__ __forceinline__ void fill(int c, const float* lp,
                                       int lane) const {
    if (c >= slots) mbar_wait(empty + c % slots, ((c / slots) + 1) & 1);
    const float* src = lp + (size_t)chunk_lo(c) * s_n;
    float* dst = slot(c);
    const int count = chunk_frames(c) * s_n;
    for (int i = lane; i < count; i += 32) cp_async4(dst + i, src + i);
    mbar_arrive_on_copies(full + c % slots);
  }
};

// K2's gamma pass over elements [lo, hi) of an utterance: (alpha + beta)
// - logZ below `valid`, NEG_INF from it. ga and gb lie at the same offset
// in two buffers of one shape, so 16-byte accesses line up in both where
// their bases do; U float4 pairs in flight a thread (8 spills).
__device__ __forceinline__ void gamma_range(float* ga, const float* gb,
                                            size_t lo, size_t hi,
                                            size_t valid, float logz) {
  const size_t vend = min(hi, valid);
  size_t head = vend;
  if ((((uintptr_t)gb - (uintptr_t)ga) & 15) == 0 && lo < vend) {
    head = min(vend, lo + ((16 - ((uintptr_t)(ga + lo) & 15)) & 15) / 4);
  }
  const size_t nvec = (vend - head) / 4;
  for (size_t i = lo + threadIdx.x; i < head; i += blockDim.x) {
    ga[i] = (__ldcg(ga + i) + __ldcg(gb + i)) - logz;
  }
  float4* va = reinterpret_cast<float4*>(ga + head);
  const float4* vb = reinterpret_cast<const float4*>(gb + head);
  constexpr int U = 4;
  for (size_t v0 = threadIdx.x; v0 < nvec; v0 += U * blockDim.x) {
    float4 x[U], y[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t v = v0 + (size_t)u * blockDim.x;
      if (v < nvec) {
        x[u] = __ldcg(va + v);
        y[u] = __ldcg(vb + v);
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const size_t v = v0 + (size_t)u * blockDim.x;
      if (v < nvec) {
        va[v] = make_float4((x[u].x + y[u].x) - logz, (x[u].y + y[u].y) - logz,
                            (x[u].z + y[u].z) - logz,
                            (x[u].w + y[u].w) - logz);
      }
    }
  }
  for (size_t i = head + 4 * nvec + threadIdx.x; i < vend; i += blockDim.x) {
    ga[i] = (__ldcg(ga + i) + __ldcg(gb + i)) - logz;
  }
  for (size_t i = max(lo, valid) + threadIdx.x; i < hi; i += blockDim.x) {
    ga[i] = NEG_INF;
  }
}

// K2's counterpart: see the header. A cluster of two blocks an utterance:
// block 2b runs alpha, block 2b+1 beta, each on warps 0..W-1, with warp W
// filling the block's ring of `slots` slots of K2_CHUNK frames
// (global_slots). Alpha's history goes into gamma and beta's into bws [B,
// T, S]; both are read back only after the cluster's barrier, by either
// block, so neither pointer is read-only or restrict.
template <int P>
__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(K2_WARPS * 32)
    ctc_dp_global_kernel(const float* __restrict__ label_logp,
                         const int* __restrict__ in_lens,
                         const int* __restrict__ s_lens,
                         const unsigned char* __restrict__ allow2, int t_len,
                         int s_n, int slots, float* loss, float* gamma,
                         float* bws) {
  extern __shared__ float smem[];  // the ring [slots][K2_CHUNK * S]
  __shared__ uint64_t full[K2_MAX_SLOTS], empty[K2_MAX_SLOTS];
  // [step parity][warp]: the two values a warp hands on
  __shared__ __align__(8) float edge[2][K2_MAX_W][2];
  __shared__ float ends[2];

  const int nw = (s_n + 32 * P - 1) / (32 * P);  // W, warps a recursion
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const bool is_alpha = (blockIdx.x & 1) == 0;  // the block's cluster rank
  const int b = blockIdx.x >> 1;
  const int n = max(0, min(in_lens[b], t_len));  // frames to walk
  const int slen = s_lens[b];
  const int end1 = slen - 1;
  const int end2 = max(slen - 2, 0);
  const size_t plane = (size_t)t_len * s_n;
  const float* lp = label_logp + b * plane;
  float* ga = gamma + b * plane;  // alpha's rows, then gamma
  float* gb = bws + b * plane;    // beta's rows
  const unsigned char* a2row = allow2 + (size_t)b * s_n;
  const Ring rg = {smem, full, empty, slots, s_n, n, is_alpha ? 0 : 1};

  if (threadIdx.x == 0) {
    for (int i = 0; i < slots; ++i) {
      mbar_init(&full[i], 32);        // the producer's lanes
      mbar_init(&empty[i], 32 * nw);  // the recursion's threads
    }
    ends[0] = NEG_INF;
    ends[1] = NEG_INF;
  }
  __syncthreads();

  if (warp == nw) {
    // ---- the producer: the ring, chunk by chunk
    const int chunks = (rg.items() + K2_CHUNK - 1) / K2_CHUNK;
    for (int c = 0; c < chunks; ++c) rg.fill(c, lp, lane);
  } else if (warp < nw && n >= 1) {
    const int k = warp;  // this warp's place in its recursion
    const int s0 = (k * 32 + lane) * P;
    const bool chained = nw > 1;
    const int bar_count = 32 * nw;
    // a step: the neighbours (shuffles; the edge pair from the next warp,
    // a broadcast read that lanes other than `both` and `second` ignore),
    // the lae3, the edge pair handed on; then, off the chain while the
    // recursion's warps meet at the barrier, the history row and the next
    // frame's label_logp
    const int from = !chained ? k : is_alpha ? max(k - 1, 0) : min(k + 1, nw - 1);
    const bool taking = chained && from != k;
    const bool both = taking && lane == (is_alpha ? 0 : 31);
    const bool second = taking && P == 1 && lane == (is_alpha ? 1 : 30);
    if (is_alpha) {
      // ---- alpha over frames 0..n-1
      Ring::Cursor cur = rg.start();
      bool on[P], skip_in[P];
      float alpha[P], lp_t[P] = {};  // lp_t: frame t, fetched at step t-1
      const float* row0 = rg.next(cur);
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int s = s0 + q;
        on[q] = s < s_n;
        skip_in[q] = on[q] && s >= 2 && a2row[s] != 0;  // s-2 -> s
        alpha[q] = (on[q] && s < 2 && s < slen) ? row0[s] : NEG_INF;
        if (on[q]) ga[s] = alpha[q];
      }
      if (n > 1) {
        const float* r = rg.next(cur);
#pragma unroll
        for (int q = 0; q < P; ++q) lp_t[q] = on[q] ? r[s0 + q] : 0.0f;
      }
      if (chained) {
        alpha_hand_on<P>(edge[0][k], alpha, lane);
        group_sync(1, bar_count);
      }
      float* out = ga + (size_t)s_n + s0;  // row t
      for (int t = 1; t < n; ++t, out += s_n) {
        float up1, up2;
        alpha_from_below<P>(alpha, up1, up2);
        take_edge(edge[(t - 1) & 1][from], both, second, up1, up2);
        alpha_step<P>(alpha, lp_t, on, skip_in, s0, up1, up2);
        if (chained) alpha_hand_on<P>(edge[t & 1][k], alpha, lane);
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (on[q]) out[q] = alpha[q];
        }
        if (t + 1 < n) {
          const float* r = rg.next(cur);
#pragma unroll
          for (int q = 0; q < P; ++q) lp_t[q] = on[q] ? r[s0 + q] : 0.0f;
        }
        if (chained) group_sync(1, bar_count);
      }
      // logZ's ends s_len-1 and max(s_len-2, 0) at step n-1, each once
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int s = s0 + q;
        if (on[q] && s == end1) ends[0] = alpha[q];
        if (on[q] && s == end2 && end2 != end1) ends[1] = alpha[q];
      }
    } else {
      // ---- beta over frames n-1..0: step i takes bn0 = beta[i+1] +
      // label_logp[i+1], formed at the end of step i+1
      Ring::Cursor cur = rg.start();
      bool on[P], skip_out[P];
      float beta[P], bn0[P] = {};
      float lp_i[P] = {};  // frame i, fetched at step i+1
      float* last = gb + (size_t)(n - 1) * s_n + s0;
#pragma unroll
      for (int q = 0; q < P; ++q) {
        const int s = s0 + q;
        on[q] = s < s_n;
        skip_out[q] = on[q] && s + 2 < s_n && a2row[s + 2] != 0;  // s -> s+2
        beta[q] = (on[q] && (s == end1 || s == end2)) ? 0.0f : NEG_INF;
        if (on[q]) last[q] = beta[q];
      }
      if (n > 1) {
        const float* r = rg.next(cur);  // frame n-1
#pragma unroll
        for (int q = 0; q < P; ++q) {
          bn0[q] = on[q] ? beta[q] + r[s0 + q] : NEG_INF;
        }
        if (n > 2) {
          const float* r2 = rg.next(cur);  // frame n-2
#pragma unroll
          for (int q = 0; q < P; ++q) lp_i[q] = on[q] ? r2[s0 + q] : 0.0f;
        }
        if (chained) {
          beta_hand_on<P>(edge[0][k], bn0, lane);
          group_sync(1, bar_count);
        }
      }
      int parity = 0;
      float* out = gb + (size_t)max(n - 2, 0) * s_n + s0;  // row i
      for (int i = n - 2; i >= 0; --i, out -= s_n) {
        float dn1, dn2;
        beta_from_above<P>(bn0, dn1, dn2);
        take_edge(edge[parity][from], both, second, dn1, dn2);
        beta_step<P>(beta, bn0, on, skip_out, s0, s_n, dn1, dn2);
        if (i >= 1) {
#pragma unroll
          for (int q = 0; q < P; ++q) {
            bn0[q] = on[q] ? beta[q] + lp_i[q] : NEG_INF;  // frame i
          }
          parity ^= 1;
          if (chained) beta_hand_on<P>(edge[parity][k], bn0, lane);
        }
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (on[q]) out[q] = beta[q];
        }
        if (i >= 2) {
          const float* r = rg.next(cur);  // frame i-1
#pragma unroll
          for (int q = 0; q < P; ++q) lp_i[q] = on[q] ? r[s0 + q] : 0.0f;
        }
        if (chained && i >= 1) group_sync(1, bar_count);
      }
    }
  }
  __syncthreads();  // the block's history and, in alpha's, the ends
  if (is_alpha && threadIdx.x == 0) {
    loss[b] = -lae3(ends[0], ends[1], NEG_INF);
  }
  cluster_sync();  // both histories and the loss, in both blocks

  // ---- gamma = (alpha + beta) - logZ over the n walked frames, NEG_INF
  // past them: alpha's block the first half of the utterance's elements,
  // beta's the rest. The other block's rows come from L2 (ldcg).
  const float logz = -__ldcg(loss + b);
  const size_t mid = (plane / 2) & ~(size_t)3;
  gamma_range(ga, gb, is_alpha ? 0 : mid, is_alpha ? mid : plane,
              (size_t)n * s_n, logz);
}

// The chain's step with no memory traffic: each of two warps runs
// `steps` dependent lae3 + add steps, each followed by a named barrier of
// its warp, K1's alpha and beta steps without their neighbours.
__global__ void ctc_chain_step_kernel(int steps, float b, float c,
                                      float* __restrict__ out) {
  const int id = 1 + (int)threadIdx.x / 32;
  float a = 0.001f * threadIdx.x;
  for (int i = 0; i < steps; ++i) {
    a = lae3(a, b, c) + b;
    group_sync(id, 32);
  }
  out[threadIdx.x] = a;
}

// Positions a lane of a recursion at S: K1's, and K2's (the fewest from
// 1 up, in powers of two, that K2_MAX_W warps cover S with); K2's ring
// slots at S.
int pair_p(int s_n) { return s_n <= 32 ? 1 : s_n <= 64 ? 2 : 4; }
int global_p(int s_n) {
  int p = 1;
  while (32 * p * K2_MAX_W < s_n) p *= 2;
  return p;
}
int global_slots(int s_n) {
  return min(K2_MAX_SLOTS, K2_RING_BYTES / (K2_CHUNK * s_n * 4));
}

// Dynamic shared memory of each kernel at (T, S), in bytes.
long long pair_smem(int t_len, int s_n) { return 2LL * t_len * s_n * 4; }
long long global_smem(int s_n) {
  return 4LL * global_slots(s_n) * K2_CHUNK * s_n;
}

// raise a kernel's dynamic shared memory limit once per larger size, so a
// later launch of the same shape (inside a CUDA graph capture, say) makes
// no attribute call
int raise_smem(const void* kernel, size_t smem, size_t* configured) {
  if (smem <= *configured) return 0;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  *configured = smem;
  return 0;
}

template <int P>
int launch_pair(const float* lp, const int* il, const int* sl,
                const unsigned char* a2, int batch, int t_len, int s_n,
                float* lo, float* ga, cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const size_t smem = (size_t)pair_smem(t_len, s_n);
  const int rc = raise_smem((const void*)ctc_dp_pair_kernel<P>, smem,
                            &configured);
  if (rc != 0) return rc;
  ctc_dp_pair_kernel<P><<<batch, K1_WARPS * 32, smem, st>>>(
      lp, il, sl, a2, t_len, s_n, lo, ga);
  return (int)cudaGetLastError();
}

template <int P>
int launch_global(const float* lp, const int* il, const int* sl,
                  const unsigned char* a2, int batch, int t_len, int s_n,
                  float* lo, float* ga, float* ws, cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const size_t smem = (size_t)global_smem(s_n);
  const int rc = raise_smem((const void*)ctc_dp_global_kernel<P>, smem,
                            &configured);
  if (rc != 0) return rc;
  ctc_dp_global_kernel<P><<<2 * batch, K2_WARPS * 32, smem, st>>>(
      lp, il, sl, a2, t_len, s_n, global_slots(s_n), lo, ga, ws);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, that a variant needs at (T, S):
// smem_hist = 1 is K1's counterpart (both histories in shared memory), 0
// is K2's (its two label_logp rings).
extern "C" long long openeat_ctc_dp_smem_bytes(int t_len, int s_n,
                                               int smem_hist) {
  return smem_hist ? pair_smem(t_len, s_n) : global_smem(s_n);
}

// K2's plan at S: positions a lane, warps a recursion, ring slots, and
// the block's threads, into out[4]. Returns 0.
extern "C" int openeat_ctc_global_plan(int s_n, int* out) {
  const int p = global_p(s_n);
  out[0] = p;
  out[1] = (s_n + 32 * p - 1) / (32 * p);
  out[2] = global_slots(s_n);
  out[3] = K2_WARPS * 32;
  return 0;
}

// label_logp [batch, t_len, s_n] float32, in_lens/s_lens [batch] int32,
// allow2 [batch, s_n] uint8 (0/1), all contiguous on the device. Writes
// loss [batch] and gamma [batch, t_len, s_n] (float32). smem_hist = 1
// runs K1's counterpart (s_n <= 128; workspace unused, may be null), 0
// K2's (s_n <= 1024), which keeps beta's history in `workspace`, float32
// [batch, t_len, s_n] on the device. Launches one kernel on `stream` and
// returns a cudaError_t (0 on success).
extern "C" int openeat_ctc_dp(const void* label_logp, const void* in_lens,
                              const void* s_lens, const void* allow2,
                              void* loss, void* gamma, void* workspace,
                              int batch, int t_len, int s_n, int smem_hist,
                              void* stream) {
  if (batch <= 0 || t_len <= 0 || s_n <= 0 ||
      s_n > (smem_hist ? PAIR_MAX_S : MAX_S) ||
      (!smem_hist && workspace == nullptr)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(label_logp);
  const int* il = static_cast<const int*>(in_lens);
  const int* sl = static_cast<const int*>(s_lens);
  const unsigned char* a2 = static_cast<const unsigned char*>(allow2);
  float* lo = static_cast<float*>(loss);
  float* ga = static_cast<float*>(gamma);
  float* ws = static_cast<float*>(workspace);
  if (smem_hist) {
    const int p = pair_p(s_n);
    if (p == 1) return launch_pair<1>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, st);
    if (p == 2) return launch_pair<2>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, st);
    return launch_pair<4>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, st);
  }
  const int p = global_p(s_n);
  if (p == 1) return launch_global<1>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, ws, st);
  if (p == 2) return launch_global<2>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, ws, st);
  return launch_global<4>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, ws, st);
}

// Two warps run `steps` chain steps each (ctc_chain_step_kernel) and
// write out [64]. Timed at two step counts, the difference over the steps
// is one step's time. Returns a cudaError_t.
extern "C" int openeat_ctc_chain_step(int steps, void* out, void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  ctc_chain_step_kernel<<<1, 64, 0, static_cast<cudaStream_t>(stream)>>>(
      steps, -1.0f, -2.0f, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

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
// One block per utterance.
//
// K1's counterpart (ctc_dp_pair_kernel, both histories in shared memory)
// runs alpha and beta at once: the two recursions are independent (only
// gamma needs both, and logZ), so warp 0 walks alpha and warp 1 beta,
// and the chain is len steps rather than 2 x len. A lane owns P = S / 32
// rounded up label positions (P <= K1_MAX_P, so S <= 128) and takes the
// neighbours it does not own from the next lane down (alpha) or up
// (beta) by shuffles: a step waits on no barrier and on no other thread's
// memory, and the P lae3 of a lane are evaluated phase by phase
// (lae3_p) so that their dependent chains interleave. First all
// K1_WARPS warps copy the utterance's label_logp rows with cp.async into
// both [T, S] histories, which alpha and beta then overwrite in place,
// reading each frame's row a step before they replace it, so no step
// waits on device memory and nothing but the chain runs on the two
// recursing warps. When both are done and logZ is known, all warps write
// gamma = alpha + beta - logZ, NEG_INF at t >= len, as
// openeat_tpu/ops/ctc_loss.py:324-329 does. Neither recursion walks past
// len: alpha is frozen and beta held there, and gamma is NEG_INF.
// Designs measured slower on the H100 (PERF.md, PR 4): groups of S
// threads stepping on named barriers with their neighbours in shared
// memory; label_logp staged through rings of frame chunks by the
// recursing warps themselves; beta's history kept in the gamma output
// and read back for the gamma pass; more than 4 positions a lane, where
// a step costs more than K2's two.
//
// K2's counterpart (ctc_dp_global_kernel, for T x S too tall for shared
// memory) walks alpha, then beta, in one group of threads with one
// __syncthreads per step; alpha's history lives in the gamma output in
// device memory (each thread rereads only what it wrote), with the
// current row double-buffered in shared memory, and gamma is written on
// the fly during the beta pass.
//
// Arithmetic follows the JAX kernels term for term, the same in both:
// NEG_INF = -1e30 as the log of zero (never -inf, since -inf - -inf is
// NaN), the lae3 guard (ms = 0 where m <= NEG_INF), alpha frozen past
// the input length, the final alpha row captured at t = len-1, logZ over
// the ends s_len-1 and max(s_len-2, 0) counted once each, beta reset at
// len-1 and held past it. expf/logf, no fast math: both kernels agree
// with openeat_torch/ops/ctc_loss.py:ctc_dp_plain bit for bit.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float NEG_INF = -1.0e30f;
constexpr int K1_MAX_P = 4;      // K1: label positions per lane
constexpr int PAIR_MAX_S = 32 * K1_MAX_P;
constexpr int K1_WARPS = 8;      // K1's block; warps 0 and 1 recur
constexpr int MAX_S = 1024;      // K2: one thread per label position

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

// all `count` threads of barrier `id` (a multiple of 32: whole warps)
__device__ __forceinline__ void group_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// 4 bytes from src to dst in shared memory, asynchronously
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// returns once every cp.async of this thread has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// K1's counterpart. All K1_WARPS warps first copy the utterance's
// label_logp rows into both histories; then warp 0 runs alpha and warp 1
// beta, each overwriting its history in place (a lane reads frame t of
// its own columns before it writes step t there); then all warps write
// gamma. Lane l owns the P label positions s = l x P + p, p < P, of its
// recursion (S <= 32 x P) and takes the neighbours it does not own from
// lane l - 1 (alpha: s-1, s-2) or l + 1 (beta: s+1, s+2) by shuffles, so
// a step waits on no barrier and no memory but its own shared memory.
template <int P>
__global__ void __launch_bounds__(K1_WARPS * 32)
    ctc_dp_pair_kernel(const float* __restrict__ label_logp,
                       const int* __restrict__ in_lens,
                       const int* __restrict__ s_lens,
                       const unsigned char* __restrict__ allow2, int t_len,
                       int s_n, float* __restrict__ loss,
                       float* __restrict__ gamma) {
  constexpr unsigned ALL = 0xffffffffu;
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
      // lane l-1's last two positions: s0 - 1 and s0 - 2
      const float up1 = __shfl_up_sync(ALL, alpha[P - 1], 1);
      const float up2 = __shfl_up_sync(ALL, alpha[P > 1 ? P - 2 : 0],
                                       P > 1 ? 1 : 2);
      float nw[P], a1[P], a2[P], l3[P];
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
      for (int q = 0; q < P; ++q) {
        nw[q] = on[q] ? l3[q] + lp_t[q] : NEG_INF;
      }
#pragma unroll
      for (int q = 0; q < P; ++q) {
        alpha[q] = nw[q];
        if (on[q]) row[q] = nw[q];
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
      // lane l+1's first two positions: s0 + P and s0 + P + 1
      const float dn1 = __shfl_down_sync(ALL, bn0[0], 1);
      const float dn2 = __shfl_down_sync(ALL, bn0[P > 1 ? 1 : 0],
                                         P > 1 ? 1 : 2);
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
      for (int q = 0; q < P; ++q) {
        beta[q] = on[q] ? l3[q] : NEG_INF;
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

// K2's counterpart: alpha, then beta, one thread per label position
// (blockDim = S rounded up to a warp).
__global__ void ctc_dp_global_kernel(const float* __restrict__ label_logp,
                                     const int* __restrict__ in_lens,
                                     const int* __restrict__ s_lens,
                                     const unsigned char* __restrict__ allow2,
                                     int t_len, int s_n,
                                     float* __restrict__ loss,
                                     float* __restrict__ gamma) {
  extern __shared__ float smem[];
  __shared__ float ends[2];
  float* rows = smem;  // [2][S]

  const int b = blockIdx.x;
  const int s = threadIdx.x;
  const bool on = s < s_n;
  const int len = in_lens[b];
  const int slen = s_lens[b];
  const float* lp = label_logp + (size_t)b * t_len * s_n;
  float* gb = gamma + (size_t)b * t_len * s_n;
  const unsigned char* a2row = allow2 + (size_t)b * s_n;
  const bool skip_in = on && s >= 2 && a2row[s] != 0;            // s-2 -> s
  const bool skip_out = on && s + 2 < s_n && a2row[s + 2] != 0;  // s -> s+2

  if (s == 0) {
    ends[0] = NEG_INF;
    ends[1] = NEG_INF;
  }

  // ---- alpha
  float alpha = (on && s < 2 && s < slen) ? lp[s] : NEG_INF;
  float final_row = (len == 1) ? alpha : NEG_INF;
  if (on) {
    rows[s] = alpha;
    gb[s] = alpha;
  }
  float lp_next = (on && t_len > 1) ? lp[s_n + s] : 0.0f;
  __syncthreads();
  for (int t = 1; t < t_len; ++t) {
    const float lp_t = lp_next;
    if (on && t + 1 < t_len) lp_next = lp[(size_t)(t + 1) * s_n + s];
    const float* prev = rows + ((t - 1) & 1) * s_n;
    if (on) {
      const float a1 = (s >= 1) ? prev[s - 1] : NEG_INF;
      const float a2 = skip_in ? prev[s - 2] : NEG_INF;
      float nw = lae3(alpha, a1, a2) + lp_t;
      nw = (t < len) ? nw : alpha;
      alpha = nw;
      if (t == len - 1) final_row = nw;
      rows[(t & 1) * s_n + s] = nw;
      gb[(size_t)t * s_n + s] = nw;
    }
    __syncthreads();
  }

  // ---- logZ over the ends s_len-1 and max(s_len-2, 0), each once
  const int end1 = slen - 1;
  const int end2 = max(slen - 2, 0);
  if (on && s == end1) ends[0] = final_row;
  if (on && s == end2 && end2 != end1) ends[1] = final_row;
  __syncthreads();
  const float logz = lae3(ends[0], ends[1], NEG_INF);
  if (s == 0) loss[b] = -logz;

  // ---- beta, gamma on the fly. rows[i & 1] holds bnext = beta[i+1] +
  // label_logp[i+1] for step i.
  const float beta_init = (on && (s == end1 || s == end2)) ? 0.0f : NEG_INF;
  float beta = beta_init;
  {
    const int t = t_len - 1;
    if (on) {
      const float a = gb[(size_t)t * s_n + s];
      gb[(size_t)t * s_n + s] = (t < len) ? a + beta - logz : NEG_INF;
    }
  }
  float lp_b = (on && t_len > 1) ? lp[(size_t)(t_len - 1) * s_n + s] : 0.0f;
  for (int i = t_len - 2; i >= 0; --i) {
    const float lp_i1 = lp_b;  // label_logp at frame i+1
    if (on && i >= 1) lp_b = lp[(size_t)i * s_n + s];
    float* buf = rows + (i & 1) * s_n;
    const float bn0 = beta + lp_i1;
    if (on) buf[s] = bn0;
    __syncthreads();
    if (on) {
      const float bn1 = (s + 1 < s_n) ? buf[s + 1] : NEG_INF;
      const float bn2 = skip_out ? buf[s + 2] : NEG_INF;
      float nw = lae3(bn0, bn1, bn2);
      nw = (i == len - 1) ? beta_init : nw;
      nw = (i > len - 1) ? beta : nw;
      beta = nw;
      const float a = gb[(size_t)i * s_n + s];
      gb[(size_t)i * s_n + s] = (i < len) ? a + nw - logz : NEG_INF;
    }
  }
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

// Dynamic shared memory of each kernel at (T, S), in bytes.
long long pair_smem(int t_len, int s_n) { return 2LL * t_len * s_n * 4; }
long long global_smem(int s_n) { return 2LL * s_n * 4; }

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
                float* lo, float* ga, size_t smem, cudaStream_t st) {
  static size_t configured = 48 * 1024;
  const int rc = raise_smem((const void*)ctc_dp_pair_kernel<P>, smem,
                            &configured);
  if (rc != 0) return rc;
  ctc_dp_pair_kernel<P><<<batch, K1_WARPS * 32, smem, st>>>(
      lp, il, sl, a2, t_len, s_n, lo, ga);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, that a variant needs at (T, S):
// smem_hist = 1 is K1's counterpart (both histories in shared memory), 0
// is K2's (alpha's history in device memory).
extern "C" long long openeat_ctc_dp_smem_bytes(int t_len, int s_n,
                                               int smem_hist) {
  return smem_hist ? pair_smem(t_len, s_n) : global_smem(s_n);
}

// label_logp [batch, t_len, s_n] float32, in_lens/s_lens [batch] int32,
// allow2 [batch, s_n] uint8 (0/1), all contiguous on the device. Writes
// loss [batch] and gamma [batch, t_len, s_n] (float32). smem_hist = 1
// runs K1's counterpart (s_n <= 128), 0 K2's (s_n <= 1024). Launches one
// kernel on `stream` and returns a cudaError_t (0 on success).
extern "C" int openeat_ctc_dp(const void* label_logp, const void* in_lens,
                              const void* s_lens, const void* allow2,
                              void* loss, void* gamma, int batch, int t_len,
                              int s_n, int smem_hist, void* stream) {
  if (batch <= 0 || t_len <= 0 || s_n <= 0 ||
      s_n > (smem_hist ? PAIR_MAX_S : MAX_S)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(label_logp);
  const int* il = static_cast<const int*>(in_lens);
  const int* sl = static_cast<const int*>(s_lens);
  const unsigned char* a2 = static_cast<const unsigned char*>(allow2);
  float* lo = static_cast<float*>(loss);
  float* ga = static_cast<float*>(gamma);
  const int grp = (s_n + 31) / 32 * 32;
  if (smem_hist) {
    const size_t smem = (size_t)pair_smem(t_len, s_n);
    if (s_n <= 32) {
      return launch_pair<1>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, smem,
                            st);
    } else if (s_n <= 64) {
      return launch_pair<2>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, smem,
                            st);
    }
    return launch_pair<4>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, smem,
                          st);
  } else {
    static size_t configured = 48 * 1024;
    const size_t smem = (size_t)global_smem(s_n);
    const int rc = raise_smem((const void*)ctc_dp_global_kernel, smem,
                              &configured);
    if (rc != 0) return rc;
    ctc_dp_global_kernel<<<batch, grp, smem, st>>>(lp, il, sl, a2, t_len,
                                                   s_n, lo, ga);
  }
  return (int)cudaGetLastError();
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

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
// Bound: latency. The work is 2*T dependent steps per utterance of a few
// operations per label position; the bytes (label_logp read once, gamma
// written once) take well under a microsecond at the training shapes, so
// the kernel is bound by the chain of steps, not by bytes or operations.
//
// Design: one block per utterance, one thread per label position s
// (blockDim = S rounded up to a warp, S <= 1024), T walked in order
// inside the block with one __syncthreads per step. A step reads its
// neighbours s-1, s-2 (alpha) or s+1, s+2 (beta) from shared memory and
// prefetches the next step's label_logp into a register. The two
// variants differ only in where alpha's [T, S] history lives for the
// beta pass:
//   SMEM_HIST = true  (K1's counterpart): in dynamic shared memory,
//       T*S*4 bytes, up to the 227 KB a block may have;
//   SMEM_HIST = false (K2's counterpart): in the gamma output itself in
//       device memory (each thread rereads only what it wrote), with
//       the current row double-buffered in shared memory.
// Both write gamma on the fly during the beta pass.
//
// Arithmetic follows the JAX kernels term for term: NEG_INF = -1e30 as
// the log of zero (never -inf, since -inf - -inf is NaN), the lae3 guard
// (ms = 0 where m <= NEG_INF), alpha frozen past the input length, the
// final alpha row captured at t = len-1, logZ over the ends s_len-1 and
// max(s_len-2, 0) counted once each, beta reset at len-1 and held past
// it. expf/logf, no fast math.

#include <cuda_runtime.h>

namespace {

constexpr float NEG_INF = -1.0e30f;

__device__ __forceinline__ float lae3(float a, float b, float c) {
  const float m = fmaxf(a, fmaxf(b, c));
  const float ms = (m <= NEG_INF) ? 0.0f : m;
  const float out = ms + logf(expf(a - ms) + expf(b - ms) + expf(c - ms));
  return (m <= NEG_INF) ? NEG_INF : out;
}

template <bool SMEM_HIST>
__global__ void ctc_dp_kernel(const float* __restrict__ label_logp,
                              const int* __restrict__ in_lens,
                              const int* __restrict__ s_lens,
                              const unsigned char* __restrict__ allow2,
                              int t_len, int s_n, float* __restrict__ loss,
                              float* __restrict__ gamma) {
  extern __shared__ float smem[];
  __shared__ float ends[2];
  // K1: hist [T][S] then rows [2][S]; K2: rows [2][S] only
  float* hist = smem;
  float* rows = SMEM_HIST ? smem + (size_t)t_len * s_n : smem;

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
    if (SMEM_HIST) {
      hist[s] = alpha;
    } else {
      rows[s] = alpha;
      gb[s] = alpha;
    }
  }
  float lp_next = (on && t_len > 1) ? lp[s_n + s] : 0.0f;
  __syncthreads();
  for (int t = 1; t < t_len; ++t) {
    const float lp_t = lp_next;
    if (on && t + 1 < t_len) lp_next = lp[(size_t)(t + 1) * s_n + s];
    const float* prev = SMEM_HIST ? hist + (size_t)(t - 1) * s_n
                                  : rows + ((t - 1) & 1) * s_n;
    if (on) {
      const float a1 = (s >= 1) ? prev[s - 1] : NEG_INF;
      const float a2 = skip_in ? prev[s - 2] : NEG_INF;
      float nw = lae3(alpha, a1, a2) + lp_t;
      nw = (t < len) ? nw : alpha;
      alpha = nw;
      if (t == len - 1) final_row = nw;
      if (SMEM_HIST) {
        hist[(size_t)t * s_n + s] = nw;
      } else {
        rows[(t & 1) * s_n + s] = nw;
        gb[(size_t)t * s_n + s] = nw;
      }
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
      const float a = SMEM_HIST ? hist[(size_t)t * s_n + s]
                                : gb[(size_t)t * s_n + s];
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
      const float a = SMEM_HIST ? hist[(size_t)i * s_n + s]
                                : gb[(size_t)i * s_n + s];
      gb[(size_t)i * s_n + s] = (i < len) ? a + nw - logz : NEG_INF;
    }
  }
}

template <bool SMEM_HIST>
int launch(const float* lp, const int* in_lens, const int* s_lens,
           const unsigned char* allow2, int batch, int t_len, int s_n,
           float* loss, float* gamma, cudaStream_t stream) {
  const int threads = (s_n + 31) / 32 * 32;
  const size_t smem =
      ((SMEM_HIST ? (size_t)t_len * s_n : 0) + 2 * (size_t)s_n) *
      sizeof(float);
  // raise the kernel's dynamic shared memory limit once per size, so a
  // later launch of the same shape (inside a CUDA graph capture, say)
  // makes no attribute call
  static size_t configured = 48 * 1024;
  if (smem > configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        ctc_dp_kernel<SMEM_HIST>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
    configured = smem;
  }
  ctc_dp_kernel<SMEM_HIST><<<batch, threads, smem, stream>>>(
      lp, in_lens, s_lens, allow2, t_len, s_n, loss, gamma);
  return (int)cudaGetLastError();
}

}  // namespace

// Dynamic shared memory, in bytes, that a variant needs at (T, S):
// smem_hist = 1 is K1's counterpart (alpha history in shared memory),
// 0 is K2's (history in device memory).
extern "C" long long openeat_ctc_dp_smem_bytes(int t_len, int s_n,
                                               int smem_hist) {
  return ((smem_hist ? (long long)t_len * s_n : 0) + 2LL * s_n) * 4;
}

// label_logp [batch, t_len, s_n] float32, in_lens/s_lens [batch] int32,
// allow2 [batch, s_n] uint8 (0/1), all contiguous on the device. Writes
// loss [batch] and gamma [batch, t_len, s_n] (float32). Launches on
// `stream` and returns a cudaError_t (0 on success).
extern "C" int openeat_ctc_dp(const void* label_logp, const void* in_lens,
                              const void* s_lens, const void* allow2,
                              void* loss, void* gamma, int batch, int t_len,
                              int s_n, int smem_hist, void* stream) {
  if (batch <= 0 || t_len <= 0 || s_n <= 0 || s_n > 1024) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* lp = static_cast<const float*>(label_logp);
  const int* il = static_cast<const int*>(in_lens);
  const int* sl = static_cast<const int*>(s_lens);
  const unsigned char* a2 = static_cast<const unsigned char*>(allow2);
  float* lo = static_cast<float*>(loss);
  float* ga = static_cast<float*>(gamma);
  if (smem_hist) {
    return launch<true>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, st);
  }
  return launch<false>(lp, il, sl, a2, batch, t_len, s_n, lo, ga, st);
}

// Multi-tensor kernels of the training update for Hopper (sm_90a):
// gradient gather, global norm, and clip + Adam with the bfloat16 weight
// mirror (openeat_torch/ops/multi_tensor.py, utils/weight_mirror.py).
//
// They replace no TPU kernel. The JAX package's update is one jitted XLA
// program (openeat_tpu/parallel/train_step.py: optax's global norm, clip
// and adam), which XLA fuses. Eager PyTorch spends a few launches a
// parameter on the same work (a square and a sum for the norm, Adam's
// foreach ops, a cast at each use and its backward), and in the
// benchmark's Conformers (620 parameters) those launches, not the bytes,
// bound the update. Each kernel here walks every parameter in one launch.
//
// The layout (ops/multi_tensor.py:ParamTable): the parameters lie end to
// end in two flat buffers, the float32 gradient accumulator and the
// bfloat16 mirror, each parameter's slice at `offset` (a multiple of 8
// elements). A table of Entry rows, one a parameter, holds the addresses
// of the float32 parameter and of Adam's two moments (0 for a parameter
// the optimizer does not update), its offset and size; a block map
// assigns each block one CHUNK of one parameter. Both are built once, in
// device memory, when the table is.
//
// Bound: device-memory bytes, each byte once. The gather reads each new
// gradient (2 bytes bf16 or 4 float32) and, after the first micro-batch,
// the accumulator (4), and writes it (4). The norm reads the accumulator
// (4 bytes a parameter) and sums squares in double in a fixed order:
// each of NORM_BLOCKS blocks takes a fixed slice and the last block to
// finish (an integer ticket) adds the slices' sums in block order, so two
// runs give the same bits. Adam reads the parameter, the gradient and
// both moments (16 bytes) and writes the parameter, the moments (12) and
// the mirror (2): 30 bytes a parameter, about 0.29 ms for AIShell's 32.6
// M parameters at 3.35 TB/s. Adjacent threads take adjacent elements:
// four a thread an iteration in the gather (8- and 16-byte loads, the
// gradients' slices being aligned), one in Adam, whose four loads an
// element are independent and keep enough bytes in flight.
//
// The gather's per-micro-batch gradient addresses change with every
// backward (autograd allocates the gradients), so they travel as kernel
// parameters, up to GATHER_MAX entries a launch (16,000 bytes; Hopper
// with CUDA 12.1 or later takes 32,764 bytes of kernel parameters).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CHUNK = 8192;        // elements of one parameter a block walks
constexpr int GATHER_MAX = 1000;   // entries a gather launch
constexpr int NORM_BLOCKS = 264;   // 2 a streaming multiprocessor

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

struct Entry {
  int64_t param;        // float32 [numel]
  int64_t exp_avg;      // float32 [numel], or 0: not updated
  int64_t exp_avg_sq;   // float32 [numel], or 0
  int64_t offset;       // first element in the flat buffers
  int64_t numel;
};

struct GatherSources {
  const __nv_bfloat16* g16[GATHER_MAX];   // a mirror leaf's gradient, or 0
  const float* g32[GATHER_MAX];           // the parameter's own, or 0
};

struct AdamArgs {
  float beta1_weight;     // 1 - beta1: exp_avg's lerp weight
  float beta2;
  float one_minus_beta2;
  float step_size;        // -lr / (1 - beta1^t)
  float bc2_sqrt;         // sqrt(1 - beta2^t)
  float eps;
  float weight_decay;
  float decay;            // AdamW: 1 - lr * weight_decay
  int decoupled;          // AdamW's decay, else Adam's L2 term
};

// acc[offset + i] = (first ? 0 : acc) + f32(g16[i]) + g32[i], times inv
// (1 / accum_grad on the last micro-batch, else 1): AccumulateGrad's
// float32 sums and the train step's divide, in their order. A g32 may be
// the accumulator's own slice (a gradient left from before the step),
// which each element reads before it writes.
__device__ __forceinline__ float gather_one(float t, float acc_old, int first,
                                            float inv) {
  if (!first) t = acc_old + t;
  return inv != 1.0f ? t * inv : t;
}

__global__ void __launch_bounds__(THREADS)
gather_kernel(const Entry* __restrict__ table, const int* __restrict__ blocks,
              int b0, int e0, GatherSources src, float* acc,
              int first, float inv) {
  const int b = b0 + blockIdx.x;
  const int e = blocks[2 * b];
  const int64_t lo = (int64_t)blocks[2 * b + 1] * CHUNK;
  const int n = (int)lmin(CHUNK, table[e].numel - lo);
  const __nv_bfloat16* a = src.g16[e - e0];
  const float* f = src.g32[e - e0];
  if (!first && a == nullptr && f == nullptr && inv == 1.0f) return;
  if (a != nullptr) a += lo;
  if (f != nullptr) f += lo;
  float* out = acc + table[e].offset + lo;
  // four elements a thread where the sources allow 8- and 16-byte loads
  // (the accumulator's slices are 32-byte aligned, chunks 4-aligned)
  int done = 0;
  if ((reinterpret_cast<uintptr_t>(a) & 7) == 0 &&
      (reinterpret_cast<uintptr_t>(f) & 15) == 0) {
    done = n & ~3;
    for (int i = 4 * threadIdx.x; i < done; i += 4 * THREADS) {
      float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (a != nullptr) {
        const uint2 raw = *reinterpret_cast<const uint2*>(a + i);
        const float2 lo2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
        const float2 hi2 = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
        t[0] = lo2.x;
        t[1] = lo2.y;
        t[2] = hi2.x;
        t[3] = hi2.y;
      }
      if (f != nullptr) {
        const float4 q = *reinterpret_cast<const float4*>(f + i);
        if (a != nullptr) {
          t[0] += q.x;
          t[1] += q.y;
          t[2] += q.z;
          t[3] += q.w;
        } else {
          t[0] = q.x;
          t[1] = q.y;
          t[2] = q.z;
          t[3] = q.w;
        }
      }
      float4 o = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (!first) o = *reinterpret_cast<const float4*>(out + i);
      o.x = gather_one(t[0], o.x, first, inv);
      o.y = gather_one(t[1], o.y, first, inv);
      o.z = gather_one(t[2], o.z, first, inv);
      o.w = gather_one(t[3], o.w, first, inv);
      *reinterpret_cast<float4*>(out + i) = o;
    }
  }
  for (int i = done + threadIdx.x; i < n; i += THREADS) {
    float t = 0.0f;
    if (a != nullptr) t = __bfloat162float(a[i]);
    if (f != nullptr) t = a != nullptr ? t + f[i] : f[i];
    out[i] = gather_one(t, first ? 0.0f : out[i], first, inv);
  }
}

__device__ double block_sum(double s, double* shm) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(0xffffffffu, s, o);
  if (threadIdx.x % 32 == 0) shm[threadIdx.x / 32] = s;
  __syncthreads();
  double total = 0.0;
  if (threadIdx.x == 0) {
    for (int w = 0; w < THREADS / 32; ++w) total += shm[w];
  }
  return total;   // in thread 0
}

// out[0] = sqrt(sum acc^2) (float32), out[1] = min(1, clip / max(out[0],
// 1e-12)) written as the train step writes it (the reciprocal times clip).
// n is a multiple of 4 and acc 16-byte aligned.
__global__ void __launch_bounds__(THREADS)
norm_kernel(const float* __restrict__ acc, int64_t n, double* partial,
            unsigned int* ticket, float clip, float* out) {
  __shared__ double shm[THREADS / 32];
  __shared__ bool last;
  const int64_t quads = n / 4;
  const int64_t per = (quads + gridDim.x - 1) / gridDim.x;
  const int64_t lo = (int64_t)blockIdx.x * per;
  const int64_t hi = lmin(lo + per, quads);
  const float4* v = reinterpret_cast<const float4*>(acc);
  double s = 0.0;
  for (int64_t i = lo + threadIdx.x; i < hi; i += THREADS) {
    const float4 g = v[i];
    s += (double)g.x * g.x + (double)g.y * g.y + (double)g.z * g.z +
         (double)g.w * g.w;
  }
  s = block_sum(s, shm);
  if (threadIdx.x == 0) {
    partial[blockIdx.x] = s;
    __threadfence();
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last || threadIdx.x != 0) return;
  __threadfence();
  const volatile double* sums = partial;
  double total = 0.0;
  for (unsigned int blk = 0; blk < gridDim.x; ++blk) total += sums[blk];
  const float gnorm = (float)sqrt(total);
  out[0] = gnorm;
  out[1] = fminf((1.0f / fmaxf(gnorm, 1e-12f)) * clip, 1.0f);
  *ticket = 0u;   // for the next launch on the stream
}

// torch.optim.Adam / AdamW (single-tensor form) on g = acc * clip_scale,
// then mirror = bf16(param), for every entry with moments.
__global__ void __launch_bounds__(THREADS)
adam_kernel(const Entry* __restrict__ table, const int* __restrict__ blocks,
            const float* __restrict__ acc, const float* __restrict__ clip_scale,
            __nv_bfloat16* __restrict__ mirror, AdamArgs h) {
  const int e = blocks[2 * blockIdx.x];
  if (table[e].exp_avg == 0) return;
  const int64_t lo = (int64_t)blocks[2 * blockIdx.x + 1] * CHUNK;
  const int n = (int)lmin(CHUNK, table[e].numel - lo);
  float* __restrict__ p = reinterpret_cast<float*>(table[e].param) + lo;
  float* __restrict__ m = reinterpret_cast<float*>(table[e].exp_avg) + lo;
  float* __restrict__ v = reinterpret_cast<float*>(table[e].exp_avg_sq) + lo;
  const float* __restrict__ g = acc + table[e].offset + lo;
  __nv_bfloat16* __restrict__ w = mirror + table[e].offset + lo;
  const float scale = *clip_scale;
#pragma unroll 1
  for (int i = threadIdx.x; i < n; i += THREADS) {
    float gi = g[i] * scale;
    float pi = p[i];
    float mi = m[i];
    float vi = v[i];
    if (h.weight_decay != 0.0f) {
      if (h.decoupled) {
        pi = pi * h.decay;
      } else {
        gi = gi + h.weight_decay * pi;
      }
    }
    mi = fabsf(h.beta1_weight) < 0.5f ? mi + h.beta1_weight * (gi - mi)
                                      : gi - (gi - mi) * (1.0f - h.beta1_weight);
    vi = vi * h.beta2;
    vi = vi + h.one_minus_beta2 * (gi * gi);
    const float denom = sqrtf(vi) / h.bc2_sqrt + h.eps;
    pi = pi + h.step_size * (mi / denom);
    p[i] = pi;
    m[i] = mi;
    v[i] = vi;
    w[i] = __float2bfloat16_rn(pi);
  }
}

// mirror = bf16(param) for every entry.
__global__ void __launch_bounds__(THREADS)
mirror_kernel(const Entry* __restrict__ table, const int* __restrict__ blocks,
              __nv_bfloat16* __restrict__ mirror) {
  const int e = blocks[2 * blockIdx.x];
  const int64_t lo = (int64_t)blocks[2 * blockIdx.x + 1] * CHUNK;
  const int n = (int)lmin(CHUNK, table[e].numel - lo);
  const float* __restrict__ p = reinterpret_cast<const float*>(table[e].param) + lo;
  __nv_bfloat16* __restrict__ w = mirror + table[e].offset + lo;
  for (int i = threadIdx.x; i < n; i += THREADS) {
    w[i] = __float2bfloat16_rn(p[i]);
  }
}

}  // namespace

extern "C" {

// The kernels' constants, for the wrapper to check its own against.
int openeat_mt_constants(int* out) {
  out[0] = THREADS;
  out[1] = CHUNK;
  out[2] = GATHER_MAX;
  out[3] = NORM_BLOCKS;
  out[4] = (int)sizeof(Entry);
  return 0;
}

// Entries [e0, e0 + n) of `table`, walked by blocks [b0, b0 + nb) of the
// block map (int32 pairs: entry, chunk). g16 / g32: n host addresses each
// (0 for none). acc: the flat float32 accumulator. Returns a cudaError_t.
int openeat_mt_gather(const void* table, const void* blocks, int b0, int nb,
                      int e0, int n, const long long* g16,
                      const long long* g32, void* acc, int first, float inv,
                      void* stream) {
  if (n < 0 || n > GATHER_MAX || nb < 0 || b0 < 0 || e0 < 0) {
    return (int)cudaErrorInvalidValue;
  }
  if (nb == 0) return 0;
  GatherSources src;
  for (int i = 0; i < GATHER_MAX; ++i) {
    src.g16[i] = i < n ? reinterpret_cast<const __nv_bfloat16*>(g16[i]) : nullptr;
    src.g32[i] = i < n ? reinterpret_cast<const float*>(g32[i]) : nullptr;
  }
  gather_kernel<<<nb, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Entry*>(table), static_cast<const int*>(blocks), b0,
      e0, src, static_cast<float*>(acc), first, inv);
  return (int)cudaGetLastError();
}

// acc float32 [n], n a positive multiple of 4, 16-byte aligned;
// partial: NORM_BLOCKS doubles; ticket: one unsigned int, 0 before the
// first launch (each launch leaves it 0). Writes out[0..1].
int openeat_mt_norm(const void* acc, long long n, void* partial, void* ticket,
                    float clip, void* out, void* stream) {
  if (n <= 0 || n % 4 != 0) return (int)cudaErrorInvalidValue;
  norm_kernel<<<NORM_BLOCKS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(acc), (int64_t)n, static_cast<double*>(partial),
      static_cast<unsigned int*>(ticket), clip, static_cast<float*>(out));
  return (int)cudaGetLastError();
}

// nb blocks of the block map over `table`; clip_scale: one float32 on the
// device (the norm's out[1]). mirror_only = 1 writes the mirror from the
// parameters of every entry and reads nothing else (acc and clip_scale
// may be null).
int openeat_mt_adam(const void* table, const void* blocks, int nb,
                    const void* acc, const void* clip_scale, void* mirror,
                    int mirror_only, float beta1_weight, float beta2,
                    float one_minus_beta2, float step_size, float bc2_sqrt,
                    float eps, float weight_decay, float decay, int decoupled,
                    void* stream) {
  if (nb < 0 || (!mirror_only && (acc == nullptr || clip_scale == nullptr))) {
    return (int)cudaErrorInvalidValue;
  }
  if (nb == 0) return 0;
  const Entry* t = static_cast<const Entry*>(table);
  const int* bl = static_cast<const int*>(blocks);
  __nv_bfloat16* w = static_cast<__nv_bfloat16*>(mirror);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (mirror_only) {
    mirror_kernel<<<nb, THREADS, 0, st>>>(t, bl, w);
  } else {
    const AdamArgs h{beta1_weight, beta2, one_minus_beta2, step_size, bc2_sqrt,
                     eps, weight_decay, decay, decoupled};
    adam_kernel<<<nb, THREADS, 0, st>>>(t, bl, static_cast<const float*>(acc),
                                        static_cast<const float*>(clip_scale),
                                        w, h);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

// Depthwise 1-D convolution, forward, VALID padding, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel openeat_tpu/ops/depthwise_conv.py:_kernel
// (launched by _pallas_dwconv). Same function: x [B, T+K-1, C] (padded by
// the caller), w [K, C] -> out [B, T, C] in x's dtype, no bias, taps
// accumulated in float32 in the order j = 0..K-1.
//
// Bound: device-memory bytes. Each output element costs K multiply-adds
// (2K = 30 flops at the Conformer's K = 15) against one read of its input
// and one write, about 4 flops per byte in float32, below the H100's
// balance of 20 (67 TFLOP/s float32 outside the tensor cores over
// 3.35 TB/s). The least traffic is one read of x and w and one write of
// out: B*(T+K-1)*C + K*C + B*T*C elements.
//
// Design: a block owns (batch row b, a T_TILE slice of output time, a
// C_TILE slice of channels). Threads run along channels, so every load
// and store of the channel-minor [B, T, C] layout is coalesced. The block
// stages its (T_TILE+K-1) x C_TILE input tile (the K-1 halo included) and
// its K x C_TILE taps in shared memory as float32, then each thread
// computes T_TILE / T_ROWS outputs of its channel from shared memory.
// Ragged T and C edges are masked on load (zero fill) and on store.
//
// Each multiply and each add rounds separately (__fmul_rn / __fadd_rn,
// no fused multiply-add), the same arithmetic as the shift-and-add plain
// version in openeat_torch/ops/depthwise_conv.py, so the two agree bit
// for bit. The backward's dgrad runs this same kernel on dy padded by
// K-1 on both sides with the taps reversed, as _bwd does on the TPU.
//
// The backward's wgrad (openeat_dwconv1d_wgrad below) is a [K, C]
// reduction over B*T, also bound by bytes: it must read x and dy once
// and write dw. Pass 1 gives each (channel slice, batch row, time tile)
// block its own partial sums; pass 2 adds the partials in a fixed order.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int C_TILE = 64;  // channels per block, threads along x
constexpr int T_ROWS = 4;   // threads along y
constexpr int T_TILE = 32;  // output time steps per block

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <typename T>
__global__ void __launch_bounds__(C_TILE* T_ROWS)
    dwconv1d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                        T* __restrict__ out, int tp, int c, int k) {
  extern __shared__ float smem[];
  const int t_out = tp - k + 1;
  const int halo = T_TILE + k - 1;
  float* xs = smem;                  // [halo][C_TILE]
  float* ws = smem + halo * C_TILE;  // [k][C_TILE]

  const int b = blockIdx.z;
  const int t0 = blockIdx.y * T_TILE;
  const int cx = threadIdx.x;
  const int ch = blockIdx.x * C_TILE + cx;
  const bool c_ok = ch < c;

  const T* xb = x + (size_t)b * tp * c;
  for (int r = threadIdx.y; r < halo; r += T_ROWS) {
    const int t = t0 + r;
    xs[r * C_TILE + cx] =
        (c_ok && t < tp) ? load_f32(xb + (size_t)t * c + ch) : 0.0f;
  }
  for (int j = threadIdx.y; j < k; j += T_ROWS) {
    ws[j * C_TILE + cx] = c_ok ? load_f32(w + (size_t)j * c + ch) : 0.0f;
  }
  __syncthreads();
  if (!c_ok) return;

  T* ob = out + (size_t)b * t_out * c;
  for (int r = threadIdx.y; r < T_TILE; r += T_ROWS) {
    const int t = t0 + r;
    if (t >= t_out) break;
    const float* xr = xs + r * C_TILE + cx;
    float acc = __fmul_rn(xr[0], ws[cx]);
    for (int j = 1; j < k; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(xr[j * C_TILE], ws[j * C_TILE + cx]));
    }
    store_from_f32(ob + (size_t)t * c + ch, acc);
  }
}

// wgrad, pass 1. dw[j, c] = sum_{b,t} x[b, t+j, c] * dy[b, t, c], the
// weight gradient that the JAX package leaves to XLA (ops/
// depthwise_conv.py:_bwd). A block owns (a C_TILE slice of channels, one
// (b, T_TILE) tile of output time), stages its x halo tile and dy tile
// in shared memory as float32, and writes its K x C_TILE partial sums to
// partial[tile][K][C]. No atomics: pass 2 adds the tiles in a fixed
// order, so the result is the same bits on every run.
template <typename T>
__global__ void __launch_bounds__(C_TILE* T_ROWS)
    dwconv1d_wgrad_partial_kernel(const T* __restrict__ x,
                                  const T* __restrict__ dy,
                                  float* __restrict__ partial, int tp, int c,
                                  int k, int t_tiles) {
  extern __shared__ float smem[];
  const int t_out = tp - k + 1;
  const int halo = T_TILE + k - 1;
  float* xs = smem;                   // [halo][C_TILE]
  float* ds = smem + halo * C_TILE;   // [T_TILE][C_TILE]

  const int tile = blockIdx.y;        // b * t_tiles + time tile
  const int b = tile / t_tiles;
  const int t0 = (tile % t_tiles) * T_TILE;
  const int cx = threadIdx.x;
  const int ch = blockIdx.x * C_TILE + cx;
  const bool c_ok = ch < c;

  const T* xb = x + (size_t)b * tp * c;
  const T* db = dy + (size_t)b * t_out * c;
  for (int r = threadIdx.y; r < halo; r += T_ROWS) {
    const int t = t0 + r;
    xs[r * C_TILE + cx] =
        (c_ok && t < tp) ? load_f32(xb + (size_t)t * c + ch) : 0.0f;
  }
  for (int r = threadIdx.y; r < T_TILE; r += T_ROWS) {
    const int t = t0 + r;
    ds[r * C_TILE + cx] =
        (c_ok && t < t_out) ? load_f32(db + (size_t)t * c + ch) : 0.0f;
  }
  __syncthreads();
  if (!c_ok) return;
  float* pb = partial + (size_t)tile * k * c;
  for (int j = threadIdx.y; j < k; j += T_ROWS) {
    float acc = 0.0f;
    for (int r = 0; r < T_TILE; ++r) {
      acc += xs[(r + j) * C_TILE + cx] * ds[r * C_TILE + cx];
    }
    pb[(size_t)j * c + ch] = acc;
  }
}

// wgrad, pass 2: dw[j, c] = sum over tiles of partial[tile][j][c], tiles
// in order, then one rounding to dw's dtype.
template <typename T>
__global__ void dwconv1d_wgrad_reduce_kernel(const float* __restrict__ partial,
                                             T* __restrict__ dw, int kc,
                                             int n_tiles) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kc) return;
  float acc = 0.0f;
  for (int tile = 0; tile < n_tiles; ++tile) {
    acc += partial[(size_t)tile * kc + i];
  }
  store_from_f32(dw + i, acc);
}

}  // namespace

// Scratch that openeat_dwconv1d_wgrad needs in `partial`, in float32
// elements: one K x C slab per (batch row, T_TILE slice of output time).
extern "C" long long openeat_dwconv1d_wgrad_scratch(int batch, int tp, int c,
                                                    int k) {
  const int t_out = tp - k + 1;
  const long long t_tiles = (t_out + T_TILE - 1) / T_TILE;
  return (long long)batch * t_tiles * k * c;
}

// Weight gradient of the VALID depthwise conv: x [batch, tp, c] and dy
// [batch, tp-k+1, c] of dtype `dtype` (0 = float32, 1 = bfloat16) give
// dw [k, c] in the same dtype, summed in float32. `partial` is float32
// scratch of openeat_dwconv1d_wgrad_scratch() elements. Launches two
// kernels on `stream` and returns cudaGetLastError() (0 on success).
extern "C" int openeat_dwconv1d_wgrad(const void* x, const void* dy,
                                      void* partial, void* dw, int batch,
                                      int tp, int c, int k, int dtype,
                                      void* stream) {
  const int t_out = tp - k + 1;
  if (batch <= 0 || c <= 0 || k <= 0 || t_out <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int t_tiles = (t_out + T_TILE - 1) / T_TILE;
  const long long n_tiles = (long long)batch * t_tiles;
  if (n_tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 block(C_TILE, T_ROWS);
  const dim3 grid((c + C_TILE - 1) / C_TILE, (unsigned)n_tiles);
  const size_t smem =
      (size_t)(2 * T_TILE + k - 1) * C_TILE * sizeof(float);
  const int kc = k * c;
  const int threads = 256;
  const int blocks = (kc + threads - 1) / threads;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* part = static_cast<float*>(partial);
  if (dtype == 0) {
    dwconv1d_wgrad_partial_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(dy), part,
        tp, c, k, t_tiles);
    dwconv1d_wgrad_reduce_kernel<float><<<blocks, threads, 0, s>>>(
        part, static_cast<float*>(dw), kc, (int)n_tiles);
  } else if (dtype == 1) {
    dwconv1d_wgrad_partial_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(dy), part, tp, c, k, t_tiles);
    dwconv1d_wgrad_reduce_kernel<__nv_bfloat16><<<blocks, threads, 0, s>>>(
        part, static_cast<__nv_bfloat16*>(dw), kc, (int)n_tiles);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype: 0 = float32, 1 = bfloat16; x, w and out share it. Pointers are
// to contiguous x [batch, tp, c], w [k, c] and out [batch, tp-k+1, c].
extern "C" int openeat_dwconv1d_fwd(const void* x, const void* w, void* out,
                                    int batch, int tp, int c, int k,
                                    int dtype, void* stream) {
  const int t_out = tp - k + 1;
  if (batch <= 0 || c <= 0 || k <= 0 || t_out <= 0 || batch > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 block(C_TILE, T_ROWS);
  const dim3 grid((c + C_TILE - 1) / C_TILE, (t_out + T_TILE - 1) / T_TILE,
                  batch);
  const size_t smem = (size_t)(T_TILE + 2 * k - 1) * C_TILE * sizeof(float);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    dwconv1d_fwd_kernel<float><<<grid, block, smem, s>>>(
        static_cast<const float*>(x), static_cast<const float*>(w),
        static_cast<float*>(out), tp, c, k);
  } else if (dtype == 1) {
    dwconv1d_fwd_kernel<__nv_bfloat16><<<grid, block, smem, s>>>(
        static_cast<const __nv_bfloat16*>(x),
        static_cast<const __nv_bfloat16*>(w),
        static_cast<__nv_bfloat16*>(out), tp, c, k);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

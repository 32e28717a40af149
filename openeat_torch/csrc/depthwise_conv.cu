// Depthwise 1-D convolution for Hopper (sm_90a): K3's forward and its
// dgrad as one kernel body with two entries, and the wgrad.
//
// Replaces the Pallas TPU kernel openeat_tpu/ops/depthwise_conv.py:_kernel
// (launched by _pallas_dwconv), and the dgrad that _bwd runs through that
// kernel on dy padded by K-1 on both sides with the taps reversed. One
// body computes, for t in [0, t_out),
//
//   out[b, t, c] = sum_{j=0..K-1} xin[b, t + j - pad_left, c] * tap(j, c)
//
// with xin zero outside [0, t_in). The forward (openeat_dwconv1d_fwd)
// runs it with pad_left = 0, t_out = t_in - K + 1 and tap(j) = w[j]; the
// dgrad (openeat_dwconv1d_dgrad) on dy with pad_left = K - 1,
// t_out = t_in + K - 1 and tap(j) = w[K-1-j], read from the original w:
// the flip is a read order and the padding is the loads' zero fill, so
// dgrad is one launch with no padded copy of dy and no flipped copy of w.
// Taps are summed in float32 in the order j = 0..K-1, each multiply and
// each add rounded on its own (__fmul_rn / __fadd_rn, no fused
// multiply-add), the arithmetic of the plain versions in
// openeat_torch/ops/depthwise_conv.py, so float32 agrees with them bit
// for bit and bfloat16 is the same float32 sum rounded once.
//
// Bound: device-memory bytes. Each output element costs K multiply-adds
// (2K = 30 flops at the Conformer's K = 15) against one read of its input
// and one write: about 4 flops per byte in float32 and 8 in bfloat16, far
// below the H100's balance of 20 (67 TFLOP/s float32 outside the tensor
// cores over 3.35 TB/s). There is no contraction over channels, so tensor
// cores have nothing to do. The least traffic is one read of the input
// and w and one write of the output.
//
// Design. The problems on the main path are a few MB (1.7 MB in, 1.6 MB
// out at the decode shape [8, 212, 256] float32), so the kernel has to put
// all of its loads in flight at once, and at that size a launch and a
// round trip to device memory cost about as much as the bytes
// (chip_k3_bench.py times a plain copy of the same input beside it).
// The tiles are fixed: other tilings (16 or 64 rows, 128 channels, one or
// four blocks per SM) measured no faster on the H100 (PERF.md).
// - A block owns one channel tile (C_TILE = 64 channels) for its whole
//   life, keeps that tile's K x VEC taps in float32 registers (the
//   compile-time K = 15 instance; other K read them from shared memory),
//   and walks (batch row, time tile) items with a stride of gridDim.y: a
//   persistent grid of at most two blocks per SM.
// - Each item's input window, rows [t0 - pad_left, t0 - pad_left + rows)
//   with rows = T_TILE + K - 1, lands in a ring of STAGES tiles in shared
//   memory, asynchronously: the first STAGES windows are requested before
//   the taps are read, and window n + STAGES as soon as window n has been
//   used. Where x's base is 16-byte aligned and a row of channels is a
//   multiple of 16 bytes, one thread asks the Tensor Memory Accelerator
//   for the window (a 3-D tensor map over [B, t_in, C], completion on an
//   mbarrier); the map fills rows outside [0, t_in), negative ones too,
//   with zeros. Elsewhere every thread issues cp.async copies of 16, 8 or
//   4 bytes, with source size 0 (zero fill) outside [0, t_in).
// - A thread owns VEC = 4 channels (16 bytes of float32, 8 of bfloat16)
//   and RT consecutive output rows. It reads each of its RT + K - 1 input
//   rows once from shared memory as one vector load, adds it into every
//   output row it reaches (the taps still in order j = 0..K-1 for each
//   output), and stores each output row as one vector store. Eight
//   bfloat16 channels a thread (16-byte accesses) halve the threads and
//   double each one's multiply-adds, and measured slower; so do taps read
//   with vector loads, which the compiler keeps packed and widens at every
//   use.
// The caller picks the route (TMA or the cp.async copy size) from x's
// address; launch_conv derives the tiles, the grid and the shared memory
// from the constants below. openeat_torch/ops/depthwise_conv.py:
// launch_plan states the same plan in Python, so the CPU tests reach it.
//
// The backward's wgrad (openeat_dwconv1d_wgrad below) is a [K, C]
// reduction over B*T, also bound by bytes: it must read x and dy once
// and write dw. Pass 1 gives each (channel slice, batch row, time tile)
// block its own partial sums; pass 2 adds the partials in a fixed order.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

// ---------------------------------------------------------------- forward
// and dgrad

constexpr int VEC = 4;           // channels per thread
constexpr int RT = 4;            // output rows per thread
constexpr int C_TILE = 64;       // most channels per block (wgrad: exactly)
constexpr int T_TILE = 32;       // output rows per item (wgrad: per block)
constexpr int STAGES = 2;        // ring of input windows per block
constexpr int BLOCKS_PER_SM = 2; // the persistent grid's occupancy
constexpr int K_FIXED = 15;      // the compile-time K (the Conformer's)
constexpr int THREADS = C_TILE / VEC * (T_TILE / RT);  // at most
constexpr int MAX_BOX = 256;     // a TMA box dimension's limit
constexpr int SMEM_MAX = 232448; // dynamic shared memory a block may use
constexpr int ERR_TENSOR_MAP = 10000;  // + the CUresult of the encoding

struct Params {
  const void* x;    // [batch, t_in, c]
  const void* w;    // [k, c]
  void* out;        // [batch, t_out, c]
  int t_in, c, k, pad_left, t_out, flip;
  int c_tile, rows, t_tiles, n_items, stage_bytes;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ float load_f32(const float* p) { return *p; }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_from_f32(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_from_f32(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// VEC values of shared memory -> float32 (bfloat16 widens exactly: its
// bits are the high half of the float32's): one 16-byte load of float32,
// one 8-byte load of bfloat16
__device__ __forceinline__ void load_vec(const float* p, float (&v)[VEC]) {
  const float4 q = *reinterpret_cast<const float4*>(p);
  v[0] = q.x;
  v[1] = q.y;
  v[2] = q.z;
  v[3] = q.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p,
                                         float (&v)[VEC]) {
  const uint2 q = *reinterpret_cast<const uint2*>(p);
  v[0] = __uint_as_float(q.x << 16);
  v[1] = __uint_as_float(q.x & 0xffff0000u);
  v[2] = __uint_as_float(q.y << 16);
  v[3] = __uint_as_float(q.y & 0xffff0000u);
}

__device__ __forceinline__ void store_vec(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo))
         | ((uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p,
                                          const float (&v)[VEC]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(pack_bf16x2(v[0], v[1]), pack_bf16x2(v[2], v[3]));
}

// n_valid channels from p on: one vector store where the whole vector is
// valid and aligned (always, on the TMA route), else one per element
template <typename T>
__device__ __forceinline__ void store_out(T* p, const float (&v)[VEC],
                                          int n_valid) {
  if (n_valid >= VEC &&
      reinterpret_cast<uintptr_t>(p) % (VEC * sizeof(T)) == 0) {
    store_vec(p, v);
  } else {
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (e < n_valid) store_from_f32(p + e, v[e]);
    }
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// returns once the phase of parity `parity` of `bar` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// the box at (channel c0, time t0, batch b) of `map` into dst; rows
// outside the tensor, negative t0 included, arrive as zeros
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int t0,
                                            int b) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(t0), "r"(b)
      : "memory");
}

// G bytes from src to dst, or G zero bytes where !valid (source size 0)
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  const int n = valid ? G : 0;
  if constexpr (G == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(n)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "n"(G), "r"(n)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// RT output rows from the window rows at xs (row stride `stride`
// elements) with the K taps in registers. Input row i reaches output rows
// o = i - j; i ascends, so each output still sums j = 0..K-1 in order.
template <int KC, typename T>
__device__ __forceinline__ void conv_reg_taps(const T* xs, int stride,
                                              const float (&tap)[KC][VEC],
                                              float (&acc)[RT][VEC]) {
#pragma unroll
  for (int i = 0; i < RT + KC - 1; ++i) {
    float xv[VEC];
    load_vec(xs + i * stride, xv);
#pragma unroll
    for (int o = 0; o < RT; ++o) {
      const int j = i - o;
      if (j >= 0 && j < KC) {
#pragma unroll
        for (int v = 0; v < VEC; ++v) {
          const float pr = __fmul_rn(xv[v], tap[j][v]);
          acc[o][v] = j == 0 ? pr : __fadd_rn(acc[o][v], pr);
        }
      }
    }
  }
}

// The same sum for a runtime k, with the taps in shared memory: float32
// rows of `stride` values, this thread's VEC channels at ws.
template <typename T>
__device__ __forceinline__ void conv_smem_taps(const T* xs, int stride,
                                               const float* ws, int k,
                                               float (&acc)[RT][VEC]) {
  for (int j = 0; j < k; ++j) {
    float tv[VEC];
    load_vec(ws + j * stride, tv);
#pragma unroll
    for (int o = 0; o < RT; ++o) {
      float xv[VEC];
      load_vec(xs + (o + j) * stride, xv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float pr = __fmul_rn(xv[v], tv[v]);
        acc[o][v] = j == 0 ? pr : __fadd_rn(acc[o][v], pr);
      }
    }
  }
}

// G = 0: windows arrive by TMA through `map`; G = 4, 8 or 16: by cp.async
// copies of G bytes from p.x (map unused). KC = K_FIXED keeps the taps in
// registers; KC = 0 takes p.k at run time. A thread computes VEC channels
// of RT output rows.
template <typename T, int KC, int G>
__global__ void __launch_bounds__(THREADS)
    dwconv1d_kernel(const __grid_constant__ CUtensorMap map, const Params p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  unsigned char* tiles = smem;  // STAGES x [rows][c_tile] of T
  float* ws = reinterpret_cast<float*>(smem + STAGES * p.stage_bytes);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      smem + STAGES * p.stage_bytes + (KC > 0 ? 0 : p.k * p.c_tile * 4));

  const int tid = threadIdx.y * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y;
  const int c0 = blockIdx.x * p.c_tile;
  const int cl = threadIdx.x * VEC;  // this thread's channels in the tile
  const int ch = c0 + cl;
  const int r0 = threadIdx.y * RT;   // its output rows in the time tile
  const int first = blockIdx.y;
  const int n_mine =
      first < p.n_items ? (p.n_items - 1 - first) / gridDim.y + 1 : 0;

  // request the input window of this block's n-th item into stage n % STAGES
  auto request = [&](int n) {
    const int item = first + n * gridDim.y;
    const int b = item / p.t_tiles;
    const int t_lo = (item % p.t_tiles) * T_TILE - p.pad_left;
    unsigned char* dst = tiles + (n % STAGES) * p.stage_bytes;
    if constexpr (G == 0) {
      mbar_expect_tx(&full[n % STAGES],
                     (uint32_t)(p.rows * p.c_tile * sizeof(T)));
      tma_load_3d(dst, &map, &full[n % STAGES], c0, t_lo, b);
    } else {
      constexpr int E = G / (int)sizeof(T);  // elements per copy
      const int per_row = p.c_tile / E;
      const T* xb = static_cast<const T*>(p.x) + (size_t)b * p.t_in * p.c;
      for (int i = tid; i < p.rows * per_row; i += nthr) {
        const int r = i / per_row;
        const int cc = c0 + (i % per_row) * E;
        if (cc >= p.c) continue;  // past C: never stored
        const int t = t_lo + r;
        const bool in = t >= 0 && t < p.t_in;
        cp_async<G>(dst + ((size_t)r * p.c_tile + (cc - c0)) * sizeof(T),
                    in ? xb + (size_t)t * p.c + cc : xb, in);
      }
    }
  };

  // the first windows go out before the taps are read
  if constexpr (G == 0) {
    if (tid == 0) {
      for (int s = 0; s < STAGES; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int n = 0; n < STAGES && n < n_mine; ++n) request(n);
    }
  } else {
    for (int n = 0; n < STAGES; ++n) {
      if (n < n_mine) request(n);
      cp_async_commit();  // one group per stage, empty or not
    }
  }

  const T* w = static_cast<const T*>(p.w);
  float tap[KC > 0 ? KC : 1][VEC];
  if constexpr (KC > 0) {
    // element loads, each widened once: vector loads let the compiler keep
    // bfloat16 taps packed and widen them again at every use
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      const T* wj = w + (size_t)(p.flip ? KC - 1 - j : j) * p.c + ch;
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        tap[j][v] = ch + v < p.c ? load_f32(wj + v) : 0.0f;
      }
    }
  } else {
    for (int i = tid; i < p.k * p.c_tile; i += nthr) {
      const int j = i / p.c_tile;
      const int cc = c0 + i % p.c_tile;
      const int jj = p.flip ? p.k - 1 - j : j;
      ws[i] = cc < p.c ? load_f32(w + (size_t)jj * p.c + cc) : 0.0f;
    }
  }
  __syncthreads();  // barriers initialised, shared taps written

  T* out = static_cast<T*>(p.out);
  for (int n = 0; n < n_mine; ++n) {
    const int s = n % STAGES;
    if constexpr (G == 0) {
      mbar_wait(&full[s], (uint32_t)(n / STAGES) & 1u);
    } else {
      cp_async_wait<STAGES - 1>();
      __syncthreads();  // every thread's copies have landed
    }
    const int item = first + n * gridDim.y;
    const int b = item / p.t_tiles;
    const int t0 = (item % p.t_tiles) * T_TILE;
    const T* xs = reinterpret_cast<const T*>(tiles + s * p.stage_bytes) +
                  r0 * p.c_tile + cl;
    float acc[RT][VEC];
    if constexpr (KC > 0) {
      conv_reg_taps<KC>(xs, p.c_tile, tap, acc);
    } else {
      conv_smem_taps(xs, p.c_tile, ws + cl, p.k, acc);
    }
    if (ch < p.c) {
      T* ob = out + ((size_t)b * p.t_out + t0 + r0) * p.c + ch;
#pragma unroll
      for (int o = 0; o < RT; ++o) {
        if (t0 + r0 + o < p.t_out) store_out(ob + (size_t)o * p.c, acc[o],
                                             p.c - ch);
      }
    }
    __syncthreads();  // stage s is free again
    if (n + STAGES < n_mine) {
      if constexpr (G == 0) {
        if (tid == 0) request(n + STAGES);
      } else {
        request(n + STAGES);
      }
    }
    if constexpr (G != 0) cp_async_commit();
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so
// the library needs no -lcuda
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000,
                                     cudaEnableDefault, &found);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &ptr, cudaEnableDefault,
                            &found);
#endif
    if (found == cudaDriverEntryPointSuccess) {
      fn = reinterpret_cast<EncodeTiled>(ptr);
    }
  }
  return fn;
}

template <typename T, int KC, int G>
int launch_instance(const CUtensorMap& map, const Params& p, dim3 grid,
                    dim3 block, int smem, cudaStream_t stream) {
  // allowed once per instance, before any capture can start, so that a
  // CUDA graph never holds this call
  static bool smem_raised = false;
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        dwconv1d_kernel<T, KC, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_raised = true;
  }
  dwconv1d_kernel<T, KC, G><<<grid, block, smem, stream>>>(map, p);
  return (int)cudaGetLastError();
}

template <typename T, int KC>
int launch_route(int copy_bytes, const CUtensorMap& map, const Params& p,
                 dim3 grid, dim3 block, int smem, cudaStream_t stream) {
  switch (copy_bytes) {
    case 0:
      return launch_instance<T, KC, 0>(map, p, grid, block, smem, stream);
    case 4:
      return launch_instance<T, KC, 4>(map, p, grid, block, smem, stream);
    case 8:
      return launch_instance<T, KC, 8>(map, p, grid, block, smem, stream);
    case 16:
      return launch_instance<T, KC, 16>(map, p, grid, block, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the taps in registers for the compile-time K, else in shared memory
template <typename T>
int launch_typed(int copy_bytes, const CUtensorMap& map, const Params& p,
                 dim3 grid, dim3 block, int smem, cudaStream_t stream) {
  if (p.k == K_FIXED) {
    return launch_route<T, K_FIXED>(copy_bytes, map, p, grid, block, smem,
                                    stream);
  }
  return launch_route<T, 0>(copy_bytes, map, p, grid, block, smem, stream);
}

bool aligned(const void* ptr, long long bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % (uintptr_t)bytes == 0;
}

// SMs of the current device, asked once per device
int num_sms() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 0;
  if (sms[dev] == 0) {
    cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
  }
  return sms[dev];
}

// Cuts the problem into the kernel's tiles and grid, checks that the
// route (copy_bytes: 0 = TMA, else the cp.async size) fits x, encodes the
// tensor map on the TMA route and launches.
int launch_conv(const void* x, const void* w, void* out, int batch, int t_in,
                int c, int k, int pad_left, int t_out, int flip, int dtype,
                int copy_bytes, void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  if (batch <= 0 || t_in <= 0 || c <= 0 || k <= 0 || t_out <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  // a channel tile of whole vectors and whole 16-byte rows (TMA boxes,
  // 16-byte copies), no wider than C needs
  const int step = 16 / item > VEC ? 16 / item : VEC;
  const int c_round = (c + step - 1) / step * step;
  const int c_tile = c_round < C_TILE ? c_round : C_TILE;
  const int rows = T_TILE + k - 1;
  const long long t_tiles = (t_out + T_TILE - 1) / T_TILE;
  const long long n_items = (long long)batch * t_tiles;
  const int n_ctiles = (c + c_tile - 1) / c_tile;
  const int sms = num_sms();
  const long long stage_bytes =
      ((long long)rows * c_tile * item + 127) / 128 * 128;
  const long long smem = 128 + STAGES * stage_bytes +
                         (k == K_FIXED ? 0 : (long long)k * c_tile * 4) +
                         STAGES * 8;
  if (rows > MAX_BOX || n_items > 0x7fffffffLL || sms <= 0 ||
      smem > SMEM_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  long long grid_y = (BLOCKS_PER_SM * sms + n_ctiles - 1) / n_ctiles;
  if (grid_y > n_items) grid_y = n_items;
  if (grid_y > 65535) grid_y = 65535;
  const long long row_bytes = (long long)c * item;
  alignas(64) CUtensorMap map{};
  if (copy_bytes == 0) {
    if (!aligned(x, 16) || !aligned(out, 16) || row_bytes % 16 != 0) {
      return (int)cudaErrorInvalidValue;
    }
    EncodeTiled encode = encode_tiled();
    if (encode == nullptr) return ERR_TENSOR_MAP + (int)CUDA_ERROR_NOT_FOUND;
    const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)t_in,
                                (cuuint64_t)batch};
    const cuuint64_t strides[2] = {(cuuint64_t)row_bytes,
                                   (cuuint64_t)row_bytes * t_in};
    const cuuint32_t box[3] = {(cuuint32_t)c_tile, (cuuint32_t)rows, 1};
    const cuuint32_t elem_strides[3] = {1, 1, 1};
    const CUresult r = encode(
        &map,
        dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                   : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
        3, const_cast<void*>(x), dims, strides, box, elem_strides,
        CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
        CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return ERR_TENSOR_MAP + (int)r;
  } else if (copy_bytes == 4 || copy_bytes == 8 || copy_bytes == 16) {
    if (!aligned(x, copy_bytes) || row_bytes % copy_bytes != 0) {
      return (int)cudaErrorInvalidValue;
    }
  } else {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
  p.x = x;
  p.w = w;
  p.out = out;
  p.t_in = t_in;
  p.c = c;
  p.k = k;
  p.pad_left = pad_left;
  p.t_out = t_out;
  p.flip = flip;
  p.c_tile = c_tile;
  p.rows = rows;
  p.t_tiles = (int)t_tiles;
  p.n_items = (int)n_items;
  p.stage_bytes = (int)stage_bytes;
  const dim3 grid(n_ctiles, (unsigned)grid_y);
  const dim3 block(c_tile / VEC, T_TILE / RT);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_typed<float>(copy_bytes, map, p, grid, block, (int)smem, s);
  }
  return launch_typed<__nv_bfloat16>(copy_bytes, map, p, grid, block,
                                     (int)smem, s);
}

// ---------------------------------------------------------------- wgrad

// A block of C_TILE x T_ROWS threads owns C_TILE channels and T_TILE
// output time steps.
constexpr int T_ROWS = 4;  // threads along y

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

// Forward: x [batch, tp, c] and w [k, c] give out [batch, tp-k+1, c].
// Dgrad: dy [batch, t, c] and the forward's w [k, c] give dx
// [batch, t+k-1, c]. dtype: 0 = float32, 1 = bfloat16, shared by all
// three tensors, which are contiguous. copy_bytes is the route that
// openeat_torch/ops/depthwise_conv.py:launch_plan picks from the input's
// address: 0 = TMA, else the cp.async copy size (4, 8 or 16). Each
// launches one kernel on `stream` and returns cudaGetLastError() (0 on
// success), cudaErrorInvalidValue for a problem or route the kernel does
// not take, or 10000 + the CUresult where the tensor map cannot be
// encoded.
extern "C" int openeat_dwconv1d_fwd(const void* x, const void* w, void* out,
                                    int batch, int tp, int c, int k,
                                    int dtype, int copy_bytes, void* stream) {
  return launch_conv(x, w, out, batch, tp, c, k, 0, tp - k + 1, 0, dtype,
                     copy_bytes, stream);
}

extern "C" int openeat_dwconv1d_dgrad(const void* dy, const void* w,
                                      void* dx, int batch, int t, int c,
                                      int k, int dtype, int copy_bytes,
                                      void* stream) {
  return launch_conv(dy, w, dx, batch, t, c, k, k - 1, t + k - 1, 1, dtype,
                     copy_bytes, stream);
}

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

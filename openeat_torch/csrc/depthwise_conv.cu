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
// (chip_kernel_bench.py times a plain copy of the same input beside it).
// The tiles are fixed: other tilings (16 or 64 rows, 128 channels, one or
// four blocks per SM) measured no faster on the H100 (PERF.md).
// - A block owns one channel tile (C_TILE = 64 channels) for its whole
//   life, keeps that tile's K x VEC taps in float32 registers (the
//   compile-time instances K = 15 and K = 31, the AIShell and the
//   LibriSpeech Conformers' kernels; other K read them from shared
//   memory), and walks (batch row, time tile) items with a stride of
//   gridDim.y: a persistent grid of at most two blocks per SM. At K = 31
//   the taps take 124 registers a thread, loaded once, all in flight
//   beside the first windows; the shared-memory route would reload a tap
//   vector and RT input vectors for every tap of every item.
// - Each item's input window, rows [t0 - pad_left, t0 - pad_left + rows)
//   with rows = T_TILE + K - 1, lands in a ring of STAGES tiles in shared
//   memory, asynchronously: the first STAGES windows are requested before
//   the taps are read, and window n + STAGES as soon as window n has been
//   used. Where x's base is 16-byte aligned and a row of channels is a
//   multiple of 16 bytes, one thread asks the Tensor Memory Accelerator
//   for the window (a 3-D tensor map over [B, t_in, C], completion on an
//   mbarrier); the map fills rows outside [0, t_in), negative ones too,
//   with zeros. Elsewhere every thread issues cp.async copies of 8 or 4
//   bytes, with source size 0 (zero fill) outside [0, t_in); where no
//   4-byte copy fits (bfloat16 rows of odd C, an input at a 2-byte
//   offset), synchronous 2-byte element loads into the same ring, zeros
//   outside [0, t_in). That route serves no shape of the port's models
//   and is there so the kernel takes every input the JAX kernel takes.
// - A thread owns VEC = 4 channels (16 bytes of float32, 8 of bfloat16)
//   and RT consecutive output rows. It reads each of its RT + K - 1 input
//   rows once from shared memory as one vector load, adds it into every
//   output row it reaches (the taps still in order j = 0..K-1 for each
//   output), and stores each output row as one vector store. Eight
//   bfloat16 channels a thread (16-byte accesses) halve the threads and
//   double each one's multiply-adds, and measured slower; so do taps read
//   with vector loads, which the compiler keeps packed and widens at every
//   use.
// The caller picks the route (TMA, the cp.async copy size, or element
// loads) from x's address; launch_conv derives the tiles, the grid and the shared memory
// from the constants below. openeat_torch/ops/depthwise_conv.py:
// launch_plan states the same plan in Python, so the CPU tests reach it.
//
// The backward's wgrad (openeat_dwconv1d_wgrad below) is a [K, C]
// reduction over B*T, also bound by bytes, in one launch with the same
// routes; its design is set out above its kernel.

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
constexpr int K_FIXED = 15;      // compile-time K: the Conformer's (wgrad too)
constexpr int K_WIDE = 31;       // compile-time K: LibriSpeech's (fwd, dgrad)
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

// G = 4 or 8 bytes from src to dst, or G zero bytes where !valid (source
// size 0); rows and addresses that take 16-byte copies take TMA instead
template <int G>
__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "n"(G), "r"(valid ? G : 0)
               : "memory");
}

// G = 4, 8 or 16: cp_async<G>. G = 2, for what no 4-byte copy fits
// (bfloat16 rows of odd C, an input at a 2-byte offset): one synchronous
// element load and store, zero where !valid; the ring's wait and
// __syncthreads order it like the copies
template <int G>
__device__ __forceinline__ void copy_in(void* dst, const void* src,
                                        bool valid) {
  if constexpr (G == 2) {
    *static_cast<unsigned short*>(dst) =
        valid ? *static_cast<const unsigned short*>(src) : (unsigned short)0;
  } else {
    cp_async<G>(dst, src, valid);
  }
}

// Rows [t_lo, t_lo + n_rows) of batch row b of src [batch, t_len, c],
// channels [c0, c0 + c_tile), into dst ([n_rows][c_tile] of T) by copies
// of G bytes shared over the block's threads; rows outside [0, t_len)
// arrive as zeros, channels past c are never copied (nor stored)
template <typename T, int G>
__device__ __forceinline__ void copy_window(unsigned char* dst, const T* src,
                                            int b, int t_lo, int n_rows,
                                            int t_len, int c, int c0,
                                            int c_tile, int tid, int nthr) {
  constexpr int E = G / (int)sizeof(T);  // elements per copy
  const int per_row = c_tile / E;
  const T* sb = src + (size_t)b * t_len * c;
  for (int i = tid; i < n_rows * per_row; i += nthr) {
    const int r = i / per_row;
    const int cc = c0 + (i % per_row) * E;
    if (cc >= c) continue;
    const int t = t_lo + r;
    const bool in = t >= 0 && t < t_len;
    copy_in<G>(dst + ((size_t)r * c_tile + (cc - c0)) * sizeof(T),
               in ? sb + (size_t)t * c + cc : sb, in);
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
// copies of G bytes from p.x (map unused). KC = K_FIXED or K_WIDE keeps
// the taps in registers; KC = 0 takes p.k at run time. A thread computes
// VEC channels of RT output rows.
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
      copy_window<T, G>(dst, static_cast<const T*>(p.x), b, t_lo, p.rows,
                        p.t_in, p.c, c0, p.c_tile, tid, nthr);
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

// A 3-D tensor map over src [batch, t_len, c] (dtype 0 = float32, 1 =
// bfloat16) whose box is c_tile channels x box_rows rows x one batch row;
// rows outside the tensor, negative ones too, load as zeros. Returns 0
// or ERR_TENSOR_MAP + the CUresult.
int encode_map(CUtensorMap* map, const void* src, int dtype, int batch,
               int t_len, int c, int c_tile, int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return ERR_TENSOR_MAP + (int)CUDA_ERROR_NOT_FOUND;
  const cuuint64_t row_bytes = (cuuint64_t)c * (dtype == 0 ? 4 : 2);
  const cuuint64_t dims[3] = {(cuuint64_t)c, (cuuint64_t)t_len,
                              (cuuint64_t)batch};
  const cuuint64_t strides[2] = {row_bytes, row_bytes * (cuuint64_t)t_len};
  const cuuint32_t box[3] = {(cuuint32_t)c_tile, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult r = encode(
      map,
      dtype == 0 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      3, const_cast<void*>(src), dims, strides, box, elem_strides,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : ERR_TENSOR_MAP + (int)r;
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
    case 2:  // element loads, bfloat16 only
      if constexpr (sizeof(T) == 2) {
        return launch_instance<T, KC, 2>(map, p, grid, block, smem, stream);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

bool taps_in_registers(int k) { return k == K_FIXED || k == K_WIDE; }

// the taps in registers for a compile-time K, else in shared memory
template <typename T>
int launch_typed(int copy_bytes, const CUtensorMap& map, const Params& p,
                 dim3 grid, dim3 block, int smem, cudaStream_t stream) {
  if (p.k == K_FIXED) {
    return launch_route<T, K_FIXED>(copy_bytes, map, p, grid, block, smem,
                                    stream);
  }
  if (p.k == K_WIDE) {
    return launch_route<T, K_WIDE>(copy_bytes, map, p, grid, block, smem,
                                   stream);
  }
  return launch_route<T, 0>(copy_bytes, map, p, grid, block, smem, stream);
}

bool aligned(const void* ptr, long long bytes) {
  return reinterpret_cast<uintptr_t>(ptr) % (uintptr_t)bytes == 0;
}

// whether the route (copy_bytes: 0 = TMA, else the copy size: 2 for
// element loads, 4 or 8 for cp.async) fits rows of c elements of `item`
// bytes at ptr
bool route_fits(int copy_bytes, int item, int c, const void* ptr) {
  const long long row_bytes = (long long)c * item;
  if (copy_bytes == 0) return aligned(ptr, 16) && row_bytes % 16 == 0;
  if (copy_bytes != 2 && copy_bytes != 4 && copy_bytes != 8) return false;
  return copy_bytes >= item && aligned(ptr, copy_bytes) &&
         row_bytes % copy_bytes == 0;
}

// a channel tile of whole vectors and whole 16-byte rows (TMA boxes), at
// most `cap` channels and no wider than C needs
int channel_tile(int c, int item, int cap) {
  const int step = 16 / item > VEC ? 16 / item : VEC;
  const int c_round = (c + step - 1) / step * step;
  return c_round < cap ? c_round : cap;
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
  const int c_tile = channel_tile(c, item, C_TILE);
  const int rows = T_TILE + k - 1;
  const long long t_tiles = (t_out + T_TILE - 1) / T_TILE;
  const long long n_items = (long long)batch * t_tiles;
  const int n_ctiles = (c + c_tile - 1) / c_tile;
  const int sms = num_sms();
  const long long stage_bytes =
      ((long long)rows * c_tile * item + 127) / 128 * 128;
  const long long tap_bytes =
      taps_in_registers(k) ? 0 : (long long)k * c_tile * 4;
  const long long smem = 128 + STAGES * stage_bytes + tap_bytes + STAGES * 8;
  if (rows > MAX_BOX || n_items > 0x7fffffffLL || sms <= 0 ||
      smem > SMEM_MAX) {
    return (int)cudaErrorInvalidValue;
  }
  long long grid_y = (BLOCKS_PER_SM * sms + n_ctiles - 1) / n_ctiles;
  if (grid_y > n_items) grid_y = n_items;
  if (grid_y > 65535) grid_y = 65535;
  if (!route_fits(copy_bytes, item, c, x) ||
      (copy_bytes == 0 && !aligned(out, 16))) {
    return (int)cudaErrorInvalidValue;
  }
  alignas(64) CUtensorMap map{};
  if (copy_bytes == 0) {
    const int rc = encode_map(&map, x, dtype, batch, t_in, c, c_tile, rows);
    if (rc != 0) return rc;
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
//
// dw[j, c] = sum_{b,t} x[b, t+j, c] * dy[b, t, c], the weight gradient
// that the JAX package leaves to XLA (openeat_tpu/ops/depthwise_conv.py:
// _bwd). Bound by bytes, like the forward: one read of x and dy, K x C
// written. One launch (openeat_dwconv1d_wgrad):
// - Items are (batch row, chunk of `rows` <= W_ROWS output steps): each
//   batch row is cut into q even chunks. A block owns one channel tile of
//   at most W_C_TILE channels and a contiguous run of `per` items, a long
//   span of time, so the K-1 halo of x is reread once per chunk, and
//   mostly from L2; the grid has about W_BLOCKS_PER_SM blocks per SM.
//   Narrow tiles keep each tile's final sum small: at [22, 162, 256], 8
//   tiles of 15 blocks leave each tile's last block 29 KB of partials,
//   where 64-channel tiles of 33 blocks left it 127 KB, whose reads
//   measured slower on the H100 than the narrow tiles' loads cost.
// - Each item's x window (rows + K - 1 rows) and dy rows land in a ring
//   of W_STAGES stages in shared memory by the forward's routes: TMA
//   through two tensor maps, else cp.async or element copies.
// - A thread owns VEC channels, a contiguous share of the item's rows
//   (one of W_GROUPS row groups) and KC of the taps. It keeps KC x VEC
//   float32 accumulators and a sliding window of KC x rows in registers,
//   so each x row and each dy row is one vector load from shared memory
//   per pass. The compile-time instances take one pass and keep their
//   sums in registers over all of the block's items: K_FIXED = 15 in one
//   group of KC = 15 taps; K_WIDE = 31 in W_TAP_GROUPS = 2 groups of
//   KC = 16 taps (blockDim.z; taps 0-15 and 16-30, the 32nd a dropped
//   product of clamped rows), both groups reading the same staged rows,
//   since 31 x VEC sums beside a 31 x VEC window would not fit in
//   registers. Any other K takes passes of W_KC taps and adds each
//   item's passes into the thread's slots of red [row group][K][c_tile]
//   in shared memory; the one-pass instances write their slots once.
// - The block adds its row groups in order into its K x c_tile partial.
//   Across blocks, K_WIDE's splits (at most W_CLUSTER) are one
//   thread-block cluster: each block stores its partial of output i into
//   the shared memory of block i % splits, and after one cluster barrier
//   each block adds its outputs' partials in split order and rounds once
//   to dw's dtype. Other K write their partials to the workspace, and
//   the last block of the tile to finish takes the sum: each block takes
//   a ticket, an integer atomic per channel tile, once its partial is
//   visible; the block that takes the last one adds the tile's partials
//   in split order, rounds once and resets the ticket; it loads up to
//   W_FINAL partials at once, so the sum waits on few round trips. No
//   float atomics either way: two runs give the same bits.
// - K_WIDE's tiling, measured on the H100 against the K = 15 one
//   (PERF.md): 16-channel tiles and items of up to W_WIDE_ROWS rows, at
//   least W_CLUSTER / batch a batch row, give 96-128 blocks of 128
//   threads at the LibriSpeech micro-batches, all resident at once (256
//   threads a block ran the clusters in two waves); the cluster's sum
//   replaced a store, a fence, a ticket and the last block's loads, the
//   largest share of the time with the workspace route.

constexpr int W_C_TILE = 32;        // most channels per block
constexpr int W_ROWS = 128;         // most output rows per item
constexpr int W_GROUPS = 16;        // row groups per block (blockDim.y)
constexpr int W_KC = 8;             // taps per pass for a runtime K
constexpr int W_TAP_GROUPS = 2;     // groups of taps (blockDim.z) at K_WIDE
constexpr int W_WIDE_C_TILE = 16;   // K_WIDE: most channels per block
constexpr int W_WIDE_GROUPS = 16;   // K_WIDE: row groups per block
constexpr int W_WIDE_ROWS = 226;    // K_WIDE: most output rows per item
constexpr int W_CLUSTER = 8;        // K_WIDE: most blocks per channel tile
constexpr int W_STAGES = 3;         // ring of items per block
constexpr int W_BLOCKS_PER_SM = 1;  // the grid's target
constexpr int W_MAX_CTILES = 1024;  // tickets at the workspace's head
constexpr int W_FINAL = 32;         // partials the final sum loads at once
// shared memory after the ring: red, W_STAGES barriers and the ticket,
// then (K_WIDE) the inbox of float4s, 16-byte aligned
static_assert((W_STAGES * 8 + 8) % 16 == 0, "the inbox's alignment");

// The wgrad's instances: KF = K_FIXED or K_WIDE is a compile-time K
// summed in one pass by wgrad_tap_groups(KF) groups of wgrad_kc(KF) taps;
// KF = 0 takes K at run time, in passes of W_KC taps.
__host__ __device__ constexpr int wgrad_tap_groups(int kf) {
  return kf == K_WIDE ? W_TAP_GROUPS : 1;
}
__host__ __device__ constexpr int wgrad_kc(int kf) {
  return kf == 0 ? W_KC
                 : (kf + wgrad_tap_groups(kf) - 1) / wgrad_tap_groups(kf);
}
__host__ __device__ constexpr int wgrad_groups(int kf) {
  return kf == K_WIDE ? W_WIDE_GROUPS : W_GROUPS;
}
__host__ __device__ constexpr int wgrad_threads(int kf) {
  return (kf == K_WIDE ? W_WIDE_C_TILE : W_C_TILE) / VEC * wgrad_groups(kf) *
         wgrad_tap_groups(kf);
}

struct WParams {
  const void* x;     // [batch, t_in, c]
  const void* dy;    // [batch, t_out, c]
  void* dw;          // [k, c]
  float* part;       // [n_ctiles][splits][k][c_tile]
  unsigned* ticket;  // [n_ctiles], 0 between launches
  int t_in, t_out, c, k, c_tile, rows, q, n_items, per, splits;
  int x_rows, x_bytes, stage_bytes;
};

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// The cluster barrier in two halves: arrive (this thread's shared-memory
// writes before it released to the cluster; relaxed: nothing released)
// and wait (returns once every thread of every block in the cluster has
// arrived, acquiring what they released)
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// v into the float4 at `local`'s offset in the shared memory of the
// cluster's block `rank`
__device__ __forceinline__ void st_cluster4(float4* local, uint32_t rank,
                                            float4 v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(remote)
               : "r"(smem_u32(local)), "r"(rank));
  asm volatile("st.shared::cluster.v4.f32 [%0], {%1, %2, %3, %4};" ::"r"(
                   remote),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// acc[jj] += x[r + j0 + jj] * dy[r] for the staged rows r in [lo, hi),
// x rows clamped to x_last (rows past it feed only taps j0 + jj >= K,
// which the caller drops). xw holds x rows r + j0 .. r + j0 + KC - 1 in
// slots (r - lo + jj) % KC; unrolled by KC, every slot index is a
// compile-time constant. EXIT leaves the unrolled rows at the first one
// past hi, so they reconverge once and not at every row: measured faster
// at K_WIDE (at most 15 rows a thread), slower at K_FIXED (PERF.md); the
// K_WIDE instances of the copy routes spill with it at the 168 registers
// ptxas gives them, so only the TMA route takes it.
template <int KC, bool EXIT, typename T>
__device__ __forceinline__ void wgrad_rows(const T* xs, const T* ds,
                                           int stride, int lo, int hi,
                                           int j0, int x_last,
                                           float (&acc)[KC][VEC]) {
  float xw[KC][VEC];
#pragma unroll
  for (int i = 0; i < KC - 1; ++i) {
    load_vec(xs + min(lo + j0 + i, x_last) * stride, xw[i]);
  }
  for (int base = lo; base < hi; base += KC) {
#pragma unroll
    for (int u = 0; u < KC; ++u) {
      const int r = base + u;
      if (EXIT && r >= hi) break;
      if (r < hi) {
        load_vec(xs + min(r + j0 + KC - 1, x_last) * stride,
                 xw[(u + KC - 1) % KC]);
        float d[VEC];
        load_vec(ds + r * stride, d);
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
#pragma unroll
          for (int v = 0; v < VEC; ++v) {
            acc[jj][v] = fmaf(xw[(u + jj) % KC][v], d[v], acc[jj][v]);
          }
        }
      }
    }
  }
}

// G = 0: items arrive by TMA through xmap and dmap; G = 2, 4 or 8: by
// copies of G bytes (maps unused). KF: the compile-time K, or 0.
template <typename T, int KF, int G>
__global__ void __launch_bounds__(wgrad_threads(KF))
    dwconv1d_wgrad_kernel(const __grid_constant__ CUtensorMap xmap,
                          const __grid_constant__ CUtensorMap dmap,
                          const WParams p) {
  constexpr int TG = wgrad_tap_groups(KF);
  constexpr int KC = wgrad_kc(KF);
  constexpr int GROUPS = wgrad_groups(KF);
  constexpr bool ONE_PASS = KF != 0;
  constexpr bool CLUSTER = KF == K_WIDE;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((128 - (smem_u32(smem_raw) & 127)) & 127);
  float* red = reinterpret_cast<float*>(smem + W_STAGES * p.stage_bytes);
  uint64_t* full =
      reinterpret_cast<uint64_t*>(red + (size_t)GROUPS * p.k * p.c_tile);
  unsigned* last = reinterpret_cast<unsigned*>(full + W_STAGES);
  // CLUSTER: the partials of this block's outputs, one float4 from each
  // block of the cluster: [output / splits][rank]
  float4* inbox = reinterpret_cast<float4*>(full + W_STAGES + 1);

  const int tz = TG > 1 ? (int)threadIdx.z : 0;  // tap group
  const int tid = (tz * blockDim.y + threadIdx.y) * blockDim.x + threadIdx.x;
  const int nthr = blockDim.x * blockDim.y * TG;
  const int ctile = blockIdx.x;
  const int c0 = ctile * p.c_tile;
  const int cl = threadIdx.x * VEC;
  const int g = threadIdx.y;
  const int j0 = tz * KC;  // this thread's first tap in one pass
  const int i0 = blockIdx.y * p.per;
  const int n_mine = min(p.per, p.n_items - i0);

  // request this block's n-th item into stage n % W_STAGES
  auto request = [&](int n) {
    const int item = i0 + n;
    const int b = item / p.q;
    const int t0 = (item % p.q) * p.rows;
    unsigned char* dst = smem + (n % W_STAGES) * p.stage_bytes;
    if constexpr (G == 0) {
      mbar_expect_tx(&full[n % W_STAGES],
                     (uint32_t)((p.x_rows + p.rows) * p.c_tile * sizeof(T)));
      tma_load_3d(dst, &xmap, &full[n % W_STAGES], c0, t0, b);
      tma_load_3d(dst + p.x_bytes, &dmap, &full[n % W_STAGES], c0, t0, b);
    } else {
      copy_window<T, G>(dst, static_cast<const T*>(p.x), b, t0, p.x_rows,
                        p.t_in, p.c, c0, p.c_tile, tid, nthr);
      copy_window<T, G>(dst + p.x_bytes, static_cast<const T*>(p.dy), b, t0,
                        p.rows, p.t_out, p.c, c0, p.c_tile, tid, nthr);
    }
  };

  // the cluster's blocks have all started before any writes to another's
  // shared memory (the matching wait comes before the first such write)
  if constexpr (CLUSTER) cluster_arrive_relaxed();
  if constexpr (G == 0) {
    if (tid == 0) {
      for (int s = 0; s < W_STAGES; ++s) mbar_init(&full[s], 1);
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
      for (int n = 0; n < W_STAGES && n < n_mine; ++n) request(n);
    }
  } else {
    for (int n = 0; n < W_STAGES; ++n) {
      if (n < n_mine) request(n);
      cp_async_commit();  // one group per stage, empty or not
    }
  }
  if constexpr (!ONE_PASS) {
    for (int i = tid; i < GROUPS * p.k * p.c_tile; i += nthr) red[i] = 0.0f;
  }
  __syncthreads();  // barriers initialised, red zeroed

  float* my_red = red + (size_t)g * p.k * p.c_tile + cl;
  float keep[KC][VEC] = {};  // one pass: sums over all items
  for (int n = 0; n < n_mine; ++n) {
    const int s = n % W_STAGES;
    if constexpr (G == 0) {
      mbar_wait(&full[s], (uint32_t)(n / W_STAGES) & 1u);
    } else {
      cp_async_wait<W_STAGES - 1>();
      __syncthreads();  // every thread's copies have landed
    }
    const int t0 = ((i0 + n) % p.q) * p.rows;
    const int n_rows = min(p.rows, p.t_out - t0);
    const int lo = g * n_rows / GROUPS;
    const int hi = (g + 1) * n_rows / GROUPS;
    const unsigned char* stage = smem + s * p.stage_bytes;
    const T* xs = reinterpret_cast<const T*>(stage) + cl;
    const T* ds = reinterpret_cast<const T*>(stage + p.x_bytes) + cl;
    if (ONE_PASS && lo < hi) {
      wgrad_rows<KC, CLUSTER && G == 0>(xs, ds, p.c_tile, lo, hi, j0,
                                        p.x_rows - 1, keep);
    } else if (lo < hi) {
      for (int j0 = 0; j0 < p.k; j0 += KC) {
        float acc[KC][VEC] = {};
        wgrad_rows<KC, false>(xs, ds, p.c_tile, lo, hi, j0, p.x_rows - 1,
                              acc);
#pragma unroll
        for (int jj = 0; jj < KC; ++jj) {
          if (j0 + jj < p.k) {
            float4* r4 =
                reinterpret_cast<float4*>(my_red + (size_t)(j0 + jj) * p.c_tile);
            *r4 = add4(*r4, make_float4(acc[jj][0], acc[jj][1], acc[jj][2],
                                        acc[jj][3]));
          }
        }
      }
    }
    __syncthreads();  // stage s is free again
    if (n + W_STAGES < n_mine) {
      if constexpr (G == 0) {
        if (tid == 0) request(n + W_STAGES);
      } else {
        request(n + W_STAGES);
      }
    }
    if constexpr (G != 0) cp_async_commit();
  }
  if constexpr (ONE_PASS) {
#pragma unroll
    for (int j = 0; j < KC; ++j) {
      if (j0 + j < KF) {
        *reinterpret_cast<float4*>(my_red + (size_t)(j0 + j) * p.c_tile) =
            make_float4(keep[j][0], keep[j][1], keep[j][2], keep[j][3]);
      }
    }
  }
  __syncthreads();  // every row group's sums are in red

  // this block's partial: the row groups added in order
  const int nvec = p.k * p.c_tile / VEC;
  float4* red4 = reinterpret_cast<float4*>(red);
  T* dw = static_cast<T*>(p.dw);
  const int cvec = p.c_tile / VEC;
  if constexpr (CLUSTER) {
    // the cluster's blocks (the tile's splits, rank = split) share the
    // final sum: output i belongs to block i % splits, and each block
    // stores its partial of i there, into inbox slot [i / splits][rank];
    // after the cluster barrier each block adds its outputs' partials in
    // rank order from its own shared memory
    const int s_n = p.splits;
    cluster_wait();
    for (int i = tid; i < nvec; i += nthr) {
      float4 a = red4[i];
      for (int gg = 1; gg < GROUPS; ++gg) a = add4(a, red4[(size_t)gg * nvec + i]);
      st_cluster4(inbox + (size_t)(i / s_n) * s_n + blockIdx.y,
                  (uint32_t)(i % s_n), a);
    }
    cluster_arrive();
    cluster_wait();  // every block's partials are in their owners' inboxes
    for (int m = tid; m * s_n + (int)blockIdx.y < nvec; m += nthr) {
      const int i = m * s_n + blockIdx.y;
      const float4* in = inbox + (size_t)m * s_n;
      float4 a = in[0];
      for (int u = 1; u < s_n; ++u) a = add4(a, in[u]);
      const float v[VEC] = {a.x, a.y, a.z, a.w};
      const int j = i / cvec;
      const int ch = c0 + (i % cvec) * VEC;
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        if (ch + e < p.c) store_from_f32(dw + (size_t)j * p.c + ch + e, v[e]);
      }
    }
    return;
  }
  float4* part = reinterpret_cast<float4*>(p.part) +
                 (size_t)ctile * p.splits * nvec;
  for (int i = tid; i < nvec; i += nthr) {
    float4 a = red4[i];
    for (int gg = 1; gg < GROUPS; ++gg) a = add4(a, red4[(size_t)gg * nvec + i]);
    __stcg(part + (size_t)blockIdx.y * nvec + i, a);
  }
  __threadfence();  // the partial is visible before the ticket is taken
  __syncthreads();
  if (tid == 0) *last = atomicAdd(&p.ticket[ctile], 1u);
  __syncthreads();
  if (*last != (unsigned)p.splits - 1) return;

  // the tile's last block: all partials in split order, one rounding
  __threadfence();
  for (int i = tid; i < nvec; i += nthr) {
    // up to W_FINAL partials in flight at once, added in split order
    float4 a = __ldcg(part + i);
    for (int s0 = 1; s0 < p.splits; s0 += W_FINAL) {
      float4 got[W_FINAL];
#pragma unroll
      for (int u = 0; u < W_FINAL; ++u) {
        if (s0 + u < p.splits) got[u] = __ldcg(part + (size_t)(s0 + u) * nvec + i);
      }
#pragma unroll
      for (int u = 0; u < W_FINAL; ++u) {
        if (s0 + u < p.splits) a = add4(a, got[u]);
      }
    }
    const float v[VEC] = {a.x, a.y, a.z, a.w};
    const int j = i / cvec;
    const int ch = c0 + (i % cvec) * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      if (ch + e < p.c) store_from_f32(dw + (size_t)j * p.c + ch + e, v[e]);
    }
  }
  if (tid == 0) p.ticket[ctile] = 0;  // for the next launch on the stream
}

template <typename T, int KF, int G>
int wgrad_instance(const CUtensorMap& xmap, const CUtensorMap& dmap,
                   const WParams& p, dim3 grid, dim3 block, int smem,
                   cudaStream_t stream) {
  static bool smem_raised = false;  // as in launch_instance
  if (!smem_raised) {
    const cudaError_t e = cudaFuncSetAttribute(
        dwconv1d_wgrad_kernel<T, KF, G>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
    if (e != cudaSuccess) return (int)e;
    smem_raised = true;
  }
  if constexpr (KF == K_WIDE) {
    // a cluster of the channel tile's splits (at most W_CLUSTER)
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = 1;
    attr[0].val.clusterDim.y = grid.y;
    attr[0].val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = grid;
    cfg.blockDim = block;
    cfg.dynamicSmemBytes = (size_t)smem;
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaLaunchKernelEx(
        &cfg, dwconv1d_wgrad_kernel<T, KF, G>, xmap, dmap, p);
    if (e != cudaSuccess) return (int)e;
  } else {
    dwconv1d_wgrad_kernel<T, KF, G><<<grid, block, smem, stream>>>(xmap, dmap,
                                                                   p);
  }
  return (int)cudaGetLastError();
}

template <typename T, int KF>
int wgrad_route(int copy_bytes, const CUtensorMap& xmap,
                const CUtensorMap& dmap, const WParams& p, dim3 grid,
                dim3 block, int smem, cudaStream_t stream) {
  switch (copy_bytes) {
    case 0:
      return wgrad_instance<T, KF, 0>(xmap, dmap, p, grid, block, smem,
                                      stream);
    case 4:
      return wgrad_instance<T, KF, 4>(xmap, dmap, p, grid, block, smem,
                                      stream);
    case 8:
      return wgrad_instance<T, KF, 8>(xmap, dmap, p, grid, block, smem,
                                      stream);
    case 2:  // element loads, bfloat16 only
      if constexpr (sizeof(T) == 2) {
        return wgrad_instance<T, KF, 2>(xmap, dmap, p, grid, block, smem,
                                        stream);
      }
      return (int)cudaErrorInvalidValue;
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// the compile-time instance for K_FIXED and K_WIDE, else the run-time K
template <typename T>
int wgrad_typed(int k, int copy_bytes, const CUtensorMap& xmap,
                const CUtensorMap& dmap, const WParams& p, dim3 grid,
                dim3 block, int smem, cudaStream_t stream) {
  if (k == K_FIXED) {
    return wgrad_route<T, K_FIXED>(copy_bytes, xmap, dmap, p, grid, block,
                                   smem, stream);
  }
  if (k == K_WIDE) {
    return wgrad_route<T, K_WIDE>(copy_bytes, xmap, dmap, p, grid, block,
                                  smem, stream);
  }
  return wgrad_route<T, 0>(copy_bytes, xmap, dmap, p, grid, block, smem,
                           stream);
}

// The wgrad's plan: the items, the grid, the shared memory and the
// workspace, from the constants above. openeat_torch/ops/
// depthwise_conv.py:wgrad_plan states the same plan. Returns false for a
// problem the kernel does not take.
struct WPlan {
  int c_tile, n_ctiles, rows, q, n_items, per, splits, x_rows, x_bytes,
      stage_bytes, smem, kf, kc, tap_groups, groups, cluster;
  long long ws_floats;
};

bool wgrad_plan(int batch, int t_in, int c, int k, int item, int sms,
                WPlan* w) {
  const int t_out = t_in - k + 1;
  if (batch <= 0 || c <= 0 || k <= 0 || t_out <= 0 || sms <= 0) return false;
  w->kf = k == K_FIXED || k == K_WIDE ? k : 0;
  w->kc = wgrad_kc(w->kf);
  w->tap_groups = wgrad_tap_groups(w->kf);
  w->groups = wgrad_groups(w->kf);
  w->cluster = w->kf == K_WIDE;
  w->c_tile = channel_tile(c, item, w->cluster ? W_WIDE_C_TILE : W_C_TILE);
  w->n_ctiles = (c + w->c_tile - 1) / w->c_tile;
  // items of at most W_ROWS rows (K_WIDE: W_WIDE_ROWS, and at least
  // W_CLUSTER / batch items a batch row), shorter where a large K leaves
  // less shared memory for the ring
  const int cap = w->cluster ? W_WIDE_ROWS : W_ROWS;
  int q0 = (t_out + cap - 1) / cap;
  if (w->cluster && q0 < W_CLUSTER / batch) q0 = W_CLUSTER / batch;
  long long x_bytes = 0, stage_bytes = 0, smem = 0;
  for (w->q = q0;; ++w->q) {
    w->rows = (t_out + w->q - 1) / w->q;
    w->x_rows = w->rows + k - 1;
    x_bytes = ((long long)w->x_rows * w->c_tile * item + 127) / 128 * 128;
    stage_bytes =
        x_bytes + ((long long)w->rows * w->c_tile * item + 127) / 128 * 128;
    smem = 128 + W_STAGES * stage_bytes +
           (long long)w->groups * k * w->c_tile * 4 + W_STAGES * 8 + 8 +
           (w->cluster ? ((long long)k * w->c_tile / VEC + W_CLUSTER) * 16
                       : 0);
    if (smem <= SMEM_MAX || w->rows == 1) break;
  }
  w->q = (t_out + w->rows - 1) / w->rows;  // no empty item
  const long long n_items = (long long)batch * w->q;
  long long per = 0;
  if (w->cluster) {
    per = (n_items + W_CLUSTER - 1) / W_CLUSTER;
  } else {
    const long long target =
        ((long long)W_BLOCKS_PER_SM * sms + w->n_ctiles - 1) / w->n_ctiles;
    per = (n_items + target - 1) / target;
    if (per < (n_items + 65534) / 65535) per = (n_items + 65534) / 65535;
  }
  if (n_items > 0x7fffffffLL || w->x_rows > MAX_BOX || smem > SMEM_MAX ||
      w->n_ctiles > W_MAX_CTILES) {
    return false;
  }
  w->n_items = (int)n_items;
  w->per = (int)per;
  w->splits = (int)((n_items + per - 1) / per);
  w->x_bytes = (int)x_bytes;
  w->stage_bytes = (int)stage_bytes;
  w->smem = (int)smem;
  w->ws_floats = W_MAX_CTILES +
                 (w->cluster ? 0LL
                             : (long long)w->n_ctiles * w->splits * k *
                                   w->c_tile);
  return true;
}

}  // namespace

// Forward: x [batch, tp, c] and w [k, c] give out [batch, tp-k+1, c].
// Dgrad: dy [batch, t, c] and the forward's w [k, c] give dx
// [batch, t+k-1, c]. dtype: 0 = float32, 1 = bfloat16, shared by all
// three tensors, which are contiguous. copy_bytes is the route that
// openeat_torch/ops/depthwise_conv.py:launch_plan picks from the input's
// address: 0 = TMA, 4 or 8 = the cp.async copy size, 2 = element loads
// (bfloat16 rows of odd C, or an input at a 2-byte offset). Each
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

// Weight gradient of the VALID depthwise conv: x [batch, tp, c] and dy
// [batch, tp-k+1, c] of dtype `dtype` (0 = float32, 1 = bfloat16) give
// dw [k, c] in the same dtype, summed in float32 in a fixed order.
// copy_bytes is the route (as for the forward) that fits both x and dy.
// `ws` is a workspace of ws_floats float32 values whose first
// W_MAX_CTILES words (the tickets) are 0 and stay 0 after each launch;
// openeat_torch/ops/depthwise_conv.py:wgrad_plan gives its size. Calls
// that share a workspace run one after another (one stream). Launches
// one kernel on `stream` and returns cudaGetLastError() (0 on success),
// cudaErrorInvalidValue for what the kernel does not take (a workspace
// too small among it), or 10000 + the CUresult of a tensor map.
extern "C" int openeat_dwconv1d_wgrad(const void* x, const void* dy,
                                      void* ws, long long ws_floats,
                                      void* dw, int batch, int tp, int c,
                                      int k, int dtype, int copy_bytes,
                                      void* stream) {
  if (dtype != 0 && dtype != 1) return (int)cudaErrorInvalidValue;
  const int item = dtype == 0 ? 4 : 2;
  WPlan w;
  if (!wgrad_plan(batch, tp, c, k, item, num_sms(), &w) ||
      ws_floats < w.ws_floats || !aligned(ws, 16) ||
      !route_fits(copy_bytes, item, c, x) ||
      !route_fits(copy_bytes, item, c, dy)) {
    return (int)cudaErrorInvalidValue;
  }
  const int t_out = tp - k + 1;
  alignas(64) CUtensorMap xmap{};
  alignas(64) CUtensorMap dmap{};
  if (copy_bytes == 0) {
    int rc = encode_map(&xmap, x, dtype, batch, tp, c, w.c_tile, w.x_rows);
    if (rc == 0) {
      rc = encode_map(&dmap, dy, dtype, batch, t_out, c, w.c_tile, w.rows);
    }
    if (rc != 0) return rc;
  }
  WParams p;
  p.x = x;
  p.dy = dy;
  p.dw = dw;
  p.ticket = static_cast<unsigned*>(ws);
  p.part = static_cast<float*>(ws) + W_MAX_CTILES;
  p.t_in = tp;
  p.t_out = t_out;
  p.c = c;
  p.k = k;
  p.c_tile = w.c_tile;
  p.rows = w.rows;
  p.q = w.q;
  p.n_items = w.n_items;
  p.per = w.per;
  p.splits = w.splits;
  p.x_rows = w.x_rows;
  p.x_bytes = w.x_bytes;
  p.stage_bytes = w.stage_bytes;
  const dim3 grid(w.n_ctiles, w.splits);
  const dim3 block(w.c_tile / VEC, w.groups, w.tap_groups);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return wgrad_typed<float>(w.kf, copy_bytes, xmap, dmap, p, grid, block,
                              w.smem, s);
  }
  return wgrad_typed<__nv_bfloat16>(w.kf, copy_bytes, xmap, dmap, p, grid,
                                    block, w.smem, s);
}

// The wgrad's plan for x [batch, tp, c] (dtype as above) on a card of
// `sms` SMs, as openeat_dwconv1d_wgrad derives it, into out[14]: c_tile,
// n_ctiles, rows, q, n_items, per, splits, x_rows, smem, kc, tap_groups,
// row groups, cluster (1: the splits of a channel tile are a cluster)
// and ws_floats, the fields of openeat_torch/ops/depthwise_conv.py:
// WGRAD_PLAN_FIELDS. Returns 0, or cudaErrorInvalidValue for a problem
// the kernel does not take.
extern "C" int openeat_dwconv1d_wgrad_plan(int batch, int tp, int c, int k,
                                           int dtype, int sms,
                                           long long* out) {
  WPlan w;
  if ((dtype != 0 && dtype != 1) ||
      !wgrad_plan(batch, tp, c, k, dtype == 0 ? 4 : 2, sms, &w)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long v[14] = {w.c_tile, w.n_ctiles, w.rows,   w.q,
                           w.n_items, w.per,     w.splits, w.x_rows,
                           w.smem,   w.kc,       w.tap_groups, w.groups,
                           w.cluster, w.ws_floats};
  for (int i = 0; i < 14; ++i) out[i] = v[i];
  return 0;
}

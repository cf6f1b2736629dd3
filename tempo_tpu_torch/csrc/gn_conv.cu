// K2: GroupNorm + activation + 3x3 SAME conv, NHWC, one pass.
//
// Replaces tempo_tpu/ops/pallas_gn_conv.py: _gn_conv_kernel.
//
// What bounds it on the H100: operations. At the flagship's widest shape
// ([8,64,64,512] -> 512) the conv does 2*9*C*F = 4.7 MFLOP per pixel
// against ~2 KB of input and output per pixel, far above the ~295 bf16
// FLOP/byte ridge. The bound is the bf16 tensor-core rate.
//
// Design: an implicit-GEMM conv. One block owns an 8x16 tile of output
// pixels (M = 128) and 64 output channels (N = 64); K = 9*C runs as a loop
// over C in chunks of 32 and, inside each chunk, over the nine taps.
// - Prologue fused on the load: the (8+2)x(16+2) halo slab of x for the
//   chunk's channels is read from device memory, normalized with the K1a
//   stats, scaled, shifted and activated in fp32, rounded to the operand
//   type and stored in shared memory. Pixels outside the image are stored
//   as 0 AFTER normalization and activation: zero padding of the activated
//   tensor, as the SAME conv of the plain chain sees it (not GN(0)).
// - The 3x3 taps are shifted views of the slab: for tap (di, dj), the A
//   operand of tile row r is slab row r+di starting at column dj, so no
//   im2col buffer exists anywhere.
// - bf16: operands are rounded to bf16 and multiplied on the tensor cores
//   with WMMA 16x16x16 fragments, fp32 accumulate. Eight warps; each owns
//   two tile rows x 32 channels (2x2 fragments).
// - fp32: the same tiles on CUDA cores (FMA), each thread 8 pixels x 4
//   channels. It keeps fp32 operands so fp32 runs match the plain chain.
// - The weight comes pre-laid-out as [9, C, F] in x's type (the module
//   caches that layout). Any F is masked (F = 64 and 1028 on the main path),
//   as are tiles that overhang H or W and a last chunk of C below 32.
// - Shared memory: 58.8 KB (bf16) or 97.5 KB (fp32) of dynamic shared
//   memory, reused for the fp32 epilogue tile that adds the conv bias and
//   writes coalesced rows of 64 channels.
// Simple and correct first: no cp.async/TMA pipelining and no wgmma yet.
#include <mma.h>

#include <type_traits>

#include "common.cuh"

namespace tempo {

constexpr int kTH = 8;                // output tile rows
constexpr int kTW = 16;               // output tile columns
constexpr int kBM = kTH * kTW;        // output pixels per block
constexpr int kBN = 64;               // output channels per block
constexpr int kBK = 32;               // input channels per chunk
constexpr int kSH = kTH + 2;          // slab rows (with halo)
constexpr int kSW = kTW + 2;          // slab columns (with halo)
constexpr int kSP = kSH * kSW;        // slab pixels
constexpr int kThreads = 256;
constexpr int kLDC = kBN + 4;         // fp32 epilogue tile stride

// Shared-memory strides by operand type. WMMA needs 32-byte aligned
// fragment bases: the slab pixel stride is a multiple of 16 bf16 values.
template <typename S>
struct Layout;
template <>
struct Layout<__nv_bfloat16> {
  static constexpr int kLDA = kBK + 16;  // 96-byte pixel stride
  static constexpr int kLDB = kBN + 8;   // 144-byte weight row stride
};
template <>
struct Layout<float> {
  static constexpr int kLDA = kBK + 1;
  static constexpr int kLDB = kBN;
};

template <typename S>
constexpr int smem_bytes() {
  constexpr int operands =
      (kSP * Layout<S>::kLDA + 9 * kBK * Layout<S>::kLDB) * (int)sizeof(S);
  constexpr int epilogue = kBM * kLDC * (int)sizeof(float);
  return operands > epilogue ? operands : epilogue;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    gn_conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias,
                      const T* __restrict__ wk, const float* __restrict__ cbias,
                      T* __restrict__ out, int h, int w, int c, int f,
                      int act) {
  using S = T;  // operand type in shared memory
  constexpr int LDA = Layout<S>::kLDA;
  constexpr int LDB = Layout<S>::kLDB;
  extern __shared__ __align__(128) unsigned char smem[];
  S* slab = reinterpret_cast<S*>(smem);
  S* wsm = slab + kSP * LDA;
  __shared__ float s_mean[kBK], s_mul[kBK], s_add[kBK];

  const int tid = threadIdx.x;
  const int tiles_w = (w + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const float* mean = stats + (size_t)b * 2 * c;
  const float* rstd = mean + c;
  const T* xb = x + (size_t)b * h * w * c;

  // bf16 accumulators (WMMA) or fp32 register tile (FMA).
  using namespace nvcuda;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][2];
  float facc[8][4];
  const int warp = tid / 32;
  const int wr = warp / 2;  // tile rows 2*wr, 2*wr+1
  const int wc = warp % 2;  // channels wc*32 .. wc*32+31
  const int fx = tid % 16;  // fp32 path: channel lane
  const int fy = tid / 16;  // fp32 path: tile column
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j) wmma::fill_fragment(acc[i][j], 0.0f);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;
  }

  for (int c0 = 0; c0 < c; c0 += kBK) {
    __syncthreads();  // previous chunk's operands are consumed
    if (tid < kBK) {
      const int ch = c0 + tid;
      if (ch < c) {
        s_mean[tid] = mean[ch];
        s_mul[tid] = rstd[ch] * scale[ch];
        s_add[tid] = bias[ch];
      }
    }
    __syncthreads();
    // Halo slab with the GN + activation prologue.
    for (int i = tid; i < kSP * kBK; i += kThreads) {
      const int p = i / kBK, k = i % kBK;
      const int gy = y0 + p / kSW - 1, gx = x0 + p % kSW - 1;
      const int ch = c0 + k;
      float v = 0.0f;
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && ch < c) {
        const float xv = to_f32(xb[((size_t)gy * w + gx) * c + ch]);
        v = apply_act(fmaf(xv - s_mean[k], s_mul[k], s_add[k]), act);
      }
      slab[p * LDA + k] = from_f32<S>(v);
    }
    // Weights of the chunk for all nine taps.
    for (int i = tid; i < 9 * kBK * kBN; i += kThreads) {
      const int n = i % kBN, k = (i / kBN) % kBK, t = i / (kBN * kBK);
      const int ch = c0 + k, fo = n0 + n;
      S v = from_f32<S>(0.0f);
      if (ch < c && fo < f) v = wk[((size_t)t * c + ch) * f + fo];
      wsm[(t * kBK + k) * LDB + n] = v;
    }
    __syncthreads();

    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          a[2];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16,
                     wmma::row_major>
          bf[2];
#pragma unroll
      for (int t = 0; t < 9; ++t) {
        const int di = t / 3, dj = t % 3;
#pragma unroll
        for (int ks = 0; ks < kBK; ks += 16) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int row = 2 * wr + i;
            wmma::load_matrix_sync(a[i], slab + ((row + di) * kSW + dj) * LDA + ks,
                                   LDA);
          }
#pragma unroll
          for (int j = 0; j < 2; ++j)
            wmma::load_matrix_sync(bf[j], wsm + (t * kBK + ks) * LDB + wc * 32 + j * 16,
                                   LDB);
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int j = 0; j < 2; ++j)
              wmma::mma_sync(acc[i][j], a[i], bf[j], acc[i][j]);
        }
      }
    } else {
      for (int t = 0; t < 9; ++t) {
        const int di = t / 3, dj = t % 3;
        for (int k = 0; k < kBK; ++k) {
          float av[8], wv[4];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            av[i] = to_f32(slab[((i + di) * kSW + fy + dj) * LDA + k]);
#pragma unroll
          for (int j = 0; j < 4; ++j)
            wv[j] = to_f32(wsm[(t * kBK + k) * LDB + fx + 16 * j]);
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(av[i], wv[j], facc[i][j]);
        }
      }
    }
  }

  // Epilogue: stage the fp32 tile in shared memory, add the conv bias,
  // write rows of 64 channels per pixel.
  __syncthreads();
  float* ctile = reinterpret_cast<float*>(smem);
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        wmma::store_matrix_sync(ctile + (2 * wr + i) * kTW * kLDC + wc * 32 + j * 16,
                                acc[i][j], kLDC, wmma::mem_row_major);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        ctile[(i * kTW + fy) * kLDC + fx + 16 * j] = facc[i][j];
  }
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int n = i % kBN, p = i / kBN;
    const int gy = y0 + p / kTW, gx = x0 + p % kTW, fo = n0 + n;
    if (gy < h && gx < w && fo < f)
      out[(((size_t)b * h + gy) * w + gx) * f + fo] =
          from_f32<T>(ctile[p * kLDC + n] + cbias[fo]);
  }
}

template <typename T>
int launch_gn_conv(const void* x, const void* stats, const void* scale,
                   const void* bias, const void* wk, const void* cbias,
                   void* out, int b, int h, int w, int c, int f, int act,
                   cudaStream_t stream) {
  constexpr int smem = smem_bytes<T>();
  cudaError_t err = cudaFuncSetAttribute(
      gn_conv3x3_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
  dim3 grid(tiles, (f + kBN - 1) / kBN, b);
  gn_conv3x3_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const T*>(wk), static_cast<const float*>(cbias),
      static_cast<T*>(out), h, w, c, f, act);
  return (int)cudaGetLastError();
}

}  // namespace tempo

extern "C" {

// x [B,H,W,C], stats [B,2,C] f32 (from tempo_gn_stats), scale/bias [C] f32,
// wk [9,C,F] in x's type, cbias [F] f32 -> out [B,H,W,F] in x's type.
int tempo_gn_conv3x3(const void* x, const void* stats, const void* scale,
                     const void* bias, const void* wk, const void* cbias,
                     void* out, int dtype, int b, int h, int w, int c, int f,
                     int act, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == tempo::DT_BF16)
    return tempo::launch_gn_conv<__nv_bfloat16>(x, stats, scale, bias, wk,
                                                cbias, out, b, h, w, c, f, act,
                                                s);
  return tempo::launch_gn_conv<float>(x, stats, scale, bias, wk, cbias, out, b,
                                      h, w, c, f, act, s);
}

}  // extern "C"

// K2: GroupNorm + activation + 3x3 SAME conv, NHWC, one pass.
//
// Replaces tempo_tpu/ops/pallas_gn_conv.py: _gn_conv_kernel.
//
// Computes, from x [B,H,W,C], K1a's [B,2,C] fp32 statistics, the GN scale
// and bias [C], the conv weight and the conv bias [F]: act((x - mean) *
// rstd * scale + bias) in fp32, rounded to x's type, zero-padded AFTER the
// activation (SAME padding of the activated tensor, not GN(0)), then the
// 3x3 conv with fp32 accumulation, plus the conv bias, out [B,H,W,F].
//
// What bounds it on the H100: operations. At the flagship's widest shape
// ([8,64,64,512] -> 512) the conv does 2*9*C*F = 4.7 MFLOP per pixel
// against ~2 KB of input and output per pixel, far above the ~295 bf16
// FLOP/byte ridge. The bound is the bf16 tensor-core rate (989 TFLOP/s).
//
// bf16 design (conv_bf16): an implicit GEMM on wgmma. M = a block's TH x TW
// output pixels, N = its BN output channels, K = 9 * C as (chunk of 64
// channels) x (tap); a k iteration is one (chunk, tap) pair.
// - A from registers. The chunk's halo slab ((TH+2) x (TW+2) pixels of 64
//   channels, one 128-byte row a pixel, 16-byte chunks XORed with the pixel
//   index mod 8) is normalised once and stays in shared memory for the nine
//   taps. A tap's A operand is a shifted view of it: each lane hands
//   ldmatrix.x4 the address of its own pixel (py + di, px + dj), so a shift
//   costs nothing whatever W is, and 8 consecutive pixels of a phase fall in
//   8 distinct 16-byte bank groups. Warp w of warpgroup g owns pixels
//   64g + 16w .. + 15.
// - B from a ring. A (chunk, tap) weight tile [64 x BN] is 8 KB per 64
//   columns, 128-byte rows swizzled as wgmma's mode 1 expects, in 64-column
//   panels (the descriptor's leading offset), read n-major. A chunk's nine
//   taps hold 9 * 64 * BN * 2 bytes (147 KB at BN = 128): too much to
//   double-buffer, so single tiles stream through a ring of kStages by
//   16-byte cp.async.cg, kStages - 1 tiles ahead of the products, one
//   commit group a tile (an empty one past the end, so the wait count holds).
//   Weight bytes per FLOP from L2 are 1 / BM: at BM = 128 and the full
//   tensor rate that is ~7.7 TB/s, above what L2 gives; at ~300 TFLOP/s it
//   is ~2.3 TB/s. So the large shapes take BM = 128; BM = 256 or a 2-block
//   cluster multicasting each tile by TMA is the way above that.
// - The prologue once per slab element per block. During a chunk's nine
//   taps the block normalises the next chunk's slab into the other slab
//   buffer, a ninth of it after each tap's products: 16-byte loads of raw
//   x, fp32 GN + activation, a bf16 16-byte store. Pixels outside the image
//   (and channels past C) are stored as 0 after the activation. A block
//   recomputes the prologue F / BN times in all (4 at F = 512 with BN =
//   128; the 8x16 tile's halo adds 1.41x).
// - Per k iteration: wait for the tile, fence.proxy.async, one
//   __syncthreads(), the next ring copy, 4 ldmatrix.x4, 4 wgmma (k 16 each),
//   commit, wait_group 0, the slab share. The overlap is between blocks:
//   two blocks an SM (the large configuration at <= 128 registers, 110 KB
//   of shared memory each) run one's products under the other's prologue,
//   barrier and waits. Tried on the H100 and dropped (PERF.md): the slab
//   share between commit and wait, or its x loads before the products
//   (both spilled at the 128-register cap), and one block an SM with a
//   second A buffer and one wgmma group in flight across the barrier; each
//   was slower.
// - Fill the card. The launcher (ops/cuda_gn_conv.py choose_config) picks a
//   configuration per call from B, H, W and F (TEMPO_GN_CONV_CONFIGS): 8x16
//   pixels x 128 channels (2 warpgroups) where at most a split in two fills
//   a wave of 132 blocks, else 4x16 pixels x 64 channels (1 warpgroup);
//   where a configuration launches fewer than 132 blocks, the k iterations
//   are split over blockIdx.z into an fp32 workspace [split, B*H*W, F]
//   that a second pass (reduce_splits) sums in a fixed order and adds the
//   conv bias to: no atomics, the same output on every run.
// - Ragged edges are masked: tiles that overhang H or W (computed, not
//   stored), F not a multiple of BN (weight columns past the padded F are
//   zero-filled by the copy, output columns past F not stored), C not a
//   multiple of 64 (the packed weight is zero-padded to 64-row chunks, the
//   slab's channels past C are 0).
// - The weight comes packed as [9, Cp, Fp] (Cp, Fp: C and F rounded up to
//   64, zero-padded), which the module caches (pack_conv3x3_weight).
// - Limits (ptxas for sm_90a, as chip_smoke.py's [build] ptxas
//   tempo::gn_conv lines print them; NVIDIA H100 80GB HBM3):
//     m128n128: 8x16 pixels x 128 channels, 2 warpgroups (256 threads), a
//       4-stage ring of 16 KB tiles and two 23 KB slabs: 112,640 bytes of
//       dynamic shared memory, 128 registers (the cap of 2 blocks an SM),
//       no spill; 2 blocks an SM.
//     m64n64: 4x16 pixels x 64 channels, 1 warpgroup (128 threads), 8 KB
//       tiles and two 13.5 KB slabs: 61,440 bytes, 110 registers, no
//       spill; 3 blocks an SM.
//
// fp32 (conv_f32): the first design's FMA body, kept so fp32 runs match the
// plain chain to 1e-4: an 8x16 pixel x 64 channel tile, chunks of 32
// channels with the GN prologue on the slab load, the nine taps as shifted
// views, each thread 8 pixels x 4 channels on CUDA cores.
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

namespace tempo {
namespace gn_conv {

using bf16 = __nv_bfloat16;

constexpr int kChunk = 64;  // input channels a chunk: one 128-byte slab row
constexpr int kTaps = 9;

// The tile configurations the launcher may pick, as (id, warpgroups, tile
// rows, tile columns, output channels); ops/cuda_gn_conv.py CONFIGS holds
// the same table.
#define TEMPO_GN_CONV_CONFIGS(X) \
  X(0, 2, 8, 16, 128)            \
  X(1, 1, 4, 16, 64)

struct Params {
  const bf16* x;
  const float* stats;  // [B, 2, C]: mean, rstd
  const float* scale;
  const float* bias;
  const bf16* wk;  // [9, cp, fp]
  const float* cbias;
  bf16* out;
  float* ws;  // [split, B*H*W, F] when the k iterations are split, else null
  long long m;  // B*H*W
  int h, w, c, f, cp, fp, act;
  int tiles_w, tiles;  // pixel tiles across a row, and in an image
  int nk, kper;        // k iterations in all, and a split's share
};

template <int WG, int TH, int TW, int BN>
struct Cfg {
  static constexpr int NT = 128 * WG;
  static constexpr int BM = TH * TW;
  static constexpr int SW = TW + 2, SP = (TH + 2) * SW;
  static constexpr int kSlabBytes = SP * 128;
  static constexpr int kSlabVecs = SP * 8;  // 16-byte vectors
  static constexpr int kSlices = (kSlabVecs + NT - 1) / NT;
  static constexpr int kTileBytes = (BN / 64) * 64 * 128;
  static constexpr int kStages = 4;
  // 1024: the ring is aligned for the swizzle.
  static constexpr int kSmem = 1024 + kStages * kTileBytes + 2 * kSlabBytes;
  static_assert(BM == 64 * WG, "a warpgroup owns 64 pixels");
  static_assert(TW % 8 == 0, "an ldmatrix phase reads 8 pixels of one row");
  static_assert(BN % 64 == 0, "weight tiles are 64-column panels");
  static_assert(kSlices <= kTaps, "the next slab fits in one chunk's taps");
  static_assert((64 * BN / 8) % NT == 0, "a weight tile splits evenly");
};

// Whether the slab vector at pixel (gy, gx), channels ch .. ch + 7, holds
// any of x (inside the image and below C).
__device__ __forceinline__ bool in_x(const Params& p, int gy, int gx,
                                     int ch) {
  return gy >= 0 && gy < p.h && gx >= 0 && gx < p.w && ch < p.c;
}

// x's 16 bytes at (gy, gx, ch .. ch + 7) when C % 8 == 0 and the vector is
// in x; zeros otherwise (slab_vector then reads element by element).
__device__ __forceinline__ uint4 load_raw(const Params& p, const bf16* xb,
                                          int gy, int gx, int ch) {
  if ((p.c & 7) != 0 || !in_x(p, gy, gx, ch)) return make_uint4(0, 0, 0, 0);
  return __ldg(reinterpret_cast<const uint4*>(
      xb + ((size_t)gy * p.w + gx) * p.c + ch));
}

// The slab's 16-byte vector at pixel (gy, gx), channels ch .. ch + 7:
// act((x - mean) * rstd * scale + bias) in fp32, rounded to bf16; zero
// outside the image and past C. ``raw`` is load_raw's vector.
__device__ __forceinline__ uint4 slab_vector(const Params& p, const bf16* xb,
                                             const float* mean,
                                             const float* rstd, int gy,
                                             int gx, int ch, uint4 raw) {
  uint4 out = make_uint4(0u, 0u, 0u, 0u);
  if (!in_x(p, gy, gx, ch)) return out;
  uint32_t* o = reinterpret_cast<uint32_t*>(&out);
  if ((p.c & 7) == 0) {
    // ch + 8 <= c; the statistics and the affine vectors are 16-byte
    // aligned there (the wrapper checks the base addresses).
    const __nv_bfloat162* xr = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
    for (int k = 0; k < 8; k += 4) {
      const float4 mu = __ldg(reinterpret_cast<const float4*>(mean + ch + k));
      const float4 rs = __ldg(reinterpret_cast<const float4*>(rstd + ch + k));
      const float4 sc = __ldg(reinterpret_cast<const float4*>(p.scale + ch + k));
      const float4 bi = __ldg(reinterpret_cast<const float4*>(p.bias + ch + k));
      const float2 x01 = __bfloat1622float2(xr[k / 2]);
      const float2 x23 = __bfloat1622float2(xr[k / 2 + 1]);
      const __nv_bfloat162 lo = __floats2bfloat162_rn(
          apply_act(fmaf(x01.x - mu.x, rs.x * sc.x, bi.x), p.act),
          apply_act(fmaf(x01.y - mu.y, rs.y * sc.y, bi.y), p.act));
      const __nv_bfloat162 hi = __floats2bfloat162_rn(
          apply_act(fmaf(x23.x - mu.z, rs.z * sc.z, bi.z), p.act),
          apply_act(fmaf(x23.y - mu.w, rs.w * sc.w, bi.w), p.act));
      o[k / 2] = *reinterpret_cast<const uint32_t*>(&lo);
      o[k / 2 + 1] = *reinterpret_cast<const uint32_t*>(&hi);
    }
    return out;
  }
  const bf16* src = xb + ((size_t)gy * p.w + gx) * p.c + ch;
#pragma unroll
  for (int k = 0; k < 8; k += 2) {
    float y[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int cc = ch + k + e;
      y[e] = cc < p.c ? apply_act(fmaf(__bfloat162float(src[k + e]) - mean[cc],
                                       rstd[cc] * p.scale[cc], p.bias[cc]),
                                  p.act)
                      : 0.f;
    }
    const __nv_bfloat162 v = __floats2bfloat162_rn(y[0], y[1]);
    o[k / 2] = *reinterpret_cast<const uint32_t*>(&v);
  }
  return out;
}

template <int WG, int TH, int TW, int BN>
__global__ void __launch_bounds__(128 * WG,
                                  WG == 2 ? 2 : 3)
    conv_bf16(Params p) {
  using C = Cfg<WG, TH, TW, BN>;
  constexpr int NT = C::NT, NS = C::kStages;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  unsigned char* slab = ring + NS * C::kTileBytes;  // two buffers

  const int tid = threadIdx.x;
  const int b = blockIdx.x / p.tiles, tile = blockIdx.x % p.tiles;
  const int y0 = (tile / p.tiles_w) * TH, x0 = (tile % p.tiles_w) * TW;
  const int n0 = blockIdx.y * BN;
  const int k0 = blockIdx.z * p.kper;
  const int nk = min(p.nk - k0, p.kper);  // this block's k iterations
  const bf16* xb = p.x + (size_t)b * p.h * p.w * p.c;
  const float* mean = p.stats + (size_t)b * 2 * p.c;
  const float* rstd = mean + p.c;

  // Slices [s_lo, s_hi) of chunk q's slab, NT vectors a slice, into buffer
  // q % 2: vector v is pixel v / 8, channels 8 (v % 8) .. + 7.
  auto fill = [&](int q, int s_lo, int s_hi) {
    for (int s = s_lo; s < s_hi; ++s) {
      const int v = s * NT + tid;
      if (C::kSlabVecs % NT != 0 && v >= C::kSlabVecs) break;
      const int px = v >> 3, j = v & 7;
      const int gy = y0 + px / C::SW - 1, gx = x0 + px % C::SW - 1;
      const int ch = q * kChunk + j * 8;
      *reinterpret_cast<uint4*>(slab + (q & 1) * C::kSlabBytes +
                                swizzle128(px * 128 + j * 16)) =
          slab_vector(p, xb, mean, rstd, gy, gx, ch,
                      load_raw(p, xb, gy, gx, ch));
    }
  };

  // The weight tile of local k iteration j into stage j % NS as one commit
  // group; past the last one the group is empty.
  auto load_tile = [&](int j) {
    if (j < nk) {
      const int i = k0 + j, q = i / kTaps, t = i - kTaps * q;
      unsigned char* dst = ring + (j % NS) * C::kTileBytes;
      const bf16* src = p.wk + ((size_t)t * p.cp + q * kChunk) * p.fp + n0;
      constexpr int kRowVecs = BN / 8, kVecs = 64 * kRowVecs;
#pragma unroll
      for (int it = 0; it < kVecs / NT; ++it) {
        const int v = it * NT + tid;
        const int r = v / kRowVecs, col = (v % kRowVecs) * 8;
        const bool live = n0 + col < p.fp;
        cp_async<16>(dst + (col / 64) * 8192 +
                         swizzle128(r * 128 + (col % 64) * 2),
                     src + (size_t)r * p.fp + (live ? col : 0), live);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_tile(j);
  const int q_last = (k0 + nk - 1) / kTaps;
  fill(k0 / kTaps, 0, C::kSlices);

  // This lane's ldmatrix row: pixel m of the tile; lanes 16-31 read the
  // k step's second 8 channels (the next 16-byte chunk).
  const int warp = tid >> 5, lane = tid & 31;
  const int m = (warp >> 2) * 64 + (warp & 3) * 16 + (lane & 15);
  const int my_py = m / TW, my_px = m % TW, khalf = lane >> 4;
  float acc[BN / 8][4];
#pragma unroll
  for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nb][e] = 0.f;

  for (int j = 0; j < nk; ++j) {
    const int i = k0 + j, q = i / kTaps, t = i - kTaps * q;
    cp_async_wait<NS - 2>();  // this thread's copies of tile j have landed
    fence_async_proxy();
    __syncthreads();  // everyone's have; tile j - 1 and chunk q - 1 are done
    load_tile(j + NS - 1);  // into the stage tile j - 1 held

    const int di = t / 3, dj = t - 3 * di;
    const int sp = (my_py + di) * C::SW + my_px + dj;
    const unsigned char* arow = slab + (q & 1) * C::kSlabBytes + sp * 128;
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      ldsm4(a[kk], arow + (((2 * kk + khalf) ^ (sp & 7)) << 4));
    const uint32_t wt = smem_addr(ring + (j % NS) * C::kTileBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma<1>(acc, a[kk], wg_desc(wt + kk * 2048, 8192, 1024, 1), 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(acc[nb][e]);
    // A ninth of the next chunk's slab (all the slices before it too where
    // the block's range starts mid-chunk), while the SM's other block keeps
    // the tensor cores busy.
    if (q < q_last)
      fill(q + 1, j == 0 ? 0 : t * C::kSlices / kTaps,
           (t + 1) * C::kSlices / kTaps);
  }

  // Epilogue from the accumulators: lane (g, c) holds pixels g and g + 8 of
  // its warp's 16, channels 8 nb + 2c, + 1.
  const int g = lane >> 2, c4 = lane & 3;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int mm = (warp >> 2) * 64 + (warp & 3) * 16 + g + 8 * hh;
    const int gy = y0 + mm / TW, gx = x0 + mm % TW;
    if (gy >= p.h || gx >= p.w) continue;
    const long long pix = ((long long)b * p.h + gy) * p.w + gx;
#pragma unroll
    for (int nb = 0; nb < BN / 8; ++nb) {
      const int col = n0 + nb * 8 + 2 * c4;
      const float v0 = acc[nb][2 * hh], v1 = acc[nb][2 * hh + 1];
      if (p.ws != nullptr) {
        float* dst = p.ws + ((long long)blockIdx.z * p.m + pix) * p.f + col;
        if ((p.f & 1) == 0 && col < p.f) {
          *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
        } else {
          if (col < p.f) dst[0] = v0;
          if (col + 1 < p.f) dst[1] = v1;
        }
      } else {
        bf16* dst = p.out + pix * p.f + col;
        if ((p.f & 1) == 0 && col < p.f) {
          *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(
              v0 + p.cbias[col], v1 + p.cbias[col + 1]);
        } else {
          if (col < p.f) dst[0] = __float2bfloat16(v0 + p.cbias[col]);
          if (col + 1 < p.f) dst[1] = __float2bfloat16(v1 + p.cbias[col + 1]);
        }
      }
    }
  }
}

// out = bf16(sum over the splits, in order, + the conv bias).
__global__ void reduce_splits(const float* __restrict__ ws,
                              const float* __restrict__ cbias,
                              bf16* __restrict__ out, long long n, int f,
                              int split) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < split; ++k) s += ws[k * n + i];
    out[i] = __float2bfloat16(s + cbias[i % f]);
  }
}

template <int WG, int TH, int TW, int BN>
int launch_bf16(Params p, int b, int split, cudaStream_t stream) {
  using C = Cfg<WG, TH, TW, BN>;
  static bool attr_set = false;
  if (!attr_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        conv_bf16<WG, TH, TW, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::kSmem);
    if (err != cudaSuccess) return (int)err;
    attr_set = true;
  }
  p.tiles_w = (p.w + TW - 1) / TW;
  p.tiles = ((p.h + TH - 1) / TH) * p.tiles_w;
  p.kper = (p.nk + split - 1) / split;
  dim3 grid(b * p.tiles, (p.f + BN - 1) / BN, split);
  conv_bf16<WG, TH, TW, BN><<<grid, C::NT, C::kSmem, stream>>>(p);
  return (int)cudaGetLastError();
}

int smem_bf16(int cfg) {
#define TEMPO_GN_CONV_SMEM(ID, WG, TH, TW, BN) \
  case ID:                                     \
    return Cfg<WG, TH, TW, BN>::kSmem;
  switch (cfg) {
    TEMPO_GN_CONV_CONFIGS(TEMPO_GN_CONV_SMEM)
    default:
      return -1;
  }
#undef TEMPO_GN_CONV_SMEM
}

// ------------------------------------------------------------------ fp32

namespace f32 {
constexpr int kTH = 8;          // output tile rows
constexpr int kTW = 16;         // output tile columns
constexpr int kBM = kTH * kTW;  // output pixels per block
constexpr int kBN = 64;         // output channels per block
constexpr int kBK = 32;         // input channels per chunk
constexpr int kSW = kTW + 2;    // slab columns (with halo)
constexpr int kSP = (kTH + 2) * kSW;
constexpr int kThreads = 256;
constexpr int kLDA = kBK + 1;
constexpr int kLDC = kBN + 4;  // epilogue tile stride
constexpr int kOperands = (kSP * kLDA + 9 * kBK * kBN) * 4;
constexpr int kSmem = kOperands > kBM * kLDC * 4 ? kOperands : kBM * kLDC * 4;
}  // namespace f32

__global__ void __launch_bounds__(f32::kThreads)
    conv_f32(const float* __restrict__ x, const float* __restrict__ stats,
             const float* __restrict__ scale, const float* __restrict__ bias,
             const float* __restrict__ wk, const float* __restrict__ cbias,
             float* __restrict__ out, int h, int w, int c, int f, int cp,
             int fp, int act) {
  using namespace f32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* slab = reinterpret_cast<float*>(smem);
  float* wsm = slab + kSP * kLDA;
  __shared__ float s_mean[kBK], s_mul[kBK], s_add[kBK];

  const int tid = threadIdx.x;
  const int tiles_w = (w + kTW - 1) / kTW;
  const int y0 = (blockIdx.x / tiles_w) * kTH;
  const int x0 = (blockIdx.x % tiles_w) * kTW;
  const int n0 = blockIdx.y * kBN;
  const int b = blockIdx.z;
  const float* mean = stats + (size_t)b * 2 * c;
  const float* rstd = mean + c;
  const float* xb = x + (size_t)b * h * w * c;
  const int fx = tid % 16;  // channel lane
  const int fy = tid / 16;  // tile column
  float facc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) facc[i][j] = 0.0f;

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
      if (gy >= 0 && gy < h && gx >= 0 && gx < w && ch < c)
        v = apply_act(fmaf(xb[((size_t)gy * w + gx) * c + ch] - s_mean[k],
                           s_mul[k], s_add[k]),
                      act);
      slab[p * kLDA + k] = v;
    }
    // Weights of the chunk for all nine taps (zero past C and F).
    for (int i = tid; i < 9 * kBK * kBN; i += kThreads) {
      const int n = i % kBN, k = (i / kBN) % kBK, t = i / (kBN * kBK);
      const int ch = c0 + k, fo = n0 + n;
      float v = 0.0f;
      if (ch < c && fo < f) v = wk[((size_t)t * cp + ch) * fp + fo];
      wsm[(t * kBK + k) * kBN + n] = v;
    }
    __syncthreads();

    for (int t = 0; t < 9; ++t) {
      const int di = t / 3, dj = t % 3;
      for (int k = 0; k < kBK; ++k) {
        float av[8], wv[4];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          av[i] = slab[((i + di) * kSW + fy + dj) * kLDA + k];
#pragma unroll
        for (int j = 0; j < 4; ++j) wv[j] = wsm[(t * kBK + k) * kBN + fx + 16 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) facc[i][j] = fmaf(av[i], wv[j], facc[i][j]);
      }
    }
  }

  // Epilogue: stage the tile in shared memory, add the conv bias, write
  // rows of 64 channels per pixel.
  __syncthreads();
  float* ctile = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      ctile[(i * kTW + fy) * kLDC + fx + 16 * j] = facc[i][j];
  __syncthreads();
  for (int i = tid; i < kBM * kBN; i += kThreads) {
    const int n = i % kBN, p = i / kBN;
    const int gy = y0 + p / kTW, gx = x0 + p % kTW, fo = n0 + n;
    if (gy < h && gx < w && fo < f)
      out[(((size_t)b * h + gy) * w + gx) * f + fo] =
          ctile[p * kLDC + n] + cbias[fo];
  }
}

int launch_f32(const void* x, const void* stats, const void* scale,
               const void* bias, const void* wk, const void* cbias, void* out,
               int b, int h, int w, int c, int f, int act,
               cudaStream_t stream) {
  using namespace f32;
  cudaError_t err = cudaFuncSetAttribute(
      conv_f32, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = ((h + kTH - 1) / kTH) * ((w + kTW - 1) / kTW);
  dim3 grid(tiles, (f + kBN - 1) / kBN, b);
  conv_f32<<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<const float*>(wk), static_cast<const float*>(cbias),
      static_cast<float*>(out), h, w, c, f, (c + 63) / 64 * 64,
      (f + 63) / 64 * 64, act);
  return (int)cudaGetLastError();
}

}  // namespace gn_conv
}  // namespace tempo

extern "C" {

// x [B,H,W,C], stats [B,2,C] f32 (from tempo_gn_stats), scale/bias [C] f32,
// wk [9,Cp,Fp] in x's type (Cp, Fp: C, F rounded up to 64, zero-padded),
// cbias [F] f32 -> out [B,H,W,F] in x's type. bf16: the tile configuration
// cfg (TEMPO_GN_CONV_CONFIGS) and the split of the k iterations; with
// split > 1, ws is an fp32 [split, B*H*W, F] workspace. fp32 ignores cfg,
// split and ws.
int tempo_gn_conv3x3(const void* x, const void* stats, const void* scale,
                     const void* bias, const void* wk, const void* cbias,
                     void* out, void* ws, int dtype, int b, int h, int w,
                     int c, int f, int act, int cfg, int split,
                     void* stream) {
  using namespace tempo::gn_conv;
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype != tempo::DT_BF16)
    return launch_f32(x, stats, scale, bias, wk, cbias, out, b, h, w, c, f,
                      act, s);
  if (split < 1 || (split > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  Params p;
  p.x = static_cast<const bf16*>(x);
  p.stats = static_cast<const float*>(stats);
  p.scale = static_cast<const float*>(scale);
  p.bias = static_cast<const float*>(bias);
  p.wk = static_cast<const bf16*>(wk);
  p.cbias = static_cast<const float*>(cbias);
  p.out = static_cast<bf16*>(out);
  p.ws = split > 1 ? static_cast<float*>(ws) : nullptr;
  p.m = (long long)b * h * w;
  p.h = h;
  p.w = w;
  p.c = c;
  p.f = f;
  p.cp = (c + kChunk - 1) / kChunk * kChunk;
  p.fp = (f + 63) / 64 * 64;
  p.act = act;
  p.nk = kTaps * (p.cp / kChunk);
  int err;
#define TEMPO_GN_CONV_LAUNCH(ID, WG, TH, TW, BN)      \
  case ID:                                            \
    err = launch_bf16<WG, TH, TW, BN>(p, b, split, s); \
    break;
  switch (cfg) {
    TEMPO_GN_CONV_CONFIGS(TEMPO_GN_CONV_LAUNCH)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TEMPO_GN_CONV_LAUNCH
  if (err || split == 1) return err;
  const long long n = p.m * f;
  const int blocks = (int)((n + 255) / 256 < 4096 ? (n + 255) / 256 : 4096);
  reduce_splits<<<blocks, 256, 0, s>>>(p.ws, p.cbias, p.out, n, f, split);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the bf16 configuration cfg, -1 if unknown.
int tempo_gn_conv_smem_bytes(int cfg) { return tempo::gn_conv::smem_bf16(cfg); }

}  // extern "C"

// K5: flash attention for training, causal or not: the forward (K5f), the
// dK/dV pass (K5dkv) and the dQ pass (K5dq).
//
// Replaces the library Pallas TPU flash attention that
// tempo_tpu/nn/transformer.py: _flash_attention calls
// (jax/experimental/pallas/ops/tpu/flash_attention.py: the forward
// pallas_call, _flash_attention_bwd_dkv and _flash_attention_bwd_dq).
//
// Over q, k, v [b, t, n, hd] (head h of q reads head h of k/v; GQA is
// repeated to n heads by the caller) with s = scale * q.k:
//   K5f   o = softmax_j(s) v over keys j <= i (causal) or all j < t, and the
//         row's logsumexp lse [b, n, t] in fp32;
//   K5dkv dv_j = sum_i p_ij do_i, dk_j = scale * sum_i ds_ij q_i;
//   K5dq  dq_i = scale * sum_j ds_ij k_j,
// with p_ij = exp(s_ij - lse_i) recomputed from q, k and lse, and
// ds_ij = p_ij (do_i . v_j - di_i), di_i = do_i . o_i (fp32, computed by the
// wrapper as the library computes it outside its kernels). dQ has its own
// kernel, as the library's, so no atomics are needed and every pass is
// deterministic.
//
// What bounds it on the H100: both, nearly equally. At GPT-2-small's
// training shape ([8, 1024, 12, 64] bf16, causal: t(t+1)/2 pairs) the
// forward does 2 products (12.9 GFLOP, 13.0 us at 989 TFLOP/s) and must
// move q, k, v, o and lse once (50.7 MB, 15.1 us at 3.35 TB/s): 254
// FLOP/byte, just under the ~295 of the bf16 ridge. dK/dV (4 products,
// 25.8 GFLOP against 76 MB) and dQ (3 products, 19.3 GFLOP against 64 MB)
// sit just above it. A kernel near the bound must keep the tensor cores fed
// while it streams each operand once.
//
// Design (simple and correct first; wgmma, TMA and pipelining are left for
// later):
// - One block per (64-row tile, batch x head): 64 query rows (K5f, K5dq) or
//   64 key rows (K5dkv), 4 warps of 16 rows each. The TPU grid walked the
//   other sequence axis serially through VMEM scratch; here that is a loop
//   inside the block over tiles staged in shared memory (64 keys for K5f and
//   K5dq; 64 queries for K5dkv, 32 at hd 128 to keep the accumulators in
//   registers).
// - bf16: mma.sync m16n8k16 bf16 with fp32 accumulation. The score tile
//   stays in registers: its accumulator layout is re-packed in place as the
//   A operand of the next product (p.V, ds.K, p^T.dO, ds^T.q), rounded to
//   bf16 there. Operands read as B along their rows are also staged
//   transposed (v in K5f, k in K5dq, q and do in K5dkv), so every fragment
//   is two 32-bit shared loads; rows are padded by 8 values so the 8 row
//   groups of a warp hit distinct banks.
// - Online softmax in fp32 in the log2 domain (exp2f), the running max and
//   sum per row shared by the row's 4 lanes; rows are normalised once at
//   the end. lse = (m + log2 l) * ln 2.
// - Causal: tiles wholly above the diagonal are not visited (the loop stops
//   at the diagonal tile, K5dkv starts there); only elements of the
//   diagonal tile are masked. Masked scores are -inf, p = 0, so a padded
//   tail tile (t not a multiple of 64; its rows are staged as zeros) gives 0
//   and never NaN. The TPU kernel adds DEFAULT_MASK_VALUE (-0.7 f32max)
//   instead; with t_q = t_k no causal row is wholly masked, so both agree.
// - K5f and K5dq walk the query tiles from the last one down, so the blocks
//   with the most key tiles start first.
// - fp32: the same blocks and tiles on CUDA cores (FMA), 8 warps; a warp
//   owns 8 rows, its lanes split the tile's 64 keys (or queries) for the
//   dot products and then the head dim for the accumulation. Slow, kept for
//   fp32 runs that must match the plain version to 1e-4.
// - Strides: q, k, v and do are taken as strided views (batch, sequence and
//   head strides in elements, the head dim contiguous), so the wrapper passes
//   the c_attn output's slices as they are; rows are read as 16-byte
//   vectors (the wrapper checks the alignment). o, dq, dk and dv are
//   written contiguous [b, t, n, hd]; lse and di are [b, n, t] fp32.
#include <math.h>
#include <stdint.h>

#include "common.cuh"

namespace tempo {
namespace flash {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;  // rows a block owns
constexpr int kTile = 64;  // rows of the other sequence per staged tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;  // [b, n, t], natural log (backward inputs)
  const float* di;   // [b, n, t]
  void* o;
  float* lse_out;
  void* dq;
  void* dk;
  void* dv;
  long long sq[3], sk[3], sv[3], sdo[3];  // batch, sequence, head strides
  int t, n;
  float scale;
  int causal;
};

template <typename T>
__device__ __forceinline__ const T* head_ptr(const void* base,
                                             const long long (&s)[3], int bi,
                                             int h) {
  return static_cast<const T*>(base) + bi * s[0] + h * s[2];
}

// Offset of row r of head h, batch bi, in a contiguous [b, t, n, hd] output.
__device__ __forceinline__ size_t out_row(int bi, int r, int h, int t, int n,
                                          int hd) {
  return ((size_t)bi * t + r) * n * hd + (size_t)h * hd;
}

// ------------------------------------------------------------------ bf16

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// d += a . b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// A operand (16 x 16) at rows r0.., columns k0.. of row-major x (stride ld).
// Lane (g = lane / 4, c = lane % 4) holds rows g and g + 8, columns 2c, 2c+1
// and 2c+8, 2c+9.
__device__ __forceinline__ void frag_a(uint32_t (&a)[4], const bf16* x,
                                       int ld, int r0, int k0, int g, int c) {
  const bf16* p = x + (r0 + g) * ld + k0 + 2 * c;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * ld);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * ld + 8);
}

// B operand (16 x 8), B[kk][nn] = y[n0 + nn][k0 + kk] for row-major y.
__device__ __forceinline__ void frag_b(uint32_t (&b)[2], const bf16* y,
                                       int ld, int n0, int k0, int g, int c) {
  const bf16* p = y + (n0 + g) * ld + k0 + 2 * c;
  b[0] = ld32(p);
  b[1] = ld32(p + 8);
}

// The accumulators of two adjacent 16 x 8 tiles (columns 16kk .. 16kk+15)
// as the A operand over those columns, rounded to bf16.
__device__ __forceinline__ void frag_a_acc(uint32_t (&a)[4],
                                           const float (&lo)[4],
                                           const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Rows [r0, r0 + R) of a strided [t, HD] matrix (row stride rs) into shared
// memory, row-major x[R][LD] and/or transposed xt[HD][LDT]; rows at or past t
// are zeros.
template <int R, int HD, int LD, int LDT>
__device__ __forceinline__ void stage(bf16* x, bf16* xt, const bf16* src,
                                      long long rs, int r0, int t) {
  constexpr int kVec = HD / 8;  // 16-byte vectors per row
  for (int i = threadIdx.x; i < R * kVec; i += blockDim.x) {
    const int r = i / kVec, c = (i % kVec) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < t)
      val = __ldg(reinterpret_cast<const uint4*>(src + (r0 + r) * rs + c));
    if (x != nullptr) *reinterpret_cast<uint4*>(x + r * LD + c) = val;
    if (xt != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&val);
#pragma unroll
      for (int j = 0; j < 8; ++j) xt[(c + j) * LDT + r] = e[j];
    }
  }
}

__device__ __forceinline__ bool visible(int row, int col, int t, int causal) {
  return col < t && row < t && !(causal && col > row);
}

template <int HD>
constexpr int fwd_smem() {
  return ((kRows + kTile) * (HD + 8) + HD * (kTile + 8)) * 2;
}

template <int HD>
__global__ void __launch_bounds__(128) fwd_bf16(Params p) {
  constexpr int LD = HD + 8, LDT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* ks = qs + kRows * LD;
  bf16* vt = ks + kTile * LD;
  const int t = p.t, n = p.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bi = blockIdx.y / n, h = blockIdx.y % n;
  const bf16* q = head_ptr<bf16>(p.q, p.sq, bi, h);
  const bf16* k = head_ptr<bf16>(p.k, p.sk, bi, h);
  const bf16* v = head_ptr<bf16>(p.v, p.sv, bi, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, wr = warp * 16;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  stage<kRows, HD, LD, 0>(qs, nullptr, q, p.sq[1], q0, t);
  float acc[HD / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const float sl2 = p.scale * kLog2e;
  int n_tiles = (t + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kTile + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();  // the previous tile is consumed
    stage<kTile, HD, LD, 0>(ks, nullptr, k, p.sk[1], k0, t);
    stage<kTile, HD, 0, LDT>(nullptr, vt, v, p.sv[1], k0, t);
    __syncthreads();

    float s[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t a[4];
      frag_a(a, qs, LD, wr, kk * 16, g, c);
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb) {
        uint32_t b[2];
        frag_b(b, ks, LD, nb * 8, kk * 16, g, c);
        mma(s[nb], a, b);
      }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + 2 * c + (e & 1);
        float x = s[nb][e] * sl2;
        if (col >= t || (p.causal && col > rows[e >> 1])) x = -INFINITY;
        s[nb][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    float base[2], alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      base[i] = mn == -INFINITY ? 0.f : mn;
      alpha[i] = exp2f(m[i] - base[i]);
      m[i] = mn;
    }
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[nb][e] - base[e >> 1]);
        s[nb][e] = pe;
        rsum[e >> 1] += pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      acc[nb][0] *= alpha[0];
      acc[nb][1] *= alpha[0];
      acc[nb][2] *= alpha[1];
      acc[nb][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      frag_a_acc(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        uint32_t b[2];
        frag_b(b, vt, LDT, nb * 8, kk * 16, g, c);
        mma(acc[nb], a, b);
      }
    }
  }

  bf16* o = static_cast<bf16*>(p.o);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (rows[i] >= t) continue;
    const float inv = 1.f / l[i];
    bf16* orow = o + out_row(bi, rows[i], h, t, n, HD);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(orow + nb * 8 + 2 * c) =
          __floats2bfloat162_rn(acc[nb][2 * i] * inv, acc[nb][2 * i + 1] * inv);
    if (c == 0)
      p.lse_out[(size_t)blockIdx.y * t + rows[i]] = (m[i] + log2f(l[i])) * kLn2;
  }
}

template <int HD>
constexpr int dq_smem() {
  return ((2 * kRows + 2 * kTile) * (HD + 8) + HD * (kTile + 8)) * 2;
}

template <int HD>
__global__ void __launch_bounds__(128) dq_bf16(Params p) {
  constexpr int LD = HD + 8, LDT = kTile + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* qs = reinterpret_cast<bf16*>(smem);
  bf16* dos = qs + kRows * LD;
  bf16* ks = dos + kRows * LD;
  bf16* vs = ks + kTile * LD;
  bf16* kt = vs + kTile * LD;
  const int t = p.t, n = p.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bi = blockIdx.y / n, h = blockIdx.y % n;
  const bf16* q = head_ptr<bf16>(p.q, p.sq, bi, h);
  const bf16* k = head_ptr<bf16>(p.k, p.sk, bi, h);
  const bf16* v = head_ptr<bf16>(p.v, p.sv, bi, h);
  const bf16* dout = head_ptr<bf16>(p.dout, p.sdo, bi, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, wr = warp * 16;
  const int rows[2] = {q0 + wr + g, q0 + wr + g + 8};

  stage<kRows, HD, LD, 0>(qs, nullptr, q, p.sq[1], q0, t);
  stage<kRows, HD, LD, 0>(dos, nullptr, dout, p.sdo[1], q0, t);
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const size_t at = (size_t)blockIdx.y * t + rows[i];
    lse2[i] = rows[i] < t ? p.lse[at] * kLog2e : 0.f;
    di[i] = rows[i] < t ? p.di[at] : 0.f;
  }
  float acc[HD / 8][4] = {};
  const float sl2 = p.scale * kLog2e;
  int n_tiles = (t + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kTile + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    stage<kTile, HD, LD, LDT>(ks, kt, k, p.sk[1], k0, t);
    stage<kTile, HD, LD, 0>(vs, nullptr, v, p.sv[1], k0, t);
    __syncthreads();

    float s[kTile / 8][4] = {}, dp[kTile / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t aq[4], ado[4];
      frag_a(aq, qs, LD, wr, kk * 16, g, c);
      frag_a(ado, dos, LD, wr, kk * 16, g, c);
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb) {
        uint32_t b[2];
        frag_b(b, ks, LD, nb * 8, kk * 16, g, c);
        mma(s[nb], aq, b);
        frag_b(b, vs, LD, nb * 8, kk * 16, g, c);
        mma(dp[nb], ado, b);
      }
    }
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nb * 8 + 2 * c + (e & 1);
        float ds = 0.f;
        if (visible(rows[e >> 1], col, t, p.causal)) {
          const float pe = exp2f(s[nb][e] * sl2 - lse2[e >> 1]);
          ds = pe * (dp[nb][e] - di[e >> 1]);
        }
        s[nb][e] = ds;
      }
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk) {
      uint32_t a[4];
      frag_a_acc(a, s[2 * kk], s[2 * kk + 1]);
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        uint32_t b[2];
        frag_b(b, kt, LDT, nb * 8, kk * 16, g, c);
        mma(acc[nb], a, b);
      }
    }
  }

  bf16* dq = static_cast<bf16*>(p.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (rows[i] >= t) continue;
    bf16* row = dq + out_row(bi, rows[i], h, t, n, HD);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb)
      *reinterpret_cast<__nv_bfloat162*>(row + nb * 8 + 2 * c) =
          __floats2bfloat162_rn(acc[nb][2 * i] * p.scale,
                                acc[nb][2 * i + 1] * p.scale);
  }
}

// Queries per staged tile in K5dkv: 32 at hd 128 keeps the dK and dV
// accumulators and both score tiles in registers.
template <int HD>
constexpr int kDkvTile = HD == 128 ? 32 : 64;

template <int HD>
constexpr int dkv_smem() {
  constexpr int BI = kDkvTile<HD>;
  return ((2 * kRows + 2 * BI) * (HD + 8) + 2 * HD * (BI + 8)) * 2 +
         2 * BI * 4;
}

template <int HD>
__global__ void __launch_bounds__(128) dkv_bf16(Params p) {
  constexpr int BI = kDkvTile<HD>;
  constexpr int LD = HD + 8, LDT = BI + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + kRows * LD;
  bf16* qs = vs + kRows * LD;
  bf16* dos = qs + BI * LD;
  bf16* qt = dos + BI * LD;
  bf16* dot = qt + HD * LDT;
  float* lse_s = reinterpret_cast<float*>(dot + HD * LDT);
  float* di_s = lse_s + BI;
  const int t = p.t, n = p.n;
  const int k0 = blockIdx.x * kRows;
  const int bi = blockIdx.y / n, h = blockIdx.y % n;
  const bf16* q = head_ptr<bf16>(p.q, p.sq, bi, h);
  const bf16* k = head_ptr<bf16>(p.k, p.sk, bi, h);
  const bf16* v = head_ptr<bf16>(p.v, p.sv, bi, h);
  const bf16* dout = head_ptr<bf16>(p.dout, p.sdo, bi, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, wr = warp * 16;
  const int keys[2] = {k0 + wr + g, k0 + wr + g + 8};

  stage<kRows, HD, LD, 0>(ks, nullptr, k, p.sk[1], k0, t);
  stage<kRows, HD, LD, 0>(vs, nullptr, v, p.sv[1], k0, t);
  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  const float sl2 = p.scale * kLog2e;
  const int n_tiles = (t + BI - 1) / BI;
  const float* lse = p.lse + (size_t)blockIdx.y * t;
  const float* dig = p.di + (size_t)blockIdx.y * t;

  for (int it = p.causal ? k0 / BI : 0; it < n_tiles; ++it) {
    const int i0 = it * BI;
    __syncthreads();
    stage<BI, HD, LD, LDT>(qs, qt, q, p.sq[1], i0, t);
    stage<BI, HD, LD, LDT>(dos, dot, dout, p.sdo[1], i0, t);
    for (int i = threadIdx.x; i < BI; i += blockDim.x) {
      const bool live = i0 + i < t;
      lse_s[i] = live ? lse[i0 + i] * kLog2e : 0.f;
      di_s[i] = live ? dig[i0 + i] : 0.f;
    }
    __syncthreads();

    float s[BI / 8][4] = {}, dp[BI / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      uint32_t ak[4], av[4];
      frag_a(ak, ks, LD, wr, kk * 16, g, c);
      frag_a(av, vs, LD, wr, kk * 16, g, c);
#pragma unroll
      for (int nb = 0; nb < BI / 8; ++nb) {
        uint32_t b[2];
        frag_b(b, qs, LD, nb * 8, kk * 16, g, c);
        mma(s[nb], ak, b);
        frag_b(b, dos, LD, nb * 8, kk * 16, g, c);
        mma(dp[nb], av, b);
      }
    }
#pragma unroll
    for (int nb = 0; nb < BI / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = nb * 8 + 2 * c + (e & 1);
        float pe = 0.f, ds = 0.f;
        if (visible(i0 + qi, keys[e >> 1], t, p.causal)) {
          pe = exp2f(s[nb][e] * sl2 - lse_s[qi]);
          ds = pe * (dp[nb][e] - di_s[qi]);
        }
        s[nb][e] = pe;
        dp[nb][e] = ds;
      }
#pragma unroll
    for (int kk = 0; kk < BI / 16; ++kk) {
      uint32_t ap[4], ads[4];
      frag_a_acc(ap, s[2 * kk], s[2 * kk + 1]);
      frag_a_acc(ads, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
      for (int nb = 0; nb < HD / 8; ++nb) {
        uint32_t b[2];
        frag_b(b, dot, LDT, nb * 8, kk * 16, g, c);
        mma(dv[nb], ap, b);
        frag_b(b, qt, LDT, nb * 8, kk * 16, g, c);
        mma(dk[nb], ads, b);
      }
    }
  }

  bf16* dkp = static_cast<bf16*>(p.dk);
  bf16* dvp = static_cast<bf16*>(p.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (keys[i] >= t) continue;
    const size_t at = out_row(bi, keys[i], h, t, n, HD);
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      const int col = nb * 8 + 2 * c;
      *reinterpret_cast<__nv_bfloat162*>(dkp + at + col) =
          __floats2bfloat162_rn(dk[nb][2 * i] * p.scale,
                                dk[nb][2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + at + col) =
          __floats2bfloat162_rn(dv[nb][2 * i], dv[nb][2 * i + 1]);
    }
  }
}

// ------------------------------------------------------------------ fp32

constexpr int kF32Warps = 8;  // a warp owns rows warp, warp + 8, ...
constexpr int kF32Rows = kRows / kF32Warps;

// Rows [r0, r0 + R) of a strided [t, HD] fp32 matrix into x[R][HD + 1]
// (the odd stride lets lanes read different rows at one column without
// bank conflicts); rows at or past t are zeros.
template <int R, int HD>
__device__ __forceinline__ void stage32(float* x, const float* src,
                                        long long rs, int r0, int t) {
  for (int i = threadIdx.x; i < R * HD; i += blockDim.x) {
    const int r = i / HD, col = i % HD;
    x[r * (HD + 1) + col] = r0 + r < t ? src[(r0 + r) * rs + col] : 0.f;
  }
}

template <int HD>
__device__ __forceinline__ float dot32(const float* a, const float* b) {
  float s = 0.f;
#pragma unroll 16
  for (int d = 0; d < HD; ++d) s = fmaf(a[d], b[d], s);
  return s;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <int HD>
constexpr int fwd32_smem() {
  return (3 * kRows * (HD + 1) + kF32Warps * kTile) * 4;
}

template <int HD>
__global__ void __launch_bounds__(256) fwd_f32(Params p) {
  constexpr int LD = HD + 1, D = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* ks = qs + kRows * LD;
  float* vs = ks + kTile * LD;
  float* pw = vs + kTile * LD + (threadIdx.x >> 5) * kTile;
  const int t = p.t, n = p.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bi = blockIdx.y / n, h = blockIdx.y % n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage32<kRows, HD>(qs, head_ptr<float>(p.q, p.sq, bi, h), p.sq[1], q0, t);
  const float* k = head_ptr<float>(p.k, p.sk, bi, h);
  const float* v = head_ptr<float>(p.v, p.sv, bi, h);
  float acc[kF32Rows][D] = {}, m[kF32Rows], l[kF32Rows] = {};
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) m[i] = -INFINITY;
  const float sl2 = p.scale * kLog2e;
  int n_tiles = (t + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kTile + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    stage32<kTile, HD>(ks, k, p.sk[1], k0, t);
    stage32<kTile, HD>(vs, v, p.sv[1], k0, t);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int rl = warp + kF32Warps * i, row = q0 + rl;
      float sv[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kl = lane + 32 * u;
        const float x = dot32<HD>(qs + rl * LD, ks + kl * LD) * sl2;
        sv[u] = visible(row, k0 + kl, t, p.causal) ? x : -INFINITY;
      }
      const float mn = fmaxf(m[i], warp_max(fmaxf(sv[0], sv[1])));
      const float base = mn == -INFINITY ? 0.f : mn;
      const float alpha = exp2f(m[i] - base);
      m[i] = mn;
      const float p0 = exp2f(sv[0] - base), p1 = exp2f(sv[1] - base);
      l[i] = l[i] * alpha + warp_sum(p0 + p1);
      pw[lane] = p0;
      pw[lane + 32] = p1;
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        float a = acc[i][dd] * alpha;
        const float* vc = vs + lane + 32 * dd;
#pragma unroll 8
        for (int kl = 0; kl < kTile; ++kl) a = fmaf(pw[kl], vc[kl * LD], a);
        acc[i][dd] = a;
      }
      __syncwarp();
    }
  }
  float* o = static_cast<float*>(p.o);
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int row = q0 + warp + kF32Warps * i;
    if (row >= t) continue;
    float* orow = o + out_row(bi, row, h, t, n, HD);
#pragma unroll
    for (int dd = 0; dd < D; ++dd) orow[lane + 32 * dd] = acc[i][dd] / l[i];
    if (lane == 0)
      p.lse_out[(size_t)blockIdx.y * t + row] = (m[i] + log2f(l[i])) * kLn2;
  }
}

template <int HD>
constexpr int dq32_smem() {
  return (4 * kRows * (HD + 1) + kF32Warps * kTile) * 4;
}

template <int HD>
__global__ void __launch_bounds__(256) dq_f32(Params p) {
  constexpr int LD = HD + 1, D = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* qs = reinterpret_cast<float*>(smem);
  float* dos = qs + kRows * LD;
  float* ks = dos + kRows * LD;
  float* vs = ks + kTile * LD;
  float* dsw = vs + kTile * LD + (threadIdx.x >> 5) * kTile;
  const int t = p.t, n = p.n;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kRows;
  const int bi = blockIdx.y / n, h = blockIdx.y % n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage32<kRows, HD>(qs, head_ptr<float>(p.q, p.sq, bi, h), p.sq[1], q0, t);
  stage32<kRows, HD>(dos, head_ptr<float>(p.dout, p.sdo, bi, h), p.sdo[1],
                     q0, t);
  const float* k = head_ptr<float>(p.k, p.sk, bi, h);
  const float* v = head_ptr<float>(p.v, p.sv, bi, h);
  float acc[kF32Rows][D] = {}, lse2[kF32Rows], di[kF32Rows];
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int row = q0 + warp + kF32Warps * i;
    const size_t at = (size_t)blockIdx.y * t + row;
    lse2[i] = row < t ? p.lse[at] * kLog2e : 0.f;
    di[i] = row < t ? p.di[at] : 0.f;
  }
  const float sl2 = p.scale * kLog2e;
  int n_tiles = (t + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kTile + 1);

  for (int j = 0; j < n_tiles; ++j) {
    const int k0 = j * kTile;
    __syncthreads();
    stage32<kTile, HD>(ks, k, p.sk[1], k0, t);
    stage32<kTile, HD>(vs, v, p.sv[1], k0, t);
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int rl = warp + kF32Warps * i, row = q0 + rl;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int kl = lane + 32 * u;
        float ds = 0.f;
        if (visible(row, k0 + kl, t, p.causal)) {
          const float pe =
              exp2f(dot32<HD>(qs + rl * LD, ks + kl * LD) * sl2 - lse2[i]);
          ds = pe * (dot32<HD>(dos + rl * LD, vs + kl * LD) - di[i]);
        }
        dsw[kl] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        float a = acc[i][dd];
        const float* kc = ks + lane + 32 * dd;
#pragma unroll 8
        for (int kl = 0; kl < kTile; ++kl) a = fmaf(dsw[kl], kc[kl * LD], a);
        acc[i][dd] = a;
      }
      __syncwarp();
    }
  }
  float* dq = static_cast<float*>(p.dq);
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int row = q0 + warp + kF32Warps * i;
    if (row >= t) continue;
    float* out = dq + out_row(bi, row, h, t, n, HD);
#pragma unroll
    for (int dd = 0; dd < D; ++dd) out[lane + 32 * dd] = acc[i][dd] * p.scale;
  }
}

template <int HD>
constexpr int dkv32_smem() {
  return (4 * kRows * (HD + 1) + 2 * kTile + 2 * kF32Warps * kTile) * 4;
}

template <int HD>
__global__ void __launch_bounds__(256) dkv_f32(Params p) {
  constexpr int LD = HD + 1, D = HD / 32;
  extern __shared__ __align__(16) unsigned char smem[];
  float* ks = reinterpret_cast<float*>(smem);
  float* vs = ks + kRows * LD;
  float* qs = vs + kRows * LD;
  float* dos = qs + kTile * LD;
  float* lse_s = dos + kTile * LD;
  float* di_s = lse_s + kTile;
  float* pw = di_s + kTile + (threadIdx.x >> 5) * 2 * kTile;
  float* dsw = pw + kTile;
  const int t = p.t, n = p.n;
  const int k0 = blockIdx.x * kRows;
  const int bi = blockIdx.y / n, h = blockIdx.y % n;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  stage32<kRows, HD>(ks, head_ptr<float>(p.k, p.sk, bi, h), p.sk[1], k0, t);
  stage32<kRows, HD>(vs, head_ptr<float>(p.v, p.sv, bi, h), p.sv[1], k0, t);
  const float* q = head_ptr<float>(p.q, p.sq, bi, h);
  const float* dout = head_ptr<float>(p.dout, p.sdo, bi, h);
  const float* lse = p.lse + (size_t)blockIdx.y * t;
  const float* dig = p.di + (size_t)blockIdx.y * t;
  float dk[kF32Rows][D] = {}, dv[kF32Rows][D] = {};
  const float sl2 = p.scale * kLog2e;
  const int n_tiles = (t + kTile - 1) / kTile;

  for (int it = p.causal ? k0 / kTile : 0; it < n_tiles; ++it) {
    const int i0 = it * kTile;
    __syncthreads();
    stage32<kTile, HD>(qs, q, p.sq[1], i0, t);
    stage32<kTile, HD>(dos, dout, p.sdo[1], i0, t);
    for (int i = threadIdx.x; i < kTile; i += blockDim.x) {
      const bool live = i0 + i < t;
      lse_s[i] = live ? lse[i0 + i] * kLog2e : 0.f;
      di_s[i] = live ? dig[i0 + i] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kF32Rows; ++i) {
      const int kl = warp + kF32Warps * i, key = k0 + kl;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int ql = lane + 32 * u;
        float pe = 0.f, ds = 0.f;
        if (visible(i0 + ql, key, t, p.causal)) {
          pe = exp2f(dot32<HD>(qs + ql * LD, ks + kl * LD) * sl2 - lse_s[ql]);
          ds = pe * (dot32<HD>(dos + ql * LD, vs + kl * LD) - di_s[ql]);
        }
        pw[ql] = pe;
        dsw[ql] = ds;
      }
      __syncwarp();
#pragma unroll
      for (int dd = 0; dd < D; ++dd) {
        float a = dv[i][dd], b = dk[i][dd];
        const float* doc = dos + lane + 32 * dd;
        const float* qc = qs + lane + 32 * dd;
#pragma unroll 8
        for (int ql = 0; ql < kTile; ++ql) {
          a = fmaf(pw[ql], doc[ql * LD], a);
          b = fmaf(dsw[ql], qc[ql * LD], b);
        }
        dv[i][dd] = a;
        dk[i][dd] = b;
      }
      __syncwarp();
    }
  }
  float* dkp = static_cast<float*>(p.dk);
  float* dvp = static_cast<float*>(p.dv);
#pragma unroll
  for (int i = 0; i < kF32Rows; ++i) {
    const int key = k0 + warp + kF32Warps * i;
    if (key >= t) continue;
    const size_t at = out_row(bi, key, h, t, n, HD);
#pragma unroll
    for (int dd = 0; dd < D; ++dd) {
      dkp[at + lane + 32 * dd] = dk[i][dd] * p.scale;
      dvp[at + lane + 32 * dd] = dv[i][dd];
    }
  }
}

// ---------------------------------------------------------------- launch

enum Pass { kFwd = 0, kDkv = 1, kDq = 2 };

template <typename Kernel>
int launch(Kernel kernel, int smem, int threads, const Params& p, int b,
           cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((p.t + kRows - 1) / kRows, b * p.n);
  kernel<<<grid, threads, smem, s>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_pass(int pass, int bf16_in, const Params& p, int b,
                cudaStream_t s) {
  if (bf16_in) {
    if (pass == kFwd) return launch(fwd_bf16<HD>, fwd_smem<HD>(), 128, p, b, s);
    if (pass == kDkv) return launch(dkv_bf16<HD>, dkv_smem<HD>(), 128, p, b, s);
    return launch(dq_bf16<HD>, dq_smem<HD>(), 128, p, b, s);
  }
  if (pass == kFwd) return launch(fwd_f32<HD>, fwd32_smem<HD>(), 256, p, b, s);
  if (pass == kDkv) return launch(dkv_f32<HD>, dkv32_smem<HD>(), 256, p, b, s);
  return launch(dq_f32<HD>, dq32_smem<HD>(), 256, p, b, s);
}

int run(int pass, const Params& p, int dtype, int b, int hd, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int bf = dtype == DT_BF16;
  switch (hd) {
    case 32:
      return launch_pass<32>(pass, bf, p, b, s);
    case 64:
      return launch_pass<64>(pass, bf, p, b, s);
    case 128:
      return launch_pass<128>(pass, bf, p, b, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const long long* strides, int t, int n,
                   float scale, int causal) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  for (int i = 0; i < 3; ++i) {
    p.sq[i] = strides[i];
    p.sk[i] = strides[3 + i];
    p.sv[i] = strides[6 + i];
    p.sdo[i] = dout != nullptr ? strides[9 + i] : 0;
  }
  p.t = t;
  p.n = n;
  p.scale = scale;
  p.causal = causal;
  return p;
}

}  // namespace flash
}  // namespace tempo

extern "C" {

// q, k, v [b, t, n, hd] (dtype 0 f32, 1 bf16) as strided views: strides
// holds the batch, sequence and head strides in elements of q, k and v, in
// that order (9 values), the head dim contiguous. o [b, t, n, hd]
// contiguous in the input type; lse [b, n, t] fp32. hd in {32, 64, 128}.
int tempo_flash_fwd(const void* q, const void* k, const void* v, void* o,
                    void* lse, const long long* strides, int dtype, int b,
                    int t, int n, int hd, float scale, int causal,
                    void* stream) {
  using namespace tempo::flash;
  Params p = make_params(q, k, v, nullptr, strides, t, n, scale, causal);
  p.o = o;
  p.lse_out = static_cast<float*>(lse);
  return run(kFwd, p, dtype, b, hd, stream);
}

// As tempo_flash_fwd, with do (strides 9..11), lse and di [b, n, t] fp32;
// writes dk and dv [b, t, n, hd] contiguous in the input type.
int tempo_flash_bwd_dkv(const void* q, const void* k, const void* v,
                        const void* dout, const void* lse, const void* di,
                        void* dk, void* dv, const long long* strides,
                        int dtype, int b, int t, int n, int hd, float scale,
                        int causal, void* stream) {
  using namespace tempo::flash;
  Params p = make_params(q, k, v, dout, strides, t, n, scale, causal);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dk = dk;
  p.dv = dv;
  return run(kDkv, p, dtype, b, hd, stream);
}

// As tempo_flash_bwd_dkv; writes dq [b, t, n, hd] contiguous.
int tempo_flash_bwd_dq(const void* q, const void* k, const void* v,
                       const void* dout, const void* lse, const void* di,
                       void* dq, const long long* strides, int dtype, int b,
                       int t, int n, int hd, float scale, int causal,
                       void* stream) {
  using namespace tempo::flash;
  Params p = make_params(q, k, v, dout, strides, t, n, scale, causal);
  p.lse = static_cast<const float*>(lse);
  p.di = static_cast<const float*>(di);
  p.dq = dq;
  return run(kDq, p, dtype, b, hd, stream);
}

}  // extern "C"

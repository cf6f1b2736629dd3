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
// Design. Every pass keeps the score tile in registers: its fp32
// accumulator layout is re-packed in place as the A operand of the next
// product (p.v, ds.k, p^T.do, ds^T.q), rounded to bf16 there. The TPU grid
// walked the other sequence axis serially through VMEM scratch; here that is
// a loop inside the block over tiles staged in shared memory. The bf16
// kernels (fwd_bf16, dkv_bf16, dq_bf16) are built for Hopper; they share:
// - Asynchronous staging. Tiles arrive by 16-byte cp.async.cg into a ring of
//   2 stages (K5f and K5dq: k and v; K5dkv: q, do and, by 4-byte cp.async,
//   the tile's lse and di), one commit group a tile, the next tile's copies
//   in flight while this tile's products run, one __syncthreads() a tile.
//   Rows at or past t are zero-filled by the copy (src-size 0), not by a
//   branch. Past the last tile an empty group is committed, so wait_group's
//   count holds on every iteration. The strided source needs no tensor map.
// - One copy of each operand, row-major; no transposed second copy exists.
// - Masks only where they can bite. A tile that crosses a warp's diagonal
//   or the ragged end of the sequence gets the compare; every other tile
//   runs none, and tiles wholly outside the causal triangle are not
//   visited. Masked scores are -inf, p = 0 and never NaN. The TPU kernel
//   adds DEFAULT_MASK_VALUE (-0.7 f32max) instead; with t_q = t_k no causal
//   row is wholly masked, so both agree.
// - Outputs go through the warp's own rows of shared memory and leave as
//   16-byte vectors.
// - Grid: (batch x head) on x and the tile on y, heaviest tile first (K5f
//   and K5dq walk the query tiles from the last one down), so all heads'
//   heavy blocks start first and the light ones fill the tail.
//
// K5f and K5dq run on wgmma. A block is one warpgroup and owns 64 query
// rows of one (batch, head), 16 a warp, and walks key tiles (64 keys; 32 in
// K5dq at hd 128).
// - q's (and in K5dq do's) A fragments are loaded once by ldmatrix.x4 and
//   stay in registers (16 each at hd 64); q's shared memory later carries
//   the output out.
// - s = q.k^T is wgmma m64nNk16 with A = q from registers and B = the k
//   tile through a descriptor, k-major; K5dq's dp = do.v^T is the same
//   product on the v tile, issued in the same commit group. o += p.v has
//   A = p from the score registers and B = the v tile read n-major (bf16
//   allows the transposed B); K5dq's dq += ds.k reads the k tile that s
//   read k-major, n-major, so neither pass keeps a second copy. wgmma.fence
//   before, commit_group and wait_group 0 after each batch; the accumulators
//   are pinned after the wait so the compiler keeps its arithmetic below it.
// - The ring's tiles are dense and swizzled as the descriptors expect
//   (128-byte rows XORed by row mod 8 in panels of 64 columns; 64-byte rows
//   at hd 32), written in that layout by the cp.async destinations; a
//   fence.proxy.async before the barrier hands them to wgmma.
// - K5f's softmax runs in fp32 in the log2 domain with the scale folded into
//   the exponent's FMA: p = ex2(s * scale*log2e - m * scale*log2e), one FMA
//   and one ex2.approx an element; the row maximum is taken on the raw scores
//   (a negative scale moves into q's sign). The running max and sum per row
//   are shared by the row's 4 lanes; rows are normalised once at the end.
//   lse = (m * scale*log2e + log2 l) * ln 2. K5dq recomputes p the same way
//   from the stored lse, p = ex2(s * scale*log2e - lse*log2e), with no
//   running max, and ds = p (dp - di) in place, zeroed where masked.
// - K5f: 128 registers and 42 KB at hd 64, 4 blocks an SM, which is what
//   overlaps one warpgroup's softmax with another's products. Within a
//   warpgroup the tile is still serial (products, wait, softmax, products,
//   wait); starting the next tile's q.k^T under this tile's softmax,
//   128-key tiles and TMA are what is left. An mma.sync version of this
//   pass (4 warps of 32 rows, k by ldmatrix.x4, v by ldmatrix.x4.trans) was
//   0.068 ms a call where this one takes 0.050 and SDPA's forward 0.052
//   ([8, 1024, 12, 64] bf16 causal, cold L2, NVIDIA H100 80GB HBM3 at
//   700 W).
// - K5dq: 174 registers and 51 KB at hd 64 (2 blocks an SM), no spill at hd
//   32, 64 or 128; at hd 128 the dq accumulator takes 64 registers and
//   64-key s and dp tiles beside it spilled, so the key tile is 32 there.
//   0.074 ms a call (261 TFLOP/s) where the mma.sync design before it, with
//   load-then-compute staging, k staged twice and fragments by 32-bit
//   shared loads, took 0.248; with K5dkv, 0.195 against SDPA's whole
//   backward 0.169 ([8, 1024, 12, 64] bf16 causal, cold L2, the same card).
//   Like K5f it is serial within a warpgroup (s and dp, wait, ds, dq, wait).
//
// K5dkv runs on mma.sync m16n8k16. A block owns 64 key rows, 4 warps of 16,
// and walks query tiles of 64 (32 at hd 128).
// - Tiles are row-major with rows padded by 8 values (144-byte rows at hd
//   64: the 8 rows of an ldmatrix phase fall in 8 distinct 16-byte bank
//   groups). q and do are read along their rows by ldmatrix.x4 for k.q^T and
//   v.do^T, and down their rows by ldmatrix.x4.trans for p^T.do and ds^T.q,
//   from the same tile.
// - k's and v's A fragments stay in registers (32 at hd 64; at hd 128 they
//   are re-read by ldmatrix, or the accumulators would spill).
// - A tile goes s^T = k.q^T -> p (packed to bf16) -> dv += p^T.do ->
//   dp^T = v.do^T -> ds = p (dp - di), p read back from its pack -> dk +=
//   ds^T.q, so one fp32 score tile is live beside the two accumulators (244
//   registers at hd 64, no spill; 128 threads x 244 registers is under half
//   of an SM's 65,536, so 2 blocks an SM without a minimum-blocks bound). A
//   warp skips a tile that lies wholly before its keys.
// - Off the training path's head dim, ptxas reports small spills that are
//   accepted for now: 36 bytes at hd 128 and 8 bytes at hd 32 (a few values
//   beside the accumulators and the score tile). Both stay correct
//   and are checked on the card; retiling them belongs to K5dkv's move to
//   wgmma.
//
// fp32: 64-row blocks and tiles on CUDA cores (FMA), 8 warps; a warp owns 8
// rows, its lanes split the tile's 64 keys (or queries) for the dot products
// and then the head dim for the accumulation. Slow, kept for fp32 runs that
// must match the plain version to 1e-4.
//
// Strides: q, k, v and do are taken as strided views (batch, sequence and
// head strides in elements, the head dim contiguous), so the wrapper passes
// the c_attn output's slices as they are; rows are read as 16-byte vectors
// (the wrapper checks the alignment). o, dq, dk and dv are written
// contiguous [b, t, n, hd]; lse and di are [b, n, t] fp32.
#include <math.h>
#include <stdint.h>

#include "common.cuh"
#include "hopper.cuh"

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

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
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

__device__ __forceinline__ bool visible(int row, int col, int t, int causal) {
  return col < t && row < t && !(causal && col > row);
}

// --------------------------------- building blocks of the bf16 kernels
// (the mma.sync below serves K5dkv alone; the Hopper helpers, cp_async,
// ldsm4, lane_rc/lane_cr, wgmma and its fences, are in hopper.cuh)

// Rows [r0, r0 + R) of a strided [t, HD] matrix (row stride rs) into the
// row-major tile x[R][HD + 8] by 16-byte asynchronous copies; rows at or
// past t are zero-filled by the copy itself (it reads nothing: the source
// stays at row 0, which exists).
template <int R, int HD, int NT>
__device__ __forceinline__ void stage_async(bf16* x, const bf16* src,
                                            long long rs, int r0, int t) {
  constexpr int kVec = HD / 8, LD = HD + 8, kAll = R * kVec;
#pragma unroll
  for (int it = 0; it < (kAll + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (kAll % NT != 0 && i >= kAll) break;
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool live = r0 + r < t;
    cp_async<16>(x + r * LD + c, src + (live ? r0 + r : 0) * rs + c, live);
  }
}

// d += a . b, m16n8k16, bf16 operands, fp32 accumulators.
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x in one instruction (ex2.approx: relative error 2^-22; -inf gives 0).
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// A warp's 16 x HD block of bf16 rows in shared memory (row stride HD + 8),
// written by that warp alone, to rows [row0, row0 + 16) of a contiguous
// [b, t, n, hd] output as 16-byte vectors; rows at or past t are left out.
template <int HD>
__device__ __forceinline__ void store_rows(bf16* out, const bf16* x, int bi,
                                           int row0, int h, int t, int n,
                                           int lane) {
  constexpr int kVec = HD / 8, LD = HD + 8;
  __syncwarp();
#pragma unroll
  for (int i = lane; i < 16 * kVec; i += 32) {
    const int r = i / kVec, c = (i % kVec) * 8;
    if (row0 + r < t)
      *reinterpret_cast<uint4*>(out + out_row(bi, row0 + r, h, t, n, HD) + c) =
          *reinterpret_cast<const uint4*>(x + r * LD + c);
  }
}

// ------------------------------------------------------------------ K5f

// A k or v tile as wgmma reads it: ROWS rows in panels of PW = min(hd, 64)
// columns (rows of 128 bytes; 64 at hd 32), each panel dense and swizzled:
// the 16-byte chunk index of a byte offset is XORed with the offset's bits
// 7.. (3 bits for 128-byte rows, 2 for 64-byte rows), which is the layout
// the descriptor's mode names. One tile serves both readings: k-major (8-row
// groups kSbo apart, a k step of 16 columns is 32 bytes further along the
// row) and n-major (a k step of 16 rows is 2 groups further down).
template <int HD, int ROWS = kTile>
struct WgTile {
  static constexpr int PW = HD < 64 ? HD : 64, NP = HD / PW;
  static constexpr int kRowBytes = PW * 2, kBits = PW == 64 ? 3 : 2;
  static constexpr int kMode = PW == 64 ? 1 : 2;
  static constexpr int kPanelBytes = ROWS * kRowBytes;
  static constexpr int kBytes = NP * kPanelBytes;
  static constexpr int kSbo = 8 * kRowBytes;
  // Byte offset of the 8 values at row r, columns col .. col + 7.
  __device__ static int offset(int r, int col) {
    const int off = r * kRowBytes + (col % PW) * 2;
    return (col / PW) * kPanelBytes +
           (off ^ (((off >> 7) & ((1 << kBits) - 1)) << 4));
  }
};

// Rows [r0, r0 + ROWS) of a strided [t, HD] matrix into a WgTile, by
// 16-byte asynchronous copies; rows at or past t are zero-filled.
template <int HD, int NT, int ROWS = kTile>
__device__ __forceinline__ void stage_async_wg(unsigned char* x,
                                               const bf16* src, long long rs,
                                               int r0, int t) {
  constexpr int kVec = HD / 8, kAll = ROWS * kVec;
#pragma unroll
  for (int it = 0; it < (kAll + NT - 1) / NT; ++it) {
    const int i = it * NT + threadIdx.x;
    if (kAll % NT != 0 && i >= kAll) break;
    const int r = i / kVec, c = (i % kVec) * 8;
    const bool live = r0 + r < t;
    cp_async<16>(x + WgTile<HD, ROWS>::offset(r, c),
                 src + (live ? r0 + r : 0) * rs + c, live);
  }
}

// K5f's block: one warpgroup, 64 query rows (16 a warp), key tiles of kTile
// rows in a ring of kFwdStages stages (a third stage costs a block an SM at
// hd 64 and was slower).
constexpr int kFwdStages = 2;

template <int HD>
constexpr int fwd_smem() {  // 1024: the ring is aligned for the swizzle
  return 1024 + kFwdStages * 2 * WgTile<HD>::kBytes + kRows * (HD + 8) * 2;
}

template <int HD>
__global__ void __launch_bounds__(128, HD <= 64 ? 4 : 1) fwd_bf16(Params p) {
  using Tile = WgTile<HD>;
  constexpr int LD = HD + 8, NT = 128, NS = kFwdStages;
  constexpr int PW = Tile::PW, NP = Tile::NP;
  constexpr int kStage = 2 * Tile::kBytes;  // a k tile, then its v tile
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(ring + NS * kStage);
  const int t = p.t, n = p.n;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int bi = blockIdx.x / n, h = blockIdx.x % n;
  const bf16* q = head_ptr<bf16>(p.q, p.sq, bi, h);
  const bf16* k = head_ptr<bf16>(p.k, p.sk, bi, h);
  const bf16* v = head_ptr<bf16>(p.v, p.sv, bi, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the block
  int n_tiles = (t + kTile - 1) / kTile;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / kTile + 1);

  // Tile j into stage j % NS as one commit group; past the last tile the
  // group is empty, so the wait count below holds on every iteration.
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      unsigned char* ks = ring + (j % NS) * kStage;
      stage_async_wg<HD, NT>(ks, k, p.sk[1], j * kTile, t);
      stage_async_wg<HD, NT>(ks + Tile::kBytes, v, p.sv[1], j * kTile, t);
    }
    cp_async_commit();
  };
  stage_async<kRows, HD, NT>(qs, q, p.sq[1], q0, t);  // in tile 0's group
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_tile(j);
  cp_async_wait<NS - 2>();
  __syncthreads();

  // q stays in registers as A fragments. A negative scale moves into q's
  // sign, so the row maximum can be taken before scaling; a zero scale is
  // floored (2^(s * 1e-30) is 1 in fp32 and -inf stays -inf).
  uint32_t aq[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    ldsm4(aq[kk], qs + wr * LD + kk * 16 + lane_rc<LD>(lane));
    if (p.scale < 0.f) {
#pragma unroll
      for (int e = 0; e < 4; ++e) aq[kk][e] ^= 0x80008000u;
    }
  }
  const float sl2 = fmaxf(fabsf(p.scale) * kLog2e, 1e-30f);
  float acc[NP][PW / 8][4] = {};
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  const int wrow0 = q0 + wr;

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile j have landed
    fence_async_proxy();
    __syncthreads();          // everyone's have, and tile j - 1 is consumed
    load_tile(j + NS - 1);    // into the stage tile j - 1 held
    const int k0 = j * kTile;
    const uint32_t ks = smem_addr(ring + (j % NS) * kStage);
    const uint32_t vs = ks + Tile::kBytes;

    // s = q.k^T: k-major b, one product per 16 columns of the head dim.
    float s[kTile / 8][4] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk)
      wgmma<0>(s, aq[kk],
               wg_desc(ks + (kk * 16 / PW) * Tile::kPanelBytes +
                           (kk * 16 % PW) * 2,
                       16, Tile::kSbo, Tile::kMode),
               kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) pin(s[nb][e]);

    // Only a tile that crosses the warp's diagonal or the end of the
    // sequence holds a masked element; the others run no compare.
    if ((p.causal && k0 + kTile - 1 > wrow0) || k0 + kTile > t) {
#pragma unroll
      for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nb * 8 + 2 * c + (e & 1);
          const int row = wrow0 + g + (e >> 1) * 8;
          if (col >= t || (p.causal && col > row)) s[nb][e] = -INFINITY;
        }
    }
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[nb][e]);
    // Every row of a visited tile sees at least the tile's first key (k0 <=
    // q0 when causal), so the new maximum is finite.
    float msc[2], alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      const float mn = fmaxf(m[i], mx[i]);
      alpha[i] = fast_exp2((m[i] - mn) * sl2);
      msc[i] = mn * sl2;
      m[i] = mn;
    }
#pragma unroll
    for (int nb = 0; nb < kTile / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp2(fmaf(s[nb][e], sl2, -msc[e >> 1]));
        s[nb][e] = pe;
        rsum[e >> 1] += pe;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * alpha[i] + rsum[i];
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int nb = 0; nb < PW / 8; ++nb) {
        acc[pn][nb][0] *= alpha[0];
        acc[pn][nb][1] *= alpha[0];
        acc[pn][nb][2] *= alpha[1];
        acc[pn][nb][3] *= alpha[1];
      }

    // o += p.v: p from the score registers, v n-major from its row-major
    // tile, one product per 16 keys and panel of the head dim.
    uint32_t ap[kTile / 16][4];
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
      frag_a_acc(ap[kk], s[2 * kk], s[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTile / 16; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        wgmma<1>(acc[pn], ap[kk],
                 wg_desc(vs + pn * Tile::kPanelBytes +
                             kk * 16 * Tile::kRowBytes,
                         Tile::kPanelBytes, Tile::kSbo, Tile::kMode),
                 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int nb = 0; nb < PW / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(acc[pn][nb][e]);
  }

  // The warp's rows of o go through its own rows of qs (no other warp read
  // them) and leave as 16-byte vectors.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float li = l[i];
    li += __shfl_xor_sync(0xffffffffu, li, 1);
    li += __shfl_xor_sync(0xffffffffu, li, 2);
    const float inv = 1.f / li;
    const int rl = wr + g + 8 * i;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int nb = 0; nb < PW / 8; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(qs + rl * LD + pn * PW + nb * 8 +
                                           2 * c) =
            __floats2bfloat162_rn(acc[pn][nb][2 * i] * inv,
                                  acc[pn][nb][2 * i + 1] * inv);
    if (c == 0 && q0 + rl < t)
      p.lse_out[(size_t)blockIdx.x * t + q0 + rl] =
          (m[i] * sl2 + log2f(li)) * kLn2;
  }
  store_rows<HD>(static_cast<bf16*>(p.o), qs + wr * LD, bi, wrow0, h, t, n,
                 lane);
}

// ------------------------------------------------------------------ K5dq

// K5dq's block: one warpgroup, 64 query rows (16 a warp), k and v tiles of
// kDqTile rows in a ring of kDqStages stages, as K5f's.
constexpr int kDqStages = 2;

// Keys per staged tile in K5dq: 32 at hd 128, where the dq accumulator
// takes 64 registers and the s and dp tiles of 64 keys beside it spill.
template <int HD>
constexpr int kDqTile = HD == 128 ? 32 : 64;

template <int HD>
constexpr int dq_smem() {  // 1024: the ring is aligned for the swizzle
  return 1024 + kDqStages * 2 * WgTile<HD, kDqTile<HD>>::kBytes +
         2 * kRows * (HD + 8) * 2;
}

template <int HD>
__global__ void __launch_bounds__(128, HD <= 64 ? 2 : 1) dq_bf16(Params p) {
  constexpr int BK = kDqTile<HD>;
  using Tile = WgTile<HD, BK>;
  constexpr int LD = HD + 8, NT = 128, NS = kDqStages;
  constexpr int PW = Tile::PW, NP = Tile::NP;
  constexpr int kStage = 2 * Tile::kBytes;  // a k tile, then its v tile
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* ring = smem + ((1024 - (smem_addr(smem) & 1023)) & 1023);
  bf16* qs = reinterpret_cast<bf16*>(ring + NS * kStage);
  bf16* dos = qs + kRows * LD;
  const int t = p.t, n = p.n;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int bi = blockIdx.x / n, h = blockIdx.x % n;
  const bf16* q = head_ptr<bf16>(p.q, p.sq, bi, h);
  const bf16* k = head_ptr<bf16>(p.k, p.sk, bi, h);
  const bf16* v = head_ptr<bf16>(p.v, p.sv, bi, h);
  const bf16* dout = head_ptr<bf16>(p.dout, p.sdo, bi, h);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3;
  const int wr = warp * 16;  // the warp's first row in the block
  int n_tiles = (t + BK - 1) / BK;
  if (p.causal) n_tiles = min(n_tiles, (q0 + kRows - 1) / BK + 1);

  // Tile j into stage j % NS as one commit group (empty past the last).
  auto load_tile = [&](int j) {
    if (j < n_tiles) {
      unsigned char* ks = ring + (j % NS) * kStage;
      stage_async_wg<HD, NT, BK>(ks, k, p.sk[1], j * BK, t);
      stage_async_wg<HD, NT, BK>(ks + Tile::kBytes, v, p.sv[1], j * BK, t);
    }
    cp_async_commit();
  };
  stage_async<kRows, HD, NT>(qs, q, p.sq[1], q0, t);  // in tile 0's group
  stage_async<kRows, HD, NT>(dos, dout, p.sdo[1], q0, t);
#pragma unroll
  for (int j = 0; j < NS - 1; ++j) load_tile(j);
  const int wrow0 = q0 + wr;
  float lse2[2], di[2];  // the lane's two rows, g and g + 8
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = wrow0 + g + 8 * i;
    const size_t at = (size_t)blockIdx.x * t + row;
    lse2[i] = row < t ? p.lse[at] * kLog2e : 0.f;
    di[i] = row < t ? p.di[at] : 0.f;
  }
  cp_async_wait<NS - 2>();
  __syncthreads();

  // q and do stay in registers as A fragments.
  uint32_t aq[HD / 16][4], ado[HD / 16][4];
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    ldsm4(aq[kk], qs + wr * LD + kk * 16 + lane_rc<LD>(lane));
    ldsm4(ado[kk], dos + wr * LD + kk * 16 + lane_rc<LD>(lane));
  }
  const float sl2 = p.scale * kLog2e;
  float acc[NP][PW / 8][4] = {};

  for (int j = 0; j < n_tiles; ++j) {
    cp_async_wait<NS - 2>();  // this thread's copies of tile j have landed
    fence_async_proxy();
    __syncthreads();          // everyone's have, and tile j - 1 is consumed
    load_tile(j + NS - 1);    // into the stage tile j - 1 held
    const int k0 = j * BK;
    const uint32_t ks = smem_addr(ring + (j % NS) * kStage);
    const uint32_t vs = ks + Tile::kBytes;

    // s = q.k^T and dp = do.v^T in one group: k and v k-major.
    float s[BK / 8][4] = {}, dp[BK / 8][4] = {};
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int at = (kk * 16 / PW) * Tile::kPanelBytes + (kk * 16 % PW) * 2;
      wgmma<0>(s, aq[kk], wg_desc(ks + at, 16, Tile::kSbo, Tile::kMode),
               kk > 0);
      wgmma<0>(dp, ado[kk], wg_desc(vs + at, 16, Tile::kSbo, Tile::kMode),
               kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pin(s[nb][e]);
        pin(dp[nb][e]);
      }

    // ds = p (dp - di), p = 2^(s * scale*log2e - lse*log2e). Only a tile
    // that crosses the warp's diagonal or the end of the sequence holds a
    // masked element; there ds is 0 (p may overflow past t: selected, not
    // multiplied away).
    const bool masked = (p.causal && k0 + BK - 1 > wrow0) || k0 + BK > t;
#pragma unroll
    for (int nb = 0; nb < BK / 8; ++nb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = fast_exp2(fmaf(s[nb][e], sl2, -lse2[e >> 1]));
        float ds = pe * (dp[nb][e] - di[e >> 1]);
        if (masked) {
          const int col = k0 + nb * 8 + 2 * c + (e & 1);
          const int row = wrow0 + g + (e >> 1) * 8;
          if (col >= t || (p.causal && col > row)) ds = 0.f;
        }
        s[nb][e] = ds;
      }

    // dq += ds.k: ds from the score registers, k n-major from the same tile
    // that s read k-major, one product per 16 keys and panel of the head dim.
    uint32_t ads[BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      frag_a_acc(ads[kk], s[2 * kk], s[2 * kk + 1]);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int pn = 0; pn < NP; ++pn)
        wgmma<1>(acc[pn], ads[kk],
                 wg_desc(ks + pn * Tile::kPanelBytes +
                             kk * 16 * Tile::kRowBytes,
                         Tile::kPanelBytes, Tile::kSbo, Tile::kMode),
                 1);
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int nb = 0; nb < PW / 8; ++nb)
#pragma unroll
        for (int e = 0; e < 4; ++e) pin(acc[pn][nb][e]);
  }

  // The warp's rows of dq (times the scale) go through its own rows of qs
  // and leave as 16-byte vectors.
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int rl = wr + g + 8 * i;
#pragma unroll
    for (int pn = 0; pn < NP; ++pn)
#pragma unroll
      for (int nb = 0; nb < PW / 8; ++nb)
        *reinterpret_cast<__nv_bfloat162*>(qs + rl * LD + pn * PW + nb * 8 +
                                           2 * c) =
            __floats2bfloat162_rn(acc[pn][nb][2 * i] * p.scale,
                                  acc[pn][nb][2 * i + 1] * p.scale);
  }
  store_rows<HD>(static_cast<bf16*>(p.dq), qs + wr * LD, bi, wrow0, h, t, n,
                 lane);
}

// ---------------------------------------------------------------- K5dkv

// Queries per staged tile in K5dkv: 32 at hd 128 keeps the dK and dV
// accumulators (128 registers there) and a score tile in registers.
template <int HD>
constexpr int kDkvTile = HD == 128 ? 32 : 64;

// Whether K5dkv holds its k and v A fragments in registers for the whole
// block (2 x HD / 4 registers); at hd 128 they are re-read by ldmatrix from
// the block's own tiles instead, or the accumulators would spill.
template <int HD>
constexpr bool kDkvResident = HD <= 64;

// One query tile of K5dkv for one warp (16 keys), in an order that keeps
// one fp32 score tile live beside the two accumulators:
// s^T = k.q^T -> p (packed to bf16) -> dv += p^T.do -> dp^T = v.do^T ->
// ds = p (dp - di) (packed) -> dk += ds^T.q. q and do are read along their
// rows by ldmatrix for the first products and down their rows by
// ldmatrix.trans for the second, from the same row-major tiles.
// MASK: the tile holds queries past t or (causal) before a key of the warp.
template <int HD, bool RES, bool MASK>
__device__ __forceinline__ void dkv_tile(
    const bf16* qs, const bf16* dos, const float* lse_s, const float* di_s,
    const bf16* kw, const bf16* vw, const uint32_t (&ak)[HD / 16][4],
    const uint32_t (&av)[HD / 16][4], float (&dk)[HD / 8][4],
    float (&dv)[HD / 8][4], float sl2, int i0, int key0, int t, int causal,
    int lane) {
  constexpr int BI = kDkvTile<HD>, LD = HD + 8;
  const int c = lane & 3;
  const bf16* qb = qs + lane_cr<LD>(lane);
  const bf16* qbt = qs + lane_rc<LD>(lane);
  const bf16* dob = dos + lane_cr<LD>(lane);
  const bf16* dobt = dos + lane_rc<LD>(lane);
  float s[BI / 8][4] = {};
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    if constexpr (RES) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = ak[kk][e];
    } else {
      ldsm4(a, kw + kk * 16 + lane_rc<LD>(lane));
    }
#pragma unroll
    for (int nbp = 0; nbp < BI / 16; ++nbp) {
      uint32_t b[4];
      ldsm4(b, qb + nbp * 16 * LD + kk * 16);
      mma(s[2 * nbp], a, b[0], b[1]);
      mma(s[2 * nbp + 1], a, b[2], b[3]);
    }
  }
  uint32_t ap[BI / 16][4];
#pragma unroll
  for (int nb = 0; nb < BI / 8; ++nb) {
    const float2 ls = *reinterpret_cast<const float2*>(lse_s + nb * 8 + 2 * c);
    const float l2[2] = {ls.x * kLog2e, ls.y * kLog2e};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float pe = fast_exp2(fmaf(s[nb][e], sl2, -l2[e & 1]));
      if (MASK && !visible(i0 + nb * 8 + 2 * c + (e & 1),
                           key0 + 8 * (e >> 1), t, causal))
        pe = 0.f;
      s[nb][e] = pe;
    }
  }
#pragma unroll
  for (int kk = 0; kk < BI / 16; ++kk) {
    frag_a_acc(ap[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int nbp = 0; nbp < HD / 16; ++nbp) {
      uint32_t b[4];
      ldsm4_t(b, dobt + kk * 16 * LD + nbp * 16);
      mma(dv[2 * nbp], ap[kk], b[0], b[1]);
      mma(dv[2 * nbp + 1], ap[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < BI / 8; ++nb)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nb][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < HD / 16; ++kk) {
    uint32_t a[4];
    if constexpr (RES) {
#pragma unroll
      for (int e = 0; e < 4; ++e) a[e] = av[kk][e];
    } else {
      ldsm4(a, vw + kk * 16 + lane_rc<LD>(lane));
    }
#pragma unroll
    for (int nbp = 0; nbp < BI / 16; ++nbp) {
      uint32_t b[4];
      ldsm4(b, dob + nbp * 16 * LD + kk * 16);
      mma(s[2 * nbp], a, b[0], b[1]);
      mma(s[2 * nbp + 1], a, b[2], b[3]);
    }
  }
  // ds = p (dp - di), p read back from its bf16 pack: ap[kk][2 hh + r] holds
  // block 2 kk + hh, row half r, columns 2c (low half) and 2c + 1.
#pragma unroll
  for (int nb = 0; nb < BI / 8; ++nb) {
    const float2 dd = *reinterpret_cast<const float2*>(di_s + nb * 8 + 2 * c);
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t pk = ap[nb >> 1][2 * (nb & 1) + r];
      s[nb][2 * r] = __uint_as_float(pk << 16) * (s[nb][2 * r] - dd.x);
      s[nb][2 * r + 1] =
          __uint_as_float(pk & 0xffff0000u) * (s[nb][2 * r + 1] - dd.y);
    }
  }
#pragma unroll
  for (int kk = 0; kk < BI / 16; ++kk) {
    frag_a_acc(ap[kk], s[2 * kk], s[2 * kk + 1]);
#pragma unroll
    for (int nbp = 0; nbp < HD / 16; ++nbp) {
      uint32_t b[4];
      ldsm4_t(b, qbt + kk * 16 * LD + nbp * 16);
      mma(dk[2 * nbp], ap[kk], b[0], b[1]);
      mma(dk[2 * nbp + 1], ap[kk], b[2], b[3]);
    }
  }
}

// K5dkv's block: 4 warps of 16 key rows each (kRows keys); a ring stage
// holds a q tile, its do tile and the tile's lse and di.
constexpr int kDkvWarps = kRows / 16;

template <int HD>
constexpr int kDkvStageBytes =
    2 * kDkvTile<HD> * (HD + 8) * 2 + 2 * kDkvTile<HD> * 4;

template <int HD>
constexpr int dkv_smem() {  // the k and v tiles, then the ring
  return 2 * kRows * (HD + 8) * 2 + 2 * kDkvStageBytes<HD>;
}

template <int HD>
__global__ void __launch_bounds__(kDkvWarps * 32) dkv_bf16(Params p) {
  constexpr int BK = kRows, BI = kDkvTile<HD>, LD = HD + 8;
  constexpr int NT = kDkvWarps * 32;
  constexpr bool RES = kDkvResident<HD>;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* ks = reinterpret_cast<bf16*>(smem);
  bf16* vs = ks + BK * LD;
  unsigned char* ring = smem + 2 * BK * LD * 2;
  const int t = p.t, n = p.n;
  const int k0 = blockIdx.y * BK;
  const int bi = blockIdx.x / n, h = blockIdx.x % n;
  const bf16* q = head_ptr<bf16>(p.q, p.sq, bi, h);
  const bf16* k = head_ptr<bf16>(p.k, p.sk, bi, h);
  const bf16* v = head_ptr<bf16>(p.v, p.sv, bi, h);
  const bf16* dout = head_ptr<bf16>(p.dout, p.sdo, bi, h);
  const float* lse = p.lse + (size_t)blockIdx.x * t;
  const float* dig = p.di + (size_t)blockIdx.x * t;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, c = lane & 3, wk = warp * 16;
  const int n_tiles = (t + BI - 1) / BI;
  const int it0 = p.causal ? k0 / BI : 0;  // the first tile with a visible pair

  // Query tile it into stage (it - it0) % 2 as one commit group (empty past
  // the last tile): q, do, then lse and di by 4-byte copies, since a
  // [b, n, t] row starts at a 16-byte boundary only when t is a multiple
  // of 4.
  auto load_tile = [&](int it) {
    if (it < n_tiles) {
      unsigned char* st = ring + ((it - it0) & 1) * kDkvStageBytes<HD>;
      bf16* qs = reinterpret_cast<bf16*>(st);
      bf16* dos = qs + BI * LD;
      float* stats = reinterpret_cast<float*>(dos + BI * LD);
      const int i0 = it * BI;
      stage_async<BI, HD, NT>(qs, q, p.sq[1], i0, t);
      stage_async<BI, HD, NT>(dos, dout, p.sdo[1], i0, t);
      for (int i = threadIdx.x; i < 2 * BI; i += NT) {
        const bool live = i0 + i % BI < t;
        cp_async<4>(stats + i,
                    (i < BI ? lse : dig) + (live ? i0 + i % BI : 0), live);
      }
    }
    cp_async_commit();
  };
  stage_async<BK, HD, NT>(ks, k, p.sk[1], k0, t);  // in the first tile's group
  stage_async<BK, HD, NT>(vs, v, p.sv[1], k0, t);
  load_tile(it0);
  cp_async_wait<0>();
  __syncthreads();

  const bf16* kw = ks + wk * LD;  // the warp's own 16 rows of k and v
  const bf16* vw = vs + wk * LD;
  uint32_t ak[HD / 16][4], av[HD / 16][4];
  if constexpr (RES) {
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      ldsm4(ak[kk], kw + kk * 16 + lane_rc<LD>(lane));
      ldsm4(av[kk], vw + kk * 16 + lane_rc<LD>(lane));
    }
  }
  float dk[HD / 8][4] = {}, dv[HD / 8][4] = {};
  const float sl2 = p.scale * kLog2e;
  const int wkey0 = k0 + wk;

  for (int it = it0; it < n_tiles; ++it) {
    cp_async_wait<0>();  // this thread's copies of tile it have landed
    __syncthreads();     // everyone's have, and tile it - 1 is consumed
    load_tile(it + 1);   // into the stage tile it - 1 held
    const int i0 = it * BI;
    if (p.causal && wkey0 > i0 + BI - 1) continue;  // wholly before the keys
    const unsigned char* st = ring + ((it - it0) & 1) * kDkvStageBytes<HD>;
    const bf16* qs = reinterpret_cast<const bf16*>(st);
    const bf16* dos = qs + BI * LD;
    const float* lse_s = reinterpret_cast<const float*>(dos + BI * LD);
    if ((p.causal && wkey0 + 15 > i0) || i0 + BI > t)
      dkv_tile<HD, RES, true>(qs, dos, lse_s, lse_s + BI, kw, vw, ak, av, dk,
                              dv, sl2, i0, wkey0 + g, t, p.causal, lane);
    else
      dkv_tile<HD, RES, false>(qs, dos, lse_s, lse_s + BI, kw, vw, ak, av, dk,
                               dv, sl2, i0, wkey0 + g, t, p.causal, lane);
  }

  // dk and dv leave through the warp's own rows of the k and v tiles.
  bf16* kout = ks + wk * LD;
  bf16* vout = vs + wk * LD;
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int nb = 0; nb < HD / 8; ++nb) {
      const int at = (g + 8 * i) * LD + nb * 8 + 2 * c;
      *reinterpret_cast<__nv_bfloat162*>(kout + at) = __floats2bfloat162_rn(
          dk[nb][2 * i] * p.scale, dk[nb][2 * i + 1] * p.scale);
      *reinterpret_cast<__nv_bfloat162*>(vout + at) =
          __floats2bfloat162_rn(dv[nb][2 * i], dv[nb][2 * i + 1]);
    }
  store_rows<HD>(static_cast<bf16*>(p.dk), kout, bi, wkey0, h, t, n, lane);
  store_rows<HD>(static_cast<bf16*>(p.dv), vout, bi, wkey0, h, t, n, lane);
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

// One block per ROWS rows of the sequence and (batch, head). HEADS_FIRST
// puts (batch, head) on grid.x, the axis blocks are handed out along first:
// all heads' blocks of one tile start together, the tiles in the kernel's
// order (heaviest first), so the light blocks fill the tail. The opt-in to
// more than 48 KB of dynamic shared memory is made once per instantiation
// and device, not on every launch.
template <void (*KERNEL)(Params), int SMEM, int THREADS, int ROWS,
          bool HEADS_FIRST>
int launch(const Params& p, int b, cudaStream_t s) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(
        KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  const int tiles = (p.t + ROWS - 1) / ROWS;
  const dim3 grid = HEADS_FIRST ? dim3(b * p.n, tiles) : dim3(tiles, b * p.n);
  KERNEL<<<grid, THREADS, SMEM, s>>>(p);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_pass(int pass, int bf16_in, const Params& p, int b,
                cudaStream_t s) {
  if (bf16_in) {
    if (pass == kFwd)
      return launch<fwd_bf16<HD>, fwd_smem<HD>(), 128, kRows, true>(p, b, s);
    if (pass == kDkv)
      return launch<dkv_bf16<HD>, dkv_smem<HD>(), kDkvWarps * 32, kRows,
                    true>(p, b, s);
    return launch<dq_bf16<HD>, dq_smem<HD>(), 128, kRows, true>(p, b, s);
  }
  if (pass == kFwd)
    return launch<fwd_f32<HD>, fwd32_smem<HD>(), 256, kRows, false>(p, b, s);
  if (pass == kDkv)
    return launch<dkv_f32<HD>, dkv32_smem<HD>(), 256, kRows, false>(p, b, s);
  return launch<dq_f32<HD>, dq32_smem<HD>(), 256, kRows, false>(p, b, s);
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

template <int HD>
int smem_bytes(int pass) {
  if (pass == kFwd) return fwd_smem<HD>();
  return pass == kDkv ? dkv_smem<HD>() : dq_smem<HD>();
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

// Dynamic shared memory, in bytes, that a block of the bf16 kernel of a pass
// (0 forward, 1 dK/dV, 2 dQ) asks for at head dim hd; -1 for another hd.
int tempo_flash_smem_bytes(int pass, int hd) {
  using namespace tempo::flash;
  switch (hd) {
    case 32:
      return smem_bytes<32>(pass);
    case 64:
      return smem_bytes<64>(pass);
    case 128:
      return smem_bytes<128>(pass);
    default:
      return -1;
  }
}

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

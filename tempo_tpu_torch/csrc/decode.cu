// K3 and K4: active-length single-token decode attention, over a dense
// cache (K3) and over a paged cache through a block table (K4).
//
// Replaces tempo_tpu/ops/pallas_decode.py: _decode_kernel (K3, run by
// decode_attention) and _paged_kernel (K4, run by paged_decode_attention).
//
// out[r, 0, h*g + i, :] = softmax_j(q[r, 0, h*g + i, :] . K[r, j, h, :] /
// sqrt(hd)) V[r, j, h, :] over the live positions j = 0 .. pos[r] (and
// j < the cache length), q heads kv-major as in nn/transformer.py's GQA
// reshape. fp32 math; output in q's type.
//
// What bounds it on the H100: bytes. A step reads each row's live keys and
// values once, 2 * (pos[r] + 1) * kv * hd elements, plus q and the output;
// the arithmetic is 4 flops per element read. At 3.35 TB/s GPT-2-small's
// 12 kv heads x 64 at 1024 live bf16 positions (3.1 MB per row and layer)
// take ~0.94 us a row.
//
// Design (flash-decoding: a split over the sequence, then a merge):
// - Split the sequence across blocks. The split kernel's grid is (kv heads,
//   rows, n_split) with n_split = ceil(cap / kSplit), sized from the static
//   cache length because the wrapper never syncs to learn a position; a
//   block whose split starts at or past its row's live length exits at
//   once. A block does all g = n / kv query heads of its kv head, so each
//   K/V element is read once for the whole group.
// - Each lane loads 16 bytes (8 bf16 or 4 f32 values) of a key; hd / VEC
//   lanes hold one key, a warp reads 32 / (hd / VEC) keys at once, and every
//   lane issues its loads of U keys (k and v) before it uses any of them:
//   with 4 warps, kSplit = 128 positions and hd 64 bf16, one batch of 8 + 8
//   16-byte loads a lane covers the whole split. A key's partial dot
//   products are summed across its lanes by shuffles.
// - Paged (K4): the block reads the table entry of each page its split
//   covers once into shared memory, before its K/V loads, so no load of
//   k or v waits on a table read of its own (the TPU kernel's index map,
//   pallas_decode.py:132-134). Dead logical pages are never visited.
// - Each lane group keeps a running max, denominator and its slice of the
//   [g, hd] accumulator in fp32 registers; the groups of a warp merge by
//   shuffles, the warps through shared memory, and the block writes its
//   split's partial state (max, denominator, [g, hd] numerator; fp32, in
//   the log2 domain with the 1/sqrt(hd) scale folded into q) to a scratch
//   tensor the wrapper allocates.
// - A short row (up to kShortRow = 2 * kSplit live positions) is not split:
//   split 0's block walks it whole and writes its output, the other splits
//   exit. Where one batch covers a split, that is a second batch: one more
//   trip to memory, which costs less than the fold below (the path's dense
//   calls, positions 64-191, are all short rows).
// - One launch. Every live split of a longer (row, kv head) writes its
//   state and adds one to the (row, kv head)'s counter in an int32
//   buffer the wrapper keeps at zero between calls; the block that brings
//   the count to the row's live splits folds them all in split order,
//   0 .. ceil(n_live / kSplit) - 1, writes the output and puts the counter
//   back to 0. The counter only elects the folding block: no sum is atomic
//   and the fold's order is fixed, so a row's result depends on its own
//   position, q, K and V alone (not on the batch, the other rows'
//   positions, the pool's size, where its pages lie or which split ends
//   last), bit for bit.
// - The group width is a template parameter G in {1, 2, 4, 8}; heads past
//   g in the last G are computed on zeros and never written. The launch
//   bounds name one block an SM as the minimum: without it ptxas held some
//   fp32 instantiations to 96 registers and spilled; with it none spills.
//
// What bounds it now: fixed latency, not bytes. Timed whole and alone with
// a cold L2, a call is ~5 us of launch outside the kernel, then the
// kernel's dependent trips to memory (the position, q and the table
// entries; k and v; a long row's fold). At generate's most frequent K3 call
// (position 64) the kernel runs 3.6 us of an 8.6-8.8 us call; at the
// serve's most frequent K4 call 6.5 us of 12.1-12.3. The average K4 call
// (b = 8, ~312 live positions a row) moves 7.7 MB, a 2.3 us byte bound, in
// 14.0 us (16.5 with one block per row and kv head); the average K3 call
// takes 10.2 us (10.5). NVIDIA H100 80GB HBM3 at 700 W, chip_smoke.py.
// Left: the launch cost, which a captured decode step removes.
#include <math.h>

#include "common.cuh"

namespace tempo {

// Positions a split covers: a divisor of the serving path's 128-position
// page, so a split reads one table entry there (64 and 256 were slower on
// the path's calls).
constexpr int kSplit = 128;
constexpr int kSplitWarps = 4;
// A row of up to kShortRow live positions is not split: split 0's block
// walks it in batches and writes its output, with no fold.
constexpr int kShortRow = 2 * kSplit;

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    out[2 * i] = f.x;
    out[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void unpack(const uint4& raw, float (&out)[4]) {
  out[0] = __uint_as_float(raw.x);
  out[1] = __uint_as_float(raw.y);
  out[2] = __uint_as_float(raw.z);
  out[3] = __uint_as_float(raw.w);
}

// Folds state (mo, lo, ao) into (m, l, a), log2 domain; either may be
// empty (m = -inf).
template <int V>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&a)[V],
                                            float mo, float lo,
                                            const float (&ao)[V]) {
  const float mn = fmaxf(m, mo);
  const float fa = (m == -INFINITY) ? 0.0f : exp2f(m - mn);
  const float fb = (mo == -INFINITY) ? 0.0f : exp2f(mo - mn);
  l = l * fa + lo * fb;
#pragma unroll
  for (int e = 0; e < V; ++e) a[e] = a[e] * fa + ao[e] * fb;
  m = mn;
}

// out[off] in q's type.
__device__ __forceinline__ void store_out(void* out_, int q_bf16, size_t off,
                                          float o) {
  if (q_bf16)
    static_cast<__nv_bfloat16*>(out_)[off] = __float2bfloat16(o);
  else
    static_cast<float*>(out_)[off] = o;
}

// The live length of a row at position row_pos: positions 0 .. row_pos,
// within the cache.
__device__ __forceinline__ int live_len(int row_pos, int cap) {
  return min(row_pos, cap - 1) + 1;
}

// Offset of split s of (row r, kv head h) in the partial state: acc holds
// [b, kv, n_split, g, hd] fp32, ml [b, kv, n_split, g, 2] (max, sum).
__device__ __forceinline__ size_t part_at(int r, int h, int s, int kv,
                                          int n_split, int g) {
  return (((size_t)r * kv + h) * n_split + s) * g;
}

// Folds the live_splits states of (row r, kv head h) from part_at(r, h,
// 0, ...) in split order and writes the [g, HD] output in q's type. A live
// split holds a live key, so its max is finite. The states of kMergeChunk
// splits are loaded together (past L1: other blocks wrote them), then
// folded one by one.
constexpr int kMergeChunk = 4;

template <int HD>
__device__ void fold_splits(const float* __restrict__ part_acc,
                            const float* __restrict__ part_ml,
                            void* __restrict__ out_, int q_bf16, int r, int h,
                            int n, int g, size_t at, int live_splits) {
  for (int idx = threadIdx.x; idx < g * HD; idx += blockDim.x) {
    const int i = idx / HD, d = idx % HD;
    float mx = -INFINITY, den = 0.0f, num = 0.0f;
    for (int c0 = 0; c0 < live_splits; c0 += kMergeChunk) {
      float ms[kMergeChunk], ls[kMergeChunk], as[kMergeChunk];
#pragma unroll
      for (int u = 0; u < kMergeChunk; ++u) {
        const size_t a = at + (size_t)(c0 + u) * g + i;
        const bool live = c0 + u < live_splits;
        ms[u] = live ? __ldcg(part_ml + 2 * a) : -INFINITY;
        ls[u] = live ? __ldcg(part_ml + 2 * a + 1) : 0.0f;
        as[u] = live ? __ldcg(part_acc + a * HD + d) : 0.0f;
      }
#pragma unroll
      for (int u = 0; u < kMergeChunk; ++u) {
        if (ms[u] == -INFINITY) continue;  // past the live splits
        const float mn = fmaxf(mx, ms[u]);
        const float fa = exp2f(mx - mn);  // 0 at the first split
        const float fb = exp2f(ms[u] - mn);
        den = den * fa + ls[u] * fb;
        num = num * fa + as[u] * fb;
        mx = mn;
      }
    }
    store_out(out_, q_bf16, ((size_t)r * n + h * g + i) * HD + d, num / den);
  }
}

template <typename TC, int HD, int G>
struct SplitShape {
  static constexpr int VEC = 16 / sizeof(TC);  // elements per 16-byte load
  static constexpr int LPK = HD / VEC;         // lanes per key
  static constexpr int KPW = 32 / LPK;         // keys per warp load
  // keys a lane group loads before it uses them: the split in one batch
  // where the registers allow (fewer at wide groups; one at G = 8, where q
  // and the accumulator alone take 64 registers and fp32 spilled at 2)
  static constexpr int UMAX = G <= 2 ? 8 : (G == 4 ? 4 : 1);
  static constexpr int UFIT = kSplit / (kSplitWarps * KPW);
  static constexpr int U = UFIT < 1 ? 1 : (UFIT < UMAX ? UFIT : UMAX);
  static_assert(LPK >= 1 && LPK <= 32 && (32 % LPK) == 0, "head dim");
};

// TC: cache type. HD: head dim. G: group width rounded up to {1,2,4,8}.
// Dense (table == nullptr): ck/cv [b, cap, kv, HD]. Paged: ck/cv pools
// [P, page, kv, HD], table [b, max_pages], cap = max_pages * page.
// counters: [b, kv] int32, zero on entry and on exit.
template <typename TC, int HD, int G>
__global__ void __launch_bounds__(kSplitWarps * 32, 1)
    decode_split(const void* __restrict__ q_, const TC* __restrict__ ck,
                 const TC* __restrict__ cv, const int* __restrict__ pos,
                 int pos_stride, const int* __restrict__ table,
                 float* __restrict__ part_acc, float* __restrict__ part_ml,
                 int* __restrict__ counters, void* __restrict__ out_,
                 int q_bf16, int n, int kv, int g,
                 int cap, int page, int max_pages, int n_split,
                 float qscale) {
  using S = SplitShape<TC, HD, G>;
  constexpr int VEC = S::VEC, LPK = S::LPK, KPW = S::KPW, U = S::U;
  constexpr int kWarpSpan = KPW * U;  // keys a warp covers per batch

  const int h = blockIdx.x, r = blockIdx.y, split = blockIdx.z;
  const int s0 = split * kSplit;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK, part = lane % LPK;
  const size_t kstride = (size_t)kv * HD;  // elements between positions

  // The position, q and (paged) the table entries of the pages the split
  // may cover (split 0 covers a short row whole) are loaded together,
  // before the block knows whether its split is live: the entries of every
  // page in [s0, min(s0 + s_pre, cap)) exist.
  const int row_pos = pos[(size_t)r * pos_stride];
  float qf[G][VEC];  // q slice of this lane, pre-scaled by log2(e) / sqrt(hd)
#pragma unroll
  for (int i = 0; i < G; ++i) {
    const size_t off = ((size_t)r * n + h * g + i) * HD + part * VEC;
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float v = 0.0f;
      if (i < g)
        v = q_bf16 ? __bfloat162float(
                         static_cast<const __nv_bfloat16*>(q_)[off + e])
                   : static_cast<const float*>(q_)[off + e];
      qf[i][e] = v * qscale;
    }
  }
  __shared__ int pages[kShortRow];  // pool page of each logical page covered
  const int s_pre = split == 0 ? kShortRow : kSplit;
  const int p0 = table != nullptr ? s0 / page : 0;
  const int n_pages =
      table != nullptr ? (min(s0 + s_pre, cap) - 1) / page - p0 + 1 : 0;
  for (int i = threadIdx.x; i < n_pages; i += blockDim.x)
    pages[i] = table[(size_t)r * max_pages + p0 + i];

  const int n_live = live_len(row_pos, cap);
  const bool short_row = n_live <= kShortRow;
  // A split with no live position, or past split 0 of a short row, exits.
  if (s0 >= n_live || (short_row && split > 0)) return;
  const int s_end = short_row ? n_live : min(s0 + kSplit, n_live);
  if (table != nullptr) __syncthreads();

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.0f;
  }

  for (int base = s0 + warp * kWarpSpan; base < s_end;
       base += kSplitWarps * kWarpSpan) {  // warp-uniform bound
    // One batch: U keys a lane group, k and v, all loads before any use.
    uint4 kr[U], vr[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = base + u * KPW + sub;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (j < s_end) {
        const size_t row =
            table != nullptr
                ? (size_t)pages[j / page - p0] * page + j % page
                : (size_t)r * cap + j;
        const size_t off = row * kstride + (size_t)h * HD + part * VEC;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(ck + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(cv + off));
      }
    }
    float s[U][G];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float kf[VEC];
      unpack(kr[u], kf);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qf[i][e], kf[e], d);
        s[u][i] = d;
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < G; ++i)
          s[u][i] += __shfl_xor_sync(0xffffffffu, s[u][i], off);
      }
      if (base + u * KPW + sub >= s_end) {
#pragma unroll
        for (int i = 0; i < G; ++i) s[u][i] = -INFINITY;
      }
    }
    // One rescale a batch: the batch's maximum first, then its terms.
#pragma unroll
    for (int i = 0; i < G; ++i) {
      float mx = m[i];
#pragma unroll
      for (int u = 0; u < U; ++u) mx = fmaxf(mx, s[u][i]);
      if (mx == -INFINITY) continue;  // no live key of this group yet
      const float a = exp2f(m[i] - mx);  // 0 on the group's first keys
      l[i] *= a;
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc[i][e] *= a;
      m[i] = mx;
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      float vf[VEC];
      unpack(vr[u], vf);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        if (m[i] == -INFINITY) continue;  // no live key of this group yet
        const float p = exp2f(s[u][i] - m[i]);  // a dead key gives 0
        l[i] += p;
#pragma unroll
        for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e]);
      }
    }
  }

  // Merge the key groups of the warp (lanes with the same `part`).
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], off);
      const float lo = __shfl_xor_sync(0xffffffffu, l[i], off);
      float ao[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e)
        ao[e] = __shfl_xor_sync(0xffffffffu, acc[i][e], off);
      merge_state<VEC>(m[i], l[i], acc[i], mo, lo, ao);
    }
  }

  // Merge the warps through shared memory into the split's partial state.
  __shared__ float sm_m[kSplitWarps][G], sm_l[kSplitWarps][G];
  __shared__ float sm_acc[kSplitWarps][G][HD];
  if (sub == 0) {
#pragma unroll
    for (int i = 0; i < G; ++i) {
#pragma unroll
      for (int e = 0; e < VEC; ++e) sm_acc[warp][i][part * VEC + e] = acc[i][e];
      if (part == 0) {
        sm_m[warp][i] = m[i];
        sm_l[warp][i] = l[i];
      }
    }
  }
  __syncthreads();
  // A short row gets its output here; a longer one's splits write their
  // partial state for the fold.
  const size_t at = part_at(r, h, split, kv, n_split, g);
  for (int idx = threadIdx.x; idx < g * HD; idx += blockDim.x) {
    const int i = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) mx = fmaxf(mx, sm_m[w][i]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kSplitWarps; ++w) {
      const float mw = sm_m[w][i];
      if (mw != -INFINITY) {
        const float f = exp2f(mw - mx);
        den = fmaf(sm_l[w][i], f, den);
        num = fmaf(sm_acc[w][i][d], f, num);
      }
    }
    if (short_row) {
      store_out(out_, q_bf16, ((size_t)r * n + h * g + i) * HD + d,
                num / den);
      continue;
    }
    part_acc[(at + i) * HD + d] = num;
    if (d == 0) {
      part_ml[2 * (at + i)] = mx;
      part_ml[2 * (at + i) + 1] = den;
    }
  }
  if (short_row) return;

  // The last live split of (row, kv head) to arrive folds the row. Its
  // arrival is counted by one acq_rel atomic after the block's barrier:
  // release orders the block's writes before it, acquire the other blocks'
  // writes before the fold's reads. The counter goes back to 0 for the next
  // call once every live split came.
  const int live_splits = (n_live + kSplit - 1) / kSplit;
  __shared__ int last;
  __syncthreads();
  if (threadIdx.x == 0) {
    int* count = counters + (size_t)r * kv + h;
    int ticket;
    asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                 : "=r"(ticket)
                 : "l"(count)
                 : "memory");
    last = ticket == live_splits - 1;
    if (last) *count = 0;
  }
  __syncthreads();
  if (!last) return;
  fold_splits<HD>(part_acc, part_ml, out_, q_bf16, r, h, n, g,
                  part_at(r, h, 0, kv, n_split, g), live_splits);
}

// What one call launches, passed down the dispatch on type, head dim and
// group width.
struct Launch {
  const void *q, *k, *v;
  const int* pos;
  int pos_stride;
  const int* table;
  float *part_acc, *part_ml;
  int* counters;
  void* out;
  int q_bf16, b, n, kv, cap, page, max_pages, n_split;
  cudaStream_t stream;
};

template <typename TC, int HD, int G>
void launch_split(const Launch& a) {
  const dim3 grid(a.kv, a.b, a.n_split);
  decode_split<TC, HD, G><<<grid, kSplitWarps * 32, 0, a.stream>>>(
      a.q, static_cast<const TC*>(a.k), static_cast<const TC*>(a.v), a.pos,
      a.pos_stride, a.table, a.part_acc, a.part_ml, a.counters, a.out,
      a.q_bf16, a.n, a.kv, a.n / a.kv, a.cap, a.page, a.max_pages,
      a.n_split, 1.4426950408889634f / sqrtf((float)HD));
}

template <typename TC, int HD>
void launch_group(const Launch& a) {
  const int g = a.n / a.kv;
  if (g <= 1)
    launch_split<TC, HD, 1>(a);
  else if (g <= 2)
    launch_split<TC, HD, 2>(a);
  else if (g <= 4)
    launch_split<TC, HD, 4>(a);
  else
    launch_split<TC, HD, 8>(a);
}

template <typename TC>
int launch_hd(int hd, const Launch& a) {
  switch (hd) {
    case 16:
      launch_group<TC, 16>(a);
      break;
    case 32:
      launch_group<TC, 32>(a);
      break;
    case 64:
      launch_group<TC, 64>(a);
      break;
    case 128:
      launch_group<TC, 128>(a);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace tempo

extern "C" {

// Positions a split covers (the scratch the wrapper allocates depends on
// it: n_split = ceil(cap / split) partial states a (row, q head)).
int tempo_decode_split_len() { return tempo::kSplit; }

// q [b, 1, n, hd] (q_dtype), cache k/v (cache_dtype): dense [b, cap, kv, hd]
// with table == NULL, or pools [P, page, kv, hd] with table [b, max_pages]
// int32 and cap = max_pages * page. pos int32, pos[r * pos_stride] (stride 0
// broadcasts one position). out [b, 1, n, hd] in q's type. scratch: fp32,
// b * n * ceil(cap / split) * (hd + 2) values, written before it is read.
// counters: b * kv int32, zero before the call and left zero by it (calls
// that share them must be ordered, as on one stream). n % kv == 0,
// n / kv <= 8, hd in {16, 32, 64, 128}, 16-byte aligned k/v (the wrapper
// checks all of it). One launch.
int tempo_decode_attention(const void* q, const void* k, const void* v,
                           const void* pos, int pos_stride, const void* table,
                           void* out, void* scratch, void* counters,
                           int cache_dtype, int q_dtype, int b, int n, int kv,
                           int hd, int cap, int page, int max_pages,
                           void* stream) {
  const int n_split = (cap + tempo::kSplit - 1) / tempo::kSplit;
  float* part_acc = static_cast<float*>(scratch);
  const tempo::Launch a = {
      q, k, v, static_cast<const int*>(pos), pos_stride,
      static_cast<const int*>(table), part_acc,
      part_acc + (size_t)b * n * n_split * hd, static_cast<int*>(counters),
      out, q_dtype == tempo::DT_BF16, b, n, kv, cap, page, max_pages,
      n_split, static_cast<cudaStream_t>(stream)};
  return cache_dtype == tempo::DT_BF16
             ? tempo::launch_hd<__nv_bfloat16>(hd, a)
             : tempo::launch_hd<float>(hd, a);
}

}  // extern "C"

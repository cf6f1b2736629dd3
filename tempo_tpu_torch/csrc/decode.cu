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
// Design:
// - One block per (row, kv head). The block does all g = n / kv query heads
//   of the group, so each K/V element is read once for the whole group.
//   The Pallas grid walked the sequence serially through VMEM scratch; here
//   the block's warps split the row's live positions instead.
// - Each lane loads 16 bytes (8 bf16 or 4 f32 values) of a key; hd / 8
//   lanes (bf16) hold one key, so a warp reads 32 / (hd / 8) keys at once,
//   kUnroll times over before it uses any of them, to keep loads in flight.
//   A key's partial dot products are summed across its lanes by shuffles.
// - Every group of lanes keeps a running max, denominator and its slice of
//   the [g, hd] accumulator in fp32 registers (online softmax). At the end
//   the groups of a warp merge by shuffles and the warps merge through
//   shared memory; the block writes [g, hd] in q's type.
// - Positions past pos[r] are never loaded: the loop bound is the row's
//   position, read from device memory (the wrapper never syncs to learn it).
// - K4 is the same body; a key's address goes through table[r, j / page]
//   (the TPU kernel's index map, pallas_decode.py:132-134), so dead logical
//   pages are not visited and the gathered dense view is never built.
// - The group width is a template parameter G in {1, 2, 4, 8}; heads past
//   g in the last G are computed on zeros and never written.
//
// Left for later: a split over the sequence with a second merge pass
// (flash-decoding; at b = 8 and 12 heads there are only 96 blocks for 132
// SMs) and cp.async / TMA staging.
#include <math.h>

#include "common.cuh"

namespace tempo {

constexpr int kDecodeWarps = 8;
constexpr int kUnroll = 4;  // keys a lane loads before it uses them

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

// Folds state (mo, lo, ao) into (m, l, a); either may be empty (-inf).
template <int V>
__device__ __forceinline__ void merge_state(float& m, float& l, float (&a)[V],
                                            float mo, float lo,
                                            const float (&ao)[V]) {
  const float mn = fmaxf(m, mo);
  const float fa = (m == -INFINITY) ? 0.0f : expf(m - mn);
  const float fb = (mo == -INFINITY) ? 0.0f : expf(mo - mn);
  l = l * fa + lo * fb;
#pragma unroll
  for (int e = 0; e < V; ++e) a[e] = a[e] * fa + ao[e] * fb;
  m = mn;
}

// TC: cache type. HD: head dim. G: group width rounded up to {1,2,4,8}.
// Dense (table == nullptr): ck/cv [b, cap, kv, HD]. Paged: ck/cv pools
// [P, page, kv, HD], table [b, max_pages], cap = max_pages * page.
template <typename TC, int HD, int G>
__global__ void __launch_bounds__(kDecodeWarps * 32)
    decode_attn_kernel(const void* __restrict__ q_, const TC* __restrict__ ck,
                       const TC* __restrict__ cv, const int* __restrict__ pos,
                       int pos_stride, const int* __restrict__ table,
                       void* __restrict__ out_, int q_bf16, int n, int kv,
                       int g, int cap, int page, int max_pages, float scale) {
  constexpr int VEC = 16 / sizeof(TC);  // elements per 16-byte load
  constexpr int LPK = HD / VEC;         // lanes per key
  constexpr int KPW = 32 / LPK;         // keys per warp load
  static_assert(LPK >= 1 && LPK <= 32 && (32 % LPK) == 0, "head dim");

  const int h = blockIdx.x, r = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPK, part = lane % LPK;
  const int n_live = min(pos[(size_t)r * pos_stride], cap - 1) + 1;
  const size_t kstride = (size_t)kv * HD;  // elements between positions

  // q slice of this lane, pre-scaled by 1/sqrt(hd).
  float qf[G][VEC];
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
      qf[i][e] = v * scale;
    }
  }

  float m[G], l[G], acc[G][VEC];
#pragma unroll
  for (int i = 0; i < G; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
#pragma unroll
    for (int e = 0; e < VEC; ++e) acc[i][e] = 0.0f;
  }

  constexpr int kWarpSpan = KPW * kUnroll;  // keys a warp covers per pass
  for (int base = warp * kWarpSpan; base < n_live;
       base += kDecodeWarps * kWarpSpan) {  // warp-uniform bound
    uint4 kr[kUnroll], vr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * KPW + sub;
      kr[u] = make_uint4(0, 0, 0, 0);
      vr[u] = make_uint4(0, 0, 0, 0);
      if (j < n_live) {
        size_t row;
        if (table != nullptr)
          row = (size_t)table[(size_t)r * max_pages + j / page] * page +
                j % page;
        else
          row = (size_t)r * cap + j;
        const size_t off = row * kstride + (size_t)h * HD + part * VEC;
        kr[u] = __ldg(reinterpret_cast<const uint4*>(ck + off));
        vr[u] = __ldg(reinterpret_cast<const uint4*>(cv + off));
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const bool live = base + u * KPW + sub < n_live;
      float kf[VEC];
      unpack(kr[u], kf);
      float s[G];
#pragma unroll
      for (int i = 0; i < G; ++i) {
        float d = 0.0f;
#pragma unroll
        for (int e = 0; e < VEC; ++e) d = fmaf(qf[i][e], kf[e], d);
        s[i] = d;
      }
#pragma unroll
      for (int off = LPK / 2; off > 0; off >>= 1) {
#pragma unroll
        for (int i = 0; i < G; ++i)
          s[i] += __shfl_xor_sync(0xffffffffu, s[i], off);
      }
      if (live) {
        float vf[VEC];
        unpack(vr[u], vf);
#pragma unroll
        for (int i = 0; i < G; ++i) {
          const float mn = fmaxf(m[i], s[i]);
          const float a = expf(m[i] - mn);  // exp(-inf) = 0 on the first key
          const float p = expf(s[i] - mn);
          l[i] = l[i] * a + p;
#pragma unroll
          for (int e = 0; e < VEC; ++e) acc[i][e] = fmaf(p, vf[e], acc[i][e] * a);
          m[i] = mn;
        }
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

  // Merge the warps through shared memory.
  __shared__ float sm_m[kDecodeWarps][G], sm_l[kDecodeWarps][G];
  __shared__ float sm_acc[kDecodeWarps][G][HD];
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
  for (int idx = threadIdx.x; idx < g * HD; idx += blockDim.x) {
    const int i = idx / HD, d = idx % HD;
    float mx = -INFINITY;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) mx = fmaxf(mx, sm_m[w][i]);
    float den = 0.0f, num = 0.0f;
#pragma unroll
    for (int w = 0; w < kDecodeWarps; ++w) {
      const float mw = sm_m[w][i];
      if (mw != -INFINITY) {
        const float f = expf(mw - mx);
        den = fmaf(sm_l[w][i], f, den);
        num = fmaf(sm_acc[w][i][d], f, num);
      }
    }
    const float o = num / den;
    const size_t off = ((size_t)r * n + h * g + i) * HD + d;
    if (q_bf16)
      static_cast<__nv_bfloat16*>(out_)[off] = __float2bfloat16(o);
    else
      static_cast<float*>(out_)[off] = o;
  }
}

template <typename TC, int HD, int G>
void launch_decode(const void* q, const void* k, const void* v,
                   const int* pos, int pos_stride, const int* table,
                   void* out, int q_bf16, int b, int n, int kv, int cap,
                   int page, int max_pages, cudaStream_t s) {
  const dim3 grid(kv, b);
  decode_attn_kernel<TC, HD, G><<<grid, kDecodeWarps * 32, 0, s>>>(
      q, static_cast<const TC*>(k), static_cast<const TC*>(v), pos,
      pos_stride, table, out, q_bf16, n, kv, n / kv, cap, page, max_pages,
      1.0f / sqrtf((float)HD));
}

template <typename TC, int HD>
void launch_group(int g, const void* q, const void* k, const void* v,
                  const int* pos, int pos_stride, const int* table, void* out,
                  int q_bf16, int b, int n, int kv, int cap, int page,
                  int max_pages, cudaStream_t s) {
#define TEMPO_DECODE_G(G)                                                  \
  launch_decode<TC, HD, G>(q, k, v, pos, pos_stride, table, out, q_bf16, b, \
                           n, kv, cap, page, max_pages, s)
  if (g <= 1)
    TEMPO_DECODE_G(1);
  else if (g <= 2)
    TEMPO_DECODE_G(2);
  else if (g <= 4)
    TEMPO_DECODE_G(4);
  else
    TEMPO_DECODE_G(8);
#undef TEMPO_DECODE_G
}

template <typename TC>
int launch_hd(int hd, int g, const void* q, const void* k, const void* v,
              const int* pos, int pos_stride, const int* table, void* out,
              int q_bf16, int b, int n, int kv, int cap, int page,
              int max_pages, cudaStream_t s) {
#define TEMPO_DECODE_HD(HD)                                                 \
  launch_group<TC, HD>(g, q, k, v, pos, pos_stride, table, out, q_bf16, b, \
                       n, kv, cap, page, max_pages, s)
  switch (hd) {
    case 16:
      TEMPO_DECODE_HD(16);
      break;
    case 32:
      TEMPO_DECODE_HD(32);
      break;
    case 64:
      TEMPO_DECODE_HD(64);
      break;
    case 128:
      TEMPO_DECODE_HD(128);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef TEMPO_DECODE_HD
  return 0;
}

}  // namespace tempo

extern "C" {

// q [b, 1, n, hd] (q_dtype), cache k/v (cache_dtype): dense [b, cap, kv, hd]
// with table == NULL, or pools [P, page, kv, hd] with table [b, max_pages]
// int32 and cap = max_pages * page. pos int32, pos[r * pos_stride] (stride 0
// broadcasts one position). out [b, 1, n, hd] in q's type. n % kv == 0,
// n / kv <= 8, hd in {16, 32, 64, 128}, 16-byte aligned k/v (the wrapper
// checks all of it).
int tempo_decode_attention(const void* q, const void* k, const void* v,
                           const void* pos, int pos_stride, const void* table,
                           void* out, int cache_dtype, int q_dtype, int b,
                           int n, int kv, int hd, int cap, int page,
                           int max_pages, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  const int g = n / kv;
  const int q_bf16 = q_dtype == tempo::DT_BF16;
  const int* p = static_cast<const int*>(pos);
  const int* t = static_cast<const int*>(table);
  int err;
  if (cache_dtype == tempo::DT_BF16)
    err = tempo::launch_hd<__nv_bfloat16>(hd, g, q, k, v, p, pos_stride, t,
                                          out, q_bf16, b, n, kv, cap, page,
                                          max_pages, s);
  else
    err = tempo::launch_hd<float>(hd, g, q, k, v, p, pos_stride, t, out,
                                  q_bf16, b, n, kv, cap, page, max_pages, s);
  if (err) return err;
  return (int)cudaGetLastError();
}

}  // extern "C"

// K1: GroupNorm statistics and GroupNorm + activation apply, NHWC.
//
// Replaces tempo_tpu/ops/pallas_gn.py: _stats_kernel (K1a) and
// _apply_kernel (K1b).
//
// What bounds it on the H100: bytes. Stats read x once (2 B/element in
// bf16) and do two FMAs per element; apply reads x once and writes it once.
// At 3.35 TB/s an [8,64,64,512] bf16 tensor (33.5 MB) takes ~10 us to read.
//
// Design:
// - K1a is a split reduction. The TPU kernel walked one sample per grid
//   step and carried the sums through VMEM; blocks on Hopper run in no
//   order, so here each block sums a chunk of rows for 32 channels into
//   fp32 partials [B, n_chunks, 2, C], and a second small kernel folds the
//   partials of each (sample, group) and writes per-channel (mean, rstd).
//   The number of row chunks is chosen by the wrapper so the first kernel
//   has ~1000 blocks at any batch, including a whole granule at B=1
//   (HW = 262,144): no per-sample size limit as on the TPU.
// - var = max(E[x^2] - E[x]^2, 0), as the plain GroupNorm computes it.
// - K1b is elementwise over [B, HW, C], grid-stride, with 16-byte vector
//   loads and stores when C and the pointers allow it.
#include "common.cuh"

namespace tempo {

constexpr int kStatsChannels = 32;  // channels per stats block (one warp)
constexpr int kStatsRows = 8;       // row lanes per stats block

template <typename T>
__global__ void gn_partial_kernel(const T* __restrict__ x,
                                  float* __restrict__ partial, int hw, int c,
                                  int rows_per_chunk, int n_chunks) {
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int ch = blockIdx.x * kStatsChannels + tx;
  const int chunk = blockIdx.y;
  const int b = blockIdx.z;
  const int r0 = chunk * rows_per_chunk;
  const int r1 = min(hw, r0 + rows_per_chunk);

  float s = 0.0f, sq = 0.0f;
  if (ch < c) {
    const T* xb = x + (size_t)b * hw * c + ch;
    for (int r = r0 + ty; r < r1; r += kStatsRows) {
      const float v = to_f32(xb[(size_t)r * c]);
      s += v;
      sq = fmaf(v, v, sq);
    }
  }
  __shared__ float ss[kStatsRows][kStatsChannels + 1];
  __shared__ float ssq[kStatsRows][kStatsChannels + 1];
  ss[ty][tx] = s;
  ssq[ty][tx] = sq;
  __syncthreads();
  if (ty == 0 && ch < c) {
    float ts = 0.0f, tq = 0.0f;
#pragma unroll
    for (int i = 0; i < kStatsRows; ++i) {
      ts += ss[i][tx];
      tq += ssq[i][tx];
    }
    const size_t o = ((size_t)b * n_chunks + chunk) * 2 * c + ch;
    partial[o] = ts;
    partial[o + c] = tq;
  }
}

// One block per (group, sample): fold the partial sums of the group's
// channels over all row chunks, then broadcast (mean, rstd) to its channels.
__global__ void gn_fold_kernel(const float* __restrict__ partial,
                               float* __restrict__ stats, int hw, int c,
                               int groups, int n_chunks, float eps) {
  const int g = blockIdx.x, b = blockIdx.y;
  const int cg = c / groups;
  const int n = n_chunks * cg;
  float s = 0.0f, sq = 0.0f;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int chunk = i / cg, j = i - (i / cg) * cg;
    const size_t o = ((size_t)b * n_chunks + chunk) * 2 * c + g * cg + j;
    s += partial[o];
    sq += partial[o + c];
  }
  __shared__ float rs[256], rq[256];
  rs[threadIdx.x] = s;
  rq[threadIdx.x] = sq;
  __syncthreads();
  for (int step = blockDim.x / 2; step > 0; step >>= 1) {
    if (threadIdx.x < step) {
      rs[threadIdx.x] += rs[threadIdx.x + step];
      rq[threadIdx.x] += rq[threadIdx.x + step];
    }
    __syncthreads();
  }
  const float denom = (float)hw * (float)cg;
  const float mean = rs[0] / denom;
  const float var = fmaxf(rq[0] / denom - mean * mean, 0.0f);
  const float rstd = rsqrtf(var + eps);
  for (int j = threadIdx.x; j < cg; j += blockDim.x) {
    stats[((size_t)b * 2) * c + g * cg + j] = mean;
    stats[((size_t)b * 2 + 1) * c + g * cg + j] = rstd;
  }
}

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__global__ void gn_apply_kernel(const T* __restrict__ x,
                                const float* __restrict__ stats,
                                const float* __restrict__ scale,
                                const float* __restrict__ bias,
                                T* __restrict__ out, long long total,
                                long long hwc, int c, int act) {
  const long long n_packs = total / VEC;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long p = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       p < n_packs; p += stride) {
    const long long i = p * VEC;
    const int b = (int)(i / hwc);
    const int ch0 = (int)(i % c);
    const float* mean = stats + (size_t)b * 2 * c;
    const float* rstd = mean + c;
    Pack<T, VEC> in = reinterpret_cast<const Pack<T, VEC>*>(x)[p];
    Pack<T, VEC> res;
#pragma unroll
    for (int k = 0; k < VEC; ++k) {
      const int ch = ch0 + k;
      float y = (to_f32(in.v[k]) - mean[ch]) * rstd[ch];
      y = fmaf(y, scale[ch], bias[ch]);
      res.v[k] = from_f32<T>(apply_act(y, act));
    }
    reinterpret_cast<Pack<T, VEC>*>(out)[p] = res;
  }
}

template <typename T>
void launch_stats(const void* x, void* partial, void* stats, int b, int hw,
                  int c, int groups, int rows_per_chunk, int n_chunks,
                  float eps, cudaStream_t stream) {
  dim3 grid((c + kStatsChannels - 1) / kStatsChannels, n_chunks, b);
  dim3 block(kStatsChannels, kStatsRows);
  gn_partial_kernel<T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial), hw, c,
      rows_per_chunk, n_chunks);
  gn_fold_kernel<<<dim3(groups, b), 256, 0, stream>>>(
      static_cast<const float*>(partial), static_cast<float*>(stats), hw, c,
      groups, n_chunks, eps);
}

template <typename T, int VEC>
void launch_apply(const void* x, const void* stats, const void* scale,
                  const void* bias, void* out, int b, int hw, int c, int act,
                  cudaStream_t stream) {
  const long long total = (long long)b * hw * c;
  const long long n_packs = total / VEC;
  const int threads = 256;
  long long blocks = (n_packs + threads - 1) / threads;
  if (blocks > 132 * 16) blocks = 132 * 16;
  if (blocks < 1) blocks = 1;
  gn_apply_kernel<T, VEC><<<(int)blocks, threads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), total, (long long)hw * c, c, act);
}

}  // namespace tempo

extern "C" {

// x [B, HW, C] (f32 or bf16) -> stats [B, 2, C] f32 (per-channel mean and
// rstd of the channel's group). partial: scratch of B*n_chunks*2*C floats.
int tempo_gn_stats(const void* x, void* partial, void* stats, int dtype,
                   int b, int hw, int c, int groups, int rows_per_chunk,
                   int n_chunks, float eps, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == tempo::DT_BF16)
    tempo::launch_stats<__nv_bfloat16>(x, partial, stats, b, hw, c, groups,
                                       rows_per_chunk, n_chunks, eps, s);
  else
    tempo::launch_stats<float>(x, partial, stats, b, hw, c, groups,
                               rows_per_chunk, n_chunks, eps, s);
  return (int)cudaGetLastError();
}

// out = act((x - mean) * rstd * scale + bias), out in x's type.
// vectorized != 0 asserts C % (16 / sizeof(T)) == 0 and 16-byte aligned
// pointers (the wrapper checks both).
int tempo_gn_apply(const void* x, const void* stats, const void* scale,
                   const void* bias, void* out, int dtype, int b, int hw,
                   int c, int act, int vectorized, void* stream) {
  auto s = static_cast<cudaStream_t>(stream);
  if (dtype == tempo::DT_BF16) {
    if (vectorized)
      tempo::launch_apply<__nv_bfloat16, 8>(x, stats, scale, bias, out, b,
                                            hw, c, act, s);
    else
      tempo::launch_apply<__nv_bfloat16, 1>(x, stats, scale, bias, out, b,
                                            hw, c, act, s);
  } else {
    if (vectorized)
      tempo::launch_apply<float, 4>(x, stats, scale, bias, out, b, hw, c,
                                    act, s);
    else
      tempo::launch_apply<float, 1>(x, stats, scale, bias, out, b, hw, c,
                                    act, s);
  }
  return (int)cudaGetLastError();
}

}  // extern "C"

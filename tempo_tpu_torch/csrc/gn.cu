// K1: GroupNorm statistics (K1a) and GroupNorm + activation apply (K1b),
// NHWC.
//
// Replaces tempo_tpu/ops/pallas_gn.py: _stats_kernel (K1a) and
// _apply_kernel (K1b).
//
// What bounds them on the H100: bytes. K1a reads x once (2 B an element in
// bf16) and does two FMAs an element; K1b reads x once and writes it once.
// At 3.35 TB/s a granule's [1,128,2048,512] bf16 activation (268 MB) takes
// 80 us to read. A lone small call is bound by its launch (~5 us).
//
// K1a, one launch. The TPU kernel walked one sample per grid step and
// carried the sums through VMEM; blocks on Hopper run in no order, so:
// - The work is split by sample only: a sample's rows are cut into
//   `gridDim.x` ranges of `rows_per_block` rows, chosen by the wrapper from
//   (HW, C, dtype) alone (cuda_gn.choose_stats_split), never from B. A
//   sample's statistics are therefore bitwise the same alone and in a batch.
// - NHWC keeps a block's rows one contiguous range. Each thread owns one
//   fixed 16-byte channel pack (kThreads packs are a whole number of rows)
//   and streams it with kLoads 16-byte read-only loads in flight, summing x
//   and x^2 in fp32 registers; 4 blocks an SM keep ~64 KB in flight. A
//   bulk-copy ring in shared memory (cp.async.bulk on an mbarrier) was
//   measured beside it and was no faster (PERF.md §6). An unaligned x,
//   or a C that is not a whole number of packs dividing the block's pass,
//   takes the plain-load path of the same kernel.
// - Each block folds its channels into per-group sums in a fixed order (row
//   lanes in order, then one warp a group, a butterfly over its lanes),
//   as pallas_gn.py:79-101 does with its one-hot matmuls, and writes a
//   2 x G partial.
// - The last block of a sample to arrive, elected by one acq_rel atomic on
//   the sample's counter after the block's barrier (as decode.cu's splits
//   are), folds the sample's partials in block order (one warp a value, lane
//   l taking blocks l, l + 32, ..., then the butterfly), writes mean and rstd
//   as [2, C] and puts the counter back to 0. No sum is atomic: the result
//   is the same whatever order the blocks finish in. A sample of one block
//   skips the partials and the counter.
// - var = max(E[x^2] - E[x]^2, 0), rstd = rsqrt(var + eps), fp32 throughout.
// - The sums mode (SUMS, entry point tempo_gn_sums) is the same launch, split
//   and fold; the electing block writes the folded [Σx | Σx²] per group,
//   [2, G] a sample, where it would write mean and rstd. A caller that holds
//   a sample in pieces (spatial sharding: a granule split along W over
//   ranks) adds the pieces' sums and finishes mean and rstd with the same
//   formula (cuda_gn.stats_from_sums).
//
// K1b, one pass with its constants in registers. The grid is (row block,
// sample); each thread owns one fixed 16-byte channel pack, loads its mean,
// rstd, scale and bias once, then streams up to kApplyRows rows with
// 16-byte loads and stores, all in flight together (fewer rows a thread
// where the grid would not cover the card twice). (x - mean) * rstd first,
// then the affine and the activation. C not a whole number of packs, or an
// unaligned pointer, takes the same kernel with one-element packs.
#include <string.h>

#include <algorithm>

#include "common.cuh"

namespace tempo {

constexpr int kThreads = 256;      // threads a block, both kernels
constexpr int kLoads = 4;          // 16-byte loads a K1a thread has in flight
constexpr int kApplyRows = 4;      // rows a K1b thread has in flight, at most
constexpr int kApplyBlocks = 264;  // K1b grid below which a thread takes fewer
constexpr int kMaxChannels = 8192;  // K1a's per-channel fold in shared memory

template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

// A pack through the read-only path (16-byte ld.global.nc where it is one).
template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load_pack(const Pack<T, VEC>* p) {
  Pack<T, VEC> r;
  if constexpr (sizeof(Pack<T, VEC>) == 16) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    memcpy(&r, &u, 16);
  } else {
    r = *p;
  }
  return r;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One block of K1a: rows [r0, r0 + rows) of sample blockIdx.y. VECTOR
// loads 16-byte packs (needs C % VEC == 0, (kThreads * VEC) % C == 0 and x
// 16-byte aligned); otherwise one element at a time. SUMS writes the
// sample's group sums [2, G] to `stats` in place of mean and rstd [2, C].
template <typename T, bool VECTOR, bool SUMS>
__global__ void __launch_bounds__(kThreads, 4)
    gn_stats_kernel(const T* __restrict__ x, float* __restrict__ partial,
                    int* __restrict__ counters, float* __restrict__ stats,
                    int hw, int c, int groups, int rows_per_block,
                    float eps) {
  extern __shared__ __align__(16) float red[];
  __shared__ int last;
  constexpr int VEC = 16 / sizeof(T);
  const int tid = threadIdx.x;
  const int blk = blockIdx.x, n_blk = gridDim.x, b = blockIdx.y;
  const int r0 = blk * rows_per_block;
  const int rows = min(hw, r0 + rows_per_block) - r0;
  const T* xs = x + ((size_t)b * hw + r0) * c;
  // After the stream, red holds each thread's sums as [2][lanes][c] (Σx,
  // then Σx²): lane l, channel ch is row lane l's sum for channel ch.
  int lanes;
  if constexpr (VECTOR) {
    using P = Pack<T, VEC>;
    lanes = kThreads * VEC / c;
    const P* xp = reinterpret_cast<const P*>(xs);
    const int n_vec = rows * c / VEC;
    float s[VEC], q[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) s[j] = q[j] = 0.0f;
    // Thread tid's packs are tid, tid + kThreads, ... of the block's range:
    // all at element offset tid * VEC of a pass, channel (tid * VEC) % c.
    for (int v0 = tid; v0 < n_vec; v0 += kThreads * kLoads) {
      P p[kLoads];
#pragma unroll
      for (int u = 0; u < kLoads; ++u)
        if (v0 + u * kThreads < n_vec)
          p[u] = load_pack(xp + v0 + u * kThreads);
#pragma unroll
      for (int u = 0; u < kLoads; ++u) {
        if (v0 + u * kThreads < n_vec) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            const float f = to_f32(p[u].v[j]);
            s[j] += f;
            q[j] = fmaf(f, f, q[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      red[tid * VEC + j] = s[j];
      red[kThreads * VEC + tid * VEC + j] = q[j];
    }
  } else {
    const int tc = min(c, kThreads);
    lanes = kThreads / tc;
    const int lane = tid / tc, cl = tid % tc;
    if (lane < lanes) {
      for (int ch = cl; ch < c; ch += tc) {
        float s = 0.0f, q = 0.0f;
#pragma unroll 4
        for (int r = lane; r < rows; r += lanes) {
          const float f = to_f32(xs[(size_t)r * c + ch]);
          s += f;
          q = fmaf(f, f, q);
        }
        red[lane * c + ch] = s;
        red[lanes * c + lane * c + ch] = q;
      }
    }
  }
  __syncthreads();

  // Channel sums over the row lanes, in lane order, into lane 0's row.
  float* red_q = red + lanes * c;
  for (int ch = tid; ch < c; ch += kThreads) {
    float s = red[ch], q = red_q[ch];
    for (int l = 1; l < lanes; ++l) {
      s += red[l * c + ch];
      q += red_q[l * c + ch];
    }
    red[ch] = s;
    red_q[ch] = q;
  }
  __syncthreads();

  // Group sums, one warp a group: lane i takes channels i, i + 32, ... of
  // the group in order, then the butterfly. The block's partial is
  // [Σx per group, Σx² per group]; a sample of one block keeps it in res
  // (shared memory past the sums), which then holds [mean | rstd].
  const int warp = tid / 32, ln = tid % 32;
  const int cg = c / groups;
  const bool alone = n_blk == 1;
  float* res = red_q + lanes * c;
  float* part = alone ? res : partial + ((size_t)b * n_blk + blk) * 2 * groups;
  for (int g = warp; g < groups; g += kThreads / 32) {
    float s = 0.0f, q = 0.0f;
    for (int i = ln; i < cg; i += 32) {
      s += red[g * cg + i];
      q += red_q[g * cg + i];
    }
    s = warp_sum(s);
    q = warp_sum(q);
    if (ln == 0) {
      part[g] = s;
      part[groups + g] = q;
    }
  }

  if (!alone) {
    // The last block of the sample to arrive folds it. Its arrival is
    // counted by one acq_rel atomic after the block's barrier: release
    // orders the block's partial before it, acquire the other blocks'
    // partials before the fold's reads. The counter goes back to 0 for the
    // next call.
    __threadfence();
    __syncthreads();
    if (tid == 0) {
      int* count = counters + b;
      int ticket;
      asm volatile("atom.add.acq_rel.gpu.s32 %0, [%1], 1;\n"
                   : "=r"(ticket)
                   : "l"(count)
                   : "memory");
      last = ticket == n_blk - 1;
      if (last) *count = 0;
    }
    __syncthreads();
    if (!last) return;

    // Value j of the 2 x G partials summed over the sample's blocks in
    // block order: one warp a value, lane i taking blocks i, i + 32, ...,
    // then the butterfly.
    const float* psample = partial + (size_t)b * n_blk * 2 * groups;
    for (int j = warp; j < 2 * groups; j += kThreads / 32) {
      float v = 0.0f;
      for (int i = ln; i < n_blk; i += 32)
        v += __ldcg(psample + (size_t)i * 2 * groups + j);
      v = warp_sum(v);
      if (ln == 0) res[j] = v;
    }
  }
  __syncthreads();
  if constexpr (SUMS) {
    float* out = stats + (size_t)b * 2 * groups;
    for (int j = tid; j < 2 * groups; j += kThreads) out[j] = res[j];
    return;
  }
  const float denom = (float)((long long)hw * cg);
  for (int g = tid; g < groups; g += kThreads) {
    const float mean = res[g] / denom;
    const float var = fmaxf(res[groups + g] / denom - mean * mean, 0.0f);
    res[g] = mean;
    res[groups + g] = rsqrtf(var + eps);
  }
  __syncthreads();
  float* out = stats + (size_t)b * 2 * c;
  for (int ch = tid; ch < c; ch += kThreads) {
    const int g = ch / cg;
    out[ch] = res[g];
    out[c + ch] = res[groups + g];
  }
}

// Rows [blockIdx.x * rows_per_block, + rows_per_block) of sample
// blockIdx.y. Thread (lane, pack) = (tid / tc, tid % tc) with tc = min(C /
// VEC, kThreads) owns packs pack, pack + tc, ... and rows lane, lane +
// lanes, ... of the block; rows_per_block <= lanes * kApplyRows.
template <typename T, int VEC>
__global__ void __launch_bounds__(kThreads, 2)
    gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ stats,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, T* __restrict__ out,
                    int hw, int c, int act, int rows_per_block) {
  using P = Pack<T, VEC>;
  const int packs = c / VEC;
  const int tc = min(packs, kThreads), lanes = kThreads / tc;
  const int lane = threadIdx.x / tc, pc = threadIdx.x % tc;
  if (lane >= lanes) return;
  const int b = blockIdx.y;
  const int r0 = blockIdx.x * rows_per_block + lane;
  const int r1 = min(hw, (int)(blockIdx.x + 1) * rows_per_block);
  const float* mean_b = stats + (size_t)b * 2 * c;
  const float* rstd_b = mean_b + c;
  const P* xb = reinterpret_cast<const P*>(x + (size_t)b * hw * c);
  P* ob = reinterpret_cast<P*>(out + (size_t)b * hw * c);
  for (int p = pc; p < packs; p += tc) {
    float m[VEC], rs[VEC], sc[VEC], bi[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const int ch = p * VEC + j;
      m[j] = mean_b[ch];
      rs[j] = rstd_b[ch];
      sc[j] = scale[ch];
      bi[j] = bias[ch];
    }
    P in[kApplyRows];
#pragma unroll
    for (int u = 0; u < kApplyRows; ++u) {
      const int r = r0 + u * lanes;
      if (r < r1) in[u] = load_pack(xb + (size_t)r * packs + p);
    }
#pragma unroll
    for (int u = 0; u < kApplyRows; ++u) {
      const int r = r0 + u * lanes;
      if (r < r1) {
        P res;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float y = (to_f32(in[u].v[j]) - m[j]) * rs[j];
          res.v[j] = from_f32<T>(apply_act(fmaf(y, sc[j], bi[j]), act));
        }
        ob[(size_t)r * packs + p] = res;
      }
    }
  }
}

// Dynamic shared memory of a K1a block: the sums ([2][lanes][C] floats;
// lanes * C is kThreads * VEC on the vector path and <= max(C, kThreads) on
// the plain one) and the group results (2 G floats) past them.
template <typename T, bool VECTOR>
int stats_smem_bytes(int c, int groups) {
  const int tc = c < kThreads ? c : kThreads;
  const int lanes_c = VECTOR ? kThreads * (16 / (int)sizeof(T))
                             : (kThreads / tc) * c;
  return (2 * lanes_c + 2 * groups) * (int)sizeof(float);
}

// The opt-in to more than 48 KB of dynamic shared memory (static and
// dynamic together may not pass 48 KB without it) is made once per
// instantiation and device, for the most the instantiation can ask.
template <typename T, bool VECTOR, bool SUMS>
int launch_stats(const void* x, void* partial, void* counters, void* stats,
                 int b, int hw, int c, int groups, int blocks,
                 int rows_per_block, float eps, cudaStream_t stream) {
  static bool ready[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 64 || !ready[dev]) {
    err = cudaFuncSetAttribute(gn_stats_kernel<T, VECTOR, SUMS>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               stats_smem_bytes<T, VECTOR>(kMaxChannels,
                                                           kMaxChannels));
    if (err != cudaSuccess) return (int)err;
    if (dev < 64) ready[dev] = true;
  }
  const int smem = stats_smem_bytes<T, VECTOR>(c, groups);
  gn_stats_kernel<T, VECTOR, SUMS>
      <<<dim3(blocks, b), kThreads, smem, stream>>>(
      static_cast<const T*>(x), static_cast<float*>(partial),
      static_cast<int*>(counters), static_cast<float*>(stats), hw, c, groups,
      rows_per_block, eps);
  return (int)cudaGetLastError();
}

// K1a over (dtype, vectorized) for one mode.
template <bool SUMS>
int dispatch_stats(const void* x, void* partial, void* counters, void* out,
                   int dtype, int b, int hw, int c, int groups, int blocks,
                   int rows_per_block, int vectorized, float eps,
                   cudaStream_t s) {
  if (c > kMaxChannels) return (int)cudaErrorInvalidValue;
  if (dtype == DT_BF16)
    return vectorized
               ? launch_stats<__nv_bfloat16, true, SUMS>(
                     x, partial, counters, out, b, hw, c, groups, blocks,
                     rows_per_block, eps, s)
               : launch_stats<__nv_bfloat16, false, SUMS>(
                     x, partial, counters, out, b, hw, c, groups, blocks,
                     rows_per_block, eps, s);
  return vectorized ? launch_stats<float, true, SUMS>(
                          x, partial, counters, out, b, hw, c, groups,
                          blocks, rows_per_block, eps, s)
                    : launch_stats<float, false, SUMS>(
                          x, partial, counters, out, b, hw, c, groups,
                          blocks, rows_per_block, eps, s);
}

template <typename T, int VEC>
void launch_apply(const void* x, const void* stats, const void* scale,
                  const void* bias, void* out, int b, int hw, int c, int act,
                  cudaStream_t stream) {
  const int packs = c / VEC;
  const int lanes = kThreads / (packs < kThreads ? packs : kThreads);
  const long long lane_rows = ((long long)b * hw + lanes - 1) / lanes;
  const int rows = (int)std::min<long long>(
      kApplyRows, (lane_rows + kApplyBlocks - 1) / kApplyBlocks);
  const int rows_per_block = lanes * std::max(rows, 1);
  const dim3 grid((hw + rows_per_block - 1) / rows_per_block, b);
  gn_apply_kernel<T, VEC><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(stats),
      static_cast<const float*>(scale), static_cast<const float*>(bias),
      static_cast<T*>(out), hw, c, act, rows_per_block);
}

}  // namespace tempo

extern "C" {

// x [B, HW, C] (f32 or bf16) -> stats [B, 2, C] f32 (per-channel mean and
// rstd of the channel's group), one launch of a (blocks, B) grid.
// partial: scratch of B * blocks * 2 * groups floats; counters: B ints, zero
// before the call and zero after it. vectorized != 0 asserts C % (16 /
// sizeof(T)) == 0, (256 * 16 / sizeof(T)) % C == 0 and a 16-byte aligned x
// (the wrapper checks all three); C <= 8192.
int tempo_gn_stats(const void* x, void* partial, void* counters, void* stats,
                   int dtype, int b, int hw, int c, int groups, int blocks,
                   int rows_per_block, int vectorized, float eps,
                   void* stream) {
  return tempo::dispatch_stats<false>(
      x, partial, counters, stats, dtype, b, hw, c, groups, blocks,
      rows_per_block, vectorized, eps, static_cast<cudaStream_t>(stream));
}

// K1a's sums mode: x [B, HW, C] -> sums [B, 2, G] f32 (each group's Σx,
// then its Σx²), the same launch, split and fold as tempo_gn_stats.
int tempo_gn_sums(const void* x, void* partial, void* counters, void* sums,
                  int dtype, int b, int hw, int c, int groups, int blocks,
                  int rows_per_block, int vectorized, void* stream) {
  return tempo::dispatch_stats<true>(
      x, partial, counters, sums, dtype, b, hw, c, groups, blocks,
      rows_per_block, vectorized, 0.0f, static_cast<cudaStream_t>(stream));
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

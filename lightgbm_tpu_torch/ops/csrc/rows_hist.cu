// Single-leaf histogram over row-major rows for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel K4 of lightgbm_tpu/ops/histogram.py:
//   _hist_pallas_kernel (:94), launched at :136 by
//   build_histogram_rows_pallas (:118)
// It computes, for rows r of rows [S, F] (uint8 bin codes),
//   hist[f, b, c] = sum over r with rows[r, f] == b of gh[r, c] * mask[r]
// The leaf-wise engine calls it on the split leaf's gathered segment (the
// partitioned engine) or on all rows with a membership mask (the masked
// engine and the root).
//
// Design.  The Pallas kernel builds a [Fg, Bp, Rt] bin one-hot in VMEM and
// contracts it with gh on the MXU, because a TPU has no per-lane scatter.
// Hopper has shared-memory atomics: each block holds a (feature group x B
// x C) tile of 64-bit fixed-point cells in shared memory (28 features x
// 255 bins x 2 channels = 114 KB at the main path's shape, so one group),
// streams a contiguous range of rows into it, and flushes the non-zero
// cells to the int64 result with global atomics.  A float32 finish pass
// converts; the engines skip it and keep the int64 sums.
//
// Determinism and exactness.  As in wave_hist.cu, channel c is scaled by
// 2^(62 - E_c) with integer atomics, so the sums are order-free and
// bit-identical to the plain version (int64 index_add_ in
// ops/histogram.py).  The caller passes E: the engines pass one set per
// tree, taken from the whole tree's gh, so every histogram of a tree is on
// one grid and the parent minus the smaller child is exact.
//
// Bound on this card.  A call must read rows (S*F bytes), gh (4*C*S) and
// mask (4*S) once and write the histograms (4*F*B*C): at S = 2^20, F = 28
// that is 38 MB, about 11 us at 3.35 TB/s.  The kernel is bound instead by
// shared-memory atomics (one 64-bit atomic per row, feature and channel)
// and by the global flush of each block's tile; it is the simple first
// version.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxC = 4;
constexpr int kRowsPerBlock = 8192;  // rows one block streams (at least)

__device__ __forceinline__ long long to_fixed(float v, int e) {
  return __float2ll_rn(v * ldexpf(1.0f, 62 - e));
}

// grid (row chunks, feature groups)
__global__ void rows_hist_kernel(const uint8_t* __restrict__ rows,
                                 const float* __restrict__ gh,
                                 const float* __restrict__ mask,
                                 const int* __restrict__ exps, int S, int F,
                                 int B, int C, int FG, int rows_per_block,
                                 long long* __restrict__ acc) {
  extern __shared__ long long sm[];
  const int f0 = blockIdx.y * FG;
  const int fg = min(FG, F - f0);
  int e[kMaxC];
  for (int c = 0; c < C; ++c) e[c] = exps[c];
  const int len = fg * B * C;
  for (int i = threadIdx.x; i < len; i += blockDim.x) sm[i] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)S, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const float m = mask[r];
    if (m == 0.0f) continue;
    long long q[kMaxC];
    bool any = false;
    for (int c = 0; c < C; ++c) {
      // the mask folds into gh in float32, as in the plain version
      q[c] = to_fixed(__fmul_rn(gh[r * C + c], m), e[c]);
      any |= q[c] != 0;
    }
    if (!any) continue;
    const uint8_t* row = rows + r * F + f0;
    for (int fl = 0; fl < fg; ++fl) {
      int b = row[fl];
      if (b >= B) continue;
      long long* cell = sm + ((long long)fl * B + b) * C;
      for (int c = 0; c < C; ++c)
        if (q[c] != 0)
          atomicAdd(reinterpret_cast<unsigned long long*>(cell + c),
                    static_cast<unsigned long long>(q[c]));
    }
  }
  __syncthreads();
  long long* out = acc + (long long)f0 * B * C;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    long long v = sm[i];
    if (v != 0)
      atomicAdd(reinterpret_cast<unsigned long long*>(out + i),
                static_cast<unsigned long long>(v));
  }
}

__global__ void finish_kernel(const long long* __restrict__ acc,
                              const int* __restrict__ exps, long long total,
                              int C, float* __restrict__ hist) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    double inv = ldexp(1.0, exps[(int)(i % C)] - 62);
    hist[i] = (float)((double)acc[i] * inv);
  }
}

}  // namespace

extern "C" {

// K4.  rows: uint8 [S, F]; gh: float32 [S, C]; mask: float32 [S]; exps:
// int32 [C] (device); acc: int64 [F*B*C].  FG features per block (the
// wrapper sizes it to shared memory).  With hist == NULL the int64 sums
// are the result.
int rows_hist_f32(const void* rows, const void* gh, const void* mask,
                  const void* exps, int S, int F, int B, int C, int FG,
                  void* acc, void* hist, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (C < 1 || C > kMaxC || FG < 1) return (int)cudaErrorInvalidValue;
  const long long total = (long long)F * B * C;
  cudaMemsetAsync(acc, 0, sizeof(long long) * total, stream);
  size_t smem = sizeof(long long) * (size_t)FG * B * C;
  cudaError_t err = cudaFuncSetAttribute(
      rows_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int groups = (F + FG - 1) / FG;
  int chunks = std::max(1, std::min(132 * 2 / groups,
                                    (S + kRowsPerBlock - 1) / kRowsPerBlock));
  int rows_per_block = (S + chunks - 1) / chunks;
  dim3 grid(chunks, groups);
  rows_hist_kernel<<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)rows, (const float*)gh, (const float*)mask,
      (const int*)exps, S, F, B, C, FG, rows_per_block, (long long*)acc);
  err = cudaGetLastError();
  if (err != cudaSuccess || hist == nullptr) return (int)err;
  long long g = std::min((total + kThreads - 1) / kThreads, 132LL * 16);
  finish_kernel<<<(int)std::max(g, 1LL), kThreads, 0, stream>>>(
      (const long long*)acc, (const int*)exps, total, C, (float*)hist);
  return (int)cudaGetLastError();
}

}  // extern "C"

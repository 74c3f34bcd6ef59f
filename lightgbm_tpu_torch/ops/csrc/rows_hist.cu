// Single-leaf histogram over row-major rows for Hopper (sm_90a), plain C
// interface.
//
// Replaces the TPU kernel K4 of lightgbm_tpu/ops/histogram.py:
//   _hist_pallas_kernel (:94), launched at :136 by
//   build_histogram_rows_pallas (:118)
// It computes, for rows r of rows [S, F] (uint8 bin codes, or uint16 ones
// where a column has more than 256 bins: the kernel is templated on the
// code type),
//   hist[f, b, c] = sum over r with rows[r, f] == b of gh[r, c] * mask[r]
// The leaf-wise engine calls it on the split leaf's gathered segment (the
// partitioned engine) or on all rows with a membership mask (the masked
// engine and the root).
//
// Design.  The Pallas kernel builds a [Fg, Bp, Rt] bin one-hot in VMEM and
// contracts it with gh on the MXU, because a TPU has no per-lane scatter.
// Hopper has shared-memory atomics: each block holds a (feature group x B
// x C) tile of 64-bit fixed-point cells in shared memory, adds a range of
// rows into it, and flushes the non-zero cells to the int64 result.  The
// grid follows the segment: the wrapper's planner (rows_plan in
// ops/histogram.py) picks small feature groups (about 28 KB tiles, several
// blocks per SM) and row chunks of a few hundred to a few thousand rows,
// so a 4,096-row segment spreads over tens of blocks and a 2^20-row one
// over hundreds.  With one row chunk a block owns its cells and stores
// them all (no memset, no atomics); with more it adds its non-zero cells
// with 64-bit global atomics into a zeroed result.  A float32 finish pass
// converts; the engines skip it and keep the int64 sums.  Where one
// feature's B x C cells exceed a block's shared memory (above about
// 14,500 bins), the planner cuts the bin axis into windows of Bw bins
// (bin_window in ops/histogram.py): the grid's second axis then walks
// (feature group, window) pairs and a block skips the codes outside its
// window.
//
// Hot cells.  The rows of a small leaf share the bins of the features
// split above it, so many lanes add to one cell.  Each 64-bit add is two
// native 32-bit shared atomics (below), not the compare-and-swap loop a
// 64-bit shared atomicAdd compiles to, so a hot cell serializes single
// atomic instructions rather than retried loops.
//
// Determinism and exactness.  As in wave_hist.cu, channel c is scaled by
// 2^(62 - E_c) with integer atomics, so the sums are order-free and
// bit-identical to the plain version (int64 index_add_ in
// ops/histogram.py).  The caller passes E: the
// engines pass one set per tree, taken from the whole tree's gh, so every
// histogram of a tree is on one grid and the parent minus the smaller
// child is exact.
//
// Bound on this card.  A call must read rows (S*F code bytes), gh (4*C*S) and
// mask (4*S) once and write the histograms (4*F*B*C): at S = 2^20, F = 28
// that is 38 MB, about 11 us at 3.35 TB/s.  The kernel is bound instead by
// shared-memory atomics (one 64-bit add per masked row, feature and
// channel); at small S by the launch and the per-block tile.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxC = 4;
constexpr int kTileFeatures = 8;  // most features of one block

// grid (row chunks, feature groups x bin windows of Bw bins).
template <typename T>
__global__ void __launch_bounds__(kThreads)
rows_hist_kernel(const T* __restrict__ rows,
                 const float* __restrict__ gh,
                 const float* __restrict__ mask,
                 const int* __restrict__ exps, int S, int F, int B, int Bw,
                 int C, int FG, int rows_per_block,
                 long long* __restrict__ acc) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  unsigned long long* tile = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned* tile32 = reinterpret_cast<unsigned*>(smem_raw);
  const int Wn = (B + Bw - 1) / Bw;
  const int g = blockIdx.y / Wn, w = blockIdx.y - g * Wn;
  const int f0 = g * FG;
  const int fg = min(FG, F - f0);
  const int b0 = w * Bw, bw = min(Bw, B - b0), bwc = bw * C;
  int e[kMaxC];
#pragma unroll
  for (int c = 0; c < kMaxC; ++c) e[c] = c < C ? exps[c] : 0;
  const int len = fg * bwc;
  for (int i = threadIdx.x; i < len; i += blockDim.x) tile[i] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rows_per_block;
  const long long r1 = min((long long)S, r0 + rows_per_block);
  for (long long r = r0 + threadIdx.x; r < r1; r += blockDim.x) {
    const float m = mask[r];
    if (m == 0.0f) continue;
    long long q[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c)
      // the mask folds into gh in float32, as in the plain version
      q[c] = c < C ? to_fixed(__fmul_rn(gh[r * C + c], m), e[c]) : 0;
    const T* row = rows + r * F + f0;
#pragma unroll
    for (int fl = 0; fl < kTileFeatures; ++fl) {
      if (fl >= fg) break;
      const int bin = (int)row[fl] - b0;
      if ((unsigned)bin >= (unsigned)bw) continue;
      unsigned* cell = tile32 + 2 * ((fl * bw + bin) * C);
#pragma unroll
      for (int c = 0; c < kMaxC; ++c)
        if (c < C && q[c] != 0) add_pair(cell + 2 * c, q[c]);
    }
  }
  __syncthreads();
  // cell i = (fl * bw + b) * C + c of feature f0 + fl, bin b0 + b
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const int fl = i / bwc;
    long long* out =
        acc + ((long long)(f0 + fl) * B + b0) * C + (i - fl * bwc);
    if (gridDim.x == 1) {
      *out = (long long)tile[i];
    } else {
      const unsigned long long v = tile[i];
      if (v != 0) atomicAdd(reinterpret_cast<unsigned long long*>(out), v);
    }
  }
}

// One code type's launch: the block's dynamic shared memory set once per
// instantiation (the largest size asked for so far).
template <typename T>
cudaError_t launch_rows(const void* rows, const void* gh, const void* mask,
                        const void* exps, int S, int F, int B, int Bw, int C,
                        int FG, int rows_per_block, dim3 grid, size_t smem,
                        long long* acc, cudaStream_t stream) {
  static int smem_set = 48 * 1024;
  if ((int)smem > smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        rows_hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return err;
    smem_set = (int)smem;
  }
  rows_hist_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const T*)rows, (const float*)gh, (const float*)mask, (const int*)exps,
      S, F, B, Bw, C, FG, rows_per_block, acc);
  return cudaGetLastError();
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

// K4.  rows: [S, F] codes of code_bytes bytes (1: uint8, 2: uint16);
// gh: float32 [S, C]; mask: float32 [S]; exps: int32 [C] (device); acc:
// int64 [F*B*C].  Bw bins per window, FG (<= kTileFeatures) features and
// rows_per_block rows per block (the wrapper's planner).  With hist ==
// NULL the int64 sums are the result.
int rows_hist_f32(const void* rows, const void* gh, const void* mask,
                  const void* exps, int S, int F, int B, int C,
                  int code_bytes, int Bw, int FG, int rows_per_block,
                  void* acc, void* hist, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (C < 1 || C > kMaxC || FG < 1 || FG > kTileFeatures ||
      rows_per_block < 1 || S < 1 || B < 1 || B > 65536 || Bw < 1 ||
      Bw > B || (code_bytes != 1 && code_bytes != 2))
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)F * B * C;
  const int groups = (F + FG - 1) / FG, windows = (B + Bw - 1) / Bw;
  const int chunks = (S + rows_per_block - 1) / rows_per_block;
  if (chunks > 1)
    cudaMemsetAsync(acc, 0, sizeof(long long) * total, stream);
  const size_t smem = sizeof(long long) * (size_t)FG * Bw * C;
  dim3 grid(chunks, groups * windows);
  cudaError_t err =
      code_bytes == 2
          ? launch_rows<uint16_t>(rows, gh, mask, exps, S, F, B, Bw, C, FG,
                                  rows_per_block, grid, smem,
                                  (long long*)acc, stream)
          : launch_rows<uint8_t>(rows, gh, mask, exps, S, F, B, Bw, C, FG,
                                 rows_per_block, grid, smem, (long long*)acc,
                                 stream);
  if (err != cudaSuccess || hist == nullptr) return (int)err;
  long long g = std::min((total + kThreads - 1) / kThreads, 132LL * 16);
  finish_kernel<<<(int)std::max(g, 1LL), kThreads, 0, stream>>>(
      (const long long*)acc, (const int*)exps, total, C, (float*)hist);
  return (int)cudaGetLastError();
}

}  // extern "C"

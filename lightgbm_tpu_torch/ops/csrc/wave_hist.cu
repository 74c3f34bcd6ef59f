// Multi-leaf wave histograms for Hopper (sm_90a), plain C interface.
//
// Replaces the TPU kernels of lightgbm_tpu/ops/histogram.py:
//   K1  _wave_kernel (fp32 mode), reached through build_histogram_wave
//   K2  _wave_kernel (int8 mode, histogram.py:462-469 and :517-520),
//       reached through build_histogram_wave(quant_bins, quant_scales)
//   K3  _wave_kernel_hl, reached through build_histogram_wave_hl
// All compute, for rows r with slot[r] == s and bin[f, r] == b,
//   hist[s, f, b, c] = sum gh[r, c]   (c < C)      counts[s] = sum gh[r, C]
// where slots outside [0, num_slots) match nothing (the sentinel).
//
// Design.  The Pallas kernels build bin one-hots and contract them on the
// MXU because a TPU has no per-lane scatter.  Hopper has shared-memory
// atomics, so each block privatizes a tile of histograms in shared memory
// (the shape of the reference's cuda_histogram_constructor.cu:18-230),
// streams its share of the rows, and adds the tile to the device result.
//
// Determinism.  K1 and K3 accumulate every value as 64-bit fixed point
// with integer atomics, so the result does not depend on the order in
// which threads and blocks add.  Channel c uses the scale 2^(62 - E_c),
// where 2^E_c bounds max|gh[:, c]| * n; the caller passes E (one set per
// tree in the engines, so sibling subtraction of the int64 sums is exact),
// so no partial sum can overflow.  The optional finishing pass converts to
// float32; without it the caller gets the int64 sums.  K2 recovers the
// quantized integers k = rint(gh / scale) (float32 division, as the plain
// version and the JAX package do) and sums them exactly in int32: the
// caller's gate n * quant_bins < 2^31 rules out overflow.  Its cells are 4
// bytes, so a block holds twice K1's (slot, feature) histograms.  Its
// finish pass is float32(int_sum) * scale.  The plain PyTorch versions in
// ops/histogram.py repeat this arithmetic with int64 index_add_, so kernel
// and plain version agree bit for bit.
//
// Bound on this card.  Each call must read binned (F*n bytes; K3 reads the
// row-major copy), slot (4n) and gh (4(C+1)n) once and write the float32
// histograms: 44 MB at the main path's n = 2^20, F = 28, about 13 us at
// 3.35 TB/s.  In practice the kernels are bound by shared-memory atomic
// throughput (one 64-bit atomic per computed row, feature and channel)
// and, in K1, by re-reading slot and gh once per (slot group, feature
// group) tile, which mostly hits the 50 MB L2.  K3 holds every computed
// slot of a feature group in one block, so it reads each row once per
// feature group.  Making either faster is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 512;
constexpr int kMaxC = 4;  // gh channels accumulated per bin (the wave engine uses 2)

// v * 2^(62 - e) rounded half to even (the plain version's torch.round);
// the scale is an exact power of two, so the product is exact.
__device__ __forceinline__ long long to_fixed(float v, int e) {
  return __float2ll_rn(v * ldexpf(1.0f, 62 - e));
}

// The quantized integer of a grid-snapped value: rint(v / scale).
__device__ __forceinline__ int to_quant(float v, float scale) {
  return (int)rintf(__fdiv_rn(v, scale));
}

// Cell adds: 64-bit fixed point (K1, K3) or int32 quantized sums (K2).
__device__ __forceinline__ void cell_add(long long* p, long long v) {
  atomicAdd(reinterpret_cast<unsigned long long*>(p),
            static_cast<unsigned long long>(v));
}
__device__ __forceinline__ void cell_add(int* p, int v) { atomicAdd(p, v); }

// Shared-memory tile: [SG slots][FG features][B bins][C] cells, then SG
// slot counts.
struct Tile {
  int s0, SG, f0, FG;
};

template <typename T>
__device__ __forceinline__ void zero_smem(T* sm, int len) {
  for (int i = threadIdx.x; i < len; i += blockDim.x) sm[i] = 0;
}

template <typename T>
__device__ __forceinline__ void flush_tile(const T* sm, const Tile& t, int F,
                                           int B, int C, bool counts,
                                           T* __restrict__ acc,
                                           T* __restrict__ cnt_acc) {
  const int per_slot = t.FG * B * C;
  const int len = t.SG * per_slot;
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    T v = sm[i];
    if (v == 0) continue;
    int s = i / per_slot;
    int rem = i - s * per_slot;           // (f_local * B + b) * C + c
    int fl = rem / (B * C);
    int bc = rem - fl * (B * C);
    long long g = (((long long)(t.s0 + s) * F + (t.f0 + fl)) * B) * C + bc;
    cell_add(acc + g, v);
  }
  if (counts) {
    for (int s = threadIdx.x; s < t.SG; s += blockDim.x) {
      T v = sm[len + s];
      if (v != 0) cell_add(cnt_acc + t.s0 + s, v);
    }
  }
}

// Per-row accumulands: 64-bit fixed point with exponents e (K1, K3), or
// the quantized integers of K2 (scales sc), whose count cell is 1 per row
// with a positive mask.
template <typename T>
struct Quantizer;
template <>
struct Quantizer<long long> {
  int e[kMaxC + 1];
  __device__ Quantizer(const int* exps, const float*, int C) {
    for (int c = 0; c <= C; ++c) e[c] = exps[c];
  }
  __device__ __forceinline__ long long value(float v, int c) const {
    return to_fixed(v, e[c]);
  }
  __device__ __forceinline__ long long count(float m, int C) const {
    return to_fixed(m, e[C]);
  }
};
template <>
struct Quantizer<int> {
  float sc[kMaxC];
  __device__ Quantizer(const int*, const float* scales, int C) {
    for (int c = 0; c < C; ++c) sc[c] = scales[c];
  }
  __device__ __forceinline__ int value(float v, int c) const {
    return to_quant(v, sc[c]);
  }
  __device__ __forceinline__ int count(float m, int) const {
    return m > 0.0f ? 1 : 0;
  }
};

// K1 (T = int64) and K2 (T = int32): grid (row chunks, slot groups *
// feature groups).  Feature-major bins.
template <typename T>
__global__ void wave_hist_kernel(const uint8_t* __restrict__ binned_fm,
                                 const int* __restrict__ slot,
                                 const float* __restrict__ gh,
                                 const int* __restrict__ exps,
                                 const float* __restrict__ scales, int n,
                                 int F, int B, int C, int NL, int SG, int FG,
                                 int rows_per_block, T* __restrict__ acc,
                                 T* __restrict__ cnt_acc) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  T* sm = reinterpret_cast<T*>(smem_raw);
  const int n_fg = (F + FG - 1) / FG;
  Tile t;
  t.s0 = (blockIdx.y / n_fg) * SG;
  t.f0 = (blockIdx.y % n_fg) * FG;
  t.SG = min(SG, NL - t.s0);
  t.FG = min(FG, F - t.f0);
  const bool counts = (t.f0 == 0);
  const int C1 = C + 1;
  const Quantizer<T> quant(exps, scales, C);
  const int len = t.SG * t.FG * B * C;
  zero_smem(sm, len + t.SG);
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 = min((long long)n, row0 + rows_per_block);
  for (long long r = row0 + threadIdx.x; r < row1; r += blockDim.x) {
    int s = slot[r] - t.s0;
    if (s < 0 || s >= t.SG) continue;
    T q[kMaxC];
    for (int c = 0; c < C; ++c) q[c] = quant.value(gh[r * C1 + c], c);
    T* base = sm + (long long)s * t.FG * B * C;
    for (int fl = 0; fl < t.FG; ++fl) {
      int b = binned_fm[(long long)(t.f0 + fl) * n + r];
      if (b >= B) continue;
      T* cell = base + ((long long)fl * B + b) * C;
      for (int c = 0; c < C; ++c)
        if (q[c] != 0) cell_add(cell + c, q[c]);
    }
    if (counts) {
      T qm = quant.count(gh[r * C1 + C], C);
      if (qm != 0) cell_add(sm + len + s, qm);
    }
  }
  __syncthreads();
  flush_tile(sm, t, F, B, C, counts, acc, cnt_acc);
}

// K3: grid (row chunks, feature groups); every computed slot [0, S) of the
// feature group lives in the block's tile.  Row-major bins.
__global__ void wave_hist_hl_kernel(const uint8_t* __restrict__ binned_rm,
                                    const int* __restrict__ slot,
                                    const float* __restrict__ gh,
                                    const int* __restrict__ exps, int n,
                                    int F, int B, int C, int S, int FG,
                                    int rows_per_block,
                                    long long* __restrict__ acc,
                                    long long* __restrict__ cnt_acc) {
  extern __shared__ long long sm[];
  Tile t;
  t.s0 = 0;
  t.SG = S;
  t.f0 = blockIdx.y * FG;
  t.FG = min(FG, F - t.f0);
  const bool counts = (t.f0 == 0);
  const int C1 = C + 1;
  const Quantizer<long long> quant(exps, nullptr, C);
  const int len = S * t.FG * B * C;
  zero_smem(sm, len + S);
  __syncthreads();
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 = min((long long)n, row0 + rows_per_block);
  for (long long r = row0 + threadIdx.x; r < row1; r += blockDim.x) {
    int s = slot[r];
    if (s < 0 || s >= S) continue;
    long long q[kMaxC];
    for (int c = 0; c < C; ++c) q[c] = quant.value(gh[r * C1 + c], c);
    long long* base = sm + (long long)s * t.FG * B * C;
    const uint8_t* row = binned_rm + r * F + t.f0;
    for (int fl = 0; fl < t.FG; ++fl) {
      int b = row[fl];
      if (b >= B) continue;
      long long* cell = base + ((long long)fl * B + b) * C;
      for (int c = 0; c < C; ++c)
        if (q[c] != 0) cell_add(cell + c, q[c]);
    }
    if (counts) {
      long long qm = quant.count(gh[r * C1 + C], C);
      if (qm != 0) cell_add(sm + len + s, qm);
    }
  }
  __syncthreads();
  flush_tile(sm, t, F, B, C, counts, acc, cnt_acc);
}

// Fixed point -> float32: hist [out_slots, F, B, C] and counts [out_slots]
// (acc and cnt_acc hold out_slots zero-initialized slots).
__global__ void finish_fixed_kernel(const long long* __restrict__ acc,
                                    const long long* __restrict__ cnt_acc,
                                    const int* __restrict__ exps, int F,
                                    int B, int C, int out_slots,
                                    float* __restrict__ hist,
                                    float* __restrict__ counts) {
  const long long total = (long long)out_slots * F * B * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total + out_slots; i += (long long)gridDim.x * blockDim.x) {
    if (i < total) {
      double inv = ldexp(1.0, exps[(int)(i % C)] - 62);
      hist[i] = (float)((double)acc[i] * inv);
    } else {
      long long s = i - total;
      counts[s] = (float)((double)cnt_acc[s] * ldexp(1.0, exps[C] - 62));
    }
  }
}

// K2's dequantization: float32(int_sum) * scale, counts as float32.
__global__ void finish_quant_kernel(const int* __restrict__ acc,
                                    const int* __restrict__ cnt_acc,
                                    const float* __restrict__ scales, int F,
                                    int B, int C, int NL,
                                    float* __restrict__ hist,
                                    float* __restrict__ counts) {
  const long long total = (long long)NL * F * B * C;
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       i < total + NL; i += (long long)gridDim.x * blockDim.x) {
    if (i < total)
      hist[i] = __fmul_rn((float)acc[i], scales[(int)(i % C)]);
    else
      counts[i - total] = (float)cnt_acc[i - total];
  }
}

int grid_for(long long work) {
  long long g = (work + kThreads - 1) / kThreads;
  return (int)std::min(std::max(g, 1LL), 132LL * 16);
}

int row_blocks(int n, int tiles) {
  // enough blocks to fill the card's 132 SMs about twice over
  int chunks = (2 * 132 + tiles - 1) / tiles;
  chunks = std::max(1, std::min(chunks, (n + kThreads - 1) / kThreads));
  return chunks;
}

template <typename T>
cudaError_t launch_wave(const void* binned_fm, const void* slot,
                        const void* gh, const int* exps, const float* scales,
                        int n, int F, int B, int C, int NL, int SG, int FG,
                        T* acc, T* cnt_acc, cudaStream_t stream) {
  long long acc_len = (long long)NL * F * B * C;
  cudaMemsetAsync(acc, 0, sizeof(T) * acc_len, stream);
  cudaMemsetAsync(cnt_acc, 0, sizeof(T) * NL, stream);
  size_t smem = sizeof(T) * ((size_t)SG * FG * B * C + SG);
  cudaError_t err = cudaFuncSetAttribute(
      wave_hist_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int tiles = ((NL + SG - 1) / SG) * ((F + FG - 1) / FG);
  int chunks = row_blocks(n, tiles);
  int rows_per_block = (n + chunks - 1) / chunks;
  dim3 grid(chunks, tiles);
  wave_hist_kernel<T><<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)binned_fm, (const int*)slot, (const float*)gh, exps,
      scales, n, F, B, C, NL, SG, FG, rows_per_block, acc, cnt_acc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// K1.  exps: int32 [C+1] (device); acc: int64 [NL*F*B*C]; cnt_acc: int64
// [NL].  With hist == NULL the int64 sums are the result.
int wave_hist_f32(const void* binned_fm, const void* slot, const void* gh,
                  const void* exps, int n, int F, int B, int C, int NL,
                  int SG, int FG, void* acc, void* cnt_acc, void* hist,
                  void* counts, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_wave<long long>(
      binned_fm, slot, gh, (const int*)exps, nullptr, n, F, B, C, NL, SG, FG,
      (long long*)acc, (long long*)cnt_acc, stream);
  if (err != cudaSuccess || hist == nullptr) return (int)err;
  long long acc_len = (long long)NL * F * B * C;
  finish_fixed_kernel<<<grid_for(acc_len + NL), kThreads, 0, stream>>>(
      (const long long*)acc, (const long long*)cnt_acc, (const int*)exps, F,
      B, C, NL, (float*)hist, (float*)counts);
  return (int)cudaGetLastError();
}

// K2.  scales: float32 [C] (device); acc: int32 [NL*F*B*C]; cnt_acc: int32
// [NL].  With hist == NULL the int32 sums are the result.
int wave_hist_i32(const void* binned_fm, const void* slot, const void* gh,
                  const void* scales, int n, int F, int B, int C, int NL,
                  int SG, int FG, void* acc, void* cnt_acc, void* hist,
                  void* counts, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  cudaError_t err = launch_wave<int>(
      binned_fm, slot, gh, nullptr, (const float*)scales, n, F, B, C, NL, SG,
      FG, (int*)acc, (int*)cnt_acc, stream);
  if (err != cudaSuccess || hist == nullptr) return (int)err;
  long long acc_len = (long long)NL * F * B * C;
  finish_quant_kernel<<<grid_for(acc_len + NL), kThreads, 0, stream>>>(
      (const int*)acc, (const int*)cnt_acc, (const float*)scales, F, B, C, NL,
      (float*)hist, (float*)counts);
  return (int)cudaGetLastError();
}

// K3.  acc: int64 [out_slots*F*B*C], cnt_acc: int64 [out_slots]; slots
// past S stay 0 (the zero padding).  With hist == NULL the int64 sums are
// the result.
int wave_hist_hl_f32(const void* binned_rm, const void* slot, const void* gh,
                     const void* exps, int n, int F, int B, int C, int S,
                     int out_slots, int FG, void* acc, void* cnt_acc,
                     void* hist, void* counts, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (C < 1 || C > kMaxC) return (int)cudaErrorInvalidValue;
  long long out_len = (long long)out_slots * F * B * C;
  cudaMemsetAsync(acc, 0, sizeof(long long) * out_len, stream);
  cudaMemsetAsync(cnt_acc, 0, sizeof(long long) * out_slots, stream);
  size_t smem = sizeof(long long) * ((size_t)S * FG * B * C + S);
  cudaError_t err = cudaFuncSetAttribute(
      wave_hist_hl_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  int tiles = (F + FG - 1) / FG;
  int chunks = row_blocks(n, tiles);
  int rows_per_block = (n + chunks - 1) / chunks;
  dim3 grid(chunks, tiles);
  wave_hist_hl_kernel<<<grid, kThreads, smem, stream>>>(
      (const uint8_t*)binned_rm, (const int*)slot, (const float*)gh,
      (const int*)exps, n, F, B, C, S, FG, rows_per_block, (long long*)acc,
      (long long*)cnt_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess || hist == nullptr) return (int)err;
  finish_fixed_kernel<<<grid_for(out_len + out_slots), kThreads, 0, stream>>>(
      (const long long*)acc, (const long long*)cnt_acc, (const int*)exps, F,
      B, C, out_slots, (float*)hist, (float*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"

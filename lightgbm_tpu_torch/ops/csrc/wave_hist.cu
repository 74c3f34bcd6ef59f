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
// adds its rows into it, and adds the tile to the device result.
//
// K1 is slot-partitioned.  A counting sort groups the computed rows by
// slot (count per warp chunk, scan, scatter); the scatter transposes each
// computed row's bins into a packed row-major copy and its gh into 64-bit
// fixed point, so every later read is contiguous.  A persistent grid then
// walks work items (slot, feature group, at most R rows of the slot), so
// each computed row is read once per feature group, whatever the number
// of slots, and uneven leaves split into even items.  K2 and K3 stream
// every row through (slot group x feature group) tiles: K2 reads each row
// once per tile, K3 (few slots, all in one tile) once per feature group.
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
// and plain version agree bit for bit.  K1's scatter ranks the rows of a
// warp by __match_any_sync, so the partition itself is deterministic too.
//
// Bound on this card.  Each call must read binned (F*n bytes; K3 reads the
// row-major copy), slot (4n) and gh (4(C+1)n) once and write the float32
// histograms: 44 MB at the main path's n = 2^20, F = 28, about 13 us at
// 3.35 TB/s.  In practice the kernels are bound by shared-memory atomic
// throughput (one 64-bit add per computed row, feature and channel).  A
// 64-bit shared atomicAdd compiles to a compare-and-swap loop on this
// card, so K1 adds each 64-bit value as two native 32-bit atomics, the
// high word taking the carry of the low one (exact modulo 2^64).

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kMaxC = 4;  // gh channels accumulated per bin (the wave engine uses 2)

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

// K2 (T = int32): grid (row chunks, slot groups * feature groups).
// Feature-major bins.
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

// ------------------------------------------------------------------ K1
// Pass 1-3 partition the computed rows by slot; pass 4 histograms them.
constexpr int kHistThreads = 256;
constexpr int kTileFeatures = 8;  // most features of one work item

// Partition walk.  A warp owns the rows [u * UR, (u + 1) * UR) of its unit
// u and walks them in steps of 128: each lane loads 4 consecutive rows
// with 16-byte (slot, gh) and 4-byte (bins of one feature) loads, and the
// warp ranks the step's rows in the fixed order (row within the lane's 4,
// lane): __match_any_sync groups the lanes of equal slots, and the
// group's leader advances the warp's per-slot counter in shared memory.

// Pass 1: rows of slot s in unit u -> cnt[s * U + u].
__global__ void slot_count_kernel(const int* __restrict__ slot, int n,
                                  int NL, int U, int UR,
                                  int* __restrict__ cnt) {
  extern __shared__ int sc[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* my = sc + w * NL;
  for (int i = lane; i < NL; i += 32) my[i] = 0;
  __syncwarp();
  const int u = blockIdx.x * (blockDim.x >> 5) + w;
  if (u >= U) return;
  const long long r0 = (long long)u * UR;
  const long long r1 = min((long long)n, r0 + UR);
  for (long long base = r0; base < r1; base += 128) {
    const long long r = base + 4 * lane;
    const int4 s4 = r < r1 ? *reinterpret_cast<const int4*>(slot + r)
                           : make_int4(-1, -1, -1, -1);
    const int sj[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool ok = sj[j] >= 0 && sj[j] < NL;
      const unsigned peers = __match_any_sync(0xffffffffu, ok ? sj[j] : -1);
      if (ok && __ffs(peers) - 1 == lane) my[sj[j]] += __popc(peers);
      __syncwarp();
    }
  }
  for (int i = lane; i < NL; i += 32) cnt[(long long)i * U + u] = my[i];
}

// Pass 2: one block per slot; cnt[s, :] becomes its exclusive scan over
// the units and tot[s] the slot's row count.
__global__ void slot_scan_kernel(int* __restrict__ cnt, int U,
                                 int* __restrict__ tot) {
  __shared__ int part[kHistThreads];
  int* col = cnt + (long long)blockIdx.x * U;
  const int per = (U + blockDim.x - 1) / blockDim.x;
  const int a = min(U, (int)threadIdx.x * per), b = min(U, a + per);
  int sum = 0;
  for (int i = a; i < b; ++i) sum += col[i];
  part[threadIdx.x] = sum;
  __syncthreads();
  if (threadIdx.x == 0) {
    int run = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) {
      int v = part[t];
      part[t] = run;
      run += v;
    }
    tot[blockIdx.x] = run;
  }
  __syncthreads();
  int run = part[threadIdx.x];
  for (int i = a; i < b; ++i) {
    int v = col[i];
    col[i] = run;
    run += v;
  }
}

// Pass 2b (one block): plan[0..NL] = exclusive scan of the slot counts
// (segment starts), plan[NL+1..2NL+1] = exclusive scan of the items per
// slot, ceil(count / R).
__global__ void slot_plan_kernel(const int* __restrict__ tot, int NL, int R,
                                 int* __restrict__ plan) {
  __shared__ int ps[kHistThreads], pc[kHistThreads];
  const int per = (NL + blockDim.x - 1) / blockDim.x;
  const int a = min(NL, (int)threadIdx.x * per), b = min(NL, a + per);
  int s1 = 0, s2 = 0;
  for (int i = a; i < b; ++i) {
    s1 += tot[i];
    s2 += (tot[i] + R - 1) / R;
  }
  ps[threadIdx.x] = s1;
  pc[threadIdx.x] = s2;
  __syncthreads();
  if (threadIdx.x == 0) {
    int r1 = 0, r2 = 0;
    for (int t = 0; t < (int)blockDim.x; ++t) {
      int v1 = ps[t], v2 = pc[t];
      ps[t] = r1;
      pc[t] = r2;
      r1 += v1;
      r2 += v2;
    }
    plan[NL] = r1;
    plan[2 * NL + 1] = r2;
  }
  __syncthreads();
  int r1 = ps[threadIdx.x], r2 = pc[threadIdx.x];
  for (int i = a; i < b; ++i) {
    plan[i] = r1;
    plan[NL + 1 + i] = r2;
    r1 += tot[i];
    r2 += (tot[i] + R - 1) / R;
  }
}

// Pass 3: the same walk as pass 1; each computed row goes to position
// start[s] + (rows of s in earlier units) + (its rank among the rows of s
// in this unit), as its packed bins rows_p[pos, :Fp] (row-major, Fp = F
// rounded up to 16, transposed from the feature-major input in registers
// with byte permutes) and its fixed-point gh q_p[pos, :QS] (QS = kC + 1
// rounded up to 2), each written as whole 16-byte stores.
template <int kC>
__global__ void slot_scatter_kernel(const uint8_t* __restrict__ binned_fm,
                                    const int* __restrict__ slot,
                                    const float* __restrict__ gh,
                                    const int* __restrict__ exps, int n,
                                    int F, int Fp, int QS, int NL, int U,
                                    int UR, const int* __restrict__ cnt,
                                    const int* __restrict__ plan,
                                    uint8_t* __restrict__ rows_p,
                                    long long* __restrict__ q_p) {
  extern __shared__ int sc[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* run = sc + w * NL;
  const int u = blockIdx.x * (blockDim.x >> 5) + w;
  if (u >= U) return;
  for (int i = lane; i < NL; i += 32)
    run[i] = plan[i] + cnt[(long long)i * U + u];
  __syncwarp();
  int e[kC + 1];
#pragma unroll
  for (int c = 0; c <= kC; ++c) e[c] = exps[c];
  const unsigned lt = (1u << lane) - 1u;
  const long long r0 = (long long)u * UR;
  const long long r1 = min((long long)n, r0 + UR);
  for (long long base = r0; base < r1; base += 128) {
    const long long r = base + 4 * lane;
    const bool in = r < r1;
    const int4 s4 = in ? *reinterpret_cast<const int4*>(slot + r)
                       : make_int4(-1, -1, -1, -1);
    const int sj[4] = {s4.x, s4.y, s4.z, s4.w};
    bool ok[4];
    long long pos[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      ok[j] = sj[j] >= 0 && sj[j] < NL;
      const unsigned peers = __match_any_sync(0xffffffffu, ok[j] ? sj[j] : -1);
      pos[j] = ok[j] ? run[sj[j]] + __popc(peers & lt) : 0;
      __syncwarp();
      if (ok[j] && __ffs(peers) - 1 == lane) run[sj[j]] += __popc(peers);
      __syncwarp();
    }
    if (!(ok[0] || ok[1] || ok[2] || ok[3])) continue;
    // bins: word k of a 16-feature chunk holds feature 16v + k of rows
    // r..r+3; row j's word q gathers byte j of words 4q..4q+3
    const unsigned* col = reinterpret_cast<const unsigned*>(binned_fm + r);
    const long long fstride = n >> 2;
    for (int v = 0; v < Fp / 16; ++v) {
      unsigned b[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int f = 16 * v + k;
        b[k] = f < F ? col[f * fstride] : 0u;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!ok[j]) continue;
        const unsigned sel = (unsigned)j | ((4u + j) << 4);
        unsigned wd[4];
#pragma unroll
        for (int k = 0; k < 4; ++k)
          wd[k] = __byte_perm(__byte_perm(b[4 * k], b[4 * k + 1], sel),
                              __byte_perm(b[4 * k + 2], b[4 * k + 3], sel),
                              0x5410);
        reinterpret_cast<uint4*>(rows_p + pos[j] * Fp)[v] =
            make_uint4(wd[0], wd[1], wd[2], wd[3]);
      }
    }
    // gh of rows r..r+3: 4 (kC + 1) floats, kC + 1 aligned float4 loads
    float gv[4 * (kC + 1)];
    const float4* g4 = reinterpret_cast<const float4*>(gh + r * (kC + 1));
#pragma unroll
    for (int c = 0; c <= kC; ++c) {
      const float4 t = g4[c];
      gv[4 * c] = t.x;
      gv[4 * c + 1] = t.y;
      gv[4 * c + 2] = t.z;
      gv[4 * c + 3] = t.w;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!ok[j]) continue;
      long long q[kC + 2];
#pragma unroll
      for (int c = 0; c < kC + 2; ++c)
        q[c] = c <= kC ? to_fixed(gv[j * (kC + 1) + c], e[c]) : 0;
      longlong2* qd = reinterpret_cast<longlong2*>(q_p + pos[j] * QS);
#pragma unroll
      for (int c = 0; c + 1 < kC + 2; c += 2)
        qd[c / 2] = make_longlong2(q[c], q[c + 1]);
    }
  }
}

// Pass 4: a persistent grid over the work items it = k * G + g (chunk k of
// the slot-grouped rows, feature group g).  Each block adds its item's
// rows into a (FG x B x C) tile plus the count cell, then flushes the
// non-zero cells: plain stores when the slot has one chunk (the block owns
// those cells alone), else 64-bit global atomics.  acc and cnt_acc start
// zeroed.
__global__ void __launch_bounds__(kHistThreads)
wave_part_hist_kernel(const uint8_t* __restrict__ rows_p,
                      const long long* __restrict__ q_p,
                      const int* __restrict__ plan, int NL, int F, int Fp,
                      int B, int C, int QS, int FG, int R,
                      long long* __restrict__ acc,
                      long long* __restrict__ cnt_acc) {
  extern __shared__ __align__(8) unsigned char smem_raw[];
  unsigned long long* tile = reinterpret_cast<unsigned long long*>(smem_raw);
  unsigned* tile32 = reinterpret_cast<unsigned*>(smem_raw);
  const int G = (F + FG - 1) / FG;
  const int* seg = plan;
  const int* chunk = plan + NL + 1;
  const long long items = (long long)chunk[NL] * G;
  const int full = FG * B * C;
  for (int i = threadIdx.x; i <= full; i += blockDim.x) tile[i] = 0;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int k = (int)(it / G), g = (int)(it % G);
    int lo = 0, hi = NL;  // the slot s with chunk[s] <= k < chunk[s + 1]
    while (hi - lo > 1) {
      int mid = (lo + hi) >> 1;
      if (chunk[mid] <= k) lo = mid; else hi = mid;
    }
    const int s = lo;
    const long long a = seg[s] + (long long)(k - chunk[s]) * R;
    const long long b = min((long long)seg[s + 1], a + R);
    const bool owner = chunk[s + 1] - chunk[s] == 1;
    const int f0 = g * FG, fg = min(FG, F - f0);
    const int len = fg * B * C;
    unsigned* cnt_cell = tile32 + 2 * full;
    __syncthreads();
    for (long long i = a + threadIdx.x; i < b; i += blockDim.x) {
      long long q[kMaxC];
      const long long* qi = q_p + i * QS;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) q[c] = c < C ? qi[c] : 0;
      const long long qc = g == 0 ? qi[C] : 0;  // the count column
      const uint8_t* row = rows_p + i * Fp + f0;
#pragma unroll
      for (int fl = 0; fl < kTileFeatures; ++fl) {
        if (fl >= fg) break;
        const int bin = row[fl];
        if (bin >= B) continue;
        unsigned* cell = tile32 + 2 * ((fl * B + bin) * C);
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < C && q[c] != 0) add_pair(cell + 2 * c, q[c]);
      }
      if (qc != 0) add_pair(cnt_cell, qc);
    }
    __syncthreads();
    long long* out = acc + ((long long)s * F + f0) * B * C;
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const unsigned long long v = tile[i];
      if (v == 0) continue;
      tile[i] = 0;
      if (owner) out[i] = (long long)v;
      else atomicAdd(reinterpret_cast<unsigned long long*>(out + i), v);
    }
    if (g == 0 && threadIdx.x == 0) {
      const unsigned long long v = tile[full];
      tile[full] = 0;
      if (v != 0) {
        if (owner) cnt_acc[s] = (long long)v;
        else atomicAdd(reinterpret_cast<unsigned long long*>(cnt_acc + s), v);
      }
    }
  }
}

// Dynamic shared memory above the default 48 KB, set once per function
// (the largest size asked for so far).
template <typename Fn>
cudaError_t ensure_smem(Fn* fn, size_t bytes, int* done) {
  if ((int)bytes <= *done || bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err == cudaSuccess) *done = (int)bytes;
  return err;
}

int sm_count() {
  static int sms = 0;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (sms <= 0) sms = 132;
  }
  return sms;
}

template <int kC>
cudaError_t launch_scatter(const void* binned_fm, const void* slot,
                           const void* gh, const void* exps, int n, int F,
                           int Fp, int QS, int NL, int U, int UR, int PW,
                           size_t smem, const int* cnt, const int* plan,
                           uint8_t* rows_p, long long* q_p, int* smem_set,
                           cudaStream_t stream) {
  cudaError_t err = ensure_smem(slot_scatter_kernel<kC>, smem, smem_set);
  if (err != cudaSuccess) return err;
  slot_scatter_kernel<kC><<<(U + PW - 1) / PW, 32 * PW, smem, stream>>>(
      (const uint8_t*)binned_fm, (const int*)slot, (const float*)gh,
      (const int*)exps, n, F, Fp, QS, NL, U, UR, cnt, plan, rows_p, q_p);
  return cudaGetLastError();
}

// Bytes of K1's scratch: the unit counts, slot totals and plan, then the
// packed rows and their fixed-point gh on 256-byte boundaries (the
// layout wave_hist_f32 carves; wave_part_plan in ops/histogram.py).
long long wave_part_scratch(int n, int F, int C, int NL, int UR) {
  const long long U = (n + UR - 1) / UR;
  const long long Fp = (F + 15) / 16 * 16, QS = (C + 2) / 2 * 2;
  const long long ints = (long long)NL * U + NL + 2 * (NL + 1);
  const long long head = (ints * 4 + 255) / 256 * 256;
  const long long rows = ((long long)n * Fp + 255) / 256 * 256;
  return head + rows + (long long)n * QS * 8;
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
// [NL]; UR rows per partition warp, PW warps per partition block, FG
// (<= kTileFeatures) features and at most R rows per work item (the
// wrapper's planner, wave_part_plan); scratch holds scratch_bytes (at
// least wave_part_scratch of the same arguments).  With
// hist == NULL the int64 sums are the result.
int wave_hist_f32(const void* binned_fm, const void* slot, const void* gh,
                  const void* exps, int n, int F, int B, int C, int NL,
                  int UR, int PW, int FG, int R, void* scratch,
                  long long scratch_bytes, void* acc, void* cnt_acc,
                  void* hist, void* counts, void* stream_ptr) {
  static int smem_count = 0, smem_scatter[kMaxC] = {0}, smem_hist = 0;
  static size_t occ_smem = 0;
  static int occ_blocks = 0;
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (C < 1 || C > kMaxC || UR < 128 || UR % 128 || n < 1 || n % 4 ||
      PW < 1 || PW > 32 || FG < 1 || FG > kTileFeatures || R < 1 || NL < 1)
    return (int)cudaErrorInvalidValue;
  if (scratch_bytes < wave_part_scratch(n, F, C, NL, UR))
    return (int)cudaErrorInvalidValue;
  const int U = (n + UR - 1) / UR;
  const int Fp = (F + 15) / 16 * 16, QS = (C + 2) / 2 * 2;
  int* cnt = (int*)scratch;
  int* tot = cnt + (long long)NL * U;
  int* plan = tot + NL;
  const long long ints = (long long)NL * U + NL + 2 * (NL + 1);
  // rows_p and q_p start on 256-byte boundaries, so each packed row (and
  // each row's gh, at Fp and 8 * QS bytes) fills whole 32-byte sectors
  uint8_t* rows_p = (uint8_t*)scratch + (ints * 4 + 255) / 256 * 256;
  long long* q_p =
      (long long*)(rows_p + ((long long)n * Fp + 255) / 256 * 256);
  const long long acc_len = (long long)NL * F * B * C;
  cudaMemsetAsync(acc, 0, sizeof(long long) * acc_len, stream);
  cudaMemsetAsync(cnt_acc, 0, sizeof(long long) * NL, stream);

  const size_t part_smem = sizeof(int) * (size_t)PW * NL;
  cudaError_t err = ensure_smem(slot_count_kernel, part_smem, &smem_count);
  if (err != cudaSuccess) return (int)err;
  const int part_blocks = (U + PW - 1) / PW;
  slot_count_kernel<<<part_blocks, 32 * PW, part_smem, stream>>>(
      (const int*)slot, n, NL, U, UR, cnt);
  slot_scan_kernel<<<NL, kHistThreads, 0, stream>>>(cnt, U, tot);
  slot_plan_kernel<<<1, kHistThreads, 0, stream>>>(tot, NL, R, plan);
  decltype(&launch_scatter<1>) const scatter[kMaxC] = {
      launch_scatter<1>, launch_scatter<2>, launch_scatter<3>,
      launch_scatter<4>};
  err = scatter[C - 1](binned_fm, slot, gh, exps, n, F, Fp, QS, NL, U, UR,
                       PW, part_smem, cnt, plan, rows_p, q_p,
                       &smem_scatter[C - 1], stream);
  if (err != cudaSuccess) return (int)err;

  const size_t hist_smem = sizeof(long long) * ((size_t)FG * B * C + 1);
  err = ensure_smem(wave_part_hist_kernel, hist_smem, &smem_hist);
  if (err != cudaSuccess) return (int)err;
  if (occ_smem != hist_smem) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &occ_blocks, wave_part_hist_kernel, kHistThreads, hist_smem);
    if (err != cudaSuccess) return (int)err;
    occ_smem = hist_smem;
  }
  const long long G = (F + FG - 1) / FG;
  const long long max_items = ((n + R - 1) / R + (long long)NL) * G;
  const int grid = (int)std::max(1LL, std::min(
      max_items, (long long)std::max(occ_blocks, 1) * sm_count()));
  wave_part_hist_kernel<<<grid, kHistThreads, hist_smem, stream>>>(
      rows_p, q_p, plan, NL, F, Fp, B, C, QS, FG, R, (long long*)acc,
      (long long*)cnt_acc);
  err = cudaGetLastError();
  if (err != cudaSuccess || hist == nullptr) return (int)err;
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

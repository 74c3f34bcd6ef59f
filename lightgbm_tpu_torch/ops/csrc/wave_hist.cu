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
// Design.  The Pallas kernels contract bin one-hots on the MXU because a
// TPU has no per-lane scatter.  Hopper has shared-memory atomics: each
// block adds its rows into a tile of histograms in shared memory (the
// shape of the reference's cuda_histogram_constructor.cu:18-230) and adds
// the tile's non-zero cells to the int64 device result.  Two pipelines,
// each templated on the tile's cell type:
// * Slot-partitioned (K1; K2 at many slots).  A counting sort groups the
//   computed rows by slot (count per warp chunk, scan, scatter) into a
//   packed row-major copy of their bins and their per-channel values; a
//   persistent grid then walks work items (slot, feature group, at most R
//   rows), so each computed row is read once per feature group whatever
//   the number of slots, and uneven leaves split into even items.
// * Streaming (K3; K2 at few slots).  Grid (row chunk x feature group),
//   every computed slot of the group's features in one tile.  A warp loads
//   128 consecutive rows a step: slots as one int4 a lane, 4 rows of one
//   feature's bins as one coalesced word a lane, gh as float4s; sentinel
//   rows cost their loads and no adds.  Tile budget (wave_few_plan in
//   ops/histogram.py): each extra feature group re-reads slot and gh (16
//   B a row, mostly from L2) and redoes the row's setup, each KB of tile
//   costs resident warps; two 512-thread blocks of half an SM each.
//
// Codes.  Every kernel is templated on the bin code type: uint8_t while
// every column has at most 256 bins, uint16_t up to 65,536 (the wrapper
// stores them as int16 bits), uint32_t above (int32 storage, codes below
// 2^31).  A streaming warp loads 4 rows of one feature as one word (4
// bytes of uint8 codes, 8 of uint16, 16 of uint32); the partition packs
// rows at Fp codes.  Bin windows: where one feature's
// (slots x B x C) cells exceed a block's shared memory, the wrapper's
// planner cuts the bin axis into windows of Bw bins (bin_window in
// ops/histogram.py); a work item or block then covers one window of one
// feature group and skips the codes outside it, which replaces the JAX
// kernel's Bg grid axis.  With one window (Bw = B, every width up to
// 14,500 bins in K1) the launches and the work are those of the narrow
// kernels.
//
// Cells.  FixedCells (K1, K3): 64-bit fixed point, channel c scaled by
// 2^(62 - E_c) with 2^E_c >= max|gh[:, c]| * n from the caller (one set
// per tree in the engines, so sibling subtraction is exact; no partial sum
// overflows).  A 64-bit shared atomicAdd compiles to a compare-and-swap
// loop here, so each add is two native 32-bit atomics (add_pair).
// IntCells (K2): k = rint(gh / scale) (float32 division, as the plain
// version and the JAX package) in int32 cells, one native atomic an add;
// a cell holds at most n * quant_bins < 2^31 (the caller's gate), and a
// tile twice the features.  Device results are int64 (native 64-bit
// global atomics), the form the engines' cache takes; the finish pass
// converts to float32 (sum * 2^(E - 62) via float64, or float32(sum) *
// scale).  Integer sums do not depend on the order of addition and the
// scatter ranks rows by __match_any_sync, so results repeat run to run and
// equal the plain versions' (int64 index_add_) bit for bit.
//
// Bound on this card.  A call must read binned (F*n bytes, twice that for
// 16-bit codes), slot (4n) and gh (4(C+1)n) once and write the float32
// histograms: 44 MB at n = 2^20, F = 28, 255 bins, about 13 us at 3.35
// TB/s.  The kernels are bound instead by
// shared-memory atomics and latency and, at many slots, by the scatter.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

#include "fixed_point.cuh"

namespace {

constexpr int kThreads = 512;      // finish passes
constexpr int kHistThreads = 256;  // histogram, scan and plan blocks
constexpr int kFewThreads = 512;   // streaming blocks, two to an SM
constexpr int kMaxC = 4;  // gh channels per bin (the wave engine uses 2)

// Tile cells.  Q: a row's per-channel value as the partition stores it; a
// cell is kWords 32-bit words; kMaxFG features fit a work item; kHoist:
// the streaming kernel loads 8 features' bins before their adds (int32
// cells leave it the registers at two blocks an SM).
#define DEV __device__ __forceinline__
struct FixedCells {  // 64-bit fixed point, value v * 2^(62 - e[c])
  using Q = long long;
  static constexpr int kWords = 2, kMaxFG = 8;
  static constexpr bool kHoist = false;
  int e[kMaxC + 1];
  __device__ FixedCells(const void* param, int C) {
    for (int c = 0; c <= C; ++c) e[c] = static_cast<const int*>(param)[c];
  }
  DEV Q value(float v, int c) const { return to_fixed(v, e[c]); }
  DEV Q count(float m, int C) const { return to_fixed(m, e[C]); }
  static DEV void add(unsigned* t, int i, Q v) { add_pair(t + 2 * i, v); }
  static DEV long long take(unsigned* t, int i) {  // read and clear
    const long long v = ((long long*)t)[i];
    if (v != 0) ((long long*)t)[i] = 0;
    return v;
  }
};

struct IntCells {  // quantized integers rint(v / scale[c]), count mask > 0
  using Q = int;
  static constexpr int kWords = 1, kMaxFG = 16;
  static constexpr bool kHoist = true;
  float sc[kMaxC];
  __device__ IntCells(const void* param, int C) {
    for (int c = 0; c < C; ++c) sc[c] = static_cast<const float*>(param)[c];
  }
  DEV Q value(float v, int c) const { return (int)rintf(__fdiv_rn(v, sc[c])); }
  DEV Q count(float m, int) const { return m > 0.0f ? 1 : 0; }
  static DEV void add(unsigned* t, int i, Q v) { atomicAdd((int*)t + i, v); }
  static DEV long long take(unsigned* t, int i) {
    const int v = (int)t[i];
    if (v != 0) t[i] = 0u;
    return v;
  }
};

// Bin codes: one Word holds 4 consecutive rows of one feature.
template <typename T>
struct Codes;
template <>
struct Codes<uint8_t> {
  using Word = unsigned;
  static DEV int bin(Word w, int j) { return (w >> (8 * j)) & 255; }
  // row j's codes of the 16 features of words b[0..15], packed 16 bytes
  static DEV void pack16(const Word* b, int j, uint4* dst) {
    const unsigned sel = (unsigned)j | ((4u + j) << 4);
    unsigned wd[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wd[k] = __byte_perm(__byte_perm(b[4 * k], b[4 * k + 1], sel),
                          __byte_perm(b[4 * k + 2], b[4 * k + 3], sel),
                          0x5410);
    dst[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
  }
};
template <>
struct Codes<uint16_t> {
  using Word = uint2;  // rows 0, 1 in x; rows 2, 3 in y
  static DEV int bin(Word w, int j) {
    return ((j < 2 ? w.x : w.y) >> (16 * (j & 1))) & 0xFFFF;
  }
  static DEV void pack16(const Word* b, int j, uint4* dst) {
    const unsigned sel = (j & 1) ? 0x7632u : 0x5410u;  // high or low halves
    unsigned wd[8];
#pragma unroll
    for (int k = 0; k < 8; ++k)
      wd[k] = __byte_perm(j < 2 ? b[2 * k].x : b[2 * k].y,
                          j < 2 ? b[2 * k + 1].x : b[2 * k + 1].y, sel);
    dst[0] = make_uint4(wd[0], wd[1], wd[2], wd[3]);
    dst[1] = make_uint4(wd[4], wd[5], wd[6], wd[7]);
  }
};

template <>
struct Codes<uint32_t> {
  using Word = uint4;  // rows 0-3 in x, y, z, w
  static DEV int bin(Word w, int j) {
    return (int)(j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w);
  }
  // row j's 16 codes are component j of each word: 64 bytes, 4 stores
  static DEV unsigned part(const Word& w, int j) {
    return j == 0 ? w.x : j == 1 ? w.y : j == 2 ? w.z : w.w;
  }
  static DEV void pack16(const Word* b, int j, uint4* dst) {
#pragma unroll
    for (int k = 0; k < 4; ++k)
      dst[k] = make_uint4(part(b[4 * k], j), part(b[4 * k + 1], j),
                          part(b[4 * k + 2], j), part(b[4 * k + 3], j));
  }
};

// gh of rows r..r+3 (4 (kC + 1) floats) as kC + 1 aligned float4 loads.
template <int kC>
DEV void load_gh4(const float* gh, long long r, float* gv) {
  const float4* g4 = reinterpret_cast<const float4*>(gh + r * (kC + 1));
#pragma unroll
  for (int c = 0; c <= kC; ++c)
    reinterpret_cast<float4*>(gv)[c] = g4[c];
}

// Values per row in the partition's q array: C + 1 rounded up to 16 bytes.
template <typename Cells>
__host__ __device__ constexpr int q_stride(int C) {
  return ((C + 1) * (int)sizeof(typename Cells::Q) + 15) / 16 * 16 /
         (int)sizeof(typename Cells::Q);
}

DEV void add_global(long long* p, long long v) {
  atomicAdd((unsigned long long*)p, (unsigned long long)v);
}

// Fixed point -> float32: hist [out_slots, F, B, C] and counts [out_slots].
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
      counts[i - total] =
          (float)((double)cnt_acc[i - total] * ldexp(1.0, exps[C] - 62));
    }
  }
}

// K2's dequantization: float32(int_sum) * scale, counts as float32.
__global__ void finish_quant_kernel(const long long* __restrict__ acc,
                                    const long long* __restrict__ cnt_acc,
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

// ------------------------------------------------------ slot-partitioned
// Pass 1-3 partition the computed rows by slot; pass 4 histograms them.
//
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

// part[0..blockDim.x) -> its exclusive scan (one thread); returns the sum.
__device__ int serial_scan(int* part) {
  int run = 0;
  for (int t = 0; t < (int)blockDim.x; ++t) {
    const int v = part[t];
    part[t] = run;
    run += v;
  }
  return run;
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
  if (threadIdx.x == 0) tot[blockIdx.x] = serial_scan(part);
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
    plan[NL] = serial_scan(ps);
    plan[2 * NL + 1] = serial_scan(pc);
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
// with byte permutes) and its values q_p[pos, :QS] (Cells::value of each
// channel, then Cells::count of the mask, zero-padded to QS = q_stride),
// each written as whole 16-byte stores.
template <int kC, typename Cells, typename T>
__global__ void slot_scatter_kernel(const T* __restrict__ binned_fm,
                                    const int* __restrict__ slot,
                                    const float* __restrict__ gh,
                                    const void* __restrict__ param, int n,
                                    int F, int Fp, int NL, int U, int UR,
                                    const int* __restrict__ cnt,
                                    const int* __restrict__ plan,
                                    T* __restrict__ rows_p,
                                    typename Cells::Q* __restrict__ q_p) {
  using Q = typename Cells::Q;
  using Word = typename Codes<T>::Word;
  constexpr int kChunkVecs = 16 * sizeof(T) / 16;  // uint4s of 16 codes
  constexpr int kQS = q_stride<Cells>(kC);
  extern __shared__ int sc[];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  int* run = sc + w * NL;
  const int u = blockIdx.x * (blockDim.x >> 5) + w;
  if (u >= U) return;
  for (int i = lane; i < NL; i += 32)
    run[i] = plan[i] + cnt[(long long)i * U + u];
  __syncwarp();
  const Cells cells(param, kC);
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
    // r..r+3; row j's codes gather code j of each word (Codes::pack16)
    const Word* col = reinterpret_cast<const Word*>(binned_fm) + (r >> 2);
    const long long fstride = n >> 2;
    for (int v = 0; v < Fp / 16; ++v) {
      Word b[16];
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const int f = 16 * v + k;
        b[k] = f < F ? col[f * fstride] : Word{};
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (!ok[j]) continue;
        Codes<T>::pack16(
            b, j, reinterpret_cast<uint4*>(rows_p + pos[j] * Fp) +
                      kChunkVecs * v);
      }
    }
    alignas(16) float gv[4 * (kC + 1)];
    load_gh4<kC>(gh, r, gv);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (!ok[j]) continue;
      constexpr int kW = sizeof(Q) / 4;  // 32-bit words per value
      unsigned wd[kQS * kW];
#pragma unroll
      for (int c = 0; c < kQS; ++c) {
        const Q v = c < kC ? cells.value(gv[j * (kC + 1) + c], c)
                  : c == kC ? cells.count(gv[j * (kC + 1) + kC], kC) : 0;
        wd[c * kW] = (unsigned)v;
        if constexpr (kW == 2)
          wd[c * kW + 1] = (unsigned)((unsigned long long)v >> 32);
      }
      uint4* qd = reinterpret_cast<uint4*>(q_p + pos[j] * kQS);
#pragma unroll
      for (int k = 0; k < kQS * kW / 4; ++k)
        qd[k] = make_uint4(wd[4 * k], wd[4 * k + 1], wd[4 * k + 2],
                           wd[4 * k + 3]);
    }
  }
}

// Pass 4: a persistent grid over the work items it = k * GW + g * Wn + w
// (chunk k of the slot-grouped rows, feature group g, bin window w of Bw
// bins).  Each block adds its item's rows into an (fg x bw x C) tile plus
// the count cell, then flushes the non-zero cells: plain stores when the
// slot has one chunk (the block owns those cells alone), else 64-bit
// global atomics.  acc and cnt_acc start zeroed.
template <typename Cells, typename T>
__global__ void __launch_bounds__(kHistThreads)
wave_part_hist_kernel(const T* __restrict__ rows_p,
                      const typename Cells::Q* __restrict__ q_p,
                      const int* __restrict__ plan, int NL, int F, int Fp,
                      int B, int Bw, int C, int QS, int FG, int R,
                      long long* __restrict__ acc,
                      long long* __restrict__ cnt_acc) {
  using Q = typename Cells::Q;
  extern __shared__ __align__(16) unsigned tile[];
  const int G = (F + FG - 1) / FG;
  const int Wn = (B + Bw - 1) / Bw;
  const int GW = G * Wn;
  const int* seg = plan;
  const int* chunk = plan + NL + 1;
  const long long items = (long long)chunk[NL] * GW;
  const int full = FG * Bw * C;  // the count cell follows the histogram
  for (int i = threadIdx.x; i < (full + 1) * Cells::kWords; i += blockDim.x)
    tile[i] = 0u;
  for (long long it = blockIdx.x; it < items; it += gridDim.x) {
    const int k = (int)(it / GW), gw = (int)(it % GW);
    const int g = gw / Wn, w = gw - g * Wn;
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
    const int b0 = w * Bw, bw = min(Bw, B - b0), bwc = bw * C;
    const int len = fg * bwc;
    __syncthreads();
    for (long long i = a + threadIdx.x; i < b; i += blockDim.x) {
      Q q[kMaxC];
      const Q* qi = q_p + i * QS;
#pragma unroll
      for (int c = 0; c < kMaxC; ++c) q[c] = c < C ? qi[c] : 0;
      const Q qc = gw == 0 ? qi[C] : 0;  // the count column
      const T* row = rows_p + i * Fp + f0;
#pragma unroll
      for (int fl = 0; fl < Cells::kMaxFG; ++fl) {
        if (fl >= fg) break;
        const int bin = (int)row[fl] - b0;
        if ((unsigned)bin >= (unsigned)bw) continue;
        const int cell = (fl * bw + bin) * C;
#pragma unroll
        for (int c = 0; c < kMaxC; ++c)
          if (c < C && q[c] != 0) Cells::add(tile, cell + c, q[c]);
      }
      if (qc != 0) Cells::add(tile, full, qc);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < len; i += blockDim.x) {
      const long long v = Cells::take(tile, i);
      if (v == 0) continue;
      const int fl = i / bwc;
      long long* out = acc + ((long long)(s * F + f0 + fl) * B + b0) * C +
                       (i - fl * bwc);
      if (owner) *out = v;
      else add_global(out, v);
    }
    if (gw == 0 && threadIdx.x == 0) {
      const long long v = Cells::take(tile, full);
      if (v != 0 && owner) cnt_acc[s] = v;
      else if (v != 0) add_global(cnt_acc + s, v);
    }
  }
}

// ------------------------------------------------------------- streaming
// Grid (row chunks, feature groups x bin windows).  The tile holds [S
// slots][fg features][bw bins][kC] cells, then S count cells (in the first
// feature group's first window only).  Warp w walks the steps base = row0
// + 128 (w + k * warps); lane l takes rows base + 4l .. base + 4l + 3.
// rows_per_block is a multiple of 128 and n of 4, so a lane's 4 rows lie
// inside the chunk or outside.
template <int kC, typename Cells, typename T>
__global__ void __launch_bounds__(kFewThreads, 2)
wave_few_kernel(const T* __restrict__ binned_fm,
                const int* __restrict__ slot, const float* __restrict__ gh,
                const void* __restrict__ param, int n, int F, int B, int Bw,
                int S, int FG, int rows_per_block,
                long long* __restrict__ acc,
                long long* __restrict__ cnt_acc) {
  using Q = typename Cells::Q;
  using Word = typename Codes<T>::Word;
  // 16-byte words of 32-bit codes would take 32 registers to hoist
  constexpr bool kHoist = Cells::kHoist && sizeof(Word) <= 8;
  extern __shared__ __align__(16) unsigned tile[];
  const int Wn = (B + Bw - 1) / Bw;
  const int g = blockIdx.y / Wn, win = blockIdx.y - g * Wn;
  const int f0 = g * FG, fg = min(FG, F - f0);
  const int b0 = win * Bw, bw = min(Bw, B - b0), bwc = bw * kC;
  const bool counts = blockIdx.y == 0;
  const int per_slot = fg * bwc, len = S * per_slot;
  for (int i = threadIdx.x; i < (len + S) * Cells::kWords; i += blockDim.x)
    tile[i] = 0u;
  __syncthreads();
  const Cells cells(param, kC);
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const long long row1 = min((long long)n, row0 + rows_per_block);
  const long long fstride = n >> 2;
  const Word* col = reinterpret_cast<const Word*>(binned_fm) + f0 * fstride;
  for (long long base = row0 + 128 * w; base < row1;
       base += 128 * (blockDim.x >> 5)) {
    const long long r = base + 4 * lane, q4 = r >> 2;
    if (r >= row1) continue;
    const int4 s4 = *reinterpret_cast<const int4*>(slot + r);
    const int sj[4] = {s4.x, s4.y, s4.z, s4.w};
    bool ok[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) ok[j] = (unsigned)sj[j] < (unsigned)S;
    if (!(ok[0] || ok[1] || ok[2] || ok[3])) continue;
    alignas(16) float gv[4 * (kC + 1)];
    load_gh4<kC>(gh, r, gv);
    Q q[4][kC];
    int base_cell[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int c = 0; c < kC; ++c)
        q[j][c] = ok[j] ? cells.value(gv[j * (kC + 1) + c], c) : 0;
      base_cell[j] = ok[j] ? sj[j] * per_slot : 0;
    }
    for (int f8 = 0; f8 < fg; f8 += 8) {
      Word wv[8];
#pragma unroll
      for (int k = 0; k < 8; ++k)
        if (kHoist && f8 + k < fg) wv[k] = col[(f8 + k) * fstride + q4];
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        const int fl = f8 + k;
        if (fl >= fg) break;
        const Word word = kHoist ? wv[k] : col[fl * fstride + q4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int bin = Codes<T>::bin(word, j) - b0;
          if (!ok[j] || (unsigned)bin >= (unsigned)bw) continue;
          const int cell = base_cell[j] + (fl * bw + bin) * kC;
#pragma unroll
          for (int c = 0; c < kC; ++c)
            if (q[j][c] != 0) Cells::add(tile, cell + c, q[j][c]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const Q m = counts && ok[j] ? cells.count(gv[j * (kC + 1) + kC], kC) : 0;
      if (m != 0) Cells::add(tile, len + sj[j], m);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < len; i += blockDim.x) {
    const long long v = Cells::take(tile, i);
    if (v == 0) continue;
    const int s = i / per_slot, rem = i - s * per_slot;  // (fl*bw + b)*kC + c
    const int fl = rem / bwc, bc = rem - fl * bwc;
    add_global(acc + (((long long)s * F + f0 + fl) * B + b0) * kC + bc, v);
  }
  for (int s = threadIdx.x; counts && s < S; s += blockDim.x) {
    const long long v = Cells::take(tile, len + s);
    if (v != 0) add_global(cnt_acc + s, v);
  }
}

// ------------------------------------------------------------------ host
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

// Blocks of fn resident on one SM at this shared memory, cached per size.
template <typename Fn>
cudaError_t resident_blocks(Fn* fn, size_t smem, size_t* cached_smem,
                            int* blocks) {
  if (*cached_smem == smem) return cudaSuccess;
  cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, fn, kHistThreads, smem);
  if (err == cudaSuccess) *cached_smem = smem;
  return err;
}

int sm_count() {
  static int sms = 0;
  int dev = 0;
  if (sms <= 0 && cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms > 0 ? sms : 132;
}

int grid_for(long long work) {
  long long g = (work + kThreads - 1) / kThreads;
  return (int)std::min(std::max(g, 1LL), 132LL * 16);
}

template <int kC, typename Cells, typename T>
cudaError_t launch_scatter(const void* binned_fm, const void* slot,
                           const void* gh, const void* param, int n, int F,
                           int Fp, int NL, int U, int UR, int PW, size_t smem,
                           const int* cnt, const int* plan, T* rows_p,
                           void* q_p, cudaStream_t stream) {
  static int smem_set = 0;
  cudaError_t err = ensure_smem(slot_scatter_kernel<kC, Cells, T>, smem,
                                &smem_set);
  if (err != cudaSuccess) return err;
  slot_scatter_kernel<kC, Cells, T><<<(U + PW - 1) / PW, 32 * PW, smem,
                                      stream>>>(
      (const T*)binned_fm, (const int*)slot, (const float*)gh, param, n, F,
      Fp, NL, U, UR, cnt, plan, rows_p, (typename Cells::Q*)q_p);
  return cudaGetLastError();
}

// Bytes of the partition's scratch: the unit counts, slot totals and
// plan, then the packed rows and their values on 256-byte boundaries (the
// layout run_partition carves; wave_part_plan in ops/histogram.py).
template <typename Cells, typename T>
long long part_scratch(int n, int F, int C, int NL, int UR) {
  const long long U = (n + UR - 1) / UR, Fp = (F + 15) / 16 * 16;
  const long long ints = (long long)NL * U + NL + 2 * (NL + 1);
  return (ints * 4 + 255) / 256 * 256 +
         ((long long)n * Fp * sizeof(T) + 255) / 256 * 256 +
         (long long)n * q_stride<Cells>(C) * sizeof(typename Cells::Q);
}

// The slot-partitioned pipeline into zeroed acc [NL*F*B*C] and cnt_acc
// [NL]: UR rows per partition warp, PW warps per partition block, FG
// features, Bw bins and at most R rows per work item (the wrapper's
// planner).
template <typename Cells, typename T>
cudaError_t run_partition(const void* binned_fm, const void* slot,
                          const void* gh, const void* param, int n, int F,
                          int B, int Bw, int C, int NL, int UR, int PW,
                          int FG, int R, void* scratch,
                          long long scratch_bytes, long long* acc,
                          long long* cnt_acc, cudaStream_t stream) {
  static int smem_count = 0, smem_hist = 0, occ_blocks = 0;
  static size_t occ_smem = 0;
  if (UR < 128 || UR % 128 || PW < 1 || PW > 32 || FG < 1 ||
      FG > Cells::kMaxFG || R < 1 || Bw < 1 || Bw > B ||
      scratch_bytes < part_scratch<Cells, T>(n, F, C, NL, UR))
    return cudaErrorInvalidValue;
  const int U = (n + UR - 1) / UR;
  const int Fp = (F + 15) / 16 * 16, QS = q_stride<Cells>(C);
  int* cnt = (int*)scratch;
  int* tot = cnt + (long long)NL * U;
  int* plan = tot + NL;
  const long long ints = (long long)NL * U + NL + 2 * (NL + 1);
  // rows_p and q_p start on 256-byte boundaries, so each packed row (and
  // each row's values, Fp and QS * sizeof(Q) bytes) fills whole sectors
  uint8_t* rows_b = (uint8_t*)scratch + (ints * 4 + 255) / 256 * 256;
  T* rows_p = (T*)rows_b;
  void* q_p = rows_b + ((long long)n * Fp * sizeof(T) + 255) / 256 * 256;

  const size_t part_smem = sizeof(int) * (size_t)PW * NL;
  cudaError_t err = ensure_smem(slot_count_kernel, part_smem, &smem_count);
  if (err != cudaSuccess) return err;
  slot_count_kernel<<<(U + PW - 1) / PW, 32 * PW, part_smem, stream>>>(
      (const int*)slot, n, NL, U, UR, cnt);
  slot_scan_kernel<<<NL, kHistThreads, 0, stream>>>(cnt, U, tot);
  slot_plan_kernel<<<1, kHistThreads, 0, stream>>>(tot, NL, R, plan);
  decltype(&launch_scatter<1, Cells, T>) const scatter[kMaxC] = {
      launch_scatter<1, Cells, T>, launch_scatter<2, Cells, T>,
      launch_scatter<3, Cells, T>, launch_scatter<4, Cells, T>};
  err = scatter[C - 1](binned_fm, slot, gh, param, n, F, Fp, NL, U, UR, PW,
                       part_smem, cnt, plan, rows_p, q_p, stream);
  if (err != cudaSuccess) return err;

  const size_t hist_smem = 4 * Cells::kWords * ((size_t)FG * Bw * C + 1);
  err = ensure_smem(wave_part_hist_kernel<Cells, T>, hist_smem, &smem_hist);
  if (err == cudaSuccess)
    err = resident_blocks(wave_part_hist_kernel<Cells, T>, hist_smem,
                          &occ_smem, &occ_blocks);
  if (err != cudaSuccess) return err;
  const long long GW = (long long)((F + FG - 1) / FG) * ((B + Bw - 1) / Bw);
  const long long max_items = ((n + R - 1) / R + (long long)NL) * GW;
  const int grid = (int)std::max(1LL, std::min(
      max_items, (long long)std::max(occ_blocks, 1) * sm_count()));
  wave_part_hist_kernel<Cells, T><<<grid, kHistThreads, hist_smem, stream>>>(
      rows_p, (const typename Cells::Q*)q_p, plan, NL, F, Fp, B, Bw, C, QS,
      FG, R, acc, cnt_acc);
  return cudaGetLastError();
}

// The streaming kernel into zeroed acc and cnt_acc (slots [0, S)): one
// wave of two blocks an SM (the launch bounds and a tile of at most half
// an SM), each feature group's bin window cut into row chunks of a
// multiple of 128.
template <int kC, typename Cells, typename T>
cudaError_t launch_few(const void* binned_fm, const void* slot,
                       const void* gh, const void* param, int n, int F,
                       int B, int Bw, int S, int FG, long long* acc,
                       long long* cnt_acc, cudaStream_t stream) {
  static int smem_set = 0;
  const size_t smem = 4 * Cells::kWords * ((size_t)S * FG * Bw * kC + S);
  cudaError_t err = ensure_smem(wave_few_kernel<kC, Cells, T>, smem,
                                &smem_set);
  if (err != cudaSuccess) return err;
  const long long GW = (long long)((F + FG - 1) / FG) * ((B + Bw - 1) / Bw);
  long long chunks = (2LL * sm_count() + GW - 1) / GW;  // two blocks an SM
  chunks = std::max(1LL, std::min(chunks, (n + 1023LL) / 1024));
  const long long rows = ((n + chunks - 1) / chunks + 127) / 128 * 128;
  chunks = (n + rows - 1) / rows;
  wave_few_kernel<kC, Cells, T><<<dim3((unsigned)chunks, (unsigned)GW),
                                  kFewThreads, smem, stream>>>(
      (const T*)binned_fm, (const int*)slot, (const float*)gh, param, n, F,
      B, Bw, S, FG, (int)rows, acc, cnt_acc);
  return cudaGetLastError();
}

template <typename Cells, typename T>
cudaError_t run_few(const void* binned_fm, const void* slot, const void* gh,
                    const void* param, int n, int F, int B, int Bw, int C,
                    int S, int FG, long long* acc, long long* cnt_acc,
                    cudaStream_t stream) {
  if (FG < 1 || FG > F || S < 1 || Bw < 1 || Bw > B)
    return cudaErrorInvalidValue;
  decltype(&launch_few<1, Cells, T>) const few[kMaxC] = {
      launch_few<1, Cells, T>, launch_few<2, Cells, T>,
      launch_few<3, Cells, T>, launch_few<4, Cells, T>};
  return few[C - 1](binned_fm, slot, gh, param, n, F, B, Bw, S, FG, acc,
                    cnt_acc, stream);
}

bool bad_shape(int n, int F, int B, int C, int NL, int code_bytes) {
  return C < 1 || C > kMaxC || n < 1 || n % 4 || F < 1 || B < 1 ||
         NL < 1 || (code_bytes != 1 && code_bytes != 2 && code_bytes != 4);
}

// The pipelines on the caller's code type (1: uint8_t, 2: uint16_t, 4:
// uint32_t).
template <typename Cells>
cudaError_t run_partition_codes(int code_bytes, const void* binned_fm,
                                const void* slot, const void* gh,
                                const void* param, int n, int F, int B,
                                int Bw, int C, int NL, int UR, int PW, int FG,
                                int R, void* scratch, long long scratch_bytes,
                                long long* acc, long long* cnt_acc,
                                cudaStream_t stream) {
  if (code_bytes == 4)
    return run_partition<Cells, uint32_t>(
        binned_fm, slot, gh, param, n, F, B, Bw, C, NL, UR, PW, FG, R,
        scratch, scratch_bytes, acc, cnt_acc, stream);
  return code_bytes == 2
             ? run_partition<Cells, uint16_t>(
                   binned_fm, slot, gh, param, n, F, B, Bw, C, NL, UR, PW,
                   FG, R, scratch, scratch_bytes, acc, cnt_acc, stream)
             : run_partition<Cells, uint8_t>(
                   binned_fm, slot, gh, param, n, F, B, Bw, C, NL, UR, PW,
                   FG, R, scratch, scratch_bytes, acc, cnt_acc, stream);
}

template <typename Cells>
cudaError_t run_few_codes(int code_bytes, const void* binned_fm,
                          const void* slot, const void* gh, const void* param,
                          int n, int F, int B, int Bw, int C, int S, int FG,
                          long long* acc, long long* cnt_acc,
                          cudaStream_t stream) {
  if (code_bytes == 4)
    return run_few<Cells, uint32_t>(binned_fm, slot, gh, param, n, F, B, Bw,
                                    C, S, FG, acc, cnt_acc, stream);
  return code_bytes == 2
             ? run_few<Cells, uint16_t>(binned_fm, slot, gh, param, n, F, B,
                                        Bw, C, S, FG, acc, cnt_acc, stream)
             : run_few<Cells, uint8_t>(binned_fm, slot, gh, param, n, F, B,
                                       Bw, C, S, FG, acc, cnt_acc, stream);
}

}  // namespace

extern "C" {

// K1.  binned_fm: [F, n] codes of code_bytes bytes; exps: int32 [C+1]
// (device); acc: int64 [NL*F*B*C]; cnt_acc: int64 [NL]; Bw bins per
// window, UR, PW, FG (<= 8), R and scratch (at least part_scratch bytes)
// from the wrapper's planner, wave_part_plan.  With hist == NULL the
// int64 sums are the result.
int wave_hist_f32(const void* binned_fm, const void* slot, const void* gh,
                  const void* exps, int n, int F, int B, int C, int NL,
                  int code_bytes, int Bw, int UR, int PW, int FG, int R,
                  void* scratch, long long scratch_bytes, void* acc,
                  void* cnt_acc, void* hist, void* counts, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (bad_shape(n, F, B, C, NL, code_bytes)) return (int)cudaErrorInvalidValue;
  const long long acc_len = (long long)NL * F * B * C;
  cudaMemsetAsync(acc, 0, sizeof(long long) * acc_len, stream);
  cudaMemsetAsync(cnt_acc, 0, sizeof(long long) * NL, stream);
  cudaError_t err = run_partition_codes<FixedCells>(
      code_bytes, binned_fm, slot, gh, exps, n, F, B, Bw, C, NL, UR, PW, FG,
      R, scratch, scratch_bytes, (long long*)acc, (long long*)cnt_acc,
      stream);
  if (err != cudaSuccess || hist == nullptr) return (int)err;
  finish_fixed_kernel<<<grid_for(acc_len + NL), kThreads, 0, stream>>>(
      (const long long*)acc, (const long long*)cnt_acc, (const int*)exps, F,
      B, C, NL, (float*)hist, (float*)counts);
  return (int)cudaGetLastError();
}

// K2.  scales: float32 [C] (device); acc: int64 [NL*F*B*C]; cnt_acc: int64
// [NL].  few != 0 takes the streaming kernel (FG features and Bw bins per
// block, the wrapper's wave_few_plan with 4-byte cells; UR, PW, R and
// scratch unused), else the slot-partitioned pipeline (FG <= 16, the
// wrapper's wave_part_plan with 4-byte cells).  With hist == NULL the
// int64 sums are the result.
int wave_hist_i32(const void* binned_fm, const void* slot, const void* gh,
                  const void* scales, int n, int F, int B, int C, int NL,
                  int code_bytes, int Bw, int few, int UR, int PW, int FG,
                  int R, void* scratch, long long scratch_bytes, void* acc,
                  void* cnt_acc, void* hist, void* counts, void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (bad_shape(n, F, B, C, NL, code_bytes)) return (int)cudaErrorInvalidValue;
  const long long acc_len = (long long)NL * F * B * C;
  cudaMemsetAsync(acc, 0, sizeof(long long) * acc_len, stream);
  cudaMemsetAsync(cnt_acc, 0, sizeof(long long) * NL, stream);
  cudaError_t err =
      few ? run_few_codes<IntCells>(code_bytes, binned_fm, slot, gh, scales,
                                    n, F, B, Bw, C, NL, FG, (long long*)acc,
                                    (long long*)cnt_acc, stream)
          : run_partition_codes<IntCells>(
                code_bytes, binned_fm, slot, gh, scales, n, F, B, Bw, C, NL,
                UR, PW, FG, R, scratch, scratch_bytes, (long long*)acc,
                (long long*)cnt_acc, stream);
  if (err != cudaSuccess || hist == nullptr) return (int)err;
  finish_quant_kernel<<<grid_for(acc_len + NL), kThreads, 0, stream>>>(
      (const long long*)acc, (const long long*)cnt_acc, (const float*)scales,
      F, B, C, NL, (float*)hist, (float*)counts);
  return (int)cudaGetLastError();
}

// K3.  Feature-major bins; acc: int64 [out_slots*F*B*C], cnt_acc: int64
// [out_slots]; FG features and Bw bins per block (the wrapper's
// wave_few_plan).  Slots past S stay 0 (the zero padding).  With hist ==
// NULL the int64 sums are the result.
int wave_hist_hl_f32(const void* binned_fm, const void* slot, const void* gh,
                     const void* exps, int n, int F, int B, int C, int S,
                     int code_bytes, int Bw, int out_slots, int FG, void* acc,
                     void* cnt_acc, void* hist, void* counts,
                     void* stream_ptr) {
  cudaStream_t stream = reinterpret_cast<cudaStream_t>(stream_ptr);
  if (bad_shape(n, F, B, C, S, code_bytes) || out_slots < S)
    return (int)cudaErrorInvalidValue;
  const long long out_len = (long long)out_slots * F * B * C;
  cudaMemsetAsync(acc, 0, sizeof(long long) * out_len, stream);
  cudaMemsetAsync(cnt_acc, 0, sizeof(long long) * out_slots, stream);
  cudaError_t err = run_few_codes<FixedCells>(
      code_bytes, binned_fm, slot, gh, exps, n, F, B, Bw, C, S, FG,
      (long long*)acc, (long long*)cnt_acc, stream);
  if (err != cudaSuccess || hist == nullptr) return (int)err;
  finish_fixed_kernel<<<grid_for(out_len + out_slots), kThreads, 0, stream>>>(
      (const long long*)acc, (const long long*)cnt_acc, (const int*)exps, F,
      B, C, out_slots, (float*)hist, (float*)counts);
  return (int)cudaGetLastError();
}

}  // extern "C"

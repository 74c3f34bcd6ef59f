// 64-bit fixed-point cells shared by the histogram kernels (wave_hist.cu,
// rows_hist.cu).  Channel c of a histogram is scaled by 2^(62 - E_c), with
// E_c from the caller, and summed with integer atomics, so the sums are
// order-free and equal the plain versions' int64 index_add_ bit for bit.

#pragma once

#include <cuda_runtime.h>

namespace {

// v * 2^(62 - e) rounded half to even (the plain version's torch.round);
// the scale is an exact power of two, so the product is exact.
__device__ __forceinline__ long long to_fixed(float v, int e) {
  return __float2ll_rn(v * ldexpf(1.0f, 62 - e));
}

// 64-bit add into a shared-memory cell as two native 32-bit atomics (a
// 64-bit shared atomicAdd compiles to a compare-and-swap loop on Hopper):
// the low word's carry goes into the high word, so the cell ends as the
// exact sum mod 2^64.
__device__ __forceinline__ void add_pair(unsigned* cell, long long v) {
  const unsigned lo = (unsigned)v;
  unsigned hi = (unsigned)((unsigned long long)v >> 32);
  const unsigned old = atomicAdd(cell, lo);
  hi += (unsigned)(old + lo < old);
  if (hi != 0u) atomicAdd(cell + 1, hi);
}

}  // namespace

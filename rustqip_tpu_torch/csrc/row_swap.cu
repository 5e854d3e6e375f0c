// Row-swap pass for Hopper (sm_90a): applies a set of disjoint row-bit swap
// pairs to the (R, 128) re/im planes of a state, in place, in one pass.
//
// Replaces the TPU kernel of scripts/field_reversal_probe.py: _slab_call
// (pallas_call at :105, bodies body_take :120, body_rolls :125, body_mm
// :150), which reverses a contiguous field of row bits of the (2^21, 128)
// float32 planes -- the data motion of QFT's trailing bit-reversal swap.
// This kernel takes any set of disjoint row-row pairs (a reversed field of
// any span, or scattered pairs) and float32 or float64 planes alike: a
// permutation moves bits and computes nothing.
//
// What bounds it on an H100: device-memory bytes. Row r goes to the row
// p(r) whose index has each pair's two bits exchanged; a row moves when the
// bits of some pair differ, which is R - R / 2^k rows for k pairs. Each
// moved row is read once and written once in both planes, so the pass must
// move 2 planes x 2 (read + write) x rows moved x row bytes (512 in f32,
// 1024 in f64): (1 - 2^-k) x 4.29 GB at n = 28 in f32, at most 1.28 ms at
// 3.35 TB/s.
//
// What the design does about it. p is an involution, so the rows are
// exchanged in place: the warp that owns row r with p(r) > r loads rows r
// and p(r) of both planes and stores them crossed; rows with p(r) < r
// belong to their partner's warp and fixed rows are skipped, so no row is
// touched twice and no scratch plane is needed (1 GiB per plane at n = 28).
// A warp moves a whole row: 512 or 1024 contiguous bytes as one or two
// 16-byte loads per lane, so every read and write is coalesced, and all of
// a warp's loads are issued before its stores. The TPU probe's slabs and
// in-VMEM shuffles, its way to one HBM pass, have no counterpart here: a
// row is already a whole coalesced unit.

#include <cuda_runtime.h>
#include <stdint.h>

#define RQ_MAX_PAIRS 31

struct Pairs {
  int n;
  int lo[RQ_MAX_PAIRS];
  int hi[RQ_MAX_PAIRS];
};

__device__ __forceinline__ long long partner(long long r, const Pairs& p) {
  long long q = r;
  for (int t = 0; t < p.n; ++t) {
    const long long d = ((r >> p.lo[t]) ^ (r >> p.hi[t])) & 1LL;
    q ^= (d << p.lo[t]) | (d << p.hi[t]);
  }
  return q;
}

// U = 16-byte units per lane per row: 1 for 512-byte rows, 2 for 1024.
template <int U>
__global__ void __launch_bounds__(256) row_swap_kernel(uint4* xr, uint4* xi,
                                                       long long rows,
                                                       Pairs pairs) {
  const int lane = threadIdx.x & 31;
  const long long warps = (long long)gridDim.x * (blockDim.x >> 5);
  for (long long r = (long long)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       r < rows; r += warps) {
    const long long p = partner(r, pairs);
    if (p <= r) continue;  // uniform across the warp
    uint4* ar = xr + r * (32 * U) + lane;
    uint4* br = xr + p * (32 * U) + lane;
    uint4* ai = xi + r * (32 * U) + lane;
    uint4* bi = xi + p * (32 * U) + lane;
    uint4 var[U], vbr[U], vai[U], vbi[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      var[u] = ar[32 * u];
      vbr[u] = br[32 * u];
      vai[u] = ai[32 * u];
      vbi[u] = bi[32 * u];
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      ar[32 * u] = vbr[u];
      br[32 * u] = var[u];
      ai[32 * u] = vbi[u];
      bi[32 * u] = vai[u];
    }
  }
}

// xr, xi: the planes, rows x row_bytes each, 16-byte aligned; row_bytes is
// 512 or 1024. lo[t] < hi[t] are row-index bit positions (bit 0 = the
// lowest bit of the row index), disjoint across pairs, all < 63.
extern "C" int rq_row_swap(void* xr, void* xi, long long rows, int row_bytes,
                           int npairs, const int* lo, const int* hi,
                           void* stream) {
  if (npairs < 0 || npairs > RQ_MAX_PAIRS) return (int)cudaErrorInvalidValue;
  Pairs p;
  p.n = npairs;
  for (int t = 0; t < RQ_MAX_PAIRS; ++t) {
    p.lo[t] = t < npairs ? lo[t] : 0;
    p.hi[t] = t < npairs ? hi[t] : 0;
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long want = (rows + 7) / 8;  // one row per warp
  const int blocks = (int)(want < 132LL * 32 ? want : 132LL * 32);
  if (blocks <= 0) return 0;
  if (row_bytes == 512) {
    row_swap_kernel<1><<<blocks, threads, 0, st>>>(
        reinterpret_cast<uint4*>(xr), reinterpret_cast<uint4*>(xi), rows, p);
  } else if (row_bytes == 1024) {
    row_swap_kernel<2><<<blocks, threads, 0, st>>>(
        reinterpret_cast<uint4*>(xr), reinterpret_cast<uint4*>(xi), rows, p);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

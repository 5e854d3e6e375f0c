// Swap pass for Hopper (sm_90a): applies the disjoint qubit swap pairs of
// one SwapOp to the (R, 128) re/im planes of a state in one pass. Two
// kernels: row_swap_kernel for row-row pairs alone, in place, and
// cross_row_swap_kernel (below) for ops that also exchange row qubits with
// lane qubits.
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

// ---------------------------------------------------------------------------
// cross_row_swap_kernel: a whole SwapOp whose k >= 2 cross pairs (a row
// qubit with a lane qubit) hold the top k row qubits, with any row pairs.
//
// Replaces no TPU kernel: the JAX package leaves its cross pairs to XLA (a
// lane relabel, a block transpose, a relabel back), and the port ran them as
// plain torch passes, a gather through an index table and a copy back for
// each 64 MiB chunk of row groups, before row_swap_kernel took the row pairs.
//
// What bounds it on an H100: device-memory bytes. The op is a bit
// permutation P of the flat index (the row bits above the 7 lane bits), an
// involution; an element moves when the two bits of some pair differ, which
// is 2^n - 2^(n-k) elements for k pairs in all, each read once and written
// once in both planes: 68.7 GB at n = 32 in f32, 20.5 ms at 3.35 TB/s.
//
// What the design does about it. A cross pair sends an element to another
// row, so a row no longer moves whole. The unit is a tile: the 32-lane
// segments (lane bits 0..4: 128 bytes in f32, 256 in f64) of the 2^c rows
// spanned by the row bits whose partners are among those lane bits (c of
// the cross pairs). P maps each tile onto a tile, since every pair lies
// inside the tile's bits or wholly outside them, and permutes the tile's
// elements by pi, the exchange of those c row bits with their lane bits. A
// block holds 32 segments a side and plane in shared memory (2^(5-c) tiles
// of 2^c rows: 4 KB a plane a side in f32), each padded to 33 elements so
// that pi's transposed reads fall on distinct banks. In place, the block
// that holds tile a with P(a) > a loads both tiles and stores each, through
// pi, into the other; a tile with P(a) = a is permuted into itself; a tile
// with P(a) < a is its partner's. So every read and write is a whole
// segment, and no element is read or written twice. To fresh planes (a
// caller that keeps its input) every tile is written from its partner's.
// A thread's segment, and the source under pi of each element it writes,
// stay the same from tile to tile: both are worked out once, before the
// grid-stride loop. P of a tile's first element is one OR-reduction over
// the warp, a lane per pair. A block issues the loads of its next unit as
// soon as this unit sits in shared memory, so they fly while this unit is
// stored, and the launch has 16 blocks for each that fits on the card at
// once. Measured on the H100 at n = 32 (QFT-32's reversal, PERF.md): 26.4
// ms; 31.4 with only as many blocks as fit at once; 32.6-34.1 with that
// and no loads ahead; 42.3 with one block per unit of work (each block
// then works out its tables for one unit). With the unit order changed so that
// lane bits 5 and 6 and their partners' row bits vary fastest (whole 512-
// byte rows on both sides at once) it ran the same; with streaming cache
// hints 1 % faster; capped at 40 registers (6 blocks an SM) it spilled and
// ran 1.7 times slower.

#define RQ_CROSS_MAX_PAIRS 64
#define RQ_SEGS 32  // segments a block holds a side and plane
#define RQ_PAD 33   // a segment's stride in shared memory, in elements
// Blocks launched per block resident at once: a block walks every this
// many-th unit of work, and the scheduler refills the SMs from the rest.
#define RQ_CROSS_WAVES 16

struct CrossPlan {
  int npairs;  // every pair of the op, as bits of the flat index
  int lo[RQ_CROSS_MAX_PAIRS];
  int hi[RQ_CROSS_MAX_PAIRS];
  int c;        // cross pairs whose lane bit is below 5
  int fbit[5];  // their row bits (as flat index bits), ascending
  int lbit[5];  // their lane bits
  long long tiles;  // 2^(n - 5 - c)
};

// The first element of tile t: t's bits spread over the flat index bits
// outside every tile (lanes 5 and 6, the row bits other than fbit).
__device__ __forceinline__ long long tile_base(long long t, const CrossPlan& p) {
  long long x = t << 5;
  for (int u = 0; u < p.c; ++u) {
    const int f = p.fbit[u];
    x = ((x >> f) << (f + 1)) | (x & ((1LL << f) - 1));
  }
  return x;
}

__device__ __forceinline__ long long flat_partner(long long x, const CrossPlan& p) {
  long long q = x;
  for (int t = 0; t < p.npairs; ++t) {
    const long long d = ((x >> p.lo[t]) ^ (x >> p.hi[t])) & 1LL;
    q ^= (d << p.lo[t]) | (d << p.hi[t]);
  }
  return q;
}

template <typename T>
union Vec16 {
  uint4 u;
  T e[16 / sizeof(T)];
};

template <typename T>
__global__ void __launch_bounds__(256) cross_row_swap_kernel(const T* sr, const T* si, T* dr,
                                                             T* di, long long units,
                                                             CrossPlan p) {
  constexpr int E = 16 / sizeof(T);  // elements a 16-byte unit
  constexpr int U = 32 / (8 * E);    // units a thread moves of a segment
  __shared__ T sm[2][2][RQ_SEGS * RQ_PAD];  // [tile a or its partner][plane]
  const bool fresh = sr != dr;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int c = p.c;
  const int s = tid >> 3;            // the segment this thread moves
  const int sig = s >> c;            // its tile in the block
  const int r = s & ((1 << c) - 1);  // its row in the tile
  long long rowoff = 0;
  for (int u = 0; u < c; ++u) rowoff |= (long long)((r >> u) & 1) << p.fbit[u];
  const long long dsig = tile_base(sig, p);
  const long long pdsig = flat_partner(dsig, p);
  unsigned long long mk0 = 0, mk1 = 0;
  int lo0 = 0, hi0 = 0, lo1 = 0, hi1 = 0;
  if (lane < p.npairs) {
    lo0 = p.lo[lane];
    hi0 = p.hi[lane];
    mk0 = (1ULL << lo0) | (1ULL << hi0);
  }
  if (lane + 32 < p.npairs) {
    lo1 = p.lo[lane + 32];
    hi1 = p.hi[lane + 32];
    mk1 = (1ULL << lo1) | (1ULL << hi1);
  }
  int src[U][E];  // shared-memory index of the source of each element written
#pragma unroll
  for (int v = 0; v < U; ++v) {
#pragma unroll
    for (int e = 0; e < E; ++e) {
      const int x = ((tid & 7) + 8 * v) * E + e;
      int rs = r, xs = x;
      for (int u = 0; u < c; ++u) {
        const int l = p.lbit[u];
        rs = (rs & ~(1 << u)) | (((x >> l) & 1) << u);
        xs = (xs & ~(1 << l)) | (((r >> u) & 1) << l);
      }
      src[v][e] = ((sig << c) | rs) * RQ_PAD + xs;
    }
  }
  const long long off = rowoff + (tid & 7) * E;  // + 8 E v: this thread's units
  const int sl = s * RQ_PAD + (tid & 7) * E;
  // The unit's tiles for this thread's slot: a (its own) and b = P(a);
  // `one`: it loads tile 0 (a, or b to fresh planes) and writes tile a;
  // `two`: it also swaps a with b in place. `load_unit` sets them for a unit
  // and issues its loads into v0*, v1*, which the loop stores to shared
  // memory before the next unit's loads are issued over them.
  long long a = 0, b = 0;
  bool one = false, two = false;
  Vec16<T> v0r[U], v0i[U], v1r[U], v1i[U];
  auto load_unit = [&](long long unit) {
    const long long t0 = unit << (5 - c);
    const long long b0 = tile_base(t0, p);
    const unsigned long long m = (((b0 >> lo0) ^ (b0 >> hi0)) & 1LL ? mk0 : 0ULL) |
                                 (((b0 >> lo1) ^ (b0 >> hi1)) & 1LL ? mk1 : 0ULL);
    const unsigned ml = __reduce_or_sync(0xffffffffu, (unsigned)m);
    const unsigned mh = __reduce_or_sync(0xffffffffu, (unsigned)(m >> 32));
    a = b0 | dsig;
    b = (b0 ^ (long long)(((unsigned long long)mh << 32) | ml)) | pdsig;
    const bool active = unit < units && t0 + sig < p.tiles;
    one = active && (fresh || a <= b);
    two = active && !fresh && a < b;
    const long long at0 = fresh ? b : a;
    if (one) {
#pragma unroll
      for (int v = 0; v < U; ++v) {
        v0r[v].u = *reinterpret_cast<const uint4*>(sr + at0 + off + 8 * E * v);
        v0i[v].u = *reinterpret_cast<const uint4*>(si + at0 + off + 8 * E * v);
      }
    }
    if (two) {
#pragma unroll
      for (int v = 0; v < U; ++v) {
        v1r[v].u = *reinterpret_cast<const uint4*>(sr + b + off + 8 * E * v);
        v1i[v].u = *reinterpret_cast<const uint4*>(si + b + off + 8 * E * v);
      }
    }
  };
  long long unit = blockIdx.x;
  load_unit(unit);
  for (; unit < units; unit += gridDim.x) {
    // also the barrier between the last unit's reads of shared memory and
    // this unit's writes
    if (!__syncthreads_or(one)) {
      load_unit(unit + gridDim.x);
      continue;
    }
    const bool cone = one, ctwo = two;
    const long long ca = a, cb = b;
    if (one) {
#pragma unroll
      for (int v = 0; v < U; ++v) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sm[0][0][sl + 8 * E * v + e] = v0r[v].e[e];
          sm[0][1][sl + 8 * E * v + e] = v0i[v].e[e];
        }
      }
    }
    if (two) {
#pragma unroll
      for (int v = 0; v < U; ++v) {
#pragma unroll
        for (int e = 0; e < E; ++e) {
          sm[1][0][sl + 8 * E * v + e] = v1r[v].e[e];
          sm[1][1][sl + 8 * E * v + e] = v1i[v].e[e];
        }
      }
    }
    load_unit(unit + gridDim.x);  // in flight while this unit is stored
    __syncthreads();
    if (cone) {
      const T* fr = sm[ctwo ? 1 : 0][0];
      const T* fi = sm[ctwo ? 1 : 0][1];
#pragma unroll
      for (int v = 0; v < U; ++v) {
        Vec16<T> wr, wi;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          wr.e[e] = fr[src[v][e]];
          wi.e[e] = fi[src[v][e]];
        }
        *reinterpret_cast<uint4*>(dr + ca + off + 8 * E * v) = wr.u;
        *reinterpret_cast<uint4*>(di + ca + off + 8 * E * v) = wi.u;
      }
    }
    if (ctwo) {
#pragma unroll
      for (int v = 0; v < U; ++v) {
        Vec16<T> wr, wi;
#pragma unroll
        for (int e = 0; e < E; ++e) {
          wr.e[e] = sm[0][0][src[v][e]];
          wi.e[e] = sm[0][1][src[v][e]];
        }
        *reinterpret_cast<uint4*>(dr + cb + off + 8 * E * v) = wr.u;
        *reinterpret_cast<uint4*>(di + cb + off + 8 * E * v) = wi.u;
      }
    }
  }
}

template <typename T>
static int cross_launch(const void* xr, const void* xi, void* yr, void* yi, long long units,
                        const CrossPlan& p, cudaStream_t st) {
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, cross_row_swap_kernel<T>, 256, 0);
  long long blocks = (long long)RQ_CROSS_WAVES * sms * (per > 0 ? per : 1);
  if (blocks > units) blocks = units;
  cross_row_swap_kernel<T><<<(unsigned)blocks, 256, 0, st>>>(
      reinterpret_cast<const T*>(xr), reinterpret_cast<const T*>(xi),
      reinterpret_cast<T*>(yr), reinterpret_cast<T*>(yi), units, p);
  return (int)cudaGetLastError();
}

// xr, xi: the source planes, 2^n elements each (n >= 9, 128 lanes a row),
// 16-byte aligned; yr, yi: the destination, equal to xr, xi in place.
// elem_bytes 4 or 8. lo[t] < hi[t]: every pair as flat index bits,
// disjoint; fbit[u], lbit[u]: the c <= 5 cross pairs whose lane bit is
// below 5, as (row bit, lane bit), by row bit. units = ceil(tiles / 2^(5-c))
// blocks of work, tiles = 2^(n-5-c).
extern "C" int rq_cross_row_swap(const void* xr, const void* xi, void* yr, void* yi,
                                 int elem_bytes, int npairs, const int* lo, const int* hi,
                                 int c, const int* fbit, const int* lbit, long long tiles,
                                 long long units, void* stream) {
  if (npairs < 0 || npairs > RQ_CROSS_MAX_PAIRS || c < 0 || c > 5 || units <= 0 ||
      tiles <= 0)
    return (int)cudaErrorInvalidValue;
  CrossPlan p;
  p.npairs = npairs;
  for (int t = 0; t < RQ_CROSS_MAX_PAIRS; ++t) {
    p.lo[t] = t < npairs ? lo[t] : 0;
    p.hi[t] = t < npairs ? hi[t] : 0;
  }
  p.c = c;
  for (int u = 0; u < 5; ++u) {
    p.fbit[u] = u < c ? fbit[u] : 0;
    p.lbit[u] = u < c ? lbit[u] : 0;
  }
  p.tiles = tiles;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (elem_bytes == 4) return cross_launch<float>(xr, xi, yr, yi, units, p, st);
  if (elem_bytes == 8) return cross_launch<double>(xr, xi, yr, yi, units, p, st);
  return (int)cudaErrorInvalidValue;
}

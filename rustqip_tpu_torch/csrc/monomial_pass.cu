// Monomial pass for Hopper (sm_90a): applies an op whose matrix has one
// nonzero in every row and column (a permutation of the values of its k
// target bits, each moved amplitude times a phase), on the (R, 128) float32
// re/im planes of a state, in place, to the segments whose control bits
// are all 1.
//
// Replaces no TPU kernel: the JAX package runs such an op as a dense
// matrix product over the whole state (Shor's controlled modular
// multiplications, rustqip_tpu/algos/shor.py, as 2^k x 2^k 0/1 matrices),
// and so did the port (real_apply._dense_ri: 128 x 128 block products of
// every strip pair, then a select against the input for the control).
//
// What bounds it on an H100: device-memory bytes. A segment is the 2^k
// amplitudes that the target bits span with every other bit fixed; the op
// maps each segment onto itself. The least work is one read and one write
// of both planes of every segment the controls select: 2^(n - c) amplitudes
// for c controls, 2^(n-c) x 2 planes x 4 B x 2 bytes, 17.2 GB for one
// control at n = 31, 5.13 ms at 3.35 TB/s.
//
// What the design does about it. A block owns a tile: whole segments, 2^11
// amplitudes at least (the segments that differ in the lowest bits that are
// neither target nor control), so no two blocks share a segment and the
// pass is safe in place. The tile's index bits are its flat index bits in
// ascending order, so where the targets hold the lowest bits (Shor's work
// register holds the 7 lanes and 3 row bits) consecutive threads read and
// write consecutive addresses, 16 bytes a thread. The block loads a tile
// into shared memory, synchronises, and writes each place from the
// shared-memory slot of its source times its phase; the loads of its next
// tile are issued before this one is stored, so they fly meanwhile. Every
// address and source comes from small tables the host works out once per
// op (the flat offset of a tile index by two table lookups, the source of
// a place by two more), which the block copies to shared memory once.
// Products are rounded one by one (no fused multiply-add), so the kernel
// computes what the plain torch version computes, bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

#define RQ_MONO_MAX_TILE_BITS 12
#define RQ_MONO_LO_BITS 7
#define RQ_MONO_LO (1 << RQ_MONO_LO_BITS)
#define RQ_MONO_HI (1 << (RQ_MONO_MAX_TILE_BITS - RQ_MONO_LO_BITS))
#define RQ_MONO_THREADS 256
#define RQ_MONO_MAX_OUTER 32
// Blocks launched per block resident at once.
#define RQ_MONO_WAVES 8

struct MonoPlan {
  int tile_bits;  // index bits of a tile: the k targets and the lowest free bits
  int k;          // target bits
  int tmask;      // the tile index bits that are target bits
  int n_outer;    // the other free bits, which number the tiles
  int outer[RQ_MONO_MAX_OUTER];  // their flat index bits, ascending
  long long cval;   // the control bits, all 1, as a flat index
  long long tiles;  // 2^n_outer
};

// The tables, in this order (32-bit words; offsets are unsigned):
//   off_lo[RQ_MONO_LO], off_hi[RQ_MONO_HI]: the flat offset of a tile index
//     e is off_lo[e & (LO-1)] + off_hi[e >> LO_BITS];
//   sl_lo[RQ_MONO_LO], sl_hi[RQ_MONO_HI]: its segment-local index s (bit b of
//     s is the b-th target bit, ascending), sl_lo[...] | sl_hi[...];
//   src[2^k]: the tile index bits, at the target positions, of the source of
//     place s (the other bits of e carry over);
//   with phases, ph_re[2^k] and ph_im[2^k] (float32): the factor of place s.
#define RQ_MONO_HEAD (2 * RQ_MONO_LO + 2 * RQ_MONO_HI)

template <bool VEC>
struct Lane;
template <>
struct Lane<true> {
  typedef float4 T;
  static constexpr int W = 4;
};
template <>
struct Lane<false> {
  typedef float T;
  static constexpr int W = 1;
};

__device__ __forceinline__ long long tile_base(long long tile, const MonoPlan& p) {
  long long b = p.cval;
  for (int j = 0; j < p.n_outer; ++j) b |= ((tile >> j) & 1LL) << p.outer[j];
  return b;
}

__device__ __forceinline__ long long tile_off(const unsigned* off_lo, const unsigned* off_hi,
                                              int e) {
  return (long long)off_lo[e & (RQ_MONO_LO - 1)] + (long long)off_hi[e >> RQ_MONO_LO_BITS];
}

__device__ __forceinline__ float get(const float4& v, int w) {
  return w == 0 ? v.x : w == 1 ? v.y : w == 2 ? v.z : v.w;
}
__device__ __forceinline__ float get(const float& v, int) { return v; }
__device__ __forceinline__ void put(float4& v, int w, float x) {
  if (w == 0) v.x = x;
  else if (w == 1) v.y = x;
  else if (w == 2) v.z = x;
  else v.w = x;
}
__device__ __forceinline__ void put(float& v, int, float x) { v = x; }

template <bool VEC, bool PHASE>
__global__ void __launch_bounds__(RQ_MONO_THREADS)
    monomial_pass_kernel(float* xr, float* xi, const unsigned* tables, MonoPlan p) {
  typedef typename Lane<VEC>::T T;
  constexpr int W = Lane<VEC>::W;
  constexpr int PER = (1 << RQ_MONO_MAX_TILE_BITS) / (RQ_MONO_THREADS * W);
  extern __shared__ unsigned smem[];
  const int E = 1 << p.tile_bits;
  const int S = 1 << p.k;
  const int ntab = RQ_MONO_HEAD + S * (PHASE ? 3 : 1);
  for (int i = threadIdx.x; i < ntab; i += RQ_MONO_THREADS) smem[i] = tables[i];
  const unsigned* off_lo = smem;
  const unsigned* off_hi = off_lo + RQ_MONO_LO;
  const unsigned* sl_lo = off_hi + RQ_MONO_HI;
  const unsigned* sl_hi = sl_lo + RQ_MONO_LO;
  const unsigned* src = sl_hi + RQ_MONO_HI;
  const float* ph_re = reinterpret_cast<const float*>(src + S);
  const float* ph_im = ph_re + S;
  // the tile, 16-byte aligned: ntab words rounded up to 4
  float* tr = reinterpret_cast<float*>(smem + ((ntab + 3) & ~3));
  float* ti = tr + E;
  const int units = E / W;
  const int keep = ~p.tmask;
  __syncthreads();

  T vr[PER], vi[PER];
  long long tile = blockIdx.x;
  if (tile < p.tiles) {
    const long long base = tile_base(tile, p);
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = threadIdx.x + i * RQ_MONO_THREADS;
      if (u < units) {
        const long long a = base + tile_off(off_lo, off_hi, u * W);
        vr[i] = *reinterpret_cast<const T*>(xr + a);
        vi[i] = *reinterpret_cast<const T*>(xi + a);
      }
    }
  }
  for (; tile < p.tiles; tile += gridDim.x) {
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = threadIdx.x + i * RQ_MONO_THREADS;
      if (u < units) {
        *reinterpret_cast<T*>(tr + u * W) = vr[i];
        *reinterpret_cast<T*>(ti + u * W) = vi[i];
      }
    }
    __syncthreads();
    const long long base = tile_base(tile, p);
    const long long next = tile + gridDim.x;
    if (next < p.tiles) {
      const long long nbase = tile_base(next, p);
#pragma unroll
      for (int i = 0; i < PER; ++i) {
        const int u = threadIdx.x + i * RQ_MONO_THREADS;
        if (u < units) {
          const long long a = nbase + tile_off(off_lo, off_hi, u * W);
          vr[i] = *reinterpret_cast<const T*>(xr + a);
          vi[i] = *reinterpret_cast<const T*>(xi + a);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int u = threadIdx.x + i * RQ_MONO_THREADS;
      if (u < units) {
        T wr, wi;
#pragma unroll
        for (int w = 0; w < W; ++w) {
          const int e = u * W + w;
          const int s = (int)(sl_lo[e & (RQ_MONO_LO - 1)] | sl_hi[e >> RQ_MONO_LO_BITS]);
          const int j = (e & keep) | (int)src[s];
          const float a = tr[j];
          const float b = ti[j];
          if (PHASE) {
            const float c = ph_re[s];
            const float d = ph_im[s];
            put(wr, w, __fsub_rn(__fmul_rn(a, c), __fmul_rn(b, d)));
            put(wi, w, __fadd_rn(__fmul_rn(a, d), __fmul_rn(b, c)));
          } else {
            put(wr, w, a);
            put(wi, w, b);
          }
        }
        const long long a = base + tile_off(off_lo, off_hi, u * W);
        *reinterpret_cast<T*>(xr + a) = wr;
        *reinterpret_cast<T*>(xi + a) = wi;
      }
    }
    __syncthreads();
  }
}

template <bool VEC, bool PHASE>
static int mono_launch(float* xr, float* xi, const unsigned* tables, const MonoPlan& p,
                       cudaStream_t st) {
  const int S = 1 << p.k;
  const int ntab = RQ_MONO_HEAD + S * (PHASE ? 3 : 1);
  const size_t smem = 4 * (size_t)((ntab + 3) & ~3) + 2 * 4 * ((size_t)1 << p.tile_bits);
  cudaError_t err = cudaFuncSetAttribute(monomial_pass_kernel<VEC, PHASE>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, sms = 0, per = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, monomial_pass_kernel<VEC, PHASE>,
                                                RQ_MONO_THREADS, smem);
  long long blocks = (long long)RQ_MONO_WAVES * sms * (per > 0 ? per : 1);
  if (blocks > p.tiles) blocks = p.tiles;
  monomial_pass_kernel<VEC, PHASE><<<(unsigned)blocks, RQ_MONO_THREADS, smem, st>>>(
      xr, xi, tables, p);
  return (int)cudaGetLastError();
}

// xr, xi: the float32 planes, 16-byte aligned. tables: the device tables
// above. tile_bits <= 12 (k <= tile_bits), tmask: the tile index bits that
// are targets; outer[0 .. n_outer): the flat bits that number the tiles,
// ascending; cval: the control bits as a flat index. vec: the tile's two
// lowest index bits are flat bits 0 and 1, so four consecutive tile
// indices are four consecutive floats.
extern "C" int rq_monomial_pass(void* xr, void* xi, const void* tables, int tile_bits, int k,
                                int tmask, int n_outer, const int* outer, long long cval,
                                int has_phase, int vec, void* stream) {
  if (tile_bits < 0 || tile_bits > RQ_MONO_MAX_TILE_BITS || k < 1 || k > tile_bits ||
      n_outer < 0 || n_outer > RQ_MONO_MAX_OUTER || (vec && tile_bits < 2))
    return (int)cudaErrorInvalidValue;
  MonoPlan p;
  p.tile_bits = tile_bits;
  p.k = k;
  p.tmask = tmask;
  p.n_outer = n_outer;
  for (int j = 0; j < RQ_MONO_MAX_OUTER; ++j) p.outer[j] = j < n_outer ? outer[j] : 0;
  p.cval = cval;
  p.tiles = 1LL << n_outer;
  float* r = reinterpret_cast<float*>(xr);
  float* i = reinterpret_cast<float*>(xi);
  const unsigned* t = reinterpret_cast<const unsigned*>(tables);
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (vec) {
    return has_phase ? mono_launch<true, true>(r, i, t, p, st)
                     : mono_launch<true, false>(r, i, t, p, st);
  }
  return has_phase ? mono_launch<false, true>(r, i, t, p, st)
                   : mono_launch<false, false>(r, i, t, p, st);
}

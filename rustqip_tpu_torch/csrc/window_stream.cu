// Strip-window sweep for Hopper (sm_90a), register-streaming path: windows
// whose steps are all strip-local (mix, diag, cmix) run here, every other
// window on the tile path of csrc/window_sweep.cu. Both interpret the same
// step program (engine/window_kernel.py: encode_window is the one writer;
// WindowProgram.path says which kernel a window takes).
//
// Replaces, with the tile path, the JAX package's Pallas kernel
// rustqip_tpu/engine/pallas_kernels.py: _window_sweep_pipelined (:1029,
// pallas_call at :1112) / window_sweep (:1155, pallas_call at :1262) with
// body _window_kernel_body (:308).
//
// What bounds it on an H100: device-memory bytes. A window reads the strips
// some step consumes and writes the strips some step changes, once each, so
// a sweep costs (reads + writes) * strip bytes at 3.35 TB/s (1.28 ms for
// all 16 strips of an n = 28 state). The arithmetic is small beside it: a
// mix term is 2 or 4 FMAs per element, a diag step one complex product.
// What is not small is the work of interpreting the program: the JAX kernel
// specialises each window's chain at trace time, this kernel reads it at
// run time, and every instruction spent decoding it is issue time taken
// from the arithmetic.
//
// What the design does about it. Every step it takes combines the strips at
// one (row, lane) position and nothing else: mix and cmix sum strips at the
// same position, diag scales each element. So no thread needs another's
// data and no step needs a barrier. A warp owns one strip-local row t and
// 32 * L lanes of it (L = 4 up to 8 strips, L = 2 at 16: half a row); each
// thread holds L neighbouring lanes of all 2^h strips in registers,
// 2^(h+1) * L floats, loaded with one vector load per strip and plane
// (neighbouring threads on neighbouring lanes, so every load is coalesced),
// runs the whole step chain on them, and stores the strips it changed in
// place (each thread reads its addresses before it writes them; positions
// are disjoint). CTAs are four warps, so several sit on each SM and their
// loads in flight cover the latency that one 8-warp CTA per SM (the tile
// path) cannot.
//
// A register can only be named by a constant, so code that picks strips by
// a runtime index is unrolled over the strips, and code size is the cost:
// with every strip loop of a 16-strip chain unrolled the kernel is some
// 370 KB, more than the SM's instruction caches hold, and runs slower than
// the tile path. Only the strip loops that write registers are unrolled,
// and the steps take three forms:
// * butterflies, unrolled over the 2^(h-1) pairs of each window-index bit
//   (a template argument): a cmix record, and a mix whose coefficient
//   matrix the encoder factored into one 2x2 matrix per window bit
//   (QFT's H on one bit is one butterfly, Grover's H on four bits four).
//   Per-lane controls become identity coefficients, row controls one
//   uniform test per pair.
// * any other mix: its terms, by output strip (mask of input strips, type
//   bits, coefficients in input order), in a runtime loop over the terms
//   of each output with no branch in its body: the inputs are staged in
//   this thread's own slots of shared memory (private, so still no
//   barrier), read back by index, and each output lands in a named
//   register. One or real terms take 2 products, a row of imaginary terms
//   2 and one rotation by i, others 4 (JAX: _scalar_pair).
// * diag: everything about a row is uniform in a warp. The row angle of
//   each strip (the constant plus up to ~40 row monomials) is summed once
//   per warp: lane l takes strip l % 2^h and every (32 / 2^h)-th monomial,
//   a shuffle butterfly adds the parts, one sincosf. When every strip's
//   lane factor is one of two (QFT's), the two are loaded once and each
//   strip is scaled by its row factor times its lane factor, unrolled;
//   otherwise a loop over the strips parks each factor in the slots.
// Offsets are 64-bit (an element offset overflows int32 at n >= 31).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;
constexpr int REC = 8;
constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;
constexpr int DIAG_ENT = 6;  // ints of a per-strip diag entry

enum Kind { K_MIX = 0, K_DIAG = 2, K_CMIX = 5 };

struct Params {
  float* xr;
  float* xi;
  const int* iprog;
  const float* fprog;
  long long srows;  // rows per strip
  int nsteps;
  int in_mask;
  int out_mask;
  int pos[4];          // absolute row bit of window bit j (strip bit h-1-j)
  unsigned soff[16];   // row bits of strip i's window bits
};

template <int L>
__device__ __forceinline__ void load(const float* p, float (&v)[L]) {
  if constexpr (L == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x; v[1] = t.y;
  }
}

// Read-only program data (lane factors), through the read-only cache.
template <int L>
__device__ __forceinline__ void load_ro(const float* p, float (&v)[L]) {
  if constexpr (L == 4) {
    const float4 t = __ldg(reinterpret_cast<const float4*>(p));
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    const float2 t = __ldg(reinterpret_cast<const float2*>(p));
    v[0] = t.x; v[1] = t.y;
  }
}

template <int L>
__device__ __forceinline__ void store(float* p, const float (&v)[L]) {
  if constexpr (L == 4)
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
}

// Row bits of strip i's window bits, for a runtime i.
template <int H>
__device__ __forceinline__ unsigned strip_off(const Params& P, int i) {
  unsigned o = 0;
#pragma unroll
  for (int j = 0; j < H; ++j)
    if ((i >> (H - 1 - j)) & 1) o |= 1u << P.pos[j];
  return o;
}

// This thread's own slots of shared memory: slot (i, plane) holds L floats
// at ((2 i + plane) * THREADS + t) * L, neighbouring threads on
// neighbouring addresses (conflict-free vector accesses).
template <int L>
struct Slots {
  float* base;  // this thread's slot (0, 0)
  __device__ float* re(int i) const { return base + (2 * i) * THREADS * L; }
  __device__ float* im(int i) const { return base + (2 * i + 1) * THREADS * L; }
};

// y0 = a x0 + b x1, y1 = c x0 + d x1 on the pairs (j0, j0 | 2^PB) of the
// low strips in `pairs` whose row holds the row controls rm; `cf` holds
// (a, b, c, d) as (re, im). Lanes off the col controls cm take the
// identity (exact for finite values: 1 * x + 0 * ...).
template <int NS, int L, int H, int PB>
__device__ __forceinline__ void butterfly(const Params& P, unsigned pairs,
                                          unsigned rm, unsigned cm,
                                          const float* cf, unsigned base,
                                          int c0, float (&vr)[NS][L],
                                          float (&vi)[NS][L]) {
  if constexpr (PB < H) {
    float k[8][L];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const float v = __ldg(cf + q);
      const float id = (q == 0 || q == 6) ? 1.0f : 0.0f;
#pragma unroll
      for (int l = 0; l < L; ++l)
        k[q][l] = (((unsigned)(c0 + l) & cm) == cm) ? v : id;
    }
#pragma unroll
    for (int j0 = 0; j0 < NS; ++j0) {
      if (j0 & (1 << PB)) continue;
      if (!((pairs >> j0) & 1)) continue;
      if (((base | P.soff[j0]) & rm) != rm) continue;
      constexpr int SB = 1 << PB;
      const int j1 = j0 | SB;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float x0r = vr[j0][l], x0i = vi[j0][l];
        const float x1r = vr[j1][l], x1i = vi[j1][l];
        vr[j0][l] = k[0][l] * x0r - k[1][l] * x0i + k[2][l] * x1r - k[3][l] * x1i;
        vi[j0][l] = k[0][l] * x0i + k[1][l] * x0r + k[2][l] * x1i + k[3][l] * x1r;
        vr[j1][l] = k[4][l] * x0r - k[5][l] * x0i + k[6][l] * x1r - k[7][l] * x1i;
        vi[j1][l] = k[4][l] * x0i + k[5][l] * x0r + k[6][l] * x1i + k[7][l] * x1r;
      }
    }
  }
}

template <int NS, int L, int H>
__device__ __forceinline__ void butterfly_bit(const Params& P, int bit,
                                              unsigned pairs, unsigned rm,
                                              unsigned cm, const float* cf,
                                              unsigned base, int c0,
                                              float (&vr)[NS][L],
                                              float (&vi)[NS][L]) {
  switch (bit) {
    case 0: butterfly<NS, L, H, 0>(P, pairs, rm, cm, cf, base, c0, vr, vi); break;
    case 1: butterfly<NS, L, H, 1>(P, pairs, rm, cm, cf, base, c0, vr, vi); break;
    case 2: butterfly<NS, L, H, 2>(P, pairs, rm, cm, cf, base, c0, vr, vi); break;
    default: butterfly<NS, L, H, 3>(P, pairs, rm, cm, cf, base, c0, vr, vi); break;
  }
}

// MIX record: a0 = int offset of NS per-output entries (input mask, type
// bits, float offset of the coefficients in input order, class: 0 = every
// term one or real, 1 = every term imaginary, 2 = any other); a1 = K, the
// number of butterflies the coefficient matrix factors into (0: it does
// not), a2 = int offset of their K window-index bits, a3 = float offset of
// their K x (a, b, c, d).
template <int NS, int L, int H>
__device__ __forceinline__ void mix_step(const Params& P, const Slots<L>& S,
                                         const int* rec, int active,
                                         unsigned base, int c0,
                                         float (&vr)[NS][L],
                                         float (&vi)[NS][L]) {
  const int nb = __ldg(rec + 3);
  if (nb) {
    const int* bits = P.iprog + __ldg(rec + 4);
    const float* cf = P.fprog + __ldg(rec + 5);
    for (int q = 0; q < nb; ++q)
      butterfly_bit<NS, L, H>(P, __ldg(bits + q), FULL, 0u, 0u, cf + 8 * q, base, c0,
                              vr, vi);
    return;
  }
  const int4* ent = reinterpret_cast<const int4*>(P.iprog + __ldg(rec + 2));
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    store<L>(S.re(i), vr[i]);
    store<L>(S.im(i), vi[i]);
  }
#pragma unroll
  for (int j = 0; j < NS; ++j) {
    if (!((active >> j) & 1)) continue;
    const int4 e = __ldg(ent + j);
    const float* cf = P.fprog + e.z;
    unsigned m = (unsigned)e.x;
    const int cnt = __popc(m);
    float ar[L], ai[L];
#pragma unroll
    for (int l = 0; l < L; ++l) ar[l] = ai[l] = 0.0f;
    if (e.w < 2) {
      const float* w = cf + e.w;  // the real parts, or the imaginary ones
#pragma unroll 1
      for (int k = 0; k < cnt; ++k) {
        const int i = __ffs(m) - 1;
        m &= m - 1;
        const float c = __ldg(w + 2 * k);
        float x[L], y[L];
        load<L>(S.re(i), x);
        load<L>(S.im(i), y);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          ar[l] += c * x[l];
          ai[l] += c * y[l];
        }
      }
      if (e.w == 1) {
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float t = ar[l];
          ar[l] = -ai[l];
          ai[l] = t;
        }
      }
    } else {
#pragma unroll 1
      for (int k = 0; k < cnt; ++k) {
        const int i = __ffs(m) - 1;
        m &= m - 1;
        const float2 c = __ldg(reinterpret_cast<const float2*>(cf) + k);
        float x[L], y[L];
        load<L>(S.re(i), x);
        load<L>(S.im(i), y);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          ar[l] += c.x * x[l] - c.y * y[l];
          ai[l] += c.x * y[l] + c.y * x[l];
        }
      }
    }
#pragma unroll
    for (int l = 0; l < L; ++l) {
      vr[j][l] = ar[l];
      vi[j][l] = ai[l];
    }
  }
}

// DIAG record: a0 = int offset of NS x 6 per-strip entries (int offset,
// float offset, row monomials nr, groups G, angle mode, lane-part float
// offset), as the tile path; a1 = 1 when some entry is in angle mode;
// a2 = 1 when every entry is in factor mode with no group and its lane
// part is at a3 or at a4, a5 = the strips whose lane part is at a4.
template <int NS, int L, int H>
__device__ __forceinline__ void diag_step(const Params& P, const Slots<L>& S,
                                          const int* rec, int active,
                                          unsigned base, int lane, int c0,
                                          float (&vr)[NS][L],
                                          float (&vi)[NS][L]) {
  constexpr int PARTS = 32 / NS;
  const int* per = P.iprog + __ldg(rec + 2);
  // Lane l sums part l / NS of the row angle of strip si = l % NS.
  const int si = lane % NS, part = lane / NS;
  float ang = 0.0f;
  int mode = 0;
  if ((active >> si) & 1) {
    const int* e = per + DIAG_ENT * si;
    const int io = __ldg(e), fo = __ldg(e + 1), nr = __ldg(e + 2);
    mode = __ldg(e + 4);
    const int* rmk = P.iprog + io;
    const float* fl = P.fprog + fo;
    const unsigned row = base | strip_off<H>(P, si);
    if (part == 0) ang = __ldg(fl);
#pragma unroll 4
    for (int m = part; m < nr; m += PARTS) {
      const unsigned rm = (unsigned)__ldg(rmk + m);
      const float c = __ldg(fl + 1 + m);
      ang += (row & rm) == rm ? c : 0.0f;
    }
  }
#pragma unroll
  for (int o = NS; o < 32; o <<= 1) ang += __shfl_xor_sync(FULL, ang, o);
  float cs = 1.0f, sn = 0.0f;
  if (!mode) sincosf(ang, &sn, &cs);

  if (__ldg(rec + 4)) {
    float lr[2][L], li[2][L];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      const float* lanep = P.fprog + __ldg(rec + 5 + q);
      load_ro<L>(lanep + c0, lr[q]);
      load_ro<L>(lanep + C + c0, li[q]);
    }
    const unsigned second = (unsigned)__ldg(rec + 7);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      if (!((active >> i) & 1)) continue;
      const float fr = __shfl_sync(FULL, cs, i), fi = __shfl_sync(FULL, sn, i);
      const bool q = (second >> i) & 1;
#pragma unroll
      for (int l = 0; l < L; ++l) {
        const float a = q ? lr[1][l] : lr[0][l], b = q ? li[1][l] : li[0][l];
        const float pr = fr * a - fi * b, pi = fr * b + fi * a;
        const float x = vr[i][l], y = vi[i][l];
        vr[i][l] = x * pr - y * pi;
        vi[i][l] = x * pi + y * pr;
      }
    }
    return;
  }

  // The general case: a loop over the active strips parks each one's
  // factor at this thread's lanes in its slots (lane factor, then the
  // mixed groups whose row mask holds, in the tile path's order; or, in
  // angle mode, one sincosf of the summed angles per element); then the
  // strips are scaled in registers.
  for (unsigned act = (unsigned)active; act; act &= act - 1) {
    const int i = __ffs(act) - 1;
    const int* e = per + DIAG_ENT * i;
    const int io = __ldg(e), nr = __ldg(e + 2);
    const int G = __ldg(e + 3), md = __ldg(e + 4);
    const int* gm = P.iprog + io + nr;
    const float* lanep = P.fprog + __ldg(e + 5);
    const unsigned row = base | strip_off<H>(P, i);
    float pr[L], pi[L];
    if (!md) {
      const float fr = __shfl_sync(FULL, cs, i), fi = __shfl_sync(FULL, sn, i);
      float lr[L], li[L];
      load_ro<L>(lanep + c0, lr);
      load_ro<L>(lanep + C + c0, li);
#pragma unroll
      for (int l = 0; l < L; ++l) {
        pr[l] = fr * lr[l] - fi * li[l];
        pi[l] = fr * li[l] + fi * lr[l];
      }
      for (int k = 0; k < G; ++k) {
        const unsigned m = (unsigned)__ldg(gm + k);
        if ((row & m) != m) continue;
        float gr[L], gi[L];
        load_ro<L>(lanep + 2 * C * (1 + k) + c0, gr);
        load_ro<L>(lanep + 2 * C * (1 + k) + C + c0, gi);
#pragma unroll
        for (int l = 0; l < L; ++l) {
          const float t = pr[l] * gr[l] - pi[l] * gi[l];
          pi[l] = pr[l] * gi[l] + pi[l] * gr[l];
          pr[l] = t;
        }
      }
    } else {
      const float ra = __shfl_sync(FULL, ang, i);
      float a[L];
      load_ro<L>(lanep + c0, a);
#pragma unroll
      for (int l = 0; l < L; ++l) a[l] = ra + a[l];
      for (int k = 0; k < G; ++k) {
        const unsigned m = (unsigned)__ldg(gm + k);
        if ((row & m) != m) continue;
        float g[L];
        load_ro<L>(lanep + C * (1 + k) + c0, g);
#pragma unroll
        for (int l = 0; l < L; ++l) a[l] += g[l];
      }
#pragma unroll
      for (int l = 0; l < L; ++l) sincosf(a[l], &pi[l], &pr[l]);
    }
    store<L>(S.re(i), pr);
    store<L>(S.im(i), pi);
  }
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (!((active >> i) & 1)) continue;
    float pr[L], pi[L];
    load<L>(S.re(i), pr);
    load<L>(S.im(i), pi);
#pragma unroll
    for (int l = 0; l < L; ++l) {
      const float x = vr[i][l], y = vi[i][l];
      vr[i][l] = x * pr[l] - y * pi[l];
      vi[i][l] = x * pi[l] + y * pr[l];
    }
  }
}

template <int NS, int L>
__global__ void __launch_bounds__(THREADS)
window_stream_kernel(const Params P) {
  constexpr int H = NS == 1 ? 0 : NS == 2 ? 1 : NS == 4 ? 2 : NS == 8 ? 3 : 4;
  constexpr int CHUNKS = C / (32 * L);  // warps per strip row
  const int lane = threadIdx.x & 31;
  const long long unit = (long long)blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (unit >= P.srows * CHUNKS) return;
  const int c0 = (int)(unit % CHUNKS) * 32 * L + lane * L;
  // Absolute row of strip 0: the strip-local row with a 0 inserted at each
  // window bit, lowest position first.
  unsigned base = (unsigned)(unit / CHUNKS);
#pragma unroll
  for (int j = H - 1; j >= 0; --j) {
    const int p = P.pos[j];
    base = ((base >> p) << (p + 1)) | (base & ((1u << p) - 1u));
  }

  extern __shared__ __align__(16) float smem[];
  const Slots<L> S{smem + threadIdx.x * L};

  float vr[NS][L], vi[NS][L];
#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if ((P.in_mask >> i) & 1) {
      const size_t off = (size_t)(base | P.soff[i]) * C + c0;
      load<L>(P.xr + off, vr[i]);
      load<L>(P.xi + off, vi[i]);
    } else {
#pragma unroll
      for (int l = 0; l < L; ++l) vr[i][l] = vi[i][l] = 0.0f;
    }
  }

  for (int s = 0; s < P.nsteps; ++s) {
    const int* rec = P.iprog + s * REC;
    const int kind = __ldg(rec), active = __ldg(rec + 1);
    if (kind == K_MIX) {
      mix_step<NS, L, H>(P, S, rec, active, base, c0, vr, vi);
    } else if (kind == K_DIAG) {
      diag_step<NS, L, H>(P, S, rec, active, base, lane, c0, vr, vi);
    } else {  // K_CMIX: a0 = pair bit, a1 = row controls, a2 = col controls,
              // a3 = float offset of (a, b, c, d); active = the low strips
      butterfly_bit<NS, L, H>(P, __ldg(rec + 2), (unsigned)active,
                              (unsigned)__ldg(rec + 3), (unsigned)__ldg(rec + 4),
                              P.fprog + __ldg(rec + 5), base, c0, vr, vi);
    }
  }

#pragma unroll
  for (int i = 0; i < NS; ++i) {
    if (!((P.out_mask >> i) & 1)) continue;
    const size_t off = (size_t)(base | P.soff[i]) * C + c0;
    store<L>(P.xr + off, vr[i]);
    store<L>(P.xi + off, vi[i]);
  }
}

template <int NS, int L>
int launch(const Params& p, cudaStream_t st) {
  const long long units = p.srows * (C / (32 * L));
  const long long blocks = (units + WARPS - 1) / WARPS;
  const int smem = NS * 2 * THREADS * L * (int)sizeof(float);  // the slots
  cudaError_t err = cudaFuncSetAttribute(
      window_stream_kernel<NS, L>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  window_stream_kernel<NS, L><<<(unsigned)blocks, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the CUDA error code of
// the launch (0 = launched). p0..p3: the row bit of each window bit
// (window_kernel._window_row_positions); srows: rows per strip.
extern "C" int rq_window_stream(float* xr, float* xi, const int* iprog,
                                const float* fprog, int h, int nsteps,
                                int in_mask, int out_mask, int p0, int p1,
                                int p2, int p3, long long srows,
                                void* stream) {
  Params p;
  p.xr = xr;
  p.xi = xi;
  p.iprog = iprog;
  p.fprog = fprog;
  p.srows = srows;
  p.nsteps = nsteps;
  p.in_mask = in_mask;
  p.out_mask = out_mask;
  p.pos[0] = p0;
  p.pos[1] = p1;
  p.pos[2] = p2;
  p.pos[3] = p3;
  // _strip_index_map's interleave: window bit j is strip index bit h-1-j
  for (int i = 0; i < 16; ++i) {
    p.soff[i] = 0;
    for (int j = 0; j < h; ++j)
      if ((i >> (h - 1 - j)) & 1) p.soff[i] |= 1u << p.pos[j];
  }
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (h) {
    case 0: return launch<1, 4>(p, st);
    case 1: return launch<2, 4>(p, st);
    case 2: return launch<4, 4>(p, st);
    case 3: return launch<8, 4>(p, st);
    case 4: return launch<16, 2>(p, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

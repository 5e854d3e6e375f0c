// Strip-window sweep for Hopper (sm_90a), tile path: one read and one write
// of the live strips of a (R, 128) float32 re/im state, with a whole chain
// of gate steps applied in shared memory in between. Windows whose steps
// are all strip-local (mix, diag, cmix) take the register-streaming path,
// csrc/window_stream.cu, instead; this path keeps every window with a row
// butterfly or a matrix step.
//
// Replaces the JAX package's Pallas kernel
// rustqip_tpu/engine/pallas_kernels.py: _window_sweep_pipelined (:1029,
// pallas_call at :1112) / window_sweep (:1155) with body _window_kernel_body
// (:308), and c64_low_matmul (:1328) as its one-"low"-step case.
//
// What bounds it on an H100. Element-wise steps (mix, cbf, rbf, cmix, diag)
// are bound by device-memory bytes: a window reads the strips some step
// consumes and writes the strips some step changes, once each
// (window_strip_activity), so a sweep costs (reads + writes) * strip bytes
// at 3.35 TB/s. Matrix steps ("low", "lowr", matrix blocks of "rmix") do a
// 128x128 product per row: at FP32-equivalent precision that is 3 TF32
// tensor-core products per real product (3xTF32), 6 for a real B on both
// planes and 9 for a complex B (Karatsuba: 3 real products), i.e.
// 0.83 / 1.25 ms of 495 TFLOP/s tensor work per full-state step at n = 28,
// next to its 1.28 ms of bytes.
//
// What the design does about it. A CTA owns `bt` consecutive strip-local
// rows of every strip, all 128 lanes, both planes, in dynamic shared memory
// (2^h strips x bt x 1 KiB, from the HopperSmemAdmission budget). It loads
// the input strips with cp.async (the whole tile in flight at once), runs
// every step on the tile with a barrier between steps, and stores only the
// output strips, in place (each CTA reads all of its addresses before it
// writes them and tiles are disjoint). The step chain is not compiled per
// window: the host encodes each window once into a step program (int32
// records + float32 coefficients + deduplicated 128x128 matrix operands)
// and this one kernel, instantiated per window width h, interprets it.
// Offsets are 64-bit (an element offset overflows int32 at n >= 31).
//
// * Matrix steps run on the tensor cores with mma.sync.m16n8k8 in 3xTF32,
//   the counterpart of the TPU's Precision.HIGHEST: each FP32 operand x is
//   split into hi = tf32(x) and lo = tf32(x - hi) and the product is
//   lo*hi + hi*lo + hi*hi in FP32 accumulators (plain TF32 is never used).
//   A step's GEMM M dimension is all its output rows at once (active
//   strips x bt, <= 128), taken in passes of 32 or 64 rows whose
//   accumulators live in registers. B streams from L2 in chunks of 16 k,
//   double-buffered: each thread loads its part of the next chunk into
//   registers while the tensor cores work on the current one, then splits
//   it into hi/lo once per CTA as it stores it to shared memory (the A
//   tile is split as each lane reads its fragments). A complex B uses
//   Karatsuba: xr.Br, xi.Bi and (xr + xi).(Br + Bi). "low"/"lowr" write a
//   pass back in place after the barrier that ends its last chunk (every
//   read of those rows is done); "rmix" accumulates, per output strip,
//   only the input strips whose block is the staged matrix, adds its
//   scalar blocks and writes the rmix scratch. The k order inside a chunk
//   is permuted (A and B alike) so that each lane reads its A and B
//   fragments with one 16-byte load per two mma k-steps.
// * "mix" turns its outputs' term lists into an NS x NS coefficient table
//   (in each thread's registers up to 4 strips, in shared memory above);
//   every element then runs the unrolled NS x NS loop over that table,
//   predicated on the term masks.
// * "diag" keeps the separable structure of the TPU kernel's diag_factors:
//   per strip, one row angle per tile row (bt sincosf, in shared memory),
//   one 128-entry complex lane factor and one 128-entry complex lane vector
//   per row-support group of mixed monomials, all made on the host; an
//   element is multiplied by rowfac[r] * lanefac[c] * the vectors of the
//   groups whose row mask holds. Above DIAG_MASK_MAX groups (the JAX
//   default, 4) the entry holds angles instead and each element takes one
//   sincosf of their sum, as the TPU kernel's diag_phase does.
//
// Step program (engine/window_kernel.py: encode_window is the one writer):
// record i = iprog[8*i .. 8*i+8) = {kind, active strip mask, a0..a5}.
//   MIX  (0): a0 = int offset of NS per-output entries (input mask, type
//             bits, float offset, row class; 16-byte aligned): output j
//             sums its inputs i in the mask,
//             each times the next (re, im) of its coefficient list (8-byte
//             aligned), folded by type (2 bits per i: 0 = one, 1 = real,
//             2 = imaginary, 3 = complex; JAX: _scalar_pair). This path
//             turns the lists into an NS x NS table first.
//   RMIX (1): a0 = int offset of NS x NS (type, payload) terms; type 1 =
//             complex scalar at fprog[payload], 2 = real matrix mats[payload],
//             3 = complex matrix mats[payload] (re), mats[payload + 1] (im);
//             a1 = int offset of the step's distinct matrix operands as
//             (payload, complex) pairs, a2 = their count, a3 = 1 when any is
//             complex (three accumulator sets, Karatsuba).
//   DIAG (2): a1 = 1 when some entry is in angle mode (read by the
//             register path);
//             a0 = int offset of NS x 6 per-strip entries (int offset,
//             float offset, row monomial count nr, group count G, angle
//             mode, lane-part float offset). ints: nr row masks, then G
//             group row masks. floats: the constant and nr row
//             coefficients; at the lane-part offset (16-byte aligned,
//             shared by entries with equal parts) the lane part, then G
//             group parts; a part is 128 re + 128 im factors, or 128 angles
//             in angle mode (G > DIAG_MASK_MAX). A row mask rm holds on a
//             row when row & rm == rm.
//   CBF  (3) / RBF (4): a0 = lane / row bit p, a1 = row control mask,
//             a2 = col control mask, a3 = float offset of (a, b, c, d).
//   CMIX (5): a0 = window-index bit of the pair, a1..a3 as CBF; the active
//             mask names the pair's low strip.
//   LOW  (6) / LOWR (7): a0 = operand index (complex: re, im at a0, a0 + 1).
// Matrix operands are B itself, row-major: mats[idx][c][k] is the weight of
// input lane k in output lane c (out = x @ B^T); a complex operand is
// followed by its im part and by re + im (the plain version's Karatsuba
// operand; the kernel forms the same fp32 sum as it stages B).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;
constexpr int REC = 8;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int HEADER = 256;  // bytes before the tile: strip base rows
constexpr int KC = 16;       // matrix steps: k per staged chunk of B
constexpr int NCHUNK = C / KC;
constexpr int BPART = C * KC;     // words of one staged part (hi or lo)
constexpr int DIAG_MASK_MAX = 4;  // most groups an entry holds as factors
constexpr int DIAG_ENT = 6;       // ints of a per-strip diag entry

enum Kind { K_MIX = 0, K_RMIX = 1, K_DIAG = 2, K_CBF = 3, K_RBF = 4,
            K_CMIX = 5, K_LOW = 6, K_LOWR = 7 };

struct Params {
  float* xr;
  float* xi;
  const int* iprog;
  const float* fprog;
  const float* mats;
  long long seg[5];
  int h;
  int nsteps;
  int bt;
  int in_mask;
  int out_mask;
  int scratch;
};

struct Tile {
  float* base;
  int bt;
  __device__ float* re(int i) const { return base + (size_t)(2 * i) * bt * C; }
  __device__ float* im(int i) const { return base + (size_t)(2 * i + 1) * bt * C; }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src));
}

__device__ __forceinline__ bool ctrl_on(unsigned row, int col, unsigned rm,
                                        unsigned cm) {
  return (row & rm) == rm && ((unsigned)col & cm) == cm;
}

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r;
}

// x = hi + lo within 2^-22 |x|; both halves are exact TF32 values.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// One A fragment (16 x 8, row-major) split into TF32 hi and lo.
struct Frag {
  uint32_t hi[4];
  uint32_t lo[4];
};

// Fragment of mma k-step s from the float4s a lane read of rows g and g+8
// (chunk-relative k = 4q .. 4q+3): the k order inside a chunk is permuted
// so that k-slot q of step s is k = 4q + 2s and k-slot q+4 is 4q + 2s + 1,
// for A and B alike.
__device__ __forceinline__ void make_frag(Frag& f, float4 v0, float4 v1, int s) {
  split(s ? v0.z : v0.x, f.hi[0], f.lo[0]);
  split(s ? v1.z : v1.x, f.hi[1], f.lo[1]);
  split(s ? v0.w : v0.y, f.hi[2], f.lo[2]);
  split(s ? v1.w : v1.y, f.hi[3], f.lo[3]);
}

// d += A B in 3xTF32: lo*hi + hi*lo + hi*hi (the lo*lo term is dropped).
__device__ __forceinline__ void mma3(float (&d)[4], const Frag& a, uint4 bh,
                                     uint4 bl, int s) {
  const uint32_t h0 = s ? bh.z : bh.x, h1 = s ? bh.w : bh.y;
  const uint32_t l0 = s ? bl.z : bl.x, l1 = s ? bl.w : bl.y;
  mma_tf32(d, a.lo, h0, h1);
  mma_tf32(d, a.hi, l0, l1);
  mma_tf32(d, a.hi, h0, h1);
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(a.x + b.x, a.y + b.y, a.z + b.z, a.w + b.w);
}

// B chunk in registers on its way from L2 to shared memory (register
// double buffering: the next chunk's loads are in flight while the tensor
// cores work on the current one).
struct BStage {
  float4 r[2];
  float4 i[2];
};

__device__ __forceinline__ void stage_load(BStage& st, const float* mats,
                                           int idx, bool cplx, int kc,
                                           int tid) {
  const float* br = mats + (size_t)idx * C * C;
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = tid + THREADS * u;
    const int off = (e >> 2) * C + kc * KC + 4 * (e & 3);
    st.r[u] = __ldg(reinterpret_cast<const float4*>(br + off));
    st.i[u] = cplx ? __ldg(reinterpret_cast<const float4*>(br + C * C + off))
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

__device__ __forceinline__ void split_store(uint32_t* hi, uint32_t* lo,
                                            float4 v) {
  uint4 h, l;
  split(v.x, h.x, l.x);
  split(v.y, h.y, l.y);
  split(v.z, h.z, l.z);
  split(v.w, h.w, l.w);
  *reinterpret_cast<uint4*>(hi) = h;
  *reinterpret_cast<uint4*>(lo) = l;
}

// Stage layout: part p (0 = re, 1 = im, 2 = re + im) x (hi, lo) at
// buf + (2p + hl) * BPART, each [output lane c][16 k]. Three-set steps stage
// all three parts (a real B there has im = 0 and re + im = re).
__device__ __forceinline__ void stage_store(uint32_t* buf, const BStage& st,
                                            bool three, int tid) {
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int e = tid + THREADS * u;
    const int soff = (e >> 2) * KC + 4 * (e & 3);
    split_store(buf + soff, buf + BPART + soff, st.r[u]);
    if (three) {
      split_store(buf + 2 * BPART + soff, buf + 3 * BPART + soff, st.i[u]);
      split_store(buf + 4 * BPART + soff, buf + 5 * BPART + soff,
                  add4(st.r[u], st.i[u]));
    }
  }
}

// One matrix step on the tensor cores. Output rows are the rows of the
// strips in `outm` (M = popcount * bt), taken in passes of 32 or 64 rows:
// warp (wm, wn) of a WM x WN grid owns 32 rows x (8 NT) lanes, in two
// m16 blocks. Terms: "low"/"lowr" (terms == nullptr) map each strip
// through operand `low_idx`; "rmix" sums terms[j][i] over input strips i,
// matrices through the tensor cores and scalars in the epilogue, into the
// scratch tile S. Two accumulator sets (re, im planes; all-real steps) or
// three (Karatsuba: a = xr.Br, b = xi.Bi, c = (xr + xi).(Br + Bi); out =
// (a - b, c - a - b)).
template <int NS>
__device__ void matrix_step(const Params& P, const Tile& T, const Tile& S,
                            uint32_t* bbuf, int outm, const int* terms,
                            int low_idx, bool low_cplx, const int* mlist,
                            int nmat, bool three) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bt = P.bt;
  const float* fprog = P.fprog;
  const int M = __popc(outm) * bt;
  const int stage_words = (three ? 6 : 2) * BPART;
  const int cpp = nmat * NCHUNK;  // chunks per pass

  auto mat_of = [&](int m, int& idx, bool& cplx) {
    if (terms) {
      idx = mlist[2 * m];
      cplx = mlist[2 * m + 1] != 0;
    } else {
      idx = low_idx;
      cplx = low_cplx;
    }
  };

  for (int base = 0; base < M;) {
    const int WM = (M - base > 32) ? 2 : 1;
    const int WN = WARPS / WM;
    const int NT = (C / 8) / WN;  // 4 or 2 n-tiles of 8 lanes per warp
    const int wm = warp / WN, wn = warp % WN;
    const int n0 = wn * NT * 8;
    // This lane's four output rows: [m16 block][half] -> (strip, row).
    int rj[2][2], rr[2][2];
    bool rok[2][2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int v = base + wm * 32 + mb * 16 + hf * 8 + g;
        rok[mb][hf] = v < M;
        int nth = rok[mb][hf] ? v / bt : 0, j = 0;
        for (int t = 0; t < NS; ++t) {
          if ((outm >> t) & 1) {
            if (nth == 0) {
              j = t;
              break;
            }
            --nth;
          }
        }
        rj[mb][hf] = j;
        rr[mb][hf] = v % bt;
      }
    }
    float acc[3][2][4][4];
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[a][mb][nt][e] = 0.0f;

    if (cpp) {
      BStage st;
      int idx;
      bool cplx;
      mat_of(0, idx, cplx);
      stage_load(st, P.mats, idx, cplx, 0, tid);
      stage_store(bbuf, st, three, tid);
      __syncthreads();
      unsigned use_mask[2][2] = {{0u, 0u}, {0u, 0u}};
      for (int w = 0; w < cpp; ++w) {
        const int m = w / NCHUNK, kc = w % NCHUNK;
        if (w + 1 < cpp) {
          int idx2;
          bool cplx2;
          mat_of((w + 1) / NCHUNK, idx2, cplx2);
          stage_load(st, P.mats, idx2, cplx2, (w + 1) % NCHUNK, tid);
        }
        mat_of(m, idx, cplx);
        const uint32_t* B = bbuf + (w & 1) * stage_words;
        if (terms && kc == 0) {
          // Input strips whose block through this matrix reaches this
          // lane's rows, per [m16 block][half].
#pragma unroll
          for (int mb = 0; mb < 2; ++mb)
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              unsigned mk = 0;
              if (rok[mb][hf])
                for (int i = 0; i < NS; ++i) {
                  const int* tm = terms + 2 * (rj[mb][hf] * NS + i);
                  if (tm[0] >= 2 && tm[1] == idx) mk |= 1u << i;
                }
              use_mask[mb][hf] = mk;
            }
        }
#pragma unroll
        for (int mb = 0; mb < 2; ++mb) {
          unsigned bits =
              terms ? __reduce_or_sync(0xffffffffu, use_mask[mb][0] | use_mask[mb][1]) : 1u;
          while (bits) {
            const int i = __ffs(bits) - 1;
            bits &= bits - 1;
            bool use[2];
            int src[2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              use[hf] = terms ? ((use_mask[mb][hf] >> i) & 1) : rok[mb][hf];
              src[hf] = terms ? i : rj[mb][hf];
            }
            float4 ar[2], ai[2];
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              const size_t off = (size_t)rr[mb][hf] * C + kc * KC + 4 * q;
              const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
              ar[hf] = use[hf] ? *reinterpret_cast<const float4*>(T.re(src[hf]) + off) : z;
              ai[hf] = use[hf] ? *reinterpret_cast<const float4*>(T.im(src[hf]) + off) : z;
            }
#pragma unroll
            for (int s = 0; s < 2; ++s) {
              Frag fr, fi;
              make_frag(fr, ar[0], ar[1], s);
              make_frag(fi, ai[0], ai[1], s);
              if (!three) {
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                  if (nt >= NT) continue;
                  const int boff = (n0 + nt * 8 + g) * KC + 4 * q;
                  const uint4 bh = *reinterpret_cast<const uint4*>(B + boff);
                  const uint4 bl = *reinterpret_cast<const uint4*>(B + BPART + boff);
                  mma3(acc[0][mb][nt], fr, bh, bl, s);
                  mma3(acc[1][mb][nt], fi, bh, bl, s);
                }
              } else {
                Frag fs;
                make_frag(fs, add4(ar[0], ai[0]), add4(ar[1], ai[1]), s);
#pragma unroll
                for (int nt = 0; nt < 4; ++nt) {
                  if (nt >= NT) continue;
                  const int boff = (n0 + nt * 8 + g) * KC + 4 * q;
                  uint4 bh = *reinterpret_cast<const uint4*>(B + boff);
                  uint4 bl = *reinterpret_cast<const uint4*>(B + BPART + boff);
                  mma3(acc[0][mb][nt], fr, bh, bl, s);
                  if (cplx) {
                    bh = *reinterpret_cast<const uint4*>(B + 2 * BPART + boff);
                    bl = *reinterpret_cast<const uint4*>(B + 3 * BPART + boff);
                    mma3(acc[1][mb][nt], fi, bh, bl, s);
                  }
                  bh = *reinterpret_cast<const uint4*>(B + 4 * BPART + boff);
                  bl = *reinterpret_cast<const uint4*>(B + 5 * BPART + boff);
                  mma3(acc[2][mb][nt], fs, bh, bl, s);
                }
              }
            }
          }
        }
        if (w + 1 < cpp)
          stage_store(bbuf + ((w + 1) & 1) * stage_words, st, three, tid);
        // Ends every read of this chunk's stage and, after the last chunk,
        // every read of this pass's rows: "low" may then write them.
        __syncthreads();
      }
    }

    // Epilogue: this lane's (row, 2 lanes) pairs of every n-tile.
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (!rok[mb][hf]) continue;
        const int j = rj[mb][hf];
        const size_t rowoff = (size_t)rr[mb][hf] * C;
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          if (nt >= NT) continue;
          const int col = n0 + nt * 8 + 2 * q;
          float o[2][2];  // [plane][lane pair]
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const float a = acc[0][mb][nt][2 * hf + e];
            const float b = acc[1][mb][nt][2 * hf + e];
            if (three) {
              const float c = acc[2][mb][nt][2 * hf + e];
              o[0][e] = a - b;
              o[1][e] = c - a - b;
            } else {
              o[0][e] = a;
              o[1][e] = b;
            }
          }
          if (terms) {
            for (int i = 0; i < NS; ++i) {
              const int* tm = terms + 2 * (j * NS + i);
              if (tm[0] != 1) continue;
              const float cr = fprog[tm[1]], ci = fprog[tm[1] + 1];
              const float2 x = *reinterpret_cast<const float2*>(T.re(i) + rowoff + col);
              const float2 y = *reinterpret_cast<const float2*>(T.im(i) + rowoff + col);
              o[0][0] += cr * x.x - ci * y.x;
              o[0][1] += cr * x.y - ci * y.y;
              o[1][0] += cr * y.x + ci * x.x;
              o[1][1] += cr * y.y + ci * x.y;
            }
          }
          const Tile& D = terms ? S : T;
          *reinterpret_cast<float2*>(D.re(j) + rowoff + col) = make_float2(o[0][0], o[0][1]);
          *reinterpret_cast<float2*>(D.im(j) + rowoff + col) = make_float2(o[1][0], o[1][1]);
        }
      }
    }
    base += 32 * WM;
  }
}

// One mix step over the tile: each element reads its input strips, then
// writes its output strips (outputs read only old values: in place per
// element). coef(j, i) is the (re, im) weight of input i in output j.
template <int NS, typename Coef>
__device__ __forceinline__ void mix_elements(const Tile& T, int tid, int nel,
                                             int active, const int (&nz)[NS],
                                             int need, Coef coef) {
  for (int e = tid; e < nel; e += THREADS) {
    float vr[NS], vi[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      vr[i] = 0.0f;
      vi[i] = 0.0f;
      if ((need >> i) & 1) {
        vr[i] = T.re(i)[e];
        vi[i] = T.im(i)[e];
      }
    }
#pragma unroll
    for (int j = 0; j < NS; ++j) {
      if (!((active >> j) & 1)) continue;
      float ar = 0.0f, ai = 0.0f;
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        if ((nz[j] >> i) & 1) {
          const float2 c = coef(j, i);
          ar += c.x * vr[i] - c.y * vi[i];
          ai += c.x * vi[i] + c.y * vr[i];
        }
      }
      T.re(j)[e] = ar;
      T.im(j)[e] = ai;
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(THREADS, 1)
window_sweep_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* sbase = reinterpret_cast<long long*>(smem);
  const int bt = P.bt;
  const size_t tile_floats = (size_t)NS * 2 * bt * C;
  Tile T{reinterpret_cast<float*>(smem + HEADER), bt};
  Tile S{T.base + tile_floats, bt};  // rmix output scratch
  // After the tile (and scratch): staged B chunks, or diag row factors.
  float* aux = T.base + tile_floats * (P.scratch ? 2 : 1);
  const int tid = threadIdx.x;
  const int h = P.h;
  const int* iprog = P.iprog;
  const float* fprog = P.fprog;

  // Absolute first row of each strip's tile: _strip_index_map (:934).
  if (tid < NS) {
    long long tile = blockIdx.x;
    long long sl = P.seg[h] / bt;
    long long d = tile % sl;
    long long rest = tile / sl;
    long long coord[4] = {0, 0, 0, 0};
    for (int j = h - 1; j >= 0; --j) {
      coord[j] = rest % P.seg[j];
      rest /= P.seg[j];
    }
    long long blk = 0;
    for (int j = 0; j < h; ++j)
      blk = (blk * P.seg[j] + coord[j]) * 2 + ((tid >> (h - 1 - j)) & 1);
    sbase[tid] = (blk * sl + d) * bt;
  }
  __syncthreads();

  const int n4 = bt * C / 4;
  for (int i = 0; i < NS; ++i) {
    if (!((P.in_mask >> i) & 1)) continue;
    const float4* gr = reinterpret_cast<const float4*>(P.xr + sbase[i] * C);
    const float4* gi = reinterpret_cast<const float4*>(P.xi + sbase[i] * C);
    float4* tr = reinterpret_cast<float4*>(T.re(i));
    float4* ti = reinterpret_cast<float4*>(T.im(i));
    for (int e = tid; e < n4; e += THREADS) {
      cp_async16(tr + e, gr + e);
      cp_async16(ti + e, gi + e);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();

  const int nel = bt * C;

  for (int s = 0; s < P.nsteps; ++s) {
    const int* rec = iprog + s * REC;
    const int kind = rec[0];
    const int active = rec[1];

    if (kind == K_MIX) {
      // The outputs' term lists as an NS x NS table of (re, im), 0 where a
      // term is absent (a stored one, real or imaginary coefficient has its
      // other part 0, so the 4-product MAC gives exactly the folded
      // products): up to 4 strips in each thread's registers, read once per
      // step; above that expanded into aux once per CTA and step.
      const int* ent = iprog + rec[2];
      int need = 0;
      int nz[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        nz[j] = ((active >> j) & 1) ? ent[4 * j] : 0;
        need |= nz[j];
      }
      if constexpr (NS <= 4) {
        float2 ct[NS][NS];
#pragma unroll
        for (int j = 0; j < NS; ++j)
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            const int k = __popc(nz[j] & ((1u << i) - 1u));  // terms before i
            ct[j][i] = ((nz[j] >> i) & 1)
                ? *reinterpret_cast<const float2*>(fprog + ent[4 * j + 2] + 2 * k)
                : make_float2(0.0f, 0.0f);
          }
        mix_elements<NS>(T, tid, nel, active, nz, need,
                         [&](int j, int i) { return ct[j][i]; });
      } else {
        float* tab = aux;
        for (int j = tid; j < NS; j += THREADS) {
          const float* cf = fprog + ent[4 * j + 2];
          for (int i = 0; i < NS; ++i) {
            const bool on = (nz[j] >> i) & 1;
            tab[2 * (j * NS + i)] = on ? cf[0] : 0.0f;
            tab[2 * (j * NS + i) + 1] = on ? cf[1] : 0.0f;
            cf += on ? 2 : 0;
          }
        }
        __syncthreads();
        const float2* __restrict__ ctab = reinterpret_cast<const float2*>(tab);
        mix_elements<NS>(T, tid, nel, active, nz, need,
                         [&](int j, int i) { return ctab[j * NS + i]; });
      }
    } else if (kind == K_RMIX) {
      matrix_step<NS>(P, T, S, reinterpret_cast<uint32_t*>(aux), active,
                      iprog + rec[2], 0, false, iprog + rec[3], rec[4],
                      rec[5] != 0);
      __syncthreads();
      for (int j = 0; j < NS; ++j) {
        if (!((active >> j) & 1)) continue;
        for (int e = tid; e < nel; e += THREADS) {
          T.re(j)[e] = S.re(j)[e];
          T.im(j)[e] = S.im(j)[e];
        }
      }
    } else if (kind == K_DIAG) {
      const int* per = iprog + rec[2];
      // Row factors (cos, sin) or row angles of every active strip row:
      // bt sincosf per strip, not bt x 128.
      for (int idx = tid; idx < NS * bt; idx += THREADS) {
        const int i = idx / bt, r = idx - i * bt;
        if (!((active >> i) & 1)) continue;
        const int* ent = per + DIAG_ENT * i;
        const unsigned* rmk = reinterpret_cast<const unsigned*>(iprog + ent[0]);
        const float* fl = fprog + ent[1];
        const unsigned row = (unsigned)(sbase[i] + r);
        float ang = fl[0];
        for (int m = 0; m < ent[2]; ++m)
          if ((row & rmk[m]) == rmk[m]) ang += fl[1 + m];
        if (ent[4]) {
          aux[2 * idx] = ang;
        } else {
          float sn, cs;
          sincosf(ang, &sn, &cs);
          aux[2 * idx] = cs;
          aux[2 * idx + 1] = sn;
        }
      }
      __syncthreads();
      const int c = tid & (C - 1);
      for (int i = 0; i < NS; ++i) {
        if (!((active >> i) & 1)) continue;
        const int* ent = per + DIAG_ENT * i;
        const int nr = ent[2], G = ent[3];
        const unsigned* gm = reinterpret_cast<const unsigned*>(iprog + ent[0] + nr);
        const float* lanep = fprog + ent[5];
        const long long b = sbase[i];
        const float* rowv = aux + 2 * i * bt;
        float* xr = T.re(i);
        float* xi = T.im(i);
        if (!ent[4]) {
          const float lr = lanep[c], li = lanep[C + c];
          float gr[DIAG_MASK_MAX], gi[DIAG_MASK_MAX];
          unsigned gmask[DIAG_MASK_MAX];
#pragma unroll
          for (int k = 0; k < DIAG_MASK_MAX; ++k) {
            const bool on = k < G;
            gr[k] = on ? lanep[2 * C * (1 + k) + c] : 1.0f;
            gi[k] = on ? lanep[2 * C * (1 + k) + C + c] : 0.0f;
            gmask[k] = on ? gm[k] : 0xffffffffu;
          }
          for (int e = tid; e < nel; e += THREADS) {
            const int r = e >> 7;
            const unsigned row = (unsigned)(b + r);
            const float fr = rowv[2 * r], fi = rowv[2 * r + 1];
            float pr = fr * lr - fi * li;
            float pi = fr * li + fi * lr;
#pragma unroll
            for (int k = 0; k < DIAG_MASK_MAX; ++k) {
              if (k < G && (row & gmask[k]) == gmask[k]) {
                const float tr = pr * gr[k] - pi * gi[k];
                pi = pr * gi[k] + pi * gr[k];
                pr = tr;
              }
            }
            const float x = xr[e], y = xi[e];
            xr[e] = x * pr - y * pi;
            xi[e] = x * pi + y * pr;
          }
        } else {
          const float la = lanep[c];
          for (int e = tid; e < nel; e += THREADS) {
            const int r = e >> 7;
            const unsigned row = (unsigned)(b + r);
            float ang = rowv[2 * r] + la;
            for (int k = 0; k < G; ++k)
              if ((row & gm[k]) == gm[k]) ang += lanep[C * (1 + k) + c];
            float sn, cs;
            sincosf(ang, &sn, &cs);
            const float x = xr[e], y = xi[e];
            xr[e] = x * cs - y * sn;
            xi[e] = x * sn + y * cs;
          }
        }
      }
    } else if (kind == K_CBF || kind == K_RBF || kind == K_CMIX) {
      const int p = rec[2];
      const unsigned rm = (unsigned)rec[3];
      const unsigned cm = (unsigned)rec[4];
      const float* cf = fprog + rec[5];
      const float a_r = cf[0], a_i = cf[1], b_r = cf[2], b_i = cf[3];
      const float c_r = cf[4], c_i = cf[5], d_r = cf[6], d_i = cf[7];
      const int sbit = 1 << p;
      for (int i = 0; i < NS; ++i) {
        if (!((active >> i) & 1)) continue;
        const long long b = sbase[i];
        // Each thread owns both members of its pairs: in place, no races.
        const int npairs = (kind == K_CMIX) ? nel : nel / 2;
        for (int e = tid; e < npairs; e += THREADS) {
          float *p0r, *p0i, *p1r, *p1i;
          int off0, off1;
          unsigned row;
          int col;
          if (kind == K_CBF) {
            const int r = e >> 6, cl = e & 63;
            const int c0 = ((cl >> p) << (p + 1)) | (cl & (sbit - 1));
            off0 = r * C + c0;
            off1 = off0 + sbit;
            row = (unsigned)(b + r);
            col = c0;
            p0r = p1r = T.re(i);
            p0i = p1i = T.im(i);
          } else if (kind == K_RBF) {
            const int rl = e >> 7, c = e & (C - 1);
            const int r0 = ((rl >> p) << (p + 1)) | (rl & (sbit - 1));
            off0 = r0 * C + c;
            off1 = off0 + sbit * C;
            row = (unsigned)(b + r0);
            col = c;
            p0r = p1r = T.re(i);
            p0i = p1i = T.im(i);
          } else {
            const int j1 = i | sbit;
            off0 = off1 = e;
            row = (unsigned)(b + (e >> 7));
            col = e & (C - 1);
            p0r = T.re(i);
            p0i = T.im(i);
            p1r = T.re(j1);
            p1i = T.im(j1);
          }
          // Controls are disjoint from the target bit: one mask per pair.
          if (!ctrl_on(row, col, rm, cm)) continue;
          const float x0r = p0r[off0], x0i = p0i[off0];
          const float x1r = p1r[off1], x1i = p1i[off1];
          p0r[off0] = a_r * x0r - a_i * x0i + b_r * x1r - b_i * x1i;
          p0i[off0] = a_r * x0i + a_i * x0r + b_r * x1i + b_i * x1r;
          p1r[off1] = c_r * x0r - c_i * x0i + d_r * x1r - d_i * x1i;
          p1i[off1] = c_r * x0i + c_i * x0r + d_r * x1i + d_i * x1r;
        }
      }
    } else if (kind == K_LOW || kind == K_LOWR) {
      matrix_step<NS>(P, T, S, reinterpret_cast<uint32_t*>(aux), active,
                      nullptr, rec[2], kind == K_LOW, nullptr, 1,
                      kind == K_LOW);
    }
    __syncthreads();
  }

  for (int i = 0; i < NS; ++i) {
    if (!((P.out_mask >> i) & 1)) continue;
    float4* gr = reinterpret_cast<float4*>(P.xr + sbase[i] * C);
    float4* gi = reinterpret_cast<float4*>(P.xi + sbase[i] * C);
    const float4* tr = reinterpret_cast<const float4*>(T.re(i));
    const float4* ti = reinterpret_cast<const float4*>(T.im(i));
    for (int e = tid; e < n4; e += THREADS) {
      gr[e] = tr[e];
      gi[e] = ti[e];
    }
  }
}

template <int NS>
int launch(const Params& p, size_t smem, long long n_tiles, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      window_sweep_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_sweep_kernel<NS><<<(unsigned)n_tiles, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the CUDA error code of
// the launch (0 = launched). `scratch` doubles the tile for rmix windows;
// `aux_bytes` follow the tile for staged matrix chunks and diag row factors
// (WindowProgram.aux_bytes).
extern "C" int rq_window_sweep(float* xr, float* xi, const int* iprog,
                               const float* fprog, const float* mats, int h,
                               int nsteps, int bt, int in_mask, int out_mask,
                               int scratch, int aux_bytes, long long s0,
                               long long s1, long long s2, long long s3,
                               long long s4, long long n_tiles, void* stream) {
  Params p;
  p.xr = xr;
  p.xi = xi;
  p.iprog = iprog;
  p.fprog = fprog;
  p.mats = mats;
  p.seg[0] = s0;
  p.seg[1] = s1;
  p.seg[2] = s2;
  p.seg[3] = s3;
  p.seg[4] = s4;
  p.h = h;
  p.nsteps = nsteps;
  p.bt = bt;
  p.in_mask = in_mask;
  p.out_mask = out_mask;
  p.scratch = scratch;
  const size_t ns = (size_t)1 << h;
  const size_t smem = HEADER +
                      ns * 2 * (size_t)bt * C * sizeof(float) * (scratch ? 2 : 1) +
                      (size_t)aux_bytes;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (h) {
    case 0: return launch<1>(p, smem, n_tiles, st);
    case 1: return launch<2>(p, smem, n_tiles, st);
    case 2: return launch<4>(p, smem, n_tiles, st);
    case 3: return launch<8>(p, smem, n_tiles, st);
    case 4: return launch<16>(p, smem, n_tiles, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

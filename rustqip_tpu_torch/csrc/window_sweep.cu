// Strip-window sweep for Hopper (sm_90a): one read and one write of the
// live strips of a (R, 128) float32 re/im state, with a whole chain of gate
// steps applied in shared memory in between.
//
// Replaces the JAX package's Pallas kernel
// rustqip_tpu/engine/pallas_kernels.py: _window_sweep_pipelined (:1029,
// pallas_call at :1112) / window_sweep (:1155) with body _window_kernel_body
// (:308), and c64_low_matmul (:1328) as its one-"low"-step case.
//
// What bounds it on an H100: device-memory bytes. A window reads the strips
// some step consumes and writes the strips some step changes, once each
// (window_strip_activity), so a sweep costs (reads + writes) * strip bytes
// at 3.35 TB/s. Matrix steps ("low", "lowr", matrix blocks of "rmix") are
// the exception: a 128x128 complex product is 512 FMAs per amplitude, which
// makes them FP32-bound (67 TFLOP/s) rather than memory-bound.
//
// What the design does about it: a CTA owns `bt` consecutive strip-local
// rows of every strip, all 128 lanes, both planes, in dynamic shared memory
// (2^h strips x bt x 1 KiB, from the HopperSmemAdmission budget). It loads
// the input strips with 16-byte loads, runs every step on the tile with a
// barrier between steps, and stores only the output strips, in place
// (each CTA reads all of its addresses before it writes them and tiles are
// disjoint). The step chain is not compiled per window: the host encodes
// each window once into a step program (int32 records + float32
// coefficients + deduplicated 128x128 matrix operands) and this one kernel,
// instantiated per window width h, interprets it. Matrix products are plain
// FP32 FMAs (no TF32, no tensor cores) with each operand element loaded once
// per 16 rows. Offsets are 64-bit (an element offset overflows int32 at
// n >= 31).
//
// Step program (engine/window_kernel.py: encode_window is the one writer):
// record i = iprog[8*i .. 8*i+8) = {kind, active strip mask, a0..a5}.
//   MIX  (0): a0 = int offset of per-output input masks [NS],
//             a1 = float offset of an NS x NS complex coefficient table.
//   RMIX (1): a0 = int offset of NS x NS (type, payload) terms; type 1 =
//             complex scalar at fprog[payload], 2 = real matrix mats[payload],
//             3 = complex matrix mats[payload] (re), mats[payload + 1] (im).
//   DIAG (2): a0 = int offset of NS x (mono int offset, mono float offset,
//             count), a1 = float offset of NS per-strip constants. A monomial
//             is (row mask, col mask) ints + one float coefficient; the phase
//             is sincos(const + sum coeff * [row & rm == rm && col & cm == cm]).
//   CBF  (3) / RBF (4): a0 = lane / row bit p, a1 = row control mask,
//             a2 = col control mask, a3 = float offset of (a, b, c, d).
//   CMIX (5): a0 = window-index bit of the pair, a1..a3 as CBF; the active
//             mask names the pair's low strip.
//   LOW  (6) / LOWR (7): a0 = operand index (complex: re, im at a0, a0 + 1).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;
constexpr int REC = 8;
constexpr int THREADS = 256;
constexpr int HEADER = 256;  // bytes before the tile: strip base rows
constexpr int ROWS_PER_PASS = 16;  // matrix steps: rows sharing one operand load

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
};

struct Tile {
  float* base;
  int bt;
  __device__ float* re(int i) const { return base + (size_t)(2 * i) * bt * C; }
  __device__ float* im(int i) const { return base + (size_t)(2 * i + 1) * bt * C; }
};

__device__ __forceinline__ bool ctrl_on(unsigned row, int col, unsigned rm,
                                        unsigned cm) {
  return (row & rm) == rm && ((unsigned)col & cm) == cm;
}

// acc[p] += x[r_p, :] @ M[:, c] for the rows r_p = pb + g + 2p of one strip
// (M = B^T as stored by _window_matrix_operands; Mi == nullptr: real B).
template <bool COMPLEX>
__device__ __forceinline__ void mat_accumulate(const float* xr, const float* xi,
                                               const float* Mr, const float* Mi,
                                               int pb, int g, int c, int bt,
                                               float* ar, float* ai) {
  for (int k = 0; k < C; ++k) {
    float br = __ldg(Mr + k * C + c);
    float bi = COMPLEX ? __ldg(Mi + k * C + c) : 0.0f;
#pragma unroll
    for (int p = 0; p < ROWS_PER_PASS / 2; ++p) {
      int r = pb + g + 2 * p;
      if (r < bt) {
        float x = xr[r * C + k];
        float y = xi[r * C + k];
        if (COMPLEX) {
          ar[p] += x * br - y * bi;
          ai[p] += x * bi + y * br;
        } else {
          ar[p] += x * br;
          ai[p] += y * br;
        }
      }
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(THREADS)
window_sweep_kernel(Params P) {
  extern __shared__ __align__(16) unsigned char smem[];
  long long* sbase = reinterpret_cast<long long*>(smem);
  const int bt = P.bt;
  Tile T{reinterpret_cast<float*>(smem + HEADER), bt};
  Tile S{T.base + (size_t)NS * 2 * bt * C, bt};  // rmix output scratch
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
      tr[e] = gr[e];
      ti[e] = gi[e];
    }
  }
  __syncthreads();

  const int c_of = tid & (C - 1);
  const int g_of = tid >> 7;
  const int nel = bt * C;

  for (int s = 0; s < P.nsteps; ++s) {
    const int* rec = iprog + s * REC;
    const int kind = rec[0];
    const int active = rec[1];

    if (kind == K_MIX) {
      const int* nzm = iprog + rec[2];
      const float* coef = fprog + rec[3];
      int need = 0;
      int nz[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        nz[j] = ((active >> j) & 1) ? nzm[j] : 0;
        need |= nz[j];
      }
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
              float cr = coef[2 * (j * NS + i)];
              float ci = coef[2 * (j * NS + i) + 1];
              ar += cr * vr[i] - ci * vi[i];
              ai += cr * vi[i] + ci * vr[i];
            }
          }
          T.re(j)[e] = ar;
          T.im(j)[e] = ai;
        }
      }
    } else if (kind == K_RMIX) {
      const int* terms = iprog + rec[2];
      for (int j = 0; j < NS; ++j) {
        if (!((active >> j) & 1)) continue;
        for (int pb = 0; pb < bt; pb += ROWS_PER_PASS) {
          float ar[ROWS_PER_PASS / 2], ai[ROWS_PER_PASS / 2];
#pragma unroll
          for (int p = 0; p < ROWS_PER_PASS / 2; ++p) ar[p] = ai[p] = 0.0f;
          for (int i = 0; i < NS; ++i) {
            const int type = terms[2 * (j * NS + i)];
            const int pay = terms[2 * (j * NS + i) + 1];
            if (type == 1) {
              const float cr = fprog[pay], ci = fprog[pay + 1];
#pragma unroll
              for (int p = 0; p < ROWS_PER_PASS / 2; ++p) {
                int r = pb + g_of + 2 * p;
                if (r < bt) {
                  float x = T.re(i)[r * C + c_of], y = T.im(i)[r * C + c_of];
                  ar[p] += cr * x - ci * y;
                  ai[p] += cr * y + ci * x;
                }
              }
            } else if (type == 2) {
              mat_accumulate<false>(T.re(i), T.im(i),
                                    P.mats + (size_t)pay * C * C, nullptr,
                                    pb, g_of, c_of, bt, ar, ai);
            } else if (type == 3) {
              mat_accumulate<true>(T.re(i), T.im(i),
                                   P.mats + (size_t)pay * C * C,
                                   P.mats + (size_t)(pay + 1) * C * C,
                                   pb, g_of, c_of, bt, ar, ai);
            }
          }
#pragma unroll
          for (int p = 0; p < ROWS_PER_PASS / 2; ++p) {
            int r = pb + g_of + 2 * p;
            if (r < bt) {
              S.re(j)[r * C + c_of] = ar[p];
              S.im(j)[r * C + c_of] = ai[p];
            }
          }
        }
      }
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
      const float* consts = fprog + rec[3];
      for (int i = 0; i < NS; ++i) {
        if (!((active >> i) & 1)) continue;
        const int* mono = iprog + per[3 * i];
        const float* mcoef = fprog + per[3 * i + 1];
        const int cnt = per[3 * i + 2];
        const float c0 = consts[i];
        const long long b = sbase[i];
        for (int e = tid; e < nel; e += THREADS) {
          const unsigned row = (unsigned)(b + (e >> 7));
          const unsigned col = (unsigned)(e & (C - 1));
          float ang = c0;
          for (int m = 0; m < cnt; ++m) {
            const unsigned rm = (unsigned)mono[2 * m];
            const unsigned cm = (unsigned)mono[2 * m + 1];
            if ((row & rm) == rm && (col & cm) == cm) ang += mcoef[m];
          }
          float sn, cs;
          sincosf(ang, &sn, &cs);
          const float x = T.re(i)[e], y = T.im(i)[e];
          T.re(i)[e] = x * cs - y * sn;
          T.im(i)[e] = x * sn + y * cs;
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
      const float* Mr = P.mats + (size_t)rec[2] * C * C;
      const float* Mi = Mr + C * C;
      for (int i = 0; i < NS; ++i) {
        if (!((active >> i) & 1)) continue;
        for (int pb = 0; pb < bt; pb += ROWS_PER_PASS) {
          float ar[ROWS_PER_PASS / 2], ai[ROWS_PER_PASS / 2];
#pragma unroll
          for (int p = 0; p < ROWS_PER_PASS / 2; ++p) ar[p] = ai[p] = 0.0f;
          if (kind == K_LOW)
            mat_accumulate<true>(T.re(i), T.im(i), Mr, Mi, pb, g_of, c_of,
                                 bt, ar, ai);
          else
            mat_accumulate<false>(T.re(i), T.im(i), Mr, nullptr, pb, g_of,
                                  c_of, bt, ar, ai);
          __syncthreads();  // every read of these rows precedes the writes
#pragma unroll
          for (int p = 0; p < ROWS_PER_PASS / 2; ++p) {
            int r = pb + g_of + 2 * p;
            if (r < bt) {
              T.re(i)[r * C + c_of] = ar[p];
              T.im(i)[r * C + c_of] = ai[p];
            }
          }
          __syncthreads();
        }
      }
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
// the launch (0 = launched). `scratch` doubles the tile for rmix windows.
extern "C" int rq_window_sweep(float* xr, float* xi, const int* iprog,
                               const float* fprog, const float* mats, int h,
                               int nsteps, int bt, int in_mask, int out_mask,
                               int scratch, long long s0, long long s1,
                               long long s2, long long s3, long long s4,
                               long long n_tiles, void* stream) {
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
  const size_t ns = (size_t)1 << h;
  const size_t smem =
      HEADER + ns * 2 * (size_t)bt * C * sizeof(float) * (scratch ? 2 : 1);
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

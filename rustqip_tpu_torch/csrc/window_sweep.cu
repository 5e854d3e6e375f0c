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
// at 3.35 TB/s; inside a CTA each step is one pass over the tile in shared
// memory. Matrix steps ("low", "lowr", matrix blocks of "rmix") do a
// 128x128 product per row at FP32-equivalent precision: 3 TF32 tensor-core
// products per real product (3xTF32), 2 real products for a real B on
// both planes, 3 for a complex B by Karatsuba (the plain version's form),
// i.e. 0.83 / 1.25 ms of 495 TFLOP/s tensor work per full-state step at
// n = 28 next to its 1.28 ms of bytes. Every CTA also reads B itself per
// tile: 128 KiB (real) or 256 KiB (complex) of split B from L2.
//
// What the design does about it (the design before it ran mma.sync
// m16n8k8, issue-bound at one 8-warp CTA per SM, split A and B per
// element in every CTA, and ran load, steps and store in series).
// * A CTA is two warpgroups (256 threads), one per SM: the matrix step's
//   accumulators take the registers. It holds `group` consecutive tiles of
//   `bt` rows of every strip (both planes; up to 128 rows in all, 64 with
//   an rmix scratch) in dynamic shared memory, as slabs, each plane of a
//   slab one contiguous run of rows in device memory. Several tiles to a
//   CTA let the 8-row tiles of Grover's and the capacity circuit's h = 2
//   windows meet in one 128-row GEMM; the element-wise steps see disjoint
//   slabs.
// * Loads run on the TMA engine: one thread issues one bulk copy per slab
//   plane on an mbarrier, and at once the first chunks of the window's B
//   stream (below), so B arrives while the tile lands and the element-wise
//   steps before a matrix step run. Stores are plain 16-byte stores, in
//   place (each CTA reads all its addresses before it writes them and the
//   tiles are disjoint) or, when the caller passes them, to separate
//   output planes (c64_low_matmul leaves its input alone).
// * Matrix steps run on wgmma.mma_async (m64n128k8 or m64n64k8, tf32, A
//   from registers, B from shared memory) in 3xTF32: lo*hi + hi*lo +
//   hi*hi in FP32 accumulators (plain TF32 is never used), the
//   counterpart of the TPU's Precision.HIGHEST. Warpgroup w takes output
//   rows 64w .. 64w + 63 with all 128 lanes (at most 64 rows: both take the
//   rows and split the lanes). A: each thread reads the float4s of its two
//   rows, 16 k at a time, and splits them into TF32 hi and lo in registers
//   (the other warpgroup's wgmmas run meanwhile). B: split into hi and lo
//   once, on the host, as
//   cvt.rna.tf32.f32 rounds (encode_window: tf32_split), laid out as
//   wgmma's no-swizzle K-major core matrices, and streamed in chunks of 16
//   k (16 KiB real, 32 KiB complex) through a ring of two stages of bulk
//   copies; a stage is refilled once both warpgroups have finished its
//   chunk (a third or fourth stage measured no faster, and the shared
//   memory they take from L1 slows the element-wise steps). Two accumulator sets (re, im planes): a complex B takes four
//   real products, re = xr.Br - xi.Bi (wgmma scales A by -1), im = xr.Bi
//   + xi.Br, since Karatsuba's three sets of m64n128 accumulators would
//   not fit the registers. "rmix" sums, per output row and distinct
//   matrix, the input strips whose block is that matrix (one GEMM per
//   matrix), adds its scalar blocks and writes the scratch tile.
// * Element-wise steps take units of four lanes (a float4) of both members
//   of a pair: rbf two rows, cbf two lane quads (one quad for lane bits 0
//   and 1), cmix two strips; a thread loads two units before it computes.
//   diag keeps the separable structure of the TPU kernel's diag_factors:
//   per strip, one row factor per tile row (bt sincosf) and lane factors
//   held in each thread's registers for its lane quad; above
//   DIAG_MASK_MAX row-support groups (angle mode) each row's groups as
//   bits and one sincosf per element. A mix whose
//   matrix factors into one 2 x 2 per window bit (as the encoder finds it) runs
//   as butterflies over the strips, W lanes at a time; other mixes from an
//   NS x NS coefficient table. One barrier per step.
// * Offsets are 64-bit (an element offset overflows int32 at n >= 31).
//
// Step program (engine/window_kernel.py: encode_window is the one writer):
// record i = iprog[8*i .. 8*i+8) = {kind, active strip mask, a0..a5}.
//   MIX  (0): a0 = int offset of NS per-output entries (input mask, type
//             bits, float offset, row class; 16-byte aligned): output j
//             sums its inputs i in the mask, each times the next (re, im)
//             of its coefficient list (8-byte aligned), folded by type (2
//             bits per i: 0 = one, 1 = real, 2 = imaginary, 3 = complex;
//             JAX: _scalar_pair); a1 = the number of butterflies the
//             matrix factors into (0: it does not), a2 = int offset of
//             their window bits, a3 = float offset of their (a, b, c, d).
//   RMIX (1): a0 = int offset of NS x NS (type, payload) terms; type 1 =
//             complex scalar at fprog[payload], 2 = real matrix, 3 =
//             complex matrix (payload: its operand index); a1 = int offset
//             of the step's distinct matrix operands as (payload, complex)
//             pairs, a2 = their count, a3 = 1 when any is complex.
//   DIAG (2): a1 = 1 when some entry is in angle mode;
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
//   LOW  (6) / LOWR (7): a0 = operand index.
// Matrix steps consume the B stream (bstream) in order: 8 chunks per use
// (a low step; each distinct matrix of an rmix step), listed at chunk_tab
// as (16-byte offset, bytes). A chunk holds, for k = 16 kc .. 16 kc + 15
// of B (row c = output lane c), its hi part, its lo part and, for a
// complex B, the hi and lo of its imaginary part; in each part the two k8
// steps, each as 16 lane cores x 2 k cores of 8 lanes x 4 k.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 128;
constexpr int REC = 8;
constexpr int THREADS = 256;       // two warpgroups
constexpr int HEADER = 256;        // slab base rows, then the mbarriers
constexpr int BAR_OFF = 128;       // mbarriers: [0] the tile, [1 + s] B stage s
constexpr int MAX_STAGES = 2;
constexpr int SMALL_AUX = 2048;    // diag row factors, or the mix table
constexpr int KC = 16;             // matrix steps: k per B chunk
constexpr int NCHUNK = C / KC;
constexpr int PART_BYTES = C * KC * 4;  // one hi or lo part of a chunk
constexpr int KK_BYTES = PART_BYTES / 2;  // one k8 step of a part
constexpr int DIAG_MASK_MAX = 4;  // most groups an entry holds as factors
constexpr int DIAG_ENT = 6;       // ints of a per-strip diag entry
constexpr int UNITS = 2;          // butterfly units a thread loads before it computes

enum Kind { K_MIX = 0, K_RMIX = 1, K_DIAG = 2, K_CBF = 3, K_RBF = 4,
            K_CMIX = 5, K_LOW = 6, K_LOWR = 7 };

struct Params {
  const float* xr;  // input planes
  const float* xi;
  float* yr;        // output planes (the input ones: in place)
  float* yi;
  const int* iprog;
  const float* fprog;
  const float* bstream;  // B chunks, split and laid out for wgmma
  long long seg[5];
  int h;
  int nsteps;
  int bt;
  int group;       // tiles per CTA
  int in_mask;
  int out_mask;
  int scratch;
  int nstage;      // B stages in the ring
  int stage_bytes;
  int chunk_tab;   // int offset of (16-byte offset, bytes) per B chunk
  int nchunks;
};

// Slab s = (tile t of the CTA) * NS + strip i: bt rows x 128 lanes, re
// then im, each plane one contiguous run of bt rows in device memory.
struct Tile {
  float* base;
  int bt;
  __device__ float* re(int s) const { return base + (size_t)(2 * s) * bt * C; }
  __device__ float* im(int s) const { return base + (size_t)(2 * s + 1) * bt * C; }
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ float4 ldg4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float compc(const float4& v, int l) {
  return l == 0 ? v.x : l == 1 ? v.y : l == 2 ? v.z : v.w;
}

// ---------------------------------------------------------------------------
// mbarriers and bulk copies (the TMA engine)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

// Wait for the phase of `parity` to complete. A wait that does not end
// within about ten seconds traps (a launch error) instead of hanging.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  long long t0 = 0;
  for (int spin = 0;; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (spin == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 34)) asm volatile("trap;");
  }
}

// dst (shared) <- src (global), `bytes` a multiple of 16; completes on bar.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---------------------------------------------------------------------------
// 3xTF32 on wgmma
// ---------------------------------------------------------------------------

// d += (SA a) b on the tensor cores: wgmma m64n128k8, tf32 inputs, f32
// accumulators; a from registers, b by its shared-memory descriptor,
// SA = 1 or -1 (the instruction's scale of a).
template <int SA>
__device__ __forceinline__ void wgmma_n128(float (&d)[64], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, %70, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(SA));
}

// d += (SA a) b on the tensor cores: wgmma m64n64k8, tf32 inputs, f32
// accumulators; a from registers, b by its shared-memory descriptor,
// SA = 1 or -1 (the instruction's scale of a).
template <int SA>
__device__ __forceinline__ void wgmma_n64(float (&d)[32], const uint32_t (&a)[4],
                                           uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, %38, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1), "n"(SA));
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wg_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}
// Registers an asynchronous wgmma reads or writes stay put until here.
template <int N>
__device__ __forceinline__ void keep(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void keep(uint32_t (&a)[4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[i])::"memory");
}

template <int NN, int SA>
__device__ __forceinline__ void wgmma(float (&d)[NN / 2], const uint32_t (&a)[4],
                                      uint64_t b) {
  if constexpr (NN == 128) wgmma_n128<SA>(d, a, b);
  else wgmma_n64<SA>(d, a, b);
}

// Descriptor of one k8 step of a B part in shared memory, no swizzle,
// K-major: 8-lane x 16-byte core matrices, the two of one k8 step 128 B
// apart (LBO), the next 8 lanes 256 B on (SBO).
__device__ __forceinline__ uint64_t bdesc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(256 >> 4) << 32);
}

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

// d += SA A B in 3xTF32: lo*hi + hi*lo + hi*hi (the lo*lo term is
// dropped). B's hi part at `b`, its lo part one part on.
template <int NN, int SA = 1>
__device__ __forceinline__ void mma3(float (&d)[NN / 2], const uint32_t (&ah)[4],
                                     const uint32_t (&al)[4], uint32_t b) {
  wgmma<NN, SA>(d, al, bdesc(b));
  wgmma<NN, SA>(d, ah, bdesc(b + PART_BYTES));
  wgmma<NN, SA>(d, ah, bdesc(b));
}

// Issue B chunk c of the window's stream into its stage (one thread).
__device__ __forceinline__ void issue_chunk(const Params& P, unsigned char* stages,
                                            uint32_t bars, int c) {
  const int st = c % P.nstage;
  const int* tab = P.iprog + P.chunk_tab + 2 * c;
  const uint32_t bar = bars + 8 * (1 + st);
  mbar_expect_tx(bar, (uint32_t)tab[1]);
  bulk_load(smem_u32(stages + (size_t)st * P.stage_bytes),
            P.bstream + (size_t)tab[0] * 4, (uint32_t)tab[1], bar);
}

// The nth slab (from 0) whose strip is in mask m, in slab order.
template <int NS>
__device__ __forceinline__ int nth_slab(int m, int nth, int nslab) {
  for (int s = 0; s < nslab; ++s) {
    if ((m >> (s & (NS - 1))) & 1) {
      if (nth == 0) return s;
      --nth;
    }
  }
  return 0;
}

// One matrix step on the tensor cores. Output rows are the rows of the
// slabs whose strip is in `outm`, in slab order (M of them, <= 128).
// NN = 128: warpgroup w takes rows 64w.. with all 128 output lanes; NN =
// 64 (M <= 64): both take rows 0..63, warpgroup w the lanes 64w... Each
// thread holds two of the rows (warp rows g and g + 8). Per 16-k chunk it
// reads its A values from the tile, splits them into TF32 hi/lo in
// registers, and issues wgmma against the chunk's B parts (hi and lo,
// split on the host) in the stage ring. Two accumulator sets (re, im):
// a real B maps each plane; a complex B takes four real products, re =
// xr.Br - xi.Bi, im = xr.Bi + xi.Br. "low"/"lowr" (terms == nullptr)
// map every active slab through the window's next matrix; "rmix" sums,
// per output row and distinct matrix, the input strips whose block is that
// matrix (one GEMM per matrix), adds its scalar blocks and writes the
// scratch tile S.
template <int NS, int NN>
__device__ void matrix_step(const Params& P, const Tile& T, const Tile& S,
                            unsigned char* stages,
                            uint32_t bars, int outm, const int* terms,
                            const int* mlist, int nmat, bool low_cplx, int& gc) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7, wq = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3;
  const int bt = P.bt, nslab = P.group * NS;
  const int M = __popc(outm) * P.group * bt;
  const int rowbase = NN == 128 ? 64 * wg : 0;
  const int n0 = NN == 128 ? 0 : 64 * wg;
  const float* fprog = P.fprog;
  int vs[2], vr[2];
  bool vok[2];
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int v = rowbase + 16 * wq + g + 8 * hf;
    vok[hf] = v < M;
    vs[hf] = vok[hf] ? nth_slab<NS>(outm, v / bt, nslab) : 0;
    vr[hf] = v % bt;
  }
  float acc[2][NN / 2];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int e = 0; e < NN / 2; ++e) acc[a][e] = 0.0f;

  const int nm = terms ? nmat : 1;
  for (int m = 0; m < nm; ++m) {
    const bool cplx = terms ? mlist[2 * m + 1] != 0 : low_cplx;
    unsigned use[2] = {0u, 0u};
    if (terms) {
      const int idx = mlist[2 * m];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        if (!vok[hf]) continue;
        const int j = vs[hf] & (NS - 1);
        for (int i = 0; i < NS; ++i) {
          const int* tm = terms + 2 * (j * NS + i);
          if (tm[0] >= 2 && tm[1] == idx) use[hf] |= 1u << i;
        }
      }
    }
    for (int kc = 0; kc < NCHUNK; ++kc, ++gc) {
      const int st = gc % P.nstage;
      mbar_wait(bars + 8 * (1 + st), (gc / P.nstage) & 1);
      // This thread's A values: rows g and g + 8, k = 16 kc + 4q .. + 3.
      float4 ar[2], ai[2];
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        ar[hf] = make_float4(0.f, 0.f, 0.f, 0.f);
        ai[hf] = ar[hf];
        const size_t off = (size_t)vr[hf] * C + kc * KC + 4 * q;
        if (!terms) {
          if (vok[hf]) {
            ar[hf] = ld4(T.re(vs[hf]) + off);
            ai[hf] = ld4(T.im(vs[hf]) + off);
          }
        } else {
          const int t0 = vs[hf] & ~(NS - 1);
          for (unsigned b = use[hf]; b; b &= b - 1) {
            const int s = t0 + __ffs(b) - 1;
            const float4 x = ld4(T.re(s) + off), y = ld4(T.im(s) + off);
            ar[hf] = make_float4(ar[hf].x + x.x, ar[hf].y + x.y, ar[hf].z + x.z, ar[hf].w + x.w);
            ai[hf] = make_float4(ai[hf].x + y.x, ai[hf].y + y.y, ai[hf].z + y.z, ai[hf].w + y.w);
          }
        }
      }
      // Fragments of the chunk's two k8 steps. The k order inside a chunk
      // is permuted (the host lays B out the same way): slot q of step kk
      // is k = 4q + 2kk, slot q + 4 is 4q + 2kk + 1, so one float4 per row
      // feeds both steps.
      uint32_t xh[2][4], xl[2][4], yh[2][4], yl[2][4];
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        split(compc(ar[0], 2 * kk), xh[kk][0], xl[kk][0]);
        split(compc(ar[1], 2 * kk), xh[kk][1], xl[kk][1]);
        split(compc(ar[0], 2 * kk + 1), xh[kk][2], xl[kk][2]);
        split(compc(ar[1], 2 * kk + 1), xh[kk][3], xl[kk][3]);
        split(compc(ai[0], 2 * kk), yh[kk][0], yl[kk][0]);
        split(compc(ai[1], 2 * kk), yh[kk][1], yl[kk][1]);
        split(compc(ai[0], 2 * kk + 1), yh[kk][2], yl[kk][2]);
        split(compc(ai[1], 2 * kk + 1), yh[kk][3], yl[kk][3]);
      }
      const uint32_t sb = smem_u32(stages + (size_t)st * P.stage_bytes) + n0 * 32;
      keep(acc[0]);
      keep(acc[1]);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        const uint32_t b = sb + kk * KK_BYTES;
        mma3<NN>(acc[0], xh[kk], xl[kk], b);
        mma3<NN>(acc[1], yh[kk], yl[kk], b);
        if (cplx) {
          const uint32_t bi = b + 2 * PART_BYTES;
          mma3<NN, -1>(acc[0], yh[kk], yl[kk], bi);
          mma3<NN>(acc[1], xh[kk], xl[kk], bi);
        }
      }
      wg_commit();
      wg_wait0();
      keep(acc[0]);
      keep(acc[1]);
#pragma unroll
      for (int kk = 0; kk < 2; ++kk) {
        keep(xh[kk]);
        keep(xl[kk]);
        keep(yh[kk]);
        keep(yl[kk]);
      }
      // Every wgmma of this chunk is done in both warpgroups (and, after
      // the last chunk, every read of the step's rows): the stage is free.
      __syncthreads();
      if (tid == 0 && gc + P.nstage < P.nchunks)
        issue_chunk(P, stages, bars, gc + P.nstage);
    }
  }

  // Epilogue: this thread's (row, 2 lanes) pairs of every 8-lane group.
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    if (!vok[hf]) continue;
    const int s = vs[hf];
    const size_t rowoff = (size_t)vr[hf] * C;
#pragma unroll
    for (int jn = 0; jn < NN / 8; ++jn) {
      const int col = n0 + 8 * jn + 2 * q;
      float o[2][2];  // [plane][lane pair]
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        o[0][e] = acc[0][4 * jn + 2 * hf + e];
        o[1][e] = acc[1][4 * jn + 2 * hf + e];
      }
      if (terms) {
        const int t0 = s & ~(NS - 1), j = s & (NS - 1);
        for (int i = 0; i < NS; ++i) {
          const int* tm = terms + 2 * (j * NS + i);
          if (tm[0] != 1) continue;
          const float cr = fprog[tm[1]], ci = fprog[tm[1] + 1];
          const float2 x = *reinterpret_cast<const float2*>(T.re(t0 + i) + rowoff + col);
          const float2 y = *reinterpret_cast<const float2*>(T.im(t0 + i) + rowoff + col);
          o[0][0] += cr * x.x - ci * y.x;
          o[0][1] += cr * x.y - ci * y.y;
          o[1][0] += cr * y.x + ci * x.x;
          o[1][1] += cr * y.y + ci * x.y;
        }
      }
      const Tile& D = terms ? S : T;
      *reinterpret_cast<float2*>(D.re(s) + rowoff + col) = make_float2(o[0][0], o[0][1]);
      *reinterpret_cast<float2*>(D.im(s) + rowoff + col) = make_float2(o[1][0], o[1][1]);
    }
  }
}

template <int NS>
__device__ __forceinline__ void run_matrix_step(const Params& P, const Tile& T,
                                                const Tile& S,
                                                unsigned char* stages, uint32_t bars,
                                                int outm, const int* terms,
                                                const int* mlist, int nmat,
                                                bool low_cplx, int& gc) {
  if (__popc(outm) * P.group * P.bt > 64)
    matrix_step<NS, 128>(P, T, S, stages, bars, outm, terms, mlist, nmat,
                         low_cplx, gc);
  else
    matrix_step<NS, 64>(P, T, S, stages, bars, outm, terms, mlist, nmat,
                        low_cplx, gc);
}

// ---------------------------------------------------------------------------
// Element-wise steps, four lanes (one float4) of a row per thread and unit
// ---------------------------------------------------------------------------

// y0 = a x0 + b x1, y1 = c x0 + d x1 on one lane; k = (a, b, c, d) as
// (re, im).
__device__ __forceinline__ void pair_apply(const float (&k)[8], float& x0r,
                                           float& x0i, float& x1r, float& x1i) {
  const float a0r = x0r, a0i = x0i, a1r = x1r, a1i = x1i;
  x0r = k[0] * a0r - k[1] * a0i + k[2] * a1r - k[3] * a1i;
  x0i = k[0] * a0i + k[1] * a0r + k[2] * a1i + k[3] * a1r;
  x1r = k[4] * a0r - k[5] * a0i + k[6] * a1r - k[7] * a1i;
  x1i = k[4] * a0i + k[5] * a0r + k[6] * a1i + k[7] * a1r;
}

// One unit of a butterfly step (cbf, rbf, cmix): four lanes of the pair's
// two members (or, for a cbf on lane bit 0 or 1, one float4 that holds
// both), at float offsets o0 / o1 of slabs s0 / s1.
struct BUnit {
  float4 x0r, x0i, x1r, x1i;
  int s0, s1, o0, o1;
  unsigned row;
  int col;
  bool ok;
};

__device__ __forceinline__ BUnit bunit_locate(int kind, int p, int e, int lu, int total,
                                              int active, unsigned rm,
                                              const long long* sbase, int ns) {
  BUnit U;
  const int sl = e >> lu, u = e & ((1 << lu) - 1);
  U.ok = e < total && ((active >> (sl & (ns - 1))) & 1);
  U.s0 = U.s1 = sl;
  if (kind == K_RBF) {
    const int rl = u >> 5, c0 = 4 * (u & 31);
    const int r0 = ((rl >> p) << (p + 1)) | (rl & ((1 << p) - 1));
    U.o0 = r0 * C + c0;
    U.o1 = U.o0 + (C << p);
    U.col = c0;
  } else if (kind == K_CBF && p >= 2) {
    const int r = u >> 4, qp = u & 15, sq = 1 << (p - 2);
    const int q0 = ((qp >> (p - 2)) << (p - 1)) | (qp & (sq - 1));
    U.o0 = r * C + 4 * q0;
    U.o1 = U.o0 + 4 * sq;
    U.col = 4 * q0;
  } else {  // cbf on lane bit 0 or 1, cmix
    U.o0 = U.o1 = 4 * u;
    U.col = 4 * (u & 31);
    if (kind == K_CMIX) U.s1 = sl | (1 << p);
  }
  U.row = U.ok ? (unsigned)(sbase[sl] + (U.o0 >> 7)) : 0u;
  U.ok = U.ok && (U.row & rm) == rm;
  return U;
}

__device__ __forceinline__ void bunit_load(const Tile& T, BUnit& U, bool inner) {
  if (!U.ok) return;
  U.x0r = ld4(T.re(U.s0) + U.o0);
  U.x0i = ld4(T.im(U.s0) + U.o0);
  if (!inner) {
    U.x1r = ld4(T.re(U.s1) + U.o1);
    U.x1i = ld4(T.im(U.s1) + U.o1);
  }
}

__device__ __forceinline__ void bunit_apply(const Tile& T, BUnit& U, bool inner, int p,
                                            unsigned cm, const float (&k)[8]) {
  if (!U.ok) return;
  float ar[4] = {U.x0r.x, U.x0r.y, U.x0r.z, U.x0r.w};
  float ai[4] = {U.x0i.x, U.x0i.y, U.x0i.z, U.x0i.w};
  if (!inner) {
    float br[4] = {U.x1r.x, U.x1r.y, U.x1r.z, U.x1r.w};
    float bi[4] = {U.x1i.x, U.x1i.y, U.x1i.z, U.x1i.w};
#pragma unroll
    for (int l = 0; l < 4; ++l)
      if (((unsigned)(U.col + l) & cm) == cm) pair_apply(k, ar[l], ai[l], br[l], bi[l]);
    st4(T.re(U.s1) + U.o1, make_float4(br[0], br[1], br[2], br[3]));
    st4(T.im(U.s1) + U.o1, make_float4(bi[0], bi[1], bi[2], bi[3]));
  } else if (p == 0) {  // lane pairs (0, 1), (2, 3) of the float4
#pragma unroll
    for (int l = 0; l < 4; l += 2)
      if (((unsigned)(U.col + l) & cm) == cm) pair_apply(k, ar[l], ai[l], ar[l + 1], ai[l + 1]);
  } else {  // lane pairs (0, 2), (1, 3)
#pragma unroll
    for (int l = 0; l < 2; ++l)
      if (((unsigned)(U.col + l) & cm) == cm) pair_apply(k, ar[l], ai[l], ar[l + 2], ai[l + 2]);
  }
  st4(T.re(U.s0) + U.o0, make_float4(ar[0], ar[1], ar[2], ar[3]));
  st4(T.im(U.s0) + U.o0, make_float4(ai[0], ai[1], ai[2], ai[3]));
}

// W consecutive floats at p (16- or 8-byte aligned for W = 4, 2).
template <int W>
__device__ __forceinline__ void ldw(const float* p, float (&v)[W]) {
  if constexpr (W == 4) {
    const float4 t = ld4(p);
    v[0] = t.x, v[1] = t.y, v[2] = t.z, v[3] = t.w;
  } else if constexpr (W == 2) {
    const float2 t = *reinterpret_cast<const float2*>(p);
    v[0] = t.x, v[1] = t.y;
  } else {
    v[0] = *p;
  }
}
template <int W>
__device__ __forceinline__ void stw(float* p, const float (&v)[W]) {
  if constexpr (W == 4) st4(p, make_float4(v[0], v[1], v[2], v[3]));
  else if constexpr (W == 2) *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  else *p = v[0];
}

// Butterflies of a factored mix on window-index bit PB over the NS values
// of W lanes of one element position.
template <int NS, int W, int PB>
__device__ __forceinline__ void mix_butterfly(const float (&k)[8], float (&vr)[NS][W],
                                              float (&vi)[NS][W]) {
  if constexpr ((1 << PB) < NS) {
#pragma unroll
    for (int j0 = 0; j0 < NS; ++j0) {
      if (j0 & (1 << PB)) continue;
#pragma unroll
      for (int w = 0; w < W; ++w)
        pair_apply(k, vr[j0][w], vi[j0][w], vr[j0 | (1 << PB)][w], vi[j0 | (1 << PB)][w]);
    }
  }
}

// A diag step's lane factors for one thread's four lanes c0 .. c0 + 3
// (factor mode: at most DIAG_MASK_MAX row-support groups).
struct DiagLanes {
  float4 lr, li;
  float4 gr[DIAG_MASK_MAX], gi[DIAG_MASK_MAX];
  unsigned gmask[DIAG_MASK_MAX];
  int groups;
};

__device__ __forceinline__ DiagLanes diag_lanes(const int* iprog, const float* fprog,
                                                const int* ent, int c0) {
  DiagLanes D;
  const float* lanep = fprog + ent[5];
  const unsigned* gm = reinterpret_cast<const unsigned*>(iprog + ent[0] + ent[2]);
  D.groups = ent[3];
  D.lr = ldg4(lanep + c0);
  D.li = ldg4(lanep + C + c0);
#pragma unroll
  for (int k = 0; k < DIAG_MASK_MAX; ++k) {
    const bool on = k < D.groups;
    D.gr[k] = on ? ldg4(lanep + 2 * C * (1 + k) + c0) : make_float4(1.f, 1.f, 1.f, 1.f);
    D.gi[k] = on ? ldg4(lanep + 2 * C * (1 + k) + C + c0) : make_float4(0.f, 0.f, 0.f, 0.f);
    D.gmask[k] = on ? gm[k] : 0xffffffffu;
  }
  return D;
}

// x *= rowfactor(row) * lanefactor * the groups whose row mask holds, on
// four lanes; (fr, fi) is the row's factor.
__device__ __forceinline__ void diag_mul(const DiagLanes& D, float fr, float fi,
                                         unsigned row, float (&xr)[4], float (&xi)[4]) {
  const float lr[4] = {D.lr.x, D.lr.y, D.lr.z, D.lr.w};
  const float li[4] = {D.li.x, D.li.y, D.li.z, D.li.w};
  float pr[4], pi[4];
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    pr[l] = fr * lr[l] - fi * li[l];
    pi[l] = fr * li[l] + fi * lr[l];
  }
#pragma unroll
  for (int k = 0; k < DIAG_MASK_MAX; ++k) {
    if (k < D.groups && (row & D.gmask[k]) == D.gmask[k]) {
      const float gr[4] = {D.gr[k].x, D.gr[k].y, D.gr[k].z, D.gr[k].w};
      const float gi[4] = {D.gi[k].x, D.gi[k].y, D.gi[k].z, D.gi[k].w};
#pragma unroll
      for (int l = 0; l < 4; ++l) {
        const float tr = pr[l] * gr[l] - pi[l] * gi[l];
        pi[l] = pr[l] * gi[l] + pi[l] * gr[l];
        pr[l] = tr;
      }
    }
  }
#pragma unroll
  for (int l = 0; l < 4; ++l) {
    const float a = xr[l], c = xi[l];
    xr[l] = a * pr[l] - c * pi[l];
    xi[l] = a * pi[l] + c * pr[l];
  }
}

// A diag step's row factors (cos, sin), or row angles in angle mode, of
// every row of the active slabs, into rowv[2 (slab * bt + r)].
template <int NS>
__device__ __forceinline__ void diag_rows(const int* iprog, const float* fprog,
                                          const int* per, int active, int nslab, int lbt,
                                          const long long* sbase, float* rowv) {
  const int bt = 1 << lbt;
  for (int idx = threadIdx.x; idx < nslab * bt; idx += THREADS) {
    const int sl = idx >> lbt, r = idx & (bt - 1);
    const int i = sl & (NS - 1);
    if (!((active >> i) & 1)) continue;
    const int* ent = per + DIAG_ENT * i;
    const unsigned* rmk = reinterpret_cast<const unsigned*>(iprog + ent[0]);
    const float* fl = fprog + ent[1];
    const unsigned row = (unsigned)(sbase[sl] + r);
    float ang = fl[0];
    for (int m = 0; m < ent[2]; ++m)
      if ((row & rmk[m]) == rmk[m]) ang += fl[1 + m];
    if (ent[4]) {
      // angle mode: the row angle, and the groups whose row mask holds
      // (up to 32 as bits; more: the element loop tests them itself)
      const unsigned* gm = rmk + ent[2];
      unsigned on = 0;
      for (int k = 0; k < ent[3] && k < 32; ++k)
        if ((row & gm[k]) == gm[k]) on |= 1u << k;
      rowv[2 * idx] = ang;
      rowv[2 * idx + 1] = __uint_as_float(on);
    } else {
      float sn, cs;
      sincosf(ang, &sn, &cs);
      rowv[2 * idx] = cs;
      rowv[2 * idx + 1] = sn;
    }
  }
}

// One mix step over the tile from an NS x NS coefficient table: each
// element reads its input strips, then writes its output strips.
template <int NS, typename Coef>
__device__ __forceinline__ void mix_elements(const Tile& T, int tid, int nel,
                                             int group, int active,
                                             const int (&nz)[NS], int need,
                                             Coef coef) {
  for (int e = tid; e < group * nel; e += THREADS) {
    const int t = e / nel, off = e - t * nel, s0 = t * NS;
    float vr[NS], vi[NS];
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      vr[i] = 0.0f;
      vi[i] = 0.0f;
      if ((need >> i) & 1) {
        vr[i] = T.re(s0 + i)[off];
        vi[i] = T.im(s0 + i)[off];
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
      T.re(s0 + j)[off] = ar;
      T.im(s0 + j)[off] = ai;
    }
  }
}

template <int NS>
__global__ void __launch_bounds__(THREADS, 1)
window_sweep_kernel(const __grid_constant__ Params P) {
  extern __shared__ __align__(128) unsigned char smem[];
  long long* sbase = reinterpret_cast<long long*>(smem);
  const uint32_t bars = smem_u32(smem + BAR_OFF);
  const int bt = P.bt, G = P.group, nslab = G * NS;
  const size_t slab_floats = (size_t)2 * bt * C;
  Tile T{reinterpret_cast<float*>(smem + HEADER), bt};
  Tile S{T.base + nslab * slab_floats, bt};  // rmix output scratch
  float* small = T.base + nslab * slab_floats * (P.scratch ? 2 : 1);
  unsigned char* stages = reinterpret_cast<unsigned char*>(small) + SMALL_AUX;
  const int tid = threadIdx.x;
  const int h = P.h;
  const int* iprog = P.iprog;
  const float* fprog = P.fprog;
  const int full = (1 << NS) - 1;

  // Absolute first row of each slab: _strip_index_map (:934) of tile
  // blockIdx.x * G + t, strip i.
  if (tid < nslab) {
    const int i = tid & (NS - 1);
    const long long tile = (long long)blockIdx.x * G + tid / NS;
    const long long sl = P.seg[h] / bt;
    const long long d = tile % sl;
    long long rest = tile / sl;
    long long coord[4] = {0, 0, 0, 0};
    for (int j = h - 1; j >= 0; --j) {
      coord[j] = rest % P.seg[j];
      rest /= P.seg[j];
    }
    long long blk = 0;
    for (int j = 0; j < h; ++j)
      blk = (blk * P.seg[j] + coord[j]) * 2 + ((i >> (h - 1 - j)) & 1);
    sbase[tid] = (blk * sl + d) * bt;
  }
  if (tid == 0) {
    for (int b = 0; b <= P.nstage; ++b) mbar_init(bars + 8 * b, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  // One thread hands the tile's input slabs and the first B chunks to the
  // TMA engine; the stages fill while the element-wise steps run.
  const uint32_t plane_bytes = (uint32_t)bt * C * 4;
  if (tid == 0) {
    const uint32_t bytes = 2u * plane_bytes * __popc(P.in_mask) * G;
    if (bytes) {
      mbar_expect_tx(bars, bytes);
      for (int s = 0; s < nslab; ++s) {
        if (!((P.in_mask >> (s & (NS - 1))) & 1)) continue;
        bulk_load(smem_u32(T.re(s)), P.xr + sbase[s] * C, plane_bytes, bars);
        bulk_load(smem_u32(T.im(s)), P.xi + sbase[s] * C, plane_bytes, bars);
      }
    }
    for (int c = 0; c < P.nstage && c < P.nchunks; ++c) issue_chunk(P, stages, bars, c);
  }
  // Slabs no step reads before writing them start at 0 (a factored mix
  // reads every strip, with 0 weight on these).
  if (P.in_mask != full) {
    const int n4 = bt * C / 4;
    for (int s = 0; s < nslab; ++s) {
      if ((P.in_mask >> (s & (NS - 1))) & 1) continue;
      for (int e = tid; e < n4; e += THREADS) {
        st4(T.re(s) + 4 * e, make_float4(0.f, 0.f, 0.f, 0.f));
        st4(T.im(s) + 4 * e, make_float4(0.f, 0.f, 0.f, 0.f));
      }
    }
  }
  if (P.in_mask) mbar_wait(bars, 0);
  __syncthreads();

  const int nel = bt * C;
  const int lbt = __ffs(bt) - 1;
  int gc = 0;  // next B chunk a matrix step consumes

  for (int s = 0; s < P.nsteps; ++s) {
    const int* rec = iprog + s * REC;
    const int kind = rec[0];
    const int active = rec[1];

    if (kind == K_MIX) {
      const int nb = rec[3];
      const int* ent = iprog + rec[2];
      int need = 0;
      int nz[NS];
#pragma unroll
      for (int j = 0; j < NS; ++j) {
        nz[j] = ((active >> j) & 1) ? ent[4 * j] : 0;
        need |= nz[j];
      }
      if (nb) {
        // The coefficient matrix factors into one 2 x 2 per window bit:
        // butterflies over the NS values of each element position, W
        // lanes at a time.
        constexpr int W = NS <= 4 ? 4 : NS == 8 ? 2 : 1;
        const int* bits = iprog + rec[4];
        const float* cf = fprog + rec[5];
        const int nw = nel / W;
        for (int e = tid; e < G * nw; e += THREADS) {
          const int t = e / nw, off = (e - t * nw) * W, s0 = t * NS;
          float vr[NS][W], vi[NS][W];
#pragma unroll
          for (int i = 0; i < NS; ++i) {
            ldw<W>(T.re(s0 + i) + off, vr[i]);
            ldw<W>(T.im(s0 + i) + off, vi[i]);
          }
          for (int k = 0; k < nb; ++k) {
            float kf[8];
#pragma unroll
            for (int u = 0; u < 8; ++u) kf[u] = __ldg(cf + 8 * k + u);
            switch (bits[k]) {
              case 0: mix_butterfly<NS, W, 0>(kf, vr, vi); break;
              case 1: mix_butterfly<NS, W, 1>(kf, vr, vi); break;
              case 2: mix_butterfly<NS, W, 2>(kf, vr, vi); break;
              default: mix_butterfly<NS, W, 3>(kf, vr, vi); break;
            }
          }
#pragma unroll
          for (int j = 0; j < NS; ++j) {
            if (!((active >> j) & 1)) continue;
            stw<W>(T.re(s0 + j) + off, vr[j]);
            stw<W>(T.im(s0 + j) + off, vi[j]);
          }
        }
      } else if constexpr (NS <= 4) {
        // The outputs' term lists as an NS x NS table of (re, im) in each
        // thread's registers (0 where a term is absent).
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
        mix_elements<NS>(T, tid, nel, G, active, nz, need,
                         [&](int j, int i) { return ct[j][i]; });
      } else {
        float* tab = small;
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
        mix_elements<NS>(T, tid, nel, G, active, nz, need,
                         [&](int j, int i) { return ctab[j * NS + i]; });
      }
    } else if (kind == K_RMIX) {
      run_matrix_step<NS>(P, T, S, stages, bars, active, iprog + rec[2],
                          iprog + rec[3], rec[4], false, gc);
      __syncthreads();
      const int n4 = nel / 4;
      for (int sl = 0; sl < nslab; ++sl) {
        if (!((active >> (sl & (NS - 1))) & 1)) continue;
        for (int e = tid; e < n4; e += THREADS) {
          st4(T.re(sl) + 4 * e, ld4(S.re(sl) + 4 * e));
          st4(T.im(sl) + 4 * e, ld4(S.im(sl) + 4 * e));
        }
      }
    } else if (kind == K_DIAG) {
      const int* per = iprog + rec[2];
      float* rowv = small;
      diag_rows<NS>(iprog, fprog, per, active, nslab, lbt, sbase, rowv);
      __syncthreads();
      // Each thread keeps one lane quad (its lane factors in registers)
      // and walks rows 8 apart, four rows per batch.
      const int c0 = 4 * (tid & 31);
      for (int sl = 0; sl < nslab; ++sl) {
        const int i = sl & (NS - 1);
        if (!((active >> i) & 1)) continue;
        const int* ent = per + DIAG_ENT * i;
        const long long b = sbase[sl];
        const float* rv = rowv + 2 * sl * bt;
        float* xr = T.re(sl);
        float* xi = T.im(sl);
        if (!ent[4]) {
          const DiagLanes D = diag_lanes(iprog, fprog, ent, c0);
          for (int r0 = tid >> 5; r0 < bt; r0 += 32) {
            float x[4][4], y[4][4];
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = r0 + 8 * u;
              if (r < bt) {
                ldw<4>(xr + r * C + c0, x[u]);
                ldw<4>(xi + r * C + c0, y[u]);
              }
            }
#pragma unroll
            for (int u = 0; u < 4; ++u) {
              const int r = r0 + 8 * u;
              if (r >= bt) continue;
              diag_mul(D, rv[2 * r], rv[2 * r + 1], (unsigned)(b + r), x[u], y[u]);
              stw<4>(xr + r * C + c0, x[u]);
              stw<4>(xi + r * C + c0, y[u]);
            }
          }
        } else if (ent[3] <= 32) {
          // angle mode, four lanes a thread: the row's groups as bits (warp-
          // uniform: a warp shares its row), their lane angles as float4s
          const float* lanep = fprog + ent[5];
          const float4 la = ldg4(lanep + c0);
          for (int r = tid >> 5; r < bt; r += 8) {
            const float4 x = ld4(xr + r * C + c0), y = ld4(xi + r * C + c0);
            float a[4] = {rv[2 * r] + la.x, rv[2 * r] + la.y, rv[2 * r] + la.z,
                          rv[2 * r] + la.w};
            for (unsigned on = __float_as_uint(rv[2 * r + 1]); on; on &= on - 1) {
              const float4 g = ldg4(lanep + C * __ffs(on) + c0);
              a[0] += g.x, a[1] += g.y, a[2] += g.z, a[3] += g.w;
            }
            float xo[4] = {x.x, x.y, x.z, x.w}, yo[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
            for (int l = 0; l < 4; ++l) {
              float sn, cs;
              sincosf(a[l], &sn, &cs);
              const float u = xo[l], v = yo[l];
              xo[l] = u * cs - v * sn;
              yo[l] = u * sn + v * cs;
            }
            stw<4>(xr + r * C + c0, xo);
            stw<4>(xi + r * C + c0, yo);
          }
        } else {
          const int Gn = ent[3];
          const unsigned* gm = reinterpret_cast<const unsigned*>(iprog + ent[0] + ent[2]);
          const float* lanep = fprog + ent[5];
          for (int e = tid; e < nel; e += THREADS) {
            const int r = e >> 7, c = e & (C - 1);
            const unsigned row = (unsigned)(b + r);
            float ang = rv[2 * r] + lanep[c];
            for (int k = 0; k < Gn; ++k)
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
      float k[8];
#pragma unroll
      for (int u = 0; u < 8; ++u) k[u] = fprog[rec[5] + u];
      const bool inner = kind == K_CBF && p < 2;  // both members in one float4
      int lu;  // log2 of the units per slab
      if (kind == K_RBF) lu = lbt - 1 + 5;      // row pairs x 32 quads
      else if (kind == K_CBF && !inner) lu = lbt + 4;  // rows x 16 quad pairs
      else lu = lbt + 5;                         // rows x 32 quads
      const int total = nslab << lu;
      for (int e0 = tid; e0 < total; e0 += UNITS * THREADS) {
        BUnit U[UNITS];
#pragma unroll
        for (int b = 0; b < UNITS; ++b)
          U[b] = bunit_locate(kind, p, e0 + b * THREADS, lu, total, active, rm, sbase, NS);
#pragma unroll
        for (int b = 0; b < UNITS; ++b) bunit_load(T, U[b], inner);
#pragma unroll
        for (int b = 0; b < UNITS; ++b) bunit_apply(T, U[b], inner, p, cm, k);
      }
    } else if (kind == K_LOW || kind == K_LOWR) {
      run_matrix_step<NS>(P, T, S, stages, bars, active, nullptr, nullptr, 1,
                          kind == K_LOW, gc);
    }
    __syncthreads();
  }

  const int n4 = bt * C / 4;
  for (int sl = 0; sl < nslab; ++sl) {
    if (!((P.out_mask >> (sl & (NS - 1))) & 1)) continue;
    float4* gr = reinterpret_cast<float4*>(P.yr + sbase[sl] * C);
    float4* gi = reinterpret_cast<float4*>(P.yi + sbase[sl] * C);
    const float* tr = T.re(sl);
    const float* ti = T.im(sl);
    for (int e = tid; e < n4; e += THREADS) {
      gr[e] = ld4(tr + 4 * e);
      gi[e] = ld4(ti + 4 * e);
    }
  }
}

template <int NS>
int launch(const Params& p, size_t smem, long long n_ctas, cudaStream_t st) {
  cudaError_t err = cudaFuncSetAttribute(
      window_sweep_kernel<NS>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  window_sweep_kernel<NS><<<(unsigned)n_ctas, THREADS, smem, st>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C entry point (loaded with ctypes). Returns the CUDA error code of
// the launch (0 = launched). Reads planes (xr, xi) and writes (yr, yi),
// which may be the same planes (in place). `scratch` doubles the tile for
// rmix windows; `nstage` stages of `stage_bytes` follow the small aux
// area for the B ring (WindowProgram.smem_bytes).
extern "C" int rq_window_sweep(const float* xr, const float* xi, float* yr, float* yi,
                               const int* iprog, const float* fprog,
                               const float* bstream, int h, int nsteps, int bt,
                               int group, int in_mask, int out_mask, int scratch,
                               int nstage, int stage_bytes, int chunk_tab,
                               int nchunks, long long s0, long long s1, long long s2,
                               long long s3, long long s4, long long n_ctas,
                               void* stream) {
  if (nstage > MAX_STAGES || (nchunks && nstage < 1) || group * (1 << h) > 16)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.xr = xr;
  p.xi = xi;
  p.yr = yr;
  p.yi = yi;
  p.iprog = iprog;
  p.fprog = fprog;
  p.bstream = bstream;
  p.seg[0] = s0;
  p.seg[1] = s1;
  p.seg[2] = s2;
  p.seg[3] = s3;
  p.seg[4] = s4;
  p.h = h;
  p.nsteps = nsteps;
  p.bt = bt;
  p.group = group;
  p.in_mask = in_mask;
  p.out_mask = out_mask;
  p.scratch = scratch;
  p.nstage = nstage > 0 ? nstage : 1;
  p.stage_bytes = stage_bytes;
  p.chunk_tab = chunk_tab;
  p.nchunks = nchunks;
  const size_t tile = ((size_t)group << h) * 2 * (size_t)bt * C * sizeof(float);
  const size_t smem = HEADER + tile * (scratch ? 2 : 1) + SMALL_AUX +
                      (size_t)nstage * stage_bytes;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (h) {
    case 0: return launch<1>(p, smem, n_ctas, st);
    case 1: return launch<2>(p, smem, n_ctas, st);
    case 2: return launch<4>(p, smem, n_ctas, st);
    case 3: return launch<8>(p, smem, n_ctas, st);
    case 4: return launch<16>(p, smem, n_ctas, st);
    default: return (int)cudaErrorInvalidValue;
  }
}

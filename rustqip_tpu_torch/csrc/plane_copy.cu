// Plane-pair copy for Hopper (sm_90a): one read and one write of the re/im
// planes of a state, to fresh planes or in place.
//
// Replaces the TPU copy probes: scripts/copy_bandwidth_probe.py make_step
// (pallas_call at :56, an emit_pipeline copy of a (2^21, 128) float32 plane
// pair) and scripts/copy_bandwidth_probe2.py make_emit (pallas_call at :70,
// 1 or 4 row strips per grid step) and make_outer_grid (:87, a plain
// grid), each in place or to fresh planes. Like them it measures the copy
// floor, the least time a pass over the state takes on this card; the port
// also uses it for the plane copies a wide controlled op needs
// (engine/real_apply._control_ri).
//
// What bounds it on an H100: device-memory bytes, each plane read once and
// written once: 2 planes x 2 x 1 GiB = 4.29 GB at n = 28 in f32, 1.28 ms at
// 3.35 TB/s.
//
// The design: a grid of short blocks, no persistent loop. Block b copies
// 256 x S 16-byte units of plane b & 1: each thread loads its unit of each
// of the S strips (S = strips, 1 or 4: the plane cut into S contiguous
// strips, the counterpart of probe2's row strips) and then stores them;
// neighbouring threads take neighbouring units. Every block is short, so
// the block scheduler keeps every SM full to the last wave: that, not more
// bytes in flight, is what the copy needs here. Persistent grids (one CTA
// per SM driving a ring of TMA bulk copies; register streams with four
// loads in flight per thread; a grid-stride loop) stayed 4-7 % behind
// Tensor.copy_, where short blocks, by registers or by TMA, come within
// 2 % of it, this design within 1 % (PERF.md; the A/B harness that built
// all five designs is rustqip_tpu_torch/tools/copy_ab.py at the git tag
// copy-ab-harness). In place is safe: each thread reads its units before
// it writes them, and no two threads share a unit.

#include <cuda_runtime.h>
#include <stdint.h>

#define THREADS 256

template <int S>
__global__ void __launch_bounds__(THREADS) plane_copy_kernel(const uint4* xr, const uint4* xi,
                                                             uint4* yr, uint4* yi,
                                                             long long len) {
  const uint4* x = (blockIdx.x & 1) ? xi : xr;
  uint4* y = (blockIdx.x & 1) ? yi : yr;
  const long long i = (long long)(blockIdx.x >> 1) * THREADS + threadIdx.x;
  if (i >= len) return;
  uint4 a[S];
#pragma unroll
  for (int s = 0; s < S; ++s) a[s] = x[s * len + i];
#pragma unroll
  for (int s = 0; s < S; ++s) y[s * len + i] = a[s];
}

// x*, y*: planes of `bytes` bytes each, 16-byte aligned; y may equal x (in
// place). bytes must be a multiple of 16 * strips; strips is 1 or 4.
extern "C" int rq_plane_copy(const void* xr, const void* xi, void* yr,
                             void* yi, long long bytes, int strips,
                             void* stream) {
  if (strips != 1 && strips != 4) return (int)cudaErrorInvalidValue;
  if (bytes % (16LL * strips)) return (int)cudaErrorInvalidValue;
  const long long len = bytes / 16 / strips;  // units of one strip
  if (len == 0) return 0;
  const long long blocks = 2 * ((len + THREADS - 1) / THREADS);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const uint4* a = static_cast<const uint4*>(xr);
  const uint4* b = static_cast<const uint4*>(xi);
  uint4* c = static_cast<uint4*>(yr);
  uint4* d = static_cast<uint4*>(yi);
  if (strips == 1)
    plane_copy_kernel<1><<<(unsigned)blocks, THREADS, 0, st>>>(a, b, c, d, len);
  else
    plane_copy_kernel<4><<<(unsigned)blocks, THREADS, 0, st>>>(a, b, c, d, len);
  return (int)cudaGetLastError();
}

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
// 3.35 TB/s. Its measured time is the achievable floor that every other
// memory-bound kernel of the port is held against beside that bound.
//
// What the design does about it. A grid-stride loop over 16-byte units,
// neighbouring lanes on neighbouring addresses. With S strips the planes
// are cut into S contiguous row strips and each thread loads its unit of
// every strip of both planes before it stores any (2 S loads in flight per
// thread), mirroring probe2's stream count. In place, each thread reads
// and writes only its own units, so the copy is a write of the same values.

#include <cuda_runtime.h>
#include <stdint.h>

template <int S>
__global__ void __launch_bounds__(256) plane_copy_kernel(const uint4* xr,
                                                         const uint4* xi,
                                                         uint4* yr, uint4* yi,
                                                         long long per) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < per;
       i += stride) {
    uint4 a[S], b[S];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      a[s] = xr[s * per + i];
      b[s] = xi[s * per + i];
    }
#pragma unroll
    for (int s = 0; s < S; ++s) {
      yr[s * per + i] = a[s];
      yi[s * per + i] = b[s];
    }
  }
}

// x*, y*: planes of `bytes` bytes each, 16-byte aligned; y may equal x (in
// place). bytes must be a multiple of 16 * strips; strips is 1 or 4.
extern "C" int rq_plane_copy(const void* xr, const void* xi, void* yr,
                             void* yi, long long bytes, int strips,
                             void* stream) {
  if (strips != 1 && strips != 4) return (int)cudaErrorInvalidValue;
  if (bytes % (16LL * strips)) return (int)cudaErrorInvalidValue;
  const long long per = bytes / 16 / strips;
  if (per == 0) return 0;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const int threads = 256;
  const long long want = (per + threads - 1) / threads;
  const int blocks = (int)(want < 132LL * 16 ? want : 132LL * 16);
  const uint4* a = reinterpret_cast<const uint4*>(xr);
  const uint4* b = reinterpret_cast<const uint4*>(xi);
  uint4* c = reinterpret_cast<uint4*>(yr);
  uint4* d = reinterpret_cast<uint4*>(yi);
  if (strips == 1)
    plane_copy_kernel<1><<<blocks, threads, 0, st>>>(a, b, c, d, per);
  else
    plane_copy_kernel<4><<<blocks, threads, 0, st>>>(a, b, c, d, per);
  return (int)cudaGetLastError();
}

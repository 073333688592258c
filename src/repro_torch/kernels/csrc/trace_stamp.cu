// Device stamps for the port's span recorder (repro_torch/tracing.py).
//
// Replaces no TPU kernel. A stamp is a one-thread kernel that writes
// (site, %globaltimer) into a ring of 2 x cap 8-byte words in device
// memory, at the slot an atomicAdd on a device cursor hands it. Being a
// kernel, a stamp can be captured into a CUDA graph at any depth of its
// IF and WHILE bodies (an event node cannot be captured there), and each
// replay of the graph, each run of a WHILE body, stamps again. The ring
// and the cursor are allocated once by the host and keep their address
// for the life of the process, since captured graphs hold their pointers.
// A stamp that finds the ring full writes nothing; the cursor still
// counts it, so the host sees cursor - cap stamps dropped.
//
// trace_stamp_launch(ring, cursor, cap, site, stream): one stamp on
// `stream` (capturing or not). trace_stamp_device_launches(out): out[0]
// the stamps launched since the library loaded, out[1] those that found
// the ring full, counted on the device (one atomic add each, so stamps
// replayed from a captured graph count too). Both return a cudaError_t.
#include <cuda_runtime.h>

namespace {

__device__ unsigned long long g_launches[2];

__global__ void stamp_kernel(unsigned long long* ring,
                             unsigned long long* cursor,
                             unsigned long long cap,
                             unsigned long long site) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long slot = atomicAdd(cursor, 1ull);
  atomicAdd(&g_launches[0], 1ull);
  if (slot < cap) {
    ring[2 * slot] = site;
    ring[2 * slot + 1] = now;
  } else {
    atomicAdd(&g_launches[1], 1ull);
  }
}

}  // namespace

extern "C" int trace_stamp_launch(void* ring, void* cursor,
                                  unsigned long long cap,
                                  unsigned long long site, void* stream) {
  stamp_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned long long*>(ring),
      static_cast<unsigned long long*>(cursor), cap, site);
  return (int)cudaGetLastError();
}

extern "C" int trace_stamp_device_launches(unsigned long long* out) {
  cudaError_t err = cudaDeviceSynchronize();
  if (err == cudaSuccess)
    err = cudaMemcpyFromSymbol(out, g_launches, sizeof(g_launches));
  return (int)err;
}

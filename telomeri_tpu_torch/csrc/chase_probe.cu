// Dependent-load latency probe for Hopper (sm_90a). It replaces no reference
// function and runs on no path of the program: chip_smoke.py times it to give
// the greedy scan (csrc/greedy_scan.cu, a walk is a chain of dependent row
// fetches) the time its chain cannot beat.
//
// One thread follows next[] for `hops` loads, each load's address the value of
// the load before, so no two loads overlap and the kernel's time over `hops`
// is one load's latency. __ldcg caches in the L2 only: over a cycle the L2
// holds, that is an L2 hit's latency; over one far larger than the L2, a
// device-memory load's. Bound: latency, by construction.

#include <cuda_runtime.h>

namespace {

__global__ void chase_kernel(const int* __restrict__ next, int start, int hops,
                             int* __restrict__ out) {
  int i = start;
  for (int h = 0; h < hops; ++h) i = __ldcg(next + i);
  *out = i;  // keeps the chain
}

}  // namespace

// Launches one thread on `stream` without synchronising; returns
// cudaGetLastError(). next is int32, every entry an index into it.
extern "C" int telomeri_chase(const int* next, int start, int hops, int* out, void* stream) {
  chase_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(next, start, hops, out);
  return (int)cudaGetLastError();
}

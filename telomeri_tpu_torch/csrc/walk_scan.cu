// All-Monte-Carlo walk scan for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel telomeri_tpu/kernels/walk_vmem.py::_walk_kernel
// (driven by _vmem_scan / run_walks_mc_vmem), itself the twin of the lax.scan in
// telomeri_tpu/walk/engine.py::_mc_fast_core. Records are bit-equal to both.
//
// Per walk and step s (the walk's node is `cur`):
//   1. fetch row `cur` of the packed table wide (N, 6H) int32:
//      [nbr | cum | eid | adv | es_bits | os_bits], each block H wide;
//   2. total  = cum[H-1];
//   3. r      = (bits[s] & 0x7FFFFFFF) % max(total, 1)        (int32);
//   4. choice = min(#{j : cum[j] <= r}, H-1);
//   5. write the step's records: nbr, total, eid, adv, es_bits at `choice`;
//   6. cur = nbr[choice] if it is >= 0.
// A dead row (total <= 0) gives r = 0, every cum entry <= 0, choice = H-1: a pad
// slot, nxt = -1, and the walk stays put, exactly as on the TPU. Events (dead row,
// revisit, anchor hit) are resolved afterwards from the records, in torch
// (telomeri_tpu_torch/walk/engine.py::resolve_mc_events).
//
// Design: one warp per walk, a loop over the S steps inside the warp. The H-wide
// cum block is read coalesced (lane l reads slots l, l+32, ...); __ballot_sync +
// __popc of (cum <= r) gives the compare-count without a search; lanes 0-3 then
// read the chosen slot's nbr / eid / adv / es_bits and write one record each, lane
// 4 writes `total`, and __shfl_sync hands nbr to the whole warp for the next step.
// The Mosaic gather workarounds of the TPU kernel (take / dyng / loop) have no
// counterpart here: a warp simply loads the row it needs.
//
// Bound: the latency of a dependent row gather per step (the next row's address
// is the value just read), not bandwidth: per step a walk reads one 4H-byte cum
// block plus 4 words and writes 20 bytes. The table (40.9 MB for the E. coli
// preset) stays in device memory and is served mostly from the 50 MB L2; enough
// warps in flight (8 per block, thousands of blocks) hide the latency.

#include <cuda_runtime.h>

namespace {

constexpr unsigned kFullMask = 0xffffffffu;

__global__ void walk_scan_kernel(const int* __restrict__ wide, int h,
                                 const int* __restrict__ start,
                                 const int* __restrict__ bits,  // (S, W) uint32 bit patterns
                                 int w, int s_max,
                                 int* __restrict__ out) {  // (5, W, S): nxt, total, eid, adv, es
  const int walk = (int)(((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (walk >= w) return;  // whole warps only: blockDim is a multiple of 32
  const long long row_stride = 6LL * h;
  const long long plane = (long long)w * s_max;
  // lanes 0..3 own one picked field each: block 0 (nbr), 2 (eid), 3 (adv), 4 (es);
  // the record plane has the same index, plane 1 is `total` (lane 4)
  const int field = lane == 0 ? 0 : lane + 1;
  int cur = start[walk];
  for (int s = 0; s < s_max; ++s) {
    const int* row = wide + (long long)cur * row_stride;
    const int* cum = row + h;
    const int total = __ldg(cum + h - 1);
    const unsigned b = (unsigned)__ldg(bits + (long long)s * w + walk);
    const int r = (int)(b & 0x7FFFFFFFu) % max(total, 1);
    int count = 0;
    for (int j = lane; j < h; j += 32) {  // h % 32 == 0: every lane takes every turn
      count += __popc(__ballot_sync(kFullMask, __ldg(cum + j) <= r));
    }
    const int choice = min(count, h - 1);
    int v = 0;
    if (lane < 4) v = __ldg(row + (long long)field * h + choice);
    const int nxt = __shfl_sync(kFullMask, v, 0);
    const long long o = (long long)walk * s_max + s;
    if (lane < 4) out[field * plane + o] = v;
    else if (lane == 4) out[plane + o] = total;
    cur = nxt >= 0 ? nxt : cur;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError() so the
// caller can raise on a refused launch. Requires h % 32 == 0.
extern "C" int telomeri_walk_scan(const int* wide, int h, const int* start,
                                  const int* bits, int w, int s_max, int* out,
                                  void* stream) {
  if (w <= 0 || s_max <= 0) return (int)cudaSuccess;
  if (h <= 0 || h % 32 != 0) return (int)cudaErrorInvalidValue;
  const int threads = 256;  // 8 walks per block
  const long long blocks = ((long long)w * 32 + threads - 1) / threads;
  walk_scan_kernel<<<(unsigned)blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      wide, h, start, bits, w, s_max, out);
  return (int)cudaGetLastError();
}

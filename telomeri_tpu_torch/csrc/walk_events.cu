// Monte-Carlo event resolution for Hopper (sm_90a).
//
// Replaces telomeri_tpu/walk/engine.py::_resolve_mc_events (:313-376), the
// vectorised post-hoc resolution that the reference runs inside its one walk
// program after the historyless MC scan (_mc_fast_core, :307; its Pallas twin
// kernels/walk_vmem.py feeds it the same records). It has no Pallas kernel of
// its own: XLA compiles it. Input: the scan's five (W, S) int32 record planes
// (csrc/walk_scan.cu: nxt, total, eid, adv, es_bits), the walks' start and
// active flags. Output: the seven WalkResult fields, bit-equal to the plain
// torch version (kernels/walk_events.py resolve_events_torch).
//
// Per walk (one thread), in step order t = 0 .. S-1, until the first event:
//   - kill   total[t] <= 0 (a dead row), or nxt[t] equals start or any of
//            nxt[0 .. t-1], -1 included (a revisit: the cycle kill);
//   - anchor nxt[t] < 2 * n_anchors, unless a kill holds at the same step (a
//            kill at the step of an anchor hit wins).
// An inactive walk is killed before step 0. n_taken = t + 1 after an anchor
// hit (success, terminal = nxt[t]), t after a kill, S with no event. Steps
// t < n_taken are taken: nodes = [start, nxt[0..n_taken-1], -1 ...], eids
// likewise with -1 pads, path_len the int32 (wrapping) sum of adv over the
// taken steps, score_sum the float32 sum of their ES in XLA's row-reduce order
// (walk_common.cuh StepSum). The revisit test is the pairwise one: both
// branches of the reference (the packed sort and the pairwise compare) give
// this same t_rev, and computed this way it needs no int32 packing of node ids,
// so there is no overflow branch and any n_nodes is taken.
//
// Bound: bytes. There is no arithmetic to speak of (at most S(S+1)/2 compares
// a walk, 528 at S = 32). A thread that reads and writes its walk's rows
// straight from device memory puts a warp's accesses on 32 rows S * 4 bytes
// apart: at 1.57M walks that ran at 7.6% of the byte bound on an H100. So a
// block of nw walks moves its records as whole spans (the block's rows of a
// plane are one contiguous span of nw * S int32, and of nodes one of
// nw * (S+1)), every access of a warp on neighbouring addresses:
//   1. nxt rows into shared memory, rows kept `stride` = S | 1 apart (odd, so
//      the 32 rows a warp reads at one step fall in 32 banks), and one bit a
//      step for total <= 0 (a warp's ballot over 32 neighbouring steps);
//   2. each thread finds its walk's first event on those rows, keeping the
//      revisit test in shared memory too;
//   3. over the spans: nodes written from the nxt rows; then eids written (eid
//      where taken, else -1) and adv added into the walk's path_len with
//      shared-memory atomics (an int32 sum: its order does not change it),
//      both read only at taken steps; es where taken (+0.0 elsewhere) into
//      the rows the nxt values leave free;
//   4. each thread sums its walk's es row in XLA's order and writes the
//      scalars.
// nxt and total are read whole (the event is not known before); eid, adv and
// es only where a step was taken, at the 32-byte granularity of the memory.
// A block takes kMaxWalks walks, or as many as fit its shared memory in 48 KB
// (about S <= 700 for all 64); one walk of the longest path StepSum takes,
// 32**3 steps, needs 132 KiB. Nothing is allocated: the wrapper's torch.empty.

#include "walk_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 64;   // threads a block
constexpr int kMaxWalks = 64;  // walks a block at most, a thread each

// int32 words of shared memory a block of nw walks of S steps takes: the nxt
// (then es) rows, the dead-row bits, and n_taken and path_len of each walk.
__host__ __device__ inline size_t smem_words(int nw, int s_max) {
  return (size_t)nw * (s_max | 1) + ((size_t)nw * s_max + 31) / 32 + 2 * (size_t)nw;
}

__global__ void __launch_bounds__(kThreads)
resolve_events_kernel(const int* __restrict__ nxt, const int* __restrict__ total,
                      const int* __restrict__ eid, const int* __restrict__ adv,
                      const int* __restrict__ es, const int* __restrict__ start,
                      const unsigned char* __restrict__ active, int anchor_lim, int w,
                      int s_max, int walks_per_block, int* __restrict__ nodes,
                      int* __restrict__ eids, int* __restrict__ steps,
                      unsigned char* __restrict__ success, int* __restrict__ terminal,
                      int* __restrict__ path_len, float* __restrict__ score_sum) {
  extern __shared__ int smem[];
  const int stride = s_max | 1;
  int* rows = smem;  // (walks_per_block, stride): the nxt rows, then the taken es rows
  unsigned* dead = reinterpret_cast<unsigned*>(rows + (size_t)walks_per_block * stride);
  int* taken = reinterpret_cast<int*>(dead + ((size_t)walks_per_block * s_max + 31) / 32);
  int* plen = taken + walks_per_block;  // n_taken, path_len of each walk
  const long long w0 = (long long)blockIdx.x * walks_per_block;
  const int nw = (int)min((long long)walks_per_block, (long long)w - w0);  // this block's walks
  const long long base = w0 * s_max;  // its rows of a record plane: one span
  const int span = nw * s_max;
  const int me = threadIdx.x;

  // bit i of `dead`: total <= 0 at place i of the span (walk i / S, step i % S);
  // warp k of a pass covers places i0 + 32k .. i0 + 32k + 31, one word
  for (int i0 = 0; i0 < span; i0 += kThreads) {
    const int i = i0 + me;
    bool is_dead = false;
    if (i < span) {
      const int r = i / s_max, t = i - r * s_max;
      rows[r * stride + t] = __ldg(nxt + base + i);
      is_dead = __ldg(total + base + i) <= 0;
    }
    const unsigned word = __ballot_sync(kFullMask, is_dead);
    const int first = i - (me & 31);
    if ((me & 31) == 0 && first < span) dead[first >> 5] = word;
  }
  __syncthreads();

  int n_taken = 0, term = -1;
  bool hit = false;
  if (me < nw) {
    const int* row = rows + me * stride;
    const int bit0 = me * s_max;
    const int first = start[w0 + me];
    if (active[w0 + me]) {
      n_taken = s_max;
      for (int t = 0; t < s_max; ++t) {
        const int v = row[t];
        const int b = bit0 + t;
        bool kill = ((dead[b >> 5] >> (b & 31)) & 1u) || v == first;
        for (int j = 0; j < t && !kill; ++j) kill = row[j] == v;
        if (kill) {
          n_taken = t;
          break;
        }
        if (v < anchor_lim) {
          n_taken = t + 1;
          hit = true;
          term = v;
          break;
        }
      }
    }
    taken[me] = n_taken;
    plen[me] = 0;
  }
  __syncthreads();

  const int node_span = nw * (s_max + 1);
  int* nd = nodes + w0 * (s_max + 1);
  for (int i = me; i < node_span; i += kThreads) {
    const int r = i / (s_max + 1), c = i - r * (s_max + 1);
    nd[i] = c == 0 ? start[w0 + r] : c - 1 < taken[r] ? rows[r * stride + c - 1] : -1;
  }
  __syncthreads();  // the nxt rows are read: the es rows take their place
  for (int i = me; i < span; i += kThreads) {
    const int r = i / s_max, t = i - r * s_max;
    const bool took = t < taken[r];
    eids[base + i] = took ? __ldg(eid + base + i) : -1;
    if (took) atomicAdd(plen + r, __ldg(adv + base + i));
    rows[r * stride + t] = took ? __ldg(es + base + i) : 0;  // +0.0 where not taken
  }
  __syncthreads();

  if (me < nw) {
    const int* es_row = rows + me * stride;
    StepSum sum(s_max);
    for (int t = 0; t < s_max; ++t) sum.add(__int_as_float(es_row[t]));
    steps[w0 + me] = n_taken;
    success[w0 + me] = hit ? 1 : 0;
    terminal[w0 + me] = term;
    path_len[w0 + me] = plen[me];
    score_sum[w0 + me] = sum.result();
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError() (or
// the error that kept it from launching) so the caller can raise. Every plane
// is (W, S) int32, contiguous; active and success are bool (one byte).
// Requires 1 <= S <= 32**3.
extern "C" int telomeri_resolve_events(const int* nxt, const int* total, const int* eid,
                                       const int* adv, const int* es, const int* start,
                                       const unsigned char* active, int anchor_lim, int w,
                                       int s_max, int* nodes, int* eids, int* steps,
                                       unsigned char* success, int* terminal, int* path_len,
                                       float* score_sum, void* stream) {
  if (w <= 0) return (int)cudaSuccess;
  if (s_max <= 0 || s_max > kMaxSteps) return (int)cudaErrorInvalidValue;
  int nw = kMaxWalks;
  while (nw > 1 && smem_words(nw, s_max) * sizeof(int) > kDefaultSmem) --nw;
  const size_t smem = smem_words(nw, s_max) * sizeof(int);
  if (smem > kDefaultSmem) {  // one walk's rows need more: opt in, up to the card's limit
    const cudaError_t rc = cudaFuncSetAttribute(
        resolve_events_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = ((long long)w + nw - 1) / nw;
  resolve_events_kernel<<<(unsigned)blocks, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      nxt, total, eid, adv, es, start, active, anchor_lim, w, s_max, nw, nodes, eids, steps,
      success, terminal, path_len, score_sum);
  return (int)cudaGetLastError();
}

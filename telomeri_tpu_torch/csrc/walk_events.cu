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
// Per walk, in step order t = 0 .. S-1, until the first event:
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
// Bound: bytes (the compares are a few warp instructions per 32 steps). Design:
// one warp a walk, lane = step, in 32-step chunks in order, stopping after the
// chunk that holds the event:
//   - nxt and total come in coalesced rows, only for the chunks up to the
//     event; a dead row is a __ballot_sync of total <= 0, an anchor one of
//     nxt < 2 * n_anchors; step t revisits when nxt[t] == start, when a lower
//     lane holds the same node (__match_any_sync), or, past the first chunk,
//     when an earlier chunk's node (kept in shared memory) equals it, read by
//     broadcast 16 bytes at a time; the event is the lowest set bit of
//     kill | anchor, and a kill wins at its step;
//   - eid and adv are read only by lanes of taken steps, so untouched 32-byte
//     sectors are never fetched; nodes and eids are written as whole rows;
//     path_len is a __reduce_add_sync.
// At S <= 32 (the main path's 32 steps) a warp takes tiles of up to 32
// consecutive walks and the blocks are persistent (as many as the card holds):
// lane k loads walk k's start and active flag and stores its five scalars, so
// they move once a tile, coalesced, instead of as single words a walk; each
// walk's next rows are loaded before the walk is searched; and at the tile's
// end lane k sums its own walk's taken ES values in step order, one add a step
// a lane, where a warp feeding one lane would spend 32 shuffles and 32 adds a
// walk. On an H100 that took the 1.57M-walk peak from 0.64 ms (a warp a walk,
// the sum by shuffles) to about 0.54 ms, half of its bound; keeping the eid /
// adv loads in flight one walk longer, reading every plane with the rows, or
// forcing more warps an SM (they spill) ran no faster, so the kernel is not
// waiting on its loads, and staging the rows by bulk copies (cp.async.bulk)
// was not built. Longer walks keep the
// first design (StepSum fed in step order by shuffles); a block takes kWarps
// of them, or as many as their paths (S + 1 int32 each, rounded up to 16
// bytes) fit 48 KB; one path of the longest walk StepSum takes, 32**3 steps,
// needs 128 KiB. Nothing is allocated: the wrapper's torch.empty.

#include "walk_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kWarps = 8;  // walks a block at a time, a warp each

// int32 words of one warp's path at S > 32: start, then nxt[0..S-1], rounded
// up to 16 bytes
__host__ __device__ inline int path_words(int s_max) { return (s_max + 1 + 3) & ~3; }

// S <= 32: lane t holds step t. A warp resolves tiles of `tw` consecutive walks
// in order (blocks are persistent: as many as the card holds). Lane k of the
// warp loads walk k's start and active flag and keeps its scalars, so those
// are read and written once a tile, coalesced; each walk's next rows are
// loaded before the walk is searched. At the tile's end lane k sums its own
// walk's es row in step order (a sequential sum from +0.0 is XLA's order at
// S <= 32), reading only the sectors of taken steps: one add a step per lane
// instead of 32 shuffles and adds a walk.
__global__ void __launch_bounds__(kWarps * 32)
resolve_events_kernel_short(const int* __restrict__ nxt, const int* __restrict__ total,
                            const int* __restrict__ eid, const int* __restrict__ adv,
                            const int* __restrict__ es, const int* __restrict__ start,
                            const unsigned char* __restrict__ active, int anchor_lim, int w,
                            int s_max, int tw, int* __restrict__ nodes, int* __restrict__ eids,
                            int* __restrict__ steps, unsigned char* __restrict__ success,
                            int* __restrict__ terminal, int* __restrict__ path_len,
                            float* __restrict__ score_sum) {
  const int lane = threadIdx.x & 31;
  const long long n_tiles = ((long long)w + tw - 1) / tw;
  const long long n_warps = (long long)gridDim.x * kWarps;
  const bool in = lane < s_max;
  const unsigned lanes = s_max >= 32 ? kFullMask : (1u << s_max) - 1u;
  const unsigned lower = (1u << lane) - 1u;
  for (long long tile = (long long)blockIdx.x * kWarps + (threadIdx.x >> 5); tile < n_tiles;
       tile += n_warps) {
    const long long base = tile * tw;
    const int nw = (int)min((long long)tw, (long long)w - base);  // walks in this tile
    const int first_l = lane < nw ? __ldg(start + base + lane) : 0;
    const bool act_l = lane < nw && active[base + lane];
    int my_taken = 0, my_term = -1, my_plen = 0;  // lane k: walk k's scalars
    bool my_hit = false;
    long long o = base * s_max + lane;  // step `lane` of the tile's current walk
    int v = in ? __ldg(nxt + o) : -1;
    int tot = in ? __ldg(total + o) : 1;
    for (int k = 0; k < nw; ++k, o += s_max) {
      int v_n = -1, tot_n = 1;  // the next walk's rows, in flight while this one resolves
      if (k + 1 < nw && in) {
        v_n = __ldg(nxt + o + s_max);
        tot_n = __ldg(total + o + s_max);
      }
      const int first = __shfl_sync(kFullMask, first_l, k);
      const bool act = __shfl_sync(kFullMask, (int)act_l, k) != 0;
      const unsigned same = __match_any_sync(kFullMask, v);
      const bool kill = tot <= 0 || v == first || (same & lower) != 0u;
      const unsigned kills = __ballot_sync(kFullMask, kill) & lanes;
      const unsigned events = kills | (__ballot_sync(kFullMask, v < anchor_lim) & lanes);
      const int t_ev = events ? __ffs(events) - 1 : 0;
      const int v_ev = __shfl_sync(kFullMask, v, t_ev);
      int n_taken = s_max, term = -1;
      bool hit = false;
      if (!act) {
        n_taken = 0;
      } else if (events) {
        hit = !((kills >> t_ev) & 1u);
        n_taken = hit ? t_ev + 1 : t_ev;
        if (hit) term = v_ev;
      }

      const bool took = lane < n_taken;  // eid and adv only where the step is taken
      const int e = took ? __ldg(eid + o) : -1;
      const int a = took ? __ldg(adv + o) : 0;
      int* nd = nodes + (base + k) * (s_max + 1);
      if (lane == 0) nd[0] = first;
      if (in) {
        nd[1 + lane] = took ? v : -1;
        eids[o] = e;
      }
      const int plen = (int)__reduce_add_sync(kFullMask, (unsigned)a);
      if (lane == k) {
        my_taken = n_taken;
        my_hit = hit;
        my_term = term;
        my_plen = plen;
      }
      v = v_n;
      tot = tot_n;
    }
    if (lane < nw) {
      const int* row = es + (base + lane) * s_max;
      float sum = 0.0f;
      for (int t0 = 0; t0 < my_taken; t0 += 8) {  // 8 loads in flight, then 8 adds
        int x[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) x[i] = t0 + i < my_taken ? __ldg(row + t0 + i) : 0;
#pragma unroll
        for (int i = 0; i < 8; ++i) sum = __fadd_rn(sum, __int_as_float(x[i]));
      }
      steps[base + lane] = my_taken;
      success[base + lane] = my_hit ? 1 : 0;
      terminal[base + lane] = my_term;
      path_len[base + lane] = my_plen;
      score_sum[base + lane] = sum;
    }
  }
}

// S > 32: 32-step chunks in order; each warp keeps its walk's path (start, then
// nxt of the chunks read) in shared memory for the later chunks' revisit test
// and for the nodes row.
__global__ void __launch_bounds__(kWarps * 32)
resolve_events_kernel_long(const int* __restrict__ nxt, const int* __restrict__ total,
                           const int* __restrict__ eid, const int* __restrict__ adv,
                           const int* __restrict__ es, const int* __restrict__ start,
                           const unsigned char* __restrict__ active, int anchor_lim, int w,
                           int s_max, int* __restrict__ nodes, int* __restrict__ eids,
                           int* __restrict__ steps, unsigned char* __restrict__ success,
                           int* __restrict__ terminal, int* __restrict__ path_len,
                           float* __restrict__ score_sum) {
  extern __shared__ int4 smem4[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int words = path_words(s_max);
  const int4* path4 = smem4 + warp * (words / 4);
  int* path = reinterpret_cast<int*>(smem4 + warp * (words / 4));
  const unsigned lower = (1u << lane) - 1u;
  const long long walk = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (walk >= w) return;  // the whole warp
  const long long row = walk * s_max;
  const int first = __ldg(start + walk);
  if (lane == 0) path[0] = first;
  __syncwarp();

  int n_taken = active[walk] ? s_max : 0, term = -1;
  bool hit = false;
  for (int c0 = 0; c0 < n_taken; c0 += 32) {
    const int t = c0 + lane;
    const bool in = t < s_max;
    const int v = in ? __ldg(nxt + row + t) : -1;
    const int tot = in ? __ldg(total + row + t) : 1;
    // earlier nodes, path[0 .. c0] = start, nxt[0 .. c0-1]: a broadcast read each
    bool rev = v == path[c0];
    for (int i4 = 0; i4 < c0 / 4; ++i4) {
      const int4 q = path4[i4];
      rev |= (v == q.x) | (v == q.y) | (v == q.z) | (v == q.w);
    }
    rev |= (__match_any_sync(kFullMask, v) & lower) != 0u;
    const unsigned lanes = __ballot_sync(kFullMask, in);
    const unsigned kills = __ballot_sync(kFullMask, tot <= 0 || rev) & lanes;
    const unsigned events = kills | (__ballot_sync(kFullMask, v < anchor_lim) & lanes);
    if (in) path[c0 + 1 + lane] = v;
    __syncwarp();
    if (events) {
      const int t_ev = __ffs(events) - 1;
      const int v_ev = __shfl_sync(kFullMask, v, t_ev);
      hit = !((kills >> t_ev) & 1u);
      n_taken = c0 + (hit ? t_ev + 1 : t_ev);
      if (hit) term = v_ev;
    }
  }

  int* nd = nodes + walk * (s_max + 1);
  for (int i = lane; i <= s_max; i += 32) nd[i] = i == 0 ? first : i - 1 < n_taken ? path[i] : -1;
  unsigned plen = 0u;
  StepSum sum(s_max);
  for (int c0 = 0; c0 < s_max; c0 += 32) {
    const int t = c0 + lane;
    const int n = min(32, s_max - c0);  // steps in this chunk
    if (c0 >= n_taken) {  // nothing taken: -1 eids, and the pads only close windows
      if (t < s_max) eids[row + t] = -1;
      for (int i = 0; i < n; ++i) sum.add(0.0f);
      continue;
    }
    const bool took = t < n_taken;
    int e = -1, a = 0, x = 0;
    if (took) {
      e = __ldg(eid + row + t);
      a = __ldg(adv + row + t);
      x = __ldg(es + row + t);
    }
    if (t < s_max) eids[row + t] = e;
    plen += __reduce_add_sync(kFullMask, (unsigned)a);
    for (int i = 0; i < n; ++i) sum.add(__int_as_float(__shfl_sync(kFullMask, x, i)));
  }
  if (lane == 0) {
    steps[walk] = n_taken;
    success[walk] = hit ? 1 : 0;
    terminal[walk] = term;
    path_len[walk] = (int)plen;
    score_sum[walk] = sum.result();
  }
}

// Blocks of kWarps warps that the card holds at once for the short kernel, in
// `blocks` (the cards of a host are alike: read once a process).
cudaError_t resident_short_blocks(int* blocks) {
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaError_t rc = cudaGetDevice(&dev);
    if (rc == cudaSuccess) rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (rc == cudaSuccess) {
      rc = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, resolve_events_kernel_short,
                                                         kWarps * 32, 0);
    }
    if (rc != cudaSuccess) return rc;
    resident = (per_sm > 1 ? per_sm : 1) * (sms > 1 ? sms : 1);
  }
  *blocks = resident;
  return cudaSuccess;
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (s_max <= 32) {
    int resident = 0;
    const cudaError_t rc = resident_short_blocks(&resident);
    if (rc != cudaSuccess) return (int)rc;
    int tw = 32;  // walks a tile: the most that still give every resident warp a tile
    while (tw > 1 && ((long long)w + tw - 1) / tw < (long long)resident * kWarps) tw /= 2;
    const long long tiles = ((long long)w + tw - 1) / tw;
    const long long needed = (tiles + kWarps - 1) / kWarps;
    const long long blocks = needed < resident ? needed : resident;
    resolve_events_kernel_short<<<(unsigned)blocks, kWarps * 32, 0, st>>>(
        nxt, total, eid, adv, es, start, active, anchor_lim, w, s_max, tw, nodes, eids, steps,
        success, terminal, path_len, score_sum);
    return (int)cudaGetLastError();
  }
  const size_t path = (size_t)path_words(s_max) * sizeof(int);
  const size_t fit = kDefaultSmem / path;  // paths in 48 KB
  const int warps = fit >= (size_t)kWarps ? kWarps : fit >= 1 ? (int)fit : 1;
  const size_t smem = warps * path;
  if (smem > kDefaultSmem) {  // one path needs more: opt in, up to the card's limit
    const cudaError_t rc = cudaFuncSetAttribute(
        resolve_events_kernel_long, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = ((long long)w + warps - 1) / warps;
  resolve_events_kernel_long<<<(unsigned)blocks, warps * 32, smem, st>>>(
      nxt, total, eid, adv, es, start, active, anchor_lim, w, s_max, nodes, eids, steps,
      success, terminal, path_len, score_sum);
  return (int)cudaGetLastError();
}

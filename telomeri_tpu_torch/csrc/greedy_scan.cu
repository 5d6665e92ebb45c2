// Greedy and mixed walk scan with the in-scan visited list, for Hopper (sm_90a).
//
// Replaces telomeri_tpu/walk/engine.py::_kind_core (:401-543), the lax.scan
// that the reference runs inside its one walk program for the greedy section
// (kind "greedy") and for plans that are not sectioned (kind "mixed"). It has
// no Pallas kernel of its own: XLA compiles the scan. Bit-equal to the plain
// torch loop (kernels/greedy_scan.py greedy_scan_torch).
//
// Per walk, per step s while the walk is not done (its node is `cur`, its path
// visited[0..S] holds start, then the node of each step taken, -1 elsewhere):
//   1. fetch row `cur` of the packed table wide (N, 6H) int32:
//      [nbr | cum | eid | adv | es_bits | os_bits], each block H wide;
//   2. greedy: valid[j] = nbr[j] >= 0 and nbr[j] not in visited; the key is
//      os[j] (a float) for mode 0 (greedy by OS) and -j otherwise (greedy by
//      ES: rows are ES-sorted, so the first valid slot), -inf where not
//      valid; choice = the FIRST maximum slot in torch.argmax / jnp.argmax
//      order (NaN is the maximum, the first NaN wins; all -inf gives slot 0);
//      dead = no slot is valid;
//   3. mixed only, for an MC walk (mode 2) instead of 2: r = (bits &
//      0x7FFFFFFF) % max(total, 1) with total = cum[H-1] and bits the walk's
//      Threefry draw of step s (walk_common.cuh), choice = min(#{cum <= r},
//      H-1), dead = total <= 0 (the reference computes the greedy choice of an
//      MC walk too and drops it);
//   4. at step 0 a walk with first_edge >= 0 takes that slot, dead unless the
//      slot is valid (a slot outside [0, H) reads nothing, picks nbr 0, dead);
//   5. nxt, eid, adv, es at the slot; mixed MC walks also die when nxt is on
//      visited[0..S] (the cycle kill; -1 is always there, so a pad kills);
//   6. unless dead: step to nxt (visited[s+1] = nxt, the edge and its advance
//      and ES recorded); an anchor (nxt < 2 * n_anchors) ends the walk with
//      success; dead or anchor, the walk is done.
// A done walk stops: its remaining steps are the pads (-1 nodes and eids, +0.0
// ES), as the reference masks them. path_len is an int32 (wrapping) sum,
// score_sum the float32 sum in XLA's row-reduce order (walk_common.cuh StepSum).
//
// Bound: the latency of a chain. A walk is up to S dependent row fetches (the
// next row is the node just picked), each a load of the nbr block (and the OS
// or cum block) and then of the four picked words; the bytes are negligible
// (480 walks x 32 steps x under 1 KB on the bench) and nothing multiplies
// matrices. The design keeps every step of a walk on the card in one launch
// instead of ~40 host launches a step: one warp per walk, each lane loading
// 16-byte pieces of the blocks and testing its slots against the warp's
// visited list in shared memory (broadcast reads), a __shfl_xor_sync butterfly
// for the first maximum, lanes 0-3 picking nbr / eid / adv / es in one
// instruction. Lane 0 writes the eid of each step taken; the path is written
// once at the end from shared memory, coalesced, with the eids' pads; no
// (W, S) took / adv / es planes exist. A block takes kMaxWarps walks, or as
// many paths (S + 1 int32 each) as fit 48 KB of shared memory; one path of
// the longest walk StepSum takes, 32**3 steps, needs 128 KiB.

#include <math.h>

#include "walk_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWarps = 4;  // walks a block at most, a warp each
constexpr int kModeGreedyOs = 0;
constexpr int kModeMc = 2;

// (key, slot) = the larger of itself and (k, j): NaN above every number, then
// the value (-0.0 == +0.0), then the LOWER slot. A total order on distinct
// slots, so the butterfly gives every lane the first maximum.
__device__ __forceinline__ void take_max(float k, int j, float& key, int& slot) {
  const bool k_nan = isnan(k), key_nan = isnan(key);
  const bool better = key_nan ? (k_nan && j < slot)
                              : (k_nan || k > key || (k == key && j < slot));
  if (better) {
    key = k;
    slot = j;
  }
}

// Whether v is one of the S + 1 entries of the warp's visited list (each lane
// tests every 32nd; the answer is the warp's).
__device__ __forceinline__ bool on_path(const int* visited, int s_max, int v, int lane) {
  bool found = false;
  for (int t = lane; t <= s_max; t += 32) found |= visited[t] == v;
  return __any_sync(kFullMask, found);
}

__device__ __forceinline__ int count_le(const int4& c, int r) {
  return (c.x <= r) + (c.y <= r) + (c.z <= r) + (c.w <= r);
}

template <bool kMixed>
__global__ void __launch_bounds__(kMaxWarps * 32)
greedy_scan_kernel(const int* __restrict__ wide, int h, long long n_nodes,
                   const int* __restrict__ start, const int* __restrict__ first_edge,
                   const int* __restrict__ mode, const int* __restrict__ uid,
                   const unsigned char* __restrict__ active, unsigned seed, int anchor_lim,
                   int w, int s_max, int* __restrict__ nodes, int* __restrict__ eids,
                   int* __restrict__ steps, unsigned char* __restrict__ success,
                   int* __restrict__ terminal, int* __restrict__ path_len,
                   float* __restrict__ score_sum) {
  extern __shared__ int smem[];  // per warp: the path, visited (S + 1)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long walk = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (walk >= w) return;  // the whole warp
  int* visited = smem + warp * (s_max + 1);
  int* ed = eids + walk * s_max;
  const int first = start[walk];
  for (int t = lane; t <= s_max; t += 32) visited[t] = t == 0 ? first : -1;
  __syncwarp();

  const long long row_stride = 6LL * h;
  const int md = mode[walk];
  const bool by_os = md == kModeGreedyOs;
  const bool mc = kMixed && md == kModeMc;
  const int forced_slot = first_edge[walk];
  unsigned k0 = 0u, k1 = 0u;
  if (mc) fold_in(seed, uid[walk], k0, k1);

  bool done = !active[walk];
  bool hit = false;
  int cur = first, n_taken = 0, term = -1;
  unsigned plen = 0u;
  StepSum sum(s_max);
  int s = 0;
  for (; s < s_max && !done; ++s) {
    // torch and jnp index row -1 as the last row; only a walk whose valid keys
    // are all -inf could step onto a pad, and it would read that row too
    const long long r = cur < 0 ? cur + n_nodes : cur;
    const int* row = wide + r * row_stride;
    const int4* nbr4 = reinterpret_cast<const int4*>(row);
    const int4* os4 = reinterpret_cast<const int4*>(row + 5 * h);

    int choice;
    bool dead;
    if (mc) {  // the draw; an MC walk never needs the greedy choice
      const int total = __ldg(row + 2 * h - 1);
      const unsigned bits = draw_bits(k0, k1, s);
      const int rr = (int)((bits & 0x7FFFFFFFu) % (unsigned)max(total, 1));
      const int4* cum4 = reinterpret_cast<const int4*>(row + h);
      int count = 0;
      for (int c = lane; c < h / 4; c += 32) count += count_le(__ldg(cum4 + c), rr);
      choice = min(__reduce_add_sync(kFullMask, count), h - 1);
      dead = total <= 0;
    } else {
      float key = -INFINITY;
      choice = h;  // every slot beats it on a tie; lanes without slots keep it
      bool any_valid = false;
      for (int c = lane; c < h / 4; c += 32) {
        const int4 nb = __ldg(nbr4 + c);
        const int4 ob = by_os ? __ldg(os4 + c) : make_int4(0, 0, 0, 0);
        const int nbv[4] = {nb.x, nb.y, nb.z, nb.w};
        const int obv[4] = {ob.x, ob.y, ob.z, ob.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int j = 4 * c + i;
          bool valid = nbv[i] >= 0;
          for (int t = 0; t <= s && valid; ++t) valid = visited[t] != nbv[i];
          any_valid |= valid;
          const float k = !valid ? -INFINITY : by_os ? __int_as_float(obv[i]) : -(float)j;
          take_max(k, j, key, choice);
        }
      }
#pragma unroll
      for (int d = 16; d > 0; d >>= 1) {
        const float k = __shfl_xor_sync(kFullMask, key, d);
        const int j = __shfl_xor_sync(kFullMask, choice, d);
        take_max(k, j, key, choice);
      }
      dead = !__any_sync(kFullMask, any_valid);
    }

    const bool forced = s == 0 && forced_slot >= 0;
    if (forced) choice = forced_slot;
    const bool inside = choice >= 0 && choice < h;
    // lane 0 picks nbr (block 0), lanes 1-3 eid, adv, es (blocks 2, 3, 4)
    int v = 0;
    if (lane < 4 && inside) v = __ldg(row + (long long)(lane == 0 ? 0 : lane + 1) * h + choice);
    const int nxt = __shfl_sync(kFullMask, v, 0);
    const int e_id = __shfl_sync(kFullMask, v, 1);
    const int e_adv = __shfl_sync(kFullMask, v, 2);
    const int e_es = __shfl_sync(kFullMask, v, 3);
    if (forced) dead = !(inside && nxt >= 0) || on_path(visited, s_max, nxt, lane);
    if (mc) dead = dead || on_path(visited, s_max, nxt, lane);

    if (!dead) {  // stepping
      hit = nxt < anchor_lim;
      cur = nxt;
      ++n_taken;
      plen += (unsigned)e_adv;
      if (lane == 0) {
        visited[s + 1] = nxt;
        ed[s] = e_id;  // steps 0 .. n_taken - 1 are the ones taken
      }
      if (hit) term = nxt;
    }
    sum.add(dead ? 0.0f : __int_as_float(e_es));
    done = dead || hit;
    __syncwarp();
  }
  for (; s < s_max; ++s) sum.add(0.0f);  // the pads only close windows

  int* nd = nodes + walk * (s_max + 1);
  for (int t = lane; t <= s_max; t += 32) nd[t] = visited[t];
  for (int t = n_taken + lane; t < s_max; t += 32) ed[t] = -1;
  if (lane == 0) {
    steps[walk] = n_taken;
    success[walk] = hit ? 1 : 0;
    terminal[walk] = term;
    path_len[walk] = (int)plen;
    score_sum[walk] = sum.result();
  }
}

template <bool kMixed>
int launch(const int* wide, int h, long long n_nodes, const int* start, const int* first_edge,
           const int* mode, const int* uid, const unsigned char* active, unsigned seed,
           int anchor_lim, int w, int s_max, int* nodes, int* eids, int* steps,
           unsigned char* success, int* terminal, int* path_len, float* score_sum,
           cudaStream_t stream) {
  const size_t path = (size_t)(s_max + 1) * sizeof(int);
  const size_t fit = kDefaultSmem / path;  // paths in 48 KB
  const int warps = fit >= (size_t)kMaxWarps ? kMaxWarps : fit >= 1 ? (int)fit : 1;
  const size_t smem = warps * path;
  if (smem > kDefaultSmem) {  // one path needs more: opt in, up to the card's limit
    const cudaError_t rc = cudaFuncSetAttribute(
        greedy_scan_kernel<kMixed>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = ((long long)w + warps - 1) / warps;
  greedy_scan_kernel<kMixed><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      wide, h, n_nodes, start, first_edge, mode, uid, active, seed, anchor_lim, w, s_max, nodes,
      eids, steps, success, terminal, path_len, score_sum);
  return (int)cudaGetLastError();
}

}  // namespace

// kind: 0 greedy, 1 mixed. Launches on `stream` without synchronising; returns
// cudaGetLastError() so the caller can raise on a refused launch. wide is
// (n_nodes, 6H) int32 with H % 64 == 0; the plan columns are (W,) int32, active
// and success bool (one byte); nodes (W, S+1), eids (W, S). Requires
// 1 <= S <= 32**3.
extern "C" int telomeri_greedy_scan(const int* wide, int h, long long n_nodes, const int* start,
                                    const int* first_edge, const int* mode, const int* uid,
                                    const unsigned char* active, unsigned seed, int anchor_lim,
                                    int kind, int w, int s_max, int* nodes, int* eids,
                                    int* steps, unsigned char* success, int* terminal,
                                    int* path_len, float* score_sum, void* stream) {
  if (w <= 0) return (int)cudaSuccess;
  if (h <= 0 || h % 64 != 0 || s_max <= 0 || s_max > kMaxSteps || (kind != 0 && kind != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (kind == 1) {
    return launch<true>(wide, h, n_nodes, start, first_edge, mode, uid, active, seed, anchor_lim,
                        w, s_max, nodes, eids, steps, success, terminal, path_len, score_sum, st);
  }
  return launch<false>(wide, h, n_nodes, start, first_edge, mode, uid, active, seed, anchor_lim,
                       w, s_max, nodes, eids, steps, success, terminal, path_len, score_sum, st);
}

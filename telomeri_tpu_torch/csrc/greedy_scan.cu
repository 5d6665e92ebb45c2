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
//   2. valid[j] = nbr[j] >= 0 and nbr[j] not in visited[0..s];
//   3. greedy: the key is os[j] (a float) for mode 0 (greedy by OS) and -j
//      otherwise (greedy by ES: rows are ES-sorted, so the first valid slot),
//      -inf where not valid; choice = the FIRST maximum slot in torch.argmax /
//      jnp.argmax order (NaN is the maximum, the first NaN wins; all -inf gives
//      slot 0); dead = no slot is valid;
//   4. mixed only, for an MC walk (mode 2) instead of 3: r = (bits &
//      0x7FFFFFFF) % max(total, 1) with total = cum[H-1] and bits the walk's
//      Threefry draw of step s (walk_common.cuh), choice = min(#{cum <= r},
//      H-1), dead = total <= 0 (the reference computes the greedy choice of an
//      MC walk too and drops it);
//   5. at step 0 a walk with first_edge >= 0 takes that slot, dead unless the
//      slot is valid (a slot outside [0, H) reads nothing, picks nbr 0, dead);
//   6. nxt, eid, adv, es at the slot; mixed MC walks also die when the slot is
//      not valid (the cycle kill: while a walk is not done visited[s+1..S] are
//      all -1, so "nxt on visited[0..S]" is "nxt < 0 or nxt on visited[0..s]");
//   7. unless dead: step to nxt (visited[s+1] = nxt, the edge and its advance
//      and ES recorded); an anchor (nxt < 2 * n_anchors) ends the walk with
//      success; dead or anchor, the walk is done.
// A done walk stops: its remaining steps are the pads (-1 nodes and eids, +0.0
// ES), as the reference masks them. path_len is an int32 (wrapping) sum,
// score_sum the float32 sum in XLA's row-reduce order (walk_common.cuh StepSum).
//
// Bound: the latency of a chain. A walk is up to S dependent row fetches (the
// next row is the node just picked); the bytes are negligible (480 walks x 32
// steps x under 2 KB on the bench) and nothing multiplies matrices. So the
// design keeps each step to ONE dependent load round and a few warp-wide
// instructions, one warp per walk, every step in one launch:
//   - slots by lane, strided: lane l holds slots l, l + 32, ... (kG groups of
//     32 slots in registers), so each block of the row is one coalesced
//     128-byte line per group and all 32 lanes work;
//   - one round of loads a step: nbr, the key block (OS for mode 0, cum for an
//     MC walk) AND eid, adv, es of the lane's own slots are all in flight
//     before any is used; the pick is a __shfl_sync from the slot's owner
//     lane, with no second trip to L2;
//   - the visited test reads the path from shared memory 16 bytes at a time,
//     every lane the same address (a broadcast), and compares each entry with
//     every slot the lane holds, with no early exit: the loads are independent.
//     One `valid` bit a slot serves the greedy key, the forced first edge and
//     the MC cycle kill;
//   - the first maximum without a butterfly: each key maps to an
//     order-preserving uint32 (every NaN 0xFFFFFFFF, -0.0 as +0.0, an invalid
//     slot as -inf), each lane keeps its own first maximum (lower group first),
//     __reduce_max_sync takes the warp's, and __reduce_min_sync over the slots
//     of the lanes that hold it gives the first such slot: torch.argmax order;
//   - the MC draw counts #{cum <= r} as __popc of one __ballot_sync a group;
//   - the step sum in registers (walk_common.cuh StepSum keeps its levels in
//     scalars: as arrays they sat on the stack, a local-memory trip a step).
// On an H100 the step is still several L2 hits long, and an instrumented
// build put most of it in the one load round (the rows of an L2-resident
// table, up to 12 lines a step), then the key and the visited test.
// Rows wider than 32 * 16 slots are read in pages of 512 slots, the pick then
// a second load (no table of the package is that wide at its default
// max_degree, 64). Lane 0 writes the eid of each step taken; the path is
// written once at the end from shared memory, coalesced, with the eids' pads.
// A block takes kMaxWarps walks, or as many paths (S + 1 int32 each, rounded up
// to 16 bytes) as fit 48 KB of shared memory; one path of the longest walk
// StepSum takes, 32**3 steps, needs 128 KiB.

#include <math.h>

#include "walk_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kMaxWarps = 4;  // walks a block at most, a warp each
constexpr int kModeGreedyOs = 0;
constexpr int kModeMc = 2;
constexpr unsigned kKeyNegInf = 0x007FFFFFu;  // key_order(-inf): every invalid slot

// An order-preserving map of a float32 key to uint32, in torch.argmax order:
// every NaN above +inf (all equal), -0.0 equal to +0.0.
__device__ __forceinline__ unsigned key_order(float k) {
  if (isnan(k)) return 0xFFFFFFFFu;
  const unsigned b = __float_as_uint(k == 0.0f ? 0.0f : k);
  return (b & 0x80000000u) ? ~b : b | 0x80000000u;
}

// int32 words of one warp's path: S + 1, rounded up to 16 bytes
__host__ __device__ inline int path_words(int s_max) { return (s_max + 1 + 3) & ~3; }

// Whether v is one of the S + 1 entries of the warp's visited list (each lane
// tests every 32nd; the answer is the warp's). Used by the paged rows only.
__device__ __forceinline__ bool on_path(const int* visited, int s_max, int v, int lane) {
  bool found = false;
  for (int t = lane; t <= s_max; t += 32) found |= visited[t] == v;
  return __any_sync(kFullMask, found);
}

// kG groups of 32 slots a page, in registers; pages of 32 * kG slots (one
// page for H <= 32 * kG).
template <int kG, bool kMixed>
__global__ void __launch_bounds__(kMaxWarps * 32)
greedy_scan_kernel(const int* __restrict__ wide, int h, long long n_nodes,
                   const int* __restrict__ start, const int* __restrict__ first_edge,
                   const int* __restrict__ mode, const int* __restrict__ uid,
                   const unsigned char* __restrict__ active, unsigned seed, int anchor_lim,
                   int w, int s_max, int* __restrict__ nodes, int* __restrict__ eids,
                   int* __restrict__ steps, unsigned char* __restrict__ success,
                   int* __restrict__ terminal, int* __restrict__ path_len,
                   float* __restrict__ score_sum) {
  extern __shared__ int4 smem4[];  // per warp: the path, visited (S + 1, padded)
  constexpr int kPage = 32 * kG;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long walk = (long long)blockIdx.x * (blockDim.x >> 5) + warp;
  if (walk >= w) return;  // the whole warp
  const int words = path_words(s_max);
  const int4* path4 = smem4 + warp * (words / 4);
  int* visited = reinterpret_cast<int*>(smem4 + warp * (words / 4));
  int* ed = eids + walk * s_max;
  const int first = start[walk];
  for (int t = lane; t < words; t += 32) visited[t] = t == 0 ? first : -1;
  __syncwarp();

  const long long row_stride = 6LL * h;
  const bool paged = h > kPage;
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

    int total = 0, rr = 0;
    if (mc) {  // the draw; an MC walk never needs the greedy choice
      total = __ldg(row + 2 * h - 1);
      const unsigned bits = draw_bits(k0, k1, s);
      rr = (int)((bits & 0x7FFFFFFFu) % (unsigned)max(total, 1));
    }
    unsigned best_key = 0u;  // below every slot's key: lanes without slots keep it
    int best_slot = 0, count = 0;
    bool any_valid = false;
    int nb[kG], ky[kG], ei[kG], ad[kG], es[kG];
    unsigned valid = 0u;  // bit g: slot 32g + lane of the last page
    for (int base = 0; base < h; base += kPage) {
      // one round of loads: nothing below uses a value before all are sent
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        const int j = base + 32 * g + lane;
        const bool in = j < h;
        nb[g] = in ? __ldg(row + j) : -1;
        ky[g] = !in ? 0 : mc ? __ldg(row + h + j) : by_os ? __ldg(row + 5 * h + j) : 0;
        // the picked words too, unless the row is read in pages (a second load)
        ei[g] = !paged && in ? __ldg(row + 2 * h + j) : 0;
        ad[g] = !paged && in ? __ldg(row + 3 * h + j) : 0;
        es[g] = !paged && in ? __ldg(row + 4 * h + j) : 0;
      }
      // the visited test: path[0..s] by broadcast, 16 bytes a read, no early exit
      unsigned seen = 0u;
#pragma unroll 4
      for (int t4 = 0; 4 * t4 <= s; ++t4) {
        const int4 v = path4[t4];
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int x = nb[g];
          seen |= (unsigned)((x == v.x) | (x == v.y) | (x == v.z) | (x == v.w)) << g;
        }
      }
      valid = 0u;
#pragma unroll
      for (int g = 0; g < kG; ++g) valid |= (unsigned)(nb[g] >= 0 && !((seen >> g) & 1u)) << g;
      any_valid |= valid != 0u;
      if (mc) {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          count += __popc(__ballot_sync(kFullMask, base + 32 * g + lane < h && ky[g] <= rr));
        }
      } else {
#pragma unroll
        for (int g = 0; g < kG; ++g) {
          const int j = base + 32 * g + lane;
          const float k = by_os ? __int_as_float(ky[g]) : -(float)j;
          const unsigned key = ((valid >> g) & 1u) ? key_order(k) : kKeyNegInf;
          if (j < h && key > best_key) {  // strictly: the lower group keeps a tie
            best_key = key;
            best_slot = j;
          }
        }
      }
    }

    int choice;
    bool dead;
    if (mc) {
      choice = min(count, h - 1);
      dead = total <= 0;
    } else {
      const unsigned top = __reduce_max_sync(kFullMask, best_key);
      choice = (int)__reduce_min_sync(kFullMask, best_key == top ? (unsigned)best_slot
                                                                  : 0xFFFFFFFFu);
      dead = !__any_sync(kFullMask, any_valid);
    }
    const bool forced = s == 0 && forced_slot >= 0;
    if (forced) choice = forced_slot;
    const bool inside = choice >= 0 && choice < h;

    int nxt, e_id, e_adv, e_es;
    bool ok;  // the chosen slot is valid
    if (!paged) {  // the owner lane's registers, then a shuffle
      const int g_pick = choice >> 5;
      int v0 = 0, v1 = 0, v2 = 0, v3 = 0, v4 = 0;
#pragma unroll
      for (int g = 0; g < kG; ++g) {
        if (g == g_pick) {
          v0 = nb[g];
          v1 = ei[g];
          v2 = ad[g];
          v3 = es[g];
          v4 = (valid >> g) & 1u;
        }
      }
      const int owner = choice & 31;
      nxt = __shfl_sync(kFullMask, v0, owner);
      e_id = __shfl_sync(kFullMask, v1, owner);
      e_adv = __shfl_sync(kFullMask, v2, owner);
      e_es = __shfl_sync(kFullMask, v3, owner);
      ok = __shfl_sync(kFullMask, v4, owner) != 0;
      if (!inside) {
        nxt = e_id = e_adv = e_es = 0;
        ok = false;
      }
    } else {  // lane 0 picks nbr (block 0), lanes 1-3 eid, adv, es (blocks 2, 3, 4)
      int v = 0;
      if (lane < 4 && inside) v = __ldg(row + (long long)(lane == 0 ? 0 : lane + 1) * h + choice);
      nxt = __shfl_sync(kFullMask, v, 0);
      e_id = __shfl_sync(kFullMask, v, 1);
      e_adv = __shfl_sync(kFullMask, v, 2);
      e_es = __shfl_sync(kFullMask, v, 3);
      ok = inside && nxt >= 0 && !on_path(visited, s, nxt, lane);
    }
    if (forced) dead = !(inside && ok);
    if (mc) dead = dead || !ok;

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

template <int kG, bool kMixed>
int launch(const int* wide, int h, long long n_nodes, const int* start, const int* first_edge,
           const int* mode, const int* uid, const unsigned char* active, unsigned seed,
           int anchor_lim, int w, int s_max, int* nodes, int* eids, int* steps,
           unsigned char* success, int* terminal, int* path_len, float* score_sum,
           cudaStream_t stream) {
  const size_t path = (size_t)path_words(s_max) * sizeof(int);
  const size_t fit = kDefaultSmem / path;  // paths in 48 KB
  const int warps = fit >= (size_t)kMaxWarps ? kMaxWarps : fit >= 1 ? (int)fit : 1;
  const size_t smem = warps * path;
  if (smem > kDefaultSmem) {  // one path needs more: opt in, up to the card's limit
    const cudaError_t rc = cudaFuncSetAttribute(
        greedy_scan_kernel<kG, kMixed>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (rc != cudaSuccess) return (int)rc;
  }
  const long long blocks = ((long long)w + warps - 1) / warps;
  greedy_scan_kernel<kG, kMixed><<<(unsigned)blocks, warps * 32, smem, stream>>>(
      wide, h, n_nodes, start, first_edge, mode, uid, active, seed, anchor_lim, w, s_max, nodes,
      eids, steps, success, terminal, path_len, score_sum);
  return (int)cudaGetLastError();
}

template <bool kMixed>
int launch_width(const int* wide, int h, long long n_nodes, const int* start,
                 const int* first_edge, const int* mode, const int* uid,
                 const unsigned char* active, unsigned seed, int anchor_lim, int w, int s_max,
                 int* nodes, int* eids, int* steps, unsigned char* success, int* terminal,
                 int* path_len, float* score_sum, cudaStream_t st) {
#define TELOMERI_GREEDY_LAUNCH(G)                                                             \
  launch<G, kMixed>(wide, h, n_nodes, start, first_edge, mode, uid, active, seed, anchor_lim, \
                    w, s_max, nodes, eids, steps, success, terminal, path_len, score_sum, st)
  if (h <= 64) return TELOMERI_GREEDY_LAUNCH(2);
  if (h <= 128) return TELOMERI_GREEDY_LAUNCH(4);
  if (h <= 256) return TELOMERI_GREEDY_LAUNCH(8);
  return TELOMERI_GREEDY_LAUNCH(16);  // pages of 512 slots above 512
#undef TELOMERI_GREEDY_LAUNCH
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
    return launch_width<true>(wide, h, n_nodes, start, first_edge, mode, uid, active, seed,
                              anchor_lim, w, s_max, nodes, eids, steps, success, terminal,
                              path_len, score_sum, st);
  }
  return launch_width<false>(wide, h, n_nodes, start, first_edge, mode, uid, active, seed,
                             anchor_lim, w, s_max, nodes, eids, steps, success, terminal,
                             path_len, score_sum, st);
}

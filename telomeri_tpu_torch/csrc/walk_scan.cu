// All-Monte-Carlo walk scan for Hopper (sm_90a), with the Threefry draw fused in.
//
// Replaces the Pallas TPU kernel telomeri_tpu/kernels/walk_vmem.py::_walk_kernel
// (driven by _vmem_scan / run_walks_mc_vmem), itself the twin of the lax.scan in
// telomeri_tpu/walk/engine.py::_mc_fast_core, together with the draw table that
// feeds both (_stable_bits_table). Records are bit-equal to all of them.
//
// Inputs: the packed table wide (N, 6H) int32, [nbr | cum | eid | adv | es_bits |
// os_bits], each block H wide, and its pick plane picks (N, H, 8) int32: entry
// [v, j] = {nbr, eid, adv, es_bits} of slot j of node v, pads included, then
// {total, span} of the row u the pick leads to (u = nbr, or v at a pad), then two
// zero words (kernels/walk_table.py pick_plane and row_header, built once per
// table). total = cum_u[H-1]; span = 1 + max{j : cum_u[j] < total}, 0 if none,
// and H where total <= 0.
// Per walk, once: (k0, k1) = threefry2x32(key (0, seed), counters (0, uid)), which
// is jax.random.fold_in(key(seed), uid) with the uid as its uint32 bit pattern.
// Per walk and step s (the walk's node is `cur`):
//   1. bits   = word s % 2 of threefry2x32(key (k0, k1), counters (2b, 2b + 1)),
//               b = s / 2: one block serves two steps, and an odd S leaves the
//               last block's second word unused;
//   2. total  = cum[H-1] of row `cur`: read from wide at step 0, from the header
//               of the entry the step before picked at every later step;
//   3. r      = (bits & 0x7FFFFFFF) % max(total, 1);
//   4. choice = min(#{j : cum[j] <= r}, H-1), counted over the words j < span
//               (span = H at step 0): a word at j >= span is >= total > r;
//   5. read picks[cur, choice] and record nbr, total, eid, adv, es_bits;
//   6. cur = nbr if it is >= 0; total and span are the entry's header.
// A dead row (total <= 0, span H) gives r = 0, every cum entry <= 0, choice =
// H-1: a pad slot, nxt = -1, and the walk stays put. Events (dead row, revisit,
// anchor hit) are resolved afterwards from the records (csrc/walk_events.cu on a
// card, through telomeri_tpu_torch/walk/engine.py::resolve_mc_events). The
// Threefry arithmetic is csrc/walk_common.cuh's.
//
// Bound: bytes. Nothing here multiplies matrices, and no tile's address is known
// before the step that reads it (the next row is the value just picked), so there
// is no work for wgmma or TMA. A walk is S steps in sequence, each two dependent
// memory round trips: the cum block, then the pick, whose address is the count
// just computed. On a table far larger than the L2 (the 9.66 GB human-scale one)
// about 33,800 walks are in flight, each step takes two round trips of about
// 4.5 us against 0.35 us for an unloaded one: the memory system is saturated,
// and what each step asks of it is the cost. A step reads:
//   - the words of the cum block below the row's span, in 16-byte chunks: at
//     H = 64 and a span of d words, ceil(d / 16) lines, ceil(d / 8) sectors and
//     ceil(d / 16) of the HBM's 64-byte atoms, where the whole 256-byte block is
//     2 lines, 8 sectors and 4 atoms. On the human-scale table (degrees uniform on
//     4..64, every weight >= 100, so span = degree - 1) that is 1.51 lines, 4.56
//     sectors and 2.52 atoms on average;
//   - the pick, one 32-byte entry of the plane: 1 sector, 1 atom. Its header
//     rides in the sector the pick loads anyway, so knowing the span costs no
//     round trip.
// So at H = 64 a step touches about 2.5 lines and 3.5 atoms, where the whole
// block made it 3 lines and 5 atoms, and the wide row's pick (before the plane)
// 6 lines and 8 atoms. The design:
//   - a sub-warp of LANES lanes per walk (32 / LANES walks a warp), each lane
//     loading 16 bytes: with 16 lanes a 64-entry cum block is ONE request, and
//     twice as many walks are resident as with a warp per walk. With 8 lanes it
//     is two requests issued back to back and four times the walks: on an H100
//     that measured 17% faster at H = 64 (49,152 and 2**20 walks x 32 steps),
//     and 4 lanes slower again, so H = 64 runs 8 lanes and wider rows 16
//     (16 against 8 was not timed there);
//   - a lane loads its chunk only when the chunk's first word lies below the
//     span, and an unloaded chunk counts nothing; each lane counts its own
//     entries <= r and a butterfly of __shfl_xor_sync sums the sub-warp; the draw
//     is computed in registers (20 rounds of 32-bit add / rotate / xor), so no
//     (S, W) bits table is written or read; `total` is known before the cum load,
//     so r is too;
//   - lanes 0-5 of the sub-warp load word `sub` of picks[cur, choice]: one
//     instruction on one sector; nbr and the header come to the other lanes by
//     __shfl_sync. Offsets into both inputs are 64-bit: at the human-scale
//     table's 6.29M rows the plane is 3.22 G words at H = 64;
//   - lanes 0-3 keep their picked word, and lane 4 the step's total, for four
//     steps in registers, and each stores 16 contiguous bytes of its record
//     plane, so a 32-byte sector of the output is written by two stores instead
//     of eight. With S % 4 != 0 the rows of a plane are not 16-byte aligned and
//     the stores are scalar.
// The row's os_bits block is never read, nor the nbr / eid / adv / es_bits blocks
// of wide (the plane holds them). Registers (ptxas -v, sm_90a, CUDA 12.8, this
// file), under __launch_bounds__(256, 8) where a lane holds two 16-byte loads of
// cum and (256, 6) where it holds four: <8, 2>, <16, 2> and the generic <16, 0>
// 32 a thread, <16, 4> 40, none spills (lane 4 records the total from the header,
// so no lane keeps four steps' totals beside its picked words). So H = 64 (8
// lanes, two loads) and H = 128 (16 lanes, two loads) keep the SM's full 2048
// threads resident, 256 and 128 walks an SM, and H = 256 1536 threads, 96 walks.

#include "walk_common.cuh"

namespace {

constexpr unsigned kFullMask = 0xffffffffu;
constexpr int kThreads = 256;
constexpr int kEntry = 8;        // words of a pick-plane entry
constexpr int kLoaders = 6;      // lanes that load an entry's nbr, eid, adv, es, total, span
constexpr int kNever = 0x7fffffff;   // r < total <= INT_MAX: a word that never counts

__device__ __forceinline__ int count_le(const int4& c, int r) {
  return (c.x <= r) + (c.y <= r) + (c.z <= r) + (c.w <= r);
}

// LANES lanes per walk; CH = H / (4 * LANES) 16-byte loads per lane cover the
// whole cum block in registers. CH == 0: any H % (4 * LANES) == 0, the block read
// in a loop.
template <int LANES, int CH>
__global__ void __launch_bounds__(kThreads, CH <= 2 ? 8 : 6)
walk_scan_kernel(const int* __restrict__ wide, const int* __restrict__ picks, int h,
                 const int* __restrict__ start, const int* __restrict__ uid, unsigned seed,
                 int w, int s_max,
                 int* __restrict__ out) {  // (5, W, S): nxt, total, eid, adv, es
  static_assert(LANES >= kLoaders, "a sub-warp loads a whole pick entry's header");
  const long long tid = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long walk_raw = tid / LANES;
  const bool live = walk_raw < w;  // a dead sub-warp still takes part in the shuffles
  const int walk = live ? (int)walk_raw : w - 1;
  const int lane = threadIdx.x & 31;
  const int sub = lane % LANES;           // lane within the walk's sub-warp
  const int shift = lane - sub;           // first lane of the sub-warp
  const long long row_stride = 6LL * h;
  const long long plane = (long long)w * s_max;
  // lanes 0..3 record word `sub` of the entry (nbr, eid, adv, es: planes 0, 2, 3,
  // 4) and lane 4 the step's total (plane 1); lanes 4 and 5 load the header
  const int field = sub == 0 ? 0 : sub == 4 ? 1 : sub + 1;
  const bool loader = sub < kLoaders;
  const bool writer = sub < 5;
  const bool vec = (s_max & 3) == 0;

  unsigned k0 = 0u, k1 = (unsigned)uid[walk];
  threefry2x32(0u, seed, k0, k1);  // fold_in: key (0, seed) over counters (0, uid)

  int cur = start[walk];
  // step 0 reads its row's total from wide and the whole block; each later step
  // has both from the header of the entry the step before it picked
  int total = __ldg(wide + (long long)cur * row_stride + 2 * h - 1);
  int span = h;
  for (int s0 = 0; s0 < s_max; s0 += 4) {
    int rec[4];
    unsigned y0 = 0u, y1 = 0u;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = s0 + i;
      if (s < s_max) {  // uniform over the grid
        if ((i & 1) == 0) {
          y0 = (unsigned)s;  // counters (2b, 2b + 1) with 2b = s
          y1 = (unsigned)s + 1u;
          threefry2x32(k0, k1, y0, y1);
        }
        const unsigned b = (i & 1) ? y1 : y0;
        const int r = (int)((b & 0x7FFFFFFFu) % (unsigned)max(total, 1));
        const int4* cum4 = reinterpret_cast<const int4*>(wide + (long long)cur * row_stride + h);
        int count = 0;
        if constexpr (CH > 0) {
          int4 c[CH];
#pragma unroll
          for (int j = 0; j < CH; ++j) {
            const int q = j * LANES + sub;   // the chunk of words 4q .. 4q + 3
            c[j] = make_int4(kNever, kNever, kNever, kNever);
            if (4 * q < span) c[j] = __ldg(cum4 + q);
          }
#pragma unroll
          for (int j = 0; j < CH; ++j) count += count_le(c[j], r);
        } else {
          for (int q = sub; 4 * q < span; q += LANES) count += count_le(__ldg(cum4 + q), r);
        }
        // sum the sub-warp's lane counts
#pragma unroll
        for (int d = LANES / 2; d > 0; d >>= 1) count += __shfl_xor_sync(kFullMask, count, d);
        const int choice = min(count, h - 1);
        int v = 0;
        if (loader) v = __ldg(picks + (((long long)cur * h + choice) * kEntry) + sub);
        const int nxt = __shfl_sync(kFullMask, v, shift);
        const int next_total = __shfl_sync(kFullMask, v, shift + 4);
        const int next_span = __shfl_sync(kFullMask, v, shift + 5);
        rec[i] = sub == 4 ? total : v;
        cur = nxt >= 0 ? nxt : cur;
        total = next_total;
        span = next_span;
      } else {
        rec[i] = 0;
      }
    }
    if (live && writer) {
      const long long o = (long long)walk * s_max + s0;
      int* dst = out + field * plane + o;
      if (vec) {  // s0 + 3 < s_max, and o * 4 bytes is 16-byte aligned
        *reinterpret_cast<int4*>(dst) = make_int4(rec[0], rec[1], rec[2], rec[3]);
      } else {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if (s0 + i < s_max) dst[i] = rec[i];
        }
      }
    }
  }
}

template <int LANES, int CH>
int launch(const int* wide, const int* picks, int h, const int* start, const int* uid,
           unsigned seed, int w, int s_max, int* out, cudaStream_t stream) {
  const long long blocks = ((long long)w * LANES + kThreads - 1) / kThreads;
  walk_scan_kernel<LANES, CH><<<(unsigned)blocks, kThreads, 0, stream>>>(
      wide, picks, h, start, uid, seed, w, s_max, out);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError() so the
// caller can raise on a refused launch. Requires h % 64 == 0.
extern "C" int telomeri_walk_scan(const int* wide, const int* picks, int h, const int* start,
                                  const int* uid, unsigned seed, int w, int s_max, int* out,
                                  void* stream) {
  if (w <= 0 || s_max <= 0) return (int)cudaSuccess;
  if (h <= 0 || h % 64 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (h == 64) return launch<8, 2>(wide, picks, h, start, uid, seed, w, s_max, out, st);
  if (h == 128) return launch<16, 2>(wide, picks, h, start, uid, seed, w, s_max, out, st);
  if (h == 256) return launch<16, 4>(wide, picks, h, start, uid, seed, w, s_max, out, st);
  return launch<16, 0>(wide, picks, h, start, uid, seed, w, s_max, out, st);
}

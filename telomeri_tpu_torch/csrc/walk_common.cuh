// Device functions shared by the walk kernels (walk_scan.cu, greedy_scan.cu,
// walk_events.cu): the Threefry-2x32 draw of jax.random and the float32 step
// sum in the order XLA's CPU backend reduces a (W, S) row.
//
// Everything here is header-only and inline, inside an anonymous namespace, so
// each .cu file that includes it gets its own copy and the library links
// without duplicate symbols.

#pragma once

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ unsigned rotl32(unsigned x, int r) {
  return __funnelshift_l(x, x, r);
}

// Threefry-2x32, 20 rounds, as jax.random's threefry_2x32: key (k0, k1),
// counters (x0, x1) in, two words out (in place).
__device__ __forceinline__ void threefry2x32(unsigned k0, unsigned k1, unsigned& x0,
                                             unsigned& x1) {
  const unsigned ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x0 += x1;
      x1 = rotl32(x1, rot[i % 2][j]) ^ x0;
    }
    x0 += ks[(i + 1) % 3];
    x1 += ks[(i + 2) % 3] + (unsigned)(i + 1);
  }
}

// jax.random.fold_in(key(seed), uid): key (0, seed) over counters (0, uid),
// the uid taken as its uint32 bit pattern. The walk's key is (k0, k1).
__device__ __forceinline__ void fold_in(unsigned seed, int uid, unsigned& k0, unsigned& k1) {
  k0 = 0u;
  k1 = (unsigned)uid;
  threefry2x32(0u, seed, k0, k1);
}

// The draw of step s under the walk's key: word s % 2 of the block with the
// counters (2b, 2b + 1), b = s / 2 (walk/engine.py stable_bits_table).
__device__ __forceinline__ unsigned draw_bits(unsigned k0, unsigned k1, int s) {
  unsigned y0 = (unsigned)(s & ~1), y1 = (unsigned)(s & ~1) + 1u;
  threefry2x32(k0, k1, y0, y1);
  return (s & 1) ? y1 : y0;
}

// The float32 sum of one walk's S step values in the order of XLA CPU's row
// reduce (walk/engine.py _sum_steps), fed one value a step, in step order:
//   - S <= 32: one sequential sum from +0.0;
//   - S > 32: the steps zero-padded to a multiple of 32, pad / 2 zeros in
//     front and the rest behind; each 32-wide window summed sequentially from
//     +0.0; the window sums reduced by the same rule (a level up).
// A padding zero is never added: +0.0 added to an accumulator that started at
// +0.0 changes nothing under round-to-nearest (no such sum is ever -0.0), so
// only where the windows end matters. Every add is __fadd_rn (and the library
// builds with -fmad=false). Three levels: S <= kMaxSteps = 32**3, which the
// kernels' entry points and kernels/walk_common.py MAX_STEPS hold to.
constexpr int kMaxSteps = 32 * 32 * 32;

// A block's shared memory without opting in to more. The greedy scan and the
// event resolution fit as many walks a block into it as they can (their
// largest block at S = 32) and opt in only where one walk needs more.
constexpr size_t kDefaultSmem = 48 * 1024;

// Three levels, kept in named scalars (no arrays), so the sum stays in
// registers: an array of levels indexed in an unrolled loop with an early
// return was placed on the stack, a local-memory round trip a step.
struct StepSum {
  float acc0, acc1, acc2;
  int pushed0, pushed1;  // values added to levels 0 and 1 so far
  int front0, front1;    // zeros padded in front of their values
  int count0, count1;    // values they receive
  int top;               // the level summed sequentially to the end

  __device__ __forceinline__ explicit StepSum(int s) {
    acc0 = acc1 = acc2 = 0.0f;
    pushed0 = pushed1 = 0;
    const int w0 = (s + 31) / 32;    // level 0's windows: level 1's values
    const int w1 = (w0 + 31) / 32;   // level 1's windows: level 2's values
    count0 = s;
    count1 = w0;
    front0 = s > 32 ? (w0 * 32 - s) / 2 : 0;
    front1 = w0 > 32 ? (w1 * 32 - w0) / 2 : 0;
    top = s <= 32 ? 0 : w0 <= 32 ? 1 : 2;
  }

  // Adds the next step's value (+0.0 for a step not taken).
  __device__ __forceinline__ void add(float v) {
    acc0 = __fadd_rn(acc0, v);
    if (top == 0) return;
    int pos = pushed0 + front0;  // place in level 0's padded row
    ++pushed0;
    if ((pos & 31) != 31 && pushed0 != count0) return;  // the window goes on
    acc1 = __fadd_rn(acc1, acc0);  // the window is whole: its sum goes up a level
    acc0 = 0.0f;
    if (top == 1) return;
    pos = pushed1 + front1;
    ++pushed1;
    if ((pos & 31) != 31 && pushed1 != count1) return;
    acc2 = __fadd_rn(acc2, acc1);
    acc1 = 0.0f;
  }

  __device__ __forceinline__ float result() const {
    return top == 0 ? acc0 : top == 1 ? acc1 : acc2;
  }
};

}  // namespace

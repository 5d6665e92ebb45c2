// Overlap-extension scoring (SI / OS / ES1 / ES2) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernels telomeri_tpu/kernels/scoring.py::_score_kernel
// (4 outputs) and ::_score_kernel_os_es2 (2 outputs, the production rescore path),
// both driven by score_overlaps_pallas_tiled. One template, OUTPUTS = 4 or 2.
//
// What it computes, per row, in float32 and in exactly this order (the numpy
// oracle score_arrays_np is the contract, bit for bit):
//   SI  = nm / max(bl, 1)
//   OS  = SI * ((ol1 + ol2) * 0.5)
//   pen = (oh1 + oh2) * 0.5
//   ES1 = (OS + el1 * 0.5) - pen
//   ES2 = (OS + el2 * 0.5) - pen
// Every int -> float conversion and every operation rounds to nearest even, and
// nothing is contracted into an FMA (the explicit __f*_rn intrinsics below, and
// the library is built with -fmad=false besides); a fused multiply-add would skip
// the rounding of el * 0.5 and change the last bit of ES.
//
// Bound: device memory bandwidth. With OUTPUTS = 4 a row reads 8 int32 and
// writes 4 float32: 48 B/row. With OUTPUTS = 2 nothing depends on el1, which is
// not loaded: 7 int32 read and 2 float32 written, 36 B/row. Against ~12
// operations a row; each byte is touched once, so shared memory, cp.async and
// TMA have nothing to stage. At the main path's shape (552,256 rows, 20 MB)
// the whole pass is a few microseconds, so what counts is how many bytes are in
// flight per thread from its first instruction; at 2**26 rows, how few
// instructions and memory transactions a byte costs.
//
// The design, two kernels behind one launcher:
//   score_kernel_vec     each thread takes 4 consecutive rows: seven or eight
//                        16-byte loads through the read-only path (__ldg on
//                        const int4*), all issued before the first use, then two
//                        or four 16-byte stores. A warp moves 512 B per array and
//                        instruction. The n % 4 last rows are scored one each by
//                        the threads just past the last full group of four, in
//                        the same launch. 256 threads a block, one thread per
//                        group: 540 blocks at the main path's shape, one wave on
//                        132 SMs.
//   score_kernel_scalar  one row a thread, 4-byte loads and stores: for arrays
//                        that are not all 16-byte aligned (a contiguous view such
//                        as a[1:]). The launcher tests the twelve pointers and
//                        picks; both are this file's kernels, on the card.
// Tried on an H100 and not kept (PERF.md has the times): streaming hints
// (__ldcs / __stcs) were 4% slower at 2**26 rows and twice as slow where the
// arrays sit in the L2; a grid-stride loop of 8 or 16 blocks a SM was 3% slower
// at 2**26 rows; 128-thread blocks were within the spread of 256.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

// One row; si / es1 are dead code (and el1 is unused) when OUTPUTS == 2.
template <int OUTPUTS>
__device__ __forceinline__ void score_row(int nm, int bl, int ol1, int ol2, int oh1, int oh2,
                                          int el1, int el2, float& si, float& os,
                                          float& es1, float& es2) {
  si = __fdiv_rn(__int2float_rn(nm), fmaxf(__int2float_rn(bl), 1.0f));
  os = __fmul_rn(si, __fmul_rn(__fadd_rn(__int2float_rn(ol1), __int2float_rn(ol2)), 0.5f));
  const float pen = __fmul_rn(__fadd_rn(__int2float_rn(oh1), __int2float_rn(oh2)), 0.5f);
  es2 = __fsub_rn(__fadd_rn(os, __fmul_rn(__int2float_rn(el2), 0.5f)), pen);
  if (OUTPUTS == 4) es1 = __fsub_rn(__fadd_rn(os, __fmul_rn(__int2float_rn(el1), 0.5f)), pen);
}

template <int OUTPUTS>
__device__ __forceinline__ void score_one(const int* nm, const int* bl, const int* ol1,
                                          const int* ol2, const int* oh1, const int* oh2,
                                          const int* el1, const int* el2, float* si_o,
                                          float* os_o, float* es1_o, float* es2_o,
                                          long long i) {
  float si, os, es1, es2;
  score_row<OUTPUTS>(nm[i], bl[i], ol1[i], ol2[i], oh1[i], oh2[i],
                     OUTPUTS == 4 ? el1[i] : 0, el2[i], si, os, es1, es2);
  os_o[i] = os;
  es2_o[i] = es2;
  if (OUTPUTS == 4) {
    si_o[i] = si;
    es1_o[i] = es1;
  }
}

template <int OUTPUTS>
__global__ void __launch_bounds__(kThreads)
score_kernel_scalar(const int* __restrict__ nm, const int* __restrict__ bl,
                    const int* __restrict__ ol1, const int* __restrict__ ol2,
                    const int* __restrict__ oh1, const int* __restrict__ oh2,
                    const int* __restrict__ el1, const int* __restrict__ el2,
                    float* __restrict__ si_o, float* __restrict__ os_o,
                    float* __restrict__ es1_o, float* __restrict__ es2_o, long long n) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i < n) score_one<OUTPUTS>(nm, bl, ol1, ol2, oh1, oh2, el1, el2, si_o, os_o, es1_o, es2_o, i);
}

// Threads [0, n / 4) score rows 4t .. 4t + 3; threads [n / 4, n / 4 + n % 4)
// score the last n % 4 rows, one each. All pointers 16-byte aligned.
template <int OUTPUTS>
__global__ void __launch_bounds__(kThreads)
score_kernel_vec(const int* __restrict__ nm, const int* __restrict__ bl,
                 const int* __restrict__ ol1, const int* __restrict__ ol2,
                 const int* __restrict__ oh1, const int* __restrict__ oh2,
                 const int* __restrict__ el1, const int* __restrict__ el2,
                 float* __restrict__ si_o, float* __restrict__ os_o,
                 float* __restrict__ es1_o, float* __restrict__ es2_o, long long n) {
  const long long t = (long long)blockIdx.x * kThreads + threadIdx.x;
  const long long groups = n >> 2;
  if (t >= groups) {
    const long long i = 4 * groups + (t - groups);
    if (i < n) score_one<OUTPUTS>(nm, bl, ol1, ol2, oh1, oh2, el1, el2, si_o, os_o, es1_o, es2_o, i);
    return;
  }
  const int4 a_nm = __ldg(reinterpret_cast<const int4*>(nm) + t);
  const int4 a_bl = __ldg(reinterpret_cast<const int4*>(bl) + t);
  const int4 a_ol1 = __ldg(reinterpret_cast<const int4*>(ol1) + t);
  const int4 a_ol2 = __ldg(reinterpret_cast<const int4*>(ol2) + t);
  const int4 a_oh1 = __ldg(reinterpret_cast<const int4*>(oh1) + t);
  const int4 a_oh2 = __ldg(reinterpret_cast<const int4*>(oh2) + t);
  const int4 a_el2 = __ldg(reinterpret_cast<const int4*>(el2) + t);
  int4 a_el1 = make_int4(0, 0, 0, 0);
  if (OUTPUTS == 4) a_el1 = __ldg(reinterpret_cast<const int4*>(el1) + t);
  float4 si, os, es1, es2;
  score_row<OUTPUTS>(a_nm.x, a_bl.x, a_ol1.x, a_ol2.x, a_oh1.x, a_oh2.x, a_el1.x, a_el2.x,
                     si.x, os.x, es1.x, es2.x);
  score_row<OUTPUTS>(a_nm.y, a_bl.y, a_ol1.y, a_ol2.y, a_oh1.y, a_oh2.y, a_el1.y, a_el2.y,
                     si.y, os.y, es1.y, es2.y);
  score_row<OUTPUTS>(a_nm.z, a_bl.z, a_ol1.z, a_ol2.z, a_oh1.z, a_oh2.z, a_el1.z, a_el2.z,
                     si.z, os.z, es1.z, es2.z);
  score_row<OUTPUTS>(a_nm.w, a_bl.w, a_ol1.w, a_ol2.w, a_oh1.w, a_oh2.w, a_el1.w, a_el2.w,
                     si.w, os.w, es1.w, es2.w);
  reinterpret_cast<float4*>(os_o)[t] = os;
  reinterpret_cast<float4*>(es2_o)[t] = es2;
  if (OUTPUTS == 4) {
    reinterpret_cast<float4*>(si_o)[t] = si;
    reinterpret_cast<float4*>(es1_o)[t] = es1;
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError() so the
// caller can raise on a refused launch. si_o / es1_o are ignored when outputs == 2.
// The 16-byte kernel runs when all twelve pointers are 16-byte aligned (null
// counts as aligned), else the 4-byte one.
extern "C" int telomeri_score_overlaps(const int* nm, const int* bl, const int* ol1,
                                       const int* ol2, const int* oh1, const int* oh2,
                                       const int* el1, const int* el2, float* si_o,
                                       float* os_o, float* es1_o, float* es2_o,
                                       long long n, int outputs, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (outputs != 2 && outputs != 4) return (int)cudaErrorInvalidValue;
  const void* ptrs[12] = {nm, bl, ol1, ol2, oh1, oh2, el1, el2, si_o, os_o, es1_o, es2_o};
  uintptr_t low = 0;
  for (const void* p : ptrs) low |= reinterpret_cast<uintptr_t>(p);
  const bool vec = (low & 15) == 0;
  const long long threads = vec ? (n >> 2) + (n & 3) : n;
  const long long blocks = (threads + kThreads - 1) / kThreads;
  if (blocks > 0x7FFFFFFFLL) return (int)cudaErrorInvalidValue;   // above 2**39 rows
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define TELOMERI_SCORE_LAUNCH(KERNEL, OUTPUTS)                         \
  KERNEL<OUTPUTS><<<(unsigned)blocks, kThreads, 0, s>>>(               \
      nm, bl, ol1, ol2, oh1, oh2, el1, el2, si_o, os_o, es1_o, es2_o, n)
  if (vec && outputs == 4) TELOMERI_SCORE_LAUNCH(score_kernel_vec, 4);
  else if (vec) TELOMERI_SCORE_LAUNCH(score_kernel_vec, 2);
  else if (outputs == 4) TELOMERI_SCORE_LAUNCH(score_kernel_scalar, 4);
  else TELOMERI_SCORE_LAUNCH(score_kernel_scalar, 2);
#undef TELOMERI_SCORE_LAUNCH
  return (int)cudaGetLastError();
}

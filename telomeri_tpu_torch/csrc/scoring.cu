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
// Bound: device memory bandwidth. Each row reads 8 int32 (32 B) and writes 2 or
// 4 float32: 40 B/row (OUTPUTS = 2) or 48 B/row (OUTPUTS = 4), against ~15 flops.
// The design is the plain one for that: 1-D arrays (the TPU's (rows, 128) tiling
// does not carry over), one thread per row in a grid-stride loop, coalesced
// 4-byte loads and stores.

#include <cuda_runtime.h>

namespace {

template <int OUTPUTS>
__global__ void score_kernel(const int* __restrict__ nm, const int* __restrict__ bl,
                             const int* __restrict__ ol1, const int* __restrict__ ol2,
                             const int* __restrict__ oh1, const int* __restrict__ oh2,
                             const int* __restrict__ el1, const int* __restrict__ el2,
                             float* __restrict__ si_o, float* __restrict__ os_o,
                             float* __restrict__ es1_o, float* __restrict__ es2_o,
                             long long n) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const float f_nm = __int2float_rn(nm[i]);
    const float f_bl = __int2float_rn(bl[i]);
    const float si = __fdiv_rn(f_nm, fmaxf(f_bl, 1.0f));
    const float os = __fmul_rn(
        si, __fmul_rn(__fadd_rn(__int2float_rn(ol1[i]), __int2float_rn(ol2[i])), 0.5f));
    const float pen =
        __fmul_rn(__fadd_rn(__int2float_rn(oh1[i]), __int2float_rn(oh2[i])), 0.5f);
    const float es2 =
        __fsub_rn(__fadd_rn(os, __fmul_rn(__int2float_rn(el2[i]), 0.5f)), pen);
    os_o[i] = os;
    es2_o[i] = es2;
    if (OUTPUTS == 4) {
      si_o[i] = si;
      es1_o[i] = __fsub_rn(__fadd_rn(os, __fmul_rn(__int2float_rn(el1[i]), 0.5f)), pen);
    }
  }
}

}  // namespace

// Launches on `stream` without synchronising; returns cudaGetLastError() so the
// caller can raise on a refused launch. si_o / es1_o are ignored when outputs == 2.
extern "C" int telomeri_score_overlaps(const int* nm, const int* bl, const int* ol1,
                                       const int* ol2, const int* oh1, const int* oh2,
                                       const int* el1, const int* el2, float* si_o,
                                       float* os_o, float* es1_o, float* es2_o,
                                       long long n, int outputs, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (outputs != 2 && outputs != 4) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  long long blocks = (n + threads - 1) / threads;
  if (blocks > (1LL << 20)) blocks = 1LL << 20;  // grid-stride beyond ~268M rows
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (outputs == 4) {
    score_kernel<4><<<(unsigned)blocks, threads, 0, s>>>(
        nm, bl, ol1, ol2, oh1, oh2, el1, el2, si_o, os_o, es1_o, es2_o, n);
  } else {
    score_kernel<2><<<(unsigned)blocks, threads, 0, s>>>(
        nm, bl, ol1, ol2, oh1, oh2, el1, el2, si_o, os_o, es1_o, es2_o, n);
  }
  return (int)cudaGetLastError();
}

// Displacement log-sum-exp device code shared by the comparison kernels:
// compare_fused.cu (K1) and compare_batched.cu (K4).
//
//   v   = a_coef · log1p(a_u·cc − b_u·cc²)
//   out = (max v, Σ exp(v − max), first-occurrence flat argmax, cc there)
//
// log1pf/expf are libdevice (no fast-math intrinsics: a_coef ≈ −N²/2
// amplifies any error in log1p).
//
// Also the body variants both kernels take as a template parameter: the
// production instances are kFull, and K1's kernel in its kCcOut body is
// the cc-lattice kernel K3; the others exist only for the ablation probe P3
// (ops/probe_cuda.py) and write a checksum in place of a result.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace bioem_lse {

// kNoLse: the cc lattice without the log-sum-exp; kMmOnly: stage 1 alone,
// fed from operands formed once (no conv product, fold or TF32 split);
// kNoGemm: everything but the tensor-core GEMM; kCcOut (K1 only): the cc
// lattice written out in place of the log-sum-exp.
enum Body : int { kFull = 0, kNoLse = 1, kMmOnly = 2, kNoGemm = 3, kCcOut = 4 };

// (v, q) ranks above (best, bidx): the larger value wins, NaN counts as
// the largest (as jnp.max/argmax treat it), and ties go to the lower flat
// index — the reference sweep's first-occurrence rule.
__device__ __forceinline__ bool better(float v, int q, float best, int bidx) {
  const bool vn = isnan(v), bn = isnan(best);
  if (vn || bn) return vn && (!bn || q < bidx);
  return v > best || (v == best && q < bidx);
}

// One lattice point's log-posterior term.
__device__ __forceinline__ float lattice_value(float cc, float au, float bu, float a_coef) {
  const float u = au * cc - bu * cc * cc;
  return a_coef * log1pf(u);
}

// Warp reduction of (value, flat index) pairs under `better`: lane 0 ends
// with the warp's best pair. Every lane of the warp must take part.
__device__ __forceinline__ void warp_argmax(float& best, int& bidx) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bidx, off);
    if (better(ov, oi, best, bidx)) {
      best = ov;
      bidx = oi;
    }
  }
}

// Warp sum: lane 0 ends with the total.
__device__ __forceinline__ float warp_sum(float s) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s += __shfl_down_sync(0xffffffffu, s, off);
  return s;
}

}  // namespace bioem_lse

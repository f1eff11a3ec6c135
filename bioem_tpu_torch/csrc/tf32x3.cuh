// 3xTF32 on the tensor cores with `wmma`: the f32-accurate product step of
// the product precision probe (probe.cu, P1). The image-batched comparison
// kernel (compare_batched.cu, K4) runs the same scheme on `wgmma`: the
// same split, the same three products per k-step in a zeroed accumulator,
// the same IEEE add.
//
// Each operand is split x = hi + lo with hi = tf32(x), lo = tf32(x − hi).
// One k-step forms lo·hi + hi·lo + hi·hi (the dropped lo·lo term is
// ~2⁻²² relative) in a zeroed fragment and adds it to the running sum with
// IEEE f32 adds: chaining every k-step through one accumulator loses ~5×
// accuracy to the tensor cores' truncating accumulation (H100, production
// block: cc at the argmax 5.4e-6 vs 7.2e-7 relative to the plain version).

#pragma once

#include <mma.h>

namespace bioem_tf32x3 {

// hi holds x on entry; on exit hi = tf32(x) and lo = tf32(x − hi).
template <class Frag>
__device__ __forceinline__ void split(Frag& hi, Frag& lo) {
#pragma unroll
  for (int t = 0; t < hi.num_elements; ++t) {
    const float x = hi.x[t];
    const float h = nvcuda::wmma::__float_to_tf32(x);
    hi.x[t] = h;
    lo.x[t] = nvcuda::wmma::__float_to_tf32(x - h);
  }
}

// acc += a·b for one 8-deep k-step, in 3xTF32; step is scratch.
template <class Acc, class FragA, class FragB>
__device__ __forceinline__ void mma_step(Acc& acc, Acc& step, const FragA& a_hi,
                                         const FragA& a_lo, const FragB& b_hi,
                                         const FragB& b_lo) {
  nvcuda::wmma::fill_fragment(step, 0.f);
  nvcuda::wmma::mma_sync(step, a_lo, b_hi, step);
  nvcuda::wmma::mma_sync(step, a_hi, b_lo, step);
  nvcuda::wmma::mma_sync(step, a_hi, b_hi, step);
#pragma unroll
  for (int t = 0; t < step.num_elements; ++t) acc.x[t] += step.x[t];
}

}  // namespace bioem_tf32x3

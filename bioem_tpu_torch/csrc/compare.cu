// Fused comparison kernel: conv ⊙ image → displacement-lattice DFT →
// a·log1p(u) → displacement log-sum-exp, for Hopper (sm_90a).
//
// Replaces bioem_tpu/ops/compare_pallas.py:_fused_block_kernel (with
// _vector_lse and the _cc_tile_* bodies, entry fused_compare_block) and, in
// its cc-out mode, _fused_cc_kernel (entry fused_displacement_cc).
//
// Per (orientation·ctf oc, image i):
//   conv   = proj[o] ⊙ conj(ctf[c])                 (N, F) complex
//   p      = conv ⊙ img[i], rows folded by n_fold    (M = N/n_fold, F)
//   t1     = wx · p                                  (D, F) complex
//   cc     = Re(t1 · wyᵀ)                            (D, D)
//   v      = a_coef · log1p(a_u·cc − b_u·cc²)
//   out    = (max v, Σ exp(v − max), first-occurrence flat argmax d·D+e,
//             cc at the argmax)
// The cc-out mode takes a precomputed conv bank (OC, N, F), writes the
// (D, D) cc lattice and skips the log-sum-exp.
//
// What bounds it on the card: the useful work is 8·D·M·F + 4·D²·F f32 FMA
// operations per comparison (≈2.3 MFLOP at N=224, D=21, M=112), while the
// inputs (proj, ctf, image spectra: a few MB per orientation block) sit in
// the 50 MB L2. Stage 1 is the bulk of the arithmetic, so the kernel is
// bound by f32 FMA issue and by the shared-memory reads that feed it.
// Design: one block per (oc, i); each thread owns one column f of the
// cross-spectrum, forms p on the fly from coalesced global loads (conv is
// never written to device memory) and keeps DC lattice rows of t1 in
// registers while the wx weights are broadcast from shared memory as
// float4 pairs. t1 and the lattice stay in shared memory. Plain f32 FMA,
// no tensor cores (compare_batched.cu is the tensor-core variant, K4);
// the log-sum-exp is compare_lse.cuh, shared with K4. The body variant V is
// kFull in production; the ablation probe P3 instantiates the others at
// DC = 24 only (D = 17..24, the production D = 21).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compare_lse.cuh"

namespace {

using bioem_lse::better;
using bioem_lse::kFull;
using bioem_lse::kMmOnly;
using bioem_lse::kNoLse;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

// Block sum of one float per thread into *out (thread 0 writes); the
// checksum of P3's ablated bodies. Every thread of the block must call it.
__device__ __forceinline__ void block_checksum(float s, float* red_s, float* out) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  s = bioem_lse::warp_sum(s);
  if (lane == 0) red_s[warp] = s;
  __syncthreads();
  if (threadIdx.x == 0) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red_s[w];
    *out = tot;
  }
}

template <int DC, bool CC_OUT, int V>
__global__ void __launch_bounds__(kThreads)
compare_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
               const float* __restrict__ k_re, const float* __restrict__ k_im,
               const float* __restrict__ img_re, const float* __restrict__ img_im,
               const float* __restrict__ wx_re, const float* __restrict__ wx_im,
               const float* __restrict__ wy_re, const float* __restrict__ wy_im,
               const float* __restrict__ a_u, const float* __restrict__ b_u,
               float a_coef, int C, int I, int N, int F, int D, int M, int n_fold,
               float* __restrict__ out_m, float* __restrict__ out_se,
               int* __restrict__ out_ds, float* __restrict__ out_ccs,
               float* __restrict__ out_cc) {
  extern __shared__ float4 smem4[];
  const int Dpad = ((D + DC - 1) / DC) * DC;
  const int DD = D * D;
  float2* wxs = reinterpret_cast<float2*>(smem4);  // [M][Dpad] complex
  float2* wys = wxs + (size_t)M * Dpad;            // [D][F] complex
  float2* t1s = wys + (size_t)D * F;               // [D][F] complex
  float* ccv = reinterpret_cast<float*>(t1s + (size_t)D * F);  // [D²] cc
  float* vv = ccv + DD;                                        // [D²] v
  __shared__ float red_v[kWarps];
  __shared__ int red_i[kWarps];
  __shared__ float red_s[kWarps];

  const int i = blockIdx.x;
  const int oc = blockIdx.y;
  const int tid = threadIdx.x;
  const size_t NF = (size_t)N * F;

  for (int q = tid; q < M * Dpad; q += kThreads) {
    const int j = q / Dpad, d = q - j * Dpad;
    wxs[q] = d < D ? make_float2(wx_re[d * M + j], wx_im[d * M + j])
                   : make_float2(0.f, 0.f);
  }
  for (int q = tid; q < D * F; q += kThreads)
    wys[q] = make_float2(wy_re[q], wy_im[q]);
  __syncthreads();

  const float *pa_re, *pa_im, *pk_re = nullptr, *pk_im = nullptr;
  if (CC_OUT) {
    pa_re = a_re + oc * NF;
    pa_im = a_im + oc * NF;
  } else {
    const int o = oc / C, c = oc - (oc / C) * C;
    pa_re = a_re + o * NF;
    pa_im = a_im + o * NF;
    pk_re = k_re + c * NF;
    pk_im = k_im + c * NF;
  }
  const float* pi_re = img_re + i * NF;
  const float* pi_im = img_im + i * NF;

  // Stage 1: t1[d, f] = Σ_j wx[d, j] · fold(p)[j, f].
  float chk = 0.f;  // the ablated bodies' checksum
  for (int d0 = 0; d0 < D; d0 += DC) {
    for (int f = tid; f < F; f += kThreads) {
      float ar[DC], ai[DC];
#pragma unroll
      for (int dd = 0; dd < DC; ++dd) {
        ar[dd] = 0.f;
        ai[dd] = 0.f;
      }
#pragma unroll 2
      for (int j = 0; j < M; ++j) {
        float pr = 0.f, pim = 0.f;
        if constexpr (V == kMmOnly) {
          // Operands formed once: the image spectrum itself.
          pr = pi_re[(size_t)j * F + f];
          pim = pi_im[(size_t)j * F + f];
        } else {
          for (int k = 0; k < n_fold; ++k) {
            const size_t idx = (size_t)(j + k * M) * F + f;
            float cr, ci;
            if (CC_OUT) {
              cr = pa_re[idx];
              ci = pa_im[idx];
            } else {
              const float xr = pa_re[idx], xi = pa_im[idx];
              const float kr = pk_re[idx], ki = pk_im[idx];
              cr = xr * kr + xi * ki;
              ci = xi * kr - xr * ki;
            }
            const float ir = pi_re[idx], ii = pi_im[idx];
            pr += cr * ir - ci * ii;
            pim += cr * ii + ci * ir;
          }
        }
        const float4* w4 = reinterpret_cast<const float4*>(wxs + (size_t)j * Dpad + d0);
#pragma unroll
        for (int h = 0; h < DC / 2; ++h) {
          const float4 w = w4[h];  // (re, im) of rows d0+2h and d0+2h+1
          ar[2 * h] += w.x * pr - w.y * pim;
          ai[2 * h] += w.x * pim + w.y * pr;
          ar[2 * h + 1] += w.z * pr - w.w * pim;
          ai[2 * h + 1] += w.z * pim + w.w * pr;
        }
      }
      if constexpr (V == kMmOnly) {
#pragma unroll
        for (int dd = 0; dd < DC; ++dd) chk += ar[dd] + ai[dd];
      } else {
#pragma unroll
        for (int dd = 0; dd < DC; ++dd)
          if (d0 + dd < D) t1s[(d0 + dd) * F + f] = make_float2(ar[dd], ai[dd]);
      }
    }
  }
  if constexpr (V == kMmOnly) {
    block_checksum(chk, red_s, out_m + (size_t)oc * I + i);
    return;
  }
  __syncthreads();

  // Stage 2: cc[d, e] = Σ_f Re(t1[d, f] · wy[e, f]).
  for (int q = tid; q < DD; q += kThreads) {
    const int d = q / D, e = q - (q / D) * D;
    const float2* t = t1s + d * F;
    const float2* w = wys + e * F;
    float sr = 0.f, si = 0.f;
    for (int f = 0; f < F; ++f) {
      const float2 tv = t[f], wv = w[f];
      sr += tv.x * wv.x;
      si += tv.y * wv.y;
    }
    const float cc = sr - si;
    if (CC_OUT)
      out_cc[((size_t)oc * I + i) * DD + q] = cc;
    else if constexpr (V == kNoLse)
      chk += cc;
    else
      ccv[q] = cc;
  }
  if (CC_OUT) return;
  if constexpr (V == kNoLse) {
    block_checksum(chk, red_s, out_m + (size_t)oc * I + i);
    return;
  }
  __syncthreads();

  // Displacement log-sum-exp over the D² lattice.
  const float au = a_u[(size_t)oc * I + i];
  const float bu = b_u[(size_t)oc * I + i];
  float best = -INFINITY;
  int bidx = DD;
  for (int q = tid; q < DD; q += kThreads) {
    const float v = bioem_lse::lattice_value(ccv[q], au, bu, a_coef);
    vv[q] = v;
    if (better(v, q, best, bidx)) {
      best = v;
      bidx = q;
    }
  }
  const int lane = tid & 31, warp = tid >> 5;
  bioem_lse::warp_argmax(best, bidx);
  if (lane == 0) {
    red_v[warp] = best;
    red_i[warp] = bidx;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kWarps; ++w)
      if (better(red_v[w], red_i[w], best, bidx)) {
        best = red_v[w];
        bidx = red_i[w];
      }
    if (bidx >= DD) bidx = 0;  // every v is −inf: argmax of an all-equal row
    red_v[0] = best;
    red_i[0] = bidx;
  }
  __syncthreads();
  const float mx = red_v[0];
  float s = 0.f;
  for (int q = tid; q < DD; q += kThreads) s += expf(vv[q] - mx);
  s = bioem_lse::warp_sum(s);
  __syncthreads();
  if (lane == 0) red_s[warp] = s;
  __syncthreads();
  if (tid == 0) {
    float tot = 0.f;
    for (int w = 0; w < kWarps; ++w) tot += red_s[w];
    const size_t o = (size_t)oc * I + i;
    out_m[o] = mx;
    out_se[o] = tot;
    out_ds[o] = red_i[0];
    out_ccs[o] = ccv[red_i[0]];
  }
}

size_t smem_bytes(int DC, int D, int M, int F) {
  const int Dpad = ((D + DC - 1) / DC) * DC;
  return sizeof(float2) * ((size_t)M * Dpad + 2 * (size_t)D * F) +
         sizeof(float) * 2 * (size_t)D * D;
}

template <int DC, bool CC_OUT, int V = kFull>
int launch(const float* a_re, const float* a_im, const float* k_re, const float* k_im,
           const float* img_re, const float* img_im, const float* wx_re,
           const float* wx_im, const float* wy_re, const float* wy_im,
           const float* a_u, const float* b_u, float a_coef, int OC, int C, int I,
           int N, int F, int D, int M, int n_fold, float* m, float* se, int* ds,
           float* ccs, float* cc, cudaStream_t stream) {
  const size_t smem = smem_bytes(DC, D, M, F);
  cudaError_t err = cudaFuncSetAttribute(compare_kernel<DC, CC_OUT, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(I, OC);
  compare_kernel<DC, CC_OUT, V><<<grid, kThreads, smem, stream>>>(
      a_re, a_im, k_re, k_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u, b_u,
      a_coef, C, I, N, F, D, M, n_fold, m, se, ds, ccs, cc);
  return (int)cudaGetLastError();
}

template <bool CC_OUT>
int dispatch(const float* a_re, const float* a_im, const float* k_re, const float* k_im,
             const float* img_re, const float* img_im, const float* wx_re,
             const float* wx_im, const float* wy_re, const float* wy_im,
             const float* a_u, const float* b_u, float a_coef, int OC, int C, int I,
             int N, int F, int D, int M, int n_fold, float* m, float* se, int* ds,
             float* ccs, float* cc, cudaStream_t stream) {
  // DC lattice rows of t1 live in registers per thread; larger D loops
  // over row chunks of 24.
  if (D <= 8)
    return launch<8, CC_OUT>(a_re, a_im, k_re, k_im, img_re, img_im, wx_re, wx_im,
                             wy_re, wy_im, a_u, b_u, a_coef, OC, C, I, N, F, D, M,
                             n_fold, m, se, ds, ccs, cc, stream);
  if (D <= 16)
    return launch<16, CC_OUT>(a_re, a_im, k_re, k_im, img_re, img_im, wx_re, wx_im,
                              wy_re, wy_im, a_u, b_u, a_coef, OC, C, I, N, F, D, M,
                              n_fold, m, se, ds, ccs, cc, stream);
  return launch<24, CC_OUT>(a_re, a_im, k_re, k_im, img_re, img_im, wx_re, wx_im,
                            wy_re, wy_im, a_u, b_u, a_coef, OC, C, I, N, F, D, M,
                            n_fold, m, se, ds, ccs, cc, stream);
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these sizes (the wrapper
// checks it against the card's per-block limit before launching).
size_t bioem_compare_smem_bytes(int D, int M, int F) {
  const int DC = D <= 8 ? 8 : (D <= 16 ? 16 : 24);
  return smem_bytes(DC, D, M, F);
}

int bioem_fused_compare(const float* proj_re, const float* proj_im, const float* ctf_re,
                        const float* ctf_im, const float* img_re, const float* img_im,
                        const float* wx_re, const float* wx_im, const float* wy_re,
                        const float* wy_im, const float* a_u, const float* b_u,
                        float a_coef, int O, int C, int I, int N, int F, int D, int M,
                        int n_fold, float* m, float* se, int* ds, float* ccs,
                        void* stream) {
  return dispatch<false>(proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im,
                         wy_re, wy_im, a_u, b_u, a_coef, O * C, C, I, N, F, D, M, n_fold,
                         m, se, ds, ccs, nullptr, (cudaStream_t)stream);
}

int bioem_fused_displacement_cc(const float* conv_re, const float* conv_im,
                                const float* img_re, const float* img_im,
                                const float* wx_re, const float* wx_im,
                                const float* wy_re, const float* wy_im, int OC, int I,
                                int N, int F, int D, int M, int n_fold, float* cc,
                                void* stream) {
  return dispatch<true>(conv_re, conv_im, nullptr, nullptr, img_re, img_im, wx_re, wx_im,
                        wy_re, wy_im, nullptr, nullptr, 0.f, OC, 1, I, N, F, D, M, n_fold,
                        nullptr, nullptr, nullptr, nullptr, cc, (cudaStream_t)stream);
}

// The kernel probe P3: body variant ``variant`` (bioem_lse::Body: kFull,
// kNoLse or kMmOnly) of bioem_fused_compare at DC = 24 (D = 17..24). kFull
// is the production instance itself; the other variants write a checksum
// into m and nothing else.
int bioem_probe_compare(int variant, const float* proj_re, const float* proj_im,
                        const float* ctf_re, const float* ctf_im, const float* img_re,
                        const float* img_im, const float* wx_re, const float* wx_im,
                        const float* wy_re, const float* wy_im, const float* a_u,
                        const float* b_u, float a_coef, int O, int C, int I, int N, int F,
                        int D, int M, int n_fold, float* m, float* se, int* ds, float* ccs,
                        void* stream) {
  if (D <= 16 || D > 24) return (int)cudaErrorInvalidValue;
#define BIOEM_K1_ARGS                                                                    \
  proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u, b_u, \
      a_coef, O * C, C, I, N, F, D, M, n_fold, m, se, ds, ccs, nullptr, (cudaStream_t)stream
  switch (variant) {
    case kFull: return launch<24, false, kFull>(BIOEM_K1_ARGS);
    case kNoLse: return launch<24, false, kNoLse>(BIOEM_K1_ARGS);
    case kMmOnly: return launch<24, false, kMmOnly>(BIOEM_K1_ARGS);
  }
#undef BIOEM_K1_ARGS
  return (int)cudaErrorInvalidValue;
}

const char* bioem_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

// cc-lattice kernel (K3) for Hopper (sm_90a): conv ⊙ image → the
// displacement-lattice DFT, written out as the (D, D) cc lattice.
//
// Replaces bioem_tpu/ops/compare_pallas.py:_fused_cc_kernel (entry
// fused_displacement_cc). Per (orientation·ctf oc, image i) of a
// precomputed conv bank (OC, N, F):
//   p      = conv[oc] ⊙ img[i], rows folded by n_fold   (M = N/n_fold, F)
//   t1     = wx · p                                     (D, F) complex
//   cc     = Re(t1 · wyᵀ)                               (D, D)
// The engine's hybrid branch (fused_lse=False, DC-dominated image banks)
// and the DEBUG_PROB dump run it; the log-sum-exp follows in torch.
//
// This is the first K1's FP32 FMA body in its cc-out mode, kept as it
// was: K1 itself moved to compare_fused.cu (warpgroup wgmma), and this
// file serves K3 alone until K3's own redesign (ROADMAP queue B), which
// may share K1's new body.
//
// What bounds it on the card: the useful work is 8·D·M·F + 4·D²·F f32 FMA
// operations per comparison (≈2.3 MFLOP at N=224, D=21, M=112), while the
// inputs (conv and image spectra: a few MB per orientation block) sit in
// the 50 MB L2. Stage 1 is the bulk of the arithmetic, so the kernel is
// bound by f32 FMA issue and by the shared-memory reads that feed it.
// Design: one block per (oc, i); each thread owns one column f of the
// cross-spectrum, forms p on the fly from coalesced global loads and keeps
// DC lattice rows of t1 in registers while the wx weights are broadcast
// from shared memory as float4 pairs. t1 stays in shared memory. Plain f32
// FMA, no tensor cores.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

template <int DC>
__global__ void __launch_bounds__(kThreads)
cc_kernel(const float* __restrict__ a_re, const float* __restrict__ a_im,
          const float* __restrict__ img_re, const float* __restrict__ img_im,
          const float* __restrict__ wx_re, const float* __restrict__ wx_im,
          const float* __restrict__ wy_re, const float* __restrict__ wy_im, int I, int N,
          int F, int D, int M, int n_fold, float* __restrict__ out_cc) {
  extern __shared__ float4 smem4[];
  const int Dpad = ((D + DC - 1) / DC) * DC;
  const int DD = D * D;
  float2* wxs = reinterpret_cast<float2*>(smem4);  // [M][Dpad] complex
  float2* wys = wxs + (size_t)M * Dpad;            // [D][F] complex
  float2* t1s = wys + (size_t)D * F;               // [D][F] complex

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

  const float* pa_re = a_re + oc * NF;
  const float* pa_im = a_im + oc * NF;
  const float* pi_re = img_re + i * NF;
  const float* pi_im = img_im + i * NF;

  // Stage 1: t1[d, f] = Σ_j wx[d, j] · fold(p)[j, f].
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
        for (int k = 0; k < n_fold; ++k) {
          const size_t idx = (size_t)(j + k * M) * F + f;
          const float cr = pa_re[idx], ci = pa_im[idx];
          const float ir = pi_re[idx], ii = pi_im[idx];
          pr += cr * ir - ci * ii;
          pim += cr * ii + ci * ir;
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
#pragma unroll
      for (int dd = 0; dd < DC; ++dd)
        if (d0 + dd < D) t1s[(d0 + dd) * F + f] = make_float2(ar[dd], ai[dd]);
    }
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
    out_cc[((size_t)oc * I + i) * DD + q] = sr - si;
  }
}

size_t smem_bytes(int DC, int D, int M, int F) {
  const int Dpad = ((D + DC - 1) / DC) * DC;
  return sizeof(float2) * ((size_t)M * Dpad + 2 * (size_t)D * F) +
         sizeof(float) * 2 * (size_t)D * D;
}

template <int DC>
int launch(const float* conv_re, const float* conv_im, const float* img_re,
           const float* img_im, const float* wx_re, const float* wx_im, const float* wy_re,
           const float* wy_im, int OC, int I, int N, int F, int D, int M, int n_fold, float* cc,
           cudaStream_t stream) {
  const size_t smem = smem_bytes(DC, D, M, F);
  cudaError_t err = cudaFuncSetAttribute(cc_kernel<DC>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(I, OC);
  cc_kernel<DC><<<grid, kThreads, smem, stream>>>(conv_re, conv_im, img_re, img_im, wx_re,
                                                   wx_im, wy_re, wy_im, I, N, F, D, M, n_fold,
                                                   cc);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Dynamic shared memory the kernel needs for these sizes (the wrapper
// checks it against the card's per-block limit before launching). The
// formula is the first K1's, which shared this kernel: it counts two D² float
// arrays the cc-out mode does not use.
size_t bioem_compare_smem_bytes(int D, int M, int F) {
  const int DC = D <= 8 ? 8 : (D <= 16 ? 16 : 24);
  return smem_bytes(DC, D, M, F);
}

int bioem_fused_displacement_cc(const float* conv_re, const float* conv_im,
                                const float* img_re, const float* img_im,
                                const float* wx_re, const float* wx_im,
                                const float* wy_re, const float* wy_im, int OC, int I,
                                int N, int F, int D, int M, int n_fold, float* cc,
                                void* stream) {
  // DC lattice rows of t1 live in registers per thread; larger D loops
  // over row chunks of 24.
  const cudaStream_t st = (cudaStream_t)stream;
  if (D <= 8)
    return launch<8>(conv_re, conv_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, OC, I, N,
                     F, D, M, n_fold, cc, st);
  if (D <= 16)
    return launch<16>(conv_re, conv_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, OC, I, N,
                      F, D, M, n_fold, cc, st);
  return launch<24>(conv_re, conv_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, OC, I, N, F,
                    D, M, n_fold, cc, st);
}

const char* bioem_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

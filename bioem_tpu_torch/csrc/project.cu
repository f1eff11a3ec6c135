// Radius-grouped Fourier-space projection kernel for Hopper (sm_90a).
//
// Replaces bioem_tpu/ops/project_pallas.py:_project_kernel (with
// _pow_table and _dot3, entry fourier_project_block).
//
// For every orientation o and frequency (k1, k2) of the half spectrum:
//   out[o, k1, k2] = Σ_g Ŝ_g[k1, k2] · Σ_{p∈g} dens[g, o, p] ·
//                    e^{−2πi·(i0[g,o,p]·k1 + j0[g,o,p]·k2)/N}
// UNSCALED (the caller applies norm_den/tempden). The snapped pixel
// positions i0, j0 are integers, so the phase is an exact table entry
// tw[(i0·k1 + j0·k2) mod N] with tw[j] = e^{−2πi·j/N} built in double
// precision: no sincos of f32 arguments of up to ~10³ rad (whose rounding
// is ~1e-4 rad), and one table read per (point, frequency) instead of the
// Ex ⊗ Ey outer product.
//
// What bounds it on the card: O·G·Pp·N·F point-frequency terms per block
// (≈2.3e8 at O=8, G=14, Pp=80, N=224, F=113), each an integer index, a
// shared-memory table read and two FMAs — instruction issue, not memory
// (the stencil bank Ŝ is read once per (o, k1, k2, g)). Design: one thread
// per output frequency of one orientation; each group's points are staged
// in shared memory in chunks and broadcast to all threads; the mod-N index
// uses a float reciprocal with one correction step instead of an integer
// division.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;

__global__ void __launch_bounds__(kThreads)
project_kernel(const int* __restrict__ i0, const int* __restrict__ j0,
               const float* __restrict__ dens, const float* __restrict__ st_re,
               const float* __restrict__ st_im, int G, int O, int Pp, int N, int F,
               float* __restrict__ out_re, float* __restrict__ out_im) {
  extern __shared__ float2 tw[];  // [N] twiddles e^{−2πi j/N}
  __shared__ int sa[kChunk];
  __shared__ int sb[kChunk];
  __shared__ float sd[kChunk];

  const int o = blockIdx.y;
  const int tid = threadIdx.x;
  const int q = blockIdx.x * kThreads + tid;
  const int NF = N * F;
  const bool live = q < NF;
  const int k1 = live ? q / F : 0;
  const int k2 = live ? q - k1 * F : 0;

  for (int j = tid; j < N; j += kThreads) {
    double s, c;
    sincospi(-2.0 * (double)j / (double)N, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
  const float inv_n = 1.0f / (float)N;

  float acc_re = 0.f, acc_im = 0.f;
  for (int g = 0; g < G; ++g) {
    float s_re = 0.f, s_im = 0.f;
    const size_t base = ((size_t)g * O + o) * Pp;
    for (int p0 = 0; p0 < Pp; p0 += kChunk) {
      const int cnt = min(kChunk, Pp - p0);
      __syncthreads();
      for (int t = tid; t < cnt; t += kThreads) {
        int a = i0[base + p0 + t] % N;
        int b = j0[base + p0 + t] % N;
        sa[t] = a < 0 ? a + N : a;
        sb[t] = b < 0 ? b + N : b;
        sd[t] = dens[base + p0 + t];
      }
      __syncthreads();
      for (int t = 0; t < cnt; ++t) {
        // x < 2·N² ≤ 2^24 (checked by the wrapper), so x is exact in f32
        // and the reciprocal quotient is off by at most one.
        const int x = sa[t] * k1 + sb[t] * k2;
        int r = x - __float2int_rz(__int2float_rn(x) * inv_n) * N;
        r = r >= N ? r - N : r;
        r = r < 0 ? r + N : r;
        const float2 w = tw[r];
        const float dv = sd[t];
        s_re = fmaf(dv, w.x, s_re);
        s_im = fmaf(dv, w.y, s_im);
      }
    }
    if (live) {
      const size_t si = (size_t)g * NF + q;
      const float str = st_re[si], sti = st_im[si];
      acc_re += str * s_re - sti * s_im;
      acc_im += str * s_im + sti * s_re;
    }
  }
  if (live) {
    out_re[(size_t)o * NF + q] = acc_re;
    out_im[(size_t)o * NF + q] = acc_im;
  }
}

}  // namespace

extern "C" {

int bioem_fourier_project(const int* i0, const int* j0, const float* dens,
                          const float* st_re, const float* st_im, int G, int O, int Pp,
                          int N, int F, float* out_re, float* out_im, void* stream) {
  const size_t smem = sizeof(float2) * (size_t)N;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((N * F + kThreads - 1) / kThreads, O);
  project_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      i0, j0, dens, st_re, st_im, G, O, Pp, N, F, out_re, out_im);
  return (int)cudaGetLastError();
}

}  // extern "C"

// PR 14's design of the posterior glue, kept as a probe: its full variants
// are the G1 and G2 the redesign replaced (posterior_glue.cu), so that a
// run can time the two designs side by side on one card, and its partial
// variants attribute the old design's time (ops/probe_cuda.py,
// tools/kernel_probe.py glue_attribution).
//
// G1, one CTA of 512 threads per (o, c) pair: each CTA streams its own
// projection and CTF rows through one SM, each thread's f64 sum is a
// dependent chain over ~50 frequencies (an integer j % F each), thread 0
// adds the 16 warp partials, and in the epilogue 64 of the 512 threads
// each work one image, recomputing log ssr for every (o, c, i) entry.
// Parts: kFull; kLoads (the loads and index arithmetic, an f32 sum of the
// values in place of the f64 products); kLoadsSum (the loads and the f64
// sum, no epilogue); kEpilogue (the epilogue on a fixed ssq_c, no loop).
//
// G2, one warp per image, four images per CTA: each lane walks its O·C/32
// pairs twice (the max with its f64 log1p, then Σ se·ex recomputing the
// log1p), then with slabs all O orientations one after another with C of
// 32 lanes busy (three f64 log1p per pair); lane 0 runs the state update.
// Parts: kFull; kMax (the max pass and the state update on a block sum of
// 1); kMaxSum (the max and Σ passes and the state update, no slabs).
//
// Only kFull computes G1 or G2; the parts write what they compute into the
// same outputs, which are then wrong by design.

#include "posterior_glue.cuh"

namespace {

using namespace glue;

constexpr int kG1Threads = 512;
constexpr int kG2Warps = 4;  // images per G2 block, one warp each

enum G1Part { kG1Full = 0, kLoads = 1, kLoadsSum = 2, kEpilogue = 3 };
enum G2Part { kG2Full = 0, kMax = 1, kMaxSum = 2 };

template <int kPart>
__global__ void __launch_bounds__(kG1Threads) constants_probe_kernel(
    const float* __restrict__ pr, const float* __restrict__ pi,
    const float* __restrict__ ctf_re, const float* __restrict__ ctf_im,
    const float* __restrict__ h, const float* __restrict__ sum_ref,
    const float* __restrict__ ssq_ref, const double* __restrict__ prior,
    const int* __restrict__ mask, int C, int I, int N, int F, double ntot, double ln_ntot,
    int normalized, float* __restrict__ sum_c, float* __restrict__ ssq_c,
    double* __restrict__ f0, double* __restrict__ k, float* __restrict__ a_u,
    float* __restrict__ b_u) {
  const int oc = blockIdx.x;
  const int o = oc / C, c = oc - o * C;
  const int nf = N * F;
  const float* p_re = pr + (size_t)o * nf;
  const float* p_im = pi + (size_t)o * nf;
  const float* c_re = ctf_re + (size_t)c * nf;
  const float* c_im = ctf_im + (size_t)c * nf;

  double acc = 0.0;
  if (kPart == kLoads) {
    float s = 0.f;
    for (int j = threadIdx.x; j < nf; j += kG1Threads)
      s += (p_re[j] + p_im[j]) + (c_re[j] + c_im[j]) * h[j % F];
    acc = s;
  } else if (kPart != kEpilogue) {
    for (int j = threadIdx.x; j < nf; j += kG1Threads)
      acc = __dadd_rn(acc, __dmul_rn(__dmul_rn(mag2(p_re[j], p_im[j]), (double)h[j % F]),
                                     mag2(c_re[j], c_im[j])));
  }
  __shared__ double part[kG1Threads / 32];
  __shared__ float s_sum, s_ssq;
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < kG1Threads / 32; ++w) tot = __dadd_rn(tot, part[w]);
    if (kPart == kEpilogue) tot = __dmul_rn(ntot, 1.2345);  // a representative ssq_c
    const float sc = dc_term(p_re[0], p_im[0], c_re[0], c_im[0]);
    const float ssc = __double2float_rn(__ddiv_rn(tot, ntot));
    sum_c[oc] = sc;
    ssq_c[oc] = ssc;
    s_sum = sc;
    s_ssq = ssc;
  }
  __syncthreads();
  if (kPart == kLoads || kPart == kLoadsSum) return;

  const PairConsts q = pair_consts(s_sum, s_ssq, ntot);
  const double a_coef = __dmul_rn(__dsub_rn(3.0, ntot), 0.5);
  const double pri = prior[c];
  const bool live = mask[o] != 0;
  const float ntot32 = __double2float_rn(ntot);
  for (int i = threadIdx.x; i < I; i += kG1Threads) {
    const size_t at = (size_t)oc * I + i;
    entry(q, image_consts(sum_ref[i], ssq_ref[i]), sum_ref[i], ssq_ref[i], pri, live, normalized,
          ntot, ln_ntot, a_coef, ntot32, f0 + at, k + at, a_u + at, b_u + at);
  }
}

__device__ __forceinline__ double logmax_at(const MergeArgs& a, int oc, int i) {
  const size_t at = (size_t)oc * a.I + i;
  return __dadd_rn(a.k[at], varying_max(a, oc, i, at));
}

template <int kPart>
__global__ void __launch_bounds__(32 * kG2Warps) merge_probe_kernel(const MergeArgs a) {
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * kG2Warps + (threadIdx.x >> 5);
  if (i >= a.I) return;  // the whole warp
  const int oc_n = a.O * a.C;

  double mx = -(double)INFINITY;
  int best = kNoIndex;
  for (int oc = lane; oc < oc_n; oc += 32) {
    const size_t at = (size_t)oc * a.I + i;
    const double mv = varying_max(a, oc, i, at);
    if (a.m_out != nullptr) a.m_out[at] = mv;
    const double lm = __dadd_rn(a.k[at], mv);
    if (better(lm, oc, mx, best)) {
      mx = lm;
      best = oc;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, mx, off);
    const int oi = __shfl_xor_sync(kFull, best, off);
    if (better(ov, oi, mx, best)) {
      mx = ov;
      best = oi;
    }
  }
  double block_sum = 1.0;
  if (kPart != kMax) {
    double s = 0.0;
    for (int oc = lane; oc < oc_n; oc += 32)
      s = __dadd_rn(s, weighted(a.se[(size_t)oc * a.I + i], logmax_at(a, oc, i), mx));
    block_sum = warp_sum(s);
  }

  if (lane == 0) {
    const double c0 = a.cnst[i];
    lse_fold(a.total[i], c0, block_sum, mx, a.total + i, a.cnst + i);
    if (mx > c0) {  // strict >, reference bioem_algorithm.h:96
      const size_t at = (size_t)best * a.I + i;
      write_tuple(a, best, i, a.sum_c[best], a.ssq_c[best], a.ccs[at], a.ds[at], a.disp);
    }
  }

  if (kPart != kG2Full || a.ang_total == nullptr) return;
  const long long a0 = *a.ang_offset;
  for (int o = 0; o < a.O; ++o) {
    double am = -(double)INFINITY;
    for (int c = lane; c < a.C; c += 32) am = nan_max(logmax_at(a, o * a.C + c, i), am);
    am = warp_max(am);
    double as = 0.0;
    for (int c = lane; c < a.C; c += 32) {
      const int oc = o * a.C + c;
      as = __dadd_rn(as, weighted(a.se[(size_t)oc * a.I + i], logmax_at(a, oc, i), am));
    }
    as = warp_sum(as);
    const long long col = a0 + o;
    if (lane == 0 && col >= 0 && col < a.n_cols) {
      double* tp = a.ang_total + (size_t)i * a.n_cols + col;
      double* cp = a.ang_const + (size_t)i * a.n_cols + col;
      lse_fold(*tp, *cp, as, am, tp, cp);
    }
  }
}

template <int kPart>
int launch_constants(const float* pr, const float* pi, const float* ctf_re, const float* ctf_im,
                     const float* h, const float* sum_ref, const float* ssq_ref,
                     const double* prior, const int* mask, int O, int C, int I, int N, int F,
                     double ntot, double ln_ntot, int normalized, float* sum_c, float* ssq_c,
                     double* f0, double* k, float* a_u, float* b_u, cudaStream_t stream) {
  constants_probe_kernel<kPart><<<O * C, kG1Threads, 0, stream>>>(
      pr, pi, ctf_re, ctf_im, h, sum_ref, ssq_ref, prior, mask, C, I, N, F, ntot, ln_ntot,
      normalized, sum_c, ssq_c, f0, k, a_u, b_u);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// part: 0 full, 1 loads, 2 loads and the f64 sum, 3 the epilogue
int bioem_probe_block_constants(int part, const float* pr, const float* pi, const float* ctf_re,
                                const float* ctf_im, const float* h, const float* sum_ref,
                                const float* ssq_ref, const double* prior, const int* mask, int O,
                                int C, int I, int N, int F, double ntot, double ln_ntot,
                                int normalized, float* sum_c, float* ssq_c, double* f0, double* k,
                                float* a_u, float* b_u, void* stream) {
  if (O < 1 || C < 1 || I < 0 || N < 1 || F < 1 || (long long)N * F > 0x7fffffffLL ||
      (long long)O * C > 0x7fffffffLL || part < 0 || part > 3)
    return (int)cudaErrorInvalidValue;
  auto s = (cudaStream_t)stream;
#define BIOEM_G1_PART(P)                                                                    \
  launch_constants<P>(pr, pi, ctf_re, ctf_im, h, sum_ref, ssq_ref, prior, mask, O, C, I, N, F, \
                      ntot, ln_ntot, normalized, sum_c, ssq_c, f0, k, a_u, b_u, s)
  switch (part) {
    case 0: return BIOEM_G1_PART(kG1Full);
    case 1: return BIOEM_G1_PART(kLoads);
    case 2: return BIOEM_G1_PART(kLoadsSum);
    default: return BIOEM_G1_PART(kEpilogue);
  }
#undef BIOEM_G1_PART
}

// part: 0 full, 1 the max pass, 2 the max and Σ passes (the args as
// bioem_merge_block's)
int bioem_probe_merge_block(int part, const float* m, const float* se, const int* ds,
                            const float* ccs, const double* k, const double* f0,
                            const float* sum_c, const float* ssq_c, const float* sum_ref,
                            const int* disp, const long long* orient_offset,
                            const long long* ang_offset, int O, int C, int I, int D, int n_cols,
                            double ntot, double* total, double* cnst, int* best_orient,
                            int* best_conv, int* best_cx, int* best_cy, double* best_norm,
                            double* best_mu, double* ang_total, double* ang_const, double* m_out,
                            void* stream) {
  if (O < 1 || C < 1 || I < 0 || D < 1 || (long long)O * C > 0x7fffffffLL || part < 0 ||
      part > 2)
    return (int)cudaErrorInvalidValue;
  if (I == 0) return 0;
  const MergeArgs a{m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp, orient_offset,
                    ang_offset, O, C, I, D, n_cols, ntot, (3.0 - ntot) * 0.5, total, cnst,
                    best_orient, best_conv, best_cx, best_cy, best_norm, best_mu, ang_total,
                    ang_const, m_out};
  const int grid = (I + kG2Warps - 1) / kG2Warps;
  auto s = (cudaStream_t)stream;
  if (part == 0)
    merge_probe_kernel<kG2Full><<<grid, 32 * kG2Warps, 0, s>>>(a);
  else if (part == 1)
    merge_probe_kernel<kMax><<<grid, 32 * kG2Warps, 0, s>>>(a);
  else
    merge_probe_kernel<kMaxSum><<<grid, 32 * kG2Warps, 0, s>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

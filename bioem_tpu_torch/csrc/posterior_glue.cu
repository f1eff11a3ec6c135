// The block step's posterior glue for Hopper (sm_90a): the block constants
// (G1) and the f64 max repair with the streaming merge (G2).
//
// No Pallas kernel has these bodies: on the TPU, XLA fused them into the
// jitted, scanned block step (bioem_tpu/core/engine.py:503, jit at
// :280-281, scan at :675). They replace:
//   G1 block_constants — engine.py:526-540 (the convolution sums and
//      bioem_tpu/core/posterior.py:199 logpro_constants), :553-560 (the
//      u coefficients a_u and b_u) and the orientation mask at :606;
//   G2 merge_block — engine.py:580 (posterior.py:289 refine_varying_max)
//      and :606-610 (posterior.py:426-522 merge_block).
// Before them the port ran the same arithmetic as ~131 small torch kernels
// per block (ops/posterior_cuda.py keeps those torch ops as the plain
// versions).
//
// Bounds (the production block: O = 8, C = 8, I = 64, N = 224, F = 113).
// G1 reads pr, pi (O, N, F) and ctf_re, ctf_im (C, N, F) once, 3.24 MB:
// ~1 µs at 3.35 TB/s; its f64 work (a multiply-add per (o, c, n, f)) is a
// twentieth of that. G2 reads ~0.15 MB and writes the state: well under a
// microsecond. Both are bound by latency and by being launched at all, not
// by bytes or operations, so the design keeps each to one launch with no
// scratch, no second pass and no atomics (the same bits every launch), and
// does not trade exactness for speed: f64 throughput is not the limit.
//
// Exactness. Every f64 and f32 operation that the plain version rounds on
// its own is written with a round-to-nearest intrinsic (__dmul_rn,
// __dadd_rn, __ddiv_rn, __fmul_rn, ...), which nvcc never contracts into an
// FMA, in the plain version's order; the transcendental functions are
// libdevice's log, log1p, exp and f32 log1pf, expf, as torch's CUDA kernels
// call them (no fast-math flag). So G1's f0, k, a_u, b_u equal the plain
// formulas on G1's own sum_c and ssq_c, and G2's repaired max equals
// refine_varying_max. Where G1 and G2 differ from the plain version, they
// sum in f64: ssq_c (the plain version's f32 matrix product) and the merge's
// Σ se·ex (a torch f32 sum).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kG1Threads = 512;
constexpr int kG2Warps = 4;  // images per G2 block, one warp each
constexpr int kNoIndex = 0x7fffffff;

__device__ __forceinline__ double warp_sum(double v) {
  // A butterfly: every lane ends with the same sum (IEEE addition commutes).
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// torch.maximum / torch.amax: NaN wins, otherwise the larger.
__device__ __forceinline__ double nan_max(double a, double b) {
  return (isnan(a) || a > b) ? a : b;
}

__device__ __forceinline__ double warp_max(double v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = nan_max(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

// (a, ia) beats (b, ib) under torch.argmax's rule: NaN counts as the
// largest value, and of equal values (−inf included) the lower flat index
// — the first occurrence — wins. A strict order on distinct indices, so the
// warp's butterfly reduction gives the same winner in every lane and in any
// order.
__device__ __forceinline__ bool better(double a, int ia, double b, int ib) {
  const bool an = isnan(a), bn = isnan(b);
  if (an || bn) return an && (!bn || ia < ib);
  return a > b || (a == b && ia < ib);
}

// ---------------------------------------------------------------------------
// G1: one block per (o, c) pair
// ---------------------------------------------------------------------------
//
// The block reduces |p|²·h·|ctf|² over the N·F half spectrum in f64 (the
// f32 inputs squared exactly, one rounding per product and per add, the
// threads' partial sums in a fixed tree), divides by ntot in f64 and rounds
// to f32 once: nearer f64 truth than the plain f32 matrix product, not
// bit-equal to it. sum_c is conv's DC term, Re(p₀₀·conj(ctf₀₀)), in f32 as
// the plain version rounds it. The same block then writes row (o, c, :) of
// f0, k, a_u and b_u, which depends only on its own sums and the (I,)
// image vectors: no block waits on another.

__global__ void __launch_bounds__(kG1Threads) block_constants_kernel(
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
  for (int j = threadIdx.x; j < nf; j += kG1Threads) {
    const double a = p_re[j], b = p_im[j], x = c_re[j], y = c_im[j];
    const double mp = __dadd_rn(__dmul_rn(a, a), __dmul_rn(b, b));
    const double mc = __dadd_rn(__dmul_rn(x, x), __dmul_rn(y, y));
    acc = __dadd_rn(acc, __dmul_rn(__dmul_rn(mp, (double)h[j % F]), mc));
  }
  __shared__ double part[kG1Threads / 32];
  __shared__ float s_sum, s_ssq;
  acc = warp_sum(acc);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < kG1Threads / 32; ++w) tot = __dadd_rn(tot, part[w]);
    const float sc = __fadd_rn(__fmul_rn(p_re[0], c_re[0]), __fmul_rn(p_im[0], c_im[0]));
    const float ssc = __double2float_rn(__ddiv_rn(tot, ntot));
    sum_c[oc] = sc;
    ssq_c[oc] = ssc;
    s_sum = sc;
    s_ssq = ssc;
  }
  __syncthreads();

  // logpro_constants (core/posterior.py), operation for operation
  const float sc32 = s_sum;
  const double sc = sc32, ssc = s_ssq;
  const double forlog = __dsub_rn(__dmul_rn(ssc, ntot), __dmul_rn(sc, sc));
  const double a_coef = __dmul_rn(__dsub_rn(3.0, ntot), 0.5);
  const double k_forlog = __dmul_rn(__dsub_rn(__dmul_rn(ntot, 0.5), 2.0),
                                    log(__dmul_rn(__dsub_rn(ntot, 2.0), forlog)));
  const double g = __ddiv_rn(forlog, ssc);
  const double log_ssc = log(ssc), log_g = log(g);
  const double pri = prior[c];
  const bool live = mask[o] != 0;
  const float ntot32 = __double2float_rn(ntot);
  for (int i = threadIdx.x; i < I; i += kG1Threads) {
    const double sr = sum_ref[i], ssr = ssq_ref[i];
    double f0v, log_f0;
    if (normalized) {
      // F0 = ssr·ssc·(g − h); log F0 = log ssr + log ssc + log g + log1p(−h/g),
      // the last in f32 of the f32-rounded ratio, as the plain version.
      const double hh = __ddiv_rn(__dmul_rn(sr, sr), ssr);
      f0v = __dmul_rn(__dmul_rn(ssr, ssc), __dsub_rn(g, hh));
      const float corr = log1pf(-__double2float_rn(__ddiv_rn(hh, g)));
      log_f0 = __dadd_rn(__dadd_rn(__dadd_rn(log(ssr), log_ssc), log_g), (double)corr);
    } else {
      // the DC-capable point F0 = ntot·ssr·ssc (the hybrid's f64 u)
      f0v = __dmul_rn(__dmul_rn(ntot, ssr), ssc);
      log_f0 = __dadd_rn(__dadd_rn(ln_ntot, log(ssr)), log_ssc);
    }
    const double kv = __dsub_rn(__dadd_rn(__dmul_rn(a_coef, log_f0), k_forlog), pri);
    const size_t at = (size_t)oc * I + i;
    f0[at] = f0v;
    k[at] = live ? kv : -(double)INFINITY;
    // the u coefficients: a_u = 2·sr·sc/f0, b_u = (1/f0)·ntot in f32 (torch's
    // scalar/tensor is a reciprocal and a product)
    const float f0_32 = __double2float_rn(f0v);
    a_u[at] = __fdiv_rn(__fmul_rn(__fmul_rn(2.0f, sum_ref[i]), sc32), f0_32);
    b_u[at] = __fmul_rn(__frcp_rn(f0_32), ntot32);
  }
}

// ---------------------------------------------------------------------------
// G2: one warp per image
// ---------------------------------------------------------------------------
//
// The warp walks the image's O·C (orientation, CTF) pairs, a lane taking
// pairs lane, lane + 32, ...: (1) the varying max m (repaired in f64 from
// the argmax cc, as refine_varying_max, unless the hybrid's f32 m of a
// DC-dominated bank is given), logmax = k + m, and the first-occurrence argmax; (2) Σ se·ex with
// ex = expf(f32(logmax − max)) and 0 where that difference is NaN (−inf −
// −inf: a masked pair), each product in f32 as the plain version takes it
// and the sum in f64 (the plain version sums in f32); (3) with slabs, per
// orientation the same over its C pairs. Lane 0 then folds the block into
// the image's state in place: total and const by the online log-sum-exp
// rule, the argmax tuple where the block's max beats const strictly. A fully
// masked block leaves the state exactly as it was (max −inf, sum 0,
// exp(0) = 1). Each pass recomputes logmax (the same bits each time)
// rather than hold O·C values per warp. The block's orientation offsets
// are read from device memory at run time: a captured step advances them.

struct MergeArgs {
  const float* m;  // (O, C, I) f32 varying max, or null: repair from ccs
  const float* se;
  const int* ds;
  const float* ccs;
  const double* k;
  const double* f0;
  const float* sum_c;
  const float* ssq_c;
  const float* sum_ref;
  const int* disp;
  const long long* orient_offset;
  const long long* ang_offset;
  int O, C, I, D, n_cols;
  double ntot, a_coef;
  double* total;
  double* cnst;
  int* best_orient;
  int* best_conv;
  int* best_cx;
  int* best_cy;
  double* best_norm;
  double* best_mu;
  double* ang_total;  // (I, n_cols) or null
  double* ang_const;
  double* m_out;  // (O, C, I) f64 or null: the varying max used
};

__device__ __forceinline__ double varying_max(const MergeArgs& a, int oc, int i, size_t at) {
  if (a.m != nullptr) return a.m[at];
  // refine_varying_max: u = (2·sr·sc·cc − ntot·cc·cc)/F0, A·log1p(u)
  const double cc = a.ccs[at];
  const double t = __dmul_rn(__dmul_rn(__dmul_rn(2.0, (double)a.sum_ref[i]), (double)a.sum_c[oc]), cc);
  const double u = __ddiv_rn(__dsub_rn(t, __dmul_rn(__dmul_rn(a.ntot, cc), cc)), a.f0[at]);
  return __dmul_rn(a.a_coef, log1p(u));
}

__device__ __forceinline__ double logmax_at(const MergeArgs& a, int oc, int i) {
  const size_t at = (size_t)oc * a.I + i;
  return __dadd_rn(a.k[at], varying_max(a, oc, i, at));
}

// se·expf(f32(lm − mx)) in f32, 0 where the difference is NaN
__device__ __forceinline__ double weighted(const MergeArgs& a, int oc, int i, double lm, double mx) {
  const float diff = __double2float_rn(__dsub_rn(lm, mx));
  const float ex = isnan(diff) ? 0.f : expf(diff);
  return (double)__fmul_rn(a.se[(size_t)oc * a.I + i], ex);
}

__global__ void __launch_bounds__(32 * kG2Warps) merge_block_kernel(const MergeArgs a) {
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
  double s = 0.0;
  for (int oc = lane; oc < oc_n; oc += 32) s = __dadd_rn(s, weighted(a, oc, i, logmax_at(a, oc, i), mx));
  const double block_sum = warp_sum(s);

  if (lane == 0) {
    const double c0 = a.cnst[i];
    const double nc = nan_max(c0, mx);
    a.total[i] = __dadd_rn(__dmul_rn(a.total[i], exp(__dsub_rn(c0, nc))),
                           __dmul_rn(block_sum, exp(__dsub_rn(mx, nc))));
    a.cnst[i] = nc;
    if (mx > c0) {  // strict >, reference bioem_algorithm.h:96
      const int os = best / a.C, cs = best - os * a.C;
      const size_t at = (size_t)best * a.I + i;
      const double sc = a.sum_c[best], ssc = a.ssq_c[best], cc = a.ccs[at], sr = a.sum_ref[i];
      const int d = a.ds[at];
      // bioem_algorithm.h:106-111
      const double denom = __dsub_rn(__dmul_rn(sc, sc), __dmul_rn(ssc, a.ntot));
      a.best_norm[i] = -__ddiv_rn(__dadd_rn(__dmul_rn(-sc, sr), __dmul_rn(a.ntot, cc)), denom);
      a.best_mu[i] = -__ddiv_rn(__dadd_rn(__dmul_rn(-sc, cc), __dmul_rn(ssc, sr)), denom);
      a.best_orient[i] = (int)(*a.orient_offset + os);
      a.best_conv[i] = cs;
      a.best_cx[i] = -a.disp[d / a.D];
      a.best_cy[i] = -a.disp[d % a.D];
    }
  }

  if (a.ang_total == nullptr) return;
  // Per-(image, orientation) accumulation (bioem_algorithm.h:130-141):
  // merged over the CTF axis, then streamed into the slab's column
  // ang_offset + o. The wrapper raises on an int offset whose block does
  // not fit the slab, as the plain version's index_copy_ does; a device
  // offset out of range is the caller's fault, and its columns are not
  // written (no write outside the slab).
  const long long a0 = *a.ang_offset;
  for (int o = 0; o < a.O; ++o) {
    double am = -(double)INFINITY;
    for (int c = lane; c < a.C; c += 32) am = nan_max(logmax_at(a, o * a.C + c, i), am);
    am = warp_max(am);
    double as = 0.0;
    for (int c = lane; c < a.C; c += 32) {
      const int oc = o * a.C + c;
      as = __dadd_rn(as, weighted(a, oc, i, logmax_at(a, oc, i), am));
    }
    as = warp_sum(as);
    const long long col = a0 + o;
    if (lane == 0 && col >= 0 && col < a.n_cols) {
      double* tp = a.ang_total + (size_t)i * a.n_cols + col;
      double* cp = a.ang_const + (size_t)i * a.n_cols + col;
      const double sc0 = *cp;
      const double nc = nan_max(sc0, am);
      *tp = __dadd_rn(__dmul_rn(*tp, exp(__dsub_rn(sc0, nc))), __dmul_rn(as, exp(__dsub_rn(am, nc))));
      *cp = nc;
    }
  }
}

}  // namespace

extern "C" {

int bioem_block_constants(const float* pr, const float* pi, const float* ctf_re,
                          const float* ctf_im, const float* h, const float* sum_ref,
                          const float* ssq_ref, const double* prior, const int* mask, int O, int C,
                          int I, int N, int F, double ntot, double ln_ntot, int normalized,
                          float* sum_c, float* ssq_c, double* f0, double* k, float* a_u,
                          float* b_u, void* stream) {
  if (O < 1 || C < 1 || I < 0 || N < 1 || F < 1 || (long long)N * F > 0x7fffffffLL ||
      (long long)O * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  block_constants_kernel<<<O * C, kG1Threads, 0, (cudaStream_t)stream>>>(
      pr, pi, ctf_re, ctf_im, h, sum_ref, ssq_ref, prior, mask, C, I, N, F, ntot, ln_ntot,
      normalized, sum_c, ssq_c, f0, k, a_u, b_u);
  return (int)cudaGetLastError();
}

int bioem_merge_block(const float* m, const float* se, const int* ds,
                      const float* ccs, const double* k, const double* f0, const float* sum_c,
                      const float* ssq_c, const float* sum_ref, const int* disp,
                      const long long* orient_offset, const long long* ang_offset, int O, int C,
                      int I, int D, int n_cols, double ntot, double* total, double* cnst,
                      int* best_orient, int* best_conv, int* best_cx, int* best_cy,
                      double* best_norm, double* best_mu, double* ang_total, double* ang_const,
                      double* m_out, void* stream) {
  if (O < 1 || C < 1 || I < 0 || D < 1 || (long long)O * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (I == 0) return 0;
  MergeArgs a;
  a.m = m;
  a.se = se;
  a.ds = ds;
  a.ccs = ccs;
  a.k = k;
  a.f0 = f0;
  a.sum_c = sum_c;
  a.ssq_c = ssq_c;
  a.sum_ref = sum_ref;
  a.disp = disp;
  a.orient_offset = orient_offset;
  a.ang_offset = ang_offset;
  a.O = O;
  a.C = C;
  a.I = I;
  a.D = D;
  a.n_cols = n_cols;
  a.ntot = ntot;
  a.a_coef = (3.0 - ntot) * 0.5;
  a.total = total;
  a.cnst = cnst;
  a.best_orient = best_orient;
  a.best_conv = best_conv;
  a.best_cx = best_cx;
  a.best_cy = best_cy;
  a.best_norm = best_norm;
  a.best_mu = best_mu;
  a.ang_total = ang_total;
  a.ang_const = ang_const;
  a.m_out = m_out;
  const int grid = (I + kG2Warps - 1) / kG2Warps;
  merge_block_kernel<<<grid, 32 * kG2Warps, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

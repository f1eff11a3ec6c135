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
// The formulas are in posterior_glue.cuh.
//
// Bounds (the production block: O = 8, C = 8, I = 64, N = 224, F = 113).
// G1 reads pr, pi (O, N, F) and ctf_re, ctf_im (C, N, F) once, 3.24 MB:
// ~1 µs at 3.35 TB/s; its f64 work (a multiply-add per (o, c, n, f)) is a
// twentieth of that. G2 reads ~0.1 MB and writes the state: well under a
// microsecond. Both are bound by latency, not by bytes or operations: the
// design spreads each over the card and keeps each thread's dependent
// chain short, with no float atomics (the same bits every launch).
//
// G1. A grid of at most one CTA per SM splits the N·F half spectrum into
// chunks. Each CTA copies its chunk of all O projection rows and all C CTF
// rows into shared memory once (cp.async, every copy in flight at once;
// every input read once by the whole grid), forms |p|²·h and |ctf|² in f64
// beside them, and its threads each accumulate one (o, c) pair over a
// strided share of the chunk's columns; the shares are added in a fixed
// order into one partial per (CTA, pair) in a workspace. Every CTA also
// writes a slice of the per-image table (log ssr, sr²/ssr). The CTAs then
// take an integer ticket: the last `workers` to arrive wait until every CTA
// of the launch has arrived, then each sums the partials of its slice of
// pairs over the chunks in a fixed order (so ssq_c has the same bits on
// every launch), rounds to f32 once, forms the per-pair constants once,
// and writes its pairs' (o, c, i) rows of f0, k, a_u, b_u, one entry per
// thread. The ticket counts arrivals and is never reset, so a graph replay
// needs no memset. The wait is safe: the grid is no larger than the number
// of SMs, so every CTA it waits for runs. The plan (grid, chunk, columns
// per staging pass, workers, pairs per worker) is ops/posterior_cuda.py
// constants_plan; the engine holds one workspace, the wrapper makes one for
// a call that passes none.
//
// G2. One CTA per image, one thread per (o, c) pair (up to 512; beyond
// that each thread loops over pairs). Each thread repairs its pair's
// varying max once (one f64 log1p) and keeps logmax = k + m and se in
// shared memory; the block reduces max and first-occurrence argmax, then
// Σ se·expf(f32(lm − max)) in f64, by a fixed tree over lanes and warps.
// One thread folds the block into total and const; the thread of the
// block's best pair, which kept that pair's cc, displacement and sums,
// writes the argmax tuple where the block's max beats const strictly. With slabs, the
// C pairs of each orientation reduce as a segment of lanes (C ≤ 32) or a
// warp looping over them, all orientations at once.
//
// Where G1 and G2 differ from the plain version, they sum in f64: ssq_c
// (the plain version's f32 matrix product) and the merge's Σ se·ex (a torch
// f32 sum). Every other output is the plain formula's, to the bit.

#include "posterior_glue.cuh"

namespace {

using namespace glue;

constexpr int kG1Threads = 512;
constexpr int kG2MaxThreads = 512;
constexpr int kTailLoads = 8;  // partials a worker thread loads at once

// A worker's threads that share one (o, c) pair: a power of 2, at most a
// warp (they are neighbours in it and add their shares by a butterfly), so
// that n pairs fit kG1Threads.
__device__ __forceinline__ int pair_lanes(int n) {
  int l = 1;
  while (l < 32 && 2 * l * n <= kG1Threads) l <<= 1;
  return l;
}

// v summed over each aligned group of `lanes` neighbouring lanes of a warp,
// in a fixed tree (every lane of the group ends with the same sum); the
// whole warp calls it
__device__ __forceinline__ double lanes_sum(double v, int lanes) {
  for (int off = lanes >> 1; off > 0; off >>= 1) v = __dadd_rn(v, __shfl_xor_sync(kFull, v, off));
  return v;
}

__device__ __forceinline__ unsigned long long load_acquire(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// a 4-byte copy from device memory into shared memory that holds no register
__device__ __forceinline__ void copy_async(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---------------------------------------------------------------------------
// G1: a split-K f64 reduction over the card
// ---------------------------------------------------------------------------

struct ConstantsArgs {
  const float *pr, *pi, *ctf_re, *ctf_im, *h, *sum_ref, *ssq_ref;
  const double* prior;
  const int* mask;
  int O, C, I, N, F;
  double ntot, ln_ntot;
  int normalized;
  int chunk, sub, workers, per_worker;  // the plan
  double* ws;                   // (grid·O·C) partials, then (2·I) the image table
  unsigned long long* ticket;  // arrivals since the workspace was made
  float *sum_c, *ssq_c;
  double *f0, *k;
  float *a_u, *b_u;
};

__global__ void __launch_bounds__(kG1Threads) block_constants_kernel(const ConstantsArgs a) {
  extern __shared__ double smem[];
  __shared__ int s_rank;
  const int t = threadIdx.x, grid = gridDim.x, b = blockIdx.x;
  const int P = a.O * a.C, R = a.O + a.C, nf = a.N * a.F;
  double* partials = a.ws;
  double* img = a.ws + (size_t)grid * P;  // log ssr, then h = sr²/ssr

  for (int i = b * kG1Threads + t; i < a.I; i += grid * kG1Threads) {
    const ImageConsts im = image_consts(a.sum_ref[i], a.ssq_ref[i]);
    img[i] = im.log_ssr;
    img[a.I + i] = im.hh;
  }

  // Phase 1: this CTA's chunk of columns, staged `sub` at a time (the raw
  // rows copied into shared memory, then |p|²·h and |ctf|² in f64 beside
  // them); a pair pass covers up to kG1Threads pairs with `lanes` threads
  // each, a warp's threads on neighbouring pairs (the C rows they read at
  // one column lie in distinct banks).
  const int j0 = b * a.chunk, j1 = min(j0 + a.chunk, nf);
  const int ld = a.sub | 1;  // odd row stride: the C rows read at one column hit distinct banks
  double* hcol = smem + (size_t)R * ld;              // h of each staged column
  float* raw = (float*)(hcol + a.sub);               // (2R, sub): re, im of each row
  const int wl = t & 31, warp = t >> 5;
  const int pp = min(P, kG1Threads), lanes = kG1Threads / pp;
  const int slot = t % pp, lane = t / pp;
  for (int p0 = 0; p0 < P; p0 += pp) {
    const int p = p0 + slot;
    const bool active = lane < lanes && p < P;
    const int o = active ? p / a.C : 0, c = active ? p - o * a.C : 0;
    double acc = 0.0;
    for (int s0 = j0; s0 < j1; s0 += a.sub) {
      const int len = min(a.sub, j1 - s0);
      __syncthreads();  // the previous columns are consumed
      // every row segment in flight at once: a warp per (row, re or im)
      for (int ra = warp; ra < 2 * R; ra += kG1Threads / 32) {
        const int r = ra >> 1;
        const float* src = r < a.O ? ((ra & 1) ? a.pi : a.pr) + (size_t)r * nf
                                   : ((ra & 1) ? a.ctf_im : a.ctf_re) + (size_t)(r - a.O) * nf;
        for (int jj = wl; jj < len; jj += 32) copy_async(raw + (size_t)ra * a.sub + jj, src + s0 + jj);
      }
      for (int jj = t; jj < len; jj += kG1Threads) hcol[jj] = a.h[(s0 + jj) % a.F];
      copy_async_wait();
      __syncthreads();
      for (int r = warp; r < R; r += kG1Threads / 32) {
        const float* re = raw + (size_t)2 * r * a.sub;
        for (int jj = wl; jj < len; jj += 32) {
          const double m2 = mag2(re[jj], re[a.sub + jj]);
          smem[r * ld + jj] = r < a.O ? __dmul_rn(m2, hcol[jj]) : m2;
        }
      }
      __syncthreads();
      if (active) {
        const double* mp = smem + o * ld;
        const double* mc = smem + (a.O + c) * ld;
#pragma unroll 4
        for (int jj = lane; jj < len; jj += lanes) acc = __dadd_rn(acc, __dmul_rn(mp[jj], mc[jj]));
      }
    }
    // the lanes' shares of each pair, added in lane order
    __syncthreads();
    if (active) smem[lane * pp + slot] = acc;
    __syncthreads();
    if (t < pp && p0 + t < P) {
      double tot = smem[t];
      for (int l = 1; l < lanes; ++l) tot = __dadd_rn(tot, smem[l * pp + t]);
      partials[(size_t)b * P + p0 + t] = tot;
    }
  }

  // The ticket: the last `workers` CTAs of this launch to arrive wait for
  // the rest. One thread fences after the barrier (a fence is cumulative: it
  // orders the CTA's writes before the barrier too) and takes a ticket; the
  // ticket counts every arrival since the workspace was made, so launch L's
  // tickets are L·grid ... (L + 1)·grid − 1 (launches on one workspace are
  // stream-ordered) and nothing is reset. A worker's thread 0 then waits
  // with acquire loads.
  __syncthreads();
  if (t == 0) {
    __threadfence();
    const unsigned long long tk = atomicAdd(a.ticket, 1ull);
    const unsigned long long done = (tk / grid + 1) * grid;
    const int rank = (int)(tk % grid) - (grid - a.workers);
    if (rank >= 0)
      while (load_acquire(a.ticket) < done) {
      }
    s_rank = rank;
  }
  __syncthreads();
  const int rank = s_rank;
  if (rank < 0) return;

  // Phase 2: pairs [q0, q1) of this worker, in tiles of up to kG1Threads.
  const int q0 = rank * a.per_worker, q1 = min(q0 + a.per_worker, P);
  PairConsts* pc = (PairConsts*)smem;        // kG1Threads
  double* pri = (double*)(pc + kG1Threads);  // kG1Threads
  int* live = (int*)(pri + kG1Threads);      // kG1Threads
  const double a_coef = __dmul_rn(__dsub_rn(3.0, a.ntot), 0.5);
  const float ntot32 = __double2float_rn(a.ntot);
  for (int e0 = q0; e0 < q1; e0 += kG1Threads) {
    // the tile's np pairs, each with nl neighbouring threads
    const int np = min(kG1Threads, q1 - e0), nl = pair_lanes(np);
    const int ps = t / nl, pl = t % nl;
    const bool lead = ps < np && pl == 0;
    // Everything the tile reads from memory, in one round trip: this
    // thread's share of the partials, its pair's DC terms, prior and mask,
    // and its first entry's image values.
    float d_pr = 0.f, d_pi = 0.f, d_cr = 0.f, d_ci = 0.f;
    double d_pri = 0.0;
    int d_live = 0;
    if (lead) {
      const int p = e0 + ps, o = p / a.C, c = p - o * a.C;
      const size_t ro = (size_t)o * nf, rc = (size_t)c * nf;
      d_pr = a.pr[ro];
      d_pi = a.pi[ro];
      d_cr = a.ctf_re[rc];
      d_ci = a.ctf_im[rc];
      d_pri = a.prior[c];
      d_live = a.mask[o] != 0;
    }
    ImageConsts im_first{0.0, 0.0};
    float sr_first = 0.f, ssr_first = 0.f;
    if (t < np * a.I) {
      const int i = t % a.I;
      im_first = ImageConsts{__ldcg(img + i), __ldcg(img + a.I + i)};
      sr_first = a.sum_ref[i];
      ssr_first = a.ssq_ref[i];
    }
    // the lane's partials cb = pl, pl + nl, ...: the first kTailLoads in
    // registers, their loads issued together
    double part[kTailLoads];
#pragma unroll
    for (int u = 0; u < kTailLoads; ++u) {
      const int cb = pl + u * nl;
      part[u] = ps < np && cb < grid ? __ldcg(partials + (size_t)cb * P + e0 + ps) : 0.0;
    }
    double tot = 0.0;
#pragma unroll
    for (int u = 0; u < kTailLoads; ++u)
      if (pl + u * nl < grid) tot = __dadd_rn(tot, part[u]);
    if (ps < np)
      for (int cb = pl + kTailLoads * nl; cb < grid; cb += nl)
        tot = __dadd_rn(tot, __ldcg(partials + (size_t)cb * P + e0 + ps));
    tot = lanes_sum(tot, nl);
    __syncthreads();  // the previous tile's table is consumed
    if (lead) {
      const int p = e0 + ps;
      const float sc = dc_term(d_pr, d_pi, d_cr, d_ci);
      const float ssc = __double2float_rn(__ddiv_rn(tot, a.ntot));
      a.sum_c[p] = sc;
      a.ssq_c[p] = ssc;
      pc[ps] = pair_consts(sc, ssc, a.ntot);
      pri[ps] = d_pri;
      live[ps] = d_live;
    }
    __syncthreads();
    // the tile's (o, c, i) entries are contiguous in the outputs
    const size_t base = (size_t)e0 * a.I;
    for (int e = t; e < np * a.I; e += kG1Threads) {
      const int q = e / a.I, i = e - q * a.I;
      const bool first = e == t;
      const ImageConsts im = first ? im_first : ImageConsts{__ldcg(img + i), __ldcg(img + a.I + i)};
      const float sr = first ? sr_first : a.sum_ref[i], ssr = first ? ssr_first : a.ssq_ref[i];
      const size_t at = base + e;
      entry(pc[q], im, sr, ssr, pri[q], live[q] != 0, a.normalized, a.ntot, a.ln_ntot, a_coef,
            ntot32, a.f0 + at, a.k + at, a.a_u + at, a.b_u + at);
    }
  }
}

// ---------------------------------------------------------------------------
// G2: one CTA per image, one thread per (o, c) pair
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kG2MaxThreads) merge_block_kernel(const MergeArgs a) {
  extern __shared__ double lm_s[];  // (P) logmax, then (P) se, then (D) disp
  __shared__ double w_val[kG2MaxThreads / 32], w_sum[kG2MaxThreads / 32];
  __shared__ int w_idx[kG2MaxThreads / 32];
  __shared__ double s_c0;
  const int t = threadIdx.x, nt = blockDim.x, lane = t & 31, warp = t >> 5, nw = nt >> 5;
  const int i = blockIdx.x, P = a.O * a.C;
  float* se_s = (float*)(lm_s + P);
  int* disp_s = (int*)(se_s + P);

  double t0 = 0.0, c0 = 0.0;
  if (t == 0) {
    t0 = a.total[i];
    c0 = a.cnst[i];
    s_c0 = c0;
  }
  for (int d = t; d < a.D; d += nt) disp_s[d] = a.disp[d];

  // each pair's varying max, once
  double mx = -(double)INFINITY;
  int best = kNoIndex;
  // and what the tuple needs of this thread's best pair (the block's best
  // is its thread's best), every load of a pair issued before its
  // arithmetic
  double b_sc = 0.0, b_ssc = 0.0, b_cc = 0.0;
  int b_d = 0;
  for (int p = t; p < P; p += nt) {
    const size_t at = (size_t)p * a.I + i;
    const double kk = a.k[at], cc = a.ccs[at], sc = a.sum_c[p], ssc = a.ssq_c[p];
    const float se = a.se[at];
    const int d = a.ds[at];
    const double mv = varying_max(a, p, i, at);
    const double lm = __dadd_rn(kk, mv);
    if (a.m_out != nullptr) a.m_out[at] = mv;
    lm_s[p] = lm;
    se_s[p] = se;
    if (better(lm, p, mx, best)) {
      mx = lm;
      best = p;
      b_sc = sc;
      b_ssc = ssc;
      b_cc = cc;
      b_d = d;
    }
  }
  const int mine = best;
  // max and first-occurrence argmax: a strict order, so the tree's shape
  // does not matter
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const double ov = __shfl_xor_sync(kFull, mx, off);
    const int oi = __shfl_xor_sync(kFull, best, off);
    if (better(ov, oi, mx, best)) {
      mx = ov;
      best = oi;
    }
  }
  if (lane == 0) {
    w_val[warp] = mx;
    w_idx[warp] = best;
  }
  __syncthreads();
  mx = w_val[0];
  best = w_idx[0];
  for (int w = 1; w < nw; ++w)
    if (better(w_val[w], w_idx[w], mx, best)) {
      mx = w_val[w];
      best = w_idx[w];
    }

  // Σ se·ex in f64: each thread's pairs in order, a butterfly per warp,
  // the warps in order
  double s = 0.0;
  for (int p = t; p < P; p += nt) s = __dadd_rn(s, weighted(se_s[p], lm_s[p], mx));
  s = warp_sum(s);
  if (lane == 0) w_sum[warp] = s;
  __syncthreads();
  if (t == 0) {
    double block_sum = w_sum[0];
    for (int w = 1; w < nw; ++w) block_sum = __dadd_rn(block_sum, w_sum[w]);
    lse_fold(t0, c0, block_sum, mx, a.total + i, a.cnst + i);
  }
  // the tuple, by the best pair's thread (strict >, reference
  // bioem_algorithm.h:96)
  if (mine == best && mx > s_c0) write_tuple(a, best, i, b_sc, b_ssc, b_cc, b_d, disp_s);

  if (a.ang_total == nullptr) return;
  // Per-(image, orientation) accumulation (bioem_algorithm.h:130-141):
  // each orientation's C pairs (contiguous, oc = o·C + c) reduce as a
  // segment of W lanes, nt / W orientations at a time, into the slab's
  // column ang_offset + o. The wrapper raises on an int offset whose block
  // does not fit the slab, as the plain version's index_copy_ does; a
  // device offset out of range is the caller's fault, and its columns are
  // not written (no write outside the slab).
  const long long a0 = *a.ang_offset;
  int W = 1;
  while (W < a.C && W < 32) W <<= 1;
  const int segs = nt / W, l = t % W;
  for (int ob = 0; ob < a.O; ob += segs) {  // the same trip count in every thread
    const int o = ob + t / W;
    const bool valid = o < a.O;
    const long long col = a0 + o;
    const bool writes = valid && l == 0 && col >= 0 && col < a.n_cols;
    double tp = 0.0, cp = 0.0;
    if (writes) {
      tp = a.ang_total[(size_t)i * a.n_cols + col];
      cp = a.ang_const[(size_t)i * a.n_cols + col];
    }
    double am = -(double)INFINITY;
    if (valid)
      for (int c = l; c < a.C; c += W) am = nan_max(lm_s[o * a.C + c], am);
    for (int off = W >> 1; off > 0; off >>= 1) am = nan_max(am, __shfl_xor_sync(kFull, am, off));
    double as = 0.0;
    if (valid)
      for (int c = l; c < a.C; c += W) {
        const int oc = o * a.C + c;
        as = __dadd_rn(as, weighted(se_s[oc], lm_s[oc], am));
      }
    for (int off = W >> 1; off > 0; off >>= 1) as = __dadd_rn(as, __shfl_xor_sync(kFull, as, off));
    if (writes)
      lse_fold(tp, cp, as, am, a.ang_total + (size_t)i * a.n_cols + col,
               a.ang_const + (size_t)i * a.n_cols + col);
  }
}

size_t merge_smem_bytes(int P, int D) {
  return (size_t)P * (sizeof(double) + sizeof(float)) + (size_t)D * sizeof(int);
}

size_t constants_smem_bytes(int O, int C, int sub) {
  const size_t stage = (size_t)(O + C) * (sub | 1) * sizeof(double) + (size_t)sub * sizeof(double) +
                       (size_t)2 * (O + C) * sub * sizeof(float);
  const size_t tail = (size_t)kG1Threads * (sizeof(double) + sizeof(PairConsts) + sizeof(int));
  return stage > tail ? stage : tail;
}

int allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

extern "C" {

// The plan (grid, chunk, sub, workers, per_worker) must cover the shapes:
// grid·chunk ≥ N·F > (grid − 1)·chunk, workers ≤ grid, workers·per_worker ≥
// O·C; ws holds grid·O·C + 2·I doubles, and ticket a 64-bit count that only
// G1 launches of this plan have changed since it was 0.
int bioem_block_constants(const float* pr, const float* pi, const float* ctf_re,
                          const float* ctf_im, const float* h, const float* sum_ref,
                          const float* ssq_ref, const double* prior, const int* mask, int O, int C,
                          int I, int N, int F, double ntot, double ln_ntot, int normalized,
                          int grid, int chunk, int sub, int workers, int per_worker, double* ws,
                          unsigned long long* ticket, float* sum_c, float* ssq_c, double* f0, double* k,
                          float* a_u, float* b_u, void* stream) {
  const long long nf = (long long)N * F, P = (long long)O * C;
  if (O < 1 || C < 1 || I < 0 || N < 1 || F < 1 || nf > 0x7fffffffLL || P > 0x7fffffffLL ||
      grid < 1 || chunk < 1 || sub < 1 || (long long)grid * chunk < nf ||
      (long long)(grid - 1) * chunk >= nf || workers < 1 || workers > grid || per_worker < 1 ||
      (long long)workers * per_worker < P || (long long)(workers - 1) * per_worker >= P)
    return (int)cudaErrorInvalidValue;
  const size_t bytes = constants_smem_bytes(O, C, sub);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  const int err = allow_smem((const void*)block_constants_kernel, bytes);
  if (err) return err;
  const ConstantsArgs a{pr, pi, ctf_re, ctf_im, h, sum_ref, ssq_ref, prior, mask, O, C, I, N, F,
                        ntot, ln_ntot, normalized, chunk, sub, workers, per_worker, ws, ticket,
                        sum_c, ssq_c, f0, k, a_u, b_u};
  block_constants_kernel<<<grid, kG1Threads, bytes, (cudaStream_t)stream>>>(a);
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
  const int P = O * C;
  const size_t bytes = merge_smem_bytes(P, D);
  if (bytes > 227 * 1024) return (int)cudaErrorInvalidValue;
  int err = allow_smem((const void*)merge_block_kernel, bytes);
  if (err) return err;
  const MergeArgs a{m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp, orient_offset,
                    ang_offset, O, C, I, D, n_cols, ntot, (3.0 - ntot) * 0.5, total, cnst,
                    best_orient, best_conv, best_cx, best_cy, best_norm, best_mu, ang_total,
                    ang_const, m_out};
  const int threads = P >= kG2MaxThreads ? kG2MaxThreads : (P + 31) / 32 * 32;
  merge_block_kernel<<<I, threads, bytes, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"

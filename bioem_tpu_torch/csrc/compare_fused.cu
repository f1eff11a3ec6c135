// Per-image fused comparison kernel (K1) for Hopper (sm_90a): stage 1 of
// the displacement-lattice DFT on warpgroup wgmma in 3xTF32, conv formed
// once per orientation·CTF. In its cc-out body the same kernel is the
// cc-lattice kernel K3.
//
// Replaces bioem_tpu/ops/compare_pallas.py:_fused_block_kernel (with
// _vector_lse and the _cc_tile_* bodies, entry fused_compare_block) and,
// as K3, _fused_cc_kernel (entry fused_displacement_cc: the lattice cc of
// a conv bank given as (OC, N, F), written to (OC, I, D, D)).
// Per (orientation·ctf oc, image i):
//   conv = proj[o] ⊙ conj(ctf[c]),  p = fold(conv ⊙ img[i])   (M = N/n_fold, F)
//   t1   = wx · p                                              (D, F) complex
//   cc   = Re(t1 · wyᵀ),  v = a_coef · log1p(a_u·cc − b_u·cc²)
//   out  = (max v, Σ exp(v − max), first-occurrence flat argmax d·D+e, cc there)
// Only m is the raw f32 max; the engine repairs it in f64.
//
// What bounds it on the card. Stage 1 is 8·D·M·F real multiply-adds per
// comparison, three times over in 3xTF32 on the tensor cores (0.05 ms of
// TF32 peak at the production block O=8, C=8, I=64, N=224, D=21,
// n_fold=2); p (6·N·F), stage 2 (4·D²·F) and the log-sum-exp are f32 on
// the CUDA cores. The earlier design (FP32 FMA, one CTA per (oc, image), conv
// re-formed from three spectra by every CTA: ~2.5 GB of L2 reads per
// block) took 1.03 ms; stage 1 on the CUDA cores was half of it. K3 does
// the same stage 1 (3 × 8.71e9 TF32 operations per production block,
// 0.053 ms), no conv product and no log-sum-exp (1.54e9 f32 operations,
// 0.023 ms), and writes the lattice (7.2 MB) beside reading ~26 MB of
// spectra: 0.076 ms, operations-bound.
//
// Design.
// * Two kernels in one launch of the entry point. A prologue forms the conv
//   bank (OC, N, Fp) once per oc, as interleaved complex rows padded with
//   zeros to Fp = 64·⌈F/64⌉ (16-byte aligned rows), and W = [[wx_re,
//   −wx_im], [wx_im, wx_re]] split hi/lo in TF32, cut into (N chunk, K
//   chunk) blocks already in wgmma's shared-memory layout. Both go to
//   scratch the wrapper allocates; the main kernel only copies them.
// * Roles. t1ᵀ (frequencies × 2Dp) = pᵀ (frequencies × 2M) · Wᵀ: 64
//   frequencies of one image are wgmma's M (an m-tile; F = 113 gives two),
//   a chunk of NP = 2·dc stacked t1 rows (dc lattice rows, re then im) its
//   N (n16…n64; wider lattices loop over ⌈Dp/32⌉ N chunks), so p is formed
//   straight into registers as the A fragment. A k8 step holds four folded
//   rows j, real parts at k = 0..3 and imaginary parts at k = 4..7.
// * conv shared by the images of a CTA. A CTA takes one oc and n_wg
//   consecutive images, one per warpgroup (a run of images ends where I
//   ends: the last CTA's idle warpgroups compute on a copy and write
//   nothing). For each K chunk of KC steps the CTA copies W's block and
//   the conv rows of the chunk (all folds, the m-tile's 64 frequencies)
//   into shared memory with cp.async, a chunk ahead of their use (double
//   buffers, one block barrier per chunk); every warpgroup forms its p
//   from that conv and its own image's rows, loaded into registers a step
//   ahead. W streams through shared memory, so neither D nor M is bounded
//   by a resident W.
// * Overlap. Each warpgroup issues a step's three products asynchronously
//   and forms the next step's fragments while they run.
// * Accuracy. Each operand is split x = hi + lo (hi = tf32(x), lo =
//   tf32(x − hi)); a step forms lo·hi + hi·lo + hi·hi in a zeroed
//   accumulator and adds it to the f32 sum with IEEE adds (K4's scheme:
//   the tensor cores truncate when they accumulate).
// * Stage 2 (cc = Re(t1·wyᵀ)) on the CUDA cores: a warpgroup writes its
//   m-tile's t1 chunk to shared memory; thread (warp w, lane l) sums the
//   lattice columns e ≡ l (mod 32) of rows d = dc·chunk + w·dc/4 + r over
//   the m-tile (re and im terms apart, as K1 always did) into the image's
//   cc lattice in shared memory (D² floats per warpgroup).
// * The log-sum-exp (compare_lse.cuh) over the lattice by the warpgroup's
//   128 threads. No atomics: two launches on the same inputs give the
//   same bits.
// * Shared memory: W and conv double buffers, the t1 tiles, wy and the
//   lattices. The wrapper (ops/compare_cuda.k1_plan) picks the largest K
//   chunk, with four warpgroups and then two, that fits a block; its
//   formula is bioem_fused_compare_smem_bytes below.
// * K3 (body kCcOut) runs all of the above but the log-sum-exp: its
//   prologue copies the conv bank it is given into the padded interleaved
//   scratch instead of forming it, and each warpgroup writes its image's
//   lattice from shared memory to out_cc[(oc·I + i)·D² + q], coalesced.
//   It takes every shape K1 takes, with K1's tiling.
// The body variant V is kFull (K1) or kCcOut (K3) in production; the
// ablation probe P3 instantiates the others at NP = 48 with four
// warpgroups only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compare_lse.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = bioem_wgmma;
using bioem_lse::kCcOut;
using bioem_lse::kFull;
using bioem_lse::kMmOnly;
using bioem_lse::kNoGemm;
using bioem_lse::kNoLse;

constexpr int kMT = 64;     // frequencies per m-tile (wgmma M)
constexpr int kLdF = 68;    // stride of a staged conv row (float2): conflict-free
                            // fragment reads (rows t = 0..3 land 8 banks apart)
constexpr int kPrepThreads = 256;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// The tiling of a problem, the same on the host and in the kernels.
struct Plan {
  int D, M, F, n_fold, n_wg, KC;
  int Dp, n_nc, dc, NP, n_ks, n_kc, n_mt, Fp;
  size_t w_chunk, cv_chunk;             // bytes of one W block, one conv chunk
  size_t w, cv, t1, wy, cc, bytes;      // shared-memory offsets and total
  size_t scratch_w;                     // bytes of the W blocks in scratch
};

__host__ __device__ inline Plan plan(int D, int M, int F, int n_fold, int n_wg, int KC) {
  Plan P;
  P.D = D, P.M = M, P.F = F, P.n_fold = n_fold, P.n_wg = n_wg, P.KC = KC;
  P.Dp = (D + 7) / 8 * 8;
  P.n_nc = (P.Dp + 31) / 32;
  P.dc = ((P.Dp + P.n_nc - 1) / P.n_nc + 7) / 8 * 8;
  P.NP = 2 * P.dc;
  P.n_ks = (M + 3) / 4;
  P.n_kc = (P.n_ks + KC - 1) / KC;
  P.n_mt = (F + kMT - 1) / kMT;
  P.Fp = P.n_mt * kMT;
  P.w_chunk = (size_t)2 * P.NP * 32 * KC;  // hi then lo, NP rows × 32·KC bytes
  P.cv_chunk = sizeof(float2) * (size_t)KC * n_fold * 4 * kLdF;
  P.w = 0;
  P.cv = P.w + 2 * P.w_chunk;
  P.t1 = P.cv + 2 * align128(P.cv_chunk);
  P.wy = P.t1 + align128(sizeof(float) * (size_t)n_wg * kMT * (P.NP + 4));
  P.cc = P.wy + align128(sizeof(float2) * (size_t)D * F);
  P.bytes = P.cc + align128(sizeof(float) * (size_t)n_wg * D * D);
  P.scratch_w = P.w_chunk * P.n_nc * P.n_kc;
  return P;
}

// ---------------------------------------------------------------------------
// cp.async (16 bytes; src_bytes = 0 writes zeros)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Prologue: the conv bank and the W blocks
// ---------------------------------------------------------------------------

// CONV_IN (K3): proj_re/proj_im hold the conv bank (OC, N, F) itself, which
// is copied; otherwise conv = proj[o] ⊙ conj(ctf[c]) is formed (K1).
template <bool CONV_IN>
__global__ void __launch_bounds__(kPrepThreads)
compare_fused_prep_kernel(const float* __restrict__ proj_re, const float* __restrict__ proj_im,
            const float* __restrict__ ctf_re, const float* __restrict__ ctf_im,
            const float* __restrict__ wx_re, const float* __restrict__ wx_im, Plan P, int C,
            int OC, int N, float2* __restrict__ conv, unsigned char* __restrict__ wblk) {
  const size_t n_conv = (size_t)OC * N * P.Fp;
  const size_t n_w = (size_t)P.n_nc * P.n_kc * P.NP * 8 * P.KC;
  const size_t NF = (size_t)N * P.F;
  for (size_t q = (size_t)blockIdx.x * kPrepThreads + threadIdx.x; q < n_conv + n_w;
       q += (size_t)gridDim.x * kPrepThreads) {
    if (q < n_conv) {
      const int f = (int)(q % P.Fp);
      const size_t rq = q / P.Fp;
      const int r = (int)(rq % N), oc = (int)(rq / N);
      float2 v = make_float2(0.f, 0.f);
      if (CONV_IN && f < P.F) {
        const size_t ci = (size_t)oc * NF + (size_t)r * P.F + f;
        v = make_float2(proj_re[ci], proj_im[ci]);
      } else if (f < P.F) {
        const int o = oc / C, c = oc - (oc / C) * C;
        const size_t pi = o * NF + (size_t)r * P.F + f, ki = c * NF + (size_t)r * P.F + f;
        const float xr = proj_re[pi], xi = proj_im[pi], kr = ctf_re[ki], ki_ = ctf_im[ki];
        v = make_float2(xr * kr + xi * ki_, xi * kr - xr * ki_);
      }
      conv[q] = v;
      continue;
    }
    // W block (nc, kc): row n < dc is t1_re[d], row dc + d' is t1_im[d];
    // column 8s + u (u < 4) multiplies Re p[4(kc·KC + s) + u], 8s + 4 + u
    // its Im. Rows d ≥ D and folded rows j ≥ M are zero.
    const size_t qw = q - n_conv;
    const int per_row = 8 * P.KC;
    const int kp = (int)(qw % per_row);
    const size_t rq = qw / per_row;
    const int n = (int)(rq % P.NP);
    const size_t blk = rq / P.NP;  // nc · n_kc + kc
    const int kc = (int)(blk % P.n_kc), nc = (int)(blk / P.n_kc);
    const int j = 4 * (kc * P.KC + (kp >> 3)) + (kp & 3);
    const bool im_col = (kp & 7) >= 4, im_row = n >= P.dc;
    const int d = nc * P.dc + (im_row ? n - P.dc : n);
    float v = 0.f;
    if (d < P.D && j < P.M) {
      const float wr = wx_re[d * P.M + j], wi = wx_im[d * P.M + j];
      v = im_row ? (im_col ? wr : wi) : (im_col ? -wi : wr);
    }
    const uint32_t hi = wg::to_tf32(v);
    const uint32_t kb = 32 * P.KC;
    unsigned char* b = wblk + blk * P.w_chunk;
    const uint32_t off = wg::offset_km(n, 4 * kp, kb);
    *reinterpret_cast<uint32_t*>(b + off) = hi;
    *reinterpret_cast<uint32_t*>(b + (size_t)P.NP * kb + off) =
        wg::to_tf32(v - __uint_as_float(hi));
  }
}

// ---------------------------------------------------------------------------
// The main kernel
// ---------------------------------------------------------------------------

// acc ← lo·W_hi + hi·W_lo + hi·W_hi for step s of the staged W block
// (acc's old value is not read), issued asynchronously.
template <int NP>
__device__ __forceinline__ void chain(float (&acc)[NP / 2], const uint32_t (&hi)[4],
                                      const uint32_t (&lo)[4], const unsigned char* w, int s,
                                      uint32_t kb) {
  const uint64_t dh = wg::desc(w + 256 * s, 128, 8 * kb);
  const uint64_t dl = wg::desc(w + (size_t)NP * kb + 256 * s, 128, 8 * kb);
  wg::fence();
  wg::Tf32RS<NP>::mma(acc, lo, dh, 0);
  wg::Tf32RS<NP>::mma(acc, hi, dl, 1);
  wg::Tf32RS<NP>::mma(acc, hi, dh, 1);
  wg::commit();
}

// Sum of one float per thread of a warpgroup, returned to thread 0 of it.
__device__ __forceinline__ float wg_sum(float s, float* red, int bar) {
  const int wt = threadIdx.x & 127;
  s = bioem_lse::warp_sum(s);
  if ((wt & 31) == 0) red[wt >> 5] = s;
  wg::wg_barrier(bar);
  return red[0] + red[1] + red[2] + red[3];
}

template <int NP, int NWG, int V>
__global__ void __launch_bounds__(128 * NWG, 1)
compare_fused_kernel(const float2* __restrict__ conv, const unsigned char* __restrict__ wblk,
                     const float* __restrict__ img_re, const float* __restrict__ img_im,
                     const float* __restrict__ wy_re, const float* __restrict__ wy_im,
                     const float* __restrict__ a_u, const float* __restrict__ b_u,
                     float a_coef, Plan P, int I, int N, float* __restrict__ out_m,
                     float* __restrict__ out_se, int* __restrict__ out_ds,
                     float* __restrict__ out_ccs) {
  constexpr int kThreads = 128 * NWG;
  constexpr int NA = NP / 2;  // accumulator floats per thread
  constexpr int DR = NP / 8;  // stage-2 lattice rows per thread (dc / 4)
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ float red_v[NWG][4], red_s[NWG][4];
  __shared__ int red_i[NWG][4];

  const int D = P.D, M = P.M, F = P.F, n_fold = P.n_fold, DD = D * D;
  const int dc = P.dc, KC = P.KC, n_ks = P.n_ks, ldt = NP + 4;
  const uint32_t kb = 32 * KC;
  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, warp = wt >> 5, g = lane >> 2, t = lane & 3;
  const int bar = 1 + wgi;

  unsigned char* wbuf = smem + P.w;
  float2* cvbuf = reinterpret_cast<float2*>(smem + P.cv);
  const size_t cv_stride = align128(P.cv_chunk) / sizeof(float2);
  float* t1w = reinterpret_cast<float*>(smem + P.t1) + (size_t)wgi * kMT * ldt;
  float2* wys = reinterpret_cast<float2*>(smem + P.wy);
  float* ccw = reinterpret_cast<float*>(smem + P.cc) + (size_t)wgi * DD;

  const int oc = blockIdx.y;
  const int i_raw = blockIdx.x * NWG + wgi;
  const bool has = i_raw < I;  // warpgroup-uniform: the last run may end early
  const int i = has ? i_raw : I - 1;
  const size_t NF = (size_t)N * F;
  const float* ir_p = img_re + (size_t)i * NF;
  const float* ii_p = img_im + (size_t)i * NF;
  const float2* conv_oc = conv + (size_t)oc * N * P.Fp;

  if constexpr (V != kMmOnly) {
    for (int q = tid; q < F * D; q += kThreads) {
      const int f = q / D, e = q - f * D;
      wys[q] = make_float2(wy_re[e * F + f], wy_im[e * F + f]);
    }
  }

  // Copy K chunk kc (of N chunk nc, m-tile at frequency fb) into buffer b:
  // W's block, and conv rows j + k·M (j = 4·step + u) as [step][k][u][kLdF].
  auto issue = [&](int nc, int kc, int fb, int b) {
    const unsigned char* src = wblk + ((size_t)nc * P.n_kc + kc) * P.w_chunk;
    unsigned char* dst = wbuf + (size_t)b * P.w_chunk;
    for (size_t q = (size_t)tid * 16; q < P.w_chunk; q += (size_t)kThreads * 16)
      cp16(dst + q, src + q, true);
    if constexpr (V != kMmOnly) {
      float2* cdst = cvbuf + (size_t)b * cv_stride;
      const int n_rows = KC * n_fold * 4;
      for (int q = tid; q < n_rows * (kMT / 2); q += kThreads) {
        const int row = q / (kMT / 2), c2 = q - row * (kMT / 2);  // two frequencies per copy
        const int s = row / (4 * n_fold), k = (row / 4) % n_fold, u = row & 3;
        const int j = 4 * (kc * KC + s) + u;
        const bool ok = j < M;
        const float2* src_row = conv_oc + (size_t)(ok ? j + k * M : 0) * P.Fp + fb + 2 * c2;
        cp16(cdst + (size_t)row * kLdF + 2 * c2, src_row, ok);
      }
    }
    cp_commit();
  };

  float chk = 0.f;  // the ablated bodies' checksum
  for (int nc = 0; nc < P.n_nc; ++nc) {
    for (int mt = 0; mt < P.n_mt; ++mt) {
      const int fb = mt * kMT;
      // This thread's fragment rows: frequencies f0 and f0 + 8 of its image.
      const int f0 = fb + 16 * warp + g, f1 = f0 + 8;
      const bool v0 = f0 < F, v1 = f1 < F;

      // The image values of folds 0 and 1 of step s (re, im at f0, then at
      // f1), loaded a step before their use.
      auto img_pre = [&](int s, float (&pre)[8]) {
        const int j = 4 * s + t;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const bool ok = k < n_fold && j < M;
          const size_t row = (size_t)(j + k * M) * F;
          pre[4 * k + 0] = ok && v0 ? ir_p[row + f0] : 0.f;
          pre[4 * k + 1] = ok && v0 ? ii_p[row + f0] : 0.f;
          pre[4 * k + 2] = ok && v1 ? ir_p[row + f1] : 0.f;
          pre[4 * k + 3] = ok && v1 ? ii_p[row + f1] : 0.f;
        }
      };
      // Fragment of local step s of the chunk in buffer cb (global step
      // gs): Re p(j, f0), Re p(j, f1), Im p(j, f0), Im p(j, f1), j = 4gs + t,
      // split into TF32 hi and lo. Folds past the second (a lattice stride
      // above 2) load their image values here.
      auto frag_form = [&](const float2* cb, int s, int gs, const float (&pre)[8],
                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        const int j = 4 * gs + t;
        const int cl = 16 * warp + g;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        auto add = [&](const float2* row, float ir0, float ii0, float ir1, float ii1) {
          const float2 c0 = row[cl], c1 = row[cl + 8];
          x[0] += c0.x * ir0 - c0.y * ii0;
          x[2] += c0.x * ii0 + c0.y * ir0;
          x[1] += c1.x * ir1 - c1.y * ii1;
          x[3] += c1.x * ii1 + c1.y * ir1;
        };
        const float2* rows = cb + (size_t)(s * n_fold * 4 + t) * kLdF;  // fold k: + 4k·kLdF
        add(rows, pre[0], pre[1], pre[2], pre[3]);
        if (n_fold > 1) add(rows + 4 * kLdF, pre[4], pre[5], pre[6], pre[7]);
        for (int k = 2; k < n_fold; ++k) {
          const bool ok = j < M;
          const size_t r = (size_t)(j + k * M) * F;
          add(rows + 4 * k * kLdF, ok && v0 ? ir_p[r + f0] : 0.f, ok && v0 ? ii_p[r + f0] : 0.f,
              ok && v1 ? ir_p[r + f1] : 0.f, ok && v1 ? ii_p[r + f1] : 0.f);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = wg::to_tf32(x[e]);
          lo[e] = wg::to_tf32(x[e] - __uint_as_float(hi[e]));
        }
      };

      float sum[NA], acc[NA], pre[8];
#pragma unroll
      for (int r = 0; r < NA; ++r) sum[r] = acc[r] = 0.f;
      uint32_t ha[4], la[4], hb[4], lb[4];
      if constexpr (V == kMmOnly) {
        // Operands formed once: the raw image spectrum, unsplit.
        const int j = t < M ? t : 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (e & 1) ? v1 : v0;
          ha[e] = wg::to_tf32(ok ? ((e & 2) ? ii_p : ir_p)[(size_t)j * F + ((e & 1) ? f1 : f0)]
                                 : 0.f);
        }
      } else {
        img_pre(0, pre);
      }
      issue(nc, 0, fb, 0);
      for (int kc = 0; kc < P.n_kc; ++kc) {
        if (kc + 1 < P.n_kc) {
          issue(nc, kc + 1, fb, (kc + 1) & 1);
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        wg::fence_proxy_async();
        __syncthreads();  // chunk kc is in buffer kc & 1 for every thread
        const unsigned char* wb = wbuf + (size_t)(kc & 1) * P.w_chunk;
        const float2* cb = cvbuf + (size_t)(kc & 1) * cv_stride;
        const int s0 = kc * KC;
        const int ns = n_ks - s0 < KC ? n_ks - s0 : KC;
        if constexpr (V == kMmOnly) {
          for (int s = 0; s < ns; ++s) {
            chain<NP>(acc, ha, ha, wb, s, kb);
            wg::wait<0>();
            wg::fence_operand(acc);
#pragma unroll
            for (int r = 0; r < NA; ++r) sum[r] += acc[r];
          }
        } else {
          // Step s: issue its products; while they run, form step s + 1
          // (and load the image values of step s + 2); then add the
          // products to the sum. Unrolled by two so that each step's
          // fragments are fixed registers, read by wgmma until its wait.
          auto form = [&](int s, uint32_t (&hn)[4], uint32_t (&ln)[4]) {
            frag_form(cb, s, s0 + s, pre, hn, ln);
            if (s0 + s + 1 < n_ks) img_pre(s0 + s + 1, pre);
          };
          auto step = [&](int s, uint32_t (&hc)[4], uint32_t (&lc)[4], uint32_t (&hn)[4],
                          uint32_t (&ln)[4]) {
            if constexpr (V != kNoGemm) chain<NP>(acc, hc, lc, wb, s, kb);
            if (s + 1 < ns) form(s + 1, hn, ln);
            if constexpr (V == kNoGemm) {
              // Keep the formed operands alive without a product: 0·x adds
              // nothing to a finite sum (no fast-math to fold it away).
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sum[e] = fmaf(0.f, __uint_as_float(hc[e]) + __uint_as_float(lc[e]), sum[e]);
            } else {
              wg::wait<0>();
              wg::fence_operand(acc);
#pragma unroll
              for (int r = 0; r < NA; ++r) sum[r] += acc[r];
            }
          };
          form(0, ha, la);
          for (int s = 0; s < ns; s += 2) {
            step(s, ha, la, hb, lb);
            if (s + 1 < ns) step(s + 1, hb, lb, ha, la);
          }
        }
        __syncthreads();  // every warpgroup is done with buffer kc & 1
      }

      if constexpr (V == kMmOnly) {
#pragma unroll
        for (int r = 0; r < NA; ++r) chk += sum[r];
      } else {
        // The warpgroup's t1 chunk (frequency row; columns [0, dc) re,
        // [dc, 2dc) im) to shared memory, then stage 2 on its image:
        // cc[d, e] (+)= Σ_f Re(t1[d, f] · wy[e, f]) over the m-tile.
#pragma unroll
        for (int jj = 0; jj < NP / 8; ++jj) {
          *reinterpret_cast<float2*>(t1w + (16 * warp + g) * ldt + 8 * jj + 2 * t) =
              make_float2(sum[4 * jj], sum[4 * jj + 1]);
          *reinterpret_cast<float2*>(t1w + (16 * warp + g + 8) * ldt + 8 * jj + 2 * t) =
              make_float2(sum[4 * jj + 2], sum[4 * jj + 3]);
        }
        wg::wg_barrier(bar);
        const int fcn = F - fb < kMT ? F - fb : kMT;
        const int dl0 = warp * DR;  // this thread's first chunk row
        for (int e = lane; e < D; e += 32) {
          float sr[DR], si[DR];
#pragma unroll
          for (int r = 0; r < DR; ++r) sr[r] = si[r] = 0.f;
          for (int fl = 0; fl < fcn; ++fl) {
            const float2 w = wys[(fb + fl) * D + e];
            const float* row = t1w + fl * ldt + dl0;
#pragma unroll
            for (int r = 0; r < DR; r += 2) {
              const float2 a = *reinterpret_cast<const float2*>(row + r);
              const float2 b = *reinterpret_cast<const float2*>(row + dc + r);
              sr[r] += a.x * w.x;
              sr[r + 1] += a.y * w.x;
              si[r] += b.x * w.y;
              si[r + 1] += b.y * w.y;
            }
          }
#pragma unroll
          for (int r = 0; r < DR; ++r) {
            const int d = nc * dc + dl0 + r;
            if (d < D) {
              const float v = sr[r] - si[r];
              ccw[d * D + e] = mt == 0 ? v : ccw[d * D + e] + v;
            }
          }
        }
      }
    }
  }

  const size_t oi = (size_t)oc * I + i;
  if constexpr (V == kMmOnly) {
    const float s = wg_sum(chk, red_s[wgi], bar);
    if (wt == 0 && has) out_m[oi] = s;
    return;
  }
  wg::wg_barrier(bar);  // the whole lattice is in ccw
  if constexpr (V == kCcOut) {
    // K3: the lattice out (out_ccs is the (OC, I, D, D) cc tensor)
    if (has) {
      float* dst = out_ccs + oi * DD;
      for (int q = wt; q < DD; q += 128) dst[q] = ccw[q];
    }
    return;
  }
  if constexpr (V == kNoLse) {
    float s = 0.f;
    for (int q = wt; q < DD; q += 128) s += ccw[q];
    s = wg_sum(s, red_s[wgi], bar);
    if (wt == 0 && has) out_m[oi] = s;
    return;
  }

  // Displacement log-sum-exp over the D² lattice.
  const float au = a_u[oi], bu = b_u[oi];
  float best = -INFINITY;
  int bidx = DD;
  for (int q = wt; q < DD; q += 128) {
    const float v = bioem_lse::lattice_value(ccw[q], au, bu, a_coef);
    if (bioem_lse::better(v, q, best, bidx)) {
      best = v;
      bidx = q;
    }
  }
  bioem_lse::warp_argmax(best, bidx);
  if (lane == 0) {
    red_v[wgi][warp] = best;
    red_i[wgi][warp] = bidx;
  }
  wg::wg_barrier(bar);
  if (wt == 0) {
    for (int w = 1; w < 4; ++w)
      if (bioem_lse::better(red_v[wgi][w], red_i[wgi][w], best, bidx)) {
        best = red_v[wgi][w];
        bidx = red_i[wgi][w];
      }
    if (bidx >= DD) bidx = 0;  // every v is −inf: argmax of an all-equal row
    red_v[wgi][0] = best;
    red_i[wgi][0] = bidx;
  }
  wg::wg_barrier(bar);
  const float mx = red_v[wgi][0];
  const int arg = red_i[wgi][0];
  float s = 0.f;
  for (int q = wt; q < DD; q += 128)
    s += expf(bioem_lse::lattice_value(ccw[q], au, bu, a_coef) - mx);
  s = wg_sum(s, red_s[wgi], bar);
  if (wt == 0 && has) {
    out_m[oi] = mx;
    out_se[oi] = s;
    out_ds[oi] = arg;
    out_ccs[oi] = ccw[arg];
  }
}

template <int NP, int NWG, int V = kFull>
int launch(const float* proj_re, const float* proj_im, const float* ctf_re,
           const float* ctf_im, const float* img_re, const float* img_im,
           const float* wx_re, const float* wx_im, const float* wy_re, const float* wy_im,
           const float* a_u, const float* b_u, float a_coef, int O, int C, int I, int N,
           const Plan& P, float* m, float* se, int* ds, float* ccs, void* scratch,
           cudaStream_t stream) {
  const int OC = O * C;
  float2* conv = reinterpret_cast<float2*>(scratch);
  unsigned char* wblk =
      reinterpret_cast<unsigned char*>(scratch) + align128(sizeof(float2) * (size_t)OC * N * P.Fp);
  const size_t n_prep = (size_t)OC * N * P.Fp + (size_t)P.n_nc * P.n_kc * P.NP * 8 * P.KC;
  const size_t blocks = (n_prep + kPrepThreads - 1) / kPrepThreads;
  compare_fused_prep_kernel<V == kCcOut>
      <<<(unsigned)(blocks < 4096 ? blocks : 4096), kPrepThreads, 0, stream>>>(
          proj_re, proj_im, ctf_re, ctf_im, wx_re, wx_im, P, C, OC, N, conv, wblk);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(compare_fused_kernel<NP, NWG, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((I + NWG - 1) / NWG, OC);
  compare_fused_kernel<NP, NWG, V><<<grid, 128 * NWG, P.bytes, stream>>>(
      conv, wblk, img_re, img_im, wy_re, wy_im, a_u, b_u, a_coef, P, I, N, m, se, ds, ccs);
  return (int)cudaGetLastError();
}

bool valid(int D, int M, int F, int n_fold, int n_wg, int KC) {
  return D >= 1 && M >= 1 && F >= 1 && n_fold >= 1 && (n_wg == 2 || n_wg == 4) &&
         (KC == 1 || KC == 2 || KC == 4 || KC == 8);
}

}  // namespace

extern "C" {

// Dynamic shared memory of K1 at (D, M, F, n_fold) with n_wg warpgroups
// and K chunks of KC steps, or 0 for an invalid tiling; the wrapper's
// plan (ops/compare_cuda.k1_plan) uses the same formula.
size_t bioem_fused_compare_smem_bytes(int D, int M, int F, int n_fold, int n_wg, int KC) {
  return valid(D, M, F, n_fold, n_wg, KC) ? plan(D, M, F, n_fold, n_wg, KC).bytes : 0;
}

// Bytes of scratch K1 needs for OC orientation·ctf pairs at N: the conv
// bank and the W blocks.
size_t bioem_fused_compare_scratch_bytes(int OC, int N, int D, int M, int F, int n_fold,
                                         int n_wg, int KC) {
  if (!valid(D, M, F, n_fold, n_wg, KC)) return 0;
  const Plan P = plan(D, M, F, n_fold, n_wg, KC);
  return align128(sizeof(float2) * (size_t)OC * N * P.Fp) + P.scratch_w;
}

#define BIOEM_K1_ARGS                                                                    \
  proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u, b_u, \
      a_coef, O, C, I, N, P, m, se, ds, ccs, scratch, (cudaStream_t)stream

int bioem_fused_compare(const float* proj_re, const float* proj_im, const float* ctf_re,
                        const float* ctf_im, const float* img_re, const float* img_im,
                        const float* wx_re, const float* wx_im, const float* wy_re,
                        const float* wy_im, const float* a_u, const float* b_u,
                        float a_coef, int O, int C, int I, int N, int F, int D, int M,
                        int n_fold, int n_wg, int KC, float* m, float* se, int* ds,
                        float* ccs, void* scratch, void* stream) {
  if (!valid(D, M, F, n_fold, n_wg, KC) || M * n_fold != N) return (int)cudaErrorInvalidValue;
  const Plan P = plan(D, M, F, n_fold, n_wg, KC);
  const int key = P.NP * 10 + n_wg;
  switch (key) {
    case 164: return launch<16, 4>(BIOEM_K1_ARGS);
    case 324: return launch<32, 4>(BIOEM_K1_ARGS);
    case 484: return launch<48, 4>(BIOEM_K1_ARGS);
    case 644: return launch<64, 4>(BIOEM_K1_ARGS);
    case 162: return launch<16, 2>(BIOEM_K1_ARGS);
    case 322: return launch<32, 2>(BIOEM_K1_ARGS);
    case 482: return launch<48, 2>(BIOEM_K1_ARGS);
    case 642: return launch<64, 2>(BIOEM_K1_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// K3: cc[oc, i, d, e] of the conv bank (OC, N, F) against the images, with
// K1's tiling (n_wg, KC) and scratch (bioem_fused_compare_scratch_bytes at
// OC pairs; its shared memory is bioem_fused_compare_smem_bytes).
int bioem_fused_displacement_cc(const float* conv_re, const float* conv_im,
                                const float* img_re, const float* img_im, const float* wx_re,
                                const float* wx_im, const float* wy_re, const float* wy_im,
                                int OC, int I, int N, int F, int D, int M, int n_fold, int n_wg,
                                int KC, float* cc, void* scratch, void* stream) {
  if (!valid(D, M, F, n_fold, n_wg, KC) || M * n_fold != N) return (int)cudaErrorInvalidValue;
  const Plan P = plan(D, M, F, n_fold, n_wg, KC);
  // The prologue copies the bank (one "orientation" per pair, no CTF); the
  // body writes the lattice to ccs and reads no a_u, b_u or a_coef.
  const float *proj_re = conv_re, *proj_im = conv_im, *ctf_re = nullptr, *ctf_im = nullptr;
  const float *a_u = nullptr, *b_u = nullptr;
  const float a_coef = 0.f;
  const int O = OC, C = 1;
  float *m = nullptr, *se = nullptr, *ccs = cc;
  int* ds = nullptr;
  switch (P.NP * 10 + n_wg) {
    case 164: return launch<16, 4, kCcOut>(BIOEM_K1_ARGS);
    case 324: return launch<32, 4, kCcOut>(BIOEM_K1_ARGS);
    case 484: return launch<48, 4, kCcOut>(BIOEM_K1_ARGS);
    case 644: return launch<64, 4, kCcOut>(BIOEM_K1_ARGS);
    case 162: return launch<16, 2, kCcOut>(BIOEM_K1_ARGS);
    case 322: return launch<32, 2, kCcOut>(BIOEM_K1_ARGS);
    case 482: return launch<48, 2, kCcOut>(BIOEM_K1_ARGS);
    case 642: return launch<64, 2, kCcOut>(BIOEM_K1_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel probe P3: body variant ``variant`` (bioem_lse::Body) of the
// production instance (NP = 48: D = 17..24, four warpgroups). kFull is the
// production instance itself; the other variants write a checksum into m
// and nothing else.
int bioem_probe_compare(int variant, const float* proj_re, const float* proj_im,
                        const float* ctf_re, const float* ctf_im, const float* img_re,
                        const float* img_im, const float* wx_re, const float* wx_im,
                        const float* wy_re, const float* wy_im, const float* a_u,
                        const float* b_u, float a_coef, int O, int C, int I, int N, int F,
                        int D, int M, int n_fold, int n_wg, int KC, float* m, float* se,
                        int* ds, float* ccs, void* scratch, void* stream) {
  if (!valid(D, M, F, n_fold, n_wg, KC) || M * n_fold != N) return (int)cudaErrorInvalidValue;
  const Plan P = plan(D, M, F, n_fold, n_wg, KC);
  if (P.NP != 48 || n_wg != 4) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kFull: return launch<48, 4, kFull>(BIOEM_K1_ARGS);
    case kNoLse: return launch<48, 4, kNoLse>(BIOEM_K1_ARGS);
    case kMmOnly: return launch<48, 4, kMmOnly>(BIOEM_K1_ARGS);
    case kNoGemm: return launch<48, 4, kNoGemm>(BIOEM_K1_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}
#undef BIOEM_K1_ARGS

const char* bioem_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

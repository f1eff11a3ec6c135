// Image-batched fused comparison kernel (K4) for Hopper (sm_90a): stage 1
// of the displacement-lattice DFT on warpgroup wgmma in 3xTF32.
//
// Replaces bioem_tpu/ops/compare_pallas.py:_fused_block_kernel_batched
// (entry fused_compare_block(..., batched_stage1=True)). Same contract as
// K1 (compare_fused.cu): per (orientation·ctf oc, image i)
//   conv = proj[o] ⊙ conj(ctf[c]),  p = fold(conv ⊙ img[i])   (M = N/n_fold, F)
//   t1   = wx · p                                              (D, F) complex
//   cc   = Re(t1 · wyᵀ),  v = a_coef · log1p(a_u·cc − b_u·cc²)
//   out  = (max v, Σ exp(v − max), first-occurrence flat argmax, cc there)
// Only m is the raw f32 max; the engine repairs it in f64.
//
// What bounds it on the card. Stage 1 is 8·D·M·F real multiply-adds per
// comparison, three times over in 3xTF32 on the tensor cores; the rest
// (p from three spectra, the fold, stage 2's 4·D²·F, the log-sum-exp) is
// f32 on the CUDA cores. At the production block (O=8, C=8, I=64, N=224,
// D=21, n_fold=2) that is 0.076 ms at the peaks. The earlier design (wmma,
// one CTA per (oc, tile), p staged through shared memory between block
// barriers) took 0.95 ms: its fragment loads and mma.sync issue, and
// forming p serially between barriers, not the peaks, set the time. Here
// the products take ~0.11 ms (the ablation probe P3's mm_only) and forming
// the operands is what remains: each k-step waits on loads from L2 and on
// one warpgroup barrier (latency, not bandwidth: staging the image rows
// once per CTA, which cuts L2 reads ~2.7×, measured no faster).
//
// Design.
// * Roles. The GEMM is t1ᵀ (frequencies × 2Dp) = pᵀ (frequencies × 2M) ·
//   Wᵀ with W = [[wx_re, −wx_im], [wx_im, wx_re]] (2Dp × 2M). The
//   frequencies of four images are wgmma's M (one m64 tile = 16
//   frequencies of each of four images, one image per warp) and the 2·Dp
//   stacked t1 rows its N (n16…n64: D up to 32), so no row of the
//   instruction is padding at D = 21 (2Dp = 48), and p is formed straight
//   into registers as wgmma's A fragment: no shared-memory stage of p. A
//   k8 step holds four folded rows j, the real parts at k = 0..3 and the
//   imaginary parts at k = 4..7, so each thread forms two complex p values
//   per step.
// * W formed once per CTA. W is split hi/lo in TF32 and kept in shared
//   memory (K-major, wgmma.cuh's layout: 2·Dp × 8·⌈M/4⌉ × 8 bytes, 86 KB at
//   the production shape) by persistent CTAs, one per SM, that walk the
//   work items (block of four consecutive oc, group of four images) in a
//   fixed order; warpgroup w of a CTA takes the block's oc w. The image
//   tile IT is only the JAX kernel's contract I % IT = 0: it shapes
//   neither the schedule nor the shared memory (work items of a whole
//   tile of 16 images left half the SMs idle).
// * Reach. W resident in shared memory and one lane per lattice column
//   bound the instances to D ≤ 32 and to problems whose W (2 · 2Dp ·
//   32⌈M/4⌉ bytes) fits with the rest: M = 112 fits at every D ≤ 32, while
//   at D = 21 M = 224 (a stride-1 lattice at N = 224) does not. Elsewhere
//   the engine runs K1, whose contract is the same (core/engine.py).
// * Overlap. Each warpgroup issues a k-step's three products
//   asynchronously and, while they run, forms the next step's fragments
//   and issues the loads of the step after it; the other warpgroups of the
//   SM fill the tensor cores meanwhile.
// * Spectrum reuse. conv = proj ⊙ conj(ctf) of a k-step is formed once per
//   warpgroup (one value per thread) into a shared-memory buffer, behind
//   one warpgroup barrier, and used by its four images; the CTA's
//   warpgroups start each tile together and read the same image rows.
// * Accuracy. Each operand is split x = hi + lo (hi = tf32(x), lo =
//   tf32(x − hi)); a k-step forms lo·hi + hi·lo + hi·hi in a zeroed
//   accumulator (the first product does not add) and adds it to the f32
//   sum with IEEE adds: the tensor cores truncate when they accumulate, and
//   chaining all 84 products of a tile through one accumulator loses ~5×
//   (measured on the earlier wmma design; the step is wgmma.cuh tf32x3_step,
//   which P1's 3xTF32 runs too).
// * Stage 2 (cc = Re(t1·wyᵀ), 4·D²·F per comparison) stays f32 FMA on the
//   CUDA cores, per warp on its own image: the warp's 16 rows of t1 go to
//   shared memory once per tile, lane e sums its lattice column cc[·, e]
//   over the tile (re and im terms apart, as K1 does) and adds it to a
//   column kept in shared memory across the image's tiles. On the tensor
//   cores it would need its own 3xTF32 split and chains for a GEMM with
//   N = D; it is a small share of the CUDA cores' work.
// * The log-sum-exp (compare_lse.cuh, shared with K1) runs on each warp
//   for its image. No atomics: two launches on the same inputs give the
//   same bits.
// The body variant V is kFull in production; the ablation probe P3
// instantiates the others at 2·Dp = 48 only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compare_lse.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = bioem_wgmma;

constexpr int kRowsW = 16;    // frequencies per warp per m64 tile (one image per warp)
constexpr int kLd = 20;       // stride of a conv row of 16 frequencies (float2): no bank
                              // conflicts for the fragment's (t, g) reads
constexpr int kMaxD = 32;     // 2·Dp ≤ 64: wgmma n16 … n64

// Warpgroups per CTA: four (one CTA of 512 threads per SM, ≤ 128
// registers each) up to n48; two at n64, whose W fills more of the
// shared memory.
__host__ __device__ constexpr int warpgroups(int np) { return np > 48 ? 2 : 4; }

// Shared-memory carve-up, the same on the host and in the kernel.
struct Layout {
  int Dp, NP, n_ks, kb, ldt, n_wg, ncv;
  size_t w_hi, w_lo, wy, t1, cv, cc, bytes;
};

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

__host__ __device__ inline Layout layout(int D, int M, int F) {
  Layout L;
  L.Dp = (D + 7) / 8 * 8;  // t1 rows per re/im half
  L.NP = 2 * L.Dp;         // wgmma N
  L.n_ks = (M + 3) / 4;    // k8 steps: four folded rows each
  L.kb = 32 * L.n_ks;      // bytes of K per W row
  L.ldt = L.NP + 4;        // row stride of a tile's t1 in shared memory (floats)
  L.n_wg = warpgroups(L.NP);
  // One k-step's conv of a tile for one warpgroup, folds 0 and 1, in rows
  // of kRowsW frequencies padded to kLd.
  L.ncv = 2 * 4 * kLd;
  L.w_hi = 0;
  L.w_lo = L.w_hi + (size_t)L.NP * L.kb;
  L.wy = L.w_lo + (size_t)L.NP * L.kb;
  L.t1 = L.wy + align128(sizeof(float2) * (size_t)F * D);
  L.cv = L.t1 + align128(sizeof(float) * (size_t)L.n_wg * 64 * L.ldt);
  L.cc = L.cv + align128(sizeof(float2) * (size_t)L.n_wg * 2 * L.ncv);
  L.bytes = L.cc + align128(sizeof(float) * (size_t)L.n_wg * 4 * L.Dp * 32);
  return L;
}

using bioem_lse::kFull;
using bioem_lse::kMmOnly;
using bioem_lse::kNoGemm;
using bioem_lse::kNoLse;

// acc ← lo·W_hi + hi·W_lo + hi·W_hi for k-step s (acc's old value is not
// read), issued asynchronously (wgmma.cuh tf32x3_step).
template <int NP>
__device__ __forceinline__ void chain(float (&acc)[NP / 2], const uint32_t (&hi)[4],
                                      const uint32_t (&lo)[4], const unsigned char* w_hi,
                                      const unsigned char* w_lo, int s, uint32_t kb) {
  wg::tf32x3_step<NP>(acc, hi, lo, wg::desc(w_hi + 256 * s, 128, 8 * kb),
                      wg::desc(w_lo + 256 * s, 128, 8 * kb));
}

template <int NP, int V>
__global__ void __launch_bounds__(NP > 48 ? 256 : 512, 1)
compare_batched_kernel(const float* __restrict__ proj_re, const float* __restrict__ proj_im,
                       const float* __restrict__ ctf_re, const float* __restrict__ ctf_im,
                       const float* __restrict__ img_re, const float* __restrict__ img_im,
                       const float* __restrict__ wx_re, const float* __restrict__ wx_im,
                       const float* __restrict__ wy_re, const float* __restrict__ wy_im,
                       const float* __restrict__ a_u, const float* __restrict__ b_u,
                       float a_coef, int C, int I, int N, int F, int D, int M, int n_fold,
                       int OC, float* __restrict__ out_m, float* __restrict__ out_se,
                       int* __restrict__ out_ds, float* __restrict__ out_ccs) {
  constexpr int kWG = warpgroups(NP);
  constexpr int kThreads = 128 * kWG;
  constexpr int NA = NP / 2;  // accumulator floats per thread
  constexpr int DP = NP / 2;  // t1 rows per re/im half
  extern __shared__ __align__(1024) unsigned char smem[];
  const Layout L = layout(D, M, F);
  unsigned char* w_hi = smem + L.w_hi;
  unsigned char* w_lo = smem + L.w_lo;
  float2* wys = reinterpret_cast<float2*>(smem + L.wy);
  const int n_ks = L.n_ks, ldt = L.ldt, ncv = L.ncv;
  const uint32_t kb = L.kb;
  const int DD = D * D;

  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, warp = wt >> 5, g = lane >> 2, t = lane & 3;
  // This warp's 16 rows of the warpgroup's t1 tile, and the warpgroup's
  // two conv buffers (k-steps alternate between them).
  float* t1w = reinterpret_cast<float*>(smem + L.t1) + (size_t)(wgi * 64 + 16 * warp) * ldt;
  float2* cvw = reinterpret_cast<float2*>(smem + L.cv) + (size_t)wgi * 2 * ncv;
  // This warp's cc[d, e] at d·32 + e (lane e's column), across the tiles
  // of its image.
  float* ccw = reinterpret_cast<float*>(smem + L.cc) + (size_t)(wgi * 4 + warp) * DP * 32;
  const size_t NF = (size_t)N * F;

  // W (hi, lo): row n < Dp is t1_re[d = n], row Dp + d is t1_im[d]; column
  // 8s + u (u < 4) multiplies Re p[4s + u], column 8s + 4 + u Im p[4s + u].
  // Rows d ≥ D and folded rows j ≥ M are zero.
  for (int q = tid; q < NP * 8 * n_ks; q += kThreads) {
    const int n = q / (8 * n_ks), kp = q - n * (8 * n_ks);
    const int j = 4 * (kp >> 3) + (kp & 3);
    const bool im_col = (kp & 7) >= 4, im_row = n >= DP;
    const int d = im_row ? n - DP : n;
    float v = 0.f;
    if (d < D && j < M) {
      const float wr = wx_re[d * M + j], wi = wx_im[d * M + j];
      v = im_row ? (im_col ? wr : wi) : (im_col ? -wi : wr);
    }
    const uint32_t hi = wg::to_tf32(v);
    const uint32_t off = wg::offset_km(n, 4 * kp, kb);
    *reinterpret_cast<uint32_t*>(w_hi + off) = hi;
    *reinterpret_cast<uint32_t*>(w_lo + off) = wg::to_tf32(v - __uint_as_float(hi));
  }
  if constexpr (V != kMmOnly) {
    for (int q = tid; q < F * D; q += kThreads) {
      const int f = q / D, e = q - f * D;
      wys[q] = make_float2(wy_re[e * F + f], wy_im[e * F + f]);
    }
  }
  wg::fence_proxy_async();
  __syncthreads();

  // This CTA's work items blockIdx.x + k·gridDim.x, each (block of kWG
  // consecutive oc, group of four consecutive images). Warpgroup w takes
  // the block's oc w, warp v the group's image v: the warpgroups of a CTA
  // read the same image rows at about the same time (one L2 read, then L1
  // hits) and, with c varying fastest in oc, mostly the same proj rows.
  const int n_groups = (I + 3) / 4;
  const int n_blocks = (OC + kWG - 1) / kWG;
  const int n_mt = (F + kRowsW - 1) / kRowsW;
  const int bar = 1 + wgi;
  const int NFi = N * F;
  for (int item = blockIdx.x; item < n_blocks * n_groups; item += gridDim.x) {
    const int ocb = item / n_groups;
    const int oc_raw = ocb * kWG + wgi;
    const bool live = oc_raw < OC;  // warpgroup-uniform: the last block is short
    const int oc = live ? oc_raw : OC - 1;
    const int i0 = 4 * (item - ocb * n_groups);
    const bool has = i0 + warp < I;  // warp-uniform: this warp has an image
    const int i = has ? i0 + warp : i0;
    const int o = oc / C, c = oc - (oc / C) * C;
    const int po = o * NFi, pc = c * NFi;  // proj and ctf offsets
    const float* ir_p = img_re + (size_t)i * NF;
    const float* ii_p = img_im + (size_t)i * NF;

    __syncwarp();  // lane 0 is done reading the last image's cc
#pragma unroll
    for (int d = 0; d < DP; ++d) ccw[d * 32 + lane] = 0.f;
    float chk = 0.f;  // kMmOnly's checksum

    for (int mt = 0; mt < n_mt; ++mt) {
      // The CTA's warpgroups start each tile together, so that they read
      // the same image rows at about the same time; this also ends every
      // warp's reads of the last tile's conv.
      __syncthreads();
      if (!live) continue;
      // This thread's fragment rows: frequencies f0 and f0 + 8 of its
      // warp's image.
      const int fb = mt * kRowsW;
      const int f0 = fb + g, f1 = f0 + 8;
      const bool v0 = has && f0 < F, v1 = has && f1 < F;

      // conv of k-step s for the tile's 16 frequencies, shared by the
      // warpgroup's four images: thread wt forms entry (fold k < 2, folded
      // row 4s + u4, frequency fb + fl), rows of 16 frequencies kLd apart.
      // Folds past the second (a lattice stride above 2) form their conv in
      // frag_form.
      auto conv_load = [&](int s, float (&raw)[4]) {
        const int k = wt >> 6, u4 = (wt >> 4) & 3, fl = wt & 15;
        const int j = 4 * s + u4, f = fb + fl;
        const bool ok = k < n_fold && j < M && f < F;
        const int idx = (j + k * M) * F + f;
        raw[0] = ok ? proj_re[po + idx] : 0.f;
        raw[1] = ok ? proj_im[po + idx] : 0.f;
        raw[2] = ok ? ctf_re[pc + idx] : 0.f;
        raw[3] = ok ? ctf_im[pc + idx] : 0.f;
      };
      auto conv_store = [&](int s, const float (&raw)[4]) {
        cvw[(s & 1) * ncv + (wt >> 4) * kLd + (wt & 15)] =
            make_float2(raw[0] * raw[2] + raw[1] * raw[3], raw[1] * raw[2] - raw[0] * raw[3]);
      };
      // The image values of folds 0 and 1 of k-step s (re, im at f0, then
      // at f1), loaded a step before their use.
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
      // Fragment of k-step s: Re p(j, f0), Re p(j, f1), Im p(j, f0),
      // Im p(j, f1) with j = 4s + t, split into TF32 hi and lo.
      auto frag_form = [&](int s, const float (&pre)[8], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        const float2* cb = cvw + (s & 1) * ncv;
        const int j = 4 * s + t;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        auto add = [&](float2 c0, float2 c1, float ir0, float ii0, float ir1, float ii1) {
          x[0] += c0.x * ir0 - c0.y * ii0;
          x[2] += c0.x * ii0 + c0.y * ir0;
          x[1] += c1.x * ir1 - c1.y * ii1;
          x[3] += c1.x * ii1 + c1.y * ir1;
        };
        add(cb[t * kLd + g], cb[t * kLd + g + 8], pre[0], pre[1], pre[2], pre[3]);
        if (n_fold > 1)
          add(cb[(4 + t) * kLd + g], cb[(4 + t) * kLd + g + 8], pre[4], pre[5], pre[6], pre[7]);
        for (int k = 2; k < n_fold && j < M; ++k) {
          const size_t row = (size_t)(j + k * M) * F;
          float2 cv[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
          float im[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if (!(h ? v1 : v0)) continue;
            const size_t idx = row + (h ? f1 : f0);
            const float xr = proj_re[po + idx], xi = proj_im[po + idx];
            const float kr = ctf_re[pc + idx], ki = ctf_im[pc + idx];
            cv[h] = make_float2(xr * kr + xi * ki, xi * kr - xr * ki);
            im[2 * h] = ir_p[idx];
            im[2 * h + 1] = ii_p[idx];
          }
          add(cv[0], cv[1], im[0], im[1], im[2], im[3]);
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
        for (int s = 0; s < n_ks; ++s) {
          chain<NP>(acc, ha, ha, w_hi, w_lo, s, kb);
          wg::wait<0>();
          wg::fence_operand(acc);
#pragma unroll
          for (int r = 0; r < NA; ++r) sum[r] += acc[r];
        }
#pragma unroll
        for (int r = 0; r < NA; ++r) chk += sum[r];
        continue;
      } else {
        // k-step s: issue its products; while they run, form step s + 1
        // (conv into the other buffer, one warpgroup barrier, fragments
        // into the other registers) and issue step s + 2's loads; then add
        // the products to the sum. Loads run a step ahead of their use, and
        // the loop is unrolled by two so that each step's fragments are
        // fixed registers, read by wgmma until its wait.
        float raw[4];
        auto form = [&](int s, uint32_t (&hn)[4], uint32_t (&ln)[4]) {
          conv_store(s, raw);
          wg::wg_barrier(bar);
          frag_form(s, pre, hn, ln);
          if (s + 1 < n_ks) {
            img_pre(s + 1, pre);
            conv_load(s + 1, raw);
          }
        };
        auto step = [&](int s, uint32_t (&hc)[4], uint32_t (&lc)[4], uint32_t (&hn)[4],
                        uint32_t (&ln)[4]) {
          if constexpr (V != kNoGemm) chain<NP>(acc, hc, lc, w_hi, w_lo, s, kb);
          if (s + 1 < n_ks) form(s + 1, hn, ln);
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
        img_pre(0, pre);
        conv_load(0, raw);
        form(0, ha, la);
        for (int s = 0; s < n_ks; s += 2) {
          step(s, ha, la, hb, lb);
          if (s + 1 < n_ks) step(s + 1, hb, lb, ha, la);
        }
      }

      // This warp's t1 rows (frequency fb + row; columns [0, Dp) re,
      // [Dp, 2Dp) im) to shared memory, then stage 2 on its own image,
      // lane e: cc[d, e] += Σ_f Re(t1[d, f] · wy[e, f]).
      __syncwarp();  // the last tile's stage-2 reads of t1w are done
#pragma unroll
      for (int jj = 0; jj < NP / 8; ++jj) {
        *reinterpret_cast<float2*>(t1w + g * ldt + 8 * jj + 2 * t) =
            make_float2(sum[4 * jj], sum[4 * jj + 1]);
        *reinterpret_cast<float2*>(t1w + (g + 8) * ldt + 8 * jj + 2 * t) =
            make_float2(sum[4 * jj + 2], sum[4 * jj + 3]);
      }
      __syncwarp();
      if (has && lane < D) {
        // Σ over the tile's frequencies of the re and im terms apart, then
        // their difference into cc (the order K1 uses).
        const int fcn = F - fb < kRowsW ? F - fb : kRowsW;
        float sr[DP], si[DP];
#pragma unroll
        for (int d = 0; d < DP; ++d) sr[d] = si[d] = 0.f;
        for (int fl = 0; fl < fcn; ++fl) {
          const float2 w = wys[(fb + fl) * D + lane];
          const float4* tr = reinterpret_cast<const float4*>(t1w + fl * ldt);
          const float4* ti = reinterpret_cast<const float4*>(t1w + fl * ldt + DP);
#pragma unroll
          for (int d4 = 0; d4 < DP / 4; ++d4) {
            const float4 a = tr[d4], b = ti[d4];
            sr[4 * d4 + 0] += a.x * w.x;
            sr[4 * d4 + 1] += a.y * w.x;
            sr[4 * d4 + 2] += a.z * w.x;
            sr[4 * d4 + 3] += a.w * w.x;
            si[4 * d4 + 0] += b.x * w.y;
            si[4 * d4 + 1] += b.y * w.y;
            si[4 * d4 + 2] += b.z * w.y;
            si[4 * d4 + 3] += b.w * w.y;
          }
        }
#pragma unroll
        for (int d = 0; d < DP; ++d) ccw[d * 32 + lane] += sr[d] - si[d];
      }
    }

    if (!has || !live) continue;
    const size_t oi = (size_t)oc * I + i;
    if constexpr (V == kMmOnly) {
      chk = bioem_lse::warp_sum(chk);
      if (lane == 0) out_m[oi] = chk;
      continue;
    }
    __syncwarp();  // every lane's cc column is written
    if constexpr (V == kNoLse) {
      float s = 0.f;
      if (lane < D)
        for (int d = 0; d < D; ++d) s += ccw[d * 32 + lane];
      s = bioem_lse::warp_sum(s);
      if (lane == 0) out_m[oi] = s;
      continue;
    }

    // Displacement log-sum-exp of this warp's image: lane e takes the
    // lattice points d·D + e.
    const float au = a_u[oi], bu = b_u[oi];
    float best = -INFINITY;
    int bidx = DD;
    if (lane < D) {
      for (int d = 0; d < D; ++d) {
        const float v = bioem_lse::lattice_value(ccw[d * 32 + lane], au, bu, a_coef);
        if (bioem_lse::better(v, d * D + lane, best, bidx)) {
          best = v;
          bidx = d * D + lane;
        }
      }
    }
    bioem_lse::warp_argmax(best, bidx);
    best = __shfl_sync(0xffffffffu, best, 0);
    bidx = __shfl_sync(0xffffffffu, bidx, 0);
    if (bidx >= DD) bidx = 0;  // every v is −inf: argmax of an all-equal row
    float s = 0.f;
    if (lane < D)
      for (int d = 0; d < D; ++d)
        s += expf(bioem_lse::lattice_value(ccw[d * 32 + lane], au, bu, a_coef) - best);
    s = bioem_lse::warp_sum(s);
    if (lane == 0) {
      out_m[oi] = best;
      out_se[oi] = s;
      out_ds[oi] = bidx;
      out_ccs[oi] = ccw[(bidx / D) * 32 + bidx % D];
    }
  }
}

template <int NP, int V = kFull>
int launch(const float* proj_re, const float* proj_im, const float* ctf_re,
           const float* ctf_im, const float* img_re, const float* img_im,
           const float* wx_re, const float* wx_im, const float* wy_re, const float* wy_im,
           const float* a_u, const float* b_u, float a_coef, int O, int C, int I, int N,
           int F, int D, int M, int n_fold, float* m, float* se, int* ds,
           float* ccs, cudaStream_t stream) {
  const size_t smem = layout(D, M, F).bytes;
  cudaError_t err = cudaFuncSetAttribute(compare_batched_kernel<NP, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const int n_blocks = (O * C + warpgroups(NP) - 1) / warpgroups(NP);
  const int n_work = n_blocks * ((I + 3) / 4);  // (block of oc, four images) work items
  const int grid = n_work < n_sm ? n_work : n_sm;
  compare_batched_kernel<NP, V><<<grid, 128 * warpgroups(NP), smem, stream>>>(
      proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u,
      b_u, a_coef, C, I, N, F, D, M, n_fold, O * C, m, se, ds, ccs);
  return (int)cudaGetLastError();
}

// A lattice width the kernel has an instance for: D ≤ 32 (2·Dp ≤ 64).
bool supported(int D) { return D >= 1 && D <= kMaxD; }

}  // namespace

extern "C" {

// Dynamic shared memory of the batched kernel for these sizes, or 0 when
// it has no instance for D. The wrapper checks the size against the card's
// per-block limit before launching.
size_t bioem_compare_batched_smem_bytes(int D, int M, int F) {
  return supported(D) ? layout(D, M, F).bytes : 0;
}

int bioem_fused_compare_batched(const float* proj_re, const float* proj_im,
                                const float* ctf_re, const float* ctf_im,
                                const float* img_re, const float* img_im,
                                const float* wx_re, const float* wx_im, const float* wy_re,
                                const float* wy_im, const float* a_u, const float* b_u,
                                float a_coef, int O, int C, int I, int N, int F, int D, int M,
                                int n_fold, int IT, float* m, float* se, int* ds, float* ccs,
                                void* stream) {
  if (!supported(D) || IT < 1 || I % IT != 0) return (int)cudaErrorInvalidValue;
#define BIOEM_K4_ARGS                                                                    \
  proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u, b_u, \
      a_coef, O, C, I, N, F, D, M, n_fold, m, se, ds, ccs, (cudaStream_t)stream
  switch (layout(D, M, F).NP) {
    case 16: return launch<16>(BIOEM_K4_ARGS);
    case 32: return launch<32>(BIOEM_K4_ARGS);
    case 48: return launch<48>(BIOEM_K4_ARGS);
    case 64: return launch<64>(BIOEM_K4_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel probe P3: the body variant ``variant`` (bioem_lse::Body) of
// the production instance at its width (2·Dp = 48: D = 17..24, any tile).
// kFull is the production instance itself; the other variants write a
// checksum into m and nothing else.
int bioem_probe_compare_batched(int variant, const float* proj_re, const float* proj_im,
                                const float* ctf_re, const float* ctf_im,
                                const float* img_re, const float* img_im,
                                const float* wx_re, const float* wx_im, const float* wy_re,
                                const float* wy_im, const float* a_u, const float* b_u,
                                float a_coef, int O, int C, int I, int N, int F, int D, int M,
                                int n_fold, int IT, float* m, float* se, int* ds, float* ccs,
                                void* stream) {
  if (!supported(D) || IT < 1 || I % IT != 0) return (int)cudaErrorInvalidValue;
  if (layout(D, M, F).NP != 48) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kFull: return launch<48, kFull>(BIOEM_K4_ARGS);
    case kNoLse: return launch<48, kNoLse>(BIOEM_K4_ARGS);
    case kMmOnly: return launch<48, kMmOnly>(BIOEM_K4_ARGS);
    case kNoGemm: return launch<48, kNoGemm>(BIOEM_K4_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}
#undef BIOEM_K4_ARGS

}  // extern "C"

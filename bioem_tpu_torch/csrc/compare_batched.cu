// Image-batched fused comparison kernel (K4) for Hopper (sm_90a): stage 1
// of the displacement-lattice DFT on tensor cores in 3xTF32.
//
// Replaces bioem_tpu/ops/compare_pallas.py:_fused_block_kernel_batched
// (entry fused_compare_block(..., batched_stage1=True)). Same contract as
// K1 (compare.cu): per (orientation·ctf oc, image i)
//   conv = proj[o] ⊙ conj(ctf[c]),  p = fold(conv ⊙ img[i])   (M = N/n_fold, F)
//   t1   = wx · p                                              (D, F) complex
//   cc   = Re(t1 · wyᵀ),  v = a_coef · log1p(a_u·cc − b_u·cc²)
//   out  = (max v, Σ exp(v − max), first-occurrence flat argmax, cc there)
// Only m is the raw f32 max; the engine repairs it in f64.
//
// What bounds it on the card. K1 reads the proj, ctf and image spectra for
// every comparison: 3·N·F·8 B = 607 KB at N=224, 2.49 GB per production
// block (O=8, C=8, I=64), all of it from the 50 MB L2. Stage 1 is
// 2·(2·Dp)·(2·M)·F FLOP per comparison, 3 × that on the tensor cores in
// 3xTF32 (Dp = D rounded up to 8): 34 GFLOP per production block. On an
// H100 neither bound is reached: at tile 8 (0.96 ms per block) redirecting
// every spectrum load to L1 saves 2 %, while removing the tensor-core
// phase saves half (its fragment loads, splits and per-step adds around
// mma.sync, fenced by block barriers at 16 warps per SM).
//
// Design. One CTA per (oc, tile of IT images). conv is formed once per
// tile and reused for its IT images, so the spectra cost (1 + 2/IT)·N·F·8 B
// per comparison (253 KB at IT=8). Stage 1 is one real GEMM per tile,
//   [t1_re; t1_im] (2Dp × IT·F) = [[wx_re, −wx_im], [wx_im, wx_re]] · [p_re; p_im],
// on tensor cores (nvcuda::wmma m16n16k8 tf32) with the N dimension
// spanning the tile's IT·F columns. Each operand is split x = hi + lo with
// hi = tf32(x), lo = tf32(x − hi), and lo·hi + hi·lo + hi·hi is summed;
// the dropped lo·lo term keeps the product near f32 accuracy (single-pass
// TF32, ~1e-3 relative, moves the displacement argmax). Each 8-deep k-step
// goes into a zeroed fragment that is then added to the running sum with
// IEEE f32 adds (tf32x3.cuh, shared with the precision probe P1): chaining
// all 84 MMAs of an F chunk through one accumulator loses ~5× accuracy to
// the tensor cores' truncating accumulation. The GEMM walks F in
// chunks of 16 columns per image and the folded rows j in chunks of 16,
// forming p for the chunk in shared memory (double-buffered) straight from
// L2; t1 is never held whole: each F chunk's t1 goes to shared memory and
// stage 2 accumulates cc = Re(t1 · wyᵀ) over the chunks (f32 FMA). The
// log-sum-exp (compare_lse.cuh, shared with K1) runs one warp per image.
// The body variant V is kFull in production; the ablation probe P3
// instantiates the others at the production tiling only.

#include <cuda_runtime.h>
#include <math.h>
#include <mma.h>
#include <stdint.h>

#include "compare_lse.cuh"
#include "tf32x3.cuh"

using namespace nvcuda;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int KC = 16;       // folded rows j per B chunk (two 8-deep k-steps each for re, im)
constexpr int FC = 16;       // frequency columns per image per chunk: one wmma N tile
constexpr int kMaxTile = 16; // images per CTA
static_assert(kThreads == KC * FC, "one (row, column) of a B chunk per thread");

// Shared-memory carve-up, the same on the host and in the kernel.
struct Layout {
  int Dp, Mp, MT, ld, lda;
  size_t a_off, u_off, cc_off, wy_off, bytes;
};

__host__ __device__ inline Layout layout(int D, int M, int IT) {
  Layout L;
  L.Dp = (D + 7) / 8 * 8;        // t1 rows per re/im half
  L.Mp = (M + KC - 1) / KC * KC; // folded rows, padded to whole chunks
  L.MT = 2 * L.Dp / 16;          // 16-row tensor-core tiles of [t1_re; t1_im]
  L.ld = IT * FC + 4;            // row stride of the B chunks and of t1
  L.lda = 2 * L.Mp + 4;          // row stride of the stacked wx matrix
  const int urows = 4 * KC > 2 * L.Dp ? 4 * KC : 2 * L.Dp;
  L.a_off = 0;
  L.u_off = L.a_off + sizeof(float) * (size_t)(2 * L.Dp) * L.lda;
  // U holds the two B buffers (2·KC rows each) and, aliased onto them
  // once a chunk's GEMM is done, that chunk's t1 (2·Dp rows).
  L.cc_off = L.u_off + sizeof(float) * (size_t)urows * L.ld;
  L.wy_off = L.cc_off + (sizeof(float) * (size_t)IT * D * D + 31) / 32 * 32;
  L.bytes = L.wy_off + sizeof(float2) * (size_t)FC * D;
  return L;
}

// Warp tiling of the (MT × IT) output tiles of one F chunk: NTW image
// tiles × MTW row tiles per warp, so the accumulators stay in registers.
struct Tiling {
  int ntw, mtw;
};

inline Tiling tiling(int D, int IT) {
  const int MT = 2 * ((D + 7) / 8 * 8) / 16;
  Tiling t;
  t.ntw = IT <= kWarps ? 1 : 2;
  const int groups_n = (IT + t.ntw - 1) / t.ntw;
  const int gm_max = kWarps / groups_n;
  t.mtw = (MT + gm_max - 1) / gm_max;
  return t;
}

using bioem_lse::kFull;
using bioem_lse::kMmOnly;
using bioem_lse::kNoGemm;
using bioem_lse::kNoLse;

template <int NTW, int MTW, int V>
__global__ void __launch_bounds__(kThreads)
compare_batched_kernel(const float* __restrict__ proj_re, const float* __restrict__ proj_im,
                       const float* __restrict__ ctf_re, const float* __restrict__ ctf_im,
                       const float* __restrict__ img_re, const float* __restrict__ img_im,
                       const float* __restrict__ wx_re, const float* __restrict__ wx_im,
                       const float* __restrict__ wy_re, const float* __restrict__ wy_im,
                       const float* __restrict__ a_u, const float* __restrict__ b_u,
                       float a_coef, int C, int I, int N, int F, int D, int M, int n_fold,
                       int IT, float* __restrict__ out_m, float* __restrict__ out_se,
                       int* __restrict__ out_ds, float* __restrict__ out_ccs) {
  extern __shared__ __align__(128) unsigned char smem[];
  const Layout L = layout(D, M, IT);
  float* As = reinterpret_cast<float*>(smem + L.a_off);
  float* U = reinterpret_cast<float*>(smem + L.u_off);
  float* ccs = reinterpret_cast<float*>(smem + L.cc_off);
  float2* wyc = reinterpret_cast<float2*>(smem + L.wy_off);
  const int Dp = L.Dp, Mp = L.Mp, MT = L.MT, ld = L.ld, lda = L.lda;
  const int DD = D * D;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int i0 = blockIdx.x * IT;
  const int oc = blockIdx.y;
  const int o = oc / C, c = oc - (oc / C) * C;
  const size_t NF = (size_t)N * F;
  const float* pp_re = proj_re + o * NF;
  const float* pp_im = proj_im + o * NF;
  const float* pk_re = ctf_re + c * NF;
  const float* pk_im = ctf_im + c * NF;

  // A = [[wx_re, −wx_im], [wx_im, wx_re]] (2Dp × 2Mp); rows d ≥ D and
  // columns j ≥ M are zero.
  for (int q = tid; q < 2 * Dp * 2 * Mp; q += kThreads) {
    const int r = q / (2 * Mp), k = q - r * (2 * Mp);
    const bool im_row = r >= Dp, im_col = k >= Mp;
    const int d = im_row ? r - Dp : r, j = im_col ? k - Mp : k;
    float v = 0.f;
    if (d < D && j < M) {
      const float wr = wx_re[d * M + j], wi = wx_im[d * M + j];
      v = im_row ? (im_col ? wr : wi) : (im_col ? -wi : wr);
    }
    As[r * lda + k] = v;
  }
  for (int q = tid; q < IT * DD; q += kThreads) ccs[q] = 0.f;

  // This warp's output tiles: image tiles nt = gn·NTW + u, row tiles
  // mt = gm·MTW + v (warps past the last group have none).
  const int groups_n = (IT + NTW - 1) / NTW;
  const int gn = warp % groups_n, gm = warp / groups_n;
  const bool mma_warp = gm * MTW < MT;

  // B-chunk role of this thread: folded row jj, column fcl of every image.
  const int jj = tid / FC, fcl = tid - (tid / FC) * FC;
  const int n_jc = Mp / KC;
  const int n_fc = (F + FC - 1) / FC;

  float chk = 0.f;  // kMmOnly's checksum
  if constexpr (V == kMmOnly) {
    // Operands formed once: both B buffers from the tile's image spectra.
    for (int q = tid; q < 4 * KC * ld; q += kThreads)
      U[q] = img_re[(size_t)i0 * NF + (size_t)q % NF];
    __syncthreads();
  }
  for (int fcb = 0; fcb < n_fc; ++fcb) {
    const int f0 = fcb * FC;
    const int f = f0 + fcl;
    if constexpr (V != kMmOnly) {
      for (int q = tid; q < FC * D; q += kThreads) {
        const int fc = q / D, e = q - (q / D) * D;
        wyc[q] = f0 + fc < F ? make_float2(wy_re[e * F + f0 + fc], wy_im[e * F + f0 + fc])
                             : make_float2(0.f, 0.f);
      }
    }

    // p rows [j0, j0 + KC) of this F chunk for every image of the tile:
    // rows [0, KC) of the chunk hold p_re, rows [KC, 2KC) p_im. conv is
    // formed once per (row, column) and reused across the tile.
    auto form_b = [&](int jc, float* Bb) {
      const int j = jc * KC + jj;
      float* bre = Bb + jj * ld + fcl;
      float* bim = Bb + (KC + jj) * ld + fcl;
      if (j >= M || f >= F) {
        for (int i = 0; i < IT; ++i) {
          bre[i * FC] = 0.f;
          bim[i * FC] = 0.f;
        }
        return;
      }
      for (int k = 0; k < n_fold; ++k) {
        const size_t idx = (size_t)(j + k * M) * F + f;
        const float xr = pp_re[idx], xi = pp_im[idx];
        const float kr = pk_re[idx], ki = pk_im[idx];
        const float cr = xr * kr + xi * ki;
        const float ci = xi * kr - xr * ki;
        const float* ir_p = img_re + (size_t)i0 * NF + idx;
        const float* ii_p = img_im + (size_t)i0 * NF + idx;
        for (int i = 0; i < IT; ++i) {
          const float ir = ir_p[i * NF], ii = ii_p[i * NF];
          const float pr = cr * ir - ci * ii;
          const float pim = cr * ii + ci * ir;
          if (k == 0) {
            bre[i * FC] = pr;
            bim[i * FC] = pim;
          } else {
            bre[i * FC] += pr;
            bim[i * FC] += pim;
          }
        }
      }
    };

    wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[MTW][NTW];
#pragma unroll
    for (int v = 0; v < MTW; ++v)
#pragma unroll
      for (int u = 0; u < NTW; ++u) wmma::fill_fragment(acc[v][u], 0.f);

    if constexpr (V != kMmOnly) {
      form_b(0, U);
      __syncthreads();
    }
    for (int jc = 0; jc < n_jc; ++jc) {
      const float* Bc = U + (jc & 1) * 2 * KC * ld;
      if constexpr (V != kMmOnly)
        if (jc + 1 < n_jc) form_b(jc + 1, U + ((jc + 1) & 1) * 2 * KC * ld);
      if (V != kNoGemm && mma_warp) {
#pragma unroll
        for (int s = 0; s < 2 * KC / 8; ++s) {
          // k-step s covers chunk rows [8s, 8s + 8): p_re rows first, then p_im.
          const int acol = s < KC / 8 ? jc * KC + 8 * s : Mp + jc * KC + 8 * s - KC;
          wmma::fragment<wmma::accumulator, 16, 16, 8, float> step[MTW][NTW];
          wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major>
              a_hi[MTW], a_lo[MTW];
#pragma unroll
          for (int v = 0; v < MTW; ++v) {
            const int mt = gm * MTW + v;
            if (mt < MT) {
              wmma::load_matrix_sync(a_hi[v], As + mt * 16 * lda + acol, lda);
              if constexpr (V != kMmOnly) bioem_tf32x3::split(a_hi[v], a_lo[v]);
            }
          }
#pragma unroll
          for (int u = 0; u < NTW; ++u) {
            const int nt = gn * NTW + u;
            if (nt < IT) {
              wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major>
                  b_hi, b_lo;
              wmma::load_matrix_sync(b_hi, Bc + 8 * s * ld + nt * FC, ld);
              if constexpr (V != kMmOnly) bioem_tf32x3::split(b_hi, b_lo);
#pragma unroll
              for (int v = 0; v < MTW; ++v) {
                if (gm * MTW + v < MT) {
                  if constexpr (V == kMmOnly)
                    bioem_tf32x3::mma_step(acc[v][u], step[v][u], a_hi[v], a_hi[v], b_hi, b_hi);
                  else
                    bioem_tf32x3::mma_step(acc[v][u], step[v][u], a_hi[v], a_lo[v], b_hi, b_lo);
                }
              }
            }
          }
        }
      }
      if constexpr (V != kMmOnly) __syncthreads();
    }
    if constexpr (V == kMmOnly) {
#pragma unroll
      for (int v = 0; v < MTW; ++v)
#pragma unroll
        for (int u = 0; u < NTW; ++u)
          for (int t = 0; t < acc[v][u].num_elements; ++t) chk += acc[v][u].x[t];
      continue;
    }

    // This chunk's t1 (rows [0, Dp) re, [Dp, 2Dp) im; image i at columns
    // [i·FC, i·FC + FC)) over the B buffers, all of whose reads are done.
    if (mma_warp) {
#pragma unroll
      for (int v = 0; v < MTW; ++v)
#pragma unroll
        for (int u = 0; u < NTW; ++u) {
          const int mt = gm * MTW + v, nt = gn * NTW + u;
          if (mt < MT && nt < IT)
            wmma::store_matrix_sync(U + mt * 16 * ld + nt * FC, acc[v][u], ld,
                                    wmma::mem_row_major);
        }
    }
    __syncthreads();

    // Stage 2 over this chunk: cc[i, d, e] += Σ_f Re(t1[d, f] · wy[e, f]).
    const int fcn = F - f0 < FC ? F - f0 : FC;
    for (int q = tid; q < IT * DD; q += kThreads) {
      const int i = q / DD, r = q - (q / DD) * DD;
      const int d = r / D, e = r - (r / D) * D;
      const float* tr = U + d * ld + i * FC;
      const float* ti = U + (Dp + d) * ld + i * FC;
      float sr = 0.f, si = 0.f;
      for (int fc = 0; fc < fcn; ++fc) {
        const float2 w = wyc[fc * D + e];
        sr += tr[fc] * w.x;
        si += ti[fc] * w.y;
      }
      ccs[q] += sr - si;
    }
    __syncthreads();
  }

  if constexpr (V == kMmOnly) {
    chk = bioem_lse::warp_sum(chk);
    if (lane == 0 && warp < IT) out_m[(size_t)oc * I + i0 + warp] = chk;
    return;
  }
  // Displacement log-sum-exp, one warp per image.
  for (int i = warp; i < IT; i += kWarps) {
    const size_t oi = (size_t)oc * I + i0 + i;
    const float au = a_u[oi], bu = b_u[oi];
    const float* cci = ccs + i * DD;
    if constexpr (V == kNoLse) {
      float sum = 0.f;
      for (int q = lane; q < DD; q += 32) sum += cci[q];
      sum = bioem_lse::warp_sum(sum);
      if (lane == 0) out_m[oi] = sum;
      continue;
    }
    float best = -INFINITY;
    int bidx = DD;
    for (int q = lane; q < DD; q += 32) {
      const float v = bioem_lse::lattice_value(cci[q], au, bu, a_coef);
      if (bioem_lse::better(v, q, best, bidx)) {
        best = v;
        bidx = q;
      }
    }
    bioem_lse::warp_argmax(best, bidx);
    best = __shfl_sync(0xffffffffu, best, 0);
    bidx = __shfl_sync(0xffffffffu, bidx, 0);
    if (bidx >= DD) bidx = 0;  // every v is −inf: argmax of an all-equal row
    float s = 0.f;
    for (int q = lane; q < DD; q += 32)
      s += expf(bioem_lse::lattice_value(cci[q], au, bu, a_coef) - best);
    s = bioem_lse::warp_sum(s);
    if (lane == 0) {
      out_m[oi] = best;
      out_se[oi] = s;
      out_ds[oi] = bidx;
      out_ccs[oi] = cci[bidx];
    }
  }
}

template <int NTW, int MTW, int V = kFull>
int launch(const float* proj_re, const float* proj_im, const float* ctf_re,
           const float* ctf_im, const float* img_re, const float* img_im,
           const float* wx_re, const float* wx_im, const float* wy_re, const float* wy_im,
           const float* a_u, const float* b_u, float a_coef, int O, int C, int I, int N,
           int F, int D, int M, int n_fold, int IT, float* m, float* se, int* ds,
           float* ccs, cudaStream_t stream) {
  const size_t smem = layout(D, M, IT).bytes;
  cudaError_t err = cudaFuncSetAttribute(compare_batched_kernel<NTW, MTW, V>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(I / IT, O * C);
  compare_batched_kernel<NTW, MTW, V><<<grid, kThreads, smem, stream>>>(
      proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u,
      b_u, a_coef, C, I, N, F, D, M, n_fold, IT, m, se, ds, ccs);
  return (int)cudaGetLastError();
}

// A (D, IT) the kernel has an instance for: IT ≤ 16 and at most four
// 16-row tiles of [t1_re; t1_im] per warp.
bool supported(int D, int IT) {
  if (D < 1 || IT < 1 || IT > kMaxTile) return false;
  return tiling(D, IT).mtw <= 4;
}

}  // namespace

extern "C" {

// Dynamic shared memory of the batched kernel for these sizes, or 0 when
// it has no instance for (D, IT). F does not enter: the kernel walks F in
// chunks of 16 columns. The wrapper checks the size against the card's
// per-block limit before launching.
size_t bioem_compare_batched_smem_bytes(int D, int M, int F, int IT) {
  (void)F;
  return supported(D, IT) ? layout(D, M, IT).bytes : 0;
}

int bioem_fused_compare_batched(const float* proj_re, const float* proj_im,
                                const float* ctf_re, const float* ctf_im,
                                const float* img_re, const float* img_im,
                                const float* wx_re, const float* wx_im, const float* wy_re,
                                const float* wy_im, const float* a_u, const float* b_u,
                                float a_coef, int O, int C, int I, int N, int F, int D, int M,
                                int n_fold, int IT, float* m, float* se, int* ds, float* ccs,
                                void* stream) {
  if (!supported(D, IT) || I % IT != 0) return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(D, IT);
#define BIOEM_K4_ARGS                                                                    \
  proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u, b_u, \
      a_coef, O, C, I, N, F, D, M, n_fold, IT, m, se, ds, ccs, (cudaStream_t)stream
  switch (t.ntw * 10 + t.mtw) {
    case 11: return launch<1, 1>(BIOEM_K4_ARGS);
    case 12: return launch<1, 2>(BIOEM_K4_ARGS);
    case 13: return launch<1, 3>(BIOEM_K4_ARGS);
    case 14: return launch<1, 4>(BIOEM_K4_ARGS);
    case 21: return launch<2, 1>(BIOEM_K4_ARGS);
    case 22: return launch<2, 2>(BIOEM_K4_ARGS);
    case 23: return launch<2, 3>(BIOEM_K4_ARGS);
    case 24: return launch<2, 4>(BIOEM_K4_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel probe P3: the body variant ``variant`` (bioem_lse::Body) of
// the production instance at its tiling (one image tile and three t1 row
// tiles per warp: D = 21, IT = 8). kFull is the production instance
// itself; the other variants write a checksum into m and nothing else.
int bioem_probe_compare_batched(int variant, const float* proj_re, const float* proj_im,
                                const float* ctf_re, const float* ctf_im,
                                const float* img_re, const float* img_im,
                                const float* wx_re, const float* wx_im, const float* wy_re,
                                const float* wy_im, const float* a_u, const float* b_u,
                                float a_coef, int O, int C, int I, int N, int F, int D, int M,
                                int n_fold, int IT, float* m, float* se, int* ds, float* ccs,
                                void* stream) {
  if (!supported(D, IT) || I % IT != 0) return (int)cudaErrorInvalidValue;
  const Tiling t = tiling(D, IT);
  if (t.ntw != 1 || t.mtw != 3) return (int)cudaErrorInvalidValue;
  switch (variant) {
    case kFull: return launch<1, 3, kFull>(BIOEM_K4_ARGS);
    case kNoLse: return launch<1, 3, kNoLse>(BIOEM_K4_ARGS);
    case kMmOnly: return launch<1, 3, kMmOnly>(BIOEM_K4_ARGS);
    case kNoGemm: return launch<1, 3, kNoGemm>(BIOEM_K4_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}
#undef BIOEM_K4_ARGS

}  // extern "C"

// Kernel probes P1 and P2 for Hopper (sm_90a). P3, the ablation of the
// production comparison bodies, is a template parameter of compare_fused.cu (K1)
// and compare_batched.cu (K4) instead of a copy of them.
//
// P1 replaces tools/kernel_probe.py:_f32_dot_kernel (probe_f32_accuracy).
// The TPU question was whether Mosaic lowers an f32 dot in several bf16
// passes or casts it to one. The card's question is which product scheme
// holds the port's f32 accuracy contract, and at what cost: the same
// C = A·B in each scheme the port runs or could run,
//   kFma     FP32 FMA on the CUDA cores, a register-tiled product;
//   kTf32x3  3xTF32 on warpgroup wgmma, K4's step (wgmma.cuh
//            tf32x3_step): per k8 step lo·hi + hi·lo + hi·hi in a zeroed
//            accumulator, added to the f32 sum with IEEE adds;
//   kTf32    1xTF32 on wgmma chained through one accumulator (the precision
//            trap of ROADMAP's precision rules);
//   kF64Tc   FP64 tensor cores (mma.sync m16n8k16 f64, sm_90's largest
//            f64 shape; PERF.md gives its time against m8n8k4, m16n8k4 and
//            m16n8k8) on operands widened from f32 once, as they are
//            staged, rounded to f32 once at the end.
// What bounds it, at K4's stage-1 shape (512 products of (48×224)·
// (224×1024)): the operations of the scheme (2·M·K·N per product in f32 on
// the CUDA cores or on the FP64 tensor cores at 67 TFLOP/s, three TF32
// products at 495) or, for 1xTF32, writing C (99 % of the bytes).
//
// Design. Persistent CTAs, one per SM, walk the output tiles (48 rows ×
// 256 columns of one of the ``batch`` copies; 48 rows are K4's 2·Dp
// stage-1 rows) in a fixed order, columns fastest:
// * A is resident. Each CTA forms A's rows of its tile once, over a slab
//   of up to 224 of K (the whole of K at the probe's shapes), in the
//   scheme's own form: split into TF32 hi and lo in wgmma's K-major layout,
//   widened to f64, or transposed in f32 for FMA. It is formed again only
//   when a tile of other rows or a deeper slab comes (M > 48, K > 224),
//   as K4 forms its W once per CTA.
// * B streams through a ring of four stages of 32 rows of K × 256
//   columns, filled by cp.async (16-byte copies when N % 4 = 0, else
//   4-byte ones; the ragged edge zero-filled by the copy) three stages
//   ahead of their use, so that loads overlap the products. Stages of 16
//   rows, which left room for a C tile of its own, measured slower: the
//   wait and barrier per stage, not the depth of the ring, cost time.
// * Warpgroups work apart: each loads, computes and stores its own
//   columns of the tile and waits on its own named barrier, so that one
//   warpgroup's loads, waits and adds overlap another's products. The
//   tensor-core schemes run four warpgroups (64 columns each), FMA two.
// * TF32. TF32 wgmma reads its shared-memory operand K-major only, and B
//   (K×N, row-major) is N-major, so each warpgroup computes its tile
//   transposed, Cᵀ = Bᵀ·Aᵀ, as K4's stage 1 does, with m64n48k8
//   (wgmma.cuh Tf32RS<48>): the register operand is 64 columns of B, read
//   from the stage and split (cvt.rna) in registers; the shared-memory
//   operand is A's 48 rows, K-major as stored. 3xTF32 issues a step's
//   products while the next step's fragments are formed.
// * FP64: warp w takes 16 columns of the 48 rows, A's f64 fragments from
//   the resident slab (row stride ≡ 4 doubles mod 16: two wavefronts per
//   load, the least for 8-byte loads), B's widened in registers as they
//   are read from the stage.
// * FMA: each thread holds 6 rows × 8 columns; a warp takes 12 rows ×
//   128 columns, so a k reads A as three 8-byte loads of two distinct
//   addresses and B as two float4 loads of 16.
// * The tensor-core schemes' tiles go out as rows through shared memory,
//   the warpgroup's columns of the stage it has just consumed, 24 rows at
//   a time; FMA's register tile is rows already. Stores are float4 and
//   streaming when N % 4 = 0.
// Each copy is computed, and in the same order as every other copy of the
// same tile, so copies are equal bit for bit.
//
// P2 replaces tools/kernel_probe.py:_loop_mm_kernel and _batched_mm_kernel
// (probe_issue_overhead): reps × Σ_i A·B_i over n_img images, bf16 inputs,
// f32 accumulation, on warpgroup wgmma (wgmma.cuh) across the card, in two
// structures with one output:
//   kLoop     the image × rep products in the TPU kernel's order, reps
//             outer and images inner (product q is image q mod n_img), are
//             split into contiguous slices, one per CTA; each CTA stages
//             each of its products' B_i in turn and issues the product into
//             one running register accumulator (K1's per-image structure),
//             and a second pass sums the per-CTA partials;
//   kBatched  the wide product W = A·[B_0 … B_{n−1}] (96 × n_img·128), one
//             column block per CTA (its B_i staged once, an accumulator
//             over the reps), then the column-block reduction (K4's
//             structure).
// Both second passes add in a fixed order (no atomics), so a result is the
// same on every run. Layout: 96 rows are not a multiple of wgmma's 64, so
// each CTA computes outᵀ (128 × 96) as two m64n96k16 tiles, one per
// warpgroup: wgmma's A is B_iᵀ (rows n, K-major: B_i is transposed while
// it is staged into shared memory) and its B is A itself (rows m, K
// contiguous as stored). Both operands K-major keeps one descriptor form
// for P2 and K4 (TF32 takes K-major only). What bounds it: 2·M·K·N·
// n_img·reps at 989 TFLOP/s bf16 is under a microsecond, as is reading B
// once; at the probe's size the launch, the staging of each B_i and the
// partials' round trip through L2 are what remain, which is what the
// probe compares between the two structures.

#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

namespace wg = bioem_wgmma;

// ---------------------------------------------------------------------------
// P1
// ---------------------------------------------------------------------------

enum Scheme : int { kFma = 0, kTf32x3 = 1, kTf32 = 2, kF64Tc = 3 };  // ops/probe_cuda.py SCHEMES

constexpr int TM = 48;          // output rows per tile
constexpr int TN = 256;         // output columns per tile
constexpr int TK = 32;          // rows of K per ring stage
constexpr int NS = 4;           // ring stages
constexpr int LDB = TN + 8;     // row stride of a stage: fragment reads (k t, column g) hit 32 banks
constexpr int kMaxKA = 224;     // depth of A's resident slab (a multiple of TK)

__host__ __device__ constexpr bool is_tf32(int S) { return S == kTf32x3 || S == kTf32; }
// Threads per CTA: FMA's register tile wants two warpgroups of 6×8
// outputs per thread; the tensor-core schemes take four, each a 64-column
// quarter, for more warpgroups to hide each other's waits.
__host__ __device__ constexpr int threads(int S) { return S == kFma ? 256 : 512; }

// Shared-memory carve-up, the same on the host and in the kernel: A's
// slab, then the ring of B stages (the C tile goes out through the stage
// just consumed).
struct P1Layout {
  int ka, lda;         // slab depth; FP64 row stride in doubles (≡ 4 mod 16)
  size_t ring, bytes;  // byte offset of the ring; the total
};

__host__ __device__ inline P1Layout p1_layout(int S, int K) {
  P1Layout L;
  const int kr = (K + TK - 1) / TK * TK;
  L.ka = kr < kMaxKA ? kr : kMaxKA;
  L.lda = L.ka + 4;
  if (S == kFma || S == kTf32) L.ring = (size_t)TM * L.ka * 4;
  else if (S == kTf32x3) L.ring = 2 * (size_t)TM * L.ka * 4;  // hi, lo
  else L.ring = (size_t)TM * L.lda * 8;
  L.bytes = L.ring + (size_t)NS * TK * LDB * 4;
  return L;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// FP64 mma.sync m16n8k16: d += a·b. Fragments (g = lane / 4, t = lane %
// 4): a[i] is (row g + 8·(i mod 2), k t + 4·(i / 2)), b[i] (k t + 4i,
// column g), d[0..1] (row g, columns 2t, 2t + 1), d[2..3] the same at row
// g + 8.
__device__ __forceinline__ void mma_f64(double (&d)[4], const double (&a)[8],
                                        const double (&b)[4]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f64.f64.f64.f64 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7, %8, %9, %10, %11}, {%12, %13, %14, %15}, {%0, %1, %2, %3};\n"
      : "+d"(d[0]), "+d"(d[1]), "+d"(d[2]), "+d"(d[3])
      : "d"(a[0]), "d"(a[1]), "d"(a[2]), "d"(a[3]), "d"(a[4]), "d"(a[5]), "d"(a[6]),
        "d"(a[7]), "d"(b[0]), "d"(b[1]), "d"(b[2]), "d"(b[3]));
}

template <int S>
__global__ void __launch_bounds__(threads(S), 1)
product_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
               int M, int K, int N, int batch, bool vec) {
  constexpr int NT = threads(S);
  constexpr int WC = TN * 128 / NT;  // columns per warpgroup (TF32: one m64 tile)
  constexpr int NJ = WC / 32;        // FP64: n8 tiles per warp
  constexpr int MT = TM / 16;        // FP64: m16 tiles per warp
  extern __shared__ __align__(1024) unsigned char smem[];
  const P1Layout L = p1_layout(S, K);
  unsigned char* As = smem;
  float* ring = reinterpret_cast<float*>(smem + L.ring);
  const uint32_t kb = 4u * L.ka;  // TF32: bytes of K per row of A

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3, wgi = warp >> 2, wt = tid & 127;
  const int n_nt = (N + TN - 1) / TN, n_mt = (M + TM - 1) / TM, n_kc = (K + TK - 1) / TK;
  const int n_items = n_mt * batch * n_nt;

  // Items (row tile, copy, column tile), columns fastest: this CTA's are
  // blockIdx.x + r·gridDim.x, each n_kc stages of B in turn. The issue
  // cursor (item, stage) runs NS − 1 stages ahead of the products. Each
  // warpgroup loads, computes and stores its own WC columns and waits only
  // for itself (named barrier 1 + wgi), so that the warpgroups drift apart
  // and fill each other's gaps.
  int is_it = blockIdx.x, is_c = 0, is_n0 = (blockIdx.x % n_nt) * TN;
  auto issue = [&](float* dst) {
    if (is_it < n_items) {
      const int k0 = is_c * TK, n0 = is_n0;
      if (vec) {
#pragma unroll
        for (int u = 0; u < TK * WC / 4 / 128; ++u) {
          const int e = wt + u * 128;
          const int r = e / (WC / 4), c4 = WC * wgi + 4 * (e - r * (WC / 4));
          const bool ok = k0 + r < K && n0 + c4 < N;  // N % 4 = 0: all four or none
          cp_async16(dst + r * LDB + c4, ok ? B + (size_t)(k0 + r) * N + n0 + c4 : B, ok ? 16 : 0);
        }
      } else {
#pragma unroll 4
        for (int u = 0; u < TK * WC / 128; ++u) {
          const int e = wt + u * 128;
          const int r = e / WC, cc = WC * wgi + e - r * WC;
          const bool ok = k0 + r < K && n0 + cc < N;
          cp_async4(dst + r * LDB + cc, ok ? B + (size_t)(k0 + r) * N + n0 + cc : B, ok ? 4 : 0);
        }
      }
      if (++is_c == n_kc) {
        is_c = 0;
        is_it += gridDim.x;
        is_n0 = (is_it % n_nt) * TN;
      }
    }
    cp_commit();  // an empty group past the end keeps the count of groups
  };

  // A's rows [48·mt, 48·mt + 48) × K [k_base, k_base + ka) in the scheme's
  // form, zero outside A; U loads in flight per thread.
  auto form_a = [&](int mt, int k_base) {
    const int ka = L.ka;
    constexpr int U = 16;
    for (int e0 = tid; e0 < TM * ka; e0 += U * NT) {
      float xs[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT, r = e / ka, gm = mt * TM + r, gk = k_base + e - r * ka;
        xs[u] = e < TM * ka && gm < M && gk < K ? A[(size_t)gm * K + gk] : 0.f;
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = e0 + u * NT, r = e / ka, k = e - r * ka;
        if (e >= TM * ka) break;
        if constexpr (S == kFma) {
          reinterpret_cast<float*>(As)[k * TM + r] = xs[u];
        } else if constexpr (is_tf32(S)) {
          const uint32_t hi = wg::to_tf32(xs[u]);
          const uint32_t off = wg::offset_km(r, 4 * k, kb);
          *reinterpret_cast<uint32_t*>(As + off) = hi;
          if constexpr (S == kTf32x3)
            *reinterpret_cast<uint32_t*>(As + (size_t)TM * kb + off) =
                wg::to_tf32(xs[u] - __uint_as_float(hi));
        } else {
          reinterpret_cast<double*>(As)[r * L.lda + k] = (double)xs[u];
        }
      }
    }
  };

  // Register tiles, in warpgroup wgi's columns [WC·wgi, WC·wgi + WC). FMA:
  // rows fr + r (r < 6), columns fc + u and fc + 64 + u (u < 4), a warp 12
  // rows × 128 columns. TF32: an m64 tile of Cᵀ, rows (columns n of C) tn
  // (+8), columns m 8j + 2t (+1). FP64: warp w takes
  // columns (WC/4)·w + 8j + 2t (+1), j < NJ, rows 16i + g (+8).
  const int fr = (warp & 3) * 12 + (lane >> 4) * 6, fc = WC * wgi + (lane & 15) * 4;
  const int tn = WC * wgi + 16 * (warp & 3) + g;
  float fa[6][8];
  float sum[24], st[24];
  double da[MT][NJ][4];
  auto zero = [&]() {
    if constexpr (S == kFma) {
#pragma unroll
      for (int r = 0; r < 6; ++r)
#pragma unroll
        for (int u = 0; u < 8; ++u) fa[r][u] = 0.f;
    } else if constexpr (is_tf32(S)) {
#pragma unroll
      for (int r = 0; r < 24; ++r) sum[r] = 0.f;
    } else {
#pragma unroll
      for (int i = 0; i < MT; ++i)
#pragma unroll
        for (int j = 0; j < NJ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) da[i][j][e] = 0.0;
    }
  };

  // The products of one stage: its rows [0, depth) hold K (depth ≥ 1), at
  // k_off of A's slab.
  auto compute = [&](const float* Bs, int k_off, int depth) {
    if constexpr (S == kFma) {
      const float* Af = reinterpret_cast<const float*>(As) + (size_t)k_off * TM + fr;
#pragma unroll 8
      for (int k = 0; k < TK; ++k) {
        const float2 a0 = *reinterpret_cast<const float2*>(Af + k * TM);
        const float2 a1 = *reinterpret_cast<const float2*>(Af + k * TM + 2);
        const float2 a2 = *reinterpret_cast<const float2*>(Af + k * TM + 4);
        const float4 b0 = *reinterpret_cast<const float4*>(Bs + k * LDB + fc);
        const float4 b1 = *reinterpret_cast<const float4*>(Bs + k * LDB + fc + 64);
        const float a[6] = {a0.x, a0.y, a1.x, a1.y, a2.x, a2.y};
        const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int r = 0; r < 6; ++r)
#pragma unroll
          for (int u = 0; u < 8; ++u) fa[r][u] = fmaf(a[r], b[u], fa[r][u]);
      }
    } else if constexpr (is_tf32(S)) {
      constexpr int NSTEP = TK / 8;
      const unsigned char* a_hi = As + 256 * (k_off / 8);
      const unsigned char* a_lo = a_hi + (size_t)TM * kb;
      const int n_s = (min(depth, TK) + 7) / 8;  // k8 steps holding K
      // Fragment of step s: rows n = g, g + 8 and k = t, t + 4 of Bᵀ, split
      // into TF32 hi (and lo).
      uint32_t h[NSTEP][4], l[NSTEP][4];
      auto frag = [&](int s, uint32_t (&hs)[4], uint32_t (&ls)[4]) {
        const float* b = Bs + (8 * s + t) * LDB + tn;
        const float x[4] = {b[0], b[8], b[4 * LDB], b[4 * LDB + 8]};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hs[e] = wg::to_tf32(x[e]);
          if constexpr (S == kTf32x3) ls[e] = wg::to_tf32(x[e] - __uint_as_float(hs[e]));
        }
      };
      auto dsc = [&](const unsigned char* a, int s) { return wg::desc(a + 256 * s, 128, 8 * kb); };
      if constexpr (S == kTf32) {
        // One accumulator through every step: the stage's steps issued
        // together.
#pragma unroll
        for (int s = 0; s < NSTEP; ++s)
          if (s < n_s) frag(s, h[s], l[s]);
        wg::fence();
#pragma unroll
        for (int s = 0; s < NSTEP; ++s)
          if (s < n_s) wg::Tf32RS<48>::mma(sum, h[s], dsc(a_hi, s), 1);
        wg::commit();
        wg::wait<0>();
        wg::fence_operand(sum);
      } else {
        // K4's order: step s's products, into a zeroed accumulator, run
        // while step s + 1's fragment is formed; then they are added to
        // the sum. (Two accumulators in turn, wait<1> overlapping the adds
        // with the next step, spill at 512 threads' 128 registers and ptxas
        // serialises the wgmma: 4.7–5.1× slower, PERF.md §6.)
        frag(0, h[0], l[0]);
#pragma unroll
        for (int s = 0; s < NSTEP; ++s) {
          if (s < n_s) {
            wg::tf32x3_step<48>(st, h[s], l[s], dsc(a_hi, s), dsc(a_lo, s));
            constexpr int kLast = NSTEP - 1;
            if (s + 1 < n_s) frag(s + 1, h[s < kLast ? s + 1 : kLast], l[s < kLast ? s + 1 : kLast]);
            wg::wait<0>();
            wg::fence_operand(st);
#pragma unroll
            for (int r = 0; r < 24; ++r) sum[r] += st[r];
          }
        }
      }
    } else {
      const double* Ad = reinterpret_cast<const double*>(As) + k_off;
      const float* bcol = Bs + WC / 4 * warp + g;
#pragma unroll
      for (int kk = 0; kk < TK; kk += 16) {
        if (kk < depth) {
          double b[NJ][4];
#pragma unroll
          for (int j = 0; j < NJ; ++j)
#pragma unroll
            for (int i = 0; i < 4; ++i) b[j][i] = (double)bcol[(kk + t + 4 * i) * LDB + 8 * j];
#pragma unroll
          for (int i = 0; i < MT; ++i) {
            double a[8];
#pragma unroll
            for (int e = 0; e < 8; ++e)
              a[e] = Ad[(size_t)(16 * i + g + 8 * (e % 2)) * L.lda + kk + t + 4 * (e / 2)];
#pragma unroll
            for (int j = 0; j < NJ; ++j) mma_f64(da[i][j], a, b[j]);
          }
        }
      }
    }
  };

  // The tile of item (mt, z, nt) out. FMA's register tile is rows already
  // (a half-warp writes 256 contiguous bytes of a row); the others go out
  // as rows through Cs, the warpgroup's columns of the stage it has just
  // consumed (the next copy into it follows the next barrier), 24 rows at
  // a time.
  auto store = [&](int mt, int z, int nt, float* Cs) {
    const int m0 = mt * TM, n0 = nt * TN;
    const int rows = min(TM, M - m0), cols = min(TN, N - n0);
    float* Cz = C + (size_t)z * M * N + (size_t)m0 * N + n0;
    if constexpr (S == kFma) {
#pragma unroll
      for (int r = 0; r < 6; ++r) {
        if (fr + r >= rows) break;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c0 = fc + 64 * h;
          float* dst = Cz + (size_t)(fr + r) * N + c0;
          if (vec) {
            if (c0 < cols)
              __stcs(reinterpret_cast<float4*>(dst), make_float4(fa[r][4 * h], fa[r][4 * h + 1],
                                                                 fa[r][4 * h + 2], fa[r][4 * h + 3]));
          } else {
#pragma unroll
            for (int u = 0; u < 4; ++u)
              if (c0 + u < cols) dst[u] = fa[r][4 * h + u];
          }
        }
      }
      return;
    }
    constexpr int HR = TM / 2;  // rows per pass
#pragma unroll
    for (int pass = 0; pass < 2; ++pass) {
      wg::wg_barrier(1 + wgi);  // the stage's (or the last pass's) reads are done
      if constexpr (is_tf32(S)) {
#pragma unroll
        for (int j = 3 * pass; j < 3 * pass + 3; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            Cs[(8 * j + 2 * t + (e & 1) - HR * pass) * LDB + tn + 8 * (e >> 1)] = sum[4 * j + e];
      } else {
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            if ((16 * i + 8 * h) / HR != pass) continue;  // rows 16i + 8h + g lie in one pass
#pragma unroll
            for (int j = 0; j < NJ; ++j)
              *reinterpret_cast<float2*>(Cs + (16 * i + g + 8 * h - HR * pass) * LDB +
                                         WC / 4 * warp + 8 * j + 2 * t) =
                  make_float2((float)da[i][j][2 * h], (float)da[i][j][2 * h + 1]);
          }
      }
      wg::wg_barrier(1 + wgi);
      const int pr = min(HR, rows - HR * pass);  // rows of this pass in C
      float* Cp = Cz + (size_t)HR * pass * N;
      if (vec) {
#pragma unroll
        for (int u = 0; u < HR * WC / 4 / 128; ++u) {
          const int e = wt + u * 128;
          const int r = e / (WC / 4), c4 = WC * wgi + 4 * (e - r * (WC / 4));
          if (r < pr && c4 < cols)
            __stcs(reinterpret_cast<float4*>(Cp + (size_t)r * N + c4),
                   *reinterpret_cast<const float4*>(Cs + r * LDB + c4));
        }
      } else {
        for (int e = wt; e < HR * WC; e += 128) {
          const int r = e / WC, cc = WC * wgi + e - r * WC;
          if (r < pr && cc < cols) Cp[(size_t)r * N + cc] = Cs[r * LDB + cc];
        }
      }
    }
  };

#pragma unroll 1
  for (int q = 0; q < NS - 1; ++q) issue(ring + q * TK * LDB);
  int q = 0, res_mt = -1, res_kb = -1;
#pragma unroll 1
  for (int it = blockIdx.x; it < n_items; it += gridDim.x) {
    const int nt = it % n_nt, z = (it / n_nt) % batch, mt = it / n_nt / batch;
    zero();
#pragma unroll 1
    for (int c = 0; c < n_kc; ++c, ++q) {
      cp_wait<NS - 2>();         // stage q has landed (this thread's copies) …
      wg::wg_barrier(1 + wgi);  // … the warpgroup's; its columns of stage q − 1 are free
      issue(ring + (q + NS - 1) % NS * TK * LDB);
      const int k_base = c * TK / L.ka * L.ka;
      if (mt != res_mt || k_base != res_kb) {
        // Every warpgroup reaches this stage: once all are done with the
        // old slab, all threads form the new one.
        __syncthreads();
        form_a(mt, k_base);
        if constexpr (is_tf32(S)) wg::fence_proxy_async();
        __syncthreads();
        res_mt = mt;
        res_kb = k_base;
      }
      compute(ring + q % NS * TK * LDB, c * TK - k_base, K - c * TK);
    }
    store(mt, z, nt, ring + (q - 1) % NS * TK * LDB);
  }
}

template <int S>
int launch_product(const float* A, const float* B, float* C, int M, int K, int N, int batch,
                   cudaStream_t stream) {
  const size_t smem = p1_layout(S, K).bytes;
  cudaError_t err = cudaFuncSetAttribute(product_kernel<S>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  int dev = 0, n_sm = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return (int)err;
  const long long n_items = (long long)((M + TM - 1) / TM) * batch * ((N + TN - 1) / TN);
  const int grid = (int)(n_items < n_sm ? n_items : n_sm);
  if (n_items > INT_MAX || (n_items + grid - 1) / grid * ((K + TK - 1) / TK) > INT_MAX)
    return (int)cudaErrorInvalidValue;
  const bool vec = N % 4 == 0 && (reinterpret_cast<uintptr_t>(B) | reinterpret_cast<uintptr_t>(C)) % 16 == 0;
  product_kernel<S><<<grid, threads(S), smem, stream>>>(A, B, C, M, K, N, batch, vec);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// P2
// ---------------------------------------------------------------------------

enum Structure : int { kLoop = 0, kBatched = 1 };

constexpr int kP2M = 96, kP2N = 128;  // A (96, K), B_i (K, 128)
constexpr int kSThreads = 256;        // two warpgroups: outᵀ rows [64h, 64h + 64)
constexpr int kMaxK = 128;
constexpr int kMaxSlices = 128;       // loop: CTAs (per-CTA partials) at most

// CTA b sums the products q ∈ [b·per, (b + 1)·per) ∩ [0, n_img·reps) into
// one accumulator and writes it (96 × 128, f32) to dst + b·bstride with row
// stride rs. Product q is of image q mod n_img (rep_major: the loop) or
// q / reps (the batched structure's column blocks).
__global__ void __launch_bounds__(kSThreads)
product_sum_kernel(const uint16_t* __restrict__ A, const uint16_t* __restrict__ B,
                   float* __restrict__ dst, int K, int n_img, int reps, int per,
                   bool rep_major, size_t bstride, int rs) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const uint32_t kb = 2u * K;  // bytes of K per row
  unsigned char* As = smem;
  unsigned char* Bs = smem + kP2M * kb;
  const int tid = threadIdx.x, h = tid >> 7, lane = tid & 31, warp = (tid & 127) >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int kc = K / 8;  // 16-byte chunks per row
  // Staging: every load of a pass is issued before its stores.
  constexpr int kAIt = (kP2M * (kMaxK / 8) + kSThreads - 1) / kSThreads;
  constexpr int kBIt = (kMaxK * (kP2N / 8) + kSThreads - 1) / kSThreads;
  {
    uint4 v[kAIt];
#pragma unroll
    for (int r = 0; r < kAIt; ++r) {
      const int q = tid + r * kSThreads;
      if (q < kP2M * kc) v[r] = reinterpret_cast<const uint4*>(A + (size_t)(q / kc) * K)[q % kc];
    }
#pragma unroll
    for (int r = 0; r < kAIt; ++r) {
      const int q = tid + r * kSThreads;
      if (q < kP2M * kc)
        *reinterpret_cast<uint4*>(As + wg::offset_km(q / kc, 16 * (q % kc), kb)) = v[r];
    }
  }
  const int q0 = blockIdx.x * per;
  const int q1 = min(q0 + per, n_img * reps);
  float acc[48];
#pragma unroll
  for (int r = 0; r < 48; ++r) acc[r] = 0.f;
  int cur = -1;
  for (int q = q0; q < q1; ++q) {
    const int i = rep_major ? q % n_img : q / reps;
    if (i != cur) {
      __syncthreads();  // both warpgroups are done reading the last B_i
      // B_i (K × 128, n contiguous) → B_iᵀ rows n, K-major. Neighbouring
      // threads take neighbouring k, so that their 2-byte stores spread
      // over the banks.
      const uint16_t* Bi = B + (size_t)i * K * kP2N;
      uint4 v[kBIt];
#pragma unroll
      for (int r = 0; r < kBIt; ++r) {
        const int q = tid + r * kSThreads;
        if (q < K * (kP2N / 8))
          v[r] = *reinterpret_cast<const uint4*>(Bi + (size_t)(q % K) * kP2N + 8 * (q / K));
      }
#pragma unroll
      for (int r = 0; r < kBIt; ++r) {
        const int q = tid + r * kSThreads;
        if (q < K * (kP2N / 8)) {
          const int n0 = 8 * (q / K), k = q % K;
          const uint16_t* e = reinterpret_cast<const uint16_t*>(&v[r]);
#pragma unroll
          for (int u = 0; u < 8; ++u)
            *reinterpret_cast<uint16_t*>(Bs + wg::offset_km(n0 + u, 2 * k, kb)) = e[u];
        }
      }
      wg::fence_proxy_async();
      __syncthreads();
      cur = i;
    }
    wg::fence();
    for (int ks = 0; ks < K / 16; ++ks)
      wg::Bf16SS<96>::mma(acc, wg::desc(Bs + 64u * h * kb + 256 * ks, 128, 8 * kb),
                          wg::desc(As + 256 * ks, 128, 8 * kb), 1);
    wg::commit();
    wg::wait<0>();
    wg::fence_operand(acc);
  }
  // acc (row n = 64h + 16·warp + g (+8), column m = 8j + 2t (+1)) → dst[m][n]
  float* out = dst + blockIdx.x * bstride;
#pragma unroll
  for (int j = 0; j < 12; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = 64 * h + 16 * warp + g + 8 * (e >> 1), m = 8 * j + 2 * t + (e & 1);
      out[(size_t)m * rs + n] = acc[4 * j + e];
    }
}

// out[m][n] = Σ_b src[b·bstride + m·rs + n], in a fixed order (the same
// bits on every run): a block takes 64 outputs; thread (z, o) sums the
// quarter z of the b range for output o in eight running sums (b mod 8,
// each in order of b), and thread (0, o) adds the eight, then the four
// quarters, in order. Eight loads per thread in flight, four threads per
// output.
constexpr int kSumOut = 64;

__global__ void __launch_bounds__(4 * kSumOut)
sum_blocks_kernel(const float* __restrict__ src, float* __restrict__ out, int nb,
                  size_t bstride, int rs) {
  __shared__ float part[4][kSumOut];
  const int o = threadIdx.x % kSumOut, z = threadIdx.x / kSumOut;
  const int q = blockIdx.x * kSumOut + o;  // kP2M·kP2N is a multiple of kSumOut
  const float* s = src + (size_t)(q / kP2N) * rs + q % kP2N;
  const int per = (nb + 3) / 4;
  const int b0 = z * per, b1 = min(b0 + per, nb);
  float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  int b = b0;
  for (; b + 8 <= b1; b += 8)
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] += s[(size_t)(b + u) * bstride];
#pragma unroll
  for (int u = 0; u < 8; ++u)
    if (b + u < b1) acc[u] += s[(size_t)(b + u) * bstride];
  float total = 0.f;
#pragma unroll
  for (int u = 0; u < 8; ++u) total += acc[u];
  part[z][o] = total;
  __syncthreads();
  if (z == 0) out[q] = ((part[0][o] + part[1][o]) + part[2][o]) + part[3][o];
}

}  // namespace

extern "C" {

// P1: C[z] = A·B for z < batch, A (M, K) and B (K, N) f32 row-major, in
// scheme ``scheme`` (0 FMA, 1 3xTF32, 2 1xTF32, 3 FP64 tensor cores).
int bioem_probe_f32_product(int scheme, const float* A, const float* B, float* C, int M,
                            int K, int N, int batch, void* stream) {
  if (M < 1 || K < 1 || N < 1 || batch < 1 || batch > 65535) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (scheme) {
    case kFma: return launch_product<kFma>(A, B, C, M, K, N, batch, s);
    case kTf32x3: return launch_product<kTf32x3>(A, B, C, M, K, N, batch, s);
    case kTf32: return launch_product<kTf32>(A, B, C, M, K, N, batch, s);
    case kF64Tc: return launch_product<kF64Tc>(A, B, C, M, K, N, batch, s);
  }
  return (int)cudaErrorInvalidValue;
}

// P2: out = reps · Σ_i A·B_i, A (96, K) and B (n_img, K, 128) bf16
// row-major, out (96, 128) f32, in structure ``structure`` (0 loop,
// 1 batched), ``per`` products per CTA (loop: in order reps outer, images
// inner; batched: per = reps, one image per CTA). ``scratch`` holds the CTAs' partials: ⌈n_img·reps / per⌉ blocks of
// 96 × 128 f32 for the loop, the wide product (96 × n_img·128 f32) for
// the batched structure.
int bioem_probe_product_sum(int structure, const void* A, const void* B, float* out,
                            float* scratch, int M, int K, int N, int n_img, int reps, int per,
                            void* stream) {
  if (M != kP2M || N != kP2N || K < 16 || K % 16 || K > kMaxK || n_img < 1 || reps < 1 ||
      per < 1 || scratch == nullptr)
    return (int)cudaErrorInvalidValue;
  const int n_cta = (n_img * reps + per - 1) / per;
  size_t bstride;
  int rs;
  if (structure == kLoop) {
    if (n_cta > kMaxSlices) return (int)cudaErrorInvalidValue;
    bstride = (size_t)kP2M * kP2N;
    rs = kP2N;
  } else if (structure == kBatched) {
    if (per != reps) return (int)cudaErrorInvalidValue;
    bstride = kP2N;
    rs = n_img * kP2N;
  } else {
    return (int)cudaErrorInvalidValue;
  }
  const int smem = (kP2M + kP2N) * 2 * K;
  cudaError_t err = cudaFuncSetAttribute(product_sum_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t s = (cudaStream_t)stream;
  product_sum_kernel<<<n_cta, kSThreads, smem, s>>>(
      static_cast<const uint16_t*>(A), static_cast<const uint16_t*>(B), scratch, K, n_img, reps,
      per, structure == kLoop, bstride, rs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  sum_blocks_kernel<<<kP2M * kP2N / kSumOut, 4 * kSumOut, 0, s>>>(scratch, out, n_cta, bstride,
                                                                   rs);
  return (int)cudaGetLastError();
}

}  // extern "C"

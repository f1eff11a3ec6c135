// Kernel probes P1 and P2 for Hopper (sm_90a). P3, the ablation of the
// production comparison bodies, is a template parameter of compare_fused.cu (K1)
// and compare_batched.cu (K4) instead of a copy of them.
//
// P1 replaces tools/kernel_probe.py:_f32_dot_kernel (probe_f32_accuracy).
// The TPU question was whether Mosaic lowers an f32 dot in several bf16
// passes or casts it to one. The card's question is which product scheme
// holds the port's f32 accuracy contract, and at what cost: the same
// C = A·B in each scheme the port runs or could run,
//   kFma     FP32 FMA on the CUDA cores (the earlier K1's and K3's stage 1),
//   kTf32x3  3xTF32 wmma m16n16k8, each k-step added in IEEE f32
//            (tf32x3.cuh; K4's stage 1 runs the same scheme on wgmma),
//   kTf32    1xTF32 wmma chained through one accumulator (the precision
//            trap of ROADMAP's precision rules),
//   kF64Tc   FP64 tensor cores (mma.sync m8n8k4 f64) on operands widened
//            from f32, rounded to f32 once at the end.
// What bounds it: the operations of the scheme (2·M·K·N per product in f32
// on the CUDA cores at 67 TFLOP/s, three TF32 products at 495 TFLOP/s,
// FP64 tensor cores at 67 TFLOP/s). Design: one block of four warps per
// 48×64 output tile (48 rows: K4's 2·Dp stage-1 rows, and half the TPU
// probe's 96), A and B staged through shared memory in 32-deep chunks,
// zero-padded at the ragged edges, and each thread or warp holding a
// register tile that reuses every staged value several times (FMA: 6×4
// outputs per thread; wmma: three 16×16 tiles per warp; FP64: twelve 8×8
// tiles per warp), so that the scheme's arithmetic and not the staging
// sets the time. ``batch`` blocks of the grid's z dimension repeat the
// product into separate outputs, so that the scheme is timed at the size
// of K4's stage 1 over a production block, not where the launch dominates.
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
#include <mma.h>
#include <stdint.h>

#include "tf32x3.cuh"
#include "wgmma.cuh"

using namespace nvcuda;

namespace {

// ---------------------------------------------------------------------------
// P1
// ---------------------------------------------------------------------------

enum Scheme : int { kFma = 0, kTf32x3 = 1, kTf32 = 2, kF64Tc = 3 };

constexpr int kPThreads = 128;  // four warps
constexpr int TM = 48, TN = 64, TK = 32;
constexpr int LDA = TK + 4, LDB = TN + 4, LDC = TN + 4;  // wmma: multiples of 4 floats
constexpr int FR = TM / 8, FC = TN / 16;  // FMA register tile: rows ty + 8r, columns tx + 16c

__device__ __forceinline__ void mma_f64(double (&c)[2], double a, double b) {
  asm volatile(
      "mma.sync.aligned.m8n8k4.row.col.f64.f64.f64.f64 {%0, %1}, {%2}, {%3}, {%0, %1};\n"
      : "+d"(c[0]), "+d"(c[1])
      : "d"(a), "d"(b));
}

template <int S>
__global__ void __launch_bounds__(kPThreads)
product_kernel(const float* __restrict__ A, const float* __restrict__ B, float* __restrict__ C,
               int M, int K, int N) {
  __shared__ __align__(32) float As[TM * LDA];
  __shared__ __align__(32) float Bs[TK * LDB];
  __shared__ __align__(32) float Cs[TM * LDC];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  float* Cb = C + (size_t)blockIdx.z * M * N;

  // FMA: thread (tx, ty) = (tid % 16, tid / 16) owns FR × FC outputs.
  // wmma: warp w owns columns [16w, 16w + 16) in three 16-row tiles.
  // FP64: warp w owns the same columns as 2 × 6 tiles of 8×8.
  const int tx = tid & 15, ty = tid >> 4;
  const int g = lane >> 2, tg = lane & 3;  // FP64 fragment coordinates
  float fa[FR][FC];
  double da[TM / 8][2][2];
  wmma::fragment<wmma::accumulator, 16, 16, 8, float> acc[TM / 16], step;
  if constexpr (S == kFma) {
#pragma unroll
    for (int r = 0; r < FR; ++r)
#pragma unroll
      for (int c = 0; c < FC; ++c) fa[r][c] = 0.f;
  } else if constexpr (S == kF64Tc) {
#pragma unroll
    for (int r = 0; r < TM / 8; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c) da[r][c][0] = da[r][c][1] = 0.0;
  } else {
#pragma unroll
    for (int mt = 0; mt < TM / 16; ++mt) wmma::fill_fragment(acc[mt], 0.f);
  }

  for (int k0 = 0; k0 < K; k0 += TK) {
    for (int q = tid; q < TM * TK; q += kPThreads) {
      const int r = q / TK, c = q - r * TK;
      As[r * LDA + c] = (m0 + r < M && k0 + c < K) ? A[(size_t)(m0 + r) * K + k0 + c] : 0.f;
    }
    for (int q = tid; q < TK * TN; q += kPThreads) {
      const int r = q / TN, c = q - r * TN;
      Bs[r * LDB + c] = (k0 + r < K && n0 + c < N) ? B[(size_t)(k0 + r) * N + n0 + c] : 0.f;
    }
    __syncthreads();
    if constexpr (S == kFma) {
#pragma unroll 4
      for (int k = 0; k < TK; ++k) {
        float a[FR], b[FC];
#pragma unroll
        for (int r = 0; r < FR; ++r) a[r] = As[(ty + 8 * r) * LDA + k];
#pragma unroll
        for (int c = 0; c < FC; ++c) b[c] = Bs[k * LDB + tx + 16 * c];
#pragma unroll
        for (int r = 0; r < FR; ++r)
#pragma unroll
          for (int c = 0; c < FC; ++c) fa[r][c] = fmaf(a[r], b[c], fa[r][c]);
      }
    } else if constexpr (S == kF64Tc) {
#pragma unroll
      for (int ks = 0; ks < TK / 4; ++ks) {
        double b[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) b[c] = (double)Bs[(ks * 4 + tg) * LDB + warp * 16 + c * 8 + g];
#pragma unroll
        for (int r = 0; r < TM / 8; ++r) {
          const double a = (double)As[(r * 8 + g) * LDA + ks * 4 + tg];
#pragma unroll
          for (int c = 0; c < 2; ++c) mma_f64(da[r][c], a, b[c]);
        }
      }
    } else {
#pragma unroll
      for (int ks = 0; ks < TK / 8; ++ks) {
        wmma::fragment<wmma::matrix_a, 16, 16, 8, wmma::precision::tf32, wmma::row_major> a_hi, a_lo;
        wmma::fragment<wmma::matrix_b, 16, 16, 8, wmma::precision::tf32, wmma::row_major> b_hi, b_lo;
        wmma::load_matrix_sync(b_hi, Bs + ks * 8 * LDB + warp * 16, LDB);
        if constexpr (S == kTf32x3) {
          bioem_tf32x3::split(b_hi, b_lo);
        } else {
#pragma unroll
          for (int t = 0; t < b_hi.num_elements; ++t) b_hi.x[t] = wmma::__float_to_tf32(b_hi.x[t]);
        }
#pragma unroll
        for (int mt = 0; mt < TM / 16; ++mt) {
          wmma::load_matrix_sync(a_hi, As + mt * 16 * LDA + ks * 8, LDA);
          if constexpr (S == kTf32x3) {
            bioem_tf32x3::split(a_hi, a_lo);
            bioem_tf32x3::mma_step(acc[mt], step, a_hi, a_lo, b_hi, b_lo);
          } else {
#pragma unroll
            for (int t = 0; t < a_hi.num_elements; ++t) a_hi.x[t] = wmma::__float_to_tf32(a_hi.x[t]);
            wmma::mma_sync(acc[mt], a_hi, b_hi, acc[mt]);
          }
        }
      }
    }
    __syncthreads();
  }

  // The block's tile to shared memory, then its in-range part out.
  if constexpr (S == kFma) {
#pragma unroll
    for (int r = 0; r < FR; ++r)
#pragma unroll
      for (int c = 0; c < FC; ++c) Cs[(ty + 8 * r) * LDC + tx + 16 * c] = fa[r][c];
  } else if constexpr (S == kF64Tc) {
#pragma unroll
    for (int r = 0; r < TM / 8; ++r)
#pragma unroll
      for (int c = 0; c < 2; ++c)
#pragma unroll
        for (int h = 0; h < 2; ++h)
          Cs[(r * 8 + g) * LDC + warp * 16 + c * 8 + tg * 2 + h] = (float)da[r][c][h];
  } else {
#pragma unroll
    for (int mt = 0; mt < TM / 16; ++mt)
      wmma::store_matrix_sync(Cs + mt * 16 * LDC + warp * 16, acc[mt], LDC, wmma::mem_row_major);
  }
  __syncthreads();
  for (int q = tid; q < TM * TN; q += kPThreads) {
    const int r = q / TN, c = q - r * TN;
    if (m0 + r < M && n0 + c < N) Cb[(size_t)(m0 + r) * N + n0 + c] = Cs[r * LDC + c];
  }
}

template <int S>
int launch_product(const float* A, const float* B, float* C, int M, int K, int N, int batch,
                   cudaStream_t stream) {
  const dim3 grid((N + TN - 1) / TN, (M + TM - 1) / TM, batch);
  product_kernel<S><<<grid, kPThreads, 0, stream>>>(A, B, C, M, K, N);
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
  namespace wg = bioem_wgmma;
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

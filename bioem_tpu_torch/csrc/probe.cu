// Kernel probes P1 and P2 for Hopper (sm_90a). P3, the ablation of the
// production comparison bodies, is a template parameter of compare.cu (K1)
// and compare_batched.cu (K4) instead of a copy of them.
//
// P1 replaces tools/kernel_probe.py:_f32_dot_kernel (probe_f32_accuracy).
// The TPU question was whether Mosaic lowers an f32 dot in several bf16
// passes or casts it to one. The card's question is which product scheme
// holds the port's f32 accuracy contract, and at what cost: the same
// C = A·B in each scheme the port runs or could run,
//   kFma     FP32 FMA on the CUDA cores (K1's stage 1),
//   kTf32x3  3xTF32 wmma m16n16k8, each k-step added in IEEE f32
//            (K4's stage 1, the same code: tf32x3.cuh),
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
// f32 accumulation (wmma m16n16k16), computed in one block (one SM, as the
// TPU probe runs on one core) in two structures with one output:
//   kLoop     one accumulator per output tile; every image's product is
//             issued in turn and added in (K1's per-image structure);
//   kBatched  one wide product A·[B_0 … B_{n−1}] whose tiles are independent
//             accumulators, written to a scratch buffer and then reduced
//             over the column blocks (K4's structure).
// What bounds it: on one SM the issue of mma.sync and of the fragment
// loads, which is the quantity the probe measures; the card-wide bound
// (2·M·K·N·n_img·reps at 989 TFLOP/s bf16) is far below it by design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

#include "tf32x3.cuh"

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

constexpr int kMT = 6;             // 16-row tiles of A: M = 96
constexpr int kNT = 8;             // 16-column tiles per image: N = 128, one per warp
constexpr int kSThreads = kNT * 32;
constexpr int kMaxK = 128;         // A is staged whole in shared memory

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

template <int ST>
__global__ void __launch_bounds__(kSThreads)
product_sum_kernel(const __nv_bfloat16* __restrict__ A, const __nv_bfloat16* __restrict__ B,
                   float* __restrict__ out, float* __restrict__ wide, int K, int n_img,
                   int reps) {
  constexpr int M = kMT * 16, N = kNT * 16;
  __shared__ __align__(32) __nv_bfloat16 As[M * kMaxK];
  const int tid = threadIdx.x, warp = tid >> 5;
  for (int q = tid; q < M * K; q += kSThreads) As[q] = A[q];
  __syncthreads();
  const int n_ks = K / 16;
  FragA a;
  FragB b;
  FragC acc[kMT];

  if constexpr (ST == kLoop) {
    // Warp w owns output columns [16w, 16w + 16): one accumulator per row
    // tile, every image's product added in turn.
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) wmma::fill_fragment(acc[mt], 0.f);
    for (int r = 0; r < reps; ++r)
      for (int i = 0; i < n_img; ++i)
        for (int ks = 0; ks < n_ks; ++ks) {
          wmma::load_matrix_sync(b, B + ((size_t)i * K + ks * 16) * N + warp * 16, N);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            wmma::load_matrix_sync(a, As + mt * 16 * K + ks * 16, K);
            wmma::mma_sync(acc[mt], a, b, acc[mt]);
          }
        }
#pragma unroll
    for (int mt = 0; mt < kMT; ++mt)
      wmma::store_matrix_sync(out + mt * 16 * N + warp * 16, acc[mt], N, wmma::mem_row_major);
  } else {
    // The wide product W = A·[B_0 … B_{n−1}] (M × n_img·N): warp w takes the
    // column tiles w, w + 8, …, each an independent accumulator over the
    // reps, stored to W; then out = Σ_i W[:, i·N : (i+1)·N].
    const int ldw = n_img * N;
    for (int nt = warp; nt < n_img * kNT; nt += kNT) {
      const int i = nt / kNT, c = nt - i * kNT;
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) wmma::fill_fragment(acc[mt], 0.f);
      for (int r = 0; r < reps; ++r)
        for (int ks = 0; ks < n_ks; ++ks) {
          wmma::load_matrix_sync(b, B + ((size_t)i * K + ks * 16) * N + c * 16, N);
#pragma unroll
          for (int mt = 0; mt < kMT; ++mt) {
            wmma::load_matrix_sync(a, As + mt * 16 * K + ks * 16, K);
            wmma::mma_sync(acc[mt], a, b, acc[mt]);
          }
        }
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
        wmma::store_matrix_sync(wide + (size_t)mt * 16 * ldw + nt * 16, acc[mt], ldw,
                                wmma::mem_row_major);
    }
    __syncthreads();
    for (int q = tid; q < M * N; q += kSThreads) {
      const int r = q / N, c = q - r * N;
      const float* w = wide + (size_t)r * ldw + c;
      float s = 0.f;
      for (int i = 0; i < n_img; ++i) s += w[i * N];
      out[q] = s;
    }
  }
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
// 1 batched; the batched one needs ``wide``, 96 × n_img·128 f32). One block.
int bioem_probe_product_sum(int structure, const void* A, const void* B, float* out,
                            float* wide, int M, int K, int N, int n_img, int reps,
                            void* stream) {
  if (M != kMT * 16 || N != kNT * 16 || K < 16 || K % 16 || K > kMaxK || n_img < 1 ||
      reps < 1)
    return (int)cudaErrorInvalidValue;
  const auto* a = static_cast<const __nv_bfloat16*>(A);
  const auto* b = static_cast<const __nv_bfloat16*>(B);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (structure) {
    case kLoop:
      product_sum_kernel<kLoop><<<1, kSThreads, 0, s>>>(a, b, out, wide, K, n_img, reps);
      return (int)cudaGetLastError();
    case kBatched:
      if (wide == nullptr) return (int)cudaErrorInvalidValue;
      product_sum_kernel<kBatched><<<1, kSThreads, 0, s>>>(a, b, out, wide, K, n_img, reps);
      return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"

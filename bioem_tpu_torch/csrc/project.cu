// Radius-grouped Fourier-space projection kernel (K2) for Hopper (sm_90a):
// the group product on warpgroup wgmma in 3xTF32.
//
// Replaces bioem_tpu/ops/project_pallas.py:_project_kernel (with
// _pow_table and _dot3, entry fourier_project_block).
//
// For every orientation o and frequency (k1, k2) of the half spectrum:
//   out[o, k1, k2] = Σ_g Ŝ_g[k1, k2] · S_g[k1, k2],
//   S_g = Ex_gᵀ · diag(dens) · Ey_g,  Ex_g[p, k1] = e^{−2πi·i0[g,o,p]·k1/N},
//                                      Ey_g[p, k2] = e^{−2πi·j0[g,o,p]·k2/N}
// times scale[o] (norm_den/tempden from G3, csrc/project_glue.cu) where a
// scale is given, else UNSCALED: each stored value is one f32 rounding of
// the unscaled sum times scale[o], the product the caller rounded before
// K2 took the scale. Only the first counts[g] slots of group g are read:
// the slots after them are the group's padding, whose density is zero.
// Out-of-bounds points inside the count carry zero density per
// orientation and are summed like the rest.
//
// Phases. The snapped pixel positions i0, j0 are integers, so every Ex and
// Ey entry is an exact table entry tw[(a·k) mod N], tw[j] = e^{−2πi·j/N}
// built in double precision: no sincos of f32 arguments of up to ~10³ rad.
// a·(k mod N) < N² must fit int32 (N ≤ 46340); the table must fit shared
// memory beside the operand tiles (N ≤ kMaxN below).
//
// The least work: the group product, 4 real multiply-adds per (real
// point, k1, k2) per orientation, three times over in 3xTF32 (0.005 ms at
// the TF32 peak for the production block, O=8, 500 points, N=224, F=113);
// Ŝ and the outputs are read and written once per (o, k1, k2). Each
// (point, k1) and each (point, k2) operand is one table entry split into
// TF32 hi and lo. What bounds it measured: see the end of this header.
//
// Design. A CTA owns a 64 (k1) × 32 (k2) output tile of one orientation
// (4 × 4 × O CTAs at N = 224). Its four warpgroups split the orientation's
// real points (the groups' first counts[g] slots, concatenated) into four
// equal runs, and each computes, per group, S for the tile as
//   [S_re | S_im] (64 × 64) = [Xr | Xi] (64 × 2K) · [[Yr, Yi], [−Yi, Yr]],
// X = d·Ex: wgmma m64n64k8, one k8 step holding four points (k 0..3 their
// Re X, 4..7 their Im X), S_re and S_im 32 columns apart so that both
// parts of one frequency land in one thread's accumulator.
// * A (X) is formed straight into registers from the table (a thread's
//   two rows and one point per step); B (the Y blocks) is written by the
//   warpgroup into shared memory in wgmma's layout, hi and lo, for a chunk
//   of up to 32 points of one group (runs of eight k2 per point, the table
//   index stepped by one add; each run starts at a rotated entry so that
//   one store instruction spans all banks).
// * Accuracy: each step issues lo·hi, hi·lo and hi·hi (3xTF32). The steps
//   of one chunk (up to 32 points) chain in the tensor cores' f32
//   accumulator, whose adds truncate; each chunk's accumulator is added to
//   S in IEEE f32. K4 adds every step to its sum instead, because its
//   log-sum-exp amplifies the truncation; a spectrum held to 5e-5 of its
//   largest value does not need that (tests/test_torch_split_precision.py
//   emulates these chains against f64). Chaining lets a step's products
//   run while the next step's A fragment is formed (wait<1>, two fragment
//   buffers): a wait for every step measured 4 % slower (0.0446–0.0454
//   ms).
// * Epilogue per group: the warpgroup adds Ŝ_g ⊙ S into its partial
//   spectrum in shared memory (a group split between two runs has its Ŝ_g
//   applied by both: the spectrum is linear in S); the four partial
//   spectra are summed at the end in a fixed order. No atomics: two
//   launches on the same inputs give the same bits.
// Why wgmma and not FP32 FMA: a design on FP32 FMA register tiles (a
// thread's 4 × 4 frequencies times every point, the same point split and
// table) measured 0.0448–0.0459 ms at the production block against this
// design's 0.0431–0.0437 ms, in one process on one H100, two runs
// (kernel_ab, the card's own time; PERF.md §6). Neither is bound by its
// products: the time grows with the chunks a warpgroup walks (7 µs with
// no points, 0.044 ms with the model's 500, 0.070 ms with all 1120
// slots; kernel_probe.probe_projection_points), each a chain of global
// loads, barriers and operand formation.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "wgmma.cuh"

namespace {

namespace wg = bioem_wgmma;

constexpr int kSlices = 4;  // point runs per CTA, one warpgroup each
constexpr int kSliceThreads = 128;
constexpr int kThreads = kSlices * kSliceThreads;
constexpr int kT1 = 64;                     // k1 per CTA: wgmma's M
constexpr int kT2 = 32;                     // k2 per CTA
constexpr int kNB = 2 * kT2;                // wgmma's N: S_re columns, then S_im
constexpr int kSteps = 8;                   // k8 steps per chunk, four points each
constexpr int kChunk = 4 * kSteps;          // points per chunk
constexpr int kRun = 8;                     // k2 entries per index run
constexpr int kRuns = kT2 / kRun;           // runs per point
constexpr uint32_t kKb = 32 * kSteps;       // bytes of K per B row
constexpr int kBBytes = kNB * kKb;          // one B tile (hi or lo)
constexpr int kAcc = kT1 * kNB / kSliceThreads;  // accumulator floats per thread (32)
// Shared memory: per slice the B tiles hi and lo, the partial spectrum
// [kAcc][128] and the chunk's points; then the twiddle table.
constexpr size_t kSliceBytes = 2 * kBBytes + sizeof(float) * kAcc * kSliceThreads +
                               sizeof(int2) * kChunk;
constexpr size_t kFixedBytes = kSlices * kSliceBytes;
constexpr size_t kMaxSmem = 227 * 1024;
constexpr int kMaxN = (int)((kMaxSmem - kFixedBytes) / sizeof(float2));

__device__ __forceinline__ void slice_barrier(int id) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "n"(kSliceThreads) : "memory");
}

__device__ __forceinline__ void put(unsigned char* b, uint32_t off, uint32_t v) {
  *reinterpret_cast<uint32_t*>(b + off) = v;
}

__global__ void __launch_bounds__(kThreads, 1)
project_kernel(const int* __restrict__ i0, const int* __restrict__ j0,
               const float* __restrict__ dens, const int* __restrict__ counts,
               const float* __restrict__ st_re, const float* __restrict__ st_im,
               const float* __restrict__ scale, int G, int O, int Pp, int N, int F,
               float* __restrict__ out_re, float* __restrict__ out_im) {
  extern __shared__ __align__(1024) unsigned char smem[];
  const int tid = threadIdx.x, sl = tid / kSliceThreads, st = tid % kSliceThreads;
  const int warp = st >> 5, lane = st & 31, g = lane >> 2, t = lane & 3;
  unsigned char* bh = smem + (size_t)sl * kSliceBytes;  // B hi
  unsigned char* bl = bh + kBBytes;                      // B lo
  float* part = reinterpret_cast<float*>(bl + kBBytes);  // [kAcc][128]
  int2* pts = reinterpret_cast<int2*>(part + kAcc * kSliceThreads);  // (a mod N, dens bits)
  float2* tw = reinterpret_cast<float2*>(smem + kFixedBytes);        // e^{−2πi j/N}
  const int k1b = blockIdx.x * kT1, k2b = blockIdx.y * kT2, o = blockIdx.z;
  const size_t NF = (size_t)N * F;

  for (int j = tid; j < N; j += kThreads) {
    double s, c;
    sincospi(-2.0 * (double)j / (double)N, &s, &c);
    tw[j] = make_float2((float)c, (float)s);
  }
#pragma unroll
  for (int r = 0; r < kAcc; ++r) part[r * kSliceThreads + st] = 0.f;
  __syncthreads();

  // This thread's fragment rows k1 = r0 and r0 + 8, reduced mod N.
  const int r0 = k1b + 16 * warp + g;
  const int k1m0 = r0 % N, k1m1 = (r0 + 8) % N;

  // This slice's share of the orientation's points, in group order: the
  // points [p_lo, p_hi) of the groups' concatenated real points.
  auto cnt = [&](int gg) { return max(0, min(counts[gg], Pp)); };
  int total = 0;
  for (int gg = 0; gg < G; ++gg) total += cnt(gg);
  const int p_lo = (int)((long long)total * sl / kSlices);
  const int p_hi = (int)((long long)total * (sl + 1) / kSlices);

  // sum: S of the current group (re at [4j + e], im at [16 + 4j + e] for
  // column 8j + 2t + (e & 1), row r0 + 8·(e >> 1)); acc: one step's products.
  float sum[kAcc], acc[kAcc];
#pragma unroll
  for (int r = 0; r < kAcc; ++r) sum[r] = acc[r] = 0.f;

  // A chunk: up to kChunk points [p, p + np) of one group gi, whose first
  // point is g0 (np = 0: the slice is done).
  struct Chunk {
    int gi, g0, p, np;
  };
  auto next_chunk = [&](const Chunk& c) {
    Chunk n{c.gi, c.g0, c.p + c.np, 0};
    while (n.gi < G && n.p >= n.g0 + cnt(n.gi)) n.g0 += cnt(n.gi++);
    if (n.p < p_hi) n.np = min(kChunk, min(p_hi, n.g0 + cnt(n.gi)) - n.p);
    return n;
  };

  for (Chunk cur = next_chunk(Chunk{0, 0, p_lo, 0}); cur.np > 0;) {
    const size_t base = ((size_t)cur.gi * O + o) * Pp + (cur.p - cur.g0);
    const int ns = (cur.np + 3) / 4;
    slice_barrier(1 + sl);  // the slice's last chunk is consumed
    if (st < kChunk) {
      int a = st < cur.np ? i0[base + st] % N : 0;
      a = a < 0 ? a + N : a;
      pts[st] = make_int2(a, __float_as_int(st < cur.np ? dens[base + st] : 0.f));
    }
    // B: task (point pl, run r) writes Y(pl, k2) for eight consecutive k2
    // of the tile: re row n gets Yr at k = u, −Yi at k = 4 + u; im row
    // 32 + n gets Yi, Yr (pl = 4s + u, step s).
    for (int task = st; task < 4 * ns * kRuns; task += kSliceThreads) {
      const int r = task / (4 * ns), pl = task - r * (4 * ns);
      const int s = pl >> 2, u = pl & 3;
      int b = pl < cur.np ? j0[base + pl] % N : 0;
      b = b < 0 ? b + N : b;
      const int k0 = k2b + kRun * r;
      const int rot = s & (kRun - 1);
      const int b8 = (kRun * b) % N;
      int idx = (b * ((k0 + rot) % N)) % N;
      const uint32_t kr = 32 * s + 4 * u, ki = kr + 16;
#pragma unroll
      for (int v = 0; v < kRun; ++v) {
        const int e = (rot + v) & (kRun - 1);
        const int n = kRun * r + e;
        const float2 w = tw[idx];
        const uint32_t hr = wg::to_tf32(w.x), hi = wg::to_tf32(w.y);
        const uint32_t lr = wg::to_tf32(w.x - __uint_as_float(hr));
        const uint32_t li = wg::to_tf32(w.y - __uint_as_float(hi));
        put(bh, wg::offset_km(n, kr, kKb), hr);
        put(bh, wg::offset_km(n, ki, kKb), hi ^ 0x80000000u);
        put(bh, wg::offset_km(kT2 + n, kr, kKb), hi);
        put(bh, wg::offset_km(kT2 + n, ki, kKb), hr);
        put(bl, wg::offset_km(n, kr, kKb), lr);
        put(bl, wg::offset_km(n, ki, kKb), li ^ 0x80000000u);
        put(bl, wg::offset_km(kT2 + n, kr, kKb), li);
        put(bl, wg::offset_km(kT2 + n, ki, kKb), lr);
        idx += b;  // entry e + 1, or back to entry 0 after entry 7
        idx = idx >= N ? idx - N : idx;
        if (e == kRun - 1) idx = idx >= b8 ? idx - b8 : idx - b8 + N;
      }
    }
    wg::fence_proxy_async();
    slice_barrier(1 + sl);
    const Chunk nxt = next_chunk(cur);

    // A fragment of step s: Re X at rows r0, r0 + 8, then Im X (point 4s + t).
    auto form = [&](int s, uint32_t (&h)[4], uint32_t (&l)[4]) {
      const int2 pt = pts[4 * s + t];
      const float d = __int_as_float(pt.y);
      const float2 w0 = tw[(pt.x * k1m0) % N], w1 = tw[(pt.x * k1m1) % N];
      const float x[4] = {d * w0.x, d * w1.x, d * w0.y, d * w1.y};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        h[e] = wg::to_tf32(x[e]);
        l[e] = wg::to_tf32(x[e] - __uint_as_float(h[e]));
      }
    };
    // Step s's three products, issued asynchronously into the chunk's
    // accumulator (the chunk's first product starts it from zero).
    auto issue = [&](int s, const uint32_t (&h)[4], const uint32_t (&l)[4]) {
      const uint64_t dh = wg::desc(bh + 256 * s, 128, 8 * kKb);
      const uint64_t dl = wg::desc(bl + 256 * s, 128, 8 * kKb);
      wg::fence();
      wg::Tf32RS<kNB>::mma(acc, l, dh, s > 0);
      wg::Tf32RS<kNB>::mma(acc, h, dl, 1);
      wg::Tf32RS<kNB>::mma(acc, h, dh, 1);
      wg::commit();
    };
    // Two fragment buffers: step s + 1 is formed while step s runs, into
    // the buffer step s − 1 read (free once wait<1> has retired it).
    uint32_t ha[4], la[4], hb[4], lb[4];
    form(0, ha, la);
    for (int s = 0; s < ns; s += 2) {
      issue(s, ha, la);
      if (s + 1 < ns) {
        wg::wait<1>();
        form(s + 1, hb, lb);
        issue(s + 1, hb, lb);
      }
      if (s + 2 < ns) {
        wg::wait<1>();
        form(s + 2, ha, la);
      }
    }
    wg::wait<0>();
    wg::fence_operand(acc);
#pragma unroll
    for (int r = 0; r < kAcc; ++r) sum[r] += acc[r];

    if (nxt.np == 0 || nxt.gi != cur.gi) {
      // the slice's part of group gi is summed: part += Ŝ_gi ⊙ S
      const size_t sg = (size_t)cur.gi * NF;
#pragma unroll
      for (int r = 0; r < kAcc / 2; ++r) {
        const int k1 = r0 + 8 * ((r & 3) >> 1);
        const int k2 = k2b + 8 * (r >> 2) + 2 * t + (r & 1);
        if (k1 < N && k2 < F) {
          const size_t si = sg + (size_t)k1 * F + k2;
          const float str = st_re[si], sti = st_im[si];
          const float sr = sum[r], sim = sum[kAcc / 2 + r];
          part[r * kSliceThreads + st] += str * sr - sti * sim;
          part[(kAcc / 2 + r) * kSliceThreads + st] += str * sim + sti * sr;
        }
        sum[r] = sum[kAcc / 2 + r] = 0.f;
      }
    }
    cur = nxt;
  }

  // Sum the slices' partial spectra in a fixed order (slice 0 + 1 + 2 + 3)
  // and write the tile, scaled where a scale is given.
  __syncthreads();
  const float sc = scale != nullptr ? scale[o] : 1.f;
  for (int q = tid; q < (kAcc / 2) * kSliceThreads; q += kThreads) {
    const int r = q / kSliceThreads, th = q - r * kSliceThreads;
    const int ln = th & 31;
    const int k1 = k1b + 16 * (th >> 5) + (ln >> 2) + 8 * ((r & 3) >> 1);
    const int k2 = k2b + 8 * (r >> 2) + 2 * (ln & 3) + (r & 1);
    if (k1 >= N || k2 >= F) continue;
    float vr = 0.f, vi = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) {
      const float* pk = reinterpret_cast<const float*>(smem + (size_t)k * kSliceBytes + 2 * kBBytes);
      vr += pk[r * kSliceThreads + th];
      vi += pk[(kAcc / 2 + r) * kSliceThreads + th];
    }
    const size_t oi = (size_t)o * NF + (size_t)k1 * F + k2;
    out_re[oi] = scale != nullptr ? __fmul_rn(vr, sc) : vr;
    out_im[oi] = scale != nullptr ? __fmul_rn(vi, sc) : vi;
  }
}

}  // namespace

extern "C" {

// The largest N the kernel takes (its twiddle table in shared memory).
int bioem_fourier_project_max_n() { return kMaxN < 46340 ? kMaxN : 46340; }

int bioem_fourier_project(const int* i0, const int* j0, const float* dens, const int* counts,
                          const float* st_re, const float* st_im, const float* scale, int G,
                          int O, int Pp, int N, int F, float* out_re, float* out_im,
                          void* stream) {
  if (N < 1 || N > bioem_fourier_project_max_n()) return (int)cudaErrorInvalidValue;
  const size_t smem = kFixedBytes + sizeof(float2) * (size_t)N;
  cudaError_t err = cudaFuncSetAttribute(
      project_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + kT1 - 1) / kT1, (F + kT2 - 1) / kT2, O);
  project_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      i0, j0, dens, counts, st_re, st_im, scale, G, O, Pp, N, F, out_re, out_im);
  return (int)cudaGetLastError();
}

}  // extern "C"

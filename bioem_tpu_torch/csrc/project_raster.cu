// The raster projection for Hopper (sm_90a): G4 raster_project — the
// rotation matrices of an orientation block, the rotation and pixel snap
// of every model point, its stencil weights (a single-pixel splat for a
// point-like radius, the solid sphere's chord lengths over its disc
// otherwise), their deposit into the (O, N, N) projections and the density
// scale norm_den / tempden, in one launch. torch.fft.rfft2 transforms its
// output, as the JAX package's jnp.fft.rfft2 does.
//
// No Pallas kernel has this body: on the TPU, XLA fused it into the jitted
// block step (bioem_tpu/core/engine.py:484, :496-500). It replaces, on the
// JAX side, bioem_tpu/core/projection.py:74-195 (_stencil_weights,
// _raster_scatter, _raster_onehot, project_one, project_batch) and the
// rotation matrices (bioem_tpu/core/orientations.py:138-202); in the
// port's torch code (ops/project_cuda.raster_project_plain keeps it as the
// plain version) core/orientations.py rotation_matrices and
// core/projection.py project_batch: ~25 elementwise kernels over an (O, P,
// S, S) weight tensor, a torch.sum for tempden and an index_add_, whose
// float atomics add in an order that may change from one replay to the
// next.
//
// For a check, a caller may ask for each point's snapped pixel (snaps,
// (O, 2, P) int32) and each orientation's scale (O,) as well; the first
// band's CTAs write them.
//
// Contract (core/projection.project_batch, from the angle rows):
//   out[o, i, j] = (norm_den / tempden[o]) · Σ_p w_o,p(i − i0, j − j0)
// in model order, with w the bounds-masked stencil weights of point p at
// its snapped pixel (i0, j0) and tempden[o] = Σ_p Σ_(du,dv) w_o,p(du, dv).
// |du|, |dv| ≤ S, the engine's stencil_half (S = 0: only point-like points
// deposit, as in the plain version).
//
// Exactness. The rotation and the snap are csrc/project_snap.cuh's, shared
// with G3: the matrices bit-equal to torch's, the rotated coordinate an FMA
// chain that may snap elsewhere than cuBLAS's product only within an ulp or
// two of an integer. A weight depends on (du, dv) only through
// k = du² + dv², so each point's weights are formed once per octant entry
// (0 ≤ a ≤ b ≤ S, k = a² + b²) with the plain version's roundings, each op
// it rounds alone an __f*_rn intrinsic in its order:
//   dist  = (k·pix)·pix                      (two f32 multiplies)
//   chord = (((c·√max(r² − dist, 0))·ρ)·3) / ((c'·r)·r²)   where dist < r²
// with c = f32(pix·pix·2.0) and c' = f32(4.0·f32(π)) rounded on the host
// from the plain version's Python expressions; √ and / correctly rounded,
// as torch's CUDA kernels compute them. The weights are therefore
// bit-equal to the plain version's; the sums differ only in order. Each
// pixel adds its weights in model order in f32 (the plain version: in the
// atomics' order); tempden is Σ multiplicity·weight over the octant entries
// in f64, in a fixed tree, and the scale norm_den / tempden is rounded to
// f32 once, as G3 rounds it. No atomics: two launches give the same bits.
//
// Bound. At the production block (O = 8, N = 224, 500 points, S = 4) it
// writes the (O, N, N) f32 output, 1.6 MB (~0.5 µs at 3.35 TB/s), and reads
// the model (10 KB) and the angles; its arithmetic, ~10 operations per
// octant weight over 8·500·15 entries and an add per deposited weight, is
// less. So it is bound by its launch and by each CTA's serial walk over
// the points, not by bytes or operations. The design: one CTA per (band of
// kBand rows, orientation); each thread owns one column of the band and
// keeps the band's rows in registers; the CTA stages the orientation's
// snapped points and their octant weights in shared memory, a chunk of one
// point per thread at a time (each thread forms its point's weights from
// the values it loaded for the snap; a model of any size fits), compacts the
// points whose stencil meets the band into a list in model order (a warp
// ballot each), and each thread walks that list, adding every weight that
// lands in its column; the band is written once, scaled. Every CTA of an
// orientation computes tempden from the same entries in the same order,
// so all use one scale without a second pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "project_snap.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kBand = 8;         // rows of the frame per CTA
constexpr int kMaxN = 512;       // one thread per column
constexpr int kSmemCap = 48 * 1024;

__host__ __device__ inline int octants(int s) { return (s + 1) * (s + 2) / 2; }

// Dynamic shared memory of a chunk: per point its slot (int4), its octant
// weights and its place in the hit list; the octant entries' k and
// multiplicity.
__host__ __device__ inline size_t smem_bytes(int chunk, int s) {
  return (size_t)chunk * (sizeof(int4) + sizeof(float) * octants(s) + sizeof(int)) +
         2 * sizeof(int) * octants(s);
}

// Points staged per pass, at most one per thread (0: stencil half-width s
// too large for the shared memory cap).
int chunk_for(int P, int s, int threads) {
  int c = P < threads ? P : threads;
  while (c > 0 && smem_bytes(c, s) > (size_t)kSmemCap) c >>= 1;
  return c;
}

__global__ void __launch_bounds__(kMaxN) raster_projection_kernel(
    const float* __restrict__ angles, int quat, const float* __restrict__ points,
    const float* __restrict__ radii, const float* __restrict__ dens,
    const float* __restrict__ norm_den, int P, int N, float pix, int shift_x, int shift_y,
    int S, float c_chord, float c_den, int chunk, float* __restrict__ out,
    int* __restrict__ snaps, float* __restrict__ scale_out) {
  const int r0 = blockIdx.x * kBand;
  const int o = blockIdx.y;
  const int T = blockDim.x;
  const int W = octants(S);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  extern __shared__ __align__(16) unsigned char smem[];
  int4* slot = reinterpret_cast<int4*>(smem);           // chunk: (i0 − r0, j0, reach, 0)
  float* tab = reinterpret_cast<float*>(slot + chunk);  // chunk × W octant weights
  int* list = reinterpret_cast<int*>(tab + (size_t)chunk * W);  // the chunk's hits
  int* kk = list + chunk;                               // W: a² + b²
  int* mult = kk + W;                                   // W: positions per entry
  __shared__ float R[9];
  __shared__ double part[kMaxN / 32];
  __shared__ int wcount[kMaxN / 32];
  __shared__ float s_scale;

  if (threadIdx.x == 0) bioem_snap::rotation_matrix(angles + 4 * (size_t)o, quat != 0, R);
  for (int b = threadIdx.x; b <= S; b += T) {
    for (int a = 0; a <= b; ++a) {
      const int e = b * (b + 1) / 2 + a;
      kk[e] = a * a + b * b;
      mult[e] = b == 0 ? 1 : (a == 0 || a == b) ? 4 : 8;
    }
  }
  __syncthreads();
  const float Rl[6] = {R[0], R[1], R[2], R[3], R[4], R[5]};
  const bioem_snap::Frame frame = bioem_snap::make_frame(N, pix, shift_x, shift_y);
  const int col = threadIdx.x;

  float acc[kBand];
#pragma unroll
  for (int b = 0; b < kBand; ++b) acc[b] = 0.f;
  double tsum = 0.0;

  for (int base = 0; base < P; base += chunk) {
    const int cn = min(chunk, P - base);
    // the chunk, one point per thread: its snap (reach −1: dropped, out of
    // the frame or a sphere with S = 0; 0: a single-pixel splat; S: a
    // sphere's stencil), its octant weights and their share of tempden. A
    // hit is a point whose stencil meets the band.
    const int t = threadIdx.x;
    bool hit = false;
    if (t < cn) {
      const int p = base + t;
      const float r = radii[p], d = dens[p];
      const bioem_snap::Snap sn = bioem_snap::snap_point(
          frame, Rl, points[3 * (size_t)p], points[3 * (size_t)p + 1],
          points[3 * (size_t)p + 2], r);
      const int reach = !sn.valid ? -1 : sn.small ? 0 : (S > 0 ? S : -1);
      slot[t] = make_int4(sn.ii - r0, sn.jj, reach, 0);
      hit = reach >= 0 && sn.ii + reach >= r0 && sn.ii - reach < r0 + kBand;
      if (snaps != nullptr && blockIdx.x == 0) {
        snaps[((size_t)o * 2) * P + p] = sn.ii;
        snaps[((size_t)o * 2 + 1) * P + p] = sn.jj;
      }
      const float rad2 = __fmul_rn(r, r);
      const float den = __fmul_rn(__fmul_rn(c_den, r), rad2);
      float* wt = tab + (size_t)t * W;
      for (int idx = 0; idx < W; ++idx) {
        float w = 0.f;
        if (reach == 0) {
          w = idx == 0 ? d : 0.f;
        } else if (reach > 0) {
          const float dist = __fmul_rn(__fmul_rn((float)kk[idx], pix), pix);
          if (dist < rad2) {
            const float sq = __fsqrt_rn(fmaxf(__fsub_rn(rad2, dist), 0.f));
            w = __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(c_chord, sq), d), 3.f), den);
          }
        }
        wt[idx] = w;
        tsum = __dadd_rn(tsum, __dmul_rn((double)mult[idx], (double)w));
      }
    }
    // the hits, compacted in model order (a ballot per warp, the warps in
    // order)
    const unsigned ballot = __ballot_sync(kFull, hit);
    if (lane == 0) wcount[warp] = __popc(ballot);
    __syncthreads();
    int before = 0, nhit = 0;
    for (int w = 0; w < T / 32; ++w) {
      before += w < warp ? wcount[w] : 0;
      nhit += wcount[w];
    }
    if (hit) list[before + __popc(ballot & ((1u << lane) - 1u))] = t;
    __syncthreads();
    // the deposit: this thread's column of the band, the hits in order
    if (col < N) {
      for (int k = 0; k < nhit; ++k) {
        const int q = list[k];
        const int4 s = slot[q];
        const int dv = abs(col - s.y);
        if (dv > s.z) continue;
        const float* wt = tab + (size_t)q * W;
#pragma unroll
        for (int b = 0; b < kBand; ++b) {
          const int du = abs(b - s.x);
          if (du <= s.z) {
            const int lo = min(du, dv), hi = max(du, dv);
            acc[b] = __fadd_rn(acc[b], wt[hi * (hi + 1) / 2 + lo]);
          }
        }
      }
    }
    __syncthreads();
  }

  // tempden: a butterfly in each warp, then the warps' sums in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) tsum = __dadd_rn(tsum, __shfl_xor_sync(kFull, tsum, off));
  if (lane == 0) part[warp] = tsum;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < T / 32; ++w) tot = __dadd_rn(tot, part[w]);
    s_scale = __double2float_rn(__ddiv_rn((double)*norm_den, tot));
    if (scale_out != nullptr && blockIdx.x == 0) scale_out[o] = s_scale;
  }
  __syncthreads();
  const float sc = s_scale;
  if (col < N) {
#pragma unroll
    for (int b = 0; b < kBand; ++b) {
      if (r0 + b < N) out[((size_t)o * N + r0 + b) * N + col] = __fmul_rn(acc[b], sc);
    }
  }
}

}  // namespace

extern "C" {

// The largest stencil half-width G4 takes: a chunk of one point must fit
// the shared memory cap.
int bioem_raster_max_stencil_half() {
  int s = 0;
  while (chunk_for(1, s + 1, 32) > 0) ++s;
  return s;
}

int bioem_raster_project(const float* angles, int quat, const float* points, const float* radii,
                         const float* dens, const float* norm_den, int O, int P, int N, float pix,
                         int shift_x, int shift_y, int S, float c_chord, float c_den, float* out,
                         int* snaps, float* scale, void* stream) {
  if (O < 1 || O > 65535 || P < 1 || N < 1 || N > kMaxN || S < 0 ||
      (long long)P > 0x7fffffffLL / 3)
    return (int)cudaErrorInvalidValue;
  const int threads = (N + 31) / 32 * 32;
  const int chunk = chunk_for(P, S, threads);
  if (chunk < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + kBand - 1) / kBand, O);
  raster_projection_kernel<<<grid, threads, smem_bytes(chunk, S), (cudaStream_t)stream>>>(
      angles, quat, points, radii, dens, norm_den, P, N, pix, shift_x, shift_y, S, c_chord,
      c_den, chunk, out, snaps, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"

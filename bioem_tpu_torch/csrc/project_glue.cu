// The Fourier projection's prologue for Hopper (sm_90a): G3
// project_prologue — the rotation matrices of an orientation block, the
// rotation of the model's points, the pixel snap with its bounds masks,
// the regrouping into K2's (G, O, Pp) layout and the density scale
// norm_den / tempden, in one launch.
//
// No Pallas kernel has this body: on the TPU, XLA fused it around the
// projection kernel in the jitted block step (bioem_tpu/core/engine.py:
// 481-501, :508). It replaces, on the JAX side,
//   bioem_tpu/core/orientations.py:138-202 (rotmat_from_quaternion,
//      rotmat_from_euler, rotation_matrices),
//   bioem_tpu/core/projection.py:302-330 (fourier_prologue) and :444-461
//      (the regroup, the group density sums, tempden and the scale of
//      project_fourier_batch_pallas);
// and in the port's torch code (ops/project_cuda.project_prologue_plain
// keeps it as the plain version), core/orientations.py rotation_matrices,
// core/projection.py grouped_snap, fourier_snap, _snap and _rotate, and
// the tempden and scale lines of project_fourier_batch_kernel: ~91 small
// torch kernels per block before.
//
// Outputs per block: i0, j0 (G, O, Pp) int32, the snapped pixel positions;
// de (G, O, Pp) f32, the bounds-masked densities; scale (O,) f32,
// norm_den / tempden with tempden[o] = Σ_g st_sums[g]·Σ_p de[g, o, p].
// K2 (csrc/project.cu) multiplies its spectra by scale as it stores them.
//
// Exactness. The rotation and the snap are csrc/project_snap.cuh's, shared
// with G4 (csrc/project_raster.cu): its header says how they round as the
// plain version does (bit-equal matrices; the rotated coordinate an FMA
// chain, which may snap elsewhere than cuBLAS's product only within an ulp
// or two of an integer). tempden is a sum of the products st_sums[g]·de
// (each exact in f64) in f64 over a fixed tree, and the scale norm_den /
// tempden is rounded to f32 once: no atomics, so two launches give the
// same bits.
//
// Bound. At the production block (O = 8, G = 14, Pp = 80) it reads the
// model's 1120 slots (points, radii, densities: 22 KB) and 8 angle rows,
// and writes 3·O·G·Pp values (108 KB): ~0.04 µs at 3.35 TB/s, and a few
// hundred operations per slot-orientation pair. So it is bound by its
// launch and its one block's latency, not by bytes or operations. The
// design keeps to one launch with no second pass: one CTA per orientation
// (the rotation formed once into shared memory by one thread), threads
// striding over the slots in order so that each group's Pp consecutive
// slots are written contiguously in (G, O, Pp), and the tempden reduction
// inside the CTA.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "project_snap.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) project_prologue_kernel(
    const float* __restrict__ angles, int quat, const float* __restrict__ points,
    const float* __restrict__ radii, const float* __restrict__ dens,
    const float* __restrict__ st_sums, const float* __restrict__ norm_den, int O, int G, int Pp,
    int N, float pix, int shift_x, int shift_y, int* __restrict__ i0, int* __restrict__ j0,
    float* __restrict__ de, float* __restrict__ scale) {
  const int o = blockIdx.x;
  __shared__ float R[9];
  __shared__ double part[kThreads / 32];
  if (threadIdx.x == 0) bioem_snap::rotation_matrix(angles + 4 * (size_t)o, quat != 0, R);
  __syncthreads();
  const float Rl[6] = {R[0], R[1], R[2], R[3], R[4], R[5]};
  const bioem_snap::Frame frame = bioem_snap::make_frame(N, pix, shift_x, shift_y);

  double acc = 0.0;
  const int slots = G * Pp;
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    const int g = s / Pp;
    const bioem_snap::Snap sn = bioem_snap::snap_point(
        frame, Rl, points[3 * (size_t)s], points[3 * (size_t)s + 1], points[3 * (size_t)s + 2],
        radii[s]);
    const int ii = sn.ii, jj = sn.jj;
    const bool valid = sn.valid;
    const float d = valid ? dens[s] : 0.f;
    const size_t at = ((size_t)g * O + o) * Pp + (s - g * Pp);
    i0[at] = ii;
    j0[at] = jj;
    de[at] = d;
    acc = __dadd_rn(acc, __dmul_rn((double)st_sums[g], (double)d));
  }
  // tempden: a butterfly in each warp, then the warps' sums in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc = __dadd_rn(acc, __shfl_xor_sync(kFull, acc, off));
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x == 0) {
    double tot = 0.0;
    for (int w = 0; w < kThreads / 32; ++w) tot = __dadd_rn(tot, part[w]);
    scale[o] = __double2float_rn(__ddiv_rn((double)*norm_den, tot));
  }
}

}  // namespace

extern "C" {

int bioem_project_prologue(const float* angles, int quat, const float* points,
                           const float* radii, const float* dens, const float* st_sums,
                           const float* norm_den, int O, int G, int Pp, int N, float pix,
                           int shift_x, int shift_y, int* i0, int* j0, float* de, float* scale,
                           void* stream) {
  if (O < 1 || G < 1 || Pp < 1 || N < 1 || (long long)G * Pp > 0x7fffffffLL / 3)
    return (int)cudaErrorInvalidValue;
  project_prologue_kernel<<<O, kThreads, 0, (cudaStream_t)stream>>>(
      angles, quat, points, radii, dens, st_sums, norm_den, O, G, Pp, N, pix, shift_x, shift_y,
      i0, j0, de, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"

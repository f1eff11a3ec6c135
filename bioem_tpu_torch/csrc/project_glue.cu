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
// Exactness. The plain version rounds every elementwise op of the rotation
// formulas in its own torch kernel, so each matrix entry is formed here
// with __fmul_rn / __fadd_rn / __fsub_rn (never contracted into an FMA) in
// torch's order: r00 = (1 − (2·q1)·q1) − (2·q2)·q2, r10 = 2·(q0·q1 − q2·q3),
// ...; the Euler branch with libdevice cosf and sinf, as torch's CUDA
// kernels call them (no fast-math flag). The matrices are therefore
// bit-equal to torch's. The rotated coordinate is the 3-term dot product
//   x = fmaf(p2, r02, fmaf(p1, r01, p0·r00))   (y the same with row 1),
// an FMA chain in k order; the plain version's torch.matmul goes to cuBLAS,
// whose order is not documented, so x may differ by an ulp and flip
// floor(x/pix + N/2 + 0.5) where that value lies within an ulp or two of an
// integer (the card tests count those slots). x/pix is x·(1/pix), as
// torch's CUDA division by a host scalar computes it; the adds of N/2 and
// 0.5, the floor and the int conversions are the plain version's. tempden
// is a sum of the products st_sums[g]·de (each exact in f64) in f64 over a
// fixed tree, and the scale norm_den / tempden is rounded to f32 once: no
// atomics, so two launches give the same bits.
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

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kThreads = 256;

// The rotation matrix R (row-major, R[3·i + j] = r_ij) of one angle row,
// as core/orientations.py builds it: points rotate as r' = R·r.
__device__ void rotation_matrix(const float* a, bool quat, float* R) {
  if (quat) {
    // rotmat_from_quaternion (reference bioem.cpp:1638-1646), rows (x, y, z, w)
    const float q0 = a[0], q1 = a[1], q2 = a[2], q3 = a[3];
    const float q00 = __fmul_rn(__fmul_rn(2.f, q0), q0);
    const float q11 = __fmul_rn(__fmul_rn(2.f, q1), q1);
    const float q22 = __fmul_rn(__fmul_rn(2.f, q2), q2);
    R[0] = __fsub_rn(__fsub_rn(1.f, q11), q22);
    R[1] = __fmul_rn(2.f, __fadd_rn(__fmul_rn(q0, q1), __fmul_rn(q2, q3)));
    R[2] = __fmul_rn(2.f, __fsub_rn(__fmul_rn(q0, q2), __fmul_rn(q1, q3)));
    R[3] = __fmul_rn(2.f, __fsub_rn(__fmul_rn(q0, q1), __fmul_rn(q2, q3)));
    R[4] = __fsub_rn(__fsub_rn(1.f, q00), q22);
    R[5] = __fmul_rn(2.f, __fadd_rn(__fmul_rn(q1, q2), __fmul_rn(q0, q3)));
    R[6] = __fmul_rn(2.f, __fadd_rn(__fmul_rn(q0, q2), __fmul_rn(q1, q3)));
    R[7] = __fmul_rn(2.f, __fsub_rn(__fmul_rn(q1, q2), __fmul_rn(q0, q3)));
    R[8] = __fsub_rn(__fsub_rn(1.f, q00), q11);
  } else {
    // rotmat_from_euler, ZXZ (reference bioem.cpp:1664-1672)
    const float ca = cosf(a[0]), sa = sinf(a[0]);
    const float cb = cosf(a[1]), sb = sinf(a[1]);
    const float cg = cosf(a[2]), sg = sinf(a[2]);
    const float cbsa = __fmul_rn(cb, sa), cbca = __fmul_rn(cb, ca);
    R[0] = __fsub_rn(__fmul_rn(cg, ca), __fmul_rn(cbsa, sg));
    R[1] = __fadd_rn(__fmul_rn(cg, sa), __fmul_rn(cbca, sg));
    R[2] = __fmul_rn(sg, sb);
    R[3] = __fsub_rn(__fmul_rn(-sg, ca), __fmul_rn(cbsa, cg));
    R[4] = __fadd_rn(__fmul_rn(-sg, sa), __fmul_rn(cbca, cg));
    R[5] = __fmul_rn(cg, sb);
    R[6] = __fmul_rn(sb, sa);
    R[7] = __fmul_rn(-sb, ca);
    R[8] = cb;
  }
}

__global__ void __launch_bounds__(kThreads) project_prologue_kernel(
    const float* __restrict__ angles, int quat, const float* __restrict__ points,
    const float* __restrict__ radii, const float* __restrict__ dens,
    const float* __restrict__ st_sums, const float* __restrict__ norm_den, int O, int G, int Pp,
    int N, float pix, int shift_x, int shift_y, int* __restrict__ i0, int* __restrict__ j0,
    float* __restrict__ de, float* __restrict__ scale) {
  const int o = blockIdx.x;
  __shared__ float R[9];
  __shared__ double part[kThreads / 32];
  if (threadIdx.x == 0) rotation_matrix(angles + 4 * (size_t)o, quat != 0, R);
  __syncthreads();
  const float r00 = R[0], r01 = R[1], r02 = R[2], r10 = R[3], r11 = R[4], r12 = R[5];
  const float inv_pix = __frcp_rn(pix);
  const float half = (float)N * 0.5f;

  double acc = 0.0;
  const int slots = G * Pp;
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    const int g = s / Pp;
    const float p0 = points[3 * (size_t)s], p1 = points[3 * (size_t)s + 1],
                p2 = points[3 * (size_t)s + 2];
    const float x = fmaf(p2, r02, fmaf(p1, r01, __fmul_rn(p0, r00)));
    const float y = fmaf(p2, r12, fmaf(p1, r11, __fmul_rn(p0, r10)));
    const int i_raw = (int)floorf(__fadd_rn(__fadd_rn(__fmul_rn(x, inv_pix), half), 0.5f));
    const int j_raw = (int)floorf(__fadd_rn(__fadd_rn(__fmul_rn(y, inv_pix), half), 0.5f));
    const float r = radii[s];
    const bool small = r <= pix;
    const int irad = (int)__fmul_rn(r, inv_pix) + 1;
    const int ii = small ? i_raw : i_raw - shift_x;
    const int jj = small ? j_raw : j_raw - shift_y;
    const bool valid =
        small ? (i_raw >= 0 && j_raw >= 0 && i_raw < N && j_raw < N)
              : (ii >= irad && jj >= irad && ii < N - irad && jj < N - irad);
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

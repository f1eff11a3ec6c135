// The rotation and the pixel snap shared by the projection's kernels:
// G3 (csrc/project_glue.cu, the Fourier path's prologue) and G4
// (csrc/project_raster.cu, the raster projection). One copy, so that both
// snap every point to the same pixel.
//
// Exactness. The plain versions round every elementwise op of the rotation
// formulas in its own torch kernel, so each matrix entry is formed here
// with __fmul_rn / __fadd_rn / __fsub_rn (never contracted into an FMA) in
// torch's order: r00 = (1 − (2·q1)·q1) − (2·q2)·q2, r10 = 2·(q0·q1 − q2·q3),
// ...; the Euler branch with libdevice cosf and sinf, as torch's CUDA
// kernels call them (no fast-math flag). The matrices are therefore
// bit-equal to torch's. The rotated coordinate is the 3-term dot product
//   x = fmaf(p2, r02, fmaf(p1, r01, p0·r00))   (y the same with row 1),
// an FMA chain in k order; the plain versions' torch.matmul goes to
// cuBLAS, whose order is not documented, so x may differ by an ulp and
// flip floor(x/pix + N/2 + 0.5) where that value lies within an ulp or two
// of an integer (the card tests count those slots). x/pix is x·(1/pix), as
// torch's CUDA division by a host scalar computes it; the adds of N/2 and
// 0.5, the floor and the int conversions are the plain versions'
// (core/projection.py _snap).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace bioem_snap {

// The rotation matrix R (row-major, R[3·i + j] = r_ij) of one angle row,
// as core/orientations.py builds it: points rotate as r' = R·r.
__device__ inline void rotation_matrix(const float* a, bool quat, float* R) {
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

// One point's snap (reference bioem.cpp:1715-1803): its pixel (ii, jj) —
// the raw pixel for a point-like radius (≤ pix), shifted by (shift_x,
// shift_y) for a sphere — whether it is point-like, its reach irad, and
// whether the reference's bounds checks keep it.
struct Snap {
  int ii, jj, irad;
  bool small, valid;
};

// The frame's constants of a snap: 1/pix (torch's CUDA division by a host
// scalar) and N/2.
struct Frame {
  float pix, inv_pix, half;
  int n, shift_x, shift_y;
};

__device__ inline Frame make_frame(int N, float pix, int shift_x, int shift_y) {
  return Frame{pix, __frcp_rn(pix), (float)N * 0.5f, N, shift_x, shift_y};
}

// R's first two rows (R[0..5]) rotate the point; r is its radius.
__device__ inline Snap snap_point(const Frame& f, const float* R, float p0, float p1, float p2,
                                  float r) {
  const float x = fmaf(p2, R[2], fmaf(p1, R[1], __fmul_rn(p0, R[0])));
  const float y = fmaf(p2, R[5], fmaf(p1, R[4], __fmul_rn(p0, R[3])));
  const int i_raw = (int)floorf(__fadd_rn(__fadd_rn(__fmul_rn(x, f.inv_pix), f.half), 0.5f));
  const int j_raw = (int)floorf(__fadd_rn(__fadd_rn(__fmul_rn(y, f.inv_pix), f.half), 0.5f));
  Snap s;
  s.small = r <= f.pix;
  s.irad = (int)__fmul_rn(r, f.inv_pix) + 1;
  s.ii = s.small ? i_raw : i_raw - f.shift_x;
  s.jj = s.small ? j_raw : j_raw - f.shift_y;
  const int N = f.n;
  s.valid = s.small ? (i_raw >= 0 && j_raw >= 0 && i_raw < N && j_raw < N)
                    : (s.ii >= s.irad && s.jj >= s.irad && s.ii < N - s.irad &&
                       s.jj < N - s.irad);
  return s;
}

}  // namespace bioem_snap

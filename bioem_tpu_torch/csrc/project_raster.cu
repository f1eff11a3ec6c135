// The raster projection for Hopper (sm_90a): G4 raster_project — the
// rotation matrices of an orientation block, the rotation and pixel snap
// of every model point, its stencil weights (a single-pixel splat for a
// point-like radius, the solid sphere's chord lengths over its disc
// otherwise), their deposit into the (O, N, N) projections and the density
// scale norm_den / tempden. torch.fft.rfft2 transforms its output, as the
// JAX package's jnp.fft.rfft2 does. Also the out-of-frame census
// (bioem_bounds_census), which counts per orientation the points the snap
// drops.
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
// (O, 2, P) int32) and each orientation's scale (O,) as well.
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
// k = du² + dv², so each point's weights are formed per octant entry
// (0 ≤ a ≤ b, k = a² + b²) with the plain version's roundings, each op it
// rounds alone an __f*_rn intrinsic in its order:
//   dist  = (k·pix)·pix                      (two f32 multiplies)
//   chord = (((c·√max(r² − dist, 0))·ρ)·3) / ((c'·r)·r²)   where dist < r²
// with c = f32(pix·pix·2.0) and c' = f32(4.0·f32(π)) rounded on the host
// from the plain version's Python expressions; √ and / correctly rounded,
// as torch's CUDA kernels compute them. The weights are therefore
// bit-equal to the plain version's; the sums differ only in order. Each
// pixel adds its nonzero weights in model order in f32 (the plain version:
// in the atomics' order); tempden is Σ multiplicity·weight over a point's
// octant entries in f64, the points' sums in a fixed tree, and the scale
// norm_den / tempden is rounded to f32 once, as G3 rounds it. No float
// atomics: two launches give the same bits.
//
// A point's reach is the largest b ≤ S whose (b, 0) weight is nonzero:
// dist grows with k, so every nonzero weight lies within the (2·reach + 1)²
// square around its pixel (reach 1 for a voxel of radius 2·pix: 9 weights).
// Reach grows with the radius, and every radius of a stencil S has
// f32(r / pix) < S (core/projection.make_projection_spec), so the host
// bounds every reach by the reach of the largest such f32 radius
// (reach_bound: S − 1 at every pixel size tried), and the kernels clamp
// to that bound, which sizes the scratch.
//
// Design of the generic variant. The work is O·P snaps and O·P·E deposits
// (E the nonzero weights of a point); a map of 224³ voxels at the 4608
// orientations of the BioEM manual's grid is 5.2e10 snaps a pass. Each
// (orientation, point) is snapped twice and each deposit made once, in six
// launches per block:
//   prep     one thread per point: its share of tempden where it lies in
//            the frame (Σ multiplicity·weight over its octant entries, f64),
//            which no orientation changes;
//   count    one CTA per (tile of points, group of orientations), a
//            warp per orientation: the snap, the reach, the point's tempden
//            share (in point order per lane, then a butterfly), and the
//            number of the tile's points whose square meets each bin (a bin:
//            kTH rows × kTW columns of the frame), in shared memory;
//   scan     the counts' exclusive prefix over the tiles of each
//            (orientation, bin) (a warp per 32 bins), then over the bins of
//            each orientation, and tempden's tiles in a fixed tree → scale;
//   scatter  the count's grid again: each warp snaps its tile's points in
//            order, 32 at a time, and writes each point's entry (its pixel,
//            reach, density and radius) into every bin its square meets, at
//            the bin's cursor plus its rank among the 32 (a point's bins lie
//            in distinct residues of (row bin mod mr, column bin mod mc), mr
//            and mc the round's widest boxes, so per residue the lanes that
//            share a bin are ranked in lane order, one bin at a time): each
//            bin's list is in model order;
//   deposit  one warp per (bin, orientation), one pixel per lane: the warp
//            takes its bin's entries 32 at a time; each lane forms its
//            entry's octant weights and lays them over the bin's 32 pixels in
//            a zeroed row of shared memory; then every lane adds the 32 rows'
//            values at its pixel in entry order (zeros leave an f32 sum
//            unchanged) and clears them; the pixel is written once, scaled.
//            The octant weights come from a table in shared memory where
//            the reach bound's fit beside the pixel rows, else each lane
//            forms the weight of each pixel it lays (the same bits).
// An entry is one 16-byte store (its packed pixel and reach, density and
// radius); the entries live in the caller's scratch, sized for the worst
// case of every point meeting ntr·ntc bins at the reach bound. That round
// trip through device memory is this design's floor: ~8e10 entries a pass
// for the 224³ map, ~1.3 TB written and read again.
//
// Two variants; which runs is decided by what the model shows
// (core/projection.lattice_axes, asked by the engine and by
// rank.common_model_layout), never by a knob:
//   generic  the six launches above, for any point list: residue models,
//            models of many radii, a map ranked beside a model that is not
//            a lattice of its shape and radius;
//   lattice  a voxel map (--ReadModelMRC, io/model_io.voxel_model): the
//            points are the C-order broadcast of three evenly spaced axes
//            (steps 0.8–1.25 pixel), every one of one radius r (pix < r ≤
//            3.5·pix: reach 1 to 3). Two launches, no entries:
//   raster_projection_kernel_lattice<reach>: one CTA per (32 × 32-
//            pixel tile, orientation). For one orientation the voxels of a
//            plane of the lattice axis a most nearly along the view
//            (|R[2][a]| ≥ 1/√3 at equal steps) project to a lattice of the
//            frame under a 2 × 2 map of determinant ±R[2][a]·h_b·h_c/pix², so
//            the voxels whose snap can land in the tile widened by the reach
//            are, per plane, the rows of a parallelogram in the plane's (u,
//            v) indices, found through the axes' evenly spaced fit with a
//            margin of a pixel (the fit strays from the exact pre-floor
//            coordinate by ~1e-5 pixel; the lattice's axes by at most 1e-3,
//            lattice_axes). Each warp walks its own planes (a, a + 8, ...):
//            it lays out a plane's rows in its own table (each row's first
//            column and running count), then takes the plane's voxels 32 at
//            a time as one list (a chunk's lanes 8 voxels apart, so that one
//            instruction's lanes seldom meet on a pixel), snaps each with
//            bioem_snap::snap_point on its own coordinates (so every snap is
//            the generic variant's), and for those that land in the widened
//            tile forms each octant entry's weight with the plain version's
//            roundings and adds it to that entry's sum at the voxel's pixel.
//            The sums are integers: each weight times 2^fx, rounded to an
//            integer below 2^(57 − lg na − lg (2·reach + 1)²) in size (fx
//            from the model's largest |density|; 2^45 at 224 planes and reach
//            1), so that a pixel's sums over the planes and the gather of its
//            neighbours' stay below 2^62; the largest weight then has 45 bits,
//            and a pixel whose weights sum to a small share of it keeps more
//            than f32's 24 (a 31-bit scale broke f32 reordering's bound on a
//            32³ map, where a pixel's sum is under 1 % of the largest
//            weight). They are added exactly into 64-bit sums held as two
//            words in shared memory with native 32-bit atomics (the low
//            word, then its carry or borrow with the high word; a 64-bit
//            shared atomicAdd is a compare-and-swap loop on sm_90). Integer
//            sums do not depend on the order of the adds, so two launches
//            give the same bits and there are no float atomics. Then each
//            pixel of the tile adds, for each offset (du, dv) of the reach,
//            its neighbour's sum of that offset's entry (exactly) and rounds
//            the total to f32 once: each pixel within f32 reordering's bound
//            of the plain version, every weight the plain version's
//            (weight_at's roundings, __fdiv_rn included). tempden: each valid
//            voxel's share (Σ multiplicity · weight in f64, prep's sum) is
//            counted by the tile whose interior holds its snapped pixel,
//            summed in f64 per thread and
//            the tile's threads in a fixed tree, into (O, tiles) f64 in the
//            scratch: within one f32 ulp of the generic variant's scale;
//   raster_projection_kernel_lattice_scale: per orientation the tiles' sums
//            in a fixed tree, the scale norm_den / tempden rounded to f32
//            once, and the orientation's pixels, written unscaled by the tile
//            kernel, times it.
//   Work: O·P snaps and weight sets (each voxel once per tile whose widened
//   tile with the margin holds its fit, ~1.27 at tile 32 and reach 1) and
//   three atomic adds per voxel that lands; the densities from L2 (45 MB at
//   224³). Snaps, where asked for, are written for the voxels whose snap lies
//   in the frame.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "project_snap.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTH = 4;                // rows of a bin
constexpr int kTW = 8;                // columns of a bin: kTH·kTW = 32 pixels, one per lane
constexpr int kTileMin = 32;          // points of a tile of the count and the scatter: enough
constexpr int kTileMax = 32768;       // tiles to fill the card (kTiles), each at most kTileMax
constexpr int kTiles = 512;           // (a small model's warps each take one round of 32)
constexpr int kMaxWarps = 8;          // orientations per CTA of the count and the scatter
constexpr int kDepWarps = 4;          // bins per CTA of the deposit
constexpr int kRow = 33;              // floats per entry row of the deposit (bank-conflict pad)
constexpr int kMaxN = 512;            // the packed pixel's 10 bits a coordinate
constexpr int kMaxS = 1023;           // the packed reach's 10 bits
constexpr size_t kSmemMax = 227 * 1024;

__host__ __device__ inline int octants(int s) { return (s + 1) * (s + 2) / 2; }

// Bins of t pixels that an interval of len pixels can meet.
__host__ __device__ inline int bins_met(int len, int t) { return (len + t - 2) / t + 1; }

struct Geo {
  int N, nbr, nbc, nb, tile, nt, ntr, ntc, wpc;
  long long cap;  // entries per orientation
};

__host__ inline Geo geometry(int P, int N, int R) {
  Geo g;
  g.N = N;
  g.nbr = (N + kTH - 1) / kTH;
  g.nbc = (N + kTW - 1) / kTW;
  g.nb = g.nbr * g.nbc;
  const int want = ((P + kTiles - 1) / kTiles + 31) / 32 * 32;
  g.tile = want < kTileMin ? kTileMin : want > kTileMax ? kTileMax : want;
  g.nt = (P + g.tile - 1) / g.tile;
  g.ntr = bins_met(2 * R + 1, kTH);
  g.ntc = bins_met(2 * R + 1, kTW);
  g.cap = (long long)g.ntr * g.ntc * P;
  int w = kMaxWarps;
  while (w > 1 && (size_t)w * g.nb * sizeof(int) > kSmemMax) --w;
  g.wpc = w;
  return g;
}

__host__ inline size_t deposit_smem(int W) {
  return (size_t)kDepWarps * 32 * (kRow + W) * sizeof(float);
}

// The deposit's octant table per entry: octants(R) floats where they fit
// shared memory, else 0 (each lane forms each pixel's weight).
__host__ inline int table_width(int R) {
  return deposit_smem(octants(R)) <= kSmemMax ? octants(R) : 0;
}

// The largest reach of a point of stencil S at pixel size pix: the reach of
// the largest f32 radius r with f32(r / pix) < S (header), by reach_of's
// comparison in f32.
__host__ inline int reach_bound(int S, float pix) {
  if (S == 0) return 0;
  float r = (float)S * pix;
  while (r > 0.f && r / pix >= (float)S) r = nextafterf(r, 0.f);
  while (nextafterf(r, INFINITY) / pix < (float)S) r = nextafterf(r, INFINITY);
  const float rad2 = r * r;
  int b = 0;
  while (b < S && ((float)((b + 1) * (b + 1)) * pix) * pix < rad2) ++b;
  return b;
}

// The scratch's parts, each 256-byte aligned: counts (O, NT, NB) int32,
// bin totals (O, NB) int32, bin starts (O, NB + 1) int32, tempden's tile
// sums (O, NT) f64, the points' tempden shares (P,) f64, the scale (O,)
// f32, the entries (O, cap) int4.
struct Parts {
  size_t hist, btot, bstart, tpart, share, scale, entries, total;
};

__host__ inline size_t align256(size_t x) { return (x + 255) / 256 * 256; }

__host__ inline Parts parts(const Geo& g, int O, int P) {
  Parts p;
  size_t at = 0;
  p.hist = at;
  at = align256(at + sizeof(int) * (size_t)O * g.nt * g.nb);
  p.btot = at;
  at = align256(at + sizeof(int) * (size_t)O * g.nb);
  p.bstart = at;
  at = align256(at + sizeof(int) * (size_t)O * (g.nb + 1));
  p.tpart = at;
  at = align256(at + sizeof(double) * (size_t)O * g.nt);
  p.share = at;
  at = align256(at + sizeof(double) * (size_t)P);
  p.scale = at;
  at = align256(at + sizeof(float) * (size_t)O);
  p.entries = at;
  at = align256(at + sizeof(int4) * (size_t)O * g.cap);
  p.total = at;
  return p;
}

struct Consts {
  float pix, c_chord, c_den;
  int S;  // the stencil half-width (0: spheres dropped)
  int R;  // the reach bound (reach_bound)
};

// The weight at k = du² + dv² of a point (radius r, density d), as the plain
// version rounds it (header).
__device__ inline float weight_at(const Consts& c, int k, float r, float d, bool small) {
  if (small) return k == 0 ? d : 0.f;
  const float rad2 = __fmul_rn(r, r);
  const float dist = __fmul_rn(__fmul_rn((float)k, c.pix), c.pix);
  if (!(dist < rad2)) return 0.f;
  const float den = __fmul_rn(__fmul_rn(c.c_den, r), rad2);
  const float sq = __fsqrt_rn(fmaxf(__fsub_rn(rad2, dist), 0.f));
  return __fdiv_rn(__fmul_rn(__fmul_rn(__fmul_rn(c.c_chord, sq), d), 3.f), den);
}

// A snapped point's reach: −1 dropped (out of the frame, or a sphere with
// S = 0), 0 a single-pixel splat, else the largest b ≤ R with a nonzero
// (b, 0) weight.
__device__ inline int reach_of(const Consts& c, const bioem_snap::Snap& sn, float r) {
  if (!sn.valid) return -1;
  if (sn.small) return 0;
  if (c.S == 0) return -1;
  const float rad2 = __fmul_rn(r, r);
  int b = 0;
  while (b < c.R && __fmul_rn(__fmul_rn((float)((b + 1) * (b + 1)), c.pix), c.pix) < rad2) ++b;
  return b;
}

// The bins a point's square meets: rows [tr0, tr1] of bins, columns [tc0, tc1].
struct Box {
  int tr0, tr1, tc0, tc1;
};

__device__ inline Box box_of(int ii, int jj, int reach, int N) {
  Box b;
  b.tr0 = max(ii - reach, 0) / kTH;
  b.tr1 = min(ii + reach, N - 1) / kTH;
  b.tc0 = max(jj - reach, 0) / kTW;
  b.tc1 = min(jj + reach, N - 1) / kTW;
  return b;
}

struct Point {
  bioem_snap::Snap sn;
  float r, d;
  int reach;
};

__device__ inline Point load_point(const bioem_snap::Frame& f, const float* R, const Consts& c,
                                   const float* __restrict__ points,
                                   const float* __restrict__ radii,
                                   const float* __restrict__ dens, int p) {
  Point q;
  q.r = radii[p];
  q.d = dens[p];
  q.sn = bioem_snap::snap_point(f, R, points[3 * (size_t)p], points[3 * (size_t)p + 1],
                                points[3 * (size_t)p + 2], q.r);
  q.reach = reach_of(c, q.sn, q.r);
  return q;
}

struct Launch {
  const float* angles;
  int quat;
  const float *points, *radii, *dens;
  int O, P;
  int shift_x, shift_y;
  Consts c;
  Geo g;
};

// prep: each point's share of tempden where it lies in the frame (header).
__global__ void __launch_bounds__(256) raster_projection_kernel_prep(Launch L,
                                                                     double* __restrict__ share) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= L.P) return;
  const float r = L.radii[p], d = L.dens[p];
  bioem_snap::Snap sn;
  sn.valid = true;
  sn.small = r <= L.c.pix;
  const int reach = reach_of(L.c, sn, r);
  double t = 0.0;
  for (int b = 0; b <= reach; ++b) {
    for (int a = 0; a <= b; ++a) {
      const int mult = b == 0 ? 1 : (a == 0 || a == b) ? 4 : 8;
      t = __dadd_rn(t, __dmul_rn((double)mult, (double)weight_at(L.c, a * a + b * b, r, d,
                                                                    sn.small)));
    }
  }
  share[p] = t;
}

// count: per (tile, orientation) the points meeting each bin, and tempden's
// share of the tile (header).
__global__ void __launch_bounds__(kMaxWarps * 32) raster_projection_kernel_count(
    Launch L, const double* __restrict__ share, int* __restrict__ hist,
    double* __restrict__ tpart, int* __restrict__ snaps) {
  extern __shared__ int sh_count[];
  const Geo& g = L.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = blockIdx.y * g.wpc + warp;
  const int tile = blockIdx.x;
  int* h = sh_count + warp * g.nb;
  if (o >= L.O) return;  // a whole warp; no CTA barrier follows
  for (int b = lane; b < g.nb; b += 32) h[b] = 0;
  float R[9];
  bioem_snap::rotation_matrix(L.angles + 4 * (size_t)o, L.quat != 0, R);
  const bioem_snap::Frame f = bioem_snap::make_frame(g.N, L.c.pix, L.shift_x, L.shift_y);
  __syncwarp();
  double tsum = 0.0;
  const int p1 = min(L.P, (tile + 1) * g.tile);
  for (int p = tile * g.tile + lane; p < p1; p += 32) {
    const Point q = load_point(f, R, L.c, L.points, L.radii, L.dens, p);
    if (snaps != nullptr) {
      snaps[((size_t)o * 2) * L.P + p] = q.sn.ii;
      snaps[((size_t)o * 2 + 1) * L.P + p] = q.sn.jj;
    }
    if (q.reach < 0) continue;
    tsum = __dadd_rn(tsum, share[p]);
    const Box bx = box_of(q.sn.ii, q.sn.jj, q.reach, g.N);
    for (int br = bx.tr0; br <= bx.tr1; ++br)
      for (int bc = bx.tc0; bc <= bx.tc1; ++bc) atomicAdd(&h[br * g.nbc + bc], 1);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) tsum = __dadd_rn(tsum, __shfl_xor_sync(kFull, tsum, off));
  if (lane == 0) tpart[(size_t)o * g.nt + tile] = tsum;
  __syncwarp();
  int* out = hist + ((size_t)o * g.nt + tile) * g.nb;
  for (int b = lane; b < g.nb; b += 32) out[b] = h[b];
}

// scan, first part: per (orientation, 32 bins) the counts' exclusive prefix
// over the tiles, in place, and the bins' totals.
__global__ void __launch_bounds__(128) raster_projection_kernel_scan_tiles(
    int* __restrict__ hist, int* __restrict__ btot, int nt, int nb) {
  const int o = blockIdx.y;
  const int b = (blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5)) * 32 + (threadIdx.x & 31);
  if (b >= nb) return;
  int* col = hist + (size_t)o * nt * nb + b;
  int run = 0;
  int t = 0;
  for (; t + 8 <= nt; t += 8) {
    int v[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) v[u] = col[(size_t)(t + u) * nb];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      col[(size_t)(t + u) * nb] = run;
      run += v[u];
    }
  }
  for (; t < nt; ++t) {
    const int v = col[(size_t)t * nb];
    col[(size_t)t * nb] = run;
    run += v;
  }
  btot[(size_t)o * nb + b] = run;
}

// scan, second part: per orientation the bins' starts (an exclusive prefix
// over the bins, and the total last) and the scale norm_den / tempden, the
// tiles' sums in a fixed tree.
__global__ void __launch_bounds__(1024) raster_projection_kernel_scan_bins(
    const int* __restrict__ btot, int* __restrict__ bstart, const double* __restrict__ tpart,
    const float* __restrict__ norm_den, float* __restrict__ scale, float* __restrict__ scale_out,
    int nt, int nb) {
  __shared__ int wsum[32];
  __shared__ double dsum[32];
  const int o = blockIdx.x;
  const int T = blockDim.x, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  const int per = (nb + T - 1) / T;
  const int b0 = min(t * per, nb), b1 = min(b0 + per, nb);
  const int* in = btot + (size_t)o * nb;
  int mine = 0;
  for (int b = b0; b < b1; ++b) mine += in[b];
  int x = mine;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(kFull, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int v = lane < T / 32 ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int y = __shfl_up_sync(kFull, v, off);
      if (lane >= off) v += y;
    }
    wsum[lane] = v;
  }
  __syncthreads();
  int run = x - mine + (warp > 0 ? wsum[warp - 1] : 0);
  int* out = bstart + (size_t)o * (nb + 1);
  for (int b = b0; b < b1; ++b) {
    out[b] = run;
    run += in[b];
  }
  if (t == T - 1) out[nb] = run;

  double s = 0.0;
  for (int k = t; k < nt; k += T) s = __dadd_rn(s, tpart[(size_t)o * nt + k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __dadd_rn(s, __shfl_xor_sync(kFull, s, off));
  if (lane == 0) dsum[warp] = s;
  __syncthreads();
  if (t == 0) {
    double tot = 0.0;
    for (int w = 0; w < T / 32; ++w) tot = __dadd_rn(tot, dsum[w]);
    const float sc = __double2float_rn(__ddiv_rn((double)*norm_den, tot));
    scale[o] = sc;
    if (scale_out != nullptr) scale_out[o] = sc;
  }
}

// scatter: each warp writes its tile's entries for its orientation into
// the bins' lists, in model order (header).
__global__ void __launch_bounds__(kMaxWarps * 32) raster_projection_kernel_scatter(
    Launch L, const int* __restrict__ hist, const int* __restrict__ bstart,
    int4* __restrict__ entries) {
  extern __shared__ int sh_cursor[];
  const Geo& g = L.g;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int o = blockIdx.y * g.wpc + warp;
  const int tile = blockIdx.x;
  int* cur = sh_cursor + warp * g.nb;
  if (o >= L.O) return;  // a whole warp; no CTA barrier follows
  const int* h = hist + ((size_t)o * g.nt + tile) * g.nb;
  const int* bs = bstart + (size_t)o * (g.nb + 1);
  for (int b = lane; b < g.nb; b += 32) cur[b] = bs[b] + h[b];
  float R[9];
  bioem_snap::rotation_matrix(L.angles + 4 * (size_t)o, L.quat != 0, R);
  const bioem_snap::Frame f = bioem_snap::make_frame(g.N, L.c.pix, L.shift_x, L.shift_y);
  const size_t region = (size_t)o * g.cap;
  __syncwarp();
  const int p0 = tile * g.tile, p1 = min(L.P, p0 + g.tile);
  for (int base = p0; base < p1; base += 32) {
    const int p = base + lane;
    Point q;
    q.reach = -1;
    if (p < p1) q = load_point(f, R, L.c, L.points, L.radii, L.dens, p);
    const bool in = q.reach >= 0;
    Box bx{0, -1, 0, -1};
    int packed = 0;
    if (in) {
      bx = box_of(q.sn.ii, q.sn.jj, q.reach, g.N);
      packed = q.sn.ii | (q.sn.jj << 10) | (q.reach << 20) | ((int)q.sn.small << 30);
    }
    // the round's widest boxes: each lane's bins lie in distinct residues of
    // (row bin mod mr, column bin mod mc)
    int mr = bx.tr1 - bx.tr0 + 1, mc = bx.tc1 - bx.tc0 + 1;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      mr = max(mr, __shfl_xor_sync(kFull, mr, off));
      mc = max(mc, __shfl_xor_sync(kFull, mc, off));
    }
    const int rr0 = in ? bx.tr0 % mr : 0, rc0 = in ? bx.tc0 % mc : 0;
    for (int sr = 0; sr < mr; ++sr) {
      const int br = bx.tr0 + (sr - rr0 + mr) % mr;
      for (int sc = 0; sc < mc; ++sc) {
        const int bc = bx.tc0 + (sc - rc0 + mc) % mc;
        const bool has = in && br <= bx.tr1 && bc <= bx.tc1;
        const int key = has ? br * g.nbc + bc : -1;
        // one bin at a time, the lowest pending lane's: its lanes take
        // places in lane order after the bin's cursor
        unsigned pend = __ballot_sync(kFull, has);
        while (pend != 0) {
          const int k = __shfl_sync(kFull, key, __ffs(pend) - 1);
          const unsigned same = __ballot_sync(kFull, key == k);
          const int at = cur[k];
          if (key == k)
            entries[region + at + __popc(same & ((1u << lane) - 1u))] =
                make_int4(packed, __float_as_int(q.d), __float_as_int(q.r), 0);
          __syncwarp();
          if (lane == 0) cur[k] = at + __popc(same);
          __syncwarp();
          pend &= ~same;
        }
      }
    }
  }
}

// deposit: one warp per (bin, orientation), one pixel per lane (header);
// kTable: the octant weights from a table of table_width(R) floats an
// entry, else formed at each pixel.
template <bool kTable>
__global__ void __launch_bounds__(kDepWarps * 32) raster_projection_kernel_deposit(
    const int4* __restrict__ entries, const int* __restrict__ bstart,
    const float* __restrict__ scale, int nbr, int nbc, int N, long long cap, Consts c,
    float* __restrict__ out) {
  extern __shared__ float sh_dep[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nb = nbr * nbc;
  const int bin = blockIdx.x * kDepWarps + warp;
  const int o = blockIdx.y;
  if (bin >= nb) return;  // a whole warp; no CTA barrier follows
  const int W = kTable ? octants(c.R) : 0;
  float* rows = sh_dep + (size_t)warp * 32 * (kRow + W);  // 32 entry rows of the bin's pixels
  float* oct = rows + 32 * kRow;                         // each entry's octant weights
  for (int i = lane; i < 32 * kRow; i += 32) rows[i] = 0.f;
  const int row0 = (bin / nbc) * kTH, col0 = (bin % nbc) * kTW;
  const int* bs = bstart + (size_t)o * (nb + 1);
  const int s = bs[bin], e = bs[bin + 1];
  const size_t region = (size_t)o * cap;
  float* mine = rows + lane * kRow;
  float* moct = oct + lane * W;
  __syncwarp();
  float acc = 0.f;
  for (int at = s; at < e; at += 32) {
    if (at + lane < e) {
      const int4 en = entries[region + at + lane];
      const int pk = en.x;
      const float d = __int_as_float(en.y), r = __int_as_float(en.z);
      const int ii = pk & 1023, jj = (pk >> 10) & 1023, reach = (pk >> 20) & 1023;
      const bool small = (pk >> 30) & 1;
      if (kTable)
        for (int b = 0; b <= reach; ++b)
          for (int a = 0; a <= b; ++a)
            moct[b * (b + 1) / 2 + a] = weight_at(c, a * a + b * b, r, d, small);
      const int ra = max(ii - reach, row0), rb = min(ii + reach, row0 + kTH - 1);
      const int ca = max(jj - reach, col0), cb = min(jj + reach, col0 + kTW - 1);
      for (int rr = ra; rr <= rb; ++rr) {
        const int du = abs(rr - ii);
        for (int cc = ca; cc <= cb; ++cc) {
          const int dv = abs(cc - jj);
          const int lo = min(du, dv), hi = max(du, dv);
          mine[(rr - row0) * kTW + (cc - col0)] =
              kTable ? moct[hi * (hi + 1) / 2 + lo] : weight_at(c, du * du + dv * dv, r, d, small);
        }
      }
    }
    __syncwarp();
#pragma unroll 8
    for (int j = 0; j < 32; ++j) {
      float* cell = rows + j * kRow + lane;
      acc = __fadd_rn(acc, *cell);
      *cell = 0.f;
    }
    __syncwarp();
  }
  const int row = row0 + lane / kTW, col = col0 + lane % kTW;
  if (row < N && col < N) out[((size_t)o * N + row) * N + col] = __fmul_rn(acc, scale[o]);
}

// ---------------------------------------------------------------------------
// The lattice variant (header): a CTA per (pixel tile, orientation)
// ---------------------------------------------------------------------------

constexpr int kLTile = 32;            // pixels a side of a CTA's tile
constexpr int kLThreads = 256;        // a tile's 1024 pixels, four a thread in the gather
constexpr int kLMaxReach = 3;         // the widest instance
constexpr int kLMaxAxes = 3 * 4096;   // axis coordinates held in shared memory
constexpr float kLMargin = 1.f;       // the walk's margin around the widened tile, in pixels
constexpr int kLMaxRows = 208;        // rows of a plane's walk: ≤ 194 at steps in [0.8, 1.25]·pix
constexpr int kLScaleBlocks = 16;     // CTAs per orientation of the scale

struct LatticeLaunch {
  const float* angles;
  int quat;
  const float *axes, *dens;  // axes: x, y, z, then the largest |density|
  int n[3];     // nx, ny, nz
  int P;        // points of the layout (the snaps' stride), ≥ nx·ny·nz
  int N, shift_x, shift_y, tiles_c;
  float r;      // the lattice's one radius
  Consts c;
  float* out;
  int* snaps;
  double* tpart;  // (O, tiles) tempden's tile sums
};

__device__ inline float pick3(const float v[3], int d) { return d == 0 ? v[0] : d == 1 ? v[1] : v[2]; }

// The lattice kernel (header): each warp walks its planes of the axis most
// nearly along the view, row by row, snapping each voxel whose fit lies in
// the widened tile once with bioem_snap::snap_point on its own coordinates;
// those that land in it add their octant weights, in 64-bit fixed point,
// into their pixel's sums; then each pixel of the tile adds its neighbours'
// sums at its offset from them and rounds the total to f32 once.
template <int kReach>
__global__ void __launch_bounds__(kLThreads, 3) raster_projection_kernel_lattice(LatticeLaunch L) {
  constexpr int E = kLTile + 2 * kReach;                // the widened tile's side
  constexpr int W = (kReach + 1) * (kReach + 2) / 2;    // octant entries
  constexpr int kPer = kLTile * kLTile / kLThreads;     // gathered pixels a thread
  constexpr int kWarps = kLThreads / 32;
  extern __shared__ unsigned sh_lat[];
  __shared__ double red[kWarps];
  __shared__ int row_tab[kWarps * 2 * (kLMaxRows + 1)];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int o = blockIdx.y, tile = blockIdx.x;
  const int n_ax = L.n[0] + L.n[1] + L.n[2];
  unsigned* S_lo = sh_lat;                               // [W][E·E] each pixel's sums,
  int* S_hi = reinterpret_cast<int*>(sh_lat + W * E * E); // their low and high words
  float* ax = reinterpret_cast<float*>(sh_lat + 2 * W * E * E);
  for (int i = tid; i < n_ax; i += kLThreads) ax[i] = L.axes[i];
  for (int i = tid; i < 2 * W * E * E; i += kLThreads) sh_lat[i] = 0u;
  const int r0 = (tile / L.tiles_c) * kLTile, c0 = (tile % L.tiles_c) * kLTile;
  float R[9];
  bioem_snap::rotation_matrix(L.angles + 4 * (size_t)o, L.quat != 0, R);
  const bioem_snap::Frame f = bioem_snap::make_frame(L.N, L.c.pix, L.shift_x, L.shift_y);
  __syncthreads();

  // the axes' evenly spaced fits and the plane axis a: the largest
  // |R[2][a]| / |h_a| (the best-conditioned in-plane map); b < c the others
  float h[3], c0f[3], gi[3], gj[3];
  int a = 0;
  float best = -1.f;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float* A = ax + (d > 0 ? L.n[0] : 0) + (d > 1 ? L.n[1] : 0);
    c0f[d] = A[0];
    h[d] = __fdiv_rn(__fsub_rn(A[L.n[d] - 1], A[0]), (float)(L.n[d] - 1));
    gi[d] = __fmul_rn(__fmul_rn(R[d], h[d]), f.inv_pix);
    gj[d] = __fmul_rn(__fmul_rn(R[3 + d], h[d]), f.inv_pix);
    const float score = __fdiv_rn(fabsf(R[6 + d]), fabsf(h[d]));
    if (score > best) {
      best = score;
      a = d;
    }
  }
  const int b = a == 0 ? 1 : 0, cc = a == 2 ? 1 : 2;
  const int nb = b == 0 ? L.n[0] : L.n[1], nc = cc == 1 ? L.n[1] : L.n[2];
  const int na = a == 0 ? L.n[0] : a == 1 ? L.n[1] : L.n[2];
  const int sa = a == 0 ? L.n[1] * L.n[2] : a == 1 ? L.n[2] : 1;
  const int sb = b == 0 ? L.n[1] * L.n[2] : L.n[2], sc = cc == 1 ? L.n[2] : 1;
  const float* Aa = ax + (a > 0 ? L.n[0] : 0) + (a > 1 ? L.n[1] : 0);
  const float* Ab = ax + (b > 0 ? L.n[0] : 0);
  const float* Ac = ax + L.n[0] + (cc > 1 ? L.n[1] : 0);
  // t = x/pix + N/2 + 0.5 − shift, the pre-floor pixel coordinate whose
  // floor is the snapped pixel; on the fit t = (ti0, tj0) + g_a·k + g_b·u + g_c·v
  const float ti0 = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fadd_rn(
      __fmul_rn(R[0], c0f[0]), __fmul_rn(R[1], c0f[1])), __fmul_rn(R[2], c0f[2])), f.inv_pix),
      f.half), 0.5f), (float)L.shift_x);
  const float tj0 = __fsub_rn(__fadd_rn(__fadd_rn(__fmul_rn(__fadd_rn(__fadd_rn(
      __fmul_rn(R[3], c0f[0]), __fmul_rn(R[4], c0f[1])), __fmul_rn(R[5], c0f[2])), f.inv_pix),
      f.half), 0.5f), (float)L.shift_y);
  const float gia = pick3(gi, a), gja = pick3(gj, a);
  const float gib = pick3(gi, b), gjb = pick3(gj, b), gic = pick3(gi, cc), gjc = pick3(gj, cc);
  const float det = __fsub_rn(__fmul_rn(gib, gjc), __fmul_rn(gic, gjb));
  const float m00 = __fdiv_rn(gjc, det), m01 = __fdiv_rn(-gic, det);
  // the widened tile with the walk's margin, in t
  const float lo_i = (float)(r0 - kReach) - kLMargin, hi_i = (float)(r0 + kLTile + kReach) + kLMargin;
  const float lo_j = (float)(c0 - kReach) - kLMargin, hi_j = (float)(c0 + kLTile + kReach) + kLMargin;
  const float hu_t = __fmul_rn(__fadd_rn(fabsf(m00), fabsf(m01)), 0.5f * (hi_i - lo_i));
  const float ci_t = 0.5f * (lo_i + hi_i), cj_t = 0.5f * (lo_j + hi_j);
  // a row's columns: both coordinates' intervals, through 1/g_c
  const bool use_i = fabsf(gic) > 1e-6f, use_j = fabsf(gjc) > 1e-6f;
  const float rgi = use_i ? 1.f / gic : 0.f, rgj = use_j ? 1.f / gjc : 0.f;

  // each octant entry's density-free factors, as weight_at forms them
  const float rad2 = __fmul_rn(L.r, L.r);
  const float den = __fmul_rn(__fmul_rn(L.c.c_den, L.r), rad2);
  float chord[W];
  bool inside[W];
  float cmax = 0.f;
#pragma unroll
  for (int bb = 0; bb <= kReach; ++bb)
#pragma unroll
    for (int aa = 0; aa <= bb; ++aa) {
      const int e = bb * (bb + 1) / 2 + aa;
      const float dist = __fmul_rn(__fmul_rn((float)(aa * aa + bb * bb), L.c.pix), L.c.pix);
      inside[e] = dist < rad2;
      chord[e] = __fmul_rn(L.c.c_chord, __fsqrt_rn(fmaxf(__fsub_rn(rad2, dist), 0.f)));
      if (inside[e]) cmax = fmaxf(cmax, chord[e]);
    }
  // The fixed point (header): weights times 2^fx, each then below 2^(57 −
  // lg na − lg (2·reach + 1)²) in size (the model's largest |density|, after
  // the axes, bounds them; 2^45 at 224 planes), so that a pixel's sums over
  // the planes (at most 32 voxels of a plane snap to one pixel) and a
  // gather of them stay below 2^62.
  const float wmax = __fmul_rn(__fdiv_rn(__fmul_rn(__fmul_rn(cmax, L.axes[n_ax]), 3.f), den),
                               1.0001f);
  const int room = 57 - (32 - __clz(na)) - (32 - __clz((2 * kReach + 1) * (2 * kReach + 1)));
  const int fx = wmax > 0.f ? min(max(room - (ilogbf(wmax) + 1), -100), 100) : 0;
  const float up = scalbnf(1.f, fx);                     // exact scalings
  const int N = L.N;
  double tsum = 0.0;  // tempden's share of the tile

  const int rs = warp * 2 * (kLMaxRows + 1), rv = rs + kLMaxRows + 1;  // this warp's plane's
                                                                        // row starts, first columns
  for (int k = warp; k < na; k += kWarps) {
    const float bi = __fadd_rn(ti0, __fmul_rn(gia, (float)k));
    const float bj = __fadd_rn(tj0, __fmul_rn(gja, (float)k));
    const float uc = __fadd_rn(__fmul_rn(m00, __fsub_rn(ci_t, bi)),
                               __fmul_rn(m01, __fsub_rn(cj_t, bj)));
    const int u0 = (int)ceilf(fmaxf(__fsub_rn(uc, hu_t), 0.f));
    const int u1 = (int)floorf(fminf(__fadd_rn(uc, hu_t), (float)(nb - 1)));
    const int nrows = u1 - u0 + 1;
    if (nrows > kLMaxRows) __trap();  // steps outside the detector's range
    // the plane's rows: each row's columns whose fit lies in the widened
    // tile with the margin, and the running count of the rows' voxels
    int total = 0;
    for (int t0 = 0; t0 < nrows; t0 += 32) {
      const int t = t0 + lane;
      int vlo = 0, len = 0;
      if (t < nrows) {
        const float uf = (float)(u0 + t);
        const float ri = __fadd_rn(bi, __fmul_rn(gib, uf));
        const float rj = __fadd_rn(bj, __fmul_rn(gjb, uf));
        float vl = 0.f, vh = (float)(nc - 1);
        bool any = true;
        if (use_i) {
          const float x = (lo_i - ri) * rgi, y = (hi_i - ri) * rgi;
          vl = fmaxf(vl, fminf(x, y));
          vh = fminf(vh, fmaxf(x, y));
        } else {
          any = ri >= lo_i && ri <= hi_i;
        }
        if (use_j) {
          const float x = (lo_j - rj) * rgj, y = (hi_j - rj) * rgj;
          vl = fmaxf(vl, fminf(x, y));
          vh = fminf(vh, fmaxf(x, y));
        } else {
          any = any && rj >= lo_j && rj <= hi_j;
        }
        if (any && vl <= vh) {
          vlo = (int)ceilf(vl);
          len = max((int)floorf(vh) - vlo + 1, 0);
        }
        row_tab[rv + t] = vlo;
      }
      int x = len;  // inclusive scan over the lanes
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(kFull, x, off);
        if (lane >= off) x += y;
      }
      if (t < nrows) row_tab[rs + t] = total + x - len;
      total += __shfl_sync(kFull, x, 31);
    }
    if (lane == 0) row_tab[rs + max(nrows, 0)] = total;
    __syncwarp();
    // the plane's voxels as one list, 32 at a time
    const float pa = Aa[k];
    const int pk = k * sa;
    // a chunk's 32 voxels to the lanes 8 apart (lane ℓ: voxel (ℓ % 4)·8 +
    // ℓ / 4), so that the lanes of one atomic seldom share a pixel
    const int spread = (lane & 3) * 8 + (lane >> 2);
    int j = 0;
    for (int fl = spread; fl < total; fl += 32) {
      while (row_tab[rs + j + 1] <= fl) ++j;
      const int u = u0 + j, v = row_tab[rv + j] + (fl - row_tab[rs + j]);
      const int p = pk + u * sb + v * sc;  // P < 2^31 (the C entry checks)
      const float d = __ldg(L.dens + p);
      const float pu = Ab[u], pv = Ac[v];
      const float x0 = a == 0 ? pa : b == 0 ? pu : pv;
      const float x1 = a == 1 ? pa : b == 1 ? pu : pv;
      const float x2 = a == 2 ? pa : pv;
      const bioem_snap::Snap sn = bioem_snap::snap_point(f, R, x0, x1, x2, L.r);
      const int ei = sn.ii - (r0 - kReach), ej = sn.jj - (c0 - kReach);
      const bool interior = sn.ii >= r0 && sn.ii < min(r0 + kLTile, N) && sn.jj >= c0 &&
                            sn.jj < min(c0 + kLTile, N);
      if (L.snaps != nullptr && interior) {
        L.snaps[((size_t)o * 2) * L.P + p] = sn.ii;
        L.snaps[((size_t)o * 2 + 1) * L.P + p] = sn.jj;
      }
      if (!sn.valid || ei < 0 || ei >= E || ej < 0 || ej >= E) continue;
      const int key = ei * E + ej;
      double share = 0.0;
      long long q[W];
#pragma unroll
      for (int bb = 0; bb <= kReach; ++bb)
#pragma unroll
        for (int aa = 0; aa <= bb; ++aa) {
          const int e = bb * (bb + 1) / 2 + aa;
          const int mult = bb == 0 ? 1 : (aa == 0 || aa == bb) ? 4 : 8;
          q[e] = 0;
          if (!inside[e]) continue;
          const float x = __fmul_rn(__fmul_rn(chord[e], d), 3.f);
          const float w = __fdiv_rn(x, den);
          q[e] = __float2ll_rn(__fmul_rn(w, up));
          share = __dadd_rn(share, __dmul_rn((double)mult, (double)w));  // prep's order
        }
      if (interior) tsum = __dadd_rn(tsum, share);
      // the low words first, then the high words with their carries, so
      // that the entries' atomics overlap: each sum is 64-bit fixed point held
      // as (hi, lo) words, added with native 32-bit atomics (a 64-bit shared
      // atomicAdd is a compare-and-swap loop on sm_90); exact in any order
      unsigned old[W];
#pragma unroll
      for (int e = 0; e < W; ++e)
        if (inside[e]) old[e] = atomicAdd(S_lo + e * E * E + key, (unsigned)q[e]);
#pragma unroll
      for (int e = 0; e < W; ++e) {
        if (!inside[e]) continue;
        const int up_e = (int)(q[e] >> 32) + (old[e] + (unsigned)q[e] < old[e] ? 1 : 0);
        if (up_e != 0) atomicAdd(S_hi + e * E * E + key, up_e);
      }
    }
    __syncwarp();
  }
  __syncthreads();
  // each pixel of the tile: its neighbours' sums at its offset from them
  const double down = scalbn(1.0, -fx);
#pragma unroll
  for (int m = 0; m < kPer; ++m) {
    const int px = tid + m * kLThreads;
    const int i = px / kLTile + kReach, j = px % kLTile + kReach;
    long long acc = 0;
#pragma unroll
    for (int du = -kReach; du <= kReach; ++du)
#pragma unroll
      for (int dv = -kReach; dv <= kReach; ++dv) {
        const int lo = min(abs(du), abs(dv)), hi = max(abs(du), abs(dv));
        const int at = (hi * (hi + 1) / 2 + lo) * E * E + (i - du) * E + (j - dv);
        acc += ((long long)S_hi[at] << 32) + (long long)S_lo[at];
      }
    const int row = r0 + i - kReach, col = c0 + j - kReach;
    if (row < N && col < N)
      L.out[((size_t)o * N + row) * N + col] = __double2float_rn(__dmul_rn(__ll2double_rn(acc), down));
  }
  // tempden's tile sum: each thread's, then a fixed tree
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) tsum = __dadd_rn(tsum, __shfl_xor_sync(kFull, tsum, off));
  if (lane == 0) red[warp] = tsum;
  __syncthreads();
  if (tid == 0) {
    double t = 0.0;
    for (int w = 0; w < kWarps; ++w) t = __dadd_rn(t, red[w]);
    L.tpart[(size_t)o * gridDim.x + tile] = t;
  }
}

// The lattice variant's scale: per orientation tempden from its tiles' sums
// in a fixed tree, norm_den / tempden rounded to f32 once, and the
// orientation's pixels times it (a chunk of them per CTA).
__global__ void __launch_bounds__(256) raster_projection_kernel_lattice_scale(
    const double* __restrict__ tpart, int tiles, const float* __restrict__ norm_den,
    float* __restrict__ out, int nn, float* __restrict__ scale_out) {
  __shared__ double dsum[8];
  __shared__ float sc_sh;
  const int o = blockIdx.y, t = threadIdx.x, lane = t & 31, warp = t >> 5;
  double s = 0.0;
  for (int k = t; k < tiles; k += 256) s = __dadd_rn(s, tpart[(size_t)o * tiles + k]);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) s = __dadd_rn(s, __shfl_xor_sync(kFull, s, off));
  if (lane == 0) dsum[warp] = s;
  __syncthreads();
  if (t == 0) {
    double tot = 0.0;
    for (int w = 0; w < 8; ++w) tot = __dadd_rn(tot, dsum[w]);
    const float sc = __double2float_rn(__ddiv_rn((double)*norm_den, tot));
    sc_sh = sc;
    if (scale_out != nullptr && blockIdx.x == 0) scale_out[o] = sc;
  }
  __syncthreads();
  const float sc = sc_sh;
  const int per = (nn + gridDim.x - 1) / gridDim.x;
  const int i0 = blockIdx.x * per, i1 = min(nn, i0 + per);
  float* row = out + (size_t)o * nn;
  for (int i = i0 + t; i < i1; i += 256) row[i] = __fmul_rn(row[i], sc);
}

// The census: per orientation, the points the snap drops out of the frame
// (a group of 32 orientations per CTA, their matrices in shared memory).
__global__ void __launch_bounds__(256) bounds_census_kernel(
    const float* __restrict__ angles, int quat, int O, const float* __restrict__ points,
    const float* __restrict__ radii, int P, int N, float pix, int shift_x, int shift_y,
    int per_thread, unsigned long long* __restrict__ oob) {
  __shared__ float Rs[32][9];
  __shared__ unsigned cnt[32];
  const int o0 = blockIdx.y * 32;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x < 32) {
    if (o0 + threadIdx.x < O)
      bioem_snap::rotation_matrix(angles + 4 * (size_t)(o0 + threadIdx.x), quat != 0,
                                  Rs[threadIdx.x]);
    cnt[threadIdx.x] = 0;
  }
  __syncthreads();
  const int no = min(32, O - o0);
  const bioem_snap::Frame f = bioem_snap::make_frame(N, pix, shift_x, shift_y);
  const size_t first = (size_t)blockIdx.x * blockDim.x * per_thread + threadIdx.x;
  for (int k = 0; k < per_thread; ++k) {
    const size_t p = first + (size_t)k * blockDim.x;
    const bool live = p < (size_t)P;
    float x = 0.f, y = 0.f, z = 0.f, r = 0.f;
    if (live) {
      x = points[3 * p];
      y = points[3 * p + 1];
      z = points[3 * p + 2];
      r = radii[p];
    }
    for (int u = 0; u < no; ++u) {
      const bool bad = live && !bioem_snap::snap_point(f, Rs[u], x, y, z, r).valid;
      const unsigned b = __ballot_sync(kFull, bad);
      if (lane == 0 && b != 0) atomicAdd(&cnt[u], (unsigned)__popc(b));
    }
  }
  __syncthreads();
  if (threadIdx.x < no && cnt[threadIdx.x] != 0)
    atomicAdd(oob + o0 + threadIdx.x, (unsigned long long)cnt[threadIdx.x]);
}

}  // namespace

extern "C" {

// The largest stencil half-width G4 takes: an entry packs a point's reach
// in 10 bits.
int bioem_raster_max_stencil_half() { return kMaxS; }

// Bytes of the scratch one launch of bioem_raster_project needs (0: the
// shapes are out of its range).
size_t bioem_raster_scratch_bytes(int O, int P, int N, int S, float pix) {
  if (O < 1 || O > 65535 || P < 1 || N < 1 || N > kMaxN || S < 0 || S > kMaxS || !(pix > 0.f))
    return 0;
  const Geo g = geometry(P, N, reach_bound(S, pix));
  if (g.cap > 0x7fffffffLL || (long long)P > 0x7fffffffLL / 3) return 0;
  return parts(g, O, P).total;
}

int bioem_raster_project(const float* angles, int quat, const float* points, const float* radii,
                         const float* dens, const float* norm_den, int O, int P, int N, float pix,
                         int shift_x, int shift_y, int S, float c_chord, float c_den, float* out,
                         int* snaps, float* scale, void* scratch, size_t scratch_bytes,
                         void* stream) {
  const size_t need = bioem_raster_scratch_bytes(O, P, N, S, pix);
  if (need == 0 || scratch == nullptr || scratch_bytes < need) return (int)cudaErrorInvalidValue;
  const int R = reach_bound(S, pix);
  const Geo g = geometry(P, N, R);
  const Parts pt = parts(g, O, P);
  unsigned char* base = static_cast<unsigned char*>(scratch);
  int* hist = reinterpret_cast<int*>(base + pt.hist);
  int* btot = reinterpret_cast<int*>(base + pt.btot);
  int* bstart = reinterpret_cast<int*>(base + pt.bstart);
  double* tpart = reinterpret_cast<double*>(base + pt.tpart);
  double* share = reinterpret_cast<double*>(base + pt.share);
  float* sc = reinterpret_cast<float*>(base + pt.scale);
  int4* entries = reinterpret_cast<int4*>(base + pt.entries);
  const cudaStream_t st = (cudaStream_t)stream;
  const Launch L{angles, quat, points, radii, dens, O, P, shift_x, shift_y,
                 Consts{pix, c_chord, c_den, S, R}, g};
  const size_t smem_cs = (size_t)g.wpc * g.nb * sizeof(int);
  const int W = table_width(R);
  const size_t smem_dep = deposit_smem(W);
  const auto deposit = W > 0 ? raster_projection_kernel_deposit<true>
                             : raster_projection_kernel_deposit<false>;
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(raster_projection_kernel_count,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_cs)) ||
      (err = cudaFuncSetAttribute(raster_projection_kernel_scatter,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_cs)) ||
      (err = cudaFuncSetAttribute(deposit, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem_dep)))
    return (int)err;
  const dim3 grid_cs(g.nt, (O + g.wpc - 1) / g.wpc);
  raster_projection_kernel_prep<<<(P + 255) / 256, 256, 0, st>>>(L, share);
  raster_projection_kernel_count<<<grid_cs, g.wpc * 32, smem_cs, st>>>(L, share, hist, tpart,
                                                                       snaps);
  raster_projection_kernel_scan_tiles<<<dim3((g.nb + 127) / 128, O), 128, 0, st>>>(hist, btot,
                                                                                   g.nt, g.nb);
  raster_projection_kernel_scan_bins<<<O, 1024, 0, st>>>(btot, bstart, tpart, norm_den, sc, scale,
                                                         g.nt, g.nb);
  raster_projection_kernel_scatter<<<grid_cs, g.wpc * 32, smem_cs, st>>>(L, hist, bstart,
                                                                         entries);
  deposit<<<dim3((g.nb + kDepWarps - 1) / kDepWarps, O), kDepWarps * 32, smem_dep, st>>>(
      entries, bstart, sc, g.nbr, g.nbc, N, g.cap, L.c, out);
  return (int)cudaGetLastError();
}

// The widest reach of the lattice variant's instances, its tile's side and
// its walk's margin around the widened tile, in pixels (the tests' twin of
// the walk reads the same numbers from ops/project_cuda.py).
int bioem_raster_lattice_max_reach() { return kLMaxReach; }
int bioem_raster_lattice_tile() { return kLTile; }
float bioem_raster_lattice_margin() { return kLMargin; }

// Bytes of the scratch one launch of bioem_raster_project_lattice needs:
// tempden's tile sums, (O, tiles) f64.
size_t bioem_raster_lattice_scratch_bytes(int O, int N) {
  if (O < 1 || O > 65535 || N < 1 || N > kMaxN) return 0;
  const int t = (N + kLTile - 1) / kLTile;
  return sizeof(double) * (size_t)O * t * t;
}

// G4 on a voxel lattice (header): the points of the layout's first
// nx·ny·nz slots are the C-order broadcast of the axes (x, y, z), every one
// of radius r; axes holds nx + ny + nz + 1 f32, the axes then the largest
// |density| of those slots; the slots after them (a layout's padding) are
// not read. The contract, the snaps and the scale are bioem_raster_project's.
int bioem_raster_project_lattice(const float* angles, int quat, const float* axes, int nx, int ny,
                                 int nz, const float* dens, const float* norm_den, int O, int P,
                                 int N, float pix, int shift_x, int shift_y, int S, float r,
                                 float c_chord, float c_den, float* out, int* snaps, float* scale,
                                 void* scratch, size_t scratch_bytes, void* stream) {
  const size_t need = bioem_raster_lattice_scratch_bytes(O, N);
  if (need == 0 || scratch == nullptr || scratch_bytes < need || S < 1 || S > kMaxS ||
      !(pix > 0.f) || !(r > pix) || nx < 2 || ny < 2 || nz < 2 ||
      nx + ny + nz + 1 > kLMaxAxes || (long long)nx * ny * nz > P || P > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  // the radius's reach, as reach_of finds it
  const int Rb = reach_bound(S, pix);
  const float rad2 = r * r;
  int reach = 0;
  while (reach < Rb && ((float)((reach + 1) * (reach + 1)) * pix) * pix < rad2) ++reach;
  if (reach < 1 || reach > kLMaxReach) return (int)cudaErrorInvalidValue;
  const int tc = (N + kLTile - 1) / kLTile;
  LatticeLaunch L{angles, quat, axes, dens, {nx, ny, nz}, P, N, shift_x, shift_y, tc, r,
                  Consts{pix, c_chord, c_den, S, Rb}, out, snaps, static_cast<double*>(scratch)};
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem_ax = sizeof(float) * (size_t)(nx + ny + nz + 1);
  const dim3 grid(tc * tc, O);
  cudaError_t err = cudaSuccess;
  auto launch = [&](auto kernel, int E, int W) {
    const size_t smem = smem_ax + 2 * sizeof(unsigned) * (size_t)W * E * E;
    if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                    (int)smem)))
      return;
    kernel<<<grid, kLThreads, smem, st>>>(L);
  };
  if (reach == 1)
    launch(raster_projection_kernel_lattice<1>, kLTile + 2, 3);
  else if (reach == 2)
    launch(raster_projection_kernel_lattice<2>, kLTile + 4, 6);
  else
    launch(raster_projection_kernel_lattice<3>, kLTile + 6, 10);
  if (err) return (int)err;
  raster_projection_kernel_lattice_scale<<<dim3(kLScaleBlocks, O), 256, 0, st>>>(
      L.tpart, tc * tc, norm_den, out, N * N, scale);
  return (int)cudaGetLastError();
}

// The census: oob[o] += the points of (points, radii) that the snap of
// orientation row o drops out of the frame, for the O rows of angles. oob,
// (O,) uint64, is the caller's, zeroed.
int bioem_bounds_census(const float* angles, int quat, int O, const float* points,
                        const float* radii, int P, int N, float pix, int shift_x, int shift_y,
                        unsigned long long* oob, void* stream) {
  if (O < 1 || P < 1 || N < 1) return (int)cudaErrorInvalidValue;
  constexpr int kThreads = 256, kPer = 16;
  const long long chunks = ((long long)P + kThreads * kPer - 1) / (kThreads * kPer);
  if (chunks > 0x7fffffffLL || (O + 31) / 32 > 65535) return (int)cudaErrorInvalidValue;
  bounds_census_kernel<<<dim3((unsigned)chunks, (O + 31) / 32), kThreads, 0,
                         (cudaStream_t)stream>>>(angles, quat, O, points, radii, P, N, pix,
                                                 shift_x, shift_y, kPer, oob);
  return (int)cudaGetLastError();
}

}  // extern "C"

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
// Design. The work is O·P snaps and O·P·E deposits (E the nonzero weights
// of a point); a map of 224³ voxels at the 4608 orientations of the BioEM
// manual's grid is 5.2e10 snaps a pass. Each (orientation, point) is
// snapped twice and each deposit made once, in six launches per block:
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
// case of every point meeting ntr·ntc bins at the reach bound.

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

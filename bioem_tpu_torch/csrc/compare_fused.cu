// Per-image fused comparison kernel (K1) for Hopper (sm_90a): stage 1 of
// the displacement-lattice DFT on warpgroup wgmma in 3xTF32, conv formed
// once per orientation·CTF, and at the wide lattices (33 to 128 padded
// rows, the reference grid's D = 81) stage 2 on wgmma in 3xTF32 too. In its
// cc-out body the same kernel is the cc-lattice kernel K3.
//
// Replaces bioem_tpu/ops/compare_pallas.py:_fused_block_kernel (with
// _vector_lse and the _cc_tile_* bodies, entry fused_compare_block) and,
// as K3, _fused_cc_kernel (entry fused_displacement_cc: the lattice cc of
// a conv bank given as (OC, N, F), written to (OC, I, D, D)).
// Per (orientation·ctf oc, image i):
//   conv = proj[o] ⊙ conj(ctf[c]),  p = fold(conv ⊙ img[i])   (M = N/n_fold, F)
//   t1   = wx · p                                              (D, F) complex
//   cc   = Re(t1 · wyᵀ),  v = a_coef · log1p(a_u·cc − b_u·cc²)
//   out  = (max v, Σ exp(v − max), first-occurrence flat argmax d·D+e, cc there)
// Only m is the raw f32 max; the engine repairs it in f64.
//
// What bounds it on the card. Stage 1 is 8·D·M·F real multiply-adds per
// comparison, three times over in 3xTF32 on the tensor cores (0.05 ms of
// TF32 peak at the production block O=8, C=8, I=64, N=224, D=21,
// n_fold=2); p (6·N·F) and the log-sum-exp are f32 on the CUDA cores,
// stage 2 (2·D²·F) too at D ≤ 32. The earlier design (FP32 FMA, one CTA per (oc, image), conv
// re-formed from three spectra by every CTA: ~2.5 GB of L2 reads per
// block) took 1.03 ms; stage 1 on the CUDA cores was half of it. K3 does
// the same stage 1 (3 × 8.71e9 TF32 operations per production block,
// 0.053 ms), no conv product and no log-sum-exp (1.54e9 f32 operations,
// 0.023 ms), and writes the lattice (7.2 MB) beside reading ~26 MB of
// spectra: 0.076 ms, operations-bound. At the reference grid's D = 81 (a
// block O=8, C=32, I=64, N=224, fold 1) stage 1 bounds it at 2.40 ms and
// stage 2 in 3xTF32 with its padding (below) at 0.54 ms; what the kernel
// pays beyond the products is per formed p (the image loads, the conv
// product, the TF32 split, the barriers of each K chunk), so a wide
// lattice forms each p once for as many of its rows as one warpgroup's
// registers hold (below), and stage 2, which on the CUDA cores was bound
// by its shared-memory reads (2.9 ms of K1's 8.4 there), runs on the
// tensor cores.
//
// Design.
// * Two kernels in one launch of the entry point. A prologue forms the conv
//   bank (OC, N, Fp) once per oc, as interleaved complex rows padded with
//   zeros to Fp = 64·⌈F/64⌉ (16-byte aligned rows), and W = [[wx_re,
//   −wx_im], [wx_im, wx_re]] split hi/lo in TF32, cut into (N chunk, K
//   chunk) blocks already in wgmma's shared-memory layout, and wy: as
//   (Fp, D) complex rows for stage 2 on the CUDA cores, as stage 2's B
//   blocks on the tensor cores (below). All go to scratch the wrapper
//   allocates; the main kernel only copies them.
// * Roles. t1ᵀ (frequencies × 2Dp) = pᵀ (frequencies × 2M) · Wᵀ: 64
//   frequencies of one image are wgmma's M (an m-tile; F = 113 gives two),
//   a chunk of NP = 2·dc stacked t1 rows (dc lattice rows, re then im) its
//   N, so p is formed straight into registers as the A fragment and read
//   from there by all NP columns of the product. A k8 step holds four
//   folded rows j, real parts at k = 0..3 and imaginary parts at k = 4..7.
// * Row chunks (plan below). With four warpgroups a CTA (128 registers a
//   thread) a chunk holds at most 32 rows (n16…n64): the production block's
//   D = 21 is one chunk. Lattices of 33 to 128 padded rows run two
//   warpgroups a CTA (255 registers) on wide chunks: the whole lattice as
//   one chunk of 64 or 88 rows (NP = 128, 176: 88 accumulators and 88 sums a
//   thread at D = 81) or, from 89 rows, two chunks of 64 (D = 121). The K
//   loop runs once per chunk, so each p a warpgroup forms serves the whole
//   chunk: at D = 81 one p where 32-row chunks formed it three times (the
//   image loads, the conv product, the split and the K chunks' barriers
//   with it). A wide chunk's W block holds t1_re's rows only: t1_im is the
//   same block against p with its real and imaginary parts exchanged (and
//   one negated), a permutation of the A fragment's registers (chain), so
//   W's L2 traffic per comparison stays about that of 32-row chunks on
//   four warpgroups (at D = 81 2.8 against 3 KB an image a k8 step) and
//   its double buffer leaves K chunks of 8. Wider lattices go back to
//   32-row chunks, on four
//   warpgroups and from D = 159 on two: their wy and lattice tiles leave
//   no room for wide ones.
// * conv shared by the images of a CTA. A CTA takes one oc and n_wg
//   consecutive images, one per warpgroup (a run of images ends where I
//   ends: the last CTA's idle warpgroups compute on a copy and write
//   nothing). For each K chunk of KC steps the CTA copies W's block and
//   the conv rows of the chunk (all folds, the m-tile's 64 frequencies)
//   into shared memory with cp.async, a chunk ahead of their use (double
//   buffers, one block barrier per chunk); every warpgroup forms its p
//   from that conv and its own image's rows, loaded into registers a step
//   ahead. W streams through shared memory, so neither D nor M is bounded
//   by a resident W.
// * Overlap. Each warpgroup issues a step's three products asynchronously
//   and forms the next step's fragments while they run.
// * Accuracy. Each operand is split x = hi + lo (hi = tf32(x), lo =
//   tf32(x − hi)); a step forms lo·hi + hi·lo + hi·hi in a zeroed
//   accumulator and adds it to the f32 sum with IEEE adds (K4's scheme:
//   the tensor cores truncate when they accumulate).
// * Stage 2 (cc = Re(t1·wyᵀ)) on the tensor cores at the wide chunks
//   (NP = 128, 176). Per m-tile, the chunk's lattice rows d are M (dc = 88
//   rows as two m64 tiles, the second 24 rows valid; 64 rows as one), the
//   lattice columns e are N (n2 = 88, or 128 in chunks of 64) and K the
//   m-tile's 64 frequencies twice: cc += [t1_re, t1_im] · [wy_re, −wy_im]ᵀ,
//   in two halves (re, then im), each in 3xTF32 k8 steps as stage 1 (a
//   fresh accumulator a step, added to the f32 sums with IEEE adds; a
//   chain of two steps was as accurate but spilled). t1 leaves the
//   accumulators into the warpgroup's two tiles over the chunk buffers
//   (row f, f32; column d ^ 8·(f mod 4), so that the pairs stored and the
//   A fragments loaded meet no bank conflict) and is split into hi/lo as
//   each A fragment is loaded from there: t1 split at the store would need
//   twice the space, which the block does not have beside the lattice. B
//   comes from the prologue split hi/lo in wgmma's layout, two blocks an
//   m-tile (n2 rows × 64 frequencies each: 45,056 bytes at D = 81): the
//   real half is copied with the m-tile's last K chunk, under the stage-1
//   products, the imaginary half over it once both warpgroups are done
//   with it (a block barrier each side; the block holds one half).
//   Chunks of 88 rows run both m64 tiles in turn, two accumulators: one
//   tile's step runs while the other's is added. The m-tile's sums are
//   added into the lattice's rows in shared memory, the earlier m-tiles'
//   values loaded first. The padding (128 × 88 computed for 81 × 81 at
//   D = 81, 56 of the second m-tile's 64 frequencies) costs ~1.9× the
//   products needed: 2.66e11 TF32 operations a reference block, 0.54 ms at
//   peak. Chosen against the other orientation (M = e, N = d): the same
//   padding at D = 81, twice the instructions at D = 121, and t1 would be
//   the shared-memory operand, needing its hi/lo split stored.
// * Stage 2 on the CUDA cores at chunks of ≤ 32 rows (four warpgroups, the
//   production block's D = 21; and 32-row chunks past 128 rows): a
//   warpgroup writes its m-tile's t1 chunk to shared memory; thread (warp
//   w, lane l) sums the lattice columns e ≡ l (mod 32) of rows d =
//   dc·chunk + w·dc/4 + r over the m-tile (re and im terms apart) into the
//   chunk's dc × D rows of the image's lattice in shared memory. It is
//   bound by its shared-memory reads, so at chunks of 32 rows (NP = 64) a
//   thread takes 8 rows and up to three columns e, e + 32, e + 64 at once:
//   each t1 value it reads serves three columns, each wy value 8 rows.
//   Narrower chunks (the production block's D = 21) keep one column a
//   thread: three ran 6 % slower there. wy is read only there, 64
//   frequencies × D at a time: the prologue writes it to scratch as (Fp,
//   D) complex rows, and each m-tile's rows are copied to shared memory by
//   cp.async with the m-tile's last K chunk, so the copy runs under the
//   stage-1 products (one buffer; a block barrier orders it after every
//   warpgroup's stage 2 of the previous m-tile).
// * The lattice, one row chunk at a time. The lattice is walked in n_nc
//   chunks of dc rows (the outer loop, every m-tile inside it); after
//   a chunk's last m-tile its rows are complete and only they are held.
//   K1 reduces them (compare_lse.cuh) by the warpgroup's 128 threads (the
//   first pass leaves each v in place of its cc, carrying the cc at the
//   argmax, so the second pass sums Σ exp(v − max) without recomputing v)
//   and merges the chunk into a running (max, first-occurrence argmax, cc
//   there, Σ exp) with the log-sum-exp's online rule, s ← s·e^(m − m') + s_c·e^(m_c − m'):
//   the chunks come in flat-index order, so `better` keeps the first
//   occurrence; a chunk whose values are all −inf adds nothing, a lattice
//   all −inf ends as the plain version's (argmax 0, Σ exp NaN), and NaN
//   wins and spreads as in jnp.argmax/max. With one chunk (D ≤ 32, or a
//   wide chunk up to D = 88) this is a single reduction. No atomics: two
//   launches on the same inputs give the same bits.
// * Shared memory: W and conv double buffers, the t1 tiles (over those
//   buffers, the region the larger of the two: stage 2 runs between an
//   m-tile's last K chunk and the next m-tile's first copy, behind
//   barriers on both sides, so the K chunk can be longer: fewer barriers,
//   and more of the SM left to L1), stage 2's tile of wy (CUDA cores: one
//   m-tile, 64 × D complex; tensor cores: one half of B) and each
//   warpgroup's chunk of the lattice (dc × D floats): nothing grows with
//   F, and D only through those tiles. The wrapper (ops/compare_cuda.
//   k1_plan) picks the largest K chunk that fits a block, with the wide
//   chunks first where the lattice has them, else four warpgroups and then
//   two; its formula is bioem_fused_compare_smem_bytes below. At D = 81,
//   fold 1: W hi/lo 88 rows × 8 steps × 32 B × 2 = 45,056 B a buffer, two;
//   conv 2 × 17,408; the t1 tiles (2 warpgroups × 2 × 64 × 96 floats,
//   98,304 B) over those 124,928; B's half 45,056; two lattices of 88 × 81
//   floats, 57,088 (each part rounded up to 128 bytes): 227,072 B with K
//   chunks of 8 steps. D = 121 (two chunks of 64, B 128 rows): 227,840 B,
//   also 8.
// * K3 (body kCcOut) runs all of the above but the log-sum-exp: its
//   prologue copies the conv bank it is given into the padded interleaved
//   scratch instead of forming it, and each warpgroup writes its image's
//   lattice chunk by chunk from shared memory to out_cc[(oc·I + i)·D² + q],
//   coalesced. It takes every shape K1 takes, with K1's tiling.
// The body variant V is kFull (K1) or kCcOut (K3) in production; the
// ablation probe P3 instantiates the others at NP = 48 (the production
// block) and NP = 64 with four warpgroups, and at NP = 176 (the reference
// grid's D = 81) with two, kNoStage2 there only.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "compare_lse.cuh"
#include "wgmma.cuh"

namespace {

namespace wg = bioem_wgmma;
using bioem_lse::kCcOut;
using bioem_lse::kFull;
using bioem_lse::kMmOnly;
using bioem_lse::kNoGemm;
using bioem_lse::kNoLse;
using bioem_lse::kNoStage2;

constexpr int kMT = 64;     // frequencies per m-tile (wgmma M)
constexpr int kLdF = 68;    // stride of a staged conv row (float2): conflict-free
                            // fragment reads (rows t = 0..3 land 8 banks apart)
constexpr int kPrepThreads = 256;

__host__ __device__ inline size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// The row chunks of the lattice. Four warpgroups (128 registers a thread)
// take chunks of at most 32 rows (NP ≤ 64). Two warpgroups (255 registers)
// take the wide chunks: the whole padded lattice as one chunk of 64 or 88
// rows (NP = 128 or 176: 88 accumulators and 88 sums a thread) up to Dp = 88,
// two chunks of 64 rows up to Dp = 128; each p a warpgroup forms then serves
// every 32-row part of its chunk. Wider lattices go in 32-row chunks again
// (their wy and lattice tiles leave no room for wide ones), on four
// warpgroups and, from D = 159 where four no longer fit, on two. Two
// warpgroups are not valid below Dp = 33, where four always fit.
constexpr int kWideRows = 88;    // rows of the widest chunk (NP = 176)
constexpr int kWideMaxDp = 128;  // the widest padded lattice in wide chunks (two of 64)

__host__ __device__ inline bool wide_chunks(int Dp, int n_wg) {
  return n_wg == 2 && Dp > 32 && Dp <= kWideMaxDp;
}

// The tiling of a problem, the same on the host and in the kernels.
struct Plan {
  int D, M, F, n_fold, n_wg, KC;
  int Dp, n_nc, dc, NP, wn, n_ks, n_kc, n_mt, Fp;  // wn: rows of a W block
  bool tc2;      // stage 2 on the tensor cores (the wide chunks)
  int n2, ld2;   // tc2: stage 2's N (lattice columns, padded), a t1 tile's row (floats)
  // bytes of one W block, one conv chunk, and one stage-2 tile of wy: an
  // m-tile's (64, D) complex rows (CUDA cores) or one half of its B
  // operand, re or im, hi and lo (tensor cores)
  size_t w_chunk, cv_chunk, wy_tile;
  size_t w, cv, t1, wy, cc, bytes;       // shared-memory offsets and total
  size_t scratch_w, scratch_wy;          // bytes of the W blocks and of wy in scratch
};

__host__ __device__ inline Plan plan(int D, int M, int F, int n_fold, int n_wg, int KC) {
  Plan P;
  P.D = D, P.M = M, P.F = F, P.n_fold = n_fold, P.n_wg = n_wg, P.KC = KC;
  P.Dp = (D + 7) / 8 * 8;
  const bool wide = wide_chunks(P.Dp, n_wg);
  if (wide) {
    P.n_nc = P.Dp <= kWideRows ? 1 : 2;
    P.dc = P.Dp > 64 && P.Dp <= kWideRows ? kWideRows : 64;
  } else {
    P.n_nc = (P.Dp + 31) / 32;
    P.dc = ((P.Dp + P.n_nc - 1) / P.n_nc + 7) / 8 * 8;
  }
  P.NP = 2 * P.dc;
  P.wn = wide ? P.dc : P.NP;  // a wide chunk's W holds t1_re's rows only (chain)
  P.n_ks = (M + 3) / 4;
  P.n_kc = (P.n_ks + KC - 1) / KC;
  P.n_mt = (F + kMT - 1) / kMT;
  P.Fp = P.n_mt * kMT;
  P.tc2 = wide;
  P.n2 = wide ? (P.dc == kWideRows ? kWideRows : kWideMaxDp) : 0;
  P.ld2 = (P.dc + 31) / 32 * 32;
  P.w_chunk = (size_t)2 * P.wn * 32 * KC;  // hi then lo, wn rows × 32·KC bytes
  P.cv_chunk = sizeof(float2) * (size_t)KC * n_fold * 4 * kLdF;
  P.wy_tile = wide ? (size_t)2 * P.n2 * 4 * kMT : sizeof(float2) * (size_t)kMT * D;
  P.w = 0;
  P.cv = P.w + 2 * P.w_chunk;
  // stage 2's t1 tiles lie over the W and conv buffers, which hold nothing
  // between an m-tile's last K chunk and the next m-tile's first copy; the
  // region is the larger of the two
  const size_t chunks = P.cv + 2 * align128(P.cv_chunk);
  const size_t t1 = wide ? align128(sizeof(float) * (size_t)n_wg * 2 * kMT * P.ld2)
                         : align128(sizeof(float) * (size_t)n_wg * kMT * (P.NP + 4));
  P.t1 = 0;
  P.wy = t1 > chunks ? t1 : chunks;
  P.cc = P.wy + align128(P.wy_tile);
  P.bytes = P.cc + align128(sizeof(float) * (size_t)n_wg * P.dc * D);
  P.scratch_w = P.w_chunk * P.n_nc * P.n_kc;
  P.scratch_wy = wide ? (size_t)P.n_mt * 2 * P.wy_tile : sizeof(float2) * (size_t)P.Fp * D;
  return P;
}

// Scratch: the conv bank (OC, N, Fp complex), the W blocks, wy as (Fp, D)
// complex rows (stage 2 on the CUDA cores) or as stage 2's B blocks, two
// an m-tile (tensor cores); each part starts on 128 bytes.
__host__ __device__ inline size_t scratch_conv_bytes(const Plan& P, int OC, int N) {
  return align128(sizeof(float2) * (size_t)OC * N * P.Fp);
}

// ---------------------------------------------------------------------------
// cp.async (16 bytes; src_bytes = 0 writes zeros)
// ---------------------------------------------------------------------------

__device__ __forceinline__ void cp16(void* dst, const void* src, bool ok) {
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(src),
               "r"(ok ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------------------
// Prologue: the conv bank, the W blocks and wy
// ---------------------------------------------------------------------------

// CONV_IN (K3): proj_re/proj_im hold the conv bank (OC, N, F) itself, which
// is copied; otherwise conv = proj[o] ⊙ conj(ctf[c]) is formed (K1).
template <bool CONV_IN>
__global__ void __launch_bounds__(kPrepThreads)
compare_fused_prep_kernel(const float* __restrict__ proj_re, const float* __restrict__ proj_im,
            const float* __restrict__ ctf_re, const float* __restrict__ ctf_im,
            const float* __restrict__ wx_re, const float* __restrict__ wx_im,
            const float* __restrict__ wy_re, const float* __restrict__ wy_im, Plan P, int C,
            int OC, int N, float2* __restrict__ conv, unsigned char* __restrict__ wblk,
            unsigned char* __restrict__ wyp) {
  const size_t n_conv = (size_t)OC * N * P.Fp;
  const size_t n_w = (size_t)P.n_nc * P.n_kc * P.wn * 8 * P.KC;
  const size_t n_wy = P.tc2 ? (size_t)P.n_mt * 2 * P.n2 * kMT : (size_t)P.Fp * P.D;
  const size_t NF = (size_t)N * P.F;
  for (size_t q = (size_t)blockIdx.x * kPrepThreads + threadIdx.x; q < n_conv + n_w + n_wy;
       q += (size_t)gridDim.x * kPrepThreads) {
    if (q < n_conv) {
      const int f = (int)(q % P.Fp);
      const size_t rq = q / P.Fp;
      const int r = (int)(rq % N), oc = (int)(rq / N);
      float2 v = make_float2(0.f, 0.f);
      if (CONV_IN && f < P.F) {
        const size_t ci = (size_t)oc * NF + (size_t)r * P.F + f;
        v = make_float2(proj_re[ci], proj_im[ci]);
      } else if (f < P.F) {
        const int o = oc / C, c = oc - (oc / C) * C;
        const size_t pi = o * NF + (size_t)r * P.F + f, ki = c * NF + (size_t)r * P.F + f;
        const float xr = proj_re[pi], xi = proj_im[pi], kr = ctf_re[ki], ki_ = ctf_im[ki];
        v = make_float2(xr * kr + xi * ki_, xi * kr - xr * ki_);
      }
      conv[q] = v;
      continue;
    }
    if (q >= n_conv + n_w) {
      const size_t qy = q - n_conv - n_w;
      if (P.tc2) {
        // Stage 2's B on the tensor cores, block (m-tile, half) of n2 rows e
        // × 64 frequencies of K: half 0 wy_re, half 1 −wy_im; split hi/lo
        // in wgmma's layout. Rows e ≥ D and frequencies f ≥ F are zero.
        const int kf = (int)(qy % kMT);
        const size_t r = qy / kMT;
        const int e = (int)(r % P.n2);
        const size_t blk = r / P.n2;  // 2·m-tile + half
        const int f = (int)(blk >> 1) * kMT + kf;
        float v = 0.f;
        if (e < P.D && f < P.F)
          v = (blk & 1) ? -wy_im[(size_t)e * P.F + f] : wy_re[(size_t)e * P.F + f];
        const uint32_t hi = wg::to_tf32(v);
        unsigned char* b = wyp + blk * P.wy_tile;
        const uint32_t off = wg::offset_km(e, 4 * kf, 4 * kMT);
        *reinterpret_cast<uint32_t*>(b + off) = hi;
        *reinterpret_cast<uint32_t*>(b + (size_t)P.n2 * 4 * kMT + off) =
            wg::to_tf32(v - __uint_as_float(hi));
      } else {
        // wy row f (frequency), column e; rows f ≥ F are zero
        const int f = (int)(qy / P.D), e = (int)(qy % P.D);
        reinterpret_cast<float2*>(wyp)[qy] =
            f < P.F ? make_float2(wy_re[(size_t)e * P.F + f], wy_im[(size_t)e * P.F + f])
                    : make_float2(0.f, 0.f);
      }
      continue;
    }
    // W block (nc, kc): row n < dc is t1_re[d], row dc + d' is t1_im[d]
    // (a wide chunk's block has the first dc rows only: chain); column
    // 8s + u (u < 4) multiplies Re p[4(kc·KC + s) + u], 8s + 4 + u its Im.
    // Rows d ≥ D and folded rows j ≥ M are zero.
    const size_t qw = q - n_conv;
    const int per_row = 8 * P.KC;
    const int kp = (int)(qw % per_row);
    const size_t rq = qw / per_row;
    const int n = (int)(rq % P.wn);
    const size_t blk = rq / P.wn;  // nc · n_kc + kc
    const int kc = (int)(blk % P.n_kc), nc = (int)(blk / P.n_kc);
    const int j = 4 * (kc * P.KC + (kp >> 3)) + (kp & 3);
    const bool im_col = (kp & 7) >= 4, im_row = n >= P.dc;
    const int d = nc * P.dc + (im_row ? n - P.dc : n);
    float v = 0.f;
    if (d < P.D && j < P.M) {
      const float wr = wx_re[d * P.M + j], wi = wx_im[d * P.M + j];
      v = im_row ? (im_col ? wr : wi) : (im_col ? -wi : wr);
    }
    const uint32_t hi = wg::to_tf32(v);
    const uint32_t kb = 32 * P.KC;
    unsigned char* b = wblk + blk * P.w_chunk;
    const uint32_t off = wg::offset_km(n, 4 * kp, kb);
    *reinterpret_cast<uint32_t*>(b + off) = hi;
    *reinterpret_cast<uint32_t*>(b + (size_t)P.wn * kb + off) =
        wg::to_tf32(v - __uint_as_float(hi));
  }
}

// ---------------------------------------------------------------------------
// The main kernel
// ---------------------------------------------------------------------------

// acc ← lo·W_hi + hi·W_lo + hi·W_hi for step s of the staged W block
// (acc's old value is not read), issued asynchronously. A wide chunk
// (NP = 128, 176) keeps t1_re's rows of W only, [wx_re, −wx_im]: t1_im =
// Im p·wx_re + Re p·wx_im is the same block against p' = (Im p, −Re p),
// the A fragment with its k halves exchanged and the second negated (exact
// in TF32), into the second half of acc. That halves W's bytes, in L2
// traffic and in shared memory, for the same products; only the order of
// t1_im's two k halves within a step differs from a block with its rows.
template <int NP>
__device__ __forceinline__ void chain(float (&acc)[NP / 2], const uint32_t (&hi)[4],
                                      const uint32_t (&lo)[4], const unsigned char* w, int s,
                                      uint32_t kb) {
  const uint64_t dh = wg::desc(w + 256 * s, 128, 8 * kb);
  if constexpr (NP >= 128) {
    constexpr int DC = NP / 2, NH = NP / 4;
    float(&re)[NH] = *reinterpret_cast<float(*)[NH]>(&acc[0]);
    float(&im)[NH] = *reinterpret_cast<float(*)[NH]>(&acc[NH]);
    const uint32_t hs[4] = {hi[2], hi[3], hi[0] ^ 0x80000000u, hi[1] ^ 0x80000000u};
    const uint32_t ls[4] = {lo[2], lo[3], lo[0] ^ 0x80000000u, lo[1] ^ 0x80000000u};
    const uint64_t dl = wg::desc(w + (size_t)DC * kb + 256 * s, 128, 8 * kb);
    wg::fence();
    wg::Tf32RS<DC>::mma(re, lo, dh, 0);
    wg::Tf32RS<DC>::mma(im, ls, dh, 0);
    wg::Tf32RS<DC>::mma(re, hi, dl, 1);
    wg::Tf32RS<DC>::mma(im, hs, dl, 1);
    wg::Tf32RS<DC>::mma(re, hi, dh, 1);
    wg::Tf32RS<DC>::mma(im, hs, dh, 1);
  } else {
    const uint64_t dl = wg::desc(w + (size_t)NP * kb + 256 * s, 128, 8 * kb);
    wg::fence();
    wg::Tf32RS<NP>::mma(acc, lo, dh, 0);
    wg::Tf32RS<NP>::mma(acc, hi, dl, 1);
    wg::Tf32RS<NP>::mma(acc, hi, dh, 1);
  }
  wg::commit();
}

// Sum of one float per thread of a warpgroup, returned to thread 0 of it.
__device__ __forceinline__ float wg_sum(float s, float* red, int bar) {
  const int wt = threadIdx.x & 127;
  s = bioem_lse::warp_sum(s);
  if ((wt & 31) == 0) red[wt >> 5] = s;
  wg::wg_barrier(bar);
  return red[0] + red[1] + red[2] + red[3];
}

template <int NP, int NWG, int V>
__global__ void __launch_bounds__(128 * NWG, 1)
compare_fused_kernel(const float2* __restrict__ conv, const unsigned char* __restrict__ wblk,
                     const float* __restrict__ img_re, const float* __restrict__ img_im,
                     const unsigned char* __restrict__ wyp, const float* __restrict__ a_u,
                     const float* __restrict__ b_u,
                     float a_coef, Plan P, int I, int N, float* __restrict__ out_m,
                     float* __restrict__ out_se, int* __restrict__ out_ds,
                     float* __restrict__ out_ccs) {
  constexpr int kThreads = 128 * NWG;
  constexpr int NA = NP / 2;  // accumulator floats per thread
  // stage 2 on the tensor cores at the wide chunks (NP = 128, 176), else on
  // the CUDA cores, dc / 4 lattice rows a thread (8 in chunks of 32)
  constexpr bool kTc2 = NP >= 128;
  constexpr int DR = NP / 8;
  extern __shared__ __align__(1024) unsigned char smem[];
  __shared__ float red_v[NWG][4], red_s[NWG][4];
  __shared__ int red_i[NWG][4];
  // each warpgroup's running (max, Σ exp, cc there, argmax) over the chunks
  // merged so far: read and written by its thread 0 only
  __shared__ float run_v[NWG], run_s[NWG], run_c[NWG];
  __shared__ int run_i[NWG];

  const int D = P.D, M = P.M, F = P.F, n_fold = P.n_fold, DD = D * D;
  const int dc = P.dc, KC = P.KC, n_ks = P.n_ks;
  const uint32_t kb = 32 * KC;
  const int tid = threadIdx.x, wgi = tid >> 7, wt = tid & 127;
  const int lane = tid & 31, warp = wt >> 5, g = lane >> 2, t = lane & 3;
  const int bar = 1 + wgi;

  unsigned char* wbuf = smem + P.w;
  float2* cvbuf = reinterpret_cast<float2*>(smem + P.cv);
  const size_t cv_stride = align128(P.cv_chunk) / sizeof(float2);
  const float2* wys = reinterpret_cast<const float2*>(smem + P.wy);
  float* ccw = reinterpret_cast<float*>(smem + P.cc) + (size_t)wgi * dc * D;

  const int oc = blockIdx.y;
  const int i_raw = blockIdx.x * NWG + wgi;
  const bool has = i_raw < I;  // warpgroup-uniform: the last run may end early
  const int i = has ? i_raw : I - 1;
  const size_t NF = (size_t)N * F;
  const float* ir_p = img_re + (size_t)i * NF;
  const float* ii_p = img_im + (size_t)i * NF;
  const float2* conv_oc = conv + (size_t)oc * N * P.Fp;
  if (wt == 0) {
    run_v[wgi] = -INFINITY;
    run_s[wgi] = 0.f;
    run_c[wgi] = 0.f;
    run_i[wgi] = DD;
  }

  // Copy K chunk kc (of N chunk nc, m-tile at frequency fb) into buffer b:
  // W's block, and conv rows j + k·M (j = 4·step + u) as [step][k][u][kLdF];
  // with the m-tile's last chunk also its tile of wy for stage 2 (on the
  // tensor cores the real half of its B operand).
  auto issue = [&](int nc, int kc, int fb, int b) {
    const unsigned char* src = wblk + ((size_t)nc * P.n_kc + kc) * P.w_chunk;
    unsigned char* dst = wbuf + (size_t)b * P.w_chunk;
    for (size_t q = (size_t)tid * 16; q < P.w_chunk; q += (size_t)kThreads * 16)
      cp16(dst + q, src + q, true);
    if constexpr (V != kMmOnly) {
      float2* cdst = cvbuf + (size_t)b * cv_stride;
      const int n_rows = KC * n_fold * 4;
      for (int q = tid; q < n_rows * (kMT / 2); q += kThreads) {
        const int row = q / (kMT / 2), c2 = q - row * (kMT / 2);  // two frequencies per copy
        const int s = row / (4 * n_fold), k = (row / 4) % n_fold, u = row & 3;
        const int j = 4 * (kc * KC + s) + u;
        const bool ok = j < M;
        const float2* src_row = conv_oc + (size_t)(ok ? j + k * M : 0) * P.Fp + fb + 2 * c2;
        cp16(cdst + (size_t)row * kLdF + 2 * c2, src_row, ok);
      }
      if (V != kNoStage2 && kc == P.n_kc - 1) {
        const unsigned char* ysrc =
            wyp + (kTc2 ? (size_t)(fb / kMT) * 2 * P.wy_tile : sizeof(float2) * (size_t)fb * D);
        unsigned char* ydst = smem + P.wy;
        for (size_t q = (size_t)tid * 16; q < P.wy_tile; q += (size_t)kThreads * 16)
          cp16(ydst + q, ysrc + q, true);
      }
    }
    cp_commit();
  };

  float chk = 0.f;  // the ablated bodies' checksum
  if constexpr (V == kNoStage2)  // the lattice the log-sum-exp reads, in place of stage 2's
    for (int q = wt; q < dc * D; q += 128) ccw[q] = 0.f;
  for (int nc = 0; nc < P.n_nc; ++nc) {
    for (int mt = 0; mt < P.n_mt; ++mt) {
      const int fb = mt * kMT;
      // Every warpgroup is done with the previous m-tile's stage 2 (its t1
      // over the chunk buffers, and wy) before this m-tile's copies land.
      if (nc + mt > 0) __syncthreads();
      // This thread's fragment rows: frequencies f0 and f0 + 8 of its image.
      const int f0 = fb + 16 * warp + g, f1 = f0 + 8;
      const bool v0 = f0 < F, v1 = f1 < F;

      // The image values of folds 0 and 1 of step s (re, im at f0, then at
      // f1), loaded a step before their use.
      auto img_pre = [&](int s, float (&pre)[8]) {
        const int j = 4 * s + t;
#pragma unroll
        for (int k = 0; k < 2; ++k) {
          const bool ok = k < n_fold && j < M;
          const size_t row = (size_t)(j + k * M) * F;
          pre[4 * k + 0] = ok && v0 ? ir_p[row + f0] : 0.f;
          pre[4 * k + 1] = ok && v0 ? ii_p[row + f0] : 0.f;
          pre[4 * k + 2] = ok && v1 ? ir_p[row + f1] : 0.f;
          pre[4 * k + 3] = ok && v1 ? ii_p[row + f1] : 0.f;
        }
      };
      // Fragment of local step s of the chunk in buffer cb (global step
      // gs): Re p(j, f0), Re p(j, f1), Im p(j, f0), Im p(j, f1), j = 4gs + t,
      // split into TF32 hi and lo. Folds past the second (a lattice stride
      // above 2) load their image values here.
      auto frag_form = [&](const float2* cb, int s, int gs, const float (&pre)[8],
                           uint32_t (&hi)[4], uint32_t (&lo)[4]) {
        const int j = 4 * gs + t;
        const int cl = 16 * warp + g;
        float x[4] = {0.f, 0.f, 0.f, 0.f};
        auto add = [&](const float2* row, float ir0, float ii0, float ir1, float ii1) {
          const float2 c0 = row[cl], c1 = row[cl + 8];
          x[0] += c0.x * ir0 - c0.y * ii0;
          x[2] += c0.x * ii0 + c0.y * ir0;
          x[1] += c1.x * ir1 - c1.y * ii1;
          x[3] += c1.x * ii1 + c1.y * ir1;
        };
        const float2* rows = cb + (size_t)(s * n_fold * 4 + t) * kLdF;  // fold k: + 4k·kLdF
        add(rows, pre[0], pre[1], pre[2], pre[3]);
        if (n_fold > 1) add(rows + 4 * kLdF, pre[4], pre[5], pre[6], pre[7]);
        for (int k = 2; k < n_fold; ++k) {
          const bool ok = j < M;
          const size_t r = (size_t)(j + k * M) * F;
          add(rows + 4 * k * kLdF, ok && v0 ? ir_p[r + f0] : 0.f, ok && v0 ? ii_p[r + f0] : 0.f,
              ok && v1 ? ir_p[r + f1] : 0.f, ok && v1 ? ii_p[r + f1] : 0.f);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          hi[e] = wg::to_tf32(x[e]);
          lo[e] = wg::to_tf32(x[e] - __uint_as_float(hi[e]));
        }
      };

      float sum[NA], acc[NA], pre[8];
#pragma unroll
      for (int r = 0; r < NA; ++r) sum[r] = acc[r] = 0.f;
      uint32_t ha[4], la[4], hb[4], lb[4];
      if constexpr (V == kMmOnly) {
        // Operands formed once: the raw image spectrum, unsplit.
        const int j = t < M ? t : 0;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const bool ok = (e & 1) ? v1 : v0;
          ha[e] = wg::to_tf32(ok ? ((e & 2) ? ii_p : ir_p)[(size_t)j * F + ((e & 1) ? f1 : f0)]
                                 : 0.f);
        }
      } else {
        img_pre(0, pre);
      }
      issue(nc, 0, fb, 0);
      for (int kc = 0; kc < P.n_kc; ++kc) {
        if (kc + 1 < P.n_kc) {
          issue(nc, kc + 1, fb, (kc + 1) & 1);
          cp_wait<1>();
        } else {
          cp_wait<0>();
        }
        wg::fence_proxy_async();
        __syncthreads();  // chunk kc is in buffer kc & 1 for every thread
        const unsigned char* wb = wbuf + (size_t)(kc & 1) * P.w_chunk;
        const float2* cb = cvbuf + (size_t)(kc & 1) * cv_stride;
        const int s0 = kc * KC;
        const int ns = n_ks - s0 < KC ? n_ks - s0 : KC;
        if constexpr (V == kMmOnly) {
          for (int s = 0; s < ns; ++s) {
            chain<NP>(acc, ha, ha, wb, s, kb);
            wg::wait<0>();
            wg::fence_operand(acc);
#pragma unroll
            for (int r = 0; r < NA; ++r) sum[r] += acc[r];
          }
        } else {
          // Step s: issue its products; while they run, form step s + 1
          // (and load the image values of step s + 2); then add the
          // products to the sum. Unrolled by two so that each step's
          // fragments are fixed registers, read by wgmma until its wait.
          auto form = [&](int s, uint32_t (&hn)[4], uint32_t (&ln)[4]) {
            frag_form(cb, s, s0 + s, pre, hn, ln);
            if (s0 + s + 1 < n_ks) img_pre(s0 + s + 1, pre);
          };
          auto step = [&](int s, uint32_t (&hc)[4], uint32_t (&lc)[4], uint32_t (&hn)[4],
                          uint32_t (&ln)[4]) {
            if constexpr (V != kNoGemm) chain<NP>(acc, hc, lc, wb, s, kb);
            if (s + 1 < ns) form(s + 1, hn, ln);
            if constexpr (V == kNoGemm) {
              // Keep the formed operands alive without a product: 0·x adds
              // nothing to a finite sum (no fast-math to fold it away).
#pragma unroll
              for (int e = 0; e < 4; ++e)
                sum[e] = fmaf(0.f, __uint_as_float(hc[e]) + __uint_as_float(lc[e]), sum[e]);
            } else {
              wg::wait<0>();
              wg::fence_operand(acc);
#pragma unroll
              for (int r = 0; r < NA; ++r) sum[r] += acc[r];
            }
          };
          form(0, ha, la);
          for (int s = 0; s < ns; s += 2) {
            step(s, ha, la, hb, lb);
            if (s + 1 < ns) step(s + 1, hb, lb, ha, la);
          }
        }
        __syncthreads();  // every warpgroup is done with buffer kc & 1
      }

      if constexpr (V == kMmOnly || V == kNoStage2) {
#pragma unroll
        for (int r = 0; r < NA; ++r) chk += sum[r];
      } else if constexpr (kTc2) {
        // Stage 2 on the tensor cores: the chunk's lattice rows d (M, in
        // NM2 tiles of 64; dc valid) × columns e (N2) of the m-tile's cc =
        // Σ_k t1[d, k]·B[e, k], K = its 64 frequencies of t1_re against
        // wy_re, then of t1_im against −wy_im (two halves: one half of B is
        // held at a time), in 3xTF32 k8 steps whose fresh accumulator is
        // added to the f32 sums s2 with IEEE adds. t1 goes to this
        // warpgroup's tiles (row f, f32) over the chunk buffers and is split
        // into hi/lo as each A fragment is loaded; B comes split from the
        // prologue, its real half copied with the last K chunk, its
        // imaginary half over it once both warpgroups are done with it.
        constexpr int NH = NP / 4;  // floats of t1_re (and of t1_im) a thread holds
        constexpr int N2 = NP == 2 * kWideRows ? kWideRows : kWideMaxDp;
        constexpr int NM2 = NP == 2 * kWideRows ? 2 : 1;
        constexpr int NA2 = N2 / 2;        // accumulator floats of one m64 × N2 tile
        constexpr uint32_t kb2 = 4 * kMT;  // bytes of K in a row of B
        const int ld2 = P.ld2;
        float* t1r = reinterpret_cast<float*>(smem + P.t1) + (size_t)wgi * 2 * kMT * ld2;
        float* t1i = t1r + (size_t)kMT * ld2;
        const unsigned char* yb = smem + P.wy;
        const int fcn = F - fb < kMT ? F - fb : kMT;
        const int ns2 = (fcn + 7) / 8;  // k8 steps of a half (frequencies past F add 0)
        // t1's half h (sum[h·NH..]) to the tile at dst: element (f, d) at
        // column d ^ 8·(f mod 4), so that the accumulator's pairs are stored
        // and the A fragments loaded without bank conflicts.
        auto put = [&](int h, float* dst) {
          const int sw = (g & 3) << 3;
#pragma unroll
          for (int jj = 0; jj < NH / 4; ++jj) {
            const int col = ((8 * jj) ^ sw) + 2 * t;
            *reinterpret_cast<float2*>(dst + (16 * warp + g) * ld2 + col) =
                make_float2(sum[h * NH + 4 * jj], sum[h * NH + 4 * jj + 1]);
            *reinterpret_cast<float2*>(dst + (16 * warp + g + 8) * ld2 + col) =
                make_float2(sum[h * NH + 4 * jj + 2], sum[h * NH + 4 * jj + 3]);
          }
        };
        // A fragment of step s, tile tl, from the tile at src: t1 at rows
        // d0, d0 + 8 (d0 = 64·tl + 16·warp + g; rows past the chunk read 0)
        // and frequencies 8s + t, 8s + t + 4, split into TF32 hi and lo.
        auto frag2 = [&](const float* src, int tl, int s, uint32_t (&hi)[4], uint32_t (&lo)[4]) {
          const int d0 = 64 * tl + 16 * warp + g, sw = t << 3;
          const float* r0 = src + (8 * s + t) * ld2;
          const float* r1 = r0 + 4 * ld2;
          const float x[4] = {d0 < dc ? r0[d0 ^ sw] : 0.f, d0 + 8 < dc ? r0[(d0 + 8) ^ sw] : 0.f,
                              d0 < dc ? r1[d0 ^ sw] : 0.f, d0 + 8 < dc ? r1[(d0 + 8) ^ sw] : 0.f};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            hi[e] = wg::to_tf32(x[e]);
            lo[e] = wg::to_tf32(x[e] - __uint_as_float(hi[e]));
          }
        };
        // step s of the half against B (hi, then lo n2 rows later), into acc
        auto mma2 = [&](float (&acc)[NA2], const uint32_t (&hi)[4], const uint32_t (&lo)[4],
                        int s) {
          wg::tf32x3_step<N2>(acc, hi, lo, wg::desc(yb + 256 * s, 128, 8 * kb2),
                              wg::desc(yb + (size_t)N2 * kb2 + 256 * s, 128, 8 * kb2));
        };
        float s2a[NA2], s2b[NA2];  // the sums of tiles 0 and 1
#pragma unroll
        for (int r = 0; r < NA2; ++r) s2a[r] = s2b[r] = 0.f;
        // One half of t1 (the tile at src) against the B half in place.
        auto half = [&](const float* src) {
          if constexpr (NM2 == 2) {
            // Both tiles in turn: tile 0's step s runs while tile 1's step
            // s − 1 is added, tile 1's step s while tile 0's is.
            float a0[NA2], a1[NA2];
#pragma unroll
            for (int r = 0; r < NA2; ++r) a0[r] = a1[r] = 0.f;
            uint32_t h0[4], l0[4], h1[4], l1[4];
            frag2(src, 0, 0, h0, l0);
            frag2(src, 1, 0, h1, l1);
            for (int s = 0; s < ns2; ++s) {
              mma2(a0, h0, l0, s);
              if (s > 0) {
                wg::wait<1>();
                wg::fence_operand(a1);
#pragma unroll
                for (int r = 0; r < NA2; ++r) s2b[r] += a1[r];
              }
              mma2(a1, h1, l1, s);
              wg::wait<1>();
              wg::fence_operand(a0);
              if (s + 1 < ns2) frag2(src, 0, s + 1, h0, l0);
#pragma unroll
              for (int r = 0; r < NA2; ++r) s2a[r] += a0[r];
              wg::wait<0>();
              wg::fence_operand(a1);
              if (s + 1 < ns2) frag2(src, 1, s + 1, h1, l1);
            }
#pragma unroll
            for (int r = 0; r < NA2; ++r) s2b[r] += a1[r];
          } else {
            // One tile: each step's fragments are formed while the previous
            // step's products run.
            float a2[NA2];
#pragma unroll
            for (int r = 0; r < NA2; ++r) a2[r] = 0.f;
            uint32_t ha[4], la[4], hb[4], lb[4];
            auto step = [&](int s, uint32_t (&hc)[4], uint32_t (&lc)[4], uint32_t (&hn)[4],
                            uint32_t (&ln)[4]) {
              mma2(a2, hc, lc, s);
              if (s + 1 < ns2) frag2(src, 0, s + 1, hn, ln);
              wg::wait<0>();
              wg::fence_operand(a2);
#pragma unroll
              for (int r = 0; r < NA2; ++r) s2a[r] += a2[r];
            };
            frag2(src, 0, 0, ha, la);
            for (int s = 0; s < ns2; s += 2) {
              step(s, ha, la, hb, lb);
              if (s + 1 < ns2) step(s + 1, hb, lb, ha, la);
            }
          }
        };
        put(0, t1r);
        put(1, t1i);
        wg::wg_barrier(bar);
        half(t1r);
        __syncthreads();  // every warpgroup is done with B's real half
        {
          const unsigned char* ysrc = wyp + (size_t)(2 * mt + 1) * P.wy_tile;
          for (size_t q = (size_t)tid * 16; q < P.wy_tile; q += (size_t)kThreads * 16)
            cp16(smem + P.wy + q, ysrc + q, true);
          cp_commit();
        }
        cp_wait<0>();
        wg::fence_proxy_async();
        __syncthreads();  // B's imaginary half is in
        half(t1i);
        // The m-tile's share into the chunk's rows of the lattice: the
        // earlier m-tiles' sums are loaded first, all at once, then added.
        auto add_cc = [&](int tl, const float (&st)[NA2]) {
          float old[NA2];
#pragma unroll
          for (int j = 0; j < N2 / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int dl = 64 * tl + 16 * warp + g + 8 * h, e = 8 * j + 2 * t + u;
                const bool ok = mt > 0 && dl < dc && nc * dc + dl < D && e < D;
                old[4 * j + 2 * h + u] = ok ? ccw[dl * D + e] : 0.f;
              }
#pragma unroll
          for (int j = 0; j < N2 / 8; ++j)
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int u = 0; u < 2; ++u) {
                const int dl = 64 * tl + 16 * warp + g + 8 * h, e = 8 * j + 2 * t + u;
                if (dl < dc && nc * dc + dl < D && e < D)
                  ccw[dl * D + e] = old[4 * j + 2 * h + u] + st[4 * j + 2 * h + u];
              }
        };
        add_cc(0, s2a);
        if constexpr (NM2 == 2) add_cc(1, s2b);
      } else {
        // The warpgroup's t1 chunk (frequency row; columns [0, dc) re,
        // [dc, 2dc) im) to shared memory, then stage 2 on the CUDA cores:
        // cc[d, e] (+)= Σ_f Re(t1[d, f] · wy[e, f]) over the m-tile.
        constexpr int ldt = NP + 4;
        float* t1w = reinterpret_cast<float*>(smem + P.t1) + (size_t)wgi * kMT * ldt;
#pragma unroll
        for (int jj = 0; jj < NP / 8; ++jj) {
          *reinterpret_cast<float2*>(t1w + (16 * warp + g) * ldt + 8 * jj + 2 * t) =
              make_float2(sum[4 * jj], sum[4 * jj + 1]);
          *reinterpret_cast<float2*>(t1w + (16 * warp + g + 8) * ldt + 8 * jj + 2 * t) =
              make_float2(sum[4 * jj + 2], sum[4 * jj + 3]);
        }
        wg::wg_barrier(bar);
        const int fcn = F - fb < kMT ? F - fb : kMT;
        const int dl0 = warp * DR;  // this thread's first chunk row
        if constexpr (NP == 64) {
          // Chunks of 32 rows (D = 25..32, and D ≥ 129): 8 rows a thread
          // and lattice columns e = e0 + lane + 32·ce, up to three at a
          // time: each t1 value a thread reads serves that many columns,
          // each wy value 8 rows. A warp whose rows lie past the lattice
          // skips (it would only compute rows nothing reads).
          if (nc * dc + dl0 < D) {  // warp-uniform
            for (int e0 = 0; e0 < D; e0 += 96) {
              const int nce = D - e0 > 64 ? 3 : D - e0 > 32 ? 2 : 1;  // warp-uniform
              float sr[DR][3], si[DR][3];
#pragma unroll
              for (int r = 0; r < DR; ++r)
#pragma unroll
                for (int ce = 0; ce < 3; ++ce) sr[r][ce] = si[r][ce] = 0.f;
              int ec[3];
#pragma unroll
              for (int ce = 0; ce < 3; ++ce) ec[ce] = min(e0 + lane + 32 * ce, D - 1);
#pragma unroll 4
              for (int fl = 0; fl < fcn; ++fl) {
                const float* row = t1w + fl * ldt + dl0;
                float2 a[DR / 2], b[DR / 2];
#pragma unroll
                for (int r = 0; r < DR; r += 2) {
                  a[r / 2] = *reinterpret_cast<const float2*>(row + r);
                  b[r / 2] = *reinterpret_cast<const float2*>(row + dc + r);
                }
#pragma unroll
                for (int ce = 0; ce < 3; ++ce) {
                  if (ce < nce) {
                    const float2 w = wys[fl * D + ec[ce]];
#pragma unroll
                    for (int r = 0; r < DR; r += 2) {
                      sr[r][ce] += a[r / 2].x * w.x;
                      sr[r + 1][ce] += a[r / 2].y * w.x;
                      si[r][ce] += b[r / 2].x * w.y;
                      si[r + 1][ce] += b[r / 2].y * w.y;
                    }
                  }
                }
              }
#pragma unroll
              for (int ce = 0; ce < 3; ++ce) {
                const int e = e0 + lane + 32 * ce;
                if (ce >= nce || e >= D) continue;
#pragma unroll
                for (int r = 0; r < DR; ++r) {
                  if (nc * dc + dl0 + r < D) {
                    float* c = ccw + (dl0 + r) * D + e;
                    const float v = sr[r][ce] - si[r][ce];
                    *c = mt == 0 ? v : *c + v;
                  }
                }
              }
            }
          }
        } else {
          // One lattice column at a time (row chunks of at most 24 rows,
          // the production block's among them, where three were slower).
          for (int e = lane; e < D; e += 32) {
            float sr[DR], si[DR];
#pragma unroll
            for (int r = 0; r < DR; ++r) sr[r] = si[r] = 0.f;
            for (int fl = 0; fl < fcn; ++fl) {
              const float2 w = wys[fl * D + e];
              const float* row = t1w + fl * ldt + dl0;
#pragma unroll
              for (int r = 0; r < DR; r += 2) {
                const float2 a = *reinterpret_cast<const float2*>(row + r);
                const float2 b = *reinterpret_cast<const float2*>(row + dc + r);
                sr[r] += a.x * w.x;
                sr[r + 1] += a.y * w.x;
                si[r] += b.x * w.y;
                si[r + 1] += b.y * w.y;
              }
            }
#pragma unroll
            for (int r = 0; r < DR; ++r) {
              if (nc * dc + dl0 + r < D) {
                float* c = ccw + (dl0 + r) * D + e;
                const float v = sr[r] - si[r];
                *c = mt == 0 ? v : *c + v;
              }
            }
          }
        }
      }
    }

    if constexpr (V != kMmOnly) {
      // The chunk's rows d0 ≤ d < d0 + rows (rows ≥ 1 at every D a plan
      // fits) are complete in ccw: flat lattice indices q0 + q, q < nq.
      const int d0 = nc * dc;
      const int rows = D - d0 < dc ? D - d0 : dc;
      const int q0 = d0 * D, nq = rows * D;
      const size_t oi = (size_t)oc * I + i;
      wg::wg_barrier(bar);
      if constexpr (V == kCcOut) {
        // K3: the chunk's rows out (out_ccs is the (OC, I, D, D) cc tensor)
        if (has) {
          float* dst = out_ccs + oi * DD + q0;
          for (int q = wt; q < nq; q += 128) dst[q] = ccw[q];
        }
      } else if constexpr (V == kNoLse) {
        for (int q = wt; q < nq; q += 128) chk += ccw[q];
      } else {
        // The chunk's log-sum-exp, merged into the running one. The first
        // pass leaves each value v in place of its cc and carries the cc at
        // the argmax along, so that v is computed once.
        const float au = a_u[oi], bu = b_u[oi];
        float best = -INFINITY, bcc = 0.f;
        int bidx = DD;
        for (int q = wt; q < nq; q += 128) {
          const float c = ccw[q];
          const float v = bioem_lse::lattice_value(c, au, bu, a_coef);
          ccw[q] = v;
          if (bioem_lse::better(v, q0 + q, best, bidx)) {
            best = v;
            bidx = q0 + q;
            bcc = c;
          }
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
          const float ov = __shfl_down_sync(0xffffffffu, best, off);
          const int oq = __shfl_down_sync(0xffffffffu, bidx, off);
          const float oc = __shfl_down_sync(0xffffffffu, bcc, off);
          if (bioem_lse::better(ov, oq, best, bidx)) {
            best = ov;
            bidx = oq;
            bcc = oc;
          }
        }
        if (lane == 0) {
          red_v[wgi][warp] = best;
          red_i[wgi][warp] = bidx;
          red_s[wgi][warp] = bcc;
        }
        wg::wg_barrier(bar);
        if (wt == 0) {
          for (int w = 1; w < 4; ++w)
            if (bioem_lse::better(red_v[wgi][w], red_i[wgi][w], best, bidx)) {
              best = red_v[wgi][w];
              bidx = red_i[wgi][w];
              bcc = red_s[wgi][w];
            }
          red_v[wgi][0] = best;
        }
        wg::wg_barrier(bar);
        const float mx = red_v[wgi][0];
        float s = 0.f;
        for (int q = wt; q < nq; q += 128) s += expf(ccw[q] - mx);
        s = wg_sum(s, red_s[wgi], bar);
        if (wt == 0) {
          // s ← s·e^(m − mx) + s_c where the chunk ranks above the run,
          // else s + s_c·e^(mx − m); a chunk all −inf adds nothing (its
          // s_c is NaN, its true share 0). NaN and +inf carry NaN on.
          const float rm = run_v[wgi];
          if (bioem_lse::better(mx, bidx, rm, run_i[wgi])) {
            if (mx != -INFINITY) run_s[wgi] = run_s[wgi] * expf(rm - mx) + s;
            run_v[wgi] = mx;
            run_i[wgi] = bidx;
            run_c[wgi] = bcc;
          } else if (mx != -INFINITY) {
            run_s[wgi] += s * expf(mx - rm);
          }
        }
      }
    }
  }

  if constexpr (V == kCcOut) return;  // K3 wrote its lattice chunk by chunk
  const size_t oi = (size_t)oc * I + i;
  if constexpr (V == kMmOnly || V == kNoLse || V == kNoStage2) {
    if constexpr (V == kNoStage2) {
      if (wt == 0) chk += run_v[wgi] + run_s[wgi];  // the log-sum-exp's result
      wg::wg_barrier(bar);  // the last chunk's reduction is done with red_s
    }
    const float s = wg_sum(chk, red_s[wgi], bar);
    if (wt == 0 && has) out_m[oi] = s;
  } else if (wt == 0 && has) {
    // the first chunk always ranks above the (−inf, D²) start: run_i < D²
    out_m[oi] = run_v[wgi];
    // every v is −inf: Σ exp(v − max) is NaN, as in the plain version
    out_se[oi] = run_v[wgi] == -INFINITY ? NAN : run_s[wgi];
    out_ds[oi] = run_i[wgi];
    out_ccs[oi] = run_c[wgi];
  }
}

template <int NP, int NWG, int V = kFull>
int launch(const float* proj_re, const float* proj_im, const float* ctf_re,
           const float* ctf_im, const float* img_re, const float* img_im,
           const float* wx_re, const float* wx_im, const float* wy_re, const float* wy_im,
           const float* a_u, const float* b_u, float a_coef, int O, int C, int I, int N,
           const Plan& P, float* m, float* se, int* ds, float* ccs, void* scratch,
           cudaStream_t stream) {
  const int OC = O * C;
  float2* conv = reinterpret_cast<float2*>(scratch);
  unsigned char* wblk = reinterpret_cast<unsigned char*>(scratch) + scratch_conv_bytes(P, OC, N);
  unsigned char* wyp = wblk + align128(P.scratch_w);
  const size_t n_prep = (size_t)OC * N * P.Fp + (size_t)P.n_nc * P.n_kc * P.wn * 8 * P.KC +
                        (P.tc2 ? (size_t)P.n_mt * 2 * P.n2 * kMT : (size_t)P.Fp * P.D);
  const size_t blocks = (n_prep + kPrepThreads - 1) / kPrepThreads;
  compare_fused_prep_kernel<V == kCcOut>
      <<<(unsigned)(blocks < 4096 ? blocks : 4096), kPrepThreads, 0, stream>>>(
          proj_re, proj_im, ctf_re, ctf_im, wx_re, wx_im, wy_re, wy_im, P, C, OC, N, conv, wblk,
          wyp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(compare_fused_kernel<NP, NWG, V>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)P.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((I + NWG - 1) / NWG, OC);
  compare_fused_kernel<NP, NWG, V><<<grid, 128 * NWG, P.bytes, stream>>>(
      conv, wblk, img_re, img_im, wyp, a_u, b_u, a_coef, P, I, N, m, se, ds, ccs);
  return (int)cudaGetLastError();
}

bool valid(int D, int M, int F, int n_fold, int n_wg, int KC) {
  return D >= 1 && M >= 1 && F >= 1 && n_fold >= 1 &&
         (n_wg == 4 || (n_wg == 2 && (D + 7) / 8 * 8 > 32)) &&
         (KC == 1 || KC == 2 || KC == 4 || KC == 8);
}

}  // namespace

extern "C" {

// Dynamic shared memory of K1 at (D, M, F, n_fold) with n_wg warpgroups
// and K chunks of KC steps, or 0 for an invalid tiling; the wrapper's
// plan (ops/compare_cuda.k1_plan) uses the same formula.
size_t bioem_fused_compare_smem_bytes(int D, int M, int F, int n_fold, int n_wg, int KC) {
  return valid(D, M, F, n_fold, n_wg, KC) ? plan(D, M, F, n_fold, n_wg, KC).bytes : 0;
}

// Bytes of scratch K1 needs for OC orientation·ctf pairs at N: the conv
// bank, the W blocks and wy.
size_t bioem_fused_compare_scratch_bytes(int OC, int N, int D, int M, int F, int n_fold,
                                         int n_wg, int KC) {
  if (!valid(D, M, F, n_fold, n_wg, KC)) return 0;
  const Plan P = plan(D, M, F, n_fold, n_wg, KC);
  return scratch_conv_bytes(P, OC, N) + align128(P.scratch_w) + P.scratch_wy;
}

#define BIOEM_K1_ARGS                                                                    \
  proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u, b_u, \
      a_coef, O, C, I, N, P, m, se, ds, ccs, scratch, (cudaStream_t)stream

int bioem_fused_compare(const float* proj_re, const float* proj_im, const float* ctf_re,
                        const float* ctf_im, const float* img_re, const float* img_im,
                        const float* wx_re, const float* wx_im, const float* wy_re,
                        const float* wy_im, const float* a_u, const float* b_u,
                        float a_coef, int O, int C, int I, int N, int F, int D, int M,
                        int n_fold, int n_wg, int KC, float* m, float* se, int* ds,
                        float* ccs, void* scratch, void* stream) {
  if (!valid(D, M, F, n_fold, n_wg, KC) || M * n_fold != N) return (int)cudaErrorInvalidValue;
  const Plan P = plan(D, M, F, n_fold, n_wg, KC);
  const int key = P.NP * 10 + n_wg;
  switch (key) {
    case 164: return launch<16, 4>(BIOEM_K1_ARGS);
    case 324: return launch<32, 4>(BIOEM_K1_ARGS);
    case 484: return launch<48, 4>(BIOEM_K1_ARGS);
    case 644: return launch<64, 4>(BIOEM_K1_ARGS);
    case 642: return launch<64, 2>(BIOEM_K1_ARGS);
    case 1282: return launch<128, 2>(BIOEM_K1_ARGS);
    case 1762: return launch<176, 2>(BIOEM_K1_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// K3: cc[oc, i, d, e] of the conv bank (OC, N, F) against the images, with
// K1's tiling (n_wg, KC) and scratch (bioem_fused_compare_scratch_bytes at
// OC pairs; its shared memory is bioem_fused_compare_smem_bytes).
int bioem_fused_displacement_cc(const float* conv_re, const float* conv_im,
                                const float* img_re, const float* img_im, const float* wx_re,
                                const float* wx_im, const float* wy_re, const float* wy_im,
                                int OC, int I, int N, int F, int D, int M, int n_fold, int n_wg,
                                int KC, float* cc, void* scratch, void* stream) {
  if (!valid(D, M, F, n_fold, n_wg, KC) || M * n_fold != N) return (int)cudaErrorInvalidValue;
  const Plan P = plan(D, M, F, n_fold, n_wg, KC);
  // The prologue copies the bank (one "orientation" per pair, no CTF); the
  // body writes the lattice to ccs and reads no a_u, b_u or a_coef.
  const float *proj_re = conv_re, *proj_im = conv_im, *ctf_re = nullptr, *ctf_im = nullptr;
  const float *a_u = nullptr, *b_u = nullptr;
  const float a_coef = 0.f;
  const int O = OC, C = 1;
  float *m = nullptr, *se = nullptr, *ccs = cc;
  int* ds = nullptr;
  switch (P.NP * 10 + n_wg) {
    case 164: return launch<16, 4, kCcOut>(BIOEM_K1_ARGS);
    case 324: return launch<32, 4, kCcOut>(BIOEM_K1_ARGS);
    case 484: return launch<48, 4, kCcOut>(BIOEM_K1_ARGS);
    case 644: return launch<64, 4, kCcOut>(BIOEM_K1_ARGS);
    case 642: return launch<64, 2, kCcOut>(BIOEM_K1_ARGS);
    case 1282: return launch<128, 2, kCcOut>(BIOEM_K1_ARGS);
    case 1762: return launch<176, 2, kCcOut>(BIOEM_K1_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}

// The kernel probe P3: body variant ``variant`` (bioem_lse::Body) of the
// production instance (NP = 48, four warpgroups: D = 17..24), of the
// 32-row chunks (NP = 64, four warpgroups: D = 25..32 and D ≥ 129) and of
// the reference grid's wide chunk (NP = 176, two warpgroups: D = 65..88;
// kNoStage2 there only). kFull is the production instance itself; the
// other variants write a checksum into m and nothing else.
int bioem_probe_compare(int variant, const float* proj_re, const float* proj_im,
                        const float* ctf_re, const float* ctf_im, const float* img_re,
                        const float* img_im, const float* wx_re, const float* wx_im,
                        const float* wy_re, const float* wy_im, const float* a_u,
                        const float* b_u, float a_coef, int O, int C, int I, int N, int F,
                        int D, int M, int n_fold, int n_wg, int KC, float* m, float* se,
                        int* ds, float* ccs, void* scratch, void* stream) {
  if (!valid(D, M, F, n_fold, n_wg, KC) || M * n_fold != N) return (int)cudaErrorInvalidValue;
  const Plan P = plan(D, M, F, n_fold, n_wg, KC);
  if (!((P.NP == 48 || P.NP == 64) && n_wg == 4) && !(P.NP == 176 && n_wg == 2))
    return (int)cudaErrorInvalidValue;
  switch (variant * 1000 + P.NP) {
    case kFull * 1000 + 48: return launch<48, 4, kFull>(BIOEM_K1_ARGS);
    case kNoLse * 1000 + 48: return launch<48, 4, kNoLse>(BIOEM_K1_ARGS);
    case kMmOnly * 1000 + 48: return launch<48, 4, kMmOnly>(BIOEM_K1_ARGS);
    case kNoGemm * 1000 + 48: return launch<48, 4, kNoGemm>(BIOEM_K1_ARGS);
    case kFull * 1000 + 64: return launch<64, 4, kFull>(BIOEM_K1_ARGS);
    case kNoLse * 1000 + 64: return launch<64, 4, kNoLse>(BIOEM_K1_ARGS);
    case kMmOnly * 1000 + 64: return launch<64, 4, kMmOnly>(BIOEM_K1_ARGS);
    case kNoGemm * 1000 + 64: return launch<64, 4, kNoGemm>(BIOEM_K1_ARGS);
    case kFull * 1000 + 176: return launch<176, 2, kFull>(BIOEM_K1_ARGS);
    case kNoLse * 1000 + 176: return launch<176, 2, kNoLse>(BIOEM_K1_ARGS);
    case kMmOnly * 1000 + 176: return launch<176, 2, kMmOnly>(BIOEM_K1_ARGS);
    case kNoGemm * 1000 + 176: return launch<176, 2, kNoGemm>(BIOEM_K1_ARGS);
    case kNoStage2 * 1000 + 176: return launch<176, 2, kNoStage2>(BIOEM_K1_ARGS);
  }
  return (int)cudaErrorInvalidValue;
}
#undef BIOEM_K1_ARGS

const char* bioem_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"

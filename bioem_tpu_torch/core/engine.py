"""Single-device BioEM engine: host precompute → loop over orientation blocks.

PyTorch counterpart of ``bioem_tpu.core.engine`` (reference main loop
``bioem::run``, bioem.cpp:659-907). The reference's triple loop
(orientation × ctf × image) becomes:

* host-side precompute of the CTF bank, image FFT bank, per-image sums and
  DFT displacement weights (reference precalculate, bioem.cpp:594-622);
* one **block step** that projects an orientation block, compares it with
  the whole CTF bank and every image over the displacement lattice, and
  folds the result into the streaming per-image state;
* a loop over orientation blocks that updates the state in place (the
  JAX package's ``lax.scan`` with buffer donation).

Two branches of the block step, chosen like the JAX package's
``use_pallas = (backend == "tpu")``: on a CUDA device the **kernel branch**
runs the hand-written CUDA kernels (ops/project_cuda.py,
ops/compare_cuda.py, and ops/posterior_cuda.py for the arithmetic around
them that XLA fused on the TPU: the block constants and the merge); on
the CPU the **plain branch** runs the einsum formulation of
core/posterior.py. The kernel branch's comparison is, as
in the JAX engine, the fused kernel with the displacement log-sum-exp
inside (K1, or the image-batched K4 with ``fused_batched``) or, with
``fused_lse=False`` or DC-dominated images, the hybrid: the cc-lattice
kernel K3 and the torch ``displacement_lse``. Without an explicit device
the engine takes the card, or the CPU when ``BIOEM_TPU_FORCE_CPU`` asks
(config.resolve_device); it never falls back to the CPU by itself.

The loop, on the kernel branch on the card, is the port's counterpart of
the jitted scan: the block step is captured once per engine in a
``torch.cuda.CUDAGraph`` (after a warm-up step on a side stream, which
builds the kernels and makes K2's count tensor and any cuFFT plan) on a
static state and a device block index that the graph reads and advances,
and each block is one replay: no host dispatch per kernel, no host copy.
A failed capture raises; there is no eager fallback on the card. The
graph's launches are added to the kernel wrappers' launch counters per
replay. On the CPU, and on the plain branch on the card (a yardstick
only), the loop stays an eager Python loop over ``_block_step``.

An engine may also be one slot of an (images × orientations) mesh
(``Slot``, parallel/mesh.py): it then holds only its image rows and its
orientation blocks of the mesh's padded problem, and its state is merged
with the other slots' after the pass.

``run`` checkpoints and resumes the streaming state
(runtime/checkpoint.py); ``time_blocks`` times the loop the pass runs (the
replayed one on the card's kernel branch, capture and warm-up outside the
timed span) for the autotuner (runtime/autotune.py). The engine's
construction, capture, passes, results and swaps are spans of the
process's recorder (utils/timestat.py).
"""

from __future__ import annotations

import time
import warnings
from dataclasses import dataclass
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..config import RunConfig, resolve_device
from ..params import (
    BioEMParams,
    displacement_lists,
    log_normalization_constant,
    make_ctf_grid,
    orientation_volume_quirked,
)
from ..io.map_io import ImageStack
from ..io.model_io import Model
from ..utils.timestat import count, span, traced
from .ctf import build_ctf_bank
from .orientations import OrientationSet, rotation_matrices
from .posterior import (
    PosteriorState,
    convolution_sums,
    ctf_prior_term,
    displacement_cc,
    displacement_dft_weights,
    displacement_lse,
    hermitian_weights,
    init_state,
    logpro_constants,
    merge_block,
    stride_fold,
)
from .projection import (
    choose_projection,
    lattice_axes,
    lattice_field,
    make_fourier_projection_spec,
    make_projection_spec,
    project_batch,
    project_batch_kernel,
    project_fourier_batch,
    project_fourier_batch_kernel,
    oob_census,
    projection_always_in_bounds,
)

F64 = torch.float64


class Banks(NamedTuple):
    """Device-resident precomputed constants of one engine (same fields,
    shapes and dtypes as the JAX package's Banks; see convert.py)."""

    ctf_re: torch.Tensor  # (C, N, F) f32 CTF/PSF kernel bank (real part)
    ctf_im: torch.Tensor
    wx_re: torch.Tensor  # (D, N) f32 displacement DFT rows
    wx_im: torch.Tensor
    wy_re: torch.Tensor  # (D, F) f32 displacement DFT cols
    wy_im: torch.Tensor
    h: torch.Tensor  # (F,) f32 Hermitian weights
    img_re: torch.Tensor  # (I, N, F) f32 conj image spectra · h/N² (real)
    img_im: torch.Tensor
    sum_ref: torch.Tensor  # (I,) f32
    ssq_ref: torch.Tensor  # (I,) f32
    disp: torch.Tensor  # (D,) i32
    amp: torch.Tensor  # (C,)
    pha: torch.Tensor
    env: torch.Tensor
    points: torch.Tensor  # (P, 3) f32 (radius-grouped when Fourier projection)
    radii: torch.Tensor  # (P,) f32
    dens: torch.Tensor  # (P,) f32
    norm_den: torch.Tensor  # scalar f32
    st_re: torch.Tensor  # (G, N, F) f32 radius-group stencil DFTs (Fourier
    st_im: torch.Tensor  # projection path; (1, 1, 1) dummies otherwise)
    st_sums: torch.Tensor  # (G,) f32 unit-stencil sums (tempden weights)
    # (G,) i32 model points per radius group (K2 reads only these slots of
    # each group); the port's own field: model data that swap_model
    # replaces with the rest of the model. None (banks converted from the
    # JAX package's) reads the spec's counts.
    counts: Optional[torch.Tensor] = None
    # (nx + ny + nz + 1,) f32 the axis coordinates of a voxel lattice
    # (core.projection.lattice_axes), x then y then z, then the model's
    # largest |density| (core.projection.lattice_field), where the engine
    # runs the raster's lattice kernel; (0,) otherwise. Model data, swapped
    # with the model. None in banks converted from the JAX package's.
    axes: Optional[torch.Tensor] = None


# The fields a swap may replace: the image chunk (swap_images) and the
# model (swap_model). Every other field is the engine's own.
IMAGE_FIELDS = ("img_re", "img_im", "sum_ref", "ssq_ref")
MODEL_FIELDS = ("points", "radii", "dens", "norm_den", "st_re", "st_im", "st_sums", "counts",
                "axes")


@dataclass
class Results:
    """Final per-image posterior summary (reference Output_Probabilities)."""

    log_prob: np.ndarray
    constoadd: np.ndarray
    total: np.ndarray
    best_orient: np.ndarray
    best_conv: np.ndarray
    best_cent_x: np.ndarray
    best_cent_y: np.ndarray
    best_norm: np.ndarray
    best_mu: np.ndarray
    angle_log: Optional[np.ndarray]  # (I, n_orient) or None
    log_norm_const: float
    # raw per-angle accumulator split for ANG_PROB's "Separated:" columns:
    # (log(forAngles), ConstAngle) per (image, orientation)
    angle_raw: Optional[tuple] = None
    # CTF parameter grid, attached by run_bioem for the output writers
    grid: Optional[object] = None


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class Slot(NamedTuple):
    """Where an engine sits in an (images × orientations) mesh
    (parallel/mesh.py): image shard ``i`` of ``n_i`` and orientation shard
    ``o`` of ``n_o``, with the comparison gate (:func:`f32_corr_gate`)
    computed once over the whole image stack, so that every slot takes the
    branch a single engine would."""

    i: int
    o: int
    n_i: int
    n_o: int
    f32_corr_ok: bool


def f32_corr_gate(maps: np.ndarray, p: BioEMParams) -> bool:
    """Data-driven gate for the f32 log1p shortcut in logpro_constants and
    for the fused comparison (K1/K4), whose log-sum-exp evaluates u in f32.
    The shortcut needs h/g = (sr²/ssr)/g ≲ 1e-4 per image; with
    g = ntot − sc²/ssc ≳ ntot/2 that bounds to h_max < 5e-5·ntot.
    Normalised ingest gives h ≈ 1e-9; TEXT maps are never normalised
    (reference parity) and a DC-dominated text image has h ~ ntot."""
    if p.no_map_norm:
        return False
    if not maps.shape[0]:
        return True
    flat = maps.reshape(maps.shape[0], -1).astype(np.float64)
    sum_ref = flat.sum(axis=1).astype(np.float32).astype(np.float64)
    ssq_ref = (flat**2).sum(axis=1).astype(np.float32).astype(np.float64)
    h_max = float(np.max(sum_ref**2 / np.maximum(ssq_ref, 1e-300)))
    return h_max < 5e-5 * p.n_total_pixels


def _same_shapes(a: PosteriorState, b: PosteriorState) -> bool:
    """Both states hold the same fields at the same shapes."""
    return all(
        (x is None) == (y is None) and (x is None or x.shape == y.shape)
        for x, y in zip(a, b)
    )


def _kernel_wrappers() -> tuple:
    """The kernel wrappers a block step can launch, each with its
    ``launches`` counter."""
    from ..ops import compare_cuda, posterior_cuda, project_cuda

    return (compare_cuda.fused_compare_block, compare_cuda.fused_compare_block_batched,
            compare_cuda.fused_displacement_cc, project_cuda.fourier_project_block,
            project_cuda.project_prologue, project_cuda.raster_project,
            posterior_cuda.block_constants, posterior_cuda.merge_block)


class BioEMEngine:
    """Posterior computation for one model against an image stack."""

    @traced("bioem.engine")
    def __init__(
        self,
        p: BioEMParams,
        orients: OrientationSet,
        model: Model,
        images: ImageStack,
        cfg: Optional[RunConfig] = None,
        device=None,
        model_layout: Optional[dict] = None,
        slot: Optional[Slot] = None,
    ):
        """``model_layout`` pads the model-dependent array shapes to a
        common layout so that one engine (and its captured block step)
        serves several models through :meth:`swap_model` (multi-model
        ranking, rank.py). Keys: ``n_points_pad``, ``n_groups_pad``,
        ``group_pad``, ``stencil_half``, ``force_raster``, ``lattice``
        (False: the raster's generic walk over the point list even for a
        voxel lattice, as for a set of models that are not all lattices of
        one shape and radius).

        ``slot`` makes this engine one slot of a mesh (parallel/mesh.py):
        images and orientations are padded for the whole mesh (to
        multiples of ``i_block·n_i`` and ``o_block·n_o``, as the JAX
        engine pads for its shards), and the engine holds only its image
        shard's rows (``img_rows``) and its orientation shard's blocks
        (from ``orient_base``). Its state is the slot's pre-merge state:
        ``best_orient`` carries global orientation indices, the per-angle
        slabs the shard's own columns."""
        from ..convert import banks_from_numpy

        cfg = cfg or RunConfig()
        self.cfg = cfg
        self.p = p
        lay = model_layout or {}
        self._n_points_pad = int(lay.get("n_points_pad", 0))
        self._g_pad = int(lay.get("n_groups_pad", 0))
        self._pp_pad = int(lay.get("group_pad", 0))
        self._stencil_half_min = int(lay.get("stencil_half", 0))
        self._force_raster = bool(lay.get("force_raster", False))
        self._lattice_ok = bool(lay.get("lattice", True))
        # The card, or the CPU only when asked (config.resolve_device).
        self.device = resolve_device(device)
        self.use_kernels = (
            cfg.use_kernels if cfg.use_kernels is not None
            else self.device.type == "cuda"
        )
        # Log-sum-exp inside the comparison kernel (K1/K4) or the hybrid
        # (K3 + torch displacement_lse); only the kernel branch reads it.
        self.fused_lse = cfg.fused_lse if cfg.fused_lse is not None else True
        # The projection's kernels (G3 and K2, or G4 on the raster) or the
        # plain projection; follows the comparison branch.
        self.kernel_projection = (
            cfg.kernel_projection if cfg.kernel_projection is not None
            else self.use_kernels
        )
        if self.device.type == "cuda":
            # TF32 keeps ~3 decimal digits of an f32 product: the same trap
            # as the TPU's bf16 default matmul precision, which moved pixel
            # snaps and displacement argmaxes there. Every contraction on
            # the card (rotations, convolution sums, the plain branch's
            # einsums) must stay full f32.
            torch.backends.cuda.matmul.allow_tf32 = False
            torch.backends.cudnn.allow_tf32 = False

        # Debug reductions (reference bioem.cpp:518-525, map.cpp:545-548)
        grid = make_ctf_grid(p)
        n_orient = orients.n
        n_ctf = grid.n
        if cfg.debug_break:
            n_orient = min(n_orient, cfg.debug_break)
            n_ctf = min(n_ctf, cfg.debug_break)
        maps = images.maps
        if cfg.debug_nmaps:
            maps = maps[: cfg.debug_nmaps]

        self.orients = orients
        self.n_orient = n_orient
        self.n_img = maps.shape[0]
        n = p.n_pixels
        nf = p.n_fft_1d

        # --- CTF bank (host precompute, reference param.cpp:1336-1620) ---
        self.grid = grid
        ctf_bank = build_ctf_bank(p, grid)[:n_ctf]
        self.n_ctf = n_ctf

        # --- displacement lattice + DFT weights ---
        disp, _cent = displacement_lists(p)
        self.disp = disp
        wx, wy = displacement_dft_weights(n, disp)
        self.n_fold = stride_fold(p.grid_space_center, n, disp)
        self._h = hermitian_weights(n)
        self.slot = slot
        self._f32_corr_ok = f32_corr_gate(maps, p) if slot is None else slot.f32_corr_ok
        # The comparison the kernel branch runs: K4, K1 or the hybrid.
        fused = self.use_kernels and self.fused_lse and self._f32_corr_ok
        self.fused_batched = fused and cfg.fused_batched
        if self.fused_batched and self.device.type == "cuda":
            # K4 has instances for D ≤ 32 whose operands fit shared memory
            # (the kernel library answers, so this builds it); elsewhere K1
            # runs, whose contract is the same. On the CPU K4's wrapper runs
            # its plain version, which takes any lattice.
            from ..ops.compare_cuda import batched_fits

            self.fused_batched = batched_fits(disp.shape[0], n // self.n_fold, nf)

        # --- block sizes ---
        self.o_block = max(1, min(cfg.orient_block, n_orient))
        if self.use_kernels:
            # The image padding granularity, and K4's tile (the JAX
            # kernel's contract I % tile = 0; it shapes no kernel's work).
            self.i_block = min(max(cfg.kernel_img_tile, 1), self.n_img)
        elif cfg.image_block > 0:
            self.i_block = min(cfg.image_block, self.n_img)
        else:
            # Bound the (O, C, Ib, N, F) complex product tensor ≈ 1 GiB.
            budget = 1 << 27  # elements
            per_img = self.o_block * n_ctf * n * nf
            self.i_block = int(np.clip(budget // max(per_img, 1), 1, self.n_img))
        si, so, n_i, n_o = slot[:4] if slot is not None else (0, 0, 1, 1)
        img_mult = self.i_block * n_i
        self.n_img_pad = _cdiv(self.n_img, img_mult) * img_mult
        blk_mult = self.o_block * n_o
        self.n_orient_pad = _cdiv(n_orient, blk_mult) * blk_mult
        # this engine's rows of the padded image axis, its first orientation
        # and its orientation count (all of them alone)
        rows = self.n_img_pad // n_i
        self.img_rows = (si * rows, (si + 1) * rows)
        self.n_orient_local = self.n_orient_pad // n_o
        self.orient_base = so * self.n_orient_local

        with span("bioem.engine.images"):
            img = self._image_arrays(maps)
        self.fspec = None
        self.spec = None
        # (shape, radius) of the voxel lattice the raster's lattice kernel
        # projects, or None (_model_arrays)
        self.lattice = None
        with span("bioem.engine.model"):
            marr = self._model_arrays(model, first=True)

        with span("bioem.engine.banks"):
            self.banks = banks_from_numpy(
                dict(
                    ctf_re=ctf_bank.real, ctf_im=ctf_bank.imag,
                    wx_re=wx.real, wx_im=wx.imag, wy_re=wy.real, wy_im=wy.imag,
                    h=self._h, disp=disp.astype(np.int32),
                    amp=grid.amp[:n_ctf], pha=grid.phase[:n_ctf], env=grid.env[:n_ctf],
                    **img, **marr,
                ),
                self.device,
            )
        # the block-invariant CTF prior (C,) f64
        self._prior = ctf_prior_term(self.banks.amp, self.banks.pha, self.banks.env, p)
        # The kernel branch's comparisons read the lattice weights' first
        # N/n_fold columns: held once, since the weights are the engine's
        # own (_check_banks); the plain branch reads the full wx.
        m_cols = n // self.n_fold
        self.wx_cols = (self.banks.wx_re[:, :m_cols].contiguous(),
                        self.banks.wx_im[:, :m_cols].contiguous())
        # G1's scratch on the card, this engine's alone (ops/posterior_cuda.py)
        self._g1_workspace = None
        if self.use_kernels and self.device.type == "cuda":
            from ..ops.posterior_cuda import constants_workspace

            self._g1_workspace = constants_workspace(
                self.o_block, n_ctf, self.banks.img_re.shape[0], n, nf, self.device)
        # (graph, static state, block index, launches per replay), captured
        # at the first replayed pass (the kernel branch on the card), and
        # the banks the graph reads: a copy of the engine's, into which
        # each replayed pass copies the banks it runs on
        self._graph = None
        self._graph_banks: Optional[Banks] = None
        self.captures = 0  # block steps captured (one per engine)
        self._copy_stream = None  # side stream of _place_banks on the card

        # --- orientation blocks (padded with angle 0; the int mask kills
        # the padding lanes) ---
        ang = orients.angles[:n_orient]
        pad_o = self.n_orient_pad - n_orient
        ang_p = np.concatenate([ang, np.repeat(ang[:1], pad_o, 0)]) if pad_o else ang
        mask = np.concatenate(
            [np.ones(n_orient, np.int32), np.zeros(pad_o, np.int32)]
        )
        nblk = self.n_orient_pad // self.o_block
        self._ang = ang
        blks = slice(self.orient_base // self.o_block,
                     (self.orient_base + self.n_orient_local) // self.o_block)
        self.ang_blocks = torch.as_tensor(
            ang_p.reshape(nblk, self.o_block, 4)[blks].astype(np.float32), device=self.device
        )
        self.mask_blocks = torch.as_tensor(mask.reshape(nblk, self.o_block)[blks],
                                           device=self.device)

        self._check_projection_bounds(model)

        # Identifies the problem in checkpoints (one sha256 over the small
        # identifying arrays); run() may checkpoint per call.
        from ..runtime.checkpoint import problem_fingerprint

        self._fingerprint = problem_fingerprint(p, orients, model, images, cfg)
        if slot is not None:
            self._fingerprint += f"|mesh:{n_i}x{n_o}|slot:{si}x{so}"

    # ------------------------------------------------------------------
    def _image_arrays(self, maps: np.ndarray) -> dict:
        """Per-image Σ/Σ² and prefolded conj-FFT bank, padded to n_img_pad
        by replicating image 0 (reference map.cpp:557-630). A swapped chunk
        must fit the engine's capacity and, when the engine runs the f32
        log1p shortcut and the fused comparison, pass their gate: a
        DC-dominated chunk raises rather than run the wrong comparison."""
        n = self.p.n_pixels
        n_img = maps.shape[0]
        if n_img > self.n_img_pad:
            raise ValueError(f"{n_img} images exceed engine capacity {self.n_img_pad}")
        if self._f32_corr_ok and not f32_corr_gate(maps, self.p):
            raise ValueError(
                "swap_images: this image chunk has DC-dominated images but the "
                "engine was built with the f32 log1p shortcut and the fused "
                "comparison for near-zero-mean images; rebuild the engine with "
                "(a chunk of) these images so that the f64 path is chosen"
            )
        if self.slot is not None:
            # the slot's rows of the padded stack (padding rows replicate
            # image 0, as below); it holds them all, so it pads none
            r0, r1 = self.img_rows
            rows = np.arange(r0, r1)
            maps = maps[np.where(rows < n_img, rows, 0)]
            n_img = maps.shape[0]
        flat = maps.reshape(n_img, -1).astype(np.float64)
        sum_ref = flat.sum(axis=1).astype(np.float32)
        ssq_ref = (flat**2).sum(axis=1).astype(np.float32)
        img_fft = np.fft.rfft2(maps.astype(np.float32)).astype(np.complex64)
        img_fc = (
            np.conj(img_fft) * (self._h[None, None, :] / np.float32(n * n))
        ).astype(np.complex64)
        pad_i = self.img_rows[1] - self.img_rows[0] - n_img
        if pad_i:
            # Replicate image 0 into the padding lanes to keep all values
            # finite; padded lanes are dropped at extraction time.
            img_fc = np.concatenate([img_fc, np.repeat(img_fc[:1], pad_i, 0)])
            sum_ref = np.concatenate([sum_ref, np.repeat(sum_ref[:1], pad_i)])
            ssq_ref = np.concatenate([ssq_ref, np.repeat(ssq_ref[:1], pad_i)])
        return dict(
            img_re=img_fc.real, img_im=img_fc.imag, sum_ref=sum_ref, ssq_ref=ssq_ref,
        )

    def _model_arrays(self, model: Model, first: bool = False) -> dict:
        """Model point/stencil arrays in the engine's projection layout:
        radius-grouped for the Fourier path, as read for the raster. With
        ``first`` it sets the engine's layout (self.fspec, self.spec);
        later models (swap_model) must land on that layout."""
        p = self.p
        cfg = self.cfg
        fspec = None
        pts = model.points
        radii = model.radii
        dens = model.densities
        st_re = st_im = np.zeros((1, 1, 1), np.float32)
        st_sums = np.zeros(1, np.float32)
        counts = np.zeros(1, np.int32)
        # The path: the first model's by the path rule (projection.py
        # choose_projection; a layout may force the raster), a later
        # model's the engine's, on the engine's layout. The Fourier path is
        # exact and raster+FFT-free, for few distinct radii.
        if first:
            path = ("raster" if self._force_raster
                    else choose_projection(p, [model], cfg.projection))
        else:
            path = "fourier" if self.fspec is not None else "raster"
        count(f"bioem.projection.{path}")
        if path == "fourier":
            fp = make_fourier_projection_spec(
                p, model.radii, n_groups_pad=self._g_pad, group_pad=self._pp_pad
            )
            if fp is not None:
                fspec, gather_idx, pad_mask, st, st_sums = fp
                pts = model.points[gather_idx]
                radii = model.radii[gather_idx]
                # Group-padding slots carry zero density → contribute nothing.
                dens = model.densities[gather_idx] * pad_mask
                st_re, st_im = st.real, st.imag
                counts = np.asarray(fspec.group_counts, np.int32)
        spec = make_projection_spec(p, model.radii, stencil_half_min=self._stencil_half_min)
        if fspec is None and self._n_points_pad:
            pad = self._n_points_pad - pts.shape[0]
            if pad < 0:
                raise ValueError(
                    f"model has {pts.shape[0]} points > layout pad {self._n_points_pad}"
                )
            if pad:
                # Zero-density pad points contribute nothing to the raster.
                pts = np.concatenate([pts, np.repeat(pts[:1], pad, 0)])
                radii = np.concatenate([radii, np.repeat(radii[:1], pad)])
                dens = np.concatenate([dens, np.zeros(pad, dens.dtype)])
        # The raster's variant: the lattice kernel where the model is a
        # voxel lattice (projection.lattice_axes) and the layout allows it,
        # else the generic walk over the point list. A later model must fit
        # the engine's variant: a lattice of the same shape and radius.
        axes = None
        if fspec is None and (self._lattice_ok if first else self.lattice is not None):
            found = lattice_axes(model.points, model.radii, p.pixel_size)
            lat = None if found is None else (found[1], float(np.float32(model.radii[0])))
            if not first and lat != self.lattice:
                raise ValueError(
                    "swap_model: this engine projects a voxel lattice of shape "
                    f"{self.lattice[0]} and radius {self.lattice[1]} (the raster's lattice "
                    "kernel); the model is "
                    + ("not a voxel lattice" if lat is None else
                       f"a lattice of shape {lat[0]} and radius {lat[1]}")
                    + " — pass rank.common_model_layout's model_layout at engine construction")
            if lat is not None:
                axes = lattice_field(found[0], model.densities)
                count("bioem.projection.raster.lattice")
            if first:
                self.lattice = lat
        if first:
            self.fspec = fspec
            self.spec = spec
        else:
            # The spec's equality leaves out its group counts: they are
            # model data (Banks.counts), swapped with the model.
            if (fspec is None) != (self.fspec is None) or (
                fspec is not None and fspec != self.fspec
            ):
                raise ValueError(
                    "swap_model: model needs a different Fourier-projection "
                    "layout than this engine was built for — pass a common "
                    "model_layout at engine construction (see "
                    "rank.common_model_layout)"
                )
            if fspec is None and spec != self.spec:
                raise ValueError(
                    "swap_model: model needs a different raster stencil than "
                    "this engine was built for — pass model_layout with "
                    f"stencil_half >= {spec.stencil_half}"
                )
        return dict(
            points=np.asarray(pts, np.float32),
            radii=np.asarray(radii, np.float32),
            dens=np.asarray(dens, np.float32),
            norm_den=np.float32(model.norm_den),
            st_re=st_re,
            st_im=st_im,
            st_sums=np.asarray(st_sums, np.float32),
            counts=counts,
            axes=np.zeros(0, np.float32) if axes is None else axes,
        )

    def _place_banks(self, host_fields: dict) -> Banks:
        """Banks with this engine's constants and ``host_fields`` (NumPy
        arrays or CPU tensors, e.g. from :meth:`pin_fields`) on its device.
        On the card the copies run from pinned memory on a side stream, so
        that they overlap the work already queued on the current stream (a
        streamed run's next chunk rides under the current chunk's
        replays); the current stream waits for them before any later
        work."""
        dev = self.device
        with span("bioem.place.pin"):
            host_fields = self.pin_fields(host_fields)
        with span("bioem.place.copy"):
            if dev.type != "cuda":
                return self.banks._replace(**{
                    k: torch.as_tensor(np.array(v, copy=True, order="C")) if not torch.is_tensor(v)
                    else v for k, v in host_fields.items()
                })
            cur = torch.cuda.current_stream(dev)
            if self._copy_stream is None:
                self._copy_stream = torch.cuda.Stream(dev)
            out = {}
            with torch.cuda.stream(self._copy_stream):
                for k, src in host_fields.items():
                    dst = torch.empty(src.shape, dtype=src.dtype, device=dev)
                    dst.copy_(src, non_blocking=True)
                    dst.record_stream(cur)  # freed only after the current stream's use
                    out[k] = dst
            cur.wait_stream(self._copy_stream)
            return self.banks._replace(**out)

    def pin_fields(self, host_fields: dict) -> dict:
        """``host_fields`` as page-locked CPU tensors when the engine runs
        on the card (the source of an asynchronous copy; thread-safe, so a
        prefetch thread can do it), else unchanged."""
        if self.device.type != "cuda":
            return host_fields
        return {
            k: v if torch.is_tensor(v) and v.is_pinned()
            else torch.as_tensor(np.array(v, copy=True, order="C")).pin_memory()
            for k, v in host_fields.items()
        }

    def swap_model(self, model: Model) -> Banks:
        """Banks with this engine's precompute but ``model``'s arrays (and
        its per-group point counts), on the engine's layout: same shapes,
        so the captured block step serves it."""
        with span("bioem.swap_model"):
            with span("bioem.swap_model.bounds"):
                self._check_projection_bounds(model)
            with span("bioem.swap_model.layout"):
                fields = self._model_arrays(model)
            return self._place_banks(fields)

    def swap_images(self, maps: np.ndarray) -> Banks:
        """Banks with this engine's precompute but a new image chunk
        (padded to the engine's image capacity)."""
        with span("bioem.swap_images"):
            with span("bioem.swap_images.layout"):
                fields = self._image_arrays(maps)
            return self._place_banks(fields)

    def _check_banks(self, banks: Banks) -> None:
        """Banks a pass may run on: the engine's own, or a swap of its image
        and model fields at the engine's shapes and dtypes (the captured
        step reads tensors of those shapes; the CTF prior and the
        lattice are the engine's)."""
        if banks is self.banks:
            return
        for name, a, b in zip(Banks._fields, self.banks, banks):
            if name in IMAGE_FIELDS or name in MODEL_FIELDS:
                if (a is None) != (b is None) or (a is not None and (
                        a.shape != b.shape or a.dtype != b.dtype or a.device != b.device)):
                    raise ValueError(
                        f"swapped banks: {name} must be {None if a is None else (a.dtype, tuple(a.shape))} "
                        f"on {self.device}, got {None if b is None else (b.dtype, tuple(b.shape), str(b.device))}"
                        " (swap through swap_images/swap_model on a common layout)")
            elif b is not a:
                raise ValueError(f"swapped banks: {name} is the engine's own and cannot be swapped")

    def _check_projection_bounds(self, model: Model):
        """Out-of-frame diagnostics (reference bioem.cpp:1723-1731 warns per
        projection; a fully out-of-frame orientation gives tempden == 0 →
        NaN). The O(P) rotation-invariant bound skips the scan for
        well-centred models; otherwise the census (projection.oob_census)
        counts the dropped (orientation, point) pairs, on the card with the
        projection kernels' own snap, else with projection_oob_report.
        Span ``bioem.bounds``; counter ``bioem.bounds.oob_points``."""
        p = self.p
        n = p.n_pixels
        with span("bioem.bounds"):
            if projection_always_in_bounds(
                n, p.pixel_size, p.shift_x, p.shift_y, model.points, model.radii
            ):
                return
            on_card = self.device.type == "cuda" and self.kernel_projection
            total_oob, affected, all_oob = oob_census(
                n, p.pixel_size, p.shift_x, p.shift_y, model.points, model.radii,
                self._ang, self.orients.use_quaternions,
                device=self.device if on_card else "cpu",
            )
            count("bioem.bounds.oob_points", total_oob)
            if all_oob:
                raise ValueError(
                    f"model projects entirely outside the {n}x{n} grid for "
                    f"{all_oob} of {self.n_orient} orientations (tempden == 0 — "
                    "the posterior would be NaN). Check PIXEL_SIZE / "
                    "NUMBER_PIXELS / SHIFT_X/Y against the model extent."
                )
            if total_oob:
                warnings.warn(
                    f"{total_oob} point projections fall outside the "
                    f"{n}x{n} grid across {affected} of {self.n_orient} "
                    "orientations; their density is dropped (reference "
                    "bioem.cpp:1723-1731 behaviour).",
                    RuntimeWarning,
                    stacklevel=2,
                )

    # ------------------------------------------------------------------
    def _project_block(self, banks: Banks, angles: torch.Tensor):
        """Projection spectra (pr, pi), each (O, N, F) f32, of one
        orientation block: on the kernel projection from the angle rows
        (ops/project_cuda.py) G3 and K2, or G4 then rfft2 on the raster;
        else the rotation matrices and the plain Fourier or raster
        projection."""
        model = (banks.points, banks.radii, banks.dens, banks.norm_den)
        quat = self.orients.use_quaternions
        if self.kernel_projection:
            if self.fspec is not None:
                return project_fourier_batch_kernel(
                    self.fspec, angles, *model, banks.st_re, banks.st_im, banks.st_sums,
                    counts=banks.counts, use_quaternions=quat,
                )
            if self.lattice is None:
                proj = project_batch_kernel(self.spec, angles, *model, use_quaternions=quat)
            else:
                proj = project_batch_kernel(self.spec, angles, *model, use_quaternions=quat,
                                            lattice=(banks.axes, *self.lattice))
        else:
            rotm = rotation_matrices(angles, quat)
            if self.fspec is not None:
                return project_fourier_batch(
                    self.fspec, rotm, *model, banks.st_re, banks.st_im, banks.st_sums,
                )
            proj = project_batch(self.spec, rotm, *model)
        proj_f = torch.fft.rfft2(proj)  # (O, N, F) complex64
        return proj_f.real.contiguous(), proj_f.imag.contiguous()

    def _kernel_constants(self, banks: Banks, pr, pi, mask: torch.Tensor):
        """The kernel branch's block constants (G1, ops/posterior_cuda.py):
        the convolution sums without materialising conv, the f64 F0 and K
        (K −inf where ``mask`` is 0) and the fused comparison's u
        coefficients. Returns (sum_c, ssq_c, f0, k, a_u, b_u)."""
        from ..ops.posterior_cuda import block_constants

        return block_constants(
            pr, pi, banks.ctf_re, banks.ctf_im, banks.h, banks.sum_ref, banks.ssq_ref,
            self._prior, mask, ntot=self.p.n_total_pixels, images_normalized=self._f32_corr_ok,
            workspace=self._g1_workspace,
        )

    def _block_step(
        self, state: PosteriorState, banks: Banks, angles: torch.Tensor,
        orient_offset, mask: torch.Tensor, ang_offset=None,
    ) -> PosteriorState:
        """Fold one orientation block into ``state`` in place. The (global)
        index of its first orientation is an int or a 0-d device tensor,
        as is ``ang_offset``, its column in the state's per-angle slabs
        (None: the same; a mesh slot's slabs hold only its shard's
        columns). The step holds no host synchronisation and allocates
        nothing whose size depends on the block, so it can be captured. Its
        phases are spans (``bioem.projection``, ``.constants``,
        ``.compare``, ``.merge``; utils/timestat.py): they time the host's
        work of every block of the eager loop, and tools/trace_step.py
        groups an eager window's glue by their profiler ranges. On the
        card they fire only at the warm-up step and the capture: a replay
        runs no host code, and the replayed phases are the kernels by
        name. On the kernel branch the constants are G1 and the
        merge (with the f64 repair of the fused comparison's max) is G2
        (ops/posterior_cuda.py)."""
        p = self.p
        n = p.n_pixels
        ntot = p.n_total_pixels
        o, c = self.o_block, self.n_ctf
        d = self.disp.shape[0]
        n_img_local = banks.img_re.shape[0]

        with span("bioem.projection"):
            pr, pi = self._project_block(banks, angles)

        if self.use_kernels:
            from ..ops import posterior_cuda

            with span("bioem.constants"):
                sum_c, ssq_c, f0, k, a_u, b_u = self._kernel_constants(banks, pr, pi, mask)
            wx_re, wx_im = self.wx_cols
            # The fused kernels evaluate u in f32; DC-dominated image banks
            # need the f64 u, so they take the hybrid: the cc-lattice
            # kernel and the f64 displacement_lse (as does fused_lse=False).
            if self.fused_lse and self._f32_corr_ok:
                from ..ops import compare_cuda

                with span("bioem.compare"):
                    args = (pr, pi, banks.ctf_re, banks.ctf_im, banks.img_re, banks.img_im,
                            wx_re, wx_im, banks.wy_re, banks.wy_im, a_u, b_u)
                    if self.fused_batched:
                        _m, se, ds, ccs = compare_cuda.fused_compare_block_batched(
                            *args, a_coef=(3.0 - ntot) * 0.5, n_fold=self.n_fold,
                            img_tile=self.i_block,
                        )
                    else:
                        _m, se, ds, ccs = compare_cuda.fused_compare_block(
                            *args, a_coef=(3.0 - ntot) * 0.5, n_fold=self.n_fold,
                        )
                    se = se.reshape(o, c, n_img_local)
                    ds = ds.reshape(o, c, n_img_local)
                    ccs = ccs.reshape(o, c, n_img_local)
                # G2 repairs the kernel's f32 max in f64 at the argmax cc.
                m = None
            else:
                from ..ops.compare_cuda import fused_displacement_cc

                with span("bioem.compare"):
                    conv_re = pr[:, None] * banks.ctf_re[None] + pi[:, None] * banks.ctf_im[None]
                    conv_im = pi[:, None] * banks.ctf_re[None] - pr[:, None] * banks.ctf_im[None]
                    cc = fused_displacement_cc(
                        conv_re.reshape(o * c, n, p.n_fft_1d),
                        conv_im.reshape(o * c, n, p.n_fft_1d),
                        banks.img_re, banks.img_im, wx_re, wx_im, banks.wy_re, banks.wy_im,
                        n_fold=self.n_fold,
                    ).reshape(o, c, n_img_local, d, d)
                    m, se, ds, ccs = displacement_lse(
                        cc, sum_c, banks.sum_ref, f0, ntot, f32_u=self._f32_corr_ok,
                        ssq_c=ssq_c, ssq_ref=banks.ssq_ref, repair=False,
                    )
                # On the f32-u branch G2 repairs the max, as on the fused
                # path; a DC-dominated bank's f64-u max is final.
                if self._f32_corr_ok:
                    m = None
            with span("bioem.merge"):
                return posterior_cuda.merge_block(
                    state, m, se, ds, ccs, k, f0, sum_c, ssq_c, banks.sum_ref, banks.disp,
                    orient_offset, ntot=ntot, ang_offset=ang_offset,
                )

        prior_oc = self._prior[None, :].expand(o, c)
        with span("bioem.compare"):
            # conv = proj · conj(ctf) (reference bioem.cpp:1879-1883), split form
            conv_re = pr[:, None] * banks.ctf_re[None] + pi[:, None] * banks.ctf_im[None]
            conv_im = pi[:, None] * banks.ctf_re[None] - pr[:, None] * banks.ctf_im[None]
            sum_c, ssq_c = convolution_sums(conv_re, conv_im, banks.h, n)
            outs = []
            for s in range(0, n_img_local, self.i_block):
                sl = slice(s, s + self.i_block)
                sref_b, ssref_b = banks.sum_ref[sl], banks.ssq_ref[sl]
                f0_b, k_b = logpro_constants(
                    sum_c, ssq_c, sref_b, ssref_b, prior_oc, ntot,
                    images_normalized=self._f32_corr_ok,
                )
                cc = displacement_cc(
                    conv_re, conv_im, banks.img_re[sl], banks.img_im[sl],
                    banks.wx_re, banks.wx_im, banks.wy_re, banks.wy_im,
                )
                outs.append((*displacement_lse(
                    cc, sum_c, sref_b, f0_b, ntot, f32_u=self._f32_corr_ok,
                    ssq_c=ssq_c, ssq_ref=ssref_b,
                ), k_b))
            m, se, ds, ccs, k = (torch.cat(x, dim=2) for x in zip(*outs))

        with span("bioem.merge"):
            k = torch.where(mask[:, None, None] != 0, k, torch.full_like(k, -torch.inf))
            return merge_block(
                state, m, se, ds, ccs, k, sum_c, ssq_c, banks.sum_ref,
                banks.disp, orient_offset, ntot, d, ang_offset=ang_offset,
            )

    # ------------------------------------------------------------------
    def initial_state(self) -> PosteriorState:
        return init_state(
            self.img_rows[1] - self.img_rows[0], self.n_orient_local,
            self.p.write_angles > 0, self.device,
        )

    def _offsets(self, b):
        """(orient_offset, ang_offset) of local block ``b`` (an int or a
        0-d device tensor): a mesh slot's blocks start at orient_base."""
        local = b * self.o_block
        if not self.orient_base:
            return local, None
        return local + self.orient_base, local

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _replayed(self) -> bool:
        """The pass replays a captured block step: the kernel branch on the
        card."""
        return self.device.type == "cuda" and self.use_kernels

    @traced("bioem.capture")
    def _capture(self) -> None:
        """Capture the block step once per engine: warm-up on a side
        stream, then capture on it (PyTorch's rule), on a static state, a
        device block index that each replay reads and advances, and the
        graph's own copy of the banks (``_graph_banks``), into which each
        pass copies the banks it runs on. The kernel wrappers counted the
        captured launches, which did not run: they are taken off and added
        back per replay. :meth:`_graph_load` calls it while the engine has
        no graph."""
        dev = self.device
        state = self.initial_state()
        blk = torch.zeros(1, dtype=torch.long, device=dev)
        gb = Banks(*(x.clone() if x is not None else None for x in self.banks))
        self._graph_banks = gb

        def step():
            off, ang_off = self._offsets(blk[0])
            self._block_step(state, gb, self.ang_blocks.index_select(0, blk)[0], off,
                             self.mask_blocks.index_select(0, blk)[0], ang_offset=ang_off)
            blk.add_(1)

        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with span("bioem.capture.warmup"), torch.cuda.stream(side):
            step()
        torch.cuda.current_stream(dev).wait_stream(side)
        wrappers = _kernel_wrappers()
        before = [fn.launches for fn in wrappers]
        graph = torch.cuda.CUDAGraph()
        # torch.cuda.graph synchronises the card on entry (the warm-up's
        # kernels) and instantiates the graph on exit
        with span("bioem.capture.graph"), torch.cuda.graph(graph, stream=side):
            step()
        made = tuple((fn, fn.launches - b) for fn, b in zip(wrappers, before))
        for fn, k in made:
            fn.launches -= k
        self._graph = (graph, state, blk, tuple((fn, k) for fn, k in made if k))
        self.captures += 1

    def _graph_load(self, state: PosteriorState, start: int,
                    banks: Optional[Banks] = None) -> PosteriorState:
        """Capture the step if need be, copy ``state`` into its static
        state and ``banks`` (default: the engine's) into the banks it
        reads, in place, and point its block index at block ``start``;
        returns the static state, which each replay updates. Everything
        the step derives from a swapped field it derives inside the graph
        (K2's counts are a field), so one capture serves every chunk and
        model."""
        if self._graph is None:
            self._capture()
        _graph, static, blk, _made = self._graph
        for dst, src in zip(static, state):
            if dst is not None:
                dst.copy_(src)
        for dst, src in zip(self._graph_banks, self.banks if banks is None else banks):
            if dst is not None and dst.data_ptr() != src.data_ptr():
                dst.copy_(src)
        blk.fill_(start)
        return static

    def _replay(self) -> None:
        """One block: one replay of the captured step."""
        graph, _static, _blk, made = self._graph
        graph.replay()
        for fn, k in made:
            fn.launches += k

    def time_blocks(self, target_orients: int, repeats: int = 2) -> float:
        """Best-of-``repeats`` seconds per orientation of the block loop the
        pass runs, over ~``target_orients`` orientations, after one dropped
        warm-up pass (the autotuner's probe; the warm-up builds the
        kernels). On the card's kernel branch that is the replayed loop;
        the capture (at the first pass's ``_graph_load``) precedes every
        timed span."""
        nb = min(max(1, _cdiv(target_orients, self.o_block)), self.ang_blocks.shape[0])
        replayed = self._replayed()
        best = float("inf")
        for rep in range(repeats + 1):
            state = self.initial_state()
            if replayed:
                self._graph_load(state, 0)
            self._sync()
            t0 = time.perf_counter()
            for b in range(nb):
                if replayed:
                    self._replay()
                else:
                    off, ang_off = self._offsets(b)
                    state = self._block_step(
                        state, self.banks, self.ang_blocks[b], off, self.mask_blocks[b],
                        ang_offset=ang_off,
                    )
            self._sync()
            if rep:
                best = min(best, time.perf_counter() - t0)
        return best / (nb * self.o_block)

    def _checkpoint_fingerprint(self, banks: Banks, bank_tag: str) -> str:
        """Fingerprint of this pass's checkpoint, tied to the banks it runs
        on. The construction-time fingerprint alone is wrong under
        swap_images/swap_model: chunk 2 of a streamed run would load chunk
        1's completed checkpoint (same path, same fingerprint) and return
        chunk 1's posterior for chunk 2's images. Swapped banks therefore
        carry a caller-supplied identity tag, and without one a
        checkpointed pass refuses to run."""
        if banks is self.banks:
            return self._fingerprint
        if not bank_tag:
            raise ValueError(
                "checkpointing with swapped banks requires a bank_tag "
                "identifying the active image chunk / model (see "
                "stream.py / rank.py) — without one, a completed "
                "checkpoint from a previous bank would be silently "
                "loaded as this bank's result"
            )
        return f"{self._fingerprint}|bank:{bank_tag}"

    @traced("bioem.pass")
    def run(self, banks: Optional[Banks] = None, bank_tag: str = "",
            checkpoint_path: Optional[str] = None) -> PosteriorState:
        """One full posterior pass over every orientation block.

        ``banks`` overrides the engine's banks (swap_images/swap_model:
        the same shapes, so the captured step serves them); ``bank_tag``
        identifies swapped banks in checkpoints; ``checkpoint_path``
        overrides cfg.checkpoint_path (a streamed run's per-chunk files).
        With a checkpoint path a matching checkpoint is resumed, and the
        state is saved every cfg.checkpoint_every blocks (default 16) and
        at the end. A checkpoint matches when its fingerprint does and its
        state has this engine's shapes: the fingerprint leaves out the
        image padding, which follows the kernel and its tile. At
        ``debug_output >= 2`` every block is synchronised and its time
        printed. The pass is span ``bioem.pass`` (``bioem.graph_load``,
        ``bioem.checkpoint``). On the card's kernel
        branch each block is a replay of the captured step, on the graph's
        copy of the banks, into which ``banks`` is copied first (a resumed
        run starts the graph's block index at its first block), and the
        state returned is a copy that no later pass of this engine
        overwrites."""
        banks = self.banks if banks is None else banks
        self._check_banks(banks)
        ckpt = self.cfg.checkpoint_path if checkpoint_path is None else checkpoint_path
        fingerprint = self._checkpoint_fingerprint(banks, bank_tag) if ckpt else ""
        debug = self.cfg.debug_output
        nblk = self.ang_blocks.shape[0]
        state = self.initial_state()
        start = 0
        every = max(1, self.cfg.checkpoint_every or 16)
        if ckpt:
            from ..runtime.checkpoint import load_checkpoint, save_checkpoint

            loaded = load_checkpoint(ckpt, fingerprint, self.device)
            if loaded is not None and _same_shapes(loaded[0], state):
                state, start = loaded
                if debug >= 1:
                    print(f"Resuming from checkpoint at block {start}/{nblk}")
        replayed = self._replayed()
        if replayed:
            with span("bioem.graph_load"):
                state = self._graph_load(state, start, banks)
        for b in range(start, nblk):
            save = bool(ckpt) and ((b + 1) % every == 0 or b == nblk - 1)
            t0 = time.perf_counter() if debug >= 2 else 0.0
            if replayed:
                self._replay()
            else:
                off, ang_off = self._offsets(b)
                state = self._block_step(
                    state, banks, self.ang_blocks[b], off, self.mask_blocks[b],
                    ang_offset=ang_off,
                )
            if debug >= 2 or save:
                self._sync()
            if debug >= 2:
                print(f"\tTime orientation block {b}/{nblk}: {time.perf_counter() - t0:.4f}")
            if save:
                with span("bioem.checkpoint"):
                    save_checkpoint(ckpt, state, b + 1, fingerprint)
        if replayed:
            state = PosteriorState(*(x.clone() if x is not None else None for x in state))
        return state

    # ------------------------------------------------------------------
    @traced("bioem.results")
    def results(self, state: PosteriorState, n_img: Optional[int] = None) -> Results:
        """The pass's per-image summary on the host (its reads of the state
        wait for the card)."""
        p = self.p
        volu = orientation_volume_quirked(p, self.orients.voluang, self.grid)
        k_norm = log_normalization_constant(p, volu)
        i = self.n_img if n_img is None else n_img

        def host(x):
            return x.detach().cpu().numpy()

        total = host(state.total)[:i]
        const = host(state.const)[:i]
        with np.errstate(divide="ignore"):
            log_prob = np.log(total) + const + k_norm
        angle_log = None
        angle_raw = None
        if state.ang_total is not None:
            at = host(state.ang_total)[:i, : self.n_orient]
            ac = host(state.ang_const)[:i, : self.n_orient]
            with np.errstate(divide="ignore"):
                log_at = np.log(at)
                angle_log = log_at + ac + k_norm
            angle_raw = (log_at, ac)
        return Results(
            log_prob=log_prob,
            constoadd=const,
            total=total,
            best_orient=host(state.best_orient)[:i],
            best_conv=host(state.best_conv)[:i],
            best_cent_x=host(state.best_cent_x)[:i],
            best_cent_y=host(state.best_cent_y)[:i],
            best_norm=host(state.best_norm)[:i],
            best_mu=host(state.best_mu)[:i],
            angle_log=angle_log,
            log_norm_const=k_norm,
            angle_raw=angle_raw,
        )

"""Fused comparison (K1, K4) and cc-lattice (K3) kernels: wrappers + plain versions.

Replaces ``bioem_tpu/ops/compare_pallas.py:_fused_block_kernel`` (entry
``fused_compare_block``), ``_fused_block_kernel_batched`` (entry
``fused_compare_block_batched``) and ``_fused_cc_kernel`` (entry
``fused_displacement_cc``). K1 is ``csrc/compare_fused.cu``: a CTA per
(orientation·ctf, run of images), conv formed once per orientation·ctf,
stage 1 on warpgroup wgmma in 3xTF32 with W streamed through shared
memory (any lattice width and fold; :func:`k1_plan` tiles it). K3 is the
same kernel in its cc-out body: its prologue copies the conv bank it is
given, and each warpgroup writes its image's lattice in place of the
log-sum-exp; it takes every shape K1 takes, with K1's tiling. K4 is
``csrc/compare_batched.cu``, whose persistent blocks walk groups of four
images and run stage 1 on warpgroup wgmma in 3xTF32 with W resident (see
each source's header for what bounds it on the card and how the design
answers that). K1 and K4 share one contract, so their plain version is
one function.

    conv[o,c]       = proj[o] ⊙ conj(ctf[c])
    cc[o,c,i,d,e]   = Re( wx[d] @ fold(conv[o,c] ⊙ img_fc[i]) @ wy[e]ᵀ )
    v[o,c,i,d,e]    = a_coef · log1p(a_u·cc − b_u·cc²)
    out[o,c,i]      = (max v, Σ exp(v−max), argmax d·D+e, cc@argmax)

``fold`` sums the rows j + k·N/n_fold (valid when every displacement is a
multiple of n_fold, see core.posterior.stride_fold); wx then has N/n_fold
columns. Ties of the argmax go to the lower flat index (the reference
sweep's first occurrence). Only ``m`` is the raw f32 max: the engine
repairs it in f64 with core.posterior.refine_varying_max.

A CPU tensor gets the plain torch version; a CUDA tensor gets the kernel
or an exception — never a fallback.
"""

from __future__ import annotations

import torch

from . import _build

F32 = torch.float32

# Dynamic shared memory one block may use on Hopper (232,448 bytes).
MAX_SMEM = 232448


def _fold(p: torch.Tensor, n_fold: int, m: int) -> torch.Tensor:
    """Sum rows j + k·m of (..., N, F) into (..., m, F)."""
    if n_fold <= 1:
        return p
    return p.reshape(*p.shape[:-2], n_fold, m, p.shape[-1]).sum(dim=-3)


def displacement_cc_plain(conv_re, conv_im, img_re, img_im, wx_re, wx_im,
                          wy_re, wy_im, *, n_fold: int = 1):
    """cc[oc, i, d, e] from a conv bank (OC, N, F): plain torch version."""
    m = wx_re.shape[1]
    cr, ci = conv_re[:, None], conv_im[:, None]
    p_re = _fold(cr * img_re[None] - ci * img_im[None], n_fold, m)  # (OC, I, m, F)
    p_im = _fold(cr * img_im[None] + ci * img_re[None], n_fold, m)
    ein = torch.einsum
    t1_re = ein("dm,oimf->oidf", wx_re, p_re) - ein("dm,oimf->oidf", wx_im, p_im)
    t1_im = ein("dm,oimf->oidf", wx_re, p_im) + ein("dm,oimf->oidf", wx_im, p_re)
    return ein("oidf,ef->oide", t1_re, wy_re) - ein("oidf,ef->oide", t1_im, wy_im)


def fused_compare_block_plain(proj_re, proj_im, ctf_re, ctf_im, img_re, img_im,
                              wx_re, wx_im, wy_re, wy_im, a_u, b_u, *,
                              a_coef: float, n_fold: int = 1):
    """Plain torch version of :func:`fused_compare_block`."""
    o_n, c_n = proj_re.shape[0], ctf_re.shape[0]
    conv_re = (proj_re[:, None] * ctf_re[None] + proj_im[:, None] * ctf_im[None])
    conv_im = (proj_im[:, None] * ctf_re[None] - proj_re[:, None] * ctf_im[None])
    n, f = proj_re.shape[1:]
    cc = displacement_cc_plain(
        conv_re.reshape(o_n * c_n, n, f), conv_im.reshape(o_n * c_n, n, f),
        img_re, img_im, wx_re, wx_im, wy_re, wy_im, n_fold=n_fold,
    )
    oc, i_n, d, _ = cc.shape
    cc = cc.reshape(oc, i_n, d * d)
    au, bu = a_u[..., None], b_u[..., None]
    v = float(a_coef) * torch.log1p(au * cc - bu * cc * cc)
    m = torch.amax(v, dim=-1)
    ds = torch.argmax(v, dim=-1)
    se = torch.sum(torch.exp(v - m[..., None]), dim=-1)
    ccs = torch.gather(cc, -1, ds[..., None])[..., 0]
    return m, se, ds.to(torch.int32), ccs


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _a128(x: int) -> int:
    return _cdiv(x, 128) * 128


def k1_smem_bytes(d: int, m: int, f: int, n_fold: int, n_wg: int, kc: int) -> int:
    """Dynamic shared memory of K1 with ``n_wg`` warpgroups and K chunks of
    ``kc`` steps (csrc/compare_fused.cu ``plan``; the C entry
    ``bioem_fused_compare_smem_bytes`` gives the same number): W's hi/lo
    block and the chunk's conv rows, double-buffered; the t1 tiles; wy; the
    lattices."""
    dp = _cdiv(d, 8) * 8
    n_nc = _cdiv(dp, 32)
    n_p = 2 * _cdiv(_cdiv(dp, n_nc), 8) * 8
    w_chunk = 2 * n_p * 32 * kc
    cv_chunk = 8 * kc * n_fold * 4 * 68
    return (2 * w_chunk + 2 * _a128(cv_chunk) + _a128(4 * n_wg * 64 * (n_p + 4))
            + _a128(8 * d * f) + _a128(4 * n_wg * d * d))


def k1_plan(d: int, m: int, f: int, n_fold: int):
    """K1's tiling at (D, M, F, n_fold): (warpgroups, K-chunk steps, shared
    bytes), four warpgroups before two and the longest K chunk first that
    fits one block; None if none does."""
    for n_wg in (4, 2):
        for kc in (8, 4, 2, 1):
            b = k1_smem_bytes(d, m, f, n_fold, n_wg, kc)
            if b <= MAX_SMEM:
                return n_wg, kc, b
    return None


def _check(fn: str, device, specs) -> None:
    for name, t, shape in specs:
        if t.device != device or t.dtype != F32 or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{fn}: {name} must be float32 {tuple(shape)} on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check_launch(fn: str, smem: int, d: int, m: int, n: int, n_fold: int, oc: int):
    if m * n_fold != n:
        raise ValueError(f"{fn}: wx has {m} columns, expected N/n_fold = {n}/{n_fold}")
    if oc > 65535:
        raise ValueError(f"{fn}: {oc} orientation·ctf pairs exceed the grid limit 65535")
    if smem > MAX_SMEM:
        raise ValueError(
            f"{fn}: D={d}, M={m} needs {smem} bytes of shared memory (> {MAX_SMEM})"
        )


def _compare_dims(fn: str, args) -> tuple:
    """Check the twelve inputs of a fused comparison on their CUDA device;
    return (O, C, I, N, F, D, M)."""
    proj_re, proj_im, ctf_re, ctf_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im, a_u, b_u = args
    o_n, n, f = proj_re.shape
    c_n, i_n, d, m = ctf_re.shape[0], img_re.shape[0], wy_re.shape[0], wx_re.shape[1]
    oc = o_n * c_n
    _check(fn, proj_re.device, [
        ("proj_re", proj_re, (o_n, n, f)), ("proj_im", proj_im, (o_n, n, f)),
        ("ctf_re", ctf_re, (c_n, n, f)), ("ctf_im", ctf_im, (c_n, n, f)),
        ("img_re", img_re, (i_n, n, f)), ("img_im", img_im, (i_n, n, f)),
        ("wx_re", wx_re, (d, m)), ("wx_im", wx_im, (d, m)),
        ("wy_re", wy_re, (d, f)), ("wy_im", wy_im, (d, f)),
        ("a_u", a_u, (oc, i_n)), ("b_u", b_u, (oc, i_n)),
    ])
    return o_n, c_n, i_n, n, f, d, m


def _summary_outputs(oc: int, i_n: int, dev):
    out_m = torch.empty((oc, i_n), dtype=F32, device=dev)
    return (out_m, torch.empty_like(out_m),
            torch.empty((oc, i_n), dtype=torch.int32, device=dev), torch.empty_like(out_m))


def fused_compare_block(
    proj_re: torch.Tensor,  # (O, N, F) f32 — projection spectra
    proj_im: torch.Tensor,
    ctf_re: torch.Tensor,  # (C, N, F) f32 — CTF/PSF kernel bank
    ctf_im: torch.Tensor,
    img_re: torch.Tensor,  # (I, N, F) f32 — conj(rfft2(img))·h/N² prefolded
    img_im: torch.Tensor,
    wx_re: torch.Tensor,  # (D, N/n_fold) f32
    wx_im: torch.Tensor,
    wy_re: torch.Tensor,  # (D, F) f32
    wy_im: torch.Tensor,
    a_u: torch.Tensor,  # (O·C, I) f32 — 2·sum_ref·sum_c/F0
    b_u: torch.Tensor,  # (O·C, I) f32 — Ntot/F0
    *,
    a_coef: float,  # (3 − Ntot)/2
    n_fold: int = 1,
):
    """Fully fused comparison block: (m, sumexp, d_star, cc_star), each
    (O·C, I) — the per-(orientation, ctf, image) displacement-LSE summary
    consumed by core.posterior.merge_block."""
    args = (proj_re, proj_im, ctf_re, ctf_im, img_re, img_im,
            wx_re, wx_im, wy_re, wy_im, a_u, b_u)
    dev = proj_re.device
    if dev.type == "cpu":
        return fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    if dev.type != "cuda":
        raise ValueError(f"fused_compare_block: unsupported device {dev}")
    outs = launch_k1("fused_compare_block", args, a_coef, n_fold)
    fused_compare_block.launches += 1
    return outs


def launch_plan(fn: str, d: int, m: int, f: int, n: int, n_fold: int, oc: int):
    """K1's (and K3's) tiling of a launch, (warpgroups, K-chunk steps,
    shared bytes) from :func:`k1_plan`, after the checks every launch
    needs; raises ValueError where no tiling fits or the grid is too
    large."""
    plan = k1_plan(d, m, f, n_fold)
    if plan is None:
        raise ValueError(f"{fn}: D={d}, M={m}, F={f}, n_fold={n_fold}: no K1 tiling fits "
                         f"{MAX_SMEM} bytes of shared memory")
    _check_launch(fn, plan[2], d, m, n, n_fold, oc)
    return plan


def _scratch(lib, oc: int, n: int, d: int, m: int, f: int, n_fold: int, n_wg: int, kc: int,
             dev) -> torch.Tensor:
    """K1's scratch: the conv bank (OC, N, 64·⌈F/64⌉ complex) and W's
    hi/lo blocks."""
    return torch.empty(lib.bioem_fused_compare_scratch_bytes(oc, n, d, m, f, n_fold, n_wg, kc),
                       dtype=torch.uint8, device=dev)


def launch_k1(fn: str, args, a_coef: float, n_fold: int, variant: int | None = None,
              outs=None):
    """Check the twelve inputs on their CUDA device, tile the problem
    (:func:`launch_plan`), allocate the scratch and launch K1 (or, with
    ``variant``, its P3 body of that index); returns the four outputs."""
    dev = args[0].device
    o_n, c_n, i_n, n, f, d, m = _compare_dims(fn, args)
    n_wg, kc, _smem = launch_plan(fn, d, m, f, n, n_fold, o_n * c_n)
    if outs is None:
        outs = _summary_outputs(o_n * c_n, i_n, dev)
    lib = _build.load()
    scratch = _scratch(lib, o_n * c_n, n, d, m, f, n_fold, n_wg, kc, dev)
    head = (*(t.data_ptr() for t in args), float(a_coef), o_n, c_n, i_n, n, f, d, m, n_fold,
            n_wg, kc, *(t.data_ptr() for t in outs), scratch.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if variant is None:
            status = lib.bioem_fused_compare(*head, stream)
        else:
            status = lib.bioem_probe_compare(variant, *head, stream)
    _build.check(status, fn)
    return outs


fused_compare_block.launches = 0


def fused_displacement_cc(
    conv_re: torch.Tensor,  # (OC, N, F) f32
    conv_im: torch.Tensor,
    img_re: torch.Tensor,  # (I, N, F) f32 — conj(rfft2(img))·h/N² prefolded
    img_im: torch.Tensor,
    wx_re: torch.Tensor,  # (D, N/n_fold) f32
    wx_im: torch.Tensor,
    wy_re: torch.Tensor,  # (D, F) f32
    wy_im: torch.Tensor,
    *,
    n_fold: int = 1,
) -> torch.Tensor:
    """cc[oc, i, d, e] — same contract as core.posterior.displacement_cc
    on a flattened (OC, N, F) conv bank: K3, K1's kernel in its cc-out
    body, tiled as K1 is (:func:`launch_plan`)."""
    fn = "fused_displacement_cc"
    args = (conv_re, conv_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im)
    dev = conv_re.device
    if dev.type == "cpu":
        return displacement_cc_plain(*args, n_fold=n_fold)
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    oc, n, f = conv_re.shape
    i_n, d, m = img_re.shape[0], wy_re.shape[0], wx_re.shape[1]
    _check(fn, dev, [
        ("conv_re", conv_re, (oc, n, f)), ("conv_im", conv_im, (oc, n, f)),
        ("img_re", img_re, (i_n, n, f)), ("img_im", img_im, (i_n, n, f)),
        ("wx_re", wx_re, (d, m)), ("wx_im", wx_im, (d, m)),
        ("wy_re", wy_re, (d, f)), ("wy_im", wy_im, (d, f)),
    ])
    n_wg, kc, _smem = launch_plan(fn, d, m, f, n, n_fold, oc)
    lib = _build.load()
    cc = torch.empty((oc, i_n, d, d), dtype=F32, device=dev)
    scratch = _scratch(lib, oc, n, d, m, f, n_fold, n_wg, kc, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bioem_fused_displacement_cc(
            *(t.data_ptr() for t in args), oc, i_n, n, f, d, m, n_fold, n_wg, kc,
            cc.data_ptr(), scratch.data_ptr(), stream,
        )
    _build.check(status, fn)
    fused_displacement_cc.launches += 1
    return cc


fused_displacement_cc.launches = 0


# ---------------------------------------------------------------------------
# K4: the image-batched fused comparison (csrc/compare_batched.cu)
# ---------------------------------------------------------------------------

def batched_smem_bytes(d: int, m: int, f: int) -> int:
    """Dynamic shared memory of the batched kernel at (D, M, F), or 0 when
    it has no instance for D, as the kernel library computes it
    (``bioem_compare_batched_smem_bytes``; builds the library on first use).
    The image tile does not enter."""
    return int(_build.load().bioem_compare_batched_smem_bytes(d, m, f))


def batched_fits(d: int, m: int, f: int) -> bool:
    """The batched kernel has an instance for D and its shared memory fits
    one block on Hopper (D ≤ 32 and W resident: see compare_batched.cu)."""
    return 0 < batched_smem_bytes(d, m, f) <= MAX_SMEM


def fused_compare_block_batched(
    proj_re: torch.Tensor,  # (O, N, F) f32 — projection spectra
    proj_im: torch.Tensor,
    ctf_re: torch.Tensor,  # (C, N, F) f32 — CTF/PSF kernel bank
    ctf_im: torch.Tensor,
    img_re: torch.Tensor,  # (I, N, F) f32 — conj(rfft2(img))·h/N² prefolded
    img_im: torch.Tensor,
    wx_re: torch.Tensor,  # (D, N/n_fold) f32
    wx_im: torch.Tensor,
    wy_re: torch.Tensor,  # (D, F) f32
    wy_im: torch.Tensor,
    a_u: torch.Tensor,  # (O·C, I) f32 — 2·sum_ref·sum_c/F0
    b_u: torch.Tensor,  # (O·C, I) f32 — Ntot/F0
    *,
    a_coef: float,  # (3 − Ntot)/2
    n_fold: int = 1,
    img_tile: int = 8,
):
    """K4: :func:`fused_compare_block`'s contract with stage 1 on the
    tensor cores (3xTF32). The image count must be a multiple of
    ``img_tile`` (as the JAX kernel requires); the kernel's schedule and
    shared memory do not depend on the tile, so every tile runs the same
    work. The kernel has instances for D ≤ 32 where its operands fit
    shared memory (:func:`batched_fits`); elsewhere it raises before any
    launch."""
    args = (proj_re, proj_im, ctf_re, ctf_im, img_re, img_im,
            wx_re, wx_im, wy_re, wy_im, a_u, b_u)
    i_n = img_re.shape[0]
    it = min(int(img_tile), i_n)
    if it < 1 or i_n % it:
        raise ValueError(
            f"fused_compare_block_batched: image count {i_n} not a multiple of tile {it}"
        )
    dev = proj_re.device
    if dev.type == "cpu":
        return fused_compare_block_plain(*args, a_coef=a_coef, n_fold=n_fold)
    if dev.type != "cuda":
        raise ValueError(f"fused_compare_block_batched: unsupported device {dev}")
    fn = "fused_compare_block_batched"
    o_n, c_n, i_n, n, f, d, m = _compare_dims(fn, args)
    smem = batched_smem_bytes(d, m, f)
    if smem == 0:
        raise ValueError(f"{fn}: no kernel instance for D={d} (D ≤ 32: wgmma n16..n64)")
    _check_launch(fn, smem, d, m, n, n_fold, o_n * c_n)
    outs = _summary_outputs(o_n * c_n, i_n, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = _build.load().bioem_fused_compare_batched(
            *(t.data_ptr() for t in args), float(a_coef),
            o_n, c_n, i_n, n, f, d, m, n_fold, it,
            *(t.data_ptr() for t in outs), stream,
        )
    _build.check(status, fn)
    fused_compare_block_batched.launches += 1
    return outs


fused_compare_block_batched.launches = 0

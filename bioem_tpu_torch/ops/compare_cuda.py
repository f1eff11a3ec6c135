"""Fused comparison (K1) and cc-lattice (K3) kernels: wrappers + plain versions.

Replaces ``bioem_tpu/ops/compare_pallas.py:_fused_block_kernel`` (entry
``fused_compare_block``) and ``_fused_cc_kernel`` (entry
``fused_displacement_cc``). Both are one CUDA kernel, ``csrc/compare.cu``
(see its header for what bounds it on the card and how the design
answers that); the cc-lattice entry is its cc-out mode.

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


def _check(fn: str, device, specs) -> None:
    for name, t, shape in specs:
        if t.device != device or t.dtype != F32 or tuple(t.shape) != tuple(shape):
            raise ValueError(
                f"{fn}: {name} must be float32 {tuple(shape)} on {device}, "
                f"got {t.dtype} {tuple(t.shape)} on {t.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{fn}: {name} must be contiguous")


def _check_launch(fn: str, lib, d: int, m: int, f: int, n: int, n_fold: int, oc: int):
    if m * n_fold != n:
        raise ValueError(f"{fn}: wx has {m} columns, expected N/n_fold = {n}/{n_fold}")
    if oc > 65535:
        raise ValueError(f"{fn}: {oc} orientation·ctf pairs exceed the grid limit 65535")
    smem = lib.bioem_compare_smem_bytes(d, m, f)
    if smem > MAX_SMEM:
        raise ValueError(
            f"{fn}: D={d}, M={m}, F={f} needs {smem} bytes of shared memory "
            f"(> {MAX_SMEM})"
        )


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
    o_n, n, f = proj_re.shape
    c_n, i_n, d, m = ctf_re.shape[0], img_re.shape[0], wy_re.shape[0], wx_re.shape[1]
    oc = o_n * c_n
    _check("fused_compare_block", dev, [
        ("proj_re", proj_re, (o_n, n, f)), ("proj_im", proj_im, (o_n, n, f)),
        ("ctf_re", ctf_re, (c_n, n, f)), ("ctf_im", ctf_im, (c_n, n, f)),
        ("img_re", img_re, (i_n, n, f)), ("img_im", img_im, (i_n, n, f)),
        ("wx_re", wx_re, (d, m)), ("wx_im", wx_im, (d, m)),
        ("wy_re", wy_re, (d, f)), ("wy_im", wy_im, (d, f)),
        ("a_u", a_u, (oc, i_n)), ("b_u", b_u, (oc, i_n)),
    ])
    lib = _build.load()
    _check_launch("fused_compare_block", lib, d, m, f, n, n_fold, oc)
    out_m = torch.empty((oc, i_n), dtype=F32, device=dev)
    out_se = torch.empty_like(out_m)
    out_ds = torch.empty((oc, i_n), dtype=torch.int32, device=dev)
    out_ccs = torch.empty_like(out_m)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bioem_fused_compare(
            *(t.data_ptr() for t in args), float(a_coef),
            o_n, c_n, i_n, n, f, d, m, n_fold,
            out_m.data_ptr(), out_se.data_ptr(), out_ds.data_ptr(),
            out_ccs.data_ptr(), stream,
        )
    _build.check(status, "fused_compare_block")
    fused_compare_block.launches += 1
    return out_m, out_se, out_ds, out_ccs


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
    on a flattened (OC, N, F) conv bank; the comparison kernel's cc-out
    mode."""
    args = (conv_re, conv_im, img_re, img_im, wx_re, wx_im, wy_re, wy_im)
    dev = conv_re.device
    if dev.type == "cpu":
        return displacement_cc_plain(*args, n_fold=n_fold)
    if dev.type != "cuda":
        raise ValueError(f"fused_displacement_cc: unsupported device {dev}")
    oc, n, f = conv_re.shape
    i_n, d, m = img_re.shape[0], wy_re.shape[0], wx_re.shape[1]
    _check("fused_displacement_cc", dev, [
        ("conv_re", conv_re, (oc, n, f)), ("conv_im", conv_im, (oc, n, f)),
        ("img_re", img_re, (i_n, n, f)), ("img_im", img_im, (i_n, n, f)),
        ("wx_re", wx_re, (d, m)), ("wx_im", wx_im, (d, m)),
        ("wy_re", wy_re, (d, f)), ("wy_im", wy_im, (d, f)),
    ])
    lib = _build.load()
    _check_launch("fused_displacement_cc", lib, d, m, f, n, n_fold, oc)
    cc = torch.empty((oc, i_n, d, d), dtype=F32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = lib.bioem_fused_displacement_cc(
            *(t.data_ptr() for t in args), oc, i_n, n, f, d, m, n_fold,
            cc.data_ptr(), stream,
        )
    _build.check(status, "fused_displacement_cc")
    fused_displacement_cc.launches += 1
    return cc


fused_displacement_cc.launches = 0

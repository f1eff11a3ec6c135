"""The block step's posterior glue (G1, G2): kernel wrappers + plain versions.

No Pallas kernel has these bodies: on the TPU, XLA fused the arithmetic
around the two Pallas kernels of the jitted, scanned block step
(``bioem_tpu/core/engine.py:503``). The kernels are
``csrc/posterior_glue.cu`` (see its header for the lines each replaces,
what bounds it on the card and how the design answers that):

* G1 :func:`block_constants` — per (orientation, CTF) pair the
  convolution sums (sum_c, ssq_c) from the projection and CTF spectra,
  then per image the f64 constants F0 and K of
  ``core.posterior.logpro_constants`` (K −inf for masked orientations)
  and the fused comparison's u coefficients a_u, b_u. On the card it is a
  split-K reduction over every SM (:func:`constants_plan`) into a
  :class:`ConstantsWorkspace`, which an engine holds for its blocks;
* G2 :func:`merge_block` — the f64 repair of the varying max
  (``core.posterior.refine_varying_max``, on the fused path) and the
  streaming merge of one block into the posterior state, in place
  (``core.posterior.merge_block``).

The plain versions are the torch code the engine ran before the kernels
existed; the kernels keep their operation order and rounding, except that
G1 sums ssq_c and G2 sums Σ se·ex in f64 (the plain versions in f32).

A CPU tensor gets the plain torch version; a CUDA tensor gets the kernel
or an exception — never a fallback.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.posterior import PosteriorState, logpro_constants, refine_varying_max
from ..core.posterior import merge_block as merge_state
from . import _build

F32 = torch.float32
F64 = torch.float64
I32 = torch.int32
I64 = torch.int64


# ---------------------------------------------------------------------------
# G1: the block constants
# ---------------------------------------------------------------------------

G1_THREADS = 512  # csrc/posterior_glue.cu kG1Threads
G1_MIN_CHUNK = 32  # columns a CTA takes at least
# shared memory for one staging pass: per column its O + C rows raw (f32 re,
# im) and in f64, and its h
G1_STAGE_BYTES = 160 * 1024


class ConstantsPlan(NamedTuple):
    """How G1 splits one block over the card (``csrc/posterior_glue.cu``)."""

    grid: int  # CTAs, at most one per SM
    chunk: int  # columns of the N·F half spectrum per CTA
    sub: int  # columns staged in shared memory per pass
    workers: int  # the last CTAs to arrive, which finish the pairs
    per_worker: int  # pairs each worker finishes
    ws_doubles: int  # workspace: grid·O·C partials, then 2·I per-image values


def constants_plan(o: int, c: int, i: int, n: int, f: int, n_sm: int) -> ConstantsPlan:
    """G1's plan for (O, C, I) at an (N, F) half spectrum on a card of
    ``n_sm`` SMs: chunks of at least :data:`G1_MIN_CHUNK` columns, one CTA
    per SM at most; staging passes that keep the O + C rows, raw and in
    f64, within :data:`G1_STAGE_BYTES`; workers that each finish about one (o, c, i)
    entry per thread, no more of them than CTAs. Raises ValueError where
    one column of the O + C rows does not fit."""
    if min(o, c, n, f, n_sm) < 1 or i < 0:
        raise ValueError(f"block_constants: no plan for O={o}, C={c}, I={i}, N={n}, F={f}, "
                         f"{n_sm} SMs")
    nf, p = n * f, o * c
    chunk = max(G1_MIN_CHUNK, -(-nf // n_sm))
    grid = -(-nf // chunk)
    sub = min(chunk, G1_STAGE_BYTES // (16 * (o + c) + 8))
    if sub < 1:
        raise ValueError(f"block_constants: a column of O + C = {o + c} rows does not fit "
                         f"{G1_STAGE_BYTES} bytes of shared memory")
    per_worker = min(max(G1_THREADS // max(i, 1), 1), p)
    workers = -(-p // per_worker)
    if workers > grid:
        per_worker = -(-p // grid)
        workers = -(-p // per_worker)
    return ConstantsPlan(grid, chunk, sub, workers, per_worker, grid * p + 2 * i)


class ConstantsWorkspace(NamedTuple):
    """G1's scratch for one block shape on one card: the f64 partials and
    per-image values, and the ticket, a count of G1's CTAs that have
    arrived since it was made (plan.grid per launch, never reset, so that a
    captured step replays with no memset). One G1 at a time may use it: an
    engine (each mesh slot) holds its own."""

    shape: tuple  # (O, C, I, N, F)
    plan: ConstantsPlan
    ws: torch.Tensor  # (plan.ws_doubles,) f64
    ticket: torch.Tensor  # (1,) i64, 0 when made


def constants_workspace(o: int, c: int, i: int, n: int, f: int, device) -> ConstantsWorkspace:
    """A :class:`ConstantsWorkspace` for (O, C, I, N, F) on the card
    ``device``, planned for its SMs."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"block_constants: a workspace lies on the card, not on {dev}")
    n_sm = torch.cuda.get_device_properties(dev).multi_processor_count
    plan = constants_plan(o, c, i, n, f, n_sm)
    return ConstantsWorkspace((o, c, i, n, f), plan,
                              torch.empty(max(plan.ws_doubles, 1), dtype=F64, device=dev),
                              torch.zeros(1, dtype=I64, device=dev))


def convolution_sums_plain(pr, pi, ctf_re, ctf_im, h, *, ntot):
    """(sum_c, ssq_c), each (O, C) f32, without materialising conv:
    |conv|² = |proj|²·|ctf|², so ssqC[o,c] = (|proj|²·h) @ |ctf|²ᵀ / ntot,
    and sumC = conv's DC term."""
    o, c = pr.shape[0], ctf_re.shape[0]
    mag_p = (pr * pr + pi * pi) * h[None, None, :]
    mag_c = ctf_re**2 + ctf_im**2
    ssq_c = torch.matmul(mag_p.reshape(o, -1), mag_c.reshape(c, -1).T) / float(ntot)
    sum_c = pr[:, 0, 0, None] * ctf_re[None, :, 0, 0] + pi[:, 0, 0, None] * ctf_im[None, :, 0, 0]
    return sum_c, ssq_c


def constants_from_sums(sum_c, ssq_c, sum_ref, ssq_ref, prior, mask, *, ntot,
                        images_normalized: bool):
    """(f0, k, a_u, b_u) from the convolution sums: F0 and K (O, C, I) f64
    (``logpro_constants``; K −inf where ``mask`` is 0), and the u
    coefficients u(cc) = a_u·cc − b_u·cc², (O·C, I) f32 each, the division
    by F0 hoisted out of the comparison's displacement loop."""
    o, c = sum_c.shape
    f0, k = logpro_constants(sum_c, ssq_c, sum_ref, ssq_ref, prior[None, :].expand(o, c), ntot,
                             images_normalized=images_normalized)
    k = torch.where(mask[:, None, None] != 0, k, torch.full_like(k, -torch.inf))
    f0_32 = f0.to(F32)
    a_u = (2.0 * sum_ref[None, None, :] * sum_c[:, :, None] / f0_32).to(F32)
    b_u = float(np.float32(ntot)) / f0_32
    return f0, k, a_u.reshape(o * c, -1), b_u.reshape(o * c, -1)


def block_constants_plain(pr, pi, ctf_re, ctf_im, h, sum_ref, ssq_ref, prior, mask, *, ntot,
                          images_normalized: bool):
    """Plain torch version of :func:`block_constants`."""
    sum_c, ssq_c = convolution_sums_plain(pr, pi, ctf_re, ctf_im, h, ntot=ntot)
    return (sum_c, ssq_c, *constants_from_sums(sum_c, ssq_c, sum_ref, ssq_ref, prior, mask,
                                               ntot=ntot, images_normalized=images_normalized))


def block_constants(
    pr: torch.Tensor,  # (O, N, F) f32 — projection spectra
    pi: torch.Tensor,
    ctf_re: torch.Tensor,  # (C, N, F) f32 — CTF/PSF kernel bank
    ctf_im: torch.Tensor,
    h: torch.Tensor,  # (F,) f32 — Hermitian column weights
    sum_ref: torch.Tensor,  # (I,) f32
    ssq_ref: torch.Tensor,  # (I,) f32
    prior: torch.Tensor,  # (C,) f64 — the CTF prior term
    mask: torch.Tensor,  # (O,) i32 — the block's live orientations
    *,
    ntot: float,
    images_normalized: bool,  # logpro_constants' branch (the hybrid's DC-capable F0 if False)
    workspace: Optional[ConstantsWorkspace] = None,  # on the card; None: one for this call
):
    """G1: (sum_c, ssq_c, f0, k, a_u, b_u) of one orientation block —
    (O, C) f32 ×2, (O, C, I) f64 ×2 (k −inf for masked orientations),
    (O·C, I) f32 ×2. On the card the kernel uses ``workspace``, which must
    have been made for these shapes on this card and be used by no other
    launch at the same time."""
    fn = "block_constants"
    args = (pr, pi, ctf_re, ctf_im, h, sum_ref, ssq_ref, prior, mask)
    if pr.device.type == "cpu":
        return block_constants_plain(*args, ntot=ntot, images_normalized=images_normalized)
    outs, ptrs = constants_call(fn, args, ntot, images_normalized, workspace)
    with torch.cuda.device(pr.device):
        status = _build.load().bioem_block_constants(*ptrs)
    _build.check(status, fn)
    block_constants.launches += 1
    return outs


def check_workspace(fn: str, workspace: ConstantsWorkspace, dims: tuple, dev) -> None:
    """Raise ValueError unless ``workspace`` was made for ``dims`` (O, C, I,
    N, F) on ``dev``."""
    if workspace.shape != dims or workspace.ws.device != dev:
        raise ValueError(f"{fn}: the workspace was made for (O, C, I, N, F) = {workspace.shape} "
                         f"on {workspace.ws.device}, not {dims} on {dev}")


def constants_call(fn: str, args: tuple, ntot: float, images_normalized: bool,
                   workspace: Optional[ConstantsWorkspace] = None):
    """What a G1 launch takes, checked: (the six outputs, the C entry
    point's arguments: the nine inputs' pointers, the dimensions and
    scalars, the plan and ``workspace``'s pointers (None: one made for this
    call), the outputs' pointers and the stream). Raises ValueError on a
    tensor or a workspace G1 does not take."""
    pr, pi, ctf_re, ctf_im, h, sum_ref, ssq_ref, prior, mask = args
    dev = pr.device
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    o_n, n, f = pr.shape
    c_n, i_n = ctf_re.shape[0], sum_ref.shape[0]
    _build.check_tensors(fn, dev, [
        ("pr", pr, F32, (o_n, n, f)), ("pi", pi, F32, (o_n, n, f)),
        ("ctf_re", ctf_re, F32, (c_n, n, f)), ("ctf_im", ctf_im, F32, (c_n, n, f)),
        ("h", h, F32, (f,)), ("sum_ref", sum_ref, F32, (i_n,)), ("ssq_ref", ssq_ref, F32, (i_n,)),
        ("prior", prior, F64, (c_n,)), ("mask", mask, I32, (o_n,)),
    ])
    sums = torch.empty((2, o_n, c_n), dtype=F32, device=dev)
    consts = torch.empty((2, o_n, c_n, i_n), dtype=F64, device=dev)
    coefs = torch.empty((2, o_n * c_n, i_n), dtype=F32, device=dev)
    outs = (sums[0], sums[1], consts[0], consts[1], coefs[0], coefs[1])
    if workspace is None:
        workspace = constants_workspace(o_n, c_n, i_n, n, f, dev)
    check_workspace(fn, workspace, (o_n, c_n, i_n, n, f), dev)
    ptrs = (*(t.data_ptr() for t in args), o_n, c_n, i_n, n, f, float(ntot),
            math.log(float(ntot)), int(bool(images_normalized)), *workspace.plan[:5],
            workspace.ws.data_ptr(), workspace.ticket.data_ptr(),
            *(t.data_ptr() for t in outs), torch.cuda.current_stream(dev).cuda_stream)
    return outs, ptrs


block_constants.launches = 0


# ---------------------------------------------------------------------------
# G2: the max repair and the streaming merge
# ---------------------------------------------------------------------------

def merge_block_plain(state: PosteriorState, m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp,
                      orient_offset, *, ntot, ang_offset=None,
                      m_out: Optional[torch.Tensor] = None) -> PosteriorState:
    """Plain torch version of :func:`merge_block`."""
    if m is None:
        m = refine_varying_max(ccs, sum_c, sum_ref, f0, ntot)
    if m_out is not None:
        m_out.copy_(m)
    return merge_state(state, m, se, ds, ccs, k, sum_c, ssq_c, sum_ref, disp, orient_offset,
                       ntot, disp.shape[0], ang_offset=ang_offset)


def _offset(fn: str, name: str, off, dev) -> torch.Tensor:
    """An orientation offset as a 0-d int64 tensor on ``dev`` (an int is
    filled in on the card; a 0-d integer tensor, such as the one a captured
    block step advances, is read by the kernel where it lies)."""
    if not torch.is_tensor(off):
        return torch.full((), int(off), dtype=I64, device=dev)
    if off.device != dev or off.dim() != 0 or off.dtype not in (I32, I64):
        raise ValueError(f"{fn}: {name} must be an int or a 0-d integer tensor on {dev}, "
                         f"got {off.dtype} {tuple(off.shape)} on {off.device}")
    return off.to(I64)


def merge_block(
    state: PosteriorState,  # updated in place
    m: Optional[torch.Tensor],  # (O, C, I) f32 varying max; None: repair from ccs
    se: torch.Tensor,  # (O, C, I) f32 — Σ exp(v − max) over the lattice
    ds: torch.Tensor,  # (O, C, I) i32 — flat argmax displacement d·D + e
    ccs: torch.Tensor,  # (O, C, I) f32 — cc at the argmax
    k: torch.Tensor,  # (O, C, I) f64 — K, −inf for masked orientations
    f0: torch.Tensor,  # (O, C, I) f64
    sum_c: torch.Tensor,  # (O, C) f32
    ssq_c: torch.Tensor,  # (O, C) f32
    sum_ref: torch.Tensor,  # (I,) f32
    disp: torch.Tensor,  # (D,) i32 signed displacements in sweep order
    orient_offset,  # global index of the block's first orientation: int or 0-d tensor
    *,
    ntot: float,
    ang_offset=None,  # its first column in the per-angle slabs (None: orient_offset)
    m_out: Optional[torch.Tensor] = None,  # (O, C, I) f64: receives the varying max used
) -> PosteriorState:
    """G2: fold one block into ``state`` in place and return it — with
    ``m`` None (the f32-u comparisons: K1, K4 and the normalised hybrid)
    first repair the varying max in f64 from the argmax cc
    (``refine_varying_max``); the given f32 ``m`` is a DC-dominated
    bank's. The semantics of ``core.posterior.merge_block``:
    first-occurrence argmax over the flat o·C + c index, the state's tuple
    replaced on a strict ``>``, masked (−inf − −inf) lanes contributing 0,
    a fully masked block leaving the state as it was; per-angle slabs at
    columns ang_offset + o. An int slab offset whose block does not fit
    the slab raises, as the plain version's ``index_copy_`` does; a 0-d
    device offset cannot be checked without a host synchronisation, so one
    out of range is the caller's fault (the kernel writes no column
    outside the slab)."""
    fn = "merge_block"
    if se.device.type == "cpu":
        return merge_block_plain(state, m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp,
                                 orient_offset, ntot=ntot, ang_offset=ang_offset, m_out=m_out)
    ptrs, _offsets = merge_call(fn, state, m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp,
                                orient_offset, ntot=ntot, ang_offset=ang_offset, m_out=m_out)
    with torch.cuda.device(se.device):
        status = _build.load().bioem_merge_block(*ptrs)
    _build.check(status, fn)
    merge_block.launches += 1
    return state


# the kernel keeps logmax and se per pair and the lattice in shared memory
MERGE_SMEM_MAX = 227 * 1024


def merge_call(fn: str, state, m, se, ds, ccs, k, f0, sum_c, ssq_c, sum_ref, disp,
               orient_offset, *, ntot, ang_offset=None, m_out=None) -> tuple:
    """The C entry point's arguments of a G2 launch, checked (see
    :func:`merge_block`), and the offset tensors they point into (to be
    held until the launch): raises ValueError on a tensor G2 does not take
    and IndexError on an int slab offset outside the slab."""
    dev = se.device
    o_n, c_n, i_n = se.shape
    d = disp.shape[0]
    if o_n * c_n * 12 + d * 4 > MERGE_SMEM_MAX:
        raise ValueError(f"{fn}: O·C = {o_n * c_n} pairs and D = {d} do not fit the kernel's "
                         f"{MERGE_SMEM_MAX} bytes of shared memory")
    if dev.type != "cuda":
        raise ValueError(f"{fn}: unsupported device {dev}")
    specs = [
        ("se", se, F32, (o_n, c_n, i_n)), ("ds", ds, I32, (o_n, c_n, i_n)),
        ("ccs", ccs, F32, (o_n, c_n, i_n)), ("k", k, F64, (o_n, c_n, i_n)),
        ("f0", f0, F64, (o_n, c_n, i_n)), ("sum_c", sum_c, F32, (o_n, c_n)),
        ("ssq_c", ssq_c, F32, (o_n, c_n)), ("sum_ref", sum_ref, F32, (i_n,)),
        ("disp", disp, I32, (d,)),
        ("state.total", state.total, F64, (i_n,)), ("state.const", state.const, F64, (i_n,)),
        ("state.best_orient", state.best_orient, I32, (i_n,)),
        ("state.best_conv", state.best_conv, I32, (i_n,)),
        ("state.best_cent_x", state.best_cent_x, I32, (i_n,)),
        ("state.best_cent_y", state.best_cent_y, I32, (i_n,)),
        ("state.best_norm", state.best_norm, F64, (i_n,)),
        ("state.best_mu", state.best_mu, F64, (i_n,)),
    ]
    if m is not None:
        specs.append(("m", m, F32, (o_n, c_n, i_n)))
    if m_out is not None:
        specs.append(("m_out", m_out, F64, (o_n, c_n, i_n)))
    n_cols = 0
    if state.ang_total is not None:
        n_cols = state.ang_total.shape[1]
        specs += [("state.ang_total", state.ang_total, F64, (i_n, n_cols)),
                  ("state.ang_const", state.ang_const, F64, (i_n, n_cols))]
    _build.check_tensors(fn, dev, specs)
    col = orient_offset if ang_offset is None else ang_offset
    if n_cols and not torch.is_tensor(col) and not 0 <= int(col) <= n_cols - o_n:
        raise IndexError(f"{fn}: the block's slab columns {int(col)}..{int(col) + o_n - 1} "
                         f"lie outside the slab's {n_cols}")
    off = _offset(fn, "orient_offset", orient_offset, dev)
    ang = off if ang_offset is None else _offset(fn, "ang_offset", ang_offset, dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    return (ptr(m), se.data_ptr(), ds.data_ptr(), ccs.data_ptr(), k.data_ptr(), f0.data_ptr(),
            sum_c.data_ptr(), ssq_c.data_ptr(), sum_ref.data_ptr(), disp.data_ptr(),
            off.data_ptr(), ang.data_ptr(), o_n, c_n, i_n, d, n_cols, float(ntot),
            *(ptr(t) for t in state[:8]), ptr(state.ang_total), ptr(state.ang_const),
            ptr(m_out), torch.cuda.current_stream(dev).cuda_stream), (off, ang)


merge_block.launches = 0

"""Operations, bytes and peaks: the least time one H100 could take for the
work of a pass, counted from the problem's shapes alone.

Frozen copies of the program's arithmetic (``tools/problem.py``: ``PEAK``,
``HBM_BYTES_PER_S``, ``bound``, ``compare_work``, ``compare_bytes``,
``compare_bound``, ``prologue_bound``), with K2's group product and the
f64 glue counted beside them, so that a change to the program cannot move
the yardstick. Nothing here looks at which kernel ran: the comparison's
first stage is counted at 3xTF32 on the tensor cores and the rest in f32
whatever runs it, so the bound stays when a kernel is removed or fused.
"""

from __future__ import annotations

# Published dense peaks of one H100 SXM (NVIDIA's data sheet) and its
# memory rate.
PEAK = {"f32": 67e12, "tf32": 495e12, "bf16": 989e12, "f64": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound(ops: dict, nbytes: float) -> float:
    """Seconds: the larger of the operations over the peak of their type
    (``ops`` = {type: count}, summed) and the bytes over HBM's rate."""
    return max(sum(n / PEAK[ty] for ty, n in ops.items()), nbytes / HBM_BYTES_PER_S)


def compare_work(o, c, i, n, f, d, m, n_fold) -> dict:
    """Useful f32 operations of the comparisons of O orientations × C CTFs ×
    I images: stage 1 (t1 = wx·p, 8·D·M·F per comparison) and the rest:
    conv = proj ⊙ conj(ctf) once per (o, c), p = conv ⊙ img (6·N·F), its
    fold, stage 2 (4·D²·F) and the log-sum-exp (8 per lattice point)."""
    cmp = o * c * i
    stage1 = 8 * d * m * f * cmp
    rest = 6 * o * c * n * f + cmp * (6 * n * f + 2 * (n_fold - 1) * m * f + 4 * d * d * f + 8 * d * d)
    return {"stage1": stage1, "rest": rest}


def compare_bytes(o, c, i, n, f, d, m) -> int:
    """The projection, CTF and image spectra, the lattice weights and
    a_u/b_u read once, the four (O·C, I) outputs written once."""
    return 4 * (2 * (o + c + i) * n * f + 2 * d * m + 2 * d * f + 2 * o * c * i + 4 * o * c * i)


def compare_bound(o, c, i, n, f, d, m, n_fold) -> float:
    w = compare_work(o, c, i, n, f, d, m, n_fold)
    return bound({"tf32": 3 * w["stage1"], "f32": w["rest"]}, compare_bytes(o, c, i, n, f, d, m))


def projection_bound(o, n, f, p, g) -> float:
    """The Fourier projection of O orientations of a P-point model in G
    radius groups: the prologue (~20 f32 and 2 f64 operations per point
    and orientation: rotation, snap, reach, tempden) and K2's group product
    (8 per point and frequency, three TF32 passes) with the stencil
    epilogue (8 f32 per group and frequency); the angles and the model
    read once, the stencil spectra read once, the spectra written once."""
    ops = {"tf32": 3 * 8 * p * n * f * o, "f32": 20 * o * p + 8 * g * o * n * f, "f64": 2 * o * p}
    return bound(ops, 16 * o + 20 * p + 4 * g + 8 * g * n * f + 8 * o * n * f)


def glue_bound(o, c, i, n, f) -> float:
    """The posterior glue in f64: the convolution's sum of squares (4 per
    frequency of each (o, c)), the block constants and the merge (~22 per
    comparison); the CTF and projection spectra read once, the per-image
    state written once."""
    return bound({"f64": 4 * o * c * n * f + 22 * o * c * i}, 8 * (o + c) * n * f + 48 * i)


def pass_shapes(prob) -> dict:
    """The shapes that the counts take, from the problem: orientations,
    CTFs, images, N, F, the lattice's D, the fold (the stride when it
    divides N and every displacement) and M = N/fold, model points and
    distinct radii."""
    import numpy as np

    from .registry import reference

    cfg = prob.cfg
    ref = reference(cfg)
    n = cfg["n_pixels"]
    disp = ref.displacements(cfg)
    s = cfg["grid_space_center"]
    fold = s if s > 1 and n % s == 0 and bool((disp % s == 0).all()) else 1
    model = prob.models[0]
    return dict(o=prob.quats.shape[0], c=ref.ctf_grid(cfg).amp.shape[0], i=prob.images.shape[0],
                n=n, f=n // 2 + 1, d=disp.shape[0], m=n // fold, fold=fold,
                p=model.points.shape[0], g=int(np.unique(model.radii).size))


def pass_bounds(prob) -> dict:
    """Seconds of each part's bound for one pass, and their sum."""
    s = pass_shapes(prob)
    out = {"compare": compare_bound(s["o"], s["c"], s["i"], s["n"], s["f"], s["d"], s["m"], s["fold"]),
           "projection": projection_bound(s["o"], s["n"], s["f"], s["p"], s["g"]),
           "glue": glue_bound(s["o"], s["c"], s["i"], s["n"], s["f"])}
    out["pass"] = sum(out.values())
    return out

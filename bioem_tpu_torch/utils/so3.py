"""Uniform SO(3) quaternion sample lists.

The port's copy of ``bioem_tpu.utils.so3`` (NumPy only; it writes the same
bytes): ``python -m bioem_tpu_torch.utils.so3 N out``.

The reference ships pre-tabulated uniform-SO(3) quaternion lists (its
Quaternions/ directory: 576 / 4608 / 36864 rows, format: count header +
4 × %12.6f columns, doc/index.rst:663-673) for use with
``--ReadOrientation`` + ``USE_QUATERNIONS``. Rather than shipping data
files, this module *generates* lists of any size with the Super-Fibonacci
spiral construction (Alexa, CVPR 2022) — a low-discrepancy, deterministic
covering of SO(3) that matches or beats the tabulated grids in uniformity —
and writes them in the reference's file format.
"""

from __future__ import annotations

import math

import numpy as np

# Super-Fibonacci constants (Alexa 2022): φ = √2, ψ the positive root of
# ψ⁴ = ψ + 4.
_PHI = math.sqrt(2.0)
_PSI = 1.533751168755204288118041


def super_fibonacci(n: int) -> np.ndarray:
    """(n, 4) float64 unit quaternions covering SO(3) near-uniformly."""
    if n < 1:
        raise ValueError("need n >= 1 orientations")
    i = np.arange(n, dtype=np.float64)
    s = i + 0.5
    t = s / n
    d = 2.0 * math.pi * s
    r = np.sqrt(t)
    big_r = np.sqrt(1.0 - t)
    alpha = d / _PHI
    beta = d / _PSI
    q = np.stack(
        [r * np.sin(alpha), r * np.cos(alpha), big_r * np.sin(beta), big_r * np.cos(beta)],
        axis=1,
    )
    return q


def write_quaternion_list(path: str, q: np.ndarray) -> None:
    """Reference list format: count line, then 4 fixed-width %12.6f columns
    (parsed by param.cpp:1213-1327 / bioem_tpu_torch.core.orientations)."""
    with open(path, "w") as f:
        f.write(f"{q.shape[0]:12d}\n")
        for row in q:
            f.write("".join(f"{v:12.6f}" for v in row) + "\n")


def make_quaternion_list(path: str, n: int) -> np.ndarray:
    q = super_fibonacci(n)
    write_quaternion_list(path, q)
    return q


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="Generate a uniform SO(3) quaternion list "
        "(reference Quaternions/ equivalent)"
    )
    ap.add_argument("n", type=int, help="number of orientations (e.g. 576, 4608, 36864)")
    ap.add_argument("output", help="output list file")
    args = ap.parse_args(argv)
    make_quaternion_list(args.output, args.n)
    print(f"Wrote {args.n} quaternions to {args.output}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Particle-image readers: text, MRC stack, multiple MRC, binary dump.

Equivalent of reference ``map.cpp``.
MRC images are normalised per image to zero mean / unit population σ unless
NO_MAP_NORM (map.cpp:830-845, 918-931); text images are taken as stored.
"""

from __future__ import annotations

import re
import struct
from dataclasses import dataclass

import numpy as np

from ..defs import FILE_MAPS_DUMP
from .mrc import read_mrc_data, read_mrc_header


@dataclass
class ImageStack:
    """Particle images (reference ``bioem_RefMap``, map.h:30-115).

    maps[i] is an (N, N) float32 array indexed [x, y] like the reference's
    ``maps[iMap·N² + i·N + j]``.
    """

    maps: np.ndarray  # (I, N, N) float32

    @property
    def n(self) -> int:
        return self.maps.shape[0]


def _normalize_stack(stack: np.ndarray) -> np.ndarray:
    """Zero-mean, unit population-σ per image (map.cpp:830-845).

    Matches the reference order of operations: σ = sqrt(E[x²] − mean²),
    map ← map/σ − mean/σ.
    """
    flat = stack.reshape(stack.shape[0], -1).astype(np.float64)
    mean = flat.mean(axis=1)
    sig = np.sqrt((flat**2).mean(axis=1) - mean * mean)
    out = stack / sig[:, None, None].astype(np.float32) - (mean / sig)[
        :, None, None
    ].astype(np.float32)
    return out.astype(np.float32)


def read_text_maps(path: str, n_pixels: int) -> ImageStack:
    """PARTICLE-separated text format ``%8d%8d%16.8f`` (map.cpp:268-518).

    Text maps are *not* normalised (parity with the reference, which only
    normalises MRC input).
    """
    with open(path) as f:
        content = f.read()
    if not content.startswith("PARTICLE"):
        raise ValueError("Missing correct standard map format: PARTICLE HEADER")
    blocks = content.split("PARTICLE")[1:]
    n_img = len(blocks)
    maps = np.zeros((n_img, n_pixels, n_pixels), np.float32)
    for b, blk in enumerate(blocks):
        lines = blk.splitlines()
        # First line is the remainder of the PARTICLE header line.
        rows = [ln for ln in lines[1:] if ln.strip()]
        if len(rows) != n_pixels * n_pixels:
            raise ValueError(
                f"Inconsistent number of pixels in maps and inputfile "
                f"({len(rows)}, map {b})"
            )
        arr = np.array(
            [(int(r[0:8]), int(r[8:16]), float(r[16:32])) for r in rows],
            dtype=np.float64,
        )
        i = arr[:, 0].astype(np.int64)
        j = arr[:, 1].astype(np.int64)
        if (i < 0).any() or (i >= n_pixels).any() or (j < 0).any() or (j >= n_pixels).any():
            raise ValueError(f"Reading map (Map number {b})")
        maps[b, i, j] = arr[:, 2].astype(np.float32)
    return ImageStack(maps)


def read_mrc_maps(path: str, n_pixels: int, normalize: bool = True) -> ImageStack:
    """Single MRC stack (map.cpp:663-853).

    The reference reads the file sequentially into ``maps[i·N + j]`` with j
    (row) outer and i (column) inner — i.e. the stored map is the transpose
    of the file section. Reproduced here via a transpose.
    """
    hdr = read_mrc_header(path)
    if hdr.nr != n_pixels or hdr.nc != n_pixels:
        raise ValueError(
            f"Inconsistent number of pixels in maps and inputfile "
            f"({n_pixels}, i {hdr.nc}, j {hdr.nr})"
        )
    data = read_mrc_data(path, hdr)  # (ns, nr, nc) file order
    stack = np.ascontiguousarray(np.transpose(data, (0, 2, 1)))  # maps[i, j] = file[j, i]
    if normalize:
        stack = _normalize_stack(stack)
    return ImageStack(stack)


def read_multi_mrc_maps(listfile: str, n_pixels: int, normalize: bool = True) -> ImageStack:
    """Multiple MRC files named in a list file (map.cpp:81-193).

    Lines starting with ``XXX`` terminate the list, as in the reference.
    """
    stacks = []
    with open(listfile) as f:
        for line in f:
            name = line.strip()
            if not name:
                continue
            if name.startswith("XXX"):
                break
            stacks.append(read_mrc_maps(name, n_pixels, normalize=normalize).maps)
    if not stacks:
        raise ValueError(f"No MRC files listed in {listfile}")
    return ImageStack(np.concatenate(stacks, axis=0))


def read_maps_dump(n_pixels: int, path: str = FILE_MAPS_DUMP) -> ImageStack:
    """Binary dump (map.cpp:44-78): ntot (i32) then float32 maps."""
    with open(path, "rb") as f:
        (ntot,) = struct.unpack("<i", f.read(4))
        maps = np.fromfile(f, dtype="<f4", count=ntot * n_pixels * n_pixels)
    return ImageStack(maps.reshape(ntot, n_pixels, n_pixels).astype(np.float32))


def write_maps_dump(stack: ImageStack, path: str = FILE_MAPS_DUMP) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<i", stack.n))
        stack.maps.astype("<f4").tofile(f)


def read_ref_maps(
    path: str,
    n_pixels: int,
    *,
    read_mrc: bool = False,
    read_mult_mrc: bool = False,
    load_dump: bool = False,
    dump: bool = False,
    normalize: bool = True,
    debug_nmaps: int = 0,
) -> ImageStack:
    """Dispatch matching reference readRefMaps (map.cpp:520-555)."""
    if read_mult_mrc and not read_mrc:
        raise ValueError("For multiple MRCs command --ReadMRC is necessary too")
    if load_dump:
        s = read_maps_dump(n_pixels, path=FILE_MAPS_DUMP)
    elif read_mrc and read_mult_mrc:
        s = read_multi_mrc_maps(path, n_pixels, normalize=normalize)
    elif read_mrc:
        s = read_mrc_maps(path, n_pixels, normalize=normalize)
    else:
        s = read_text_maps(path, n_pixels)
    if dump:
        write_maps_dump(s)
    if debug_nmaps:
        s = ImageStack(s.maps[:debug_nmaps])
    return s

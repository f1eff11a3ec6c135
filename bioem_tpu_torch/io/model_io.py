"""Structural-model readers: text, PDB (Cα), MRC voxel model, binary dump.

Equivalent of reference ``model.cpp``.
Parsing is vectorised NumPy over an mmap'd buffer (the reference's
OpenMP-parallel parsing, model.cpp:114-243, is replaced by NumPy bulk
parsing).
"""

from __future__ import annotations

import struct
import warnings
from dataclasses import dataclass

import numpy as np

from ..defs import FILE_MODEL_DUMP
from .mrc import read_mrc_data, read_mrc_header

# Amino-acid radius [Å] table (reference model.cpp:738-790).
AA_RADIUS = {
    "CYS": 2.75, "PHE": 3.2, "LEU": 3.1, "TRP": 3.4, "VAL": 2.95,
    "ILE": 3.1, "MET": 3.1, "HIS": 3.05, "TYR": 3.25, "ALA": 2.5,
    "GLY": 2.25, "PRO": 2.8, "ASN": 2.85, "THR": 2.8, "SER": 2.6,
    "ARG": 3.3, "GLN": 3.0, "ASP": 2.8, "LYS": 3.2, "GLU": 2.95,
}

# Electron-count table (reference model.cpp:792-844).
AA_DENSITY = {
    "CYS": 64.0, "PHE": 88.0, "LEU": 72.0, "TRP": 108.0, "VAL": 64.0,
    "ILE": 72.0, "MET": 80.0, "HIS": 82.0, "TYR": 96.0, "ALA": 48.0,
    "GLY": 40.0, "PRO": 62.0, "ASN": 66.0, "THR": 64.0, "SER": 56.0,
    "ARG": 93.0, "GLN": 78.0, "ASP": 59.0, "LYS": 79.0, "GLU": 53.0,
}


@dataclass
class Model:
    """Point-cloud model (reference ``bioem_model``, model.h:30-60)."""

    points: np.ndarray  # (P, 3) float32
    radii: np.ndarray  # (P,) float32
    densities: np.ndarray  # (P,) float32
    norm_den: float  # total electron count (NormDen)

    @property
    def n_points(self) -> int:
        return self.points.shape[0]

    def center_density_mass(self) -> "Model":
        """Shift to the density-weighted centre (model.cpp:604-672)."""
        cm = (self.points * self.densities[:, None]).sum(axis=0) / np.float32(self.norm_den)
        return Model(
            (self.points - cm).astype(np.float32), self.radii, self.densities, self.norm_den
        )


def read_text_model(path: str, ignore_pdb: bool = False) -> Model:
    """x y z radius density whitespace format (model.cpp:419-601)."""
    if ".pdb" in path and not ignore_pdb:
        raise ValueError(
            f"PDB detected in file name: {path}. Are you sure you do not need "
            "--ReadPDB? If so include the keyword IGNORE_PDB in inputfile"
        )
    data = np.loadtxt(path, dtype=np.float64, ndmin=2)
    if data.shape[1] < 5:
        raise ValueError(f"Model file {path} needs 5 columns: x y z radius density")
    if (data[:, 3] < 0).any():
        raise ValueError("Radius must be positive")
    dens = data[:, 4].astype(np.float32)
    return Model(
        data[:, :3].astype(np.float32),
        data[:, 3].astype(np.float32),
        dens,
        float(np.float64(dens.astype(np.float64).sum())),
    )


def read_pdb_model(path: str) -> Model:
    """Cα atoms with residue radius/electron-count lookup (model.cpp:85-329).

    Column layout follows the PDB fixed-width spec used by the reference:
    record 1-6, atom name 13-16, resName 18-20, x/y/z at 31-54.
    """
    if ".pdb" not in path:
        warnings.warn(
            f"PDB extension NOT detected in file name: {path}. "
            "Are you sure you want to read a PDB?"
        )
    pts, radii, dens = [], [], []
    with open(path) as f:
        for line in f:
            if not line.startswith("ATOM"):
                continue
            name = line[12:16].strip()
            if name != "CA":
                continue
            res = line[17:20].strip()
            if res not in AA_RADIUS:
                raise ValueError(f"Amino acid: {res}")
            x = float(line[30:38])
            y = float(line[38:46])
            z = float(line[46:54])
            pts.append((x, y, z))
            radii.append(AA_RADIUS[res])
            dens.append(AA_DENSITY[res])
    if not pts:
        raise ValueError(f"No CA atoms found in PDB {path}")
    d = np.asarray(dens, np.float32)
    return Model(
        np.asarray(pts, np.float32),
        np.asarray(radii, np.float32),
        d,
        float(d.astype(np.float64).sum()),
    )


def read_mrc_model(path: str, pixel_size: float) -> Model:
    """Voxel model from MRC: every voxel becomes a sphere of radius
    2·pixelSize centred at ((i−nx/2)·pix, …) with the voxel value as
    density — including the reference's 1-based voxel indexing
    (model.cpp:378-403)."""
    if ".mrc" not in path:
        warnings.warn(
            f"MRC extension NOT detected in file name: {path}. "
            "Are you sure you want to read an MRC?"
        )
    hdr = read_mrc_header(path)
    data = read_mrc_data(path, hdr)  # (ns, nr, nc) in file order
    nx, ny, nz = hdr.nc, hdr.nr, hdr.ns
    # Reference loops i(1..nx) outer, j(1..ny), k(1..nz) inner reading
    # sequentially — i.e. the file's fastest axis maps to k (z).
    vals = data.reshape(-1)  # sequential file order
    i = np.repeat(np.arange(1, nx + 1), ny * nz)
    j = np.tile(np.repeat(np.arange(1, ny + 1), nz), nx)
    k = np.tile(np.arange(1, nz + 1), nx * ny)
    pts = np.stack(
        [
            (i - nx / 2.0) * pixel_size,
            (j - ny / 2.0) * pixel_size,
            (k - nz / 2.0) * pixel_size,
        ],
        axis=1,
    ).astype(np.float32)
    dens = vals.astype(np.float32)
    radii = np.full(vals.shape, 2.0 * pixel_size, np.float32)
    return Model(pts, radii, dens, float(dens.astype(np.float64).sum()))


def read_model_dump(path: str = FILE_MODEL_DUMP) -> Model:
    """Binary dump (model.cpp:41-82): NormDen (f32), nPoints (i32), then
    per-point {pos[3], quat4, radius, density} float32 records matching the
    reference's bioem_model_point layout."""
    with open(path, "rb") as f:
        (norm_den,) = struct.unpack("<f", f.read(4))
        (n,) = struct.unpack("<i", f.read(4))
        rec = np.fromfile(f, dtype="<f4", count=n * 6).reshape(n, 6)
    return Model(rec[:, 0:3].copy(), rec[:, 4].copy(), rec[:, 5].copy(), float(norm_den))


def write_model_dump(m: Model, path: str = FILE_MODEL_DUMP) -> None:
    rec = np.zeros((m.n_points, 6), dtype="<f4")
    rec[:, 0:3] = m.points
    rec[:, 4] = m.radii
    rec[:, 5] = m.densities
    with open(path, "wb") as f:
        f.write(struct.pack("<f", np.float32(m.norm_den)))
        f.write(struct.pack("<i", m.n_points))
        rec.tofile(f)


def read_model(
    path: str,
    *,
    read_pdb: bool = False,
    read_mrc: bool = False,
    load_dump: bool = False,
    dump: bool = False,
    pixel_size: float = 1.0,
    ignore_pdb: bool = False,
    center_mass: bool = True,
) -> Model:
    """Dispatch matching reference readModel (model.cpp:674-710)."""
    if load_dump:
        m = read_model_dump()
    elif read_pdb:
        m = read_pdb_model(path)
    elif read_mrc:
        m = read_mrc_model(path, pixel_size)
    else:
        m = read_text_model(path, ignore_pdb=ignore_pdb)
    if dump:
        write_model_dump(m)
    if center_mass:
        m = m.center_density_mass()
    return m


def write_coordread(m: Model, path: str = "COORDREAD") -> None:
    """Model-coordinate echo file (reference model.cpp:712-736)."""
    with open(path, "w") as f:
        f.write(
            "Text --- Number ---- x ---- y ---- z ---- radius ---- number of electron\n"
        )
        for k in range(m.n_points):
            f.write(
                f"RESIDUE {k} {m.points[k,0]:g} {m.points[k,1]:g} {m.points[k,2]:g} "
                f"{m.radii[k]:g} {m.densities[k]:g}\n"
            )

"""One engine scores one particle set against a density map, as BioEM does
with ``--ReadModelMRC``: the configuration's map (its reference's
``voxel_map`` of the problem's residue model) is written as a mode-2 MRC
file in a temporary directory and read back through the program's own
reader (``io.model_io.read_model(path, read_mrc=True, pixel_size=...)``,
the CLI's path), then scored pass after pass as ``repeat_pass`` does.

First it asks the program's path rule (``core.projection
.choose_projection``) for the map's projection, and stops unless it is the
raster: a program without the rule, or one that would run the map through
the Fourier projection (hours a pass), fails here, before any pass.

Set-up is the read, the program's own entry (``run.maybe_autotune``,
``run.make_engine``) and one pass, which captures the block step on the
card; each pass of the window is ``eng.run()``, a synchronise and
``eng.results()``.
"""

from __future__ import annotations

import os
import struct
import tempfile
import time

import numpy as np

from benchmark.port import Session, inputs
from benchmark.registry import reference


def write_mrc(path: str, vol: np.ndarray, pixel_size: float) -> None:
    """A mode-2 (float32) MRC file of ``vol`` (ns, nr, nc), little-endian,
    its data in C order after the 1024-byte header."""
    vol = np.ascontiguousarray(vol, dtype="<f4")
    ns, nr, nc = vol.shape
    head = bytearray(1024)
    struct.pack_into("<10i", head, 0, nc, nr, ns, 2, 0, 0, 0, nc, nr, ns)
    struct.pack_into("<6f", head, 40, nc * pixel_size, nr * pixel_size, ns * pixel_size,
                     90.0, 90.0, 90.0)
    struct.pack_into("<3i", head, 64, 1, 2, 3)
    struct.pack_into("<3f", head, 76, float(vol.min()), float(vol.max()), float(vol.mean()))
    head[208:212] = b"MAP "
    struct.pack_into("<4B", head, 212, 0x44, 0x44, 0, 0)
    with open(path, "wb") as f:
        f.write(bytes(head))
        f.write(vol.tobytes())


class MapRepeatPass(Session):
    def __init__(self, prob, device, run):
        from bioem_tpu_torch.core.projection import choose_projection
        from bioem_tpu_torch.config import RunConfig
        from bioem_tpu_torch.io.model_io import read_model
        from bioem_tpu_torch.run import make_engine, maybe_autotune

        super().__init__(run, device)
        p, orients, _residues, images = inputs(prob)
        vol = reference(prob.cfg).voxel_map(prob.cfg, prob.models[0])
        with tempfile.TemporaryDirectory() as work:
            path = os.path.join(work, "map.mrc")
            write_mrc(path, vol, prob.cfg["pixel_size"])
            del vol
            model = read_model(path, read_mrc=True, pixel_size=prob.cfg["pixel_size"])
        cfg = RunConfig()
        path_taken = choose_projection(p, [model], cfg.projection)
        if path_taken != "raster":
            raise RuntimeError(f"the program's path rule takes the {path_taken} projection for a "
                               f"map of {model.n_points} voxels; this cell runs the raster")
        cfg = maybe_autotune(p, orients, model, images, cfg, device=self.device)
        t0 = time.perf_counter()
        self.eng = make_engine(p, orients, model, images, cfg, device=self.device)
        run.engine_build_s = time.perf_counter() - t0
        run.first_pass_s = self.scored(0)

    def one_pass(self):
        self.run.pass_s.append(self.scored(0))


def start(prob, mix, device, run):
    from bioem_tpu_torch.core.projection import choose_projection  # noqa: F401  (the rule first)

    return MapRepeatPass(prob, device, run)

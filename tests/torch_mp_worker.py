"""Worker process of the port's multi-process tests (tests/test_torch_multihost.py).

Each worker is one process of a two-process run (the analogue of one MPI
rank of the reference): it joins the gloo group through
``bioem_tpu_torch.parallel.distributed.initialize`` (the test sets the
BIOEM_TPU_COORDINATOR/_NUM_PROCESSES/_PROCESS_ID names), builds the same
seed-made tiny problem as every other process, runs it on a global 2×2
(images × orientations) mesh with two CPU slots per process, and process 0
writes the results to an npz. It imports the port only, never JAX.

    python tests/torch_mp_worker.py OUT.npz MODE [CHECKPOINT]

MODE: ``run``, or ``stream`` (2 chunks of 2 images, each process reading
only the rows its slots own); ``single-run`` and ``single-stream`` run the
same in one process with four CPU slots: the references the two-process
runs must equal bit for bit.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

FIELDS = ("log_prob", "best_orient", "best_conv", "best_cent_x", "best_cent_y",
          "best_norm", "best_mu", "angle_log")


def build_tiny_problem():
    """tests/mp_worker.py's problem (conftest's tiny_* at seed 1234) in the
    port's own types."""
    from bioem_tpu_torch.core.orientations import build_orientations
    from bioem_tpu_torch.io.map_io import ImageStack
    from bioem_tpu_torch.io.model_io import Model
    from bioem_tpu_torch.params import BioEMParams

    rng = np.random.default_rng(1234)
    p = BioEMParams(
        pixel_size=1.5, n_pixels=16, n_amp=1, start_amp=0.1, end_amp=0.1, n_phase=2,
        start_defocus=0.5, end_defocus=1.5, n_env=2, start_bfactor=1.0, end_bfactor=100.0,
        max_displace_center=2, grid_space_center=1, grid_points_alpha=2,
        grid_points_beta=2, write_angles=3,
    ).finalize_ctf_mode()
    pts = rng.uniform(-6.0, 6.0, size=(12, 3)).astype(np.float32)
    radii = rng.uniform(1.0, 3.2, size=12).astype(np.float32)
    dens = rng.uniform(40.0, 100.0, size=12).astype(np.float32)
    model = Model(pts, radii, dens, float(dens.astype(np.float64).sum()))
    maps = rng.normal(0.0, 1.0, size=(4, 16, 16)).astype(np.float32)
    flat = maps.reshape(4, -1).astype(np.float64)
    mean = flat.mean(axis=1)
    sig = np.sqrt((flat**2).mean(axis=1) - mean**2)
    maps = (maps / sig[:, None, None] - (mean / sig)[:, None, None]).astype(np.float32)
    return p, build_orientations(p), model, ImageStack(maps)


def main():
    out_path, mode = sys.argv[1], sys.argv[2]
    ckpt = sys.argv[3] if len(sys.argv) > 3 else ""
    torch.set_num_threads(1)
    single = mode.startswith("single-")
    mode = mode.removeprefix("single-")

    from bioem_tpu_torch.config import RunConfig
    from bioem_tpu_torch.parallel import distributed
    from bioem_tpu_torch.parallel.mesh import ShardedBioEMEngine, make_bioem_mesh

    if not single:
        distributed.initialize(timeout_s=60)
        assert distributed.process_count() == 2, distributed.process_count()
    n_local = 4 // distributed.process_count()
    p, orients, model, images = build_tiny_problem()
    cfg = RunConfig(orient_block=2, mesh_images=2, mesh_orient=2, checkpoint_path=ckpt,
                    checkpoint_every=1 if ckpt else 0)
    mesh = make_bioem_mesh(2, 2, devices=["cpu"] * n_local)
    assert len(mesh.local()) == n_local
    if mode == "stream":
        from bioem_tpu_torch.stream import ArraySource, run_streaming

        reads = []

        class RecordingSource(ArraySource):
            def chunk(self, start, stop):
                reads.append((start, stop))
                return super().chunk(start, stop)

        res, perf = run_streaming(p, orients, model, RecordingSource(images.maps), cfg,
                                  chunk_images=2, device="cpu", mesh=mesh)
        assert perf["chunks"] == 2, perf
        if distributed.process_index() == 1:
            # process 1's slots hold only padding rows of chunk 2 (the two
            # real rows shard onto process 0's slots), so it reads at most
            # one placeholder row of it, never the whole chunk
            later = [(a, b) for a, b in reads if a >= 2]
            assert sum(b - a for a, b in later) <= 1, reads
    else:
        eng = ShardedBioEMEngine(p, orients, model, images, cfg, mesh=mesh)
        res = eng.results(eng.run())
    if distributed.process_index() == 0:
        np.savez(out_path, **{f: getattr(res, f) for f in FIELDS})
    distributed.shutdown()


if __name__ == "__main__":
    main()

"""Multi-model discrimination: rank candidate models against one particle set.

PyTorch counterpart of ``bioem_tpu.rank``. Automates the reference's
MODEL_COMPARISON workflow (reference doc/index.rst:2290-2521): there, each
candidate model is a separate BioEM invocation and the user compares the
resulting ``Output_Probabilities`` by summing per-image log-posteriors.
Here one command ranks N models against one particle set, reusing the
image FFT bank, the orientation grid and, on the card's kernel branch, the
one captured block step across models:

    python -m bioem_tpu_torch.rank --Inputfile param.txt --Particlesfile p.mrc \\
        --ReadMRC --Modelfile m1.txt --Modelfile m2.txt [...]

Output: per-model total log-posterior (the model-selection evidence,
doc/index.rst:205-232: ln P(m1|data) − ln P(m2|data) = Σ_ω Δ ln P), a
normalised posterior over models, and each image's best model. The run
takes the card; ``BIOEM_TPU_FORCE_CPU=1`` asks for the CPU
(config.resolve_device).
"""

from __future__ import annotations

import argparse
import sys
import time
from typing import List, Sequence

import numpy as np

from .config import RunConfig, resolve_device
from .core.orientations import build_orientations
from .core.projection import choose_projection, lattice_axes
from .io.map_io import read_ref_maps
from .io.model_io import read_model
from .params import read_parameters


def common_model_layout(p, models: Sequence, projection: str = "auto") -> dict:
    """Model-array padding shared by all candidates, so one engine (and its
    captured block step) serves every model through swap_model — no re-FFT
    of the image bank, no second capture per candidate."""
    lay = {"n_points_pad": max(m.points.shape[0] for m in models)}
    if choose_projection(p, models, projection) == "fourier":
        g_max = pp_max = 0
        for m in models:
            uniq, inverse = np.unique(np.asarray(m.radii, np.float32), return_inverse=True)
            counts = np.bincount(inverse, minlength=uniq.size)
            g_max = max(g_max, int(uniq.size))
            pp_max = max(pp_max, -(-int(counts.max()) // 8) * 8)
        lay["n_groups_pad"] = g_max
        lay["group_pad"] = pp_max
    else:
        if projection != "raster":
            # The path rule chose the raster for the set (one continuous-radius
            # model, or a Fourier projection far dearer): ALL models take it
            # (one engine runs one projection path).
            lay["force_raster"] = True
        # The raster's lattice variant only where every model is a voxel
        # lattice (core.projection.lattice_axes) of one shape and radius:
        # a map ranked beside a perturbed copy takes the generic walk.
        found = set()
        for m in models:
            lat = lattice_axes(m.points, m.radii, p.pixel_size)
            found.add(None if lat is None else (lat[1], float(np.float32(m.radii[0]))))
        lay["lattice"] = len(found) == 1 and None not in found
    sph = 0
    for m in models:
        large = m.radii > p.pixel_size
        if large.any():
            sph = max(sph, int((large * (m.radii / p.pixel_size)).max()) + 1)
    lay["stencil_half"] = sph
    return lay


def rank_models(p, orients, models: Sequence, images, cfg=None, names=None, device=None,
                mesh=None):
    """Returns (total_logp[m], per_image_logp[m, i], perf) for each model.

    The engine (image FFT bank, CTF bank, orientation blocks, captured
    step) is built once; each candidate swaps only its model arrays in,
    padded to a common layout, with its own per-group point counts (the
    projection kernel reads those slots). ``perf["captures"]`` is the
    engine's captures of its block step: one on the card's kernel branch,
    whatever the number of models; ``perf["results"]`` each model's
    Results (its argmax tuples). With ``cfg.mesh_images × cfg.mesh_orient
    > 1`` every candidate runs on the mesh (``mesh``: its slots, as in
    run.make_engine), each slot copying the model and its counts into its
    own graph's banks."""
    from .run import make_engine

    cfg = cfg or RunConfig()
    layout = common_model_layout(p, models, cfg.projection)
    eng = make_engine(p, orients, models[0], images, cfg, device=device, model_layout=layout,
                      mesh=mesh)
    per_image = []
    perf_all = {"run_s": 0.0, "comparisons": 0, "results": []}
    for m, model in enumerate(models):
        banks = eng.banks if m == 0 else eng.swap_model(model)
        ckpt = f"{cfg.checkpoint_path}.model{m}" if cfg.checkpoint_path else None
        t0 = time.perf_counter()
        results = eng.results(eng.run(banks=banks, bank_tag=f"model:{m}", checkpoint_path=ckpt))
        perf_all["run_s"] += time.perf_counter() - t0
        perf_all["comparisons"] += eng.n_img * eng.n_orient * eng.n_ctf
        per_image.append(results.log_prob)
        perf_all["results"].append(results)
    perf_all["captures"] = eng.captures
    per_image = np.stack(per_image)  # (M, I)
    total = per_image.sum(axis=1)
    return total, per_image, perf_all


def format_ranking(total: np.ndarray, per_image: np.ndarray, names: List[str]) -> str:
    order = np.argsort(-total)
    lines = ["MODEL RANKING (total ln P, higher = better):"]
    # Posterior over models assuming equal priors: softmax of totals.
    shifted = total - total.max()
    post = np.exp(shifted) / np.exp(shifted).sum()
    for rank, m in enumerate(order):
        delta = total[m] - total[order[0]]
        lines.append(
            f"  #{rank + 1} {names[m]}: lnP_total = {total[m]:.4f} "
            f"(Δ vs best = {delta:.4f}, posterior = {post[m]:.3e})"
        )
    best_per_img = np.argmax(per_image, axis=0)
    counts = np.bincount(best_per_img, minlength=len(names))
    lines.append("Per-image best-model counts: " + ", ".join(
        f"{names[m]}: {counts[m]}" for m in range(len(names))
    ))
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="bioem_tpu_torch.rank",
        description="Rank candidate structural models against one particle set",
    )
    ap.add_argument("--Modelfile", action="append", required=True,
                    help="candidate model (repeatable)")
    ap.add_argument("--Particlesfile", required=True)
    ap.add_argument("--Inputfile", required=True)
    ap.add_argument("--ReadOrientation")
    ap.add_argument("--ReadPDB", action="store_true")
    ap.add_argument("--ReadModelMRC", action="store_true")
    ap.add_argument("--ReadMRC", action="store_true")
    ap.add_argument("--ReadMultipleMRC", action="store_true")
    ap.add_argument("--OutputFile", default="Model_Ranking")
    args = ap.parse_args(argv)

    from .parallel.distributed import initialize, process_index

    initialize()  # a multi-process run, when one is configured
    device = resolve_device()  # the card, or the CPU when asked; else raise
    cfg = RunConfig.from_env()
    p = read_parameters(args.Inputfile, not_uniform_angles=args.ReadOrientation is not None)
    images = read_ref_maps(
        args.Particlesfile, p.n_pixels, read_mrc=args.ReadMRC,
        read_mult_mrc=args.ReadMultipleMRC, normalize=not p.no_map_norm,
        debug_nmaps=cfg.debug_nmaps,
    )
    orients = build_orientations(p, args.ReadOrientation)
    models = [
        read_model(
            mf, read_pdb=args.ReadPDB, read_mrc=args.ReadModelMRC,
            pixel_size=p.pixel_size, ignore_pdb=p.ignore_pdb,
            center_mass=not p.no_center_mass,
        )
        for mf in args.Modelfile
    ]
    t0 = time.perf_counter()
    total, per_image, perf = rank_models(p, orients, models, images, cfg, device=device)
    report = format_ranking(total, per_image, args.Modelfile)
    print(report)
    print(f"Total time: {time.perf_counter() - t0:.2f}s "
          f"({perf['comparisons'] / max(perf['run_s'], 1e-9):.3e} comparisons/s)")
    if process_index() != 0:  # process 0 writes
        return 0
    with open(args.OutputFile, "w") as f:
        f.write(report + "\n")
        f.write("\nPer-image ln P:\n")
        for i in range(per_image.shape[1]):
            row = " ".join(f"{per_image[m, i]:.4f}" for m in range(len(models)))
            f.write(f"RefMap: {i} {row}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

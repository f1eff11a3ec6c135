"""Command-line interface with the reference's flag surface.

PyTorch counterpart of ``bioem_tpu.cli`` (reference ``main.cpp`` +
``bioem::readOptions``, main.cpp:57-134, bioem.cpp:142-436). The parser is
the JAX package's, flag for flag, so existing BioEM invocations work:

    python -m bioem_tpu_torch.cli --Modelfile m.txt --Particlesfile p.txt \
        --Inputfile params.txt [--ReadOrientation quat.txt] [...]

Performance env vars (BIOEM_DEBUG_*, BIOEM_TPU_*) are honoured via
RunConfig.from_env. The parts of the JAX CLI that are not ported yet
(--PrintBestCalMap, --Refine*, a device mesh, checkpointing, DEBUG_PROB
dumps) raise NotImplementedError instead of running something else.
"""

from __future__ import annotations

import argparse
import sys
import time

from . import defs
from .config import RunConfig, not_ported_env
from .params import read_parameters
from .io.map_io import read_ref_maps
from .io.model_io import read_model, write_coordread
from .io.output import write_angle_probabilities, write_probabilities


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        prog="bioem_tpu_torch",
        description="Bayesian inference of Electron Microscopy images (PyTorch/CUDA)",
        add_help=False,
    )
    # Option table mirrors reference bioem.cpp:193-224.
    ap.add_argument("--Modelfile", metavar="arg", help="(Mandatory) Name of model file")
    ap.add_argument(
        "--Particlesfile", metavar="arg", help="(Mandatory) Name of particle-image file"
    )
    ap.add_argument(
        "--Inputfile", metavar="arg", help="(Mandatory) Name of input parameter file"
    )
    ap.add_argument(
        "--PrintBestCalMap",
        metavar="arg",
        help="(Optional) Only print best calculated map. NO BioEM!",
    )
    ap.add_argument(
        "--ReadOrientation",
        metavar="arg",
        help="(Optional) Read file name containing orientations",
    )
    ap.add_argument(
        "--ReadPDB", action="store_true", help="(Optional) If reading model file in PDB format"
    )
    ap.add_argument(
        "--ReadModelMRC",
        action="store_true",
        help="(Optional) If reading model file in MRC format",
    )
    ap.add_argument(
        "--ReadMRC", action="store_true", help="(Optional) If reading particle file in MRC format"
    )
    ap.add_argument(
        "--ReadMultipleMRC", action="store_true", help="(Optional) If reading multiple MRCs"
    )
    ap.add_argument(
        "--DumpMaps",
        action="store_true",
        help="(Optional) Dump maps after they were read from particle-image file",
    )
    ap.add_argument(
        "--LoadMapDump", action="store_true", help="(Optional) Read maps from dump option"
    )
    ap.add_argument(
        "--DumpModel",
        action="store_true",
        help="(Optional) Dump model after it was read from model file",
    )
    ap.add_argument(
        "--LoadModelDump", action="store_true", help="(Optional) Read model from dump option"
    )
    ap.add_argument(
        "--PrintCOORDREAD", action="store_true", help="(Optional) Print model coordinates"
    )
    ap.add_argument(
        "--OutputFile",
        metavar="arg",
        default=defs.DEFAULT_OUTPUT_FILE,
        help="(Optional) For changing the outputfile name",
    )
    ap.add_argument(
        "--Refine",
        action="store_true",
        help="(Optional, no reference analogue) Continuously refine each "
        "image's maximizing parameters off-grid by autodiff Newton ascent; "
        "writes Output_Refined",
    )
    ap.add_argument(
        "--RefineCTF",
        action="store_true",
        help="(Optional) With --Refine: also refine the CTF phase/envelope",
    )
    ap.add_argument(
        "--RefineCTFAmp",
        action="store_true",
        help="(Optional) With --Refine: also refine the CTF amplitude "
        "(clamped to (0,1) against the Gaussian amp prior)",
    )
    ap.add_argument("--help", action="help", help="(Optional) Produce help message")
    return ap


def write_rotated_models(model, orients, out) -> None:
    """PRINT_ROTATED_MODELS debug output (reference bioem.cpp:1695-1702):
    'ROTATED iOrient iPoint x y z' per rotated model point."""
    import torch

    from .core.orientations import rotation_matrices

    rotms = rotation_matrices(
        torch.as_tensor(orients.angles), orients.use_quaternions
    ).numpy()
    for imap in range(orients.n):
        rot = model.points @ rotms[imap].T
        for k in range(model.n_points):
            out.write(
                f"ROTATED {imap} {k} {rot[k, 0]:g} {rot[k, 1]:g} {rot[k, 2]:g}\n"
            )


def _refuse_not_ported(args) -> None:
    what = []
    if args.PrintBestCalMap:
        what.append("--PrintBestCalMap (the forward simulator)")
    if args.Refine or args.RefineCTF or args.RefineCTFAmp:
        what.append("--Refine/--RefineCTF/--RefineCTFAmp (continuous refinement)")
    what += not_ported_env()
    if what:
        raise NotImplementedError(
            "not yet ported to bioem_tpu_torch: " + "; ".join(what)
            + " — run the JAX package (python -m bioem_tpu.cli) for these"
        )


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    cfg = RunConfig.from_env()
    _refuse_not_ported(args)

    if args.ReadMultipleMRC and not args.ReadMRC:
        print("Error - For multiple MRCs command --ReadMRC is necessary too")
        return 1

    for req in ("Modelfile", "Particlesfile", "Inputfile"):
        if getattr(args, req) is None:
            print("Error - Need to specify all mandatory options")
            build_parser().print_help()
            return 1

    t0 = time.perf_counter()
    p = read_parameters(args.Inputfile, not_uniform_angles=args.ReadOrientation is not None)

    images = read_ref_maps(
        args.Particlesfile,
        p.n_pixels,
        read_mrc=args.ReadMRC,
        read_mult_mrc=args.ReadMultipleMRC,
        load_dump=args.LoadMapDump,
        dump=args.DumpMaps,
        normalize=not p.no_map_norm,
        debug_nmaps=cfg.debug_nmaps,
    )
    print(f"Total Number of particles: {images.n}")

    model = read_model(
        args.Modelfile,
        read_pdb=args.ReadPDB,
        read_mrc=args.ReadModelMRC,
        load_dump=args.LoadModelDump,
        dump=args.DumpModel,
        pixel_size=p.pixel_size,
        ignore_pdb=p.ignore_pdb,
        center_mass=not p.no_center_mass,
    )
    print(f"Total Number of Voxels {model.n_points}")
    print(f"Total Number of Electrons {model.norm_den:g}")
    if args.PrintCOORDREAD:
        write_coordread(model)

    from .core.orientations import build_orientations

    orients = build_orientations(p, args.ReadOrientation)
    if p.print_rotated_models:
        write_rotated_models(model, orients, sys.stdout)
    if cfg.debug_output >= 1:
        print(f"Setup time: {time.perf_counter() - t0:.2f}s")

    from .run import run_bioem

    results, perf = run_bioem(p, orients, model, images, cfg)
    if cfg.debug_output >= 1:
        print(
            f"Main loop: {perf['run_s']:.3f}s on {perf['device']} "
            f"({perf['comparisons_per_s']:.3e} comparisons/s)"
        )

    with open(args.OutputFile, "w") as f:
        write_probabilities(f, p, orients, results.grid, results)
    if p.write_angles:
        with open(defs.FILE_ANG_PROB, "w") as f:
            write_angle_probabilities(f, p, orients, results)
    return 0


if __name__ == "__main__":
    sys.exit(main())

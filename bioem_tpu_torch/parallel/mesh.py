"""Multi-device execution over a 2-D (images × orientations) mesh.

PyTorch counterpart of ``bioem_tpu.parallel.mesh`` (the reference's MPI
layer, main.cpp:64-68, bioem.cpp:453-503, 748-753, 909-1044):

* the reference's rank-sliced orientation loop → contiguous orientation
  blocks per orientation shard;
* its OpenMP image parallelism → image rows per image shard;
* its end-of-run MPI max/rescale/sum reduction and argmax shipping → one
  host-side log-sum-exp merge per pass (:func:`merge_across_orient`).

A mesh is an (n_img_shards, n_orient_shards) grid of **slots**
(:func:`make_bioem_mesh`), each a ``torch.device`` and the rank of the
process that computes it. :class:`ShardedBioEMEngine` holds one
:class:`~bioem_tpu_torch.core.engine.BioEMEngine` per slot of this process
(``core.engine.Slot``): the slot's padded image rows, its contiguous
orientation blocks, on the slot's device, with its own captured CUDA graph
on the card. The main loop is communication-free, as the reference's: the
slots work independently and the pass ends in one merge.

Local slots run one after another, each queueing its replays on its
device's current stream (slots on separate cards overlap, slots sharing a
card do not); overlapping slots on one card is left for later.

**Checkpoints** differ from the JAX package's single file: each slot
checkpoints its own pre-merge state to ``<path>.slot<i>x<o>`` through its
engine's ``run(checkpoint_path=)``, under a fingerprint that includes the
mesh shape and the slot, and the merge follows the last slot. So a save
needs no collective (each process writes only its own slots' files), and
the JAX chunked runner's stacked pre-merge state (one orientation axis
per shard in one array) is not needed.

Multi-process runs: :func:`bioem_tpu_torch.parallel.distributed.initialize`
first; every process builds the same inputs and its own slots, and the
merge gathers every slot's state over a gloo group, so every process gets
the full state (process 0 writes the outputs, as in the JAX CLI).
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import RunConfig, resolve_device
from ..core.engine import Banks, BioEMEngine, Slot, f32_corr_gate
from ..core.posterior import PosteriorState, init_state
from . import distributed

F64 = torch.float64
# the per-image fields of PosteriorState (the merge's; the rest are the
# per-angle slabs)
IMAGE_FIELDS = ("total", "const", "best_orient", "best_conv", "best_cent_x",
                "best_cent_y", "best_norm", "best_mu")


@dataclass(frozen=True)
class MeshSlot:
    """One cell of the mesh: image shard ``i``, orientation shard ``o``,
    its device and the rank of the process that computes it."""

    i: int
    o: int
    device: torch.device
    rank: int


@dataclass(frozen=True)
class BioEMMesh:
    """An (images × orientations) grid of slots, row-major by rank."""

    slots: tuple  # (n_img_shards,) tuples of (n_orient_shards,) MeshSlot

    @property
    def shape(self) -> tuple:
        return len(self.slots), len(self.slots[0])

    def local(self) -> list:
        """The slots of this process, image-major."""
        me = distributed.process_index()
        return [s for row in self.slots for s in row if s.rank == me]


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def default_devices(device=None) -> Optional[list]:
    """This process's devices for a mesh: on the card, ``cuda:LOCAL_RANK``
    under torchrun, else every visible card (one named card: that one);
    None on the CPU (one slot per needed cell, config.resolve_device picks
    the CPU only when asked)."""
    import os

    dev = resolve_device(device)
    if dev.type != "cuda":
        return None
    if dev.index is not None:
        return [dev]
    if "LOCAL_RANK" in os.environ:
        return [torch.device("cuda", int(os.environ["LOCAL_RANK"]))]
    return [torch.device("cuda", k) for k in range(torch.cuda.device_count())]


def make_bioem_mesh(n_img_shards: int, n_orient_shards: int, devices=None,
                    device=None) -> BioEMMesh:
    """An (n_img_shards × n_orient_shards) mesh over every process's
    devices, concatenated in rank order, so that each process's slots are
    contiguous along the image axis (the JAX package's global mesh).

    ``devices`` is this process's list and may name one device more than
    once: several slots on one card (a 2×2 mesh on one H100), or on the
    CPU. Default: :func:`default_devices` of ``device``; on the CPU, as
    many CPU slots as this process's share of the mesh. Too few devices
    across the processes raise ``ValueError``."""
    need = n_img_shards * n_orient_shards
    if n_img_shards < 1 or n_orient_shards < 1:
        raise ValueError(f"mesh {n_img_shards}×{n_orient_shards}: both sides must be ≥ 1")
    if devices is None:
        devices = default_devices(device)
        if devices is None:
            devices = [torch.device("cpu")] * _cdiv(need, distributed.process_count())
    every = distributed.all_gather_object([str(torch.device(d)) for d in devices])
    flat = [(d, r) for r, ds in enumerate(every) for d in ds]
    if len(flat) < need:
        raise ValueError(f"mesh {n_img_shards}×{n_orient_shards} needs {need} devices, "
                         f"have {len(flat)}")
    return BioEMMesh(tuple(
        tuple(MeshSlot(i, o, torch.device(flat[i * n_orient_shards + o][0]),
                       flat[i * n_orient_shards + o][1]) for o in range(n_orient_shards))
        for i in range(n_img_shards)
    ))


def merge_across_orient(parts: list) -> PosteriorState:
    """Merge the pre-merge states of one image shard's slots, in
    orientation-shard order (host tensors), the JAX rule
    (``bioem_tpu.core.posterior.merge_across_orient``, the reference's MPI
    reduction, bioem.cpp:909-1044): const = the max over shards; total =
    Σ total·exp(const − const_max) in f64; the argmax tuple from the
    lowest shard whose const equals the max, so earlier orientations win
    ties as in the sequential loop. The per-angle slabs, one shard's
    columns each, are concatenated."""
    const = torch.stack([s.const for s in parts])  # (S, R)
    const_max = torch.amax(const, dim=0)
    total = parts[0].total * torch.exp(parts[0].const - const_max)
    for s in parts[1:]:
        total = total + s.total * torch.exp(s.const - const_max)
    owner = torch.argmax((const >= const_max).to(torch.int32), dim=0)  # first True

    def pick(name):
        return torch.stack([getattr(s, name) for s in parts]).gather(0, owner[None])[0]

    out = {name: pick(name) for name in IMAGE_FIELDS[2:]}
    ang = {}
    if parts[0].ang_total is not None:
        ang = {name: torch.cat([getattr(s, name) for s in parts], dim=1)
               for name in ("ang_total", "ang_const")}
    return PosteriorState(total=total, const=const_max, **out, **ang)


def _pack(st: PosteriorState) -> torch.Tensor:
    """A slot's host state as one f64 vector (the int32 fields exactly)."""
    parts = [getattr(st, f).to(F64) for f in IMAGE_FIELDS]
    if st.ang_total is not None:
        parts += [st.ang_total.reshape(-1), st.ang_const.reshape(-1)]
    return torch.cat(parts)


def _unpack(v: torch.Tensor, like: PosteriorState) -> PosteriorState:
    out, k = {}, 0
    for f in PosteriorState._fields:
        ref = getattr(like, f)
        if ref is None:
            out[f] = None
            continue
        n = ref.numel()
        out[f] = v[k:k + n].reshape(ref.shape).to(ref.dtype)
        k += n
    return PosteriorState(**out)


class ShardedBioEMEngine:
    """The posterior pass on an (images × orientations) mesh of slots, one
    :class:`BioEMEngine` per local slot, with the single engine's surface:
    ``run(banks=, bank_tag=, checkpoint_path=)`` returns the merged global
    state (host tensors), ``results``, ``swap_images``/``swap_model``/
    ``_place_banks`` (one Banks per local slot), ``time_blocks`` and
    ``owned_image_rows``."""

    def __init__(self, p, orients, model, images, cfg: Optional[RunConfig] = None,
                 mesh: Optional[BioEMMesh] = None, model_layout: Optional[dict] = None,
                 device=None):
        cfg = cfg or RunConfig()
        self.cfg = cfg
        self.mesh = mesh or make_bioem_mesh(cfg.mesh_images, cfg.mesh_orient, device=device)
        self.n_img_shards, self.n_orient_shards = self.mesh.shape
        local = self.mesh.local()
        if not local:
            raise ValueError(f"process {distributed.process_index()} holds no slot of the "
                             f"{self.n_img_shards}×{self.n_orient_shards} mesh")
        # One comparison branch for every slot: the gate over the whole
        # stack (a per-shard gate could split the slots between branches).
        maps = images.maps[: cfg.debug_nmaps] if cfg.debug_nmaps else images.maps
        gate = f32_corr_gate(maps, p)
        self.slots = {
            (s.i, s.o): BioEMEngine(
                p, orients, model, images, cfg, device=s.device, model_layout=model_layout,
                slot=Slot(s.i, s.o, self.n_img_shards, self.n_orient_shards, gate))
            for s in local
        }
        first = next(iter(self.slots.values()))
        for name in ("p", "orients", "grid", "n_img", "n_orient", "n_ctf", "disp", "n_fold",
                     "o_block", "i_block", "n_img_pad", "n_orient_pad", "use_kernels",
                     "fused_lse", "fused_batched", "kernel_projection", "fspec", "spec",
                     "_f32_corr_ok", "device"):
            setattr(self, name, getattr(first, name))
        # host seconds of the last pass: waiting for the slots' cards after
        # every slot's work was queued, then the merge (the copies of the
        # slots' states to the host, the gather across processes, the merge)
        self.wait_s = self.merge_s = 0.0

    results = BioEMEngine.results

    @property
    def banks(self) -> tuple:
        return tuple(e.banks for e in self.slots.values())

    @property
    def captures(self) -> int:
        return sum(e.captures for e in self.slots.values())

    @property
    def n_devices(self) -> int:
        """Distinct devices of the mesh (a device of each process)."""
        return len({(s.rank, s.device) for row in self.mesh.slots for s in row})

    def owned_image_rows(self) -> list:
        """Global [start, stop) ranges of the padded image axis whose slots
        this process computes: the per-process ingest contract (each
        process reads only the images it computes on, as each MPI rank of
        the reference chunks its own images, map.cpp:549)."""
        merged = []
        for a, b in sorted({e.img_rows for e in self.slots.values()}):
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(b, merged[-1][1]))
            else:
                merged.append((a, b))
        return merged

    def image_slots(self, image: int) -> list:
        """(engine, local row) of every orientation shard holding padded
        row ``image``, in orientation order; all must be local."""
        rows = self.n_img_pad // self.n_img_shards
        i = image // rows
        missing = [o for o in range(self.n_orient_shards) if (i, o) not in self.slots]
        if missing:
            raise ValueError(f"image {image}: orientation shards {missing} of its image "
                             "shard run in another process")
        return [(self.slots[(i, o)], image - i * rows) for o in range(self.n_orient_shards)]

    def gathered_banks(self) -> Banks:
        """The first local slot's banks with the image rows of every image
        shard, on its device (refinement's per-image post-pass, in a
        single process)."""
        missing = [i for i in range(self.n_img_shards) if (i, 0) not in self.slots]
        if missing:
            raise ValueError(f"image shards {missing} run in another process")
        parts = [self.slots[(i, 0)].banks for i in range(self.n_img_shards)]
        return parts[0]._replace(**{
            f: torch.cat([getattr(b, f).to(self.device) for b in parts])
            for f in ("img_re", "img_im", "sum_ref", "ssq_ref")
        })

    # ------------------------------------------------------------------
    def _image_arrays(self, maps: np.ndarray) -> list:
        return [e._image_arrays(maps) for e in self.slots.values()]

    def pin_fields(self, fields: list) -> list:
        return [e.pin_fields(f) for e, f in zip(self.slots.values(), fields)]

    def _place_banks(self, fields: list) -> tuple:
        """One Banks per local slot, each on its slot's device."""
        return tuple(e._place_banks(f) for e, f in zip(self.slots.values(), fields))

    def swap_images(self, maps: np.ndarray) -> tuple:
        return self._place_banks(self._image_arrays(maps))

    def swap_model(self, model) -> tuple:
        return tuple(e.swap_model(model) for e in self.slots.values())

    def initial_state(self) -> PosteriorState:
        """The merged global state a pass starts from (host tensors)."""
        return init_state(self.n_img_pad, self.n_orient_pad, self.p.write_angles > 0)

    def time_blocks(self, target_orients: int, repeats: int = 2) -> float:
        """The autotuner's probe: seconds per orientation of the first
        local slot's block loop. Every slot runs the same shapes, so the
        candidates rank as they would on any slot."""
        return next(iter(self.slots.values())).time_blocks(target_orients, repeats)

    def run(self, banks: Optional[tuple] = None, bank_tag: str = "",
            checkpoint_path: Optional[str] = None) -> PosteriorState:
        """One pass: every local slot's ``run`` (checkpointing to
        ``<path>.slot<i>x<o>``), then the merge across orientation shards,
        with the other processes' slots gathered first. Returns the global
        state (host tensors) on every process."""
        banks = self.banks if banks is None else banks
        ckpt = self.cfg.checkpoint_path if checkpoint_path is None else checkpoint_path
        states = {}
        for ((i, o), eng), b in zip(self.slots.items(), banks):
            states[(i, o)] = eng.run(banks=b, bank_tag=bank_tag,
                                     checkpoint_path=f"{ckpt}.slot{i}x{o}" if ckpt else "")
        t0 = time.perf_counter()
        for dev in {e.device for e in self.slots.values() if e.device.type == "cuda"}:
            torch.cuda.synchronize(dev)  # merge_s then times the merge alone
        self.wait_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        host = {k: PosteriorState(*(x.cpu() if x is not None else None for x in st))
                for k, st in states.items()}
        if distributed.process_count() > 1:
            host = self._gather(host)
        rows = [merge_across_orient([host[(i, o)] for o in range(self.n_orient_shards)])
                for i in range(self.n_img_shards)]
        merged = PosteriorState(*(
            torch.cat(f) if f[0] is not None else None for f in zip(*rows)))
        self.merge_s = time.perf_counter() - t0
        return merged

    def _gather(self, host: dict) -> dict:
        """Every slot's host state on every process, bit for bit: each
        process's slots packed into one f64 row per slot (padded to the
        most any process holds), all-gathered over the gloo group."""
        like = next(iter(host.values()))
        per_rank = {}
        for row in self.mesh.slots:
            for s in row:
                per_rank.setdefault(s.rank, []).append((s.i, s.o))
        width = max(len(v) for v in per_rank.values())
        me = distributed.process_index()
        mine = torch.zeros(width, _pack(like).numel(), dtype=F64)
        for k, key in enumerate(per_rank[me]):
            mine[k] = _pack(host[key])
        out = {}
        for r, rows in enumerate(distributed.all_gather_rows(mine)):
            for k, key in enumerate(per_rank.get(r, [])):
                out[key] = _unpack(rows[k], like)
        return out

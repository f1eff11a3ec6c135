"""The port's spans and counters (one recorder per process), their
phase table, and the profiler hook.

PyTorch counterpart of ``bioem_tpu.utils.timestat`` (the reference's
``HighResTimer``/``TimeStat``, timer.cpp:23-165, and its NVTX ranges,
bioem.cpp:53-91). :func:`span` times a region on the host clock into
:data:`RECORDER` (name, start, end, the enclosing span, the id of the
top-level span it belongs to) and, while a ``torch.profiler`` runs, opens
a ``record_function`` range of the same name, so the span lands in the
trace on the card's clock. :func:`count` adds to a named counter. The CLI
prints :meth:`TimeStat.summary` at ``debug_output >= 1``, as the
reference prints its TimeStat table. ``profile_trace`` wraps a region in
``torch.profiler`` and writes a Chrome trace (the NVTX analogue; open it
in Perfetto or chrome://tracing).

Every name starts with ``bioem.``: tools that read a trace tell the
program's ranges from the card's operations by that prefix. The spans
(:func:`traced` makes a whole function one):

* set-up: ``bioem.model.read`` (io/model_io.read_model),
  ``bioem.library`` (ops/_build.load, the kernel library's first
  load in the process; counter ``bioem.library.builds``: nvcc builds),
  ``bioem.autotune`` (run.maybe_autotune), ``bioem.engine`` (the
  engine's construction; ``.images``, ``.model``, ``.banks``; counters
  ``bioem.projection.raster`` and ``.fourier``: the path the rule chose,
  one per model laid out; ``bioem.projection.raster.lattice``: a model laid
  out on the raster's lattice variant, one per model), ``bioem.bounds``
  (the out-of-frame census, also under ``bioem.swap_model.bounds``;
  counter ``bioem.bounds.oob_points``:
  the (orientation, point) pairs dropped out of the frame),
  ``bioem.capture`` (the block step's capture; ``.warmup``, ``.graph``);
* a pass: ``bioem.pass`` (``bioem.graph_load``, ``bioem.checkpoint``),
  ``bioem.results``;
* swaps: ``bioem.swap_model`` (``.bounds``, ``.layout``),
  ``bioem.swap_images`` (``.layout``), and in each ``bioem.place.pin``
  and ``bioem.place.copy``;
* the block step's phases ``bioem.projection``, ``.constants``,
  ``.compare``, ``.merge``: every block of the eager loop (the CPU), and
  on the card only the warm-up step and the capture (a replay runs no
  host code; the replayed phases are the kernels by name).

Memory is bounded: per (name, enclosing span) the recorder keeps a count,
the total and self time (duration minus what child spans cover), the sum
of squares, the first record and the last :data:`KEEP` records. A span
adds no synchronisation and no host read of the card.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import math
import os
import threading
import time
from typing import NamedTuple, Optional

import torch

KEEP = 1024  # records kept per (name, enclosing span), besides the first


class Span(NamedTuple):
    """One closed span: ``parent`` is the enclosing span's name (None at
    the top level), ``root`` the id of the top-level span it belongs to,
    ``start_ns``/``end_ns`` ``time.perf_counter_ns`` readings."""

    name: str
    parent: Optional[str]
    root: int
    start_ns: int
    end_ns: int

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


class _Stat:
    __slots__ = ("n", "total_ns", "self_ns", "sq", "first", "last")

    def __init__(self, keep: int):
        self.n = self.total_ns = self.self_ns = 0
        self.sq = 0.0
        self.first = None
        self.last = collections.deque(maxlen=keep)


class _Open:
    """A span while it is open: the frame on its thread's stack."""

    __slots__ = ("rec", "name", "root", "start", "child_ns", "range")

    def __init__(self, rec: "TimeStat", name: str):
        self.rec = rec
        self.name = name

    def __enter__(self):
        stack = self.rec._stack()
        self.root = stack[-1].root if stack else next(self.rec._roots)
        self.child_ns = 0
        self.range = None
        stack.append(self)
        self.start = time.perf_counter_ns()
        if torch._C._autograd._profiler_enabled():
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        return self

    def __exit__(self, *exc):
        if self.range is not None:
            self.range.__exit__(*exc)
        end = time.perf_counter_ns()
        stack = self.rec._stack()
        stack.pop()
        parent = stack[-1] if stack else None
        dur = end - self.start
        if parent is not None:
            parent.child_ns += dur
        self.rec._record(Span(self.name, parent.name if parent is not None else None,
                              self.root, self.start, end), dur - self.child_ns)
        return False


class TimeStat:
    """A recorder of spans and counters (:data:`RECORDER` is the
    process's). Safe to use from several threads; each thread nests its
    own spans."""

    def __init__(self, keep: int = KEEP):
        self._keep = keep
        self._lock = threading.Lock()
        self._local = threading.local()
        self._roots = itertools.count(1)
        self._stats: dict = {}  # (name, parent) -> _Stat, in order of first record
        self._counts: dict = {}

    # -- recording --------------------------------------------------------
    def span(self, name: str) -> _Open:
        """A context manager timing its body as span ``name``."""
        return _Open(self, name)

    time = span  # the reference's TimeStat name

    def add(self, name: str, seconds: float, parent: Optional[str] = None) -> None:
        """Record a span of ``seconds`` that ended now, under ``parent``
        (a name; None: the top level) and with no children."""
        end = time.perf_counter_ns()
        dur = int(round(seconds * 1e9))
        self._record(Span(name, parent, next(self._roots), end - dur, end), dur)

    def add_count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _record(self, rec: Span, self_ns: int) -> None:
        dur = rec.end_ns - rec.start_ns
        with self._lock:
            st = self._stats.get((rec.name, rec.parent))
            if st is None:
                st = self._stats[(rec.name, rec.parent)] = _Stat(self._keep)
            st.n += 1
            st.total_ns += dur
            st.self_ns += self_ns
            st.sq += (dur * 1e-9) ** 2
            if st.first is None:
                st.first = rec
            st.last.append(rec)

    # -- reading ----------------------------------------------------------
    def _of(self, name: str, parent: Optional[str] = None) -> list:
        with self._lock:
            return [st for (n, p), st in self._stats.items()
                    if n == name and (parent is None or p == parent)]

    def records(self, name: str, parent: Optional[str] = None) -> list:
        """The kept :class:`Span` records of ``name`` (under ``parent``, a
        name, when given; under any otherwise) in the order they closed:
        the last ``keep`` and always the first."""
        stats = self._of(name, parent)
        if not stats:
            return []
        with self._lock:
            recs = sorted((r for st in stats for r in st.last), key=lambda r: r.end_ns)
            first = min((st.first for st in stats), key=lambda r: r.end_ns)
        recs = recs[-self._keep:]
        return recs if recs[0] == first else [first, *recs]

    def durations(self, name: str, parent: Optional[str] = None) -> list:
        """Seconds of the kept spans ``name`` (see :meth:`records`)."""
        return [r.seconds for r in self.records(name, parent)]

    def _by_name(self) -> dict:
        """name -> (n, total ns, self ns, Σ seconds²), in the order the
        names' first spans opened."""
        with self._lock:
            stats = sorted(self._stats.items(), key=lambda kv: kv[1].first.start_ns)
        per = {}
        for (name, _p), st in stats:
            n, tot, self_ns, sq = per.get(name, (0, 0, 0, 0.0))
            per[name] = (n + st.n, tot + st.total_ns, self_ns + st.self_ns, sq + st.sq)
        return per

    def names(self) -> list:
        """Every span name recorded (in the order their first spans
        opened), then every counter name."""
        spans = list(self._by_name())
        with self._lock:
            return spans + [n for n in self._counts if n not in spans]

    def count(self, name: str) -> int:
        """A counter's value, or the number of spans ``name`` recorded."""
        with self._lock:
            if name in self._counts:
                return self._counts[name]
        return sum(st.n for st in self._of(name))

    def self_seconds(self, name: str) -> float:
        """Seconds of the spans ``name`` not covered by their child spans."""
        return sum(st.self_ns for st in self._of(name)) * 1e-9

    def summary(self) -> str:
        """The phase table (reference timer.cpp:156-165): per name its
        total, mean, σ and self seconds and the number of spans, then the
        counters."""
        per = self._by_name()
        with self._lock:
            counts = dict(self._counts)
        lines = ["\tTime statistics:"]
        for name, (n, tot, self_ns, sq) in per.items():
            mean = tot * 1e-9 / n
            sd = math.sqrt(max(sq / n - mean * mean, 0.0))
            lines.append(
                f"\t\t{name:<26} total {tot * 1e-9:10.4f}s  mean {mean:9.5f}s  "
                f"stdev {sd:9.5f}s  self {self_ns * 1e-9:10.4f}s  (n={n})"
            )
        for name, v in counts.items():
            lines.append(f"\t\t{name:<26} count {v}")
        return "\n".join(lines)


RECORDER = TimeStat()


def span(name: str) -> _Open:
    """Time the body as span ``name`` of the process's recorder."""
    return _Open(RECORDER, name)


def traced(name: str):
    """Decorator: every call of the function is span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with _Open(RECORDER, name):
                return fn(*args, **kwargs)

        return call

    return wrap


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process's counter ``name``."""
    RECORDER.add_count(name, n)


@contextlib.contextmanager
def profile_trace(trace_dir: str | None):
    """torch.profiler region (CPU, and CUDA where a card is present) that
    writes ``trace_dir/bioem_trace_<pid>.json``. No-op when empty."""
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(trace_dir, exist_ok=True)
    with profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(trace_dir, f"bioem_trace_{os.getpid()}.json"))

"""Observability: spans, counters, phase timers, roofline accounting and a
trace context.

**Spans.**  :func:`span` names a layer of the program in a
``torch.profiler`` trace.  While a profiler records (the CLI's
``--profile``, or any ``torch.profiler.profile`` around a call) it opens
``torch.profiler.record_function("canopy." + name)``, so the span lands in
the same Chrome trace, on the same clock, as the CUDA kernels, copies and
fills launched inside it.  While none records it costs one check and
enters a shared no-op context; nothing else turns spans on.  Names are
static strings, with no request size or id in them: a span's parent is
the span that contains it on the recording thread, and a request is
identified by its root span.  The spans:

* ``canopy.uncertainty``: one ``engine.uncertainty.uncertainty_analysis``
  call, the root of an uncertainty request.  Its children:
  ``canopy.uncertainty.sample`` (one per batch; inside it
  ``canopy.sample.plan``, the tape's host work before its
  ``draw_standard`` launch: the mission-time read-back, the sample plan,
  the keys and the table), ``canopy.uncertainty.evaluate`` (the top-event
  evaluator on one batch) and ``canopy.uncertainty.statistics`` (the
  tops sorted and reduced on their device to quantiles, median, p95,
  histogram, mean and standard deviation; inside it
  ``canopy.uncertainty.readback``, that summary's copy to the host).
* ``canopy.event_tree``: one ``engine.sequences.sequence_uncertainty``
  call, the root of an event-tree request.  Its children:
  ``canopy.event_tree.sample`` (the tape's draws for every sequence),
  ``canopy.event_tree.evaluate`` (every sequence root on the batch and
  each sequence's product of factors) and ``canopy.event_tree.statistics``
  (every sequence's trials sorted and reduced on their device; inside it
  ``canopy.uncertainty.readback``, the summary of ten numbers a sequence
  copied to the host, as both paths share the reduction).
* ``canopy.event_tree.compile``: ``engine.sequences.compile_event_tree``,
  an event tree's set-up (walk, multi-root compile, point values); inside
  it ``canopy.event_tree.forest``, the attempt at the BDD forest.
* ``canopy.analysis.<phase>``: a phase of ``RiskAnalysis``
  (:class:`PhaseTimer`), named by its report key up to the colon
  (``canopy.analysis.total`` is the root of a whole analysis).
* ``canopy.build``: the CUDA library's compile from source.

A request's host time is its root span less the device's busy time
inside it; each child span names a share of it.

**Counters.**  :data:`COUNTERS` counts where the work happens, traced or
not, one dict increment a site: ``h2d`` and ``h2d_bytes``, ``d2h`` and
``d2h_bytes`` (every explicit host-device copy on the uncertainty and
event-tree paths, through :func:`to_device` and :func:`to_host`),
``trials`` (the trials ``uncertainty_analysis`` evaluated),
``stats_on_device`` (the order-statistics reductions,
``engine.uncertainty.order_statistics``, that ran on a CUDA device: one
an uncertainty evaluation, one an event-tree request), ``sequences`` (the
sequence results ``sequence_uncertainty`` summarized),
``forest_blowups`` (event-tree BDD forests that passed their node limit,
so that direct propagation took over), ``builds`` (compiles of the CUDA
library from source) and ``launch.<kernel>``, each kernel's launches:
``stream`` (forward), ``stream_roots`` (every root of a multi-root
program, one launch an event-tree request on the direct-propagation
path), ``stream_log`` (forward with the value log),
``adjoint`` (backward), the fused whole-tree kernels ``fused_tiled`` and
``fused``, the replay kernels ``replay`` (forward), ``replay_tape``
(forward with the value log) and ``replay_bwd`` (the level backward on a
replay program), the spill kernel ``spill``, the Philox sampler
``bernoulli``, the gather level kernel ``gather``, the block-gather level
kernels ``block_log`` and ``block_direct``, and the threefry sampler
``prng``.  :func:`counters` returns a snapshot of them; two snapshots'
difference counts what ran between them.

**Phases.**  :class:`PhaseTimer` times ``RiskAnalysis``'s phases for the
report's ``<calculation-time>``: each phase a span, ending when the
device's queued work has finished.  A roofline accountant turns (bytes
moved, elements processed, elapsed) into achieved-fraction numbers
against the card's memory rate; :func:`trace` records the analysis with
``torch.profiler`` (CPU and, on a CUDA device, kernel activity) and
writes a Chrome trace plus a table of the slowest operators into a
directory.
"""

from __future__ import annotations

import contextlib
import os
import time

import torch

from ..errors import LogicError

__all__ = ["span", "COUNTERS", "counters", "to_device", "to_host",
           "PhaseTimer", "RooflineAccountant", "trace"]

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """The span ``canopy.<name>`` while a profiler records, else a no-op
    context."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function("canopy." + name)
    return _NO_SPAN


#: Counts by name (module docstring); never reset by the program.
COUNTERS = {"h2d": 0, "h2d_bytes": 0, "d2h": 0, "d2h_bytes": 0,
            "trials": 0, "builds": 0, "stats_on_device": 0,
            "sequences": 0, "forest_blowups": 0,
            **{"launch." + kernel: 0 for kernel in (
                "stream", "stream_roots", "stream_log", "adjoint",
                "fused_tiled", "fused", "replay", "replay_tape",
                "replay_bwd", "spill", "bernoulli", "gather", "block_log",
                "block_direct", "prng")}}


def counters() -> dict[str, int]:
    """A snapshot of :data:`COUNTERS`."""
    return dict(COUNTERS)


def to_device(data, device, dtype=None) -> torch.Tensor:
    """``data`` (a host tensor, array, list or number) as a tensor of
    ``dtype`` on ``device``; a copy out of host memory counts in ``h2d``
    and ``h2d_bytes``."""
    host = torch.as_tensor(data, dtype=dtype)
    device = torch.device(device)
    if host.device.type == "cpu" and device.type != "cpu":
        COUNTERS["h2d"] += 1
        COUNTERS["h2d_bytes"] += host.numel() * host.element_size()
    return host.to(device)


def to_host(tensor: torch.Tensor, out: torch.Tensor | None = None
            ) -> torch.Tensor:
    """``tensor`` in host memory (copied into ``out`` where given, a host
    tensor of its shape); a copy off a device counts in ``d2h`` and
    ``d2h_bytes``."""
    if tensor.device.type != "cpu":
        COUNTERS["d2h"] += 1
        COUNTERS["d2h_bytes"] += tensor.numel() * tensor.element_size()
    return tensor.cpu() if out is None else out.copy_(tensor)


class PhaseTimer:
    """Named phase times in seconds (``times``, in the order the phases
    ended).  A phase on a CUDA ``device`` ends when the device's queued
    work has finished; it starts there too, so it times its own work
    alone."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.times: dict[str, float] = {}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def phase(self, key: str):
        """Time the block under ``key`` (a later phase of the same key
        replaces it), as the span ``canopy.analysis.<key up to ':'>``.
        A block that raises records nothing."""
        with span("analysis." + key.split(":")[0]):
            self._sync()
            start = time.perf_counter()
            yield
            self._sync()
            self.times[key] = time.perf_counter() - start


#: Device-memory bandwidth (bytes/s) by ``torch.cuda.get_device_name()``:
#: NVIDIA's data sheet for the H100 SXM (80 GB HBM3).
HBM_BANDWIDTH = {"NVIDIA H100 80GB HBM3": 3.35e12}


class RooflineAccountant:
    """Tracks kernel throughput against the card's memory roofline.

    ``bandwidth`` (bytes/s) overrides the table; otherwise ``card``
    (default: ``torch.cuda.get_device_name()``) must be one of
    :data:`HBM_BANDWIDTH`'s cards, and an unknown card raises.
    """

    def __init__(self, card: str | None = None,
                 bandwidth: float | None = None):
        if bandwidth is None:
            if card is None:
                if not torch.cuda.is_available():
                    raise LogicError("RooflineAccountant: no CUDA card, and "
                                     "no bandwidth given")
                card = torch.cuda.get_device_name()
            if card not in HBM_BANDWIDTH:
                raise LogicError(f"RooflineAccountant: no memory rate known "
                                 f"for {card!r}; pass bandwidth=")
            bandwidth = HBM_BANDWIDTH[card]
        self.bandwidth = float(bandwidth)
        self.records: list[dict] = []

    def record(self, name: str, elements: int, bytes_per_element: float,
               seconds: float) -> dict:
        ideal = elements * bytes_per_element / self.bandwidth
        entry = {
            "kernel": name,
            "elements": elements,
            "seconds": seconds,
            "elements_per_s": elements / seconds if seconds else 0.0,
            "hbm_fraction": ideal / seconds if seconds else 0.0,
        }
        self.records.append(entry)
        return entry

    def report(self) -> list[dict]:
        return list(self.records)


@contextlib.contextmanager
def trace(log_dir: str | None, cuda: bool = False):
    """`torch.profiler` trace context (no-op when log_dir is None).

    Writes ``trace.json`` (Chrome trace format) and ``ops.txt`` (the
    operator table by total time) into ``log_dir``; ``cuda`` adds the
    device activity.
    """
    if log_dir is None:
        yield
        return
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if cuda:
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    sort_by = "cuda_time_total" if cuda else "cpu_time_total"
    with open(os.path.join(log_dir, "ops.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by=sort_by, row_limit=40))

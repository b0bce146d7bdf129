"""Process-group initialization, the collectives of the mesh steps, and
failure-tolerant sweeps.

The JAX package's ``parallel/distributed.py`` on ``torch.distributed``:

* :func:`initialize` — ``init_process_group`` from explicit arguments or
  from torchrun's environment; NCCL on ``cuda``, gloo on ``cpu``; a no-op
  for a single process with no address.
* The collectives (:func:`all_reduce`, :func:`all_gather`,
  :func:`broadcast`, :func:`shift`) — every collective of ``parallel/``
  goes through them, and they count the bytes each one moves
  (``COLLECTIVE_BYTES``).  Several ranks sharing one card cannot use
  NCCL, so they run gloo, which takes CUDA tensors for its reductions,
  gathers and broadcasts but reads host memory in its point-to-point
  ops: under gloo :func:`shift` copies CUDA tensors through the host, on
  purpose (``HOST_ROUTED``, logged once per process).  That is the
  transport, not a move of the computation: the kernels still run on
  the card.
* :func:`run_resilient` — a checkpointed sweep (``engine/checkpoint.py``)
  restarted after *retryable* failures only.
"""

from __future__ import annotations

import datetime
import logging
import os
import time
import warnings

import torch
import torch.distributed as dist

from .._device import resolve_device

__all__ = ["initialize", "run_resilient", "all_reduce", "all_gather",
           "broadcast", "shift", "COLLECTIVE_BYTES", "HOST_ROUTED",
           "reset_collective_counts", "RETRYABLE"]

_log = logging.getLogger(__name__)

#: Payload bytes this process handed to each collective (the input
#: tensor's bytes per call; a gather's output is ``world`` times that).
COLLECTIVE_BYTES: dict[str, int] = {}
#: Collectives that copied CUDA tensors through host memory, and why.
HOST_ROUTED: dict[str, str] = {}

#: The errors a restart can cure: the rendezvous store, the network, the
#: communication backend.  Everything else (out-of-memory included) is a
#: property of the work and would fail again.
RETRYABLE = (dist.DistError,)


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, device="cuda",
               backend: str | None = None,
               timeout: float | None = None) -> None:
    """Initialize the default process group (no-op when single-process).

    With no arguments and torchrun's ``WORLD_SIZE``/``RANK``/
    ``MASTER_ADDR`` in the environment, the group forms from them.
    ``coordinator_address`` is ``host:port`` (TCP rendezvous) or any
    ``init_method`` URL (``file://...`` for tests).  The backend is NCCL
    on ``cuda`` and gloo on ``cpu`` unless ``backend`` names one (gloo
    puts several ranks on one card, which NCCL refuses).  ``timeout``
    (seconds) bounds every collective: a lost rank fails the step instead
    of hanging it.
    """
    device = resolve_device(device)
    if dist.is_initialized():
        return
    kwargs = {}
    if timeout is not None:
        kwargs["timeout"] = datetime.timedelta(seconds=timeout)
    backend = backend or ("nccl" if device.type == "cuda" else "gloo")
    if coordinator_address is None and num_processes is None and \
            int(os.environ.get("WORLD_SIZE", "1")) > 1:
        _set_cuda_device(device, int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group(backend, init_method="env://", **kwargs)
        return
    if num_processes in (None, 1) and coordinator_address is None:
        return  # Single-process: nothing to coordinate.
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    _set_cuda_device(device, process_id or 0)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=num_processes or 1,
                            rank=process_id or 0, **kwargs)


def _set_cuda_device(device: torch.device, local_rank: int) -> None:
    if device.type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())


def reset_collective_counts() -> None:
    COLLECTIVE_BYTES.clear()


def _count(name: str, tensor: torch.Tensor) -> None:
    COLLECTIVE_BYTES[name] = COLLECTIVE_BYTES.get(name, 0) + \
        tensor.numel() * tensor.element_size()


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """In-place sum over ``group``; returns ``tensor``."""
    _count("all_reduce", tensor)
    dist.all_reduce(tensor, group=group)
    return tensor


def all_gather(local: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``local`` (equal shapes) stacked along dim 0 in group
    rank order."""
    local = local.contiguous()
    _count("all_gather", local)
    out = local.new_empty((dist.get_world_size(group) * local.shape[0],)
                          + tuple(local.shape[1:]))
    with warnings.catch_warnings():
        # Newer torch names it all_gather_single, which older releases
        # lack; this spelling runs on both.
        warnings.simplefilter("ignore", FutureWarning)
        dist.all_gather_into_tensor(out, local, group=group)
    return out


def broadcast(tensor: torch.Tensor, src_group_rank: int,
              group=None) -> torch.Tensor:
    """In-place broadcast from group rank ``src_group_rank``."""
    _count("broadcast", tensor)
    src = dist.get_global_rank(group, src_group_rank) \
        if group is not None else src_group_rank
    dist.broadcast(tensor, src, group=group)
    return tensor


def shift(send: torch.Tensor | None, dst: int | None,
          recv: torch.Tensor | None, src: int | None) -> None:
    """One step of a point-to-point chain: send ``send`` to global rank
    ``dst`` and receive into ``recv`` from global rank ``src`` (either may
    be ``None``), as one ``batch_isend_irecv``.  Under gloo CUDA tensors
    travel through host memory (gloo's send/recv have no CUDA path)."""
    probe = send if send is not None else recv
    if probe is None:
        return
    host = probe.is_cuda and dist.get_backend() == "gloo"
    if host and "shift" not in HOST_ROUTED:
        HOST_ROUTED["shift"] = "gloo send/recv read host memory only"
        _log.warning("parallel: shift copies CUDA tensors through host "
                     "memory (gloo's send/recv read host memory only)")
    ops = []
    if send is not None:
        _count("shift", send)
        ops.append(dist.P2POp(dist.isend, send.cpu() if host else send,
                              dst))
    recv_buf = None
    if recv is not None:
        recv_buf = torch.empty_like(recv, device="cpu") if host else recv
        ops.append(dist.P2POp(dist.irecv, recv_buf, src))
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    if host and recv is not None:
        recv.copy_(recv_buf)


def run_resilient(sweep_factory, max_restarts: int = 3,
                  backoff_seconds: float = 5.0):
    """Run a checkpointed sweep, restarting after retryable failures.

    ``sweep_factory()`` must build a fresh
    :class:`~canopy_tpu_torch.engine.checkpoint.CheckpointedSweep`
    (re-reading its checkpoint) on every call.  Returns the final state;
    the counter-based batch keys make the resumed sweep bit-identical to
    an uninterrupted one.

    Only the ``torch.distributed.DistError`` family is retried
    (``DistNetworkError``, ``DistStoreError``, ``DistBackendError``: a
    lost peer, store or link).  ``torch.cuda.OutOfMemoryError`` and every
    other error are raised at once: they come from the work itself and
    would fail the same way on every restart.  The JAX package retries
    any ``JaxRuntimeError``, out-of-memory included; this is the opposite
    choice, on purpose.
    """
    attempts = 0
    while True:
        try:
            return sweep_factory().run()
        except RETRYABLE:
            attempts += 1
            if attempts > max_restarts:
                raise
            time.sleep(backoff_seconds * attempts)

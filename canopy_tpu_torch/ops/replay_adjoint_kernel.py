"""Reverse mode of a replay program: CUDA taped forward and backward.

Replaces ``canopy_tpu/ops/replay_adjoint_kernel.py``.  Its
``_tape_fwd_kernel`` copies every argument the replay forward reads into
an HBM argument tape; here the taped forward is the replay kernel with
its value log on (one row per gate output, the stream adjoint's design:
about 4x fewer rows on the bench trees), launched from
``csrc/replay_adjoint.cu``.  Its ``_bwd_kernel`` walks the backward
segments of ``compiler/replay_adjoint.py`` in reverse, as sub-kernels of
at most ``max_bwd_ops`` ops, with an XLA scatter-add of the gate-stream
cotangents into the adjoint log between segments; here one launch walks
the flat replay op table (``stream_kernel.encode_replay``) in reverse,
the adjoint pool in shared memory with the forward's slot assignment,
the eviction-log adjoints in device memory, and every cotangent of an
evicted value's read added straight into its log row (see
``csrc/replay_adjoint.cu``).  The result is the gradient stream, laid out
like the basic replay stream, which ``stream_kernel.replay_grad_basic``
folds back onto the basic events in a fixed order.

The adjoint schedule (``bwd_segments``, tape puts) of a
``ReplayAdjointProgram`` is therefore not run: the port uses its base
program (built without the resident tier, as the JAX builder forces for
the adjoint) and keeps the builder for its checks and its host
simulator, the CPU oracle.

What bounds the backward on the card: device-memory traffic of the value
log, the eviction-log adjoints and the gradient stream, at the
forward's occupancy (``csrc/replay.cu``).
"""

from __future__ import annotations

import torch

from ..compiler.graph import CompiledTree
from ..errors import LogicError
from .adjoint_kernel import _plain_backward_gate
from .stream_kernel import (EVICT, LAUNCHES, LOG, POOL, REFILL,
                            STAGED, _SUFFIX, EncodedReplay, _check_cuda,
                            _check_replay_fits, _check_staged, _raise_on,
                            _replay_block_trials, _replay_sizing,
                            encode_replay, house_tensor, replay_forward)

__all__ = ["compile_replay_adjoint", "replay_tape_forward",
           "replay_backward_plain", "replay_adjoint_backward",
           "make_differentiable_replay"]


def compile_replay_adjoint(tree: CompiledTree, **kwargs):
    """``compiler/replay_adjoint.build_replay_adjoint`` sized for the card
    as ``compile_replay_stream`` sizes the forward (a 113-slot pool by
    default; the builder turns the resident tier off for the adjoint),
    the built program checked against one block's shared memory
    (``LogicError``)."""
    from ..compiler.replay_adjoint import build_replay_adjoint
    aprog = build_replay_adjoint(tree, **_replay_sizing(tree, kwargs))
    _check_replay_fits(aprog.base)
    return aprog


def replay_tape_forward(enc: EncodedReplay, staged: torch.Tensor, house):
    """The taped forward: ``(top (n_trials,), value log (n_log,
    n_trials))``.  CPU tensors run the plain version; CUDA tensors launch
    the kernel or raise."""
    return replay_forward(enc, staged, house, with_log=True)


def replay_backward_plain(enc: EncodedReplay, staged: torch.Tensor,
                          house: torch.Tensor, vlog: torch.Tensor,
                          ct: torch.Tensor) -> torch.Tensor:
    """The backward kernel's arithmetic in plain torch, in its order:
    the gradient stream ``(brs_len_pad, n_trials)`` for cotangent ``ct``
    ``(n_trials,)``."""
    ops, args, _fill = enc.plain_ops()
    T = staged.shape[1]
    P = enc.pool_slots
    zeros = torch.zeros(T, dtype=staged.dtype, device=staged.device)
    adj = [zeros] * P
    adjlog = [zeros] * max(enc.n_evicted, 1)
    grad = [zeros] * enc.n_basic
    adj[enc.top_slot] = ct

    def x(a):
        src, idx = a[3], a[4]
        if src == LOG:
            v = vlog[idx]
        elif src == STAGED:
            v = staged[idx]
        else:
            v = house[idx].expand(T)
        return 1.0 - v if a[2] else v

    def accum(a, g, flip=True):
        if flip and a[2]:
            g = -g
        idx = a[1]
        if a[0] == POOL:
            if idx < P:
                adj[idx] = adj[idx] + g
            else:
                adjlog[idx - P] = adjlog[idx - P] + g
        elif a[0] == STAGED:
            grad[idx] = grad[idx] + g

    for op in reversed(ops):
        kind, slot = op[0], op[1]
        if kind == EVICT:
            adj[slot] = adj[slot] + adjlog[op[4]]
        elif kind == REFILL:
            adjlog[op[4]] = adjlog[op[4]] + adj[slot]
            adj[slot] = zeros
        else:
            a = adj[slot]
            adj[slot] = zeros
            _plain_backward_gate(op, a, args, x, accum, zeros)
    return torch.stack(grad)


def replay_adjoint_backward(enc: EncodedReplay, staged: torch.Tensor, house,
                            vlog: torch.Tensor,
                            ct: torch.Tensor) -> torch.Tensor:
    """Gradient stream ``(brs_len_pad, n_trials)`` of the top values with
    cotangent ``ct``.  CPU tensors run :func:`replay_backward_plain`; CUDA
    tensors launch ``csrc/replay_adjoint.cu`` or raise.  Programs with a
    resident tier raise (build them with ``compile_replay_adjoint``)."""
    _check_staged(enc, staged)
    if enc.res_rows:
        raise LogicError("the replay backward takes programs without a "
                         "resident tier (compile_replay_adjoint)")
    device, dtype = staged.device, staged.dtype
    house_t = house_tensor(enc, house, device, dtype)
    ct = ct.to(dtype)
    T = staged.shape[1]
    if vlog.shape != (enc.n_log, T) or ct.shape != (T,):
        raise LogicError("log/cotangent shapes do not match the program")
    if device.type != "cuda":
        return replay_backward_plain(enc, staged, house_t, vlog, ct)
    from ._build import load_library
    lib = load_library()
    staged, vlog, ct = staged.contiguous(), vlog.contiguous(), ct.contiguous()
    _check_cuda(dtype, staged, vlog, ct)
    width = _replay_block_trials(enc.pool_slots, dtype)
    ops, args, _fill = enc.tables(device)
    adjlog = torch.zeros((max(enc.n_evicted, 1), T), dtype=dtype,
                         device=device)
    grad = torch.zeros((enc.n_basic, T), dtype=dtype, device=device)
    LAUNCHES["replay_bwd"] += 1
    code = getattr(lib, f"canopy_replay_backward_{_SUFFIX[dtype]}")(
        ops.data_ptr(), args.data_ptr(), enc.n_ops, staged.data_ptr(),
        house_t.data_ptr(), vlog.data_ptr(), ct.data_ptr(),
        adjlog.data_ptr(), grad.data_ptr(), T, enc.pool_slots,
        enc.top_slot, width, torch.cuda.current_stream(device).cuda_stream)
    _raise_on(lib, code, "replay backward")
    return grad


class _DifferentiableReplay(torch.autograd.Function):
    @staticmethod
    def forward(ctx, staged, enc, house):
        top, vlog = replay_tape_forward(enc, staged, house)
        ctx.save_for_backward(staged, vlog)
        ctx.enc, ctx.house = enc, house
        return top

    @staticmethod
    def backward(ctx, ct):
        staged, vlog = ctx.saved_tensors
        grad = replay_adjoint_backward(ctx.enc, staged, ctx.house, vlog, ct)
        return grad, None, None


def make_differentiable_replay(aprog, house_states):
    """``fn(staged) -> (n_trials,)`` over the staged replay stream of
    ``aprog.base`` (``stage_replay(encode_replay(aprog.base), p)``), whose
    gradient runs the backward kernel.

    Called without a gradient to track it runs the replay forward (no
    value log); under autograd the taped forward, then the backward
    kernel, and ``stage_replay``'s own backward folds the gradient stream
    onto ``(n_trials, n_basic)`` with ``replay_grad_basic``'s fixed-order
    segment-sum.
    """
    enc = encode_replay(aprog.base)

    def fn(staged: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and staged.requires_grad:
            return _DifferentiableReplay.apply(staged, enc, house_states)
        return replay_forward(enc, staged, house_states)[0]
    return fn

"""Reverse mode of a replay program: CUDA taped forward and backward.

Replaces ``canopy_tpu/ops/replay_adjoint_kernel.py``.  Its
``_tape_fwd_kernel`` copies every argument the replay forward reads into
an HBM argument tape; here the taped forward is the replay kernel with
its value log on (one row per gate output, the stream adjoint's design:
about 4x fewer rows on the bench trees), ``csrc/replay_ops.cuh``
instantiated from ``csrc/replay_adjoint.cu``.  Its ``_bwd_kernel`` walks
the backward segments of ``compiler/replay_adjoint.py`` in reverse, as
sub-kernels of at most ``max_bwd_ops`` ops, with an XLA scatter-add of
the gate-stream cotangents into the adjoint log between segments.

Here the backward is level-parallel, in the stream adjoint's gather form
(``csrc/adjoint.cu``, one kernel for both adjoints).
:func:`replay_level_program` rewrites the flat replay op table
(``stream_kernel.encode_replay``) as a stream program the level kernel
takes: gates keep their arguments, and each EVICT and REFILL becomes a
copy op (SPILL) whose one argument is the location it reads, so moving a
value's adjoint through the eviction log is an op like any other.  Each
argument's producer follows the schedule: a pool slot's last writer (a
gate or a REFILL), an eviction-log row's EVICT.  Every op's adjoint is
then the left fold, from 0, of its consumers' edge partials in reverse
op order, which is how the sequential walk (:func:`replay_backward_plain`)
accumulates each slot, log row and gradient row, EVICT and REFILL
included: the kernel is bit-equal to it
(:func:`replay_backward_levels_plain` shows it in plain torch).  The
result is the gradient stream, laid out like the basic replay stream,
which ``stream_kernel.replay_grad_basic`` folds back onto the basic
events in a fixed order.

The adjoint schedule (``bwd_segments``, tape puts) of a
``ReplayAdjointProgram`` is therefore not run: the port uses its base
program (built without the resident tier, as the JAX builder forces for
the adjoint) and keeps the builder for its checks and its host
simulator, the CPU oracle.

What bounds the backward on the card: the value log (one read per
argument), the edge partials (one write and one read per argument) and
the gradient stream, against a critical path of one shared-memory round
trip per level of the level program.
"""

from __future__ import annotations

import numpy as np
import torch

from ..compiler.graph import CompiledTree
from ..errors import LogicError
from .adjoint_kernel import (_plain_backward_gate, level_backward,
                             stream_backward_levels_plain)
from .stream_kernel import (EVICT, LOG, POOL, REFILL, SPILL, STAGED,
                            EncodedReplay, EncodedStream, _check_replay_fits,
                            _check_staged, _replay_sizing, encode_replay,
                            house_tensor, replay_forward, schedule_levels)

__all__ = ["compile_replay_adjoint", "replay_tape_forward",
           "replay_backward_plain", "replay_level_program",
           "replay_backward_levels_plain", "replay_adjoint_backward",
           "make_differentiable_replay"]


def compile_replay_adjoint(tree: CompiledTree, **kwargs):
    """``compiler/replay_adjoint.build_replay_adjoint`` sized for the card
    as ``compile_replay_stream`` sizes the forward (a 56-slot pool by
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


def replay_level_program(enc: EncodedReplay) -> EncodedStream:
    """The replay program ``enc`` (no resident tier) as the level
    kernel's stream program, its :func:`~.stream_kernel.level_schedule`
    attached (cached on ``enc``).

    Ops keep their order and value-log rows.  A gate keeps its argument
    rows; an EVICT or a REFILL becomes a SPILL-kind op with one argument
    row of its own, the slot (EVICT) or eviction-log row (REFILL) it
    copies, through which the level kernel hands the op's adjoint to that
    location's producer.  Producers: a pool slot's last writer (gate or
    REFILL), an eviction-log row's EVICT; staged and house arguments have
    none.  The top op is the top slot's last writer.
    """
    if "level_program" in enc._cache:
        return enc._cache["level_program"]
    if enc.res_rows:
        raise LogicError("the replay backward takes programs without a "
                         "resident tier (compile_replay_adjoint)")
    P = enc.pool_slots
    ops, args, producer = [], [], []
    writer: dict[int, int] = {}     # pool slot -> its last writer
    evictor: dict[int, int] = {}    # eviction-log row -> its EVICT
    for o, (kind, slot, b, e, aux0, aux1, row) in enumerate(
            enc.ops.tolist()):
        begin = len(args)
        if kind == EVICT:
            args.append([POOL, slot, 0, POOL, slot])
            producer.append(writer[slot])
            evictor[aux0] = o
        elif kind == REFILL:
            args.append([POOL, P + aux0, 0, POOL, P + aux0])
            producer.append(evictor[aux0])
            writer[slot] = o
        else:
            for a in enc.args[b:e].tolist():
                args.append(a)
                idx = a[1]
                producer.append(-1 if a[0] != POOL else writer[idx]
                                if idx < P else evictor[idx - P])
            ops.append([kind, slot, begin, len(args), aux0, aux1, row])
            writer[slot] = o
            continue
        ops.append([SPILL, slot, begin, begin + 1, 0, 0, -1])
    top_op = src = writer[enc.top_slot]
    while ops[src][0] == SPILL:     # a refilled top: its gate's log row
        src = producer[ops[src][2]]
    program = EncodedStream(
        ops=np.asarray(ops, dtype=np.int32).reshape(-1, 7),
        args=np.asarray(args, dtype=np.int32).reshape(-1, 5),
        fill=np.zeros(len(ops), dtype=np.float32), n_log=enc.n_log,
        n_basic=enc.n_basic, n_house=enc.n_house, pool_slots=P,
        top_slot=enc.top_slot, max_count_states=enc.max_count_states,
        staged_cols=enc.staged_cols, out_slots=enc.out_slots)
    program._cache["levels"] = schedule_levels(
        program.ops, program.args, np.asarray(producer, dtype=np.int64),
        enc.n_basic, top_op, LOG, ops[src][6])
    enc._cache["level_program"] = program
    return program


def replay_backward_levels_plain(enc: EncodedReplay, staged: torch.Tensor,
                                 house: torch.Tensor, vlog: torch.Tensor,
                                 ct: torch.Tensor) -> torch.Tensor:
    """The level-parallel replay backward in plain torch: the stream
    adjoint's gather form over :func:`replay_level_program` (levels in
    reverse, edge slots, each op's adjoint the fold of its consumers'
    edges).  Bit-equal to :func:`replay_backward_plain`; returns the
    gradient stream ``(brs_len_pad, n_trials)``."""
    return stream_backward_levels_plain(replay_level_program(enc), staged,
                                        house, vlog, ct)


def replay_adjoint_backward(enc: EncodedReplay, staged: torch.Tensor, house,
                            vlog: torch.Tensor,
                            ct: torch.Tensor) -> torch.Tensor:
    """Gradient stream ``(brs_len_pad, n_trials)`` of the top values with
    cotangent ``ct``.  CPU tensors run :func:`replay_backward_plain`; CUDA
    tensors launch the level-parallel kernel of ``csrc/adjoint.cu`` on
    :func:`replay_level_program` or raise.  Programs with a resident tier
    raise (build them with ``compile_replay_adjoint``)."""
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
    return level_backward(replay_level_program(enc), staged, house_t, vlog,
                          ct, "replay_bwd")


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

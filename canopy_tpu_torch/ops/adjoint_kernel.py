"""Reverse mode of a stream program: CUDA adjoint kernels and plain version.

Replaces ``canopy_tpu/ops/adjoint_kernel.py``: ``_tape_kernel`` becomes
the forward kernel with its value log on (``csrc/stream.cu``, one row per
gate output instead of the TPU's argument tape of about three rows per
gate), and ``_adjoint_kernel`` becomes ``csrc/adjoint.cu``.  The TPU's
tape ring, slab flushes and adjoint schedule (``compiler/adjoint.py``)
existed to fit VMEM and DMA; the value-log design needs none of them.

The adjoint kernel is level-parallel, in gather form: a block's threads
share each level's ops (``stream_kernel.level_schedule``), like the
logged forward's.  It is bit-equal to :func:`stream_backward_plain`, the
sequential reverse walk: each value's consumer partials are folded in
the order in which that walk accumulates them
(:func:`stream_backward_levels_plain` shows it in plain torch).
The per-gate partials are those of ``_bgate_accumulate``: mux ``(hi -
lo) a, p a, (1 - p) a``; pair; the zero-safe leave-one-out product; the
leave-one-out count DP.

:func:`make_differentiable_stream` wraps both kernels as a
``torch.autograd.Function``: the forward runs the logging kernel only
when a gradient is needed, the backward runs the adjoint kernel.
"""

from __future__ import annotations

import torch

from ..errors import LogicError
from ..utils.profiling import COUNTERS
from ._build import _ptr, _raise_on, load_library
from .stream_kernel import (COUNT, FILL, LOG, MUX, PAIR, POOL, PROD,
                            SMEM_BYTES, SPILL, STAGED, _LEVEL_THREADS,
                            _SUFFIX, EncodedStream, _check_cuda,
                            _check_staged, _dp_scratch, house_tensor,
                            level_schedule,
                            level_tile, stream_forward)

__all__ = ["stream_backward", "stream_backward_plain",
           "stream_backward_levels_plain", "level_backward",
           "make_differentiable_stream"]


def _plain_backward_gate(op, a, args, x, accum, zeros) -> None:
    """Propagate adjoint ``a`` of one gate op (MUX, PROD, PAIR, COUNT) to
    its arguments in plain torch: the one plain body of
    ``csrc/adjoint_ops.cuh``'s ``backward_gate``.  ``x(arg)`` is the
    argument's forward value, ``accum(arg, g, flip=True)`` adds a partial
    into its adjoint."""
    kind, _out, b, e, aux0, aux1, _row = op
    if kind == MUX:
        p, hi, lo = (x(args[j]) for j in range(b, b + 3))
        accum(args[b], (hi - lo) * a, False)
        accum(args[b + 1], p * a, False)
        accum(args[b + 2], (1.0 - p) * a, False)
    elif kind == PROD:
        ae = -a if aux0 else a
        F = e - b
        if F == 1:
            accum(args[b], ae)
        elif F == 2:
            x0, x1 = x(args[b]), x(args[b + 1])
            accum(args[b], x1 * ae)
            accum(args[b + 1], x0 * ae)
        else:
            xs = [x(args[j]) for j in range(b, e)]
            total = xs[0]
            for v in xs[1:]:
                total = total * v
            zero = [v == 0.0 for v in xs]
            zcnt = zero[0].to(xs[0].dtype)
            nz = torch.where(zero[0], 1.0, xs[0])
            for v, z in zip(xs[1:], zero[1:]):
                zcnt = zcnt + z.to(v.dtype)
                nz = nz * torch.where(z, 1.0, v)
            for j, (v, z) in zip(range(b, e), zip(xs, zero)):
                safe = torch.where(z, 1.0, v)
                part = torch.where(
                    zcnt == 0.0, total / safe,
                    torch.where((zcnt == 1.0) & z, nz, 0.0))
                accum(args[j], part * ae)
    elif kind == PAIR:
        ae = -a if aux0 else a
        x0, x1 = x(args[b]), x(args[b + 1])
        accum(args[b], (1.0 - 2.0 * x1) * ae)
        accum(args[b + 1], (1.0 - 2.0 * x0) * ae)
    elif kind == COUNT:
        is_open = aux1 >= e - b      # upper-open: absorb at lo
        cap = aux0 if is_open else aux1 + 1
        xs = [x(args[j]) for j in range(b, e)]
        for s in range(e - b):
            # States are rows of one (len, T) tensor, updated element for
            # element as the kernel updates its states.
            dp = torch.ones_like(zeros)[None]
            for j, v in enumerate(xs):
                if j == s:
                    continue
                nv = 1.0 - v
                new = torch.cat([dp[:1] * nv, dp[1:] * nv + dp[:-1] * v])
                if len(dp) <= cap:
                    dp = torch.cat([new, dp[-1:] * v])
                else:
                    dp = torch.cat([new[:-1], new[-1:] + dp[-1:] * v])

            def mass(a0, b0):
                lo, hi = max(a0, 0), min(b0, len(dp) - 1)
                if lo > hi:
                    return zeros
                acc = dp[lo]
                for k in range(lo + 1, hi + 1):
                    acc = acc + dp[k]
                return acc
            part = mass(aux0 - 1, aux0 - 1) if is_open else \
                mass(aux0 - 1, aux1 - 1) - mass(aux0, aux1)
            accum(args[b + s], part * a)
    # FILL: a constant; its adjoint is dropped.


def stream_backward_plain(enc: EncodedStream, staged: torch.Tensor,
                          house: torch.Tensor, log: torch.Tensor,
                          ct: torch.Tensor) -> torch.Tensor:
    """d top / d staged for cotangent ``ct`` (n_trials,), in the adjoint
    kernel's order: returns ``(n_basic, n_trials)``."""
    ops, args, _fill = enc.plain_ops()
    T = staged.shape[1]
    zeros = torch.zeros(T, dtype=staged.dtype, device=staged.device)
    adj = [zeros] * enc.pool_slots
    grad = [zeros] * enc.n_basic
    adj[enc.top_slot] = ct

    def x(a):
        src, idx = a[3], a[4]
        if src == LOG:
            v = log[idx]
        elif src == STAGED:
            v = staged[idx]
        else:
            v = house[idx].expand(T)
        return 1.0 - v if a[2] else v

    def accum(a, g, flip=True):
        if flip and a[2]:
            g = -g
        if a[0] == POOL:
            adj[a[1]] = adj[a[1]] + g
        elif a[0] == STAGED:
            grad[a[1]] = grad[a[1]] + g

    for op in reversed(ops):
        kind, out, b = op[0], op[1], op[2]
        a = adj[out]
        adj[out] = zeros
        if kind == SPILL:
            grad[args[b][1]] = grad[args[b][1]] + a
        else:
            _plain_backward_gate(op, a, args, x, accum, zeros)
    return torch.stack(grad) if grad else staged.new_zeros((0, T))


def stream_backward_levels_plain(enc: EncodedStream, staged: torch.Tensor,
                                 house: torch.Tensor, log: torch.Tensor,
                                 ct: torch.Tensor) -> torch.Tensor:
    """The level-parallel adjoint in plain torch (gather form): levels in
    reverse; each op's adjoint the left fold, from 0 (the top op: from
    ``ct``), of its consumers' edge partials in the schedule's order; its
    own partials written to one edge slot per argument row; each staged
    row's gradient the fold of its readers' slots.  Bit-equal to
    :func:`stream_backward_plain`; returns ``(n_basic, n_trials)``."""
    sched = level_schedule(enc)
    ops, args, _fill = enc.plain_ops()
    rows = [[*row, j] for j, row in enumerate(args)]   # row[5]: its edge
    T = staged.shape[1]
    zeros = torch.zeros(T, dtype=staged.dtype, device=staged.device)
    edge: list = [None] * len(rows)

    def x(a):
        src, idx = a[3], a[4]
        if src == LOG:
            v = log[idx]
        elif src == STAGED:
            v = staged[idx]
        else:
            v = house[idx].expand(T)
        return 1.0 - v if a[2] else v

    def accum(a, g, flip=True):
        edge[a[5]] = -g if flip and a[2] else g

    cons, ptr = sched.cons.tolist(), sched.cons_ptr.tolist()
    order, level_ptr = sched.order.tolist(), sched.level_ptr.tolist()
    for lv in reversed(range(sched.n_levels)):
        for o in order[level_ptr[lv]:level_ptr[lv + 1]]:
            op = ops[o]
            a = ct if o == sched.top_op else zeros
            for c in cons[ptr[o]:ptr[o + 1]]:
                a = a + edge[c]
            if op[0] == SPILL:
                edge[op[2]] = a
            elif op[0] != FILL:
                _plain_backward_gate(op, a, rows, x, accum, zeros)
    scons, sptr = sched.stage_cons.tolist(), sched.stage_ptr.tolist()
    grad = []
    for r in range(enc.n_basic):
        g = zeros
        for c in scons[sptr[r]:sptr[r + 1]]:
            g = g + edge[c]
        grad.append(g)
    return torch.stack(grad) if grad else staged.new_zeros((0, T))


def stream_backward(enc: EncodedStream, staged: torch.Tensor, house,
                    log: torch.Tensor, ct: torch.Tensor) -> torch.Tensor:
    """Gradient ``(n_basic, n_trials)`` of the top values with cotangent
    ``ct``.  CPU tensors run the plain version; CUDA tensors launch the
    level-parallel gather form of ``csrc/adjoint.cu`` or raise."""
    _check_staged(enc, staged)
    device, dtype = staged.device, staged.dtype
    house_t = house_tensor(enc, house, device, dtype)
    ct = ct.to(dtype)
    T = staged.shape[1]
    if log.shape != (enc.n_log, T) or ct.shape != (T,):
        raise LogicError("log/cotangent shapes do not match the program")
    if device.type != "cuda":
        return stream_backward_plain(enc, staged, house_t, log, ct)
    return level_backward(enc, staged, house_t, log, ct, "adjoint")


def level_backward(enc: EncodedStream, staged: torch.Tensor,
                   house_t: torch.Tensor, log: torch.Tensor, ct: torch.Tensor,
                   counter: str) -> torch.Tensor:
    """Launch ``csrc/adjoint.cu``'s level-parallel gather form on CUDA
    tensors over ``level_schedule(enc)``: the gradient ``(n_basic,
    n_trials)``.  ``COUNTERS["launch." + counter]`` counts the launch
    (``adjoint`` for stream programs, ``replay_bwd`` for replay programs in
    their level form)."""
    lib = load_library()
    dtype = staged.dtype
    staged, log, ct = staged.contiguous(), log.contiguous(), ct.contiguous()
    _check_cuda(dtype, staged, log, ct)
    device, T = staged.device, staged.shape[1]
    ops, args, _fill = enc.tables(device)
    stream = torch.cuda.current_stream(device).cuda_stream
    sched = level_schedule(enc)
    tables = sched.tables(device)
    tile = level_tile(T)
    smem_log = enc.n_log * tile * staged.element_size() <= SMEM_BYTES
    edge = torch.empty((max(len(enc.args), 1), T), dtype=dtype,
                       device=device)
    grad = torch.empty((enc.n_basic, T), dtype=dtype, device=device)
    dp = _dp_scratch(enc, -(-T // tile), _LEVEL_THREADS, staged)
    COUNTERS["launch." + counter] += 1
    code = getattr(lib, f"canopy_stream_level_backward_{_SUFFIX[dtype]}")(
        ops.data_ptr(), args.data_ptr(),
        *(t.data_ptr() for t in tables[:2]), sched.n_levels,
        *(t.data_ptr() for t in tables[2:]), enc.n_basic,
        staged.data_ptr(), house_t.data_ptr(), log.data_ptr(),
        ct.data_ptr(), edge.data_ptr(), grad.data_ptr(), T, tile,
        enc.n_log, sched.top_op, int(smem_log), _ptr(dp), stream)
    _raise_on(lib, code, "level backward")
    return grad


class _DifferentiableStream(torch.autograd.Function):
    @staticmethod
    def forward(ctx, staged, enc, house):
        top, log = stream_forward(enc, staged, house, with_log=True)
        ctx.save_for_backward(staged, log)
        ctx.enc, ctx.house = enc, house
        return top

    @staticmethod
    def backward(ctx, ct):
        staged, log = ctx.saved_tensors
        grad = stream_backward(ctx.enc, staged, ctx.house, log, ct)
        return grad.to(staged.dtype), None, None


def make_differentiable_stream(enc: EncodedStream, house_states):
    """``fn(staged) -> (n_trials,)`` whose gradient runs the adjoint
    kernel.  Called without a gradient to track, it runs the plain
    forward kernel (no log).  Staging stays outside (plain indexing), so
    autograd maps the staged gradient back onto the caller's values."""

    def fn(staged: torch.Tensor) -> torch.Tensor:
        if torch.is_grad_enabled() and staged.requires_grad:
            return _DifferentiableStream.apply(staged, enc, house_states)
        return stream_forward(enc, staged, house_states)[0]
    return fn

"""The one request generator: a traffic mix is data, read here.

A mix file (``traffic/<mix>.json``) holds:

* ``kind``: the request kind, a file ``kinds/<kind>.py`` that drives the
  program for one request (see ``cells``).  The kind lists the further
  keys it reads (``MIX_KEYS``) and turns them into the requests of one
  round (``round_shapes(mix)``).
* ``loop``: ``"closed"``, with ``clients`` clients that each send their
  next request when the last one returns; or ``"open"``, with requests
  arriving at ``rate_per_s`` a second on average, whatever the server
  does.
* ``check_requests``: how many finished requests the check compares.

Every round holds each of the kind's shapes once, in an order drawn from
the seed, so every seed sends the same work in another order; each
request has a seed of its own.  A closed loop sends whole rounds until
the window's seconds have passed.  An open loop sends the whole rounds
nearest to ``rate_per_s`` times the window, at times drawn uniformly over
the window (a Poisson stream of that many arrivals); the times are the
same for every seed, which only orders the requests over them.  A mix
with a key or a value the generator does not know is refused before
set-up.

Warm-up requests come from another stream of the same seed and cover each
shape once.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rng", "validate", "requests", "arrivals", "warm_requests",
           "check_sample"]

LOOPS = {"closed": {"clients"}, "open": {"rate_per_s"}}
COMMON = {"kind", "loop", "check_requests"}


def rng(seed: int, stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), stream])


def _seed(gen: np.random.Generator) -> int:
    return int(gen.integers(0, 1 << 31))


def validate(mix: dict, kind) -> None:
    """Raise ``ValueError`` for a mix this generator cannot send as
    written; ``kind`` is the mix's kind module."""
    loop = mix.get("loop")
    if loop not in LOOPS:
        raise ValueError(f"loop {loop!r}: the generator runs "
                         f"{sorted(LOOPS)}")
    wanted = COMMON | LOOPS[loop] | set(kind.MIX_KEYS)
    unknown, missing = set(mix) - wanted, wanted - set(mix)
    if unknown or missing:
        raise ValueError(f"mix keys unknown {sorted(unknown)}, missing "
                         f"{sorted(missing)}")
    if loop == "closed" and not (isinstance(mix["clients"], int)
                                 and mix["clients"] >= 1):
        raise ValueError(f"clients {mix['clients']!r}: a whole number >= 1")
    if loop == "open" and not mix["rate_per_s"] > 0:
        raise ValueError(f"rate_per_s {mix['rate_per_s']!r}: above 0")
    if not (isinstance(mix["check_requests"], int)
            and mix["check_requests"] >= 1):
        raise ValueError("check_requests: a whole number >= 1")
    if not kind.round_shapes(mix):
        raise ValueError("the mix's round holds no request")


def requests(mix: dict, kind, seed: int):
    """The window's requests in order, without end; the last of each
    round has ``round_end`` true."""
    gen = rng(seed, 0)
    shapes = kind.round_shapes(mix)
    while True:
        order = gen.permutation(len(shapes))
        for j, i in enumerate(order):
            yield {**shapes[i], "seed": _seed(gen),
                   "round_end": j == len(order) - 1}


def arrivals(mix: dict, kind, seconds: float) -> list[float]:
    """An open loop's arrival times (seconds into the window): whole
    rounds, as many as come nearest to ``rate_per_s * seconds``, the same
    for every seed."""
    per_round = len(kind.round_shapes(mix))
    rounds = max(1, round(mix["rate_per_s"] * seconds / per_round))
    return sorted(rng(0, 3).uniform(0.0, seconds,
                                    rounds * per_round).tolist())


def warm_requests(mix: dict, kind, seed: int) -> list[dict]:
    """One request of each shape the window sends."""
    gen = rng(seed, 1)
    shapes = []
    for shape in kind.round_shapes(mix):
        if shape not in shapes:
            shapes.append(shape)
    return [{**shape, "seed": _seed(gen)} for shape in shapes]


def check_sample(records: list, mix: dict, kind, seed: int) -> list[int]:
    """Indices of the finished requests the check compares: the first of
    the largest by the kind's ``work``, and the rest drawn from the
    seed."""
    n = min(mix["check_requests"], len(records))
    if not records:
        return []
    largest = max(range(len(records)),
                  key=lambda i: (kind.work(records[i]), -i))
    rest = [i for i in range(len(records)) if i != largest]
    picked = rng(seed, 2).choice(len(rest), size=n - 1, replace=False) \
        if n > 1 else []
    return sorted([largest] + [rest[int(j)] for j in picked])

"""The traffic generator repeats for a seed, differs across seeds, and
sends every seed the same work; it refuses what it cannot send; the
window runs the loops the mix names; the check's sample holds the
largest request."""

import itertools
import os
import sys
import time
import types

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [BENCH, os.path.dirname(BENCH)]

import pytest  # noqa: E402
import torch  # noqa: E402

from canopy_bench import harness, traffic  # noqa: E402
from canopy_bench.cells import load_kind  # noqa: E402

UNCERTAINTY = load_kind(BENCH, "uncertainty")
SERVE = {"kind": "uncertainty", "loop": "closed", "clients": 1,
         "log2_trials": [14, 15, 16, 17, 18, 19, 20], "check_requests": 8}
SEEDS = [0, 7, 2**31 + 5, 2**40 + 3, 4_000_007_920]


def take(mix, seed, n):
    return list(itertools.islice(traffic.requests(mix, UNCERTAINTY, seed),
                                 n))


@pytest.mark.parametrize("seed", SEEDS)
def test_requests_repeat_for_a_seed(seed):
    assert take(SERVE, seed, 50) == take(SERVE, seed, 50)
    assert traffic.warm_requests(SERVE, UNCERTAINTY, seed) == \
        traffic.warm_requests(SERVE, UNCERTAINTY, seed)


def test_requests_differ_across_seeds():
    runs = [take(SERVE, seed, 21) for seed in SEEDS]
    for a, b in itertools.combinations(runs, 2):
        assert [r["seed"] for r in a] != [r["seed"] for r in b]
    orders = {tuple(r["n_trials"] for r in run) for run in runs}
    assert len(orders) > 1


@pytest.mark.parametrize("seed", SEEDS)
def test_every_round_sends_each_size_once(seed):
    sizes = sorted(1 << k for k in SERVE["log2_trials"])
    requests = take(SERVE, seed, 7 * 6)
    for r0 in range(0, len(requests), 7):
        block = requests[r0:r0 + 7]
        assert sorted(r["n_trials"] for r in block) == sizes
        assert [r["round_end"] for r in block] == [False] * 6 + [True]


def test_warm_up_covers_every_size_once():
    warm = traffic.warm_requests(SERVE, UNCERTAINTY, 3)
    assert sorted(r["n_trials"] for r in warm) == \
        sorted(1 << k for k in SERVE["log2_trials"])
    twice = {**SERVE, "log2_trials": [20, 14, 20]}
    assert sorted(r["n_trials"] for r in
                  traffic.warm_requests(twice, UNCERTAINTY, 3)) == \
        [1 << 14, 1 << 20]


@pytest.mark.parametrize("change", [
    {"loop": "poisson"}, {"clients": 0}, {"clients": 1.5},
    {"loop": "open"}, {"loop": "open", "rate_per_s": 0},
    {"think_s": 1.0}, {"log2_trials": []}, {"check_requests": 0},
    {"log2_trials": None}])
def test_a_mix_it_cannot_send_is_refused(change):
    mix = {k: v for k, v in {**SERVE, **change}.items() if v is not None}
    if change.get("loop") == "open" and "rate_per_s" in change:
        del mix["clients"]
    with pytest.raises(ValueError):
        traffic.validate(mix, UNCERTAINTY)


def test_the_mixes_in_the_tree_are_valid():
    for name in os.listdir(os.path.join(BENCH, "traffic")):
        mix = harness._load_json(BENCH, "traffic", name)
        traffic.validate(mix, load_kind(BENCH, mix["kind"]))


def test_open_arrivals_are_whole_rounds_over_the_window():
    mix = {**SERVE, "loop": "open", "rate_per_s": 40.0}
    del mix["clients"]
    times = traffic.arrivals(mix, UNCERTAINTY, 10.0)
    assert len(times) == 7 * round(40 * 10 / 7)
    assert times == sorted(times) and 0 <= times[0] and times[-1] < 10
    # The same arrivals for every seed; the seed orders the requests.
    assert times == traffic.arrivals(mix, UNCERTAINTY, 10.0)
    gaps = [b - a for a, b in zip(times, times[1:])]
    assert max(gaps) > 5 * min(gaps)


SERVICE_S = 0.004


class SleepCell:
    """Serves each request in ``SERVICE_S`` seconds."""

    def run(self, request):
        time.sleep(SERVICE_S)
        return dict(request)


def run_window(mix, seconds):
    records, window_s, failed = harness.window(
        SleepCell(), mix, UNCERTAINTY, 11, seconds, torch.device("cpu"))
    assert failed == 0 and window_s == records[-1]["end"]
    return records


@pytest.mark.parametrize("clients", [1, 3])
def test_closed_loop_sends_whole_rounds_from_each_client(clients):
    mix = {**SERVE, "clients": clients}
    records = run_window(mix, 0.2)
    assert len(records) % 7 == 0 and records[-1]["end"] >= 0.2
    assert [r["arrival"] for r in records[:clients]] == [0.0] * clients
    for r in records:
        assert r["arrival"] <= r["start"] < r["end"]
    # Past the first requests each waits for the other clients' ones.
    waits = sorted(r["end"] - r["arrival"] for r in records[clients:])
    assert waits[len(waits) // 2] >= clients * SERVICE_S * 0.9


def test_open_loop_waits_for_each_arrival():
    mix = {**SERVE, "loop": "open", "rate_per_s": 70.0}
    del mix["clients"]
    records = run_window(mix, 0.3)
    assert len(records) == len(traffic.arrivals(mix, UNCERTAINTY, 0.3))
    for r in records:
        assert r["start"] >= r["arrival"] - 1e-4


@pytest.mark.parametrize("seed", SEEDS)
def test_check_sample_holds_the_largest(seed):
    records = take(SERVE, seed, 70)
    picked = traffic.check_sample(records, SERVE, UNCERTAINTY, seed)
    assert len(picked) == len(set(picked)) == SERVE["check_requests"]
    largest = max(r["n_trials"] for r in records)
    first = next(i for i, r in enumerate(records)
                 if r["n_trials"] == largest)
    assert first in picked
    assert picked == traffic.check_sample(records, SERVE, UNCERTAINTY, seed)
    assert traffic.check_sample(records[:2], SERVE, UNCERTAINTY, seed) == \
        [0, 1]

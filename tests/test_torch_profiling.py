"""Torch port, ``utils/profiling.RooflineAccountant``: the achieved
fraction of the card's memory rate (exact arithmetic, checked to 1e-12),
an explicit bandwidth, and an unknown card raising."""

import pytest

from canopy_tpu_torch.errors import LogicError
from canopy_tpu_torch.utils.profiling import (HBM_BANDWIDTH,
                                              RooflineAccountant)


def test_fraction_on_the_h100():
    acc = RooflineAccountant("NVIDIA H100 80GB HBM3")
    assert acc.bandwidth == 3.35e12 == HBM_BANDWIDTH["NVIDIA H100 80GB HBM3"]
    entry = acc.record("stream", elements=1 << 30, bytes_per_element=4.0,
                       seconds=0.004)
    # 2^32 bytes at 3.35 TB/s take 1.282 ms; 4 ms measured.
    assert abs(entry["hbm_fraction"] - 2**32 / 3.35e12 / 0.004) < 1e-12
    assert entry["elements_per_s"] == (1 << 30) / 0.004
    assert sorted(entry) == ["elements", "elements_per_s", "hbm_fraction",
                             "kernel", "seconds"]
    assert acc.report() == [entry]


def test_explicit_bandwidth_overrides_the_table():
    acc = RooflineAccountant("NVIDIA H100 80GB HBM3", bandwidth=1e12)
    entry = acc.record("x", elements=1000, bytes_per_element=8.0,
                       seconds=1e-8)
    assert abs(entry["hbm_fraction"] - 0.8) < 1e-12
    assert RooflineAccountant("a card not in the table",
                              bandwidth=2e12).bandwidth == 2e12
    assert acc.record("y", 10, 4.0, 0.0)["hbm_fraction"] == 0.0


def test_unknown_card_raises():
    with pytest.raises(LogicError):
        RooflineAccountant("NVIDIA GeForce 256")


def test_no_card_and_no_bandwidth_raises():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card exists here")
    with pytest.raises(LogicError):
        RooflineAccountant()

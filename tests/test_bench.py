"""The benchmark's table of published device peaks (bench.py)."""

import pytest

import bench


def test_h100_peaks_carry_their_source():
    peaks = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks["hbm_bytes_per_s"] == 3.35e12
    assert peaks["fp64_flop_per_s"] == 34e12
    assert "data sheet" in peaks["source"]


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", "Tesla V100-SXM2-16GB"])
def test_unknown_device_kind_is_an_error(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks(kind)

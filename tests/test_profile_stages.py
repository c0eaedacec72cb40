"""The profiler's peak table: keyed by device_kind, and an unknown device
is an error rather than a default."""

import pytest

from deepvcp.profile_stages import PEAKS, device_peaks


def test_known_device_has_both_peaks():
    peaks = device_peaks("NVIDIA H100 80GB HBM3")
    assert peaks is PEAKS["NVIDIA H100 80GB HBM3"]
    assert peaks["flops"] > 0 and peaks["bytes"] > 0


@pytest.mark.parametrize("kind", ["cpu", "NVIDIA A100-SXM4-80GB", ""])
def test_unknown_device_raises(kind):
    with pytest.raises(KeyError, match="no published peaks"):
        device_peaks(kind)

"""Live-USB capture configuration logic via a mocked rtlsdr driver.

The hardware itself is absent, but the reference-parity behaviors —
tuner-retry loop, 1.5 s AGC settle flush before the FIRST capture only,
E4000 programmed-frequency model — are pure control flow around the
driver object (reference: src/CellSearch.cpp:343-434).
"""

import sys
import types

import numpy as np
import pytest

CAPLENGTH = 153600


class _MockRtlSdr:
    fail_sets = 0          # class-configured transient tuner failures

    def __init__(self):
        self.sample_rate = None
        self.gain = None
        self._fc = None
        self.samples_read = 0
        self.set_attempts = 0

    @property
    def center_freq(self):
        return self._fc

    @center_freq.setter
    def center_freq(self, v):
        self.set_attempts += 1
        if self.set_attempts <= _MockRtlSdr.fail_sets:
            raise OSError("usb transient")
        self._fc = v

    def read_samples(self, n):
        self.samples_read += n
        rng = np.random.default_rng(self.samples_read % 2**31)
        return (rng.standard_normal(n) + 1j * rng.standard_normal(n)) / 64


@pytest.fixture
def mock_rtlsdr(monkeypatch):
    mod = types.ModuleType("rtlsdr")
    mod.RtlSdr = _MockRtlSdr
    monkeypatch.setitem(sys.modules, "rtlsdr", mod)
    _MockRtlSdr.fail_sets = 0
    # no real sleeping in the retry loop
    import time

    monkeypatch.setattr(time, "sleep", lambda s: None)
    return mod


def test_usb_agc_flush_and_capture(mock_rtlsdr):
    from lte_cell_scanner.io.capture import CaptureSource

    src = CaptureSource("rtlsdr", correction=1.000012)
    sdr = src._sdr
    assert sdr.sample_rate == round(1.92e6 * 1.000012)
    assert sdr.gain == "auto"

    capbuf, fc_prog = src.capture(739e6)
    assert len(capbuf) == CAPLENGTH
    assert fc_prog == 739e6
    assert sdr.center_freq == round(739e6 * 1.000012)
    # AGC settle: >= 2 880 000 samples flushed before the capture.
    assert sdr.samples_read >= 2_880_000 + CAPLENGTH

    before = sdr.samples_read
    src.capture(740e6)
    # Second capture: no re-flush.
    assert sdr.samples_read == before + CAPLENGTH


def test_usb_tuner_retry(mock_rtlsdr):
    from lte_cell_scanner.io.capture import CaptureSource

    _MockRtlSdr.fail_sets = 3      # three transient failures, then OK
    src = CaptureSource("rtlsdr")
    capbuf, _ = src.capture(739e6)
    assert len(capbuf) == CAPLENGTH
    assert src._sdr.set_attempts == 4

    _MockRtlSdr.fail_sets = 99     # persistent failure -> raises
    src2 = CaptureSource("rtlsdr")
    with pytest.raises(OSError):
        src2.capture(739e6)
    assert src2._sdr.set_attempts == 5


def test_usb_e4000_fc_programmed(mock_rtlsdr):
    from lte_cell_scanner.io.capture import (CaptureSource,
                                             compute_fc_programmed)

    src = CaptureSource("rtlsdr", tuner="E4000")
    src._agc_settled = True        # skip the flush for speed
    _, fc_prog = src.capture(739e6)
    assert fc_prog == compute_fc_programmed(28.8e6, 739e6) + 58
    assert fc_prog != 739e6        # PLL quantization is visible

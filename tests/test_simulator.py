"""Closed-loop simulation tests: fake eNodeB -> channel -> full search.

Mirrors the role of Matlab/pss_search_final.m (randomized cell parameters,
impaired channel, detection check) but closes the loop through the MIB,
which this simulator carries and the reference's does not.
"""

import numpy as np
import pytest

from lte_cell_scanner.io.simulator import (MibConfig, apply_channel,
                                           create_dl_sig,
                                           synthetic_capture)
from lte_cell_scanner.search import cell_search, dedup


def test_signal_structure():
    sig = create_dl_sig("normal", 10, 0, 12, 2, 0.5,
                        np.random.default_rng(0))
    assert len(sig) == 19200
    # PSS template correlation must spike at the end of slots 0 and 10.
    from lte_cell_scanner.models.pss import pss_td

    tpl = np.conj(pss_td(2)) / 137
    xc = np.abs([np.dot(tpl, sig[k:k + 137]) for k in range(19000)])
    peaks = np.argsort(xc)[-2:]
    assert set(np.round(peaks / 9600).astype(int)) == {0, 1}
    # extended CP length
    sig_e = create_dl_sig("extended", 2, 0, 0, 0, 0.0)
    assert len(sig_e) == 3840


@pytest.mark.parametrize("cp_type,n_id_1,n_id_2,foff,n_rb", [
    ("normal", 90, 1, 7.7e3, 50),
    ("normal", 0, 0, -3.3e3, 6),
    ("extended", 167, 2, 11e3, 100),
])
def test_closed_loop_decode(cp_type, n_id_1, n_id_2, foff, n_rb):
    cap = synthetic_capture(n_id_1=n_id_1, n_id_2=n_id_2, cp_type=cp_type,
                            snr_db=10, freq_offset=foff, n_rb_dl=n_rb,
                            sfn_start=64, seed=3)
    cells = dedup(cell_search(cap, 739e6,
                              f_search_set=np.arange(-3, 4) * 5e3))
    assert len(cells) == 1
    c = cells[0]
    assert c.n_id_cell() == 3 * n_id_1 + n_id_2
    assert c.cp_type == cp_type
    assert c.n_rb_dl == n_rb
    assert c.sfn == 64
    assert c.n_ports == 1
    assert abs(c.freq_superfine - foff) < 30


def test_low_snr_detection():
    """Sync must still detect the cell at -5 dB SNR."""
    cap = synthetic_capture(snr_db=-5, freq_offset=2e3, seed=7)
    cells = cell_search(cap, 739e6, f_search_set=np.arange(-3, 4) * 5e3)
    assert any(c.n_id_cell() == 271 for c in cells)


def test_multipath_channel():
    from lte_cell_scanner.io.simulator import create_dl_sig

    rng = np.random.default_rng(9)
    tx = create_dl_sig("normal", 80, 0, 30, 1, 0.5, rng,
                       mib=MibConfig(n_rb_dl=25, sfn_start=0))
    rx = apply_channel(tx, snr_db=15, freq_offset=4e3,
                       taps=[1.0, 0, 0.4 + 0.2j], rng=rng)
    cells = dedup(cell_search(rx, 739e6,
                              f_search_set=np.arange(-3, 4) * 5e3))
    assert any(c.n_id_cell() == 91 and c.n_rb_dl == 25 for c in cells)


def test_capture_roundtrip(tmp_path):
    from lte_cell_scanner.io.capture import (CaptureSource, load_capbuf,
                                             save_capbuf)

    cap = synthetic_capture(seed=1)[:1000]
    save_capbuf(str(tmp_path), 0, cap, 739e6)
    back, fc = load_capbuf(str(tmp_path), 0)
    np.testing.assert_allclose(back, cap)
    assert fc == 739e6
    src = CaptureSource("file", data_dir=str(tmp_path))
    c2, fcp = src.capture(739e6)
    np.testing.assert_allclose(c2, cap)


def test_e4000_pll_model():
    from lte_cell_scanner.io.capture import (compute_fc_programmed,
                                             fs_programmed_rtl2832)

    # The PLL quantizes: programmed frequency is close to but almost never
    # exactly the requested one, and is deterministic.
    fc = compute_fc_programmed(28.8e6, 739e6)
    assert abs(fc - 739e6) < 2000
    assert fc == compute_fc_programmed(28.8e6, 739e6)
    # R multiplier steps at the band edges change the quantization grain.
    lo = compute_fc_programmed(28.8e6, 100e6)
    assert abs(lo - 100e6) < 100
    fs = fs_programmed_rtl2832(1.92e6)
    assert abs(fs - 1.92e6) < 1.0

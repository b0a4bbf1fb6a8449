"""Wideband capture front end: FIR design, decimation, end-to-end."""

import numpy as np

from lte_cell_scanner.constants import FS_SEARCH
from lte_cell_scanner.io.frontend import (
    PASSBAND_HZ,
    decimate_capture,
    design_decimation_fir,
)


def _tone(f, fs, n):
    return np.exp(2j * np.pi * f * np.arange(n) / fs)


def test_fir_passband_and_alias_rejection():
    decim = 8
    fs_in = decim * FS_SEARCH
    n = 1 << 16
    # Passband tone survives at full amplitude.
    y = decimate_capture(_tone(300e3, fs_in, n), fs_in)
    assert abs(np.abs(y[200:-200]).mean() - 1.0) < 0.01
    # A tone that would alias onto 300 kHz is rejected by >55 dB.
    y = decimate_capture(_tone(FS_SEARCH + 300e3, fs_in, n), fs_in)
    assert 20 * np.log10(np.abs(y[200:-200]).mean() + 1e-12) < -55
    # Frequency shift centers an off-carrier signal first.
    y = decimate_capture(_tone(5e6 + 100e3, fs_in, n), fs_in,
                         freq_shift=5e6)
    assert abs(np.abs(y[200:-200]).mean() - 1.0) < 0.01


def test_arbitrary_input_lengths():
    """decimate_capture must accept captures whose length is not a
    multiple of decim (any real wideband recording)."""
    rng = np.random.default_rng(1)
    fs_in = 8 * FS_SEARCH
    base = rng.standard_normal(65544) + 1j * rng.standard_normal(65544)
    ref = decimate_capture(base, fs_in)
    for n in (65541, 65543, 65537):
        y = decimate_capture(base[:n], fs_in)
        assert len(y) >= len(ref) - 1
        m = min(len(y), len(ref))
        np.testing.assert_allclose(y[:m], ref[:m], atol=1e-12)


def test_jax_backend_matches_numpy():
    rng = np.random.default_rng(0)
    fs_in = 4 * FS_SEARCH
    x = (rng.standard_normal(40000) + 1j * rng.standard_normal(40000))
    a = decimate_capture(x, fs_in)
    b = decimate_capture(x, fs_in, backend="jax")
    assert np.abs(a - b).max() < 1e-4 * np.abs(a).max()


def test_wideband_capture_to_cell_search():
    """A cell recorded at 15.36 Msps decimates to 1.92 Msps and decodes."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.search.cell_search import cell_search
    from lte_cell_scanner.utils.dsp import interpft

    base = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=20,
                             freq_offset=3e3, n_subframes=90, seed=4)
    decim = 8
    wide = interpft(base, len(base) * decim)  # band-limited upsample
    narrow = decimate_capture(wide, decim * FS_SEARCH)[:80 * 1920]
    assert len(narrow) == 153600
    cells = cell_search(narrow, 739e6,
                        f_search_set=np.arange(-2, 3) * 5e3,
                        backend="numpy")
    assert [c.n_id_cell() for c in cells] == [271]
    assert cells[0].n_rb_dl == 50

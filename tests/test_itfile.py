"""IT++ container reader/writer tests against the bundled reference fixtures."""

import os

import numpy as np
import pytest

from lte_cell_scanner.io.itfile import load_it, save_it
from conftest import reference_path


def test_load_capbuf():
    path = reference_path("test", "capbuf_0000.it")
    if not os.path.exists(path):
        pytest.skip("no reference fixtures")
    d = load_it(path)
    assert d["capbuf"].shape == (153600,)
    assert d["capbuf"].dtype == np.complex128
    assert int(d["fc"][0]) == 739000000
    # 8-bit IQ data normalized (x-127)/128: all values on the grid.
    grid = np.round(d["capbuf"].real * 128 + 127)
    assert np.allclose(d["capbuf"].real, (grid - 127) / 128)


def test_load_peak_search_fixture():
    path = reference_path("test", "test_peak_search.it")
    if not os.path.exists(path):
        pytest.skip("no reference fixtures")
    d = load_it(path)
    assert d["xc_incoherent_collapsed_pow"].shape == (3, 9600)
    assert d["xc_incoherent_collapsed_frq"].shape == (3, 9600)
    assert d["Z_th1"].shape == (9600,)
    assert len(d["f_search_set"]) == 9
    assert len(d["peaks_pow"]) == len(d["peaks_ind"])
    # Matrix orientation check: every frq entry indexes into f_search_set
    # (matlab 1-based).
    frq = d["xc_incoherent_collapsed_frq"]
    assert frq.min() >= 1 and frq.max() <= 9


def test_roundtrip(tmp_path):
    rng = np.random.default_rng(0)
    recs = {
        "v": rng.standard_normal(17),
        "cv": rng.standard_normal(5) + 1j * rng.standard_normal(5),
        "iv": np.arange(-3, 9, dtype=np.int32),
        "m": rng.standard_normal((3, 7)),
        "cm": rng.standard_normal((4, 2)) + 1j * rng.standard_normal((4, 2)),
        "b": np.array([0, 1, 1, 0], dtype=np.uint8),
    }
    p = str(tmp_path / "roundtrip.it")
    save_it(p, recs)
    back = load_it(p)
    for k, v in recs.items():
        np.testing.assert_array_equal(back[k], v)


def test_save_capbuf_fc_int32_interop(tmp_path):
    """Recordings store fc as int32 (reference-compatible,
    src/capbuf.cpp:187-197); >2^31 carriers fall back to float64."""
    from lte_cell_scanner.io.capture import load_capbuf, save_capbuf

    cap = (np.arange(64) - 32) / 128 + 1j * (np.arange(64) - 16) / 128
    save_capbuf(str(tmp_path), 0, cap, 739e6, fc_programmed=739000058.0)
    d = load_it(str(tmp_path / "capbuf_0000.it"))
    assert d["fc"].dtype == np.int32 and int(d["fc"][0]) == 739000000
    assert float(d["fc_programmed"][0]) == 739000058.0
    back, fc_prog = load_capbuf(str(tmp_path), 0, 739e6)
    np.testing.assert_array_equal(back, cap)
    assert fc_prog == 739000058.0

    # Band-41 style carrier: no int32 representation, float64 fallback.
    save_capbuf(str(tmp_path), 1, cap, 2.6e9)
    d = load_it(str(tmp_path / "capbuf_0001.it"))
    assert d["fc"].dtype == np.float64 and float(d["fc"][0]) == 2.6e9

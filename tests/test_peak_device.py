"""Device greedy peak search vs the host implementation."""

import numpy as np
import jax.numpy as jnp
import pytest

from lte_cell_scanner.constants import DS_COMB_ARM, THRESH1_N_NINES
from lte_cell_scanner.ops.peak import peak_search
from lte_cell_scanner.ops.peak_jax import (
    peak_search_device,
    peaks_to_cells,
    r_th1_normalized,
)
from lte_cell_scanner.ops.xcorr import xcorr_pss
from lte_cell_scanner.search.cell_search import detection_threshold


def _compare(cap, fc, fset):
    r = xcorr_pss(cap, fset, DS_COMB_ARM, fc, fc, 1.92e6, backend="numpy")
    z = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    host = peak_search(r.xc_incoherent_collapsed_pow,
                       r.xc_incoherent_collapsed_frq, z, fset, fc, fc,
                       r.xc_incoherent_single, DS_COMB_ARM)

    packed = np.concatenate([
        r.xc_incoherent_collapsed_pow,
        r.xc_incoherent_collapsed_frq.astype(np.float64),
        r.sp_incoherent[None],
    ], axis=0)
    r_norm = r_th1_normalized(r.n_comb_xc, DS_COMB_ARM, THRESH1_N_NINES)
    table = peak_search_device(jnp.asarray(packed),
                               jnp.asarray(np.asarray(r.xc_incoherent_single)),
                               r_norm, DS_COMB_ARM)
    dev = peaks_to_cells(np.asarray(table), fset, fc, fc)

    assert len(dev) == len(host)
    for a, b in zip(dev, host):
        assert a.n_id_2 == b.n_id_2
        assert a.ind == b.ind
        assert a.freq == b.freq
        # the device table records pow in float32
        np.testing.assert_allclose(a.pss_pow, b.pss_pow, rtol=1e-6)
    return host


def test_device_peaks_match_host_synthetic():
    from lte_cell_scanner.models.pss import pss_td

    rng = np.random.default_rng(5)
    n = 153600
    cap = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
    # Two cells on different PSS at different lags/offsets.
    for n2, lag0, f_off, amp in [(1, 500, 10e3, 0.3), (0, 4000, -5e3, 0.2)]:
        tpl = pss_td(n2)
        t = np.arange(137)
        sh = tpl * np.exp(1j * 2 * np.pi * f_off * t / 1.92e6)
        for k in range(lag0, n - 137, 9600):
            cap[k:k + 137] += amp * sh
    found = _compare(cap, 739e6, np.arange(-3, 4) * 5e3)
    assert len(found) >= 2


def test_device_peaks_match_host_real_capture(capbuf_0000):
    cap, fc = capbuf_0000
    found = _compare(cap, fc, np.arange(-15, 16) * 5e3)
    assert len(found) >= 2  # cells 271 and 277 live in this capture


def test_dead_radio_no_hang_no_cells():
    """An all-zero capture (dead radio: constant 0x7F bytes) must return
    no cells promptly on both peak-search implementations."""
    from lte_cell_scanner.ops.peak_jax import peak_search_device

    zeros = np.zeros((3, 9600))
    host = peak_search(zeros, zeros.astype(int), np.zeros(9600),
                       np.array([0.0]), 739e6, 739e6,
                       np.zeros((3, 9600, 1)), DS_COMB_ARM)
    assert host == []
    table = peak_search_device(jnp.asarray(np.zeros((7, 9600))),
                               jnp.asarray(np.zeros((3, 9600, 1))),
                               1.0, DS_COMB_ARM)
    from lte_cell_scanner.ops.peak_jax import peaks_to_cells
    assert peaks_to_cells(np.asarray(table), np.array([0.0]),
                          739e6, 739e6) == []


def _scan_and_peaks_table(cap, fc, fset):
    from lte_cell_scanner.ops.xcorr import n_comb_sp_for, n_comb_xc_for
    from lte_cell_scanner.ops.xcorr_jax import scan_and_peaks, scan_inputs

    n_comb_xc = n_comb_xc_for(len(cap) - 136, fset, fc, fc, 1.92e6)
    tre, tim, starts = scan_inputs(fset, n_comb_xc, fc, fc, 1.92e6)
    cap_ri = np.stack([cap.real, cap.imag], -1).astype(np.float32)
    return np.asarray(scan_and_peaks(
        jnp.asarray(cap_ri), jnp.asarray(tre), jnp.asarray(tim),
        jnp.asarray(starts),
        r_th1_normalized(n_comb_xc, DS_COMB_ARM, THRESH1_N_NINES),
        n_comb_sp_for(len(cap)), DS_COMB_ARM))


def test_scan_and_peaks_planted_cell_matches_host():
    """The one-program device scan (float32 scan + threshold + greedy
    peaks; the GPU's single-capture path) returns the host float64 peak
    list of a planted cell."""
    from lte_cell_scanner.models.pss import pss_td

    rng = np.random.default_rng(8)
    n, fc = 76800, 739e6
    fset = np.arange(-3, 4) * 5e3
    cap = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
    sh = pss_td(2) * np.exp(1j * 2 * np.pi * 10e3 * np.arange(137) / 1.92e6)
    for k in range(700, n - 137, 9600):
        cap[k:k + 137] += 0.3 * sh
    r = xcorr_pss(cap, fset, DS_COMB_ARM, fc, fc, 1.92e6, backend="numpy")
    z = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    host = peak_search(r.xc_incoherent_collapsed_pow,
                       r.xc_incoherent_collapsed_frq, z, fset, fc, fc,
                       r.xc_incoherent_single, DS_COMB_ARM)
    dev = peaks_to_cells(_scan_and_peaks_table(cap, fc, fset), fset, fc, fc)
    assert len(host) >= 1 and host[0].n_id_2 == 2
    assert [(c.n_id_2, c.ind, c.freq) for c in dev] == \
        [(c.n_id_2, c.ind, c.freq) for c in host]
    np.testing.assert_allclose([c.pss_pow for c in dev],
                               [c.pss_pow for c in host], rtol=1e-4)


def test_scan_and_peaks_dead_radio():
    """A dead radio (constant 0x7F bytes -> an all-zero capture) yields
    an empty peak table from the one-program device scan."""
    cap = np.zeros(76800, complex)
    table = _scan_and_peaks_table(cap, 739e6, np.arange(-1, 2) * 5e3)
    assert table.shape == (64, 4)
    assert peaks_to_cells(table, np.arange(-1, 2) * 5e3, 739e6,
                          739e6) == []

"""Capture-buffer front end: frequency shift + 6-RB decimating FIR.

The reference captures at 1.92 Msps directly from the dongle, so its only
front-end processing is the uint8 conversion. This module adds the
wideband path: captures recorded at any integer
multiple of 1.92 Msps (e.g. 15.36/30.72 Msps full-band LTE recordings)
are frequency-shifted to center the target carrier and decimated to the
6-RB 1.92 Msps analysis rate through an anti-alias FIR.

The passband matches the searcher's occupancy assumption
(rx_cutoff = (6*12*15e3/2 + 4*15e3) of half the 960 kHz Nyquist,
src/CellSearch.cpp:501); the FIR is a Kaiser-windowed sinc designed for
>60 dB stopband rejection.

Device mapping: polyphase decimation is expressed as matmuls — the input
reshapes to (n_out, decim) blocks, a (n_taps_per_phase, decim) tap matrix
contracts both axes — so the front end runs as device matmuls next to
the scan (device path), with an identical float64 NumPy host reference.
"""

from __future__ import annotations

import functools

import numpy as np

from lte_cell_scanner.constants import FS_SEARCH

PASSBAND_HZ = 6 * 12 * 15e3 / 2 + 4 * 15e3     # 600 kHz, see rx_cutoff
STOP_ATTEN_DB = 60.0


def _kaiser_beta(atten_db: float) -> float:
    if atten_db > 50:
        return 0.1102 * (atten_db - 8.7)
    if atten_db >= 21:
        return 0.5842 * (atten_db - 21) ** 0.4 + 0.07886 * (atten_db - 21)
    return 0.0


@functools.lru_cache(maxsize=8)
def design_decimation_fir(decim: int, atten_db: float = STOP_ATTEN_DB
                          ) -> np.ndarray:
    """Anti-alias lowpass for decimation by ``decim`` from
    decim*1.92 Msps: passband 600 kHz, stopband at the alias edge
    (1.92 MHz - 600 kHz folds onto the passband edge)."""
    fs_in = decim * FS_SEARCH
    f_pass = PASSBAND_HZ
    f_stop = FS_SEARCH - PASSBAND_HZ       # first alias into the passband
    df = (f_stop - f_pass) / fs_in
    beta = _kaiser_beta(atten_db)
    n_taps = int(np.ceil((atten_db - 7.95) / (2.285 * 2 * np.pi * df)))
    n_taps = (n_taps // (2 * decim) + 1) * 2 * decim + 1  # odd, phase-align
    n = np.arange(n_taps) - (n_taps - 1) / 2
    fc = (f_pass + f_stop) / 2 / fs_in
    h = 2 * fc * np.sinc(2 * fc * n) * np.kaiser(n_taps, beta)
    return h / h.sum()


def decimate_capture(x: np.ndarray, fs_in: float,
                     freq_shift: float = 0.0,
                     backend: str = "numpy") -> np.ndarray:
    """Shift ``freq_shift`` to baseband and decimate to 1.92 Msps.

    fs_in must be an integer multiple of 1.92 Msps. Returns the
    1.92 Msps complex capture (length floor(len(x)/decim) minus FIR
    startup).
    """
    decim = fs_in / FS_SEARCH
    if abs(decim - round(decim)) > 1e-9:
        raise ValueError(f"fs_in={fs_in} is not a multiple of 1.92 Msps")
    decim = int(round(decim))
    x = np.asarray(x, dtype=complex)
    if freq_shift:
        t = np.arange(len(x))
        x = x * np.exp(-2j * np.pi * freq_shift * t / fs_in)
    if decim == 1:
        return x

    h = design_decimation_fir(decim)
    n_taps = len(h)
    # Polyphase: y[m] = sum_j h_rev[j] x[m*decim + j]
    #          = sum_q X[m + q] . taps_q
    # with X the (n_blocks, decim) reshape of x and taps_q the q-th
    # decim-wide slice of the reversed taps — `phases` matmuls of
    # (n_out, decim) blocks, O(n_out) memory (not the O(n_out * n_taps)
    # im2col form).
    taps = h[::-1].copy()
    phases = -(-n_taps // decim)
    taps = np.pad(taps, (0, phases * decim - n_taps))
    n_blocks = len(x) // decim
    xb = x[:n_blocks * decim].reshape(n_blocks, decim)
    # Output count from the *blocked* length: every phase slice
    # xb[q:q+n_out] must fit in n_blocks rows (a tail of len(x) that is
    # not a whole block is dropped, so deriving n_out from len(x) would
    # leave the last phase's slice one row short for most input lengths).
    n_out = n_blocks - phases + 1
    if n_out < 1:
        raise ValueError(
            f"capture too short to decimate: {len(x)} samples < "
            f"{phases * decim} ({n_taps}-tap FIR at decim={decim})")

    if backend == "jax":
        import jax.numpy as jnp

        from lte_cell_scanner import platform

        @platform.jit
        def run(xr, xi, tp):
            yr = jnp.zeros(n_out, jnp.float32)
            yi = jnp.zeros(n_out, jnp.float32)
            for q in range(phases):
                yr = yr + xr[q:q + n_out] @ tp[q]
                yi = yi + xi[q:q + n_out] @ tp[q]
            return yr, yi

        yr, yi = run(jnp.asarray(xb.real, jnp.float32),
                     jnp.asarray(xb.imag, jnp.float32),
                     jnp.asarray(taps.reshape(phases, decim), jnp.float32))
        return np.asarray(yr, np.float64) + 1j * np.asarray(yi, np.float64)

    y = np.zeros(n_out, dtype=complex)
    tp = taps.reshape(phases, decim)
    for q in range(phases):
        y += xb[q:q + n_out] @ tp[q]
    return y

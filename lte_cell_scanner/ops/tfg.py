"""OFDM demodulation to the time/frequency grid + superfine TOE/FOE/TOC/FOC.

reference: src/searcher.cpp:852-1069 (extract_tfg, tfoec).

The reference demodulates 854 (normal CP) / 732 (extended CP) OFDM symbols
one 128-point DFT at a time; here all symbol windows are gathered into one
(n_ofdm, 128) matrix and transformed with a single batched FFT, with the
fractional-timing phase ramps applied as vectorized outer products — the
same structure the device path jits.
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

from lte_cell_scanner.constants import FS_LTE
from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.models.rs import RSDL

# Subcarrier index relative to DC for the 72 kept subcarriers.
CN = np.concatenate([np.arange(-36, 0), np.arange(1, 37)]).astype(np.float64)


def symbol_timestamps(cell: Cell, fs_programmed: float, k_factor: float
                      ) -> np.ndarray:
    """Fractional DFT start times for 6 frames + 2 slots of OFDM symbols.

    Thin wrapper over :func:`symbol_timestamps_batch` (one row) so the
    timing contract has a single source."""
    return symbol_timestamps_batch(
        cell.cp_type, np.array([cell.frame_start], np.float64),
        np.array([fs_programmed], np.float64),
        np.array([k_factor], np.float64))[0]


def symbol_timestamps_batch(cp_type: str, frame_start: np.ndarray,
                            fs_programmed: np.ndarray,
                            k_factor: np.ndarray) -> np.ndarray:
    """:func:`symbol_timestamps` batched over the candidate axis:
    (n,) float64 inputs -> (n, n_ofdm) fractional DFT start times.

    THE single source of the symbol-timing contract (CP offsets, the
    0.01-subframe early-start rule, the per-CP increment pattern):
    the scalar host path above and the device MIB plan
    (ops/mib_jax.py::mib_plan) both consume it, so a change here
    propagates to every decode path at once."""
    frame_start = np.asarray(frame_start, np.float64)
    fs_programmed = np.asarray(fs_programmed, np.float64)
    k_factor = np.asarray(k_factor, np.float64)
    n_symb_dl = 7 if cp_type == "normal" else 6
    u = 16.0 / FS_LTE * fs_programmed * k_factor
    dft_loc = frame_start + (10.0 if cp_type == "normal" else 32.0) * u

    # See if we can start one subframe earlier.
    early = dft_loc - 0.01 * fs_programmed * k_factor
    dft_loc = np.where(early > -0.5, early, dft_loc)

    n_ofdm = 6 * 10 * 2 * n_symb_dl + 2 * n_symb_dl
    if n_symb_dl == 6:
        pat = np.full(n_ofdm - 1, 128.0 + 32.0)
    else:
        pat = np.tile(128.0 + np.array([9, 9, 9, 9, 9, 9, 10],
                                       np.float64),
                      (n_ofdm + 6) // 7)[:n_ofdm - 1]
    incs = pat[None, :] * u[:, None]
    # np.cumsum (add.accumulate) is strictly sequential per row, so
    # seeding it with dft_loc reproduces the scalar accumulation loop
    # bit-exactly (the round() of these timestamps picks the DFT sample,
    # so the accumulation order is part of the numerical contract).
    return np.cumsum(np.concatenate([dft_loc[:, None], incs], axis=1),
                     axis=1)


def extract_tfg(cell: Cell, capbuf_raw: np.ndarray, fc_requested: float,
                fc_programmed: float, fs_programmed: float
                ) -> Tuple[np.ndarray, np.ndarray]:
    """Returns (tfg (n_ofdm, 72) complex, tfg_timestamp (n_ofdm,) float).

    tfg[t] is the DFT that *should* have been taken at the fractional time
    tfg_timestamp[t]; the integer-sample placement error is compensated by
    a per-subcarrier phase ramp.
    """
    capbuf_raw = np.asarray(capbuf_raw, dtype=np.complex128)
    k_factor = (fc_requested - cell.freq_fine) / fc_programmed
    ts = symbol_timestamps(cell, fs_programmed, k_factor)

    # Global frequency-offset correction.
    t_idx = np.arange(len(capbuf_raw), dtype=np.float64)
    capbuf = capbuf_raw * np.exp(
        1j * 2.0 * np.pi * -cell.freq_fine * t_idx / (fs_programmed * k_factor))

    starts = np.round(ts).astype(np.int64)
    if starts[-1] + 128 > len(capbuf) or starts[0] < 0:
        raise ValueError(
            f"capture too short for TFG extraction: need samples "
            f"[{starts[0]}, {starts[-1] + 128}) of a {len(capbuf)}-sample "
            f"buffer; the MIB search needs ~80 ms (153600 samples) at 1.92 Msps")
    wins = capbuf[starts[:, None] + np.arange(128)[None, :]]
    dft_out = np.fft.fft(wins, axis=-1) / np.sqrt(128.0)
    tfg = np.concatenate([dft_out[:, 92:128], dft_out[:, 1:37]], axis=1)

    late = starts - ts
    tfg = tfg * np.exp(-1j * 2.0 * np.pi * late[:, None] * CN[None, :] / 128.0)
    return tfg, ts


def tfoec(cell: Cell, tfg: np.ndarray, tfg_timestamp: np.ndarray,
          fc_requested: float, fc_programmed: float, rs_dl: RSDL
          ) -> Tuple[Cell, np.ndarray, np.ndarray]:
    """Superfine FOE/FOC + TOE/TOC on the grid; fills freq_superfine.

    Returns (cell_out, tfg_comp, tfg_comp_timestamp).
    """
    n_symb_dl = cell.n_symb_dl
    n_ofdm = tfg.shape[0]
    n_slot = n_ofdm // n_symb_dl

    # ---- superfine FOE: product of same-subcarrier RS across consecutive
    # slots, for both RS-bearing OFDM symbols (0 and n_symb_dl-3).
    foe = 0.0 + 0.0j
    for sym_num in (0, n_symb_dl - 3):
        shift = int(rs_dl.get_shift(0, sym_num, 0))
        rows = np.arange(n_slot) * n_symb_dl + sym_num
        rs_ext = tfg[rows][:, shift::6]                      # (n_slot, 12)
        known = np.stack([np.conj(rs_dl.get_rs(t % 20, sym_num))
                          for t in range(n_slot)])
        rs_comp = rs_ext * known
        foe += np.sum(np.conj(rs_comp[:-1]) * rs_comp[1:])
    residual_f = float(np.angle(foe)) / (2 * np.pi) / 0.0005

    # ---- FOC (bulk frequency offset + inter-symbol time rescale)
    k_factor_residual = (fc_requested - residual_f) / fc_programmed
    tfg_comp_timestamp = k_factor_residual * tfg_timestamp
    rot = np.exp(1j * 2.0 * np.pi * -residual_f * tfg_comp_timestamp / (FS_LTE / 16))
    late = tfg_timestamp - tfg_comp_timestamp
    tfg_comp = tfg * rot[:, None] * np.exp(
        -1j * 2.0 * np.pi * late[:, None] * CN[None, :] / 128.0)

    # ---- TOE: compare staggered RS (subcarrier k vs k+3) of adjacent
    # RS-bearing symbols.
    toe = 0.0 + 0.0j
    for t in range(2 * n_slot - 1):
        def rs_row(i):
            sym_num = (n_symb_dl - 3) if (i & 1) else 0
            slot_num = (i >> 1) % 20
            offset = (i >> 1) * n_symb_dl + sym_num
            shift = int(rs_dl.get_shift(0, sym_num, 0))
            row = tfg_comp[offset, shift::6] * np.conj(rs_dl.get_rs(slot_num, sym_num))
            return row, shift
        cur, cur_shift = rs_row(t)
        nxt, nxt_shift = rs_row(t + 1)
        if cur_shift < nxt_shift:
            r1v, r2v = cur, nxt
        else:
            r1v, r2v = nxt, cur
        toe += np.sum(np.conj(r1v) * r2v)
        toe += np.sum(np.conj(r2v[0:11]) * r1v[1:12])
    delay = -float(np.angle(toe)) / 3 / (2 * np.pi / 128)

    # ---- TOC
    tfg_comp = tfg_comp * np.exp(1j * 2.0 * np.pi / 128 * delay * CN)[None, :]

    out = dataclasses.replace(cell)
    out.freq_superfine = cell.freq_fine + residual_f
    return out, tfg_comp, tfg_comp_timestamp

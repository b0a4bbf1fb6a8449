"""Per-port channel estimation over the time/frequency grid.

reference: src/searcher.cpp:1072-1477 (chan_est + the three interpolators
ce_interp_hex / ce_interp_freq_time / ce_interp_2stage; the hex variant is
the one the reference enables, the others are kept for parity options —
the reference notes they perform equivalently, src/searcher.cpp:1472-1475).
"""

from __future__ import annotations

from typing import Tuple

import functools

import numpy as np

from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.models.rs import RSDL
from lte_cell_scanner.utils.dsp import interp1


def _raw_ce(cell: Cell, rs_dl: RSDL, tfg: np.ndarray, port: int):
    """Raw channel estimates at RS positions.

    Returns (ce_raw (n_rs_ofdm, 12), rs_set, shift[2]).
    """
    n_symb_dl = cell.n_symb_dl
    n_ofdm = tfg.shape[0]
    if port <= 1:
        rs_set = np.sort(np.concatenate([
            np.arange(0, n_ofdm, n_symb_dl),
            np.arange(n_symb_dl - 3, n_ofdm, n_symb_dl),
        ]))
    else:
        rs_set = np.arange(1, n_ofdm, n_symb_dl)
    n_rs_ofdm = len(rs_set)

    ce_raw = np.empty((n_rs_ofdm, 12), dtype=np.complex128)
    shift = np.full(2, -1000, dtype=np.int64)
    slot_num = 0
    for t in range(n_rs_ofdm):
        sym_num = int(rs_set[t] % n_symb_dl)
        sh = int(rs_dl.get_shift(slot_num % 20, sym_num, port))
        if t <= 1:
            shift[t] = sh
        rs = rs_dl.get_rs(slot_num, sym_num)
        ce_raw[t] = tfg[rs_set[t], sh::6] * np.conj(rs)
        if (t & 1) == 1 or port >= 2:
            slot_num = (slot_num + 1) % 20
    return ce_raw, rs_set, shift


def _filter_ce(ce_raw: np.ndarray, shift: np.ndarray) -> np.ndarray:
    """7-point hex-neighborhood averaging filter.

    For staggered ports (0/1) each filtered estimate averages up to 3
    same-row neighbors plus 2 neighbors in each adjacent RS row; for ports
    2/3 (aligned combs) the adjacent rows contribute 3 each.
    reference: src/searcher.cpp:1421-1467.
    """
    n_rs_ofdm, n_sc = ce_raw.shape
    ce_filt = np.empty_like(ce_raw)
    current_row_leftmost = shift[0] < shift[1]
    for t in range(n_rs_ofdm):
        for k in range(n_sc):
            ind = [i for i in (k - 1, k, k + 1) if 0 <= i < n_sc]
            total = ce_raw[t, ind].sum()
            n_total = len(ind)
            if shift[0] == shift[1]:
                ind2 = (k - 1, k, k + 1)
            elif current_row_leftmost:
                ind2 = (k - 1, k)
            else:
                ind2 = (k, k + 1)
            ind2 = [i for i in ind2 if 0 <= i < n_sc]
            if t != 0:
                total += ce_raw[t - 1, ind2].sum()
                n_total += len(ind2)
            if t != n_rs_ofdm - 1:
                total += ce_raw[t + 1, ind2].sum()
                n_total += len(ind2)
            ce_filt[t, k] = total / n_total
        current_row_leftmost = not current_row_leftmost
    return ce_filt


def ce_interp_freq_time(ce_filt, shift, n_ofdm, rs_set):
    """Separable linear interpolation: frequency first, then time.

    reference: src/searcher.cpp:1089-1119. This is the interpolator used by
    the device path (fully vectorizable); the reference documents it as
    equivalent to the hex interpolator.
    """
    n_rs_ofdm = len(rs_set)
    ce_frq = np.empty((n_rs_ofdm, 72), dtype=np.complex128)
    x_all = np.arange(72, dtype=np.float64)
    for t in range(n_rs_ofdm):
        X = np.arange(shift[t & 1], 72, 6, dtype=np.float64)
        ce_frq[t] = interp1(X, ce_filt[t], x_all)
    ce_tfg = np.empty((n_ofdm, 72), dtype=np.complex128)
    tq = np.arange(n_ofdm, dtype=np.float64)
    for k in range(72):
        ce_tfg[:, k] = interp1(rs_set.astype(np.float64), ce_frq[:, k], tq)
    return ce_tfg


def ce_interp_2stage(ce_filt, shift, n_ofdm, rs_set):
    """Hex grid -> uniform 3-spaced grid -> separable linear interpolation.

    reference: src/searcher.cpp:1125-1196.
    """
    n_rs_ofdm = len(rs_set)
    ce_exp = np.empty((n_rs_ofdm, 24), dtype=np.complex128)
    current_row_leftmost = shift[0] < shift[1]
    for t in range(n_rs_ofdm):
        for k in range(24):
            if (k & 1) == int(current_row_leftmost):
                total = 0.0 + 0.0j
                n_total = 0
                if t - 1 >= 0:
                    total += ce_filt[t - 1, k >> 1]
                    n_total += 1
                if t + 1 < n_rs_ofdm:
                    total += ce_filt[t + 1, k >> 1]
                    n_total += 1
                if ((k - 1) >> 1) >= 0:
                    total += ce_filt[t, (k - 1) >> 1]
                    n_total += 1
                if ((k + 1) >> 1) < 12:
                    total += ce_filt[t, (k + 1) >> 1]
                    n_total += 1
                ce_exp[t, k] = total / n_total
            else:
                ce_exp[t, k] = ce_filt[t, k >> 1]
        current_row_leftmost = not current_row_leftmost
    X = np.arange(min(shift), 72, 3, dtype=np.float64)[:24]
    ce_tfg = np.empty((n_ofdm, 72), dtype=np.complex128)
    x_all = np.arange(72, dtype=np.float64)
    rows = np.empty((n_rs_ofdm, 72), dtype=np.complex128)
    for t in range(n_rs_ofdm):
        rows[t] = interp1(X, ce_exp[t], x_all)
    tq = np.arange(n_ofdm, dtype=np.float64)
    for k in range(72):
        ce_tfg[:, k] = interp1(rs_set.astype(np.float64), rows[:, k], tq)
    return ce_tfg


def _hex_extend(row_x: np.ndarray, row_val: np.ndarray):
    """Extrapolate so each RS row has vertices at subcarriers 0 and 71.

    reference: src/searcher.cpp:1200-1213.
    """
    row_x = list(row_x)
    row_val = list(row_val)
    if row_x[0] != 0:
        v = row_val[0] - row_x[0] * (row_val[1] - row_val[0]) / (row_x[1] - row_x[0])
        row_x.insert(0, 0.0)
        row_val.insert(0, v)
    if row_x[-1] != 71:
        v = row_val[-1] + (71 - row_x[-1]) * (row_val[-1] - row_val[-2]) / (
            row_x[-1] - row_x[-2])
        row_x.append(71.0)
        row_val.append(v)
    return np.array(row_x), np.array(row_val)


def _hex_fill_pair(top_v, bot_v, top_shift, bot_shift, spacing):
    """Exact scalar triangle-strip fill for ONE pair of adjacent RS rows
    (rows 1..spacing between them). Extracted from the reference sweep
    (src/searcher.cpp:1223-1362); used directly and as the probe for the
    cached linear map below."""
    top_x, top_v = _hex_extend(
        np.arange(top_shift, 72, 6, dtype=np.float64), top_v)
    bot_x, bot_v = _hex_extend(
        np.arange(bot_shift, 72, 6, dtype=np.float64), bot_v)
    y_top, y_bot = 0.0, float(spacing)
    out = np.empty((spacing, 72), dtype=np.asarray(top_v).dtype)

    if top_x[1] < bot_x[1]:
        tri = [(top_x[0], y_top, top_v[0]), (bot_x[0], y_bot, bot_v[0]),
               (top_x[1], y_top, top_v[1])]
        top_used, bot_used = 1, 0
    else:
        tri = [(bot_x[0], y_bot, bot_v[0]), (top_x[0], y_top, top_v[0]),
               (bot_x[1], y_bot, bot_v[1])]
        top_used, bot_used = 0, 1

    x_offset = np.zeros(spacing + 1, dtype=np.int64)
    while True:
        (x0, y0, v0), (x1, y1, v1), (x2, y2, v2) = tri
        det = (x0 * (y1 - y2) + x1 * (y2 - y0) + x2 * (y0 - y1))
        a = (v0 * (y1 - y2) + v1 * (y2 - y0) + v2 * (y0 - y1)) / det
        b = (v0 * (x2 - x1) + v1 * (x0 - x2) + v2 * (x1 - x0)) / det
        c = (v0 * (x1 * y2 - x2 * y1) + v1 * (x2 * y0 - x0 * y2)
             + v2 * (x0 * y1 - x1 * y0)) / det
        a_l = (x1 - x2) / (y1 - y2)
        b_l = (y1 * x2 - y2 * x1) / (y1 - y2)

        for r in range(1, spacing + 1):
            limit = a_l * r + b_l
            hi = min(int(np.floor(limit)), 71)
            lo = x_offset[r]
            if hi >= lo:
                xs = np.arange(lo, hi + 1)
                out[r - 1, lo:hi + 1] = a * xs + b * r + c
                x_offset[r] = hi + 1

        if x_offset[1] == 72 and x_offset[spacing] == 72:
            break
        if tri[2][1] == y_top:
            bot_used += 1
            nxt = (bot_x[bot_used], y_bot, bot_v[bot_used])
        else:
            top_used += 1
            nxt = (top_x[top_used], y_top, top_v[top_used])
        tri = [tri[1], tri[2], nxt]
    return out


@functools.lru_cache(maxsize=64)
def _hex_pair_map(top_shift: int, bot_shift: int, spacing: int) -> np.ndarray:
    """(spacing*72, 24) linear map from the pair's 2x12 raw CE values to
    the interpolated grid rows. The fill (planes + edge extrapolation) is
    linear in the values, so probing the exact scalar implementation with
    the 24 basis vectors captures it exactly."""
    w = np.empty((spacing * 72, 24))
    for i in range(24):
        basis = np.zeros(24)
        basis[i] = 1.0
        out = _hex_fill_pair(basis[:12].copy(), basis[12:].copy(),
                             top_shift, bot_shift, spacing)
        w[:, i] = out.reshape(-1)
    return w


def ce_interp_hex(ce_filt, shift, n_ofdm, rs_set):
    """Delaunay-triangle planar interpolation over the hex RS lattice.

    reference: src/searcher.cpp:1223-1362 (the enabled interpolator,
    mirroring MATLAB griddata in chan_est.m:132). Between each pair of
    adjacent RS rows a strip of triangles is swept; since the sweep is a
    fixed LINEAR function of the two rows' values for each lattice
    geometry, each pair reduces to one cached (spacing*72, 24) matmul.
    """
    rs_set = np.asarray(rs_set)
    n_rs_ofdm = len(rs_set)
    ce_tfg = np.empty((n_ofdm, 72), dtype=np.complex128)

    for t in range(n_rs_ofdm - 1):
        top_shift = int(shift[1] if (t & 1) else shift[0])
        bot_shift = int(shift[0] if (t & 1) else shift[1])
        spacing = int(rs_set[t + 1] - rs_set[t])
        if t == 0:
            top_x, top_v = _hex_extend(
                np.arange(top_shift, 72, 6, dtype=np.float64), ce_filt[t])
            ce_tfg[rs_set[0]] = interp1(top_x, top_v, np.arange(72.0))
        w = _hex_pair_map(top_shift, bot_shift, spacing)
        vals = np.concatenate([ce_filt[t], ce_filt[t + 1]])
        ce_tfg[rs_set[t] + 1: rs_set[t + 1] + 1] = \
            (w @ vals).reshape(spacing, 72)

    # Rows before the first / after the last RS symbol copy the nearest one.
    ce_tfg[:rs_set[0]] = ce_tfg[rs_set[0]]
    ce_tfg[rs_set[-1] + 1:] = ce_tfg[rs_set[-1]]
    return ce_tfg


def chan_est(cell: Cell, rs_dl: RSDL, tfg: np.ndarray, port: int,
             interp: str = "hex") -> Tuple[np.ndarray, float]:
    """Channel estimate for every RE of one antenna port + noise power."""
    ce_raw, rs_set, shift = _raw_ce(cell, rs_dl, tfg, port)
    ce_filt = _filter_ce(ce_raw, shift)
    np_est = float(np.mean(np.abs(ce_filt - ce_raw) ** 2))
    n_ofdm = tfg.shape[0]
    if interp == "hex":
        ce_tfg = ce_interp_hex(ce_filt, shift, n_ofdm, rs_set)
    elif interp == "freq_time":
        ce_tfg = ce_interp_freq_time(ce_filt, shift, n_ofdm, rs_set)
    elif interp == "2stage":
        ce_tfg = ce_interp_2stage(ce_filt, shift, n_ofdm, rs_set)
    else:
        raise ValueError(f"unknown interpolator {interp!r}")
    return ce_tfg, np_est

"""Device-side greedy peak extraction.

Functionally identical to ops.peak.peak_search (reference:
src/searcher.cpp:422-510, Matlab/peak_search.m) but expressed as a
fixed-trip-count jax loop over the collapsed (3, 9600) table so the whole
scan -> threshold -> peak pipeline can run in ONE device program
(ops/xcorr_jax.scan_and_peaks). Fetching the collapsed tables to the host
costs ~300 KB per capture, while the peak list is ~1 KB, so the
sequential-but-tiny greedy loop runs on the device and only the peak
list comes home.

The greedy loop is inherently sequential (each extraction cancels
neighbors before the next argmax — SURVEY §7 "hard parts"); it stays
sequential here, just sequential *on device* with vectorized cancellation.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

from lte_cell_scanner.constants import HALF_FRAME, RX_CUTOFF
from lte_cell_scanner.models.cell import Cell

MAX_PEAKS = 64  # >= the ~52 the cancellation geometry can possibly yield
_DB8 = 10.0 ** (-8.0 / 10.0)
_DB12 = 10.0 ** (-12.0 / 10.0)


def r_th1_normalized(n_comb_xc: int, ds_comb_arm: int,
                     thresh1_n_nines: int = 12) -> float:
    """Host-precomputed scalar so the device threshold is just
    r_norm * sp_incoherent (src/CellSearch.cpp:500-503)."""
    from lte_cell_scanner.utils.dsp import chi2cdf_inv

    dof = 2 * n_comb_xc * (2 * ds_comb_arm + 1)
    r_th1 = chi2cdf_inv(1 - 10.0 ** (-thresh1_n_nines), dof)
    return float(r_th1 / RX_CUTOFF / 137 / 2 / n_comb_xc
                 / (2 * ds_comb_arm + 1))


def peak_search_device(packed: jnp.ndarray, single: jnp.ndarray,
                       r_norm: float, ds_comb_arm: int,
                       max_peaks: int = MAX_PEAKS) -> jnp.ndarray:
    """Extract up to max_peaks peaks on device.

    packed: (7, HALF_FRAME) — rows 0-2 collapsed pow, 3-5 collapsed frq,
    6 sp_incoherent (the scan core's output). single: (3, HALF_FRAME, n_f).
    Returns (max_peaks, 4) float32 rows [pow, refined_ind, foi, n_id_2],
    with pow == 0 marking unused slots (a real peak always has pow > 0).
    """
    pow0 = packed[0:3]
    frq = packed[3:6].astype(jnp.int32)
    z_th1 = r_norm * packed[6]                       # (HALF_FRAME,)
    lag_idx = jnp.arange(HALF_FRAME, dtype=jnp.int32)
    row_idx = jnp.arange(3, dtype=jnp.int32)[:, None]

    def body(_, state):
        working, out, count, done = state
        flat = jnp.argmax(working)
        n2 = (flat // HALF_FRAME).astype(jnp.int32)
        ind = (flat % HALF_FRAME).astype(jnp.int32)
        peak_pow = working[n2, ind]
        valid = jnp.logical_and(
            jnp.logical_not(done),
            jnp.logical_and(peak_pow >= z_th1[ind], peak_pow > 0.0))

        # Refine to the strongest single lag within +/-ds_comb_arm
        # (src/searcher.cpp:457-465).
        foi = frq[n2, ind]
        offs = jnp.arange(-ds_comb_arm, ds_comb_arm + 1, dtype=jnp.int32)
        tws = jnp.mod(ind + offs, HALF_FRAME)
        vals = single[n2, tws, foi]
        best_ind = tws[jnp.argmax(vals)]

        rec = jnp.array([0.0, 0.0, 0.0, 0.0], jnp.float32).at[0].set(
            peak_pow).at[1].set(best_ind.astype(jnp.float32)).at[2].set(
            foi.astype(jnp.float32)).at[3].set(n2.astype(jnp.float32))
        zero = jnp.int32(0)
        out = jax.lax.cond(
            valid, lambda o: jax.lax.dynamic_update_slice(
                o, rec[None], (count, zero)), lambda o: o, out)

        # Cancellation (vectorized): +/-274 cyclic window.
        dist = jnp.abs(jnp.mod(lag_idx - ind + HALF_FRAME // 2,
                               HALF_FRAME) - HALF_FRAME // 2)
        near = (dist <= 2 * 137)[None, :]            # (1, HALF_FRAME)
        same = row_idx == n2
        w = working
        w = jnp.where(near & same, 0.0, w)
        w = jnp.where(near & ~same & (w < peak_pow * _DB8), 0.0, w)
        w = jnp.where(w < peak_pow * _DB12, 0.0, w)
        working = jnp.where(valid, w, working)

        count = count + valid.astype(jnp.int32)
        done = jnp.logical_not(valid)
        return working, out, count, done

    out0 = jnp.zeros((max_peaks, 4), jnp.float32)
    state = (pow0.astype(jnp.float32), out0, jnp.int32(0), jnp.bool_(False))
    # Early-exit loop: a typical capture yields a handful of peaks, so
    # running the full max_peaks trips (each a sequential argmax over the
    # 3x9600 table) would dominate the device program; the while_loop
    # stops at the first below-threshold extraction.
    _, out, count, done = jax.lax.while_loop(
        lambda s: jnp.logical_and(jnp.logical_not(s[3]), s[2] < max_peaks),
        lambda s: body(None, s), state)
    return out


def peaks_to_cells(peaks: np.ndarray, f_search_set: np.ndarray,
                   fc_requested: float, fc_programmed: float,
                   fs_programmed: float = 1.92e6) -> List[Cell]:
    """Convert the device peak table to Cell records (host side)."""
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    cells: List[Cell] = []
    for row in np.asarray(peaks, dtype=np.float64):
        if row[0] <= 0.0:
            break
        cells.append(Cell(
            fc_requested=fc_requested,
            fc_programmed=fc_programmed,
            fs_programmed=fs_programmed,
            pss_pow=float(row[0]),
            ind=float(row[1]),
            freq=float(f_search_set[int(row[2])]),
            n_id_2=int(row[3]),
        ))
    return cells

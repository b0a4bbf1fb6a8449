"""Greedy peak extraction from the collapsed correlation table.

reference: src/searcher.cpp:422-510 and Matlab/peak_search.m. This stage is
inherently sequential over a tiny (3 x 9600) table, so it runs on the host.

Cancellation policy follows the MATLAB prototype (the algorithm's source of
truth): after extracting a peak,
  1. the same PSS row is zeroed within +/-274 samples,
  2. other PSS rows within that window are zeroed where they are more than
     8 dB below the peak (the C++ port's version of this loop indexes the
     peak's own row and is a no-op),
  3. everything more than 12 dB below the peak is zeroed (CRS
     self-correlation ghosts).
"""

from __future__ import annotations

from typing import List

import numpy as np

from lte_cell_scanner.constants import HALF_FRAME
from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.utils.dsp import udb10


def peak_search(
    xc_incoherent_collapsed_pow: np.ndarray,
    xc_incoherent_collapsed_frq: np.ndarray,
    Z_th1: np.ndarray,
    f_search_set: np.ndarray,
    fc_requested: float,
    fc_programmed: float,
    xc_incoherent_single: np.ndarray,
    ds_comb_arm: int,
    fs_programmed: float = 1.92e6,
) -> List[Cell]:
    working = np.array(xc_incoherent_collapsed_pow, dtype=np.float64, copy=True)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    cells: List[Cell] = []

    while True:
        flat = int(np.argmax(working))
        peak_n_id_2, peak_ind = np.unravel_index(flat, working.shape)
        peak_pow = working[peak_n_id_2, peak_ind]
        if peak_pow < Z_th1[peak_ind] or peak_pow <= 0.0:
            # <=0 guard: an all-zero capture (dead radio) makes both the
            # table and the threshold exactly 0, which would loop forever.
            break

        # Refine: the collapsed peak sums energy over +/-ds_comb_arm lags;
        # pick the single strongest lag within that window.
        # (reference: src/searcher.cpp:457-465)
        foi = int(xc_incoherent_collapsed_frq[peak_n_id_2, peak_ind])
        best_pow = -np.inf
        best_ind = -1
        for t in range(peak_ind - ds_comb_arm, peak_ind + ds_comb_arm + 1):
            tw = t % HALF_FRAME
            v = xc_incoherent_single[peak_n_id_2, tw, foi]
            if v > best_pow:
                best_pow = v
                best_ind = tw

        cells.append(Cell(
            fc_requested=fc_requested,
            fc_programmed=fc_programmed,
            fs_programmed=fs_programmed,
            pss_pow=float(peak_pow),
            ind=float(best_ind),
            freq=float(f_search_set[foi]),
            n_id_2=int(peak_n_id_2),
        ))

        # 1. No same-PSS peaks within 2*137 samples.
        cancel = np.mod(np.arange(peak_ind - 274, peak_ind + 275), HALF_FRAME)
        working[peak_n_id_2, cancel] = 0.0
        # 2. Other PSS rows near this peak survive only above -8 dB relative.
        thresh8 = peak_pow * udb10(-8.0)
        for n in range(3):
            if n == peak_n_id_2:
                continue
            sub = working[n, cancel]
            sub[sub < thresh8] = 0.0
            working[n, cancel] = sub
        # 3. CRS ghosts: cancel everything 12 dB below the peak.
        working[working < peak_pow * udb10(-12.0)] = 0.0

    return cells

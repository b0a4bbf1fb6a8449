"""Batch cell search: the per-frequency pipeline and the fc sweep driver.

reference: src/CellSearch.cpp:437-618. For each center frequency:
capture -> xcorr_pss -> threshold -> peak_search, then per candidate peak
sss_detect -> pss_sss_foe -> extract_tfg -> tfoec -> decode_mib, dropping
candidates that fail SSS or MIB; finally dedup across the sweep.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from lte_cell_scanner.constants import (
    DS_COMB_ARM,
    RX_CUTOFF,
    THRESH1_N_NINES,
    THRESH2_N_SIGMA,
)
from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.models.rs import RSDL
from lte_cell_scanner.ops.chanest import chan_est  # noqa: F401 (re-export)
from lte_cell_scanner.ops.peak import peak_search
from lte_cell_scanner.ops.pbch import decode_mib
from lte_cell_scanner.ops.sync import pss_sss_foe, sss_detect
from lte_cell_scanner.ops.tfg import extract_tfg, tfoec
from lte_cell_scanner.ops.xcorr import xcorr_pss
from lte_cell_scanner.utils.dsp import chi2cdf_inv, matlab_range


def generate_search_sets(freq_start: float, freq_end: float, ppm: float):
    """Center-frequency sweep (100 kHz raster) and per-fc offset grid.

    reference: src/CellSearch.cpp:463-465.
    """
    n_extra = int(np.floor((freq_start * ppm / 1e6 + 2.5e3) / 5e3))
    f_search_set = matlab_range(-n_extra * 5000.0, 5000.0, n_extra * 5000.0)
    fc_search_set = matlab_range(freq_start, 100e3, freq_end)
    return fc_search_set, f_search_set


def detection_threshold(sp_incoherent: np.ndarray, n_comb_xc: int,
                        ds_comb_arm: int = DS_COMB_ARM,
                        thresh1_n_nines: int = THRESH1_N_NINES) -> np.ndarray:
    """Per-lag power threshold Z_th1 from the chi-squared false-alarm target.

    reference: src/CellSearch.cpp:500-503; derivation in
    Matlab/pss_search_final.m:207-255.
    """
    dof = 2 * n_comb_xc * (2 * ds_comb_arm + 1)
    r_th1 = chi2cdf_inv(1 - 10.0 ** (-thresh1_n_nines), dof)
    return (r_th1 * sp_incoherent / RX_CUTOFF / 137 / 2
            / n_comb_xc / (2 * ds_comb_arm + 1))


def cell_search(
    capbuf: np.ndarray,
    fc_requested: float,
    fc_programmed: Optional[float] = None,
    fs_programmed: float = 1.92e6,
    f_search_set: Optional[Sequence[float]] = None,
    ds_comb_arm: int = DS_COMB_ARM,
    thresh2_n_sigma: float = THRESH2_N_SIGMA,
    backend: str = "numpy",
    interp: str = "hex",
    verbose: int = 0,
) -> List[Cell]:
    """Full search of one capture buffer at one center frequency.

    Returns the list of fully decoded cells (every returned cell has a
    valid MIB).
    """
    if fc_programmed is None:
        fc_programmed = fc_requested
    if f_search_set is None:
        f_search_set = np.array([0.0])
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    capbuf = np.asarray(capbuf, dtype=np.complex128)

    peaks = None
    if backend == "jax":
        from lte_cell_scanner import platform

        if platform.device_peaks():
            peaks = _device_peaks(capbuf, f_search_set, fc_requested,
                                  fc_programmed, fs_programmed, ds_comb_arm)
    if peaks is None:
        r = xcorr_pss(capbuf, f_search_set, ds_comb_arm, fc_requested,
                      fc_programmed, fs_programmed, backend=backend)
        z_th1 = detection_threshold(r.sp_incoherent, r.n_comb_xc,
                                    ds_comb_arm)
        peaks = peak_search(r.xc_incoherent_collapsed_pow,
                            r.xc_incoherent_collapsed_frq, z_th1,
                            f_search_set, fc_requested, fc_programmed,
                            r.xc_incoherent_single, ds_comb_arm,
                            fs_programmed)
    if verbose:
        print(f"  {len(peaks)} candidate peak(s)")

    if backend == "jax":
        # Full-device decode: the whole per-peak chain (SSS detect, fine
        # FOE, TFG extraction, TFOEC, 4-port channel estimation, blind
        # MIB decode with batched Viterbi) runs as two fixed-shape device
        # programs over ALL candidates at once; the host only does the
        # float64 window planning and the final MIB unpack. The device
        # channel estimator honors ``interp`` for "hex" (the reference's
        # enabled interpolator) and "freq_time"; "2stage" is host-only
        # and runs as freq_time on device (all three are documented
        # equivalent, src/searcher.cpp:1472-1475).
        import jax.numpy as jnp

        from lte_cell_scanner.ops.mib_jax import decode_mib_batch
        from lte_cell_scanner.ops.sync_jax import sss_foe_batch

        cap_dev = jnp.asarray(np.stack(
            [capbuf.real, capbuf.imag], -1).astype(np.float32))
        synced = sss_foe_batch(peaks, capbuf, fc_requested, fc_programmed,
                               fs_programmed, thresh2_n_sigma,
                               cap_dev=cap_dev)
        alive = [c for c in synced if c.n_id_1 >= 0]
        if verbose >= 2 and len(alive) < len(synced):
            print(f"    {len(synced) - len(alive)} peak(s) failed SSS "
                  "detection")
        detected = []
        for cp in ("normal", "extended"):
            group = [c for c in alive if c.cp_type == cp]
            if not group:
                continue
            for cell in decode_mib_batch(group, capbuf, fc_requested,
                                         fc_programmed, fs_programmed,
                                         cap_dev=cap_dev, interp=interp):
                if cell.n_rb_dl < 0:
                    if verbose >= 2:
                        print("    peak failed MIB decode")
                    continue
                detected.append(cell)
                if verbose:
                    print(f"  cell ID {cell.n_id_cell()}: "
                          f"{cell.n_rb_dl} RB, {cell.cp_type} CP, foff "
                          f"{cell.freq_superfine:+.1f} Hz")
        return detected

    detected: List[Cell] = []
    for cell in peaks:
        cell = sss_detect(cell, capbuf, thresh2_n_sigma, fc_requested,
                          fc_programmed, fs_programmed)
        if cell.n_id_1 < 0:
            if verbose >= 2:
                print("    peak failed SSS detection")
            continue
        cell = pss_sss_foe(cell, capbuf, fc_requested, fc_programmed,
                           fs_programmed)
        tfg, tfg_timestamp = extract_tfg(cell, capbuf, fc_requested,
                                         fc_programmed, fs_programmed)
        rs_dl = RSDL(cell.n_id_cell(), 6, cell.cp_type)
        cell, tfg_comp, _ = tfoec(cell, tfg, tfg_timestamp, fc_requested,
                                  fc_programmed, rs_dl)
        cell = decode_mib(cell, tfg_comp, rs_dl, interp=interp)
        if cell.n_rb_dl < 0:
            if verbose >= 2:
                print("    peak failed MIB decode")
            continue
        detected.append(cell)
        if verbose:
            print(f"  cell ID {cell.n_id_cell()}: {cell.n_rb_dl} RB, "
                  f"{cell.cp_type} CP, foff {cell.freq_superfine:+.1f} Hz")
    return detected


def _device_peaks(capbuf, f_search_set, fc_requested, fc_programmed,
                  fs_programmed, ds_comb_arm) -> Optional[List[Cell]]:
    """The scan, threshold and greedy peak search as ONE device program
    (ops/xcorr_jax.scan_and_peaks); the host receives only the ~1 KB
    peak table. None when the table filled up: the fixed-size device
    loop may have truncated a denser capture, so the caller redoes it
    with the unbounded host scan."""
    import jax.numpy as jnp

    from lte_cell_scanner.ops.peak_jax import peaks_to_cells, r_th1_normalized
    from lte_cell_scanner.ops.xcorr import n_comb_sp_for, n_comb_xc_for
    from lte_cell_scanner.ops.xcorr_jax import scan_and_peaks, scan_inputs

    n_cap = len(capbuf)
    n_comb_xc = n_comb_xc_for(n_cap - 136, f_search_set, fc_requested,
                              fc_programmed, fs_programmed)
    tre, tim, starts = scan_inputs(f_search_set, n_comb_xc, fc_requested,
                                   fc_programmed, fs_programmed)
    cap_ri = np.stack([capbuf.real, capbuf.imag], -1).astype(np.float32)
    table = np.asarray(scan_and_peaks(
        jnp.asarray(cap_ri), jnp.asarray(tre), jnp.asarray(tim),
        jnp.asarray(starts), r_th1_normalized(n_comb_xc, ds_comb_arm,
                                              THRESH1_N_NINES),
        n_comb_sp_for(n_cap), ds_comb_arm))
    peaks = peaks_to_cells(table, f_search_set, fc_requested,
                           fc_programmed, fs_programmed)
    return None if len(peaks) >= table.shape[0] else peaks


def dedup(cells: List[Cell]) -> List[Cell]:
    """Merge duplicate detections of the same cell within 1 MHz; keep the
    strongest. reference: src/CellSearch.cpp:285-319.
    """
    final: List[Cell] = []
    for c in cells:
        for i, f in enumerate(final):
            if (c.n_id_cell() == f.n_id_cell()
                    and abs((c.fc_requested + c.freq_superfine)
                            - (f.fc_requested + f.freq_superfine)) < 1e6):
                if c.pss_pow > f.pss_pow:
                    final[i] = c
                break
        else:
            final.append(c)
    return final

"""Precision parity checks of the device programs against the float64
host reference, on the numerics of the device they run on.

On an NVIDIA GPU a float32 matmul may run in TF32 unless a precision is
named; the device programs name it (platform.MATMUL_PRECISION). These
checks pin the result at production shapes:

- the PSS scan matmul (ops/xcorr_jax.correlate_conv): tables against the
  float64 host scan, and the device peak list against the host one;
- the 128->72 DFT products of the MIB program's grid extraction
  (ops/mib_jax): the full grid against ops/tfg.extract_tfg;
- the deratematch einsum and the whole MIB chain: decoded cells against
  the host decode, normal and extended CP;
- the Viterbi branch-metric matmul (models/convcode_jax): decodes
  bit-identical to the host decoder at the 768-decode MIB batch.

Each check returns its measured numbers and raises AssertionError when a
bound is broken. tests/test_gpu.py runs them under the ``gpu`` marker;
chip_smoke.py runs them in its own process.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from lte_cell_scanner.constants import DS_COMB_ARM, THRESH2_N_SIGMA

FC = 739e6
FS = 1.92e6


def scan_parity(seed: int = 0) -> dict:
    """Full 153600-sample capture, the ppm=100 grid (31 hypotheses):
    float32 device tables within 1e-4 of the float64 host tables
    (relative to the table maximum; float32 rounding of 274-term dot
    products is ~1e-6, TF32's 10-bit mantissa ~1e-3), and the same peak
    list from the one-program device scan as from the host peak
    search."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.ops.peak import peak_search
    from lte_cell_scanner.ops.xcorr import xcorr_pss
    from lte_cell_scanner.ops.xcorr_jax import xcorr_pss_jax
    from lte_cell_scanner.search.cell_search import (_device_peaks,
                                                     detection_threshold,
                                                     generate_search_sets)

    _, fset = generate_search_sets(FC, FC, 100)
    cap = synthetic_capture(seed=seed, snr_db=0.0, freq_offset=-41.3e3)
    host = xcorr_pss(cap, fset, DS_COMB_ARM, FC, FC, FS, backend="numpy")
    dev = xcorr_pss_jax(cap, fset, DS_COMB_ARM, FC, FC, FS,
                        dtype=np.float32)

    def rel(a, b):
        a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
        return float(np.abs(a - b).max() / np.abs(b).max())

    out = {"n_hyp": len(fset),
           "pow_rel_err": rel(dev.xc_incoherent_collapsed_pow,
                              host.xc_incoherent_collapsed_pow),
           "single_rel_err": rel(dev.xc_incoherent_single,
                                 host.xc_incoherent_single),
           "sp_rel_err": rel(dev.sp_incoherent, host.sp_incoherent)}
    z = detection_threshold(host.sp_incoherent, host.n_comb_xc, DS_COMB_ARM)
    want = peak_search(host.xc_incoherent_collapsed_pow,
                       host.xc_incoherent_collapsed_frq, z, fset, FC, FC,
                       host.xc_incoherent_single, DS_COMB_ARM)
    got = _device_peaks(np.asarray(cap, np.complex128), fset, FC, FC, FS,
                        DS_COMB_ARM)
    key = [(c.n_id_2, c.ind, c.freq) for c in want]
    out["n_peaks"] = len(want)
    for k in ("pow_rel_err", "single_rel_err", "sp_rel_err"):
        assert out[k] < 1e-4, out
    assert want and got is not None, "no peaks"
    assert [(c.n_id_2, c.ind, c.freq) for c in got] == key, (got, want)
    return out


def _synced_cell(cap, fset):
    """Host float64 scan + SSS + fine FOE: the strongest synced cell."""
    from lte_cell_scanner.ops.peak import peak_search
    from lte_cell_scanner.ops.sync import pss_sss_foe, sss_detect
    from lte_cell_scanner.ops.xcorr import xcorr_pss
    from lte_cell_scanner.search.cell_search import detection_threshold

    r = xcorr_pss(cap, fset, DS_COMB_ARM, FC, FC, FS, backend="numpy")
    z = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    for p in peak_search(r.xc_incoherent_collapsed_pow,
                         r.xc_incoherent_collapsed_frq, z, fset, FC, FC,
                         r.xc_incoherent_single, DS_COMB_ARM):
        c = sss_detect(dataclasses.replace(p), cap, THRESH2_N_SIGMA, FC,
                       FC, FS)
        if c.n_id_1 >= 0:
            return pss_sss_foe(c, cap, FC, FC, FS)
    raise AssertionError("no synced cell in the check capture")


def tfg_parity(seed: int = 1) -> dict:
    """The MIB program's full-grid extraction (window gather + 128->72
    DFT products + phase ramps) against ops/tfg.extract_tfg, within
    2e-3 of the grid maximum: the device plan carries phases as i16
    fixed point (2*pi/65536 rad), on top of float32 rounding."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.ops.mib_jax import extract_tfg_batch
    from lte_cell_scanner.ops.tfg import extract_tfg

    cap = synthetic_capture(seed=seed, snr_db=10.0, freq_offset=3.1e3)
    cell = _synced_cell(cap, np.arange(-2, 3) * 5e3)
    tfg_d, _, ok = extract_tfg_batch([cell], cap, FC, FC, FS)
    tfg_h, _ = extract_tfg(cell, cap, FC, FC, FS)
    err = float(np.abs(tfg_d[0] - tfg_h).max() / np.abs(tfg_h).max())
    assert ok.all() and err < 2e-3, err
    return {"tfg_rel_err": err, "rows": int(tfg_h.shape[0])}


def mib_parity(seed: int = 2) -> dict:
    """The whole device decode chain (sync + MIB program, deratematch
    einsum and Viterbi included) against the float64 host chain:
    identical cell IDs, CP, ports and MIB fields, and the superfine
    frequency within 0.5 Hz, for a normal- and an extended-CP cell."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.search.cell_search import cell_search

    fset = np.arange(-2, 3) * 5e3
    out = {}
    for i, (cp, n_rb) in enumerate((("normal", 25), ("extended", 100))):
        cap = synthetic_capture(n_id_1=40 + 7 * i, n_id_2=i, cp_type=cp,
                                snr_db=5.0, freq_offset=-2.2e3 + 3e3 * i,
                                n_rb_dl=n_rb, seed=seed + i)
        host = cell_search(cap, FC, f_search_set=fset, backend="numpy")
        dev = cell_search(cap, FC, f_search_set=fset, backend="jax")
        assert host, f"host chain decoded nothing ({cp} CP)"
        assert _mib_fields(dev) == _mib_fields(host), (dev, host)
        df = max(abs(d.freq_superfine - h.freq_superfine)
                 for d, h in zip(dev, host))
        assert df < 0.5, df
        out[f"{cp}_freq_diff_hz"] = df
    return out


def _mib_fields(cells):
    return sorted((c.n_id_cell(), c.cp_type, c.n_ports, c.n_rb_dl, c.sfn,
                   c.phich_duration, c.phich_resource) for c in cells)


def viterbi_parity(batch: int = 768, seed: int = 3) -> dict:
    """The batched device Viterbi at the MIB batch (64 candidates x 4
    frame timings x 3 port hypotheses) decodes bit-identically to the
    host decoder on 0 dB AWGN LLRs (tie-free floats)."""
    from lte_cell_scanner.models.convcode import (lte_conv_decode,
                                                  lte_conv_encode)
    from lte_cell_scanner.models.convcode_jax import lte_conv_decode_batch

    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, (batch, 40)).astype(np.uint8)
    llrs = np.stack([2.0 * ((1.0 - 2.0 * lte_conv_encode(b).astype(
        np.float64)) + rng.standard_normal((3, 40))) for b in bits])
    llrs = llrs.astype(np.float32)
    dev = lte_conv_decode_batch(llrs)
    host = np.stack([lte_conv_decode(x) for x in llrs])
    n_bad = int(np.sum(np.any(dev != host, axis=1)))
    assert n_bad == 0, f"{n_bad}/{batch} decodes differ from the host"
    return {"decodes": batch, "mismatched": n_bad}


CHECKS = (("scan", scan_parity), ("tfg_dft", tfg_parity),
          ("mib_chain", mib_parity), ("viterbi", viterbi_parity))

"""SSS detection and PSS/SSS fine frequency-offset estimation.

reference: src/searcher.cpp:516-850 (extract_psss, sss_detect_getce_sss,
sss_detect_ml, sss_detect, pss_sss_foe).

Float64 host implementation. The per-repetition window extraction is batched
(one stacked gather + one batched FFT) so the same structure vectorizes on
device; the 168x2x2 ML hypothesis scan is a single einsum.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lte_cell_scanner.constants import FS_LTE, HALF_FRAME
from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.models.pss import pss_fd
from lte_cell_scanner.models.sss import sss_fd, sss_fd_all
from lte_cell_scanner.utils.dsp import matlab_range, wrap


def extract_psss(td_samps: np.ndarray, foc_freq: float, k_factor: float,
                 fs_programmed: float, mode: str = "native") -> np.ndarray:
    """FOC + 2-sample coarse TOC + DFT + pick the 62 sync subcarriers.

    ``td_samps`` may be (..., 128): the shift/rotate/DFT are applied along
    the last axis (batched over PSS repetitions).
    reference: src/searcher.cpp:516-530.

    ``mode="native"`` removes the frequency offset at the true sample rate
    fs_programmed*k_factor (as the C++ reference does);
    ``mode="matlab"`` uses the nominal FS_LTE/16 rate exactly as the MATLAB
    prototype (and hence the golden test vectors) do. The two differ by
    O(f_off * ppm) phase — ~1e-3 on the fixtures.
    """
    td_samps = np.asarray(td_samps)
    fs_eff = fs_programmed * k_factor if mode == "native" else FS_LTE / 16
    t = np.arange(128, dtype=np.float64)
    shift = np.exp(1j * 2.0 * np.pi * foc_freq * t / fs_eff)
    x = td_samps * shift
    # Remove the 2-sample timing margin
    x = np.concatenate([x[..., 2:], x[..., :2]], axis=-1)
    dft_out = np.fft.fft(x, axis=-1) / np.sqrt(128.0)
    return np.concatenate([dft_out[..., 97:128], dft_out[..., 1:32]], axis=-1)


def _smooth13(h_raw: np.ndarray) -> np.ndarray:
    """13-tap frequency smoothing with shrinking edges (axis=-1, len 62).

    h_sm[t] = mean(h_raw[max(0,t-6) : min(61,t+6)+1]).
    """
    n = h_raw.shape[-1]
    # Direct windowed means (not a cumsum difference): summation-order
    # noise from running sums costs ~1e-12 against the golden vectors.
    out = np.empty_like(h_raw)
    for t in range(n):
        lt = max(0, t - 6)
        rt = min(n - 1, t + 6)
        out[..., t] = h_raw[..., lt:rt + 1].mean(axis=-1)
    return out


@dataclasses.dataclass
class SssDetectDebug:
    """Intermediates checked by the golden-vector test (test_sss_detect.cpp)."""

    sss_h1_np_est: np.ndarray
    sss_h2_np_est: np.ndarray
    sss_h1_nrm_est: np.ndarray
    sss_h2_nrm_est: np.ndarray
    sss_h1_ext_est: np.ndarray
    sss_h2_ext_est: np.ndarray
    log_lik_nrm: Optional[np.ndarray] = None
    log_lik_ext: Optional[np.ndarray] = None


def _getce_sss(cell: Cell, capbuf: np.ndarray, fc_requested: float,
               fc_programmed: float, fs_programmed: float,
               mode: str = "native"):
    """Channel estimates from every PSS repetition + raw SSS candidates,
    MMSE-combined split into even (h1) / odd (h2) half-frames.

    reference: src/searcher.cpp:533-632.
    """
    peak_loc = float(cell.ind)
    peak_freq = cell.freq
    n_id_2 = cell.n_id_2
    k_factor = (fc_requested - peak_freq) / fc_programmed

    # Skip right by 5 subframes if there's no room for the SSS before the
    # first PSS.
    if peak_loc + 9 < 162:
        peak_loc += HALF_FRAME * k_factor
    pss_loc_set = matlab_range(peak_loc, k_factor * HALF_FRAME,
                               len(capbuf) - 125 - 9)
    pss_dft_locs = np.round(pss_loc_set).astype(np.int64) + 9 - 2
    # A location in the half-sample band just below the bound can round up
    # so its 128-sample window would index one past the buffer; drop it.
    keep = pss_dft_locs + 128 <= len(capbuf)
    pss_loc_set = pss_loc_set[keep]
    pss_dft_locs = pss_dft_locs[keep]
    n_pss = len(pss_loc_set)

    idx = pss_dft_locs[:, None] + np.arange(128)[None, :]
    pss_wins = capbuf[idx]                       # (n_pss, 128)
    ext_wins = capbuf[idx - 128 - 32]
    nrm_wins = capbuf[idx - 128 - 9]

    h_raw = extract_psss(pss_wins, -peak_freq, k_factor, fs_programmed, mode)
    h_raw = h_raw * np.conj(pss_fd(n_id_2))[None, :]
    h_sm = _smooth13(h_raw)
    pss_np_ = np.mean(np.abs(h_sm - h_raw) ** 2, axis=-1)  # (n_pss,)

    sss_ext_raw = extract_psss(ext_wins, -peak_freq, k_factor, fs_programmed, mode)
    sss_nrm_raw = extract_psss(nrm_wins, -peak_freq, k_factor, fs_programmed, mode)

    def combine(h, np_, raw):
        w = 1.0 / np_[:, None]                           # (n, 62)
        np_est = 1.0 / (1.0 + np.sum(np.abs(h) ** 2 * w, axis=0))
        est = np_est * np.sum(np.conj(h) * w * raw, axis=0)
        return np_est, est

    h1, h2 = h_sm[0::2], h_sm[1::2]
    np1, np2 = pss_np_[0::2], pss_np_[1::2]
    sss_h1_np_est, sss_h1_nrm_est = combine(h1, np1, sss_nrm_raw[0::2])
    sss_h2_np_est, sss_h2_nrm_est = combine(h2, np2, sss_nrm_raw[1::2])
    _, sss_h1_ext_est = combine(h1, np1, sss_ext_raw[0::2])
    _, sss_h2_ext_est = combine(h2, np2, sss_ext_raw[1::2])

    return SssDetectDebug(
        sss_h1_np_est=sss_h1_np_est,
        sss_h2_np_est=sss_h2_np_est,
        sss_h1_nrm_est=sss_h1_nrm_est,
        sss_h2_nrm_est=sss_h2_nrm_est,
        sss_h1_ext_est=sss_h1_ext_est,
        sss_h2_ext_est=sss_h2_ext_est,
    )


def _ml_scan(n_id_2: int, dbg: SssDetectDebug):
    """Log-likelihood of all 168 n_id_1 x 2 orderings x {nrm, ext}.

    reference: src/searcher.cpp:636-693, vectorized over hypotheses.
    """
    np12 = np.concatenate([dbg.sss_h1_np_est, dbg.sss_h2_np_est])   # (124,)
    est_nrm = np.concatenate([dbg.sss_h1_nrm_est, dbg.sss_h2_nrm_est])
    est_ext = np.concatenate([dbg.sss_h1_ext_est, dbg.sss_h2_ext_est])

    table = sss_fd_all(n_id_2).astype(np.float64)          # (168, 2, 62)
    h12 = table.reshape(168, 124)                          # [slot0, slot10]
    h21 = table[:, ::-1, :].reshape(168, 124)

    def loglik(est, tries):
        # Phase-align each candidate to the received estimate, then compute
        # the noise-normalized distance.
        corr = tries @ np.conj(est)                        # (168,)
        ang = np.angle(corr)
        rot = tries * np.exp(-1j * ang)[:, None]
        diff = rot - est[None, :]
        return -np.sum((diff.real**2 + diff.imag**2) / np12[None, :], axis=1)

    log_lik_nrm = np.stack([loglik(est_nrm, h12), loglik(est_nrm, h21)], axis=1)
    log_lik_ext = np.stack([loglik(est_ext, h12), loglik(est_ext, h21)], axis=1)
    return log_lik_nrm, log_lik_ext


def sss_detect(cell: Cell, capbuf: np.ndarray, thresh2_n_sigma: float,
               fc_requested: float, fc_programmed: float, fs_programmed: float,
               want_debug: bool = False, mode: str = "native"):
    """ML SSS detection: fills n_id_1 / cp_type / frame_start, or leaves
    n_id_1 == -1 when the second threshold rejects the candidate.

    reference: src/searcher.cpp:696-761 and Matlab/sss_detect.m. Where the
    C++ port drifted from the prototype, the prototype's formulas are used:
    frame_start is measured from the (possibly half-frame-advanced)
    peak_loc, and the alternate-ordering bump is one half-frame of capture
    samples (the C++ applies k_factor twice there).
    """
    capbuf = np.asarray(capbuf, dtype=np.complex128)
    dbg = _getce_sss(cell, capbuf, fc_requested, fc_programmed, fs_programmed,
                     mode)
    log_lik_nrm, log_lik_ext = _ml_scan(cell.n_id_2, dbg)
    dbg.log_lik_nrm = log_lik_nrm
    dbg.log_lik_ext = log_lik_ext

    if log_lik_nrm.max() > log_lik_ext.max():
        cp_type = "normal"
        log_lik = log_lik_nrm
    else:
        cp_type = "extended"
        log_lik = log_lik_ext

    k_factor = (fc_requested - cell.freq) / fc_programmed
    u = 16.0 / FS_LTE * fs_programmed * k_factor
    peak_loc = float(cell.ind)
    if peak_loc + 9 < 162:
        peak_loc += HALF_FRAME * k_factor
    frame_start = peak_loc + (128 + 9 - 960 - 2) * u
    if log_lik[:, 0].max() > log_lik[:, 1].max():
        ll = log_lik[:, 0]
    else:
        ll = log_lik[:, 1]
        frame_start = frame_start + HALF_FRAME * u
    # Wrap into two frames of nominal capture samples (constant bounds, as
    # the prototype does; the C++ scales the upper bound by k_factor).
    frame_start = float(wrap(frame_start, -0.5, 2 * HALF_FRAME - 0.5))

    n_id_1_est = int(np.argmax(ll))
    lik_final = ll[n_id_1_est]

    # Second threshold: reject weak hypotheses.
    L = np.concatenate([log_lik_nrm.T.ravel(), log_lik_ext.T.ravel()])
    lik_mean = L.mean()
    lik_std = L.std(ddof=1)

    out = dataclasses.replace(cell)
    if lik_final >= lik_mean + lik_std * thresh2_n_sigma:
        out.n_id_1 = n_id_1_est
        out.cp_type = cp_type
        out.frame_start = frame_start
    if want_debug:
        return out, dbg
    return out


def pss_sss_foe(cell: Cell, capbuf: np.ndarray, fc_requested: float,
                fc_programmed: float, fs_programmed: float,
                mode: str = "native") -> Cell:
    """Fine FOE from PSS/SSS phase difference; fills freq_fine.

    reference: src/searcher.cpp:767-850.
    """
    capbuf = np.asarray(capbuf, dtype=np.complex128)
    k_factor = (fc_requested - cell.freq) / fc_programmed
    u = 16.0 / FS_LTE * fs_programmed * k_factor

    if cell.cp_type == "normal":
        pss_sss_dist = int(round((128 + 9) * u))
        first_sss = cell.frame_start + (960 - 128 - 9 - 128) * u
    elif cell.cp_type == "extended":
        # NOTE: the reference computes this arm without the fs/FS_LTE
        # rescale (src/searcher.cpp:783); replicated for parity.
        pss_sss_dist = int(round((128 + 32) * k_factor))
        first_sss = cell.frame_start + (960 - 128 - 32 - 128) * u
    else:
        raise ValueError("cp_type undetermined")

    first_sss = float(wrap(first_sss, -0.5, 9600 * 2 - 0.5))
    if first_sss - HALF_FRAME * k_factor > -0.5:
        first_sss -= HALF_FRAME * k_factor
        sn0 = 10
    else:
        sn0 = 0
    sss_dft_loc_set = matlab_range(first_sss, HALF_FRAME * u,
                                   len(capbuf) - 127 - pss_sss_dist - 100)
    n_sss = len(sss_dft_loc_set)
    sss_locs = np.round(sss_dft_loc_set).astype(np.int64)
    pss_locs = sss_locs + pss_sss_dist

    idx = np.arange(128)[None, :]
    pss_wins = capbuf[pss_locs[:, None] + idx]
    sss_wins = capbuf[sss_locs[:, None] + idx]

    h_raw = extract_psss(pss_wins, -cell.freq, k_factor, fs_programmed, mode)
    h_raw = h_raw * np.conj(pss_fd(cell.n_id_2))[None, :]
    h_sm = _smooth13(h_raw)
    pss_np_ = np.mean(np.abs(h_sm - h_raw) ** 2, axis=-1)

    # Alternating slot number (0/10) of each SSS repetition.
    sn = np.where((np.arange(n_sss) % 2) == 0, sn0, 10 - sn0)
    sss_tab = np.stack([
        sss_fd(cell.n_id_1, cell.n_id_2, 0),
        sss_fd(cell.n_id_1, cell.n_id_2, 10),
    ]).astype(np.float64)
    known = sss_tab[(sn != 0).astype(np.int64)]            # (n_sss, 62)

    phase = np.exp(1j * np.pi * -cell.freq / (FS_LTE / 16 / 2) * -pss_sss_dist)
    sss_raw = extract_psss(sss_wins, -cell.freq, k_factor, fs_programmed, mode) * phase
    sss_raw = sss_raw * known  # conj of a +/-1 sequence is itself

    h_sm2 = np.abs(h_sm) ** 2
    w = h_sm2 / (2.0 * h_sm2 * pss_np_[:, None] + (pss_np_**2)[:, None])
    M = np.sum(np.conj(sss_raw) * h_raw * w)

    fs_eff = fs_programmed * k_factor if mode == "native" else FS_LTE / 16
    out = dataclasses.replace(cell)
    out.freq_fine = cell.freq + float(np.angle(M)) / (2 * np.pi) / (
        pss_sss_dist / fs_eff)
    return out

"""PSS cross-correlation scan — the hot kernel of cell search.

reference: src/searcher.cpp:113-419 (xc_correlate / sp_est / xc_combine /
xc_delay_spread / xc_peak_freq / xcorr_pss).

Two implementations:

- ``backend="numpy"``: float64 host reference, used for golden-vector parity
  tests and as the source of regenerated expected outputs.
- ``backend="jax"``: the device path (ops/xcorr_jax.py). The reference's
  scalar sliding loop (63 G complex MACs at ppm=100) becomes one im2col
  matmul: for every (pss, f_off) hypothesis the 137-tap
  frequency-shifted template is one row, and all 3*n_f templates
  correlate against the capture in one product with contraction 274.
  The incoherent k_factor folding, delay-spread smoothing, power
  estimate and frequency collapse are fused elementwise/slice ops in the
  same jit. Whether a cuDNN convolution or an FFT overlap-save
  correlation beats this form on the GPU has not been measured.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from lte_cell_scanner.constants import HALF_FRAME, PSS_TD_LEN
from lte_cell_scanner.models.pss import pss_td_all


@dataclasses.dataclass
class XcorrResult:
    """Outputs of the PSS scan (naming follows the reference)."""

    # (3, 9600) peak power / best frequency-hypothesis index per lag
    xc_incoherent_collapsed_pow: np.ndarray
    xc_incoherent_collapsed_frq: np.ndarray
    # (3, 9600, n_f) per-hypothesis incoherent sums (xc_incoherent may be
    # None on paths that never materialize the smoothed table)
    xc_incoherent_single: np.ndarray
    xc_incoherent: Optional[np.ndarray]
    # (9600,) folded mean received power, aligned to correlation peaks
    sp_incoherent: np.ndarray
    n_comb_xc: int
    n_comb_sp: int
    # Full sp vector (host reference only; None on device path)
    sp: Optional[np.ndarray] = None
    # Raw correlations (3, n_lags, n_f) — huge; only kept if requested.
    xc: Optional[np.ndarray] = None


def shifted_templates(f_search_set: np.ndarray, fc_requested: float,
                      fc_programmed: float, fs_programmed: float,
                      mode: str = "native") -> np.ndarray:
    """(n_f, 3, 137) conjugated, 1/137-scaled, frequency-shifted PSS templates.

    In native mode each hypothesis f_off shifts at its own true sample rate
    fs_programmed * k_factor (reference: src/searcher.cpp:145-151); matlab
    mode shifts at the nominal FS_LTE/16 as the prototype does.
    """
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    k_factor = (fc_requested - f_search_set) / fc_programmed  # (n_f,)
    if mode == "native":
        fs_eff = fs_programmed * k_factor[:, None]
    else:
        fs_eff = np.full((len(f_search_set), 1), 1.92e6)
    t = np.arange(PSS_TD_LEN, dtype=np.float64)
    # fshift: exp(+j*2*pi*f*t/fs); then conjugate the whole template.
    phase = 2.0 * np.pi * f_search_set[:, None] * t[None, :] / fs_eff
    templates = pss_td_all()[None, :, :] * np.exp(1j * phase)[:, None, :]
    return np.conj(templates) / PSS_TD_LEN


def fold_start_indices(f_search_set: np.ndarray, n_comb_xc: int,
                       fc_requested: float, fc_programmed: float,
                       fs_programmed: float) -> np.ndarray:
    """(n_f, n_comb_xc) start index of each half-frame fold.

    The fold stride is corrected per-hypothesis by k_factor so that
    correlation peaks from successive half-frames line up even under large
    frequency offsets (reference: src/searcher.cpp:292-299).
    """
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    k_factor = (fc_requested - f_search_set) / fc_programmed
    m = np.arange(n_comb_xc, dtype=np.float64)
    idx = np.round(m[None, :] * 0.005 * k_factor[:, None] * fs_programmed)
    return idx.astype(np.int64)


# ---------------------------------------------------------------------------
# Host (float64) reference
# ---------------------------------------------------------------------------

def _xc_correlate_np(capbuf: np.ndarray, templates: np.ndarray) -> np.ndarray:
    """(3, n_lags, n_f) complex correlations via FFT convolution (float64).

    Numerically this matches the direct sliding dot product to ~1e-12; the
    reference itself stores xc in complex<float> so golden comparisons are
    at 1e-6 anyway.
    """
    n_cap = len(capbuf)
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_f = templates.shape[0]
    n_fft = 1 << int(np.ceil(np.log2(n_cap + PSS_TD_LEN)))
    cap_f = np.fft.fft(capbuf, n_fft)
    out = np.empty((3, n_lags, n_f), dtype=np.complex128)
    for foi in range(n_f):
        for t in range(3):
            # correlation: sum_m temp[m] * capbuf[k+m]
            tpl_f = np.fft.fft(templates[foi, t][::-1], n_fft)
            full = np.fft.ifft(cap_f * tpl_f)
            out[t, :, foi] = full[PSS_TD_LEN - 1:PSS_TD_LEN - 1 + n_lags]
    return out


def _sp_est_np(capbuf: np.ndarray):
    """Sliding 274-sample mean power, folded into one half-frame.

    reference: src/searcher.cpp:185-221.
    """
    n_cap = len(capbuf)
    n_comb_sp = (n_cap - 136 - 137) // HALF_FRAME
    n_sp = n_comb_sp * HALF_FRAME
    pw = capbuf.real**2 + capbuf.imag**2
    c = np.concatenate([[0.0], np.cumsum(pw)])
    sp = (c[274:274 + n_sp] - c[:n_sp]) / 274.0
    sp_incoherent = sp.reshape(n_comb_sp, HALF_FRAME).mean(axis=0)
    sp_incoherent = np.roll(sp_incoherent, 137)
    return sp, sp_incoherent, n_comb_sp


def _xc_combine_np(xc: np.ndarray, starts: np.ndarray) -> np.ndarray:
    """Incoherent fold: (3, n_lags, n_f) -> (3, 9600, n_f)."""
    n_f = xc.shape[2]
    n_comb_xc = starts.shape[1]
    out = np.zeros((3, HALF_FRAME, n_f))
    mag2 = xc.real**2 + xc.imag**2
    for foi in range(n_f):
        for m in range(n_comb_xc):
            s = starts[foi, m]
            out[:, :, foi] += mag2[:, s:s + HALF_FRAME, foi]
    return out / n_comb_xc


def _xc_delay_spread_np(xc_single: np.ndarray, ds_comb_arm: int) -> np.ndarray:
    out = xc_single.copy()
    for t in range(1, ds_comb_arm + 1):
        out += np.roll(xc_single, t, axis=1) + np.roll(xc_single, -t, axis=1)
    return out / (2 * ds_comb_arm + 1)


def n_comb_sp_for(n_cap: int) -> int:
    """Number of half-frame folds in the signal-power estimate
    (reference: src/searcher.cpp:185-221)."""
    from lte_cell_scanner.constants import HALF_FRAME, PSS_TD_LEN

    return (n_cap - (PSS_TD_LEN - 1) - PSS_TD_LEN) // HALF_FRAME


def n_comb_xc_for(n_lags: int, f_search_set: np.ndarray,
                  fc_requested: float, fc_programmed: float,
                  fs_programmed: float) -> int:
    """Number of incoherent fold segments, reduced (rarely) so that every
    hypothesis's last fold window stays inside the correlation buffer.

    The nominal count (n_lags - 100) // 9600 carries a 100-sample margin
    for k_factor stride drift (src/searcher.cpp:263-308); on captures much
    longer than 80 ms at high ppm the drift can exceed it, which would
    read out of bounds.
    """
    n = (n_lags - 100) // HALF_FRAME
    while n > 1:
        starts = fold_start_indices(f_search_set, n, fc_requested,
                                    fc_programmed, fs_programmed)
        if int(starts[:, -1].max()) + HALF_FRAME <= n_lags:
            break
        n -= 1
    return n


def xcorr_pss(
    capbuf: np.ndarray,
    f_search_set: np.ndarray,
    ds_comb_arm: int,
    fc_requested: float,
    fc_programmed: float,
    fs_programmed: float,
    backend: str = "numpy",
    keep_xc: bool = False,
) -> XcorrResult:
    """Run the full PSS scan. See module docstring for backends."""
    if backend == "jax":
        from lte_cell_scanner.ops.xcorr_jax import xcorr_pss_jax
        return xcorr_pss_jax(capbuf, f_search_set, ds_comb_arm, fc_requested,
                             fc_programmed, fs_programmed)

    capbuf = np.asarray(capbuf, dtype=np.complex128)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    templates = shifted_templates(f_search_set, fc_requested, fc_programmed,
                                  fs_programmed)
    xc = _xc_correlate_np(capbuf, templates)
    n_comb_xc = n_comb_xc_for(xc.shape[1], f_search_set, fc_requested,
                              fc_programmed, fs_programmed)
    starts = fold_start_indices(f_search_set, n_comb_xc, fc_requested,
                                fc_programmed, fs_programmed)
    xc_single = _xc_combine_np(xc, starts)
    xc_inc = _xc_delay_spread_np(xc_single, ds_comb_arm)
    sp, sp_incoherent, n_comb_sp = _sp_est_np(capbuf)
    pow_ = xc_inc.max(axis=2)
    frq = xc_inc.argmax(axis=2)
    return XcorrResult(
        xc_incoherent_collapsed_pow=pow_,
        xc_incoherent_collapsed_frq=frq,
        xc_incoherent_single=xc_single,
        xc_incoherent=xc_inc,
        sp_incoherent=sp_incoherent,
        n_comb_xc=int(n_comb_xc),
        n_comb_sp=int(n_comb_sp),
        sp=sp,
        xc=xc if keep_xc else None,
    )

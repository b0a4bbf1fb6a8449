"""Device (JAX/XLA) implementation of the PSS hypothesis scan.

The reference's hot loop (src/searcher.cpp:113-174: ~2e10 complex MACs per
80 ms capture at ppm=100, OpenMP over lags) becomes ONE matrix product:

- the complex correlation of 3 PSS x n_f frequency hypotheses is an
  im2col product: 137 shifted views of the capture's re/im planes
  stacked into a (274, n_lags) matrix, multiplied by the (2*3*n_f, 274)
  block matrix of the frequency-shifted templates (re/im of each);
- the per-hypothesis incoherent k_factor folding is a set of batched
  contiguous slices + mean;
- delay-spread smoothing, the sliding power estimate and the frequency
  collapse fuse into the same jit.

Everything from raw capture to the collapsed (3, 9600) peak tables runs in
one XLA program; :func:`scan_and_peaks` adds the greedy peak search
(ops/peak_jax.py) so only the ~1 KB peak table leaves the device.

The device program is pure REAL arithmetic on split re/im planes. The
frequency-shifted templates and the k_factor fold indices are
precomputed on host in float64 and passed in as arrays, so device results
track the float64 reference to f32 rounding only (matmuls at
platform.MATMUL_PRECISION).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from lte_cell_scanner import platform
from lte_cell_scanner.constants import HALF_FRAME, PSS_TD_LEN
from lte_cell_scanner.ops.peak_jax import MAX_PEAKS, peak_search_device
from lte_cell_scanner.ops.xcorr import (
    XcorrResult,
    fold_start_indices,
    n_comb_xc_for,
    shifted_templates,
)


def correlate_conv(cap_ri: jnp.ndarray, tpl_re: jnp.ndarray,
                   tpl_im: jnp.ndarray):
    """All-hypothesis PSS correlation as one matmul.

    cap_ri: (n_cap, 2) float. tpl_re/tpl_im: (n_ch, 137) float with
    n_ch = 3*n_f (channel c = foi*3 + t).
    Returns (xc_re, xc_im), each (n_ch, n_lags).

    The sliding window is materialized as 137 static slices of the capture
    stacked into a (2*137, n_lags) matrix (re plane over im plane); the
    whole hypothesis bank then correlates in a single
    (2*n_ch, 2*137) @ (2*137, n_lags) matmul.
    """
    rdt = cap_ri.dtype
    n_cap = cap_ri.shape[0]
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_ch = tpl_re.shape[0]
    # (137, n_lags) shifted views of each plane.
    x_re = jnp.stack([jax.lax.dynamic_slice_in_dim(cap_ri[:, 0], m, n_lags)
                      for m in range(PSS_TD_LEN)])
    x_im = jnp.stack([jax.lax.dynamic_slice_in_dim(cap_ri[:, 1], m, n_lags)
                      for m in range(PSS_TD_LEN)])
    x = jnp.concatenate([x_re, x_im], axis=0)          # (274, n_lags)
    # Complex correlate: re = tr*ar - ti*ai ; im = ti*ar + tr*ai.
    f = jnp.block([[tpl_re, -tpl_im], [tpl_im, tpl_re]]).astype(rdt)
    out = jnp.dot(f, x, preferred_element_type=rdt)    # (2*n_ch, n_lags)
    return out[:n_ch], out[n_ch:]


def _fold(mag2: jnp.ndarray, starts: jnp.ndarray) -> jnp.ndarray:
    """Incoherent fold (3*n_f, n_lags) -> (3, 9600, n_f) with per-hypothesis
    fold start indices (n_f, n_comb_xc).

    Implemented as batched contiguous dynamic slices (one per fold), not
    an element gather.
    """
    n_f = mag2.shape[0] // 3
    n_comb_xc = starts.shape[1]
    m3 = mag2.reshape(n_f, 3, -1)
    slice_f = jax.vmap(
        lambda row, st: jax.lax.dynamic_slice_in_dim(row, st, HALF_FRAME, axis=1))
    acc = slice_f(m3, starts[:, 0])
    for k in range(1, n_comb_xc):
        acc = acc + slice_f(m3, starts[:, k])
    return jnp.transpose(acc / n_comb_xc, (1, 2, 0))       # (3, 9600, n_f)


def _delay_spread(single: jnp.ndarray, ds_comb_arm: int) -> jnp.ndarray:
    out = single
    for t in range(1, ds_comb_arm + 1):
        out = out + jnp.roll(single, t, axis=1) + jnp.roll(single, -t, axis=1)
    return out / (2 * ds_comb_arm + 1)


def _sp_est(cap_ri: jnp.ndarray, n_comb_sp: int) -> jnp.ndarray:
    """Sliding 274-sample mean power folded into one half-frame."""
    return _sp_est_from_pw(cap_ri[:, 0] ** 2 + cap_ri[:, 1] ** 2, n_comb_sp)


def win_sum(x, w):
    """Sliding w-window sum by length doubling: S_{a+b}[k] = S_a[k] +
    S_b[k+a] — O(log w) vector adds, numerically a balanced tree (NOT a
    cumsum difference, which loses float32 accuracy over 144k
    samples)."""
    memo = {1: x}

    def s(n):
        if n not in memo:
            h = n // 2
            a, b = s(h), s(n - h)
            ln = x.shape[0] - n + 1
            memo[n] = a[:ln] + jax.lax.dynamic_slice_in_dim(b, h, ln)
        return memo[n]

    return s(w)


def _sp_est_from_pw(pw: jnp.ndarray, n_comb_sp: int) -> jnp.ndarray:
    n_sp = n_comb_sp * HALF_FRAME
    sp = win_sum(pw, 274)[:n_sp] / 274.0
    sp_inc = sp.reshape(n_comb_sp, HALF_FRAME).mean(axis=0)
    return jnp.roll(sp_inc, 137)


def _xcorr_core(cap_ri, tpl_re, tpl_im, starts, n_comb_sp, ds_comb_arm):
    """The full device program for ONE capture. All-real; see module doc.

    Returns (packed (7, 9600), single, inc): packed rows 0-2 are the
    collapsed peak powers, rows 3-5 the argmax hypothesis indices (as
    floats), row 6 the folded signal power — one array so the host needs a
    single transfer for the peak scan.
    """
    xc_re, xc_im = correlate_conv(cap_ri, tpl_re, tpl_im)
    mag2 = xc_re * xc_re + xc_im * xc_im
    # Materialize the correlation before the fold: without the barrier XLA
    # fuses (= recomputes) the big matmul into each of the n_comb_xc slice
    # consumers, blowing up both compile and run time.
    mag2 = jax.lax.optimization_barrier(mag2)
    single = _fold(mag2, starts)
    inc = _delay_spread(single, ds_comb_arm)
    sp_inc = _sp_est(cap_ri, n_comb_sp)
    pow_ = inc.max(axis=2)
    frq = inc.argmax(axis=2).astype(pow_.dtype)
    packed = jnp.concatenate([pow_, frq, sp_inc[None, :]], axis=0)
    return packed, single, inc


xcorr_pss_core = platform.jit(_xcorr_core,
                              static_argnames=("n_comb_sp", "ds_comb_arm"))

# Batched over a leading captures axis (one dispatch for many captures).
xcorr_pss_core_batch = platform.jit(
    jax.vmap(_xcorr_core, in_axes=(0, None, None, None, None, None),
             axis_name="capture"),
    static_argnames=("n_comb_sp", "ds_comb_arm"))


def planes_to_ri(cap2: jnp.ndarray) -> jnp.ndarray:
    """One capture's (2, n) re/im planes -> the scan's (n, 2) f32 layout.

    uint8 planes are RTL-SDR radio bytes (zero level 127, full scale
    128); float planes pass through as f32. Runs on device, so raw bytes
    cross the host link at a quarter of the f32 size."""
    if cap2.dtype == jnp.uint8:
        cap2 = (cap2.astype(jnp.float32) - 127.0) / 128.0
    return jnp.transpose(cap2.astype(jnp.float32))


def _scan_and_peaks(cap_ri, tpl_re, tpl_im, starts, r_norm, n_comb_sp,
                    ds_comb_arm, max_peaks=MAX_PEAKS):
    packed, single, _ = _xcorr_core(cap_ri, tpl_re, tpl_im, starts,
                                    n_comb_sp, ds_comb_arm)
    return peak_search_device(packed, single, r_norm, ds_comb_arm,
                              max_peaks=max_peaks)


# One device program per capture: scan + threshold (r_norm *
# sp_incoherent, ops/peak_jax.r_th1_normalized) + greedy peak search.
# Returns only the (max_peaks, 4) peak table.
scan_and_peaks = platform.jit(
    _scan_and_peaks,
    static_argnames=("n_comb_sp", "ds_comb_arm", "max_peaks"))


def scan_inputs(f_search_set, n_comb_xc, fc_requested, fc_programmed,
                fs_programmed, dtype=np.float32):
    """Host float64 -> device-dtype scan constants for one carrier:
    (tpl_re, tpl_im) (3*n_f, 137) and the fold starts (n_f, n_comb_xc)."""
    tpl = shifted_templates(f_search_set, fc_requested, fc_programmed,
                            fs_programmed).reshape(-1, PSS_TD_LEN)
    starts = fold_start_indices(f_search_set, n_comb_xc, fc_requested,
                                fc_programmed, fs_programmed)
    return (tpl.real.astype(dtype), tpl.imag.astype(dtype),
            starts.astype(np.int32))


def xcorr_pss_jax(capbuf, f_search_set, ds_comb_arm, fc_requested,
                  fc_programmed, fs_programmed, dtype=None) -> XcorrResult:
    """Device PSS scan; mirrors ops.xcorr.xcorr_pss(backend='numpy').

    dtype: the scan's real dtype (default platform.scan_dtype(): float64
    on the CPU parity path, float32 on the GPU)."""
    if dtype is None:
        dtype = platform.scan_dtype()
    capbuf = np.asarray(capbuf)
    f_search_set = np.asarray(f_search_set, dtype=np.float64)
    n_cap = capbuf.shape[0]
    n_lags = n_cap - (PSS_TD_LEN - 1)
    n_comb_xc = n_comb_xc_for(n_lags, f_search_set, fc_requested,
                              fc_programmed, fs_programmed)
    n_comb_sp = (n_cap - 136 - 137) // HALF_FRAME

    cap_ri = np.stack([capbuf.real, capbuf.imag], axis=-1).astype(dtype)
    tre, tim, starts = scan_inputs(f_search_set, n_comb_xc, fc_requested,
                                   fc_programmed, fs_programmed, dtype)
    packed, single, inc = xcorr_pss_core(
        jnp.asarray(cap_ri), jnp.asarray(tre), jnp.asarray(tim),
        jnp.asarray(starts), n_comb_sp, ds_comb_arm)

    # Fetch only what the threshold + peak scan need up front (one ~270 KB
    # transfer); the full (3, 9600, n_f) tables stay on device behind lazy
    # handles — most scans find no peaks and never touch them.
    packed = np.asarray(packed, dtype=np.float64)
    return XcorrResult(
        xc_incoherent_collapsed_pow=packed[0:3],
        xc_incoherent_collapsed_frq=packed[3:6].astype(np.int64),
        xc_incoherent_single=_LazyArray(single),
        xc_incoherent=_LazyArray(inc),
        sp_incoherent=packed[6],
        n_comb_xc=int(n_comb_xc),
        n_comb_sp=int(n_comb_sp),
    )


class _LazyArray:
    """Device-array handle that fetches to host numpy on first indexing."""

    def __init__(self, dev):
        self._dev = dev
        self._np = None

    def _materialize(self):
        if self._np is None:
            self._np = np.asarray(self._dev, dtype=np.float64)
        return self._np

    def __getitem__(self, key):
        return self._materialize()[key]

    def __array__(self, dtype=None, copy=None):
        arr = self._materialize()
        return arr.astype(dtype) if dtype is not None else arr

    @property
    def shape(self):
        return self._dev.shape

"""Batched (multi-cell) tracker math on device.

The reference tracks each cell on its own thread, ~4 cells on a dual-core
i7 (doc/LTE-Tracker.html:56-57). The device equivalent promised by
SURVEY §2.9 is a *batched* tracker: every per-symbol / per-RS computation
of src/tracker_thread.cpp expressed as fixed-shape array math with the
cell axis vectorized, so one device tracks many cells. This module
holds those pure device functions; the sequential control flow (FIFO
bookkeeping, inverse-variance feedback blends, health counters) stays on
the host in tracker/batch_runtime.py.

All functions take/return split re/im planes (trailing axis 2) — the
device path avoids complex dtypes throughout (see ops/xcorr_jax.py).

Numerical contracts mirror tracker/cell_tracker.py (which cites
src/tracker_thread.cpp line by line); parity is tested function-for-
function against it in tests/test_batch_frontend.py.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from lte_cell_scanner.constants import FS_LTE

# ----------------------------------------------------------------------
# Complex helpers on (..., 2) split planes.


def _cmul(a, b):
    re = a[..., 0] * b[..., 0] - a[..., 1] * b[..., 1]
    im = a[..., 0] * b[..., 1] + a[..., 1] * b[..., 0]
    return jnp.stack([re, im], axis=-1)


def _cconj(a):
    return jnp.stack([a[..., 0], -a[..., 1]], axis=-1)


def _cabs2(a):
    return a[..., 0] ** 2 + a[..., 1] ** 2


def to_ri(x: np.ndarray) -> np.ndarray:
    return np.stack([np.real(x), np.imag(x)], axis=-1).astype(np.float32)


def from_ri(x) -> np.ndarray:
    x = np.asarray(x, dtype=np.float64)
    return x[..., 0] + 1j * x[..., 1]


# ----------------------------------------------------------------------
# get_fd: FOC + 2-sample TOC + DFT(128 -> 72 SC) + phase compensation.

_CN = np.concatenate([np.arange(-36, 0), np.arange(1, 37)]).astype(np.float64)
_BINS = np.concatenate([np.arange(92, 128), np.arange(1, 37)])


@functools.lru_cache(maxsize=1)
def _dft_mats():
    """(128, 72) cos/sin of the unitary DFT restricted to the 72 sync
    bins, with the 2-sample cyclic rotation folded in."""
    t = np.arange(128)[:, None]
    k = _BINS[None, :]
    # The 2-sample TOC rotate (y[u] = x[(u+2) % 128]) is folded in:
    # sum_u x[(u+2)%128] e^{-2pi j u k/128} = sum_t x[t] e^{-2pi j (t-2) k/128}.
    w = np.exp(-2j * np.pi * ((t - 2) % 128) * k / 128.0) / np.sqrt(128.0)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


def get_fd_batch(data, foc_rate, bpo, late, j=None):
    """Symbol demod for a batch of 128-sample windows.

    data:     (..., 128, 2) f32 — raw symbol windows.
    foc_rate: (...,) f32 — -2*pi*fo/(fs_programmed*k_factor) per window.
    bpo:      (...,) f32 — accumulated bulk phase offset to apply
              (host-precomputed in float64, already includes this
              window's increment; reference: src/tracker_thread.cpp:
              151-171).
    late:     (...,) f32 — fractional timing for the phase ramp.
    j:        optional (..., 128) f32 — per-lane original sample index
              when ``data`` is an aligned-blend window
              (ops/sync_jax._aligned_wins); the caller must already
              have folded the blend's b offset into ``late``.

    Returns syms (..., 72, 2).
    """
    t = jnp.arange(128, dtype=data.dtype) if j is None else j
    ph = foc_rate[..., None] * t                      # (..., 128)
    foc = jnp.stack([jnp.cos(ph), jnp.sin(ph)], axis=-1)
    x = _cmul(data, foc)

    wr, wi = (jnp.asarray(m) for m in _dft_mats())
    # y = x @ W (the 2-sample rotation lives inside W)
    yr = x[..., 0] @ wr - x[..., 1] @ wi
    yi = x[..., 0] @ wi + x[..., 1] @ wr

    # Fractional-timing ramp + bulk phase in one rotation per subcarrier.
    cn = jnp.asarray(_CN.astype(np.float32))
    ang = bpo[..., None] - 2 * jnp.pi * late[..., None] * cn / 128.0
    rot = jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)
    return _cmul(jnp.stack([yr, yi], axis=-1), rot)


def bulk_phase_offsets(bpo0: np.ndarray, fo: np.ndarray,
                       n_samp_elapsed: np.ndarray) -> np.ndarray:
    """Host-side float64 bulk-phase accumulation (the drift-sensitive
    quantity — kept in f64 exactly because the reference's f32-style
    accumulation drifts, doc/LTE-Tracker.html:89-90).

    bpo0 (C,), fo (C, S), n_samp_elapsed (C, S) -> bpo (C, S) to pass to
    get_fd_batch, plus the final carry (C,).
    """
    inc = 2 * np.pi * n_samp_elapsed * (1.0 / (FS_LTE / 16)) * (-fo)
    acc = bpo0[:, None] + np.cumsum(inc, axis=1)
    acc = np.mod(acc + np.pi, 2 * np.pi) - np.pi
    return acc, acc[:, -1]


# ----------------------------------------------------------------------
# Raw CE extraction at RS positions.


def raw_ce_batch(syms, rs_conj, shift):
    """ce_raw = syms[shift::6] * conj(rs).

    syms (..., 72, 2); rs_conj (..., 12, 2) — conj of the RS sequence;
    shift (...,) i32 in [0, 6). Returns (..., 12, 2).
    """
    idx = shift[..., None] + 6 * jnp.arange(12, dtype=jnp.int32)
    got = jnp.take_along_axis(syms, idx[..., None], axis=-2)
    return _cmul(got, rs_conj)


# ----------------------------------------------------------------------
# 3-symbol CE filter + noise/signal power (filter_ce, tracker_thread.cpp
# :176-202 and :912-932).


@functools.lru_cache(maxsize=1)
def _filter_mats():
    """Averaging matrices: curr (12,12) over {t-1,t,t+1}; lohi (12,12)
    over {t,t+1} (prev shift < curr); hilo over {t-1,t}; plus counts."""
    curr = np.zeros((12, 12), np.float32)
    lohi = np.zeros((12, 12), np.float32)
    hilo = np.zeros((12, 12), np.float32)
    n_curr = np.zeros(12, np.float32)
    n_lohi = np.zeros(12, np.float32)
    n_hilo = np.zeros(12, np.float32)
    for t in range(12):
        for i in (t - 1, t, t + 1):
            if 0 <= i < 12:
                curr[t, i] = 1
                n_curr[t] += 1
        for i in (t, t + 1):
            if 0 <= i < 12:
                lohi[t, i] = 1
                n_lohi[t] += 1
        for i in (t - 1, t):
            if 0 <= i < 12:
                hilo[t, i] = 1
                n_hilo[t] += 1
    return curr, lohi, hilo, n_curr, n_lohi, n_hilo


def filter_ce_batch(ce_prev, ce_curr, ce_next, prev_lower):
    """3-symbol staggered-comb filter + bias-corrected powers.

    ce_* (..., 12, 2); prev_lower (...,) bool — True when the previous
    RS symbol's shift is below the current one. Returns
    (ce_filt (...,12,2), np_curr, tp_curr, sp_curr, sp_raw).
    """
    curr, lohi, hilo, n_curr, n_lohi, n_hilo = (
        jnp.asarray(m) for m in _filter_mats())

    def mat(ce, m):
        return jnp.stack([ce[..., 0] @ m.T, ce[..., 1] @ m.T], axis=-1)

    adj = ce_prev + ce_next
    tot_lo = mat(ce_curr, curr) + mat(adj, lohi)
    tot_hi = mat(ce_curr, curr) + mat(adj, hilo)
    cnt_lo = n_curr + 2 * n_lohi
    cnt_hi = n_curr + 2 * n_hilo
    pl = prev_lower[..., None, None]
    ce_filt = jnp.where(pl, tot_lo / cnt_lo[:, None],
                        tot_hi / cnt_hi[:, None])

    np_curr = jnp.mean(_cabs2(ce_curr - ce_filt), axis=-1) * (7.0 / 6.0)
    tp_curr = jnp.mean(_cabs2(ce_filt), axis=-1)
    sp_raw = tp_curr - np_curr / 7.0
    sp_curr = jnp.maximum(1e-5, sp_raw)
    return ce_filt, np_curr, tp_curr, sp_curr, sp_raw


# ----------------------------------------------------------------------
# FOE / TOE raw estimates (the feedback blends stay on host).


def foe_stats_batch(ce_prev, ce_next, ce_filt, np_curr):
    """MRC frequency-offset statistic (do_foe, tracker_thread.cpp:204-243).

    Returns (foe_comb (...,2), foe_comb_np (...,)) — the complex rotation
    estimate and its noise power; the host converts angle -> Hz with its
    own f64 timestamps and blends into the global FO.
    """
    foe = _cmul(_cconj(ce_prev), ce_next)                  # (..., 12, 2)
    cf2 = _cabs2(ce_filt)
    foe_np = np_curr[..., None] ** 2 + 2 * np_curr[..., None] * cf2
    weight = cf2 / foe_np
    foe_comb = jnp.sum(foe * weight[..., None], axis=-2)
    foe_comb_np = jnp.sum(foe_np * weight * weight, axis=-1)
    scale = 1.0 / jnp.sum(cf2 * weight, axis=-1)
    return foe_comb * scale[..., None], foe_comb_np * scale * scale


def toe_stats_batch(ce_prev, ce_curr, sp_curr, np_curr, prev_lower):
    """Staggered-RS timing estimate (do_toe_v2, tracker_thread.cpp:245-279).

    Returns (delay (...,), delay_np (...,)) in samples.
    """
    a = jnp.where(prev_lower[..., None, None], ce_prev, ce_curr)
    b = jnp.where(prev_lower[..., None, None], ce_curr, ce_prev)
    toe1 = jnp.sum(_cmul(_cconj(a), b), axis=-2) / 12.0
    t2a = jnp.sum(_cmul(_cconj(b[..., 0:5, :]), a[..., 1:6, :]), axis=-2)
    t2b = jnp.sum(_cmul(_cconj(b[..., 6:11, :]), a[..., 7:12, :]), axis=-2)
    toe2 = (t2a + t2b) / 10.0
    ang1 = jnp.arctan2(toe1[..., 1], toe1[..., 0])
    ang2 = jnp.arctan2(toe2[..., 1], toe2[..., 0])
    delay = -(ang1 + ang2) / 2.0 / 3.0 / (2 * jnp.pi / 128.0)
    delay_np = jnp.maximum(np_curr / sp_curr / 2.0 / 12.0, 0.001)
    return delay, delay_np


def ac_fd_batch(ce_curr, sp_curr, np_curr):
    """Frequency-domain CE autocorrelation (do_ac_fd, :318-340).

    Returns (ac (...,12,2), ac_np (...,12))."""
    outs = []
    for d in range(12):
        prod = _cmul(_cconj(ce_curr[..., :12 - d, :]), ce_curr[..., d:, :])
        outs.append(jnp.mean(prod, axis=-2))
    ac = jnp.stack(outs, axis=-2) / sp_curr[..., None, None]
    denom = jnp.arange(12, 0, -1, dtype=ce_curr.dtype)
    ac_np = ((np_curr ** 2 / sp_curr ** 2
              + 2 * np_curr / sp_curr)[..., None] / denom)
    return ac, ac_np


# ----------------------------------------------------------------------
# Sync-channel (PSS/SSS) measurements (tracker_thread.cpp:754-820).


@functools.lru_cache(maxsize=1)
def _smooth62():
    m = np.zeros((62, 62), np.float32)
    for t in range(62):
        lt, rt = max(0, t - 6), min(t + 6, 61)
        m[t, lt:rt + 1] = 1.0 / (2 * (rt - lt + 1))
    return m


def sync_meas_batch(pss_sym, sss_sym, pss_conj, sss_seq):
    """SP/NP/TP + smoothed CE from one PSS/SSS symbol pair.

    pss_sym/sss_sym (..., 72, 2); pss_conj (..., 62, 2) — conj(PSS_fd);
    sss_seq (..., 62) — the +/-1 SSS. Returns dict of measurements.
    """
    def power(x):
        return jnp.mean(_cabs2(x), axis=-1)

    np_blank = (power(sss_sym[..., 0:5, :]) + power(sss_sym[..., 67:72, :])
                + power(pss_sym[..., 0:5, :])
                + power(pss_sym[..., 67:72, :])) / 4.0
    ce_sss = sss_sym[..., 5:67, :] * sss_seq[..., None]
    ce_pss = _cmul(pss_sym[..., 5:67, :], pss_conj)
    m = jnp.asarray(_smooth62())

    def mat(ce):
        return jnp.stack([ce[..., 0] @ m.T, ce[..., 1] @ m.T], axis=-1)

    ce_smooth = mat(ce_sss) + mat(ce_pss)
    np_est = (power(ce_smooth - ce_sss) * 13 / 12
              + power(ce_smooth - ce_pss) * 13 / 12) / 2.0
    tp = power(ce_smooth)
    sp = tp - np_est / 13.0
    return {"tp": tp, "sp": sp, "np": np_est, "np_blank": np_blank,
            "ce_smooth": ce_smooth}

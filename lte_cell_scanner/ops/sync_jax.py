"""Batched device SSS detection + fine FOE (stage 1 of the device decode).

reference: src/searcher.cpp:533-850 (sss_detect_getce_sss, sss_detect_ml,
sss_detect, pss_sss_foe), mirrored numerically by the float64 host path in
ops/sync.py. Where the host processes one candidate peak at a time, this
module runs EVERY candidate of a capture in ONE fixed-shape device
program:

- the per-repetition PSS/SSS window extraction is a batched gather + one
  (128 -> 62-bin) DFT matmul;
- the 168 x 2 x {nrm, ext} ML hypothesis scan is four matmuls against the
  (168, 124) SSS table;
- the fine FOE is evaluated for all four (frame-phase ordering x CP type)
  combinations with HOST-precomputed float64 window locations, and the
  detected combination is selected on device — so the only host -> device
  traffic is the tiny index plan, and the only device -> host traffic is
  ~8 scalars per peak.

Sample-index arithmetic (the k_factor-sensitive part, SURVEY §7 "hard
parts") stays in float64 on the host inside :func:`sync_plan`; the device
does only window-local math, which is float32-safe (per-window phases
span < 3 cycles).

No complex dtypes on device: split re/im planes throughout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from lte_cell_scanner import platform
from lte_cell_scanner.constants import FS_LTE, HALF_FRAME
from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.models.pss import pss_fd
from lte_cell_scanner.models.sss import sss_fd_all
from lte_cell_scanner.tracker.batch_frontend import _cabs2, _cmul, _cconj
from lte_cell_scanner.utils.dsp import wrap

N_REP = 16   # PSS repetitions in an 80 ms capture (ceil(153600/9600))
N_SSS = 16   # PSS/SSS pairs available to the fine FOE in 80 ms


def _n_rep_for(n_cap: int) -> int:
    """Repetition-axis size for a capture: all of a standard 80 ms
    capture's 16 half-frames, growing in steps of 4 for longer captures
    (the host path combines EVERY repetition; truncating would break
    backend parity). Steps of 4 keep jit cache keys few."""
    need = -(-n_cap // HALF_FRAME)
    return max(N_REP, -(-need // 4) * 4)


def _bucket(n: int, lo: int = 4) -> int:
    """Coarse batch buckets: every distinct bucket costs a fresh jit
    compile, and padded decode rows are cheap, so few-and-large beats snug — x4 steps up to 64, then x2
    (a 65-candidate sweep pays 128 padded rows, not 256)."""
    b = lo
    while b < n:
        b *= 4 if b < 64 else 2
    return b


# ----------------------------------------------------------------------
# Constant tables.


@functools.lru_cache(maxsize=1)
def _dft62():
    """(128, 62) unitary DFT restricted to the 62 sync bins with the
    2-sample timing-margin rotation folded in (ops/sync.py extract_psss)."""
    bins = np.concatenate([np.arange(97, 128), np.arange(1, 32)])
    t = np.arange(128)[:, None]
    w = np.exp(-2j * np.pi * ((t - 2) % 128) * bins[None, :] / 128.0)
    w = w / np.sqrt(128.0)
    return w.real.astype(np.float32), w.imag.astype(np.float32)


@functools.lru_cache(maxsize=1)
def _smooth13_mat():
    """(62, 62) frequency smoother: out[t] = mean(h[max(0,t-6):min(61,t+6)+1])."""
    m = np.zeros((62, 62), np.float32)
    for t in range(62):
        lt, rt = max(0, t - 6), min(61, t + 6)
        m[t, lt:rt + 1] = 1.0 / (rt - lt + 1)
    return m


@functools.lru_cache(maxsize=1)
def _pss_fd_conj():
    """(3, 62, 2) conj(PSS_fd) split planes."""
    t = np.stack([np.conj(pss_fd(i)) for i in range(3)])
    return np.stack([t.real, t.imag], -1).astype(np.float32)


@functools.lru_cache(maxsize=1)
def _sss_tables():
    """(3, 168, 2, 62) float32 +/-1 SSS table for each n_id_2."""
    return np.stack([sss_fd_all(i) for i in range(3)]).astype(np.float32)


# ----------------------------------------------------------------------
# Host-side plan (float64 index arithmetic).


@dataclasses.dataclass
class SyncPlan:
    """Fixed-shape arrays driving the device program (leading axis B)."""

    pss_idx: np.ndarray      # (B, N_REP) i32 — PSS DFT window starts
    rep_mask: np.ndarray     # (B, N_REP) f32
    foc: np.ndarray          # (B,) f32 — -peak_freq
    inv_fs: np.ndarray       # (B,) f32 — 1 / fs_eff
    n_id_2: np.ndarray       # (B,) i32
    foe_pss: np.ndarray      # (B, 2, 2, N_SSS) i32 (ordering, cp)
    foe_sss: np.ndarray      # (B, 2, 2, N_SSS) i32
    foe_mask: np.ndarray     # (B, 2, 2, N_SSS) f32
    foe_seq: np.ndarray      # (B, 2, 2, N_SSS) i32 — 0: slot-0 SSS, 1: slot-10
    foe_phase: np.ndarray    # (B, 2, 2) f32 — phase const angle per (o, cp)
    foe_conv: np.ndarray     # (B, 2) f32 — fs_eff / (2 pi dist) per cp
    freq: np.ndarray         # (B,) f64 — coarse peak freq
    frame_start: np.ndarray  # (B, 2) f64 — candidate per ordering (host f64)
    valid: np.ndarray        # (B,) bool — real (non-padding) rows


def sync_plan(cells: Sequence[Cell], n_cap: int, fc_requested: float,
              fc_programmed: float, fs_programmed: float,
              bucket: bool = True,
              cap_bases: Sequence[int] = None) -> SyncPlan:
    """Float64 window-location plan for a batch of candidate peaks.

    Mirrors the index arithmetic of ops/sync.py `_getce_sss` /
    `sss_detect` / `pss_sss_foe` exactly (native mode).

    ``cap_bases`` (per cell) offsets every window index into a stacked
    multi-capture buffer of per-capture length ``n_cap`` — this is how a
    whole fc sweep's candidates run in ONE dispatch.
    """
    B = _bucket(max(1, len(cells))) if bucket else max(1, len(cells))
    if cap_bases is None:
        cap_bases = [0] * len(cells)
    del fc_requested, fc_programmed, fs_programmed  # per-cell (sweeps mix fcs)
    p = SyncPlan(
        pss_idx=np.zeros((B, _n_rep_for(n_cap)), np.int32),
        rep_mask=np.zeros((B, _n_rep_for(n_cap)), np.float32),
        foc=np.zeros(B, np.float32),
        inv_fs=np.zeros(B, np.float32),
        n_id_2=np.zeros(B, np.int32),
        foe_pss=np.zeros((B, 2, 2, _n_rep_for(n_cap)), np.int32),
        foe_sss=np.zeros((B, 2, 2, _n_rep_for(n_cap)), np.int32),
        foe_mask=np.zeros((B, 2, 2, _n_rep_for(n_cap)), np.float32),
        foe_seq=np.zeros((B, 2, 2, _n_rep_for(n_cap)), np.int32),
        foe_phase=np.zeros((B, 2, 2), np.float32),
        foe_conv=np.zeros((B, 2), np.float32),
        freq=np.zeros(B, np.float64),
        frame_start=np.zeros((B, 2), np.float64),
        valid=np.zeros(B, bool),
    )
    # Vectorized over the candidate axis (the per-cell Python loop cost
    # ~0.24 ms/fc at production sweep sizes). Every expression keeps the
    # float64 evaluation ORDER of the original per-cell code (start +
    # step*arange, round-then-filter), so the plans are bit-identical.
    n = len(cells)
    if n == 0:
        return p
    R = _n_rep_for(n_cap)
    fc_req = np.array([c.fc_requested for c in cells], np.float64)
    fc_prog = np.array([c.fc_programmed for c in cells], np.float64)
    fs_prog = np.array([c.fs_programmed for c in cells], np.float64)
    freq = np.array([c.freq for c in cells], np.float64)
    ind = np.array([c.ind for c in cells], np.float64)
    base_v = np.asarray(list(cap_bases)[:n], np.int64)
    ii = np.arange(R, dtype=np.float64)[None, :]            # (1, R)

    k_factor = (fc_req - freq) / fc_prog
    fs_eff = fs_prog * k_factor
    u = 16.0 / FS_LTE * fs_prog * k_factor
    peak_loc = np.where(ind + 9 < 162, ind + HALF_FRAME * k_factor, ind)

    # --- detection windows (ops/sync.py:_getce_sss)
    step = k_factor * HALF_FRAME
    n_in_range = np.floor((n_cap - 125 - 9 - peak_loc) / step)  # (n,)
    pss_loc = peak_loc[:, None] + step[:, None] * ii            # (n, R)
    locs = np.round(pss_loc).astype(np.int64) + 9 - 2
    rep_ok = (ii <= n_in_range[:, None]) & (locs + 128 <= n_cap)
    p.pss_idx[:n] = np.where(rep_ok, locs + base_v[:, None], 0)
    p.rep_mask[:n] = rep_ok
    p.foc[:n] = -freq
    p.inv_fs[:n] = 1.0 / fs_eff
    p.n_id_2[:n] = [c.n_id_2 for c in cells]
    p.freq[:n] = freq
    p.valid[:n] = True

    # --- frame_start candidates per ordering (ops/sync.py:sss_detect)
    fs_base = peak_loc + (128 + 9 - 960 - 2) * u
    p.frame_start[:n, 0] = wrap(fs_base, -0.5, 2 * HALF_FRAME - 0.5)
    p.frame_start[:n, 1] = wrap(fs_base + HALF_FRAME * u, -0.5,
                                2 * HALF_FRAME - 0.5)

    # --- FOE windows for every (ordering, cp) combo
    # (ops/sync.py:pss_sss_foe)
    for ci, cp_type in enumerate(("normal", "extended")):
        if cp_type == "normal":
            dist = np.round((128 + 9) * u).astype(np.int64)
            back = (960 - 128 - 9 - 128) * u
        else:
            # reference quirk: no fs/FS_LTE rescale on this arm
            # (src/searcher.cpp:783)
            dist = np.round((128 + 32) * k_factor).astype(np.int64)
            back = (960 - 128 - 32 - 128) * u
        p.foe_conv[:n, ci] = fs_eff / (2.0 * np.pi * dist)
        p.foe_phase[:n, :, ci] = (np.pi * -freq
                                  / (FS_LTE / 16 / 2) * -dist)[:, None]
        for oi in range(2):
            first_sss = wrap(p.frame_start[:n, oi] + back, -0.5,
                             9600 * 2 - 0.5)
            adj = first_sss - HALF_FRAME * k_factor > -0.5
            first_sss = np.where(adj, first_sss - HALF_FRAME * k_factor,
                                 first_sss)
            sn0 = np.where(adj, 10, 0)
            sss_step = HALF_FRAME * u
            n_sss_f = np.floor((n_cap - 127 - dist - 100 - first_sss)
                               / sss_step)                   # (n,)
            loc_set = first_sss[:, None] + sss_step[:, None] * ii
            sss_ok = ii <= n_sss_f[:, None]
            sss_locs = np.round(loc_set).astype(np.int64)
            p.foe_sss[:n, oi, ci] = np.where(
                sss_ok, sss_locs + base_v[:, None], 0)
            p.foe_pss[:n, oi, ci] = np.where(
                sss_ok, sss_locs + dist[:, None] + base_v[:, None], 0)
            p.foe_mask[:n, oi, ci] = sss_ok
            sn = np.where((ii.astype(np.int64) % 2) == 0, sn0[:, None],
                          10 - sn0[:, None])
            p.foe_seq[:n, oi, ci] = np.where(sss_ok, sn != 0, 0)
    return p


# ----------------------------------------------------------------------
# Device program.


_CN62 = np.concatenate([np.arange(97, 128) - 128,
                        np.arange(1, 32)]).astype(np.float32)


def _extract_psss_dev(cap, idx, foc_rate):
    """FOC + 2-sample TOC + DFT to the 62 sync bins for the windows at
    ``idx`` (fused _aligned_wins extraction, see its docstring).

    cap: (n, 2); idx: (...,) i32; foc_rate: broadcastable to idx's
    shape — the per-sample FOC phase rate 2*pi*foc/fs_eff.
    Returns (..., 62, 2).
    """
    g, j, b = _aligned_wins(cap, idx)
    ang = foc_rate[..., None] * j
    rot = jnp.stack([jnp.cos(ang), jnp.sin(ang)], axis=-1)
    x = _cmul(g, rot)
    wr, wi = (jnp.asarray(m) for m in _dft62())
    yr = x[..., 0] @ wr - x[..., 1] @ wi
    yi = x[..., 0] @ wi + x[..., 1] @ wr
    y = jnp.stack([yr, yi], axis=-1)
    # Undo the blend's b-sample cyclic rotation in the bin domain.
    tw = (2.0 * jnp.pi / 128.0) * b[..., None].astype(cap.dtype) \
        * jnp.asarray(_CN62)
    return _cmul(y, jnp.stack([jnp.cos(tw), jnp.sin(tw)], axis=-1))


def _aligned_wins(cap, idx):
    """Cyclic-blend window extraction from 128-aligned rows.

    cap (n, 2); idx (...,) i32 window starts (out-of-range rows clamp —
    callers mask those windows). Returns (g, j, b):
      g (..., 128, 2) — lane-blend of aligned rows a=idx//128 and a+1:
        lane c holds capture sample idx + (c - b) mod 128, b = idx%128;
      j (..., 128) — the original in-window sample index of each lane
        (for per-sample FOC rotation);
      b (...,) i32 — DFT_128(true window) = e^{2pi i b k/128} DFT_128(g),
        because the DFT kernel has period 128 in the sample index, so
        lane c contributes at W^{ck} = W^{(j+b)k}.

    This replaces a 128-wide elementwise gather with two contiguous row
    gathers + a lane mask, with the b-rotation folded into the existing
    post-DFT per-subcarrier phase compensation. Which form is faster on
    the GPU has not been measured.
    """
    n = cap.shape[0]
    if n % 128:
        cap = jnp.pad(cap, ((0, 128 - n % 128), (0, 0)))
    V = cap.reshape(-1, 128, 2)
    a = idx // 128
    b = idx % 128
    y = V[jnp.clip(a, 0, V.shape[0] - 1)]
    y2 = V[jnp.clip(a + 1, 0, V.shape[0] - 1)]
    c = jnp.arange(128, dtype=jnp.int32)
    mask = c >= b[..., None]
    g = jnp.where(mask[..., None], y, y2)
    j = (c - b[..., None] + jnp.where(mask, 0, 128)).astype(cap.dtype)
    return g, j, b


def _combine(h, np_, raw, mask):
    """MMSE combination across repetitions (axis -3 of h/raw, -1 of mask).

    h, raw: (B, R, 62, 2); np_: (B, R); mask: (B, R).
    Returns (np_est (B, 62), est (B, 62, 2)).
    """
    w = mask / jnp.where(np_ > 0, np_, 1.0)               # (B, R)
    acc = jnp.sum(_cabs2(h) * w[..., None], axis=-2)      # (B, 62)
    np_est = 1.0 / (1.0 + acc)
    num = jnp.sum(_cmul(_cconj(h), raw) * w[..., None, None], axis=-3)
    return np_est, num * np_est[..., None]


def _ml_lls(est, np12, tables):
    """Log-likelihood of the 168 hypotheses for one (est, ordering).

    est: (B, 124, 2); np12: (B, 124); tables: (B, 168, 124) +/-1.
    Returns (B, 168).
    """
    inv = 1.0 / np12
    s_term = jnp.sum((1.0 + _cabs2(est)) * inv, axis=-1)       # (B,)
    er, ei = est[..., 0], est[..., 1]
    # corr = sum_k t_k conj(e_k);  cw = same with 1/np weights.
    cr = jnp.einsum("bhk,bk->bh", tables, er)
    ci = -jnp.einsum("bhk,bk->bh", tables, ei)
    cwr = jnp.einsum("bhk,bk->bh", tables, er * inv)
    cwi = -jnp.einsum("bhk,bk->bh", tables, ei * inv)
    mag = jnp.sqrt(cr * cr + ci * ci)
    mag = jnp.where(mag > 0, mag, 1.0)
    return -s_term[:, None] + 2.0 * (cwr * cr + cwi * ci) / mag


def _pack_sync_plan(plan):
    """SyncPlan -> (i32 buffer, f32 buffer): the whole per-batch plan as
    TWO host->device copies instead of eleven device_puts (see
    ops/mib_jax._pack_plan for the same packing)."""
    i32 = np.concatenate([
        plan.pss_idx.reshape(-1), plan.n_id_2.reshape(-1),
        plan.foe_pss.reshape(-1), plan.foe_sss.reshape(-1),
        plan.foe_seq.reshape(-1)]).astype(np.int32)
    f32 = np.concatenate([
        plan.rep_mask.reshape(-1), plan.foc.reshape(-1),
        plan.inv_fs.reshape(-1), plan.foe_mask.reshape(-1),
        plan.foe_phase.reshape(-1), plan.foe_conv.reshape(-1)
    ]).astype(np.float32)
    return i32, f32


@platform.jit(static_argnames=("n_rep", "n_sss"))
def _sync_device_packed(cap, plan_i32, plan_f32, thresh2_n_sigma, *,
                        n_rep=N_REP, n_sss=N_SSS):
    """Unpack the two plan buffers (static slices — shapes are fixed
    multiples of the bucketed B) and run the sync program. ``n_rep`` /
    ``n_sss`` are the plan's (capture-length-dependent — see _n_rep_for)
    repetition-axis sizes, static so the slices stay constant."""
    N_REP, N_SSS = n_rep, n_sss          # shadow the 80 ms defaults
    per_i = N_REP + 1 + 3 * (4 * N_SSS)
    B = plan_i32.shape[0] // per_i
    cur = {"i": 0, "f": 0}

    def cut_i(shape):
        n = int(np.prod(shape))
        seg = jax.lax.slice_in_dim(plan_i32, cur["i"], cur["i"] + n)
        cur["i"] += n
        return seg.reshape(shape)

    def cut_f(shape):
        n = int(np.prod(shape))
        seg = jax.lax.slice_in_dim(plan_f32, cur["f"], cur["f"] + n)
        cur["f"] += n
        return seg.reshape(shape)

    pss_idx = cut_i((B, N_REP))
    n_id_2 = cut_i((B,))
    foe_pss = cut_i((B, 2, 2, N_SSS))
    foe_sss = cut_i((B, 2, 2, N_SSS))
    foe_seq = cut_i((B, 2, 2, N_SSS))
    rep_mask = cut_f((B, N_REP))
    foc = cut_f((B,))
    inv_fs = cut_f((B,))
    foe_mask = cut_f((B, 2, 2, N_SSS))
    foe_phase = cut_f((B, 2, 2))
    foe_conv = cut_f((B, 2))
    return _sync_device(cap, pss_idx, rep_mask, foc, inv_fs, n_id_2,
                        foe_pss, foe_sss, foe_mask, foe_seq, foe_phase,
                        foe_conv, thresh2_n_sigma)


@platform.jit
def _sync_device(cap, pss_idx, rep_mask, foc, inv_fs, n_id_2, foe_pss,
                 foe_sss, foe_mask, foe_seq, foe_phase, foe_conv,
                 thresh2_n_sigma):
    """The full batched sync program. See module docstring.

    cap: (n_cap, 2) f32. Returns dict of (B,)-shaped results.
    """
    f32 = cap.dtype
    foc_rate = 2.0 * jnp.pi * foc * inv_fs                 # (B,)

    # ---- detection: channel estimates from every PSS repetition.
    h_raw = _extract_psss_dev(cap, pss_idx, foc_rate[:, None])
    pconj = jnp.asarray(_pss_fd_conj())[n_id_2]            # (B, 62, 2)
    h_raw = _cmul(h_raw, pconj[:, None])
    sm = jnp.asarray(_smooth13_mat())
    h_sm = jnp.stack([h_raw[..., 0] @ sm.T, h_raw[..., 1] @ sm.T], -1)
    pss_np = jnp.mean(_cabs2(h_sm - h_raw), axis=-1)       # (B, R)

    nrm_raw = _extract_psss_dev(cap, pss_idx - 128 - 9, foc_rate[:, None])
    ext_raw = _extract_psss_dev(cap, pss_idx - 128 - 32, foc_rate[:, None])

    # Parity split: h1 = even repetitions, h2 = odd.
    ev, od = rep_mask[:, 0::2], rep_mask[:, 1::2]
    h1, h2 = h_sm[:, 0::2], h_sm[:, 1::2]
    np1, np2 = pss_np[:, 0::2], pss_np[:, 1::2]
    np_h1, est_nrm_h1 = _combine(h1, np1, nrm_raw[:, 0::2], ev)
    np_h2, est_nrm_h2 = _combine(h2, np2, nrm_raw[:, 1::2], od)
    _, est_ext_h1 = _combine(h1, np1, ext_raw[:, 0::2], ev)
    _, est_ext_h2 = _combine(h2, np2, ext_raw[:, 1::2], od)

    np12 = jnp.concatenate([np_h1, np_h2], axis=-1)        # (B, 124)
    est_nrm = jnp.concatenate([est_nrm_h1, est_nrm_h2], axis=-2)
    est_ext = jnp.concatenate([est_ext_h1, est_ext_h2], axis=-2)

    # ---- ML scan over 168 x 2 orderings x {nrm, ext}.
    tabs = jnp.asarray(_sss_tables())[n_id_2]              # (B, 168, 2, 62)
    h12 = tabs.reshape(tabs.shape[0], 168, 124)
    h21 = tabs[:, :, ::-1, :].reshape(tabs.shape[0], 168, 124)
    ll = jnp.stack([
        jnp.stack([_ml_lls(est_nrm, np12, h12),
                   _ml_lls(est_nrm, np12, h21)], axis=-1),
        jnp.stack([_ml_lls(est_ext, np12, h12),
                   _ml_lls(est_ext, np12, h21)], axis=-1),
    ], axis=-1)                                            # (B, 168, 2o, 2c)

    ll_max_c = jnp.max(ll, axis=(1, 2))                    # (B, 2c)
    cp_sel = jnp.argmax(ll_max_c, axis=-1).astype(jnp.int32)
    ll_cp = jnp.take_along_axis(
        ll, cp_sel[:, None, None, None], axis=3)[..., 0]   # (B, 168, 2o)
    ord_sel = jnp.argmax(jnp.max(ll_cp, axis=1), axis=-1).astype(jnp.int32)
    ll_ord = jnp.take_along_axis(
        ll_cp, ord_sel[:, None, None], axis=2)[..., 0]     # (B, 168)
    n_id_1 = jnp.argmax(ll_ord, axis=-1).astype(jnp.int32)
    lik_final = jnp.max(ll_ord, axis=-1)

    flat = ll.reshape(ll.shape[0], -1)                     # (B, 672)
    lik_mean = jnp.mean(flat, axis=-1)
    lik_std = jnp.sqrt(jnp.sum((flat - lik_mean[:, None]) ** 2, axis=-1)
                       / (flat.shape[-1] - 1))
    detected = lik_final >= lik_mean + lik_std * thresh2_n_sigma

    # ---- fine FOE for all four (ordering, cp) combos, then select.
    fr = foc_rate[:, None, None, None]
    fh_raw = _cmul(_extract_psss_dev(cap, foe_pss, fr),
                   pconj[:, None, None, None])
    fh_sm = jnp.stack([fh_raw[..., 0] @ sm.T, fh_raw[..., 1] @ sm.T], -1)
    fnp = jnp.mean(_cabs2(fh_sm - fh_raw), axis=-1)        # (B,2,2,S)

    # Known SSS of the detected (n_id_1, slot) per repetition.
    tab_det = jnp.take_along_axis(
        tabs, n_id_1[:, None, None, None], axis=1)[:, 0]   # (B, 2, 62)
    bb = jnp.arange(tab_det.shape[0])[:, None, None, None]
    known = tab_det[bb, foe_seq]                           # (B,2,2,S,62)

    ph = foe_phase[..., None, None]                        # (B,2,2,1,1)
    prot = jnp.stack([jnp.cos(ph), jnp.sin(ph)], -1)       # (B,2,2,1,1,2)
    sss_raw = _cmul(_extract_psss_dev(cap, foe_sss, fr), prot)
    sss_raw = sss_raw * known[..., None]

    fh2 = _cabs2(fh_sm)
    # Zero-guard like _combine: an all-zero padding window gives
    # fh2 = fnp = 0 and an unguarded 0/0 NaN would survive the
    # foe_mask multiply (NaN * 0 = NaN) and poison the candidate.
    fnp_s = jnp.where(fnp > 0, fnp, 1.0)
    w = fh2 / (2.0 * fh2 * fnp_s[..., None] + (fnp_s ** 2)[..., None])
    m_all = jnp.sum(_cmul(_cconj(sss_raw), fh_raw)
                    * (w * foe_mask[..., None])[..., None],
                    axis=(-3, -2))                         # (B, 2, 2, 2ri)
    m_o = jnp.take_along_axis(m_all, ord_sel[:, None, None, None],
                              axis=1)[:, 0]                # (B, 2c, 2)
    m_sel = jnp.take_along_axis(m_o, cp_sel[:, None, None],
                                axis=1)[:, 0]              # (B, 2)
    conv = jnp.take_along_axis(foe_conv, cp_sel[:, None], axis=1)[:, 0]
    dfreq = jnp.arctan2(m_sel[:, 1], m_sel[:, 0]) * conv

    # ONE packed (8, B) f32 output: every separate device->host array is
    # its own copy, and the whole result is a few hundred bytes (all the ints are small enough to
    # cross f32 losslessly).
    return jnp.stack([
        n_id_1.astype(f32), cp_sel.astype(f32), ord_sel.astype(f32),
        detected.astype(f32), dfreq.astype(f32),
        lik_final.astype(f32), lik_mean.astype(f32), lik_std.astype(f32),
    ])


# ----------------------------------------------------------------------
# Host wrapper.


@dataclasses.dataclass
class SyncPending:
    """An in-flight deferred sync dispatch (see sss_foe_batch defer)."""

    out: object        # device array, D2H copy already started
    plan: SyncPlan
    cells: List[Cell]


def sss_foe_batch(cells: List[Cell], capbuf, fc_requested: float,
                  fc_programmed: float, fs_programmed: float,
                  thresh2_n_sigma: float, cap_dev=None, n_cap: int = None,
                  cap_bases: Sequence[int] = None, defer: bool = False):
    """Run SSS detection + fine FOE for every candidate peak on device.

    ``cap_dev`` may pass an already-device-resident (n_cap, 2) float32
    capture (re/im planes) to avoid re-uploading; with ``cap_bases`` it
    may hold a whole fc sweep's captures stacked along the sample axis
    (per-capture length ``n_cap``), so every candidate of the sweep runs
    in one dispatch. Returns new Cell records: detected peaks carry
    n_id_1/cp_type/frame_start/freq_fine, rejected ones n_id_1 == -1
    (same contract as ops.sync.sss_detect + pss_sss_foe).

    ``defer=True`` returns a :class:`SyncPending` with the D2H copy
    started asynchronously — a pipelined sweep finishes it with
    :func:`finish_sync_batch` a batch later, so the fetch round trip
    (which gates the MIB planning) overlaps the next batch's upload and
    scan instead of blocking this one.
    """
    if not cells:
        return SyncPending(None, None, []) if defer else []
    if cap_dev is None:
        capbuf = np.asarray(capbuf)
        cap_dev = jnp.asarray(
            np.stack([capbuf.real, capbuf.imag], -1).astype(np.float32))
        n_cap = len(capbuf)
    elif n_cap is None:
        n_cap = cap_dev.shape[0]
    plan = sync_plan(cells, n_cap, fc_requested, fc_programmed,
                     fs_programmed, cap_bases=cap_bases)
    plan_i32, plan_f32 = _pack_sync_plan(plan)
    out = _sync_device_packed(cap_dev, plan_i32, plan_f32,
                              np.float32(thresh2_n_sigma),
                              n_rep=plan.pss_idx.shape[1],
                              n_sss=plan.foe_pss.shape[-1])
    pending = SyncPending(out, plan, list(cells))
    if defer:
        out.copy_to_host_async()
        return pending
    return finish_sync_batch(pending)


def finish_sync_batch(pending: SyncPending) -> List[Cell]:
    """Fetch + unpack a (possibly deferred) sync dispatch."""
    if not pending.cells:
        return []
    plan = pending.plan
    packed = np.asarray(pending.out, dtype=np.float64)  # single D2H fetch
    out = {k: packed[i] for i, k in enumerate(
        ("n_id_1", "cp_sel", "ord_sel", "detected", "dfreq",
         "lik_final", "lik_mean", "lik_std"))}

    res: List[Cell] = []
    for b, cell in enumerate(pending.cells):
        c = dataclasses.replace(cell)
        if out["detected"][b]:
            c.n_id_1 = int(out["n_id_1"][b])
            c.cp_type = "extended" if out["cp_sel"][b] else "normal"
            c.frame_start = float(
                plan.frame_start[b, int(out["ord_sel"][b])])
            c.freq_fine = cell.freq + float(out["dfreq"][b])
        res.append(c)
    return res

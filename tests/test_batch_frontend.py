"""Batched device tracker math vs the host CellTracker, function by
function."""

import numpy as np
import jax.numpy as jnp

from lte_cell_scanner.tracker.batch_frontend import (
    ac_fd_batch,
    bulk_phase_offsets,
    filter_ce_batch,
    foe_stats_batch,
    from_ri,
    get_fd_batch,
    raw_ce_batch,
    sync_meas_batch,
    to_ri,
    toe_stats_batch,
)
from lte_cell_scanner.tracker.cell_tracker import CellTracker, _RawCE
from lte_cell_scanner.tracker.state import (
    GlobalState,
    SymbolPDU,
    TrackedCell,
)

RNG = np.random.default_rng(42)


def _tracker(cp_type="normal", n_ports=2):
    state = GlobalState(fc_requested=739e6, fc_programmed=739e6,
                        fs_programmed=1.92e6, frequency_offset=21e3)
    cell = TrackedCell(n_id_cell=271, n_ports=n_ports, cp_type=cp_type,
                       n_rb_dl=50, phich_duration="normal",
                       phich_resource=1.0, frame_timing=100.0)
    return CellTracker(cell, state), state, cell


def _crand(*shape):
    return (RNG.standard_normal(shape)
            + 1j * RNG.standard_normal(shape)) / np.sqrt(2)


def test_get_fd_parity():
    tr, state, cell = _tracker()
    S = 10
    fo = 21e3
    k_factor = (state.fc_requested - fo) / state.fc_programmed
    pdus = []
    for s in range(S):
        pdus.append(SymbolPDU(
            data=_crand(128), slot_num=0, sym_num=s % 7,
            late=float(RNG.uniform(-1, 1)), frequency_offset=fo,
            frame_timing=100.0))

    host = np.stack([tr._get_fd(p) for p in pdus])

    n_samp = np.array([128 + (10 if p.sym_num == 0 else 9) for p in pdus],
                      dtype=np.float64)
    bpo, carry = bulk_phase_offsets(np.zeros(1),
                                    np.full((1, S), fo), n_samp[None])
    foc_rate = np.full((1, S), -2 * np.pi * fo
                       / (state.fs_programmed * k_factor), np.float32)
    late = np.array([[p.late for p in pdus]], np.float32)
    data = to_ri(np.stack([p.data for p in pdus]))[None]
    dev = from_ri(get_fd_batch(jnp.asarray(data), jnp.asarray(foc_rate),
                               jnp.asarray(bpo.astype(np.float32)),
                               jnp.asarray(late)))[0]
    assert np.abs(dev - host).max() < 2e-5
    # the host accumulates bulk phase across symbols; carry must match
    assert abs(np.mod(carry[0] - tr.bulk_phase_offset + np.pi, 2 * np.pi)
               - np.pi) < 1e-9


def test_raw_ce_parity():
    tr, state, cell = _tracker()
    pdu = SymbolPDU(data=_crand(128), slot_num=0, sym_num=0, late=0.3,
                    frequency_offset=21e3, frame_timing=100.0)
    tr._process_one(pdu)
    # port 0 raw CE captured by the host tracker
    host_rce = tr.ce_raw_fifo[0][0]
    syms = tr.data_fifo[0][2] if tr.data_fifo else None
    if syms is None:  # consumed; recompute
        syms = tr._get_fd(pdu)
    rs = tr.rs_dl.get_rs(0, 0)
    shift = int(tr.rs_dl.get_shift(0, 0, 0))

    dev = from_ri(raw_ce_batch(
        jnp.asarray(to_ri(syms)[None]),
        jnp.asarray(to_ri(np.conj(rs))[None]),
        jnp.asarray(np.array([shift], np.int32))))[0]
    assert np.abs(dev - host_rce.ce).max() < 1e-6


def _host_triple(tr, shifts=(0, 3, 0)):
    """Push a crafted raw-CE triple through the host filter/FOE/TOE and
    capture everything it produces."""
    recorded = {}
    state = tr.state
    cell = tr.cell
    orig_fo = state.update_frequency_offset
    orig_ft = cell.update_frame_timing
    state.update_frequency_offset = (
        lambda est, est_np, prior_np=1e-6: recorded.update(
            foe=(est, est_np)))
    cell.update_frame_timing = (
        lambda d, dnp, ft: recorded.update(toe=(d, dnp)))
    ces = [_crand(12) for _ in range(3)]
    for i, (sh, ce) in enumerate(zip(shifts, ces)):
        tr.ce_raw_fifo[0].append(_RawCE(
            sh, 0, [0, 4, 7][i], ce, 21e3, 100.0 + i * 0.01))
    tr._process_raw_ce(0)
    state.update_frequency_offset = orig_fo
    cell.update_frame_timing = orig_ft
    filt = tr.ce_filt_fifo[0][-1]
    recorded["filt"] = filt
    recorded["ac_fd"] = np.array(tr.cell.ac_fd)
    return ces, recorded


def test_filter_foe_toe_ac_parity():
    for shifts in [(0, 3, 0), (3, 0, 3)]:
        tr, state, cell = _tracker()
        ces, rec = _host_triple(tr, shifts)
        prev_lower = np.array([shifts[0] < shifts[1]])
        args = [jnp.asarray(to_ri(c)[None]) for c in ces]
        ce_filt, np_c, tp_c, sp_c, sp_raw = filter_ce_batch(
            args[0], args[1], args[2], jnp.asarray(prev_lower))
        f = rec["filt"]
        assert np.abs(from_ri(ce_filt)[0] - f.ce_filt).max() < 1e-6
        np.testing.assert_allclose(float(np_c[0]), f.np_, rtol=1e-5)
        np.testing.assert_allclose(float(tp_c[0]), f.tp, rtol=1e-5)
        np.testing.assert_allclose(float(sp_c[0]), f.sp, rtol=1e-5)

        foe_comb, foe_np = foe_stats_batch(args[0], args[2], ce_filt, np_c)
        # Recover the host's residual_f from the device statistic.
        fo = 21e3
        k_factor = (state.fc_requested - fo) / state.fc_programmed
        dt = 0.0005 + (100.02 - 100.0) / (state.fs_programmed * k_factor)
        fc = from_ri(foe_comb)[0]
        residual_f = np.angle(fc) / (2 * np.pi) / dt
        est, est_np = rec["foe"]
        np.testing.assert_allclose(fo + residual_f, est, rtol=1e-6)
        np.testing.assert_allclose(max(float(foe_np[0]) / 2, 0.001), est_np,
                                   rtol=1e-4)

        delay, delay_np = toe_stats_batch(args[0], args[1], sp_c, np_c,
                                          jnp.asarray(prev_lower))
        d_host, dnp_host = rec["toe"]
        np.testing.assert_allclose(float(delay[0]), d_host, atol=1e-5)
        np.testing.assert_allclose(float(delay_np[0]), dnp_host, rtol=1e-4)

        ac, ac_np = ac_fd_batch(args[1], sp_c, np_c)
        # host ac_fd after first update equals ac itself (f32 rounding)
        err = np.abs(from_ri(ac)[0] - rec["ac_fd"]).max()
        assert err < 1e-5 * max(1.0, np.abs(rec["ac_fd"]).max())


def test_sync_meas_parity():
    from lte_cell_scanner.models.pss import pss_fd
    from lte_cell_scanner.models.sss import sss_fd

    tr, state, cell = _tracker()
    n1, n2 = divmod(cell.n_id_cell, 3)
    sss_sym = _crand(72)
    pss_sym = _crand(72)
    tr._sigpower_pss_sss(sss_sym, 0, 5)
    tr._sigpower_pss_sss(pss_sym, 0, 6)

    out = sync_meas_batch(
        jnp.asarray(to_ri(pss_sym)[None]), jnp.asarray(to_ri(sss_sym)[None]),
        jnp.asarray(to_ri(np.conj(pss_fd(n2)))[None]),
        jnp.asarray(sss_fd(n1, n2, 0).astype(np.float32)[None]))
    np.testing.assert_allclose(float(out["tp"][0]), cell.sync_tp, rtol=1e-5)
    np.testing.assert_allclose(float(out["sp"][0]), cell.sync_sp, rtol=1e-4)
    np.testing.assert_allclose(float(out["np"][0]), cell.sync_np, rtol=1e-5)
    np.testing.assert_allclose(float(out["np_blank"][0]),
                               cell.sync_np_blank, rtol=1e-5)
    ce = from_ri(out["ce_smooth"])[0]
    assert np.abs(ce - cell.sync_ce[5:67]).max() < 1e-6

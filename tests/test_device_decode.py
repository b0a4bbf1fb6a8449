"""Device decode chain (ops/sync_jax + ops/mib_jax) vs the float64 host
path: per-stage parity on the reference capture, full backend="jax"
end-to-end, and extended-CP coverage via the simulator.

reference behavior: src/searcher.cpp:533-1692 (sss_detect .. decode_mib).
"""

import dataclasses

import numpy as np
import pytest

from lte_cell_scanner.constants import DS_COMB_ARM, THRESH2_N_SIGMA
from lte_cell_scanner.models.rs import RSDL
from lte_cell_scanner.ops.mib_jax import decode_mib_batch
from lte_cell_scanner.ops.peak import peak_search
from lte_cell_scanner.ops.pbch import decode_mib
from lte_cell_scanner.ops.sync import pss_sss_foe, sss_detect
from lte_cell_scanner.ops.sync_jax import sss_foe_batch
from lte_cell_scanner.ops.tfg import extract_tfg, tfoec
from lte_cell_scanner.ops.xcorr import xcorr_pss
from lte_cell_scanner.search.cell_search import (cell_search,
                                                 detection_threshold)


@pytest.fixture(scope="module")
def real_peaks(capbuf_0000):
    cap, fc = capbuf_0000
    fset = np.arange(-15, 16) * 5e3
    r = xcorr_pss(cap, fset, DS_COMB_ARM, fc, fc, 1.92e6, backend="numpy")
    z = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    peaks = peak_search(r.xc_incoherent_collapsed_pow,
                        r.xc_incoherent_collapsed_frq, z, fset, fc, fc,
                        r.xc_incoherent_single, DS_COMB_ARM)
    assert len(peaks) >= 2
    return cap, fc, peaks


def test_sync_stage_parity(real_peaks):
    """Device SSS detection + fine FOE matches the host chain per peak."""
    cap, fc, peaks = real_peaks
    got = sss_foe_batch(peaks, cap, fc, fc, 1.92e6, THRESH2_N_SIGMA)
    n_detected = 0
    for pk, g in zip(peaks, got):
        h = sss_detect(pk, cap, THRESH2_N_SIGMA, fc, fc, 1.92e6)
        if h.n_id_1 < 0:
            assert g.n_id_1 < 0
            continue
        n_detected += 1
        h = pss_sss_foe(h, cap, fc, fc, 1.92e6)
        assert g.n_id_1 == h.n_id_1
        assert g.cp_type == h.cp_type
        assert abs(g.frame_start - h.frame_start) < 1e-6
        assert abs(g.freq_fine - h.freq_fine) < 0.1
    assert n_detected >= 2


def test_mib_stage_parity(real_peaks):
    """Device TFG/TFOEC/chan_est/MIB matches the host (freq_time interp)."""
    cap, fc, peaks = real_peaks
    synced = sss_foe_batch(peaks, cap, fc, fc, 1.92e6, THRESH2_N_SIGMA)
    alive = [c for c in synced if c.n_id_1 >= 0]
    got = decode_mib_batch(alive, cap, fc, fc, 1.92e6)
    assert len(got) == len(alive)
    for g, c in zip(got, alive):
        h = dataclasses.replace(c)
        tfg, ts = extract_tfg(h, cap, fc, fc, 1.92e6)
        rs_dl = RSDL(h.n_id_cell(), 6, h.cp_type)
        h, tfg_comp, _ = tfoec(h, tfg, ts, fc, fc, rs_dl)
        h = decode_mib(h, tfg_comp, rs_dl, interp="freq_time")
        assert g.n_rb_dl == h.n_rb_dl == 50
        assert g.n_ports == h.n_ports == 2
        assert g.sfn == h.sfn
        assert g.phich_duration == h.phich_duration
        assert g.phich_resource == h.phich_resource
        assert abs(g.freq_superfine - h.freq_superfine) < 0.5


def test_mib_deferred_fetch_identical(real_peaks):
    """decode_mib_batch(defer=True) + finish_mib_batch must equal the
    direct call (the pipelined sweep collects MIB results one batch
    later to overlap the fetch round trip)."""
    from lte_cell_scanner.ops.mib_jax import finish_mib_batch

    cap, fc, peaks = real_peaks
    synced = sss_foe_batch(peaks, cap, fc, fc, 1.92e6, THRESH2_N_SIGMA)
    alive = [c for c in synced if c.n_id_1 >= 0]
    direct = decode_mib_batch(alive, cap, fc, fc, 1.92e6)
    pending = decode_mib_batch(alive, cap, fc, fc, 1.92e6, defer=True)
    deferred = finish_mib_batch(pending)
    assert [dataclasses.asdict(c) for c in deferred] == \
        [dataclasses.asdict(c) for c in direct]
    assert finish_mib_batch(decode_mib_batch(
        [], cap, fc, fc, 1.92e6, defer=True)) == []


def test_hex_interp_tabs_match_host():
    """The device hex-interpolator tables (mib_jax._hex_interp_tabs)
    reproduce the host Delaunay interpolator (chanest.ce_interp_hex,
    reference src/searcher.cpp:1223-1362) EXACTLY at the consumed rows,
    for both CP geometries, both port classes and all 6 shift configs."""
    from lte_cell_scanner.ops.chanest import ce_interp_hex
    from lte_cell_scanner.ops.mib_jax import _hex_interp_tabs

    rng = np.random.default_rng(0)
    for n_symb_dl in (7, 6):
        n_ofdm = (854 if n_symb_dl == 7 else 732)
        n_slot = n_ofdm // n_symb_dl
        stride = 10 * 2 * n_symb_dl
        rows_sel = tuple(f * stride + n_symb_dl + s
                         for f in range(7) for s in range(4))
        rows0 = np.arange(n_slot) * n_symb_dl
        for pc, rs_set in ((0, np.sort(np.concatenate(
                [rows0, rows0 + n_symb_dl - 3]))), (1, rows0 + 1)):
            tabs, pair = _hex_interp_tabs(n_symb_dl, n_ofdm, rows_sel, pc)
            r_n = len(rs_set)
            for m in range(6):
                cf = rng.normal(size=(r_n, 12)) \
                    + 1j * rng.normal(size=(r_n, 12))
                host = ce_interp_hex(
                    cf, np.array([m, (m + 3) % 6]), n_ofdm, rs_set)
                vp = np.concatenate(
                    [cf[pair], cf[np.minimum(pair + 1, r_n - 1)]], axis=1)
                dev = np.einsum("jki,ji->jk", tabs[m], vp)
                np.testing.assert_allclose(
                    dev, host[list(rows_sel)], rtol=0, atol=1e-12)


def test_mib_hex_interp_device(real_peaks):
    """decode_mib_batch(interp="hex") — the reference's ENABLED
    interpolator on device — decodes the same cells as the host hex
    path (ops/pbch.decode_mib default) on the reference capture."""
    cap, fc, peaks = real_peaks
    synced = sss_foe_batch(peaks, cap, fc, fc, 1.92e6, THRESH2_N_SIGMA)
    alive = [c for c in synced if c.n_id_1 >= 0]
    got = decode_mib_batch(alive, cap, fc, fc, 1.92e6, interp="hex")
    assert len(got) == len(alive)
    for g, c in zip(got, alive):
        h = dataclasses.replace(c)
        tfg, ts = extract_tfg(h, cap, fc, fc, 1.92e6)
        rs_dl = RSDL(h.n_id_cell(), 6, h.cp_type)
        h, tfg_comp, _ = tfoec(h, tfg, ts, fc, fc, rs_dl)
        h = decode_mib(h, tfg_comp, rs_dl, interp="hex")
        assert g.n_rb_dl == h.n_rb_dl == 50
        assert g.n_ports == h.n_ports == 2
        assert g.sfn == h.sfn
        assert g.phich_duration == h.phich_duration
        assert g.phich_resource == h.phich_resource
        assert abs(g.freq_superfine - h.freq_superfine) < 0.5


def test_mib_plan_link_compression(real_peaks):
    """The link-compressed MibPlan round-trips: the u8 deltas rebuild
    the host's f64-rounded integer starts EXACTLY, the i16 fixed-point
    lateness/phase stay within half an LSB of the host f64 values, and
    the device-resident 504-cell tables match the per-cell host tables
    row for row."""
    from lte_cell_scanner.ops.mib_jax import (_all_cell_tables,
                                              _cell_tables, mib_plan)
    from lte_cell_scanner.ops.tfg import symbol_timestamps

    cap, fc, peaks = real_peaks
    synced = sss_foe_batch(peaks, cap, fc, fc, 1.92e6, THRESH2_N_SIGMA)
    alive = [c for c in synced if c.n_id_1 >= 0]
    assert alive
    plan = mib_plan(alive, len(cap), fc, fc, 1.92e6)
    for b, c in enumerate(alive):
        assert plan.ok[b]
        k_factor = (c.fc_requested - c.freq_fine) / c.fc_programmed
        ts = symbol_timestamps(c, c.fs_programmed, k_factor)
        starts_host = np.round(ts).astype(np.int64)
        rebuilt = plan.start0[b] + np.cumsum(
            plan.sdelta[b].astype(np.int64))
        assert (rebuilt == starts_host).all()
        late = starts_host - ts
        assert np.abs(plan.late_q[b] / 32768.0 - late).max() \
            <= 0.5001 / 32768
        fs_eff = c.fs_programmed * k_factor
        phase = np.mod(-2.0 * np.pi * c.freq_fine * starts_host / fs_eff,
                       2.0 * np.pi)
        dq = plan.phase0_q[b] * (2.0 * np.pi / 65536.0)
        err = np.abs(np.mod(dq - phase + np.pi, 2.0 * np.pi) - np.pi)
        assert err.max() <= (np.pi / 65536) * 1.001
        nid = c.n_id_cell()
        assert plan.n_id[b] == nid
        rs_tab, sh_tab, scr_tab = _all_cell_tables(c.cp_type)
        rs_one, sh_one, scr_one = _cell_tables(nid, c.cp_type)
        assert (rs_tab[nid] == np.sign(rs_one)).all()
        assert (sh_tab[nid] == sh_one).all()
        assert (scr_tab[nid] == scr_one).all()


def test_mib_plan_link_compression_extended_cp():
    """Extended-CP geometry (160-sample symbol stride) also round-trips
    the u8 delta encoding, across a spread of crystal errors and frame
    phases (synthetic cells — the encoder only needs the timing
    fields)."""
    from lte_cell_scanner.models.cell import Cell
    from lte_cell_scanner.ops.mib_jax import mib_plan
    from lte_cell_scanner.ops.tfg import symbol_timestamps

    cells = [Cell(fc_requested=739e6, fc_programmed=739e6,
                  fs_programmed=1.92e6, n_id_2=i % 3, n_id_1=40 * i,
                  cp_type="extended", frame_start=100.25 + 7.3 * i,
                  freq_fine=(-1) ** i * 7.5e3 * (i + 1))
             for i in range(4)]
    plan = mib_plan(cells, 200000, 739e6, 739e6, 1.92e6)
    for b, c in enumerate(cells):
        assert plan.ok[b]
        k_factor = (c.fc_requested - c.freq_fine) / c.fc_programmed
        ts = symbol_timestamps(c, c.fs_programmed, k_factor)
        starts_host = np.round(ts).astype(np.int64)
        rebuilt = plan.start0[b] + np.cumsum(
            plan.sdelta[b].astype(np.int64))
        assert (rebuilt == starts_host).all()
        assert np.abs(plan.late_q[b] / 32768.0
                      - (starts_host - ts)).max() <= 0.5001 / 32768


def test_e2e_device_backend(capbuf_0000):
    """cell_search(backend='jax') runs the whole per-peak chain on the
    device path and finds cells 277 + 271 with correct MIBs."""
    cap, fc = capbuf_0000
    fset = np.arange(-15, 16) * 5e3
    dev = cell_search(cap, fc, f_search_set=fset, backend="jax")
    host = cell_search(cap, fc, f_search_set=fset, backend="numpy",
                       interp="freq_time")
    assert {c.n_id_cell() for c in dev} == {277, 271}
    hmap = {c.n_id_cell(): c for c in host}
    for c in dev:
        h = hmap[c.n_id_cell()]
        assert (c.n_rb_dl, c.n_ports, c.sfn, c.cp_type) == \
            (h.n_rb_dl, h.n_ports, h.sfn, h.cp_type)
        assert abs(c.freq_superfine - h.freq_superfine) < 0.5


def test_device_decode_extended_cp():
    """Extended-CP geometry (732-symbol grid, 1728-bit PBCH) decodes on
    the device path."""
    from lte_cell_scanner.io.simulator import synthetic_capture

    cap = synthetic_capture(n_id_1=30, n_id_2=2, cp_type="extended",
                            snr_db=20.0, freq_offset=2e3, n_rb_dl=25,
                            seed=3)
    cells = cell_search(cap, 739e6, f_search_set=np.arange(-2, 3) * 5e3,
                        backend="jax")
    assert len(cells) == 1
    assert cells[0].n_id_cell() == 3 * 30 + 2
    assert cells[0].cp_type == "extended"
    assert cells[0].n_rb_dl == 25


def test_aligned_wins_blend_identity():
    """_aligned_wins: DFT(true window) == e^{2πi b k/128} DFT(blend) for
    arbitrary offsets, and the j index recovers per-sample positions —
    including first/last/row-straddling windows."""
    import jax.numpy as jnp

    from lte_cell_scanner.ops.sync_jax import _aligned_wins

    rng = np.random.default_rng(0)
    n = 128 * 40
    cap = rng.standard_normal((n, 2)).astype(np.float32)
    idx = np.array([0, 1, 127, 128, 129, 255, n - 256, n - 129, n - 128,
                    517, 1000, 4095], np.int32)
    g, j, b = (np.asarray(a) for a in
               _aligned_wins(jnp.asarray(cap), jnp.asarray(idx)))
    k = np.arange(128)
    for i, off in enumerate(idx):
        w = cap[off:off + 128, 0] + 1j * cap[off:off + 128, 1]
        gb = g[i, :, 0] + 1j * g[i, :, 1]
        lhs = np.fft.fft(w)
        rhs = np.exp(2j * np.pi * (off % 128) * k / 128) * np.fft.fft(gb)
        assert np.abs(lhs - rhs).max() < 1e-4 * (np.abs(lhs).max() + 1)
        assert b[i] == off % 128
        # j holds each lane's original in-window sample index.
        lane = np.arange(128)
        assert (j[i].astype(int) == (lane - off % 128) % 128).all()


def test_device_sync_long_capture_uses_all_reps():
    """Captures longer than 80 ms grow the device plan's repetition axis
    (the host path combines EVERY repetition; a fixed 16-slot table
    would silently truncate and break backend parity)."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.ops.sync_jax import _n_rep_for, sync_plan
    from lte_cell_scanner.ops.xcorr import xcorr_pss

    cap = synthetic_capture(n_id_1=12, n_id_2=1, snr_db=10.0,
                            freq_offset=4e3, n_subframes=120, seed=2)
    assert len(cap) > 153600
    assert _n_rep_for(len(cap)) >= -(-len(cap) // 9600)

    fset = np.arange(-2, 3) * 5e3
    r = xcorr_pss(cap, fset, DS_COMB_ARM, 739e6, 739e6, 1.92e6,
                  backend="numpy")
    z = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    peaks = peak_search(r.xc_incoherent_collapsed_pow,
                        r.xc_incoherent_collapsed_frq, z, fset, 739e6,
                        739e6, r.xc_incoherent_single, DS_COMB_ARM)
    assert peaks
    plan = sync_plan(peaks, len(cap), 739e6, 739e6, 1.92e6)
    # The plan actually uses repetitions beyond the 80 ms table size.
    assert plan.rep_mask.shape[1] > 16
    assert plan.rep_mask[0, 16:].sum() > 0

    got = sss_foe_batch(peaks, cap, 739e6, 739e6, 1.92e6,
                        THRESH2_N_SIGMA)
    want = [sss_detect(dataclasses.replace(p), cap, THRESH2_N_SIGMA,
                       739e6, 739e6, 1.92e6) for p in peaks]
    want = [pss_sss_foe(w, cap, 739e6, 739e6, 1.92e6)
            if w.n_id_1 >= 0 else w for w in want]
    for g, w in zip(got, want):
        assert g.n_id_1 == w.n_id_1
        if w.n_id_1 >= 0:
            assert g.cp_type == w.cp_type
            assert abs(g.frame_start - w.frame_start) < 1e-6
            assert abs(g.freq_fine - w.freq_fine) < 1.0


def test_device_full_tfg_matches_host(real_peaks):
    """Device-batched FULL-grid extract_tfg (mib_jax.extract_tfg_batch,
    every row of the reference's 6-frame+2-slot grid,
    src/searcher.cpp:852-935) matches the f64 host path (ops/tfg.py) to
    f32 + i16-phase-quantization tolerance — closing the compact-grid
    divergence for device consumers beyond the MIB chain."""
    from lte_cell_scanner.ops.mib_jax import extract_tfg_batch
    from lte_cell_scanner.ops.tfg import extract_tfg

    cap, fc, peaks = real_peaks
    synced = sss_foe_batch(peaks, cap, fc, fc, 1.92e6, THRESH2_N_SIGMA)
    alive = [c for c in synced if c.n_id_1 >= 0]
    assert len(alive) >= 2
    tfg_d, ts_d, ok = extract_tfg_batch(alive, cap, fc, fc, 1.92e6)
    assert ok.all()
    assert tfg_d.shape[1] == 854              # normal CP full grid
    for b, c in enumerate(alive):
        tfg_h, ts_h = extract_tfg(c, cap, fc, fc, 1.92e6)
        assert tfg_d.shape[1:] == tfg_h.shape
        np.testing.assert_allclose(ts_d[b], ts_h, rtol=0, atol=1e-9)
        scale = np.abs(tfg_h).max()
        np.testing.assert_allclose(tfg_d[b], tfg_h, rtol=0,
                                   atol=2e-3 * scale)

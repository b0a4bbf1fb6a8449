"""Batched device tracker engine: end-to-end and vs the host tracker."""

import numpy as np
import pytest

from lte_cell_scanner.io.simulator import synthetic_capture
from lte_cell_scanner.tracker import LTETracker
from lte_cell_scanner.tracker.runtime import playback_source


@pytest.fixture(scope="module")
def sim_signal():
    return synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                             freq_offset=4e3, n_subframes=400,
                             sfn_start=0, seed=5)


def test_batch_engine_tracks_and_decodes(sim_signal):
    trk = LTETracker(739e6, initial_freq_offset=4000.0, batch=True)
    trk.run(playback_source(sim_signal), max_blocks=400)
    st = trk.status()
    assert len(st["cells"]) == 1
    c = st["cells"][0]
    assert c["n_id_cell"] == 271
    assert c["health"] == 1.0
    assert c["mib_successes"] > 10
    assert abs(st["frequency_offset"] - 4000) < 20
    assert 12 < c["sync_snr_db"] < 24


def test_batch_engine_matches_host_tracker(sim_signal):
    """Both data planes, identical input: same lock state and closely
    matching tracking loops (f32 device vs f64 host)."""
    host = LTETracker(739e6, initial_freq_offset=4000.0)
    dev = LTETracker(739e6, initial_freq_offset=4000.0, batch=True)
    host.run(playback_source(sim_signal), max_blocks=300)
    dev.run(playback_source(sim_signal), max_blocks=300)
    hs, ds = host.status(), dev.status()
    assert len(hs["cells"]) == len(ds["cells"]) == 1
    hc, dc = hs["cells"][0], ds["cells"][0]
    assert hc["n_id_cell"] == dc["n_id_cell"]
    assert hc["mib_successes"] == dc["mib_successes"]
    assert abs(hs["frequency_offset"] - ds["frequency_offset"]) < 2.0
    assert abs(hc["frame_timing"] - dc["frame_timing"]) < 0.1
    # Measurements agree
    h, d = host.cells[0], dev.cells[0]
    np.testing.assert_allclose(d.sync_sp_av, h.sync_sp_av, rtol=0.05)
    np.testing.assert_allclose(d.sync_np_av, h.sync_np_av, rtol=0.05)
    np.testing.assert_allclose(d.crs_tp_av, h.crs_tp_av, rtol=0.05)


def test_batch_engine_ac_diagnostics_match_host(sim_signal):
    """Pin the engine's cycle-granular AC diagnostics against the host
    tracker's per-RS-symbol IIR (reference accumulates do_ac_fd/do_ac_td
    per RS symbol, src/tracker_thread.cpp:318-370; the engine folds each
    cycle's inverse-variance weight sums into the same IIR once per
    cycle and correlates the last 72 consecutive raw-CE rows on device
    — batch_runtime.py scope notes). Bounds the documented divergence:
    ac_fd equals the host chain to first order in sum(w)/1e5, ac_td to
    the estimator noise of the skipped 1e-5-weight updates."""
    host = LTETracker(739e6, initial_freq_offset=4000.0)
    dev = LTETracker(739e6, initial_freq_offset=4000.0, batch=True)
    host.run(playback_source(sim_signal), max_blocks=300)
    dev.run(playback_source(sim_signal), max_blocks=300)
    h, d = host.cells[0], dev.cells[0]
    assert h.ac_fd is not None and d.ac_fd is not None
    assert h.ac_td is not None and d.ac_td is not None
    scale_fd = np.abs(h.ac_fd[0])           # lag-0 autocorr ~ 1
    assert abs(scale_fd - 1.0) < 0.25
    assert np.abs(h.ac_fd - d.ac_fd).max() < 0.05 * scale_fd
    scale_td = np.abs(h.ac_td[0])
    assert abs(scale_td - 1.0) < 0.25
    # The w0 = 1e5 IIR is dominated by the FIRST 72-row snapshot, which
    # the engine plans to end at exactly the host's 72nd row — so the
    # full complex profile must agree; the residual is the engine's
    # once-per-cycle (vs per-RS-row) cadence of the ~1e-5-weight
    # follow-up nudges plus the f16 fetch (measured 0.02).
    assert np.abs(h.ac_td - d.ac_td).max() < 0.05 * scale_td


def test_batch_engine_drop_and_reacquire(sim_signal):
    events = []
    trk = LTETracker(739e6, initial_freq_offset=4000.0, batch=True,
                     on_event=lambda k, i: events.append(k),
                     drop_threshold=4)
    trk.run(playback_source(sim_signal), max_blocks=250)
    assert "cell_acquired" in events
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(len(sim_signal))
             + 1j * rng.standard_normal(len(sim_signal))) * 0.3
    trk.run(playback_source(noise), max_blocks=1200)
    assert "cell_dropped" in events
    trk.run(playback_source(sim_signal), max_blocks=600)
    assert events.count("cell_acquired") >= 2
    assert trk.cells and trk.cells[0].n_id_cell == 271


def test_batch_engine_extended_cp():
    sig = synthetic_capture(n_id_1=44, n_id_2=2, cp_type="extended",
                            snr_db=15, freq_offset=-3e3, n_subframes=400,
                            sfn_start=4, seed=9)
    trk = LTETracker(739e6, initial_freq_offset=-3000.0, batch=True)
    trk.run(playback_source(sig), max_blocks=400)
    st = trk.status()
    assert len(st["cells"]) == 1
    c = st["cells"][0]
    assert c["n_id_cell"] == 44 * 3 + 2
    assert c["cp_type"] == "extended"
    assert c["mib_successes"] > 5
    assert c["health"] == 1.0


def test_batch_engine_two_cells_coarse_cadence():
    """Two superposed cells, engine dispatch every 10 blocks (52 ms)."""
    a = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=None,
                          freq_offset=4e3, n_subframes=400, seed=5)
    b = synthetic_capture(n_id_1=20, n_id_2=0, snr_db=None,
                          freq_offset=4.3e3, n_subframes=400, seed=6)
    sig = a + 0.7 * np.roll(b, 3121)
    sig += (np.random.default_rng(1).standard_normal(len(sig))
            + 1j * np.random.default_rng(2).standard_normal(len(sig))) * 0.1
    trk = LTETracker(739e6, initial_freq_offset=4000.0, batch=True,
                     engine_every=10)
    trk.run(playback_source(sig), max_blocks=1500)
    st = trk.status()
    ids = sorted(c["n_id_cell"] for c in st["cells"])
    assert ids == [60, 271]
    for c in st["cells"]:
        assert c["mib_successes"] > 3
        assert c["health"] == 1.0


def test_pack_f32_lossless_roundtrip():
    """Feedback-critical FOE/TOE statistics travel losslessly through the
    f16-packed fetch (at very high SNR their estimator noise sits below
    f16's ~1e-3 floor)."""
    import jax.numpy as jnp

    from lte_cell_scanner.tracker.batch_runtime import _pack, _unpack

    # Values an f16 cannot represent: sub-1e-3 relative structure.
    delay = np.array([1.0001234, -0.0123456, 3.1415927], np.float64)
    bulk = np.array([[1.0, 2.0], [3.0, 4.0]], np.float64)
    flat = _pack(jnp.asarray(bulk), ("f32", jnp.asarray(delay)))
    b2, d2 = _unpack(flat, [(2, 2), ("f32", (3,))])
    np.testing.assert_array_equal(d2, delay.astype(np.float32))
    assert np.abs(d2 - delay).max() < 1e-6      # far below the f16 floor
    assert np.abs(b2 - bulk).max() < 1e-2


def test_batch_engine_high_snr_timing_precision():
    """Noise-free capture: the batch engine's frame-timing estimate must
    track the host tracker to well below the f16 quantization floor
    (delay stats travel in f32)."""
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=None,
                            freq_offset=4e3, n_subframes=300,
                            sfn_start=0, seed=11)
    host = LTETracker(739e6, initial_freq_offset=4000.0)
    dev = LTETracker(739e6, initial_freq_offset=4000.0, batch=True)
    host.run(playback_source(sig), max_blocks=280)
    dev.run(playback_source(sig), max_blocks=280)
    hc = host.status()["cells"]
    dc = dev.status()["cells"]
    assert len(hc) == len(dc) == 1
    assert abs(hc[0]["frame_timing"] - dc[0]["frame_timing"]) < 5e-3
    assert abs(host.status()["frequency_offset"]
               - dev.status()["frequency_offset"]) < 0.05


def test_ce_observer_matches_host_at_nonconsumed_symbols(sim_signal):
    """Per-symbol interpolated CE beyond the consuming sync/PBCH set:
    the reference computes it for EVERY OFDM symbol
    (src/tracker_thread.cpp:372-477); the engine only at consumers —
    the ce_observer API makes arbitrary symbols consumers. Pin both
    planes' estimates at slot-4 symbols (nothing else consumes them)
    against each other: same bracketing lerp, f32 device rows vs the
    f64 host chain."""
    want = (4, 0)                      # (slot, sym) nothing consumes

    def tap(store):
        return (lambda slot, sym: (slot, sym) == want,
                lambda nid, slot, sym, ce, sp, np_: store.append(
                    (nid, ce, sp, np_)))

    got_h, got_d = [], []
    host = LTETracker(739e6, initial_freq_offset=4000.0,
                      ce_observer=tap(got_h))
    dev = LTETracker(739e6, initial_freq_offset=4000.0, batch=True,
                     ce_observer=tap(got_d))
    host.run(playback_source(sim_signal), max_blocks=300)
    dev.run(playback_source(sim_signal), max_blocks=300)
    assert len(got_h) > 20 and len(got_d) > 20
    assert {g[0] for g in got_h} == {g[0] for g in got_d} == {271}
    # Align on the common tail (the planes' interpolation warm-ups
    # differ by a few symbols at the start of tracking).
    n = min(len(got_h), len(got_d)) - 2
    for (hn, hce, hsp, hnp), (dn, dce, dsp, dnp) in zip(
            got_h[-n:], got_d[-n:]):
        assert hce.shape == dce.shape and hce.shape[1] == 72
        scale = np.abs(hce).max()
        np.testing.assert_allclose(dce, hce, atol=2e-2 * scale)
        np.testing.assert_allclose(dsp, hsp, rtol=0.05)
        np.testing.assert_allclose(dnp, hnp, rtol=0.05, atol=1e-4)

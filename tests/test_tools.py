"""Dev tools: rtl_sdr_check (dropped-sample detector) + debug dump."""

import numpy as np

from lte_cell_scanner.io.simulator import synthetic_capture
from lte_cell_scanner.tools.rtl_sdr_check import check_capture


def test_clean_capture_no_drops():
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=0.0, n_subframes=200, seed=2)
    events, lags = check_capture(sig, n_id_2=1)
    assert np.isfinite(lags).sum() > 30
    assert events == []


def test_detects_dropped_samples():
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=0.0, n_subframes=200, seed=2)
    # Drop 37 samples mid-capture.
    cut = 180000
    damaged = np.concatenate([sig[:cut], sig[cut + 37:]])
    events, _ = check_capture(damaged, n_id_2=1)
    assert len(events) >= 1
    assert any(abs(e.jump - 37) < 3 for e in events)
    assert abs(events[0].position - cut) < 2 * 9600


def test_detects_inserted_samples():
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=0.0, n_subframes=200, seed=2)
    cut = 150000
    damaged = np.concatenate([sig[:cut], np.zeros(20, dtype=complex),
                              sig[cut:]])
    events, _ = check_capture(damaged, n_id_2=1)
    assert any(abs(e.jump + 20) < 3 for e in events)


def test_debug_dump_roundtrip(tmp_path):
    from lte_cell_scanner.io.itfile import load_it
    from lte_cell_scanner.utils import debug_dump

    debug_dump.clear()
    debug_dump.dump("x", np.arange(5.0))
    debug_dump.dump("c", np.array([1 + 2j, 3 - 4j]))
    p = str(tmp_path / "dbg.it")
    debug_dump.flush(p)
    back = load_it(p)
    np.testing.assert_array_equal(back["x"], np.arange(5.0))
    np.testing.assert_array_equal(back["c"], np.array([1 + 2j, 3 - 4j]))


def test_noise_bias_closed_form_matches_mc():
    from lte_cell_scanner.tools.noise_bias import (
        monte_carlo_factor, residual_noise_factor, smoothed_noise_factor)

    res = residual_noise_factor()
    kept = smoothed_noise_factor()
    mc_res, mc_kept = monte_carlo_factor(trials=4000, seed=3)
    # 13-tap mean keeps ~1/13 of the noise; residual carries the rest.
    assert abs(kept - 1 / 13) < 0.02
    assert abs(res + kept - 1) < 0.25  # not exact: F is not a projection
    assert abs(res - mc_res) < 0.05
    assert abs(kept - mc_kept) < 0.02


def test_pss_ambiguity_shapes_and_peaks():
    from lte_cell_scanner.tools.pss_ambiguity import (
        freq_ambiguity, time_ambiguity)

    f = np.linspace(-30e3, 30e3, 61)
    amb = freq_ambiguity(f)
    assert amb.shape == (3, 3, 61)
    mid = 30
    for t in range(3):
        # matched pair peaks at zero offset, normalized to 1
        np.testing.assert_allclose(amb[t, t, mid], 1.0, atol=1e-9)
        assert amb[t, t, mid] >= amb[t, t].max() - 1e-12
        # cross-PSS correlation well below the matched peak at f=0
        for r in range(3):
            if r != t:
                assert amb[t, r, mid] < 0.5
    # 5 kHz/2 grid mismatch costs < 3 dB (design basis of the 5 kHz grid)
    loss = freq_ambiguity(np.array([2.5e3]))[0, 0, 0]
    assert loss > 0.5

    ta = time_ambiguity(np.arange(-8, 9))
    assert ta.shape == (3, 17)
    np.testing.assert_allclose(ta[:, 8], 1.0, atol=1e-9)


def test_mc_search_harness_clean_trials():
    from lte_cell_scanner.tools.mc_search import run_mc

    stats = run_mc(trials=2, snr_db=15.0, backend="numpy", seed=7,
                   ppm=5.0, verbose=0)
    assert stats.trials == 2
    assert stats.detections == 2
    assert stats.mib_successes == 2
    assert stats.false_cells == 0
    assert max(stats.freq_errs) < 50.0


def test_sss_td_contract():
    from lte_cell_scanner.models.sss import sss_fd, sss_td
    from lte_cell_scanner.utils.dsp import dft

    td = sss_td(23, 1, 10)
    assert td.shape == (137,)
    # 9-sample cyclic prefix
    np.testing.assert_allclose(td[:9], td[128:])
    # IDFT grid round-trips to the frequency-domain sequence
    fd = dft(td[9:]) / np.sqrt(128.0 / 62.0)
    got = np.concatenate([fd[97:128], fd[1:32]])
    np.testing.assert_allclose(got, sss_fd(23, 1, 10), atol=1e-12)


def test_stage_timer_report():
    import time

    from lte_cell_scanner.utils.profiling import StageTimer

    timer = StageTimer()
    with timer("scan", items=1000):
        time.sleep(0.01)
    with timer("scan", items=1000):
        pass
    with timer("peaks"):
        pass
    rep = timer.report(unit="samples")
    assert "scan" in rep and "peaks" in rep and "samples/s" in rep
    assert timer.stages["scan"].calls == 2
    assert timer.stages["scan"].items == 2000
    assert timer.stages["scan"].seconds >= 0.01

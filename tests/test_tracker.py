"""Tracker runtime tests: acquisition, tracking loops, drop-and-reacquire.

The dongle is mocked at the byte-FIFO level exactly like the reference
(src/LTE-Tracker.cpp:833-866): synthesized captures are re-quantized to
uint8 and pushed through the same path as live USB data.
"""

import itertools

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


def test_kalibrate_and_track(sim_signal):
    events = []
    trk = LTETracker(739e6, on_event=lambda k, i: events.append((k, i)))
    fo = trk.kalibrate(playback_source(sim_signal), ppm=10)
    assert abs(fo - 4000) < 20

    trk.run(playback_source(sim_signal), max_blocks=400)
    st = trk.status()
    assert [k for k, _ in events][:2] == ["kalibrate", "cell_acquired"]
    assert len(st["cells"]) == 1
    c = st["cells"][0]
    assert c["n_id_cell"] == 271
    assert c["n_rb_dl"] == 50
    assert c["health"] == 1.0
    assert c["mib_successes"] > 10
    # The FOE loop keeps the global FO locked to the true offset.
    assert abs(st["frequency_offset"] - 4000) < 20
    # SNR measurement in the right ballpark (15 dB signal).
    assert 12 < c["sync_snr_db"] < 24


def test_kalibrate_correction_centers_grid():
    """A pre-calibrated crystal whose true offset exceeds the ppm window
    is only acquired when the CellSearch correction factor re-centers the
    hypothesis grid (reference: src/LTE-Tracker.cpp:586)."""
    fc = 739e6
    true_off = 22.2e3     # ~30 ppm crystal
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=true_off, n_subframes=170, seed=7)
    # correction as printed by CellSearch: fc / (fc - freq_superfine)
    correction = fc / (fc - true_off)

    trk = LTETracker(fc)
    # ppm=10 -> grid is +-5 kHz: way short of 22 kHz without correction.
    with pytest.raises(RuntimeError):
        trk.kalibrate(playback_source(sig), ppm=10, max_blocks=17)
    fo = trk.kalibrate(playback_source(sig), ppm=10,
                       correction=correction)
    assert abs(fo - true_off) < 30


def test_tracker_noiseless_input_finite():
    """Noiseless input (np estimate == 0) must not NaN the FOE/AC blends
    (the host path mirrors the batch engine's non-finite guards)."""
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=None,
                            freq_offset=4e3, n_subframes=250, seed=3)
    trk = LTETracker(739e6, initial_freq_offset=4000.0)
    with np.errstate(invalid="raise", divide="raise"):
        trk.run(playback_source(sig, noise_power=None), max_blocks=250)
    assert trk.cells, "cell was not acquired on the clean signal"
    st = trk.status()
    assert np.isfinite(st["frequency_offset"])
    assert abs(st["frequency_offset"] - 4000) < 30
    cell = trk.cells[0]
    if cell.ac_fd is not None:
        assert np.all(np.isfinite(cell.ac_fd))


def test_frame_timing_stability(sim_signal):
    """Frame timing must not drift while tracking a clean loop."""
    trk = LTETracker(739e6, initial_freq_offset=4000.0)
    trk.run(playback_source(sim_signal), max_blocks=250)
    assert trk.cells, "cell was not acquired"
    ft1 = trk.cells[0].frame_timing
    trk.run(playback_source(sim_signal, seed=2), max_blocks=150)
    ft2 = trk.cells[0].frame_timing
    assert abs((ft2 - ft1 + 9600) % 19200 - 9600) < 1.0


def test_drop_and_reacquire(sim_signal):
    """Losing the signal drops the cell; its return re-acquires it."""
    events = []
    trk = LTETracker(739e6, initial_freq_offset=4000.0,
                     on_event=lambda k, i: events.append(k),
                     drop_threshold=4)
    trk.run(playback_source(sim_signal), max_blocks=250)
    assert [e for e in events if e == "cell_acquired"]

    # Signal replaced by pure noise: MIB decodes fail, health decays, the
    # cell is dropped and reaped.
    rng = np.random.default_rng(0)
    noise = (rng.standard_normal(len(sim_signal))
             + 1j * rng.standard_normal(len(sim_signal))) * 0.3
    trk.run(playback_source(noise), max_blocks=1200)
    assert "cell_dropped" in events
    assert not trk.cells

    # Signal returns: the searcher re-acquires the same cell.
    trk.run(playback_source(sim_signal), max_blocks=600)
    assert events.count("cell_acquired") >= 2
    assert trk.cells and trk.cells[0].n_id_cell == 271


def test_overload_drops_seconds(sim_signal):
    """A tracker that cannot keep up dumps whole seconds of symbols."""
    trk = LTETracker(739e6, initial_freq_offset=4000.0)
    trk.run(playback_source(sim_signal), max_blocks=250)
    assert trk.cells
    cell = trk.cells[0]
    tracker = trk.trackers[cell.n_id_cell]
    # Simulate a backlog: stuff the fifo beyond 1.5 s of symbols.
    pdu = cell.fifo[-1] if cell.fifo else None
    if pdu is None:
        from lte_cell_scanner.tracker.state import SymbolPDU

        pdu = SymbolPDU(np.zeros(128, dtype=complex), 0, 0, 0.0,
                        4000.0, cell.frame_timing)
    n_1s = cell.n_symb_dl * 2 * 1000
    for _ in range(int(n_1s * 1.6)):
        cell.fifo.append(pdu)
    before = trk.state.cell_seconds_dropped
    tracker.process_available()
    assert trk.state.cell_seconds_dropped > before


def test_debug_globals_flags():
    """The reference's hidden --g1..--g9 scratch globals
    (src/LTE-Tracker.cpp:52-60): parsed, landed in GlobalState.debug_g,
    surfaced in the expert status view."""
    from lte_cell_scanner.tracker.cli import build_parser
    from lte_cell_scanner.tracker.display import render_status

    args = build_parser().parse_args(
        ["-f", "739e6", "--simulate", "--g2", "1.5", "--g9", "-3"])
    g = tuple(getattr(args, f"g{i}") for i in range(1, 10))
    assert g == (0.0, 1.5, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, -3.0)
    trk = LTETracker(739e6)
    trk.state.debug_g = g
    out = render_status(trk.status(), expert=True)
    assert "g2=1.5" in out and "g9=-3" in out
    assert "g1=" not in out                    # zeros stay hidden


def test_curses_display_renderer(sim_signal):
    """The interactive UI renderer is a pure function of tracker state."""
    from lte_cell_scanner.tracker.curses_display import (
        UIState, VIEWS, handle_key, render_frame)

    trk = LTETracker(739e6, initial_freq_offset=4000.0)
    trk.run(playback_source(sim_signal), max_blocks=300)
    assert trk.cells

    ui = UIState()
    for v in range(len(VIEWS)):
        ui.view = v
        frame = render_frame(trk, ui)
        assert any("271" in ln for ln in frame)
        assert len(frame) >= 4
    # detail views render scaled plot_trace frames once measurements
    # exist (reference ranges: CE magnitude -50..0 dB with y-axis tick
    # labels and an x axis, src/display_thread.cpp:597-660).
    ui.view = VIEWS.index("ce_mag")
    frame = "\n".join(render_frame(trk, ui))
    assert "|CE|^2 dB" in frame
    assert " -50+" in frame and " -10+" in frame   # y tick labels
    assert "+--" in frame                          # x axis with ticks
    ui.view = VIEWS.index("ce_phase")
    frame = "\n".join(render_frame(trk, ui))
    assert "CE phase (deg)" in frame
    assert "*" in frame.split("+--")[-1] or "*" in frame  # supermark/trace
    ui.view = VIEWS.index("sync")
    frame = "\n".join(render_frame(trk, ui))
    assert "sync channel" in frame

    # keyboard loop
    ui = UIState()
    handle_key(ui, "l", 1)
    assert ui.view == 1
    handle_key(ui, "h", 1)
    handle_key(ui, "h", 1)
    assert ui.view == len(VIEWS) - 1
    handle_key(ui, "+", 1)
    assert ui.refresh_hz == 2.0
    handle_key(ui, "e", 1)
    assert ui.expert
    handle_key(ui, "?", 1)
    frame = "\n".join(render_frame(trk, ui))
    assert "keys:" in frame


def test_plot_trace_degenerate_range():
    """A length-1 trace (x_max == x_min, e.g. the curses ac_td view's
    (n-1)*0.0005 upper bound at n=1) must render, not divide by zero
    (display.py x_scale/y_scale guards)."""
    from lte_cell_scanner.tracker.display import plot_trace

    out = plot_trace([0.5], x_min=0.0, x_max=0.0, x_tick=1.0,
                     y_min=0.0, y_max=1.0, y_tick=0.5)
    assert "*" in out
    # Degenerate y range too (flat trace with y_max == y_min).
    out = plot_trace([1.0, 1.0], x_min=0.0, x_max=1.0, x_tick=0.5,
                     y_min=1.0, y_max=1.0, y_tick=1.0)
    assert isinstance(out, str) and out

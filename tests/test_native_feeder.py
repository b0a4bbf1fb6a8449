"""Native (C++) feeder equivalence against the Python reference feeder."""

import shutil

import numpy as np
import pytest

from lte_cell_scanner.io.raw import iq_to_bytes
from lte_cell_scanner.tracker.producer import SampleFeeder
from lte_cell_scanner.tracker.state import GlobalState, TrackedCell

pytestmark = pytest.mark.skipif(shutil.which("make") is None,
                                reason="no native toolchain")


def _mk_state(fo=4000.0):
    return GlobalState(fc_requested=739e6, fc_programmed=739e6,
                       fs_programmed=1.92e6, frequency_offset=fo)


def _mk_cell():
    return TrackedCell(n_id_cell=271, n_ports=1, cp_type="normal",
                       n_rb_dl=50, phich_duration="normal",
                       phich_resource=1.0, frame_timing=1234.5)


def test_native_matches_python():
    from lte_cell_scanner.tracker.native_feeder import NativeSampleFeeder

    rng = np.random.default_rng(0)
    sig = (rng.standard_normal(200000) + 1j * rng.standard_normal(200000)) * 0.2
    raw = iq_to_bytes(sig)
    # Quantized view (what both feeders actually see after uint8).
    from lte_cell_scanner.io.raw import bytes_to_iq

    sig_q = bytes_to_iq(raw)

    st_py, st_na = _mk_state(), _mk_state()
    py = SampleFeeder(st_py, searcher_capbuf_len=19200 * 2)
    na = NativeSampleFeeder(st_na, searcher_capbuf_len=19200 * 2)
    cell_py, cell_na = _mk_cell(), _mk_cell()
    py.request_searcher_capture()
    na.request_searcher_capture()

    for k in range(0, 200000, 10000):
        py.feed(sig_q[k:k + 10000], [cell_py])
        na.feed_bytes(raw[2 * k:2 * (k + 10000)], [cell_na])

    # Same symbol PDUs emitted
    assert len(cell_py.fifo) == len(cell_na.fifo) > 0
    for a, b in zip(cell_py.fifo, cell_na.fifo):
        assert (a.slot_num, a.sym_num) == (b.slot_num, b.sym_num)
        assert abs(a.late - b.late) < 1e-6
        np.testing.assert_allclose(a.data, b.data, atol=1e-6)

    # Same searcher capture
    cap_py = py.take_searcher_capture()
    cap_na = na.take_searcher_capture()
    assert (cap_py is None) == (cap_na is None)
    if cap_py is not None:
        np.testing.assert_allclose(cap_py, cap_na, atol=1e-6)
        assert abs(py.searcher_late - na.searcher_late) < 1e-9

    assert abs(py.sample_time - na.sample_time) < 1e-6


def test_native_tracker_end_to_end():
    """Swap the native feeder into the runtime: the cell must still track."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.tracker import LTETracker
    from lte_cell_scanner.tracker.native_feeder import NativeSampleFeeder
    from lte_cell_scanner.tracker.runtime import playback_source

    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=4e3, n_subframes=300, seed=5)
    trk = LTETracker(739e6, initial_freq_offset=4000.0)
    trk.feeder = NativeSampleFeeder(trk.state)
    trk.feeder.request_searcher_capture()
    trk.run(playback_source(sig), max_blocks=300)
    st = trk.status()
    assert st["cells"] and st["cells"][0]["n_id_cell"] == 271
    assert st["cells"][0]["mib_successes"] > 5
    # The playback loop seam (sfn jumps back every 0.3 s) can fail one MIB
    # period; health must stay essentially full.
    assert st["cells"][0]["health"] > 0.95


def test_native_descriptor_mode_matches_python():
    """Descriptor-mode PDUs (stream indices, no sample copies) agree
    field-for-field between the C++ and Python feeders."""
    from lte_cell_scanner.io.raw import bytes_to_iq
    from lte_cell_scanner.tracker.native_feeder import NativeSampleFeeder

    rng = np.random.default_rng(3)
    sig = (rng.standard_normal(150000)
           + 1j * rng.standard_normal(150000)) * 0.2
    raw = iq_to_bytes(sig)
    sig_q = bytes_to_iq(raw)

    st_py, st_na = _mk_state(), _mk_state()
    py = SampleFeeder(st_py, searcher_capbuf_len=19200 * 2,
                      emit_descriptors=True)
    na = NativeSampleFeeder(st_na, searcher_capbuf_len=19200 * 2,
                            emit_descriptors=True)
    cell_py, cell_na = _mk_cell(), _mk_cell()
    for k in range(0, len(sig_q), 10000):
        py.feed(sig_q[k:k + 10000], [cell_py])
        na.feed_bytes(raw[2 * k:2 * (k + 10000)], [cell_na])
    assert len(cell_py.fifo) == len(cell_na.fifo) > 50
    for a, b in zip(cell_py.fifo, cell_na.fifo):
        assert a.data is None and b.data is None
        assert (a.start, a.slot_num, a.sym_num) == (b.start, b.slot_num,
                                                    b.sym_num)
        assert abs(a.late - b.late) < 1e-6


def test_batch_tracker_with_native_feeder():
    """Full batched tracker with the C++ feeder front end."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.tracker import LTETracker
    from lte_cell_scanner.tracker.runtime import playback_source

    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=4e3, n_subframes=400, seed=5)
    trk = LTETracker(739e6, initial_freq_offset=4000.0, batch=True,
                     feeder="native")
    trk.run(playback_source(sig), max_blocks=350)
    st = trk.status()
    assert st["cells"] and st["cells"][0]["n_id_cell"] == 271
    assert st["cells"][0]["mib_successes"] > 5
    assert st["cells"][0]["health"] == 1.0

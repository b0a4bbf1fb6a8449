"""Parity tests for the pipelined sweep driver (search/pipeline.py).

The pipelined schedule (chunked uploads, deferred table/sync/MIB
fetches) must produce BIT-identical results to the whole-stack
parallel/fc_sweep.sharded_search_sweep — only the link schedule may
differ. Mirrors the reference's serial fc loop output contract
(src/CellSearch.cpp:471-569).
"""

import numpy as np
import pytest


def _u8_planes(caps: np.ndarray) -> np.ndarray:
    """Complex captures -> (B, 2, n) uint8 radio bytes (the dongle's
    native format; io/raw.py contract (x - 127) / 128)."""
    f = np.stack([caps.real, caps.imag], 1)
    return np.clip(np.round(f * 128.0 + 127.0), 0, 255).astype(np.uint8)


def test_pipelined_sweep_matches_whole_stack(capbuf_0000):
    """3-fc sweep (one padded chunk), both defer_sync modes, vs the
    single whole-stack dispatch: per-capture cell lists must match
    field-for-field."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.parallel.fc_sweep import (
        make_cap_mesh, sharded_search_sweep)
    from lte_cell_scanner.search.pipeline import pipelined_search_sweep

    cap0, fc0 = capbuf_0000
    cap1 = synthetic_capture(n_id_1=30, n_id_2=0, snr_db=15,
                             freq_offset=6e3, n_rb_dl=75, seed=7)
    caps = _u8_planes(np.stack([cap0, cap1[:len(cap0)], cap0]))
    fcs = [fc0, fc0 + 100e3, fc0 + 200e3]
    fset = np.arange(-15, 16) * 5e3
    mesh = make_cap_mesh(1)

    want_pc, want_dd = sharded_search_sweep(caps, fcs, fset, mesh)
    assert sum(len(p) for p in want_pc) >= 3   # the sweep finds cells

    def key(c):
        return (c.n_id_cell(), c.frame_start)

    for defer in (True, False):
        got_pc, got_dd = pipelined_search_sweep(
            caps, fcs, fset, mesh, batch=2, defer_sync=defer)
        assert len(got_pc) == len(want_pc)
        for b in range(len(fcs)):
            got = sorted(got_pc[b], key=key)
            want = sorted(want_pc[b], key=key)
            assert got == want, f"capture {b} (defer_sync={defer})"
        assert (sorted(c.n_id_cell() for c in got_dd)
                == sorted(c.n_id_cell() for c in want_dd))


def test_pipelined_sweep_rejects_bad_batch():
    from lte_cell_scanner.parallel.fc_sweep import make_cap_mesh
    from lte_cell_scanner.search.pipeline import pipelined_search_sweep

    caps = np.zeros((4, 2, 19200), np.uint8) + 127
    with pytest.raises(ValueError, match="not divisible"):
        pipelined_search_sweep(caps, [739e6] * 4, np.zeros(3),
                               make_cap_mesh(2), batch=3)


def test_pipelined_sweep_small_sweep_keeps_shard_multiple():
    """A sweep smaller than the (valid) batch must run: the clamp
    rounds UP to a cap-shard multiple instead of inheriting a
    non-divisible B_tot (review finding: batch=32 with 3 captures on a
    2-shard mesh used to die with 'batch=3 not divisible')."""
    from lte_cell_scanner.parallel.fc_sweep import make_cap_mesh
    from lte_cell_scanner.search.pipeline import pipelined_search_sweep

    caps = np.zeros((3, 2, 19200), np.uint8) + 127   # dead band
    per_cap, dd = pipelined_search_sweep(
        caps, [739e6, 739.1e6, 739.2e6], np.array([0.0]),
        make_cap_mesh(2), batch=32)
    assert per_cap == [[], [], []] and dd == []

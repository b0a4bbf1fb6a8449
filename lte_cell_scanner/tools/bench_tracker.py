"""Tracker capacity benchmark: cells tracked in realtime per GPU.

The reference tracks ~4 cells x 2 ports in realtime on a dual-core
i7-2640 (doc/LTE-Tracker.html:56-57, BASELINE.md). This benchmark
measures the batched device data plane (tracker/batch_runtime.py): M
tracked cells' complete per-symbol processing — demod, channel
estimation/filtering, FOE/TOE/AC statistics, sync measurements, PBCH
collection and the batched Viterbi MIB decode with health tracking —
driven for a stretch of signal, reporting how many cells fit in realtime.

The per-cell symbol streams replicate one simulated cell's PDUs (the
arithmetic is identical for any cell content; acquisition is exercised by
the e2e tests, not benchmarked here).

Usage: python -m lte_cell_scanner.tools.bench_tracker \
           [--cells 64] [--seconds 0.4]
"""

from __future__ import annotations

import argparse
import copy
import json
import time


from lte_cell_scanner.io.simulator import synthetic_capture
from lte_cell_scanner.tracker import LTETracker
from lte_cell_scanner.tracker.batch_runtime import BatchTrackerEngine
from lte_cell_scanner.tracker.runtime import playback_source
from lte_cell_scanner.tracker.state import GlobalState, TrackedCell

BASELINE_CELLS = 4.0


def _collect_pdus(seconds: float):
    """Run the real batched pipeline once to harvest authentic descriptor
    PDUs plus the raw uint8 stream they index into."""
    n_subframes = int(seconds * 1000) + 400
    sig = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                            freq_offset=4e3, n_subframes=n_subframes,
                            sfn_start=0, seed=5)
    harvested = []
    raw_blocks = []

    trk = LTETracker(739e6, initial_freq_offset=4000.0, batch=True,
                     engine_every=20)
    # Tap the feeder: record every PDU pushed to the first tracked cell.
    orig_push = TrackedCell.push_pdu

    def tap(self, pdu):
        harvested.append(copy.copy(pdu))
        orig_push(self, pdu)

    def tapped_source():
        for blk in playback_source(sig):
            raw_blocks.append(blk)
            yield blk

    TrackedCell.push_pdu = tap
    try:
        n_blocks = int(seconds * 1.92e6 / 10000) + 250
        trk.run(tapped_source(), max_blocks=n_blocks)
    finally:
        TrackedCell.push_pdu = orig_push
    assert trk.cells, "benchmark signal failed to acquire"
    proto = trk.cells[0]
    return harvested, raw_blocks, proto


def measure(cells=96, seconds=1.2, chunk_ms=300.0, verbose=True,
            warm_chunks=2):
    """Run the capacity measurement; returns the metric dict (the same
    payload ``main`` prints)."""
    pdus, raw_blocks, proto = _collect_pdus(seconds)
    n_sym_s = proto.n_symb_dl * 2 * 1000
    n_need = int(seconds * n_sym_s)
    if len(pdus) < n_need:
        n_need = len(pdus)
    pdus = pdus[:n_need]
    chunk = max(1, int(chunk_ms / 1000 * n_sym_s))
    if len(pdus) <= chunk * (int(warm_chunks) + 1):
        # Never let warm-up consume the whole signal: keep >= 2 timed
        # chunks or the measurement degenerates to 0 s.
        chunk = max(1, len(pdus) // (int(warm_chunks) + 2))

    M = cells
    state = GlobalState(fc_requested=739e6, fc_programmed=739e6,
                        fs_programmed=1.92e6, frequency_offset=4000.0)
    cells = []
    for m in range(M):
        # M replicas of the real tracked cell (distinct serials), so the
        # full locked-tracker path runs: MIB decodes succeed.
        cells.append(TrackedCell(
            n_id_cell=proto.n_id_cell, n_ports=proto.n_ports,
            cp_type=proto.cp_type, n_rb_dl=proto.n_rb_dl,
            phich_duration=proto.phich_duration,
            phich_resource=proto.phich_resource,
            frame_timing=proto.frame_timing, serial_num=m,
            drop_threshold=float("inf")))
    engine = BatchTrackerEngine(state)
    for blk in raw_blocks:
        engine.push_raw(blk)

    # Warm-up: compile the dispatch shapes, including the first four
    # power-of-two batch buckets of the Viterbi decode (see
    # lte_conv_decode_batch): job counts walk up over the first cycles,
    # and a compile must never land in a timed cycle.
    import numpy as _np

    import lte_cell_scanner.tracker.batch_runtime as _br

    for _b in (1, 129, 257, 513):
        _br.lte_conv_decode_batch(_np.zeros((_b, 3, 40), _np.float32))
    # TWO warm-up cycles by default, each of one timed cycle's size (a
    # single double-size cycle would compile the wrong symbol bucket and
    # leave the timed cycle's compile in the timed region): the MIB
    # backlog walks up batch buckets over the first cycles.
    warm = max(1, int(warm_chunks)) * chunk
    for lo in range(0, warm, chunk):
        for c in cells:
            for p in pdus[lo:lo + chunk]:
                c.fifo.append(p)
        engine.process_all(cells)

    # Tap the engine's device dispatches during the timed run so the
    # device-bound measurement below can replay one cycle's REAL
    # argument set.
    import lte_cell_scanner.tracker.batch_runtime as br

    rec: dict = {}
    counts = {"cycles": 0, "mib": 0}
    orig = (br._demod_stream_jit, br._stats_jit, br.lte_conv_decode_batch)

    def tap_demod(*a):
        rec["demod"] = a
        counts["cycles"] += 1
        return orig[0](*a)

    def tap_stats(*a):
        rec["stats"] = a
        return orig[1](*a)

    def tap_vit(b):
        rec["vit"] = b
        counts["mib"] += 1
        return orig[2](b)

    br._demod_stream_jit = tap_demod
    br._stats_jit = tap_stats
    br.lte_conv_decode_batch = tap_vit
    try:
        fed = warm
        # Full chunks only: a trailing partial chunk would change the
        # dispatch bucket and drop a fresh compile into the timed
        # region. Each cycle is timed SEPARATELY and the capacity uses
        # the median cycle: one slow cycle poisons one sample, not the
        # measurement.
        cycle_walls = []
        while fed + chunk <= len(pdus):
            hi = fed + chunk
            t1 = time.time()
            for c in cells:
                for p in pdus[fed:hi]:
                    c.fifo.append(p)
            engine.process_all(cells)
            cycle_walls.append(time.time() - t1)
            fed = hi
        import numpy as _np

        wall_med = float(_np.median(cycle_walls))
        wall = sum(cycle_walls)
    finally:
        (br._demod_stream_jit, br._stats_jit,
         br.lte_conv_decode_batch) = orig

    signal_s = (fed - warm) / n_sym_s
    chunk_s = chunk / n_sym_s
    cells_realtime = M * chunk_s / wall_med
    mibs = sum(c.mib_decode_successes for c in cells)
    if verbose:
        print(f"# {M} cells x {signal_s:.2f}s signal in {wall:.2f}s wall "
              f"(median cycle {wall_med:.2f}s, {mibs} MIB decodes)",
              flush=True)

    dev = _device_bound(rec, counts, M, chunk, n_sym_s, signal_s)
    return {
        "metric": "tracker_cells_realtime_per_gpu",
        "value": cells_realtime,
        "unit": "cells",
        "vs_baseline": cells_realtime / BASELINE_CELLS,
        "cycle_walls_s": cycle_walls,
        **dev,
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cells", type=int, default=96)
    ap.add_argument("--seconds", type=float, default=1.2)
    ap.add_argument("--chunk-ms", type=float, default=300.0,
                    help="signal per engine cycle (dispatch cadence)")
    args = ap.parse_args(argv)
    from lte_cell_scanner import platform

    device = platform.require_gpu()
    print(f"# card: {platform.card_name_and_power()}", flush=True)
    print(json.dumps({"device": device,
                      **measure(args.cells, args.seconds, args.chunk_ms)}))


def cycle_device_s(rec) -> float:
    """Device time of one engine cycle's data plane: the recorded cycle's
    REAL demod + stats dispatch arguments replayed back to back, ended
    by block_until_ready (median of repeats)."""
    import jax

    import lte_cell_scanner.tracker.batch_runtime as br
    from lte_cell_scanner.utils.profiling import median_time_s

    sa = rec["stats"]

    def cycle():
        flat, ce_dev = br._demod_stream_jit(*rec["demod"])
        flat2, hist = br._stats_jit(ce_dev, *sa[1:-1], sa[-1])
        jax.block_until_ready((flat, flat2, hist))

    return median_time_s(cycle)


def _device_bound(rec, counts, M, chunk, n_sym_s, signal_s):
    """Device-bound tracker capacity: per-cycle DEVICE time of the data
    plane (stream demod + CE/FOE/TOE/AC stats, plus the batched Viterbi
    amortized at its observed cadence) from one timed cycle's REAL
    dispatch arguments (see cycle_device_s)."""
    import jax
    import numpy as np

    import lte_cell_scanner.tracker.batch_runtime as br
    from lte_cell_scanner.utils.profiling import median_time_s

    if "demod" not in rec or "stats" not in rec:
        return {}
    per_cycle = cycle_device_s(rec)
    if "vit" in rec and counts["mib"]:
        vb = np.asarray(rec["vit"], np.float32)
        per_cycle += median_time_s(
            lambda: jax.block_until_ready(br.lte_conv_decode_batch(vb))) \
            * counts["mib"] / max(counts["cycles"], 1)
    cycle_signal_s = chunk / n_sym_s
    cells_dev = M * cycle_signal_s / per_cycle
    return {
        "device_ms_per_cycle": per_cycle * 1e3,
        "cells_realtime_device": cells_dev,
        "vs_baseline_device": cells_dev / BASELINE_CELLS,
    }


if __name__ == "__main__":
    main()

"""The realtime multi-cell tracker runtime.

reference: src/LTE-Tracker.cpp + the four thread modules. The reference
wires five boost::thread types through mutex+condvar FIFOs; this runtime is
a deterministic event loop — each iteration ingests one block of samples,
advances the feeder, drains every cell tracker, and runs the (lower-
cadence) searcher when a capture completes. The same feedback loops exist:

    tracker FOE -> global frequency offset -> feeder's k_factor resampling
    tracker TOE -> cell frame_timing       -> feeder's capture trigger

File playback pushes recorded/synthesized captures through the same uint8
re-quantization as live data (reference: src/LTE-Tracker.cpp:833-866), so
the whole stack is testable without hardware.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional

import numpy as np

from lte_cell_scanner.constants import FRAME, FS_LTE
from lte_cell_scanner.io.raw import bytes_to_iq, iq_to_bytes
from lte_cell_scanner.tracker.cell_tracker import CellTracker
from lte_cell_scanner.tracker.producer import SampleFeeder
from lte_cell_scanner.tracker.searcher import kalibrate, searcher_pass
from lte_cell_scanner.tracker.state import GlobalState, TrackedCell

BLOCK_SIZE = 10000


def playback_source(capbuf: np.ndarray, repeat: bool = True,
                    noise_power: Optional[float] = None,
                    seed: int = 0) -> Iterator[np.ndarray]:
    """Yield uint8 IQ blocks from a recorded/synthesized capture.

    Mirrors the reference's file playback: optional calibrated AWGN, then
    re-quantization to uint8 through the same path as live USB data.
    """
    rng = np.random.default_rng(seed)
    pos = 0
    sig = np.asarray(capbuf)
    while True:
        block = sig[pos:pos + BLOCK_SIZE]
        if len(block) < BLOCK_SIZE:
            if not repeat:
                if len(block):
                    yield _quantize(block, noise_power, rng)
                return
            block = np.concatenate([block, sig[:BLOCK_SIZE - len(block)]])
            pos = (pos + BLOCK_SIZE) % len(sig)
        else:
            pos += BLOCK_SIZE
        yield _quantize(block, noise_power, rng)


def _quantize(block, noise_power, rng):
    if noise_power is not None:
        block = block + (rng.standard_normal(len(block))
                         + 1j * rng.standard_normal(len(block))) \
            * np.sqrt(noise_power / 2)
    return iq_to_bytes(block)


class LTETracker:
    """Tracks every detectable cell on one center frequency."""

    def __init__(self, fc_requested: float, fc_programmed: Optional[float] = None,
                 fs_programmed: float = 1.92e6, initial_freq_offset: float = 0.0,
                 backend: str = "numpy", batch: bool = False,
                 engine_every: int = 1, feeder: str = "python",
                 on_event: Optional[Callable[[str, dict], None]] = None,
                 drop_threshold: Optional[float] = None,
                 ce_observer: Optional[tuple] = None):
        self.state = GlobalState(
            fc_requested=fc_requested,
            fc_programmed=fc_programmed if fc_programmed else fc_requested,
            fs_programmed=fs_programmed,
            frequency_offset=initial_freq_offset)
        if feeder == "native":
            from lte_cell_scanner.tracker.native_feeder import (
                NativeSampleFeeder)

            self.feeder = NativeSampleFeeder(self.state)
        else:
            self.feeder = SampleFeeder(self.state)
        self.cells: List[TrackedCell] = []
        self.trackers: Dict[int, CellTracker] = {}
        self.serial_num: Dict[int, int] = {}
        self.backend = backend
        from lte_cell_scanner.constants import CELL_DROP_THRESHOLD
        self.drop_threshold = (drop_threshold if drop_threshold is not None
                               else CELL_DROP_THRESHOLD)
        self.on_event = on_event or (lambda kind, info: None)
        # Optional (filter, callback) per-symbol interpolated-CE tap for
        # consumers beyond sync/PBCH — forwarded to both data planes
        # (CellTracker.ce_observer / BatchTrackerEngine.ce_observer).
        self.ce_observer = ce_observer
        self.feeder.request_searcher_capture()
        self.n_blocks = 0
        # Batched device data plane: all cells' per-symbol work in shared
        # device dispatches (tracker/batch_runtime.py) instead of one host
        # CellTracker per cell.
        self.engine = None
        if batch:
            from lte_cell_scanner.tracker.batch_runtime import (
                BatchTrackerEngine)

            self.engine = BatchTrackerEngine(self.state)
            self.engine.ce_observer = self.ce_observer
            # Descriptor mode: the engine uploads the raw stream once per
            # cycle and gathers every cell's windows on device.
            self.feeder.emit_descriptors = True
        # Engine dispatch cadence in input blocks: larger values amortize
        # the per-dispatch round trip at the cost of feedback-loop lag
        # (engine_every=20 ~ one cycle per 104 ms of signal).
        self.engine_every = max(1, engine_every)

    # ------------------------------------------------------------------
    def kalibrate(self, sample_source: Iterator[np.ndarray],
                  ppm: float = 120, max_blocks: int = 10000,
                  correction: float = 1.0) -> float:
        """Initial LO calibration: run one-shot cell searches on raw input
        until a cell decodes; seed the global FO with its freq_superfine.
        ``correction`` centers the hypothesis grid on a previously
        calibrated crystal's offset (src/LTE-Tracker.cpp:586).

        reference: src/LTE-Tracker.cpp:565-741.
        """
        fo = kalibrate(sample_source, self.state, ppm=ppm,
                       backend=self.backend, max_blocks=max_blocks,
                       correction=correction)
        self.state.frequency_offset = fo
        self.on_event("kalibrate", {"frequency_offset": fo})
        return fo

    # ------------------------------------------------------------------
    def run(self, sample_source: Iterator[np.ndarray],
            max_blocks: Optional[int] = None) -> int:
        """Ingest blocks until the source ends (or max_blocks this call).

        Returns the number of blocks processed by this call.
        """
        n = 0
        for raw in sample_source:
            self.step(raw)
            n += 1
            if max_blocks is not None and n >= max_blocks:
                break
        return n

    def step(self, raw_block: np.ndarray) -> None:
        """Process one block of raw uint8 IQ samples."""
        self.n_blocks += 1
        samples = bytes_to_iq(raw_block)
        if self.engine is not None:
            self.engine.push_raw(raw_block)

        # Reap killed cells (reference: producer_thread.cpp:191-197).
        for cell in list(self.cells):
            if cell.kill_me:
                self.cells.remove(cell)
                self.trackers.pop(cell.n_id_cell, None)
                self.on_event("cell_dropped", {"n_id_cell": cell.n_id_cell})

        if hasattr(self.feeder, "feed_bytes"):
            # Native feeder consumes the raw bytes directly.
            self.feeder.feed_bytes(np.ascontiguousarray(raw_block,
                                                        dtype=np.uint8),
                                   self.cells)
        else:
            self.feeder.feed(samples, self.cells)

        if self.engine is not None:
            if self.n_blocks % self.engine_every == 0:
                self.engine.process_all(self.cells)
        else:
            for cell in self.cells:
                self.trackers[cell.n_id_cell].process_available()

        capbuf = self.feeder.take_searcher_capture()
        if capbuf is not None:
            self._run_searcher(capbuf, self.feeder.searcher_late)
            self.feeder.request_searcher_capture()

    # ------------------------------------------------------------------
    def _run_searcher(self, capbuf: np.ndarray, late: float) -> None:
        """One searcher cycle on a fresh capture buffer.

        reference: src/searcher_thread.cpp:83-233.
        """
        import time

        t0 = time.time()
        tracked_ids = {c.n_id_cell for c in self.cells}
        found = searcher_pass(capbuf, self.state, tracked_ids,
                              backend=self.backend)
        for cell_res in found:
            k_factor = self.state.k_factor()
            frame_timing = np.mod(
                cell_res.frame_start * (FS_LTE / 16)
                / (self.state.fs_programmed * k_factor) + late, FRAME)
            n_id = cell_res.n_id_cell()
            serial = self.serial_num.get(n_id, 0) + 1
            self.serial_num[n_id] = serial
            cell = TrackedCell(
                n_id_cell=n_id, n_ports=cell_res.n_ports,
                cp_type=cell_res.cp_type, n_rb_dl=cell_res.n_rb_dl,
                phich_duration=cell_res.phich_duration,
                phich_resource=cell_res.phich_resource,
                frame_timing=float(frame_timing), serial_num=serial,
                drop_threshold=self.drop_threshold)
            self.cells.append(cell)
            self.trackers[n_id] = CellTracker(cell, self.state)
            self.trackers[n_id].ce_observer = self.ce_observer
            self.on_event("cell_acquired", {
                "n_id_cell": n_id, "n_ports": cell.n_ports,
                "n_rb_dl": cell.n_rb_dl, "cp_type": cell.cp_type,
                "frame_timing": cell.frame_timing})
        self.state.searcher_cycle_time = time.time() - t0

    # ------------------------------------------------------------------
    def status(self) -> dict:
        """Snapshot of all metrics (consumed by the display)."""
        return {
            "frequency_offset": self.state.frequency_offset,
            "searcher_cycle_time": self.state.searcher_cycle_time,
            "raw_seconds_dropped": self.state.raw_seconds_dropped,
            "cell_seconds_dropped": self.state.cell_seconds_dropped,
            "debug_g": self.state.debug_g,
            "cells": [{
                "n_id_cell": c.n_id_cell,
                "n_ports": c.n_ports,
                "cp_type": c.cp_type,
                "n_rb_dl": c.n_rb_dl,
                "frame_timing": c.frame_timing,
                "health": c.health,
                "mib_successes": c.mib_decode_successes,
                "fifo_peak": c.fifo_peak_size,
                "sync_snr_db": (10 * np.log10(c.sync_sp_av / c.sync_np_av)
                                if c.sync_np_av and not np.isnan(c.sync_np_av)
                                else float("nan")),
            } for c in self.cells],
        }

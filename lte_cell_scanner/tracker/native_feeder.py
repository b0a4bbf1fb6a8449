"""ctypes bindings for the native (C++) sample feeder.

Drop-in alternative to tracker.producer.SampleFeeder for the byte-stream
hot path. Built from native/feeder.cpp (``make -C native``); falls back
with ImportError if the shared library is absent so the pure-Python feeder
remains the default.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
from typing import Dict, List, Optional

import numpy as np

from lte_cell_scanner.constants import FRAME, FS_LTE
from lte_cell_scanner.tracker.state import GlobalState, SymbolPDU, TrackedCell

_NATIVE_DIR = os.path.join(os.path.dirname(__file__), "..", "..", "native")
_LIB_PATH = os.path.abspath(os.path.join(_NATIVE_DIR, "libfeeder.so"))


def build_native(force: bool = False) -> str:
    """Compile the shared library if needed; returns its path."""
    src = os.path.join(_NATIVE_DIR, "feeder.cpp")
    if force or not os.path.exists(_LIB_PATH) or (
            os.path.getmtime(src) > os.path.getmtime(_LIB_PATH)):
        subprocess.run(["make", "-C", os.path.abspath(_NATIVE_DIR)],
                       check=True, capture_output=True)
    return _LIB_PATH


def _load():
    lib = ctypes.CDLL(build_native())
    lib.feeder_create.restype = ctypes.c_void_p
    lib.feeder_create.argtypes = [ctypes.c_long]
    lib.feeder_destroy.argtypes = [ctypes.c_void_p]
    lib.feeder_set_step.argtypes = [ctypes.c_void_p, ctypes.c_double]
    lib.feeder_sample_time.restype = ctypes.c_double
    lib.feeder_sample_time.argtypes = [ctypes.c_void_p]
    lib.feeder_request_searcher.argtypes = [ctypes.c_void_p]
    lib.feeder_searcher_ready.restype = ctypes.c_int
    lib.feeder_searcher_ready.argtypes = [ctypes.c_void_p]
    lib.feeder_searcher_late.restype = ctypes.c_double
    lib.feeder_searcher_late.argtypes = [ctypes.c_void_p]
    lib.feeder_take_searcher.restype = ctypes.c_long
    lib.feeder_take_searcher.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    lib.feeder_set_cell.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                    ctypes.c_int, ctypes.c_int,
                                    ctypes.c_double]
    lib.feeder_remove_cell.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.feeder_feed.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_long, ctypes.c_double]
    lib.feeder_pdu_count.restype = ctypes.c_long
    lib.feeder_pdu_count.argtypes = [ctypes.c_void_p]
    lib.feeder_get_pdus.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p]
    lib.feeder_set_descriptor_mode.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.feeder_get_pdu_starts.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    return lib


class NativeSampleFeeder:
    """Same interface as tracker.producer.SampleFeeder, but the per-sample
    state machine runs in C++ and consumes raw uint8 bytes directly."""

    def __init__(self, state: GlobalState, searcher_capbuf_len: int = FRAME * 8,
                 emit_descriptors: bool = False):
        self._lib = _load()
        self.state = state
        self.searcher_capbuf_len = int(searcher_capbuf_len)
        self._h = self._lib.feeder_create(self.searcher_capbuf_len)
        self._known: Dict[int, int] = {}
        self.searcher_ready: Optional[np.ndarray] = None
        self.searcher_late = 0.0
        self._descriptors = bool(emit_descriptors)
        self._lib.feeder_set_descriptor_mode(self._h,
                                             1 if emit_descriptors else 0)

    @property
    def emit_descriptors(self) -> bool:
        return self._descriptors

    @emit_descriptors.setter
    def emit_descriptors(self, on: bool) -> None:
        self._descriptors = bool(on)
        self._lib.feeder_set_descriptor_mode(self._h, 1 if on else 0)

    def __del__(self):
        try:
            self._lib.feeder_destroy(self._h)
        except Exception:
            pass

    def request_searcher_capture(self) -> None:
        self._lib.feeder_request_searcher(self._h)

    def take_searcher_capture(self) -> Optional[np.ndarray]:
        buf, self.searcher_ready = self.searcher_ready, None
        return buf

    @property
    def sample_time(self) -> float:
        return self._lib.feeder_sample_time(self._h)

    def feed_bytes(self, raw: np.ndarray, cells: List[TrackedCell]) -> None:
        """Feed a block of interleaved uint8 IQ bytes."""
        k_factor = self.state.k_factor()
        step = (FS_LTE / 16) / (self.state.fs_programmed * k_factor)
        self._lib.feeder_set_step(self._h, step)

        live = set()
        for cell in cells:
            if cell.kill_me:
                continue
            live.add(cell.n_id_cell)
            self._lib.feeder_set_cell(self._h, cell.n_id_cell,
                                      cell.serial_num, cell.n_symb_dl,
                                      cell.frame_timing)
        for n_id in list(self._known):
            if n_id not in live:
                self._lib.feeder_remove_cell(self._h, n_id)
                del self._known[n_id]
        for n_id in live:
            self._known[n_id] = 1

        raw = np.ascontiguousarray(raw, dtype=np.uint8)
        self._lib.feeder_feed(self._h, raw.ctypes.data, len(raw) // 2,
                              float(self.state.frequency_offset))

        # Deliver PDUs.
        n = self._lib.feeder_pdu_count(self._h)
        if n:
            meta = np.empty((n, 3), dtype=np.int32)
            vals = np.empty((n, 3), dtype=np.float64)
            data = np.empty((n, 128, 2), dtype=np.float32)
            self._lib.feeder_get_pdus(self._h, meta.ctypes.data,
                                      vals.ctypes.data, data.ctypes.data)
            starts = None
            if self._descriptors:
                starts = np.empty(n, dtype=np.int64)
                self._lib.feeder_get_pdu_starts(self._h, starts.ctypes.data)
            by_id = {c.n_id_cell: c for c in cells}
            for i in range(n):
                cell = by_id.get(int(meta[i, 0]))
                if cell is None:
                    continue
                cell.push_pdu(SymbolPDU(
                    data=(None if self._descriptors else
                          (data[i, :, 0] + 1j * data[i, :, 1]).astype(complex)),
                    slot_num=int(meta[i, 1]), sym_num=int(meta[i, 2]),
                    late=float(vals[i, 0]), frequency_offset=float(vals[i, 1]),
                    frame_timing=float(vals[i, 2]),
                    start=(int(starts[i]) if self._descriptors else None)))

        if self._lib.feeder_searcher_ready(self._h):
            out = np.empty(self.searcher_capbuf_len * 2, dtype=np.float32)
            self._lib.feeder_take_searcher(self._h, out.ctypes.data)
            self.searcher_late = self._lib.feeder_searcher_late(self._h)
            self.searcher_ready = (out[0::2] + 1j * out[1::2]).astype(complex)

    def feed(self, samples: np.ndarray, cells: List[TrackedCell]) -> None:
        """Compatibility shim: accepts complex samples like the Python
        feeder (re-quantizes; prefer feed_bytes on the raw stream)."""
        from lte_cell_scanner.io.raw import iq_to_bytes

        self.feed_bytes(iq_to_bytes(samples), cells)

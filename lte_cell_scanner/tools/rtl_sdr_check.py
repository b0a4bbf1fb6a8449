"""Capture-integrity checker: detect dropped samples in a raw recording.

reference: src/rtl_sdr_check.cpp (dev tool, not built by default) — verify
an rtl_sdr capture by tracking a known cell's PSS: the PSS repeats every
half-frame, so any discontinuity in the sequence of correlation-peak lags
reveals sample drops (or insertions) by the capture hardware/driver.

Usage:
    python -m lte_cell_scanner.tools.rtl_sdr_check \
        --file cap.dat --cell-id 271 [--freq-offset HZ] [--it]
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
from typing import List

import numpy as np

from lte_cell_scanner.constants import HALF_FRAME
from lte_cell_scanner.models.pss import pss_td


@dataclasses.dataclass
class DropEvent:
    position: int        # approx sample index of the discontinuity
    jump: float          # timing jump in samples (positive = samples lost)


def check_capture(sig: np.ndarray, n_id_2: int, freq_offset: float = 0.0,
                  fs: float = 1.92e6, tol: float = 2.0):
    """Track the PSS lag across half-frames; report discontinuities.

    Returns (events, lags): drop events and the per-half-frame fractional
    PSS peak lags (NaN where the PSS was too weak to find).
    """
    tpl = pss_td(n_id_2)
    if freq_offset:
        t = np.arange(137)
        tpl = tpl * np.exp(1j * 2 * np.pi * freq_offset * t / fs)
    tpl = np.conj(tpl) / 137

    n_hf = (len(sig) - 137) // HALF_FRAME
    lags = np.full(n_hf, np.nan)
    prev_lag = None
    events: List[DropEvent] = []
    for h in range(n_hf):
        seg = sig[h * HALF_FRAME: (h + 1) * HALF_FRAME + 136]
        # Correlate over the entire half-frame on the first pass, then only
        # around the expected lag (fast path).
        if prev_lag is None:
            # np.correlate(a, v)[k] = sum a[k+m] * conj(v[m]); we want
            # sum tpl[m] * seg[k+m], so pass conj(tpl).
            xc = np.abs(np.correlate(seg, np.conj(tpl))) ** 2
            lag = int(np.argmax(xc))
            if xc[lag] < 4 * np.median(xc):
                continue  # no usable PSS in this half-frame
        else:
            lo = max(0, int(prev_lag) - 64)
            hi = min(len(seg) - 137, int(prev_lag) + 64)
            win = np.array([abs(np.dot(tpl, seg[k:k + 137])) ** 2
                            for k in range(lo, hi + 1)])
            lag = lo + int(np.argmax(win))
        # Refine to sub-sample with a parabolic fit around the peak.
        if 1 <= lag < HALF_FRAME - 1:
            y0 = abs(np.dot(tpl, seg[lag - 1:lag + 136])) ** 2
            y1 = abs(np.dot(tpl, seg[lag:lag + 137])) ** 2
            y2 = abs(np.dot(tpl, seg[lag + 1:lag + 138])) ** 2
            denom = (y0 - 2 * y1 + y2)
            frac = 0.5 * (y0 - y2) / denom if denom else 0.0
            lag_f = lag + np.clip(frac, -0.5, 0.5)
        else:
            lag_f = float(lag)
        lags[h] = lag_f
        if prev_lag is not None and abs(lag_f - prev_lag) > tol:
            events.append(DropEvent(
                position=h * HALF_FRAME + int(lag_f),
                jump=float(prev_lag - lag_f)))
        prev_lag = lag_f
    return events, lags


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="rtl_sdr_check")
    p.add_argument("--file", required=True)
    p.add_argument("--it", action="store_true",
                   help="file is an .it capture, not raw uint8")
    p.add_argument("--cell-id", type=int, required=True)
    p.add_argument("--freq-offset", type=float, default=0.0)
    p.add_argument("--tol", type=float, default=2.0)
    args = p.parse_args(argv)

    if args.it:
        from lte_cell_scanner.io.itfile import load_it

        sig = load_it(args.file)["capbuf"]
    else:
        from lte_cell_scanner.io.raw import load_rtl_sdr

        sig = load_rtl_sdr(args.file)
    n_id_2 = args.cell_id % 3
    events, lags = check_capture(sig, n_id_2, args.freq_offset, tol=args.tol)
    n_tracked = int(np.isfinite(lags).sum())
    print(f"tracked PSS in {n_tracked}/{len(lags)} half-frames")
    if not events:
        print("no sample drops detected")
        return 0
    for e in events:
        kind = "lost" if e.jump > 0 else "inserted"
        print(f"  ~sample {e.position}: {abs(e.jump):.1f} samples {kind}")
    return 1


if __name__ == "__main__":
    sys.exit(main())

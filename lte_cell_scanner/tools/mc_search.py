"""Monte-Carlo statistical test harness for the full search pipeline.

Reproduces Matlab/pss_search_final.m: run many randomized trials — random
cell identity, CP type, slot timing, traffic load, timing/frequency offset,
optional multipath and AWGN — through signal generation, channel
impairment, and the complete search pipeline, and log detection /
false-alarm / MIB-success statistics. Because this framework's simulator
encodes a real PBCH (io/simulator.py), the harness validates the MIB stage
too, which the reference's harness could not (its measured stages stop at
sync; Matlab/pss_search_final.m:78-127, 341-363).

Usage:
    python -m lte_cell_scanner.tools.mc_search --trials 20 \
        --snr-db -5 [--fading] [--backend jax] [--seed 1]
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Optional

import numpy as np

from lte_cell_scanner.io.simulator import (
    MibConfig,
    apply_channel,
    create_dl_sig,
)
from lte_cell_scanner.search.cell_search import cell_search


@dataclasses.dataclass
class TrialResult:
    n_id_cell: int
    cp_type: str
    snr_db: float
    detected: bool          # correct cell ID returned
    mib_ok: bool            # ... with exact MIB fields
    false_cells: int        # other cell IDs returned
    freq_err_hz: float      # |freq_superfine - true offset| if detected
    elapsed_s: float


@dataclasses.dataclass
class McStats:
    trials: int = 0
    detections: int = 0
    mib_successes: int = 0
    false_cells: int = 0
    freq_errs: list = dataclasses.field(default_factory=list)

    def add(self, r: TrialResult):
        self.trials += 1
        self.detections += r.detected
        self.mib_successes += r.mib_ok
        self.false_cells += r.false_cells
        if r.detected and np.isfinite(r.freq_err_hz):
            self.freq_errs.append(r.freq_err_hz)

    def summary(self) -> str:
        if not self.trials:
            return "no trials"
        lines = [
            f"trials:            {self.trials}",
            f"detection rate:    {self.detections / self.trials:.1%}",
            f"MIB success rate:  {self.mib_successes / self.trials:.1%}",
            f"false cells:       {self.false_cells}",
        ]
        if self.freq_errs:
            lines.append(f"freq err (med):    "
                         f"{np.median(self.freq_errs):.1f} Hz")
        return "\n".join(lines)


def run_trial(rng: np.random.Generator, snr_db: Optional[float],
              fading: bool = False, backend: str = "numpy",
              ppm: float = 30.0, fc: float = 739e6,
              n_subframes: int = 80, load_factor: Optional[float] = None,
              verbose: int = 0) -> TrialResult:
    """One randomized end-to-end trial.

    The frequency-offset draw spans the +/-ppm crystal error the search
    grid is sized for (src/CellSearch.cpp:463-465); delay is uniform over a
    frame; multipath (if enabled) is a 3-tap exponential-decay Rayleigh
    channel like pss_search_final.m's fading case.
    """
    n_id_1 = int(rng.integers(0, 168))
    n_id_2 = int(rng.integers(0, 3))
    cp_type = "normal" if rng.random() < 0.5 else "extended"
    slot_start = int(rng.integers(0, 10)) * 2
    load = float(rng.uniform(0.1, 1.0)) if load_factor is None else load_factor
    n_rb_dl = int(rng.choice([6, 15, 25, 50, 75, 100]))
    sfn_start = int(rng.integers(0, 1024 // 4)) * 4
    f_off_true = float(rng.uniform(-1, 1) * ppm * 1e-6 * fc)
    delay = int(rng.integers(0, 19200))

    mib = MibConfig(n_rb_dl=n_rb_dl, sfn_start=sfn_start)
    tx = create_dl_sig(cp_type, n_subframes, slot_start, n_id_1, n_id_2,
                       load, rng, mib=mib)
    taps = None
    if fading:
        g = np.sqrt(np.array([0.7, 0.2, 0.1]) / 2)
        taps = g * (rng.standard_normal(3) + 1j * rng.standard_normal(3))
    rx = apply_channel(tx, snr_db=snr_db, freq_offset=f_off_true,
                       delay=delay, taps=taps, rng=rng)[:len(tx)]

    n_extra = int(np.floor((fc * ppm / 1e6 + 2.5e3) / 5e3))
    f_search_set = (np.arange(-n_extra, n_extra + 1) * 5e3)

    t0 = time.perf_counter()
    cells = cell_search(rx, fc, f_search_set=f_search_set, backend=backend)
    elapsed = time.perf_counter() - t0

    want = 3 * n_id_1 + n_id_2
    hit = [c for c in cells if c.n_id_cell() == want]
    false_cells = len(cells) - len(hit)
    detected = bool(hit)
    mib_ok = False
    freq_err = np.nan
    if detected:
        c = max(hit, key=lambda c: c.pss_pow)
        freq_err = abs(c.freq_superfine - f_off_true)
        mib_ok = (c.n_rb_dl == n_rb_dl and c.cp_type == cp_type)
    if verbose:
        print(f"  cell {want} ({cp_type}, {n_rb_dl} RB, "
              f"{f_off_true / 1e3:+.1f} kHz): "
              f"{'MIB ok' if mib_ok else 'detected' if detected else 'MISS'}"
              f"{f', +{false_cells} false' if false_cells else ''} "
              f"[{elapsed:.1f} s]")
    return TrialResult(want, cp_type, snr_db if snr_db is not None
                       else np.inf, detected, mib_ok, false_cells,
                       freq_err, elapsed)


# The detection floor held on every device the search runs on:
# (snr_db, min detections, min MIB decodes) out of FLOOR_TRIALS trials at
# ppm=10, seed int(-snr_db), at most FLOOR_MAX_FALSE false cells. The
# reference documents reliable sync to about -12 dB and MIB to about
# -10 dB AWGN (src/searcher.cpp:99-104); tests/test_mc_floor.py derives
# the binomial margins.
FLOOR_TRIALS = 8
FLOOR_POINTS = ((-10.0, 5, 5), (-12.0, 3, 3))
FLOOR_MAX_FALSE = 1


def run_mc(trials: int, snr_db: Optional[float], fading: bool = False,
           backend: str = "numpy", seed: int = 0, ppm: float = 30.0,
           verbose: int = 1) -> McStats:
    rng = np.random.default_rng(seed)
    stats = McStats()
    for _ in range(trials):
        stats.add(run_trial(rng, snr_db, fading=fading, backend=backend,
                            ppm=ppm, verbose=verbose))
    return stats


def wilson_lower(k: int, n: int, z: float = 1.96) -> float:
    """95% Wilson-score lower bound on a binomial proportion (no scipy:
    the artifact's confidence bounds must not depend on an optional
    dependency)."""
    if n == 0:
        return 0.0
    p = k / n
    d = 1.0 + z * z / n
    center = p + z * z / (2 * n)
    rad = z * np.sqrt(p * (1 - p) / n + z * z / (4 * n * n))
    return max(0.0, (center - rad) / d)


def run_sweep_artifact(snrs, trials: int, ppm: float = 10.0,
                       seed: int = 0, backend: str = "jax",
                       fading: bool = False, path: Optional[str] = None,
                       verbose: int = 1) -> dict:
    """Run the SNR sweep and emit the committed statistical-floor
    artifact (MC_rNN.json): per-point trial counts, detection / MIB
    success rates with 95% Wilson lower bounds, false-alarm counts and
    median frequency error — the evidence behind the floor-parity claim
    vs the reference's documented sync ~-12 dB / MIB ~-10 dB AWGN
    floors (src/searcher.cpp:99-104; derivation
    Matlab/pss_search_final.m:207-255). Checkpoints after every SNR
    point so an interrupted run keeps its finished points."""
    import json

    art = {"metric": "mc_detection_floor",
           "trials_per_point": trials, "ppm": ppm, "seed": seed,
           "backend": backend, "fading": fading,
           "reference": "src/searcher.cpp:99-104 (sync ~-12 dB AWGN, "
                         "MIB ~-10 dB); Matlab/pss_search_final.m",
           "points": []}
    for snr in snrs:
        t0 = time.perf_counter()
        st = run_mc(trials, snr, fading=fading, backend=backend,
                    seed=seed, ppm=ppm, verbose=0)
        pt = {"snr_db": snr, "trials": st.trials,
              "detections": st.detections,
              "mib_successes": st.mib_successes,
              "false_cells": st.false_cells,
              "detect_rate": round(st.detections / st.trials, 4),
              "mib_rate": round(st.mib_successes / st.trials, 4),
              "detect_rate_wilson95_lo": round(
                  wilson_lower(st.detections, st.trials), 4),
              "mib_rate_wilson95_lo": round(
                  wilson_lower(st.mib_successes, st.trials), 4),
              "freq_err_med_hz": (round(float(np.median(st.freq_errs)), 2)
                                  if st.freq_errs else None),
              "elapsed_s": round(time.perf_counter() - t0, 1)}
        art["points"].append(pt)
        if verbose:
            print(f"{snr:7.1f} dB: detect {pt['detect_rate']:.0%} "
                  f"(>={pt['detect_rate_wilson95_lo']:.0%} w95), MIB "
                  f"{pt['mib_rate']:.0%}, false {pt['false_cells']}, "
                  f"{pt['elapsed_s']} s", flush=True)
        if path:
            tmp = path + ".tmp"
            with open(tmp, "w") as f:
                json.dump(art, f, indent=1)
            import os

            os.replace(tmp, path)
    return art


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--trials", type=int, default=20)
    ap.add_argument("--snr-db", type=float, default=None,
                    help="AWGN SNR; omit for noise-free")
    ap.add_argument("--snr-sweep", type=str, default=None,
                    help="comma-separated SNRs; validates the detection "
                         "floor (reference claims sync ~-12 dB, MIB "
                         "~-10 dB, src/searcher.cpp:99-104)")
    ap.add_argument("--artifact", type=str, default=None,
                    help="with --snr-sweep: write the JSON floor "
                         "artifact (e.g. mc_floor.json) with Wilson 95%% "
                         "bounds, checkpointed per SNR point")
    ap.add_argument("--fading", action="store_true")
    ap.add_argument("--backend", default="jax", choices=["numpy", "jax"])
    ap.add_argument("--ppm", type=float, default=30.0)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if args.snr_sweep:
        snrs = [float(s) for s in args.snr_sweep.split(",")]
        if args.artifact:
            run_sweep_artifact(snrs, args.trials, ppm=args.ppm,
                               seed=args.seed, backend=args.backend,
                               fading=args.fading, path=args.artifact)
            return
        print("SNR(dB)  detect   MIB      false")
        for snr in snrs:
            st = run_mc(args.trials, snr, fading=args.fading,
                        backend=args.backend, seed=args.seed, ppm=args.ppm,
                        verbose=0)
            print(f"{snr:7.1f}  {st.detections / st.trials:6.1%}  "
                  f"{st.mib_successes / st.trials:6.1%}  {st.false_cells}")
        return

    stats = run_mc(args.trials, args.snr_db, fading=args.fading,
                   backend=args.backend, seed=args.seed, ppm=args.ppm)
    print(stats.summary())


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""Start-up proof of the cell scanner on an NVIDIA GPU.

Drives the system's main paths once, in ONE process, through the entry
points a user calls, with every input generated from a seed:

  precision  tools/gpu_checks: the scan, DFT, deratematch and Viterbi
             matmuls against the float64 host reference at production
             shapes, on the card's own numerics
  timings    compile (set-up) time, memory_analysis() and steady device
             time of the scan, sync and MIB programs (MIB stage cuts tfg,
             llr and vit included)
  1 search   search CLI ``-s 739e6 --simulate`` (ppm 120: 37 hypotheses,
             153600-sample capture); the simulated cell must come out
  2 sweep    a 128-carrier ppm=100 band (31 hypotheses; a 12.8 MHz band
             on the 100 kHz raster) through pipelined_search_sweep in
             64-capture chunks of uint8 radio bytes, as ``--batch-sweep
             --sweep-batch 64`` runs it, against the float64 host
             reference on 10 carriers, occupied and empty
  3 wideband a 15.36 Msps recording through the ``--wideband`` CLI path
  4 tracker  tracker CLI ``--simulate --backend jax --batch`` against the
             ``--backend numpy`` tracker on the same seeded stream
  5 floor    the detection floor at -10 and -12 dB on the card's numerics
             (tools/mc_search.run_mc, backend jax, FLOOR_POINTS)

``--cards 4`` runs only the band sweep of phase 2 on a 4-device cap mesh
and compares it, cell for cell and bit for bit, with the same sweep on
one device (parallel/multichip_checks.check_pipelined_sweep_multidevice).

There is no CPU fallback: without a GPU the script exits non-zero and
prints no result. It exits non-zero if any phase fails. Every number is
printed beside the card's name and power limit. The last line of
standard output is one JSON object, {"ok": true, "device": {...}}.

Usage: python3 chip_smoke.py [--cards 4]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
import time
import traceback

import numpy as np

BAND_START = 733.6e6       # 128 raster carriers: 733.6 .. 746.3 MHz
BAND_CARRIERS = 128
BAND_OCCUPIED = 24
SWEEP_BATCH = 64
SEED = 2024
# Frequency and timing tolerances against the float64 host reference.
# The device chain runs in float32: the superfine FOE is the phase of
# ~1e4 summed RS products, so it carries float32 rounding far below the
# 0.5 Hz bound (1/30000 of the 15 kHz subcarrier spacing, a residual the
# MIB decode never sees). Frame timing is planned on the host in float64
# from the same integer peak lag; the float32 fine FOE enters it only
# through the k_factor (fc - f)/fc, a relative 1e-9 effect, so 0.01
# sample (5 ns at 1.92 Msps) is loose.
FREQ_TOL_HZ = 0.5
TIMING_TOL_SAMPLES = 0.01

CARD = "unknown card"


def say(label: str, numbers=None) -> None:
    """One result line, always beside the card's name and power limit."""
    body = "" if numbers is None else " " + json.dumps(numbers, default=str)
    print(f"{label}:{body} [card: {CARD}]", flush=True)


def peak_bytes() -> int | None:
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def result_line(device: dict) -> str:
    """The script's last line: what the device check reads."""
    return json.dumps({"ok": True, "device": device})


# ---------------------------------------------------------------- inputs

def _to_radio_bytes(cap: np.ndarray) -> np.ndarray:
    """Complex capture -> (2, n) uint8 radio planes at an AGC-like RMS of
    0.25 full scale (the RTL-SDR's byte format: zero level 127)."""
    planes = np.stack([cap.real, cap.imag])
    planes = planes * (0.25 / np.sqrt(np.mean(planes ** 2) * 2))
    return np.clip(np.round(planes * 128.0 + 127.0), 0, 255).astype(np.uint8)


def band_inputs(seed: int = SEED, n_carriers: int = BAND_CARRIERS,
                n_occupied: int = BAND_OCCUPIED):
    """A seeded raster band: occupied carriers with distinct cell IDs,
    both CP types, 6-100 RB and SNR from 10 to -6 dB, the rest noise
    only. Offsets stay within +-8 kHz (~10 ppm): the simulator shifts
    the carrier without the matching sample-clock error a real crystal
    offset brings, and the search corrects timing for that clock error
    (k_factor), so a larger simulated offset would drift the frame
    timing by many samples over the capture. Returns (caps (B, 2, n)
    uint8, fcs, f_search_set (ppm 100), truth {carrier: (cell_id, cp,
    n_rb, snr_db)})."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.search.cell_search import generate_search_sets

    rng = np.random.default_rng(seed)
    fcs = [BAND_START + 100e3 * i for i in range(n_carriers)]
    _, fset = generate_search_sets(fcs[0], fcs[0], 100)
    occupied = sorted(rng.choice(n_carriers, n_occupied, replace=False))
    ids = rng.choice(504, n_occupied, replace=False)
    snrs = rng.permutation(np.linspace(10.0, -6.0, n_occupied))
    truth, caps = {}, []
    for b in range(n_carriers):
        if b in occupied:
            k = occupied.index(b)
            cid, cp = int(ids[k]), ("normal", "extended")[k % 2]
            n_rb = int(rng.choice([6, 15, 25, 50, 75, 100]))
            cap = synthetic_capture(
                n_id_1=cid // 3, n_id_2=cid % 3, cp_type=cp,
                snr_db=float(snrs[k]),
                freq_offset=float(rng.uniform(-8e3, 8e3)),
                n_rb_dl=n_rb, slot_start=2 * int(rng.integers(0, 10)),
                sfn_start=4 * int(rng.integers(0, 256)),
                seed=int(rng.integers(1 << 30)))
            truth[b] = (cid, cp, n_rb, float(snrs[k]))
        else:
            cap = rng.standard_normal(153600) + 1j * rng.standard_normal(
                153600)
        caps.append(_to_radio_bytes(cap))
    return np.stack(caps), fcs, fset, truth


def _cell_key(c):
    return (c.n_id_cell(), c.cp_type, c.n_ports, c.n_rb_dl, c.sfn,
            c.phich_duration, c.phich_resource)


def _parse_table(out: str):
    """The CLI result table -> [(cell_id, ports, cp 'N'/'E', n_rb)]."""
    rows, on = [], False
    for line in out.splitlines():
        if line.startswith("CID A"):
            on = True
            continue
        f = line.split()
        if on and len(f) >= 10 and f[0].isdigit():
            rows.append((int(f[0]), int(f[1]), f[5], int(f[6])))
    return rows


def _run_cli(main, argv):
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue(), time.perf_counter() - t0


# ---------------------------------------------------------------- phases

def phase_precision(state):
    from lte_cell_scanner import platform
    from lte_cell_scanner.tools import gpu_checks

    say("precision", {
        "matmuls": platform.MATMUL_PRECISION_NOTE,
        "covers": ["scan matmul (ops/xcorr_jax.correlate_conv)",
                   "128->72 DFT products (ops/mib_jax, ops/sync_jax, "
                   "tracker demod)",
                   "deratematch einsum (ops/mib_jax)",
                   "Viterbi branch metrics (models/convcode_jax)"],
        "exact_at_any_precision": "one-hot cell-table picks and the CRC "
                                  "matmul (small-integer operands)"})
    for name, check in gpu_checks.CHECKS:
        say(f"precision check {name}", check())


def phase_timings(state):
    from lte_cell_scanner.parallel.fc_sweep import make_cap_mesh, sweep_call
    from lte_cell_scanner.tools.bench_decode import measure
    from lte_cell_scanner.utils.profiling import compile_and_time

    caps, fcs, fset, _ = state["band"]
    prog, args = sweep_call(caps[:SWEEP_BATCH], fcs[:SWEEP_BATCH], fset,
                            make_cap_mesh(1))
    r = compile_and_time(prog, *args, reps=5)
    r["device_ms_per_capture"] = r["device_ms"] / SWEEP_BATCH
    say(f"timing scan program ({SWEEP_BATCH} captures x {len(fset)} "
        "hypotheses, uint8 in, peak tables out)", r)
    dec = measure(b_cap=SWEEP_BATCH, stages=("tfg", "llr", "vit", "full"))
    for k in ("sync", "mib_tfg", "mib_llr", "mib_vit", "mib_full"):
        say(f"timing {k} program ({SWEEP_BATCH} candidates)", dec[k])
    # Stage cuts are cumulative programs: the Viterbi's own share is the
    # vit cut less the llr cut.
    vit = dec["mib_vit"]["device_ms"] - dec["mib_llr"]["device_ms"]
    say("timing Viterbi stage (vit cut - llr cut)",
        {"device_ms": vit,
         "share_of_mib_full": vit / dec["mib_full"]["device_ms"]})
    say("timing peak_bytes_in_use", {"bytes": peak_bytes()})


def phase_search(state):
    from lte_cell_scanner.search import cli

    rc, out, wall = _run_cli(cli.main, ["-s", "739e6", "--simulate"])
    rows = _parse_table(out)
    say("search CLI -s 739e6 --simulate (37 hypotheses)",
        {"rc": rc, "cells": rows, "wall_s_first_call": wall})
    # io/simulator.synthetic_capture's defaults: cell 3*90+1, normal CP,
    # 50 RB, one antenna port.
    assert rc == 0 and rows == [(271, 1, "N", 50)], out


def phase_sweep(state):
    from lte_cell_scanner.parallel.fc_sweep import _to_complex, make_cap_mesh
    from lte_cell_scanner.search.cell_search import cell_search
    from lte_cell_scanner.search.pipeline import pipelined_search_sweep

    caps, fcs, fset, truth = state["band"]
    t0 = time.perf_counter()
    per_cap, deduped = pipelined_search_sweep(
        caps, fcs, fset, make_cap_mesh(1), batch=SWEEP_BATCH)
    wall = time.perf_counter() - t0
    say(f"sweep {len(fcs)} carriers x {len(fset)} hypotheses "
        f"(pipelined, {SWEEP_BATCH}-capture chunks, first call incl. "
        "compile)", {"wall_s": wall, "cells": len(deduped)})

    # Against the simulator's truth: every carrier at >= 0 dB decodes
    # exactly its cell, at least 90% of all occupied ones do, and noise
    # carriers yield nothing.
    found = {b: [(c.n_id_cell(), c.cp_type, c.n_rb_dl) for c in per_cap[b]]
             for b in range(len(fcs))}
    hits = 0
    for b in range(len(fcs)):
        if b not in truth:
            assert found[b] == [], (b, found[b])
            continue
        cid, cp, n_rb, snr = truth[b]
        ok = set(found[b]) == {(cid, cp, n_rb)}
        hits += ok
        assert ok or snr < 0.0, (b, truth[b], found[b])
    assert hits >= 0.9 * len(truth), (hits, len(truth))

    # Against the float64 host reference on about 10 carriers: the
    # lowest-SNR occupied one, three more of each CP spread over the SNR
    # range, and four empty ones.
    occ = sorted(truth, key=lambda b: truth[b][3])
    by_cp = [[b for b in occ[1:] if truth[b][1] == cp]
             for cp in ("normal", "extended")]
    empty = [b for b in range(len(fcs)) if b not in truth]
    ref = sorted({occ[0], *by_cp[0][::max(1, len(by_cp[0]) // 3)][:3],
                  *by_cp[1][::max(1, len(by_cp[1]) // 3)][:3],
                  *empty[::max(1, len(empty) // 4)][:4]})
    diffs = {"freq_hz": 0.0, "timing_samples": 0.0}
    for b in ref:
        cap = np.asarray(_to_complex(caps[b:b + 1])[0], np.complex128)
        host = cell_search(cap, fcs[b], f_search_set=fset,
                           backend="numpy", interp="freq_time")
        dev = sorted(per_cap[b], key=_cell_key)
        host = sorted(host, key=_cell_key)
        assert [_cell_key(c) for c in dev] == [_cell_key(c) for c in host], \
            (b, dev, host)
        for d, h in zip(dev, host):
            diffs["freq_hz"] = max(diffs["freq_hz"],
                                   abs(d.freq_superfine - h.freq_superfine))
            diffs["timing_samples"] = max(diffs["timing_samples"],
                                          abs(d.frame_start - h.frame_start))
    say("sweep vs float64 host reference",
        {"carriers": ref, "occupied": [b for b in ref if b in truth],
         "max_diff": diffs, "tolerance": {"freq_hz": FREQ_TOL_HZ,
                                          "timing_samples":
                                          TIMING_TOL_SAMPLES},
         "truth_hits": f"{hits}/{len(truth)}"})
    assert diffs["freq_hz"] < FREQ_TOL_HZ, diffs
    assert diffs["timing_samples"] < TIMING_TOL_SAMPLES, diffs
    say("sweep peak_bytes_in_use", {"bytes": peak_bytes()})


def wideband_recording(seed: int = SEED + 1, decim: int = 8):
    """Three simulated cells upconverted into one 15.36 Msps recording
    centred at 739 MHz. Returns (wide, fs_in, {fc: (cell_id, cp, n_rb)})."""
    from lte_cell_scanner.constants import FS_SEARCH
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.utils.dsp import interpft

    fs_in = decim * FS_SEARCH
    cells = ((2.0e6, 101, "normal", 50), (-3.5e6, 377, "extended", 25),
             (5.7e6, 12, "normal", 100))
    wide, truth = 0.0, {}
    for i, (shift, cid, cp, n_rb) in enumerate(cells):
        nb = synthetic_capture(n_id_1=cid // 3, n_id_2=cid % 3, cp_type=cp,
                               snr_db=20.0, freq_offset=1.5e3 * (i - 1),
                               n_subframes=90, n_rb_dl=n_rb,
                               slot_start=4 * i, sfn_start=40 * i,
                               seed=seed + i)
        up = interpft(nb, len(nb) * decim)
        wide = wide + up * np.exp(2j * np.pi * shift * np.arange(len(up))
                                  / fs_in)
        truth[739e6 + shift] = (cid, cp, n_rb)
    rng = np.random.default_rng(seed)
    wide = wide + 0.001 * (rng.standard_normal(len(wide))
                           + 1j * rng.standard_normal(len(wide)))
    return wide, fs_in, truth


def phase_wideband(state):
    import os
    import tempfile

    from lte_cell_scanner.io.itfile import save_it
    from lte_cell_scanner.search import cli

    wide, fs_in, truth = wideband_recording()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "wide.it")
        save_it(path, {"capbuf": wide.astype(np.complex128),
                       "fc": np.array([739e6]), "fs": np.array([fs_in])})
        rc, out, wall = _run_cli(cli.main, ["-s", "731.9e6", "-e",
                                            "746.1e6", "-p", "10",
                                            "--wideband", path])
    rows = _parse_table(out)
    say("wideband CLI (15.36 Msps, the recording's whole raster, ppm 10)",
        {"rc": rc, "cells": rows, "wall_s_first_call": wall,
         "summary": [ln for ln in out.splitlines() if "carrier" in ln]})
    want = sorted((cid, {"normal": "N", "extended": "E"}[cp], n_rb)
                  for cid, cp, n_rb in truth.values())
    assert rc == 0, out
    assert sorted((r[0], r[2], r[3]) for r in rows) == want, (rows, want)


def phase_tracker(state):
    import lte_cell_scanner.tracker.batch_runtime as br
    from lte_cell_scanner.tools.bench_tracker import cycle_device_s
    from lte_cell_scanner.tracker import cli

    argv = ["-f", "739e6", "--simulate", "--blocks", "300"]
    rec, orig = {}, (br._demod_stream_jit, br._stats_jit)

    def tap_demod(*a):
        rec["demod"] = a
        return orig[0](*a)

    def tap_stats(*a):
        rec["stats"] = a
        return orig[1](*a)

    br._demod_stream_jit, br._stats_jit = tap_demod, tap_stats
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(io.StringIO()):
            dev = cli.run(argv + ["--backend", "jax", "--batch"])
        wall_dev = time.perf_counter() - t0
    finally:
        br._demod_stream_jit, br._stats_jit = orig
    with contextlib.redirect_stdout(io.StringIO()):
        host = cli.run(argv + ["--backend", "numpy"])
    ds, hs = dev.status(), host.status()
    assert len(ds["cells"]) == len(hs["cells"]) == 1, (ds, hs)
    dc, hc = ds["cells"][0], hs["cells"][0]
    # Tolerances of tests/test_batch_tracker.py (float32 device data
    # plane against the float64 host tracker).
    cmp = {"cell": (dc["n_id_cell"], hc["n_id_cell"]),
           "mib_successes": (dc["mib_successes"], hc["mib_successes"]),
           "frequency_offset_diff_hz": abs(ds["frequency_offset"]
                                           - hs["frequency_offset"]),
           "frame_timing_diff": abs(dc["frame_timing"]
                                    - hc["frame_timing"])}
    say("tracker CLI --batch jax vs numpy (300 blocks)",
        {**cmp, "wall_s_jax_first_run": wall_dev})
    assert dc["n_id_cell"] == hc["n_id_cell"] == 271
    assert (dc["n_ports"], dc["cp_type"], dc["n_rb_dl"]) == \
        (hc["n_ports"], hc["cp_type"], hc["n_rb_dl"])
    assert dc["mib_successes"] == hc["mib_successes"] > 0
    assert cmp["frequency_offset_diff_hz"] < 2.0
    assert cmp["frame_timing_diff"] < 0.1
    say("timing tracker cycle (demod + stats programs, 1 cell)",
        {"device_ms": 1e3 * cycle_device_s(rec)})


def phase_floor(state):
    from lte_cell_scanner.tools.mc_search import (FLOOR_MAX_FALSE,
                                                  FLOOR_POINTS,
                                                  FLOOR_TRIALS, run_mc)

    for snr, min_det, min_mib in FLOOR_POINTS:
        st = run_mc(FLOOR_TRIALS, snr, backend="jax", seed=int(-snr),
                    ppm=10.0, verbose=0)
        say(f"detection floor {snr} dB", {
            "trials": st.trials, "detections": st.detections,
            "mib": st.mib_successes, "false_cells": st.false_cells,
            "min_detections": min_det, "min_mib": min_mib})
        assert st.detections >= min_det and st.mib_successes >= min_mib
        assert st.false_cells <= FLOOR_MAX_FALSE


def phase_four_cards(state):
    from lte_cell_scanner.parallel.multichip_checks import \
        check_pipelined_sweep_multidevice

    caps, fcs, fset, _ = state["band"]
    t0 = time.perf_counter()
    n = check_pipelined_sweep_multidevice(4, caps=caps, fcs=fcs, fset=fset,
                                          batch=SWEEP_BATCH)
    say("four-card sweep vs one card (cap mesh, pipelined, "
        f"{len(fcs)} carriers)", {"cells_bit_identical": n,
                                  "wall_s_both_runs": time.perf_counter()
                                  - t0})


def run(phases, state) -> list:
    failed = []
    for name, fn in phases:
        t0 = time.perf_counter()
        try:
            fn(state)
            say(f"phase {name} ok", {"wall_s": time.perf_counter() - t0})
        except Exception:                      # report, then go on
            traceback.print_exc()
            print(f"phase {name} FAILED", flush=True)
            failed.append(name)
    return failed


def main(argv=None) -> int:
    global CARD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, choices=(1, 4), default=1,
                    help="4: run only the four-card sweep and its "
                         "one-card comparison")
    args = ap.parse_args(argv)

    from lte_cell_scanner import platform

    device = platform.require_gpu()           # exits: no CPU fallback
    if device["count"] < args.cards:
        sys.exit(f"--cards {args.cards}: only {device['count']} GPU(s)")
    card_lines = platform.card_name_and_power()
    CARD = "; ".join(card_lines.splitlines())
    print(card_lines, flush=True)
    say("device", device)

    t0 = time.perf_counter()
    state = {"band": band_inputs()}
    say("set-up: band inputs generated",
        {"carriers": BAND_CARRIERS, "occupied": BAND_OCCUPIED,
         "wall_s": time.perf_counter() - t0})
    if args.cards == 4:
        phases = [("four_cards", phase_four_cards)]
    else:
        phases = [("precision", phase_precision),
                  ("timings", phase_timings), ("1_search", phase_search),
                  ("2_sweep", phase_sweep), ("3_wideband", phase_wideband),
                  ("4_tracker", phase_tracker), ("5_floor", phase_floor)]
    failed = run(phases, state)
    if failed:
        print(f"chip_smoke: phases failed: {failed}", file=sys.stderr)
        return 1
    print(card_lines, flush=True)
    print(result_line(device), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

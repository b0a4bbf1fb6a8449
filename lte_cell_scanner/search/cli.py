"""CellSearch command-line interface.

reference: src/CellSearch.cpp:92-280 (argument parsing + sanity checks)
and :437-618 (the sweep driver + result table with the crystal correction
factor).

Usage examples:
    python -m lte_cell_scanner.search.cli \
        --freq-start 739e6 --load --data-dir /root/reference/test
    python -m lte_cell_scanner.search.cli \
        --freq-start 739e6 --simulate --backend jax
"""

from __future__ import annotations

import argparse
import sys
import time


from lte_cell_scanner.io.capture import CaptureSource
from lte_cell_scanner.search.cell_search import (
    cell_search,
    dedup,
    generate_search_sets,
)
from lte_cell_scanner.utils.dsp import db10


def freq_formatter(freq: float) -> str:
    """Compact frequency with unit suffix (reference: CellSearch.cpp:322)."""
    for limit, div, suffix in ((998.0, 1.0, "h"), (998e3, 1e3, "k"),
                               (998e6, 1e6, "m"), (998e9, 1e9, "g")):
        if abs(freq) < limit:
            return f"{freq / div:5.3g}{suffix}"
    return str(freq)


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="CellSearch",
        description="Search a range of frequencies for LTE cells.")
    p.add_argument("-s", "--freq-start", type=float, required=True,
                   help="frequency where the search should start (Hz)")
    p.add_argument("-e", "--freq-end", type=float, default=None,
                   help="frequency where the search should end "
                        "(default: freq-start)")
    p.add_argument("-p", "--ppm", type=float, default=120,
                   help="crystal remaining frequency error (ppm, default 120)")
    p.add_argument("-c", "--correction", type=float, default=1.0,
                   help="crystal correction factor from a previous run")
    p.add_argument("-r", "--record", action="store_true",
                   help="record captured data to data-dir")
    p.add_argument("-l", "--load", action="store_true",
                   help="load captured data from data-dir instead of the SDR")
    p.add_argument("--simulate", action="store_true",
                   help="use the built-in eNodeB simulator as the capture "
                        "source")
    p.add_argument("-d", "--data-dir", default=".",
                   help="directory for recorded/loaded captures")
    p.add_argument("-i", "--device-index", type=int, default=0,
                   help="SDR device index (live capture only)")
    p.add_argument("-v", "--verbose", action="count", default=1)
    p.add_argument("-b", "--brief", action="store_true",
                   help="only print the final result table")
    p.add_argument("--backend", choices=("numpy", "jax"), default="jax",
                   help="compute backend for the PSS scan (default jax)")
    p.add_argument("--interp", choices=("hex", "freq_time", "2stage"),
                   default="hex", help="channel-estimate interpolator")
    p.add_argument("--batch-sweep", action="store_true",
                   help="capture the whole sweep first, then scan it "
                        "data-parallel across devices and decode every "
                        "candidate in two batched dispatches (jax "
                        "backend; highest throughput, deferred output)")
    p.add_argument("--sweep-batch", type=int, default=0, metavar="N",
                   help="with --batch-sweep: process the sweep as a "
                        "software pipeline over chunks of N captures "
                        "(search/pipeline.py) instead of one whole-"
                        "sweep dispatch — uploads, scans and the "
                        "decode chain of adjacent chunks overlap, and "
                        "only N captures are device-resident at a "
                        "time (long sweeps; 0 = single dispatch)")
    p.add_argument("--wideband", metavar="FILE", default=None,
                   help="search a single wideband .it recording (fs an "
                        "integer multiple of 1.92 Msps, fc field = band "
                        "center): every raster carrier in "
                        "[freq-start, freq-end] is channelized out of "
                        "the one capture and swept data-parallel")
    p.add_argument("--fs-in", type=float, default=None,
                   help="wideband recording's sample rate (Hz; default: "
                        "the .it file's fs field, if the recording "
                        "carries one)")
    p.add_argument("--wideband-rtl-sdr", action="store_true",
                   help="the --wideband file is raw uint8 IQ (rtl_sdr "
                        "format) instead of .it; requires --fc-center")
    p.add_argument("--fc-center", type=float, default=None,
                   help="wideband recording's center frequency (Hz; "
                        "required for raw recordings, overrides the .it "
                        "file's fc field otherwise)")
    return p


def validate(args) -> None:
    if args.freq_end is None:
        args.freq_end = args.freq_start
    if args.freq_end < args.freq_start:
        sys.exit("Error: end frequency must be >= start frequency")
    if args.record and args.load:
        sys.exit("Error: record and load are mutually exclusive")
    if args.ppm < 0:
        sys.exit("Error: ppm must be non-negative")
    # Round to the 100 kHz raster like the reference.
    for name in ("freq_start", "freq_end"):
        f = getattr(args, name)
        r = round(f / 100e3) * 100e3
        if r != f:
            print(f"Warning: {name.replace('_', ' ')} rounded to the "
                  f"100 kHz raster: {r / 1e6:.4g} MHz")
            setattr(args, name, r)


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    validate(args)
    verbosity = 0 if args.brief else args.verbose

    fc_search_set, f_search_set = generate_search_sets(
        args.freq_start, args.freq_end, args.ppm)
    if verbosity >= 2:
        print(f"Searching {len(fc_search_set)} center frequencies x "
              f"{len(f_search_set)} offset hypotheses")

    if args.wideband:
        return _wideband_sweep(args, f_search_set, verbosity)

    if args.simulate:
        source = CaptureSource("simulator", data_dir=args.data_dir,
                               record=args.record)
    elif args.load:
        source = CaptureSource("file", data_dir=args.data_dir)
    else:
        source = CaptureSource("rtlsdr", data_dir=args.data_dir,
                               record=args.record,
                               correction=args.correction)

    if args.batch_sweep:
        if args.backend != "jax":
            sys.exit("Error: --batch-sweep requires --backend jax (the "
                     "batched sweep is the device data-parallel path)")
        return _batched_sweep(args, source, fc_search_set, f_search_set,
                              verbosity)

    all_cells = []
    for fc_requested in fc_search_set:
        if verbosity >= 1:
            print(f"Examining center frequency {fc_requested / 1e6:.4g} MHz ...")
        t0 = time.time()
        try:
            capbuf, fc_programmed = source.capture(fc_requested)
        except FileNotFoundError as e:
            sys.exit(f"Error: no recorded capture to load: {e.filename}")
        cells = cell_search(capbuf, fc_requested, fc_programmed,
                            f_search_set=f_search_set, backend=args.backend,
                            interp=args.interp, verbose=verbosity)
        if verbosity >= 2:
            print(f"  ({time.time() - t0:.2f}s)")
        all_cells.extend(cells)

    return print_results(dedup(all_cells), args.correction)


def print_results(cells_final, correction: float) -> int:
    if not cells_final:
        print("No LTE cells were found...")
        return 1

    print("Detected the following cells:")
    print("A: #antenna ports C: CP type ; P: PHICH duration ; "
          "PR: PHICH resource type")
    print("CID A      fc   foff RXPWR C nRB P  PR CrystalCorrectionFactor")
    for c in cells_final:
        cp = {"normal": "N", "extended": "E"}.get(c.cp_type, "U")
        ph = {"normal": "N", "extended": "E"}.get(c.phich_duration, "U")
        pr = {1 / 6: "1/6", 1 / 2: "1/2", 1.0: "one", 2.0: "two"}.get(
            c.phich_resource, "UNK")
        crystal_actual = c.fc_requested - c.freq_superfine
        correction_new = correction * (c.fc_requested / crystal_actual)
        print(f"{c.n_id_cell():3d} {c.n_ports:1d} "
              f"{c.fc_requested / 1e6:6.5g}M {freq_formatter(c.freq_superfine)} "
              f"{db10(c.pss_pow):5.3g} {cp} {c.n_rb_dl:3d} {ph} {pr} "
              f"{correction_new:.20g}")
    return 0


def _wideband_sweep(args, f_search_set, verbosity: int) -> int:
    """One wideband recording -> every raster carrier in range, swept
    data-parallel (search/wideband.py)."""
    import numpy as np

    from lte_cell_scanner.io import load_it
    from lte_cell_scanner.search.wideband import (wideband_carriers,
                                                  wideband_search_sweep)

    if args.wideband_rtl_sdr:
        # Raw uint8 IQ (the dongle's native file format) carries no
        # metadata: rate and center frequency come from the command
        # line.
        if args.fs_in is None:
            sys.exit("Error: --wideband-rtl-sdr requires --fs-in (the "
                     "recording's sample rate in Hz)")
        if args.fc_center is None:
            sys.exit("Error: --wideband-rtl-sdr requires --fc-center")
        from lte_cell_scanner.io.raw import load_rtl_sdr

        wide = load_rtl_sdr(args.wideband, fs=args.fs_in)
        fc_center = args.fc_center
    else:
        d = load_it(args.wideband)
        wide = d["capbuf"]
        if args.fs_in is None and "fs" in d:
            args.fs_in = float(np.asarray(d["fs"]).ravel()[0])
        if args.fs_in is None:
            sys.exit("Error: --wideband requires --fs-in (the recording "
                     "carries no fs field)")
        fc_center = (args.fc_center if args.fc_center is not None
                     else float(np.asarray(d["fc"]).ravel()[0]))
    fcs = wideband_carriers(args.fs_in, fc_center, args.freq_start,
                            args.freq_end)
    if not fcs:
        sys.exit("Error: no raster carriers of [freq-start, freq-end] "
                 "fit the recording's usable bandwidth")
    if verbosity >= 1:
        print(f"Channelizing {len(fcs)} carrier(s) out of the "
              f"{args.fs_in / 1e6:.4g} Msps recording at "
              f"{fc_center / 1e6:.4g} MHz ...")
    t0 = time.time()
    from lte_cell_scanner import platform

    # GPU: one dispatch channelizes every carrier and the narrowband
    # channels stay device-resident through the sweep. CPU: the float64
    # host channelizer.
    per_cap, deduped = wideband_search_sweep(
        wide, args.fs_in, fc_center, fcs, np.asarray(f_search_set),
        backend=platform.wideband_backend())
    if verbosity >= 1:
        for b, fc in enumerate(fcs):
            for c in per_cap[b]:
                print(f"  {fc / 1e6:.4g} MHz: cell ID {c.n_id_cell()}: "
                      f"{c.n_rb_dl} RB, {c.cp_type} CP, foff "
                      f"{c.freq_superfine:+.1f} Hz")
        print(f"  wideband sweep: {len(fcs)} carrier(s) in "
              f"{time.time() - t0:.2f}s")
    return print_results(deduped, args.correction)


def _batched_sweep(args, source, fc_search_set, f_search_set,
                   verbosity: int) -> int:
    """Whole-sweep batched path: capture everything, scan data-parallel
    over the available devices, decode every candidate of the sweep in
    two device dispatches (parallel/fc_sweep.sharded_search_sweep)."""
    import numpy as np

    from lte_cell_scanner.parallel.fc_sweep import (make_cap_mesh,
                                                    sharded_search_sweep)

    caps, fcs, fc_progs = [], [], []
    for fc_requested in fc_search_set:
        if verbosity >= 1:
            print(f"Capturing {fc_requested / 1e6:.4g} MHz ...")
        try:
            capbuf, fc_prog = source.capture(fc_requested)
        except FileNotFoundError as e:
            sys.exit(f"Error: no recorded capture to load: {e.filename}")
        caps.append(capbuf)
        fcs.append(fc_requested)
        fc_progs.append(fc_prog)
    import jax

    B = len(caps)
    t0 = time.time()
    if args.sweep_batch and B > args.sweep_batch:
        from lte_cell_scanner.search.pipeline import \
            pipelined_search_sweep

        n_shards = max(d for d in range(1, len(jax.devices()) + 1)
                       if args.sweep_batch % d == 0)
        per_cap, deduped = pipelined_search_sweep(
            np.stack(caps), fcs, np.asarray(f_search_set),
            make_cap_mesh(n_shards), batch=args.sweep_batch,
            fc_prog_list=fc_progs)
        mode = f"pipelined x{args.sweep_batch}"
    else:
        n_shards = max(d for d in range(1, len(jax.devices()) + 1)
                       if B % d == 0)
        per_cap, deduped = sharded_search_sweep(
            np.stack(caps), fcs, np.asarray(f_search_set),
            make_cap_mesh(n_shards), fc_prog_list=fc_progs)
        mode = "single dispatch"
    if verbosity >= 1:
        for b, fc in enumerate(fcs):
            for c in per_cap[b]:
                print(f"  {fc / 1e6:.4g} MHz: cell ID {c.n_id_cell()}: "
                      f"{c.n_rb_dl} RB, {c.cp_type} CP, foff "
                      f"{c.freq_superfine:+.1f} Hz")
        print(f"  sweep: {B} fc in {time.time() - t0:.2f}s "
              f"({mode}, {n_shards} device shard(s))")
    return print_results(deduped, args.correction)


if __name__ == "__main__":
    sys.exit(main())

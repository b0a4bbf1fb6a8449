"""LTE-Tracker command-line interface.

reference: src/LTE-Tracker.cpp:114-373 (CLI incl. the hidden --load /
--repeat / --drop / --rtl_sdr / --noise-power playback flags).

Usage examples:
    python -m lte_cell_scanner.tracker.cli -f 739e6 \
        --load capture.it --blocks 1000
    python -m lte_cell_scanner.tracker.cli -f 739e6 --simulate
"""

from __future__ import annotations

import argparse
import sys

import numpy as np

from lte_cell_scanner.tracker.display import render_status
from lte_cell_scanner.tracker.runtime import LTETracker, playback_source


def build_parser():
    p = argparse.ArgumentParser(
        prog="LTE-Tracker",
        description="Track and monitor LTE cells on one frequency.")
    p.add_argument("-f", "--freq-center", type=float, required=True)
    p.add_argument("-c", "--correction", type=float, default=1.0)
    p.add_argument("-p", "--ppm", type=float, default=120)
    p.add_argument("--load", help="playback: .it capture or raw rtl_sdr file")
    p.add_argument("--rtl-sdr-format", action="store_true",
                   help="loaded file is raw uint8 IQ, not .it")
    p.add_argument("--repeat", action="store_true", default=True)
    p.add_argument("--no-repeat", dest="repeat", action="store_false")
    p.add_argument("--drop", type=float, default=0.0,
                   help="seconds to drop from the start of the file")
    p.add_argument("--noise-power", type=float, default=None,
                   help="add AWGN of this power to the playback")
    p.add_argument("--simulate", action="store_true",
                   help="use the built-in eNodeB simulator as the source")
    p.add_argument("--blocks", type=int, default=None,
                   help="stop after N 10000-sample blocks (default: forever)")
    p.add_argument("--backend", choices=("numpy", "jax"), default="numpy")
    p.add_argument("--batch", action="store_true",
                   help="use the batched device tracker data plane")
    p.add_argument("--engine-every", type=int, default=1,
                   help="batched-engine dispatch cadence in 10k-sample "
                        "blocks")
    p.add_argument("--feeder", choices=("python", "native"),
                   default="python",
                   help="sample-feeder implementation (native = C++)")
    p.add_argument("--display", action="store_true",
                   help="interactive curses UI (j/k select, h/l views, "
                        "? help)")
    p.add_argument("--expert", action="store_true")
    p.add_argument("-v", "--verbose", action="count", default=1)
    for i in range(1, 10):
        # Hidden scratch debug globals, mirrored from the reference
        # (src/LTE-Tracker.cpp:52-60): free-form experiment knobs that
        # land in GlobalState.debug_g and show in the expert status.
        p.add_argument(f"--g{i}", type=float, default=0.0,
                       help=argparse.SUPPRESS)
    return p


def get_signal(args) -> np.ndarray:
    if args.simulate:
        from lte_cell_scanner.io.simulator import synthetic_capture

        return synthetic_capture(n_subframes=400, freq_offset=4e3,
                                 snr_db=15)
    if args.load:
        if args.rtl_sdr_format:
            from lte_cell_scanner.io.raw import load_rtl_sdr

            return load_rtl_sdr(args.load, drop_seconds=args.drop)
        from lte_cell_scanner.io.itfile import load_it

        d = load_it(args.load)
        sig = d["capbuf"]
        return sig[int(args.drop * 1.92e6):]
    sys.exit("Error: live SDR tracking requires --load or --simulate in "
             "this build (no dongle support compiled in)")


def main(argv=None) -> int:
    run(argv)
    return 0


def run(argv=None) -> LTETracker:
    """Everything ``main`` does (acquire, track, print status); returns
    the tracker so an in-process caller can read its final state."""
    args = build_parser().parse_args(argv)
    sig = get_signal(args)

    def on_event(kind, info):
        if args.verbose:
            print(f"[{kind}] {info}")

    trk = LTETracker(args.freq_center, backend=args.backend,
                     batch=args.batch, engine_every=args.engine_every,
                     feeder=args.feeder, on_event=on_event)
    trk.state.debug_g = tuple(getattr(args, f"g{i}")
                              for i in range(1, 10))
    try:
        trk.kalibrate(playback_source(sig, repeat=args.repeat,
                                      noise_power=args.noise_power),
                      ppm=args.ppm, correction=args.correction)
    except RuntimeError as e:
        sys.exit(f"Error: {e}")

    src = playback_source(sig, repeat=args.repeat,
                          noise_power=args.noise_power, seed=1)
    if args.display:
        from lte_cell_scanner.tracker.curses_display import run_curses

        run_curses(trk, src, max_blocks=args.blocks)
        return trk
    blocks_per_status = 200
    done = 0
    while args.blocks is None or done < args.blocks:
        n = blocks_per_status if args.blocks is None \
            else min(blocks_per_status, args.blocks - done)
        got = trk.run(src, max_blocks=n)
        done += got
        if got < n:
            break  # source exhausted
        print(render_status(trk.status(), expert=args.expert, tracker=trk))
    return trk


if __name__ == "__main__":
    sys.exit(main())

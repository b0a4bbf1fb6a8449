"""Device time of the wideband channelizer on the GPU.

Measures the per-carrier device cost of turning ONE wideband capture
into a whole fc sweep's worth of 1.92 Msps channels, for both
formulations in search/wideband.py:

- ``bank``: the one-pass filter bank (one modulated-kernel strided
  convolution + exact two-level post-rotation) — the production path;
- ``map``:  the per-carrier lax.map baseline (device time grows
  linearly with the carrier count).

Each program is compiled first (set-up time), then called back to back,
each call ended by ``block_until_ready``; the median is reported.

No reference equivalent — the reference retunes the dongle per carrier
(src/CellSearch.cpp:471-481). Refuses to run without a GPU. Usage:
    python -m lte_cell_scanner.tools.bench_wideband
        [--decim 16] [--carriers 16] [--reps 10] [--skip-map]
"""

from __future__ import annotations

import argparse
import json

import numpy as np


def measure_channelizer(make, fs_in: float, fc_center: float, fcs,
                        n_wide: int, reps: int = 10) -> dict:
    """compile_s / device_ms / memory of one channelizer formulation
    (``make`` is make_channelizer or make_channelizer_map)."""
    import jax.numpy as jnp

    from lte_cell_scanner.utils.profiling import compile_and_time

    rng = np.random.default_rng(0)
    planes = jnp.asarray(rng.standard_normal((2, n_wide)).astype(np.float32))
    run, consts, n_out = make(fs_in, fc_center, fcs, n_wide)
    res = compile_and_time(run, planes, *consts, reps=reps)
    res["n_out"] = n_out
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--decim", type=int, default=16,
                   help="decimation (fs_in = decim * 1.92 Msps)")
    p.add_argument("--carriers", type=int, default=16)
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--skip-map", action="store_true",
                   help="skip the slow per-carrier baseline")
    args = p.parse_args(argv)

    from lte_cell_scanner import platform
    from lte_cell_scanner.search.wideband import (CAPLENGTH,
                                                  make_channelizer,
                                                  make_channelizer_map)

    device = platform.require_gpu()
    fs_in = args.decim * 1.92e6
    fc_center = 750e6
    # 100 kHz-raster carriers straddling the band center.
    fcs = [fc_center + (i - args.carriers // 2) * 100e3
           for i in range(args.carriers)]
    n_wide = (CAPLENGTH + 64) * args.decim
    res = {"device": device, "card": platform.card_name_and_power(),
           "carriers": args.carriers, "decim": args.decim,
           "bank": measure_channelizer(make_channelizer, fs_in, fc_center,
                                       fcs, n_wide, args.reps)}
    res["bank_ms_per_carrier"] = res["bank"]["device_ms"] / args.carriers
    if not args.skip_map:
        res["map"] = measure_channelizer(make_channelizer_map, fs_in,
                                         fc_center, fcs, n_wide, args.reps)
    print(json.dumps(res))


if __name__ == "__main__":
    main()

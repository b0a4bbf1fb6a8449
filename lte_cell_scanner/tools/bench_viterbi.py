"""Device time of the batched tail-biting Viterbi, per variant, on the GPU.

Times the decoder variants of models/convcode_jax.py back to back in ONE
process at the production shape — B = 64 candidates x 4 frame timings x
3 port hypotheses = 768 decodes of 40 bits. Each variant is first
checked bit for bit against the host decoder (models/convcode.py), then
called repeatedly, each call ended by ``block_until_ready``; the
reported time is the median.

Variants:
  loop_gather — the XLA scan trellis with gather traceback
  loop_onehot — + one-hot traceback contractions (the default)

Reference workload: src/searcher.cpp:1438-1542 (decode_mib's per-
hypothesis viterbi loop); here it is one batched device program.

Refuses to run without a GPU. Usage:
    python -m lte_cell_scanner.tools.bench_viterbi [--reps 20]
        [--batch 768]
"""

from __future__ import annotations

import argparse
import functools
import json

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--batch", type=int, default=768)
    args = ap.parse_args(argv)

    import jax
    import jax.numpy as jnp

    from lte_cell_scanner import platform
    from lte_cell_scanner.models.convcode import (lte_conv_decode,
                                                  lte_conv_encode)
    from lte_cell_scanner.models.convcode_jax import _decode_one
    from lte_cell_scanner.utils.profiling import median_time_s

    device = platform.require_gpu()
    rng = np.random.default_rng(3)
    bits = rng.integers(0, 2, (args.batch, 40)).astype(np.uint8)
    # (B, 3, 40): encode -> BPSK -> 0 dB AWGN -> LLR (as the parity test)
    llrs = np.stack([2.0 * ((1.0 - 2.0 * lte_conv_encode(b).astype(
        np.float64)) + rng.standard_normal((3, 40))) for b in bits])
    llrs32 = jnp.asarray(llrs.astype(np.float32))
    host = np.stack([lte_conv_decode(l) for l in llrs.astype(np.float32)])

    results = {"device": device, "card": platform.card_name_and_power(),
               "precision": platform.MATMUL_PRECISION_NOTE,
               "batch": args.batch}
    for onehot_tb, key in ((False, "loop_gather"), (True, "loop_onehot")):
        fn = platform.jit(jax.vmap(functools.partial(
            _decode_one, onehot_tb=onehot_tb)))
        got = np.asarray(fn(llrs32))
        if not np.array_equal(got, host):
            raise SystemExit(f"variant {key} disagrees with the host "
                             f"decoder on {np.sum(np.any(got != host, 1))}"
                             f"/{args.batch} rows")
        results[f"{key}_ms"] = 1e3 * median_time_s(
            lambda fn=fn: jax.block_until_ready(fn(llrs32)), args.reps)
    print(json.dumps(results))


if __name__ == "__main__":
    main()

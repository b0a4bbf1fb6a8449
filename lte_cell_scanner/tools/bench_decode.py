"""Device time of the batched decode chain, per stage, on the GPU.

Times the sync program and the MIB program (ops/sync_jax.py,
ops/mib_jax.py) at the fc sweep's 64-candidate decode batch: each
program is compiled first (set-up time, with its memory_analysis()),
then called back to back, each call ended by ``block_until_ready``; the
reported time is the median over repeats. The MIB
program is additionally cut after each milestone (the ``stage``
instrumentation of ``_build_mib_device``) so the batch's device time is
attributed per stage: window gather, DFT grid, TFOEC, TOE, 4-port
channel estimation, PBCH RE extraction, LLR chain, Viterbi, full.

Workload: a seeded simulated capture (io/simulator.py, one cell at
10 dB), tiled to a 64-capture stack, one candidate per capture
(reference per-candidate chain: src/searcher.cpp:533-1692).

Refuses to run without a GPU. Usage:
    python -m lte_cell_scanner.tools.bench_decode [--reps 10]
        [--stages wins,tfg,...]   (default: all)
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np

STAGES = ("wins", "tfg", "tfoec", "toe", "chanest", "pbch", "llr", "vit",
          "full")


def _host_cells(cap, fc):
    """Host-path peaks + synced cells (the decode batch's inputs)."""
    from lte_cell_scanner.constants import DS_COMB_ARM, THRESH2_N_SIGMA
    from lte_cell_scanner.ops.peak import peak_search
    from lte_cell_scanner.ops.sync import pss_sss_foe, sss_detect
    from lte_cell_scanner.ops.xcorr import xcorr_pss
    from lte_cell_scanner.search.cell_search import detection_threshold

    fset = np.arange(-15, 16) * 5e3
    r = xcorr_pss(cap, fset, DS_COMB_ARM, fc, fc, 1.92e6, backend="numpy")
    z = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    peaks = peak_search(r.xc_incoherent_collapsed_pow,
                        r.xc_incoherent_collapsed_frq, z, fset, fc, fc,
                        r.xc_incoherent_single, DS_COMB_ARM)
    cells = []
    for p in peaks:
        h = sss_detect(dataclasses.replace(p), cap, THRESH2_N_SIGMA,
                       fc, fc, 1.92e6)
        if h.n_id_1 >= 0:
            cells.append(pss_sss_foe(h, cap, fc, fc, 1.92e6))
    return peaks, cells


def measure(b_cap: int = 64, stages=STAGES, reps: int = 10,
            seed: int = 0) -> dict:
    """Compile time, memory_analysis() and median device ms of the sync
    program and each MIB stage cut at a ``b_cap``-capture batch (one
    candidate per capture)."""
    import jax.numpy as jnp

    from lte_cell_scanner.constants import THRESH2_N_SIGMA
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.ops.mib_jax import (_dev_cell_tables, _mib_device,
                                              _pack_plan, mib_plan)
    from lte_cell_scanner.ops.sync_jax import (_pack_sync_plan,
                                               _sync_device_packed,
                                               sync_plan)
    from lte_cell_scanner.utils.profiling import compile_and_time

    fc = 739e6
    cap = synthetic_capture(seed=seed)
    peaks, cells = _host_cells(cap, fc)
    if not cells:
        raise SystemExit("no decodable cells in the capture")
    n_cap = len(cap)
    bases = [i * n_cap for i in range(b_cap)]
    mp = mib_plan([cells[0]] * b_cap, n_cap, fc, fc, 1.92e6,
                  cap_bases=bases)
    sp = sync_plan([peaks[0]] * b_cap, n_cap, fc, fc, 1.92e6,
                   cap_bases=bases)
    cap2 = np.stack([cap.real, cap.imag], -1).astype(np.float32)
    cap_flat = jnp.asarray(np.tile(cap2, (b_cap, 1)))
    sp_i32, sp_f32 = (jnp.asarray(a) for a in _pack_sync_plan(sp))
    mp_u8, mp_f32 = (jnp.asarray(a) for a in _pack_plan(mp))
    tabs = _dev_cell_tables(cells[0].cp_type)

    res = {"b_candidates": b_cap}
    res["sync"] = compile_and_time(
        _sync_device_packed, cap_flat, sp_i32, sp_f32,
        np.float32(THRESH2_N_SIGMA), reps=reps,
        n_rep=sp.pss_idx.shape[1], n_sss=sp.foe_pss.shape[-1])
    for st in stages:
        run = _mib_device(mp.n_symb_dl, mp.n_ofdm, mp.m_bit,
                          None if st == "full" else st)
        res[f"mib_{st}"] = compile_and_time(run, cap_flat, mp_u8, mp_f32,
                                            *tabs, reps=reps)
    return res


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--b-cap", type=int, default=64,
                   help="captures (= candidates) in the decode batch")
    p.add_argument("--stages", default=",".join(STAGES))
    args = p.parse_args(argv)

    from lte_cell_scanner import platform

    device = platform.require_gpu()
    card = platform.card_name_and_power()
    stages = [s for s in args.stages.split(",") if s in STAGES]
    res = measure(args.b_cap, stages, args.reps)
    print(json.dumps({"device": device, "card": card,
                      "precision": platform.MATMUL_PRECISION_NOTE, **res}))


if __name__ == "__main__":
    main()

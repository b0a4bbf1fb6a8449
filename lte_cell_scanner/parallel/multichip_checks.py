"""Multi-device parity checks for the production entry points.

The multichip dryrun covers not just the sharded scan + cap-axis DP
sweep but also the two production entry points — the pipelined sweep
driver (search/pipeline.py, the production
fc-sweep schedule mirroring src/CellSearch.cpp:471-569) and the batched
tracker engine (tracker/batch_runtime.py, mirroring
src/tracker_thread.cpp:823+). Both checks run on an N-device mesh
(virtual CPU devices in CI and the dryrun; real GPUs in a multi-card
deployment) and assert BIT-identical outputs against the single-device
path, which is itself golden/host-parity tested in CI — so multi-chip
execution is validated numerically end-to-end, not just for
compile+execute.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np


def check_pipelined_sweep_multidevice(n_devices: int,
                                      n_sweep: Optional[int] = None,
                                      verbose: bool = False,
                                      caps=None, fcs=None, fset=None,
                                      batch: Optional[int] = None) -> int:
    """Run the production pipelined fc-sweep on an ``n_devices``-wide
    ``cap`` mesh and assert the decoded cells are IDENTICAL, field for
    field, to the 1-device mesh run of the same sweep (which
    tests/test_pipeline.py pins against the whole-stack dispatch and the
    e2e anchor). The per-capture scan is data-parallel along ``cap`` and
    the batched sync/MIB dispatches read the cap-sharded capture stack
    through GSPMD, so sharding must not change a single decoded bit.

    ``caps``/``fcs``/``fset`` replace the default two-cell sweep (e.g.
    with a band-sized seeded sweep); ``batch`` is the pipeline chunk
    (default: the whole sweep in one chunk).

    Returns the number of decoded cells compared."""
    import jax

    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.parallel.fc_sweep import make_cap_mesh
    from lte_cell_scanner.search.pipeline import pipelined_search_sweep

    assert len(jax.devices()) >= n_devices, "not enough devices"
    min_cells = 1                 # a caller's sweep may hold empty carriers
    if caps is None:
        if n_sweep is None:
            # pipelined_search_sweep requires batch % cap-mesh-axis == 0;
            # default to the smallest multiple of n_devices >= 8 so the
            # check runs at ANY device count, not just divisors of 8.
            n_sweep = max(8, -(-8 // n_devices) * n_devices)
        # Two distinct planted cells alternating across the sweep,
        # offsets inside a small 5-hypothesis grid (decode load on
        # every capture).
        cap_a = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=15,
                                  freq_offset=4e3, seed=5)
        cap_b = synthetic_capture(n_id_1=30, n_id_2=0, snr_db=15,
                                  freq_offset=-6e3, n_rb_dl=75, seed=7)
        caps_c = np.stack([cap_a if i % 2 == 0 else cap_b[:len(cap_a)]
                           for i in range(n_sweep)])
        f = np.stack([caps_c.real, caps_c.imag], 1)
        caps = np.clip(np.round(f * 128.0 + 127.0), 0,
                       255).astype(np.uint8)
        fcs = [739e6 + 100e3 * i for i in range(n_sweep)]
        fset = np.arange(-2, 3) * 5e3
        min_cells = n_sweep       # every default capture carries a cell
    n_sweep = len(caps)
    batch = n_sweep if batch is None else batch
    assert batch % n_devices == 0, "batch must divide over the mesh"

    def run(mesh_n):
        per_cap, _ = pipelined_search_sweep(
            caps, fcs, fset, make_cap_mesh(mesh_n), batch=batch,
            dedup_cells=False)
        return per_cap

    want = run(1)
    got = run(n_devices)
    n_cells = sum(len(p) for p in want)
    assert n_cells >= min_cells, f"sweep under-decoded: {n_cells} cells"
    for b in range(n_sweep):
        assert len(got[b]) == len(want[b]), f"capture {b}: cell count"
        for cg, cw in zip(got[b], want[b]):
            assert dataclasses.asdict(cg) == dataclasses.asdict(cw), \
                f"capture {b}: sharded cell != single-device cell"
    if verbose:
        print(f"pipelined sweep multidevice OK: {n_sweep} captures on a "
              f"cap={n_devices} mesh, {n_cells} cells bit-identical")
    return n_cells


def _shard_cells_axis(args, leads, mesh):
    """device_put every array arg whose leading axis is one of the
    cell-derived sizes in ``leads`` (the cell bucket Cb, or Cb x ports —
    all mesh-divisible) with a P('cells') sharding; replicate everything
    else (the shared raw stream segment, triple-index plan arrays —
    GSPMD gathers the sharded rows they address)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n = mesh.devices.size
    out = []
    for a in args:
        arr = np.asarray(a)
        if arr.ndim >= 1 and arr.shape[0] in leads \
                and arr.shape[0] % n == 0:
            out.append(jax.device_put(arr, NamedSharding(mesh, P("cells"))))
        else:
            out.append(jax.device_put(arr, NamedSharding(mesh, P())))
    return out


def _mesh_divisible_cells(n_devices: int) -> int:
    """Smallest multiple of ``n_devices`` whose padded cell bucket
    (batch_runtime._bucket(c, lo=2), the engine's jit-cache axis) is
    also divisible by ``n_devices`` — the condition the cells-axis
    sharding needs. Buckets step ~1.25x on multiples of 4, so a hit
    always lands within a few steps (n=3 -> 9/12, n=5 -> 20/20,
    n=7 -> 21/28, n=16 -> 16/16)."""
    from lte_cell_scanner.tracker.batch_runtime import _bucket

    c = n_devices
    while _bucket(c, lo=2) % n_devices:
        c += n_devices
        assert c <= 64 * n_devices, "no mesh-divisible cell bucket found"
    return c


def check_tracker_cells_sharded(n_devices: int, cells: Optional[int] = None,
                                verbose: bool = False) -> dict:
    """Run one REAL batched-tracker engine cycle's demod + stats device
    programs with the cell axis sharded over an ``n_devices`` 'cells'
    mesh and assert bit-identical packed outputs vs the single-device
    dispatch. The cycle's arguments are harvested from a live engine run
    (tools/bench_tracker machinery: real acquisition, real PDUs), so the
    check covers the production argument shapes — and the unsharded
    engine is itself pinned against the f64 host tracker in CI
    (tests/test_batch_tracker.py), closing the chain
    sharded == single-device == host. Reference contract:
    src/tracker_thread.cpp:823+ (one thread per cell -> here one mesh
    shard per cell group)."""
    import jax
    from jax.sharding import Mesh

    import lte_cell_scanner.tracker.batch_runtime as br
    from lte_cell_scanner.tools.bench_tracker import _collect_pdus
    from lte_cell_scanner.tracker.state import GlobalState, TrackedCell

    assert len(jax.devices()) >= n_devices, "not enough devices"
    if cells is None:
        from lte_cell_scanner.tracker.batch_runtime import _bucket
        cells = 2 * n_devices                 # >= 2 cells per shard
        if _bucket(cells, lo=2) % n_devices:  # bucket not mesh-divisible
            cells = _mesh_divisible_cells(n_devices)
    assert cells % n_devices == 0, "cells must divide over the mesh"
    mesh = Mesh(np.array(jax.devices()[:n_devices]), ("cells",))

    pdus, raw_blocks, proto = _collect_pdus(0.25)
    state = GlobalState(fc_requested=739e6, fc_programmed=739e6,
                        fs_programmed=1.92e6, frequency_offset=4000.0)
    cs = [TrackedCell(
        n_id_cell=proto.n_id_cell, n_ports=proto.n_ports,
        cp_type=proto.cp_type, n_rb_dl=proto.n_rb_dl,
        phich_duration=proto.phich_duration,
        phich_resource=proto.phich_resource,
        frame_timing=proto.frame_timing, serial_num=m,
        drop_threshold=float("inf")) for m in range(cells)]
    engine = br.BatchTrackerEngine(state)
    for blk in raw_blocks:
        engine.push_raw(blk)
    n_feed = min(len(pdus), 280)        # ~one engine cycle of symbols
    for c in cs:
        for p in pdus[:n_feed]:
            c.fifo.append(p)

    # Tap ONE cycle's real dispatch arguments (both device programs).
    rec = {}
    orig = (br._demod_stream_jit, br._stats_jit)

    def tap_demod(*a):
        rec["demod"] = a
        return orig[0](*a)

    def tap_stats(*a):
        rec["stats"] = a
        return orig[1](*a)

    br._demod_stream_jit = tap_demod
    br._stats_jit = tap_stats
    try:
        engine.process_all(cs)
    finally:
        br._demod_stream_jit, br._stats_jit = orig
    assert "demod" in rec and "stats" in rec, "engine cycle never ran"

    # --- demod program: cells axis = every arg with leading dim Cb.
    da = rec["demod"]
    Cb = np.asarray(da[1]).shape[0]     # starts: (Cb, S)
    assert Cb % n_devices == 0, f"cell bucket {Cb} not mesh-divisible"
    leads = {Cb, 2 * Cb, 4 * Cb}        # Cb and Cb x n_ports variants
    flat_1, ce_1 = br._demod_stream_jit(*da)
    flat_1, ce_1 = np.asarray(flat_1), np.asarray(ce_1)
    with mesh:
        flat_n, ce_n = br._demod_stream_jit(
            *_shard_cells_axis(da, leads, mesh))
        flat_n, ce_n = np.asarray(flat_n), np.asarray(ce_n)
    np.testing.assert_array_equal(flat_n, flat_1)
    np.testing.assert_array_equal(ce_n, ce_1)

    # --- stats program: the cell-state tensors (carried raw-CE rows,
    # the fresh CE from demod, the per-(cell,port) td history) shard
    # over 'cells'; the triple-index plan arrays stay replicated and
    # GSPMD gathers the sharded rows they address.
    sa = rec["stats"]
    n_seg = sa[-1]
    T = np.asarray(sa[2]).shape[0]      # tri: (T, 3)
    stats_in = list(sa[:-1])
    flat2_1, hist_1 = br._stats_jit(*stats_in, n_seg=n_seg)
    flat2_1, hist_1 = np.asarray(flat2_1), np.asarray(hist_1)
    with mesh:
        sharded = _shard_cells_axis(stats_in, leads, mesh)
        flat2_n, hist_n = br._stats_jit(*sharded, n_seg=n_seg)
        flat2_n, hist_n = np.asarray(flat2_n), np.asarray(hist_n)
    # The device-resident td history (engine state the next cycle
    # consumes) must be bit-identical; the packed stats payload is
    # >=99% bit-identical NaN-aware (padded triples carry NaN lanes on
    # both sides), with the residual confined to the td/carry
    # DIAGNOSTIC lanes at <=~1.2e-2 relative — GSPMD partitioning
    # changes the f32 fusion/vectorization order there. Measured: the
    # feedback-critical foe/delay lanes stay exact.
    np.testing.assert_array_equal(hist_n, hist_1)
    eq = (flat2_n == flat2_1) | (np.isnan(flat2_n) & np.isnan(flat2_1))
    exact = float(np.mean(eq))
    assert exact >= 0.99, f"stats payload exact fraction {exact:.4f}"
    np.testing.assert_allclose(flat2_n.astype(np.float64),
                               flat2_1.astype(np.float64),
                               rtol=2e-2, atol=2e-3, equal_nan=True)
    if verbose:
        print(f"tracker cells-sharded OK: {cells} cells (bucket {Cb}) on "
              f"a cells={n_devices} mesh, demod+stats bit-identical")
    return {"cells": cells, "bucket": Cb, "triples": int(T)}

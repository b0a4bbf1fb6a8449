"""Pipelined fc-sweep driver: the production cell search as a software
pipeline over fixed-size capture batches.

The reference's outer loop is strictly serial per center frequency —
capture, scan, then the per-peak decode chain
(src/CellSearch.cpp:471-569). This driver runs the sweep as a deep
software pipeline over chunks of ``batch`` captures, so host work,
host<->device copies and device programs of adjacent chunks overlap:

  - an uploader thread copies chunk i+1's raw radio bytes to the device
    while the device scans chunk i;
  - the scan's peak TABLES are returned as a device array with their
    D2H copy started at dispatch (fc_sweep.sharded_fc_sweep
    ``return_tables``) and collected one chunk later;
  - the batched sync dispatch (ops/sync_jax) is deferred the same way
    (``defer_sync``), unblocking the MIB planning;
  - the batched MIB decode (ops/mib_jax) is always deferred and
    collected last.

Results are BIT-IDENTICAL to parallel/fc_sweep.sharded_search_sweep on
the same captures (same float64 host planning, same device programs —
only the schedule differs); tests/test_pipeline.py pins that parity.
The schedule's stage order was tuned on an earlier deployment; it has
not been re-measured on the GPU.
"""

from __future__ import annotations

import dataclasses
from concurrent.futures import ThreadPoolExecutor
from typing import List, Sequence

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.parallel.fc_sweep import (capture_stack,
                                                sharded_fc_sweep,
                                                tables_to_peaks)


@dataclasses.dataclass
class _Chunk:
    """One capture batch in flight through the pipeline stages."""

    lo: int                 # global index of this chunk's first capture
    n_real: int             # un-padded capture count
    fcs: List[float]
    fcp: List[float]
    idx: List[int]          # capture rows (last repeated to pad)
    tables_dev: object = None
    flat: object = None     # device (batch*n_cap, 2) f32 capture stack
    cells: List[Cell] = None
    bases: List[int] = None
    sync_pending: object = None
    mib_pendings: list = None
    mib_groups: list = None


def pipelined_search_sweep(capbufs, fc_list: Sequence[float],
                           f_search_set: np.ndarray, mesh: Mesh,
                           batch: int = 64,
                           fs_programmed: float = 1.92e6,
                           thresh2_n_sigma: float = None,
                           dedup_cells: bool = True,
                           fc_prog_list: Sequence[float] = None,
                           defer_sync: bool = True):
    """Full cell search of a whole fc sweep, pipelined in ``batch``-sized
    chunks. Same contract and results as
    parallel/fc_sweep.sharded_search_sweep; built for long sweeps where
    one whole-sweep dispatch would serialize the copy of every capture
    before any compute (and hold every capture on device at once).

    ``capbufs``: (B, 2, n_cap) uint8 radio planes or complex (B, n_cap).
    ``batch`` must be a multiple of the mesh's ``cap`` axis; the last
    chunk is padded by repeating its final capture (padded rows are
    dropped, and every chunk reuses one compiled program).

    ``defer_sync=False`` collapses the deferred-sync stage (one fewer
    chunk of pipeline depth, one blocking fetch more per chunk) — the
    profitable setting depends on the host<->device round-trip latency.
    """
    from lte_cell_scanner.constants import THRESH2_N_SIGMA
    from lte_cell_scanner.ops.mib_jax import (decode_mib_batch,
                                              finish_mib_batch)
    from lte_cell_scanner.ops.sync_jax import (finish_sync_batch,
                                               sss_foe_batch)
    from lte_cell_scanner.search.cell_search import dedup

    if thresh2_n_sigma is None:
        thresh2_n_sigma = THRESH2_N_SIGMA
    capbufs = np.asarray(capbufs)
    if capbufs.ndim == 3:
        B_tot, _, n_cap = capbufs.shape
    else:
        B_tot, n_cap = capbufs.shape
        capbufs = np.stack([capbufs.real, capbufs.imag],
                           1).astype(np.float32)
    if B_tot == 0:
        return [], []
    n_shards = mesh.shape["cap"]
    if batch % n_shards:
        raise ValueError(f"batch={batch} not divisible by cap shards "
                         f"{n_shards}")
    if B_tot < batch:
        # Shrink to the sweep size, rounded UP to a shard multiple (the
        # short chunk pads by repeating its last capture anyway).
        batch = -(-B_tot // n_shards) * n_shards
    fcp_all = (list(fc_list) if fc_prog_list is None
               else list(fc_prog_list))
    shard = NamedSharding(mesh, P("cap"))

    def make_chunk(ci: int) -> _Chunk:
        lo = ci * batch
        hi = min(lo + batch, B_tot)
        idx = list(range(lo, hi)) + [hi - 1] * (batch - (hi - lo))
        return _Chunk(lo=lo, n_real=hi - lo,
                      fcs=[fc_list[i] for i in idx],
                      fcp=[fcp_all[i] for i in idx],
                      idx=idx)

    n_chunks = -(-B_tot // batch)
    chunks = [make_chunk(ci) for ci in range(n_chunks)]
    # Deep mode defers the TABLES fetch a chunk too (device_put returns
    # before the bytes land, so a chunk's upload only truly completes
    # mid-iteration; reading the PREVIOUS chunk's tables waits on
    # almost nothing): scan -> tables -> sync -> MIB each one chunk
    # apart = 4-deep.
    depth = 4 if defer_sync else 2
    per_cap: List[List[Cell]] = [[] for _ in range(B_tot)]
    all_good: List[Cell] = []

    def stage_scan(c: _Chunk, dev):
        c.tables_dev = sharded_fc_sweep(
            dev, c.fcs, f_search_set, mesh, fs_programmed,
            fc_prog_list=c.fcp, return_tables=True)
        c.flat = capture_stack(dev)

    def stage_tables(c: _Chunk):
        """Fetch the scan tables + host peak planning (a D2H round
        trip — runs in the fetch phase, before the next upload)."""
        # Only the n_real rows are converted (padded repeats would waste
        # a host-rescan fallback); the captures go as a lazy accessor so
        # the rare fallback doesn't cost a multi-MB copy per chunk.
        peaks = tables_to_peaks(np.asarray(c.tables_dev)[:c.n_real],
                                lambda b: capbufs[c.idx[b]],
                                c.fcs[:c.n_real],
                                f_search_set, fs_programmed,
                                fc_prog_list=c.fcp[:c.n_real])
        c.tables_dev = None
        c.cells, c.bases = [], []
        for b in range(c.n_real):
            for cell in peaks[b]:
                c.cells.append(cell)
                c.bases.append(b * n_cap)

    def stage_sync_dispatch(c: _Chunk):
        c.sync_pending = sss_foe_batch(
            c.cells, None, 0.0, 0.0, fs_programmed, thresh2_n_sigma,
            cap_dev=c.flat, n_cap=n_cap, cap_bases=c.bases,
            defer=defer_sync)

    def stage_sync_collect(c: _Chunk):
        c.sync_pending = finish_sync_batch(c.sync_pending)

    def stage_mib(c: _Chunk):
        synced = c.sync_pending       # collected (or non-deferred) cells
        c.sync_pending = None
        alive = [(cell, base) for cell, base in zip(synced, c.bases)
                 if cell.n_id_1 >= 0]
        c.mib_pendings, c.mib_groups = [], []
        for cp in ("normal", "extended"):
            grp = [(cell, base) for cell, base in alive
                   if cell.cp_type == cp]
            if grp:
                c.mib_pendings.append(decode_mib_batch(
                    [cell for cell, _ in grp], None, 0.0, 0.0,
                    fs_programmed, cap_dev=c.flat, n_cap=n_cap,
                    cap_bases=[base for _, base in grp], defer=True))
                c.mib_groups.append([base for _, base in grp])
        c.flat = None                  # capture stack no longer needed

    def stage_collect(c: _Chunk):
        for pending, bases in zip(c.mib_pendings, c.mib_groups):
            for cell, base in zip(finish_mib_batch(pending), bases):
                if cell.n_rb_dl >= 0:
                    per_cap[c.lo + base // n_cap].append(cell)
                    all_good.append(cell)
        c.mib_pendings = c.mib_groups = None

    # Stage order within an iteration: drain EVERY pending fetch first,
    # then start the next chunk's upload (in eight pieces, so the decode
    # plans' small uploads can interleave), then issue the async decode
    # dispatches under it.
    with ThreadPoolExecutor(1) as ex, ThreadPoolExecutor(3) as fex:
        def put(ci):
            a = capbufs[chunks[ci].idx]
            step = a.shape[0] // 8
            if step and a.shape[0] % 8 == 0 and step % n_shards == 0:
                parts = [jax.device_put(a[k * step:(k + 1) * step],
                                        shard) for k in range(8)]
                return jnp.concatenate(parts, axis=0)
            return jax.device_put(a, shard)

        stage_scan(chunks[0], put(0))    # pipeline fill
        fut = None
        for i in range(n_chunks + depth - 1):
            ti = i - 1 if defer_sync else i    # chunk whose tables land
            # ---- fetch phase (no upload in flight). The pending
            # fetches (tables, sync, MIB) are INDEPENDENT device
            # arrays: issue them concurrently.
            jobs = []
            if 0 <= ti < n_chunks:
                jobs.append(fex.submit(stage_tables, chunks[ti]))
            if defer_sync and 0 <= ti - 1 < n_chunks:
                jobs.append(fex.submit(stage_sync_collect,
                                       chunks[ti - 1]))
            j = i - (depth - 1)
            if 0 <= j < n_chunks:
                jobs.append(fex.submit(stage_collect, chunks[j]))
            for f in jobs:
                f.result()
            if not defer_sync and 0 <= ti < n_chunks:
                # 2-deep: the in-batch sync round trip also belongs
                # here, before the next upload starts.
                stage_sync_dispatch(chunks[ti])
            # ---- upload phase (uploader thread), THEN the dispatch
            # phase under it: the decode plans' ~630 KB of puts
            # interleave with the chunked capture upload.
            if i + 1 < n_chunks:
                fut = ex.submit(put, i + 1)
            if defer_sync and 0 <= ti < n_chunks:
                stage_sync_dispatch(chunks[ti])
            if not defer_sync and 0 <= ti < n_chunks:
                stage_mib(chunks[ti])
            if defer_sync and 0 <= ti - 1 < n_chunks:
                stage_mib(chunks[ti - 1])
            if i + 1 < n_chunks:
                stage_scan(chunks[i + 1], fut.result())

    return per_cap, (dedup(all_good) if dedup_cells else all_good)

"""Wideband cell search: one wide capture -> a whole fc sweep.

The reference tunes the dongle to every carrier in turn and captures
80 ms each (src/CellSearch.cpp:471-481) — the sweep costs
N_carriers x (tune + settle + capture) of radio time. A wideband SDR
recording (any integer multiple of 1.92 Msps, e.g. a 15.36 or
30.72 Msps full-band LTE capture) contains every carrier of the band at
once: this module channelizes it (io/frontend.py: frequency shift +
polyphase decimating FIR, one strided convolution for all carriers) and
feeds the
resulting per-carrier 1.92 Msps captures to the data-parallel sharded
sweep (parallel/fc_sweep.py), so a single 80 ms recording yields every
cell in the band. No reference equivalent — this is the device
deployment's high-throughput front end.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import numpy as np

from lte_cell_scanner import platform
from lte_cell_scanner.constants import FS_SEARCH
from lte_cell_scanner.io.frontend import PASSBAND_HZ, decimate_capture
from lte_cell_scanner.models.cell import Cell

CAPLENGTH = 153600   # the searcher's 80 ms analysis window


def channelize_batch(wide: np.ndarray, fs_in: float, fc_center: float,
                     fc_list: Sequence[float], n_out: int = None):
    """Channelize every carrier in ONE device dispatch, one conv pass.

    Filter-bank formulation: for carrier c with downshift
    w_c = 2*pi*shift_c/fs, the host path computes
        y_c[m] = sum_k h[k] * e^{-j w_c t} x[t],  t = m*decim + L-1 - k,
    which factors into a carrier-MODULATED filter plus a decimated-rate
    post-rotation:
        y_c[m] = e^{-j w_c (m*decim + L-1)}
                 * sum_{k'} (h[L-1-k'] e^{j w_c (L-1-k')}) x[m*decim+k'].
    The bracketed sum over all carriers is ONE strided real convolution
    (lhs (1, 2, n_used), rhs (2B, 2, L), stride decim) that XLA hands to
    its convolution kernels — the FIR work is shared-window batched instead of a
    per-carrier lax.map, so adding carriers only grows the matmul's
    output dimension. The post-rotation splits m = a*S + b into a two-level product of
    host-float64 tables T1[c, a] = e^{-j w_c (a*S*decim + L-1)} and
    T2[c, b] = e^{-j w_c b*decim} (exact integer-mod angles), applied as
    a broadcast complex multiply — no f32 phase accumulation anywhere
    and no periodicity assumption on the carrier grid.

    The wide capture (complex, fs_in Sps) crosses the link once as f32
    planes; identical math to io/frontend.decimate_capture (parity
    <= 2e-4, tests/test_wideband.py). Returns a device-resident
    (B, 2, n_out) f32 array of 1.92 Msps channels — ready to feed
    sharded_fc_sweep without ever fetching the narrowband data to host.
    """
    import jax.numpy as jnp

    run, consts, _ = make_channelizer(fs_in, fc_center, fc_list,
                                      len(wide), n_out)
    wide = np.asarray(wide, dtype=complex)
    planes = np.stack([wide.real, wide.imag]).astype(np.float32)
    return run(jnp.asarray(planes), *consts)


def make_channelizer(fs_in: float, fc_center: float,
                     fc_list: Sequence[float], n_wide: int,
                     n_out: int = None):
    """Build the one-pass channelizer program (see channelize_batch).

    Returns (run, consts, n_out): ``run(planes, *consts)`` is a jitted
    function of the (2, >= n_used) f32 wide planes producing the
    (B, 2, n_out) channels; ``consts`` are the device-constant tables
    (conv kernel + rotation tables). Exposed separately so benchmarks
    can chain ``run`` in a lax.scan for honest device-only timings.
    """
    import jax
    import jax.numpy as jnp

    from lte_cell_scanner.io.frontend import design_decimation_fir

    decim = fs_in / FS_SEARCH
    assert abs(decim - round(decim)) < 1e-9, "fs_in not a 1.92M multiple"
    decim = int(round(decim))
    h = design_decimation_fir(decim)
    L = len(h)
    phases = -(-L // decim)
    n_blocks = n_wide // decim
    avail = n_blocks - phases + 1
    if n_out is None:
        n_out = min(CAPLENGTH, avail)
    assert avail >= n_out, "wide capture too short"
    n_used = (n_out + phases - 1) * decim

    # Integer-Hz shifts (< 1 Hz rounding, far below the 5 kHz hypothesis
    # grid); all angle math stays in host float64 with exact integer
    # mods.
    fs_int = int(round(fs_in))
    sh_int = [int(round(fc - fc_center)) for fc in fc_list]
    B = len(sh_int)

    # --- modulated filter bank (B, L) -> conv kernel (2B, 2, L).
    kern = np.zeros((2 * B, 2, L), np.float32)
    k = np.arange(L, dtype=np.int64)
    for c, sh in enumerate(sh_int):
        ang = 2.0 * np.pi * ((sh * (L - 1 - k)) % fs_int) / fs_int
        kr = h[::-1] * np.cos(ang)
        ki = h[::-1] * np.sin(ang)
        kern[2 * c, 0], kern[2 * c, 1] = kr, -ki
        kern[2 * c + 1, 0], kern[2 * c + 1, 1] = ki, kr
    # --- two-level post-rotation tables, m = a*S + b (exact f64 angles
    # via integer mod; one f32 rounding per applied factor).
    S = 2048
    n_a = -(-n_out // S)
    t1 = np.zeros((B, n_a, 2), np.float32)
    t2 = np.zeros((B, S, 2), np.float32)
    a = np.arange(n_a, dtype=object)      # Python ints: exact products
    b = np.arange(S, dtype=object)
    for c, sh in enumerate(sh_int):
        ang1 = np.array([-2.0 * np.pi * ((sh * (ai * S * decim + L - 1))
                                         % fs_int) / fs_int for ai in a])
        ang2 = np.array([-2.0 * np.pi * ((sh * bi * decim) % fs_int)
                         / fs_int for bi in b])
        t1[c, :, 0], t1[c, :, 1] = np.cos(ang1), np.sin(ang1)
        t2[c, :, 0], t2[c, :, 1] = np.cos(ang2), np.sin(ang2)

    dn = jax.lax.ConvDimensionNumbers(lhs_spec=(0, 1, 2),
                                      rhs_spec=(0, 1, 2),
                                      out_spec=(0, 1, 2))

    @platform.jit
    def run(pl, kr, rt1, rt2):
        y = jax.lax.conv_general_dilated(
            pl[None, :, :n_used], kr, window_strides=(decim,),
            padding="VALID", dimension_numbers=dn,
            preferred_element_type=jnp.float32)[0, :, :n_out]
        y = y.reshape(B, 2, n_out)                     # (B, re/im, m)
        pad = n_a * S - n_out
        yp = jnp.pad(y, ((0, 0), (0, 0), (0, pad))).reshape(B, 2, n_a, S)
        # Two successive broadcast complex multiplies (t2 over b, then
        # t1 over a) — XLA fuses both into one elementwise pass; the
        # full (B, n_a, S) rotation field is never materialized.
        c2 = rt2[:, None, None, :, 0]                  # (B, 1, 1, S)
        s2 = rt2[:, None, None, :, 1]
        yr = yp[:, 0:1] * c2 - yp[:, 1:2] * s2
        yi = yp[:, 0:1] * s2 + yp[:, 1:2] * c2
        c1 = rt1[:, None, :, None, 0]                  # (B, 1, n_a, 1)
        s1 = rt1[:, None, :, None, 1]
        out = jnp.concatenate([yr * c1 - yi * s1, yr * s1 + yi * c1],
                              axis=1)                  # (B, 2, n_a, S)
        return out.reshape(B, 2, n_a * S)[:, :, :n_out]

    consts = (jnp.asarray(kern), jnp.asarray(t1), jnp.asarray(t2))
    return run, consts, n_out


def channelize_batch_map(wide: np.ndarray, fs_in: float, fc_center: float,
                         fc_list: Sequence[float], n_out: int = None):
    """Per-carrier lax.map channelizer — the pre-filter-bank baseline
    formulation, kept for benchmarking (tools/bench_wideband.py) and as
    an independent device cross-check of channelize_batch. Device time
    grows linearly with the carrier count; prefer channelize_batch.
    """
    import jax.numpy as jnp

    run, consts, _ = make_channelizer_map(fs_in, fc_center, fc_list,
                                          len(wide), n_out)
    wide = np.asarray(wide, dtype=complex)
    planes = np.stack([wide.real, wide.imag]).astype(np.float32)
    return run(jnp.asarray(planes), *consts)


def make_channelizer_map(fs_in: float, fc_center: float,
                         fc_list: Sequence[float], n_wide: int,
                         n_out: int = None):
    """Program builder for channelize_batch_map (same contract as
    make_channelizer)."""
    import jax
    import jax.numpy as jnp

    from lte_cell_scanner.io.frontend import design_decimation_fir

    decim = fs_in / FS_SEARCH
    assert abs(decim - round(decim)) < 1e-9, "fs_in not a 1.92M multiple"
    decim = int(round(decim))
    h = design_decimation_fir(decim)
    taps = h[::-1].copy()
    phases = -(-len(taps) // decim)
    taps = np.pad(taps, (0, phases * decim - len(taps))).reshape(
        phases, decim).astype(np.float32)
    n_blocks = n_wide // decim
    avail = n_blocks - phases + 1
    if n_out is None:
        n_out = min(CAPLENGTH, avail)
    assert avail >= n_out, "wide capture too short"
    # Integer-Hz shifts are exactly periodic with period fs/gcd, so the
    # device wraps the sample index with an exact integer mod and the
    # f32 angle stays small (see channelize_batch for the exact-table
    # successor of this trick).
    fs_int = int(round(fs_in))
    sh_int = np.round([fc - fc_center for fc in fc_list]).astype(np.int64)
    g = np.maximum(np.gcd(np.abs(sh_int), fs_int), 1)
    per = np.where(sh_int != 0, fs_int // g, 1).astype(np.int32)
    rate = (sh_int / fs_int).astype(np.float32)

    n_used = (n_out + phases - 1) * decim

    @platform.jit
    def run(pl, tp):
        t = jnp.arange(n_used, dtype=jnp.int32)

        def one(args):
            rt, pr = args
            tm = jnp.mod(t, pr).astype(jnp.float32)
            ang = (-2.0 * jnp.pi) * rt * tm
            c, s = jnp.cos(ang), jnp.sin(ang)
            xr = pl[0, :n_used] * c - pl[1, :n_used] * s
            xi = pl[0, :n_used] * s + pl[1, :n_used] * c
            xb = jnp.stack([xr, xi]).reshape(2, -1, decim)
            acc = jnp.zeros((2, n_out), jnp.float32)
            for q in range(tp.shape[0]):
                acc = acc + xb[:, q:q + n_out] @ tp[q]
            return acc

        return jax.lax.map(one, (jnp.asarray(rate), jnp.asarray(per)))

    return run, (jnp.asarray(taps),), n_out


def wideband_carriers(fs_in: float, fc_center: float,
                      freq_start: float, freq_end: float,
                      raster: float = 100e3) -> List[float]:
    """The 100 kHz-raster carriers inside [freq_start, freq_end] whose
    600 kHz occupancy fits the recording's usable bandwidth."""
    usable = fs_in / 2.0 - PASSBAND_HZ
    lo = max(freq_start, fc_center - usable)
    hi = min(freq_end, fc_center + usable)
    first = np.ceil(lo / raster) * raster
    return [float(f) for f in np.arange(first, hi + raster / 2, raster)]


def wideband_search_sweep(wide: np.ndarray, fs_in: float,
                          fc_center: float, fc_list: Sequence[float],
                          f_search_set: np.ndarray, mesh=None,
                          backend: str = "numpy", **sweep_kw
                          ) -> Tuple[List[List[Cell]], List[Cell]]:
    """Channelize ``wide`` (complex, fs_in Sps, centered at fc_center)
    at every carrier in fc_list and run the full DP sharded search
    sweep on the resulting 1.92 Msps captures.

    Returns (cells_per_carrier, deduped) like sharded_search_sweep.
    ``backend`` selects the channelizer implementation (the sweep itself
    picks its device path automatically).
    """
    import jax

    from lte_cell_scanner.parallel.fc_sweep import (
        make_cap_mesh, sharded_search_sweep)

    if backend == "jax":
        # One dispatch channelizes every carrier; the (B, 2, n) f32
        # channels stay device-resident through the sweep — the only
        # host traffic is the wide capture in and the cells out.
        capbufs = channelize_batch(wide, fs_in, fc_center, fc_list)
        B = capbufs.shape[0]
    else:
        caps = []
        for fc in fc_list:
            nb = decimate_capture(wide, fs_in, freq_shift=fc - fc_center,
                                  backend=backend)
            caps.append(nb[:CAPLENGTH])
        n = min(len(c) for c in caps)
        capbufs = np.stack([c[:n] for c in caps])
        B = len(caps)

    if mesh is None:
        n_shards = max(d for d in range(1, len(jax.devices()) + 1)
                       if B % d == 0)
        mesh = make_cap_mesh(n_shards)
    return sharded_search_sweep(capbufs, list(fc_list),
                                np.asarray(f_search_set), mesh,
                                **sweep_kw)

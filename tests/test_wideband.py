"""Wideband channelized search: one wide capture -> multi-carrier sweep.

Beyond-reference capability (search/wideband.py): a single 15.36 Msps
recording carrying two cells at different 100 kHz-raster carriers must
yield both through the channelizer + DP sharded sweep.
"""

import numpy as np

from lte_cell_scanner.constants import FS_SEARCH
from lte_cell_scanner.io.simulator import synthetic_capture
from lte_cell_scanner.search.wideband import (wideband_carriers,
                                              wideband_search_sweep)
from lte_cell_scanner.utils.dsp import interpft


def _wide_two_cells(decim=8, f_a=2.0e6, f_b=-1.5e6, seed=9):
    """Two simulated cells upconverted into one decim*1.92 Msps band."""
    a = synthetic_capture(n_id_1=90, n_id_2=1, snr_db=20, freq_offset=3e3,
                          n_subframes=90, seed=seed)
    b = synthetic_capture(n_id_1=30, n_id_2=0, snr_db=20, freq_offset=-2e3,
                          n_subframes=90, slot_start=6, sfn_start=400,
                          seed=seed + 1)
    fs_in = decim * FS_SEARCH
    wa = interpft(a, len(a) * decim)
    wb = interpft(b, len(b) * decim)
    t = np.arange(len(wa))
    wide = (wa * np.exp(2j * np.pi * f_a * t / fs_in)
            + wb * np.exp(2j * np.pi * f_b * t / fs_in))
    rng = np.random.default_rng(seed)
    wide = wide + 0.001 * (rng.standard_normal(len(wide))
                           + 1j * rng.standard_normal(len(wide)))
    return wide, fs_in


def test_wideband_carriers_raster():
    fcs = wideband_carriers(15.36e6, 739e6, 735e6, 743e6)
    assert all(abs(fc % 100e3) < 1e-6 for fc in fcs)
    # usable span: +/- (7.68 MHz - 600 kHz) around center
    assert min(fcs) >= 739e6 - 7.08e6 - 1
    assert max(fcs) <= 739e6 + 7.08e6 + 1


def test_wideband_two_cell_sweep():
    wide, fs_in = _wide_two_cells()
    fc_center = 739e6
    fcs = [fc_center + 2.0e6, fc_center - 1.5e6, fc_center + 3.0e6]
    per_cap, deduped = wideband_search_sweep(
        wide, fs_in, fc_center, fcs, np.arange(-2, 3) * 5e3)
    assert [c.n_id_cell() for c in per_cap[0]] == [271]
    assert [c.n_id_cell() for c in per_cap[1]] == [90]
    assert per_cap[2] == []                     # empty carrier
    assert per_cap[0][0].n_rb_dl == 50
    assert per_cap[1][0].n_rb_dl == 50
    got = {c.n_id_cell(): c for c in deduped}
    assert set(got) == {271, 90}
    # Frequency estimates recover each cell's own offset.
    assert abs(got[271].freq_superfine - 3e3) < 50
    assert abs(got[90].freq_superfine + 2e3) < 50


def test_wideband_cli(tmp_path, capsys):
    """--wideband FILE --fs-in: the CLI channelizes the recording and
    prints the dedup'd result table."""
    from lte_cell_scanner.io.itfile import save_it
    from lte_cell_scanner.search import cli

    wide, fs_in = _wide_two_cells()
    path = str(tmp_path / "wide.it")
    save_it(path, {"capbuf": wide.astype(np.complex128),
                   "fc": np.array([739e6]),
                   "fs": np.array([fs_in])})
    # --fs-in omitted: the .it file's fs field is the documented default
    rc = cli.main(["-s", "741e6", "-p", "10", "--wideband", path])
    out = capsys.readouterr().out
    assert rc == 0
    assert "741 MHz: cell ID 271" in out
    assert "271" in out.splitlines()[-2] + out.splitlines()[-1]


def test_wideband_cli_raw_rtl_sdr(tmp_path, capsys):
    """--wideband-rtl-sdr: a raw uint8 IQ wideband recording (the
    dongle's native file format, no metadata) with --fc-center."""
    from lte_cell_scanner.io.raw import iq_to_bytes
    from lte_cell_scanner.search import cli

    wide, fs_in = _wide_two_cells()
    # Headroom so the two-cell composite survives 8-bit quantization.
    scaled = wide / (4 * np.abs(wide).std())
    path = str(tmp_path / "wide.raw")
    iq_to_bytes(scaled).tofile(path)
    rc = cli.main(["-s", "741e6", "-p", "10",
                   "--wideband", path, "--wideband-rtl-sdr",
                   "--fs-in", str(fs_in), "--fc-center", "739e6"])
    out = capsys.readouterr().out
    assert rc == 0
    assert "741 MHz: cell ID 271" in out


def test_channelize_batch_matches_host():
    """The one-dispatch device channelizer tracks the float64 host
    channelizer (f32 + wrapped-phase rotation) per carrier."""
    from lte_cell_scanner.io.frontend import decimate_capture
    from lte_cell_scanner.search.wideband import channelize_batch

    wide, fs_in = _wide_two_cells()
    fcs = [739e6 + 2.0e6, 739e6 - 1.5e6, 739e6]
    dev = np.asarray(channelize_batch(wide, fs_in, 739e6, fcs))
    for i, fc in enumerate(fcs):
        host = decimate_capture(wide, fs_in,
                                freq_shift=fc - 739e6)[:dev.shape[2]]
        got = dev[i, 0] + 1j * dev[i, 1]
        scale = np.abs(host).max()
        assert np.abs(got - host).max() < 2e-4 * scale


def test_channelize_bank_matches_map():
    """The one-pass filter-bank formulation and the per-carrier lax.map
    baseline are independent device derivations of the same math."""
    from lte_cell_scanner.search.wideband import (channelize_batch,
                                                  channelize_batch_map)

    wide, fs_in = _wide_two_cells()
    fcs = [739e6 + 2.0e6, 739e6 - 1.5e6, 739e6 + 0.7e6]
    bank = np.asarray(channelize_batch(wide, fs_in, 739e6, fcs))
    base = np.asarray(channelize_batch_map(wide, fs_in, 739e6, fcs))
    scale = np.abs(base).max()
    assert np.abs(bank - base).max() < 2e-4 * scale


def test_channelize_full_band_raster():
    """Full-band one-pass channelization: a 30.72 Msps recording's
    ENTIRE 100 kHz raster (~290 carriers) goes through one conv
    dispatch, with per-carrier parity against the float64 host
    channelizer at sampled carriers (first/center/last and both
    usable-bandwidth edges)."""
    from lte_cell_scanner.io.frontend import decimate_capture
    from lte_cell_scanner.search.wideband import channelize_batch

    fs_in, fc_center = 30.72e6, 739e6
    fcs = wideband_carriers(fs_in, fc_center, fc_center - 15.36e6,
                            fc_center + 15.36e6)
    assert len(fcs) >= 190            # the full-band deployment claim
    rng = np.random.default_rng(11)
    n_wide = 40960
    wide = (rng.standard_normal(n_wide)
            + 1j * rng.standard_normal(n_wide))
    n_out = 1024
    dev = np.asarray(channelize_batch(wide, fs_in, fc_center, fcs,
                                      n_out=n_out))
    assert dev.shape == (len(fcs), 2, n_out)
    for i in (0, len(fcs) // 2, len(fcs) - 1, 1, len(fcs) - 2):
        host = decimate_capture(wide, fs_in,
                                freq_shift=fcs[i] - fc_center)[:n_out]
        got = dev[i, 0] + 1j * dev[i, 1]
        assert np.abs(got - host).max() < 2e-4 * np.abs(host).max()


def test_wideband_sweep_device_backend():
    """backend='jax': channels stay device-resident end to end."""
    wide, fs_in = _wide_two_cells()
    fcs = [739e6 + 2.0e6, 739e6 - 1.5e6]
    per_cap, deduped = wideband_search_sweep(
        wide, fs_in, 739e6, fcs, np.arange(-2, 3) * 5e3, backend="jax")
    assert [c.n_id_cell() for c in per_cap[0]] == [271]
    assert [c.n_id_cell() for c in per_cap[1]] == [90]
    assert {c.n_id_cell() for c in deduped} == {271, 90}

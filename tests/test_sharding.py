"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import jax
import numpy as np
import pytest

from lte_cell_scanner.ops.xcorr import xcorr_pss
from lte_cell_scanner.parallel import make_search_mesh, sharded_xcorr_pss
from test_xcorr_device import _synthetic_capture


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
@pytest.mark.parametrize("n_seq,n_hyp", [(8, 1), (4, 2), (2, 4)])
def test_sharded_scan_matches_reference(n_seq, n_hyp):
    cap = _synthetic_capture(n=153600, f_off=12e3)
    fset = np.arange(-4, 4) * 5e3  # 8 hypotheses, divisible by all n_hyp
    mesh = make_search_mesh(n_seq, n_hyp)

    ref = xcorr_pss(cap, fset, 2, 739e6, 739e6, 1.92e6, backend="numpy")
    out = sharded_xcorr_pss(cap, fset, 2, 739e6, 739e6, 1.92e6, mesh,
                            dtype=np.float64)

    np.testing.assert_allclose(out.xc_incoherent_collapsed_pow,
                               ref.xc_incoherent_collapsed_pow,
                               rtol=0, atol=1e-12)
    assert (out.xc_incoherent_collapsed_frq
            == ref.xc_incoherent_collapsed_frq).all()
    np.testing.assert_allclose(np.asarray(out.xc_incoherent_single),
                               np.asarray(ref.xc_incoherent_single),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(out.sp_incoherent, ref.sp_incoherent,
                               rtol=0, atol=1e-12)


@pytest.mark.skipif(len(jax.devices()) < 8, reason="needs 8 virtual devices")
def test_sharded_end_to_end_detection(capbuf_0000):
    """Sharded scan on the real capture must find the same peak."""
    from lte_cell_scanner.constants import DS_COMB_ARM
    from lte_cell_scanner.ops.peak import peak_search
    from lte_cell_scanner.search.cell_search import detection_threshold

    cap, fc = capbuf_0000
    fset = np.arange(-15, 16) * 5e3
    mesh = make_search_mesh(4, 1)
    r = sharded_xcorr_pss(cap, fset, DS_COMB_ARM, fc, fc, 1.92e6, mesh,
                          dtype=np.float64)
    z = detection_threshold(r.sp_incoherent, r.n_comb_xc)
    peaks = peak_search(r.xc_incoherent_collapsed_pow,
                        r.xc_incoherent_collapsed_frq, z, fset, fc, fc,
                        np.asarray(r.xc_incoherent_single), DS_COMB_ARM)
    assert peaks, "no peaks found on the reference capture"
    assert peaks[0].n_id_2 == 1  # cell 271/277 site transmits PSS 1
    assert peaks[0].freq == 35000.0


def test_data_parallel_fc_sweep():
    """8 captures sharded over the cap axis find the same peaks as the
    host path per capture."""
    import numpy as np

    from lte_cell_scanner.constants import DS_COMB_ARM, THRESH1_N_NINES
    from lte_cell_scanner.models.pss import pss_td
    from lte_cell_scanner.ops.peak import peak_search
    from lte_cell_scanner.ops.xcorr import xcorr_pss
    from lte_cell_scanner.parallel.fc_sweep import (make_cap_mesh,
                                                    sharded_fc_sweep)
    from lte_cell_scanner.search.cell_search import detection_threshold

    rng = np.random.default_rng(9)
    n = 48000
    fset = np.arange(-2, 3) * 5e3
    caps, fcs = [], []
    for b in range(8):
        cap = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
        n2 = b % 3
        tpl = pss_td(n2)
        t = np.arange(137)
        sh = tpl * np.exp(1j * 2 * np.pi * (b - 4) * 3e3 * t / 1.92e6)
        for k in range(300 + 700 * b, n - 137, 9600):
            cap[k:k + 137] += 0.35 * sh
        caps.append(cap)
        fcs.append(700e6 + b * 100e3)
    caps = np.stack(caps)

    mesh = make_cap_mesh(8)
    got = sharded_fc_sweep(caps, fcs, fset, mesh)

    for b in range(8):
        r = xcorr_pss(caps[b], fset, DS_COMB_ARM, fcs[b], fcs[b], 1.92e6,
                      backend="numpy")
        z = detection_threshold(r.sp_incoherent, r.n_comb_xc, DS_COMB_ARM,
                                THRESH1_N_NINES)
        want = peak_search(r.xc_incoherent_collapsed_pow,
                           r.xc_incoherent_collapsed_frq, z, fset, fcs[b],
                           fcs[b], r.xc_incoherent_single, DS_COMB_ARM)
        assert len(got[b]) == len(want) >= 1
        for a, w in zip(got[b], want):
            assert (a.n_id_2, a.ind, a.freq) == (w.n_id_2, w.ind, w.freq)


def test_fc_sweep_truncation_fallback():
    """A capture whose device peak table fills must fall back to the
    unbounded host scan instead of silently truncating (the fused
    single-capture path already does)."""
    import numpy as np

    from lte_cell_scanner.constants import DS_COMB_ARM, THRESH1_N_NINES
    from lte_cell_scanner.models.pss import pss_td
    from lte_cell_scanner.ops.peak import peak_search
    from lte_cell_scanner.ops.xcorr import xcorr_pss
    from lte_cell_scanner.parallel.fc_sweep import (make_cap_mesh,
                                                    sharded_fc_sweep)
    from lte_cell_scanner.search.cell_search import detection_threshold

    rng = np.random.default_rng(3)
    n = 48000
    fset = np.arange(-1, 2) * 5e3
    # Two PSS sequences planted far apart -> >= 2 peaks per capture.
    cap = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
    t = np.arange(137)
    for n2, base in ((0, 300), (2, 5100)):
        for k in range(base, n - 137, 9600):
            cap[k:k + 137] += 0.4 * pss_td(n2)
    caps = np.stack([cap, cap])
    fcs = [700e6, 700.1e6]

    got = sharded_fc_sweep(caps, fcs, fset, make_cap_mesh(2), max_peaks=1)
    for b in range(2):
        r = xcorr_pss(caps[b], fset, DS_COMB_ARM, fcs[b], fcs[b], 1.92e6,
                      backend="numpy")
        z = detection_threshold(r.sp_incoherent, r.n_comb_xc, DS_COMB_ARM,
                                THRESH1_N_NINES)
        want = peak_search(r.xc_incoherent_collapsed_pow,
                           r.xc_incoherent_collapsed_frq, z, fset, fcs[b],
                           fcs[b], r.xc_incoherent_single, DS_COMB_ARM)
        assert len(want) >= 2, "test capture must produce >= 2 peaks"
        assert len(got[b]) == len(want)
        for a, w in zip(got[b], want):
            assert (a.n_id_2, a.ind, a.freq) == (w.n_id_2, w.ind, w.freq)


def test_sharded_sweep_e2e_mib(capbuf_0000):
    """A 2-fc sweep through the DP sharded scan AND the batched device
    decode must produce the same cell lists (full MIB) as the host path
    per capture."""
    from lte_cell_scanner.io.simulator import synthetic_capture
    from lte_cell_scanner.parallel.fc_sweep import (make_cap_mesh,
                                                    sharded_search_sweep)
    from lte_cell_scanner.search.cell_search import cell_search

    cap0, fc0 = capbuf_0000
    cap1 = synthetic_capture(n_id_1=30, n_id_2=0, snr_db=15,
                             freq_offset=6e3, n_rb_dl=75, seed=7)
    caps = np.stack([cap0, cap1[:len(cap0)]])
    fcs = [fc0, fc0 + 100e3]
    fset = np.arange(-15, 16) * 5e3

    per_cap, deduped = sharded_search_sweep(caps, fcs, fset,
                                            make_cap_mesh(2))

    for b, fc in enumerate(fcs):
        host = cell_search(caps[b], fc, f_search_set=fset,
                           backend="numpy", interp="freq_time")
        got = sorted(per_cap[b], key=lambda c: c.n_id_cell())
        want = sorted(host, key=lambda c: c.n_id_cell())
        assert [c.n_id_cell() for c in got] == [c.n_id_cell() for c in want]
        for g, w in zip(got, want):
            assert (g.n_rb_dl, g.n_ports, g.sfn, g.cp_type) == \
                (w.n_rb_dl, w.n_ports, w.sfn, w.cp_type)
            assert abs(g.freq_superfine - w.freq_superfine) < 0.5
    assert {c.n_id_cell() for c in deduped} >= {271, 277, 90}


def test_sharded_sweep_uint8_radio_bytes(capbuf_0000):
    """uint8 (B, 2, n) radio-byte captures run the whole sharded sweep
    (scan + full MIB decode) with on-device conversion."""
    from lte_cell_scanner.parallel.fc_sweep import (make_cap_mesh,
                                                    sharded_search_sweep)

    cap0, fc0 = capbuf_0000
    planes = np.stack([cap0.real, cap0.imag])
    u8 = np.clip(np.round(planes * 128.0 + 127.0), 0, 255).astype(np.uint8)
    caps = np.stack([u8, u8])
    fcs = [fc0, fc0 + 100e3]
    fset = np.arange(-15, 16) * 5e3
    per_cap, deduped = sharded_search_sweep(caps, fcs, fset,
                                            make_cap_mesh(2))
    for b in range(2):
        assert {c.n_id_cell() for c in per_cap[b]} == {271, 277}
        assert all(c.n_rb_dl == 50 for c in per_cap[b])


def test_sharded_sweep_fc_programmed_and_duplicate_carriers(capbuf_0000):
    """fc_programmed threads through the DP sweep's k_factor arithmetic
    (parity vs the host path given the same tuner model), and duplicate
    carriers in fc_list keep their own per-capture result lists."""
    from lte_cell_scanner.parallel.fc_sweep import (make_cap_mesh,
                                                    sharded_search_sweep)
    from lte_cell_scanner.search.cell_search import cell_search

    cap0, fc0 = capbuf_0000
    caps = np.stack([cap0, cap0])
    fcs = [fc0, fc0]                        # duplicate carrier
    fcp = [fc0 * (1.0 + 5e-6)] * 2          # tuner off by 5 ppm
    fset = np.arange(-15, 16) * 5e3
    per_cap, _ = sharded_search_sweep(caps, fcs, fset, make_cap_mesh(2),
                                      fc_prog_list=fcp)
    host = cell_search(cap0, fc0, fcp[0], f_search_set=fset,
                       backend="numpy", interp="freq_time")
    want = sorted(c.n_id_cell() for c in host)
    assert want, "host path must decode cells with this tuner model"
    for b in range(2):
        got = sorted(c.n_id_cell() for c in per_cap[b])
        assert got == want
        for g, h in zip(sorted(per_cap[b], key=lambda c: c.n_id_cell()),
                        sorted(host, key=lambda c: c.n_id_cell())):
            assert g.n_rb_dl == h.n_rb_dl
            assert abs(g.freq_superfine - h.freq_superfine) < 0.5


@pytest.mark.parametrize("kind", ["uint8", "float32", "device"])
def test_fc_sweep_input_forms_match_host(kind):
    """The DP scan takes (B, 2, n) uint8 radio bytes, float planes, or a
    device-resident array (the wideband channelizer's output, the
    pipelined sweep's chunks) and converts on device; each form gives
    the host float64 peak list of the same capture."""
    import jax.numpy as jnp

    from lte_cell_scanner.constants import DS_COMB_ARM, THRESH1_N_NINES
    from lte_cell_scanner.models.pss import pss_td
    from lte_cell_scanner.ops.peak import peak_search
    from lte_cell_scanner.parallel.fc_sweep import (_to_complex,
                                                    make_cap_mesh,
                                                    sharded_fc_sweep)
    from lte_cell_scanner.search.cell_search import detection_threshold

    rng = np.random.default_rng(21)
    n = 48000
    fset = np.arange(-2, 3) * 5e3
    caps = []
    for b in range(4):
        cap = (rng.standard_normal(n) + 1j * rng.standard_normal(n)) * 0.05
        sh = pss_td(b % 3) * np.exp(
            1j * 2 * np.pi * (b - 2) * 4e3 * np.arange(137) / 1.92e6)
        for k in range(400 + 900 * b, n - 137, 9600):
            cap[k:k + 137] += 0.35 * sh
        caps.append(cap)
    planes = np.stack([np.stack([c.real, c.imag]) for c in caps])
    if kind == "uint8":
        arg = np.clip(np.round(planes * 128.0 + 127.0), 0,
                      255).astype(np.uint8)
    else:
        arg = planes.astype(np.float32)
    host_caps = _to_complex(arg)              # what the device sees
    if kind == "device":
        arg = jnp.asarray(arg)
    fcs = [739e6 + b * 100e3 for b in range(4)]
    got = sharded_fc_sweep(arg, fcs, fset, make_cap_mesh(4))
    for b in range(4):
        r = xcorr_pss(host_caps[b], fset, DS_COMB_ARM, fcs[b], fcs[b],
                      1.92e6, backend="numpy")
        z = detection_threshold(r.sp_incoherent, r.n_comb_xc, DS_COMB_ARM,
                                THRESH1_N_NINES)
        want = peak_search(r.xc_incoherent_collapsed_pow,
                           r.xc_incoherent_collapsed_frq, z, fset, fcs[b],
                           fcs[b], r.xc_incoherent_single, DS_COMB_ARM)
        assert len(got[b]) == len(want) >= 1
        for a, w in zip(got[b], want):
            assert (a.n_id_2, a.ind, a.freq) == (w.n_id_2, w.ind, w.freq)

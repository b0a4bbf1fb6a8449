"""Golden-vector parity against the reference's bundled test fixtures.

Mirrors test/test_peak_search.cpp, test/test_sss_detect.cpp and
test/test_tfg.cpp (via the Matlab/*.mat sources for the fixtures whose .it
files are missing from the reference snapshot).
"""

import os

import numpy as np
import pytest

from lte_cell_scanner.models.cell import Cell
from lte_cell_scanner.ops.peak import peak_search
from lte_cell_scanner.ops.sync import pss_sss_foe, sss_detect
from lte_cell_scanner.ops.tfg import extract_tfg, tfoec
from lte_cell_scanner.ops.pbch import decode_mib
from lte_cell_scanner.models.rs import RSDL
from conftest import reference_path


def _fixture(name):
    path = reference_path("test", name)
    if not os.path.exists(path):
        pytest.skip(f"fixture {name} not available")
    from lte_cell_scanner.io.itfile import load_it

    return load_it(path)


def test_peak_search_golden():
    d = _fixture("test_peak_search.it")
    f_search_set = d["f_search_set"].astype(np.float64)
    frq = d["xc_incoherent_collapsed_frq"] - 1  # matlab 1-based
    pow_ = d["xc_incoherent_collapsed_pow"]
    n_f = len(f_search_set)
    # The fixture has no xc_incoherent_single; the reference test replicates
    # the collapsed power across hypotheses and uses ds_comb_arm=0
    # (test/test_peak_search.cpp:69-80).
    single = np.repeat(pow_[:, :, None], n_f, axis=2)

    cells = peak_search(pow_, frq, d["Z_th1"], f_search_set,
                        739e6, 739e6, single, ds_comb_arm=0)

    assert len(cells) == len(d["peaks_pow"])
    for c, pw, ind, fq, n2 in zip(cells, d["peaks_pow"], d["peaks_ind"] - 1,
                                  d["peaks_freq"], d["peaks_n_id_2"]):
        assert abs(c.pss_pow - pw) <= 1e-6
        assert c.ind == ind
        assert c.freq == fq
        assert c.n_id_2 == n2


def test_sss_detect_and_foe_golden():
    d = _fixture("test_sss_detect.it")
    fc = float(d["fc"][0])
    th2 = float(d["thresh2_n_sigma"][0])
    cap = d["capbuf"]
    n = len(d["peaks_pow"])

    for t in range(n):
        cell = Cell(fc_requested=fc, fc_programmed=fc, fs_programmed=1.92e6,
                    pss_pow=float(d["peaks_pow"][t]),
                    ind=float(d["peaks_ind"][t] - 1),
                    freq=float(d["peaks_freq"][t]),
                    n_id_2=int(d["peaks_n_id_2"][t]))
        out, dbg = sss_detect(cell, cap, th2, fc, fc, 1.92e6,
                              want_debug=True, mode="matlab")

        # Intermediates: the reference asserts 1e-12; we allow 2e-12 of
        # FFT/summation-order noise (numpy pocketfft vs MATLAB fftw).
        for key in ("sss_h1_np_est", "sss_h2_np_est", "sss_h1_nrm_est",
                    "sss_h2_nrm_est", "sss_h1_ext_est", "sss_h2_ext_est"):
            np.testing.assert_allclose(getattr(dbg, key), d[key][t],
                                       atol=2e-12, rtol=0)

        exp_n1 = d["peaks_out_n_id_1"][t]
        if np.isfinite(exp_n1):
            assert out.n_id_1 == int(exp_n1)
            exp_cp = "normal" if d["peaks_out_cp_type"][t] == 0 else "extended"
            assert out.cp_type == exp_cp
            assert abs(out.frame_start - (d["peaks_out_frame_start"][t] - 1)) < 1e-6
            out2 = pss_sss_foe(out, cap, fc, fc, 1.92e6, mode="matlab")
            assert abs(out2.freq_fine - d["peaks_out_freq_fine"][t]) < 1e-8
        else:
            # must-NOT-detect case
            assert out.n_id_1 == -1
            assert out.cp_type == ""
            assert np.isnan(out.frame_start)


def _load_mat_tfg():
    path = reference_path("Matlab", "test_tfg.mat")
    if not os.path.exists(path):
        pytest.skip("test_tfg.mat not available")
    import h5py

    f = h5py.File(path, "r")
    cap = f["capbuf"][:, 0]
    cap = cap["real"] + 1j * cap["imag"]
    fc = float(f["fc"][0, 0])
    p = f["peaks"]
    cp_raw = p["cp_type"][:, 0]
    cp_type = "".join(chr(int(c)) for c in cp_raw)
    peak = dict(
        ind=float(p["ind"][0, 0]),
        freq=float(p["freq"][0, 0]),
        freq_fine=float(p["freq_fine"][0, 0]),
        frame_start=float(p["frame_start"][0, 0]),
        n_id_1=int(p["n_id_1"][0, 0]),
        n_id_2=int(p["n_id_2"][0, 0]),
        cp_type=cp_type,
        freq_superfine=float(p["freq_superfine"][0, 0]),
        n_rb_dl=float(p["n_rb_dl"][0, 0]),
        phich_res=float(p["phich_res"][0, 0]),
        sfn=float(p["sfn"][0, 0]),
    )
    return cap, fc, peak


def test_tfg_chain_golden():
    """extract_tfg -> tfoec -> decode_mib on the recorded fixture.

    The reference test asserts the decoded MIB has n_rb_dl == 50
    (test/test_tfg.cpp:100); we additionally check SFN, PHICH and that
    freq_superfine lands within 1 Hz of the MATLAB value.
    """
    cap, fc, peak = _load_mat_tfg()
    cell = Cell(fc_requested=fc, fc_programmed=fc, fs_programmed=1.92e6,
                ind=peak["ind"] - 1, freq=peak["freq"],
                n_id_2=peak["n_id_2"], n_id_1=peak["n_id_1"],
                cp_type=peak["cp_type"],
                frame_start=peak["frame_start"] - 1,
                freq_fine=peak["freq_fine"])
    tfg, ts = extract_tfg(cell, cap, fc, fc, 1.92e6)
    rs_dl = RSDL(cell.n_id_cell(), 6, cell.cp_type)
    cell2, tfg_comp, _ = tfoec(cell, tfg, ts, fc, fc, rs_dl)
    # (the .mat stores only the *inputs*; output fields are NaN there, so
    # only compare when the fixture actually carries a value)
    if np.isfinite(peak["freq_superfine"]):
        assert abs(cell2.freq_superfine - peak["freq_superfine"]) < 1.0
    # The residual superfine correction must be small relative to freq_fine.
    assert abs(cell2.freq_superfine - cell.freq_fine) < 200

    out = decode_mib(cell2, tfg_comp, rs_dl)
    assert out.n_rb_dl == 50
    if np.isfinite(peak["n_rb_dl"]):
        assert out.n_rb_dl == int(peak["n_rb_dl"])
        assert out.sfn == int(peak["sfn"])
        assert out.phich_resource == peak["phich_res"]


def test_e2e_capbuf_0000(capbuf_0000):
    """The reference's integration test: capbuf_0000.it must yield cell 271.

    reference: src/CMakeLists.txt:31-35 (expects 'cell ID: 271' in the
    CellSearch output on this capture) and test/test_tfg.cpp:100 (50 RB).
    """
    from lte_cell_scanner.search import cell_search, generate_search_sets

    cap, fc = capbuf_0000
    _, f_search_set = generate_search_sets(fc, fc, 120)
    cells = cell_search(cap, fc, f_search_set=f_search_set)
    ids = {c.n_id_cell() for c in cells}
    assert 271 in ids
    c271 = next(c for c in cells if c.n_id_cell() == 271)
    assert c271.n_rb_dl == 50
    assert c271.cp_type == "normal"
    assert c271.n_ports == 2
    # The capture's known frequency offset is ~+35.2 kHz.
    assert abs(c271.freq_superfine - 35231) < 50

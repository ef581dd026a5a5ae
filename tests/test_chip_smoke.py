"""chip_smoke.py's phases at tiny sizes on the CPU (interpret-mode
kernels, virtual devices): the control flow, gates and comparisons the
GPU run relies on. The phases are called directly, not through main."""

import pytest

import chip_smoke as cs

TINY = dict(cam_w=256, cam_h=128, proj_w=256, proj_h=192, gray_bits=6)
SMALL = dict(cam_w=320, cam_h=256, proj_w=256, proj_h=192, gray_bits=6)


def test_phase_parity_tiny():
    res = cs.phase_parity(**TINY)
    for name in ("f32", "uint8"):
        assert res[name]["mask_xor"] < 0.01
        assert res[name]["max_dxp"] < 1e-3
    assert res["hdr_uint8"]["hdr_mask_xor"] < 0.02


def test_phase_timing_tiny():
    res = cs.phase_timing(**TINY, stereo_wh=(256, 192), iters=1)
    for label, r in res.items():
        if label != "two_camera":
            assert r["kernel_ms"] > 0 and r["plain_ms"] > 0, label
    assert res["two_camera"]["temp_bytes"] > 0


def test_phase_four_cards_on_virtual_devices(tmp_path):
    res = cs.phase_four_cards(tmp_path, 4, **TINY)
    assert res["tiles_max_dxp"] < 1e-5
    assert res["dp_max_dpoints_mm"] < 1e-5
    assert res["ba_max_dR"] < 1e-5


def test_phase_main_path_small(tmp_path):
    res = cs.phase_main_path(tmp_path, **SMALL, scans=2,
                             stereo_wh=(512, 384))
    assert res["scan_rms_mm"] < 1.0
    assert res["stereo_rms_mm"] < 0.1
    assert res["hdr_rms_mm"] < 1.0


def test_gate_raises_on_failure(capsys):
    cs._gate("x", 0.5, 1.0)
    with pytest.raises(AssertionError, match="not < 1"):
        cs._gate("x", 2.0, 1.0)
    assert "limit < 1" in capsys.readouterr().out

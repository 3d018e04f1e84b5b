"""The two TX synthesis paths give the same detections.

At osr == 1 ``modulate`` can synthesize by closed-form per-sample sin/cos
('vpu') or by one-hot tone matmul ('mxu'); both are float32 roundings of
the same exact integer phase.  At osr > 1 only the closed form exists, so
the wide profiles compare it with the sequential float32 emulation of the
reference's genChirp (tests/oracle.py).
"""
import numpy as np
import pytest

import jax.numpy as jnp

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.ops.chirp import (
    modulate_ri)
import oracle

WIDE = [
    {"name": "sf9_bw250_osr2", "sf": 9, "bw": 250000, "cr": "4/8", "osr": 2},
    {"name": "sf12_bw500_osr4", "sf": 12, "bw": 500000, "cr": "4/5",
     "osr": 4},
]


@pytest.mark.parametrize("profile", L.STOCK_PROFILES,
                         ids=lambda p: p["name"])
def test_vpu_and_mxu_synthesis_detect_identically(profile):
    p = L.params_from_profile(profile)
    rng = np.random.default_rng(p.sf)
    syms = rng.integers(0, 256, (3, 12)).astype(np.int32)
    vr, vi = modulate_ri(syms, p, amplitude=0.75, method="vpu")
    mr, mi = modulate_ri(syms, p, amplitude=0.75, method="mxu")
    # both round the same exact phase to float32: a few ulps apart
    np.testing.assert_allclose(np.asarray(mr), np.asarray(vr), atol=1e-5)
    np.testing.assert_allclose(np.asarray(mi), np.asarray(vi), atol=1e-5)
    a = L.demodulate_tones(*L.dechirp(vr, vi, p), p)
    b = L.demodulate_tones(*L.dechirp(mr, mi, p), p)
    np.testing.assert_array_equal(np.asarray(a.symbols), np.asarray(b.symbols))
    np.testing.assert_array_equal(np.asarray(a.symbols),
                                  (syms * p.bw_scale) % p.n)
    np.testing.assert_array_equal(np.asarray(a.sync_word),
                                  np.asarray(b.sync_word))


@pytest.mark.parametrize("profile", WIDE, ids=lambda p: p["name"])
def test_wide_synthesis_detects_like_reference_emulation(profile):
    p = L.params_from_profile(profile, osr=profile["osr"])
    rng = np.random.default_rng(p.sf)
    syms = rng.integers(0, p.n, 4).astype(np.int32)
    vr, vi = modulate_ri(syms[None], p, method="vpu")
    ref = oracle.modulate_f32(list(syms), p.sf, p.osr, p.bw_scale)
    rr, ri = L.from_complex(ref[None])
    a = L.demodulate_wide(*L.dechirp(vr, vi, p), p)
    b = L.demodulate_wide(*L.dechirp(rr, ri, p), p)
    np.testing.assert_array_equal(np.asarray(a.symbols)[0], syms)
    np.testing.assert_array_equal(np.asarray(b.symbols)[0], syms)
    assert int(a.sync_word[0]) == int(b.sync_word[0]) == p.sync_word

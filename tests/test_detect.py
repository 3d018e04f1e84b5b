"""DFT engine and detector unit tests."""
import numpy as np
import pytest

from lora_sdr_lightweight_standalone_library_clean.ops.dft import (
    dft_ri, dft_factors)
from lora_sdr_lightweight_standalone_library_clean.ops.detect import detect_ri
from lora_sdr_lightweight_standalone_library_clean.ops.chirp import (
    downchirp_ri, modulate_ri, exact_prefix_sum_mod)
import lora_sdr_lightweight_standalone_library_clean as L


@pytest.mark.parametrize("n", [4, 128, 256, 512, 1024, 2048, 4096])
@pytest.mark.parametrize("method", ["direct", "factored"])
def test_dft_matches_numpy_fft(n, method):
    if method == "factored" and n < 8:
        pytest.skip("factorization needs composite n")
    rng = np.random.default_rng(n)
    z = (rng.standard_normal((3, n)) + 1j * rng.standard_normal((3, n))
         ).astype(np.complex64)
    xr, xi = dft_ri(z.real, z.imag, method=method)
    got = np.asarray(xr) + 1j * np.asarray(xi)
    want = np.fft.fft(z, axis=-1)
    scale = np.sqrt(n)
    assert np.max(np.abs(got - want)) / scale < 2e-4, (n, method)


def test_dft_factors():
    assert dft_factors(1024) == (32, 32)
    assert dft_factors(2048) == (64, 32)
    assert dft_factors(4096) == (64, 64)


def test_detector_first_max_tie():
    """Two equal-power bins -> lowest index wins (LoRaDetector.hpp:53)."""
    n = 16
    k1, k2 = 3, 11
    t = np.arange(n)
    z = (np.exp(2j * np.pi * k1 * t / n) + np.exp(2j * np.pi * k2 * t / n)
         ).astype(np.complex64)
    det = detect_ri(z.real[None], z.imag[None])
    assert int(det.index[0]) == k1


def test_detector_metrics():
    n = 128
    t = np.arange(n)
    z = np.exp(2j * np.pi * 7 * t / n).astype(np.complex64)
    det = detect_ri(z.real[None], z.imag[None])
    assert int(det.index[0]) == 7
    # pure tone: fundamental = N -> power = 20log10(N) - 20log10(N) = 0 dB
    assert abs(float(det.power[0])) < 0.01
    assert float(det.power_avg[0]) < -30.0  # noise floor far below
    assert abs(float(det.findex[0])) < 1e-3


def test_detector_fractional_bin():
    """Off-grid tone produces a fractional index with the right sign."""
    n = 128
    t = np.arange(n)
    z = np.exp(2j * np.pi * (7.3) * t / n).astype(np.complex64)
    det = detect_ri(z.real[None], z.imag[None])
    assert int(det.index[0]) == 7
    assert 0.05 < float(det.findex[0]) < 0.5


def test_downchirp_matches_modulator_conjugate():
    """up-chirp(0) * downchirp == DC tone (bin 0)."""
    for sf, bs in [(7, 1), (9, 2), (12, 4)]:
        p = L.LoraParams(sf=sf, bw=bs * 125000)
        re, im = modulate_ri(np.zeros((1, 1), np.int32), p)
        dcr, dci = downchirp_ri(sf, bs)
        up = np.asarray(re)[0][2 * p.n:] + 1j * np.asarray(im)[0][2 * p.n:]
        dc = dcr + 1j * dci
        tone = up * dc
        spec = np.abs(np.fft.fft(tone))
        assert int(np.argmax(spec)) == 0, (sf, bs)


def test_exact_prefix_sum_mod():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 131072, (3, 50)).astype(np.int32)
    got = np.asarray(exact_prefix_sum_mod(x, 131072))
    want = np.concatenate(
        [np.zeros((3, 1), np.int64), np.cumsum(x, axis=-1)[:, :-1]],
        axis=-1) % 131072
    np.testing.assert_array_equal(got, want)

"""stream_scan against an independent per-window complex128 np.fft reference
(tests/oracle.py::stream_scan_ref).

Argmax is compared on every window whose winning bin is clear of the
runner-up by more than 1e-3 relative power (noise windows can hold
near-ties that float32 and float64 order differently).  Power is compared
in dB: a float32 DFT of unit-scale IQ is accurate to ~1e-6 relative, i.e.
~1e-5 dB, so 1e-3 dB leaves two orders of margin.  The noise floor is
total minus peak power, which cancels where the tone dominates a window;
measured deviations reach ~4e-4 dB there, so it gets 5e-3 dB.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.parallel.streaming import (
    stream_scan)
import oracle


def _stream(p, n_sym, extra, seed):
    """Noise with one packet at a sub-stride offset; ``extra`` samples past
    the whole symbols."""
    rng = np.random.default_rng(seed)
    total = n_sym * p.step + extra
    sr = rng.standard_normal(total) * 0.05
    si = rng.standard_normal(total) * 0.05
    syms = rng.integers(0, 256, (1, 6))
    re, im = L.modulate(jnp.asarray(syms), p)
    re, im = np.asarray(re)[0], np.asarray(im)[0]
    g = p.step + 3 * p.osr
    cut = min(re.size, total - g)
    sr[g:g + cut] += re[:cut]
    si[g:g + cut] += im[:cut]
    return sr.astype(np.float32), si.astype(np.float32)


@pytest.mark.parametrize("osr", [1, 2])
@pytest.mark.parametrize("stride_div", [1, 2, 4])
@pytest.mark.parametrize("sf", [7, 8, 10])
def test_stream_scan_matches_numpy_fft(sf, stride_div, osr):
    p = L.LoraParams(sf=sf, osr=osr)
    stride = p.step // stride_div
    n_sym = 12 if sf == 10 else 21
    # a whole number of symbols, and one stride more: with stride < step
    # the window count then does not divide over the stride phases and
    # the scan pads its phase slices
    for extra in (0, stride):
        sr, si = _stream(p, n_sym, extra, seed=sf * 10 + stride_div + osr)
        got = stream_scan(jnp.asarray(sr), jnp.asarray(si), p, stride=stride)
        idx, power, noise, ratio = oracle.stream_scan_ref(
            sr, si, sf, osr, p.bw_scale, stride)
        gi, gp, ga = (np.asarray(a) for a in got)
        assert gi.shape == (sr.size // stride,)
        clear = ratio < 1.0 - 1e-3
        assert clear.mean() > 0.9
        np.testing.assert_array_equal(gi[clear], idx[clear])
        np.testing.assert_allclose(gp, power, atol=1e-3, rtol=0)
        np.testing.assert_allclose(ga, noise, atol=5e-3, rtol=0)

"""Checks that need a GPU: the float32 matmul DFT at the card's precision,
and the reference fixtures decoded on the card.  Run them on a card with
``JAX_PLATFORMS=cuda python -m pytest tests/test_gpu.py -m gpu``."""
from pathlib import Path

import numpy as np
import pytest

import jax

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.ops.dft import dft_ri

pytestmark = pytest.mark.gpu

VEC_DIR = Path(__file__).parent / "vectors"


@pytest.mark.parametrize("n", [128, 4096, 16384])
def test_dft_keeps_float32_accuracy(gpu, n):
    """HIGHEST keeps the DFT at float32 accuracy on the card; TF32 rounds
    operands to 11 significant bits, which would leave errors near 1e-4
    of the peak on random input."""
    rng = np.random.default_rng(n)
    z = rng.standard_normal((16, n)) + 1j * rng.standard_normal((16, n))
    z = z.astype(np.complex64)
    xr, xi = dft_ri(*jax.device_put((z.real, z.imag), gpu))
    want = np.fft.fft(z.astype(np.complex128), axis=-1)
    err = np.abs(np.asarray(xr) + 1j * np.asarray(xi) - want).max()
    assert err < 1e-5 * np.abs(want).max()


@pytest.mark.parametrize(
    "path", sorted(f for f in VEC_DIR.glob("ref_*.npz")
                   if not f.stem.startswith("ref_offsets")),
    ids=lambda p: p.stem)
def test_reference_demod_on_card(gpu, path):
    d = np.load(path)
    p = L.LoraParams(sf=int(d["sf"]), bw=int(d["bw"]), osr=int(d["osr"]),
                     window=str(d["window"]))
    rr, ri = jax.device_put(L.from_complex(d["iq"][None]), gpu)
    syms = np.asarray(L.demodulate(rr, ri, p).symbols)[0]
    np.testing.assert_array_equal(syms, d["demod"][: len(syms)])

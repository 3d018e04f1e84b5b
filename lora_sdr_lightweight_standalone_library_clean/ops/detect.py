"""FFT-bin symbol detector: fused power scan, argmax, noise floor, frac bin.

JAX re-design of ``include/lora_phy/LoRaDetector.hpp:16-82``.  The
reference feeds one symbol at a time through a scalar FFT then scans N bins
sequentially; here detection is a batched tensor op over arbitrarily many
symbols/packets at once: DFT (matmuls, see ops/dft.py) -> |bin|^2 ->
first-max argmax -> signal/noise dB -> 3-point fractional-bin interpolation.

Semantics parity:
 - argmax with strictly-greater compare => lowest index wins ties
   (LoRaDetector.hpp:53, SEMANTIC_COMPATIBILITY.md:11).  ``jnp.argmax``
   returns the first maximum, which matches exactly.
 - power / powerAvg in dB with 20*log10(N) scale (LoRaDetector.hpp:29,60-64).
 - fractional index from circular neighbours with divide-by-zero guard
   (LoRaDetector.hpp:66-71).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from .dft import dft_ri

__all__ = ["DetectResult", "detect_ri"]


class DetectResult(NamedTuple):
    """Per-symbol detection outputs (leading axes = batch/symbol axes)."""

    index: jnp.ndarray      # int32 argmax bin
    power: jnp.ndarray      # fundamental power, dB
    power_avg: jnp.ndarray  # average noise power, dB
    findex: jnp.ndarray     # fractional frequency offset, bins
    bin_re: jnp.ndarray     # complex value of the winning bin
    bin_im: jnp.ndarray
    mag2_max: jnp.ndarray   # |winning bin|^2 (linear) for tie-break logic


def detect_ri(zr, zi, method: str = "auto") -> DetectResult:
    """Detect the argmax bin of DFT(z) for batched symbols.

    Args:
      zr, zi: float32 (..., N) dechirped (and windowed) symbol samples.
    """
    n = zr.shape[-1]
    xr, xi = dft_ri(zr, zi, method=method)
    mag2 = xr * xr + xi * xi                                  # (..., N)

    idx = jnp.argmax(mag2, axis=-1).astype(jnp.int32)         # first max
    max_val = jnp.max(mag2, axis=-1)
    total = jnp.sum(mag2, axis=-1)

    fundamental = jnp.sqrt(max_val)
    noise = jnp.sqrt(jnp.maximum(total - max_val, 0.0))
    scale = np.float32(20.0 * np.log10(n))
    power = 20.0 * jnp.log10(fundamental) - scale
    power_avg = 20.0 * jnp.log10(noise) - scale

    # winning-bin selections as one-hot masked reductions (gather-free;
    # identical results to take_along_axis)
    onehot = jax.lax.broadcasted_iota(
        jnp.int32, mag2.shape, mag2.ndim - 1) == idx[..., None]
    oh_left = jnp.roll(onehot, -1, axis=-1)    # 1 at (idx-1) mod n
    oh_right = jnp.roll(onehot, 1, axis=-1)    # 1 at (idx+1) mod n
    zero = jnp.zeros_like(mag2)
    left = jnp.sqrt(jnp.sum(jnp.where(oh_left, mag2, zero), axis=-1))
    right = jnp.sqrt(jnp.sum(jnp.where(oh_right, mag2, zero), axis=-1))
    demon = 2.0 * fundamental - right - left
    findex = jnp.where(demon == 0.0, 0.0, 0.5 * (right - left) / demon)

    bin_re = jnp.sum(jnp.where(onehot, xr, zero), axis=-1)
    bin_im = jnp.sum(jnp.where(onehot, xi, zero), axis=-1)
    return DetectResult(idx, power, power_avg, findex, bin_re, bin_im, max_val)

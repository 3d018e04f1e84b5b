"""Matmul DFT over real/imaginary planes.

The reference uses a sequential KISS-FFT (include/lora_phy/kissfft.hh) capped
at N=4096.  Here the DFT is a batched matmul:

 - N <= 512:  one complex matmul against the dense (N, N) DFT matrix
   (4 real matmuls).
 - N >= 1024: Cooley-Tukey 4-step factorization N = N1*N2 — two matmuls
   against (N1,N1)/(N2,N2) DFT matrices plus a twiddle multiply, reducing
   arithmetic from O(N^2) to O(N*(N1+N2)).

All twiddle/DFT matrices are host-precomputed in float64 and embedded as
float32 jit constants.  Every matmul runs at HIGHEST precision: at the
default a GPU may compute float32 matmuls in TF32 (about 3 decimal digits),
and the detected power, the fractional bin and the winning bin's phase feed
the CFO estimate and the sync power gate.  Everything is batched over
arbitrary leading axes.

Replaces reference component #1 (kissfft.hh:43-316) per SURVEY.md §2.
"""
from __future__ import annotations

import functools

import numpy as np
import jax.numpy as jnp
from jax import lax

__all__ = ["dft_ri", "FACTOR_THRESHOLD", "dft_factors"]

# Above this size, use the two-stage factorized DFT.
FACTOR_THRESHOLD = 512


def dft_factors(n: int) -> tuple[int, int]:
    """Split n = n1 * n2 with factors as close to square as possible."""
    n1 = 1 << (n.bit_length() - 1) // 2
    while n1 * n1 < n:
        n1 <<= 1
    return n1, n // n1


@functools.lru_cache(maxsize=None)
def _dft_mats(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Dense DFT matrices: W[k, m] = exp(-2j*pi*k*m/n) as (cos, sin) planes."""
    k = np.arange(n, dtype=np.int64)
    # integer (k*m) % n keeps the angle argument small and exact
    ang = 2.0 * np.pi * ((k[:, None] * k[None, :]) % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _twiddle(n1: int, n2: int) -> tuple[np.ndarray, np.ndarray]:
    """Twiddles T[n2_idx, k1] = exp(-2j*pi*n2_idx*k1/(n1*n2))."""
    n = n1 * n2
    idx2 = np.arange(n2, dtype=np.int64)[:, None]
    idx1 = np.arange(n1, dtype=np.int64)[None, :]
    ang = 2.0 * np.pi * ((idx2 * idx1) % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


def _mm(eq, a, b):
    return jnp.einsum(eq, a, b, precision=lax.Precision.HIGHEST)


def _dft_direct(zr, zi, n: int):
    c, s = _dft_mats(n)
    c = jnp.asarray(c)
    s = jnp.asarray(s)
    # X = (C - iS)(zr + i zi):  Xr = zr C + zi S ; Xi = zi C - zr S
    xr = _mm("...n,nk->...k", zr, c) + _mm("...n,nk->...k", zi, s)
    xi = _mm("...n,nk->...k", zi, c) - _mm("...n,nk->...k", zr, s)
    return xr, xi


def _dft_four_step(zr, zi, n: int):
    """Cooley-Tukey: x[n1*N2 + n2] -> X[k2*N1 + k1] via two matmul stages."""
    n1, n2 = dft_factors(n)
    lead = zr.shape[:-1]
    xr = zr.reshape(lead + (n1, n2))
    xi = zi.reshape(lead + (n1, n2))

    c1, s1 = map(jnp.asarray, _dft_mats(n1))
    # Stage 1: A[n2, k1] = sum_{n1} x[n1, n2] * W1[n1, k1]
    ar = _mm("...ab,ac->...bc", xr, c1) + _mm("...ab,ac->...bc", xi, s1)
    ai = _mm("...ab,ac->...bc", xi, c1) - _mm("...ab,ac->...bc", xr, s1)

    tc, ts = map(jnp.asarray, _twiddle(n1, n2))
    # Twiddle: B = A * exp(-2j*pi*n2*k1/N)
    br = ar * tc + ai * ts
    bi = ai * tc - ar * ts

    c2, s2 = map(jnp.asarray, _dft_mats(n2))
    # Stage 2: X[k2, k1] = sum_{n2} B[n2, k1] * W2[n2, k2]
    xr2 = _mm("...bc,bd->...dc", br, c2) + _mm("...bc,bd->...dc", bi, s2)
    xi2 = _mm("...bc,bd->...dc", bi, c2) - _mm("...bc,bd->...dc", br, s2)
    return xr2.reshape(lead + (n,)), xi2.reshape(lead + (n,))


def dft_ri(zr, zi, method: str = "auto"):
    """Forward DFT of (re, im) planes along the last axis.

    ``method``: 'auto' | 'direct' | 'factored'.
    """
    n = zr.shape[-1]
    if method == "direct" or (method == "auto" and n <= FACTOR_THRESHOLD):
        return _dft_direct(zr, zi, n)
    return _dft_four_step(zr, zi, n)

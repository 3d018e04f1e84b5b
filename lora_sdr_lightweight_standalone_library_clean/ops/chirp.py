"""Chirp synthesis: closed-form, integer-exact phase — fully parallel.

JAX re-design of the reference chirp generator
(``include/lora_phy/ChirpGenerator.hpp:24-51`` and ``src/phy/LoRaMod.cpp:8-43``).

The reference integrates instantaneous frequency sample-by-sample in float32
with a carried phase accumulator — inherently sequential.  Here the entire
phase trajectory is computed in closed form with *integer* arithmetic:

For up-chirp symbol ``sym`` at sample ``n`` (``m = n+1`` frequency steps taken),
the accumulated phase is exactly::

    phi(m) = pi * bw_scale * num(m) / (N * osr^2)          (mod 2*pi)
    num(m) = -m*N*osr + 2*sym*m*osr + m*(m+1) - 2*W(m)*N*osr

where ``W(m)`` counts the total frequency-wrap subtractions
(ChirpGenerator.hpp:36,44) across the first ``m`` steps.  Because
``u_k/range = (sym*osr + k) / (N*osr)`` is an exact integer ratio, the wrap
count at step ``k`` is ``w_k = (sym*osr + k - 1) // (N*osr)`` and its prefix
sum has the closed form ``W(m) = S(c+m) - S(c)`` with
``S(t) = sum_{j<t} j//b = b*q*(q-1)/2 + q*r`` (``q = t//b``, ``r = t%b``).

No cumsum, no scan, no sequential dependency: every sample of every symbol of
every packet is an independent integer expression followed by one sin/cos.
Phase continuity across symbols (LoRaMod.cpp:14) is
carried as integer numerators mod ``2*N*osr^2``, so it is *exact*, unlike the
reference's float32 accumulator.

Valid for ``sym < 2*N`` (all real LoRa paths: Hamming(8,4) codewords are
<= 255 <= 2N for sf >= 7), matching the reference's single-subtraction wrap
behaviour.
"""
from __future__ import annotations

import functools

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..utils.config import LoraParams

__all__ = [
    "chirp_phase_numerators",
    "modulate_ri",
    "downchirp_ri",
    "exact_prefix_sum_mod",
]

PI = np.float32(np.pi)

# Factored tone synthesis above this size (mirrors ops/dft.py's DFT split).
_TX_FACTOR_THRESHOLD = 512


def _wrap_count_prefix(t, b: int):
    """S(t) = sum_{j=0}^{t-1} j // b, exact in int32."""
    q = t // b
    r = t - q * b
    return b * (q * (q - 1) // 2) + q * r


def chirp_phase_numerators(symbols, n: int, osr: int, bw_scale: int,
                           nn: int | None = None):
    """Integer phase numerators for up-chirps.

    Args:
      symbols: int32 array (..., S) of symbol values (< 2*n).
      n: base samples per symbol (2^sf).
      osr: oversampling ratio.
      bw_scale: integer bandwidth scale (1, 2, 4).
      nn: samples to generate per symbol (default n*osr).

    Returns:
      (num, delta): ``num`` int32 (..., S, nn) phase numerators mod 2*D with
      ``phi = pi * num / D`` and ``D = n * osr**2``; ``delta`` int32 (..., S)
      end-of-symbol numerators for exact phase carry.
    """
    if nn is None:
        nn = n * osr
    d = n * osr * osr
    two_d = 2 * d
    b = n * osr
    sym = jnp.asarray(symbols, jnp.int32)[..., None]          # (..., S, 1)
    m = jnp.arange(1, nn + 1, dtype=jnp.int32)                 # (nn,)
    c = sym * osr
    w = _wrap_count_prefix(c + m, b) - _wrap_count_prefix(c, b)
    num = (-m * b) + 2 * sym * m * osr + m * (m + 1) - 2 * w * b
    num = jnp.mod(num, two_d)
    num = jnp.mod(num * bw_scale, two_d)
    return num, num[..., -1]


def exact_prefix_sum_mod(delta, mod: int):
    """Exclusive prefix sum of small non-negative int32 mod ``mod``.

    The prefix sum is a matmul with a strictly-lower-triangular mask.
    Values are split into 10-bit limbs so both float32 matmuls are exact.
    """
    s = delta.shape[-1]
    tri = jnp.asarray(np.tril(np.ones((s, s), np.float32), -1))
    lo = (delta & 0x3FF).astype(jnp.float32)
    hi = (delta >> 10).astype(jnp.float32)
    # exact at any matmul precision (TF32 included): operands are 0/1 and
    # 10-bit limbs, and each float32 sum stays far below 2^24
    plo = jnp.einsum("st,...t->...s", tri, lo)
    phi_ = jnp.einsum("st,...t->...s", tri, hi)
    total = phi_.astype(jnp.int32) * 1024 + plo.astype(jnp.int32)
    return jnp.mod(total, mod)


def _with_sync_prelude(symbols, params: LoraParams):
    """Prepend the two sync-word chirp symbols (LoRaMod.cpp:20-32)."""
    sym = jnp.asarray(symbols, jnp.int32)
    sw0, sw1 = params.sync_nibble_symbols()
    sync = jnp.broadcast_to(
        jnp.asarray([sw0, sw1], jnp.int32), sym.shape[:-1] + (2,)
    )
    return jnp.concatenate([sync, sym], axis=-1)               # (..., S+2)


def modulate_ri(symbols, params: LoraParams, amplitude: float = 1.0,
                method: str = "auto"):
    """Modulate symbols into IQ planes (LoRaMod.cpp:8-43).

    Emits the two sync-word chirps followed by one up-chirp per symbol with a
    packet-wide exactly-carried phase.  Batched over any leading axes of
    ``symbols``.

    ``method``: 'auto' and 'vpu' compute the closed-form per-sample
    sin/cos phases, which measured faster on an H100 than the tone matmul
    at every SF (PERF.md); 'mxu' forces the one-hot tone matmul (osr == 1
    only).  Both are float32 roundings of the same exact integer phase —
    detection-identical (tests/test_tx_paths.py).

    Returns (re, im) float32 arrays of shape (..., (S+2) * n * osr).
    """
    if method == "mxu":
        return _modulate_ri_mxu(symbols, params, amplitude)
    n, osr, bs = params.n, params.osr, params.bw_scale
    nn = n * osr
    d = n * osr * osr
    amplitude = float(np.clip(amplitude, -1.0, 1.0))  # LoRaMod.cpp:18

    sym = jnp.asarray(symbols, jnp.int32)
    allsyms = _with_sync_prelude(sym, params)                  # (..., S+2)

    num, delta = chirp_phase_numerators(allsyms, n, osr, bs, nn)
    start = exact_prefix_sum_mod(delta, 2 * d)                  # (..., S+2)
    phi = (start[..., None] + num).astype(jnp.float32) * (PI / np.float32(d))
    re = amplitude * jnp.cos(phi)
    im = amplitude * jnp.sin(phi)
    out_shape = sym.shape[:-1] + (-1,)
    return re.reshape(out_shape), im.reshape(out_shape)


@functools.lru_cache(maxsize=None)
def _tx_base_chirp(n: int, bs: int):
    """(n,) symbol-0 base chirp ``base[m] = exp(j*pi*bs*(m*(m+1) - m*n)/n)``.

    Sample index runs m = 1..n (``genChirp`` integrates phase *before*
    emitting, ChirpGenerator.hpp:37-38, so sample 0 already has one
    frequency step).  Angle arguments are exact integer residues.
    """
    m = np.arange(1, n + 1, dtype=np.int64)
    bnum = np.mod(bs * (m * (m + 1) - m * n), 2 * n)
    bphi = np.pi * bnum.astype(np.float64) / n
    return np.cos(bphi).astype(np.float32), np.sin(bphi).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tx_tone_tables(n: int):
    """(n, n) tone tables ``w[t, m] = exp(2j*pi*t*m/n)`` at m = 1..n."""
    m = np.arange(1, n + 1, dtype=np.int64)
    t = np.arange(n, dtype=np.int64)
    ang = 2.0 * np.pi * ((t[:, None] * m[None, :]) % n) / n
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _tx_tone_tables_factored(n: int, n2: int):
    """Factored tone tables: ``w1[t1, m1] = exp(2j*pi*t1*m1/n1)`` (n1 = n/n2)
    and ``w2[t, m2] = exp(2j*pi*t*m2/n)`` so that, with m' = m mod n written
    as m' = m1*n2 + m2, ``w[t, m] = w1[t mod n1, m1] * w2[t, m2]``."""
    n1 = n // n2
    t = np.arange(n, dtype=np.int64)
    m1 = np.arange(n1, dtype=np.int64)
    m2 = np.arange(n2, dtype=np.int64)
    a1 = 2.0 * np.pi * ((t[:n1, None] * m1[None, :]) % n1) / n1
    a2 = 2.0 * np.pi * ((t[:, None] * m2[None, :]) % n) / n
    return (np.cos(a1).astype(np.float32), np.sin(a1).astype(np.float32),
            np.cos(a2).astype(np.float32), np.sin(a2).astype(np.float32))


def _tone_matmul(onehot, table):
    """Select table rows by one-hot matmul.  HIGHEST precision: at the
    default a GPU may round the float32 table to TF32 (about 5e-4 relative
    error per sample); HIGHEST keeps this path at the float32 accuracy of
    the closed-form one."""
    return jnp.einsum("...sn,nm->...sm", onehot, table,
                      precision=lax.Precision.HIGHEST)


def _modulate_ri_mxu(symbols, params: LoraParams, amplitude: float = 1.0):
    """Tone-matmul chirp synthesis (osr == 1).

    At osr == 1 the wrap-count term of the integer phase vanishes mod 2*pi
    (2*W*N = 0 mod 2N), so every chirp factors exactly into

        chirp_s[m] = sign_k * base[m] * w^(t*m),  t = (s*bs) mod n

    with ``sign_k`` the carried packet phase (delta per symbol is bs*N mod
    2N, independent of the symbol: alternating +-1 for bs odd, +1 for bs
    even).  The tone factor is a one-hot matmul against the (n, n) DFT-row
    table in place of per-sample sin/cos (the analog of the reference hot
    loop ChirpGenerator.hpp:33-48).  n >= 1024 uses the two-stage factorization
    w^(t*m) = w1^(t1*m1) * w2^(t*m2) to cut FLOPs by ~n/(n2+n1^2/n).
    """
    n, bs = params.n, params.bw_scale
    assert params.osr == 1
    amplitude = np.float32(np.clip(amplitude, -1.0, 1.0))  # LoRaMod.cpp:18

    allsyms = _with_sync_prelude(symbols, params)              # (..., S+2)
    s_total = allsyms.shape[-1]
    tone = jnp.mod(allsyms * bs, n)                            # (..., S+2)

    bc, bsn = (jnp.asarray(a) for a in _tx_base_chirp(n, bs))
    if n <= _TX_FACTOR_THRESHOLD:
        wc, ws = (jnp.asarray(a) for a in _tx_tone_tables(n))
        oh = (jax.lax.broadcasted_iota(jnp.int32, tone.shape + (n,),
                                       tone.ndim) == tone[..., None])
        ohf = oh.astype(jnp.float32)
        c = _tone_matmul(ohf, wc)
        s_ = _tone_matmul(ohf, ws)
    else:
        n2 = 128
        n1 = n // n2
        w1c, w1s, w2c, w2s = (jnp.asarray(a)
                              for a in _tx_tone_tables_factored(n, n2))
        oh1 = (jax.lax.broadcasted_iota(
            jnp.int32, tone.shape + (n1,), tone.ndim)
            == jnp.mod(tone, n1)[..., None]).astype(jnp.float32)
        ohn = (jax.lax.broadcasted_iota(
            jnp.int32, tone.shape + (n,), tone.ndim)
            == tone[..., None]).astype(jnp.float32)
        f1c = _tone_matmul(oh1, w1c)                           # (..., S, n1)
        f1s = _tone_matmul(oh1, w1s)
        f2c = _tone_matmul(ohn, w2c)                           # (..., S, n2)
        f2s = _tone_matmul(ohn, w2s)
        # w[t, m1*n2 + m2] = f1[m1] * f2[m2]; m = 1..n maps to
        # m' = m mod n whose digits are (m1, m2) of m' = m1*n2 + m2 —
        # build in digit order then roll so columns follow m = 1..n
        c4 = (f1c[..., :, None] * f2c[..., None, :]
              - f1s[..., :, None] * f2s[..., None, :])
        s4 = (f1c[..., :, None] * f2s[..., None, :]
              + f1s[..., :, None] * f2c[..., None, :])
        c = jnp.roll(c4.reshape(c4.shape[:-2] + (n,)), -1, axis=-1)
        s_ = jnp.roll(s4.reshape(s4.shape[:-2] + (n,)), -1, axis=-1)

    re = bc * c - bsn * s_
    im = bc * s_ + bsn * c
    if (bs * n) % (2 * n):                                     # bs odd
        sign = jnp.asarray(
            np.where(np.arange(s_total) % 2 == 0, 1.0, -1.0)
            .astype(np.float32))
        re = re * sign[:, None]
        im = im * sign[:, None]
    out_shape = allsyms.shape[:-1] + (s_total * n,)
    return ((amplitude * re).reshape(out_shape),
            (amplitude * im).reshape(out_shape))


def downchirp_ri(sf: int, bw_scale: int, osr: int = 1,
                 nn: int | None = None) -> tuple[np.ndarray, np.ndarray]:
    """Reference down-chirp as host numpy constants (phy.cpp:206-208).

    The full-RX demodulator multiplies by a down-chirp generated with
    ``genChirp(..., f0=0, down=true, osr=1)`` whose phase is the negated
    up-chirp phase.  Computed exactly with integer numerators.
    """
    n = 1 << sf
    if nn is None:
        nn = n * osr
    d = n * osr * osr
    b = n * osr
    m = np.arange(1, nn + 1, dtype=np.int64)
    w = _wrap_count_prefix(m, b)  # sym = 0 -> S(m) - S(0)
    num = (-m * b) + m * (m + 1) - 2 * w * b
    num = np.mod(num, 2 * d)
    num = np.mod(num * bw_scale, 2 * d)
    phi = -num.astype(np.float64) * (np.pi / d)   # down: phase -= f
    return np.cos(phi).astype(np.float32), np.sin(phi).astype(np.float32)

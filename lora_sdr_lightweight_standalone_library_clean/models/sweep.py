"""BER/PER-vs-SNR sweep harness — the tooling TEST_PLAN.md promises.

The reference's TEST_PLAN references an ``awgn_sweep.py`` that does not
exist and AWGN golden blobs that were stripped (SURVEY §4.4).  Here the
sweep is a first-class jitted pipeline: thousands of packets per SNR point
run as one batched device computation (modulate -> AWGN(+CFO) -> dechirp ->
demod -> decode -> error rates), with metrics returned as arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp

from ..ops import channel
from ..utils.config import LoraParams
from .modem import encode, decode, modulate, dechirp
from .tones import demodulate_tones

__all__ = ["SweepPoint", "per_sweep", "ser_theory", "snr_at_ser_theory",
           "snr_at_level"]


class SweepPoint(NamedTuple):
    snr_db: float
    ser: float        # symbol error rate
    ber: float        # payload bit error rate
    per: float        # packet error rate (any payload byte wrong)
    crc_ok_rate: float


# ---------------------------------------------------------------------------
# Analytic anchor: LoRa symbol detection over AWGN is non-coherent M-ary
# orthogonal signalling (dechirp -> N-bin DFT -> power argmax) with M = 2^sf
# and per-bin SNR gamma = N * 10^(snr_db/10) (N samples integrate
# coherently; ops/channel.py::awgn defines snr_db per complex sample at
# unit signal power).  The exact symbol error probability is
#
#   P_s = 1 - int_0^inf e^{-(u+g)} I0(2 sqrt(u g)) (1 - e^{-u})^{M-1} du
#
# evaluated here by log-domain quadrature (the alternating binomial series
# is numerically useless at M = 4096).  This is the external truth the
# measured waterfall must track: a uniform sensitivity regression (e.g. a
# windowing bug costing 3 dB) shifts the measured curve off this anchor
# even though PER monotonicity still holds.
# ---------------------------------------------------------------------------

def _log_i0(z: np.ndarray) -> np.ndarray:
    """log(I0(z)), stable for large z (np.i0 overflows past ~709)."""
    z = np.asarray(z, np.float64)
    small = z < 700.0
    out = np.empty_like(z)
    out[small] = np.log(np.i0(z[small]))
    zl = z[~small]
    out[~small] = zl - 0.5 * np.log(2.0 * np.pi * zl) + np.log1p(1.0 / (8.0 * zl))
    return out


def ser_theory(snr_db, sf: int):
    """Exact AWGN symbol-error rate of the ideal non-coherent LoRa
    detector at per-sample ``snr_db`` (scalar or array)."""
    m = 1 << sf
    snr_db = np.atleast_1d(np.asarray(snr_db, np.float64))
    out = np.empty(snr_db.shape, np.float64)
    for i, s in enumerate(snr_db):
        g = m * 10.0 ** (s / 10.0)
        hi = g + 40.0 * np.sqrt(g + 1.0) + 40.0
        u = np.linspace(1e-12, hi, 20001)
        logf = (-(u + g) + _log_i0(2.0 * np.sqrt(u * g))
                + (m - 1) * np.log1p(-np.exp(-np.minimum(u, 700.0))))
        p_c = np.trapezoid(np.exp(logf), u)
        out[i] = min(max(1.0 - p_c, 0.0), 1.0)
    return out if out.size > 1 else float(out[0])


def snr_at_ser_theory(target_ser: float, sf: int,
                      lo: float = -40.0, hi: float = 10.0) -> float:
    """SNR (dB) at which the ideal detector hits ``target_ser`` (bisect)."""
    for _ in range(60):
        mid = 0.5 * (lo + hi)
        if ser_theory(mid, sf) > target_ser:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def snr_at_level(points: list["SweepPoint"], level: float,
                 field: str = "ser") -> float:
    """Interpolate the SNR at which a measured sweep crosses ``level``
    (log-domain linear interpolation on a descending waterfall)."""
    xs = [p.snr_db for p in points]
    ys = [max(getattr(p, field), 1e-12) for p in points]
    for i in range(len(xs) - 1):
        if ys[i] >= level >= ys[i + 1]:
            f = ((np.log(level) - np.log(ys[i]))
                 / (np.log(ys[i + 1]) - np.log(ys[i])))
            return xs[i] + f * (xs[i + 1] - xs[i])
    raise ValueError(f"sweep does not cross {field}={level}: {ys}")


def _sweep_step(params: LoraParams, receiver: str = "tones"):
    from .modem import demodulate_wide

    @jax.jit
    def step(key, payloads, snr_db):
        syms = encode(payloads)
        re, im = modulate(syms, params)
        dr, di = dechirp(re, im, params)
        dr, di = channel.awgn(key, dr, di, snr_db)
        if receiver == "wide":
            # the injective osr >= bw_scale receiver: symbols come back as
            # symbol values, so the comparison is direct
            res = demodulate_wide(dr, di, params)
            expect_bins = syms.astype(res.symbols.dtype)
        else:
            res = demodulate_tones(dr, di, params)
            # detected bins live in [0, N): compare against (sym*bs) mod N,
            # the modulation's symbol->bin mapping (PARITY.md defect 2)
            expect_bins = ((syms.astype(jnp.int32) * params.bw_scale)
                           % params.n).astype(res.symbols.dtype)
        dec, crc_ok = decode(res.symbols, check_crc=True)
        sym_err = jnp.mean((res.symbols != expect_bins).astype(jnp.float32))
        bit_err = jnp.mean(_popcount8(jnp.bitwise_xor(
            dec.astype(jnp.int32), payloads.astype(jnp.int32)))) / 8.0
        pkt_err = jnp.mean(
            jnp.any(dec != payloads, axis=-1).astype(jnp.float32))
        return sym_err, bit_err, pkt_err, jnp.mean(crc_ok.astype(jnp.float32))

    return step


def _popcount8(x):
    x = x - ((x >> 1) & 0x55)
    x = (x & 0x33) + ((x >> 2) & 0x33)
    return (x + (x >> 4)) & 0x0F


def per_sweep(params: LoraParams, snrs_db, packets: int = 1000,
              payload_len: int = 16, seed: int = 0,
              receiver: str = "tones") -> list[SweepPoint]:
    """Run a PER/BER sweep over ``snrs_db`` with ``packets`` random packets
    per point.  All packets in a point run as one batched device call.
    ``receiver="wide"`` sweeps through ``demodulate_wide`` (required for
    decodable BW-250/500 sweeps — the reference-faithful tones path cannot
    round-trip bw_scale > 1, SURVEY §4.4.2)."""
    rng = np.random.default_rng(seed)
    payloads = jnp.asarray(
        rng.integers(0, 256, (packets, payload_len)).astype(np.uint8))
    step = _sweep_step(params, receiver)
    out = []
    key = jax.random.PRNGKey(seed)
    for snr in snrs_db:
        key, sub = jax.random.split(key)
        ser, ber, per, crc = step(sub, payloads, jnp.float32(snr))
        out.append(SweepPoint(float(snr), float(ser), float(ber),
                              float(per), float(crc)))
    return out

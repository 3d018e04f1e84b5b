"""Full-fidelity LoRa modem pipeline: encode/modulate/demodulate/decode.

JAX re-design of the reference workspace API (``src/phy/phy.cpp``,
``include/lora_phy/phy.hpp``).  The reference mutates a caller-owned
workspace and processes one packet, one symbol, one sample at a time.  Here
every function is pure, jittable, and batched over arbitrary leading axes
(packets/channels), with metrics returned as arrays instead of stored in a
mutable struct (SURVEY.md §5.5).

IQ is carried as separate float32 (re, im) planes; helpers convert at the
host boundary.

Reference parity map:
 - ``encode``             -> phy.cpp:58-66  + LoRaEncoder.cpp:6-18
 - ``decode``             -> phy.cpp:245-261 + LoRaDecoder.cpp:7-21
 - ``modulate``           -> phy.cpp:68-79  + LoRaMod.cpp:8-43
 - ``demodulate``         -> phy.cpp:182-243
 - ``estimate_offsets``   -> phy.cpp:81-148
 - ``compensate_offsets`` -> phy.cpp:150-180
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax

from ..ops import codes
from ..ops.chirp import modulate_ri, downchirp_ri
from ..ops.detect import detect_ri
from ..utils.config import LoraParams, Window
from ..utils.errors import InvalidArgumentError, RangeError

__all__ = [
    "DemodResult", "OffsetEstimate",
    "encode", "decode", "crc_sx1272",
    "modulate", "modulate_dechirped", "demodulate", "demodulate_wide",
    "estimate_offsets", "compensate_offsets",
    "window_table", "to_complex", "from_complex", "dechirp",
]

TWO_PI = np.float32(2.0 * np.pi)
PI_F = np.float32(np.pi)


class OffsetEstimate(NamedTuple):
    cfo: jnp.ndarray          # carrier frequency offset (fraction of bin/N)
    time_offset: jnp.ndarray  # timing offset in oversampled samples


class DemodResult(NamedTuple):
    symbols: jnp.ndarray      # (..., S) detected data symbols
    sync_word: jnp.ndarray    # (...,) recovered sync byte
    cfo: jnp.ndarray
    time_offset: jnp.ndarray
    power: jnp.ndarray        # (..., S+2) per-symbol fundamental power dB
    power_avg: jnp.ndarray    # (..., S+2) per-symbol noise floor dB


# ---------------------------------------------------------------------------
# Codec  (LoRaEncoder.cpp / LoRaDecoder.cpp / phy.cpp:245-261)
# ---------------------------------------------------------------------------

def encode(payload, params: LoraParams | None = None):
    """Bytes -> Hamming(8,4) symbols, one codeword per nibble
    (LoRaEncoder.cpp:6-18).  Batched over leading axes."""
    del params  # sf/cr unused, mirroring LoRaEncoder.cpp:7
    p = jnp.asarray(payload, jnp.int32)
    hi = _ham84_encode(p >> 4)
    lo = _ham84_encode(p & 0xF)
    sym = jnp.stack([hi, lo], axis=-1)
    return sym.reshape(p.shape[:-1] + (p.shape[-1] * 2,)).astype(jnp.uint16)


def _ham84_encode(nib):
    """Arithmetic SX Hamming(8,4) encode (LoRaCodes.hpp:229-242): the four
    parity equations as elementwise bit ops — gather-free (a 16-entry LUT
    take costs more than the VPU XORs it replaces)."""
    d0 = nib & 1
    d1 = (nib >> 1) & 1
    d2 = (nib >> 2) & 1
    d3 = (nib >> 3) & 1
    return ((nib & 0xF)
            | ((d0 ^ d1 ^ d2) << 4)
            | ((d1 ^ d2 ^ d3) << 5)
            | ((d0 ^ d1 ^ d3) << 6)
            | ((d0 ^ d2 ^ d3) << 7))


def _ham84_decode(c):
    """Arithmetic SX Hamming(8,4) decode with single-bit correction
    (LoRaCodes.hpp:250-281): syndrome + the four correctable-flip selects
    as elementwise bit ops in place of a 256-entry LUT gather."""
    b0 = c & 1
    b1 = (c >> 1) & 1
    b2 = (c >> 2) & 1
    b3 = (c >> 3) & 1
    p0 = b0 ^ b1 ^ b2 ^ ((c >> 4) & 1)
    p1 = b1 ^ b2 ^ b3 ^ ((c >> 5) & 1)
    p2 = b0 ^ b1 ^ b3 ^ ((c >> 6) & 1)
    p3 = b0 ^ b2 ^ b3 ^ ((c >> 7) & 1)
    parity = p0 | (p1 << 1) | (p2 << 2) | (p3 << 3)
    flip = (jnp.where(parity == 0xD, 1, 0)
            | jnp.where(parity == 0x7, 2, 0)
            | jnp.where(parity == 0xB, 4, 0)
            | jnp.where(parity == 0xE, 8, 0))
    return (c ^ flip) & 0xF


@functools.lru_cache(maxsize=None)
def _crc_position_tables(n: int) -> np.ndarray:
    """S[k][b] = the CCITT step map applied k times to byte value b.

    The SX1272 CRC step is GF(2)-linear in (state, byte): byte i of an
    n-byte message enters the register and then undergoes n-1-i further
    step applications, so the final CRC is the XOR of per-position table
    lookups — no sequential scan (LoRaCodes.hpp:92-105 semantics, summed
    in parallel).  Returns (n, 256) uint16 with S[k] = step^k.
    """
    tab = codes.crc16_table()
    s = np.zeros((max(n, 1), 256), np.uint16)
    s[0] = np.arange(256, dtype=np.uint16)
    for k in range(1, n):
        prev = s[k - 1]
        s[k] = (((prev.astype(np.uint32) << 8) & 0xFFFF)
                ^ tab[prev >> 8]).astype(np.uint16)
    return s


def _xor_reduce_last(x):
    """XOR-reduce the last axis with a log-depth fold (used by the
    dynamic-length frame CRC, models/frame.py::crc_sx1272_at)."""
    n = x.shape[-1]
    while n > 1:
        half = n // 2
        x = jnp.bitwise_xor(x[..., :half], x[..., half:2 * half]) if \
            n % 2 == 0 else jnp.concatenate(
                [jnp.bitwise_xor(x[..., :half], x[..., half:2 * half]),
                 x[..., 2 * half:]], axis=-1)
        n = x.shape[-1]
    return x[..., 0]


@functools.lru_cache(maxsize=None)
def _crc_bit_matrix(n: int) -> np.ndarray:
    """(n*8, 16) GF(2) generator matrix of the n-byte SX1272 CRC.

    Row ``k*8 + i`` holds the 16 CRC bits contributed by bit i of message
    byte k, i.e. ``step^{n-1-k}(1 << i)`` — the step map is GF(2)-linear
    in the state (LoRaCodes.hpp:69-79), so the whole CRC is one GF(2)
    matrix-vector product, in float32 for a matmul."""
    s = _crc_position_tables(n)                       # (n, 256)
    rows = np.zeros((n * 8, 16), np.float32)
    j = np.arange(16)
    for k in range(n):
        for i in range(8):
            rows[k * 8 + i] = (int(s[n - 1 - k][1 << i]) >> j) & 1
    return rows


def crc_sx1272(data, length: int | None = None):
    """Batched SX1272 CRC-16 over the last axis (LoRaCodes.hpp:92-105).

    GF(2)-linearity turns the reference's per-byte loop into one matmul:
    message bits (..., n*8) x generator matrix (n*8, 16), reduced mod 2.
    The length-dependent LFSR mask bytes are host constants
    (codes.crc_mask_pair)."""
    d = jnp.asarray(data, jnp.int32)
    n = d.shape[-1] if length is None else length
    m0, m1 = codes.crc_mask_pair(n)
    if n == 0:
        return jnp.full(d.shape[:-1], m0 ^ (m1 << 8), jnp.uint16)
    bits = ((d[..., :n, None] >> jnp.arange(8, dtype=jnp.int32)) & 1)
    bits = bits.reshape(d.shape[:-1] + (n * 8,)).astype(jnp.float32)
    m = jnp.asarray(_crc_bit_matrix(n))
    # exact at any matmul precision (TF32 included): both operands are 0/1
    # and the float32 accumulator counts at most n*8 < 2^24 ones
    acc = jnp.einsum("...b,bj->...j", bits, m,
                     preferred_element_type=jnp.float32)
    crc_bits = acc.astype(jnp.int32) & 1                     # (..., 16)
    weights = jnp.asarray(1 << np.arange(16, dtype=np.int32))
    res = jnp.sum(crc_bits * weights, axis=-1)
    return (res ^ m0 ^ (m1 << 8)).astype(jnp.uint16)


def decode(symbols, params: LoraParams | None = None, *,
           check_crc: bool = True):
    """Symbol pairs -> bytes via Hamming(8,4) decode, plus CRC verdict
    (LoRaDecoder.cpp:7-21, phy.cpp:245-261).

    Returns ``(payload, crc_ok)``; ``crc_ok`` is a boolean array over the
    batch axes (False when fewer than 4 bytes decode, phy.cpp:257-258).
    """
    del params
    s = jnp.asarray(symbols, jnp.int32)
    if s.shape[-1] % 2 != 0:
        raise InvalidArgumentError(
            f"symbol count must be even, got {s.shape[-1]}")
    nib = _ham84_decode(s & 0xFF)
    hi = nib[..., 0::2] & 0xF
    lo = nib[..., 1::2] & 0xF
    payload = ((hi << 4) | lo).astype(jnp.uint8)
    k = payload.shape[-1]
    if not check_crc:
        return payload, jnp.zeros(payload.shape[:-1], bool)
    if k >= 4:
        provided = (payload[..., k - 2].astype(jnp.int32)
                    | (payload[..., k - 1].astype(jnp.int32) << 8))
        calc = crc_sx1272(payload[..., 2:k - 2]).astype(jnp.int32)
        crc_ok = provided == calc
    else:
        crc_ok = jnp.zeros(payload.shape[:-1], bool)
    return payload, crc_ok


# ---------------------------------------------------------------------------
# Modulation  (phy.cpp:68-79)
# ---------------------------------------------------------------------------

def modulate(symbols, params: LoraParams, amplitude: float = 1.0):
    """Symbols -> IQ planes; sync prelude + phase-continuous up-chirps.

    Returns (re, im) float32 of shape (..., (S+2) * step).
    """
    return modulate_ri(symbols, params, amplitude)


def modulate_dechirped(symbols, params: LoraParams, amplitude: float = 1.0):
    """Modulate and dechirp: the producer chain of the golden-vector / perf
    pipeline (modulate -> external dechirp, tests/e2e_chain_test.cpp:79-93,
    tests/performance_test.cpp:112-125).  Equivalent to
    ``dechirp(*modulate(...))``; under jit XLA fuses the dechirp multiply
    into the synthesis.
    """
    return dechirp(*modulate(symbols, params, amplitude), params)


# ---------------------------------------------------------------------------
# Window tables  (phy.cpp:39-50)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def window_table(n: int, kind: Window) -> np.ndarray | None:
    if kind == Window.NONE:
        return None
    i = np.arange(n, dtype=np.float64)
    return (0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1.0))).astype(np.float32)


# ---------------------------------------------------------------------------
# Offset estimation  (phy.cpp:81-148 / LoRaDemod.cpp:80-136)
# ---------------------------------------------------------------------------

def _wrap_pi(d):
    """Wrap a phase delta into [-pi, pi] (phy.cpp:128-131)."""
    d = jnp.where(d > PI_F, d - TWO_PI, d)
    return jnp.where(d < -PI_F, d + TWO_PI, d)


def _best_over_osr(det, osr: int, tie_break_idx: bool):
    """Sequentially select the best oversampling phase t per symbol.

    Mirrors the exact comparison chain: strictly-greater power
    (phy.cpp:116-123) or, for the legacy path, equal-power lowest-index
    (LoRaDemod.cpp:102-111).  ``det`` fields have shape (..., osr).
    """
    neg = jnp.float32(-1e30)
    best_p = jnp.full(det.power.shape[:-1], neg)
    best_idx = jnp.zeros(best_p.shape, jnp.int32)
    best_f = jnp.zeros(best_p.shape, jnp.float32)
    best_t = jnp.zeros(best_p.shape, jnp.int32)
    best_br = jnp.zeros(best_p.shape, jnp.float32)
    best_bi = jnp.zeros(best_p.shape, jnp.float32)
    for t in range(osr):
        p = det.power[..., t]
        idx = det.index[..., t]
        better = p > best_p
        if tie_break_idx:
            better = better | ((p == best_p) & (idx < best_idx))
        best_idx = jnp.where(better, idx, best_idx)
        best_f = jnp.where(better, det.findex[..., t], best_f)
        best_t = jnp.where(better, t, best_t)
        best_br = jnp.where(better, det.bin_re[..., t], best_br)
        best_bi = jnp.where(better, det.bin_im[..., t], best_bi)
        best_p = jnp.where(better, p, best_p)
    return best_p, best_idx, best_f, best_t, best_br, best_bi


def _estimate_core(iq_r, iq_i, params: LoraParams, est_syms: int,
                   tie_break_idx: bool) -> OffsetEstimate:
    """Shared CFO/timing estimator over the first ``est_syms`` symbols.

    Per symbol, every oversampling phase is windowed and detected; the best
    phase's (index + fractional index) average gives the coarse CFO, the
    wrapped inter-symbol phase delta of the winning bin gives the fine CFO,
    and the average winning phase minus the fractional part gives the timing
    offset (phy.cpp:100-147).
    """
    n, osr, step = params.n, params.osr, params.step
    sym = iq_r[..., : est_syms * step].reshape(iq_r.shape[:-1] + (est_syms, n, osr))
    symi = iq_i[..., : est_syms * step].reshape(iq_i.shape[:-1] + (est_syms, n, osr))
    # axes (..., s, i, t) -> (..., s, t, i)
    zr = jnp.moveaxis(sym, -1, -2)
    zi = jnp.moveaxis(symi, -1, -2)
    win = window_table(n, params.window)
    if win is not None:
        w = jnp.asarray(win)
        zr = zr * w
        zi = zi * w
    det = detect_ri(zr, zi)
    # reorder fields to (..., s, t) with t last for selection
    best_p, best_idx, best_f, best_t, best_br, best_bi = _best_over_osr(
        det, osr, tie_break_idx)

    sum_index = jnp.sum(best_idx.astype(jnp.float32) + best_f, axis=-1)
    sum_t = jnp.sum(best_t, axis=-1)
    phase = jnp.arctan2(best_bi, best_br)                      # std::arg
    if est_syms > 1:
        deltas = _wrap_pi(phase[..., 1:] - phase[..., :-1])
        phase_diff = jnp.sum(deltas, axis=-1)
        cfo_fine = (phase_diff / np.float32(est_syms - 1)) / (TWO_PI * n)
    else:
        cfo_fine = jnp.zeros(sum_index.shape, jnp.float32)
    avg_index = sum_index / np.float32(est_syms)
    cfo = avg_index / np.float32(n) + cfo_fine
    frac = avg_index - jnp.floor(avg_index + 0.5)
    avg_t = sum_t.astype(jnp.float32) / np.float32(est_syms)
    time_offset = avg_t - frac * np.float32(n) * np.float32(osr)
    return OffsetEstimate(cfo, time_offset)


def estimate_offsets(iq_r, iq_i, params: LoraParams) -> OffsetEstimate:
    """Estimate CFO and timing offset from preamble symbols (phy.cpp:81-148).

    Uses every whole symbol present in the input, matching the reference's
    symbol loop.  Batched over leading axes.
    """
    symbols = iq_r.shape[-1] // params.step
    if symbols == 0:
        raise InvalidArgumentError("need at least one whole symbol")
    return _estimate_core(iq_r, iq_i, params, symbols, tie_break_idx=False)


def compensate_offsets(iq_r, iq_i, params: LoraParams, est: OffsetEstimate):
    """Derotate by -CFO then integer-shift by the timing offset with
    zero-fill (phy.cpp:150-180).  Batched; returns new (re, im)."""
    n, osr = params.n, params.osr
    count = iq_r.shape[-1]
    rate = -TWO_PI * est.cfo / np.float32(n * osr)             # (...,)
    ns = jnp.arange(count, dtype=jnp.float32)
    ph = rate[..., None] * ns
    c, s = jnp.cos(ph), jnp.sin(ph)
    rr = iq_r * c - iq_i * s
    ri = iq_r * s + iq_i * c
    off = jnp.round(est.time_offset).astype(jnp.int32)         # (...,)
    # shift right by off (>0) with leading zeros, left by -off with trailing
    idx = jnp.arange(count, dtype=jnp.int32)
    src = idx[None, ...] - off[..., None] if off.ndim else idx - off
    valid_pos = (off > 0) & (off < count)
    valid_neg = (off < 0) & (-off < count)
    do_shift = valid_pos | valid_neg
    src_c = jnp.clip(src, 0, count - 1)
    shifted_r = jnp.take_along_axis(rr, src_c, axis=-1) if rr.ndim == src_c.ndim else rr[src_c]
    shifted_i = jnp.take_along_axis(ri, src_c, axis=-1) if ri.ndim == src_c.ndim else ri[src_c]
    in_bounds = (src >= 0) & (src < count)
    shifted_r = jnp.where(in_bounds, shifted_r, 0.0)
    shifted_i = jnp.where(in_bounds, shifted_i, 0.0)
    do = do_shift[..., None] if do_shift.ndim else do_shift
    return (jnp.where(do, shifted_r, rr), jnp.where(do, shifted_i, ri))


# ---------------------------------------------------------------------------
# Full-RX demodulation  (phy.cpp:182-243)
# ---------------------------------------------------------------------------

def _symbol_bases(total: int, step: int, sample_count: int, t_off):
    """Per-symbol gather base indices with the timing-shift clamps of
    phy.cpp:209-216.  ``t_off`` is a batched int32 scalar."""
    s = jnp.arange(total, dtype=jnp.int32) * step              # (S,)
    t = t_off[..., None] if t_off.ndim else t_off              # broadcast
    base_pos = jnp.where(s + t + step <= sample_count, s + t, s)
    base_neg = jnp.where((-t) <= s, s + t, s)
    return jnp.where(t > 0, base_pos, jnp.where(t < 0, base_neg, s))


def _timing_shifted_windows(iq_r, iq_i, t_off, total: int, step: int,
                            osr: int, n: int, decimate: bool = True):
    """Extract per-symbol decimated windows with the reference's per-symbol
    timing-shift clamps (phy.cpp:209-216) — gather-free.

    One per-packet dynamic_slice produces the t_off-shifted stream, both
    shifted and unshifted streams reshape statically into symbol windows,
    and a (B, S) boolean select picks per symbol — exactly the reference's
    clamp rule.
    """
    sample_count = total * step
    batched = iq_r.ndim > 1
    t = t_off if batched else t_off[None]
    r2 = iq_r if batched else iq_r[None]
    i2 = iq_i if batched else iq_i[None]
    lead = r2.shape[:-1]

    # |t_off| < step by construction (avg_t < osr plus a half-symbol
    # fraction, phy.cpp:144-147); pad one step each side and clamp
    # defensively so the slice stays in range.
    tc = jnp.clip(t, -step, step)
    pad_r = jnp.pad(r2.reshape(-1, sample_count), ((0, 0), (step, step)))
    pad_i = jnp.pad(i2.reshape(-1, sample_count), ((0, 0), (step, step)))

    def shift_one(row_r, row_i, ti):
        start = (step + ti,)
        return (lax.dynamic_slice(row_r, start, (sample_count,)),
                lax.dynamic_slice(row_i, start, (sample_count,)))

    sh_r, sh_i = jax.vmap(shift_one)(pad_r, pad_i, tc.reshape(-1))
    wr = sh_r.reshape(lead + (total, step))
    wi = sh_i.reshape(lead + (total, step))

    # With |t_off| < step, the per-symbol clamp (phy.cpp:209-216) can only
    # fall back to the unshifted base at the edges: symbol 0 when t<0 and
    # symbol S-1 when t>0.  Patch just those rows instead of materializing
    # a full unshifted copy + select (saves two full passes over the IQ).
    tb = t[..., None]                                           # (..., 1)
    first_un_r = r2[..., :step]
    first_un_i = i2[..., :step]
    last_un_r = r2[..., (total - 1) * step:]
    last_un_i = i2[..., (total - 1) * step:]
    use_un_first = tb < 0                                       # (..., 1)
    use_un_last = tb > 0
    wr = wr.at[..., 0, :].set(
        jnp.where(use_un_first, first_un_r, wr[..., 0, :]))
    wi = wi.at[..., 0, :].set(
        jnp.where(use_un_first, first_un_i, wi[..., 0, :]))
    wr = wr.at[..., total - 1, :].set(
        jnp.where(use_un_last, last_un_r, wr[..., total - 1, :]))
    wi = wi.at[..., total - 1, :].set(
        jnp.where(use_un_last, last_un_i, wi[..., total - 1, :]))
    if decimate:
        # decimate: sample i*osr within each window
        wr = wr.reshape(lead + (total, n, osr))[..., 0]
        wi = wi.reshape(lead + (total, n, osr))[..., 0]
    if not batched:
        wr, wi = wr[0], wi[0]
    return wr, wi


def demodulate(iq_r, iq_i, params: LoraParams,
               symbol_cap: int | None = None) -> DemodResult:
    """Full-fidelity RX: offset estimation, dechirp, CFO derotation,
    windowing, detection, sync-word extraction (phy.cpp:182-243).

    ``iq`` length must be a whole number of oversampled symbols and contain
    at least the two sync symbols; the first two detections become the sync
    word, the rest the data symbols.
    """
    n, osr, step = params.n, params.osr, params.step
    sample_count = iq_r.shape[-1]
    if sample_count % step != 0:
        raise InvalidArgumentError(
            f"sample count {sample_count} not a multiple of step {step}")
    total = sample_count // step
    if total < 2:
        raise RangeError("input must contain at least two symbols")
    num_symbols = total - 2
    if symbol_cap is not None and num_symbols > symbol_cap:
        raise RangeError(f"{num_symbols} symbols exceed cap {symbol_cap}")

    est_syms = min(total, 2)
    est = _estimate_core(iq_r, iq_i, params, est_syms, tie_break_idx=False)
    t_off = jnp.round(est.time_offset).astype(jnp.int32)
    rate = -TWO_PI * est.cfo / np.float32(n)                   # (...,)

    zr, zi = _timing_shifted_windows(iq_r, iq_i, t_off, total, step, osr, n)

    # CFO derotation phase: start + rate*i  (phy.cpp:218-225)
    s_idx = jnp.arange(total, dtype=jnp.float32) * np.float32(n)
    start = rate[..., None] * (
        s_idx + t_off.astype(jnp.float32)[..., None] / np.float32(osr))

    dcr, dci = downchirp_ri(params.sf, params.bw_scale)        # host consts
    dcr = jnp.asarray(dcr)
    dci = jnp.asarray(dci)
    # dechirp: samp = iq * downchirp (phy.cpp:206-225)
    ar = zr * dcr - zi * dci
    ai = zr * dci + zi * dcr

    from .tones import _rotate_detect
    idx, power, power_avg = _rotate_detect(ar, ai, rate, start, params)
    sw0, sw1 = idx[..., 0], idx[..., 1]
    shift = params.sf - 4 if params.sf > 4 else 0
    sync = (((sw0 >> shift) & 0xF) << 4) | ((sw1 >> shift) & 0xF)
    return DemodResult(
        symbols=idx[..., 2:].astype(jnp.uint16),
        sync_word=sync.astype(jnp.uint8),
        cfo=est.cfo,
        time_offset=est.time_offset,
        power=power,
        power_avg=power_avg,
    )


def demodulate_wide(iq_r, iq_i, params: LoraParams,
                    normalize: bool = True) -> DemodResult:
    """Injective oversampled demodulation: the BW-250/500 receiver the
    reference cannot express.

    The reference detector decimates each window to N samples and takes an
    N-bin FFT, so its symbol->bin map is ``sym * bw_scale mod N`` — at
    bw_scale > 1 the top log2(bw_scale) bits of every symbol are lost and
    its own e2e chain fails for all BW-250/500 profiles (verified defect,
    SURVEY §4.4.2; the demod down-chirp at phy.cpp:206-208 is generated at
    osr=1, so its osr machinery never fixes it).  The *waveform* is
    injective whenever osr >= bw_scale: this receiver keeps the full
    oversampled window and detects over an (N*osr)-point DFT, where
    the tone lands at wide-bin ``sym * bw_scale`` — unambiguous.

    Input is pre-dechirped at full rate (the ``dechirp`` helper's output),
    like ``demodulate_tones``; offset estimation reuses the per-osr-phase
    search (phy.cpp:100-123 semantics).  Requires osr >= bw_scale.

    Returns a DemodResult; ``symbols`` are recovered symbol values
    (already divided out of the wide-bin grid).
    """
    n, osr, step = params.n, params.osr, params.step
    bs = params.bw_scale
    if osr < bs:
        raise InvalidArgumentError(
            f"wide demodulation needs osr >= bw_scale ({osr} < {bs})")
    sample_count = iq_r.shape[-1]
    if sample_count % step != 0:
        raise InvalidArgumentError(
            f"sample count {sample_count} not a multiple of step {step}")
    total = sample_count // step
    if total < 2:
        raise RangeError("input must contain at least two symbols")

    if normalize:
        max_amp = jnp.maximum(
            jnp.max(jnp.abs(iq_r), axis=-1), jnp.max(jnp.abs(iq_i), axis=-1))
        scale = jnp.where(max_amp > 1.0, 1.0 / max_amp, 1.0)[..., None]
    else:
        scale = jnp.ones(iq_r.shape[:-1] + (1,), jnp.float32)

    est_syms = min(total, 2)
    est = _estimate_core(iq_r[..., : est_syms * step] * scale,
                         iq_i[..., : est_syms * step] * scale,
                         params, est_syms, tie_break_idx=True)
    t_off = jnp.round(est.time_offset).astype(jnp.int32)
    # CFO derotation over the full-rate window: the decimated-grid rate
    # (-2*pi*cfo/n per decimated sample) spread over osr samples
    rate = -TWO_PI * est.cfo / np.float32(n * osr)

    zr, zi = _timing_shifted_windows(iq_r, iq_i, t_off, total, step, osr, n,
                                     decimate=False)        # (..., S, step)
    zr = zr * scale[..., None]
    zi = zi * scale[..., None]
    s_idx = jnp.arange(total, dtype=jnp.float32) * np.float32(step)
    start = rate[..., None] * (s_idx + t_off.astype(jnp.float32)[..., None])
    ph = start[..., None] + rate[..., None, None] * jnp.arange(
        step, dtype=jnp.float32)
    c, s_ = jnp.cos(ph), jnp.sin(ph)
    fr = zr * c - zi * s_
    fi = zr * s_ + zi * c
    win = window_table(n, params.window)
    if win is not None:
        # reference windows the decimated grid; per decimated sample
        w = jnp.repeat(jnp.asarray(win), osr)
        fr = fr * w
        fi = fi * w
    det = detect_ri(fr, fi)                                  # N*osr bins

    # Residual timing/CFO moves every tone by the same wide-bin offset; the
    # two sync chirps are known pilots, so measure the common offset there
    # and subtract it before snapping to the symbol grid (robust to the
    # +-osr-sample rounding slack the decimated path hides in its
    # per-phase search).
    nn = step
    exp0, exp1 = params.sync_nibble_symbols()

    def signed_mod(x, m):
        r = jnp.mod(x, m)
        return jnp.where(r > m // 2, r - m, r)

    d0 = signed_mod(det.index[..., 0] - exp0 * bs, nn).astype(jnp.float32)
    d1 = signed_mod(det.index[..., 1] - exp1 * bs, nn).astype(jnp.float32)
    delta = (d0 + d1) * 0.5
    corrected = jnp.round(
        (signed_mod(det.index - jnp.round(delta[..., None]).astype(jnp.int32),
                    nn)).astype(jnp.float32) / np.float32(bs)
    ).astype(jnp.int32)
    sym_wide = jnp.mod(corrected, n)
    sw0, sw1 = sym_wide[..., 0], sym_wide[..., 1]
    shift = params.sf - 4 if params.sf > 4 else 0
    sync = (((sw0 >> shift) & 0xF) << 4) | ((sw1 >> shift) & 0xF)
    return DemodResult(
        symbols=sym_wide[..., 2:].astype(jnp.uint16),
        sync_word=sync.astype(jnp.uint8),
        cfo=est.cfo,
        time_offset=est.time_offset,
        power=det.power,
        power_avg=det.power_avg,
    )


# ---------------------------------------------------------------------------
# Host-boundary helpers
# ---------------------------------------------------------------------------

def to_complex(re, im) -> np.ndarray:
    """Assemble host complex64 IQ from device planes."""
    return np.asarray(re).astype(np.float32) + 1j * np.asarray(im).astype(np.float32)


def from_complex(iq) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split host complex IQ into float32 planes."""
    iq = np.asarray(iq)
    return (jnp.asarray(iq.real.astype(np.float32)),
            jnp.asarray(iq.imag.astype(np.float32)))


def dechirp(iq_r, iq_i, params: LoraParams):
    """Multiply each symbol window by the base down-chirp — the external
    dechirp step of the golden-vector path (tests/e2e_chain_test.cpp:79-93)."""
    step = params.step
    total = iq_r.shape[-1] // step
    dcr, dci = downchirp_ri(params.sf, params.bw_scale, params.osr)
    dcr = jnp.asarray(np.tile(dcr, total))
    dci = jnp.asarray(np.tile(dci, total))
    cut = total * step
    rr = iq_r[..., :cut] * dcr - iq_i[..., :cut] * dci
    ri = iq_r[..., :cut] * dci + iq_i[..., :cut] * dcr
    return rr, ri

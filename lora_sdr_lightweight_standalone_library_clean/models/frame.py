"""SX1272 framed codec: explicit header + whitening + FEC + interleave + Gray.

The reference ships every building block of the SX1272 coded frame — the
explicit-header checksum matrix and constants (``include/lora_phy/
LoRaCodes.hpp:16-18,43-67``), three whitening generators (``:111-189``),
Gray mapping (``:201-222``), four FEC codes (``:229-371``) and the diagonal
interleaver (``:376-412``) — but its core codec never wires them together:
``lora_encode`` is Hamming-only (``src/phy/LoRaEncoder.cpp:6-18``) and only
the vector-dump runner touches the interleaver.  Its own fixture intent
(``vectors/golden/golden_summary.json``: "explicit header, CRC + whitening +
interleaving enabled") describes the framed codec built here.

Frame layout (re-derived from the SX1272 structure those constants encode):

 * **Header block** — ``ppm_h = sf - 2`` Hamming(8,4) codewords interleaved
   at ``RDD = HEADER_RDD = 4`` into ``N_HEADER_SYMBOLS = 8`` symbols of
   ``sf - 2`` bits, transmitted on the reduced grid (``symbol << 2``) for
   the 2-LSB decoding margin of LoRa's low-rate header.  The first
   ``N_HEADER_CODEWORDS = 5`` codewords carry the header nibbles
   ``[len >> 4, len & 0xF, flags, chk >> 4, chk & 0xF]`` where
   ``flags = (rdd << 1) | crc_en`` and ``chk`` is the 5-bit
   ``headerChecksum`` over ``[len, flags]`` (LoRaCodes.hpp:43-67); the
   remaining ``sf - 7`` codewords carry the first payload nibbles (also at
   CR 4/8, like LoRa's first block).
 * **Payload blocks** — ``sf`` codewords of the profile's coding rate
   (rdd 4..1 -> Hamming 8/4, Hamming 7/4, parity 6/4, parity 5/4)
   interleaved into ``4 + rdd`` symbols of ``sf`` bits each.
 * **Whitening** — payload codewords (never the 5 header codewords) XOR the
   dual-LFSR SX1272 sequence (LoRaCodes.hpp:176-189) at their frame-wide
   codeword position, masked to the active codeword width.
 * **Gray** — TX maps every interleaved value through ``grayToBinary16`` so
   the receiver's ``binaryToGray16`` of the detected bin recovers it and a
   +-1-bin detection error lands within FEC reach (LoRaCodes.hpp:201-222).
 * **CRC** — 2-byte little-endian ``sx1272DataChecksum`` over the payload,
   appended before whitening when ``crc`` is enabled (LoRaCodes.hpp:92-105).

Everything is batched over leading axes and jittable: ``encode_frame`` /
``decode_frame_padded`` are pure functions of arrays with static (maximum)
sizes; dynamic payload length enters only through masks and gathers, so one
compiled program serves every length up to the bound — that is what gives
the streaming receiver (parallel/receiver.py) header-driven variable-length
recovery.  ``decode_frame`` is the host convenience wrapper that sizes the
result exactly.
"""
from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import jax.numpy as jnp

from ..ops import codes
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError

__all__ = [
    "FrameHeader", "FrameResult",
    "frame_symbols", "max_frame_symbols",
    "encode_frame", "decode_header", "decode_frame_padded", "decode_frame",
    "header_checksum_batch", "crc_sx1272_at",
]


class FrameHeader(NamedTuple):
    """Decoded explicit header (all batched device arrays)."""

    length: jnp.ndarray    # payload bytes (excl. CRC)
    rdd: jnp.ndarray       # coding-rate redundancy from the flags nibble
    crc_en: jnp.ndarray    # bool, CRC-present flag
    hdr_ok: jnp.ndarray    # bool, 5-bit checksum + field validity


class FrameResult(NamedTuple):
    payload: jnp.ndarray   # (..., max_len) uint8, zero past ``length``
    length: jnp.ndarray    # (...,) int32 payload bytes from the header
    hdr_ok: jnp.ndarray    # (...,) bool
    crc_ok: jnp.ndarray    # (...,) bool (False when hdr_ok is False;
                           # equal to hdr_ok when the frame carries no CRC)
    n_err: jnp.ndarray     # (...,) int32 FEC-corrected/detected codewords


# ---------------------------------------------------------------------------
# Static geometry
# ---------------------------------------------------------------------------

def _check_sf(sf: int) -> None:
    if sf < 7:
        raise InvalidArgumentError(
            f"framed codec needs sf >= 7 (header block holds "
            f"{codes.N_HEADER_CODEWORDS} codewords in sf-2), got sf={sf}")


def _hdr_payload_cap(sf: int) -> int:
    """Payload nibbles riding in the header block: (sf-2) - 5."""
    return (sf - 2) - codes.N_HEADER_CODEWORDS


def _frame_geometry(params: LoraParams, length: int, crc: bool):
    """(payload nibbles, payload blocks, total symbols) for a static length."""
    _check_sf(params.sf)
    nib = 2 * (length + (2 if crc else 0))
    cap = _hdr_payload_cap(params.sf)
    rem = max(0, nib - cap)
    blocks = -(-rem // params.sf)
    symbols = codes.N_HEADER_SYMBOLS + blocks * (4 + params.rdd)
    return nib, blocks, symbols


def frame_symbols(params: LoraParams, length: int, crc: bool = True) -> int:
    """On-air symbol count of a framed packet with ``length`` payload bytes."""
    return _frame_geometry(params, length, crc)[2]


def max_frame_symbols(params: LoraParams, max_length: int,
                      crc: bool = True) -> int:
    """Symbol bound used by the padded decoder / streaming receiver."""
    return frame_symbols(params, max_length, crc)


# ---------------------------------------------------------------------------
# FEC LUTs per coding rate (encode: 16 entries; decode: 2^(4+rdd) entries)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _fec_tables(rdd: int):
    """(encode_lut[16], decode_lut, err_lut) int32 host arrays for one rdd."""
    nib = np.arange(16, dtype=np.uint8)
    if rdd == 4:
        enc = codes.encode_hamming84(nib)
        cw = np.arange(256, dtype=np.uint16)
        dec, err, bad = codes.decode_hamming84(cw, return_flags=True)
        err = err | bad
    elif rdd == 3:
        enc = codes.encode_hamming74(nib)
        cw = np.arange(128, dtype=np.uint16)
        dec, err = codes.decode_hamming74(cw, return_flags=True)
    elif rdd == 2:
        enc = codes.encode_parity64(nib)
        cw = np.arange(64, dtype=np.uint8)
        dec, err = codes.check_parity64(cw, return_flags=True)
    elif rdd == 1:
        enc = codes.encode_parity54(nib)
        cw = np.arange(32, dtype=np.uint8)
        dec, err = codes.check_parity54(cw, return_flags=True)
    else:
        raise InvalidArgumentError(f"rdd must be 1..4, got {rdd}")
    return (enc.astype(np.int32), dec.astype(np.int32), err.astype(np.int32))


@functools.lru_cache(maxsize=None)
def _whiten_keys(n_cw: int, cap: int, rdd: int) -> np.ndarray:
    """Frame-positional whitening keys: full 8-bit dual-LFSR bytes masked to
    the codeword width active at each position — the first ``cap``
    header-block ride-along codewords are CR 4/8 (8-bit), later positions
    use the profile's ``4 + rdd``-bit mask (LoRaCodes.hpp:178: the
    generator's mask tracks the codeword width)."""
    full = codes.whitening_sequence_lfsr(max(n_cw, 1), 0, rdd=4)
    masks = np.where(np.arange(max(n_cw, 1)) < cap, 0xFF,
                     0xFF >> (4 - rdd))
    return (full & masks).astype(np.int32)


# ---------------------------------------------------------------------------
# Header checksum, batched (LoRaCodes.hpp:43-67)
# ---------------------------------------------------------------------------

def header_checksum_batch(h0, h1):
    """5-bit explicit-header checksum over batched (h0, h1) byte arrays."""
    h0 = jnp.asarray(h0, jnp.int32)
    h1 = jnp.asarray(h1, jnp.int32)
    shifts0 = jnp.arange(7, -1, -1, dtype=jnp.int32)
    shifts1 = jnp.arange(3, -1, -1, dtype=jnp.int32)
    bits = jnp.concatenate(
        [(h0[..., None] >> shifts0) & 1, (h1[..., None] >> shifts1) & 1],
        axis=-1).astype(jnp.float32)                       # (..., 12)
    par = jnp.asarray(codes._HDR_PARITY.astype(np.float32))  # (5, 12)
    # exact at any matmul precision (TF32 included): 0/1 operands, sums <= 12
    out = jnp.mod(bits @ par.T, 2.0).astype(jnp.int32)     # (..., 5)
    weights = jnp.asarray([16, 8, 4, 2, 1], jnp.int32)
    return jnp.sum(out * weights, axis=-1)


# ---------------------------------------------------------------------------
# Dynamic-length CRC (device): crc over data[..., :length]
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _v_seq_const() -> np.ndarray:
    return codes._V_SEQ.astype(np.int32)


def crc_sx1272_at(data, length):
    """SX1272 CRC-16 over the first ``length`` bytes of the last axis.

    ``length`` is a batched int32 array — the jit-friendly variant of
    ``models.modem.crc_sx1272`` for header-driven frames.  GF(2)-linearity
    replaces the byte loop with a masked per-position table gather + XOR
    fold (byte i of an L-byte message contributes step^{L-1-i}(byte));
    the two length-dependent LFSR mask bytes (LoRaCodes.hpp:101-103) come
    from a precomputed sequence gather.
    """
    from .modem import _crc_position_tables, _xor_reduce_last
    d = jnp.asarray(data, jnp.int32)
    length = jnp.asarray(length, jnp.int32)
    n = d.shape[-1]
    s = _crc_position_tables(max(n, 1))               # (n, 256)
    flat = jnp.asarray(s.reshape(-1).astype(np.int32))
    i = jnp.arange(n, dtype=jnp.int32)
    k = jnp.clip(length[..., None] - 1 - i, 0, max(n - 1, 0))
    contrib = jnp.take(flat, k * 256 + d, axis=0)
    contrib = jnp.where(i < length[..., None], contrib, 0)
    res = _xor_reduce_last(contrib)
    vseq = jnp.asarray(_v_seq_const())
    m0 = jnp.take(vseq, jnp.clip(length, 0, vseq.shape[0] - 1), axis=0)
    m1 = jnp.take(vseq, jnp.clip(length + 1, 0, vseq.shape[0] - 1), axis=0)
    return (res ^ m0 ^ (m1 << 8)).astype(jnp.uint16)


# ---------------------------------------------------------------------------
# Encode
# ---------------------------------------------------------------------------

def encode_frame(payload, params: LoraParams, crc: bool = True) -> jnp.ndarray:
    """Payload bytes -> framed on-air symbols (batched, jittable).

    Static shapes: ``payload`` has a fixed last-axis length, so the symbol
    count is a trace-time constant (``frame_symbols``).  Feed the result to
    ``modulate`` — the sync prelude is added there (LoRaMod.cpp:20-32).
    """
    p = jnp.asarray(payload, jnp.int32)
    length = p.shape[-1]
    sf, rdd = params.sf, params.rdd
    nib_total, blocks, _ = _frame_geometry(params, length, crc)
    cap = _hdr_payload_cap(sf)
    n_cw = cap + blocks * sf                      # payload codeword positions

    if crc:
        c = crc_sx1272_at(p, jnp.full(p.shape[:-1], length, jnp.int32))
        c = c.astype(jnp.int32)
        data = jnp.concatenate(
            [p, (c & 0xFF)[..., None], (c >> 8)[..., None]], axis=-1)
    else:
        data = p
    hi = (data >> 4) & 0xF
    lo = data & 0xF
    nib = jnp.stack([hi, lo], axis=-1).reshape(data.shape[:-1] + (nib_total,))
    pad = n_cw - nib_total
    if pad > 0:
        nib = jnp.pad(nib, [(0, 0)] * (nib.ndim - 1) + [(0, pad)])
    elif pad < 0:                                  # nib_total > capacity only
        raise AssertionError("geometry underflow")  # pragma: no cover

    # FEC encode: header-block ride-along at CR4/8, blocks at the profile CR
    enc84 = jnp.asarray(_fec_tables(4)[0])
    enc_p = jnp.asarray(_fec_tables(rdd)[0])
    cw_head = jnp.take(enc84, nib[..., :cap], axis=0)
    cw_body = jnp.take(enc_p, nib[..., cap:], axis=0)

    # whitening at frame codeword positions (header nibbles stay clear)
    keys = _whiten_keys(n_cw, cap, rdd)
    cw_head = cw_head ^ jnp.asarray(keys[:cap])
    cw_body = cw_body ^ jnp.asarray(keys[cap:])

    # explicit header: [len, (rdd << 1) | crc] + 5-bit checksum
    h0 = jnp.full(p.shape[:-1], length & 0xFF, jnp.int32)
    h1 = jnp.full(p.shape[:-1], ((rdd << 1) | (1 if crc else 0)) & 0xF,
                  jnp.int32)
    chk = header_checksum_batch(h0, h1)
    hdr_nib = jnp.stack(
        [h0 >> 4, h0 & 0xF, h1, chk >> 4, chk & 0xF], axis=-1)
    hdr_cw = jnp.take(enc84, hdr_nib, axis=0)

    # interleave + gray; header block rides the reduced (<< 2) grid
    ppm_h = sf - 2
    blk0 = jnp.concatenate([hdr_cw, cw_head], axis=-1)    # (..., sf-2)
    sym0 = codes.diagonal_interleave(blk0, ppm_h, 4, xp=jnp)
    sym0 = codes.gray_to_binary16(sym0.astype(jnp.uint16))
    air0 = (sym0.astype(jnp.int32) << 2) & ((1 << sf) - 1)
    if blocks:
        symb = codes.diagonal_interleave(cw_body, sf, rdd, xp=jnp)
        symb = codes.gray_to_binary16(symb.astype(jnp.uint16))
        air = jnp.concatenate([air0, symb.astype(jnp.int32)], axis=-1)
    else:
        air = air0
    return air.astype(jnp.uint16)


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def _decode_header_block(symbols, params: LoraParams):
    """First 8 symbols -> (FrameHeader, ride-along payload nibbles, errs)."""
    sf = params.sf
    cap = _hdr_payload_cap(sf)
    # reduced-grid snap with rounding: a +-1-bin detection error on the
    # << 2 air symbol still lands on the right header value
    s = ((jnp.asarray(symbols, jnp.int32) + 2) >> 2) & ((1 << (sf - 2)) - 1)
    s = codes.binary_to_gray16(s.astype(jnp.uint16))
    cw = codes.diagonal_deinterleave(
        s[..., :codes.N_HEADER_SYMBOLS], sf - 2, 4, xp=jnp)
    cw = cw.astype(jnp.int32)
    _, dec84, err84 = (jnp.asarray(t) for t in _fec_tables(4))
    hdr_nib = jnp.take(dec84, cw[..., :5], axis=0)
    hdr_err = jnp.take(err84, cw[..., :5], axis=0)
    keys = _whiten_keys(max(cap, 1), cap, params.rdd)
    ride_cw = cw[..., 5:] ^ jnp.asarray(keys[:cap])
    ride_nib = jnp.take(dec84, ride_cw, axis=0)
    ride_err = jnp.take(err84, ride_cw, axis=0)

    h0 = (hdr_nib[..., 0] << 4) | hdr_nib[..., 1]
    h1 = hdr_nib[..., 2]
    chk = ((hdr_nib[..., 3] & 1) << 4) | hdr_nib[..., 4]
    ok = (header_checksum_batch(h0, h1) == chk) & (hdr_nib[..., 3] <= 1)
    rdd_f = (h1 >> 1) & 0x7
    crc_en = (h1 & 1).astype(bool)
    ok = ok & (rdd_f >= 1) & (rdd_f <= 4) & (h0 >= 1)
    hdr = FrameHeader(length=h0, rdd=rdd_f, crc_en=crc_en, hdr_ok=ok)
    n_err = jnp.sum(hdr_err, axis=-1) + jnp.sum(ride_err, axis=-1)
    return hdr, ride_nib, n_err


def decode_header(symbols, params: LoraParams) -> FrameHeader:
    """Parse the explicit header from the first 8 demodulated symbols."""
    return _decode_header_block(symbols, params)[0]


def decode_frame_padded(symbols, params: LoraParams,
                        max_payload_len: int,
                        crc: bool = True) -> FrameResult:
    """Framed decode with static bounds — one compiled program for every
    payload length up to ``max_payload_len`` (the streaming RX entry point).

    ``symbols`` must provide at least ``max_frame_symbols`` entries; entries
    past the actual frame are ignored.  The profile's coding rate is the
    static truth — a header advertising a different rate fails ``hdr_ok``
    (per-packet dynamic rates would retrace; document at the call site).
    """
    sf, rdd = params.sf, params.rdd
    _, max_blocks, s_need = _frame_geometry(params, max_payload_len, crc)
    s = jnp.asarray(symbols, jnp.int32)
    if s.shape[-1] < s_need:
        raise InvalidArgumentError(
            f"need {s_need} symbols for max_payload_len={max_payload_len}, "
            f"got {s.shape[-1]}")
    cap = _hdr_payload_cap(sf)
    n_cw = cap + max_blocks * sf

    hdr, ride_nib, n_err0 = _decode_header_block(s, params)

    if max_blocks:
        body = s[..., codes.N_HEADER_SYMBOLS:
                 codes.N_HEADER_SYMBOLS + max_blocks * (4 + rdd)]
        body = codes.binary_to_gray16(
            (body & ((1 << sf) - 1)).astype(jnp.uint16))
        cw = codes.diagonal_deinterleave(body, sf, rdd, xp=jnp)
        cw = cw.astype(jnp.int32) ^ jnp.asarray(
            _whiten_keys(n_cw, cap, rdd)[cap:])
        _, dec_p, err_p = (jnp.asarray(t) for t in _fec_tables(rdd))
        nib_body = jnp.take(dec_p, cw, axis=0)
        err_body = jnp.take(err_p, cw, axis=0)
        nib = jnp.concatenate([ride_nib, nib_body], axis=-1)
        errs = err_body
    else:
        nib = ride_nib
        errs = jnp.zeros(nib.shape[:-1] + (0,), jnp.int32)

    n_bytes = n_cw // 2
    by = ((nib[..., 0:2 * n_bytes:2] << 4)
          | nib[..., 1:2 * n_bytes:2]).astype(jnp.int32)

    length = jnp.clip(hdr.length, 0, max_payload_len).astype(jnp.int32)
    # FEC-error observability only over codewords the frame actually uses
    used_nib = 2 * (length + jnp.where(hdr.crc_en, 2, 0))
    used_body = jnp.clip(used_nib - cap, 0, max_blocks * sf)
    pos = jnp.arange(errs.shape[-1], dtype=jnp.int32)
    n_err = n_err0 + jnp.sum(
        jnp.where(pos < used_body[..., None], errs, 0), axis=-1)

    if crc:
        calc = crc_sx1272_at(by, length).astype(jnp.int32)
        li = jnp.clip(length, 0, n_bytes - 1)[..., None]
        c0 = jnp.take_along_axis(by, li, axis=-1)[..., 0]
        c1 = jnp.take_along_axis(
            by, jnp.clip(li + 1, 0, n_bytes - 1), axis=-1)[..., 0]
        room = (length + 2) * 2 <= n_cw
        crc_ok = hdr.hdr_ok & hdr.crc_en & room & (
            (c0 | (c1 << 8)) == calc)
    else:
        crc_ok = hdr.hdr_ok & ~hdr.crc_en

    ok_len = hdr.hdr_ok & (hdr.length <= max_payload_len) & (hdr.rdd == rdd)
    idx = jnp.arange(max_payload_len, dtype=jnp.int32)
    src = jnp.clip(idx, 0, n_bytes - 1)
    payload = jnp.where(idx < length[..., None], by[..., src], 0)
    return FrameResult(
        payload=payload.astype(jnp.uint8),
        length=length,
        hdr_ok=ok_len,
        crc_ok=crc_ok & ok_len,
        n_err=n_err.astype(jnp.int32),
    )


def decode_frame(symbols, params: LoraParams):
    """Host convenience decode of ONE frame: exact-size payload.

    Parses the header, sizes the decode to the advertised length, and trims
    the result.  Not jittable (data-dependent shapes) — use
    ``decode_frame_padded`` in compiled/streaming paths.
    """
    hdr = decode_header(np.asarray(symbols)[..., :codes.N_HEADER_SYMBOLS],
                        params)
    if not bool(np.asarray(hdr.hdr_ok)):
        empty = jnp.zeros((0,), jnp.uint8)
        false = jnp.asarray(False)
        return FrameResult(empty, hdr.length, hdr.hdr_ok, false,
                           jnp.asarray(0, jnp.int32))
    length = int(np.asarray(hdr.length))
    crc = bool(np.asarray(hdr.crc_en))
    need = frame_symbols(params, length, crc)
    s = np.asarray(symbols)
    if s.shape[-1] < need:
        raise InvalidArgumentError(
            f"header advertises {length} bytes -> {need} symbols, "
            f"got {s.shape[-1]}")
    res = decode_frame_padded(s[..., :need], params, length, crc)
    return FrameResult(res.payload[..., :length], res.length, res.hdr_ok,
                       res.crc_ok, res.n_err)

"""End-to-end streaming RX: continuous IQ stream -> decoded payloads.

The reference's ``demodulate`` contract is IQ in, payload out, for a
caller-aligned single packet (``src/phy/phy.cpp:182-243``).  This module
lifts that contract to *continuous multi-packet streams* — the capability
the reference lacks entirely and SURVEY §5.7 assigns to this build:

  chunk of stream -> overlap-save sync scan (optionally shard_map'd over
  the mesh's 'sp' axis with ppermute halos) -> deterministic candidate
  selection -> per-packet offset estimation + demodulation + decoding,
  batched over the found packets -> payloads + CRC verdicts + positions.

Packets straddle every kind of boundary; both are handled exactly:

 * **Chunk boundaries** (time): a ``StreamRxState`` carries the last
   ``packet_len`` raw samples.  A packet is recovered by the first chunk
   in which its *whole body* is available: chunk k (providing samples up
   to E_k = offset + k*L) owns sync starts g with
   E_{k-1} < g + packet_len <= E_k.  Ownership is a partition — no packet
   is recovered twice, none is lost, and results are invariant to how the
   stream is chunked.
 * **Shard boundaries** (devices): the scan runs under ``shard_map`` with
   one-symbol ppermute halos (parallel/streaming.py); candidate windows
   are global indices, so ownership is deterministic regardless of the
   shard layout, and packet bodies that cross shards are gathered by XLA
   from the sharded stream at extraction time (K * packet_len samples —
   tiny next to the scan).

Everything is jittable with static shapes: ``max_packets`` bounds the
per-chunk recovery (extra detections are dropped deterministically — the
*earliest* starts win), ``payload_symbols`` fixes the packet length, and
absent packets are masked by ``valid``.

At bw_scale > 1 (BW-250/500) the extracted packets decode through the
injective wide receiver (``demodulate_wide``, auto-enabled when
osr >= bw_scale) — the reference's own decimating detector cannot
round-trip those profiles at all (SURVEY §4.4.2), so this is the
deployment-shaped form of the capability it lacks twice over.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh

from ..models.modem import decode, dechirp, demodulate_wide
from ..models.tones import demodulate_tones
from ..models import frame as frame_codec
from ..utils.config import LoraParams
from ..utils.errors import InvalidArgumentError
from .streaming import stream_scan, find_packet_starts

__all__ = ["StreamRxState", "RecoveredPackets", "RecoveredFrames",
           "stream_rx_init", "stream_frames_init",
           "receive_stream", "receive_stream_frames", "packet_samples"]


class StreamRxState(NamedTuple):
    """Carried state between successive chunks of one logical stream."""

    tail_r: jnp.ndarray     # (packet_len,) last raw samples of prev chunk
    tail_i: jnp.ndarray
    offset: jnp.ndarray     # int32 global sample index of the next chunk
                            # (wraps after 2^31 samples ~ 4h at 125 kHz)


class RecoveredPackets(NamedTuple):
    """Up to ``max_packets`` packets recovered from one chunk."""

    payload: jnp.ndarray    # (K, bytes) uint8
    crc_ok: jnp.ndarray     # (K,) bool
    valid: jnp.ndarray      # (K,) bool — entry k holds a real packet
    start: jnp.ndarray      # (K,) int32 global sample index of sync start
    sync_word: jnp.ndarray  # (K,) uint8
    cfo: jnp.ndarray        # (K,) float32
    time_offset: jnp.ndarray  # (K,) float32
    n_candidates: jnp.ndarray  # () int32 sync starts owned by this chunk
    n_dropped: jnp.ndarray     # () int32 owned starts beyond max_packets
                               # (a saturated chunk is observable)


def packet_samples(params: LoraParams, payload_symbols: int) -> int:
    """Samples per packet: 2 sync + payload symbols (LoRaMod.cpp:42)."""
    return (payload_symbols + 2) * params.step


def stream_rx_init(params: LoraParams, payload_symbols: int) -> StreamRxState:
    """Fresh state: a zero tail (no samples seen yet)."""
    plen = packet_samples(params, payload_symbols)
    return StreamRxState(
        tail_r=jnp.zeros(plen, jnp.float32),
        tail_i=jnp.zeros(plen, jnp.float32),
        offset=jnp.zeros((), jnp.int32),
    )


class RecoveredFrames(NamedTuple):
    """Up to ``max_packets`` variable-length frames from one chunk."""

    payload: jnp.ndarray    # (K, max_payload_len) uint8, zero past length
    length: jnp.ndarray     # (K,) int32 payload bytes from each header
    hdr_ok: jnp.ndarray     # (K,) bool explicit-header checksum verdict
    crc_ok: jnp.ndarray     # (K,) bool payload CRC verdict
    valid: jnp.ndarray      # (K,) bool — entry k holds a real detection
    start: jnp.ndarray      # (K,) int32 global sample index of sync start
    sync_word: jnp.ndarray  # (K,) uint8
    cfo: jnp.ndarray        # (K,) float32
    time_offset: jnp.ndarray   # (K,) float32
    n_err: jnp.ndarray      # (K,) int32 FEC-corrected codewords
    n_candidates: jnp.ndarray  # () int32 sync starts owned by this chunk
    n_dropped: jnp.ndarray     # () int32 owned starts beyond max_packets


def stream_frames_init(params: LoraParams, max_payload_len: int,
                       crc: bool = True) -> StreamRxState:
    """Fresh state for ``receive_stream_frames`` (max-frame-sized tail)."""
    s_max = frame_codec.max_frame_symbols(params, max_payload_len, crc)
    return stream_rx_init(params, s_max)


def _resolve_wide(params: LoraParams, wide: bool | None) -> bool:
    """Resolve the ``wide`` mode flag of the streaming receivers.

    ``None`` auto-enables the injective wide receiver exactly when it is
    both needed and possible: bw_scale > 1 (the reference's decimating
    detector loses the top log2(bw_scale) symbol bits there, SURVEY
    §4.4.2) and osr >= bw_scale (the waveform is injective).  ``True``
    forces it (raising when osr is insufficient); ``False`` keeps the
    reference-faithful decimating tones path.
    """
    if wide is None:
        return params.bw_scale > 1 and params.osr >= params.bw_scale
    if wide and params.osr < params.bw_scale:
        raise InvalidArgumentError(
            f"wide streaming RX needs osr >= bw_scale "
            f"({params.osr} < {params.bw_scale})")
    return wide


def _default_stride(params: LoraParams, wide: bool) -> int:
    """Default scan stride: a quarter symbol, shrunk by bw_scale in wide
    mode so the sync-bin misalignment residue stays within +-n/4 bins —
    unambiguous under the signed mod-n readout of find_packet_starts (a
    bs-scaled chirp shifts bs bins per decimated sample, so a quarter-
    symbol misalignment at bw_scale 4 would wrap the full spectrum)."""
    div = 4 * (params.bw_scale if wide else 1)
    return max(params.step // div, 1)


def _wide_max_mis(params: LoraParams, stride: int) -> int:
    """Misalignment bound for wide-mode sync flags: a true start's nearest
    window lies within stride/2, plus slack for +-1-bin residue rounding
    (osr/bs samples per bin).  Kills period-n*osr/bs aliases
    (streaming.find_packet_starts docstring)."""
    return stride // 2 + max(8, 4 * params.osr // params.bw_scale)


def _owned_starts(ext_r, ext_i, chunk_len: int, plen: int,
                  params: LoraParams, mesh, axis: str, stride: int,
                  power_gate_db: float, max_packets: int,
                  dedupe_tol: int = 2, max_mis: int | None = None):
    """Scan [tail | chunk] and pick this chunk's owned packet starts.

    Ownership: corrected starts g with 0 < g <= chunk_len (ext coordinates
    shifted by plen) — the packet's last sample arrived in this chunk and
    not before.  g is a pure function of the physical window, so whichever
    chunk sees the window computes the same owner.  Returns the earliest
    ``max_packets`` starts ascending (clamped for extraction), their
    validity mask, and the owned-candidate count.
    """
    ext_len = plen + chunk_len
    if mesh is not None:
        n_shards = mesh.shape[axis]
        pad = (-ext_len) % (stride * n_shards)
    else:
        pad = 0
    sr = jnp.pad(ext_r, (0, pad)) if pad else ext_r
    si = jnp.pad(ext_i, (0, pad)) if pad else ext_i
    scan = stream_scan(sr, si, params, mesh=mesh, axis=axis, stride=stride)
    mask, start = find_packet_starts(scan, params, stride=stride,
                                     power_gate_db=power_gate_db,
                                     dedupe_tol=dedupe_tol,
                                     max_mis=max_mis)
    owned = mask & (start > 0) & (start <= chunk_len)
    sentinel = jnp.int32(ext_len + 1)
    cand = jnp.where(owned, start, sentinel)
    neg_topk, _ = lax.top_k(-cand, max_packets)
    starts = -neg_topk
    valid = starts < sentinel
    starts_c = jnp.clip(jnp.where(valid, starts, 0), 0, ext_len - plen)
    return starts_c, valid, jnp.sum(owned.astype(jnp.int32))


def receive_stream(iq_r, iq_i, params: LoraParams, *,
                   payload_symbols: int, max_packets: int,
                   state: StreamRxState | None = None,
                   mesh: Mesh | None = None, axis: str = "sp",
                   stride: int | None = None,
                   power_gate_db: float = 3.0,
                   wide: bool | None = None,
                   ) -> tuple[RecoveredPackets, StreamRxState]:
    """Recover every whole packet that completes inside this chunk.

    Args:
      iq_r/iq_i: float32 (L,) chunk of the continuous stream; L must be a
        multiple of ``stride`` (and of stride*mesh-shards when sharded).
      payload_symbols: data symbols per packet (static).
      max_packets: recovery capacity per chunk (static).  If more packets
        complete in a chunk, the earliest ``max_packets`` win.
      state: carried state from the previous chunk (None = stream start).
      mesh/axis: shard the sync scan over this mesh axis via shard_map.
      stride: scan granularity in samples (default: a quarter symbol,
        divided by bw_scale in wide mode).  Packets at arbitrary sample
        offsets are recovered exactly: the sync-bin shift measures the
        window misalignment, which corrects the extraction to the true
        start.  Larger strides scan cheaper but lose detection SNR
        (~3.5 dB at half-symbol misalignment).
      wide: decode extracted packets through the injective full-rate
        receiver (``demodulate_wide``) instead of the reference-faithful
        decimating tones path — the BW-250/500 capability the reference
        cannot express (its detector loses the top log2(bw_scale) symbol
        bits, SURVEY §4.4.2; phy.cpp:206-208).  ``None`` (default)
        auto-enables it when bw_scale > 1 and osr >= bw_scale.

    Returns:
      (RecoveredPackets, new StreamRxState).
    """
    step = params.step
    wide = _resolve_wide(params, wide)
    if stride is None:
        stride = _default_stride(params, wide)
    chunk_len = iq_r.shape[-1]
    if chunk_len % stride:
        raise ValueError(f"chunk length {chunk_len} not a multiple of "
                         f"stride {stride}")
    plen = packet_samples(params, payload_symbols)
    if plen % stride:
        raise ValueError(f"packet length {plen} not a multiple of "
                         f"stride {stride}")
    if state is None:
        state = stream_rx_init(params, payload_symbols)

    # extended stream: [prev tail | chunk]; ext position p <-> global
    # sample g = p + offset - plen
    ext_r = jnp.concatenate([state.tail_r, iq_r], axis=-1)
    ext_i = jnp.concatenate([state.tail_i, iq_i], axis=-1)
    ext_len = plen + chunk_len

    starts_c, valid, n_candidates = _owned_starts(
        ext_r, ext_i, chunk_len, plen, params, mesh, axis, stride,
        power_gate_db, max_packets,
        dedupe_tol=max(2, params.osr) if wide else 2,
        max_mis=_wide_max_mis(params, stride) if wide else None)

    # --- per-packet demod + decode: the decodable tones path (external
    # dechirp + lora_demodulate semantics, LoRaDemod.cpp:50-197), or the
    # injective wide receiver at bw_scale > 1 ----------------------------
    def extract(p):
        pr = lax.dynamic_slice_in_dim(ext_r, p, plen, axis=-1)
        pi = lax.dynamic_slice_in_dim(ext_i, p, plen, axis=-1)
        return pr, pi

    pkt_r, pkt_i = jax.vmap(extract)(starts_c)      # (K, plen)
    dr, di = dechirp(pkt_r, pkt_i, params)
    res = (demodulate_wide if wide else demodulate_tones)(dr, di, params)
    payload, crc_ok = decode(res.symbols)

    zero_payload = jnp.zeros_like(payload)
    packets = RecoveredPackets(
        payload=jnp.where(valid[:, None], payload, zero_payload),
        crc_ok=crc_ok & valid,
        valid=valid,
        start=(starts_c + state.offset - plen),
        sync_word=jnp.where(valid, res.sync_word, 0).astype(jnp.uint8),
        cfo=jnp.where(valid, res.cfo, 0.0),
        time_offset=jnp.where(valid, res.time_offset, 0.0),
        n_candidates=n_candidates,
        n_dropped=jnp.maximum(n_candidates - max_packets, 0),
    )

    # --- carried state ---------------------------------------------------
    new_state = StreamRxState(
        tail_r=ext_r[..., chunk_len:],               # last plen samples
        tail_i=ext_i[..., chunk_len:],
        offset=state.offset + chunk_len,
    )
    return packets, new_state


def receive_stream_frames(iq_r, iq_i, params: LoraParams, *,
                          max_payload_len: int, max_packets: int,
                          crc: bool = True,
                          state: StreamRxState | None = None,
                          mesh: Mesh | None = None, axis: str = "sp",
                          stride: int | None = None,
                          power_gate_db: float = 3.0,
                          wide: bool | None = None,
                          ) -> tuple[RecoveredFrames, StreamRxState]:
    """Header-driven variable-length streaming RX.

    ``receive_stream`` needs the caller to fix ``payload_symbols`` — fine
    against the reference (whose demod also takes caller-sized buffers,
    phy.cpp:182-192) but unable to receive a real mixed-length stream.
    This entry point decodes the explicit header of every detected packet
    (models/frame.py) and recovers its advertised length, up to the static
    bound ``max_payload_len``; one compiled program serves every length.

    Ownership treats every packet as maximum-length: a start is owned by
    the chunk in which its *maximal* frame window completes, so a frame's
    recovery may land one chunk later than its last symbol, but no frame is
    lost or duplicated regardless of chunking.  Oversize frames (header
    advertising > max_payload_len) surface with ``hdr_ok == False``.

    ``wide`` selects the injective full-rate receiver for the extracted
    frames (see ``receive_stream``); ``None`` auto-enables it when
    bw_scale > 1 and osr >= bw_scale.

    Returns (RecoveredFrames, new state) — state from
    ``stream_frames_init`` (or None at stream start).
    """
    step = params.step
    wide = _resolve_wide(params, wide)
    if stride is None:
        stride = _default_stride(params, wide)
    chunk_len = iq_r.shape[-1]
    if chunk_len % stride:
        raise ValueError(f"chunk length {chunk_len} not a multiple of "
                         f"stride {stride}")
    s_max = frame_codec.max_frame_symbols(params, max_payload_len, crc)
    plen = packet_samples(params, s_max)
    if plen % stride:
        raise ValueError(f"max frame length {plen} not a multiple of "
                         f"stride {stride}")
    if state is None:
        state = stream_frames_init(params, max_payload_len, crc)

    ext_r = jnp.concatenate([state.tail_r, iq_r], axis=-1)
    ext_i = jnp.concatenate([state.tail_i, iq_i], axis=-1)

    starts_c, valid, n_candidates = _owned_starts(
        ext_r, ext_i, chunk_len, plen, params, mesh, axis, stride,
        power_gate_db, max_packets,
        dedupe_tol=max(2, params.osr) if wide else 2,
        max_mis=_wide_max_mis(params, stride) if wide else None)

    def extract(p):
        return (lax.dynamic_slice_in_dim(ext_r, p, plen, axis=-1),
                lax.dynamic_slice_in_dim(ext_i, p, plen, axis=-1))

    pkt_r, pkt_i = jax.vmap(extract)(starts_c)      # (K, plen)
    dr, di = dechirp(pkt_r, pkt_i, params)
    res = (demodulate_wide if wide else demodulate_tones)(dr, di, params)
    # symbols: (K, s_max)
    dec = frame_codec.decode_frame_padded(res.symbols, params,
                                          max_payload_len, crc)

    frames = RecoveredFrames(
        payload=jnp.where(valid[:, None], dec.payload, 0).astype(jnp.uint8),
        length=jnp.where(valid, dec.length, 0),
        hdr_ok=dec.hdr_ok & valid,
        crc_ok=dec.crc_ok & valid,
        valid=valid,
        start=(starts_c + state.offset - plen),
        sync_word=jnp.where(valid, res.sync_word, 0).astype(jnp.uint8),
        cfo=jnp.where(valid, res.cfo, 0.0),
        time_offset=jnp.where(valid, res.time_offset, 0.0),
        n_err=jnp.where(valid, dec.n_err, 0),
        n_candidates=n_candidates,
        n_dropped=jnp.maximum(n_candidates - max_packets, 0),
    )
    new_state = StreamRxState(
        tail_r=ext_r[..., chunk_len:],
        tail_i=ext_i[..., chunk_len:],
        offset=state.offset + chunk_len,
    )
    return frames, new_state

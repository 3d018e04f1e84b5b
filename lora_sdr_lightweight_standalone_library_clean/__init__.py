"""LoRa PHY framework in JAX.

A from-scratch JAX/XLA re-design of the LoRa-SDR lightweight standalone
library (reference: yakir1991/LoRa-SDR-Lightweight-Standalone-Library-clean):
batched, jittable, mesh-shardable chirp-spread-spectrum TX/RX with a
matmul DFT core.
"""
import os as _os
from pathlib import Path as _Path

import jax as _jax


def compile_cache_dir() -> str:
    """Persistent compilation cache location: ``JAX_COMPILATION_CACHE_DIR``
    when set (JAX reads it itself), else ``<checkout>/.jax_cache`` — a fixed
    path, because the cache key includes it."""
    return _os.environ.get(
        "JAX_COMPILATION_CACHE_DIR",
        str(_Path(__file__).resolve().parent.parent / ".jax_cache"))


if "JAX_COMPILATION_CACHE_DIR" not in _os.environ:
    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir())
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from .utils.config import LoraParams, Window, load_profiles, params_from_profile, STOCK_PROFILES
from .utils import errors
from .models.modem import (
    encode, decode, modulate, modulate_dechirped, demodulate, demodulate_wide,
    estimate_offsets,
    compensate_offsets, dechirp, to_complex, from_complex, crc_sx1272,
    DemodResult, OffsetEstimate,
)
from .models.tones import demodulate_tones
from .models import lorawan, sweep
from .models.frame import (
    encode_frame, decode_frame, decode_frame_padded, decode_header,
    frame_symbols, max_frame_symbols, FrameHeader, FrameResult,
)
from .ops import channel
from .parallel import mesh, streaming
from .parallel.receiver import (
    receive_stream, receive_stream_frames, stream_rx_init,
    stream_frames_init, packet_samples, StreamRxState,
    RecoveredPackets, RecoveredFrames,
)

__version__ = "0.1.0"

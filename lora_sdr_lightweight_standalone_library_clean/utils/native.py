"""ctypes bridge to the native host runtime (native/liblora_host.so).

The accelerator (through JAX) owns the DSP compute path; the native library owns host-side
runtime work mirroring the reference's C components: AES-128/CMAC for the
LoRaWAN MIC, the byte-codec fast path, and float32 IQ file IO.  Builds
lazily with `make` on first use; callers must handle ``None`` (pure-Python
fallbacks live next to each call site).
"""
from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

_NATIVE_DIR = Path(__file__).resolve().parent.parent.parent / "native"
_LIB_PATH = _NATIVE_DIR / "liblora_host.so"
_lib = None
_tried = False


def load():
    """Load (building if necessary) the native library, or return None."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    try:
        if not _LIB_PATH.exists():
            subprocess.run(["make", "-s"], cwd=_NATIVE_DIR, check=True,
                           capture_output=True, timeout=120)
        lib = ctypes.CDLL(str(_LIB_PATH))
        lib.lora_wan_mic.restype = ctypes.c_uint32
        lib.lora_wan_mic.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_uint32,
            ctypes.c_uint32, ctypes.POINTER(ctypes.c_uint8), ctypes.c_uint64]
        lib.lora_host_crc.restype = ctypes.c_uint16
        lib.lora_host_read_iq.restype = ctypes.c_int64
        lib.lora_host_write_iq.restype = ctypes.c_int64
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def aes_ecb_encrypt(key: bytes, block: bytes) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    buf = (ctypes.c_uint8 * 16)(*block)
    lib.lora_aes128_ecb_encrypt((ctypes.c_uint8 * 16)(*key), buf)
    return bytes(buf)


def cmac(key: bytes, msg: bytes) -> bytes | None:
    lib = load()
    if lib is None:
        return None
    mac = (ctypes.c_uint8 * 16)()
    lib.lora_cmac((ctypes.c_uint8 * 16)(*key),
                  (ctypes.c_uint8 * max(len(msg), 1))(*msg), len(msg), mac)
    return bytes(mac)


def wan_mic(key: bytes, uplink: bool, devaddr: int, fcnt: int,
            msg: bytes) -> int | None:
    lib = load()
    if lib is None:
        return None
    return int(lib.lora_wan_mic(
        (ctypes.c_uint8 * 16)(*key), int(uplink), devaddr & 0xFFFFFFFF,
        fcnt & 0xFFFFFFFF,
        (ctypes.c_uint8 * max(len(msg), 1))(*msg), len(msg)))

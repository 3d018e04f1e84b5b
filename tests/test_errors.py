"""Error-contract tests mirroring tests/error_code_test.cpp.

The C API returns negative errnos; the functional API raises typed
exceptions carrying the identical errno values (utils/errors.py).
"""
import errno

import numpy as np
import pytest

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.utils.errors import (
    InvalidArgumentError, RangeError, LoraError)


def test_invalid_params():
    with pytest.raises(ValueError):
        L.LoraParams(sf=13)
    with pytest.raises(ValueError):
        L.LoraParams(sf=1)
    with pytest.raises(ValueError):
        L.LoraParams(bw=100000)
    with pytest.raises(ValueError):
        L.LoraParams(osr=0)


def test_decode_odd_symbol_count():
    """odd count -> EINVAL (LoRaDecoder.cpp:10, odd_symbol_count_test.cpp)."""
    with pytest.raises(InvalidArgumentError) as ei:
        L.decode(np.zeros((1, 3), np.uint16))
    assert ei.value.errno == errno.EINVAL


def test_demodulate_misaligned_length():
    """non-multiple of step -> EINVAL (phy.cpp:190)."""
    p = L.LoraParams(sf=7)
    bad = np.zeros((1, 10), np.float32)
    with pytest.raises(InvalidArgumentError) as ei:
        L.demodulate(bad, bad, p)
    assert ei.value.errno == errno.EINVAL


def test_demodulate_too_few_symbols():
    """fewer than two symbols -> ERANGE (phy.cpp:192)."""
    p = L.LoraParams(sf=7)
    one = np.zeros((1, p.step), np.float32)
    with pytest.raises(RangeError) as ei:
        L.demodulate(one, one, p)
    assert ei.value.errno == errno.ERANGE


def test_demodulate_symbol_cap_overflow():
    """symbol_cap smaller than produced symbols -> ERANGE (phy.cpp:194)."""
    p = L.LoraParams(sf=7)
    iq = np.zeros((1, 4 * p.step), np.float32)
    with pytest.raises(RangeError):
        L.demodulate(iq, iq, p, symbol_cap=1)


def test_estimate_offsets_empty():
    p = L.LoraParams(sf=7)
    with pytest.raises(InvalidArgumentError):
        L.estimate_offsets(np.zeros((1, 4), np.float32),
                           np.zeros((1, 4), np.float32), p)


def test_error_hierarchy():
    assert issubclass(InvalidArgumentError, LoraError)
    assert issubclass(RangeError, LoraError)
    assert InvalidArgumentError.errno == errno.EINVAL
    assert RangeError.errno == errno.ERANGE


def test_shipped_profiles_match_stock():
    """The shipped profiles.yaml parses (reference subset format,
    tests/profiles.yaml) and stays in sync with STOCK_PROFILES."""
    from lora_sdr_lightweight_standalone_library_clean.utils.config import (
        PROFILES_PATH)
    loaded = L.load_profiles(PROFILES_PATH)
    assert len(loaded) == len(L.STOCK_PROFILES) == 7
    for got, want in zip(loaded, L.STOCK_PROFILES):
        for key in ("name", "sf", "bw", "cr"):
            assert got[key] == want[key]
        L.params_from_profile(got)  # constructible

"""Every floating-point matmul of the DFT and the TX tone tables is traced
with HIGHEST precision, so no GPU rounds it to TF32."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax

import lora_sdr_lightweight_standalone_library_clean as L
from lora_sdr_lightweight_standalone_library_clean.ops.chirp import (
    modulate_ri)
from lora_sdr_lightweight_standalone_library_clean.ops.dft import dft_ri


def _dot_generals(jaxpr):
    """All dot_general equations of a closed jaxpr, sub-jaxprs included."""
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "dot_general":
            yield eqn
        for sub in jax.core.jaxprs_in_params(eqn.params):
            yield from _dot_generals(sub)


def _float_precisions(fn, *args):
    eqns = list(_dot_generals(jax.make_jaxpr(fn)(*args).jaxpr))
    assert eqns, "traced no matmul"
    return {e.params["precision"] for e in eqns
            if jnp.issubdtype(e.invars[0].aval.dtype, jnp.floating)
            and jnp.issubdtype(e.invars[1].aval.dtype, jnp.floating)}


HIGHEST = (lax.Precision.HIGHEST, lax.Precision.HIGHEST)


@pytest.mark.parametrize("n", [128, 4096, 16384],
                         ids=["dense", "four_step", "four_step_wide"])
def test_dft_matmuls_are_highest(n):
    z = jnp.zeros((2, n), jnp.float32)
    assert _float_precisions(dft_ri, z, z) == {HIGHEST}


@pytest.mark.parametrize("sf", [7, 11], ids=["dense", "factored"])
def test_tone_table_matmuls_are_highest(sf):
    p = L.LoraParams(sf=sf)
    syms = jnp.zeros((2, 4), jnp.int32)
    got = _float_precisions(
        lambda s: modulate_ri(s, p, method="mxu"), syms)
    # the limb prefix sum is not on this path; every float matmul is a
    # tone-table selection
    assert got == {HIGHEST}


def test_demodulate_tones_matmuls_are_highest():
    p = L.LoraParams(sf=10)
    x = jnp.asarray(np.zeros((2, 6 * p.step), np.float32))
    assert _float_precisions(lambda r, i: L.demodulate_tones(r, i, p),
                             x, x) == {HIGHEST}

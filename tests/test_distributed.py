"""Multi-host distributed layer.

Launches a real 2-process x 4-virtual-CPU-device jax.distributed cluster
(coordinator + Gloo collectives over localhost) and runs the full sharded
pipeline + streaming receiver in tests/_mp_worker.py.  Also unit-tests the
mesh constructors single-process.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import jax

REPO = Path(__file__).resolve().parent.parent

needs_8 = pytest.mark.skipif(len(jax.devices()) < 8,
                             reason="needs 8 virtual devices")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_process_cluster_runs_sharded_pipeline():
    """2 processes x 4 local devices: ('host','dp','sp') mesh, channel-DP
    round-trip with a cross-DCN reduction, and the sp-sharded streaming
    receiver — all against single-process ground truth."""
    port = free_port()
    env = {k: v for k, v in os.environ.items() if k != "JAX_PLATFORMS"}
    procs = [
        subprocess.Popen(
            [sys.executable, str(REPO / "tests" / "_mp_worker.py"),
             str(pid), "2", str(port)],
            cwd=REPO, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        for pid in range(2)
    ]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        outs.append((p.returncode, out.decode(), err.decode()))
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"
    assert "MP OK 0" in outs[0][1]
    assert "MP OK 1" in outs[1][1]


@needs_8
def test_global_mesh_single_process():
    """Single-process fallback: host axis has size 1... or the virtual
    host reshape used by dryrun_multichip stays consistent."""
    from lora_sdr_lightweight_standalone_library_clean.parallel import (
        distributed as D)
    mesh = D.global_mesh(dp=4, sp=2)
    assert dict(mesh.shape) == {"host": 1, "dp": 4, "sp": 2}
    sh = D.channel_sharding(mesh)
    arr = D.make_global_array(np.arange(16, dtype=np.float32).reshape(8, 2),
                              sh)
    got = D.allgather(arr)
    np.testing.assert_array_equal(got, np.arange(16).reshape(8, 2))


@needs_8
def test_channel_sharding_zero_collectives():
    """The channel-DP pipeline compiles with no cross-device collectives:
    each device demodulates its own channels (the layout that makes DCN
    scaling linear)."""
    import jax.numpy as jnp
    import lora_sdr_lightweight_standalone_library_clean as L
    from lora_sdr_lightweight_standalone_library_clean.parallel import (
        distributed as D)

    mesh = D.global_mesh(dp=8, sp=1)
    params = L.LoraParams(sf=7)
    payloads = np.arange(16 * 8, dtype=np.uint8).reshape(16, 8)
    gpay = D.make_global_array(payloads, D.channel_sharding(mesh))

    @jax.jit
    def pipeline(pl):
        syms = L.encode(pl)
        re, im = L.modulate(syms, params)
        dr, di = L.dechirp(re, im, params)
        res = L.demodulate_tones(dr, di, params)
        dec, _ = L.decode(res.symbols)
        return dec

    txt = pipeline.lower(gpay).compile().as_text()
    for coll in ("all-reduce", "all-gather", "collective-permute",
                 "all-to-all", "reduce-scatter"):
        assert coll not in txt, f"unexpected collective {coll} in channel-DP"
    np.testing.assert_array_equal(np.asarray(pipeline(gpay)), payloads)

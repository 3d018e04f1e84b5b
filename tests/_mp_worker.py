"""Multi-process worker for tests/test_distributed.py.

Run as: python tests/_mp_worker.py <process_id> <num_processes> <port>

Initializes a 2-process x 4-virtual-CPU-device cluster, builds the
('host','dp','sp') global mesh, and proves the two distributed paths:

 1. channel data parallelism: a global payload batch sharded over
    ('host','dp') round-trips encode->modulate->dechirp->demod->decode
    bit-exactly, with a cross-DCN metric reduction (global decode-rate);
 2. sequence parallelism: the streaming receiver recovers packets from a
    stream sharded over 'sp', identical to ground truth.

Prints "MP OK <pid>" and exits 0 on success.
"""
import os
import sys

pid, nproc, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
os.environ.pop("JAX_PLATFORMS", None)

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import functools  # noqa: E402

import lora_sdr_lightweight_standalone_library_clean as L  # noqa: E402
from lora_sdr_lightweight_standalone_library_clean.parallel import (  # noqa: E402
    distributed as D)

ok = D.init_distributed(coordinator_address=f"localhost:{port}",
                        num_processes=nproc, process_id=pid)
assert ok and jax.process_count() == nproc, "cluster init failed"
assert jax.device_count() == 4 * nproc
assert jax.local_device_count() == 4

mesh = D.global_mesh(dp=2, sp=2)
assert dict(mesh.shape) == {"host": nproc, "dp": 2, "sp": 2}
# host axis must be the process boundary: all devices in one host row
# belong to one process
for h in range(nproc):
    procs = {d.process_index for d in mesh.devices[h].ravel()}
    assert procs == {h}, f"host row {h} spans processes {procs}"

params = L.LoraParams(sf=7)
rng = np.random.default_rng(17)

# --- 1. channel-DP pipeline over ('host', 'dp') --------------------------
batch = nproc * 2 * 4                  # 2 packets per (host, dp) shard
payloads = rng.integers(0, 256, (batch, 12)).astype(np.uint8)
gpay = D.make_global_array(payloads, D.channel_sharding(mesh))


@jax.jit
def pipeline(pl):
    syms = L.encode(pl)
    re, im = L.modulate(syms, params)
    dr, di = L.dechirp(re, im, params)
    res = L.demodulate_tones(dr, di, params)
    dec, _ = L.decode(res.symbols)
    # cross-DCN metric reduction: global fraction of exact decodes
    rate = jnp.mean((dec == pl).all(-1).astype(jnp.float32))
    return dec, rate


dec, rate = pipeline(gpay)
assert float(rate) == 1.0, float(rate)
np.testing.assert_array_equal(D.allgather(dec), payloads)

# --- 2. streaming receiver over 'sp' ----------------------------------
from lora_sdr_lightweight_standalone_library_clean.models.modem import (  # noqa: E402
    crc_sx1272)
from lora_sdr_lightweight_standalone_library_clean.parallel.receiver import (  # noqa: E402
    receive_stream, packet_samples)


def crc_frame(body):
    crc = int(np.asarray(crc_sx1272(jnp.asarray(body[2:]))))
    return np.concatenate([body, [crc & 0xFF, crc >> 8]]).astype(np.uint8)


psyms = 16
plen = packet_samples(params, psyms)
stream_len = 16384
sr = rng.standard_normal(stream_len).astype(np.float32) * 0.03
si = rng.standard_normal(stream_len).astype(np.float32) * 0.03
offsets = [777, 9003]
frames = []
for g in offsets:
    pl = crc_frame(rng.integers(0, 256, 6).astype(np.uint8))
    frames.append(pl)
    re, im = L.modulate(L.encode(pl[None]), params)
    sr[g:g + plen] += np.asarray(re)[0]
    si[g:g + plen] += np.asarray(im)[0]

gsr = D.make_global_array(sr, D.stream_sharding(mesh))
gsi = D.make_global_array(si, D.stream_sharding(mesh))

rx = jax.jit(functools.partial(
    receive_stream, params=params, payload_symbols=psyms, max_packets=4,
    mesh=mesh))
pkts, _ = rx(gsr, gsi)
valid = D.allgather(pkts.valid)
starts = D.allgather(pkts.start)
got_payloads = D.allgather(pkts.payload)
crc_ok = D.allgather(pkts.crc_ok)
assert valid.sum() == len(offsets), (valid, starts)
np.testing.assert_array_equal(starts[: len(offsets)], offsets)
for k, f in enumerate(frames):
    np.testing.assert_array_equal(got_payloads[k], f)
    assert crc_ok[k]

print(f"MP OK {pid}", flush=True)

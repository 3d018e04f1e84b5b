"""Streaming RX CLI: continuous float32 IQ -> one line per decoded packet.

The capability the reference lacks (its rx_runner needs a caller-aligned
single packet): scan a long multi-packet capture, recover every packet at
any sample offset, print position/CRC/payload.  Chunked internally with
carried state, so arbitrarily long files stream in bounded memory.

Usage:
    python -m ...runners.stream_rx --in=capture.f32 --sf=7 \
        --payload-bytes=16 [--chunk=65536] [--max-packets=16] [--bw=...]

Output (stdout), one line per packet:
    <start_sample> <crc_ok> <payload_hex>
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import jax.numpy as jnp

from .. import (LoraParams, receive_stream, receive_stream_frames,
                stream_rx_init, packet_samples)
from ..models import frame as frame_codec
from ..parallel.receiver import (stream_frames_init, _resolve_wide,
                                 _default_stride)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="LoRa streaming RX: multi-packet IQ -> payloads")
    ap.add_argument("--in", dest="infile", default="-",
                    help="float32 interleaved IQ file ('-' = stdin)")
    ap.add_argument("--sf", type=int, default=7)
    ap.add_argument("--bw", type=int, default=125000)
    ap.add_argument("--cr", default="4/5")
    ap.add_argument("--osr", type=int, default=1)
    ap.add_argument("--payload-bytes", type=int, required=True,
                    help="expected payload length (fixed, headerless), or "
                         "the maximum length with --framed")
    ap.add_argument("--framed", action="store_true",
                    help="header-driven variable-length frames "
                         "(receive_stream_frames): each line also reports "
                         "the decoded length and header verdict")
    ap.add_argument("--chunk", type=int, default=65536,
                    help="samples per processing chunk")
    ap.add_argument("--max-packets", type=int, default=16,
                    help="recovery capacity per chunk")
    ap.add_argument("--power-gate-db", type=float, default=3.0)
    ap.add_argument("--wide", choices=["auto", "on", "off"], default="auto",
                    help="injective osr>=bw_scale receiver for BW-250/500 "
                         "streams (demodulate_wide — the reference cannot "
                         "decode these profiles at all); 'auto' enables it "
                         "when bw_scale > 1 and osr >= bw_scale")
    return ap


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    try:
        raw = (sys.stdin.buffer.read() if args.infile == "-"
               else open(args.infile, "rb").read())
    except OSError as e:
        print(f"stream_rx: cannot read {args.infile}: {e.strerror}",
              file=sys.stderr)
        return 1
    f = np.frombuffer(raw[: len(raw) - len(raw) % 8], np.float32)
    iq_r = np.ascontiguousarray(f[0::2])
    iq_i = np.ascontiguousarray(f[1::2])
    params = LoraParams(sf=args.sf, bw=args.bw, cr=args.cr, osr=args.osr)
    wide = {"auto": None, "on": True, "off": False}[args.wide]
    if args.framed:
        psyms = frame_codec.max_frame_symbols(params, args.payload_bytes)
    else:
        psyms = args.payload_bytes * 2
    plen = packet_samples(params, psyms)

    stride = _default_stride(params, _resolve_wide(params, wide))
    chunk = max(args.chunk, plen) // stride * stride
    # pad the capture to whole chunks so trailing packets complete
    total = ((iq_r.size + plen + chunk - 1) // chunk) * chunk
    iq_r = np.pad(iq_r, (0, total - iq_r.size))
    iq_i = np.pad(iq_i, (0, total - iq_i.size))

    state = (stream_frames_init(params, args.payload_bytes) if args.framed
             else stream_rx_init(params, psyms))
    found = 0
    for lo in range(0, total, chunk):
        cr_ = jnp.asarray(iq_r[lo:lo + chunk])
        ci_ = jnp.asarray(iq_i[lo:lo + chunk])
        if args.framed:
            pkts, state = receive_stream_frames(
                cr_, ci_, params, max_payload_len=args.payload_bytes,
                max_packets=args.max_packets, state=state,
                power_gate_db=args.power_gate_db, wide=wide)
        else:
            pkts, state = receive_stream(
                cr_, ci_, params, payload_symbols=psyms,
                max_packets=args.max_packets, state=state,
                power_gate_db=args.power_gate_db, wide=wide)
        valid = np.asarray(pkts.valid)
        for k in np.nonzero(valid)[0]:
            if args.framed:
                ln = int(np.asarray(pkts.length)[k])
                payload = bytes(np.asarray(pkts.payload)[k][:ln]).hex().upper()
                print(f"{int(np.asarray(pkts.start)[k])} "
                      f"{int(bool(np.asarray(pkts.crc_ok)[k]))} {payload} "
                      f"len={ln} hdr_ok={int(bool(np.asarray(pkts.hdr_ok)[k]))}")
            else:
                payload = bytes(np.asarray(pkts.payload)[k]).hex().upper()
                print(f"{int(np.asarray(pkts.start)[k])} "
                      f"{int(bool(np.asarray(pkts.crc_ok)[k]))} {payload}")
            found += 1
    print(f"stream_rx: {found} packets recovered", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

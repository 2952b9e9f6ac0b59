"""256-channel REAL receiver session (VERDICT r4 #6).

Round 4 proved 13.5 G channel-samp/s at the KERNEL level
(tools/scaling_channels.py); this runs the real `Receiver` loop — host
nav framers, epoch alignment, acquisition retries included — at 8x the
reference's NCH=32 ceiling (bin/gnss-sdrcli.ini:5): 256 channels as 8
copies of PRNs 1-32 against the cached 12-satellite capture, so the
steady state tracks 96 locked channels while 160 keep the ACQSLEEP
retry cadence.  RINEX stays off (8 channel-sets produce duplicate
(sys,prn) observables per epoch, which is a serving scenario, not a
single-antenna RINEX file); the epoch aligner and nav decoders run.

Prints one JSON line: steady-state stream Msps, aggregate
channel-Msamples/s (stream rate x 256 channels), x-real-time vs the
32-ch envelope, and a host-stage wall budget table on stderr.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run from any cwd
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import json
import sys
import time

import numpy as np

import receiver_throughput as rxt

NCOPIES = 8
C = 32 * NCOPIES


def main() -> int:
    rxt.synthesize()
    from gnsslib_tpu.constants import DType, FrontendType
    from gnsslib_tpu.io.frontend import FileFrontend, FrontendSpec
    from gnsslib_tpu.runtime.config import ReceiverConfig, ChannelConfig
    from gnsslib_tpu.runtime.receiver import Receiver
    from gnsslib_tpu.track.state import TrackConfig
    import jax

    spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                        f_sf=rxt.F_SF, f_if=rxt.F_IF, dtype=DType.REAL)
    cfg = ReceiverConfig(
        channels=[ChannelConfig(prn=(i % 32) + 1) for i in range(C)],
        fends=[spec], files=[rxt.CACHE],
        track=TrackConfig(corrn=6, corrd=3, corrp=6),
        outms=400, rinex=False)

    nsteps = int(_os.environ.get("GNSSLIB_256CH_NSTEPS", "400"))
    depth = int(_os.environ.get("GNSSLIB_256CH_DEPTH", "2"))

    def build():
        rx = Receiver(cfg, FileFrontend(rxt.CACHE, spec),
                      nsteps_per_block=nsteps, pipeline_depth=depth)
        # post-processing throughput mode (see receiver_throughput.py):
        # this tool measures the device-resident steady state, so keep the
        # whole-capture prefetch out of the measured window instead of
        # the receiver's default latency-first rung ladder
        from gnsslib_tpu.io.devcache import DeviceBlockCache
        rx.cache = DeviceBlockCache(rx.frontend, rx.block_len,
                                    latency_first=False,
                                    stride=rx.nsteps * rx.nsamp)
        return rx

    T = {}

    def timed(obj, name, label):
        fn = getattr(obj, name)

        def wrap(*a, **k):
            t0 = time.time()
            r = fn(*a, **k)
            T.setdefault(label, []).append(time.time() - t0)
            return r
        setattr(obj, name, wrap)

    print(f"# building {C}-channel receiver (pass 1 compiles)...",
          file=sys.stderr, flush=True)
    t0 = time.time()
    rx = build()
    s1 = rx.run_seconds()
    print(f"# pass1 {time.time() - t0:.1f}s locked={len(s1['locked'])} "
          f"decoded={len(s1['decoded'])} epochs={s1['epochs']}",
          file=sys.stderr, flush=True)

    rx = build()
    timed(rx, "_feed_nav_and_obs", "nav+obs(host)")
    timed(rx, "_emit_epochs", "emit(host)")
    timed(rx, "_collect", "telem.join+feed")
    timed(rx, "_collect_acq", "acq.join+apply")
    timed(rx, "_try_acquire", "acq.dispatch")
    if rx.fast is not None:
        timed(rx.fast, "run_block_collect", "fast.collect(bg)")

    t0 = time.time()
    t_steady = base_steady = None
    end = rx.end_sample()
    walls = []
    t_prev = time.time()
    nblocks = 0
    while rx.can_step(end):
        rx.step_block()
        nblocks += 1
        now = time.time()
        if t_steady is not None:
            walls.append(now - t_prev)
        t_prev = now
        if t_steady is None and any(
                ch.locked for ch in rx.channels) and all(
                ch.synced for ch in rx.channels if ch.locked):
            t_steady, base_steady = time.time(), rx.base
            t_prev = t_steady
    rx.flush()
    wall = time.time() - t0
    locked = sum(1 for ch in rx.channels if ch.locked)
    decoded = sum(1 for ch in rx.channels if ch.nav.flagdec)
    msps_life = rx.base / 1e6 / wall
    out = dict(metric="receiver_256ch", channels=C, locked=locked,
               decoded=decoded, epochs=rx.epochs_written,
               msps_lifecycle=round(msps_life, 2),
               unit="Msamples/s", device=jax.devices()[0].platform)
    if t_steady is not None and rx.base > base_steady:
        msps = (rx.base - base_steady) / 1e6 / max(
            time.time() - t_steady, 1e-9)
        out["msps_steady_avg"] = round(msps, 2)
        out["aggregate_channel_msps"] = round(msps * C, 1)
        out["aggregate_x_32ch_realtime"] = round(
            msps * NCOPIES / rxt.F_SF * 1e6, 2)
    if len(walls) >= 10:
        med = float(np.median(np.sort(np.asarray(walls))[2:]))
        p50 = nsteps * rx.nsamp / 1e6 / med
        out["msps_steady_p50"] = round(p50, 2)
        out["aggregate_p50_channel_msps"] = round(p50 * C, 1)
        out["aggregate_p50_x_32ch"] = round(
            p50 * NCOPIES / rxt.F_SF * 1e6, 2)
    print("# host-stage budget (sum over run / per block):",
          file=sys.stderr)
    for k in sorted(T, key=lambda k: -sum(T[k])):
        v = np.asarray(T[k])
        print(f"#   {k:18s} {v.sum():7.2f}s x{len(v)}  "
              f"med {np.median(v) * 1e3:7.1f} ms", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

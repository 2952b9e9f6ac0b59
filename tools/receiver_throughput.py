"""Receiver-level throughput: the REAL `Receiver.run_seconds` loop —
acquisition retries, device tracking, host nav framers, epoch alignment,
RINEX-less output path — on a synthesized multi-satellite capture at the
reference's 16.368 Msps post-processing envelope (frontend/iffile.ini).

Unlike bench.py (FastTracker-only device throughput) this includes every
host-side cost and the acquisition program for never-present PRNs, so it
is the end-user streaming number.  Compares pipeline=True/False.

The capture is the demo sky of gnsslib_tpu.sim, cached under the
checkout's git-ignored ``.captures/`` (synthesized once, on NumPy worker
processes that never open a device).
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run from any cwd
import json
import os
import sys
import time

import numpy as np

F_SF = 16.368e6
F_IF = 4.092e6
SECONDS = float(os.environ.get("GNSSLIB_RXBENCH_SECONDS", "20"))
NPRESENT = 12                      # satellites actually in the signal
# capture cache keyed by length, so a 40/60 s lifecycle run does not
# clobber the receiver-session capture other tools share
CACHE = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))),
    ".captures", f"rxbench_l1ca_16m_{SECONDS:g}s.bin")
META = CACHE + ".json"


def synthesize():
    from gnsslib_tpu import sim
    meta = dict(f_sf=F_SF, f_if=F_IF, seconds=SECONDS, n=NPRESENT)
    if os.path.exists(CACHE) and os.path.exists(META):
        if json.load(open(META)) == meta:
            return
    os.makedirs(os.path.dirname(CACHE), exist_ok=True)
    t_start = time.time()
    sim.write_demo_capture(CACHE, SECONDS, F_SF, F_IF, npresent=NPRESENT)
    print(f"  synthesized {SECONDS:.0f} s in {time.time() - t_start:.0f} s",
          flush=True)
    json.dump(meta, open(META, "w"))


def run(pipeline: bool, nsteps: int = 400, depth: int = 2) -> dict:
    import contextlib
    import tempfile
    with contextlib.ExitStack() as stack:
        return _run(pipeline, nsteps, depth, stack.enter_context(
            tempfile.TemporaryDirectory(prefix="gnsslib_rxbench_")))


def _run(pipeline: bool, nsteps: int, depth: int, rinexdir: str) -> dict:
    from gnsslib_tpu.constants import DType, FrontendType
    from gnsslib_tpu.io.frontend import FileFrontend, FrontendSpec
    from gnsslib_tpu.runtime.config import ReceiverConfig, ChannelConfig
    from gnsslib_tpu.runtime.receiver import Receiver
    from gnsslib_tpu.track.state import TrackConfig

    spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                        f_if=F_IF, dtype=DType.REAL)
    cfg = ReceiverConfig(
        channels=[ChannelConfig(prn=p) for p in range(1, 33)],
        fends=[spec], files=[CACHE],
        track=TrackConfig(corrn=6, corrd=3, corrp=6),   # iffile.ini
        outms=400, rinex=True,                 # full output path ON
        rinexpath=rinexdir)
    acq_depth = int(os.environ.get("GNSSLIB_ACQ_DEPTH", "2"))

    def throughput_cache(r):
        # post-processing throughput mode: this tool measures the
        # device-resident steady state, so keep the single whole-capture
        # prefetch (completed during pull-in, outside the measured
        # window) instead of the receiver's default latency-first rung
        # ladder, whose catch-up uploads would land INSIDE the steady
        # window and be charged to compute (see io/devcache.py).
        from gnsslib_tpu.io.devcache import DeviceBlockCache
        r.cache = DeviceBlockCache(r.frontend, r.block_len,
                                   latency_first=False,
                                   stride=r.nsteps * r.nsamp)
        return r

    rx = throughput_cache(Receiver(
        cfg, FileFrontend(CACHE, spec), pipeline=pipeline,
        nsteps_per_block=nsteps, pipeline_depth=depth,
        acq_pipeline_depth=acq_depth))
    # compile warmup: first block(s) hit acq + slow-track compiles; run
    # one full pass, then measure a second pass on fresh receiver state
    t0 = time.time()
    s = rx.run_seconds()
    print(f"  pass1 (compile) {time.time() - t0:.1f}s "
          f"locked={len(s['locked'])} decoded={len(s['decoded'])} "
          f"epochs={s['epochs']}")
    rx2 = throughput_cache(Receiver(
        cfg, FileFrontend(CACHE, spec), pipeline=pipeline,
        nsteps_per_block=nsteps, pipeline_depth=depth,
        acq_pipeline_depth=acq_depth))
    # manual loop to split cold-start (acq + per-period pull-in scan, a
    # fixed one-time cost) from steady-state streaming (the sustained
    # production rate)
    t0 = time.time()
    t_steady = base_steady = None
    end = rx2.end_sample()
    nblocks = 0
    block_walls = []
    t_prev = time.time()
    while rx2.can_step(end):
        rx2.step_block()
        nblocks += 1
        now = time.time()
        if t_steady is not None:
            block_walls.append(now - t_prev)
        t_prev = now
        if t_steady is None and all(
                ch.synced for ch in rx2.channels if ch.locked) and \
                any(ch.locked for ch in rx2.channels):
            t_steady, base_steady = time.time(), rx2.base
            t_prev = t_steady
    rx2.flush()
    s = rx2._summary(t0, nblocks)
    if t_steady is not None and rx2.base > base_steady:
        s["msps_steady"] = ((rx2.base - base_steady) / 1e6
                            / max(time.time() - t_steady, 1e-9))
    if len(block_walls) >= max(8, 4 * depth):
        # sustainable (p50) rate: the median block wall under
        # back-pressure is the straggler-robust estimator, the windowed
        # average above the straggler-inclusive one.  The `depth` fastest walls are pipeline-fill credits
        # (dispatch-only steps), not sustained throughput — drop them;
        # short runs without enough sustained blocks get no p50.
        walls = np.sort(np.asarray(block_walls))[depth:]
        med = float(np.median(walls))
        s["msps_steady_p50"] = nsteps * rx2.nsamp / 1e6 / max(med, 1e-9)
        s["n_steady_blocks"] = len(block_walls)
    s["label"] = (("pipelined" if pipeline else "sequential")
                  + f"/{nsteps}/d{depth}")
    return s


def main():
    synthesize()
    if SECONDS < 30.0:
        # the RINEX-nav writer gates on a FULL ephemeris (update flag +
        # 3 decoded subframes, reference sdrsync.c:137-156); with this
        # capture's 6 s bit-stream preamble the third subframe completes
        # ~24.5 s in, so short scenarios legitimately report ephs=0.
        # The pipelined nav-write path itself is asserted by
        # tests/test_receiver.py::test_rinex_nav_record on a 31 s stream.
        print(f"note: SECONDS={SECONDS:.0f} < 30 — the full-ephemeris "
              "nav-writer gate (3 subframes, ~24.5 s) is not reached, "
              "so ephs=0 is expected; set GNSSLIB_RXBENCH_SECONDS=35 "
              "to see nav records written")
        print("note: at 2000-step blocks the depth-2 acquisition "
              "pipeline adds ~4 s of lock latency, which can push "
              "bit-sync past this capture's 6 s preamble and defer the "
              "subframe-1 week anchor to the next 30 s frame — epochs "
              "may then read 0 on this short capture.  The epochs "
              "column is cold-start-sensitive; steady Msps is the "
              "throughput metric.")
    for pipeline, nsteps, depth in ((True, 400, 2), (True, 2000, 2),
                                    (True, 2000, 3), (False, 2000, 2)):
        s = run(pipeline, nsteps, depth)
        stdy = s.get("msps_steady")
        stdy = f"steady {stdy:6.1f} ({stdy / 16.368:4.1f}x rt)" if stdy \
            else ""
        p50 = s.get("msps_steady_p50")
        p50 = f"p50 {p50:6.1f} ({p50 / 16.368:4.1f}x)" if p50 else ""
        print(f"{s['label']:16s} {s['msps']:7.1f} Msps "
              f"({s['msps'] / 16.368:4.1f}x real-time)  {stdy}  {p50}  "
              f"locked={len(s['locked'])} decoded={len(s['decoded'])} "
              f"epochs={s['epochs']} ephs={s['ephs']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

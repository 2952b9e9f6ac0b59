"""Time-to-first-fix instrumentation (VERDICT r4 #3).

Measures, in ONE fresh process, every cold-start stage of the real
receiver on the rxbench capture:

  attach        — import jax + jax.devices() (backend initialization)
  build         — Receiver construction (tables, caches, consts upload)
  first_block   — first step_block returned (acquisition + per-period
                  tracking compiles; persistent-cache hits make this
                  seconds, misses minutes)
  first_lock    — first channel accepted by acquisition
  first_sync    — first nav bit sync
  steady        — every locked channel synced; fast path engaged
                  (FastTracker compile happens at the next block)
  first_epoch   — first observable epoch emitted (the RINEX TTFF)
  total         — whole run; msps_lifecycle = samples/1e6/total

All stage values are wall seconds since process start (t=0 at module
import).  Prints ONE JSON line; `--twice` runs a second receiver in the
same process to separate persistent-cache effects (fresh process, warm
disk cache) from in-process warmth (everything compiled).

Reference contrast: the C receiver starts tracking in < 1 s of wall
(no compile stage) — /root/reference/src/sdrmain.c:105-173.
"""
import os as _os
import sys as _sys
import time

T0 = time.time()

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run from any cwd
_sys.path.insert(0, _os.path.dirname(_os.path.abspath(__file__)))

import argparse
import json


def _run_once(rxt, stamp, label, stream=False):
    import jax
    from gnsslib_tpu.constants import DType, FrontendType
    from gnsslib_tpu.io.frontend import FileFrontend, FrontendSpec
    from gnsslib_tpu.runtime.config import ReceiverConfig, ChannelConfig
    from gnsslib_tpu.runtime.receiver import Receiver
    from gnsslib_tpu.track.state import TrackConfig
    import contextlib
    import tempfile

    spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9,
                        f_sf=rxt.F_SF, f_if=rxt.F_IF, dtype=DType.REAL)
    with tempfile.TemporaryDirectory(prefix="gnsslib_ttff_") as rinexdir:
        cfg = ReceiverConfig(
            channels=[ChannelConfig(prn=p) for p in range(1, 33)],
            fends=[spec], files=[rxt.CACHE],
            track=TrackConfig(corrn=6, corrd=3, corrp=6),
            outms=400, rinex=True, rinexpath=rinexdir)
        t_build0 = time.time()
        fe = FileFrontend(rxt.CACHE, spec)
        rx = Receiver(cfg, fe)
        if stream:
            # live-mode ingest: short rolling segments (the live
            # frontend default) instead of whole-capture device residency,
            # so the pull-in phase is not contended by the batch upload
            # — the honest TTFF for a real-time front end, where
            # samples arrive paced anyway (nothing has touched the
            # default cache yet; swapping it pre-run is safe)
            from gnsslib_tpu.io.devcache import DeviceBlockCache
            rx.cache = DeviceBlockCache(fe, rx.block_len, seg_blocks=16)
        stamp(f"{label}build")
        s = rx.run_seconds()
        t_end = time.time()
        tl = {k: round(v + (rx.timeline["t0"] - T0), 2)
              for k, v in rx.timeline.items() if k != "t0"}
        tl[f"{label}build"] = round(t_build0 - T0, 2)
        return dict(
            timeline=tl,
            total_s=round(t_end - T0, 2),
            run_wall_s=round(t_end - rx.timeline["t0"], 2),
            msps_lifecycle=round(s["samples"] / 1e6
                                 / max(t_end - rx.timeline["t0"], 1e-9), 2),
            msps_from_proc_start=round(s["samples"] / 1e6
                                       / max(t_end - T0, 1e-9), 2),
            stream_s=round(s["seconds"], 1),
            locked=len(s["locked"]), decoded=len(s["decoded"]),
            epochs=s["epochs"],
            device=jax.devices()[0].platform,
        )


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seconds", type=float, default=None,
                    help="capture length (default: rxbench's 20 s; "
                    "set GNSSLIB_RXBENCH_SECONDS for 60 s lifecycle runs)")
    ap.add_argument("--twice", action="store_true",
                    help="run a second receiver in-process (warm)")
    ap.add_argument("--stream", action="store_true",
                    help="live-mode ingest (short rolling segments) "
                    "instead of whole-capture device residency")
    args = ap.parse_args()
    if args.seconds is not None:
        _os.environ["GNSSLIB_RXBENCH_SECONDS"] = str(args.seconds)

    marks = {}

    def stamp(name):
        marks[name] = round(time.time() - T0, 2)

    global T0
    import receiver_throughput as rxt
    t_synth0 = time.time()
    rxt.synthesize()                  # harness cost, reported separately
    synth_s = round(time.time() - t_synth0, 2)
    # restart the clock AFTER the synthesis harness: on a cold capture
    # cache it costs minutes and must not inflate attach/first_epoch
    T0 = time.time()
    import jax
    stamp("jax_import")
    dev = jax.devices()[0].platform
    stamp("attach")

    r1 = _run_once(rxt, stamp, "", stream=args.stream)
    out = dict(metric="ttff", unit="s",
               mode="stream" if args.stream else "resident",
               synth_harness_s=synth_s,
               attach_s=marks["attach"],
               **{k: v for k, v in r1.items() if k != "timeline"},
               **r1["timeline"])
    if args.twice:
        T0 = time.time()
        r2 = _run_once(rxt, stamp, "warm_", stream=args.stream)
        out["warm"] = dict(**{k: v for k, v in r2.items()
                              if k != "timeline"}, **r2["timeline"])
    out["device"] = dev
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    _sys.exit(main())

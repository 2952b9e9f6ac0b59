"""Two-process FULL-receiver demo (jax.distributed, CPU): the complete
acquisition -> tracking -> nav decode -> observables -> RINEX pipeline
with the channel axis sharded over a global 2-host x 2-device mesh.

Every process runs the same Receiver program (the multi-controller SPMD
contract): device work executes on each host's channel shard, telemetry
is allgathered, and the deterministic host logic (framers, epoch
aligner) replays identically everywhere; process 0 alone plays the
reference sync-thread role and writes RINEX (src/sdrsync.c:49-135 —
the reference itself is strictly single-process, SURVEY.md §2.4).  CPU
multi-process by design: both processes are pinned to the CPU backend
and never open a GPU.

Run:

    python tools/multihost_receiver_demo.py     # spawns both processes

Prints ``MULTIHOST RECEIVER OK`` on success: both processes acquired and
decoded every satellite, events agree, and process 0 wrote obs epochs.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile

COORD = "127.0.0.1:39934"
NPROC = 2
CAPTURE = os.path.join(tempfile.gettempdir(), "gnsslib_mh_rx.bin")
F_SF, F_IF = 4.092e6, 1.023e6
PRNS = [2, 5, 9, 12]
SECONDS = 16.0          # 6 s bit-sync pad + 2 LNAV frames + margin


def make_capture() -> None:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import numpy as np
    from gnsslib_tpu import sim
    from gnsslib_tpu.constants import DType
    if os.path.exists(CAPTURE):
        return
    chans = []
    for p in PRNS:
        eph = sim.example_eph(prn=p, week=2200, toe_tow=352800.0)
        frames = sim.lnav_bit_stream(eph, 352806.0, nframes=3)
        pad = np.concatenate([np.tile([1, -1], 149), [1, 1]]).astype(np.int8)
        chans.append(sim.SimChannel(
            prn=p, doppler=300.0 * p - 1500.0, code_phase=40.0 * p,
            nav_bits=np.concatenate([pad, frames])))
    noise = sim.noise_std_for_cn0(1.0, 46.0, F_SF, DType.REAL)
    n = int(SECONDS * F_SF)
    with open(CAPTURE + ".tmp", "wb") as f:
        step = int(F_SF)
        for t0 in range(0, n, step):
            x = sim.synthesize(chans, F_SF, F_IF, DType.REAL,
                               min(step, n - t0), noise_std=noise,
                               seed=77 + t0, t0=t0)
            sim.quantize_int8(x, 16.0).tofile(f)
    os.replace(CAPTURE + ".tmp", CAPTURE)


def worker(pid: int, outdir: str) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    jax.config.update("jax_platforms", "cpu")
    from gnsslib_tpu.constants import DType, FrontendType
    from gnsslib_tpu.io.frontend import FileFrontend, FrontendSpec
    from gnsslib_tpu.parallel.distributed import (global_mesh,
                                                  init_distributed,
                                                  is_output_host)
    from gnsslib_tpu.runtime.config import ReceiverConfig, ChannelConfig
    from gnsslib_tpu.runtime.receiver import Receiver
    from gnsslib_tpu.track.state import TrackConfig

    init_distributed(COORD, NPROC, pid)
    assert jax.process_count() == NPROC
    mesh = global_mesh()                  # 2 hosts x 2 devices = 4 = C

    spec = FrontendSpec(fend=FrontendType.FILE, f_cf=1.57542e9, f_sf=F_SF,
                        f_if=F_IF, dtype=DType.REAL)
    cfg = ReceiverConfig(
        channels=[ChannelConfig(prn=p) for p in PRNS],
        fends=[spec], files=[CAPTURE],
        track=TrackConfig(corrn=4, corrd=2, corrp=2),
        outms=400,
        rinex=is_output_host(),           # process-0 output role
        rinexpath=outdir)
    rx = Receiver(cfg, FileFrontend(CAPTURE, spec), mesh=mesh)
    rx.run_seconds()
    locked = sorted(ch.cfg.prn for ch in rx.channels if ch.locked)
    decoded = sorted(ch.cfg.prn for ch in rx.channels if ch.nav.flagdec)
    result = dict(pid=pid, locked=locked, decoded=decoded,
                  events=[e[:3] for e in rx.events],
                  epochs=rx.epochs_written, ephs=rx.ephs_written)
    with open(os.path.join(outdir, f"proc{pid}.json"), "w") as f:
        json.dump(result, f)
    rx.close()
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, default=None)
    ap.add_argument("--outdir", default=None)
    args = ap.parse_args()
    if args.pid is not None:
        return worker(args.pid, args.outdir)
    make_capture()
    auto_outdir = args.outdir is None
    outdir = args.outdir or tempfile.mkdtemp(prefix="gnsslib_mh_")
    try:
        procs = [subprocess.Popen(
            [sys.executable, __file__, "--pid", str(p),
             "--outdir", outdir],
            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
            for p in range(NPROC)]
        rc = max(p.wait() for p in procs)
        if rc:
            return rc
        res = [json.load(open(os.path.join(outdir, f"proc{p}.json")))
               for p in range(NPROC)]
        assert res[0]["locked"] == res[1]["locked"] == PRNS, res
        assert res[0]["decoded"] == res[1]["decoded"] == PRNS, res
        assert res[0]["events"] == res[1]["events"], "event mismatch"
        assert res[0]["epochs"] > 0
        obs = [p for p in os.listdir(outdir) if p.endswith(".obs")]
        assert obs, "process 0 wrote no RINEX"
        print(f"[demo] {NPROC} processes x 2 local devices, C={len(PRNS)} "
              f"channels sharded over the global mesh; all {PRNS} locked+"
              f"decoded, {res[0]['epochs']} epochs, RINEX {obs[0]} "
              f"-> MULTIHOST RECEIVER OK", flush=True)
        return 0
    finally:
        if auto_outdir:
            import shutil
            shutil.rmtree(outdir, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())

"""Multi-process scaling-efficiency measurement (CPU mesh).

BASELINE.md's north-star asks >=80% scaling efficiency from 1 to >=2
hosts.  This tool is CPU multi-process by design: it measures the SAME
channel-sharded steady-state program (parallel.ShardedFastTracker over a
jax.distributed global mesh) run as

  * 1 process x D virtual devices  (baseline), and
  * 2 processes x D virtual devices (scaled, weak scaling: the per-device
    channel load is fixed, the global channel count doubles),

and reports per-device channel-throughput and the efficiency ratio.  The
steady-state compute path has ZERO cross-device collectives (channels are
independent — parallel/sharded.py), so efficiency loss can only come from
dispatch overhead and the one cross-process barrier at result fetch; the
same program runs unchanged across accelerator hosts.  It never opens a
GPU (each process is pinned to the CPU backend), so it says nothing about
GPU speed.

Prints one JSON line:
  {"base_cps", "scaled_cps", "efficiency", "nproc", "per_dev": D, ...}
(cps = channel-samples/s/device: channels x stream-samples/s / devices.)

Used by tests/test_scaling.py; run standalone for the ROADMAP numbers:

    python tools/scaling_efficiency.py [--devices 2 --channels 8
                                        --nsteps 100 --blocks 6]
"""
import argparse
import json
import os
import subprocess
import sys
import time

COORD = "127.0.0.1:0"          # port chosen by the launcher


def worker(pid: int, nproc: int, coord: str, devices: int, channels: int,
           nsteps: int, blocks: int) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") +
                               f" --xla_force_host_platform_device_count"
                               f"={devices}")
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from gnsslib_tpu.parallel import ShardedFastTracker
    from gnsslib_tpu.parallel.distributed import (global_mesh,
                                                  init_distributed,
                                                  is_output_host)
    from gnsslib_tpu.constants import CodeType, DType
    from gnsslib_tpu.track import FastTracker, TrackConfig, Tracker

    if nproc > 1:
        init_distributed(coord, nproc, pid)
        assert jax.process_count() == nproc
    mesh = global_mesh()
    ndev = len(jax.devices())
    C = ndev * channels                  # weak scaling: fixed per device

    f_sf = 4.092e6
    f_if = 1.023e6
    rng = np.random.default_rng(7)
    trk = Tracker(TrackConfig(corrn=4, corrd=2, corrp=2),
                  [(i % 32) + 1 for i in range(C)],
                  [CodeType.L1CA] * C, f_sf, f_if, DType.REAL)
    fast = FastTracker(trk)
    nsamp = trk.n_nom
    block_len = nsteps * nsamp + trk.nwin + 8 * nsteps + 2 * nsamp + 64
    block = jnp.asarray(
        rng.integers(-64, 64, size=block_len).astype(np.float32))
    st = trk.init_state()
    st = trk.start_channels(st, list(range(C)), [0] * C,
                            [100.0 * (i % 5) for i in range(C)])
    for c in range(C):
        st = trk.set_bit_sync(st, c, c % 10)
    sfast = ShardedFastTracker(fast, mesh)

    st, _ = sfast.run_block(st, block, nsteps)      # compile + warmup
    t0 = time.time()
    for _ in range(blocks):
        st = trk.rebase(st, 0)
        st, out = sfast.run_block(st, block, nsteps)
    wall = time.time() - t0
    cps = C * nsteps * nsamp * blocks / wall / ndev
    if is_output_host():
        print(json.dumps({"cps_per_dev": cps, "nproc": nproc,
                          "ndev": ndev, "C": C, "wall": wall}),
              flush=True)
    return 0


def launch(nproc: int, devices: int, channels: int, nsteps: int,
           blocks: int) -> dict:
    """Run the measurement as nproc coordinated processes; return the
    output-host JSON."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        coord = f"127.0.0.1:{s.getsockname()[1]}"
    args = [sys.executable, os.path.abspath(__file__),
            "--worker", "--nproc", str(nproc), "--coord", coord,
            "--devices", str(devices), "--channels", str(channels),
            "--nsteps", str(nsteps), "--blocks", str(blocks)]
    # pin each process to its own cores: a "host" = a fixed CPU slice, so
    # the 1-process baseline gets the SAME per-host resources as each
    # scaled process and the ratio isolates coordination overhead rather
    # than core contention
    ncpu = os.cpu_count() or 2
    per = max(1, ncpu // max(2, nproc))

    def pin(p):
        cores = ",".join(str(c) for c in range(p * per, (p + 1) * per))
        return ["taskset", "-c", cores] if os.path.exists(
            "/usr/bin/taskset") else []
    procs = [subprocess.Popen(pin(p) + args + ["--pid", str(p)],
                              stdout=subprocess.PIPE, text=True)
             for p in range(nproc)]
    outs = [p.communicate()[0] for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    for o in outs:
        for ln in o.splitlines():
            if ln.startswith("{"):
                return json.loads(ln)
    raise RuntimeError(f"no result line: {outs}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--worker", action="store_true")
    ap.add_argument("--pid", type=int, default=0)
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--coord", default=COORD)
    ap.add_argument("--devices", type=int, default=2,
                    help="virtual devices per process")
    ap.add_argument("--channels", type=int, default=8,
                    help="channels per device (weak scaling)")
    ap.add_argument("--nsteps", type=int, default=100)
    ap.add_argument("--blocks", type=int, default=6)
    a = ap.parse_args()
    if a.worker:
        return worker(a.pid, a.nproc, a.coord, a.devices, a.channels,
                      a.nsteps, a.blocks)

    base = launch(1, a.devices, a.channels, a.nsteps, a.blocks)
    scaled = launch(a.nproc, a.devices, a.channels, a.nsteps, a.blocks)
    eff = scaled["cps_per_dev"] / base["cps_per_dev"]
    print(json.dumps({
        "base_cps_per_dev": round(base["cps_per_dev"] / 1e6, 2),
        "scaled_cps_per_dev": round(scaled["cps_per_dev"] / 1e6, 2),
        "unit": "Mchannel-samples/s/device",
        "nproc": a.nproc, "devices_per_proc": a.devices,
        "channels_per_dev": a.channels,
        "efficiency": round(eff, 3),
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())

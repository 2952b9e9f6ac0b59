"""Two-process channel-sharded receiver demo (jax.distributed, CPU).

Demonstrates the multi-host scaling story of SURVEY.md §2.4: each process
runs the same tracking program on its shard of the global channel axis;
process 0 plays the sync-thread role.  CPU multi-process by design: both
processes are pinned to the CPU backend and never open a GPU.  Run:

    python tools/multihost_demo.py            # spawns both processes

or manually:

    python tools/multihost_demo.py --pid 0 &
    python tools/multihost_demo.py --pid 1
"""
import argparse
import os
import subprocess
import sys

COORD = "127.0.0.1:39931"
NPROC = 2


def worker(pid: int) -> int:
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    jax.config.update("jax_platforms", "cpu")
    import numpy as np
    import jax.numpy as jnp
    from gnsslib_tpu.parallel.distributed import (global_mesh,
                                                  init_distributed,
                                                  is_output_host)
    from gnsslib_tpu.parallel import ShardedTracker
    from gnsslib_tpu import sim
    from gnsslib_tpu.constants import CodeType, DType
    from gnsslib_tpu.track import TrackConfig, Tracker

    init_distributed(COORD, NPROC, pid)
    assert jax.process_count() == NPROC
    mesh = global_mesh()
    ndev = len(jax.devices())
    C = ndev * 2                        # 2 channels per device, 16 total

    f_sf = 1.023e6
    chans = [sim.SimChannel(prn=(i % 32) + 1, doppler=100.0 * (i % 5),
                            code_phase=30.0 * i) for i in range(4)]
    data = np.asarray(sim.synthesize(chans, f_sf, f_sf / 4, DType.REAL,
                                     int(0.2 * f_sf), noise_std=0.5),
                      np.float32)
    trk = Tracker(TrackConfig(corrn=1, corrd=1, corrp=1),
                  [(i % 32) + 1 for i in range(C)],
                  [CodeType.L1CA] * C, f_sf, f_sf / 4, DType.REAL)
    strk = ShardedTracker(trk, mesh)
    st = trk.init_state()
    st = trk.start_channels(st, list(range(C)), [0] * C,
                            [100.0 * (i % 5) for i in range(C)])
    nsteps = 50
    st, out = strk.run_block(st, jnp.asarray(data), nsteps)

    # steady-state fast path over the same global mesh
    from gnsslib_tpu.parallel import ShardedFastTracker
    from gnsslib_tpu.track import FastTracker
    fast = FastTracker(trk)
    sfast = ShardedFastTracker(fast, mesh)
    for c in range(C):
        st = trk.set_bit_sync(st, c, c % 10)
    st = trk.rebase(st, 0)
    st, outf = sfast.run_block(st, jnp.asarray(data), fast.L)
    assert outf.ip.shape == (fast.L, C), outf.ip.shape
    if is_output_host():
        print(f"[demo] {jax.process_count()} processes x "
              f"{ndev // NPROC} local devices, C={C} channels sharded; "
              f"tracked {nsteps} periods; mean |IP| = "
              f"{float(np.mean(np.abs(out.ip))):.1f}; fast-path super-step "
              f"out {outf.ip.shape}  -> MULTIHOST OK",
              flush=True)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--pid", type=int, default=None)
    args = ap.parse_args()
    if args.pid is not None:
        return worker(args.pid)
    procs = [subprocess.Popen([sys.executable, __file__, "--pid", str(p)],
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))
             for p in range(NPROC)]
    rc = max(p.wait() for p in procs)
    return rc


if __name__ == "__main__":
    sys.exit(main())

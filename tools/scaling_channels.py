"""Channel-count scaling on one chip: the multi-stream serving headroom.

The 32-channel headline config uses a fraction of the device; production
serving can batch several independent RF streams (or a denser channel
set) into one FastTracker.  Measures ms/super-step and aggregate
channel-samples/s for growing C at the 16.368 Msps envelope.
"""
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run from any cwd
import sys
import time

import numpy as np


def main():
    import jax
    import jax.numpy as jnp
    from gnsslib_tpu.constants import CodeType, DType
    from gnsslib_tpu.track import FastTracker, TrackConfig, Tracker

    f_sf, f_if = 16.368e6, 4.092e6
    nsteps = 500                       # 0.5 s of signal per device call
    cfg = TrackConfig(corrn=6, corrd=3, corrp=6)
    rng = np.random.default_rng(0)

    for C in (32, 64, 128, 256):
        prns = [(i % 32) + 1 for i in range(C)]
        trk = Tracker(cfg, prns, [CodeType.L1CA] * C, f_sf, f_if,
                      DType.REAL)
        fast = FastTracker(trk)
        nsamp = trk.n_nom
        # the block must cover every consecutive run_block call (1
        # warmup + 2 per timing iteration x 3): the state advances
        # through it with no rebase, and the band-resident default
        # correlator fail-louds on windows past the block's end
        nblocks_total = 7
        block_len = (nblocks_total * nsteps * nsamp + trk.nwin
                     + 8 * nblocks_total * nsteps + 2 * nsamp + 64)
        block = jnp.asarray(rng.standard_normal(block_len)
                            .astype(np.float32))
        st = trk.init_state()
        st = trk.start_channels(st, list(range(C)),
                                [37 * p % nsamp for p in prns],
                                [100.0 * (i % 13) for i in range(C)])
        for c in range(C):
            st = trk.set_bit_sync(st, c, c % 10)
        t0 = time.time()
        st, h = fast.run_block_start(st, block, nsteps)
        fast.run_block_collect(h)
        comp = time.time() - t0
        best = 1e9
        for _ in range(3):
            t0 = time.time()
            st, h = fast.run_block_start(st, block, nsteps)
            st, h2 = fast.run_block_start(st, block, nsteps)
            fast.run_block_collect(h)
            fast.run_block_collect(h2)
            best = min(best, (time.time() - t0) / 2)
        nsuper = nsteps // fast.L
        ms_step = best / nsuper * 1e3
        ch_msps = C * nsteps * nsamp / best / 1e6
        print(f"C={C:4d}  {ms_step:7.3f} ms/super-step  "
              f"{ch_msps:9.0f} channel-Msps  "
              f"({ch_msps / (32 * 16.368):5.1f}x 32-ch real-time)  "
              f"compile {comp:.0f}s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

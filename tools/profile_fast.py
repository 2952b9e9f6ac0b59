"""On-card duel of the FastTracker correlator formulations.

Times the steady-state super-step (L=10 code periods x 32 ch @ 16.368
Msps, iffile.ini 13-tap geometry) for each plain-JAX correlator in
``track.fast.CORRS`` — "xla" (per-window einsum), "diag" (Gram-diagonal,
two dots) and "diag2" (Gram-diagonal, one packed dot) — plus "nocorr",
the same scan with the correlation replaced by zeros (the geometry +
loop-filter floor).  The variants run round-robin in one process, so
every round sees the same card state; each timing ends in
``block_until_ready``.  Reports per-variant median, quartiles and the
device-only Msps.  Needs the GPU (exits non-zero without one).

    python tools/profile_fast.py [--rounds N]
"""
from __future__ import annotations
import os as _os
import sys as _sys
_sys.path.insert(0, _os.path.dirname(_os.path.dirname(
    _os.path.abspath(__file__))))   # run from any cwd

import argparse
import functools
import time

import numpy as np

import jax
import jax.numpy as jnp

from gnsslib_tpu import sim
from gnsslib_tpu.constants import CodeType, DType
from gnsslib_tpu.runtime.device import card_info, require_gpu
from gnsslib_tpu.track import FastTracker, TrackConfig, Tracker
from gnsslib_tpu.track.fast import CORRS

S = 50                                   # super-steps per timed call


def timeit(fn, *args, reps=4):
    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


def variants(trk):
    """{name: jitted (carry, block, consts, fconsts) -> carry, outs}."""
    fns = {}
    for corr in CORRS:
        fast = FastTracker(trk, corr=corr)
        fns[corr] = jax.jit(functools.partial(fast.run_steps, nsuper=S))
    fast = FastTracker(trk, corr="xla")

    @jax.jit
    def nocorr(carry, block, consts, fconsts):
        def step(st, _):
            geo = jax.vmap(functools.partial(fast._geo_only, block)
                           )(consts, fconsts, st)
            zero = jnp.zeros((fast.C, fast.L, trk.cfg.ntaps), jnp.float32)

            def one(cc, fcc, stc, geoc):
                new, out = fast._filter(cc, fcc, stc, geoc, zero[0],
                                        zero[0])
                merged = {k: jnp.where(stc["active"], new[k], stc[k])
                          if k in new else stc[k] for k in stc}
                return merged, out
            return jax.vmap(one)(consts, fconsts, st, geo)
        return jax.lax.scan(step, carry, None, length=S)
    fns["nocorr"] = nocorr
    return fns


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=10)
    args = ap.parse_args()
    device = require_gpu()
    print(f"device {device}; card {card_info()}", flush=True)

    f_sf, f_if, C = 16.368e6, 4.092e6, 32
    prns = list(range(1, 33))
    cfg = TrackConfig(corrn=6, corrd=3, corrp=6)
    trk = Tracker(cfg, prns, [CodeType.L1CA] * C, f_sf, f_if, DType.REAL)
    L, nsamp = FastTracker(trk, corr="xla").L, trk.n_nom
    nsteps = S * L
    block_len = nsteps * nsamp + trk.nwin + 8 * nsteps + 2 * nsamp + 64
    x = sim.synthesize([sim.SimChannel(prn=1, doppler=500.0)], f_sf, f_if,
                       DType.REAL, block_len, noise_std=1.5, seed=3)
    block = jnp.asarray(sim.quantize_int8(x, 16.0).astype(np.float32))
    st = trk.init_state()
    st = trk.start_channels(st, list(range(C)), [0] * C, [0.0] * C)
    for c in range(C):
        st = trk.set_bit_sync(st, c, c % 10)
    carry = trk._state_to_dict(st)
    fconsts = FastTracker(trk, corr="xla")._fconsts
    argv = (carry, block, trk._consts, fconsts)

    fns = variants(trk)
    for name, fn in fns.items():
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*argv))
        print(f"# compile {name}: {time.perf_counter() - t0:.1f}s",
              flush=True)
    times = {name: [] for name in fns}
    for r in range(args.rounds):
        order = list(fns) if r % 2 == 0 else list(fns)[::-1]
        for name in order:
            times[name].append(timeit(fns[name], *argv))
    print(f"\nms per super-step over {args.rounds} interleaved rounds "
          f"({S} super-steps per call):")
    for name, v in times.items():
        ms = np.asarray(v) / S * 1e3
        q1, med, q3 = np.percentile(ms, [25, 50, 75])
        print(f"  {name:7s} median {med:7.4f}  q1 {q1:7.4f}  q3 {q3:7.4f}"
              f"  -> {L * nsamp / (med * 1e-3) / 1e6:7.1f} Msps "
              "device-only", flush=True)
    return 0


if __name__ == "__main__":
    _sys.exit(main())

"""Headline benchmark: 32-channel L1CA acq+track throughput on one GPU.

Measures steady-state IF samples/s through the receiver's device
workload at the reference's post-processing envelope (16.368 Msps real
IF, frontend/iffile.ini) with all 32 channels of the reference default
config (bin/gnss-sdrcli.ini NCH=32):

* tracking: the steady-state fast path (carrier wipe-off + 13-tap
  correlator + DLL/PLL/FLL per ms per channel) for all 32 channels, and
* acquisition: one pending-channel subset search per ACQSLEEP (2 s) of
  stream — the receiver's steady-state retry cadence for the PRNs not
  visible in the capture (20 of 32 with the reference demo sky of 12
  satellites; src/sdrmain.c:247-316 re-searches failed channels on the
  same cadence) — interleaved with the tracking blocks exactly as
  Receiver.step_block pipelines them.

vs_baseline = measured Msps / 16.368 (the reference's implicit
real-time envelope: sustaining the capture rate).

Runs in ONE process on the GPU and exits non-zero without one (no CPU
fallback).  Prints the device and the card's name and power limit on
stderr, then ONE JSON line on stdout: the median over passes with its
quartiles, and the device it ran on.

    python bench.py
"""
import json
import sys
import time

METRIC = "rx_32ch_l1ca_acq_track_throughput"
F_SF_MSPS = 16.368
NSTEPS = 2000          # 2 s of signal per device call: one ACQSLEEP
PASSES, BLOCKS = 12, 6


def main() -> int:
    from gnsslib_tpu.runtime.device import card_info, require_gpu
    device = require_gpu()
    card = card_info()
    print(f"# device {json.dumps(device)}; card {card}", file=sys.stderr,
          flush=True)

    from collections import deque

    import jax.numpy as jnp
    import numpy as np
    from gnsslib_tpu.acquire import Acquirer
    from gnsslib_tpu.constants import CodeType, DType
    from gnsslib_tpu.track import FastTracker, TrackConfig, Tracker

    f_sf, f_if, C = 16.368e6, 4.092e6, 32
    prns = list(range(1, 33))
    cfg = TrackConfig(corrn=6, corrd=3, corrp=6)      # iffile.ini geometry
    trk = Tracker(cfg, prns, [CodeType.L1CA] * C, f_sf, f_if, DType.REAL)
    fast = FastTracker(trk)
    nsamp = trk.n_nom
    # one device block covers a WHOLE pass of consecutive run_block
    # calls: the state's block offsets advance naturally through it
    # (exactly the receiver's stream semantics) and each pass's
    # start_channels reset rewinds to the block start
    block_len = (BLOCKS * NSTEPS * nsamp + trk.nwin + 8 * BLOCKS * NSTEPS
                 + 2 * nsamp + 64)

    # steady-state acquisition load: the reference demo sky has 12
    # visible satellites, so 20 of the 32 configured channels re-search
    # every ACQSLEEP (runtime/receiver.py pending-subset dispatch)
    acq = Acquirer(prns, [CodeType.L1CA] * C, f_sf, f_if, DType.REAL)
    pending = np.arange(12, 32, dtype=np.int32)

    # throughput does not depend on signal content (the loops run
    # regardless of lock): an int8-alphabet noise block stands in for the
    # multi-satellite synthesis
    rng = np.random.default_rng(3)
    block = jnp.asarray(
        rng.integers(-64, 64, size=block_len).astype(np.float32))

    st = trk.init_state()
    st = trk.start_channels(st, list(range(C)),
                            [int(97 * p) % nsamp for p in prns],
                            [250.0 * (p % 13) - 1500.0 for p in prns])
    for c in range(C):
        st = trk.set_bit_sync(st, c, c % 10)

    # warmup / compile (set-up time, reported apart)
    t0 = time.time()
    st, _ = fast.run_block(st, block, NSTEPS)
    acq.search_dev_collect(acq.search_dev_start(block, idx=pending))
    print(f"# compile+first block {time.time() - t0:.1f}s (corr="
          f"{fast.corr})", file=sys.stderr, flush=True)

    # steady state: pipelined blocks, depth 2 (dispatch block k+1 and its
    # ACQSLEEP search before collecting block k's telemetry), as the
    # receiver streams
    walls = []
    for _ in range(PASSES):
        st = trk.start_channels(st, list(range(C)), [0] * C, [0.0] * C)
        t0 = time.time()
        pend = deque()
        for _b in range(BLOCKS):
            ah = acq.search_dev_start(block, idx=pending)
            st, handle = fast.run_block_start(st, block, NSTEPS)
            pend.append((handle, ah))
            if len(pend) > 2:
                h, a = pend.popleft()
                fast.run_block_collect(h)
                acq.search_dev_collect(a)
        while pend:
            h, a = pend.popleft()
            fast.run_block_collect(h)
            acq.search_dev_collect(a)
        walls.append((time.time() - t0) / BLOCKS)
    msps = NSTEPS * nsamp / 1e6 / np.asarray(walls)
    q1, med, q3 = (float(v) for v in np.percentile(msps, [25, 50, 75]))
    print(json.dumps({
        "metric": METRIC, "value": med, "unit": "Msamples/s",
        "vs_baseline": med / F_SF_MSPS, "q1": q1, "q3": q3,
        "passes": len(walls), "device": device, "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

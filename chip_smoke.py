"""Smoke run of the full receiver on the GPU.

Drives the receiver once through its normal entry point,
``gnsslib_tpu.runtime.cli.main`` (what ``python -m gnsslib_tpu`` runs),
at the reference's post-processing envelope: 32 L1CA channels, 12
satellites present with bit-true LNAV, 16.368 Msps int8 real IF at
4.092 MHz, the iffile.ini 13-tap correlator, OUTMS=400 with RINEX obs
and nav on.  The capture and its INI are synthesized from a fixed seed
into ``.smoke/`` (git-ignored), by NumPy worker processes that never
touch a device.

Phases, in one process:

1. device — the first JAX device must be a GPU (else exit non-zero and
   print no result); prints the device, the card's name and power limit
   and whether the native host library loaded;
2. correlator — at full width on a locked state: the GPU's default
   fast-path correlator against ``corr="xla"`` at HIGHEST matmul
   precision, the fast path against the per-period scan, and one
   acquisition grid on the GPU against the same program on the CPU;
3. receiver — the CLI on the capture: all present PRNs locked, an
   ephemeris, RINEX obs epochs, no NaN observables; prints the timeline,
   peak device memory and the steady-state stream rate (informational);
4. the last line, ``{"ok": true, "device": {...}}``.

``--mesh 4`` instead runs only the CLI with ``--devices 4`` on four
cards and the one-card CLI run it is compared with.

    python chip_smoke.py [--mesh 4]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

F_SF = 16.368e6
F_IF = 4.092e6
NCH = 32                    # bin/gnss-sdrcli.ini NCH
NPRESENT = 12               # the reference demo sky
SECONDS = 32.0              # one ephemeris (sf 1-3 end ~24 s in) + epochs
WORKDIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       ".smoke")


class SmokeFailure(Exception):
    """A phase's check failed."""


def check(name: str, value, ok: bool, bound: str) -> None:
    """Print one measured quantity beside its bound; raise if outside."""
    print(f"  {name}: {value}  (bound {bound})  "
          f"{'ok' if ok else 'FAIL'}", flush=True)
    if not ok:
        raise SmokeFailure(name)


# --------------------------------------------------------------------- #
# capture + INI
# --------------------------------------------------------------------- #
def write_ini(workdir: str, capture: str, rinexdir: str, name: str = "rx",
              f_sf: float = F_SF, f_if: float = F_IF, nch: int = NCH) -> str:
    """Reference-style receiver INI + front-end INI (iffile.ini geometry:
    CORRN=6, CORRD=3, CORRP=6) for the capture; returns the receiver
    INI's path."""
    fend = os.path.join(workdir, f"{name}_fend.ini")
    with open(fend, "w") as f:
        f.write(f"""[FEND]
TYPE     =FILE
CF1      =1575.42e6
SF1      ={f_sf}
IF1      ={f_if}
DTYPE1   =1
FILE1    ={os.path.abspath(capture)}
[TRACK]
CORRN    =6
CORRD    =3
CORRP    =6
""")
    ini = os.path.join(workdir, f"{name}.ini")
    prns = ",".join(str(p) for p in range(1, nch + 1))
    ones = ",".join(["1"] * nch)
    with open(ini, "w") as f:
        f.write(f"""[RCV]
FENDCONF ={os.path.basename(fend)}
[CHANNEL]
NCH      ={nch}
PRN      ={prns}
SYS      ={ones}
CTYPE    ={ones}
FTYPE    ={ones}
[OUTPUT]
OUTMS    =400
RINEX    =1
RINEXPATH={os.path.abspath(rinexdir)}
""")
    return ini


# --------------------------------------------------------------------- #
# phases
# --------------------------------------------------------------------- #
def phase_device(want: int) -> dict:
    import jax
    from gnsslib_tpu import native
    from gnsslib_tpu.runtime.device import card_info, require_gpu
    device = require_gpu()
    print(f"device: platform={device['platform']} kind={device['kind']} "
          f"count={device['count']}", flush=True)
    if device["count"] < want:
        raise SmokeFailure(f"need {want} GPUs, JAX reports "
                           f"{device['count']}")
    print(f"card: {card_info()}", flush=True)
    print("native host library: "
          + ("loaded" if native.available() else "NumPy fallback"),
          flush=True)
    print(f"jax {jax.__version__}", flush=True)
    return device


def _lock_state(trk, block, nsteps: int, truth, f_sf: float):
    """Start the present channels at their true code phase and Doppler,
    pull in on the per-period scan and hand each bit-synced channel to
    the steady-state cadence (as the receiver does)."""
    from gnsslib_tpu.constants import CodeType
    from gnsslib_tpu.nav import NavChannel
    idx = [t["prn"] - 1 for t in truth]
    spc = f_sf / 1.023e6
    codei = [int(round(-t["code_phase"] * spc)) % trk.n_nom for t in truth]
    st = trk.start_channels(trk.init_state(), idx, codei,
                            [-t["doppler"] for t in truth])
    st, out = trk.run_block(st, block, nsteps)
    for i in idx:
        nav = NavChannel(CodeType.L1CA, i + 1)
        nav.update(out.ip[:, i], out.loc[:, i].astype(np.int64), 0)
        if not nav.flagsync:
            raise SmokeFailure(f"PRN {i + 1} did not bit-sync in pull-in")
        st = trk.set_bit_sync(st, i, nav.sync_offset)
    return st, idx


def _compare_loc(label: str, a, b, act, max_share=None) -> None:
    """Window starts: never more than one sample apart and, with
    ``max_share``, apart in at most that share of (period, channel)
    entries."""
    d = np.abs(a.loc[:, act].astype(np.int64) - b.loc[:, act])
    frac = float(np.mean(d != 0))
    check(f"max |loc diff| {label} (samples)", int(d.max()), d.max() <= 1,
          "<= 1")
    if max_share is None:
        print(f"  share of periods with loc diff {label}: {frac:.4f} "
              "(transient closed-form vs iterative rounding; no bound)")
    else:
        check(f"share of periods with loc diff {label}", f"{frac:.4f}",
              frac <= max_share, f"<= {max_share}")


def _same_updates(label: str, a, b, act) -> None:
    same = all(np.array_equal(np.nonzero(a.flagloopfilter[:, i] == 2)[0],
                              np.nonzero(b.flagloopfilter[:, i] == 2)[0])
               for i in act)
    check(f"same loop-update periods {label}", same, same, "True")


def phase_correlator(capture: str, f_sf: float = F_SF, f_if: float = F_IF,
                     nch: int = NCH, npresent: int = NPRESENT,
                     pull_s: float = 6.0, nfast: int = 600,
                     acq_prns=(1, 4, 7, 10)) -> None:
    import jax
    import jax.numpy as jnp
    from gnsslib_tpu.acquire import Acquirer
    from gnsslib_tpu.constants import CodeType, DType
    from gnsslib_tpu.track import FastTracker, TrackConfig, Tracker

    cfg = TrackConfig(corrn=6, corrd=3, corrp=6)
    prns = list(range(1, nch + 1))
    trk = Tracker(cfg, prns, [CodeType.L1CA] * nch, f_sf, f_if, DType.REAL)
    npull = int(pull_s * 1000)
    nblk = int((pull_s + 1.5) * f_sf)
    data = np.fromfile(capture, np.int8, count=nblk).astype(np.float32)
    block = jnp.asarray(data)
    t0 = time.time()
    from gnsslib_tpu.sim import demo_sky
    st, act = _lock_state(trk, block, npull, demo_sky(npresent), f_sf)
    print(f"  locked state: {len(act)} channels bit-synced after "
          f"{npull} periods ({time.time() - t0:.1f} s incl. compile)")

    fd = FastTracker(trk)
    print(f"  GPU default correlator: {fd.corr}; reference: xla at "
          "HIGHEST matmul precision")
    _, out_d = fd.run_block(st, block, nfast)
    with jax.default_matmul_precision("highest"):
        fx = FastTracker(trk, corr="xla")
        _, out_x = fx.run_block(st, block, nfast)
    # tests/test_fast.py bounds: bf16 products and f32 sums differ from
    # the f32 reference in summation order and one bf16 rounding site.
    # Sample bookkeeping: the two trajectories differ in the last bits,
    # so a code phase next to a replica-table breakpoint can flip one
    # period's window by a sample (a 1/512-chip table quantum); the test's
    # single-channel fixture sees none, 12 channels see a few isolated ones
    _compare_loc("default vs xla", out_x, out_d, act, max_share=0.01)
    scale = float(np.max(np.abs(out_x.ip[:, act])))
    for nm, a, b in (("ip", out_x.ip, out_d.ip), ("qp", out_x.qp, out_d.qp)):
        a, b = a[:, act], b[:, act]
        d = np.abs(a - b)
        med = float(np.median(d)) / scale
        nout = int(np.sum(d > 5e-3 * scale))
        corr = min(float(np.corrcoef(a[:, k], b[:, k])[0, 1])
                   for k in range(a.shape[1]))
        check(f"{nm} median |diff|/scale", f"{med:.3e}", med < 1e-3, "< 1e-3")
        check(f"{nm} outliers > 5e-3*scale", nout, nout <= 3, "<= 3")
        check(f"{nm} min channel correlation", f"{corr:.6f}", corr > 0.999,
              "> 0.999")
    dd = float(np.max(np.abs(out_x.dcarr[:, act] - out_d.dcarr[:, act])))
    check("max |dcarr diff| (Hz)", f"{dd:.4f}", dd <= 0.5, "<= 0.5")
    _same_updates("default vs xla", out_x, out_d, act)

    # fast path vs the per-period scan (tests/test_fast.py:40 checks).
    # The scan updates its NCO rates every period, the fast path once per
    # super-step, so the loops drift apart within the DLL/PLL jitter: the
    # code phase is compared as loc*ci0 - remcode (a sample of loc
    # difference is compensated in remcode) against a bound of 0.02 chip,
    # several times the 1 Hz DLL's jitter and far below a chip
    st_s, out_s = trk.run_block(st, block, nfast)
    st_f, out_f = fd.run_block(st, block, nfast)
    _compare_loc("fast vs scan", out_s, out_f, act)
    ci0 = 1.023e6 / f_sf
    code = lambda s_: (np.asarray(s_.loc)[act] * ci0
                       - np.asarray(s_.remcode)[act])
    dc = float(np.max(np.abs(code(st_s) - code(st_f))))
    check("max |final code phase diff| fast vs scan (chips)", f"{dc:.2e}",
          dc < 0.02, "< 0.02")
    corr = min(float(np.corrcoef(out_s.ip[:, i], out_f.ip[:, i])[0, 1])
               for i in act)
    check("min prompt correlation fast vs scan", f"{corr:.5f}", corr > 0.99,
          "> 0.99")
    dd = float(np.max(np.abs(out_s.dcarr[-1, act] - out_f.dcarr[-1, act])))
    check("max |final dcarr diff| fast vs scan (Hz)", f"{dd:.4f}",
          dd <= 0.5, "<= 0.5")
    _same_updates("fast vs scan", out_s, out_f, act)

    # one acquisition grid: GPU vs the same program on the CPU
    ctypes_ = [CodeType.L1CA] * len(acq_prns)
    acq_g = Acquirer(list(acq_prns), ctypes_, f_sf, f_if, DType.REAL)
    need = (acq_g.intg + 2) * acq_g.nsamp
    r_g = acq_g.search(data[:need])
    with jax.default_device(jax.devices("cpu")[0]):
        acq_c = Acquirer(list(acq_prns), ctypes_, f_sf, f_if, DType.REAL)
        r_c = acq_c.search(data[:need])
    print(f"  acquisition PRNs {list(acq_prns)}: GPU codei "
          f"{np.asarray(r_g.codei).tolist()} freqi "
          f"{np.asarray(r_g.freqi).tolist()}")
    eq = (np.array_equal(r_g.codei, r_c.codei)
          and np.array_equal(r_g.freqi, r_c.freqi))
    check("acquisition codei/freqi GPU == CPU", eq, eq, "True")


def run_cli(ini: str, devices: int = 1):
    """``cli.main([ini, "--quiet", "--devices", n])`` in-process; returns
    the receiver it built and (wall time, stream sample) after every
    block."""
    from gnsslib_tpu.runtime import cli
    built, marks = [], []
    orig = cli.build_receiver

    def capture(*a, **k):
        rx = orig(*a, **k)
        step = rx.step_block

        def timed_step():
            step()
            marks.append((time.perf_counter(), rx.base,
                          "steady" in rx.timeline))
        rx.step_block = timed_step
        built.append(rx)
        return rx
    cli.build_receiver = capture
    try:
        rc = cli.main([ini, "--quiet", "--devices", str(devices)])
    finally:
        cli.build_receiver = orig
    if rc != 0:
        raise SmokeFailure(f"CLI exited {rc}")
    return built[0], marks


def _rinex_obs(rx) -> str:
    """The body (after the header) of the receiver's RINEX obs file."""
    with open(rx.obs_writer.path) as f:
        return f.read().split("END OF HEADER", 1)[-1]


def phase_receiver(ini: str, device: dict, f_sf: float = F_SF,
                   npresent: int = NPRESENT) -> None:
    import jax
    rx, marks = run_cli(ini)
    locked = sorted(ch.cfg.prn for ch in rx.channels if ch.locked)
    print(f"  locked PRNs: {locked}")
    present = list(range(1, npresent + 1))
    ok = set(present) <= set(locked)
    check("present PRNs locked", f"{len(set(present) & set(locked))}/"
          f"{len(present)}", ok, f"{len(present)}/{len(present)}")
    check("ephemeris records", rx.ephs_written, rx.ephs_written >= 1, ">= 1")
    check("RINEX obs epochs", rx.epochs_written, rx.epochs_written > 0,
          "> 0")
    text = _rinex_obs(rx).lower()
    bad = "nan" in text or "inf" in text
    check("NaN/inf in RINEX observables", bad, not bad, "False")
    tl = {k: round(v, 3) for k, v in rx.timeline.items() if k != "t0"}
    print(f"  timeline (s since receiver construction): {tl}")
    stats = jax.devices()[0].memory_stats() or {}
    print(f"  peak_bytes_in_use: {stats.get('peak_bytes_in_use')}")
    steady = [m for m in marks if m[2]]
    if len(steady) >= 2:
        (t_a, b_a, _), (t_b, b_b, _) = steady[0], steady[-1]
        rate = (b_b - b_a) / f_sf / (t_b - t_a)
        print(f"  steady window: {rate:.3f} stream-s per wall-s over "
              f"{(b_b - b_a) / f_sf:.1f} stream-s (informational; "
              f"{device['kind']}, one run, not a benchmark)")


def _obs_by_epoch(text: str) -> dict:
    """{epoch line: {sat: first observable (pseudorange)}}."""
    out, cur = {}, None
    for ln in text.splitlines():
        if ln.startswith(">"):
            cur = ln[:30]
            out[cur] = {}
        elif cur is not None and ln[3:17].strip():
            out[cur][ln[:3]] = float(ln[3:17])
    return out


def phase_mesh(ini_mesh: str, ini_one: str, ndev: int) -> None:
    rx_m, _ = run_cli(ini_mesh, devices=ndev)
    rx_s, _ = run_cli(ini_one, devices=1)
    lm = sorted(ch.cfg.prn for ch in rx_m.channels if ch.locked)
    ls = sorted(ch.cfg.prn for ch in rx_s.channels if ch.locked)
    print(f"  locked PRNs: mesh {lm}, one card {ls}")
    check("same locks", lm == ls, lm == ls, "True")
    em = [e[:3] for e in rx_m.events]
    es = [e[:3] for e in rx_s.events]
    first = next((i for i, (a, b) in enumerate(zip(em, es)) if a != b),
                 None)
    print(f"  events: mesh {len(em)}, one card {len(es)}; first "
          f"difference at {first}"
          + ("" if first is None else f": {em[first]} vs {es[first]}"))
    check("same events (kind, stream time, PRN)", em == es, em == es,
          "True")
    check("epochs_written equal", f"{rx_m.epochs_written} vs "
          f"{rx_s.epochs_written}", rx_m.epochs_written
          == rx_s.epochs_written, "equal")
    om, os_ = _obs_by_epoch(_rinex_obs(rx_m)), _obs_by_epoch(_rinex_obs(rx_s))
    common = [(e, s) for e in om if e in os_ for s in om[e] if s in os_[e]]
    dp = max((abs(om[e][s] - os_[e][s]) for e, s in common), default=0.0)
    print(f"  pseudoranges: {len(common)} common (epoch, satellite) "
          f"pairs, max |mesh - one card| {dp:.4f} m (informational)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run only the CLI with --devices N against the "
                         "one-card CLI run")
    args = ap.parse_args(argv)
    plats = os.environ.get("JAX_PLATFORMS")
    if plats and "cpu" not in plats.split(","):
        # the acquisition cross-check runs the same program on the CPU
        import jax
        jax.config.update("jax_platforms", plats + ",cpu")
    device = phase_device(max(1, args.mesh))
    from gnsslib_tpu import sim
    os.makedirs(WORKDIR, exist_ok=True)
    capture = os.path.join(WORKDIR, "capture.bin")
    t0 = time.time()
    # NumPy worker processes, pinned off the GPU
    sim.write_demo_capture(capture, SECONDS, F_SF, F_IF, npresent=NPRESENT)
    print(f"synthesis: {SECONDS:.0f} s of 16.368 Msps int8 IF, "
          f"{NPRESENT} satellites, in {time.time() - t0:.1f} s", flush=True)
    if args.mesh:
        print(f"phase mesh: CLI --devices {args.mesh} vs one card",
              flush=True)
        phase_mesh(
            write_ini(WORKDIR, capture, os.path.join(WORKDIR, "rinex_mesh"),
                      name="mesh"),
            write_ini(WORKDIR, capture, os.path.join(WORKDIR, "rinex_one"),
                      name="one"), args.mesh)
    else:
        print("phase correlator", flush=True)
        phase_correlator(capture)
        print("phase receiver", flush=True)
        phase_receiver(write_ini(WORKDIR, capture,
                                 os.path.join(WORKDIR, "rinex")), device)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Block-streamed receiver orchestration.

The reference's thread-per-channel runtime (src/sdrmain.c:105-332) becomes
one synchronous pipeline per front end:

    for each block of IF samples:
        acquisition program  (all unlocked channels, batched)
        tracking scan        (all locked channels, one lax.scan)
        nav framers          (host, batched per channel)
        observable history + epoch alignment + RINEX/RTCM output

The absolute sample index replaces the ring-buffer clock
(sdrstat.buffcnt*fendbuffsize); acquisition retry every ~ACQSLEEP of
stream replaces the 2 s sleep (src/sdracq.c:57-59).
"""
from __future__ import annotations

import dataclasses
import functools
import os
import threading
import time

import numpy as np

from ..acquire import Acquirer
from ..constants import (ACQSLEEP, CodeType, SYS_GPS, SYS_GLO, SYS_SBS,
                         SYS_QZS, OBSINTERPN)
from ..diag.tracklog import TrackLogger
from ..nav import NavChannel
from ..nav.sbas import gen_novatel_sbasmsg
from ..obs.rtcm import encode_1019, encode_1020, encode_1044, encode_msm7
from ..sat import satno, satno2id
from .tcpout import TcpServer
from ..io.devcache import DeviceBlockCache
from ..obs.epoch import ChannelObsInput, EpochAligner, SdrObs
from ..obs.history import ObsHistory
from ..obs.rinex import RinexObsWriter, RinexNavWriter
from ..ops.nco import NSPAN
from ..track import FastTracker, Tracker
from ..track.state import loop_interval
from .config import ReceiverConfig

try:
    import jax.numpy as jnp
except ImportError:                                    # pragma: no cover
    jnp = None


class _BgFetch:
    """Background device->host fetch.

    A device_get waits out the device queue: a search decision read one
    block after dispatch waits for the tracking block queued ahead of it.
    A main-thread dispatch is NOT blocked by another thread's in-flight
    device_get, so the fetch starts here, on a daemon thread, AT
    DISPATCH; the receiver's apply schedule stays exactly as before
    (deterministic — results apply at fixed block offsets, never
    "whenever the thread lands"), but the scheduled ``get()`` joins an
    already-landed result instead of stalling the pipeline.  Exceptions
    re-raise at ``get()`` — the same point the synchronous collect
    raised.

    Deliberately a per-fetch DAEMON thread rather than a shared
    ThreadPoolExecutor: pool threads are non-daemon and joined at
    interpreter exit, so one fetch wedged in a hung device get would
    hang process shutdown — daemon threads let SIGTERM/exit proceed.
    The churn is one short-lived thread per block (~10-40/s),
    microseconds each."""

    __slots__ = ("_done", "_result", "_exc")

    def __init__(self, fn, *args):
        self._done = threading.Event()
        self._result = None
        self._exc = None

        def run():
            try:
                self._result = fn(*args)
            except BaseException as e:      # pragma: no cover - re-raised
                self._exc = e
            finally:
                self._done.set()
        threading.Thread(target=run, daemon=True).start()

    def get(self):
        self._done.wait()
        if self._exc is not None:
            raise self._exc
        return self._result


@dataclasses.dataclass
class ChannelRuntime:
    """Mutable per-channel receiver state (beyond the device pytree)."""
    idx: int                 # index within its tracker group
    cfg: object              # ChannelConfig
    nav: NavChannel
    hist: ObsHistory
    locked: bool = False
    synced: bool = False
    last_acq_attempt: float = -1e9
    t_acq: float = -1e9      # stream time the current lock started
    cn0: float = 0.0
    peak_prompt: float = 0.0
    # host-side shadows of the last collected block's telemetry for the
    # operator dashboard (diag/watch.py) — NEVER read from the device
    dcarr_live: float = 0.0
    prompt_live: float = 0.0


class OutputHub:
    """Shared output stage: RINEX/RTCM/SBAS writers plus the common-epoch
    clock.  One hub per RECEIVER (not per front end) — with two RF paths
    the reference's sync thread merges both paths' channels into one
    observation stream (src/sdrsync.c:49-135 iterates sdrch[] across all
    front ends); sharing the hub is what makes cross-path (e.g. STEREO
    L1+G1) pseudoranges land in the same RINEX epoch."""

    def __init__(self, cfg: ReceiverConfig):
        self.cfg = cfg
        self.aligner = EpochAligner(cfg.outms)
        self.outms_ms = int(cfg.outms)
        self._oldreftow = 0.0
        self.obs_writer: RinexObsWriter | None = None
        self.nav_writer: RinexNavWriter | None = None
        if cfg.rinex:
            ts = time.gmtime()
            stamp = time.strftime("%Y%m%d%H%M%S", ts)
            date = [ts.tm_year, ts.tm_mon, ts.tm_mday, ts.tm_hour,
                    ts.tm_min, ts.tm_sec]
            os.makedirs(cfg.rinexpath, exist_ok=True)
            self.obs_writer = RinexObsWriter(
                os.path.join(cfg.rinexpath, f"sdr_{stamp}.obs"), date)
            self.nav_writer = RinexNavWriter(
                os.path.join(cfg.rinexpath, f"sdr_{stamp}.nav"), date)
        self.rtcm_srv = TcpServer(cfg.rtcmport) if cfg.rtcm else None
        self.sbas_srv = TcpServer(cfg.sbasport) if cfg.sbas else None
        self.epochs_written = 0
        self.ephs_written = 0
        # single-point positioning (beyond-reference; obs/spp.py):
        # receivers register decoded ephemerides in ``ephs``; each emitted
        # epoch with >=4 usable satellites is solved and appended to
        # ``positions`` (tow, ecef, clk, nsat) + the .pos file
        self.spp = bool(cfg.spp)
        # optional carrier smoothing of pseudoranges before output/SPP
        self.smoother = None
        if cfg.smooth:
            from ..obs.smooth import HatchSmoother
            self.smoother = HatchSmoother(window=int(cfg.smooth))
        self.ephs = {}
        self.positions = []
        self.solutions = []         # full SppSolution per fix (vel, DOP)
        self.pos_writer = None
        self._last_pos = None
        if self.spp and cfg.rinex:
            os.makedirs(cfg.rinexpath, exist_ok=True)
            stamp = time.strftime('%Y%m%d%H%M%S', time.gmtime())
            if self.obs_writer is not None:
                # share the RINEX files' timestamp
                stamp = os.path.basename(self.obs_writer.path)[4:-4]
            self.pos_writer = open(
                os.path.join(cfg.rinexpath, f"sdr_{stamp}.pos"), "w")
            self.pos_writer.write(
                "% gnsslib_tpu single-point positions\n"
                "% week tow  x(m) y(m) z(m)  clk(m)  nsat  "
                "lat(deg) lon(deg) h(m)  speed(m/s) gdop\n")

    def emit_epochs(self, inputs: list[ChannelObsInput]
                    ) -> list[list[SdrObs]]:
        """Emit every OUTMS-grid epoch now covered by ALL given channel
        histories (may span several front ends)."""
        if not inputs:
            return []
        newest = min(float(c.hist.tow[0]) for c in inputs)
        lo = self._oldreftow if self._oldreftow > 0 else newest - 0.6
        epochs = []
        # integer epoch indices on the outms grid (float division would
        # re-emit boundary epochs)
        k = int(np.floor(lo * 1000.0 / self.outms_ms + 1e-6)) + 1
        while k * self.outms_ms <= newest * 1000.0 + 1e-3:
            t = k * self.outms_ms / 1000.0
            obs = self.aligner._epoch_at(inputs, t)
            if obs:
                if self.smoother is not None:
                    self.smoother.smooth(
                        obs, max_gap_s=2.5 * self.outms_ms / 1000.0)
                epochs.append(obs)
                if self.obs_writer:
                    self.obs_writer.write_epoch(obs)
                if self.rtcm_srv:
                    by_sys = {}
                    for o in obs:
                        by_sys.setdefault(o.sys, []).append(
                            (o.prn, o.P, o.L, o.D, o.S, o.fcn))
                    for sysid, lst in by_sys.items():
                        self.rtcm_srv.send(encode_msm7(
                            sysid, lst, obs[0].week, obs[0].tow))
                if self.spp:
                    self._solve_epoch(obs)
                self.epochs_written += 1
            k += 1
        self._oldreftow = newest
        return epochs

    def _solve_epoch(self, obs) -> None:
        from ..obs.spp import ecef2llh, spp_solve
        import math
        sol = spp_solve(obs, self.ephs, x0=self._last_pos,
                        raim_thresh=float(self.cfg.raim))
        if not sol.ok:
            return
        self._last_pos = sol.pos
        self.positions.append((obs[0].week, obs[0].tow, sol.pos,
                               sol.clk, sol.nsat))
        self.solutions.append((obs[0].week, obs[0].tow, sol))
        if self.pos_writer:
            lat, lon, h = ecef2llh(sol.pos)
            spd = (float(np.linalg.norm(sol.vel))
                   if sol.vel is not None else 0.0)
            gdop = sol.dop["gdop"] if sol.dop else 0.0
            self.pos_writer.write(
                f"{obs[0].week:5d} {obs[0].tow:11.3f} "
                f"{sol.pos[0]:14.3f} {sol.pos[1]:14.3f} "
                f"{sol.pos[2]:14.3f} {sol.clk:12.3f} {sol.nsat:3d} "
                f"{math.degrees(lat):12.7f} {math.degrees(lon):12.7f} "
                f"{h:9.3f} {spd:8.3f} {gdop:6.2f}\n")
            self.pos_writer.flush()

    def close(self) -> None:
        """Close output files (writers flush per record; this releases
        the descriptors for long-lived embedding processes)."""
        if self.pos_writer is not None:
            self.pos_writer.close()
            self.pos_writer = None
        for w in (self.obs_writer, self.nav_writer):
            if w is not None and hasattr(w, "close"):
                w.close()

    def emit_nav(self, channels: list["ChannelRuntime"]) -> None:
        """Nav records on ephemeris update (src/sdrsync.c:137-156);
        idempotent per eph.update flag, so each front end's receiver may
        call it with its own channel list."""
        for ch in channels:
            eph = ch.nav.eph
            if eph.update and eph.cnt >= eph.cntth:
                eph.cnt = 0
                eph.update = False
                self.ephs_written += 1
                if self.nav_writer:
                    if ch.cfg.ctype == CodeType.G1:
                        self.nav_writer.write_geph(ch.nav.prn, eph.geph)
                    elif ch.cfg.ctype == CodeType.L1CA:
                        self.nav_writer.write_eph(ch.cfg.sys, ch.cfg.prn,
                                                  eph.eph)
                if self.rtcm_srv:
                    if ch.cfg.ctype == CodeType.G1:
                        self.rtcm_srv.send(encode_1020(ch.nav.prn,
                                                       eph.geph))
                    elif ch.cfg.ctype == CodeType.L1CA and \
                            ch.cfg.sys == SYS_QZS:
                        self.rtcm_srv.send(encode_1044(ch.cfg.prn,
                                                       eph.eph))
                    elif ch.cfg.ctype == CodeType.L1CA and \
                            ch.cfg.sys == SYS_GPS:
                        self.rtcm_srv.send(encode_1019(ch.cfg.prn,
                                                       eph.eph))


class Receiver:
    """One front-end group receiver (all channels share f_sf/f_if/dtype).

    ``frontend`` provides ``read(start, n)`` + ``nsamples`` (io.FileFrontend
    or any duck-typed source, e.g. a synthesizer for tests).

    ``hub`` — pass a shared :class:`OutputHub` (and ``standalone=False``)
    to merge this path's observables with other front ends'; by default
    the receiver owns its hub and emits epochs itself.
    """

    def __init__(self, cfg: ReceiverConfig, frontend, ftype: int = 1,
                 nsteps_per_block: int = 400, hub: OutputHub | None = None,
                 standalone: bool = True, pipeline: bool = True,
                 mesh=None, channels=None, cache=None,
                 pipeline_depth: int = 2, pipeline_acq: bool | None = None,
                 acq_pipeline_depth: int | None = None,
                 precompile: bool | None = None,
                 pipeline_pullin: bool | None = None):
        self.cfg = cfg
        self.frontend = frontend
        self.standalone = standalone
        # steady-state pipelining (FastTracker.run_block_start/collect):
        # keep up to ``pipeline_depth`` blocks in flight, collecting the
        # oldest only when the queue is full, so each block's device->host
        # transfer AND its host-side nav/obs work overlap the next blocks'
        # device compute.  Engaged only when
        # every locked channel is bit-synced (no host->device nav feedback
        # pending); loss-of-lock (relock) tolerates the deferred
        # detection — the faded channel is reset up to ``depth`` blocks
        # late, during which it was integrating noise either way, and its
        # in-flight telemetry is discarded via the locked-at-dispatch
        # flags.  Costs ``depth`` blocks of nav/output latency.
        self.pipeline = pipeline
        self.pipeline_depth = max(1, int(pipeline_depth))
        self._pending = []            # FIFO of (getter, base, cnt0, locked0)
        # pipelined acquisition: dispatch the search, read the decision
        # TWO blocks later (overlapped with tracking compute) instead of a
        # blocking device->host read that drains the pipeline every
        # ACQSLEEP retry.  Depth 2 matters: a search dispatched at block k
        # executes behind the in-flight tracking block(s), so collecting
        # it at block k+1 still waits out a whole tracking block of device
        # time; by block k+2 the search finished long ago and the collect
        # reads already-copied bytes.
        # Costs up to depth blocks of lock latency on success; a no-lock
        # search (the steady-state retry tax for absent PRNs) costs
        # nothing.  Defaults to the telemetry pipelining flag.
        self.pipeline_acq = (pipeline if pipeline_acq is None
                             else bool(pipeline_acq))
        # pipelined PULL-IN (pre-steady) blocks: same dispatch/collect
        # split on the per-period scan engine.  Unlike the steady path
        # this is NOT a pure scheduling change — the deferred host->
        # device nav feedback (set_bit_sync, an absolute phase mod loop)
        # lands up to ``depth`` blocks late, keeping a just-synced
        # channel on prm1 cadence that much longer (bounded, benign:
        # prm1 is the cadence that achieved the sync).  What it buys: the
        # telemetry transfer and host nav work of each pull-in block
        # overlap the next block's device compute.
        self.pipeline_pullin = (pipeline if pipeline_pullin is None
                                else bool(pipeline_pullin))
        self._acq_pipeline_depth_arg = acq_pipeline_depth
        # in-flight pipelined searches, oldest first:
        # (getter, base, t_disp, pend_idx)
        self._acq_pend: list = []
        # background fetches (see _BgFetch): safe single-process; multi-
        # controller collects run collectives that must execute in
        # identical order on every process, so they stay synchronous
        self._bg_ok = None
        # cooperative stop (the reference's keythread 'q' -> stopflag,
        # src/sdrmain.c:59-80): run loops exit at the next block boundary
        # and flush pipelined blocks, so writers close complete
        self.stop_requested = False
        spec = cfg.fends[ftype - 1]
        self.spec = spec
        chans = (list(channels) if channels is not None else
                 [c for c in cfg.channels if c.ftype == ftype])
        if not chans:
            raise ValueError("no channels for this front end")
        self.prns = [c.prn for c in chans]
        self.ctypes = [c.ctype for c in chans]
        foffsets = [spec.foffset + c.foffset_fdma for c in chans]
        f_cfs = [c.f_cf for c in chans]

        self.acq = Acquirer(self.prns, self.ctypes, spec.f_sf, spec.f_if,
                            spec.dtype, foffsets=foffsets,
                            confirm=cfg.acqconfirm)
        self.trk = Tracker(cfg.track, self.prns, self.ctypes, spec.f_sf,
                           spec.f_if, spec.dtype, foffsets=foffsets,
                           f_cfs=f_cfs)
        try:
            # steady-state fast path (L periods/step); falls back to the
            # per-period scan during acquisition/pull-in or for mixed
            # loop-cadence channel groups
            self.fast = FastTracker(self.trk)
        except ValueError:
            self.fast = None
        # multi-chip: channel-sharded engines over a jax mesh (SPMD, no
        # collectives in steady state — SURVEY.md §2.4); host nav/obs and
        # the stream cursor are unchanged
        self._slow_eng, self._fast_eng = self.trk, self.fast
        self._acq_backend = self.acq.search   # host-data path
        self._acq_sharded = None
        self._acq_search = self._acq_dispatch  # the override point
        # device-resident block search only on the unsharded path (the
        # sharded acquirer handles its own device placement)
        self._acq_dev_ok = mesh is None
        if mesh is not None:
            from ..parallel import (ShardedAcquirer, ShardedFastTracker,
                                    ShardedTracker)
            self._slow_eng = ShardedTracker(self.trk, mesh)
            self._acq_sharded = ShardedAcquirer(self.acq, mesh)
            self._acq_backend = self._acq_sharded.search
            if self.fast is not None:
                self._fast_eng = ShardedFastTracker(self.fast, mesh)
        self.state = self.trk.init_state()
        self.nsamp = self.trk.n_nom
        self.nsteps = int(nsteps_per_block)
        self.block_len = (self.nsteps * self.nsamp + self.trk.nwin
                          + NSPAN * self.nsteps + 2 * self.nsamp + 64)
        # search-collect depth (see the pipelined-acquisition comment
        # above): the decision read starts on a daemon thread at
        # dispatch, so by the k+2 apply the bytes landed long ago and the
        # join is free at every block size.
        if self._acq_pipeline_depth_arg is None:
            self.acq_pipeline_depth = 2
        else:
            self.acq_pipeline_depth = max(
                1, int(self._acq_pipeline_depth_arg))
        # device-resident sample segments: each sample crosses the
        # host->device boundary once, in its narrowest exact dtype; blocks
        # are cut on-device (io/devcache.py).  Channel groups sharing one
        # front end (cadence split, see build_receiver) share the cache so
        # the segment is uploaded once.
        if cache is not None and cache.block_len == self.block_len:
            self.cache = cache
        else:
            # live sources: short segments (4 blocks) bound the catch-up
            # latency of each segment upload; file replay auto-sizes to
            # whole-capture device residency
            seg = 4 if getattr(frontend, "is_live", False) else None
            self.cache = DeviceBlockCache(frontend, self.block_len,
                                          seg_blocks=seg,
                                          stride=self.nsteps * self.nsamp)
        self.base = 0                      # abs sample index of block start
        self.channels = []
        for i, c in enumerate(chans):
            nav = NavChannel(c.ctype, c.prn, sat=0, ref_week=cfg.ref_week)
            # deep enough to cover one block's worth of loop updates (so
            # no epoch falls off before _emit_epochs sees it), per channel
            depth = max(OBSINTERPN,
                        2 * self.nsteps // loop_interval(c.ctype) + 8)
            hist = ObsHistory(
                ctime=float(self.trk.ctime[i]), f_sf=spec.f_sf,
                crate=float(self.trk.crate[i]),
                loop_periods=loop_interval(c.ctype), depth=depth)
            self.channels.append(ChannelRuntime(idx=i, cfg=c, nav=nav,
                                                hist=hist))
        self.hub = hub if hub is not None else OutputHub(cfg)
        # host shadow of state.cnt: reading the device array every block
        # would sync on the previous dispatch (serializing the pipeline);
        # cnt advances deterministically (+nsteps per block for channels
        # active at dispatch, 0 at start_channels)
        self._cnt_host = np.zeros(len(self.channels), np.int64)
        self.loggers = {}
        if cfg.log:
            os.makedirs(cfg.logpath, exist_ok=True)
            for ch in self.channels:
                sid = satno2id(satno(ch.cfg.sys, ch.cfg.prn)) or \
                    f"C{ch.cfg.prn:02d}"
                self.loggers[ch.idx] = TrackLogger(
                    cfg.logpath, sid, cfg.track.corrn, cfg.track.corrd,
                    float(self.trk.crate[ch.idx]), spec.f_if)
        # live diagnostics on the reference spectrum-thread cadence
        # (SPEC_MS=200 ms refresh, src/sdrspec.c:29-110), stream-time paced
        self.spec_monitor = None
        if cfg.spec:
            from ..constants import DType
            from ..diag.monitor import SpectrumMonitor
            self.spec_monitor = SpectrumMonitor(
                frontend, spec.f_sf, spec.dtype == DType.IQ)
        self._events = []
        # live diagnostics hooks: acquisition surface per acquired PRN
        # (pltacq) and last correlator tap shape per PRN (plttrk,
        # src/sdrmain.c:293-299) — populated when the monitor is on
        self.acq_views = {}
        self.corr_views = {}
        self.on_acq = None
        # composite receivers (MultiReceiver) set this to the merged
        # channel list, so cross-channel lookups (the SBAS week borrow,
        # src/sdrnav_sbs.c:124-127) see every group's channels
        self.peer_channels = None
        # cold-start observability (time-to-first-fix, SURVEY.md §5 /
        # round-5 TTFF work): wall-clock milestones since construction,
        # each recorded once — "first_block" (first step_block returned,
        # i.e. acquisition + tracking compiles done), "first_lock",
        # "first_sync" (first bit sync), "steady" (every locked channel
        # synced, fast path engaged), "first_epoch" (first observable
        # epoch emitted).  tools/ttff.py reports these per process.
        self.timeline = {"t0": time.time()}
        # cold start: warm the acquisition / pull-in / steady-state
        # program caches on a background thread, overlapped with the
        # capture upload, so the three compiles do not serialize with the
        # stream (the steady-state program would otherwise compile AT the
        # steady switch, stalling the stream mid-run)
        self._precompile_error = None
        self._precompile(enabled=precompile)

    def _precompile(self, enabled: bool | None) -> None:
        import jax
        if enabled is None:
            # auto: accelerator backends only (CPU tests would pay real
            # compile time for programs many tests never run), unsharded
            # engines only (keep mesh dispatch order owned by the main
            # thread)
            enabled = (jax.default_backend() != "cpu"
                       and self._fast_eng is self.fast)
        if not enabled:
            return
        from ..constants import DType

        def work():
            try:
                import jax.numpy as jnp
                shape = ((self.block_len, 2)
                         if self.spec.dtype == DType.IQ
                         else (self.block_len,))
                block = jnp.zeros(shape, jnp.float32)
                # full-grid acquisition (the block-0 search program)
                self.acq.search_dev_start(
                    block, diag=self.spec_monitor is not None)
                carry = self.trk._state_to_dict(self.trk.init_state())
                # per-period pull-in scan
                self.trk._run(carry, block, self.trk._consts, self.nsteps)
                # steady-state fast program (otherwise compiles AT the
                # steady switch, stalling the stream mid-run)
                if self.fast is not None and \
                        self.nsteps % self.fast.L == 0:
                    self.fast._run(carry, block, self.fast._consts,
                                   self.fast._fconsts,
                                   self.nsteps // self.fast.L)
                self._mark("precompiled")
            except Exception as e:
                # kept for the main thread: step_block raises it
                self._precompile_error = e
        threading.Thread(target=work, daemon=True).start()

    def _raise_precompile_error(self) -> None:
        """Re-raise, on the calling thread, the error the background
        precompile hit (once)."""
        err, self._precompile_error = self._precompile_error, None
        if err is not None:
            raise err

    def _mark(self, name: str) -> None:
        if name not in self.timeline:
            self.timeline[name] = time.time() - self.timeline["t0"]

    @property
    def events(self) -> list:
        """Receiver events in stream-time order.  With pipelining, a
        block's nav events are recorded one step late (after the next
        block's acq events are appended), so ordering by timestamp —
        stable within equal times — restores the sequential-mode order."""
        return sorted(self._events, key=lambda e: e[1])

    # hub delegation (external API stability) ---------------------------- #
    @property
    def epochs_written(self) -> int:
        return self.hub.epochs_written

    @property
    def ephs_written(self) -> int:
        return self.hub.ephs_written

    @property
    def obs_writer(self):
        return self.hub.obs_writer

    @property
    def nav_writer(self):
        return self.hub.nav_writer

    # ------------------------------------------------------------------ #
    def _bg_fetch(self, fn, *args):
        """Wrap a blocking device->host collect: background thread when
        safe (single controller), else a deferred synchronous call.
        Returns a zero-arg getter."""
        if self._bg_ok is None:
            import jax
            self._bg_ok = jax.process_count() == 1
        if self._bg_ok:
            return _BgFetch(fn, *args).get
        return functools.partial(fn, *args)

    def _acq_dispatch(self) -> "AcqResult":
        """One acquisition pass over the current stream position — the
        single override point (tests intercept it to suppress channels).
        Unsharded receivers search the device-resident cache block in
        place (no host read, no re-upload, only decision vectors return;
        with the diagnostics monitor on, the power-surface handle rides
        along for the pltacq view, src/sdrmain.c:258-261); the sharded /
        small-block path reads host samples for the sharded program."""
        need = (self.acq.intg + 2) * self.nsamp
        if self._acq_dev_ok and self.block_len >= need:
            return self.acq.search_dev(
                self.cache.get(self.base, self.block_len),
                diag=self.spec_monitor is not None)
        return self._acq_backend(self.frontend.read(self.base, need))

    def _collect_acq(self, all_pending: bool = False) -> None:
        """Collect matured in-flight searches (dispatched at least
        ``acq_pipeline_depth`` blocks ago — by then the search program
        finished behind the tracking blocks and its decision vectors'
        async copy landed, so the read costs one host copy, not a
        tracking block of device time).  ``all_pending`` drains
        everything (flush/checkpoint/EOF)."""
        adv = self.nsteps * self.nsamp
        while self._acq_pend and (
                all_pending
                or self.base - self._acq_pend[0][1]
                >= self.acq_pipeline_depth * adv
                or len(self._acq_pend) > self.acq_pipeline_depth):
            getter, base_s, t_disp, pend_idx = self._acq_pend.pop(0)
            self._apply_acq(getter(), base_s, t_disp, pend_idx)

    def _try_acquire(self) -> None:
        t_stream = self.base / self.spec.f_sf
        pend = [ch for ch in self.channels if not ch.locked and
                t_stream - ch.last_acq_attempt >= ACQSLEEP / 1000.0 - 1e-9]
        if not pend:
            return
        pend = self._try_hotstart(pend, t_stream)
        if not pend:
            return
        for ch in pend:
            ch.last_acq_attempt = t_stream     # retry cadence anchors at
        need = (self.acq.intg + 2) * self.nsamp   # dispatch (ACQSLEEP)
        if (self.pipeline_acq
                and (self._acq_sharded is not None
                     or (self._acq_dev_ok and self.block_len >= need))
                and getattr(self._acq_search, "__func__", None)
                is Receiver._acq_dispatch):
            # pipelined: dispatch now, decide acq_pipeline_depth blocks
            # later (the searched data is this block's — only the
            # DECISION is deferred; a lock starts up to depth blocks
            # late, comparable to the reference's own 2 s retry
            # granularity).  A mesh receiver runs the sharded program on
            # host samples on the same schedule, so its locks and events
            # match one device's.  Tests overriding _acq_search keep the
            # synchronous path.
            if self._acq_sharded is not None:
                handle = self._acq_sharded.search_start(
                    self.frontend.read(self.base, need))
                collect = self._acq_sharded.search_collect
            else:
                handle = self.acq.search_dev_start(
                    self.cache.get(self.base, self.block_len),
                    diag=self.spec_monitor is not None,
                    idx=[ch.idx for ch in pend])
                collect = self.acq.search_dev_collect
            # the decision read starts NOW on a background thread (the
            # search runs behind the in-flight tracking blocks; the
            # scheduled apply then joins landed bytes instead of waiting
            # out a tracking block of device queue)
            self._acq_pend.append((
                self._bg_fetch(collect, handle),
                self.base, t_stream, [ch.idx for ch in pend]))
            return
        self._apply_acq(self._acq_search(), self.base, t_stream,
                        [ch.idx for ch in pend])

    def _apply_acq(self, res: "AcqResult", base_s: int, t_disp: float,
                   pend_idx: list[int]) -> None:
        """Start tracking for every pending channel the search accepted.
        ``base_s`` is the stream position of the searched data; when the
        decision arrives later (pipelined search), the acquired code phase
        is propagated to the current base along the acquired code-Doppler
        trajectory (the residual after one block is ≪ the acquisition
        grid's own half-sample/half-bin quantization)."""
        delta = self.base - base_s
        for i in pend_idx:
            ch = self.channels[i]                 # idx == position
            if ch.locked or not bool(res.acquired[i]):
                continue
            codei = int(res.codei[i])
            dcarr = float(res.dcarr[i])
            if delta:
                cfreq = float(self.trk.crate[i]) + dcarr * float(
                    self.trk.aid[i])               # chips/s, carrier-aided
                tc_samp = self.trk._clens[i] / cfreq * self.spec.f_sf
                codei = int(round((codei - delta) % tc_samp))
            ch.locked = True
            ch.t_acq = self.base / self.spec.f_sf
            ch.cn0 = float(res.cn0[i])
            self._mark("first_lock")
            self.state = self.trk.start_channels(
                self.state, [i], [codei], [dcarr])
            self._cnt_host[i] = 0
            self._events.append(
                ("acq", t_disp, ch.cfg.prn, float(res.cn0[i]),
                 float(res.peakr[i])))
            if res.P is not None:
                # grid_scale: full-rate samples per surface code-phase
                # cell (> 1 with coarse acquisition) — codei is always
                # full-rate, so surface consumers divide by it
                view = dict(surface=np.asarray(res.P[i]),
                            dopp_hz=self.acq.dopp_hz,
                            codei=int(res.codei[i]),
                            grid_scale=float(self.acq.scale),
                            cn0=float(res.cn0[i]), t=t_disp)
                self.acq_views[ch.cfg.prn] = view
                if self.on_acq is not None:
                    self.on_acq(ch, view)

    def _try_hotstart(self, pend: list, t_stream: float) -> list:
        """Position/ephemeris-aided direct tracking handoff (HOTSTART=1;
        absent in the reference, which always FFT-searches).  Once fixes
        exist, an unlocked satellite's code-boundary sample and Doppler
        are predicted from the last position, its broadcast orbit, and a
        decoded reference channel's transmit-time anchor — accurate to a
        fraction of a chip, so the channel starts straight in pull-in.
        Returns the channels still needing cold FFT acquisition."""
        from ..constants import CLIGHT, FREQ1
        from ..gtime import gpst2time
        from ..obs.spp import predict_range
        hub = self.hub
        if not self.cfg.hotstart or not hub.solutions:
            return pend
        # the prediction anchors on the reference channel's NEWEST history
        # record: collect in-flight pipelined blocks first, or the anchor
        # is pipeline_depth blocks stale and the extrapolated code phase
        # drifts out of pull-in range
        self.flush()
        # the flush may have applied an in-flight search decision that
        # locked some of these channels — they need no hot start
        pend = [ch for ch in pend if not ch.locked]
        if not pend:
            return pend
        ref = next((c for c in self.channels if c.locked and c.nav.flagdec
                    and c.cfg.ctype == CodeType.L1CA
                    and c.hist.nrec > 0), None)
        if ref is None:
            return pend
        eph_r = hub.ephs.get((ref.cfg.sys, ref.nav.prn))
        if eph_r is None:
            return pend
        _, _, sol = hub.solutions[-1]
        pos = sol.pos
        week = ref.nav.eph.week_gpst
        ti = self.trk.ti
        # transmit-time anchor from the reference channel's NEWEST
        # observable record (tow_r is the transmit time of the fractional
        # sample codei - remc to tracking jitter).  The anchor must also
        # advance at the ref's TRANSMIT rate (1 - dtau/dt), not 1:1 with
        # receiver samples — code Doppler accumulates ~2.7 us of
        # transmit-time skew per second per 800 m/s of range rate, i.e.
        # chips of error if extrapolated from the preamble seconds ago.
        tow_r = float(ref.hist.tow[0])
        s_r = float(ref.hist.codei[0]) - float(ref.hist.remc[0])
        tau_r, rate_r = predict_range(eph_r, pos, gpst2time(week, tow_r))
        T_r = tow_r + (self.base - s_r) * ti * (1.0 - rate_r)
        t_rx = gpst2time(week, T_r + tau_r)      # GPS receive time at base
        remaining = []
        for ch in pend:
            if ch.cfg.ctype == CodeType.G1:
                # GLONASS: assistance is keyed by slot; find a geph for
                # this channel's FDMA number (geph.frq)
                e = next((g for (s, _), g in hub.ephs.items()
                          if s == ch.cfg.sys
                          and getattr(g, "frq", None) == ch.cfg.prn), None)
                f_cf = ch.cfg.f_cf
            elif ch.cfg.ctype == CodeType.L1CA:
                e = hub.ephs.get((ch.cfg.sys, ch.cfg.prn))
                f_cf = FREQ1
            else:
                e = None
            if e is None:
                remaining.append(ch)
                continue
            tau_t, rate = predict_range(e, pos, t_rx)
            # sample of this satellite's next code-period boundary (all
            # L1 codes here are 1 ms periods on the ms transmit grid)
            T_tx_t = (T_r + tau_r) - tau_t
            ctime = float(self.trk.ctime[ch.idx])
            loc = int(round(((-T_tx_t) % ctime) / ti))
            D = rate * f_cf + sol.clk_drift * f_cf / CLIGHT
            self.state = self.trk.start_channels(
                self.state, [ch.idx], [loc], [-D])
            self._cnt_host[ch.idx] = 0
            ch.locked = True
            ch.t_acq = t_stream
            ch.last_acq_attempt = t_stream
            self._events.append(("hot", t_stream, ch.cfg.prn,
                                 float(-D), loc))
        return remaining

    # ------------------------------------------------------------------ #
    def _feed_nav_and_obs(self, out, cnt0: np.ndarray, base: int,
                          locked0: list[bool]) -> None:
        # locked0 = lock flags AT DISPATCH of this block: with pipelining a
        # channel acquired while the block was in flight is locked NOW but
        # produced only inactive-channel garbage IN the block
        for ch in self.channels:
            if not (ch.locked and locked0[ch.idx]):
                continue
            i = ch.idx
            was_started = int(cnt0[i])
            steps = out.ip.shape[0]
            # dashboard shadows (host arrays; no device read)
            ch.dcarr_live = float(out.dcarr[-1, i])
            ch.prompt_live = float(np.median(np.abs(out.ip[:, i])))
            # a channel acquired THIS block produced outputs only from its
            # start; cnt0 is 0 for it and all steps are valid
            evs = ch.nav.update(
                out.ip[:, i],
                base + out.loc[:, i].astype(np.int64),
                was_started)
            for e in evs:
                self._events.append(("nav:" + e.kind,
                                    base / self.spec.f_sf,
                                    ch.cfg.prn, e.sfid, e.tow))
            if ch.nav.flagsync and not ch.synced:
                self.state = self.trk.set_bit_sync(self.state, i,
                                                   ch.nav.sync_offset)
                ch.synced = True
                self._mark("first_sync")
            if ch.cfg.ctype == CodeType.L1SBAS and self.hub.sbas_srv:
                self._send_sbas(ch, evs)
            if i in self.loggers:
                self.loggers[i].log_block(out, i, ch.nav, ch.hist,
                                          int(cnt0[i]))
            if self.spec_monitor is not None:
                # both loop phases (prm1 pull-in and prm2 steady state)
                # update the taps — plot whichever happened last
                updr = np.nonzero(out.flagloopfilter[:, i] > 0)[0]
                if len(updr):
                    k = int(updr[-1])
                    self.corr_views[ch.cfg.prn] = dict(
                        offsets=np.asarray(self.trk.offsets),
                        mag=np.hypot(out.sum_i[k, i], out.sum_q[k, i]),
                        t=base / self.spec.f_sf)
            if self.cfg.relock and ch.synced:
                self._check_lock(ch, out, base)
            elif self.cfg.relock and not ch.synced:
                self._check_pullin(ch, base)
            if ch.nav.flagdec:
                ch.hist.update(
                    cnts=was_started + np.arange(steps),
                    bufflocs=base + out.loc[:, i].astype(np.int64),
                    ns=out.n[:, i], dcarr=out.dcarr[:, i],
                    remcode=out.remcode[:, i], dcode=out.dcode[:, i],
                    sum_i=out.sum_i[:, i], remcarr=out.remcarr[:, i],
                    flagloopfilter=out.flagloopfilter[:, i],
                    firstsftow=ch.nav.firstsftow,
                    firstsfcnt=ch.nav.firstsfcnt,
                    flagsyncf=ch.nav.flagsyncf, polarity=ch.nav.polarity)

    # ------------------------------------------------------------------ #
    def _send_sbas(self, ch, evs) -> None:
        """NovAtel-framed SBAS messages over TCP (src/sdrnav_sbs.c:100-140
        incl. the cross-channel week borrow when MT12 hasn't arrived)."""
        if not any(e.kind == "decode" for e in evs):
            return
        sb = ch.nav.sbas
        if sb.week == 0:
            for other in (self.peer_channels or self.channels):
                if other.nav.flagdec and other.nav.eph.week_gpst:
                    sb.week = other.nav.eph.week_gpst
                    sb.tow = other.hist.tow[0]
                    break
        if sb.week:
            gen_novatel_sbasmsg(sb)
            self.hub.sbas_srv.send(bytes(sb.novatelmsg))

    def _check_lock(self, ch, out, base: int) -> None:
        """Loss-of-lock detection (absent in the reference — a channel
        that fades keeps integrating noise forever, SURVEY.md §5); gated
        by ReceiverConfig.relock.

        Self-calibrating test: the outermost correlator tap pair sits
        ±corrn·corrd samples from prompt — outside the ±1-chip
        correlation triangle for standard geometries (iffile.ini: 18
        samples = 1.125 chips), so those taps integrate NOISE ONLY and
        measure the instantaneous noise floor at the exact coherent
        length.  Lock is lost when the block-median prompt magnitude
        falls within 2x of that floor (a present signal at the ~33 dB-Hz
        tracking threshold still clears 3x).  When the geometry puts the
        outer taps inside the triangle (corrn·corrd < ~1.1 chips), fall
        back to a dropout ratio against the remembered peak prompt."""
        i = ch.idx
        upd = out.flagloopfilter[:, i] == 2
        if not np.any(upd):
            return
        mag = lambda t: (np.abs(out.sum_i[upd, i, t])
                         + np.abs(out.sum_q[upd, i, t]))
        p_med = float(np.median(mag(0)))
        outer_chips = (self.cfg.track.corrn * self.cfg.track.corrd
                       * float(self.trk.crate[i]) / self.spec.f_sf)
        if outer_chips >= 1.05:
            noise = float(np.median(np.concatenate([mag(-2), mag(-1)])))
            lost = p_med < 2.0 * noise
        else:
            lost = p_med < 0.15 * max(ch.peak_prompt, 1e-9)
        if lost:
            self._reset_channel(ch, base / self.spec.f_sf)
        else:
            ch.peak_prompt = max(ch.peak_prompt, p_med)

    def _reset_channel(self, ch, t_stream: float) -> None:
        """Shared loss-of-lock teardown: drop the lock, clear nav and
        observable state, and make the channel immediately eligible for
        the next acquisition pass (lol event path)."""
        ch.locked = False
        ch.synced = False
        ch.nav = NavChannel(ch.cfg.ctype, ch.cfg.prn,
                            ref_week=self.cfg.ref_week)
        ch.hist.nrec = 0
        ch.last_acq_attempt = -1e9
        # forget the old lock's prompt level: _check_lock's fallback
        # test compares against peak_prompt, and a satellite returning
        # ~17 dB weaker (still trackable) would otherwise be judged
        # against the strong lock's peak and reset-loop forever
        ch.peak_prompt = 0.0
        self._events.append(("lol", t_stream, ch.cfg.prn))

    def _check_pullin(self, ch, base: int) -> None:
        """Pull-in watchdog: a channel that reaches no nav bit sync
        within ``pullin_timeout`` seconds of acquisition is tracking
        noise — a satellite that faded DURING pull-in, or a false lock
        that survived the even/odd ACQCONFIRM test.  _check_lock's
        noise-floor test only runs after bit sync (its coherent sums need
        the swloop cadence), so without this watchdog such a channel
        integrates noise forever — exactly the reference failure mode
        (no relock at all, src/sdracq.c:57-59) the relock feature exists
        to fix.  Healthy channels bit-sync ~3-4.5 s after lock (the
        framer's 2 s settle window + ~2 s of NAVSYNCTH edge votes +
        pipeline latency), so the 8 s default has ~2x margin."""
        t_stream = base / self.spec.f_sf
        if t_stream - ch.t_acq > self.cfg.pullin_timeout:
            self._reset_channel(ch, t_stream)

    # ------------------------------------------------------------------ #
    def collect_obs_inputs(self) -> list[ChannelObsInput]:
        """Aligner inputs for every channel ready to produce observables.
        Gate on a FULL history: interp1's neighborhood search assumes
        monotonic sample indices, so zero-filled young histories are
        unusable (the reference tolerates garbage early epochs instead)."""
        for ch in self.channels:
            # register COMPLETE ephemerides for the hub's SPP stage
            # (flagdec only means tow is anchored; orbit terms arrive
            # with later subframes/strings)
            if ch.nav.flagdec:
                if ch.cfg.ctype == CodeType.G1:
                    if any(ch.nav.eph.geph.pos):
                        # record the FDMA channel number (cfg.prn): the
                        # hot start must find a slot's geph by fcn
                        ch.nav.eph.geph.frq = ch.cfg.prn
                        self.hub.ephs[(ch.cfg.sys, ch.nav.prn)] = \
                            ch.nav.eph.geph
                else:
                    e = ch.nav.eph.eph
                    # complete AND consistent: subframes 1 (toc/clock),
                    # 2 (A/toe), 3 (i0/OMG0) seen with MATCHING IODE —
                    # during a data-set cutover sf2's new elements pair
                    # with sf3's old ones for ~6 s; register a snapshot
                    # only when both halves agree
                    if e.A > 0.0 and e.i0 != 0.0 and e.toe.time and \
                            ch.nav.eph.iode_sf2 == ch.nav.eph.iode_sf3:
                        key = (ch.cfg.sys, ch.nav.prn)
                        old = self.hub.ephs.get(key)
                        if old is None or old.iode != e.iode:
                            import copy
                            self.hub.ephs[key] = copy.deepcopy(e)
        ready = [ch for ch in self.channels
                 if ch.nav.flagdec and ch.nav.eph.week_gpst != 0
                 and ch.hist.full]
        return [ChannelObsInput(
            hist=ch.hist, sys=ch.cfg.sys, prn=ch.nav.prn,
            week=ch.nav.eph.week_gpst, nsamp=self.nsamp,
            ctime=float(self.trk.ctime[ch.idx]), ti=self.trk.ti,
            firstsf=ch.nav.firstsf, firstsfcnt=ch.nav.firstsfcnt,
            fcn=(ch.cfg.prn if ch.cfg.ctype == CodeType.G1 else 0))
            for ch in ready]

    def _emit_epochs(self) -> list[list[SdrObs]]:
        epochs = (self.hub.emit_epochs(self.collect_obs_inputs())
                  if self.standalone else [])
        self.hub.emit_nav(self.channels)
        if self.hub.epochs_written:
            self._mark("first_epoch")
        return epochs

    # ------------------------------------------------------------------ #
    def _snapshot(self) -> dict:
        st = {f: np.asarray(getattr(self.state, f))
              for f in self.state.__dataclass_fields__}
        return dict(
            base=self.base, oldreftow=self.hub._oldreftow,
            state=st,
            channels=[(ch.locked, ch.synced, ch.last_acq_attempt,
                       ch.cn0, ch.peak_prompt, ch.nav, ch.hist, ch.t_acq)
                      for ch in self.channels],
            epochs=self.epochs_written, ephs=self.ephs_written)

    def _restore(self, d: dict) -> None:
        self.base = d["base"]
        self.hub._oldreftow = d["oldreftow"]
        self.state = dataclasses.replace(
            self.state, **{k: jnp.asarray(v) for k, v in d["state"].items()})
        self._cnt_host = np.asarray(d["state"]["cnt"], np.int64).copy()
        for ch, rec in zip(self.channels, d["channels"]):
            (locked, synced, laa, cn0, pk, nav, hist), rest = \
                rec[:7], rec[7:]
            ch.locked, ch.synced = locked, synced
            ch.last_acq_attempt, ch.cn0, ch.peak_prompt = laa, cn0, pk
            ch.nav, ch.hist = nav, hist
            # 7-field records predate t_acq; anchor the pull-in watchdog
            # to the checkpoint's stream time, not -1e9 — else RELOCK=1
            # instantly resets every restored locked-but-unsynced channel
            ch.t_acq = rest[0] if rest else d["base"] / self.spec.f_sf
        self.hub.epochs_written = d["epochs"]
        self.hub.ephs_written = d["ephs"]

    def save_checkpoint(self, path: str) -> None:
        """Snapshot the full receiver state: absolute sample index, the
        device tracking pytree, and each channel's nav/observable state —
        the resume story SURVEY.md §5 specifies (the reference has none)."""
        import pickle
        self.flush()
        with open(path, "wb") as f:
            pickle.dump(self._snapshot(), f)

    def load_checkpoint(self, path: str) -> None:
        """Restore a snapshot produced by save_checkpoint (same config)."""
        import pickle
        with open(path, "rb") as f:
            d = pickle.load(f)
        self._restore(d)

    def end_sample(self, seconds: float | None = None) -> int:
        end = self.frontend.nsamples
        if seconds is not None:
            end = min(end, int(seconds * self.spec.f_sf))
        return end

    def can_step(self, end_sample: int) -> bool:
        return self.base + self.block_len <= end_sample

    def step_block(self) -> None:
        """Process one block: acquire, track, nav, observable history —
        and, when standalone, emit epochs.  Advances the stream cursor by
        ``nsteps`` code periods.

        In the steady state (every locked channel bit-synced, relock off,
        ``pipeline=True``) the block is only DISPATCHED here; its nav/obs
        host work happens on the next call, overlapped with that block's
        device compute.  Call :meth:`flush` (run_seconds does) to finalize
        the last in-flight block."""
        self._raise_precompile_error()
        advance = self.nsteps * self.nsamp
        if self.spec_monitor is not None:
            self.spec_monitor.maybe_update(self.base)
        self._collect_acq()
        self._try_acquire()
        if not any(ch.locked for ch in self.channels):
            self.base += advance
            self._mark("first_block")
            return
        use_fast = (self.fast is not None
                    and self.nsteps % self.fast.L == 0
                    and all(ch.synced for ch in self.channels
                            if ch.locked))
        if use_fast:
            self._mark("steady")
        pipelined = use_fast and self.pipeline
        slow_eng = self._slow_eng
        slow_pipe = (not use_fast and self.pipeline_pullin
                     and hasattr(slow_eng, "run_block_start"))
        if not (pipelined or slow_pipe):
            # the in-flight blocks (if any) may feed nav state the slow
            # path depends on (bit sync of a just-acquired channel uses
            # other channels only through the shared clock — but keep
            # strict order regardless).  NOT the full flush(): draining
            # the in-flight acquisition here would collect every
            # pipelined search synchronously during pull-in, undoing the
            # dispatch-now/decide-next-block overlap
            self._flush_blocks()
        cnt0 = self._cnt_host.copy()
        locked0 = [ch.locked for ch in self.channels]
        block = self.cache.get(self.base, self.block_len)
        if slow_pipe:
            # pull-in pipelining: per-period scan dispatched now, nav fed
            # when the block matures (see pipeline_pullin in __init__)
            self.state, handle = slow_eng.run_block_start(
                self.state, block, self.nsteps)
            self._pending.append((
                self._bg_fetch(slow_eng.run_block_collect, handle),
                self.base, cnt0, locked0))
            while len(self._pending) > self.pipeline_depth:
                self._collect(*self._pending.pop(0))
        elif pipelined:
            self.state, handle = self._fast_eng.run_block_start(
                self.state, block, self.nsteps)
            # telemetry fetch starts on a background thread at dispatch
            # (same rationale as the acquisition decision read) — the
            # depth-scheduled _collect below then joins landed bytes
            self._pending.append((
                self._bg_fetch(self._fast_eng.run_block_collect, handle),
                self.base, cnt0, locked0))
            while len(self._pending) > self.pipeline_depth:
                self._collect(*self._pending.pop(0))
        else:
            eng = self._fast_eng if use_fast else self._slow_eng
            self.state, out = eng.run_block(self.state, block, self.nsteps)
            self._feed_nav_and_obs(out, cnt0, self.base, locked0)
            self._emit_epochs()
        self._cnt_host[np.asarray(locked0)] += self.nsteps
        self.state = self.trk.rebase(self.state, advance)
        self.base += advance
        self._mark("first_block")

    def _collect(self, getter, base: int, cnt0: np.ndarray,
                 locked0: list[bool]) -> None:
        out = getter()
        self._feed_nav_and_obs(out, cnt0, base, locked0)
        self._emit_epochs()

    def flush(self) -> None:
        """Finalize the in-flight pipelined blocks (no-op when none).

        In-flight acquisition searches are collected first: a search
        dispatched on the last block(s) before a checkpoint/EOF must not
        be silently dropped — a checkpoint taken with a search in flight
        would otherwise lose the pending lock and a resumed run would
        re-search ACQSLEEP later than an uninterrupted one (_apply_acq's
        delta math handles the base offset).  step_block's slow path
        uses _flush_blocks instead, which leaves searches in flight."""
        self._collect_acq(all_pending=True)
        self._flush_blocks()

    def _flush_blocks(self) -> None:
        pending, self._pending = self._pending, []
        for p in pending:
            self._collect(*p)

    def close(self) -> None:
        """Flush pending work and close output files."""
        self.flush()
        if self.standalone:
            self.hub.close()

    def _summary(self, t_start: float, nblocks: int) -> dict:
        wall = time.time() - t_start
        return dict(
            samples=self.base, seconds=self.base / self.spec.f_sf,
            wall=wall, msps=self.base / 1e6 / max(wall, 1e-9),
            blocks=nblocks,
            locked=[ch.cfg.prn for ch in self.channels if ch.locked],
            decoded=[ch.cfg.prn for ch in self.channels if ch.nav.flagdec],
            epochs=self.epochs_written, ephs=self.ephs_written,
        )

    def run_live(self, seconds: float | None = None,
                 poll_s: float = 0.02, progress=None) -> dict:
        """Stream from a LIVE frontend (ProcessFrontend/StreamFrontend):
        step whenever the producer is a block ahead, sleep-poll while it
        catches up (the reference's sleepms(1) wait, src/sdrtrk.c:30-50),
        stop at producer EOF or after ``seconds`` of stream time."""
        t_start = time.time()
        target = (None if seconds is None
                  else int(seconds * self.spec.f_sf))
        nblocks = 0
        while not self.stop_requested:
            if target is not None and \
                    self.base + self.nsteps * self.nsamp > target:
                break
            avail = self.frontend.nsamples
            if self.can_step(avail):
                self.step_block()
                nblocks += 1
                if progress:
                    progress(self.base / self.spec.f_sf)
            elif getattr(self.frontend, "eof", False):
                break
            else:
                time.sleep(poll_s)
        self.flush()
        return self._summary(t_start, nblocks)

    def run_seconds(self, seconds: float | None = None,
                    progress=None) -> dict:
        """Process the stream (whole file by default).  Returns summary
        statistics.  ``progress``: optional callable(t_stream_seconds)."""
        t_start = time.time()
        end_sample = self.end_sample(seconds)
        nblocks = 0
        while not self.stop_requested and self.can_step(end_sample):
            self.step_block()
            nblocks += 1
            if progress:
                progress(self.base / self.spec.f_sf)
        self.flush()
        return self._summary(t_start, nblocks)

    def request_stop(self) -> None:
        """Ask the run loop to stop at the next block boundary (signal /
        'q'-key safe: just sets a flag)."""
        self.stop_requested = True


class MultiReceiver:
    """Several per-group receivers stepped in lockstep with one shared
    :class:`OutputHub`, so common epochs combine every group's channels
    (the reference's single sync thread over all channel threads,
    src/sdrsync.c:49-135).  Groups arise from:

    * **RF paths** (STEREO FE1+FE2 — the classic dual front end), and/or
    * **loop-cadence classes** within one path: the FastTracker needs one
      uniform update interval, so e.g. SBAS (``loop``=2) channels get
      their own tracker group and the GPS/GLONASS (``loop``=10) group
      keeps the steady-state fast path instead of everyone falling back
      to the per-period scan.

    Same-path groups share the device sample cache (one upload).  Blocks
    are stepped in lockstep; per-group ``nsteps`` must span equal stream
    time.
    """

    def __init__(self, cfg: ReceiverConfig, parts: list,
                 nsteps_per_block: int = 400, mesh=None,
                 pipeline: bool = True):
        """``parts``: list of (ftype, frontend, channel_subset)."""
        self.cfg = cfg
        self.hub = OutputHub(cfg)
        self.rx = []
        caches = {}
        for ft, fe, chans in parts:
            r = Receiver(cfg, fe, ftype=ft,
                         nsteps_per_block=nsteps_per_block,
                         hub=self.hub, standalone=False, mesh=mesh,
                         pipeline=pipeline,
                         channels=chans, cache=caches.get(id(fe)))
            caches.setdefault(id(fe), r.cache)
            self.rx.append(r)
        merged = [ch for r in self.rx for ch in r.channels]
        for r in self.rx:
            r.peer_channels = merged
        # one spectrum monitor per physical frontend (cadence groups share
        # the RF path; recomputing the same spectrum per group is waste)
        seen_fe = set()
        for r in self.rx:
            if r.spec_monitor is not None:
                if id(r.frontend) in seen_fe:
                    r.spec_monitor = None
                else:
                    seen_fe.add(id(r.frontend))
        t0 = self.rx[0].nsteps * self.rx[0].nsamp / self.rx[0].spec.f_sf
        for r in self.rx[1:]:
            t = r.nsteps * r.nsamp / r.spec.f_sf
            if abs(t - t0) > 1e-12:
                raise ValueError("group block durations differ "
                                 f"({t0} vs {t}); use code periods with "
                                 "equal duration across groups")

    @property
    def epochs_written(self) -> int:
        return self.hub.epochs_written

    @property
    def ephs_written(self) -> int:
        return self.hub.ephs_written

    @property
    def obs_writer(self):
        return self.hub.obs_writer

    @property
    def nav_writer(self):
        return self.hub.nav_writer

    @property
    def events(self):
        ev = [e for r in self.rx for e in r.events]
        ev.sort(key=lambda e: e[1])
        return ev

    @property
    def channels(self):
        return [ch for r in self.rx for ch in r.channels]

    def save_checkpoint(self, path: str) -> None:
        import pickle
        for r in self.rx:
            r.flush()
        with open(path, "wb") as f:
            pickle.dump([r._snapshot() for r in self.rx], f)

    def load_checkpoint(self, path: str) -> None:
        import pickle
        with open(path, "rb") as f:
            snaps = pickle.load(f)
        for r, d in zip(self.rx, snaps):
            r._restore(d)

    def close(self) -> None:
        for r in self.rx:
            r.flush()
        self.hub.close()

    @property
    def stop_requested(self) -> bool:
        return any(r.stop_requested for r in self.rx)

    def request_stop(self) -> None:
        for r in self.rx:
            r.request_stop()

    def _step_all(self) -> None:
        for r in self.rx:
            r.step_block()
        # merge both paths' ready channels into one epoch stream
        self.hub.emit_epochs(
            [ci for r in self.rx for ci in r.collect_obs_inputs()])

    def _finish(self, t_start: float, nblocks: int) -> dict:
        for r in self.rx:
            r.flush()
        self.hub.emit_epochs(
            [ci for r in self.rx for ci in r.collect_obs_inputs()])
        wall = time.time() - t_start
        samples = sum(r.base for r in self.rx)
        return dict(
            samples=samples,
            seconds=self.rx[0].base / self.rx[0].spec.f_sf,
            wall=wall, msps=samples / 1e6 / max(wall, 1e-9),
            blocks=nblocks,
            locked=[ch.cfg.prn for r in self.rx for ch in r.channels
                    if ch.locked],
            decoded=[ch.cfg.prn for r in self.rx for ch in r.channels
                     if ch.nav.flagdec],
            epochs=self.hub.epochs_written, ephs=self.hub.ephs_written,
        )

    def run_seconds(self, seconds: float | None = None,
                    progress=None) -> dict:
        t_start = time.time()
        ends = [r.end_sample(seconds) for r in self.rx]
        nblocks = 0
        while not self.stop_requested and \
                all(r.can_step(e) for r, e in zip(self.rx, ends)):
            self._step_all()
            nblocks += 1
            if progress:
                progress(self.rx[0].base / self.rx[0].spec.f_sf)
        return self._finish(t_start, nblocks)

    def run_live(self, seconds: float | None = None,
                 poll_s: float = 0.02, progress=None) -> dict:
        """Live-capture lockstep: step every group once all its producer
        rings are a block ahead; sleep-poll while any catches up (the
        reference's sleepms wait, src/sdrtrk.c:30-50); stop at producer
        EOF or after ``seconds`` of stream time."""
        t_start = time.time()
        r0 = self.rx[0]
        target = None if seconds is None else int(seconds * r0.spec.f_sf)
        nblocks = 0
        while not self.stop_requested:
            if target is not None and \
                    r0.base + r0.nsteps * r0.nsamp > target:
                break
            ready = [r.can_step(r.frontend.nsamples) for r in self.rx]
            if all(ready):
                self._step_all()
                nblocks += 1
                if progress:
                    progress(r0.base / r0.spec.f_sf)
            elif any(getattr(r.frontend, "eof", False)
                     for r, ok in zip(self.rx, ready) if not ok):
                break
            else:
                time.sleep(poll_s)
        return self._finish(t_start, nblocks)


class DualReceiver(MultiReceiver):
    """Both RF paths of a dual front end (STEREO FE1+FE2) — kept as the
    named two-path special case of :class:`MultiReceiver`."""

    def __init__(self, cfg: ReceiverConfig, frontends: list,
                 nsteps_per_block: int = 400, mesh=None):
        ftypes = sorted({c.ftype for c in cfg.channels})
        if len(ftypes) < 2:
            raise ValueError("DualReceiver needs channels on two FTYPEs")
        parts = [(ft, fe, [c for c in cfg.channels if c.ftype == ft])
                 for ft, fe in zip(ftypes, frontends)]
        super().__init__(cfg, parts, nsteps_per_block, mesh)


def build_receiver(cfg: ReceiverConfig, frontends, nsteps_per_block=400,
                   mesh=None, pipeline=True):
    """Compose the right receiver for a config: channels are grouped by
    (RF path, loop cadence); a single homogeneous group gets a plain
    :class:`Receiver`, anything else a :class:`MultiReceiver`.

    ``frontends``: a {ftype: frontend} dict, or a list paired with the
    configured FTYPEs in sorted order (a single frontend is accepted).
    """
    if isinstance(frontends, dict):
        fmap = dict(frontends)
    else:
        if not isinstance(frontends, (list, tuple)):
            frontends = [frontends]
        fts = sorted({c.ftype for c in cfg.channels})[:len(frontends)]
        fmap = dict(zip(fts, frontends))
    parts = []
    for ft in sorted(fmap):
        fe = fmap[ft]
        chans = [c for c in cfg.channels if c.ftype == ft]
        if not chans:
            continue
        by_loop = {}
        for c in chans:
            by_loop.setdefault(loop_interval(c.ctype), []).append(c)
        for _, grp in sorted(by_loop.items()):
            parts.append((ft, fe, grp))
    if len(parts) == 1:
        ft, fe, grp = parts[0]
        return Receiver(cfg, fe, ftype=ft,
                        nsteps_per_block=nsteps_per_block,
                        pipeline=pipeline, mesh=mesh, channels=grp)
    return MultiReceiver(cfg, parts, nsteps_per_block, mesh,
                         pipeline=pipeline)

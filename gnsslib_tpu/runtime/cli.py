"""erlang-gnss-tpu command line — the reference `erlang-gnss` CLI
(src/sdrmain.c:70-103) for post-processing file replay.

Usage:
    python -m gnsslib_tpu <config.ini> [--seconds N] [--nsteps N] [--quiet]
"""
from __future__ import annotations

import argparse
import os
import sys

from ..constants import FrontendType as FT
from ..io.frontend import FileFrontend
from .config import load_ini
from .receiver import build_receiver

# live FEND types -> in-process driver bindings (src/sdrrcv.c:20-90)
_LIVE_FENDS = (FT.STEREO, FT.GN3SV2, FT.GN3SV3, FT.RTLSDR, FT.BLADERF)


def _make_live_frontend(spec, built: list):
    """Instantiate the in-process driver for a live FEND type.  The
    STEREO second RF path is a view over FE1's byte stream (both paths
    are packed in one byte, src/rcv/stereo/stereo.c:160-205)."""
    if spec.fend == FT.STEREO:
        from ..io.stereo import StereoFrontend
        for fe in built:                     # FE2 rides FE1's ring
            if isinstance(fe, StereoFrontend):
                return fe.fe2(spec)
        return StereoFrontend(spec)
    if spec.fend == FT.RTLSDR:
        from ..io.rtlsdr import RtlSdrFrontend
        return RtlSdrFrontend(spec)
    if spec.fend == FT.BLADERF:
        from ..io.bladerf import BladeRfFrontend
        return BladeRfFrontend(spec)
    from ..io.gn3s import Gn3sFrontend
    return Gn3sFrontend(spec)


def _install_stop_handlers(rx, quiet: bool) -> None:
    """Graceful interruption (the reference's keythread 'q' -> stopflag
    -> quitsdr teardown, src/sdrmain.c:59-80,190-218): SIGINT/SIGTERM —
    and 'q' on a tty — stop the run loop at the next block boundary, so
    pipelined blocks flush and RINEX/pos writers close complete.  A
    second signal force-exits (a hung device call must stay interruptible)."""
    import signal
    import threading

    seen = []

    def _handler(signum, frame):
        if seen:
            raise KeyboardInterrupt
        seen.append(signum)
        if not quiet:
            print("\nstopping: flushing pipelined blocks and closing "
                  "outputs (signal again to force quit)", file=sys.stderr)
        rx.request_stop()

    for s in (signal.SIGINT, signal.SIGTERM):
        try:
            signal.signal(s, _handler)
        except (ValueError, OSError):      # non-main thread / platform
            return

    if sys.stdin is not None and sys.stdin.isatty():
        # cbreak: deliver 'q' immediately (a canonical-mode tty would
        # buffer it until Enter).  Set from the MAIN thread with an
        # atexit restore — the daemon reader may die blocked in read()
        # and would never run its own cleanup.
        try:
            import atexit
            import termios
            import tty
            fd = sys.stdin.fileno()
            saved = termios.tcgetattr(fd)
            tty.setcbreak(fd)
            atexit.register(
                lambda: termios.tcsetattr(fd, termios.TCSADRAIN, saved))
        except Exception:
            pass

        def _keythread():
            while not rx.stop_requested:
                try:
                    c = sys.stdin.read(1)
                except (OSError, ValueError):
                    return
                if not c:
                    return                  # stdin EOF
                if c.lower() == "q":
                    rx.request_stop()
                    return
        threading.Thread(target=_keythread, daemon=True).start()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="erlang-gnss-tpu",
        description="GNSS SDR receiver on JAX (file replay)")
    ap.add_argument("config", help="gnss-sdrcli-style INI file")
    ap.add_argument("--seconds", type=float, default=None,
                    help="limit processing to the first N stream seconds")
    ap.add_argument("--nsteps", type=int, default=400,
                    help="code periods per device block")
    ap.add_argument("--devices", type=int, default=1,
                    help="shard channels over the first N jax devices "
                         "(acquisition + tracking engines via shard_map)")
    ap.add_argument("--ftype", type=int, default=0,
                    help="front-end RF path to process (1 or 2; default "
                         "0 = every path with configured channels)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--spp", action="store_true",
                    help="solve single-point positions per obs epoch "
                         "(also [OUTPUT] SPP=1); writes a .pos file "
                         "alongside RINEX")
    ap.add_argument("--spec", action="store_true",
                    help="write IF spectrum/histogram diagnostics "
                         "(also enabled by [SPECTRUM] SPEC=1)")
    ap.add_argument("--watch", action="store_true",
                    help="live terminal dashboard (lock, C/N0, Doppler, "
                         "nav, epoch table; SPEC_MS refresh) instead of "
                         "the one-line progress counter")
    ap.add_argument("--watch-html", metavar="PATH", default=None,
                    help="graphical live view: rewrite a self-refreshing "
                         "HTML page (channel table + spectrum, acq "
                         "surface, correlator-shape SVGs) at the SPEC_MS "
                         "cadence — open it in any browser (the gnuplot-"
                         "window equivalent, src/sdrplot.c:336-394); "
                         "implies --spec")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="capture a JAX profiler trace of the run")
    ap.add_argument("--checkpoint", metavar="PATH", default=None,
                    help="save a resumable receiver snapshot at the end")
    ap.add_argument("--resume", metavar="PATH", default=None,
                    help="load a snapshot saved with --checkpoint")
    args = ap.parse_args(argv)

    cfg = load_ini(args.config)
    if args.spp:
        cfg.spp = True
    if args.watch_html:
        # the acq/correlator/spectrum views only populate with the
        # diagnostics monitor on
        cfg.spec = True
    if not cfg.fends:
        print("error: config has no front end ([FEND] missing?)",
              file=sys.stderr)
        return 1
    if args.ftype and not (1 <= args.ftype <= len(cfg.fends)):
        print(f"error: --ftype {args.ftype} but config defines "
              f"{len(cfg.fends)} front-end path(s)", file=sys.stderr)
        return 1
    ch_ftypes = sorted({c.ftype for c in cfg.channels
                        if len(cfg.fends) >= c.ftype})
    dual = args.ftype == 0 and len(ch_ftypes) >= 2
    use_ftypes = ch_ftypes if dual else [args.ftype or (ch_ftypes or [1])[0]]
    fes = []
    for ft in use_ftypes:
        spec_ft = cfg.fends[ft - 1]
        if spec_ft.fend in _LIVE_FENDS:
            # live capture: in-process driver binding (the reference's
            # rcvinit dispatch, src/sdrrcv.c:20-90; vendor library
            # located via GNSSLIB_*_LIB / system paths)
            try:
                fes.append(_make_live_frontend(spec_ft, fes))
            except OSError as e:
                print(f"error: live front end: {e}", file=sys.stderr)
                return 1
            continue
        path = cfg.files[ft - 1] if len(cfg.files) >= ft else ""
        if not path:
            # packed dual-path formats (STEREO) carry both RF paths in
            # FILE1's byte stream
            path = cfg.files[0] if cfg.files else ""
        if not path:
            print("error: no IF file configured (FILE1/FILE2)",
                  file=sys.stderr)
            return 1
        fes.append(FileFrontend(path, spec_ft))
    spec = fes[0].spec
    fe = fes[0]
    mesh = None
    if args.devices > 1:
        from ..parallel import make_mesh
        mesh = make_mesh(args.devices)
    rx = build_receiver(cfg, dict(zip(use_ftypes, fes)),
                        nsteps_per_block=args.nsteps, mesh=mesh)
    if args.resume:
        rx.load_checkpoint(args.resume)

    if args.spec or cfg.spec:
        # reference spectrum analyzer view (src/sdrspec.c) over the first
        # second of IF data
        from ..constants import DType
        from ..diag import sample_histogram, welch_spectrum
        from ..diag.plots import plot_histogram, plot_spectrum
        import numpy as np
        x = fe.read(0, min(int(spec.f_sf), fe.nsamples))
        outdir = cfg.rinexpath
        import os as _os
        _os.makedirs(outdir, exist_ok=True)
        iq = x.ndim == 2
        freq, pdb = welch_spectrum(x, spec.f_sf, iq=iq)
        # bin width by front-end quantization: 8-bit formats get the full
        # byte range, 2/3-bit LUT formats the reference's 3-bit view
        from ..constants import FrontendType as _FT
        nbit = 8 if spec.fend in (_FT.FILE, _FT.RTLSDR, _FT.FRTLSDR,
                                  _FT.BLADERF, _FT.FBLADERF) else 3
        edges, counts = sample_histogram(x, nbit=nbit)
        np.savez(_os.path.join(outdir, "spectrum.npz"),
                 freq=freq, pdb=pdb, edges=edges, counts=counts)
        p1 = plot_spectrum(freq, pdb, _os.path.join(outdir, "spectrum.png"))
        p2 = plot_histogram(edges, counts,
                            _os.path.join(outdir, "histogram.png"))
        if not args.quiet:
            print(f"spectrum diagnostics: {outdir}/spectrum.npz"
                  + (f", {p1}, {p2}" if p1 else " (matplotlib absent)"))
        # live view during the run (reference specthread cadence,
        # src/sdrspec.c:29-110): the receiver's SpectrumMonitor refreshes
        # *_live.png in place — a file-based stand-in for the gnuplot
        # window; throttled to every 5th frame (~1 s of stream)
        mons = [r.spec_monitor for r in getattr(rx, "rx", [rx])
                if getattr(r, "spec_monitor", None) is not None]
        parts = getattr(rx, "rx", [rx])
        if mons and p1:
            from ..diag.plots import plot_acq_surface, plot_correlator
            nseen = [0]

            def _live_view(frame, _outdir=outdir):
                nseen[0] += 1
                if nseen[0] % 5:
                    return
                plot_spectrum(frame.freq_hz, frame.pspec_db,
                              _os.path.join(_outdir, "spectrum_live.png"))
                plot_histogram(frame.hist_edges, frame.hist_counts,
                               _os.path.join(_outdir, "histogram_live.png"))
                # correlator tap shapes (reference plttrk cadence,
                # src/sdrmain.c:293-299)
                for r in parts:
                    for prn, cv in r.corr_views.items():
                        plot_correlator(
                            cv["offsets"], cv["mag"],
                            _os.path.join(_outdir, f"corr_{prn:02d}.png"),
                            title=f"PRN {prn} taps @ {cv['t']:.1f}s")
            mons[0].on_frame = _live_view

            def _acq_view(ch, view, _outdir=outdir):
                # acquisition surface at lock (reference pltacq,
                # src/sdrmain.c:258-261)
                plot_acq_surface(
                    view["surface"], view["dopp_hz"],
                    _os.path.join(_outdir, f"acq_{ch.cfg.prn:02d}.png"),
                    title=(f"PRN {ch.cfg.prn} acq @ {view['t']:.1f}s "
                           f"C/N0 {view['cn0']:.1f} dB-Hz"),
                    scale=view.get("grid_scale", 1.0),
                    codei=view.get("codei"))
            for r in parts:
                r.on_acq = _acq_view
    live = any(getattr(f, "is_live", False) for f in fes)
    if not args.quiet:
        src = ("live capture" if live else
               f"{fe.nsamples/spec.f_sf:.1f} s of IF data")
        print(f"erlang-gnss-tpu: {len(rx.channels)} channels, "
              f"f_sf={spec.f_sf/1e6:.3f} MHz, f_if={spec.f_if/1e6:.3f} MHz, "
              f"{src}")

    watch = None
    if args.watch:
        # operator live view (reference gnuplot windows,
        # src/sdrplot.c:336-394 / sdrmain.c:258-299; see diag/watch.py)
        from ..diag.watch import Watch
        watch = Watch(rx)
    htmlview = None
    if args.watch_html:
        from ..diag.htmlview import HtmlView
        htmlview = HtmlView(rx, args.watch_html)
        if not args.quiet:
            print(f"live view: file://{os.path.abspath(args.watch_html)}")

    def progress(t):
        if htmlview is not None:
            htmlview.tick(t)
        if watch is not None:
            watch.tick(t)
        elif not args.quiet:
            locked = sum(ch.locked for ch in rx.channels)
            dec = sum(ch.nav.flagdec for ch in rx.channels)
            print(f"\r  t={t:7.1f}s locked={locked} decoded={dec} "
                  f"epochs={rx.epochs_written}", end="", flush=True)

    _install_stop_handlers(rx, args.quiet)
    runner = rx.run_live if live else rx.run_seconds
    if args.profile:
        import jax
        with jax.profiler.trace(args.profile):
            stats = runner(args.seconds, progress=progress)
    else:
        stats = runner(args.seconds, progress=progress)
    if args.checkpoint:
        rx.save_checkpoint(args.checkpoint)
    if not args.quiet:
        print()
        for ev in rx.events:
            print("  event:", ev)
        print(f"done: {stats['seconds']:.1f} s in {stats['wall']:.1f} s "
              f"({stats['msps']:.2f} Msamples/s); locked PRNs "
              f"{stats['locked']}, decoded {stats['decoded']}, "
              f"{stats['epochs']} obs epochs, {stats['ephs']} eph records")
        if rx.obs_writer:
            print(f"rinex obs: {rx.obs_writer.path}")
            print(f"rinex nav: {rx.nav_writer.path}")
        hub = getattr(rx, "hub", None)
        if hub is not None and hub.positions:
            import math
            from ..obs.spp import ecef2llh
            wk, tow, pos, clk, nsat = hub.positions[-1]
            lat, lon, h = ecef2llh(pos)
            print(f"spp: {len(hub.positions)} fixes; last "
                  f"tow={tow:.1f} lat={math.degrees(lat):.7f} "
                  f"lon={math.degrees(lon):.7f} h={h:.1f} m "
                  f"({nsat} sats)")
    if htmlview is not None:
        htmlview.close()               # final frame with the end state
    rx.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Batched FFT acquisition search.

Reference behavior (src/sdracq.c:14-95, sdrcmn.c:723-773):
* per round: mix each Doppler bin, FFT-correlate against the code spectrum,
  accumulate |corr|² non-coherently over up to ``intg`` rounds;
* accept when (global peak)/(second peak outside ±2 chips) > ACQTH;
* C/N0 = 10·log10(maxP / meanP / ctime).

Batched design: all channels and Doppler bins advance together as one
(C, F, nfft) batched pipeline (lax.map over channels bounds memory), all
rounds run under one ``lax.fori_loop``, and the acceptance test is a pair
of masked reductions.  The search accumulates the full ``intg`` rounds for
every channel (the reference early-exits per channel to save CPU; on the
accelerator the batch is one program and extra rounds only sharpen the statistics).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import codes
from ..constants import (ACQHBAND, ACQINTG_L1CA, ACQSTEP, ACQTH, CodeType,
                         DType)
from ..ops import fftcorr, stats
from ..ops.nco import frac


@dataclasses.dataclass
class AcqResult:
    """Per-channel acquisition outcome (arrays of shape (C,))."""
    acquired: np.ndarray   # bool
    codei: np.ndarray      # code-phase sample offset in [0, nsamp)
    freqi: np.ndarray      # Doppler bin index
    acqfreq: np.ndarray    # acquired absolute carrier frequency (Hz)
    dcarr: np.ndarray      # acqfreq - (f_if + foffset)  (Hz)
    cn0: np.ndarray        # C/N0 estimate (dB-Hz)
    peakr: np.ndarray      # first/second peak ratio
    confirmed: np.ndarray = None  # even/odd-round peak agreement (bool)
    P: object = None       # (C, F, nsamp_d) power surface DEVICE handle
                           # on the SEARCH grid: full-rate samples when
                           # coarse is off, else decimated cells of
                           # ``scale`` samples each — consumers aligning
                           # ``codei`` (always full-rate) to the surface
                           # must divide by ``scale`` (search_dev(
                           # diag=True); fetched per channel — the
                           # reference's pltacq view, sdrmain.c:258)


class Acquirer:
    """Precompiled acquisition program for a group of channels sharing one
    front end (same f_sf / f_if / dtype / nsamp).

    Parameters mirror initsdrch/initacqstruct (reference sdrinit.c:385-394,
    623-653): per-channel PRN code spectra are precomputed, the Doppler
    grid is f_if + foffset + k·step for k in [-hband/step, hband/step].
    """

    def __init__(self, prns, ctypes, f_sf: float, f_if: float, dtype: int,
                 foffsets=None, hband: float = ACQHBAND,
                 step: float = ACQSTEP, intg: int = ACQINTG_L1CA,
                 thresh: float = ACQTH, confirm: bool = False,
                 decim: int | None = None):
        prns = list(prns)
        C = len(prns)
        ctypes = list(ctypes) if not np.isscalar(ctypes) else [ctypes] * C
        foffsets = np.zeros(C) if foffsets is None else np.asarray(foffsets,
                                                                   np.float64)
        self.C = C
        self.f_sf = f_sf
        self.f_if = f_if
        self.dtype = dtype
        self.ti = 1.0 / f_sf
        self.intg = int(intg)
        self.thresh = float(thresh)
        # false-lock guard (absent in the reference, which accepts the
        # first peak-ratio pass, src/sdracq.c:89-94): when True, a channel
        # is acquired only if the even- and odd-round non-coherent halves
        # independently place the peak at the same code phase (±2 chips)
        # and within one Doppler bin — a noise peak is a different cell in
        # each half, a true peak persists.
        self.confirm = bool(confirm)
        self.nfreq = int(2 * (hband / step) + 1)
        self.step = step

        # all supported L1 codes are 1 ms periods; nsamp from the first
        code0, crate0 = codes.gencode(prns[0], ctypes[0])
        ctime = len(code0) / crate0
        self.ctime = ctime
        self.nsamp = int(round(f_sf * ctime))

        # coarse/fine search (no reference analogue — sdracq.c always runs
        # the FFT grid at the full sample rate with a 2-period zero-padded
        # linear correlation): the coarse stage rebins each 1 ms code
        # period onto a power-of-two grid of >= 4 cells/chip (cumulative-
        # sum integrate-and-dump; boxcar is the chip-matched lowpass) and
        # CIRCULARLY correlates one period of data against one period of
        # replica — exact for a periodic ranging code up to the carrier-
        # phase seam at the wrap (residual <= step/2 over 1 ms = 0.1
        # cycle worst-bin -> <= 0.9 dB worst, ~0.2 dB mean; nav-bit edges
        # sit on period boundaries, so the wrap bit-flip term is the same
        # 1-in-20-round event the reference's linear window already has).
        # The winning cell is then refined to full-rate code phase by a
        # direct correlation over the cell's +-scale full-rate lags at the
        # peak Doppler bin.  FFTs shrink from next_pow2(2*nsamp) to
        # ~nsamp/4 and the Doppler mix runs on the short grid: ~8x less
        # device work at the 16.368 Msps envelope.
        # decim=None auto-selects; decim=1 forces the exact full-rate
        # path; decim=R requests a ~R-fold grid reduction.
        clens = [len(codes.gencode(p, c)[0]) for p, c in zip(prns, ctypes)]
        if decim is None:
            ngrid = fftcorr.next_pow2(4 * max(clens))
        elif int(decim) == 1:
            ngrid = self.nsamp
        else:
            ngrid = fftcorr.next_pow2(max(1, self.nsamp // int(decim)))
        self.coarse = ngrid < self.nsamp
        self.nsamp_d = ngrid if self.coarse else self.nsamp
        # full-rate samples per coarse grid cell (1.0 on the exact path)
        self.scale = self.nsamp / self.nsamp_d
        self.decim = int(round(self.scale))
        # cover an adjacent-bin coarse argmax: near-threshold noise (or
        # the half-bin skew between the point-sampled decimated replica
        # and the boxcar-integrated data) can land the coarse peak one
        # grid cell off, putting the true full-rate peak up to ~1.5*scale
        # samples from the cell center
        self.refine_rad = int(np.ceil(1.5 * self.scale)) + 1
        self.nfft = (self.nsamp_d if self.coarse
                     else fftcorr.next_pow2(2 * self.nsamp))

        # per-channel code spectra on the SEARCH grid (C, nfft) complex64
        # (shipped to device as stacked re/im float32 planes)
        codex = np.empty((C, self.nfft), np.complex64)
        code_fr = np.empty((C, self.nsamp), np.float32)
        nsampchip = np.empty(C, np.int32)
        nsampchip_fr = np.empty(C, np.int32)
        for i, (prn, ct) in enumerate(zip(prns, ctypes)):
            code, crate = codes.gencode(prn, ct)
            clen = len(code)
            nsampchip[i] = max(1, int(self.nsamp_d / clen))
            nsampchip_fr[i] = int(self.nsamp / clen)
            idx = np.mod(np.floor(np.arange(self.nsamp_d, dtype=np.float64)
                                  * self.scale * crate / f_sf)
                         .astype(np.int64), clen)
            rc = np.zeros(self.nfft, np.float32)
            rc[:self.nsamp_d] = code[idx]
            codex[i] = np.conj(np.fft.fft(rc)).astype(np.complex64)
            idx_fr = np.mod(np.floor(np.arange(self.nsamp, dtype=np.float64)
                                     * crate / f_sf).astype(np.int64), clen)
            code_fr[i] = code[idx_fr]
        self.nsampchip_fr = nsampchip_fr

        # carrier base phase per channel: frac((f_if+foffset)*ti*i), f64->f32
        nwin = 2 * self.nsamp
        i64 = np.arange(nwin, dtype=np.float64)
        base = np.mod((f_if + foffsets)[:, None] * self.ti * i64[None, :], 1.0)
        # Doppler residual grid in cycles/sample (shared across channels)
        k = np.arange(self.nfreq, dtype=np.float64) - (self.nfreq - 1) / 2
        self.dopp_hz = k * step
        self.freqs_abs = (f_if + foffsets[:, None] + self.dopp_hz[None, :])
        # device buffers travel as jit ARGUMENTS (closure arrays would be
        # embedded as HLO constants — slow to compile)
        self._consts = dict(
            codex_ri=jnp.asarray(np.stack([codex.real, codex.imag], axis=1)
                                 .astype(np.float32)),
            nsampchip=jnp.asarray(nsampchip),
            base_phase=jnp.asarray(base.astype(np.float32)),
            d_cps=jnp.asarray((k * step * self.ti).astype(np.float32)),
        )
        if self.coarse:
            self._consts["code_fr"] = jnp.asarray(code_fr)
            # last full-rate sample index of each grid bin (bin m sums
            # samples [edges[m-1]+1, edges[m]] of the cumulative sum)
            edges = np.round(np.arange(1, self.nsamp_d + 1, dtype=np.float64)
                             * self.scale).astype(np.int32) - 1
            edges[-1] = self.nsamp - 1
            self._consts["edges"] = jnp.asarray(edges)
        # const keys carrying a leading channel axis (the sharded wrapper
        # pads + shards exactly these)
        self.ch_const_keys = [k for k in self._consts
                              if k not in ("d_cps", "edges")]
        self._search = jax.jit(self._search_impl)
        self._search_flat = jax.jit(self._search_flat_impl)

    # -- device program ------------------------------------------------------
    def _mix_one_channel(self, data, base_phase_c, d_cps):
        """(F, nfft) carrier-wiped zero-padded data for one channel.

        ``data``: (2*nsamp,) float32 real samples or (2*nsamp, 2) float32
        stacked I/Q (complex is built in-program)."""
        nwin = 2 * self.nsamp
        i = jnp.arange(nwin, dtype=jnp.float32)
        ph = base_phase_c[None, :] + frac(d_cps[:, None] * i)
        rot = jnp.exp((2j * jnp.pi) * ph.astype(jnp.complex64))
        if data.ndim == 2:
            d = jax.lax.complex(data[:nwin, 0], data[:nwin, 1])
        else:
            d = data[:nwin].astype(jnp.complex64)
        mixed = d[None, :] * rot
        return jnp.pad(mixed, ((0, 0), (0, self.nfft - nwin)))

    def _to_complex(self, data):
        """(n[, 2]) float32 -> (n,) complex64 in-program."""
        if data.ndim == 2:
            return jax.lax.complex(data[..., 0], data[..., 1])
        return data.astype(jnp.complex64)

    def _power_impl(self, data_rounds, consts):
        """FFT power stage: (intg, 2*nsamp[, 2]) windows -> even/odd
        accumulated power Ph (C, 2, F, nsamp_d).  F follows consts
        ["d_cps"], so a Doppler-sharded caller (parallel/sharded.py
        ShardedAcquirer freq mode) can run this per grid slice and feed
        the combined surface to :meth:`_decide_impl`."""
        d_cps = consts["d_cps"]
        ng = self.nsamp_d

        def one_channel(args):
            # all (rounds x Doppler) FFTs of one channel in ONE batch: a
            # round-by-round fori_loop serializes intg small FFT batches
            # (measured 0.5 s per 32-ch search at the 16.368 Msps
            # envelope; batched: one (intg*F, nfft) dispatch per channel)
            codex_ri, base_c = args[0], args[1]
            codex_c = jax.lax.complex(codex_ri[0], codex_ri[1])
            if not self.coarse:
                mixed = jax.vmap(
                    lambda d: self._mix_one_channel(d, base_c, d_cps)
                )(data_rounds)                      # (rounds, F, nfft)
            else:
                # coarse stage: wipe the per-channel center frequency at
                # full rate (exact IF/FDMA), rebin one code period onto
                # the ng-point grid by cumulative-sum integrate-and-dump
                # (residual-Doppler droop over a bin <= 2e-3 cycles),
                # then mix the +-hband residual grid on the short stream.
                # nfft == ng: the correlation below wraps circularly,
                # which is exact for the periodic code (docstring above).
                rot = jnp.exp((2j * jnp.pi)
                              * base_c[:self.nsamp].astype(jnp.complex64))
                dc = jax.vmap(
                    lambda d: self._to_complex(d[:self.nsamp]) * rot
                )(data_rounds)                      # (rounds, nsamp)
                cs = jnp.cumsum(dc, axis=-1)
                at = cs[:, consts["edges"]]         # (rounds, ng)
                dd = jnp.diff(at, axis=-1,
                              prepend=jnp.zeros((at.shape[0], 1), at.dtype))
                i_d = jnp.arange(ng, dtype=jnp.float32)
                ph = frac((d_cps * self.scale)[:, None] * i_d[None, :])
                rotd = jnp.exp((2j * jnp.pi) * ph.astype(jnp.complex64))
                mixed = dd[:, None, :] * rotd[None, :, :]
            p = fftcorr.fft_correlate_power(mixed, codex_c, self.nsamp_d)
            # even/odd-round split accumulators (the sum is the reference
            # statistic; the halves feed the false-lock confirmation)
            return jnp.stack([p[0::2].sum(axis=0), p[1::2].sum(axis=0)])
        Ph = jax.lax.map(one_channel, tuple(
            consts[k] for k in ("codex_ri", "base_phase")))
        # barrier: stops XLA from fusing the reduction stage into the
        # FFT loop — without it the CPU backend's optimizer blows up
        # (minutes-long compiles)
        return jax.lax.optimization_barrier(Ph)

    def _decide_impl(self, data_rounds, consts, Ph):
        """Acceptance stage: Ph (C, 2, F, nsamp_d) -> decision vectors.
        Runs in the same program as the power stage (one compile; only
        the tiny decision vectors leave the device)."""
        P = Ph[:, 0] + Ph[:, 1]
        codei, freqi, cn0, peakr = self.check_impl(P, consts["nsampchip"])
        if self.coarse:
            codei = self._refine_impl(data_rounds, consts, codei, freqi)
        return ((P, codei, freqi, cn0, peakr)
                + (self.confirm_impl(Ph, consts["nsampchip"]),))

    def _search_impl(self, data_rounds, consts):
        """data_rounds: (intg, 2*nsamp[, 2]) float32 windows.

        Returns P (C, F, nsamp_d) non-coherently integrated power on the
        search grid (= full rate when coarse is off) plus the decision
        vectors.
        """
        return self._decide_impl(data_rounds, consts,
                                 self._power_impl(data_rounds, consts))

    def _refine_impl(self, data_rounds, consts, codei_d, freqi):
        """Fine stage: full-rate code phase at the winning Doppler bin.

        For each channel, correlate the full-rate rounds against the
        full-rate replica at the 2*refine_rad+1 lags around the coarse
        cell's full-rate center (mod nsamp — code periodicity keeps every
        read inside the round's own 2*nsamp window) and return the argmax
        lag: the exact-cell answer the undecimated search would have
        produced, at the cost of one small einsum instead of a full-rate
        FFT grid."""
        rad = self.refine_rad
        nlag = 2 * rad + 1
        d_cps = consts["d_cps"]
        nsamp = self.nsamp
        nb = nsamp + 2 * rad

        def one(args):
            base_c, code_c, ci_d, fi = args
            cf = jnp.round(ci_d.astype(jnp.float32)
                           * np.float32(self.scale)).astype(jnp.int32)
            s = (cf - rad) % nsamp
            j = jnp.arange(2 * nsamp, dtype=jnp.float32)
            ph = base_c + frac(d_cps[fi] * j)
            rot = jnp.exp((2j * jnp.pi) * ph.astype(jnp.complex64))
            y = jax.vmap(lambda d: self._to_complex(d) * rot)(data_rounds)
            # one contiguous slice covering every lag window (tail wrapped
            # circularly: sample 2*nsamp+t is code-periodic-equivalent to
            # sample t up to carrier phase — the wrapped tail is mixed
            # with the phase computed for index t, not 2*nsamp+t, and a
            # nav-bit flip between the reused and replaced samples flips
            # only the tail, so |z| on wrapped windows is perturbed by
            # ~2*rad/nsamp in amplitude — negligible for argmax), then ONE
            # (rounds, nb) x (nb, nlag) matmul against the static
            # shifted-code matrix: lag o's column is code delayed o
            # samples.  Replaces a (rounds, nlag, nsamp) advanced-index
            # gather (~22 MB/channel materialized + read) with ~4 MB.
            ybig = jnp.concatenate([y, y[:, :2 * rad]], axis=1)
            base = jax.lax.dynamic_slice(ybig, (0, s),
                                         (ybig.shape[0], nb))
            cmat = jnp.stack(
                [jnp.pad(code_c, (o, 2 * rad - o)) for o in range(nlag)],
                axis=1)                                  # (nb, nlag)
            # full float32: the GPU would otherwise round ``base`` to TF32
            hi = jax.lax.Precision.HIGHEST
            zr = jnp.matmul(jnp.real(base), cmat, precision=hi)
            zi = jnp.matmul(jnp.imag(base), cmat, precision=hi)
            pw = jnp.sum(zr * zr + zi * zi, axis=0)      # (nlag,)
            return (s + jnp.argmax(pw).astype(jnp.int32)) % nsamp
        return jax.lax.map(one, (consts["base_phase"], consts["code_fr"],
                                 codei_d, freqi))

    def confirm_impl(self, Ph, nsampchip):
        """Even/odd-half peak agreement: (C, 2, F, n) -> (C,) bool."""
        C, _, F, n = Ph.shape
        if self.intg < 2:
            return jnp.ones((C,), bool)

        def peak(P):
            maxi = jnp.argmax(P.reshape(C, F * n), axis=-1)
            return maxi % n, maxi // n
        ce, fe = peak(Ph[:, 0])
        co, fo = peak(Ph[:, 1])
        d = jnp.abs(ce - co)
        d = jnp.minimum(d, n - d)
        return (d <= 2 * nsampchip) & (jnp.abs(fe - fo) <= 1)

    def check_impl(self, P, nsampchip):
        """Vectorized checkacquisition (reference src/sdracq.c:71-95)."""
        C, F, n = P.shape
        flat = P.reshape(C, F * n)
        maxi = jnp.argmax(flat, axis=-1)
        maxP = jnp.take_along_axis(flat, maxi[:, None], axis=-1)[:, 0]
        codei = (maxi % n).astype(jnp.int32)
        freqi = (maxi // n).astype(jnp.int32)
        row = jnp.take_along_axis(
            P, freqi[:, None, None], axis=1)[:, 0, :]      # (C, n)
        lo = jnp.mod(codei - 2 * nsampchip, n)
        hi = jnp.mod(codei + 2 * nsampchip, n)
        mask = jax.vmap(lambda l, h: stats.exclusion_mask(n, l, h))(lo, hi)
        meanP = stats.masked_mean(row, mask)
        maxP2, _ = stats.masked_max(row, mask)
        cn0 = 10.0 * jnp.log10(maxP / meanP / self.ctime)
        peakr = maxP / maxP2
        return codei, freqi, cn0, peakr

    @functools.partial(jax.jit, static_argnums=0)
    def check(self, P, nsampchip):
        return self.check_impl(P, nsampchip)

    def _search_flat_impl(self, data_flat, consts, idx=None):
        """Like _search_impl, but takes a FLAT (n[, 2]) sample array and
        stacks the (intg, 2*nsamp) round windows in-program — so a block
        already resident on device (io/devcache.py) feeds acquisition with
        no host read or re-upload (the reference re-reads the ring per
        round, src/sdracq.c:29-33).

        ``idx``: optional (P,) channel-subset indices — the per-channel
        consts are gathered so the FFT grid runs only for those channels
        (the reference's per-channel threads likewise never re-search a
        locked channel, src/sdrmain.c:247-316; the batched program should
        not either).  Cost scales with P instead of C."""
        if idx is not None:
            consts = {k: (consts[k][idx] if k in self.ch_const_keys
                          else consts[k]) for k in consts}
        nwin = 2 * self.nsamp
        rounds = jnp.stack([
            jax.lax.dynamic_slice_in_dim(data_flat, r * self.nsamp, nwin,
                                         axis=0)
            for r in range(self.intg)])
        return self._search_impl(rounds, consts)

    def search_dev(self, block, diag: bool = False) -> AcqResult:
        """Acquisition over a device-resident float32 block (first
        (intg+1)*nsamp samples used); host sees only the decision
        vectors.  With ``diag`` the (C, F, nsamp) power surface handle is
        attached (stays on device until a channel's view is fetched)."""
        return self.search_dev_collect(self.search_dev_start(block, diag))

    def search_dev_start(self, block, diag: bool = False, idx=None):
        """Dispatch the device search WITHOUT reading the decision
        vectors: returns an opaque handle of device arrays.  The receiver
        uses this to overlap the acquisition program (and its result's
        device->host copy) with tracking blocks — the reference instead
        blocks each channel thread for the whole search
        (src/sdracq.c:14-59).

        ``idx``: optional pending-channel subset — the grid runs only for
        those channels (padded to the next power-of-two bucket >= 4 so
        the number of compiled variants is O(log C), not O(C): a
        many-channel receiver's pending count shrinks block by block as
        channels lock, and per-length recompiles measured 215 s of
        dispatch stalls in a 256-channel session); the others come back
        unacquired.  Ignored with ``diag`` (the monitor wants every
        channel's surface)."""
        if diag or idx is None or len(idx) >= self.C:
            idx = None
            handle = self._search_flat(block, self._consts)
        else:
            bucket = 4
            while bucket < len(idx):
                bucket *= 2
            if bucket >= self.C:
                idx = None
                handle = self._search_flat(block, self._consts)
            else:
                idx = np.asarray(idx, np.int32)
                pad = bucket - len(idx)
                idxp = np.concatenate([idx, np.repeat(idx[:1], pad)])
                handle = self._search_flat(block, self._consts,
                                           jnp.asarray(idxp))
        P, codei, freqi, cn0, peakr, confirmed = handle
        for a in (codei, freqi, cn0, peakr, confirmed):
            # overlap the decision vectors' device->host copy with the
            # tracking blocks dispatched behind the search
            try:
                a.copy_to_host_async()
            except (AttributeError, NotImplementedError):  # pragma: no cover
                pass
        return (P if diag else None, codei, freqi, cn0, peakr, confirmed,
                idx)

    def search_dev_collect(self, handle) -> AcqResult:
        """Fetch a search_dev_start handle's decision vectors -> AcqResult
        (blocks only until the acquisition program itself finished)."""
        import jax
        P, codei, freqi, cn0, peakr, confirmed, idx = handle
        codei, freqi, cn0, peakr, confirmed = jax.device_get(
            (codei, freqi, cn0, peakr, confirmed))
        if idx is not None:
            n = len(idx)
            full = [np.zeros(self.C, a.dtype) for a in
                    (codei, freqi, cn0, peakr, confirmed)]
            for f, a in zip(full, (codei, freqi, cn0, peakr, confirmed)):
                f[idx] = a[:n]           # peakr 0 elsewhere -> unacquired
            codei, freqi, cn0, peakr, confirmed = full
        res = self.postprocess(codei, freqi, cn0, peakr, confirmed)
        if P is not None:
            res.P = P
        return res

    # -- host API --------------------------------------------------------------
    def stack_rounds(self, data: np.ndarray) -> np.ndarray:
        """(n[, 2]) samples -> (intg, 2*nsamp[, 2]) overlapping windows
        (complex input converted to stacked I/Q host-side)."""
        data = np.asarray(data)
        if np.iscomplexobj(data):
            data = np.stack([data.real, data.imag], axis=-1)
        data = data.astype(np.float32)
        nwin = 2 * self.nsamp
        return np.stack([data[r * self.nsamp: r * self.nsamp + nwin]
                         for r in range(self.intg)])

    def postprocess(self, codei, freqi, cn0, peakr, confirmed) -> AcqResult:
        """Device decision vectors -> AcqResult (shared with the sharded
        wrapper so acceptance rules live in exactly one place)."""
        codei = np.asarray(codei)
        freqi = np.asarray(freqi)
        cn0 = np.asarray(cn0)
        peakr = np.asarray(peakr)
        confirmed = np.asarray(confirmed)
        acqfreq = self.freqs_abs[np.arange(self.C), freqi]
        dcarr = self.dopp_hz[freqi]
        acquired = peakr > self.thresh
        if self.confirm:
            acquired = acquired & confirmed
        return AcqResult(acquired=acquired, codei=codei,
                         freqi=freqi, acqfreq=acqfreq, dcarr=dcarr,
                         cn0=cn0, peakr=peakr, confirmed=confirmed)

    def search(self, data: np.ndarray) -> AcqResult:
        """Run a full acquisition over (intg+1) ms of samples.

        ``data``: (n,) float32 real, (n, 2) float32 stacked I/Q, or (n,)
        complex (converted host-side) with at least (intg+1)*nsamp samples,
        starting at the abs sample index the caller tracks (the reference
        reads the latest (intg+1) ms, src/sdracq.c:25).
        """
        P, codei, freqi, cn0, peakr, confirmed = self._search(
            jnp.asarray(self.stack_rounds(data)), self._consts)
        return self.postprocess(codei, freqi, cn0, peakr, confirmed)

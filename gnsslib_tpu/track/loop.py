"""The tracking scan: batched per-code-period correlation + DLL/PLL/FLL.

Faithful re-expression of the reference per-channel thread loop
(sdrmain.c:264-313, sdrtrk.c) as one ``lax.scan`` over code periods with
every channel advanced per step via ``vmap``:

* variable per-period block length (sdrtrk.c:31-33) -> fixed window +
  sample mask + rounded period length (ops.nco.period_samples);
* correlator (sdrcmn.c:687-722) -> batched einsum taps (ops.correlator);
* the reference stores the cos-mixed channel in trk.QQ and the sin-mixed
  channel in trk.II (argument swap at sdrtrk.c:40-43), so here
  IP = corr.imag, QP = corr.real;
* cumsumcorr/clearcumsumcorr (sdrtrk.c:64-86) -> sum/oldsum carries;
* pll/dll (sdrtrk.c:94-150) -> identical discriminators and 2nd-order
  NCO updates, gated per channel (pre bit-sync: every period with prm1;
  after: every ``loop`` periods aligned to the host-detected bit phase,
  with prm2) — the reference's swloop cadence (sdrnav.c:241-282).

Host <-> device contract: the host feeds sample blocks and harvests
per-period outputs (prompt I/Q for nav-bit decoding, loop telemetry for
observables/logs); it never touches the feedback path.
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np

from .. import codes
from ..constants import PI, CodeType, DType
from ..ops import correlator as corr_ops
from ..ops.nco import NSPAN, frac
from .state import TrackConfig, TrackState, loop_interval


@dataclasses.dataclass
class TrackOutputs:
    """Per-period telemetry, host-side numpy arrays shaped (steps, C, ...)."""
    ip: np.ndarray          # prompt I (the data channel)
    qp: np.ndarray          # prompt Q
    sum_i: np.ndarray       # (steps, C, ntaps) accumulated taps (at update)
    sum_q: np.ndarray
    loc: np.ndarray         # (steps, C) int32 period-start offset in block
    n: np.ndarray           # (steps, C) int32 period length (samples)
    remcode: np.ndarray     # (steps, C) f32 chips at period start
    remcarr: np.ndarray     # (steps, C) f32 cycles at period start
    dcarr: np.ndarray       # (steps, C) f32 Hz (carrfreq - f_if - foffset)
    dcode: np.ndarray       # (steps, C) f32 Hz (codefreq - crate)
    carr_err: np.ndarray    # (steps, C)
    code_err: np.ndarray
    carr_nco: np.ndarray
    code_nco: np.ndarray
    flagloopfilter: np.ndarray  # (steps, C) int32: 0 none, 1 prm1, 2 prm2


class Tracker:
    """Compiled tracking program for a group of channels sharing a front end
    (same f_sf / f_if / dtype; code family may differ per channel)."""

    def __init__(self, cfg: TrackConfig, prns, ctypes, f_sf: float,
                 f_if: float, dtype: int, foffsets=None, f_cfs=None):
        prns = list(prns)
        C = len(prns)
        ctypes = [int(c) for c in (ctypes if not np.isscalar(ctypes)
                                   else [ctypes] * C)]
        foffsets = np.zeros(C) if foffsets is None else np.asarray(
            foffsets, np.float64)
        if f_cfs is None:
            f_cfs = np.full(C, 1.57542e9)
        f_cfs = np.asarray(f_cfs, np.float64)

        self.cfg = cfg
        self.C = C
        self.f_sf = f_sf
        self.f_if = f_if
        self.dtype = int(dtype)
        self.ti = 1.0 / f_sf

        # per-channel code constants
        codes_list, crates, clens = [], [], []
        for prn, ct in zip(prns, ctypes):
            code, crate = codes.gencode(prn, ct)
            codes_list.append(code)
            crates.append(crate)
            clens.append(len(code))
        clen_max = max(clens)
        code_mat = np.zeros((C, clen_max), np.int8)
        for i, c in enumerate(codes_list):
            code_mat[i, :len(c)] = c
        self.crate = np.asarray(crates, np.float64)
        self._ctypes = ctypes
        self._clens = clens
        self.ctime = np.asarray(clens, np.float64) / self.crate
        nsamp = np.round(f_sf * self.ctime).astype(np.int64)
        assert np.all(nsamp == nsamp[0]), \
            "channels in one tracker group must share the 1 ms period"
        self.n_nom = int(nsamp[0])
        self.nwin = self.n_nom + 2 * NSPAN + 4
        self.smax = cfg.smax
        self.next = self.nwin + 2 * self.smax
        self.offsets = corr_ops.tap_offsets(cfg.corrn, cfg.corrd)

        # exact base tables, per channel where they differ.  All device
        # buffers live in one pytree passed as a jit ARGUMENT (never closed
        # over: closure arrays become embedded HLO constants, which bloats
        # every compile).
        i64 = np.arange(self.next, dtype=np.float64)
        ci0 = self.crate * self.ti                       # (C,)
        chips = ci0[:, None] * i64[None, :]
        ks = self.n_nom + np.arange(-NSPAN, NSPAN + 1, dtype=np.float64)
        f_base = f_if + foffsets                          # (C,)
        self._f_base = f_base
        ph = np.mod(f_base[:, None] * self.ti * i64[None, :self.nwin], 1.0)
        self.aid = (self.crate / f_cfs).astype(np.float32)
        self._consts = dict(
            loop=jnp.asarray(
                np.asarray([loop_interval(ct) for ct in ctypes], np.int32)),
            ci0=jnp.asarray(ci0.astype(np.float32)),
            code_adv=jnp.asarray(
                (ci0[:, None] * ks[None, :]
                 - np.asarray(clens, np.float64)[:, None]).astype(np.float32)),
            base_phase=jnp.asarray(ph.astype(np.float32)),
            carr_adv=jnp.asarray(
                np.mod(f_base[:, None] * self.ti * ks[None, :], 1.0)
                .astype(np.float32)),
            aid=jnp.asarray(self.aid),                    # (C,)
            dt1=jnp.asarray(self.ctime.astype(np.float32)),
            dt2=jnp.asarray((self.ctime *
                             np.asarray([loop_interval(ct) for ct in ctypes]))
                            .astype(np.float32)),
        )
        if cfg.resample == "exact":
            self._consts.update(
                codes=jnp.asarray(code_mat),
                clen=jnp.asarray(np.asarray(clens, np.int32)),
                chip_int=jnp.asarray(np.floor(chips).astype(np.int32)),
                chip_frac=jnp.asarray((chips - np.floor(chips))
                                      .astype(np.float32)),
            )
        else:
            # quantized-phase replica table (see _channel_step): rows are
            # resampled codes at the MIDPOINT phases f_q = (q+.5)*ci0/Q,
            # paired with FLOOR quantization of the phase (not round).
            # This is interval-preserving: when the sample grid is
            # chip-commensurate (16.368/1.023 = 16 samples/chip), all
            # chip-transition breakpoints sit exactly on the q-grid, and
            # round() could push a phase just below a chip boundary onto
            # the boundary itself — flipping the chip identity of every
            # 16th sample (~12% replica mismatch, ~20% prompt loss).
            # floor+midpoint never crosses a breakpoint and keeps the
            # quantization error zero-mean (no pseudorange bias).
            self._tbl_q = int(max(64, min(1024, 2 ** int(np.ceil(
                np.log2(512.0 * float(ci0.max())))))))
            self._tbl_m0 = int(np.ceil(2.0 / ci0.min())) + self.smax + 2
            W = self.next + self._tbl_m0 + int(np.ceil(2.0 / ci0.min())) + 4
            j = np.arange(W, dtype=np.float64) - self._tbl_m0
            tbl = np.empty((C, self._tbl_q, W), np.int8)
            for c in range(C):
                fq = ((np.arange(self._tbl_q, dtype=np.float64) + 0.5)
                      * ci0[c] / self._tbl_q)
                pos = fq[:, None] + ci0[c] * j[None, :]
                idx = np.floor(pos).astype(np.int64)
                if cfg.interp_replica:
                    # linear interpolation across chip transitions kills
                    # the nearest-neighbour S-curve bias (state.py note);
                    # int8 at x127 keeps the table byte-sized
                    f = pos - np.floor(pos)
                    v = ((1.0 - f) * code_mat[c][np.mod(idx, clens[c])]
                         + f * code_mat[c][np.mod(idx + 1, clens[c])])
                    tbl[c] = np.round(127.0 * v).astype(np.int8)
                else:
                    tbl[c] = code_mat[c][np.mod(idx, clens[c])]
            self._tbl_scale = (1.0 / 127.0) if cfg.interp_replica else 1.0
            self._consts["table"] = jnp.asarray(tbl)
            self._consts["clen"] = jnp.asarray(np.asarray(clens, np.int32))

    # ------------------------------------------------------------------ #
    def init_state(self) -> TrackState:
        return TrackState.init(self.C, self.cfg.ntaps)

    def start_channels(self, state: TrackState, idx, loc, dcarr) -> TrackState:
        """Begin tracking channels ``idx`` at block offsets ``loc`` with
        acquisition carrier offsets ``dcarr`` (Hz) — the acquisition ->
        tracking handoff (sdracq.c:51-56: remcode=0, codefreq=crate,
        carrfreq=acqfreq)."""
        idx = np.asarray(idx, np.int64)
        upd = lambda a, v: a.at[idx].set(jnp.asarray(v, a.dtype))
        return dataclasses.replace(
            state,
            loc=upd(state.loc, loc),
            dcarr_acq=upd(state.dcarr_acq, dcarr),
            remcode=upd(state.remcode, 0.0),
            remcarr=upd(state.remcarr, 0.0),
            carr_nco=upd(state.carr_nco, 0.0),
            code_nco=upd(state.code_nco, 0.0),
            cnt=upd(state.cnt, 0),
            active=state.active.at[idx].set(True),
        )

    def set_bit_sync(self, state: TrackState, ch: int, sync_offset: int
                     ) -> TrackState:
        """Host reports nav bit sync for one channel: switch to prm2 cadence
        with loop updates at cnt ≡ sync_offset (mod loop)."""
        new = dataclasses.replace(
            state,
            flagsync=state.flagsync.at[ch].set(True),
            sync_offset=state.sync_offset.at[ch].set(int(sync_offset)),
        )
        if self.cfg.reset_nco_on_sync:
            # drop prm1 jitter: code rate restarts at the carrier-aided
            # value (code_nco=0 -> codefreq = crate + dcarr*aid)
            new = dataclasses.replace(
                new, code_nco=new.code_nco.at[ch].set(0.0),
                code_err=new.code_err.at[ch].set(0.0))
        return new

    # ------------------------------------------------------------------ #
    def _channel_step(self, block, cc, st):
        """One code period for one channel; ``cc``: per-channel consts
        slice, ``st``: per-channel state slice dict."""
        cfg = self.cfg
        ci = cc["ci0"] + st["dci"]
        # period length: n = round((clen - remcode)/ci) clamped (ops.nco)
        n = jnp.round((cc["clen"].astype(jnp.float32) - st["remcode"]) / ci
                      ).astype(jnp.int32)
        n = jnp.clip(n, self.n_nom - NSPAN, self.n_nom + NSPAN)

        # --- correlate ------------------------------------------------ #
        # block: (n,) f32 real samples or (n, 2) f32 stacked I/Q (complex
        # never crosses the host<->device boundary)
        win = jax.lax.dynamic_slice_in_dim(block, st["loc"], self.nwin)
        i = jnp.arange(self.nwin, dtype=jnp.float32)
        ph = frac(cc["base_phase"] + frac(st["dcps"] * i) + st["remcarr"])
        rot = jnp.exp((2j * PI) * ph.astype(jnp.complex64))
        if win.ndim == 2:
            mixed = jax.lax.complex(win[:, 0], win[:, 1]) * rot
        else:
            mixed = win.astype(jnp.complex64) * rot

        if self.cfg.resample == "exact":
            # per-sample gather resampler — bit-matches the reference's
            # rescode (src/sdrcmn.c:608-631) including the dci rate term,
            # at the cost of a per-sample gather
            ii = jnp.arange(self.next, dtype=jnp.float32)
            shift = st["remcode"] + st["dci"] * ii - ci * self.smax
            chip = cc["chip_int"] + jnp.floor(cc["chip_frac"] + shift
                                              ).astype(jnp.int32)
            rcode = jnp.take(cc["codes"], jnp.mod(chip, cc["clen"]), axis=0
                             ).astype(jnp.float32)
        else:
            # quantized-phase replica table: the code phase at the extended
            # window start decomposes into an integer-sample shift m and a
            # sub-sample fraction f in [0, ci0); the replica is then a
            # contiguous slice of a precomputed row for the nearest
            # quantized f (<= ci0/2Q chips = <1/512 chip phase error; the
            # NCO carries stay exact).  A row take and a dynamic slice
            # instead of a 17k-element per-sample gather.
            phi = st["remcode"] - cc["ci0"] * self.smax
            s = phi / cc["ci0"]
            m = jnp.floor(s)
            q_idx = jnp.floor((s - m) * self._tbl_q).astype(jnp.int32)
            m = m.astype(jnp.int32) + q_idx // self._tbl_q
            q_idx = q_idx % self._tbl_q
            # row select: a whole-row take (gather of one contiguous
            # 16 kB row); a one-hot matmul select would stream the ENTIRE
            # (Q, W) table from device memory every period
            row = jnp.take(cc["table"], q_idx, axis=0
                           ).astype(jnp.float32)
            rcode = jax.lax.dynamic_slice_in_dim(row, m + self._tbl_m0,
                                                 self.next)
        z = corr_ops.correlate_taps(mixed, rcode, self.offsets, self.smax, n)
        if self.cfg.resample == "table" and self._tbl_scale != 1.0:
            z = z * self._tbl_scale
        # reference I/Q mapping: trk.II=sin channel, trk.QQ=cos channel
        cur_i = z.imag
        cur_q = z.real

        # --- cumulative sums (sdrtrk.c:64-76; ocode polarity=+1 for
        # L1CA/G1/SBAS, sdrinit.c:519-558) ------------------------------ #
        sum_i = st["sum_i"] + cur_i
        sum_q = st["sum_q"] + cur_q
        oldsum_i = st["oldsum_i"] + st["prev_i"]
        oldsum_q = st["oldsum_q"] + st["prev_q"]

        # --- loop filter gating (sdrmain.c:271-280) --------------------- #
        cnt1 = st["cnt"] + 1
        swloop = jnp.mod(cnt1 - st["sync_offset"], cc["loop"]) == 0
        do1 = ~st["flagsync"]
        do2 = st["flagsync"] & swloop
        update = do1 | do2
        flagloop = jnp.where(do1, 1, jnp.where(do2, 2, 0)).astype(jnp.int32)
        dt = jnp.where(do1, cc["dt1"], cc["dt2"])

        def pick(a, b):
            return jnp.where(do1, a, b)
        p = cfg.prm1
        q = cfg.prm2
        pllaw = pick(p.pllaw, q.pllaw)
        pllw2 = pick(p.pllw2, q.pllw2)
        fllw = pick(p.fllw, q.fllw)
        dllaw = pick(p.dllaw, q.dllaw)
        dllw2 = pick(p.dllw2, q.dllw2)

        # PLL + FLL discriminators (sdrtrk.c:94-125)
        IP, QP = sum_i[0], sum_q[0]
        oIP, oQP = oldsum_i[0], oldsum_q[0]
        carr_err = jnp.where(
            IP > 0, jnp.arctan2(QP, IP), jnp.arctan2(-QP, -IP)) / PI
        f1 = jnp.where(IP == 0, PI / 2, jnp.arctan(QP / jnp.where(
            IP == 0, 1.0, IP)))
        f2 = jnp.where(oIP == 0, PI / 2, jnp.arctan(oQP / jnp.where(
            oIP == 0, 1.0, oIP)))
        freq_err = f1 - f2
        freq_err = jnp.where(freq_err > PI / 2, PI - freq_err, freq_err)
        freq_err = jnp.where(freq_err < -PI / 2, -PI - freq_err, freq_err)
        carr_nco_new = (st["carr_nco"] + pllaw * (carr_err - st["carr_err"])
                        + pllw2 * dt * carr_err + fllw * dt * freq_err)

        # DLL (sdrtrk.c:133-150)
        IE, QE = sum_i[cfg.ne], sum_q[cfg.ne]
        IL, QL = sum_i[cfg.nl], sum_q[cfg.nl]
        eE = jnp.sqrt(IE * IE + QE * QE)
        eL = jnp.sqrt(IL * IL + QL * QL)
        code_err = (eE - eL) / jnp.maximum(eE + eL, 1e-12)
        code_nco_new = (st["code_nco"] + dllaw * (code_err - st["code_err"])
                        + dllw2 * dt * code_err)

        carr_nco = jnp.where(update, carr_nco_new, st["carr_nco"])
        code_nco = jnp.where(update, code_nco_new, st["code_nco"])
        carr_err_c = jnp.where(update, carr_err, st["carr_err"])
        code_err_c = jnp.where(update, code_err, st["code_err"])
        freq_err_c = jnp.where(update, freq_err, st["freq_err"])

        dcarr_hz = st["dcarr_acq"] + carr_nco
        dcode_hz = -code_nco + dcarr_hz * cc["aid"]

        # --- advance phases with the OLD freqs used for this period ----- #
        # (exact table lookups: remcode is in chips, up to a code length,
        # and a float32 dot with a one-hot would run at TF32 on the GPU)
        k = n - self.n_nom + NSPAN
        remcode = st["remcode"] + cc["code_adv"][k] + \
            st["dci"] * n.astype(jnp.float32)
        remcarr = frac(st["remcarr"] + cc["carr_adv"][k]
                       + frac(st["dcps"] * n.astype(jnp.float32)))

        out = dict(
            ip=cur_i[0], qp=cur_q[0], sum_i=sum_i, sum_q=sum_q,
            loc=st["loc"], n=n, remcode=st["remcode"],
            remcarr=st["remcarr"], dcarr=dcarr_hz, dcode=dcode_hz,
            carr_err=carr_err_c, code_err=code_err_c,
            carr_nco=carr_nco, code_nco=code_nco,
            flagloopfilter=flagloop,
        )

        clear = update  # clearcumsumcorr when the loop filter ran
        znt = jnp.zeros_like(sum_i)
        new = dict(
            loc=st["loc"] + n, cnt=cnt1,
            remcode=remcode, remcarr=remcarr,
            dcps=(st["dcarr_acq"] + carr_nco) * self.ti,
            dci=(-code_nco + (st["dcarr_acq"] + carr_nco) * cc["aid"])
                * self.ti,
            carr_nco=carr_nco, code_nco=code_nco,
            carr_err=carr_err_c, code_err=code_err_c, freq_err=freq_err_c,
            sum_i=jnp.where(clear, znt, sum_i),
            sum_q=jnp.where(clear, znt, sum_q),
            oldsum_i=jnp.where(clear, znt, oldsum_i),
            oldsum_q=jnp.where(clear, znt, oldsum_q),
            prev_i=cur_i, prev_q=cur_q,
        )
        return new, out

    # ------------------------------------------------------------------ #
    @functools.partial(jax.jit, static_argnums=0)
    def _state_to_dict(self, s: TrackState):
        # jitted: one dispatch instead of one per field
        return dict(
            loc=s.loc, cnt=s.cnt, remcode=s.remcode, remcarr=s.remcarr,
            dcps=(s.dcarr_acq + s.carr_nco) * self.ti,
            dci=(-s.code_nco + (s.dcarr_acq + s.carr_nco) * self.aid)
                * self.ti,
            dcarr_acq=s.dcarr_acq, carr_nco=s.carr_nco, carr_err=s.carr_err,
            freq_err=s.freq_err, code_nco=s.code_nco, code_err=s.code_err,
            sum_i=s.sum_i, sum_q=s.sum_q,
            oldsum_i=s.oldsum_i, oldsum_q=s.oldsum_q,
            prev_i=s.prev_i, prev_q=s.prev_q,
            flagsync=s.flagsync, sync_offset=s.sync_offset, active=s.active,
        )

    def _dict_to_state(self, d, template: TrackState) -> TrackState:
        return dataclasses.replace(
            template, loc=d["loc"], cnt=d["cnt"], remcode=d["remcode"],
            remcarr=d["remcarr"], carr_nco=d["carr_nco"],
            carr_err=d["carr_err"], freq_err=d["freq_err"],
            code_nco=d["code_nco"], code_err=d["code_err"],
            sum_i=d["sum_i"], sum_q=d["sum_q"],
            oldsum_i=d["oldsum_i"], oldsum_q=d["oldsum_q"],
            prev_i=d["prev_i"], prev_q=d["prev_q"],
        )

    def run_steps(self, carry, block, consts, nsteps: int):
        """The traced scan body (un-jitted; `_run` is its jitted form —
        kept separate so graft/sharding wrappers can re-jit with custom
        shardings)."""
        def step(st, _):
            def one(cc, stc):
                new, out = self._channel_step(block, cc, stc)
                # inactive channels: freeze the whole carry
                act = stc["active"]
                merged = {k: jnp.where(act, new[k], stc[k]) if k in new
                          else stc[k] for k in stc}
                return merged, out
            new, out = jax.vmap(one, in_axes=(0, 0))(consts, st)
            return new, out

        return jax.lax.scan(step, carry, None, length=nsteps)

    @functools.partial(jax.jit, static_argnums=(0, 4))
    def _run(self, carry, block, consts, nsteps: int):
        carry, o = self.run_steps(carry, block, consts, nsteps)
        # pack telemetry into ONE f32 + ONE i32 array (same scheme as
        # FastTracker._run): one transfer per block instead of 15 small
        # ones.  loc stays i32 — block offsets exceed f32's 2^24 exact
        # range.
        col = lambda a: a[..., None]
        packf = jnp.concatenate(
            [col(o["ip"]), col(o["qp"]), o["sum_i"], o["sum_q"],
             col(o["remcode"]), col(o["remcarr"]), col(o["dcarr"]),
             col(o["dcode"]), col(o["carr_err"]), col(o["code_err"]),
             col(o["carr_nco"]), col(o["code_nco"])], axis=-1)
        packi = jnp.concatenate(
            [col(o["loc"]), col(o["n"]), col(o["flagloopfilter"])], axis=-1)
        return carry, packf, packi

    def _unpack_outs(self, packf, packi):
        taps = self.cfg.ntaps
        names = ("ip", "qp", "sum_i", "sum_q", "remcode", "remcarr",
                 "dcarr", "dcode", "carr_err", "code_err", "carr_nco",
                 "code_nco")
        widths = (1, 1, taps, taps, 1, 1, 1, 1, 1, 1, 1, 1)
        o, pos = {}, 0
        for name, w in zip(names, widths):
            o[name] = packf[..., pos] if w == 1 else packf[..., pos:pos + w]
            pos += w
        o["loc"], o["n"], o["flagloopfilter"] = (
            packi[..., 0], packi[..., 1], packi[..., 2])
        return o

    def run_block(self, state: TrackState, block, nsteps: int
                  ) -> tuple[TrackState, TrackOutputs]:
        """Advance every active channel ``nsteps`` code periods through
        ``block``: (n,) f32 real samples, (n, 2) f32 stacked I/Q, or (n,)
        complex (converted host-side — complex can't cross the device
        boundary).

        The caller guarantees max(loc) + nsteps*(n_nom+NSPAN) + nwin
        <= len(block).
        """
        new_state, handle = self.run_block_start(state, block, nsteps)
        return new_state, self.run_block_collect(handle)

    def run_block_start(self, state: TrackState, block, nsteps: int):
        """Dispatch a per-period block without fetching telemetry:
        returns (new_state, handle) — the same split as
        FastTracker.run_block_start, so the Receiver can pipeline the
        PULL-IN phase too (dispatch block k+1 while block k's telemetry
        comes back and its nav host work runs).  The host->device
        nav feedback this defers — set_bit_sync — is an absolute phase
        (cnt ≡ sync_offset mod loop), so applying it a block or two late
        only keeps the channel on prm1 cadence that much longer."""
        if hasattr(block, "dtype") and jnp.iscomplexobj(block):
            b = np.asarray(block)
            block = jnp.asarray(np.stack([b.real, b.imag], axis=-1)
                                .astype(np.float32))
        carry = self._state_to_dict(state)
        carry, packf, packi = self._run(carry, block, self._consts,
                                        int(nsteps))
        new_state = self._dict_to_state(carry, state)
        for a in (packf, packi):
            # start the device->host copy as soon as the block finishes
            # on device, overlapping the next block's compute
            try:
                a.copy_to_host_async()
            except (AttributeError, NotImplementedError):  # pragma: no cover
                pass
        return new_state, (packf, packi)

    def run_block_collect(self, handle) -> TrackOutputs:
        """Fetch + unpack a run_block_start handle into TrackOutputs."""
        return TrackOutputs(
            **self._unpack_outs(*jax.device_get(handle)))

    def rebase(self, state: TrackState, advance: int) -> TrackState:
        """Shift block-relative sample offsets after the host advances the
        sample window by ``advance`` samples (the ring-buffer equivalent)."""
        return dataclasses.replace(state, loc=state.loc - int(advance))

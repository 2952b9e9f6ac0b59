"""Steady-state fast tracking: L code periods per device step.

After nav bit sync, every channel's loop filter runs once per ``loop``
periods (reference swloop cadence, src/sdrnav.c:241-282) — so between
updates all NCO rates are constant and the whole L-period span is closed
form.  This program exploits that:

* window placement, code phase, and carrier phase for all L periods are
  computed as (C, L) vector math (no per-period scan);
* all L windows correlate in one batched bf16 contraction (int8 samples
  and ±1 chips are exact in bf16, accumulation in f32);
* exactly one loop-filter update per channel per super-step, read at its
  period from the cumulative tap sums — the same
  discriminators and NCO equations as the per-period path (sdrtrk.c),
  with rate changes taking effect at the next super-step (one loop
  interval of transport delay, negligible at prm2 bandwidths).

Per-period outputs (prompt I/Q, telemetry) are emitted in slow-path
layout, so the Receiver treats this as a drop-in Tracker for the
steady-state phase.  Requirements: all channels bit-synced, all channels
sharing one ``loop`` interval, table resampler.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import PI
from ..ops.nco import frac
from .loop import Tracker, TrackOutputs
from .state import TrackState, loop_interval


CORRS = ("xla", "diag", "diag2")


def default_corr(platform: str, smax: int) -> str:
    """The correlator a JAX platform runs by default: the plain reference
    formulation on the CPU, the fastest plain-JAX formulation measured on
    the GPU (tools/profile_fast.py; PERF.md).  ``smax`` is the
    correlator half-span: "diag2" needs 2*smax <= 64."""
    if platform == "cpu":
        return "xla"
    if platform == "gpu":
        return "diag2" if 2 * smax <= 64 else "diag"
    raise ValueError(f"no fast-path correlator chosen for platform "
                     f"{platform!r} (known: cpu, gpu)")


class FastTracker:
    """Wraps a table-mode Tracker for the post-bit-sync steady state.

    ``corr`` picks the correlator formulation (see :attr:`corr`); by
    default it follows the platform (:func:`default_corr`)."""

    def __init__(self, tracker: Tracker, corr: str | None = None):
        if tracker.cfg.resample != "table":
            raise ValueError("fast path needs the table resampler")
        loops = {int(loop_interval(ct)) for ct in tracker._ctypes}
        if len(loops) != 1:
            raise ValueError("fast path needs a uniform loop interval; "
                             f"got {loops}")
        self.trk = tracker
        self.L = loops.pop()
        self.C = tracker.C
        self.n_nom = tracker.n_nom
        self.nwin = tracker.nwin
        self.next = tracker.next
        self.smax = tracker.smax
        self.offsets = tracker.offsets
        self.cfg = tracker.cfg
        self.ti = tracker.ti
        self.f_sf = tracker.f_sf

        L, nbar = self.L, self.n_nom
        ci0 = tracker.crate * tracker.ti                 # (C,) f64
        f_base = tracker._f_base                          # (C,) f64
        self.emax = int(np.ceil(L / 2 + self.smax + 2.0 / ci0.min() + 16))
        e = np.arange(-self.emax, self.emax + 1, dtype=np.float64)
        k = np.arange(L + 1, dtype=np.float64)
        self._fconsts = dict(
            # carrier base advance per whole super-window stride and per
            # small sample offset, folded mod 1 in f64 then cast
            base_adv_k=jnp.asarray(
                np.mod(f_base[:, None] * tracker.ti * nbar * k[None, :], 1.0)
                .astype(np.float32)),                     # (C, L+1)
            base_adv_e=jnp.asarray(
                np.mod(f_base[:, None] * tracker.ti * e[None, :], 1.0)
                .astype(np.float32)),                     # (C, 2E+1)
            clen_k=jnp.asarray(
                (np.asarray(tracker._clens, np.float64)[:, None] * k[None, :])
                .astype(np.float32)),                     # (C, L+1)
        )
        self._consts = tracker._consts
        # total carrier base rate (cycles/sample, mod 1) for the factored
        # mixer of the Gram correlators; phase error <= 2.5e-4 cycles over
        # one window
        self._fconsts["fbt"] = jnp.asarray(
            np.mod(f_base * tracker.ti, 1.0).astype(np.float32))
        # rows per window for the take-based fetch: nwin rounded up to
        # whole 128-rows, +1 halo row for the residual-rotation pair
        self._fetch_nr = (self.nwin + 127) // 128 + 1
        # diag-correlator geometry: replica row-pair lane width covering
        # every tap lag d = smax+o in [0, 2*smax] for any lane j < 128
        self._diag_wl = 128 * ((128 + 2 * self.smax + 127) // 128)
        self.corr = (default_corr(jax.default_backend(), self.smax)
                     if corr is None else corr)

    @property
    def corr(self) -> str:
        """Correlator formulation: "xla" (per-window einsum, the plain
        reference), "diag" (Gram-diagonal, see :meth:`_taps_diag`) or
        "diag2" (its single-dot split-layout variant)."""
        return self._corr

    @corr.setter
    def corr(self, value: str) -> None:
        if value not in CORRS:
            raise ValueError(f"corr={value!r}: expected one of {CORRS}")
        # diag2 is built on the 64-lane split-Gram layout (_split_D): every
        # tap lag d = smax+o must fit a 128-lane tile from a 64-lane base.
        # Wider geometries would silently drop taps with (j%64)+d >= 128;
        # "diag" checks this itself and falls back to the wide Gram.
        if value == "diag2" and 2 * self.smax > 64:
            raise ValueError(
                f"corr={value!r} requires 2*smax <= 64 (got smax="
                f"{self.smax}, i.e. corrn*corrd > 32); use corr='diag' "
                "(wide-Gram fallback) for this correlator geometry")
        self._corr = value

    # ------------------------------------------------------------------ #
    def init_state(self) -> TrackState:
        return self.trk.init_state()

    def rebase(self, state, advance):
        return self.trk.rebase(state, advance)

    # ------------------------------------------------------------------ #
    def _geo_only(self, block, cc, fc, st):
        """Per-channel closed-form geometry for one super-step (vmapped):
        period boundaries, replica rows, window slices, carrier phases."""
        L, nbar = self.L, self.n_nom
        ci0 = cc["ci0"]
        ci = ci0 + st["dci"]
        ki = jnp.arange(L, dtype=jnp.float32)

        # closed-form period boundaries
        d = jnp.round((fc["clen_k"] - st["remcode"]) / ci)      # (L+1,)
        n_k = (d[1:] - d[:-1]).astype(jnp.int32)                # (L,)
        remcode_k = st["remcode"] + ci * d[:L] - fc["clen_k"][:L]

        # replica phase decomposition (table row + integer shift)
        phi = remcode_k - ci0 * self.smax
        s = phi / ci0
        m = jnp.floor(s)
        q_idx = jnp.floor((s - m) * self.trk._tbl_q).astype(jnp.int32)
        m = m.astype(jnp.int32) + q_idx // self.trk._tbl_q
        q_idx = q_idx % self.trk._tbl_q

        # data window start absorbs the replica's integer shift: with
        # replica[i] = T_q[M0+m+i], substituting i -> i-m turns the tap sum
        # into data[loc - m + i]*T_q[M0+i] (static replica slice)
        dprime = d[:L].astype(jnp.int32) - m                    # (L,)
        e_k = dprime - (ki * nbar).astype(jnp.int32)            # small
        wstart = st["loc"] + dprime

        # carrier phase per window (an exact table lookup: a float32 dot
        # with a one-hot would run at TF32 on the GPU)
        base_e = fc["base_adv_e"][e_k + self.emax]              # (L,)
        w = frac(st["dcps"] * nbar)
        rem_k = frac(st["remcarr"] + fc["base_adv_k"][:L] + base_e
                     + frac(w * ki) + st["dcps"] * e_k.astype(jnp.float32))

        return dict(d=d, n_k=n_k, remcode_k=remcode_k, rem_k=rem_k,
                    wstart=wstart, q_idx=q_idx)

    def _fetch_windows(self, block2, wstart, rowform=False):
        """(B,) sample starts -> (B, nwin[, 2]) windows, without a vmapped
        dynamic_slice gather of B arbitrary-offset slices:

        1. row take: each window = NR consecutive 128-sample rows of the
           pre-reshaped block, starting at floor(start/128) — a flat row
           gather, the same pattern as the replica-table gather;
        2. residual [0,128) alignment by an exact one-hot selection
           matmul: rotated[b, j, l] = rows[b, j, l + r_b] through
           [row_j | row_j+1] (256) x one-hot (256, 128).

        The one-hot has exactly one 1 per column, so the bf16 matmul
        SELECTS values exactly (samples are 8-bit-alphabet, bf16-exact);
        the rotated rows come back bf16 for the same reason, halving the
        window stream into the correlator.
        """
        B = wstart.shape[0]
        NR = self._fetch_nr
        r0 = wstart // 128
        r = (wstart - r0 * 128)
        idx = (r0[:, None]
               + jnp.arange(NR, dtype=jnp.int32)[None, :]).reshape(-1)
        lane = jnp.arange(256, dtype=jnp.int32)
        out_l = jnp.arange(128, dtype=jnp.int32)
        E = (lane[None, :, None] == (out_l[None, None, :]
                                     + r[:, None, None])
             ).astype(jnp.bfloat16)                       # (B, 256, 128)

        def rot_component(b2):
            rows = jnp.take(b2, idx, axis=0).reshape(B, NR, 128)
            pairs = jnp.concatenate([rows[:, :-1, :], rows[:, 1:, :]],
                                    axis=2).astype(jnp.bfloat16)
            rot = jax.lax.dot_general(
                pairs, E, (((2,), (1,)), ((0,), (0,))),
                preferred_element_type=jnp.bfloat16)      # (B, NR-1, 128)
            if rowform:
                return rot
            return rot.reshape(B, (NR - 1) * 128)[:, :self.nwin]

        if isinstance(block2, tuple):                     # stacked I/Q
            wi = rot_component(block2[0])
            wq = rot_component(block2[1])
            if rowform:
                return wi, wq
            return jnp.stack([wi, wq], axis=-1)
        return rot_component(block2)

    def _block_rows(self, block):
        """Pre-reshape a block into 128-sample rows for _fetch_windows
        (hoisted out of the scan: the block is loop-invariant)."""
        nrow = block.shape[0] // 128
        if block.ndim == 2:                               # (n, 2) I/Q
            b = block[: nrow * 128]
            return (b[:, 0].reshape(nrow, 128), b[:, 1].reshape(nrow, 128))
        return block[: nrow * 128].reshape(nrow, 128)

    def _taps_diag(self, winrows, rc, rem, ftot, n):
        """All-tap correlation as one per-window matrix contraction.

        Instead of 13 unaligned replica tap slices, this path needs NO
        shifts at all: with windows in 128-lane row form
        (B, K, 128) and replica row pairs rcp[b,k,l] = rc[b, 128k+l],
        the Gram matrix

            U[b, j, l] = sum_k wc[b,k,j] * rcp[b,k,l]

        contains every tap sum on a diagonal: tap lag d = smax+o is
        Z[b,d] = sum_j U[b,j,j+d].  One bf16 batched matmul
        (M=256 cos|sin, N=Wl, K=rows) + a static one-hot diagonal
        extraction — 8.4M MAC/window on 128-aligned tiles.  Numerics
        match the "xla" formulation (bf16 products, f32 accumulation) up
        to summation order.

        winrows: (B, K, 128) bf16 rotated window rows (or (I, Q) tuple;
                 8-bit sample alphabet, so bf16 is exact)
        rc:      (B, next) int8/f32 replica rows
        rem/ftot/n: (B,) carrier phase, rate, valid length
        Returns (B, 2*ntaps) f32 interleaved [cos_t, sin_t].
        """
        B = rem.shape[0]
        K = self._fetch_nr - 1
        Wl = self._diag_wl
        nrg = Wl // 128
        # factored carrier (angle addition): with i = 128k + j the mixing
        # angle splits as 2*pi*(ftot*i + rem) = theta_k + phi_j (mod 2*pi),
        # theta_k at the row starts and phi_j the in-row ramp — 2*(K+128)
        # transcendentals per window instead of 2*K*128; products of f32 cos/sin keep the same phase
        # accuracy as the direct form (the ftot*i product rounding, which
        # both share, dominates)
        kk = jnp.arange(K, dtype=jnp.float32) * 128.0            # (K,)
        th = (2.0 * PI) * frac(frac(ftot[:, None] * kk[None, :])
                               + rem[:, None])                    # (B, K)
        ck = jnp.cos(th)[..., None]                               # (B, K, 1)
        sk = jnp.sin(th)[..., None]
        jj = jnp.arange(128, dtype=jnp.float32)
        phj = (2.0 * PI) * (ftot[:, None] * jj[None, :])          # (B, 128)
        cj = jnp.cos(phj)[:, None, :]                             # (B, 1, 128)
        sj = jnp.sin(phj)[:, None, :]
        i = kk[:, None] + jj[None, :]                             # (K, 128)
        mask = i[None] < n[:, None, None].astype(jnp.float32)
        if isinstance(winrows, tuple):
            wr = jnp.where(mask, winrows[0].astype(jnp.float32), 0.0)
            wi = jnp.where(mask, winrows[1].astype(jnp.float32), 0.0)
            a = wr * ck - wi * sk
            b = wr * sk + wi * ck
        else:
            w = jnp.where(mask, winrows.astype(jnp.float32), 0.0)
            a = w * ck
            b = w * sk
        wc = a * cj - b * sj
        ws = b * cj + a * sj

        pad = 128 * (K + nrg) - rc.shape[1]
        rcf = rc.astype(jnp.bfloat16)
        if pad > 0:
            rcf = jnp.pad(rcf, ((0, 0), (0, pad)))
        r2 = rcf[:, :128 * (K + nrg)].reshape(B, K + nrg, 128)
        rcp = jnp.concatenate([r2[:, m:m + K] for m in range(nrg)],
                              axis=2)                          # (B, K, Wl)

        # bf16 Gram outputs: U entries are f32-accumulated and rounded
        # once on write, halving the (B, 128, 128) matrices' round trip
        # through device memory into the extractor.  The 13 tap sums then
        # add 64 such entries (f32 accumulation again); for the prompt tap
        # the entries are near-equal, so the rounding averages down ~1/8 —
        # well inside the path's existing bf16 tap tolerance.
        u_t = jnp.bfloat16

        if 2 * self.smax <= 64:
            # 64-lane j-split: every tap diagonal of each half fits in
            # one 128-lane tile, halving the Gram MACs and its memory
            # footprint versus the full (256, Wl) matrix
            lhsA = jnp.concatenate([wc[..., :64], ws[..., :64]],
                                   axis=2).astype(jnp.bfloat16)
            lhsB = jnp.concatenate([wc[..., 64:], ws[..., 64:]],
                                   axis=2).astype(jnp.bfloat16)
            dims = (((1,), (1,)), ((0,), (0,)))
            UA = jax.lax.dot_general(
                lhsA, rcp[:, :, :128], dims,
                preferred_element_type=u_t)                    # (B,128,128)
            UB = jax.lax.dot_general(
                lhsB, rcp[:, :, 64:192], dims,
                preferred_element_type=u_t)
            D = self._split_D()
            return (jnp.einsum("bjl,jlt->bt", UA, D,
                               preferred_element_type=jnp.float32)
                    + jnp.einsum("bjl,jlt->bt", UB, D,
                                 preferred_element_type=jnp.float32))

        wcs = jnp.concatenate([wc, ws], axis=2).astype(jnp.bfloat16)
        U = jax.lax.dot_general(
            wcs, rcp, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=u_t)                        # (B, 256, Wl)
        jj = jnp.arange(256, dtype=jnp.int32)
        D = self._extractor(jnp.where(jj < 128, jj, jj - 128), jj >= 128,
                            Wl)
        return jnp.einsum("bjl,jlt->bt", U, D,
                          preferred_element_type=jnp.float32)

    def _extractor(self, jbase, is_sin, nl):
        """Static one-hot diagonal extractor D[j, l, t] = 1 iff
        l == jbase[j] + d_t and is_sin[j] matches tap column t's sin flag
        (columns interleaved [cos_t, sin_t]).  Built from iotas so it is
        loop-invariant inside the scan; one-hot, so exact in bf16."""
        doff = np.asarray([int(o) + self.smax for o in
                           np.asarray(self.offsets)], np.int32)
        col_d = jnp.asarray(np.repeat(doff, 2))                # (2T,)
        col_sin = jnp.asarray(
            np.tile(np.asarray([0, 1], np.int32), len(doff)))
        ll = jnp.arange(nl, dtype=jnp.int32)
        return ((ll[None, :, None]
                 == jbase[:, None, None] + col_d[None, None, :])
                & (is_sin[:, None, None]
                   == (col_sin == 1)[None, None, :])
                ).astype(jnp.bfloat16)

    def _split_D(self):
        """Extractor for the 64-lane split Gram layout: row j' holds lane
        j' % 64 of the cos (j' < 64) or sin (j' >= 64) half."""
        jj = jnp.arange(128, dtype=jnp.int32)
        return self._extractor(jj % 64, jj >= 64, 128)

    def _taps_diag2(self, winrows, rc, rem, ftot, n):
        """Single-dot variant of :meth:`_taps_diag`: both 64-lane j-halves
        ride ONE sublane-concatenated batched Gram (the sum over rows is
        order-free), so XLA materializes one packed lhs, one packed
        replica, and ONE U matrix per window instead of two of each —
        less memory traffic than the two-dot split.  Same numerics
        (bf16 operands, f32 accumulation, bf16 U).  Requires
        2*smax <= 64."""
        B = rem.shape[0]
        K = self._fetch_nr - 1
        kk = jnp.arange(K, dtype=jnp.float32)[None, :, None] * 128.0
        jj = jnp.arange(128, dtype=jnp.float32)[None, None, :]
        i = kk + jj                                        # (1, K, 128)
        th = (2.0 * PI) * frac(frac(ftot[:, None, None] * kk)
                               + rem[:, None, None])       # (B, K, 1)
        ck = jnp.cos(th)
        sk = jnp.sin(th)
        ph = (2.0 * PI) * (ftot[:, None, None] * jj)       # (B, 1, 128)
        cj = jnp.cos(ph)
        sj = jnp.sin(ph)
        mask = i < n[:, None, None].astype(jnp.float32)
        if isinstance(winrows, tuple):
            wr = jnp.where(mask, winrows[0].astype(jnp.float32), 0.0)
            wi = jnp.where(mask, winrows[1].astype(jnp.float32), 0.0)
            a = wr * ck - wi * sk
            b = wr * sk + wi * ck
        else:
            w = jnp.where(mask, winrows.astype(jnp.float32), 0.0)
            a = w * ck
            b = w * sk
        wc = a * cj - b * sj
        ws = b * cj + a * sj
        # packed lhs: rows [0, K) = [wc_lo | ws_lo], rows [K, 2K) =
        # [wc_hi | ws_hi] per the 64-lane j-split
        lhsA = jnp.concatenate([wc[..., :64], ws[..., :64]],
                               axis=2).astype(jnp.bfloat16)
        lhsB = jnp.concatenate([wc[..., 64:], ws[..., 64:]],
                               axis=2).astype(jnp.bfloat16)
        lhs2 = jnp.concatenate([lhsA, lhsB], axis=1)       # (B, 2K, 128)
        need = 128 * (K + 1)
        pad = need - rc.shape[1]
        rcp = jnp.pad(rc, ((0, 0), (0, pad))) if pad > 0 else \
            rc[:, :need]
        rc2 = jnp.concatenate(
            [rcp[:, :128 * K].reshape(B, K, 128),
             rcp[:, 64:64 + 128 * K].reshape(B, K, 128)],
            axis=1).astype(jnp.bfloat16)                   # (B, 2K, 128)
        U = jax.lax.dot_general(
            lhs2, rc2, (((1,), (1,)), ((0,), (0,))),
            preferred_element_type=jnp.bfloat16)           # (B, 128, 128)
        D = self._split_D()
        return jnp.einsum("bjl,jlt->bt", U, D,
                          preferred_element_type=jnp.float32)

    def _replica_rows(self, consts, q_idx):
        """(C, L) quantized-phase indices -> (C*L, next) replica rows.

        One flat row gather over the (C*Q, W) table.  A one-hot matmul
        row select would stream the WHOLE table (~0.5 GB for 32 ch x 1024
        phases) from device memory every super-step; the gather reads
        only the C*L rows it needs."""
        C, L = q_idx.shape            # local C under shard_map
        Q = self.trk._tbl_q
        W = consts["table"].shape[-1]
        row_idx = (jnp.arange(C, dtype=jnp.int32)[:, None] * Q
                   + q_idx).reshape(C * L)
        rows = jnp.take(consts["table"].reshape(C * Q, W), row_idx,
                        axis=0)                          # table-native int8
        m0 = self.trk._tbl_m0
        return rows[:, m0:m0 + self.next]                # (C*L, next)

    def _taps_xla(self, cc, geo, st):
        """Batched-einsum tap computation (per channel, vmapped)."""
        win, rc, rem_k, n_k = (geo["win"], geo["rc"], geo["rem_k"],
                               geo["n_k"])
        i = jnp.arange(self.nwin, dtype=jnp.float32)
        ph = frac(cc["base_phase"][None, :]
                  + frac(st["dcps"] * i)[None, :] + rem_k[:, None])
        rot = jnp.exp((2j * PI) * ph.astype(jnp.complex64))
        if win.ndim == 3:
            mixed = jax.lax.complex(win[..., 0].astype(jnp.float32),
                                    win[..., 1].astype(jnp.float32)) * rot
        else:
            mixed = win.astype(jnp.complex64) * rot
        mask = (i[None, :] < n_k[:, None].astype(jnp.float32))
        iq = jnp.stack([mixed.real, mixed.imag], axis=-1)
        iq = jnp.where(mask[..., None], iq, 0.0).astype(jnp.bfloat16)
        rcb = rc.astype(jnp.bfloat16)
        reps = jnp.stack(
            [rcb[:, self.smax + int(o):self.smax + int(o) + self.nwin]
             for o in np.asarray(self.offsets)], axis=1)        # (L,t,nwin)
        z = jnp.einsum("ltn,lnr->ltr", reps, iq,
                       preferred_element_type=jnp.float32)      # (L,t,2)
        z = z * jnp.float32(self.trk._tbl_scale)
        # reference I/Q mapping (see loop.py): cur_q=real, cur_i=imag
        return z[..., 1], z[..., 0]

    def _filter(self, cc, fc, st, geo, cur_i, cur_q):
        """Loop-filter update + carries + outputs for one channel."""
        cfg = self.cfg
        L, nbar = self.L, self.n_nom
        ci0 = cc["ci0"]
        ci = ci0 + st["dci"]
        ki = jnp.arange(L, dtype=jnp.float32)
        d, n_k = geo["d"], geo["n_k"]
        remcode_k, rem_k = geo["remcode_k"], geo["rem_k"]
        w = frac(st["dcps"] * nbar)

        # --- one filter update at k_c -------------------------------------- #
        # (values at k_c are exact row lookups: a float32 dot with a
        # one-hot would run at TF32 on the GPU)
        k_c = jnp.mod(st["sync_offset"] - 1 - st["cnt"], cc["loop"])
        csum_i = st["sum_i"][None, :] + jnp.cumsum(cur_i, axis=0)
        csum_q = st["sum_q"][None, :] + jnp.cumsum(cur_q, axis=0)
        sum_i_u = csum_i[k_c]
        sum_q_u = csum_q[k_c]
        # oldsum at the update: prior + prev-carry + sums of taps[0..k_c-1]
        csum_prev_i = jnp.cumsum(
            jnp.concatenate([st["prev_i"][None, :], cur_i[:-1]], axis=0),
            axis=0)
        csum_prev_q = jnp.cumsum(
            jnp.concatenate([st["prev_q"][None, :], cur_q[:-1]], axis=0),
            axis=0)
        oldsum_i_u = st["oldsum_i"] + csum_prev_i[k_c]
        oldsum_q_u = st["oldsum_q"] + csum_prev_q[k_c]

        # discriminators + NCOs (identical math to loop.py, prm2 only)
        q2 = cfg.prm2
        dt = cc["dt2"]
        IP, QP = sum_i_u[0], sum_q_u[0]
        oIP, oQP = oldsum_i_u[0], oldsum_q_u[0]
        carr_err = jnp.where(
            IP > 0, jnp.arctan2(QP, IP), jnp.arctan2(-QP, -IP)) / PI
        f1 = jnp.where(IP == 0, PI / 2,
                       jnp.arctan(QP / jnp.where(IP == 0, 1.0, IP)))
        f2 = jnp.where(oIP == 0, PI / 2,
                       jnp.arctan(oQP / jnp.where(oIP == 0, 1.0, oIP)))
        freq_err = f1 - f2
        freq_err = jnp.where(freq_err > PI / 2, PI - freq_err, freq_err)
        freq_err = jnp.where(freq_err < -PI / 2, -PI - freq_err, freq_err)
        carr_nco = (st["carr_nco"] + q2.pllaw * (carr_err - st["carr_err"])
                    + q2.pllw2 * dt * carr_err + q2.fllw * dt * freq_err)
        IE, QE = sum_i_u[cfg.ne], sum_q_u[cfg.ne]
        IL, QL = sum_i_u[cfg.nl], sum_q_u[cfg.nl]
        eE = jnp.sqrt(IE * IE + QE * QE)
        eL = jnp.sqrt(IL * IL + QL * QL)
        code_err = (eE - eL) / jnp.maximum(eE + eL, 1e-12)
        code_nco = (st["code_nco"] + q2.dllaw * (code_err - st["code_err"])
                    + q2.dllw2 * dt * code_err)

        dcarr_hz = st["dcarr_acq"] + carr_nco
        dcode_hz = -code_nco + dcarr_hz * cc["aid"]

        # --- end-of-step carries ------------------------------------------- #
        after = (ki > k_c.astype(jnp.float32))[:, None]
        sum_i_end = jnp.sum(jnp.where(after, cur_i, 0.0), axis=0)
        sum_q_end = jnp.sum(jnp.where(after, cur_q, 0.0), axis=0)
        prevtaps_i = jnp.concatenate([st["prev_i"][None, :], cur_i[:-1]],
                                     axis=0)
        prevtaps_q = jnp.concatenate([st["prev_q"][None, :], cur_q[:-1]],
                                     axis=0)
        oldsum_i_end = jnp.sum(jnp.where(after, prevtaps_i, 0.0), axis=0)
        oldsum_q_end = jnp.sum(jnp.where(after, prevtaps_q, 0.0), axis=0)

        remcode_out = st["remcode"] + ci * d[L] - fc["clen_k"][L]
        eL_end = (d[L].astype(jnp.int32) - L * nbar)
        remcarr_out = frac(st["remcarr"] + fc["base_adv_k"][L]
                           + fc["base_adv_e"][eL_end + self.emax]
                           + frac(w * jnp.float32(L))
                           + st["dcps"] * eL_end.astype(jnp.float32))

        new = dict(
            loc=st["loc"] + d[L].astype(jnp.int32),
            cnt=st["cnt"] + L,
            remcode=remcode_out, remcarr=remcarr_out,
            dcps=dcarr_hz * self.ti,
            dci=(-code_nco + dcarr_hz * cc["aid"]) * self.ti,
            carr_nco=carr_nco, code_nco=code_nco,
            carr_err=carr_err, code_err=code_err, freq_err=freq_err,
            sum_i=sum_i_end, sum_q=sum_q_end,
            oldsum_i=oldsum_i_end, oldsum_q=oldsum_q_end,
            prev_i=cur_i[L - 1], prev_q=cur_q[L - 1],
        )
        # minimal device->host telemetry: per-period prompts + sample
        # bookkeeping, everything else only at the (single) update period —
        # the full per-period layout is reconstructed host-side.
        out = dict(
            ip=cur_i[:, 0], qp=cur_q[:, 0],
            loc=st["loc"] + d[:L].astype(jnp.int32),
            k_c=k_c,
            n_u=n_k[k_c],
            remcode_u=remcode_k[k_c],
            remcarr_u=rem_k[k_c],
            sum_i_u=sum_i_u, sum_q_u=sum_q_u,
            dcarr=dcarr_hz, dcode=dcode_hz,
            carr_err=carr_err, code_err=code_err,
            carr_nco=carr_nco, code_nco=code_nco,
        )
        return new, out

    # ------------------------------------------------------------------ #
    def run_steps(self, carry, block, consts, fconsts, nsuper: int):
        block2 = self._block_rows(block)   # loop-invariant: hoists

        def step(st, _):
            geo = jax.vmap(functools.partial(self._geo_only, block)
                           )(consts, fconsts, st)
            rc = self._replica_rows(consts, geo["q_idx"])    # (C*L, next)
            C, L = geo["q_idx"].shape    # local C under shard_map
            B = C * L
            if self.corr == "xla":
                winf = self._fetch_windows(block2,
                                           geo["wstart"].reshape(B))
                geo["rc"] = rc.reshape(C, L, self.next)
                geo["win"] = winf.reshape((C, L) + winf.shape[1:])
                cur_i, cur_q = jax.vmap(self._taps_xla)(consts, geo, st)
            else:
                winr = self._fetch_windows(
                    block2, geo["wstart"].reshape(B), rowform=True)
                ftot = jnp.broadcast_to(
                    (fconsts["fbt"] + st["dcps"])[:, None], (C, L))
                taps = (self._taps_diag2 if self.corr == "diag2"
                        else self._taps_diag)
                z2 = taps(winr, rc, geo["rem_k"].reshape(B),
                          ftot.reshape(B), geo["n_k"].reshape(B))
                z2 = (z2 * jnp.float32(self.trk._tbl_scale)
                      ).reshape(C, L, -1)
                cur_q = z2[..., 0::2]
                cur_i = z2[..., 1::2]

            def one(cc, fcc, stc, geoc, ci_, cq_):
                new, out = self._filter(cc, fcc, stc, geoc, ci_, cq_)
                act = stc["active"]
                merged = {k: jnp.where(act, new[k], stc[k]) if k in new
                          else stc[k] for k in stc}
                return merged, out
            return jax.vmap(one)(consts, fconsts, st, geo, cur_i, cur_q)
        return jax.lax.scan(step, carry, None, length=nsuper)

    def _pack(self, o):
        # pack the telemetry into ONE f32 + ONE i32 array: one transfer
        # per block instead of 17 small ones.  loc stays i32 — block
        # offsets exceed f32's 2^24 exact-integer range.
        col = lambda a: a[..., None]
        packf = jnp.concatenate(
            [o["ip"], o["qp"], col(o["remcode_u"]), col(o["remcarr_u"]),
             o["sum_i_u"], o["sum_q_u"], col(o["dcarr"]), col(o["dcode"]),
             col(o["carr_err"]), col(o["code_err"]), col(o["carr_nco"]),
             col(o["code_nco"])], axis=-1)
        packi = jnp.concatenate(
            [o["loc"], col(o["k_c"]), col(o["n_u"])], axis=-1)
        return packf, packi

    @functools.partial(jax.jit, static_argnums=(0, 5))
    def _run(self, carry, block, consts, fconsts, nsuper: int):
        carry, o = self.run_steps(carry, block, consts, fconsts, nsuper)
        packf, packi = self._pack(o)
        return carry, packf, packi

    def _unpack(self, packf, packi):
        L, taps = self.L, self.cfg.ntaps
        f = iter(np.cumsum([L, L, 1, 1, taps, taps, 1, 1, 1, 1, 1, 1]))
        sl, pos = {}, 0
        for name in ("ip", "qp", "remcode_u", "remcarr_u", "sum_i_u",
                     "sum_q_u", "dcarr", "dcode", "carr_err", "code_err",
                     "carr_nco", "code_nco"):
            end = int(next(f))
            sl[name] = packf[..., pos:end] if end - pos > 1 else \
                packf[..., pos]
            pos = end
        sl["loc"] = packi[..., :L]
        sl["k_c"] = packi[..., L]
        sl["n_u"] = packi[..., L + 1]
        return sl

    def run_block(self, state: TrackState, block, nsteps: int
                  ) -> tuple[TrackState, TrackOutputs]:
        """Drop-in run_block: ``nsteps`` must be a multiple of L; outputs
        come back in per-period (steps, C, ...) layout."""
        if nsteps % self.L:
            raise ValueError(f"nsteps must be a multiple of L={self.L}")
        new_state, handle = self.run_block_start(state, block, nsteps)
        return new_state, self.run_block_collect(handle)

    def run_block_start(self, state: TrackState, block, nsteps: int):
        """Dispatch a block without fetching telemetry: returns
        (new_state, handle).  The device starts computing immediately;
        call :meth:`run_block_collect` on the handle to fetch and unpack
        outputs.  Dispatching the NEXT block before collecting the
        previous one overlaps its device compute with this handle's
        device->host transfer."""
        if hasattr(block, "dtype") and jnp.iscomplexobj(block):
            b = np.asarray(block)
            block = jnp.asarray(np.stack([b.real, b.imag], axis=-1)
                                .astype(np.float32))
        carry = self.trk._state_to_dict(state)
        S = nsteps // self.L
        carry, packf, packi = self._run(carry, block, self._consts,
                                        self._fconsts, S)
        new_state = self.trk._dict_to_state(carry, state)
        for a in (packf, packi):
            # start the device->host copy as soon as the block finishes on
            # device, overlapping the next blocks' compute — the blocking
            # device_get in run_block_collect then reads local bytes
            try:
                a.copy_to_host_async()
            except (AttributeError, NotImplementedError):  # pragma: no cover
                pass
        return new_state, (packf, packi)

    def run_block_collect(self, handle) -> TrackOutputs:
        """Fetch + unpack a run_block_start handle into TrackOutputs."""
        o = self._unpack(*jax.device_get(handle))
        S = o["k_c"].shape[0]
        L, taps = self.L, self.cfg.ntaps
        C = o["k_c"].shape[1]

        def tolinear(a):
            a = np.moveaxis(a, 2, 1)            # (S, L, C, ...)
            return a.reshape((-1,) + a.shape[2:])

        ip = tolinear(o["ip"])
        qp = tolinear(o["qp"])
        loc = tolinear(o["loc"])
        steps = S * L
        # reconstruct the per-period layout from update-time telemetry
        kc = o["k_c"]                            # (S, C)
        upd_rows = (np.arange(S)[:, None] * L + kc)          # (S, C)
        flagloop = np.zeros((steps, C), np.int32)
        n = np.full((steps, C), self.n_nom, np.int32)
        remcode = np.zeros((steps, C), np.float32)
        remcarr = np.zeros((steps, C), np.float32)
        sum_i = np.zeros((steps, C, taps), np.float32)
        sum_q = np.zeros((steps, C, taps), np.float32)
        cols = np.broadcast_to(np.arange(C)[None, :], (S, C))
        flagloop[upd_rows, cols] = 2
        n[upd_rows, cols] = o["n_u"]
        remcode[upd_rows, cols] = o["remcode_u"]
        remcarr[upd_rows, cols] = o["remcarr_u"]
        sum_i[upd_rows, cols] = o["sum_i_u"]
        sum_q[upd_rows, cols] = o["sum_q_u"]

        def widen(a):                            # (S, C) -> (steps, C)
            return np.repeat(a, L, axis=0)

        outs = dict(
            ip=ip, qp=qp, loc=loc, n=n, remcode=remcode, remcarr=remcarr,
            sum_i=sum_i, sum_q=sum_q,
            dcarr=widen(o["dcarr"]), dcode=widen(o["dcode"]),
            carr_err=widen(o["carr_err"]), code_err=widen(o["code_err"]),
            carr_nco=widen(o["carr_nco"]), code_nco=widen(o["code_nco"]),
            flagloopfilter=flagloop,
        )
        return TrackOutputs(**outs)

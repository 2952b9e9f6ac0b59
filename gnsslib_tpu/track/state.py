"""Tracking state and configuration pytrees.

The reference's per-channel mutable ``sdrtrk_t`` (src/sdr.h:371-412)
becomes an explicit pytree of arrays with a leading channel axis, carried
through ``lax.scan`` (SURVEY.md §2.5).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from ..constants import LOOP_L1CA, LOOP_SBAS, LOOP_G1, NAVRATE_L1CA, CodeType


@dataclasses.dataclass(frozen=True)
class LoopParams:
    """2nd-order loop coefficients from noise bandwidths.

    Reference math: sdrinit.c:400-423 — w2 = (B/0.53)², aw = 1.414*(B/0.53)
    for DLL and PLL; FLL w = B/0.25.
    """
    dllw2: float
    dllaw: float
    pllw2: float
    pllaw: float
    fllw: float

    @staticmethod
    def from_bandwidths(dllb: float, pllb: float, fllb: float) -> "LoopParams":
        return LoopParams(
            dllw2=(dllb / 0.53) ** 2,
            dllaw=1.414 * (dllb / 0.53),
            pllw2=(pllb / 0.53) ** 2,
            pllaw=1.414 * (pllb / 0.53),
            fllw=fllb / 0.25,
        )


def loop_interval(ctype: int) -> int:
    """Loop-filter interval in code periods after bit sync (sdr.h:151-154)."""
    if ctype == CodeType.L1SBAS:
        return LOOP_SBAS
    if ctype == CodeType.G1:
        return LOOP_G1
    return LOOP_L1CA


@dataclasses.dataclass(frozen=True)
class TrackConfig:
    """Static (compile-time) tracking configuration for one channel group.

    Mirrors the [TRACK] section of the front-end INI + per-ctype constants
    (reference sdrinit.c:160-169, 432-480).
    """
    corrn: int = 6
    corrd: int = 3
    corrp: int = 6
    prm1: LoopParams = LoopParams.from_bandwidths(5.0, 30.0, 200.0)
    prm2: LoopParams = LoopParams.from_bandwidths(1.0, 10.0, 50.0)
    # code-replica generation: "table" = quantized-phase rows + contiguous
    # dynamic_slice (<=1/512-chip replica phase quantization);
    # "exact" = per-sample gather bit-matching the reference's rescode
    resample: str = "table"
    # reset the code NCO at bit-sync handoff: the per-period prm1 DLL
    # chases the resampler's S-curve bias, leaving several Hz of code-rate
    # jitter in the NCO; the narrow prm2 loop can inherit it and walk off
    # (observed at ~2 samples/chip).  The reference carries the jitter
    # over (src/sdrmain.c:277-279); resetting to the carrier-aided rate is
    # a strictly safer start.  Disable for bit-faithful dynamics.
    reset_nco_on_sync: bool = True
    # linearly interpolated replica rows (table mode only): cuts the
    # nearest-neighbour resampler's S-curve ripple ~2.4x at ~2 samples/
    # chip front-ends (RTL-SDR 2.048 Msps) when the signal is BAND-
    # LIMITED (any real analog front end) — the reference's rescode
    # (sdrcmn.c:608-631) has the same bias.  Against an ideal hard-
    # sampled signal it does not help (the signal carries the sampling
    # bias), hence opt-in.  Rows are stored as int8 code*127; tap sums
    # are rescaled by 1/127 on the way out.
    interp_replica: bool = False

    @property
    def ntaps(self) -> int:
        return 1 + 2 * self.corrn

    @property
    def smax(self) -> int:
        return self.corrn * self.corrd

    @property
    def ne(self) -> int:
        return 2 * (self.corrp // self.corrd) - 1

    @property
    def nl(self) -> int:
        return 2 * (self.corrp // self.corrd)


@jax.tree_util.register_dataclass
@dataclasses.dataclass
class TrackState:
    """Per-channel loop state, all arrays shaped (C, ...) float32/int32.

    Maps onto sdrtrk_t fields (src/sdr.h:371-412); phases use the
    small-offset representation of ops.nco.
    """
    loc: jnp.ndarray        # (C,) int32 — sample offset of next period in block
    cnt: jnp.ndarray        # (C,) int32 — code-period counter since track start
    remcode: jnp.ndarray    # (C,) f32 chips in ~[-ci/2, ci/2]
    remcarr: jnp.ndarray    # (C,) f32 carrier phase remainder (cycles, [0,1))
    dcarr_acq: jnp.ndarray  # (C,) f32 Hz — acquisition offset vs f_if+foffset
    carr_nco: jnp.ndarray   # (C,) f32 Hz
    carr_err: jnp.ndarray   # (C,) f32 (half-cycles)
    freq_err: jnp.ndarray   # (C,) f32 (rad)
    code_nco: jnp.ndarray   # (C,) f32 Hz
    code_err: jnp.ndarray   # (C,) f32 (chips, normalized envelope)
    sum_i: jnp.ndarray      # (C, ntaps) f32 coherent accumulation
    sum_q: jnp.ndarray      # (C, ntaps) f32
    oldsum_i: jnp.ndarray   # (C, ntaps) f32 previous accumulation (FLL)
    oldsum_q: jnp.ndarray   # (C, ntaps) f32
    prev_i: jnp.ndarray     # (C, ntaps) f32 previous period taps (FLL delay)
    prev_q: jnp.ndarray     # (C, ntaps) f32
    flagsync: jnp.ndarray   # (C,) bool — nav bit sync achieved (host sets)
    sync_offset: jnp.ndarray  # (C,) int32 — bit-phase offset from host
    active: jnp.ndarray     # (C,) bool — channel is tracking

    @staticmethod
    def init(C: int, ntaps: int) -> "TrackState":
        z = lambda *s: jnp.zeros(s, jnp.float32)
        zi = lambda *s: jnp.zeros(s, jnp.int32)
        return TrackState(
            loc=zi(C), cnt=zi(C),
            remcode=z(C), remcarr=z(C),
            dcarr_acq=z(C), carr_nco=z(C), carr_err=z(C), freq_err=z(C),
            code_nco=z(C), code_err=z(C),
            sum_i=z(C, ntaps), sum_q=z(C, ntaps),
            oldsum_i=z(C, ntaps), oldsum_q=z(C, ntaps),
            prev_i=z(C, ntaps), prev_q=z(C, ntaps),
            flagsync=jnp.zeros(C, bool), sync_offset=zi(C),
            active=jnp.zeros(C, bool),
        )

"""DSP kernel tests: correlation identities against float64 NumPy truth.

These pin the device kernel formulations (precomputed-base NCO, masked
batched correlator, power-of-two FFT correlation) to closed-form DSP
behavior on synthesized signals.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from gnsslib_tpu import codes, sim
from gnsslib_tpu.constants import CodeType, DType
from gnsslib_tpu.ops import (CarrierTables, CodeTables, correlate_taps,
                             fft_correlate_power, lagrange_interp,
                             masked_max, masked_mean, mix_carrier,
                             resample_code, tap_offsets)
from gnsslib_tpu.ops.carrier import carrier_phase
from gnsslib_tpu.ops.fftcorr import code_fft_conj, next_pow2
from gnsslib_tpu.ops.nco import advance_carrier, advance_code, period_samples
from gnsslib_tpu.ops.resample import code_chip_indices
from gnsslib_tpu.ops.stats import exclusion_mask

F_SF = 16.368e6
F_IF = 4.092e6
TI = 1.0 / F_SF
NSAMP = 16368
CLEN = 1023
CRATE = 1.023e6


def test_carrier_phase_matches_f64():
    nwin = NSAMP + 64
    tab = CarrierTables.build(F_IF, TI, nwin, NSAMP)
    d_cps = np.float32(1234.5 * TI)   # 1234.5 Hz residual
    rem = np.float32(0.3)
    ph = np.asarray(carrier_phase(nwin, d_cps, rem, tab))
    i = np.arange(nwin, dtype=np.float64)
    truth = np.mod(F_IF * TI * i + float(d_cps) * i + float(rem), 1.0)
    err = np.abs(ph - truth)
    err = np.minimum(err, 1.0 - err)  # circular
    assert np.max(err) < 2e-5  # cycles


def test_code_indices_match_f64():
    next_ = NSAMP + 64
    smax = 18
    tab = CodeTables.build(CRATE, TI, next_, NSAMP, CLEN)
    dci = np.float32(3.2 * TI)  # 3.2 Hz code-rate offset
    rem = np.float32(-0.01)
    idx = np.asarray(code_chip_indices(next_, rem, dci, smax, tab))
    i = np.arange(next_, dtype=np.float64)
    ci = CRATE * TI + float(dci)
    truth = np.mod(np.floor(float(rem) + (i - smax) * ci), CLEN).astype(int)
    assert np.mean(idx != truth) < 1e-3  # only boundary-straddling samples
    # and those that differ do so by one chip at most
    d = np.abs(idx - truth)
    d = np.minimum(d, CLEN - d)
    assert d.max() <= 1


def test_nco_advance_long_run_precision():
    """Code/carrier remainder recurrences stay glued to f64 over 10k steps."""
    tab_code = CodeTables.build(CRATE, TI, 8, NSAMP, CLEN)
    tab_carr = CarrierTables.build(F_IF, TI, 8, NSAMP)
    dci = np.float32(-2.7 * TI)
    d_cps = np.float32(987.3 * TI)

    from functools import partial

    @partial(jax.jit, static_argnums=0)
    def run(nsteps, rem0, remc0):
        def body(carry, _):
            rem, remc = carry
            n = period_samples(rem, dci, tab_code)
            rem2 = advance_code(rem, dci, n, tab_code)
            remc2 = advance_carrier(remc, d_cps, n, tab_carr)
            return (rem2, remc2), n
        (rem, remc), ns = jax.lax.scan(body, (rem0, remc0),
                                       jnp.arange(nsteps))
        return rem, remc, ns

    rem, remc, ns = run(10000, jnp.float32(0.0), jnp.float32(0.25))
    # float64 truth
    remf, remcf = 0.0, 0.25
    ci = CRATE * TI + float(dci)
    fcps = F_IF * TI + float(d_cps)
    for n in np.asarray(ns):
        remf = remf + n * ci - CLEN
        remcf = np.mod(remcf + n * fcps, 1.0)
    assert abs(float(rem) - remf) < 1e-4          # chips after 10 s
    derr = abs(float(remc) - remcf)
    assert min(derr, 1 - derr) < 1e-3             # cycles after 10 s


def _make_signal(doppler, code_phase, prn=7, nwin=NSAMP + 64, amp=1.0):
    ch = sim.SimChannel(prn=prn, doppler=doppler, code_phase=code_phase,
                        amplitude=amp)
    return sim.synthesize([ch], F_SF, F_IF, DType.REAL, nwin)


def test_correlator_recovers_clean_signal():
    """Prompt power = A*n/2 at the true code phase; E/L symmetric."""
    doppler = 1000.0
    ch_code_phase = 0.0
    data = _make_signal(doppler, ch_code_phase)
    nwin = data.shape[0]
    corrn, corrd = 6, 3
    offsets = tap_offsets(corrn, corrd)
    smax = int(np.max(np.abs(offsets)))

    tab_c = CarrierTables.build(F_IF, TI, nwin, NSAMP)
    tab_k = CodeTables.build(CRATE, TI, nwin + 2 * smax, NSAMP, CLEN)

    code, _ = codes.gencode(7, CodeType.L1CA)
    code_j = jnp.asarray(code)

    # receiver tracks at carrfreq = f_if - D -> d_cps = -D*ti
    d_cps = jnp.float32(-doppler * TI)
    dci = jnp.float32(-doppler / 1.57542e9 * CRATE * TI)
    rem = jnp.float32(0.0)
    n = period_samples(rem, dci, tab_k)

    ph = carrier_phase(nwin, d_cps, jnp.float32(0.0), tab_c)
    mixed = mix_carrier(jnp.asarray(data, jnp.float32), ph)
    idx = code_chip_indices(nwin + 2 * smax, rem, dci, smax, tab_k)
    rcode = resample_code(code_j, idx)
    corr = np.asarray(correlate_taps(mixed, rcode, offsets, smax, n))

    p = corr[0]
    n_f = float(n)
    # prompt I ~ A*n/2, Q ~ 0 (phase aligned)
    assert abs(p.real - 0.5 * n_f) / (0.5 * n_f) < 0.01
    assert abs(p.imag) < 0.02 * n_f
    # early/late pairs symmetric and below prompt
    for k in range(1, corrn + 1):
        e, l = corr[2 * k - 1], corr[2 * k]
        assert abs(e.real) < abs(p.real)
        assert abs(abs(e.real) - abs(l.real)) < 0.05 * abs(p.real)
    # 6-sample (3/8 chip) early tap attenuation ~ (1 - 3/8)
    e2 = corr[2 * 2 - 1].real  # offset -6 samples
    assert abs(e2 / p.real - (1 - 6 / 16.0)) < 0.05


def test_correlator_mask_excludes_tail():
    data = jnp.ones(64, jnp.float32)
    code = jnp.ones(64 + 8, jnp.float32)
    offs = np.array([0], np.int32)
    out = correlate_taps(data.astype(jnp.complex64), code, offs, 4,
                         jnp.int32(10))
    assert np.isclose(np.asarray(out)[0].real, 10.0)


def test_fft_correlate_finds_code_phase():
    """Acquisition-style FFT correlation peaks at the injected code phase."""
    true_codei = 5000  # samples
    code_phase = -true_codei * CRATE / F_SF  # chips: code start delayed
    doppler = -2000.0
    nwin = 2 * NSAMP
    data = _make_signal(doppler, code_phase, prn=3, nwin=nwin)

    nfft = next_pow2(2 * NSAMP)
    code, _ = codes.gencode(3, CodeType.L1CA)
    tab_k = CodeTables.build(CRATE, TI, NSAMP, NSAMP, CLEN)
    idx = code_chip_indices(NSAMP, jnp.float32(0.0), jnp.float32(0.0), 0,
                            tab_k)
    rcode = resample_code(jnp.asarray(code), idx)
    codex = code_fft_conj(rcode, nfft)

    tab_c = CarrierTables.build(F_IF, TI, nwin, NSAMP)
    ph = carrier_phase(nwin, jnp.float32(-doppler * TI), jnp.float32(0.0),
                       tab_c)
    mixed = mix_carrier(jnp.asarray(data, jnp.float32), ph)
    mixed = jnp.pad(mixed, (0, nfft - nwin))
    p = np.asarray(fft_correlate_power(mixed, codex, NSAMP))
    assert int(np.argmax(p)) == true_codei


def test_masked_stats():
    x = jnp.asarray(np.arange(10.0, dtype=np.float32))
    m = exclusion_mask(10, jnp.int32(7), jnp.int32(9))
    v, i = masked_max(x, m)
    assert float(v) == 6.0 and int(i) == 6
    assert np.isclose(float(masked_mean(x, m)), np.mean(np.arange(7.0)))
    # wrapped band: exclude [8..9]+[0..1]
    m2 = exclusion_mask(10, jnp.int32(8), jnp.int32(1))
    v2, i2 = masked_max(x, m2)
    assert float(v2) == 7.0
    assert np.isclose(float(masked_mean(x, m2)), np.mean(np.arange(2.0, 8.0)))


def test_lagrange_interp_cubic_exact():
    x = jnp.asarray(np.arange(10.0))
    y = x ** 3 - 2 * x ** 2 + 5
    for t in (2.5, 4.1, 7.9):
        z = float(lagrange_interp(x, y, jnp.asarray(t)))
        assert abs(z - (t**3 - 2 * t**2 + 5)) < 1e-3

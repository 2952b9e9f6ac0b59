"""FFT-based parallel code-phase correlation (reference cpxconv/pcorrelator,
src/sdrcmn.c:216-251, 723-773).

P(lag) = |IFFT(FFT(mixed_data) · conj(FFT(code)))|² / nfft², batched over
Doppler bins (and channels at the caller).  Differences from the reference:

* nfft is rounded up to a power of two (the reference uses exactly
  2*nsamp, src/sdrinit.c:625).  Both zero-pad beyond the 2*nsamp data, so
  the first nsamp lags — the only ones consumed — are identical linear
  correlations.
* the reference's conj is folded into its multiply loop with an overall
  sign flip (real=-(...)); the sign cancels in |·|², so we use the plain
  conjugate product.
"""
from __future__ import annotations

import jax.numpy as jnp


def next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


def code_fft_conj(code_resampled, nfft: int):
    """conj(FFT(zero-padded resampled code)) — precomputed per channel."""
    n = code_resampled.shape[-1]
    pad = [(0, 0)] * (code_resampled.ndim - 1) + [(0, nfft - n)]
    padded = jnp.pad(code_resampled.astype(jnp.float32), pad)
    return jnp.conj(jnp.fft.fft(padded).astype(jnp.complex64))


def fft_correlate_power(mixed, codex_conj, nout: int):
    """Correlation power over the first ``nout`` lags.

    mixed:      (..., nfft) complex64 zero-padded carrier-wiped data.
    codex_conj: (..., nfft) complex64 conj code spectrum (broadcastable).
    Returns (..., nout) float32, normalized by nfft² like the reference
    (src/sdrcmn.c:244-250).
    """
    nfft = mixed.shape[-1]
    spec = jnp.fft.fft(mixed).astype(jnp.complex64)
    corr = jnp.fft.ifft(spec * codex_conj).astype(jnp.complex64)
    p = (corr.real**2 + corr.imag**2)[..., :nout]
    return (p / (float(nfft) ** 2)).astype(jnp.float32)

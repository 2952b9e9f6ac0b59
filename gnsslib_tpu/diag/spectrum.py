"""IF spectrum and sample-histogram diagnostics.

Reference: src/sdrspec.c — 3-bit sample histogram (calchistgram :170) and
a Welch-style power spectrum from ``SPEC_NLOOP`` random-offset Hanning
windows of ``SPEC_NFFT`` points (spectrumanalyzer :232).  Device compute
(batched FFT on the device), arrays back to the host.
"""
from __future__ import annotations

import numpy as np

from ..constants import SPEC_NFFT, SPEC_NLOOP


def sample_histogram(x: np.ndarray, nbit: int = 3):
    """Histogram of quantized sample values (reference 3-bit view).

    Returns (edges, counts) over the symmetric integer range of nbit.
    """
    lim = 2 ** (nbit - 1)
    edges = np.arange(-lim, lim + 1)
    flat = np.asarray(x, np.float64).ravel()
    counts, _ = np.histogram(np.clip(flat, -lim, lim - 1), bins=edges + 0.0)
    return edges[:-1], counts


def welch_spectrum(x: np.ndarray, f_sf: float, iq: bool = False,
                   nfft: int = SPEC_NFFT, nloop: int = SPEC_NLOOP,
                   seed: int = 0):
    """Averaged Hanning-windowed power spectrum in dB.

    Returns (freq_hz, pspec_db).  Real sampling: [0, f_sf/2); I/Q:
    [-f_sf/2, f_sf/2) (fftshifted), matching the reference's display
    ranges (sdrspec.c:96-101).
    """
    import jax.numpy as jnp

    x = np.asarray(x, np.float32)
    n = x.shape[0]
    if n < nfft:
        raise ValueError("need at least nfft samples")
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, n - nfft + 1, size=nloop)
    if iq:
        w = np.stack([x[o:o + nfft] for o in offs])       # (nloop, nfft, 2)
        wins = jnp.asarray(w)
        data = wins[..., 0] + 1j * wins[..., 1]
    else:
        w = np.stack([x[o:o + nfft] for o in offs])
        data = jnp.asarray(w).astype(jnp.complex64)
    han = jnp.asarray(np.hanning(nfft).astype(np.float32))
    spec = jnp.fft.fft(data * han)
    p = jnp.mean(jnp.abs(spec) ** 2, axis=0)
    p_db = 10.0 * jnp.log10(jnp.maximum(p, 1e-30))
    p_db = np.asarray(p_db)
    if iq:
        p_db = np.fft.fftshift(p_db)
        freq = (np.arange(nfft) - nfft // 2) * (f_sf / nfft)
    else:
        p_db = p_db[:nfft // 2]
        freq = np.arange(nfft // 2) * (f_sf / nfft)
    return freq, p_db

"""Multi-tap E/P/L correlator (the reference's correlator, src/sdrcmn.c:670-722).

The reference computes 1+2*corrn serial int16 dot products per channel per
millisecond.  Here all taps for all channels become one batched contraction
(``einsum``) that XLA tiles onto the matrix units, with the tap-shifted code
replicas taken as static slices of one extended resampled code vector.

Tap order matches the reference (src/sdrcmn.c:712-715, sdrinit.c:442-450):
``[P, E1, L1, E2, L2, ...]`` with E_k at -k*corrd samples and L_k at
+k*corrd samples, so ``ne = 2*i-1`` / ``nl = 2*i`` index the DLL pair.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def tap_offsets(corrn: int, corrd: int) -> np.ndarray:
    """Sample offsets per tap in reference order [P, E1, L1, E2, L2, ...].

    Early taps use code shifted by -k*corrd samples, late by +k*corrd
    (reference: dot with code-s / code+s, src/sdrcmn.c:712-714).
    """
    offs = [0]
    for k in range(1, corrn + 1):
        offs += [-k * corrd, +k * corrd]
    return np.asarray(offs, dtype=np.int32)


def dll_tap_indices(corrn: int, corrd: int, corrp: int) -> tuple[int, int]:
    """(ne, nl) tap indices used by the DLL (reference sdrinit.c:444-450)."""
    k = corrp // corrd
    return 2 * k - 1, 2 * k


def correlate_taps(mixed, code_ext, offsets, smax: int, nvalid):
    """Correlate carrier-wiped data against tap-shifted code replicas.

    mixed:    (..., nwin) complex64 — carrier-wiped samples.
    code_ext: (..., nwin + 2*smax) float32 — resampled code over
              [-smax, nwin+smax).
    offsets:  (ntaps,) int32 static tap offsets in samples.
    nvalid:   scalar int — number of valid samples this period (<= nwin);
              the tail is masked, replacing the reference's per-period
              variable-length buffers with fixed shapes + masking.

    Returns (..., ntaps) complex64 correlation sums.
    """
    nwin = mixed.shape[-1]
    i = jnp.arange(nwin, dtype=jnp.int32)
    masked = jnp.where(i < nvalid, mixed, 0j)
    # static slices: tap t covers code_ext[smax+off : smax+off+nwin]
    reps = jnp.stack(
        [jax_slice(code_ext, smax + int(o), nwin) for o in np.asarray(offsets)],
        axis=-2,
    )  # (..., ntaps, nwin)
    # real-valued contraction: (taps, n) x (n, 2[re,im]) per batch elem,
    # in full float32 (the GPU would otherwise round the carrier-wiped
    # samples to TF32)
    iq = jnp.stack([masked.real, masked.imag], axis=-1)  # (..., nwin, 2)
    out = jnp.einsum("...tn,...nr->...tr", reps, iq,
                     preferred_element_type=jnp.float32,
                     precision=jax.lax.Precision.HIGHEST)
    return jax_complex(out[..., 0], out[..., 1])


def jax_slice(x, start: int, size: int):
    """Static slice along the last axis."""
    return x[..., start:start + size]


def jax_complex(re, im):
    return (re + 1j * im).astype(jnp.complex64)

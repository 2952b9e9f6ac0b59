"""DSP kernel library (the reference's src/sdrcmn.c, redesigned for JAX).

Everything here is pure, jit-able, vmap-able JAX.  The reference's
int16-LUT carrier mixer and serial dot-product correlators become exact
complex rotators and batched einsum contractions that XLA maps onto the
accelerator's matrix units; its FFTW convolution becomes batched power-of-two ``jnp.fft``.

Numerical contract (SURVEY.md §7.3): observables and lock behavior match
the reference within tolerance — not raw correlator bits (the reference
quantizes its carrier to 1/32 LSB; we do not).

Precision design: float32 on device, with every large-magnitude quantity
(cycles of carrier phase, chips of code phase across a block) supplied as a
host-precomputed float64-exact base table plus a small float32 offset, so
no f64 is ever needed on the device.
"""
from .nco import CarrierTables, CodeTables  # noqa: F401
from .carrier import mix_carrier  # noqa: F401
from .resample import resample_code  # noqa: F401
from .correlator import correlate_taps, tap_offsets  # noqa: F401
from .fftcorr import fft_correlate_power  # noqa: F401
from .stats import masked_max, masked_mean, lagrange_interp  # noqa: F401

"""gnsslib_tpu — a JAX-native GNSS software-defined-radio receiver framework.

A ground-up JAX/XLA/Pallas re-design with the capabilities of
erlangnetwork-gnsslib-sdr (GNSS-SDRLIB fork): FFT-based acquisition,
multi-correlator DLL/PLL/FLL closed-loop tracking, navigation-message
decoding (GPS L1CA, GLONASS G1, SBAS L1), and pseudorange / carrier-phase /
Doppler / SNR observable generation with RINEX 3.02 and RTCM3 output.

Architecture (accelerator-first, not a port of the reference's pthread design):

* ``codes``    — PRN ranging-code generators (pure NumPy, precomputed to
                 device arrays).  Reference: src/sdrcode.c.
* ``ops``      — the DSP kernel library: batched carrier wipe-off, code
                 resampling, multi-tap correlators (batched einsum),
                 batched FFT correlation.  Reference: src/sdrcmn.c.
* ``acquire``  — (channel, doppler, code-phase) parallel search with
                 non-coherent integration, jit-compiled & shardable.
                 Reference: src/sdracq.c.
* ``track``    — per-code-period closed loops as ``lax.scan`` over time with
                 a channel-axis state pytree (vmapped channels).
                 Reference: src/sdrtrk.c.
* ``nav``      — bit sync, frame sync, LNAV/GLONASS/SBAS decode, FEC
                 (host-side NumPy/C++: branch-heavy, O(50 bits/s)).
                 Reference: src/sdrnav*.c.
* ``obs``      — epoch-aligned observable formation, RINEX 3.02 writer,
                 RTCM3 encoder, TCP servers.  Reference: src/sdrsync.c,
                 src/sdrout.c.
* ``io``       — front-end HAL: file replay of every supported byte format
                 (int8 IF, RTL-SDR u8, GN3S 1/2/4-bit, STEREO packed),
                 block loader with absolute sample indexing.
                 Reference: src/sdrrcv.c, src/rcv/*.
* ``runtime``  — configuration (INI-compatible), receiver orchestration, CLI.
                 Reference: src/sdrinit.c, src/sdrmain.c.
* ``parallel`` — device meshes, channel/Doppler sharding via shard_map/pjit.
* ``native``   — C++ runtime library (Viterbi27, CRC24Q/32, sample unpack)
                 loaded via ctypes, with NumPy fallbacks.
* ``diag``     — spectrum analyzer, histogram, correlator-shape diagnostics.
                 Reference: src/sdrspec.c, src/sdrplot.c.
"""

__version__ = "0.1.0"

import hashlib as _hashlib
import os as _os
import platform as _platform

import jax as _jax


def _cpu_key() -> str:
    """Host key for the in-checkout cache: XLA:CPU cache entries bake in
    the host's CPU feature set, and an entry written on one machine SIGILLs
    (or error-spams) on another — so the directory is split by a hash of
    the CPU flags."""
    key = _platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    key += "_" + _hashlib.sha1(
                        line.encode()).hexdigest()[:10]
                    break
    except FileNotFoundError:    # pragma: no cover - non-Linux
        pass
    return key


def cache_dir() -> str | None:
    """Persistent XLA compilation-cache directory this package sets.

    None when ``JAX_COMPILATION_CACHE_DIR`` is set: JAX reads that
    variable itself and no other directory is set in code.  Otherwise a
    fixed directory inside the checkout (``.jax_cache/``, git-ignored),
    keyed by the host CPU (see :func:`_cpu_key`)."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    root = _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__)))
    return _os.path.join(root, ".jax_cache", _cpu_key())


# first compiles of the acquisition / tracking programs take seconds to
# minutes; cache them across processes
_cache_dir = cache_dir()
if _cache_dir is not None:
    _jax.config.update("jax_compilation_cache_dir", _cache_dir)
_jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)

from . import constants  # noqa: F401,E402

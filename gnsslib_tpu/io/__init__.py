"""Front-end HAL: file replay of every supported IF byte format.

Reference: src/sdrrcv.c (dispatch + ring buffer) and src/rcv/* (drivers).
Every hardware driver in the reference has a file-replay twin reading the
same byte format (SURVEY.md §4) — that deterministic replay contract is
the part that matters for a post-processing receiver, so the drivers'
sample-format handling is reproduced exactly.  Live capture runs the
vendor CLI as an external grabber process feeding a host ring buffer
(io.live.ProcessFrontend) — the in-process pthread grabber re-expressed
as a process boundary.
"""
from .formats import (unpack_int8, unpack_rtlsdr, unpack_gn3s_v2,
                      unpack_gn3s_v3_2bit, unpack_gn3s_v3_4bit,
                      unpack_stereo_fe1, unpack_stereo_fe2, unpack_bladerf)
from .frontend import FileFrontend, FrontendSpec
from .live import (LiveFrontend, ProcessFrontend, RingView,
                   StreamFrontend, StreamOverrun)
from .bladerf import BladeRfFrontend
from .gn3s import Gn3sFrontend
from .rtlsdr import RtlSdrFrontend
from .stereo import StereoFrontend

__all__ = ["LiveFrontend", "ProcessFrontend", "RingView",
           "StreamFrontend", "StreamOverrun",
           "RtlSdrFrontend", "BladeRfFrontend", "Gn3sFrontend",
           "StereoFrontend",
           "unpack_int8", "unpack_rtlsdr", "unpack_gn3s_v2",
           "unpack_gn3s_v3_2bit", "unpack_gn3s_v3_4bit",
           "unpack_stereo_fe1", "unpack_stereo_fe2", "unpack_bladerf",
           "FileFrontend", "FrontendSpec"]

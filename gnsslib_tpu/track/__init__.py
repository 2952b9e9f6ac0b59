"""Closed-loop code/carrier tracking (the reference's src/sdrtrk.c).

The reference runs one pthread per satellite, each serially correlating
1 ms blocks and updating 2nd-order DLL / 2nd-order PLL + 1st-order FLL
loops.  Here all channels advance in lockstep as one ``lax.scan`` over
code periods with a channel-axis state pytree: correlation is a batched
matrix contraction (ops.correlator), NCO phase carries use the exact
precomputed-base arithmetic (ops.nco), and the variable per-period block
length becomes fixed windows + masking.

The sequential feedback core (remcode/remcarr/carrfreq/codefreq -> next
period, SURVEY.md §3.3) is the scan carry; throughput comes from the
channel batch axis, never from time parallelism.
"""
from .state import TrackConfig, TrackState, LoopParams  # noqa: F401
from .loop import Tracker  # noqa: F401
from .fast import FastTracker  # noqa: F401

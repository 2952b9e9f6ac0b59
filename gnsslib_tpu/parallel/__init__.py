"""Multi-chip scaling: device meshes + channel/Doppler sharding.

Reference parallelism -> device mapping (SURVEY.md §2.4):
* one pthread per satellite channel  -> channel axis sharded over devices
* serial Doppler-bin loop            -> batched on device, shardable axis
* FFTW thread pool                   -> XLA batched FFT
* ring buffer + 5 mutexes            -> pure functional block streaming

Implemented with ``shard_map`` over a named mesh: every device runs the
same single-chip tracking/acquisition program on its channel shard; no
collectives are needed in steady state (channels are independent), and
observable fan-in happens on the host (the sync-thread equivalent).
"""
from .mesh import make_mesh
from .sharded import (ShardedAcquirer, ShardedFastTracker,
                      ShardedTracker)

__all__ = ["make_mesh", "ShardedAcquirer", "ShardedFastTracker",
           "ShardedTracker"]

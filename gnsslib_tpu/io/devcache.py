"""Device-resident IF sample segments.

Shipping every tracking block to the device as float32 would move a
400 ms block as ~26 MB, re-shipped every block (~65 MB per second of
signal at 16.368 Msps).  This cache ships each sample ONCE, in large
segments, in the narrowest dtype that represents the decoded alphabet
exactly:

* int8  — FILE/GN3S/STEREO alphabets (integer, |x| <= 127): 4x smaller
* int16 — BladeRF SC16 (12-bit integers): 2x smaller
* f32   — anything else (RTL-SDR's u8-127.5 half-integers)

Blocks are then cut on-device by one jitted dynamic_slice (+ cast back to
float32, so downstream numerics are bit-identical to the direct path).
The reference's analogue is the 327 MB host ring buffer
(src/sdrrcv.c:207-225); here the ring lives in device memory.
"""
from __future__ import annotations

import concurrent.futures
import functools

import numpy as np

import jax
import jax.numpy as jnp


class DeviceBlockCache:
    """Wraps a frontend's ``read`` with device-segment caching.

    ``get(start, n)`` returns a float32 device array of samples
    [start, start+n) — same values as ``jnp.asarray(frontend.read(...))``.
    ``n`` must not exceed ``seg_len - advance`` headroom; segments are
    re-uploaded as the cursor walks forward.

    With ``prefetch`` (default), the NEXT segment's file read + compress +
    device transfer run on a worker thread, kicked two blocks before the
    current segment runs out — at steady state the upload fully overlaps
    tracking compute instead of stalling the stream every segment.  The
    prefetched segment starts ``block_len`` before the current one ends
    (the earliest possible miss point, since the caller's stride is
    unknown), costing ~1/seg_blocks of duplicate transfer.
    """

    def __init__(self, frontend, block_len: int, seg_blocks: int | None = None,
                 prefetch: bool = True, max_bytes: float = 1.5e9,
                 first_seg_bytes: int = 48 * 1024 * 1024,
                 latency_first: bool = True, stride: int | None = None):
        self.fe = frontend
        self.block_len = int(block_len)
        self._chain_end = None
        self._rungs = None
        self._stride = int(stride) if stride else self.block_len
        if seg_blocks is None:
            # auto: cover the WHOLE stream when it fits the byte budget —
            # post-processing captures (60 s @ 16.368 Msps int8 = 1 GB)
            # then ship exactly once and steady state never transfers
            from ..constants import DType, FrontendType
            spec = getattr(frontend, "spec", None)
            comps = 2 if spec is not None and spec.dtype == DType.IQ else 1
            # raw-int8 fast path only holds for plain FILE streams; assume
            # the worst (float32) for every other decode
            bps = (1 if spec is not None
                   and spec.fend == FrontendType.FILE else 4)
            cap = max(16, int(max_bytes / (bps * comps * self.block_len)))
            total = getattr(frontend, "nsamples", None)
            want = (-(-int(total) // self.block_len) + 1
                    if total else 16)
            seg_blocks = min(cap, max(16, want))
            # LATENCY-FIRST ladder: with the whole-capture auto segment,
            # the first block past the short first segment would wait
            # fut.result() on the ENTIRE remainder upload.  Instead, ship
            # the capture as a chain of uniform ~first_seg_bytes rungs
            # submitted back-to-back on the worker: the link streams at
            # the same total rate, but the cursor waits only for the rung
            # covering ITS block.  Post-processing throughput tools that
            # measure the device-resident steady state pass
            # latency_first=False to keep the single big prefetch out of
            # their measured window (tools/receiver_throughput.py).
            if latency_first and prefetch and total and want <= cap:
                self._chain_end = int(seg_blocks) * self.block_len
        self.seg_len = int(seg_blocks) * self.block_len
        # FIRST segment short (cold start): a whole-capture segment is
        # one giant host->device transfer (327 MB for the 20 s envelope)
        # and the first acquisition's decision vectors would wait for
        # it.  The first segment covers just enough BYTES (~48 MB) to
        # reach lock; the full-size remainder prefetches IMMEDIATELY
        # after (see get()) so it lands during the pull-in phase, before
        # steady state.
        # (sized in samples assuming the dominant int8 decode; a float32
        # stream's first segment is 4x the bytes — still far below a
        # whole capture)
        fl_blocks = max(2, int(first_seg_bytes) // max(1, self.block_len))
        self._first_len = min(int(seg_blocks), fl_blocks) * self.block_len
        self._start = 0
        self._seg = None
        self._cur_len = 0             # length of the current segment
        self._np_dtype = None
        self._exec = (concurrent.futures.ThreadPoolExecutor(1)
                      if prefetch else None)
        self._next = None             # (start, len, Future[device array])

    def _compress(self, x: np.ndarray) -> np.ndarray:
        """Narrowest exact host dtype for the decoded samples.  Checked
        per SEGMENT with monotone widening: a later segment whose values
        exceed the first segment's range (e.g. BladeRF AGC settling)
        widens the dtype instead of silently wrapping.  Widening changes
        the cached array dtype, which just recompiles the tiny _slice
        program once."""
        if x.dtype in (np.int8, np.int16):
            self._np_dtype = x.dtype.type  # raw integer read — already exact
            return x
        order = [np.int8, np.int16, np.float32]
        start = 0 if self._np_dtype is None else \
            order.index(self._np_dtype)
        for dt in order[start:-1]:
            xi = x.astype(dt)
            if np.array_equal(xi.astype(np.float32), x):
                self._np_dtype = dt
                return xi
        self._np_dtype = np.float32
        return x.astype(np.float32, copy=False)

    def _load(self, start: int, length: int):
        read = getattr(self.fe, "read_narrow", self.fe.read)
        x = self._compress(read(start, length))
        # chunked upload with per-chunk fences: 32 MB chunks with a
        # scalar-get fence after each let concurrent device->host reads
        # (telemetry joins, acquisition decisions) interleave at chunk
        # boundaries instead of queueing behind one whole-capture put; a
        # final on-device concat rebuilds the contiguous segment.
        row = x.shape[1] if x.ndim == 2 else 1
        csize = max(1, 32 * 1024 * 1024 // (x.dtype.itemsize * row))
        if x.shape[0] <= csize:
            return jnp.asarray(x)
        chunks = []
        for i in range(0, x.shape[0], csize):
            c = jnp.asarray(x[i:i + csize])
            jax.device_get(c[(0,) * c.ndim])   # fence (see above)
            chunks.append(c)
        return jnp.concatenate(chunks, axis=0)

    def _upload(self, start: int) -> None:
        if self._next is not None:
            nstart, nlen, fut = self._next
            self._next = None
            if nstart <= start and start + self.block_len \
                    <= nstart + nlen:
                self._seg = fut.result()
                self._start = nstart
                self._cur_len = nlen
                return
            fut.cancel() or fut.result()      # drain a useless prefetch
        length = self._first_len if self._seg is None else self.seg_len
        self._seg = self._load(start, length)
        self._start = start
        self._cur_len = length

    @functools.partial(jax.jit, static_argnums=(0,))
    def _slice(self, seg, off):
        w = jax.lax.dynamic_slice_in_dim(seg, off, self.block_len, axis=0)
        return w.astype(jnp.float32)

    def _build_rungs(self, origin: int) -> None:
        """Uniform-rung upload chain over [origin, origin+_chain_end):
        rung length = the first-segment length (>= stride + block_len),
        rung stride = the largest multiple of the caller's block stride
        that keeps every block start covered (overlap = block slack
        only, ~40 KB, when the Receiver passes its true stride).  Rung 0
        loads synchronously; the rest queue on the single worker in
        order, so waiting on rung k's future never waits on k+1."""
        L = max(self._first_len, self._stride + self.block_len)
        K = max(1, (L - self.block_len) // self._stride)
        end = origin + self._chain_end
        rungs, s = [], origin
        while s + self.block_len <= end:
            Li = min(L, end - s)
            rungs.append([s, Li, None])
            if s + Li >= end:
                break
            s += K * self._stride
        rungs[0][2] = self._load(rungs[0][0], rungs[0][1])
        for r in rungs[1:]:
            r[2] = self._exec.submit(self._load, r[0], r[1])
        self._rungs = rungs

    def _get_chain(self, start: int, n: int):
        if self._rungs is None:
            self._build_rungs(start)
        hit = None
        for r in self._rungs:
            if r[0] + r[1] <= start:
                r[2] = "evicted"         # cursor passed: free the rung
            elif hit is None and r[0] <= start and start + n <= r[0] + r[1]:
                hit = r
        if hit is None:                  # seek outside the ladder
            # (checkpoint resume/rewind): rolling fallback
            if self._seg is None or start < self._start or \
                    start + n > self._start + self._cur_len:
                self._seg = self._load(start, self.seg_len)
                self._start, self._cur_len = start, self.seg_len
            return self._slice(self._seg, start - self._start)
        if hit[2] == "evicted":          # revisit after eviction
            hit[2] = self._load(hit[0], hit[1])
        elif isinstance(hit[2], concurrent.futures.Future):
            hit[2] = hit[2].result()
        return self._slice(hit[2], start - hit[0])

    def get(self, start: int, n: int):
        if n != self.block_len:
            raise ValueError(f"block length {n} != {self.block_len}")
        if self._chain_end is not None:
            return self._get_chain(start, n)
        if self._seg is None or start < self._start or \
                start + n > self._start + self._cur_len:
            self._upload(start)
        if self._exec is not None and self._next is None and (
                self._cur_len < self.seg_len
                or start + 3 * self.block_len
                > self._start + self._cur_len):
            # fire immediately while on the short FIRST segment (the big
            # remainder then ships during pull-in, before the steady
            # state the throughput metrics measure); otherwise the
            # earliest possible next miss is one block before the end;
            # skip when the current segment already reaches end-of-stream
            # (the prefetched segment would be EOF zero-pad nobody reads)
            nstart = self._start + self._cur_len - self.block_len
            total = getattr(self.fe, "nsamples", None)
            if total is None or nstart + self.block_len <= total:
                self._next = (nstart, self.seg_len,
                              self._exec.submit(self._load, nstart,
                                                self.seg_len))
        return self._slice(self._seg, start - self._start)

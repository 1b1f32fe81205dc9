"""Paced, arrival-driven replay: the reference's live-sensor semantics.

The reference tracker is driven by sensor arrival with a QUEUE-SIZE-1
subscription (sdf_reconstruction.cpp:89: `nh.subscribe(..., 1,
kinect_callback)`): frames arrive at the sensor rate regardless of
processing speed, and when the callback is still busy every frame but the
newest is DROPPED — the tracker must then bridge the larger inter-frame
motion. The offline runner pulls an iterator at its own pace, which hides
that failure mode; `RealtimePacer` restores it for any indexable dataset.

Semantics: the first ``warmup`` frames (default 2) are delivered un-paced
and exempt from dropping — they carry the jit compiles, like a live
system warming its pipeline before the sensor starts. The arrival clock
then starts with the next frame "arriving now": frame i arrives at wall
time (i - warmup)/hz after that. Each pull yields the NEWEST arrived
frame, counting every older unconsumed frame as dropped (stale); if the
consumer is ahead of the sensor it blocks until the next arrival, exactly
like a callback waiting for data.
"""
from __future__ import annotations

import time


class RealtimePacer:
    """Wrap an indexable dataset in queue-size-1 paced-arrival semantics.

    Attributes after (or during) iteration:
      dropped  — frames skipped because a newer one had already arrived
      yielded  — frames actually delivered
    """

    def __init__(self, dataset, hz: float = 30.0, warmup: int = 2):
        if hz <= 0:
            raise ValueError(f"hz must be positive, got {hz}")
        self._ds = dataset
        self._hz = float(hz)
        # frames delivered un-paced before the arrival clock starts: the
        # first TWO frames' processing carries the jit compiles (fusion
        # on frame 1, tracking on frame 2 — seconds each), which would
        # otherwise expire the
        # whole stream before steady state is ever measured — a live
        # system warms its pipeline before the sensor starts
        self._warmup = max(int(warmup), 0)
        self.dropped = 0
        self.yielded = 0
        # forwarded so --eval keeps working on the wrapped dataset
        self.groundtruth = getattr(dataset, "groundtruth", None)

    def __len__(self):
        return len(self._ds)

    def __iter__(self):
        n = len(self._ds)
        i = 0  # next unconsumed frame index
        while i < min(self._warmup, n):
            self.yielded += 1
            yield self._ds[i]
            i += 1
        t0 = time.perf_counter() - i / self._hz  # frame i arrives NOW
        while i < n:
            elapsed = time.perf_counter() - t0
            latest = min(int(elapsed * self._hz), n - 1)
            if latest < i:
                # consumer ahead of the sensor: block until frame i arrives
                time.sleep(max(i / self._hz - elapsed, 0.0))
                latest = i
            self.dropped += latest - i
            self.yielded += 1
            yield self._ds[latest]
            i = latest + 1


class MultihostRealtimePacer(RealtimePacer):
    """Rank-0-paced arrival clock for a jax.distributed pod (round 5,
    VERDICT r4 item 5).

    Per-rank wall-clock pacers would drop DIFFERENT frames on different
    ranks and desynchronize the replicated SPMD program (mismatched
    collectives = deadlock). Here rank 0 runs the RealtimePacer arrival
    clock (including its sleeps) and BROADCASTS the chosen frame index per
    pull (one tiny host->all collective via
    multihost_utils.broadcast_one_to_all); follower ranks yield exactly
    that frame, so every rank executes the identical frame sequence in
    lockstep. The stream end broadcasts a -1 sentinel. Drop accounting is
    rank-0-AUTHORITATIVE, and followers reconstruct the identical counts
    from the received index gaps (pinned by
    tests/test_multiprocess.py::test_multihost_cli_realtime — identical
    trajectories AND identical drop counts across ranks).

    The reference's semantics under distribution: sdf_reconstruction.cpp:89
    subscribes the live topic with queue size 1 in ONE process; a pod must
    elect one arrival clock, and the sensor-attached rank is the natural
    owner.
    """

    def __init__(self, dataset, hz: float = 30.0, warmup: int = 2):
        super().__init__(dataset, hz=hz, warmup=warmup)
        import jax

        self._rank = jax.process_index()

    def _bcast(self, idx: int) -> int:
        import numpy as np
        from jax.experimental import multihost_utils

        return int(multihost_utils.broadcast_one_to_all(
            np.int32(idx), is_source=self._rank == 0))

    def __iter__(self):
        if self._rank == 0:
            # rank 0: the plain pacer chooses (and sleeps); every chosen
            # index is broadcast before the frame is yielded
            for i, frame in self._paced_indices():
                self._bcast(i)
                yield frame
            self._bcast(-1)
        else:
            prev = -1
            while True:
                idx = self._bcast(0)  # value ignored on non-source ranks
                if idx < 0:
                    return
                # mirror rank-0 accounting from the index stream: frames
                # skipped between consecutive yields were dropped stale
                # (warmup frames are consecutive by construction)
                if prev >= 0:
                    self.dropped += max(idx - prev - 1, 0)
                self.yielded += 1
                prev = idx
                yield self._ds[idx]

    def _paced_indices(self):
        """RealtimePacer.__iter__ with the chosen index exposed."""
        n = len(self._ds)
        i = 0
        while i < min(self._warmup, n):
            self.yielded += 1
            yield i, self._ds[i]
            i += 1
        t0 = time.perf_counter() - i / self._hz
        while i < n:
            elapsed = time.perf_counter() - t0
            latest = min(int(elapsed * self._hz), n - 1)
            if latest < i:
                time.sleep(max(i / self._hz - elapsed, 0.0))
                latest = i
            self.dropped += latest - i
            self.yielded += 1
            yield latest, self._ds[latest]
            i = latest + 1

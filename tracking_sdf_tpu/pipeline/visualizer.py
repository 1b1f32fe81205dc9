"""Async mesh/render publisher — the reference's visualization thread, race-free.

The reference spawns a std::thread that marching-cubes the live grid at 1 Hz
through raw pointers shared with the fusion thread, intentionally racing
after the first frame (sdf_reconstruction.cpp:97, sdf.cpp:317-391,
SURVEY.md §5). Here the same pipeline parallelism is safe by construction:
JAX arrays are immutable, so the publisher thread meshes a SNAPSHOT pytree
reference while the frame loop keeps fusing into new arrays — the functional
replacement for the reference's condvar + atomic shutdown flag.
"""
from __future__ import annotations

import threading
import time
import warnings
from typing import Callable, Optional


class MeshPublisher:
    """Background thread: every `interval` seconds, fetch the latest grid
    snapshot and export a mesh (or call a custom sink).

    Mirrors SDF::visualize's lifecycle: waits for the first fused frame
    (`publish` called at least once), loops at the given rate, exits on
    `close()` (the reference's finish_visualization_thread atomic).

    RATE AUTO-DEGRADE (reported, never silent): when one export takes
    longer than the requested interval (e.g. a 512^3 color mesh is ~9 s —
    1 Hz is arithmetically impossible), the effective interval stretches
    to ``export_seconds * degrade_headroom`` so the publisher never
    queues unboundedly behind the device. The stretch is surfaced via
    ``effective_interval``/``degraded_cycles`` and a one-time warning —
    instead of a silently-late 1 Hz.
    """

    def __init__(
        self,
        export_fn: Callable[[object], None],
        interval: float = 1.0,
        degrade_headroom: float = 1.1,
    ):
        self._export = export_fn
        self.interval = interval
        self.effective_interval = interval
        self.degrade_headroom = degrade_headroom
        self.degraded_cycles = 0
        self._warned = False
        self._snapshot = None
        self._have_data = threading.Event()
        self._stop = threading.Event()
        self._lock = threading.Lock()
        self.published = 0
        self.errors = 0
        self.last_export_s = 0.0
        self.last_error: Optional[Exception] = None
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def publish(self, grid) -> None:
        """Hand the current grid snapshot to the publisher (non-blocking).

        Takes a device COPY: the fusion path donates its input buffers, so a
        bare reference would be invalidated by the next frame ("Array has
        been deleted"). The copy is dispatched asynchronously and costs one
        device-memory pass — the snapshot-render design of SURVEY.md §5, replacing the
        reference's intentionally racy shared pointers (sdf.cpp:47-49)."""
        import jax
        import jax.numpy as jnp

        snap = jax.tree.map(jnp.copy, grid)
        with self._lock:
            self._snapshot = snap
        self._have_data.set()

    def _loop(self) -> None:
        # wait for the first fusion, like the reference's condvar
        # (sdf.cpp:321-323)
        while not self._stop.is_set():
            if self._have_data.wait(timeout=0.1):
                break
        while not self._stop.is_set():
            with self._lock:
                snap = self._snapshot
            if snap is not None:
                t0 = time.perf_counter()
                try:
                    self._export(snap)
                    self.published += 1
                except Exception as e:  # surfaced via .last_error for callers
                    self.errors += 1
                    self.last_error = e
                self.last_export_s = time.perf_counter() - t0
                want = self.last_export_s * self.degrade_headroom
                if want > self.interval:
                    self.degraded_cycles += 1
                    self.effective_interval = want
                    if not self._warned:
                        self._warned = True
                        warnings.warn(
                            f"mesh publisher: export takes "
                            f"{self.last_export_s:.1f} s > requested "
                            f"interval {self.interval:.1f} s; publishing "
                            f"every ~{want:.1f} s instead (see "
                            f"effective_interval / config.mesh_decimate "
                            f"for a coarser, faster live mesh)",
                            RuntimeWarning, stacklevel=2)
                else:
                    self.effective_interval = self.interval
            if self._stop.wait(timeout=self.effective_interval):
                break

    def close(self, final: bool = True) -> None:
        """Stop the thread; optionally publish one final snapshot."""
        self._stop.set()
        self._thread.join(timeout=30.0)
        if self._thread.is_alive():
            # loop thread still mid-export after the timeout: a caller-side
            # final export would race it on the same output path (corrupt
            # interleaved file). Skip — the in-flight export IS the final.
            return
        if final and self._snapshot is not None:
            try:
                self._export(self._snapshot)
                self.published += 1
            except Exception as e:
                self.errors += 1
                self.last_error = e

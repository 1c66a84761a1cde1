"""Async update-hook runner: the reference decouples its render loop
from PNG/preview IO with an mpsc channel + writer thread
(renderer.rs:44, ui_util.rs:13-19 — frames are SENT, never awaited);
the device driver loop gets the same property here so PNG encode /
checkpoint save / preview updates never stall the device between
batches.

Latest-wins coalescing: if the writer is still busy when the next
batch lands, the older pending snapshot is replaced — matching the
reference's behavior where io_on_render_out drains to the newest
frame. The FINAL snapshot is always delivered (close() joins after
flushing), so "stop whenever you're satisfied" still sees the last
complete state.
"""
from __future__ import annotations

import threading

from ..render.target import RenderTarget


class AsyncHook:
    """Wrap a `hook(target)` callable so submissions return
    immediately; the hook runs on a daemon writer thread against a
    snapshot copy of the target (the render loop keeps mutating the
    live accumulator)."""

    def __init__(self, hook):
        self._hook = hook
        self._cond = threading.Condition()
        self._latest = None
        self._closing = False
        self._exc = None
        self._thread = threading.Thread(
            target=self._run, name="rtpu-update-hook", daemon=True
        )
        self._thread.start()

    def __call__(self, target: RenderTarget) -> None:
        snap = RenderTarget(target.width, target.height)
        snap.acc = target.acc.copy()
        snap.count = target.count
        with self._cond:
            self._latest = snap  # latest-wins
            self._cond.notify()

    def _run(self):
        while True:
            with self._cond:
                while self._latest is None and not self._closing:
                    self._cond.wait()
                if self._latest is None:
                    return
                snap, self._latest = self._latest, None
            try:
                self._hook(snap)
            except BaseException as e:  # surfaced at close()
                self._exc = e

    def close(self) -> None:
        """Flush the pending snapshot (if any), stop the thread, and
        re-raise the last hook exception."""
        with self._cond:
            self._closing = True
            self._cond.notify()
        self._thread.join()
        if self._exc is not None:
            raise self._exc

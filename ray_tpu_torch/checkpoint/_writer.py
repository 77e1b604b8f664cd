"""AsyncCheckpointWriter: decouple the device->host snapshot from persistence.

The port's copy of `ray_tpu/checkpoint/_writer.py` (CheckFreq's split): the
step loop pays only for a snapshot — one batch of device-to-host copies and
one synchronisation at the step boundary — while serialization, fsync and
the manifest commit run on a background thread. A bounded in-flight queue
(`INFLIGHT` snapshots, ray_tpu's default) backpressures the step loop
instead of letting host memory grow with unpersisted snapshots. Jobs run in
the order they were saved; a job's failure is raised by the next `save` or
`wait_until_finished`.

The snapshot has to be complete before `save` returns: the port's optimizer
updates parameters and moments in place, so a copy still in flight when the
next step runs would hold a mix of two steps.

Over a mesh every rank's writer snapshots and persists that rank's own
shards and spec; the committing process (rank 0) then waits, on its writer
thread and not the step loop, at most `commit_timeout_s` for every spec
before writing the manifest. A rank that dies mid-save never writes its
spec, the commit times out, and the directory stays garbage.

JAX's writer also reports metrics and trace spans through the runtime's
registry; the port has no runtime yet (ROADMAP.md).
"""

from __future__ import annotations

import queue
import threading
from typing import Optional

from ray_tpu_torch.checkpoint import _format

# Saves snapshotted but not yet persisted before `save` blocks.
INFLIGHT = 2
# How long the committing process waits for every process's spec
# (ray_tpu's train_ckpt_commit_timeout_s).
COMMIT_TIMEOUT_S = 120.0


class AsyncCheckpointWriter:
    """Background sharded-checkpoint writer with a bounded in-flight queue.

    ``save()`` blocks only for the snapshot (and, when the queue is full, for
    backpressure); ``wait_until_finished()`` is the barrier before shutdown or
    before trusting the latest directory to be committed.
    """

    def __init__(self, *, commit_timeout_s: float = COMMIT_TIMEOUT_S):
        self._commit_timeout_s = commit_timeout_s
        self._queue: "queue.Queue[Optional[dict]]" = queue.Queue(maxsize=INFLIGHT)
        self._idle = threading.Event()
        self._idle.set()
        self._lock = threading.Lock()
        self._pending = 0
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None

    # ------------------------------------------------------------------ save

    def save(self, path: str, tree, *, process_index: Optional[int] = None,
             process_count: Optional[int] = None, commit: Optional[bool] = None):
        """Snapshot this process's shards of ``tree`` (one batch of
        device-to-host copies, synchronised before returning) and enqueue
        persistence and, on the committer, the commit.

        The process index and count default to torch.distributed's rank and
        world size; ``commit=None`` commits iff this is process 0. Raises
        any error a PREVIOUS background job hit, so failures surface at the
        next step boundary instead of silently.
        """
        if self.error is not None:
            raise RuntimeError(
                f"previous async checkpoint save failed: {self.error!r}"
            ) from self.error
        me, count = _format._process_args(process_index, process_count)
        encoded, plan = _format.snapshot(tree, process_index=me, process_count=count)
        job = {"path": path, "encoded": encoded, "plan": plan, "process_index": me,
               "process_count": count, "commit": me == 0 if commit is None else commit}
        with self._lock:
            self._pending += 1
            self._idle.clear()
        self._ensure_thread()
        self._queue.put(job)  # blocks when the in-flight budget is exhausted

    # ------------------------------------------------------------ background

    def _ensure_thread(self):
        if self._thread is None or not self._thread.is_alive():
            self._thread = threading.Thread(
                target=self._loop, daemon=True, name="ckpt-writer"
            )
            self._thread.start()

    def _loop(self):
        while True:
            job = self._queue.get()
            if job is None:
                return
            try:
                self._run_job(job)
            except BaseException as e:  # surfaced on the next save()/wait
                self.error = e
            finally:
                # Drop the snapshot now, not when the next job arrives: its
                # pinned host buffers go back to the allocator's cache for
                # the next save.
                job = None
                with self._lock:
                    self._pending -= 1
                    if self._pending == 0:
                        self._idle.set()

    def _run_job(self, job: dict):
        _format.write_snapshot(job["path"], job["encoded"], job["plan"],
                               process_index=job["process_index"])
        if job["commit"]:
            _format.commit(job["path"], process_count=job["process_count"],
                           timeout_s=self._commit_timeout_s)

    # --------------------------------------------------------------- barrier

    def wait_until_finished(self, timeout: Optional[float] = None) -> bool:
        """Block until every enqueued save has been persisted (and committed,
        on the committer).
        Returns False on timeout. Raises if any
        background job failed."""
        done = self._idle.wait(timeout)
        if self.error is not None:
            raise RuntimeError(
                f"async checkpoint save failed: {self.error!r}"
            ) from self.error
        return done

    def shutdown(self, wait: bool = True):
        if wait:
            try:
                self.wait_until_finished()
            except RuntimeError:
                pass  # error already recorded on self.error
        if self._thread is not None and self._thread.is_alive():
            self._queue.put(None)
            self._thread.join(timeout=5.0)
        self._thread = None

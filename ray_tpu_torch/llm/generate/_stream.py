"""TokenStream: the engine-side per-token subscription handle.

`DecodeEngine.open_stream(...)` submits a request and returns one of these
instead of wiring a raw callback: the stream either buffers (token,
finished) pairs for a thread-side consumer (`get()` / iteration) or relays
them to an `on_token` callback (the asyncio-bridge shape LLMServer's
generate_stream uses — no double buffering).

A copy of `ray_tpu/llm/generate/_stream.py` (the port imports nothing of
ray_tpu) without its leaksan book-keeping. Lifecycle contract: every
open_stream resolves through `close()` or `cancel()`. Closing an
unfinished stream CANCELS the underlying request — that is the
mid-stream-disconnect path: the engine frees the slot, releases the prefix
lease and the constraint state within one scheduler iteration, and the
flight record finishes as `cancelled`.

A stalled consumer is bounded: past `llm_stream_buffer_tokens` undelivered
buffered tokens the stream cancels its own request instead of growing host
memory without limit (0 disables the guard).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterator, Optional, Tuple


class StreamClosed(RuntimeError):
    """get() after close()/cancel() on a stream with no buffered items."""


class TokenStream:
    def __init__(self, engine, request_id: str,
                 on_token: Optional[Callable[[int, bool], None]] = None,
                 buffer_cap: Optional[int] = None):
        if buffer_cap is None:
            from ray_tpu_torch._config import CONFIG

            buffer_cap = CONFIG.llm_stream_buffer_tokens
        self.request_id = request_id
        self._engine = engine
        self._on_token = on_token
        self._buffer_cap = max(0, int(buffer_cap))
        self._q: "queue.Queue[Tuple[int, bool]]" = queue.Queue()
        self._finished = threading.Event()
        self._lock = threading.Lock()
        self._closed = False

    # -- engine side (called from the stepper thread / callback paths) ------
    def _push(self, token: int, finished: bool):
        if finished:
            self._finished.set()
        if self._on_token is not None:
            self._on_token(token, finished)
            return
        self._q.put((token, finished))
        if (self._buffer_cap and not finished
                and self._q.qsize() > self._buffer_cap):
            # Consumer stalled past the budget: shed the request rather than
            # buffer unboundedly. cancel() re-enters the engine off the
            # stepper thread only through the pending-cancel set (one
            # lock-guarded set.add), so this is safe from the decode loop.
            self.cancel()

    @property
    def finished(self) -> bool:
        return self._finished.is_set()

    # -- consumer side ------------------------------------------------------
    def get(self, timeout: Optional[float] = None) -> Tuple[int, bool]:
        """Next (token, finished) pair. Cancelled/failed requests surface
        the engine's sentinel pair (-1, True) like every callback consumer."""
        if self._on_token is not None:
            raise RuntimeError("stream is in callback (on_token) mode")
        try:
            return self._q.get(timeout=timeout)
        except queue.Empty:
            raise StreamClosed(
                f"stream {self.request_id} produced nothing within "
                f"{timeout}s"
            )

    def __iter__(self) -> Iterator[int]:
        """Token ids until finish; the end-of-stream sentinel (token < 0)
        is consumed, not yielded. Closes the stream on exhaustion, so a
        plain `for t in engine.open_stream(...)` loop leaks nothing."""
        try:
            while True:
                token, finished = self.get()
                if token >= 0:
                    yield token
                if finished:
                    return
        finally:
            self.close()

    def cancel(self):
        """Cancel the underlying request (idempotent; a finished request is
        a no-op engine-side) and release the subscription."""
        try:
            self._engine.cancel(self.request_id)
        finally:
            self.close()

    def close(self):
        """Release the subscription. An UNFINISHED stream is cancelled —
        close-on-disconnect must free the slot, not orphan it."""
        with self._lock:
            if self._closed:
                return
            self._closed = True
        if not self._finished.is_set():
            try:
                self._engine.cancel(self.request_id)
            except Exception:
                pass  # engine already shut down: the drain freed the slot


__all__ = ["StreamClosed", "TokenStream"]

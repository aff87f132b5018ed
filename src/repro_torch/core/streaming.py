"""Managed streaming: the StreamingObject abstraction.

Producers write at any granularity; the runtime owns buffering, chunking and
readiness signaling. Chunk size is a *runtime-controlled* knob: the
controller modulates it with load, because (paper Fig. 5) fine-grained
streaming overlaps upstream compute with downstream prefill at low load but
preempts active decoding and stalls the pipeline at high load.
"""
from __future__ import annotations

import threading
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, List, Optional


@dataclass
class StreamStats:
    items_written: int = 0
    chunks_flushed: int = 0
    bytes_flushed: int = 0
    items_delivered: int = 0  # made it through the transport (PriorityFlusher)


class StreamingObject:
    """A managed producer->consumer stream.

    The developer writes items (tokens, docs) at any frequency; the runtime
    intercepts and groups them into chunks of ``chunk_size`` before invoking
    the downstream readiness callback. ``chunk_size`` may be changed at any
    time by the controller (communication-granularity management), and the
    request's scheduling priority is propagated to the transport: chunks
    from low-slack requests are flushed ahead of others sharing the link
    (paper §3.3.2, priority-aware queuing at the network layer).
    """

    def __init__(self, chunk_size: int = 16, item_bytes: int = 4,
                 priority: float = 0.0):
        self.priority = priority
        self._buf: deque = deque()
        self._chunks: deque = deque()
        self._chunk_size = chunk_size
        self._item_bytes = item_bytes
        self._closed = False
        self._lock = threading.Lock()
        self._on_chunk: Optional[Callable[[List[Any]], None]] = None
        self.stats = StreamStats()

    # ------------------------------------------------------------- producer
    def write(self, item: Any):
        with self._lock:
            if self._closed:
                raise ValueError("stream closed")
            self._buf.append(item)
            self.stats.items_written += 1
            if len(self._buf) >= self._chunk_size:
                self._flush_locked()

    def close(self):
        with self._lock:
            if self._buf:
                self._flush_locked()
            self._closed = True
            if self._on_chunk:
                self._on_chunk(None)  # EOS signal

    def _flush_locked(self):
        chunk = list(self._buf)
        self._buf.clear()
        self.stats.chunks_flushed += 1
        self.stats.bytes_flushed += len(chunk) * self._item_bytes
        if self._on_chunk:
            self._on_chunk(chunk)
        else:
            self._chunks.append(chunk)

    # ------------------------------------------------------------- consumer
    def on_chunk(self, cb: Callable[[Optional[List[Any]]], None]):
        self._on_chunk = cb

    def read_chunks(self) -> List[List[Any]]:
        with self._lock:
            out = list(self._chunks)
            self._chunks.clear()
            return out

    @property
    def closed(self) -> bool:
        return self._closed

    # ------------------------------------------------------------ controller
    def set_chunk_size(self, n: int):
        """Called by the runtime controller, never by application code."""
        with self._lock:
            self._chunk_size = max(1, int(n))

    @property
    def chunk_size(self) -> int:
        return self._chunk_size


class PriorityFlusher:
    """Shared-link transport: flushes buffered chunks from many streams in
    priority order (least slack first), FIFO within a priority level."""

    def __init__(self):
        self._pending = []  # (priority, seq, stream, chunk, deliver_cb)
        self._seq = 0

    def submit(self, stream: "StreamingObject", chunk, deliver_cb):
        self._pending.append(
            (stream.priority, self._seq, stream, chunk, deliver_cb))
        self._seq += 1

    def flush(self, n: int = None):
        """Deliver up to n chunks in (priority, arrival) order."""
        self._pending.sort(key=lambda t: (t[0], t[1]))
        n = len(self._pending) if n is None else n
        out, self._pending = self._pending[:n], self._pending[n:]
        for _, _, stream, chunk, cb in out:
            cb(chunk)
            if chunk is not None:
                stream.stats.items_delivered += len(chunk)
        return len(out)

    @property
    def backlog(self) -> int:
        return len(self._pending)


def streaming_chunk_policy(load_fraction: float, min_chunk: int = 4, max_chunk: int = 128) -> int:
    """Load-dependent chunk size (profiled policy, paper §3.3.1): stream
    fine-grained at low load (overlap prefill), coarse at high load (avoid
    preempting active decode)."""
    load_fraction = min(max(load_fraction, 0.0), 1.0)
    # geometric interpolation between min and max chunk
    import math

    log_c = math.log(min_chunk) + load_fraction * (math.log(max_chunk) - math.log(min_chunk))
    return int(round(math.exp(log_c)))

"""In-process publish/subscribe message bus (the MQTT/Mosquitto analogue).

Topic-based, synchronous delivery, MQTT-style trailing '#' wildcard —
enough to mirror the paper's control plane (parameter updates, task
dispatch, results, and the serving layer's alert/health stream) without a
broker dependency.

The '#' wildcard is segment-anchored, as in MQTT: ``edges/#`` matches
``edges`` and ``edges/3/queue`` but never ``edges9/queue`` — a trailing
``#`` only ever swallows whole ``/``-separated segments, so a pattern like
``edges#`` cannot prefix-match across the separator into a sibling
namespace.
"""
from __future__ import annotations

import fnmatch
from typing import Any, Callable, Dict, List, Tuple

Handler = Callable[[str, Any], None]


class Bus:
    def __init__(self) -> None:
        self._subs: List[Tuple[str, Handler]] = []
        self.delivered = 0
        self.published_bytes = 0

    def subscribe(self, pattern: str, handler: Handler) -> None:
        self._subs.append((pattern, handler))

    def unsubscribe(self, pattern: str, handler: Handler) -> bool:
        """Drop one (pattern, handler) subscription; True if it existed.

        Safe to call from inside a handler mid-delivery: ``publish``
        iterates a snapshot, so the in-flight delivery completes (the
        leaving handler may still see the current publication) and every
        later publish skips it."""
        try:
            self._subs.remove((pattern, handler))
            return True
        except ValueError:
            return False

    def publish(self, topic: str, payload: Any, nbytes: int = 0) -> int:
        """Deliver to all matching subscribers; returns delivery count."""
        self.published_bytes += nbytes
        n = 0
        for pattern, handler in list(self._subs):
            if _match(pattern, topic):
                handler(topic, payload)
                n += 1
        self.delivered += n
        return n


def _match(pattern: str, topic: str) -> bool:
    if pattern.endswith("#"):
        # MQTT semantics: '#' stands for "this segment and everything
        # below it", so it must sit on a topic-segment boundary.  The
        # prefix before it (sans its trailing '/') must equal the topic
        # or be a whole-segment prefix of it: "edges/#" matches "edges"
        # and "edges/3/q" but NOT "edges9/q".
        prefix = pattern[:-1].rstrip("/")
        return topic == prefix or topic.startswith(prefix + "/") \
            if prefix else True
    return fnmatch.fnmatch(topic, pattern)


class FifoLink:
    """Shared FIFO uplink: concurrent transfers serialize (the WAN model
    whose saturation reproduces cloud-only's latency, Table II)."""

    def __init__(self, MBps: float, rtt_s: float = 0.0) -> None:
        self.MBps = MBps
        self.rtt_s = rtt_s
        self.free_at = 0.0

    def send(self, t: float, nbytes: int) -> float:
        """Start a transfer at ``t``; returns its delivery time."""
        start = max(t, self.free_at)
        self.free_at = start + nbytes / (self.MBps * 1e6)
        return self.free_at + self.rtt_s

    def backlog(self, t: float) -> float:
        """Seconds of queued transfers ahead of a new send at ``t``."""
        return max(0.0, self.free_at - t)


class ParamDB:
    """Replicated parameter store (the SQLite analogue).

    Every write publishes on 'params/<key>'; every node holds the same view
    (synchronous replication — the paper's update-triggers-update semantics).
    """

    def __init__(self, bus: Bus) -> None:
        self._bus = bus
        self._store: Dict[str, Any] = {}
        self.writes = 0

    def put(self, key: str, value: Any) -> None:
        self._store[key] = value
        self.writes += 1
        self._bus.publish(f"params/{key}", value, nbytes=8)

    def get(self, key: str, default: Any = None) -> Any:
        return self._store.get(key, default)

    def snapshot(self) -> Dict[str, Any]:
        return dict(self._store)

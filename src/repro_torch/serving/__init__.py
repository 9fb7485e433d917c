"""Serving layer: message bus and links, admission control, alerts, the
asyncio driver (``engine``), the ``Item`` detection record and the legacy
``CloudEdgeSim`` (``simulator``), and the trained, scored detection
stream (``workload``)."""

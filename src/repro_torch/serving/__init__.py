"""Serving layer: message bus and links, admission control, alerts, the
asyncio driver (``engine``) and the ``Item`` detection record."""

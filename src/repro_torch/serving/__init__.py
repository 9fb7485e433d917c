"""Serving layer: message bus and links, admission control, alerts, and
the ``Item`` detection record."""

"""Sharding rules for device meshes (``sharding``), int8 serving weights
and the numpy int8 wire codec for WAN-downlink shipments (``quantize``)."""

"""The numpy int8 wire codec for WAN-downlink shipments."""

"""Host-side utilities of the port: the metrics registry."""

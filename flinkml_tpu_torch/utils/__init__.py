"""Host-side utilities of the port: the metrics registry and the row
reservoir of the streamed fits."""

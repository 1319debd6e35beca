"""Host utilities of the port: stage timers and padding buckets."""

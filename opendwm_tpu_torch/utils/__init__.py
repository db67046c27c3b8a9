"""Host utilities of the port (the bucket sampler)."""

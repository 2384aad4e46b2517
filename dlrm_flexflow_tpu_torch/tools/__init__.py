"""Timing and A/B tools of the port, for a CUDA card; run each by its path."""

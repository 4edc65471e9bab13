"""Verification tools: virtual instances (mismatch realisations),
playback co-simulation and its first-divergence locator."""

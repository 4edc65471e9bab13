"""Verification tools: virtual instances (mismatch realisations)."""

"""Helpers of the port that sit beside its layers (timing)."""

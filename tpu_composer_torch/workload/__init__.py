"""Slice qualification and the resumable training loop."""

"""Parameter conversion helpers."""

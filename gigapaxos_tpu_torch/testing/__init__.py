"""Test-support planes of the port (storage fault injection)."""

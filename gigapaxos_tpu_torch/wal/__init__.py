"""Write-ahead logging and recovery (host-side persistence layer)."""

from .logger import PaxosLogger, recover

__all__ = ["PaxosLogger", "recover"]

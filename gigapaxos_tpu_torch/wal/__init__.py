"""Write-ahead logging and recovery (host-side persistence layer)."""

from .chain_logger import ChainLogger, recover_chain
from .logger import PaxosLogger, recover

__all__ = ["ChainLogger", "PaxosLogger", "recover", "recover_chain"]

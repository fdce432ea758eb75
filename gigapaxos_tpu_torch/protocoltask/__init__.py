from .executor import ProtocolExecutor, ProtocolTask, ThresholdProtocolTask

__all__ = ["ProtocolExecutor", "ProtocolTask", "ThresholdProtocolTask"]

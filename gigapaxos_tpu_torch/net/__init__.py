from .messenger import Messenger, NodeMap
from .transport import JsonDemux, Transport

__all__ = ["Messenger", "NodeMap", "JsonDemux", "Transport"]

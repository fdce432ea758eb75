"""Test-support planes of the port: storage fault injection, the capacity
probe and the open-loop harness."""

from .capacity import CapacityProbe, ProbeResult, make_loopback_cluster

__all__ = ["CapacityProbe", "ProbeResult", "make_loopback_cluster"]

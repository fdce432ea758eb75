"""Device selection for the port's entry points.

Every entry point (``paxos.state.init_state``, ``paxos.manager.PaxosManager``,
the tick helpers that allocate) runs on the GPU unless the caller asks for
the CPU.  There is no silent fallback: asking for CUDA on a host without a
usable card raises.

:func:`serial_on_cpu` is the lock a tick program holds while it runs.  On
the CPU an eager program (the Mode B and chain ticks) is hundreds of small
ops, each of which drops and retakes the interpreter lock; several planes
ticking on threads of one process (a server's active and RC planes, a
cluster, a test's six servers) then hand that lock back and forth at every
op and each tick takes many times its time alone.  One program at a time
runs them back to back instead.  (The Paxos tick runs as one TorchScript
program, ``ops.tick.paxos_tick_health``, which drops the interpreter lock
once.)  On CUDA a program only queues launches, and takes no lock.
"""

from __future__ import annotations

import contextlib
import threading

import torch

#: held by the one CPU tick program running in this process
_CPU_PROGRAM = threading.RLock()


def resolve_device(device=None) -> torch.device:
    """``None`` means ``"cuda"``; a CUDA request without a card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "port on the CPU"
        )
    return dev


def serial_on_cpu(dev: torch.device):
    """The context a tick program on ``dev`` runs in: the process-wide
    CPU program lock, or nothing on CUDA."""
    return _CPU_PROGRAM if dev.type == "cpu" else contextlib.nullcontext()

"""Ring-buffer window primitives for ``[..., W, G]`` tensors (G = minor axis).

Each group owns a fixed ring of W slots: slot ``s`` lives at ring plane
``s & (W-1)`` (the second-to-last axis) and an entry is valid only for slots
in ``[exec_slot, exec_slot + W)``.  In-order extraction becomes a
leading-run count over the reordered window.  G stays the minor axis so
that neighbouring CUDA threads touch neighbouring groups and every load is
coalesced.

``gather_planes``, ``match_planes`` and their ``_many`` forms are
dispatchers: a CUDA tensor goes to the hand-written kernel in
``ops/plane_gather.py``, a CPU tensor to its plain version.  The ``_many``
forms take several arrays that share one index, which one kernel launch
then reads once for all of them; the tick calls only those, through
:func:`tick_gather` / :func:`tick_match`, which a scripted tick calls back
in Python.
"""

from typing import List

import torch

from . import plane_gather


def ring_index(slots, window: int):
    """Ring index for (possibly wrapped) int32 slot numbers. W power of two."""
    return torch.bitwise_and(slots.to(torch.int32), window - 1)


def window_slots(exec_slot, window: int):
    """Absolute slots covered by each group's window, in window order:
    ``exec_slot`` ``[..., G]`` -> ``[..., W, G]`` with plane j holding
    exec_slot + j."""
    ar = torch.arange(window, dtype=torch.int32, device=exec_slot.device)
    return exec_slot.unsqueeze(-2) + ar[:, None]


def in_window(slots, exec_slot, window: int):
    """True where ``slots`` (``[..., W, G]``) fall inside
    [exec_slot, exec_slot+W) for their group (wraparound-aware)."""
    d = (slots - exec_slot.unsqueeze(-2)).to(torch.int32)
    return (d >= 0) & (d < window)


def leading_run(valid):
    """Number of leading True along the plane (second-to-last) axis:
    bool ``[..., W, G]`` -> int32 ``[..., G]``."""
    run = torch.cumprod(valid.to(torch.int32), dim=-2, dtype=torch.int32)
    return run.sum(dim=-2, dtype=torch.int32)


def gather_planes(arr, idx):
    """``out[..., j, g] = arr[..., idx[..., j, g], g]`` along the plane axis.

    ``arr``: ``[..., Wp, G]``; ``idx``: ``[J, G]`` (shared by every leading
    index) or ``[..., J, G]`` (one per leading index), int32 in [0, Wp).
    Out-of-range indices give 0."""
    if arr.device.type == "cpu":
        return plane_gather.gather_planes_plain(arr, idx)
    return plane_gather.gather_planes_cuda(arr, idx)


def match_planes(vals, keys, idx):
    """Per-lane key-match select: ``out[j, g] = vals[e, g]`` for the entry
    ``e`` with ``keys[e, g] == idx[j, g]``, 0 when no entry matches; on
    duplicate keys the highest ``e`` wins."""
    if vals.device.type == "cpu":
        return plane_gather.match_planes_plain(vals, keys, idx)
    return plane_gather.match_planes_cuda(vals, keys, idx)


def gather_planes_many(arrs, idx):
    """:func:`gather_planes` of each of ``arrs`` (one shape, int32 or bool,
    at most 8 on CUDA) with one shared ``idx``, as a tuple."""
    if arrs[0].device.type == "cpu":
        return plane_gather.gather_planes_many_plain(arrs, idx)
    return plane_gather.gather_planes_many_cuda(arrs, idx)


def match_planes_many(vals_list, keys, idx):
    """:func:`match_planes` of each of ``vals_list`` (one shape, at most 4 on
    CUDA) with shared ``keys`` and ``idx``, as a tuple."""
    if vals_list[0].device.type == "cpu":
        return plane_gather.match_planes_many_plain(vals_list, keys, idx)
    return plane_gather.match_planes_many_cuda(vals_list, keys, idx)


@torch.jit.ignore
def tick_gather(arrs: List[torch.Tensor],
                idx: torch.Tensor) -> List[torch.Tensor]:
    """The tick's gather call: :func:`gather_planes_many`, looked up at
    each call.  A scripted tick calls it back in Python
    (``torch.jit.ignore``), the one place its program retakes the
    interpreter lock."""
    return list(gather_planes_many(arrs, idx))


@torch.jit.ignore
def tick_match(vals_list: List[torch.Tensor], keys: torch.Tensor,
               idx: torch.Tensor) -> List[torch.Tensor]:
    """The tick's match call: :func:`match_planes_many`, as
    :func:`tick_gather`."""
    return list(match_planes_many(vals_list, keys, idx))


def clear_below(arr, slot_of_entry, watermark, fill):
    """Replace ring entries whose slot is below ``watermark`` by ``fill``.

    ``arr``: payload ``[..., W, G]``; ``slot_of_entry``: the absolute slot
    each ring entry claims to hold ``[..., W, G]``; ``watermark``: ``[..., G]``.
    """
    stale = (slot_of_entry - watermark.unsqueeze(-2)).to(torch.int32) < 0
    return torch.where(stale, torch.as_tensor(fill, dtype=arr.dtype,
                                              device=arr.device), arr)

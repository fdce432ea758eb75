"""The two plane-select kernels of the tick: wrappers, plain versions and
launch counters.

Counterpart of the reference's ``ops/pallas_gather.py``.  The kernels are
hand-written CUDA C++ for Hopper (``csrc/plane_gather.cu``, built by
``ops/cuda_build.py``):

* :func:`gather_planes_many_cuda` — ``out_k[l, j, g] = arr_k[l, idx[(l,)
  j, g], g]`` for up to 8 arrays that share one index, in one launch: the
  ring-window plane gather (5 launches per tick);
* :func:`match_planes_many_cuda` — ``out_k[j, g] = vals_k[e, g]`` for the
  ``e`` with ``keys[e, g] == idx[j, g]`` (highest ``e`` wins), else 0, for
  up to 4 vals arrays that share keys and index: the intake key-match
  select (1 launch per tick).

:func:`gather_planes_cuda` and :func:`match_planes_cuda` are their one-array
case.  ``ops/window.py`` dispatches on the tensor's device: CPU tensors go
to the plain PyTorch versions (one ``torch.gather`` along the plane axis;
the match finds its entries first), CUDA tensors to the kernel wrapper,
which launches or raises.  There is no fallback between the two.  Each
launch adds one to ``launches[name]``, however many arrays it carries.
"""

import ctypes
import functools
import math
import threading
import warnings
from typing import List, Sequence, Tuple

import torch

from . import cuda_build

#: kernel launches since the last :func:`reset_launches` (CUDA path only)
launches = {"gather_planes": 0, "match_planes": 0}
#: the planes of one cluster tick on threads of their own
_launches_lock = threading.Lock()

#: element size in bytes of each dtype the kernels take
KERNEL_DTYPES = {torch.int32: 4, torch.bool: 1}

#: most plane (gather) or output-row (match) count the kernels take
MAX_PLANES = 32
#: most arrays one gather launch takes, and vals arrays one match launch
MAX_GATHER, MAX_MATCH = 8, 4
#: lanes a kernel thread moves at once (a 16-byte int32 vector)
LANES_PER_THREAD = 4
#: most lanes the kernels take (the gather's offsets within one leading
#: index stay in int32)
MAX_LANES = (2**31 - 1) // MAX_PLANES


def reset_launches() -> None:
    with _launches_lock:
        for k in launches:
            launches[k] = 0


@functools.lru_cache(maxsize=None)
def _lib():
    """The built library with its C signatures declared (pointers and the
    stream as ``c_void_p``, so ctypes never truncates them)."""
    lib = cuda_build.library("plane_gather")
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    pp, ip = ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int)
    lib.gp_gather_planes.argtypes = [pp, pp, ip, i32, p, i64, i32, i32, i64,
                                     i32, i32, p]
    lib.gp_gather_planes.restype = i32
    lib.gp_match_planes.argtypes = [pp, pp, ip, i32, p, p, i32, i32, i64,
                                    i32, p]
    lib.gp_match_planes.restype = i32
    return lib


def _check(t: torch.Tensor, what: str, dev: torch.device, dtypes) -> None:
    if t.device != dev:
        raise ValueError(f"{what} is on {t.device}, expected {dev}")
    if t.dtype not in dtypes:
        raise TypeError(f"{what} has dtype {t.dtype}; the kernel takes "
                        f"{sorted(str(d) for d in dtypes)}")
    if not t.is_contiguous():
        raise ValueError(f"{what} must be contiguous")


def _arrays(arrs: Sequence[torch.Tensor], what: str, most: int,
            dev_of: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """``arrs`` as a tuple of 1..``most`` contiguous int32/bool tensors of one
    shape on one CUDA device; raises on anything else."""
    arrs = tuple(arrs)
    if not 1 <= len(arrs) <= most:
        raise ValueError(f"{len(arrs)} {what} arrays; one launch takes "
                         f"1 to {most}")
    dev = dev_of.device
    if dev.type != "cuda":
        raise ValueError(f"the kernels need CUDA tensors, got {dev}")
    for n, a in enumerate(arrs):
        _check(a, f"{what}[{n}]", dev, KERNEL_DTYPES)
        if a.shape != arrs[0].shape:
            raise ValueError(f"{what}[{n}] has shape {tuple(a.shape)}, "
                             f"{what}[0] {tuple(arrs[0].shape)}: one launch "
                             "takes arrays of one shape")
    return arrs


def _vec_ok(g: int, tensors) -> bool:
    """Whether every row of every tensor starts on a whole lane quad (16
    bytes of int32, 4 of bool), so the kernel may move quads as vectors."""
    return g % LANES_PER_THREAD == 0 and all(
        t.data_ptr() % (t.element_size() * LANES_PER_THREAD) == 0
        for t in tensors)


def _launch(fn, name: str, arrs, outs, *args) -> None:
    k = len(arrs)
    ins = (ctypes.c_void_p * k)(*(a.data_ptr() for a in arrs))
    ous = (ctypes.c_void_p * k)(*(o.data_ptr() for o in outs))
    elem = (ctypes.c_int * k)(*(KERNEL_DTYPES[a.dtype] for a in arrs))
    dev = outs[0].device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(ins, ous, elem, k, *args, stream)
    if rc != 0:
        raise RuntimeError(f"gp_{name} launch failed (code {rc})")
    with _launches_lock:
        launches[name] += 1


# ----------------------------------------------------------- gather_planes

def _lead_of(arr_lead: List[int], idx: torch.Tensor) -> List[int]:
    """The output's leading shape: ``arr``'s, broadcast with a per-lead
    index's."""
    if idx.dim() == 2:
        return arr_lead
    il = idx.shape[:-2]
    if il == arr_lead:
        return arr_lead
    n = max(len(il), len(arr_lead))
    a = [1] * (n - len(arr_lead)) + arr_lead
    b = [1] * (n - len(il)) + il
    return [a[i] if b[i] == 1 else b[i] for i in range(n)]


def _take_many(arrs: List[torch.Tensor], idx: torch.Tensor
               ) -> List[torch.Tensor]:
    """``out[..., j, g] = arr[..., idx[..., j, g], g]`` of each array, by
    one ``torch.gather`` along the plane axis, 0 where the index is out of
    range (the index broadcast and masked once)."""
    arr0 = arrs[0]
    wp = arr0.shape[-2]
    lead = _lead_of(arr0.shape[:-2], idx)
    shape = lead + idx.shape[-2:]
    bad = (idx < 0) | (idx >= wp)
    any_bad = bool(bad.any())
    ix = idx.masked_fill(bad, 0) if any_bad else idx
    ix = ix.to(torch.int64).expand(shape)
    outs: List[torch.Tensor] = []
    for a in arrs:
        if a.shape[:-2] != lead:
            a = a.expand(lead + a.shape[-2:])
        out = torch.gather(a, -2, ix)
        if any_bad:
            out = out.masked_fill(bad.expand(shape), 0)
        outs.append(out)
    return outs


def _match_many(vals_list: List[torch.Tensor], keys: torch.Tensor,
                idx: torch.Tensor) -> List[torch.Tensor]:
    """The highest entry ``e`` with ``keys[..., e, g] == idx[j, g]`` per
    output lane, then a gather of each vals array at it."""
    v0 = vals_list[0]
    if v0.shape[-2] == 0:
        return [torch.zeros(v.shape[:-2] + idx.shape[-2:], dtype=v.dtype,
                            device=v.device) for v in vals_list]
    e = keys.shape[-2]
    hit = keys.unsqueeze(-3) == idx.unsqueeze(-2)           # [..., J, E, G]
    ent = torch.arange(e, dtype=torch.int32, device=keys.device)[:, None]
    return _take_many(vals_list, torch.where(hit, ent, -1).amax(dim=-2))


_scripted = {}
_scripted_lock = threading.Lock()


def _script(fn):
    """``fn`` compiled by TorchScript once a process: a plain version is
    then one call that drops the interpreter lock once, not one drop per
    op (the ticks call it back from their own scripted programs)."""
    with _scripted_lock:
        if fn.__name__ not in _scripted:
            with warnings.catch_warnings():
                # torch.jit.script warns of its deprecation at each call
                warnings.simplefilter("ignore", DeprecationWarning)
                _scripted[fn.__name__] = torch.jit.script(fn)
        return _scripted[fn.__name__]


def gather_planes_plain(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Plain version: one ``torch.gather`` along the plane axis, 0 where
    the index is out of range."""
    return gather_planes_many_plain((arr,), idx)[0]


def gather_planes_many_plain(arrs: Sequence[torch.Tensor],
                             idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of the fused gather: :func:`gather_planes_plain` of
    each array, the index prepared once, as one scripted call."""
    with torch.jit.optimized_execution(False):
        return tuple(_script(_take_many)(list(arrs), idx))


def gather_planes_many_cuda(arrs: Sequence[torch.Tensor],
                            idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch ``gp_gather_planes`` once for 1..8 arrays of one shape
    ``[..., Wp, G]`` (int32 or bool, mixed) that share ``idx``: ``[J, G]``
    (shared by every leading index) or ``arr.shape[:-2] + (J, G)`` (per
    lead).  Returns one ``[..., J, G]`` output per array."""
    arrs = _arrays(arrs, "arrs", MAX_GATHER, idx)
    dev = idx.device
    _check(idx, "idx", dev, (torch.int32,))
    arr = arrs[0]
    if arr.dim() < 2 or idx.dim() < 2:
        raise ValueError("arr and idx need a plane and a lane axis")
    lead_shape = tuple(arr.shape[:-2])
    wp, g = arr.shape[-2:]
    j = idx.shape[-2]
    if idx.shape[-1] != g:
        raise ValueError(f"idx lanes {idx.shape[-1]} != arr lanes {g}")
    if idx.dim() == 2:
        perlead = 0
    elif tuple(idx.shape[:-2]) == lead_shape:
        perlead = 1
    else:
        raise ValueError(f"idx shape {tuple(idx.shape)} is neither [J, G] "
                         f"nor {lead_shape} + [J, G]")
    if not 1 <= wp <= MAX_PLANES or g > MAX_LANES:
        raise ValueError(f"unsupported shape: Wp={wp}, G={g}")
    outs = tuple(torch.empty(lead_shape + (j, g), dtype=a.dtype, device=dev)
                 for a in arrs)
    if outs[0].numel() == 0:
        return outs
    vec = _vec_ok(g, (*arrs, *outs, idx))
    _launch(_lib().gp_gather_planes, "gather_planes", arrs, outs,
            idx.data_ptr(), math.prod(lead_shape), wp, j, g, perlead,
            int(vec))
    return outs


def gather_planes_cuda(arr: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The one-array case of :func:`gather_planes_many_cuda`."""
    return gather_planes_many_cuda((arr,), idx)[0]


# ------------------------------------------------------------ match_planes

def match_planes_plain(vals: torch.Tensor, keys: torch.Tensor,
                       idx: torch.Tensor) -> torch.Tensor:
    """Plain version: the highest matching entry per output lane, then a
    gather of ``vals`` at it."""
    return match_planes_many_plain((vals,), keys, idx)[0]


def match_planes_many_plain(vals_list: Sequence[torch.Tensor],
                            keys: torch.Tensor,
                            idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Plain version of the fused match: :func:`match_planes_plain` of each
    vals array, the matching entries found once, as one scripted call."""
    with torch.jit.optimized_execution(False):
        return tuple(_script(_match_many)(list(vals_list), keys, idx))


def match_planes_many_cuda(vals_list: Sequence[torch.Tensor],
                           keys: torch.Tensor,
                           idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """Launch ``gp_match_planes`` once for 1..4 vals arrays ``[E, G]``
    (int32 or bool, mixed) that share ``keys`` ``[E, G]`` and ``idx``
    ``[J, G]`` with J <= 32.  Returns one ``[J, G]`` output per array."""
    vals_list = _arrays(vals_list, "vals", MAX_MATCH, idx)
    dev = idx.device
    _check(keys, "keys", dev, (torch.int32,))
    _check(idx, "idx", dev, (torch.int32,))
    vals = vals_list[0]
    if vals.dim() != 2 or keys.shape != vals.shape or idx.dim() != 2:
        raise ValueError(f"shapes vals {tuple(vals.shape)}, keys "
                         f"{tuple(keys.shape)}, idx {tuple(idx.shape)}: "
                         "need [E, G], [E, G], [J, G]")
    e, g = vals.shape
    j = idx.shape[0]
    if idx.shape[1] != g or not 1 <= j <= MAX_PLANES:
        raise ValueError(f"unsupported idx shape {tuple(idx.shape)}")
    if g > MAX_LANES:
        raise ValueError(f"unsupported lane count G={g}")
    outs = tuple(torch.empty((j, g), dtype=v.dtype, device=dev)
                 for v in vals_list)
    if outs[0].numel() == 0:
        return outs
    if e == 0:
        return tuple(o.zero_() for o in outs)
    vec = _vec_ok(g, (*vals_list, *outs, keys, idx))
    _launch(_lib().gp_match_planes, "match_planes", vals_list, outs,
            keys.data_ptr(), idx.data_ptr(), e, j, g, int(vec))
    return outs


def match_planes_cuda(vals: torch.Tensor, keys: torch.Tensor,
                      idx: torch.Tensor) -> torch.Tensor:
    """The one-array case of :func:`match_planes_many_cuda`."""
    return match_planes_many_cuda((vals,), keys, idx)[0]

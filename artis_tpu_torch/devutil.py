"""Tensor-dataclass utilities shared by every module of the port.

The JAX package keeps its state in registered pytrees; here the same
structures are plain dataclasses whose array fields are torch tensors.
``replace`` gives the functional update the transport code is written in,
``map_tensors`` walks the tensor fields (device moves, dtype demotion).
"""

from __future__ import annotations

import dataclasses
import os

import torch


def replace(obj, **kw):
    return dataclasses.replace(obj, **kw)


def map_tensors(fn, obj):
    """Apply ``fn`` to every tensor leaf of a dataclass / dict / list tree."""
    if isinstance(obj, torch.Tensor):
        return fn(obj)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return dataclasses.replace(obj, **{
            f.name: map_tensors(fn, getattr(obj, f.name))
            for f in dataclasses.fields(obj) if f.init
        })
    if isinstance(obj, dict):
        return {k: map_tensors(fn, v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(map_tensors(fn, v) for v in obj)
    return obj


def to_device(obj, device):
    return map_tensors(lambda t: t.to(device), obj)


def demote_to_f32(obj):
    """Cast every float64 tensor of a tree to float32. Integer tensors keep
    int64: torch indexes with int64, so there is no integer demotion."""
    return map_tensors(
        lambda t: t.float() if t.dtype == torch.float64 else t, obj)


def index_add_(x, dim: int, index, source):
    """``x.index_add_(dim, index, source)`` whose sums repeat bit for bit:
    on CUDA index_add_ adds with float atomics, in an order that changes
    from call to call, so same-seed runs differ; index_put_ with accumulate
    sorts the indices and adds each one's values in a fixed order. The CPU
    keeps index_add_. Returns ``x``."""
    if not x.is_cuda:
        return x.index_add_(dim, index, source)
    return sorted_index_add_(x, dim, index, source)


def sorted_index_add_(x, dim: int, index, source):
    """``index_add_``'s CUDA formulation on any device: ``source`` added
    into ``x`` along ``dim`` by index_put_ with accumulate (the aten op,
    whose index list takes None for the whole of a leading dimension)."""
    c = x if x.is_contiguous() else x.contiguous()
    torch.ops.aten.index_put_(c, [None] * dim + [index.long()], source, True)
    if c is not x:
        x.copy_(c)
    return x


def index_add(x, dim: int, index, source):
    """``x.index_add(dim, index, source)`` as ``index_add_`` sums it."""
    if not x.is_cuda:
        return x.index_add(dim, index, source)
    return index_add_(x.clone(), dim, index, source)


def exp_clipped(x):
    """exp with a dtype-aware overflow clip (float64: 709, float32: 87)."""
    limit = 709.0 if x.dtype == torch.float64 else 87.0
    return torch.exp(torch.clamp(x, max=limit))


# Test-mode assertions (the reference's TESTMODE assert_testmodeonly,
# sn3d.h:145-152): no-ops unless ARTIS_TESTMODE=1 is set at import. Checking
# forces a device sync, which is why it is off by default.
TESTMODE = os.environ.get("ARTIS_TESTMODE", "0") == "1"


class TestmodeAssertionError(AssertionError):
    pass


def assert_testmodeonly(cond, msg: str, mask=None):
    """Raise if ``cond`` is False on any lane where ``mask`` is True."""
    if not TESTMODE:
        return
    ok = cond if mask is None else (~mask) | cond
    if not bool(torch.all(ok)):
        raise TestmodeAssertionError(
            f"testmode assert failed: {msg} ({int((~ok).sum())} lanes)")

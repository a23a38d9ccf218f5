"""One-copy device fetches of many-tensor payloads
(port of ``extractorb_tpu/utils/packed_fetch.py``).

Every device-to-host copy is a synchronisation and a transfer of its own.
``pack_fetch`` packs every tensor of a nested payload into ONE int32
buffer on the device (kernel K8 ``pack_i32``: float32/int32/uint32 bit
copies, uint8/int8/bool widened, int64 counts narrowed), copies that buffer to the host once,
and cuts the host copy back into the payload's structure as numpy arrays
(exact: float32 leaves are bit-cast, not rounded).

A payload is a tensor, ``None``, or a list/tuple of payloads; numpy
arrays and other non-tensor leaves pass through unchanged.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import kernels

# dtype -> (kernel kind, numpy dtype of the unpacked leaf)
_KINDS = {
    torch.float32: (0, np.float32), torch.int32: (0, np.int32), torch.uint32: (0, np.uint32),
    torch.uint8: (1, np.uint8), torch.int8: (2, np.int8), torch.bool: (3, bool),
    torch.int64: (4, np.int64),   # counts; the values must fit in int32
}


def _flatten(tree, leaves: list):
    """Replace every tensor by its leaf index; returns the skeleton."""
    if isinstance(tree, torch.Tensor):
        leaves.append(tree)
        return _Leaf(len(leaves) - 1)
    if isinstance(tree, (list, tuple)):
        return type(tree)(_flatten(t, leaves) for t in tree)
    return tree


class _Leaf:
    __slots__ = ("i",)

    def __init__(self, i: int):
        self.i = i


def _unflatten(skel, values):
    if isinstance(skel, _Leaf):
        return values[skel.i]
    if isinstance(skel, (list, tuple)):
        return type(skel)(_unflatten(s, values) for s in skel)
    return skel


def pack_i32_plain(leaves) -> torch.Tensor:
    """Plain version of ``pack_i32``."""
    flat = []
    for a in leaves:
        a = a.contiguous().reshape(-1)
        flat.append(a.view(torch.int32) if _KINDS[a.dtype][0] == 0 else a.to(torch.int32))
    if not flat:
        return torch.zeros(0, dtype=torch.int32)
    return torch.cat(flat)


def pack_i32(leaves) -> torch.Tensor:
    """Concatenate ``leaves`` (tensors on one device) into one (L,) int32
    tensor.  On CUDA tensors this launches K8 ``pack_i32``; on the CPU it
    runs the plain version."""
    for a in leaves:
        if a.dtype not in _KINDS:
            raise TypeError(f"pack_i32: unsupported dtype {a.dtype}")
    if not leaves or not leaves[0].is_cuda:
        return pack_i32_plain(leaves)
    args = [a.contiguous() for a in leaves]
    kernels.require_cuda("pack_i32", *args)
    n = len(args)
    counts = [a.numel() for a in args]
    out = torch.empty(sum(counts), dtype=torch.int32, device=args[0].device)
    # host arrays of the segment table, passed by address
    ptrs = (ctypes.c_void_p * n)(*[a.data_ptr() for a in args])
    lens = (ctypes.c_longlong * n)(*counts)
    kinds = (ctypes.c_int * n)(*[_KINDS[a.dtype][0] for a in args])
    addr = lambda arr: ctypes.cast(arr, ctypes.c_void_p)
    err = kernels.lib().pack_i32_launch(addr(ptrs), addr(lens), addr(kinds), n, out.data_ptr(),
                                        kernels.stream())
    kernels.check(err, "pack_i32")
    kernels.LAUNCHES["pack_i32"] += 1
    return out


def pack_fetch(tree):
    """Host copy of a payload of device tensors with ONE device-to-host
    copy.  Returns the same structure with numpy leaves (dtypes kept
    bit-exactly)."""
    leaves: list = []
    skel = _flatten(tree, leaves)
    if not leaves:
        return tree
    packed = pack_i32(leaves).cpu().numpy()
    out, ofs = [], 0
    for a in leaves:
        n = a.numel()
        chunk = packed[ofs:ofs + n]
        ofs += n
        kind, np_dt = _KINDS[a.dtype]
        v = chunk.view(np_dt) if kind == 0 else chunk.astype(np_dt)
        out.append(v.reshape(tuple(a.shape)))
    return _unflatten(skel, out)

"""The device mesh (port of ``extractorb_tpu/dist/mesh.py``).

The JAX package scales over a ``jax.sharding.Mesh``: one controller
process drives every device, and the sharded solvers run as ``shard_map``
programs whose reductions ride ``psum``.  The port keeps that model: a
mesh is an ordered tuple of ``torch.device``s, one per shard, driven from
one process, so the loop closer calls ``make_mesh()`` from inside
``System`` as the JAX module does.  Devices may repeat: n shards can share
one card (or the CPU), as the JAX test suite's 8 virtual CPU devices do
(``tests/conftest.py``); shards on distinct cards exchange their partial
sums by peer copies (``csrc/shard_sum.cuh``).

``make_mesh()`` takes the process's devices: those set by ``use_devices``
(the port's counterpart of XLA's
``--xla_force_host_platform_device_count``), else the CPU when the caller
runs on the CPU, else every visible card.  ``shard_sum`` is the plain
cross-shard sum, the counterpart of ``psum``: shard 0 first, then each
shard in order.  JAX's ``shard_leading`` / ``replicated`` shardings have
no counterpart: a sharded tensor here is a list of per-shard blocks, shard
s's block on ``mesh.devices[s]``.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional, Sequence, Tuple

import numpy as np
import torch

_DEVICES: Optional[Tuple[torch.device, ...]] = None


class Mesh:
    """An ordered tuple of devices, one per shard; ``shape`` is
    ``{"shard": n}`` as a one-axis JAX mesh's."""

    def __init__(self, devices: Iterable):
        self.devices = tuple(torch.device(d) for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        self.shape = {"shard": len(self.devices)}

    @property
    def size(self) -> int:
        return len(self.devices)

    def __repr__(self) -> str:
        return f"Mesh({[str(d) for d in self.devices]})"


@contextlib.contextmanager
def use_devices(devices: Sequence):
    """Within the block, ``make_mesh`` takes these devices (repeats allowed:
    ``[torch.device("cpu")] * 8`` gives 8 CPU shards, ``["cuda:0"] * 4``
    four shards on one card)."""
    global _DEVICES
    prev = _DEVICES
    _DEVICES = tuple(torch.device(d) for d in devices)
    try:
        yield
    finally:
        _DEVICES = prev


def process_devices(device=None) -> Tuple[torch.device, ...]:
    """The devices a mesh is made of: ``use_devices``'s, else the CPU when
    ``device`` is the CPU, else every visible card (raises without one)."""
    if _DEVICES is not None:
        return _DEVICES
    if device is not None and torch.device(device).type == "cpu":
        return (torch.device("cpu"),)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: the mesh is made of cards; pass device='cpu' or "
                           "use_devices(...)")
    return tuple(torch.device("cuda", i) for i in range(torch.cuda.device_count()))


def make_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """The first ``n_devices`` of the process's devices (all by default)."""
    devs = process_devices(device)
    if n_devices is not None:
        devs = devs[:n_devices]
    return Mesh(devs)


def shard_sum(parts: Sequence[torch.Tensor]) -> torch.Tensor:
    """The fixed-order sum of per-shard partials (shard 0 first), on part
    0's device: the plain counterpart of ``psum``.  One part is returned
    as it is."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p.to(out.device)
    return out


def landmark_shards(p, n: int, what: str):
    """The per-shard problems of a landmark-sharded layout: ``p``'s points
    (``points``, ``fixed_mp``) and observations (``obs_*``, ``inv_sigma2``)
    in n equal blocks, ``obs_mp`` made local to its shard; every other
    field (poses or states, chain) is every shard's.  ``p`` is a BA or a VI
    BA problem; raises unless both lengths are multiples of n."""
    P, O = p.points.shape[0], p.obs_kf.shape[0]
    if O % n or P % n:
        raise ValueError(f"{what}: {P} points and {O} observations on {n} shards")
    if n == 1:
        return [p]
    Ps, Os = P // n, O // n
    out = []
    for s in range(n):
        o, q = slice(s * Os, (s + 1) * Os), slice(s * Ps, (s + 1) * Ps)
        out.append(p._replace(points=p.points[q], obs_kf=p.obs_kf[o],
                              obs_mp=p.obs_mp[o] - s * Ps, obs_uv=p.obs_uv[o],
                              inv_sigma2=p.inv_sigma2[o], obs_valid=p.obs_valid[o],
                              fixed_mp=p.fixed_mp[q]))
    return out


def cuda_ids(mesh: Mesh, what: str) -> np.ndarray:
    """The CUDA device index of each shard (int32), for a kernel launched
    over the mesh; raises on a shard that is not a card."""
    if any(d.type != "cuda" for d in mesh.devices):
        raise ValueError(f"{what}: a card's problem on the mesh {mesh}")
    return np.asarray([d.index if d.index is not None else torch.cuda.current_device()
                       for d in mesh.devices], np.int32)

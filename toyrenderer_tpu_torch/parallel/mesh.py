"""A device mesh: the port's counterpart of a JAX `jax.sharding.Mesh`.

A `Mesh` is an array of `torch.device`s with named axes; `mesh.shape`
maps each axis name to its size, as JAX's does, so callers read
`mesh.shape['sp']` the same way.  A device may appear more than once:
`Mesh([torch.device('cuda', 0)] * 4, ('sp',))` runs the band and slice
logic of four devices on one card (each band's work then runs in turn on
that card), and `Mesh([torch.device('cpu')] * 8, ('sp',))` runs it on the
CPU.

There is no `torch.distributed` here: like the reference's `shard_map`,
the work of every device is issued from one process, one Python loop,
with no synchronizing call inside it (`run_on` makes each device current
for its part, copies land on the target device without a host wait), so
on distinct cards the parts overlap.  Outputs gather onto the mesh's
first device (`gather`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import weakref

import numpy as np
import torch


class Mesh:
    """devices: a nested sequence of torch.device (or strings) whose
    shape matches `axis_names`; `devices` is kept as a numpy object
    array of that shape."""

    def __init__(self, devices, axis_names):
        flat = [_indexed(torch.device(d))
                for d in np.asarray(devices, object).reshape(-1)]
        arr = np.empty(len(flat), object)
        arr[:] = flat
        shape = np.asarray(devices, object).shape
        self.axis_names = tuple(axis_names)
        if len(shape) != len(self.axis_names):
            raise ValueError(f"mesh of shape {shape} with axes "
                             f"{self.axis_names}")
        self.devices = arr.reshape(shape)
        self.shape = dict(zip(self.axis_names, shape))
        self._copies: dict = {}

    def __repr__(self):
        return f"Mesh({self.shape}, {list(self.devices.reshape(-1))})"

    @property
    def first(self) -> torch.device:
        """The device outputs gather onto."""
        return self.devices.reshape(-1)[0]

    def along(self, axis: str, **index) -> list[torch.device]:
        """The devices along `axis`, the other axes at `index` (0 where
        not given)."""
        sel = tuple(slice(None) if a == axis else index.get(a, 0)
                    for a in self.axis_names)
        return list(self.devices[sel].reshape(-1))

    def sub(self, axis: str, **index) -> "Mesh":
        """The one-axis mesh along `axis` (see `along`)."""
        return Mesh(self.along(axis, **index), (axis,))

    def put(self, obj, device: torch.device):
        """`obj` on `device` (to_device), the copy made once per (object,
        device) and kept while the object lives: a tree or a table that
        each frame hands the same object is copied to each device of the
        mesh once, not every frame.  An object that cannot be weakly
        referenced (a dict) is copied at each call."""
        key = (id(obj), str(device))
        hit = self._copies.get(key)
        if hit is not None and hit[0]() is obj:
            return hit[1]
        copy = to_device(obj, device)
        if copy is obj:
            return obj
        try:
            ref = weakref.ref(obj)
        except TypeError:
            return copy
        self._copies = {k: v for k, v in self._copies.items()
                        if v[0]() is not None}
        self._copies[key] = (ref, copy)
        return copy


def _indexed(device: torch.device) -> torch.device:
    """A CUDA device without an index names the current one."""
    if device.type == 'cuda' and device.index is None:
        return torch.device('cuda', torch.cuda.current_device())
    return device


def run_on(device: torch.device):
    """The context a device's part runs in: that CUDA device made
    current (a kernel launches on its current device's stream), nothing
    for the CPU."""
    if device.type == 'cuda':
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def to_device(obj, device: torch.device):
    """`obj` with every tensor in it on `device`: tensors, and dicts,
    lists, tuples and dataclasses of them, recursively (other values as
    they are).  A tensor already there is returned as it is, so a mesh
    that repeats one device copies nothing; a copy between devices does
    not block the host."""
    if isinstance(obj, torch.Tensor):
        if obj.device == device:
            return obj
        return obj.to(device, non_blocking=True)
    if isinstance(obj, dict):
        moved = {k: to_device(v, device) for k, v in obj.items()}
        if all(moved[k] is v for k, v in obj.items()):
            return obj
        new = type(obj)(moved)
        new.__dict__.update(getattr(obj, '__dict__', {}))
        return new
    if isinstance(obj, (list, tuple)) and not hasattr(obj, '_fields'):
        moved = [to_device(v, device) for v in obj]
        if all(m is v for m, v in zip(moved, obj)):
            return obj
        return type(obj)(moved)
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        changes = {}
        for f in dataclasses.fields(obj):
            if not f.init:
                continue
            v = getattr(obj, f.name)
            moved = to_device(v, device)
            if moved is not v:
                changes[f.name] = moved
        return dataclasses.replace(obj, **changes) if changes else obj
    return obj


def gather(parts, device: torch.device, dim: int = 0) -> torch.Tensor:
    """The parts, moved to `device` without a host wait, concatenated
    along `dim`."""
    return torch.cat([to_device(p, device) for p in parts], dim=dim)

"""A 1-D device mesh and the per-shard feeds over it (counterpart of
``jax.sharding.Mesh`` with ``openwakeword_tpu.parallel.engine.put_sharded``
and ``fetch_sharded``).

``torch.distributed``'s ``DeviceMesh`` is one process per device, but the
engine, like the JAX one, is one process driving all of its local devices,
so the port keeps a small mesh of its own: an ordered list of entries, each
a device and the process that owns it. An entry may repeat a device; several
shards then live on one device, as on JAX's virtual CPU devices (8 x ``cpu``
in the tests, k x ``cuda:0`` on a one-card host).

A stream-major array of n rows is split into ``size`` equal row ranges: row
``i`` lives on entry ``i // (n / size)`` (the slot-range rule of
docs/serving.md, "Multi-host serving"). Stream sharding needs no collective,
so no process group is brought up: a process ships the rows of the entries it
owns and never reads the others'.
"""

from typing import List, Optional, Sequence

import numpy as np
import torch


def as_device(d) -> torch.device:
    """``d`` as a torch.device; a bare 'cuda' is card 0, so that equal
    devices compare equal."""
    dev = torch.device(d)
    return torch.device("cuda", 0) if dev.type == "cuda" and dev.index is None else dev


class Mesh:
    """A 1-D mesh: ``devices`` (one per entry, repeats allowed) named by a
    single axis. ``owners[i]`` is the process that owns entry ``i`` (default:
    every entry ``process_index``, i.e. this process owns the whole mesh)."""

    def __init__(self, devices: Sequence, axis_names: Sequence[str] = ("streams",),
                 owners: Optional[Sequence[int]] = None, process_index: int = 0):
        self.devices = tuple(as_device(d) for d in np.asarray(devices, dtype=object).reshape(-1))
        self.axis_names = tuple(axis_names)
        if len(self.axis_names) != 1:
            raise ValueError(f"the port's mesh is 1-D; got axis names {self.axis_names}")
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        owners = [process_index] * len(self.devices) if owners is None else [int(o) for o in owners]
        if len(owners) != len(self.devices):
            raise ValueError(f"{len(owners)} owners for {len(self.devices)} mesh entries")
        self.owners = tuple(owners)
        self.process_index = int(process_index)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def owned(self) -> List[int]:
        """The entries this process owns, in mesh order."""
        return [i for i, o in enumerate(self.owners) if o == self.process_index]

    def rows(self, n: int) -> List[slice]:
        """Each entry's row range of an n-row array."""
        if n % self.size:
            raise ValueError(f"{n} rows are not divisible by the {self.size}-entry mesh")
        per = n // self.size
        return [slice(i * per, (i + 1) * per) for i in range(self.size)]

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]}, {self.axis_names})"


def to_device(t: torch.Tensor, device: torch.device, non_blocking: bool = False) -> torch.Tensor:
    """A host or device tensor on ``device``. With ``non_blocking`` a host
    tensor goes to a card from pinned memory without waiting for the stream:
    from the tensor itself when it lies in pinned memory (its owner keeps it
    unchanged until the step that reads it is done), else from a pinned copy
    that the caching host allocator keeps until the transfer is done."""
    if device.type != "cuda" or t.device.type != "cpu" or not non_blocking:
        return t.to(device)
    t = t.contiguous()
    if not t.is_pinned():
        t = t.pin_memory()
    return t.to(device, non_blocking=True)


def put_sharded(x, mesh: Mesh, axis: int = 0, non_blocking: bool = False) -> List[Optional[torch.Tensor]]:
    """Host array (numpy or a tensor) -> one tensor per mesh entry: entry
    ``i`` gets rows ``mesh.rows(n)[i]`` of ``axis`` on its device. Only the
    entries this process owns are filled (the others are None), and only
    their rows of ``x`` are read: a multi-host caller keeps a global-shape
    buffer and fills its own rows alone."""
    spans = mesh.rows(x.shape[axis])
    out: List[Optional[torch.Tensor]] = [None] * mesh.size
    for i in mesh.owned:
        if isinstance(x, torch.Tensor):
            part = x.narrow(axis, spans[i].start, spans[i].stop - spans[i].start)
        else:
            idx = (slice(None),) * axis + (spans[i],)
            part = torch.from_numpy(np.ascontiguousarray(x[idx]))
        out[i] = to_device(part, mesh.devices[i], non_blocking)
    return out


def fetch_sharded(shards: Sequence[Optional[torch.Tensor]], mesh: Mesh, axis: int = 0) -> np.ndarray:
    """Per-entry tensors (``put_sharded``'s layout) -> one global-shape host
    array. Rows of the entries this process does not own stay zero (a
    serving host polls only the slots it serves)."""
    owned = mesh.owned
    if not owned:
        raise ValueError("this process owns no entry of the mesh")
    # numpy has no bf16: such shards come back as float32
    parts = {i: (shards[i].detach().float() if shards[i].dtype == torch.bfloat16 else shards[i].detach())
             .cpu().numpy() for i in owned}
    shape = list(parts[owned[0]].shape)
    shape[axis] *= mesh.size
    out = np.zeros(shape, dtype=parts[owned[0]].dtype)
    spans = mesh.rows(shape[axis])
    for i in owned:
        out[(slice(None),) * axis + (spans[i],)] = parts[i]
    return out

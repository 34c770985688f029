"""Processes, their devices and the transport between them (counterpart
of ``ocean_model_arch_tpu/parallel/multihost.py``).

The JAX package wires its processes with ``jax.distributed`` and runs the
same mesh code across them: ``ppermute`` strips between shards of other
processes leave the chip. The port runs one process a device (a card, or
the CPU when asked for): ``torch.distributed`` wires the processes, each
holds the shards it owns (``parallel/mesh.py::Mesh``) and a shard's
margin strips move to a shard of another process as point-to-point
messages, one ``batch_isend_irecv`` a pass -- the reference's inter-rank
halo sends (syncborder_block2D_gen_all.fi:100-129).

The transport is the caller's choice, never a fallback:

- ``"nccl"`` carries CUDA tensors between processes that each have a card
  of their own (NCCL refuses two processes on one card);
- ``"gloo"`` carries CPU tensors: the CPU runs, and processes that share
  one card, whose strips are staged through pinned host buffers (Gloo's
  ``send`` / ``recv`` take no CUDA tensor).

Launch N processes with ``torchrun`` (its environment names the rank, the
world and the rendezvous) or give each its rank, the world size and an
init method (``tcp://host:port`` or ``file:///path``) by hand.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch
import torch.distributed as dist

from ..host import default_device

BACKENDS = ("gloo", "nccl")

# this process's device, set by initialize(): process-wide, as the
# process group itself is
_DEVICE: list = [None]


@dataclasses.dataclass(frozen=True)
class RankDevice:
    """The device of a shard that process ``rank`` holds (the port's
    counterpart of a jax device with its ``process_index``)."""
    rank: int
    device: torch.device


def initialize(coordinator_address: str | None = None,
               num_processes: int | None = None,
               process_id: int | None = None, backend: str = "gloo",
               device=None) -> torch.device:
    """Join the process group and return this process's device.

    ``coordinator_address``: the init method, ``tcp://host:port`` or
    ``file:///path`` (a bare ``host:port`` means tcp); None is ``env://``,
    torchrun's ``MASTER_ADDR`` / ``MASTER_PORT``. ``num_processes`` /
    ``process_id``: None takes torchrun's ``WORLD_SIZE`` / ``RANK``.
    ``backend``: ``"gloo"`` or ``"nccl"`` (see the module). ``device``:
    None is, under NCCL, the card ``LOCAL_RANK`` (or the rank modulo the
    cards) made current; under Gloo the current CUDA device, raising
    without one; ``"cpu"`` only when asked for."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}: one of {BACKENDS}")
    env = os.environ
    if coordinator_address is None:
        if "MASTER_ADDR" not in env or "MASTER_PORT" not in env:
            raise ValueError("no coordinator address: pass tcp://host:port "
                             "or file:///path, or launch under torchrun")
        # torchrun's own store at MASTER_ADDR:MASTER_PORT (its agent
        # serves it: a tcp:// rank 0 would try to bind the port again)
        coordinator_address = "env://"
    elif "://" not in coordinator_address:
        coordinator_address = "tcp://" + coordinator_address
    if num_processes is None:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None:
        process_id = int(env["RANK"])
    if backend == "nccl":
        if device is None:
            n = torch.cuda.device_count()
            if n == 0:
                raise RuntimeError("backend nccl needs a CUDA device")
            device = torch.device("cuda",
                                  int(env.get("LOCAL_RANK", process_id)) % n)
        device = torch.device(device)
        if device.type != "cuda":
            raise ValueError(f"backend nccl carries CUDA tensors, not "
                             f"{device.type} ones")
    device = torch.device(default_device() if device is None else device)
    if device.type == "cuda":
        if device.index is None:             # "cuda": the current card
            device = torch.device("cuda", torch.cuda.current_device())
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=int(num_processes),
                            rank=int(process_id))
    _DEVICE[0] = device
    # NCCL's first point-to-point call must not be a pair's alone
    barrier()
    return device


def shutdown() -> None:
    """Leave the process group (the counterpart of
    ``jax.distributed.shutdown``)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _DEVICE[0] = None


def _grouped() -> bool:
    return dist.is_available() and dist.is_initialized()


def process_count() -> int:
    """The number of processes (1 without a process group)."""
    return dist.get_world_size() if _grouped() else 1


def process_index() -> int:
    """This process's rank (0 without a process group)."""
    return dist.get_rank() if _grouped() else 0


def backend() -> str | None:
    """The process group's transport, or None without one."""
    return dist.get_backend() if _grouped() else None


def local_device() -> torch.device:
    """This process's device: the one :func:`initialize` chose, else the
    current CUDA device (raising without one)."""
    return _DEVICE[0] if _DEVICE[0] is not None else default_device()


def transport() -> str:
    """How strips travel between processes, as the compute path line
    names it."""
    b = backend()
    if b is None:
        return "one process"
    how = b
    if b == "gloo" and local_device().type == "cuda":
        how += ", staged through pinned host buffers"
    return f"{process_count()} processes, {how}"


def devices() -> list:
    """Every process's device in rank order, as :class:`RankDevice`
    (``jax.devices()`` across processes). Collective."""
    mine = str(local_device()) if _grouped() else None
    if not _grouped():
        return [RankDevice(0, local_device())]
    every = [None] * process_count()
    dist.all_gather_object(every, mine)
    return [RankDevice(r, torch.device(d)) for r, d in enumerate(every)]


def pod_mesh(px: int, py: int):
    """A px x py mesh over every process's device, one shard a process:
    shard (i, j) on rank ``i * py + j`` (x along the ranks' major order,
    as the JAX package lays it out)."""
    from .mesh import make_mesh
    if px * py != process_count():
        raise ValueError(f"mesh {px}x{py} != {process_count()} processes")
    return make_mesh(px, py, local_device())


# ---- collectives --------------------------------------------------------

def _wire(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the transport takes it: on the host under Gloo."""
    return t.cpu() if backend() == "gloo" else t


def all_gather(t: torch.Tensor) -> list:
    """Every process's ``t`` (one shape and dtype everywhere), in rank
    order, on ``t``'s device. Collective."""
    if not _grouped():
        return [t]
    w = _wire(t.contiguous())
    out = [torch.empty_like(w) for _ in range(process_count())]
    dist.all_gather(out, w)
    return [o.to(t.device) for o in out]


def gather_to_host(tensor) -> np.ndarray:
    """Every process's ``tensor`` (one shape everywhere) concatenated
    along axis 0 in rank order, on every process -- JAX's
    ``process_allgather(tiled=True)`` of process-local arrays. One
    process: the tensor as a numpy array. Collective."""
    t = torch.as_tensor(tensor)
    return torch.cat([p.cpu() for p in all_gather(t)]).numpy() \
        if _grouped() else t.detach().cpu().numpy()


def any_rank(flag: torch.Tensor) -> bool:
    """True where any process's 0-dim bool ``flag`` is True (a MAX of
    ints: NaN never enters it). Collective; one process reads the flag."""
    if not _grouped():
        return bool(flag)
    v = _wire(flag.reshape(1).to(torch.int32))
    dist.all_reduce(v, op=dist.ReduceOp.MAX)
    return bool(v.item())


def barrier() -> None:
    """Wait for every process (nothing without a process group)."""
    if _grouped():
        if backend() == "nccl":
            dist.barrier(device_ids=[local_device().index])
        else:
            dist.barrier()


def all_objects(obj) -> list:
    """Every process's picklable ``obj``, in rank order. Collective."""
    if not _grouped():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj)
    return out


class Strips:
    """Passes of point-to-point strips between processes: ``send(peer,
    tensor, tag)`` and ``recv(peer, tensor, tag)`` queue a pass's strips,
    ``run()`` posts them as one ``batch_isend_irecv`` and waits; no
    ordering by pair, so no pass deadlocks. Every process queues its
    strips in the same global order, so the k-th strip a pair sends meets
    the k-th it receives (each is tagged with its place in the pass, for
    Gloo). Under Gloo a CUDA strip travels through a pinned host buffer,
    which the owner's next pass with the same tag and shape reuses."""

    def __init__(self):
        self._ops = []
        self._land = []
        self._pinned = {}

    def _host(self, kind: str, tag: int, like: torch.Tensor) -> torch.Tensor:
        key = (kind, tag, tuple(like.shape), like.dtype)
        buf = self._pinned.get(key)
        if buf is None:
            buf = self._pinned[key] = torch.empty(
                like.shape, dtype=like.dtype, pin_memory=True)
        return buf

    def _staged(self, t: torch.Tensor) -> bool:
        return t.is_cuda and backend() == "gloo"

    def send(self, peer: int, t: torch.Tensor, tag: int) -> int:
        """Queue ``t`` (any layout) to ``peer``; returns its bytes."""
        t = t.contiguous()
        if self._staged(t):
            buf = self._host("send", tag, t)
            buf.copy_(t)
            t = buf
        self._ops.append(dist.P2POp(dist.isend, t, peer, tag=tag))
        return t.numel() * t.element_size()

    def recv(self, peer: int, into: torch.Tensor, tag: int) -> None:
        """Queue a strip from ``peer`` to land in ``into`` (any view)."""
        if self._staged(into):
            buf = self._host("recv", tag, into)
        else:
            buf = torch.empty(into.shape, dtype=into.dtype,
                              device=into.device)
        self._ops.append(dist.P2POp(dist.irecv, buf, peer, tag=tag))
        self._land.append((into, buf))

    def run(self) -> None:
        if self._ops:
            for req in dist.batch_isend_irecv(self._ops):
                req.wait()
        for into, buf in self._land:
            into.copy_(buf)
        self._ops, self._land = [], []

"""Shard groups and their collectives: the port's counterpart of
``jax.shard_map`` over a device mesh axis.

The JAX package runs its distributed engines as one SPMD program over a
``Mesh`` axis, with ``lax.psum`` / ``lax.pmax`` / ``lax.ppermute`` /
``lax.all_to_all`` / ``lax.all_gather`` / ``lax.axis_index`` inside the
body (reference: PartitionedArrays ``consistent!`` and MPI allreduces,
ext/JutulPartitionedArraysExt). Here a ``ShardGroup`` runs a Python body
once per shard and hands it a ``comm`` with the same primitives:

- ``ShardGroup.threads(D, device)``: D threads of one process on one
  device — the counterpart of the JAX package's fake-device rig, and the
  only way a D-way partition runs on one card. The shards take turns:
  one runs at a time, in rank order, until its next collective, where it
  hands the turn on; the last rank completes the collective (a reduction
  combines the D contributions once, in rank order, and every shard
  reads the same tensor) and hands the turn back to rank 0. So no two
  shards contend for the interpreter or the device's queue (eight
  contending threads ran the dryrun case ~10x slower than two on the
  card), every decision taken from a reduced value agrees across shards,
  and the order of every launch is fixed. A shard's exception stops the
  group and is re-raised in the caller.
- ``ShardGroup.process_group(group)``: one shard per rank of an
  initialised ``torch.distributed`` group (NCCL for CUDA tensors, gloo on
  the CPU). Reductions all-gather the contributions and sum them in rank
  order too, so both transports compute the same bits.

Reverse-mode derivatives never run a collective: autograd runs the
backward of CUDA tensors on one device thread shared by every shard
thread, so a collective inside a backward would wait for shards that
cannot run. The adjoints differentiate each shard's residual with respect
to its EXTENDED (halo-filled) inputs and send the ghost cotangents home by
the engines' explicit halo transposes (the role ``jax.linear_transpose``
of ppermute/all_to_all plays in the JAX package).
"""

from __future__ import annotations

import threading

import torch

from ..dtypes import resolve_device

# Seconds a shard thread waits for its turn before it breaks the group: a
# shard that never reaches a collective fails the run instead of hanging it.
TURN_TIMEOUT = 1800.0


class _Turns:
    """The rendezvous of a thread group: one shard runs at a time, in rank
    order, and hands the turn on when it reaches a collective. The shard
    that completes a collective (the last rank) combines the D
    contributions once and hands the turn back to rank 0."""

    def __init__(self, size: int):
        self.size = size
        self.events = [threading.Event() for _ in range(size)]
        self.bufs = [None] * size
        self.vals = self.result = None
        self.broken = False

    def wait(self, rank: int) -> None:
        """Block until it is ``rank``'s turn."""
        ev = self.events[rank]
        if not ev.wait(TURN_TIMEOUT):
            self.abort()
            raise _Broken("a shard did not reach the collective in time")
        ev.clear()
        if self.broken:
            raise _Broken("another shard failed")

    def hand_on(self, rank: int) -> None:
        """``rank`` is done until the next collective completes."""
        self.events[(rank + 1) % self.size].set()

    def exchange(self, rank: int, x, combine=None):
        """(every shard's ``x`` in rank order, ``combine`` of them)."""
        self.bufs[rank] = x
        if rank == self.size - 1:
            self.vals = list(self.bufs)
            self.result = combine(self.vals) if combine else None
            vals, result = self.vals, self.result
            if self.size > 1:
                self.hand_on(rank)
                self.wait(rank)
            return vals, result
        self.hand_on(rank)
        self.wait(rank)
        return self.vals, self.result

    def abort(self) -> None:
        self.broken = True
        for ev in self.events:
            ev.set()


class _Broken(RuntimeError):
    """A shard group stopped: another shard failed or timed out."""


def _sum(vals):
    out = vals[0]
    for v in vals[1:]:
        out = out + v
    return out


def _max(vals):
    out = vals[0]
    for v in vals[1:]:
        out = torch.maximum(out, v)
    return out


class ThreadComm:
    """The collectives of one shard of a ``threads`` group. Reduced and
    gathered results are computed once and shared by every shard (read
    only)."""

    def __init__(self, turns: _Turns, rank: int, size: int):
        self._turns = turns
        self.rank = rank
        self.size = size

    def axis_index(self) -> int:
        return self.rank

    def psum(self, x):
        return self._turns.exchange(self.rank, x, _sum)[1]

    def pmax(self, x):
        return self._turns.exchange(self.rank, x, _max)[1]

    def all_gather(self, x):
        """(m, ...) per shard -> (D*m, ...) in rank order."""
        return self._turns.exchange(self.rank, x, torch.cat)[1]

    def ppermute(self, x, perm):
        """``perm``: (src, dst) pairs; a shard that receives nothing gets
        zeros (``lax.ppermute``)."""
        vals = self._turns.exchange(self.rank, x)[0]
        for s, d in perm:
            if d == self.rank:
                return vals[s]
        return torch.zeros_like(x)

    def all_to_all(self, x):
        """x (D, M, ...): row d goes to shard d; out[s] = shard s's row
        for me (``lax.all_to_all(x, axis, 0, 0)``)."""
        vals = self._turns.exchange(self.rank, x)[0]
        return torch.stack([v[self.rank] for v in vals])


class ProcessComm:
    """The collectives of one rank of a ``torch.distributed`` group."""

    def __init__(self, group):
        import torch.distributed as dist

        self._dist = dist
        self._group = group
        self.rank = dist.get_rank(group)
        self.size = dist.get_world_size(group)

    def axis_index(self) -> int:
        return self.rank

    def _gather_list(self, x) -> list:
        x = x.contiguous()
        out = [torch.empty_like(x) for _ in range(self.size)]
        self._dist.all_gather(out, x, group=self._group)
        return out

    def psum(self, x):
        return _sum(self._gather_list(x))

    def pmax(self, x):
        return _max(self._gather_list(x))

    def all_gather(self, x):
        return torch.cat(self._gather_list(x))

    def ppermute(self, x, perm):
        x = x.contiguous()
        out = torch.zeros_like(x)
        ops = []
        for s, d in perm:
            if s == self.rank and d != self.rank:
                ops.append(self._dist.P2POp(self._dist.isend, x,
                                            self._group_rank(d),
                                            group=self._group))
            if d == self.rank:
                if s == self.rank:
                    out = x.clone()
                else:
                    ops.append(self._dist.P2POp(self._dist.irecv, out,
                                                self._group_rank(s),
                                                group=self._group))
        if ops:
            for req in self._dist.batch_isend_irecv(ops):
                req.wait()
        return out

    def _group_rank(self, r: int) -> int:
        """Global rank of group rank ``r`` (P2P ops take global ranks)."""
        if self._group is None:
            return r
        return self._dist.get_global_rank(self._group, r)

    def all_to_all(self, x):
        x = x.contiguous()
        out = torch.empty_like(x)
        self._dist.all_to_all_single(out, x, group=self._group)
        return out


class ShardGroup:
    """D shards that run one body SPMD (see the module docstring)."""

    def __init__(self, kind: str, size: int, device, group=None):
        self.kind = kind
        self.size = int(size)
        self.device = device
        self._group = group

    @classmethod
    def threads(cls, n_shards: int, device=None) -> "ShardGroup":
        """``n_shards`` threads on one device (``None``: the card; raises
        without one). Every collective's wait is bounded by
        ``TURN_TIMEOUT``."""
        if int(n_shards) < 1:
            raise ValueError("a shard group needs at least one shard")
        return cls("threads", n_shards, resolve_device(device))

    @classmethod
    def process_group(cls, group=None, device=None) -> "ShardGroup":
        """One shard per rank of an initialised ``torch.distributed``
        group; the device is ``cuda:<local rank>`` on an NCCL group unless
        ``device`` says otherwise, and the CPU on a gloo group."""
        import os

        import torch.distributed as dist

        if not dist.is_initialized():
            raise RuntimeError("torch.distributed is not initialised")
        if device is None:
            if dist.get_backend(group) == "nccl":
                local = int(os.environ.get("LOCAL_RANK",
                                           dist.get_rank(group)))
                device = f"cuda:{local}"
            else:
                device = "cpu"
        dev = resolve_device(device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        return cls("process", dist.get_world_size(group), dev, group=group)

    def run(self, body, per_shard_args) -> list:
        """``body(comm, args_d)`` on every shard d; returns the D outputs
        in rank order. In a process group each rank runs its own shard and
        the outputs are exchanged (tensors travel through the host)."""
        args = list(per_shard_args)
        if len(args) != self.size:
            raise ValueError(f"{len(args)} shard arguments for "
                             f"{self.size} shards")
        if self.kind == "process":
            return self._run_process(body, args)
        return self._run_threads(body, args)

    def _run_threads(self, body, args) -> list:
        D = self.size
        turns = _Turns(D)
        outs = [None] * D
        errors = [None] * D

        def work(d):
            try:
                turns.wait(d)
                outs[d] = body(ThreadComm(turns, d, D), args[d])
                if d < D - 1:
                    turns.hand_on(d)
            except BaseException as e:  # noqa: BLE001 — re-raised below
                errors[d] = e
                turns.abort()

        threads = [threading.Thread(target=work, args=(d,),
                                    name=f"shard-{d}", daemon=True)
                   for d in range(D)]
        for t in threads:
            t.start()
        turns.events[0].set()
        for t in threads:
            t.join()
        first = [e for e in errors
                 if e is not None and not isinstance(e, _Broken)]
        if first:
            raise first[0]
        broken = [e for e in errors if e is not None]
        if broken:
            raise RuntimeError("a shard left the group") from broken[0]
        return outs

    def _run_process(self, body, args) -> list:
        import torch.distributed as dist

        comm = ProcessComm(self._group)
        mine = body(comm, args[comm.rank])
        if self.size == 1:
            return [mine]
        gathered = [None] * self.size
        dist.all_gather_object(gathered, _to_cpu(mine), group=self._group)
        gathered[comm.rank] = mine
        return gathered


def _to_cpu(obj):
    if torch.is_tensor(obj):
        return obj.detach().cpu()
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj

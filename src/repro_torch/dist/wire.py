"""The data-parallel wire: the collectives the aggregation runs over the
data axes of a mesh (port of ``repro/dist/compat.py`` ``axis_size`` /
``ppermute`` and of the ``lax.all_gather`` / ``lax.pmean`` calls in
``repro/dist/aggregate.py``).

The aggregation code is written once, per worker.  Every value it hands
the wire is a LIST with one payload per worker this process runs (its
local workers); a payload is a tensor or a tuple of tensors.  Results
come back the same way.  ``axis`` names one data axis (``"pod"``,
``"data"``) or a tuple of them, joined row-major as ``lax.all_gather``
over a tuple of axes joins them.

Two implementations:

* :class:`LocalWire` — all W workers of the mesh in this process, on one
  device (the counterpart of the JAX package's ``--host-devices N``).
  ``all_gather`` stacks the payloads of an axis group in rank order
  (workers of one group share the stacked tensor), ``ppermute`` is a
  reindexing of the list, ``pmean`` a sum in rank order.
* :class:`ProcessGroupWire` — one worker per process over
  ``torch.distributed``: one process group per data axis (the ranks that
  share the other coordinates), ``all_gather_into_tensor`` of the
  payload's bytes, ``batch_isend_irecv`` for ``ppermute``.  Under gloo a
  CUDA payload is copied to the host and back explicitly; NCCL needs one
  card per rank (:func:`init_process_group` raises otherwise).  With a
  model axis ``M > 1`` it is a tensor-parallel launch of ``D·M``
  processes: a process's global rank is its joint rank over all mesh
  axes, row-major with the model axis last (``w·M + r`` for data rank
  ``w``, model rank ``r``); its data wire runs over the processes that
  share ``r``, and its model group (:meth:`model_gather`,
  :meth:`model_all_to_all`) holds the ``M`` processes that share ``w``.

Under :class:`LocalWire` the model axis stays virtual: the one process
holds all ``M`` rows of every bucket.

Both sum a ``pmean`` one rank at a time in rank order on the payload's
device and divide by the group size, so the two implementations give
the same bits.  ``all_gather(..., async_op=True)`` returns a handle whose
``wait()`` gives the gathered list: ``ProcessGroupWire`` issues the
collective asynchronously (the chunked schedule waits for it only when
it needs the mean), ``LocalWire`` has it already.
"""
from __future__ import annotations

import os
from typing import Dict, List, Sequence, Tuple

import torch

from repro_torch.launch.mesh import (Mesh, data_axes_of, data_world_size,
                                     model_axis_size, worker_coords,
                                     worker_index)


def _axes(axis) -> Tuple[str, ...]:
    return tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)


def _map(payload, fn):
    if isinstance(payload, tuple):
        return tuple(fn(t) for t in payload)
    return fn(payload)


def _ordered_sum(stacked: torch.Tensor) -> torch.Tensor:
    """``((x0 + x1) + x2) + ...`` over the leading dim: the same bits on
    every device and for every wire."""
    acc = stacked[0]
    for j in range(1, stacked.shape[0]):
        acc = acc + stacked[j]
    return acc


class _Done:
    """An all-gather that has already happened."""

    def __init__(self, out: list):
        self.out = out

    def wait(self) -> list:
        return self.out


class _Pending:
    """An all-gather in flight: ``wait()`` waits for it and unpacks."""

    def __init__(self, work, finish, keep):
        self.work, self.finish, self.keep = work, finish, keep

    def wait(self) -> list:
        self.work.wait()
        out = self.finish()
        self.work = self.finish = self.keep = None
        return out


class _MeshWire:
    """What both wires know of the mesh: axis sizes and axis groups."""

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self.data_axes = data_axes_of(mesh)
        self.world = data_world_size(mesh)
        self.model_size = model_axis_size(mesh)

    def axis_size(self, axis) -> int:
        size = 1
        for a in _axes(axis):
            if a not in self.data_axes:
                raise ValueError(f"{a!r} is not a data axis of mesh "
                                 f"{self.mesh}")
            size *= self.mesh.sizes[a]
        return size

    def group(self, rank: int, axis) -> List[int]:
        """The ranks that share ``rank``'s coordinates off ``axis``, in
        row-major order over ``axis`` (ascending rank)."""
        axes = _axes(axis)
        me = worker_coords(self.mesh, rank)
        return [r for r in range(self.world)
                if all(worker_coords(self.mesh, r)[a] == me[a]
                       for a in self.data_axes if a not in axes)]

    def _peer(self, rank: int, axis: str, pos: int) -> int:
        coords = dict(worker_coords(self.mesh, rank))
        coords[axis] = pos
        return worker_index(self.mesh, coords)

    @staticmethod
    def _sources(perm) -> Dict[int, int]:
        src = {}
        for s, d in perm:
            if d in src:
                raise ValueError(f"ppermute: two sources for {d} in {perm}")
            src[d] = s
        return src


class LocalWire(_MeshWire):
    """All ``W`` workers of ``mesh`` in this process, each holding all
    ``M`` rows of its buckets."""

    name = "local"
    backend = "none"
    tensor_parallel = False

    def __init__(self, mesh: Mesh):
        super().__init__(mesh)
        self.ranks = list(range(self.world))

    @property
    def local_workers(self) -> int:
        return self.world

    def all_gather(self, xs: Sequence, axis, async_op: bool = False):
        out, done = [None] * self.world, {}
        for r in self.ranks:
            members = tuple(self.group(r, axis))
            if members not in done:
                done[members] = _stack([xs[m] for m in members])
            out[r] = done[members]
        return _Done(out) if async_op else out

    def ppermute(self, xs: Sequence, axis: str, perm) -> list:
        src = self._sources(perm)
        out = []
        for r in self.ranks:
            s = src.get(worker_coords(self.mesh, r)[axis])
            out.append(_map(xs[r], torch.zeros_like) if s is None
                       else xs[self._peer(r, axis, s)])
        return out

    def pmean(self, xs: Sequence, axes) -> list:
        n = self.axis_size(axes)
        return [_map(g, lambda t: _ordered_sum(t) / n)
                for g in self.all_gather(xs, axes)]


def _stack(payloads: list):
    if isinstance(payloads[0], tuple):
        return tuple(torch.stack(parts) for parts in zip(*payloads))
    return torch.stack(payloads)


def init_process_group(backend: str, *, rank: int, world_size: int,
                       local_rank: int = 0, local_world_size=None,
                       init_method: str = "env://") -> None:
    """``torch.distributed.init_process_group`` for the wire.  NCCL needs
    one card per rank: with more ranks on this host than visible cards
    it raises rather than running on another backend."""
    import torch.distributed as dist
    if backend == "nccl":
        cards = torch.cuda.device_count()
        here = world_size if local_world_size is None else local_world_size
        if here > cards:
            raise RuntimeError(
                f"NCCL needs one card per rank: {here} ranks on this host "
                f"and {cards} card(s) visible; use fewer ranks or the gloo "
                "backend")
        torch.cuda.set_device(local_rank)
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world_size)


class ProcessGroupWire(_MeshWire):
    """One worker per process over ``torch.distributed``; ``rank`` is its
    worker's joint rank over the data axes.  With a model axis above 1
    the launch has ``D·M`` processes and this one is model rank
    ``model_rank`` of its worker (``tensor_parallel``).  Call after
    :func:`init_process_group`, in every rank (the groups are created
    collectively)."""

    name = "process_group"

    def __init__(self, mesh: Mesh):
        import torch.distributed as dist
        super().__init__(mesh)
        if not dist.is_initialized():
            raise RuntimeError("ProcessGroupWire: torch.distributed is not "
                               "initialised (init_process_group first)")
        M = self.model_size
        size = dist.get_world_size()
        if size != self.world * M:
            raise ValueError(
                f"mesh {'x'.join(map(str, mesh.shape))} has {self.world} "
                f"data-parallel workers x {M} model ranks, the process "
                f"group has {size} ranks")
        self.dist = dist
        self.backend = dist.get_backend()
        self.async_ops = 0          # all-gathers issued with async_op
        self.global_rank = dist.get_rank()
        self.rank, self.model_rank = divmod(self.global_rank, M)
        self.ranks = [self.rank]
        self.tensor_parallel = M > 1

        def group_of(members):
            return (dist.group.WORLD if len(members) == size
                    else dist.new_group(list(members)))

        # one group per data axis and one over all of them, for every
        # model rank, created in the same order by every rank
        self._groups = {}
        for axes in [(a,) for a in self.data_axes] + [self.data_axes]:
            if axes in self._groups:
                continue
            mine = None
            for r in range(M):
                for members in sorted({tuple(self.group(w, axes))
                                       for w in range(self.world)}):
                    g = group_of([m * M + r for m in members])
                    if r == self.model_rank and self.rank in members:
                        mine = g
            self._groups[axes] = mine
        self.model_group = None
        if M > 1:
            for w in range(self.world):
                g = group_of([w * M + r for r in range(M)])
                if w == self.rank:
                    self.model_group = g

    def _global(self, data_rank: int) -> int:
        return data_rank * self.model_size + self.model_rank

    @property
    def local_workers(self) -> int:
        return 1

    def _pg(self, axis):
        axes = _axes(axis)
        if axes not in self._groups:
            raise ValueError(f"no process group for axes {axes}")
        return self._groups[axes]

    def _staged(self, t: torch.Tensor) -> torch.Tensor:
        # gloo gets host memory, NCCL this rank's card (a payload on the
        # host, such as the allocator's signal, goes over and comes back)
        if self.backend == "gloo":
            return t.cpu()
        return t if t.is_cuda else t.to(torch.device(
            "cuda", torch.cuda.current_device()))

    def _pack(self, payload) -> Tuple[torch.Tensor, list]:
        parts = payload if isinstance(payload, tuple) else (payload,)
        meta = [(p.dtype, tuple(p.shape)) for p in parts]
        buf = torch.cat([p.contiguous().reshape(-1).view(torch.uint8)
                         for p in parts])
        return buf, meta

    @staticmethod
    def _unpack(buf: torch.Tensor, meta, lead: tuple, single: bool):
        out, off = [], 0
        for dtype, shape in meta:
            n = torch.empty((), dtype=dtype).element_size()
            for s in shape:
                n *= s
            part = buf[..., off:off + n].contiguous().view(dtype)
            out.append(part.reshape(lead + shape))
            off += n
        return out[0] if single else tuple(out)

    def all_gather(self, xs: Sequence, axis, async_op: bool = False):
        (x,) = xs
        n = self.axis_size(axis)
        buf, meta = self._pack(x)
        dev = buf.device
        src = self._staged(buf)
        out = torch.empty((n * src.numel(),), dtype=torch.uint8,
                          device=src.device)
        # all_gather_single is the newer name of all_gather_into_tensor
        gather = getattr(self.dist, "all_gather_single", None) or \
            self.dist.all_gather_into_tensor
        work = gather(out, src, group=self._pg(axis), async_op=async_op)

        def finish():
            return [self._unpack(out.to(dev).view(n, -1), meta, (n,),
                                 not isinstance(x, tuple))]

        if not async_op:
            return finish()
        self.async_ops += 1
        return _Pending(work, finish, (src, out))

    def ppermute(self, xs: Sequence, axis: str, perm) -> list:
        (x,) = xs
        me = worker_coords(self.mesh, self.rank)[axis]
        src = self._sources(perm).get(me)
        dst = [d for s, d in perm if s == me]
        buf, meta = self._pack(x)
        dev = buf.device
        send = self._staged(buf)
        recv = torch.zeros_like(send)
        ops = [self.dist.P2POp(self.dist.isend, send, self._global(
            self._peer(self.rank, axis, d))) for d in dst]
        if src is not None:
            ops.append(self.dist.P2POp(self.dist.irecv, recv, self._global(
                self._peer(self.rank, axis, src))))
        if ops:
            for req in self.dist.batch_isend_irecv(ops):
                req.wait()
        return [self._unpack(recv.to(dev), meta, (),
                             not isinstance(x, tuple))]

    def pmean(self, xs: Sequence, axes) -> list:
        n = self.axis_size(axes)
        return [_map(g, lambda t: _ordered_sum(t) / n)
                for g in self.all_gather(xs, axes)]

    def broadcast(self, t: torch.Tensor, src: int = 0) -> torch.Tensor:
        """Global rank ``src``'s ``t`` on every rank of the launch, on
        ``t``'s device: every rank passes a tensor of that shape and
        dtype (the receivers' contents are overwritten)."""
        buf = self._staged(t.contiguous())
        self.dist.broadcast(buf, src=src)
        return t if self.global_rank == src else buf.to(t.device)

    # -- the model group (tensor parallelism) --

    def model_gather(self, t: torch.Tensor) -> torch.Tensor:
        """``(M, *t.shape)``: every model rank's ``t`` in model-rank
        order, on ``t``'s device."""
        src = self._staged(t.contiguous())
        out = torch.empty((self.model_size * src.numel(),), dtype=src.dtype,
                          device=src.device)
        gather = getattr(self.dist, "all_gather_single", None) or \
            self.dist.all_gather_into_tensor
        gather(out, src.reshape(-1), group=self.model_group)
        return out.view((self.model_size,) + tuple(t.shape)).to(t.device)

    def model_all_reduce(self, t: torch.Tensor, op: str = "sum"
                         ) -> torch.Tensor:
        """``all_reduce`` of ``t`` over the model group (``"sum"`` or
        ``"max"``) into a new tensor on ``t``'s device; ``t`` is left as
        it is.  Every rank gets the same result."""
        out = self._staged(t)
        out = out.clone(memory_format=torch.contiguous_format) \
            if out is t else out.contiguous()
        reduce_op = {"sum": self.dist.ReduceOp.SUM,
                     "max": self.dist.ReduceOp.MAX}[op]
        self.dist.all_reduce(out, op=reduce_op, group=self.model_group)
        return out.to(t.device)

    def model_all_to_all(self, send: torch.Tensor, out_splits: Sequence[int],
                         in_splits: Sequence[int]) -> torch.Tensor:
        """``all_to_all_single`` of the 1-D ``send`` over the model group:
        ``in_splits[q]`` elements to model rank ``q``, ``out_splits[q]``
        from it, received in model-rank order on ``send``'s device."""
        src = self._staged(send.contiguous())
        out = torch.empty((sum(out_splits),), dtype=src.dtype,
                          device=src.device)
        self.dist.all_to_all_single(out, src, list(out_splits),
                                    list(in_splits), group=self.model_group)
        return out.to(send.device)


def torchrun_env():
    """``(rank, world_size, local_rank, local_world_size)`` from a
    ``torchrun`` launch's environment, or None outside one."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    world = int(os.environ["WORLD_SIZE"])
    return (int(os.environ["RANK"]), world,
            int(os.environ.get("LOCAL_RANK", 0)),
            int(os.environ.get("LOCAL_WORLD_SIZE", world)))

"""The ``(data, model)`` mesh over ``torch.distributed`` (port of
``repro/launch/mesh.py`` and the mesh context of
``repro/parallel/sharding.py:52-72``), the autograd rules of its
collectives, and ``run_ranks``.

The reference runs one process over a GSPMD mesh; the port runs one
process per rank.  A ``Mesh(n_data, n_model)`` lays the ranks out
data-major, as the reference's device order: rank ``d · n_model + m``
sits at data coordinate ``d`` and model coordinate ``m``.  Each axis
longer than 1 gets a process group per row (the model axis) or column
(the data axis), created by every rank in the same order, and every
collective names its axis.  Several meshes of different shapes may live
over one world (2x1 and 1x2 over two ranks).  The backend is gloo
everywhere, on the CPU and on the card: NCCL refuses two ranks on one
device.  gloo reduces CUDA tensors by staging them through the host
itself, so the reductions take CUDA tensors as they are; its
point-to-point calls take host tensors only (``parallel.pipeline``
stages through the host).

Training differentiates through the model axis's collectives, Megatron's
rules (``copy_to_model``, ``reduce_from_model``, ``gather_from_model``):
the gradient of a replicated value that enters a rank's shard of a
product is summed over the model axis where it enters, so every
replicated leaf's gradient is whole on every rank and every sharded
leaf's covers its own shard.  Serving (no gradient) calls the bare
collectives.  Serving over a data axis runs one scheduler on every rank:
a step whose batch the data axis divides runs each data row's rows and
``all_gather`` puts its tokens together; a step it does not divide (every
B = 1 prefill chunk) runs whole on every row, inside ``replicated_batch``
(the reference's ``batch_spec`` replicates such a batch).

``set_mesh``/``get_mesh`` hold the active mesh per thread, as the
reference's; model code reads it to pick its local shapes.  ``run_ranks``
spawns one process per rank and returns rank 0's result.
"""
from __future__ import annotations

import collections
import contextlib
import datetime
import pickle
import queue
import socket
import threading
import time
import traceback

import torch
import torch.distributed as dist

AXIS_DATA, AXIS_MODEL = "data", "model"


class Mesh:
    """The ``(data, model)`` axes over the default process group, this
    rank's coordinates, and the collectives the model code uses.

    Every collective over an axis longer than 1 is counted
    (``collectives``), timed on the host clock (``collective_s``: gloo on
    a CUDA tensor waits for the card, copies through the host and back,
    so the time includes that wait) and its payload's bytes summed
    (``collective_bytes``); over an axis of 1 it is the identity and
    costs nothing.  Each is counted by its op as well (``by_op``:
    'all-reduce', or 'all-gather' for ``all_gather`` and for
    ``gather_columns``, which runs as an all-reduce of a zero-filled
    whole), by (axis, op) (``by_axis``) and by (op, payload shape)
    (``op_shapes``), which the collective audit reads."""

    axis_names = (AXIS_DATA, AXIS_MODEL)

    def __init__(self, n_data: int = 1, n_model: int = None):
        world = dist.get_world_size()
        if n_model is None:
            n_model = world // n_data
        if n_data < 1 or n_model < 1 or n_data * n_model != world:
            raise ValueError(f"a {n_data}x{n_model} mesh needs "
                             f"{n_data * n_model} ranks, the group has "
                             f"{world}")
        self.shape = {AXIS_DATA: n_data, AXIS_MODEL: n_model}
        self.rank = dist.get_rank()
        self.data_rank, self.model_rank = divmod(self.rank, n_model)
        self._groups, self._ranks = {}, {}
        rows = {AXIS_MODEL: [[d * n_model + m for m in range(n_model)]
                             for d in range(n_data)],
                AXIS_DATA: [[d * n_model + m for d in range(n_data)]
                            for m in range(n_model)]}
        for axis, groups in rows.items():
            if self.shape[axis] == 1:
                continue
            for ranks in groups:
                # every rank creates every group, in the same order; an
                # axis over the whole world is the default group
                g = None if len(ranks) == world else dist.new_group(ranks)
                if self.rank in ranks:
                    self._groups[axis], self._ranks[axis] = g, ranks
        self.collectives = 0
        self.collective_s = 0.0
        self.collective_bytes = 0
        self.by_op = collections.Counter()
        self.by_axis = collections.Counter()
        self.op_shapes = collections.Counter()

    @property
    def n_model(self) -> int:
        return self.shape[AXIS_MODEL]

    @property
    def n_data(self) -> int:
        return self.shape[AXIS_DATA]

    def axis_rank(self, axis: str) -> int:
        return self.model_rank if axis == AXIS_MODEL else self.data_rank

    def group(self, axis: str):
        """(process group, its global ranks in axis order) of this rank's
        row or column along ``axis`` (longer than 1)."""
        return self._groups[axis], self._ranks[axis]

    def counters(self) -> tuple:
        """(collectives, host seconds, bytes) so far."""
        return self.collectives, self.collective_s, self.collective_bytes

    def _count(self, t: torch.Tensor, axis: str, kind: str,
               t0: float) -> None:
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        self.collective_bytes += t.numel() * t.element_size()
        self.by_op[kind] += 1
        self.by_axis[(axis, kind)] += 1
        self.op_shapes[(kind, tuple(t.shape))] += 1

    def _reduce(self, t: torch.Tensor, op, axis: str,
                kind: str = "all-reduce") -> torch.Tensor:
        if self.shape[axis] == 1:
            return t
        t = t.contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op, group=self._groups[axis])
        self._count(t, axis, kind, t0)
        return t

    def all_gather(self, t: torch.Tensor, axis: str = AXIS_DATA
                   ) -> torch.Tensor:
        """The shards ``t`` of every rank of ``axis`` stacked on dim 0 in
        axis order: ``size · t.shape[0]`` rows on every rank (counted by
        its payload, ``t``)."""
        size = self.shape[axis]
        if size == 1:
            return t
        t = t.contiguous()
        t0 = time.perf_counter()
        parts = [torch.empty_like(t) for _ in range(size)]
        dist.all_gather(parts, t, group=self._groups[axis])
        self._count(t, axis, "all-gather", t0)
        return torch.cat(parts, 0)

    def all_reduce_sum(self, t: torch.Tensor, axis: str = AXIS_MODEL
                       ) -> torch.Tensor:
        """The sum of ``t`` over ``axis`` (``t`` is reduced in place
        where it is contiguous); every rank gets the same bits."""
        return self._reduce(t, dist.ReduceOp.SUM, axis)

    def all_reduce_max(self, t: torch.Tensor, axis: str = AXIS_MODEL
                       ) -> torch.Tensor:
        """The elementwise max of ``t`` over ``axis``."""
        return self._reduce(t, dist.ReduceOp.MAX, axis)

    def gather_columns(self, t: torch.Tensor, dim: int = -1
                       ) -> torch.Tensor:
        """The model axis's shards of ``t`` along ``dim`` (n long) side by
        side, in rank order: n · size long on every rank, bit for bit (a
        sum of a zero-filled whole: ``x + 0 = x``)."""
        size = self.n_model
        if size == 1:
            return t
        n, r = t.shape[dim], self.model_rank
        shape = list(t.shape)
        shape[dim] = n * size
        full = t.new_zeros(shape)
        full.narrow(dim, r * n, n).copy_(t)
        return self._reduce(full, dist.ReduceOp.SUM, AXIS_MODEL,
                            kind="all-gather")

    def agree(self, obj) -> bool:
        """Whether every rank holds an equal ``obj`` (compared by its
        pickle, so lists, dicts and numpy arrays compare by value)."""
        mine = pickle.dumps(obj)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine)
        return all(g == mine for g in got)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` holds on some rank (uncounted: a host
        tensor)."""
        t = torch.tensor([int(bool(flag))], dtype=torch.int32)
        dist.all_reduce(t, op=dist.ReduceOp.MAX)
        return bool(t.item())

    def barrier(self) -> None:
        dist.barrier()

    @contextlib.contextmanager
    def in_turns(self):
        """Run the ``with`` body on one rank at a time, in rank order (a
        rank's peak memory, and a bundle it writes, never meet another's);
        the card's cached blocks are released before the next rank's
        turn."""
        for r in range(dist.get_world_size()):
            if r == self.rank:
                yield
                if torch.cuda.is_available():
                    torch.cuda.empty_cache()
            dist.barrier()


# ---------------------------------------------------------------------------
# the model axis's collectives under autograd (Megatron's f, g and the
# logits gather)
# ---------------------------------------------------------------------------

class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduce_sum(g.clone()), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduce_sum(x.clone())

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[-1]
        return mesh.gather_columns(x)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.model_rank, ctx.n
        return g[..., r * n:(r + 1) * n].contiguous(), None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh, ctx.n = mesh, x.shape[0]
        return mesh.all_gather(x, AXIS_DATA)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.mesh.data_rank, ctx.n
        return g[r * n:(r + 1) * n].contiguous(), None


def gather_from_data(x: torch.Tensor) -> torch.Tensor:
    """Every data row's rows of ``x`` stacked in row order
    (``Mesh.all_gather``); backward, this row's rows of the gradient (the
    caller's output on this row depends on the other rows' inputs through
    nothing differentiable).  ``x`` itself without a data axis."""
    mesh = get_mesh()
    if mesh is None or mesh.n_data == 1:
        return x
    if torch.is_grad_enabled() and x.requires_grad:
        return _GatherFromData.apply(x, mesh)
    return mesh.all_gather(x, AXIS_DATA)


def _grad_mesh(x: torch.Tensor):
    mesh = get_mesh()
    if mesh is None or mesh.n_model == 1:
        return None, mesh
    return (mesh if torch.is_grad_enabled() and x.requires_grad
            else None), mesh


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """A replicated value entering this rank's shard of a product: the
    identity forward; backward, its gradient summed over the model axis
    (each rank's covers only its shard's share)."""
    g, _ = _grad_mesh(x)
    return x if g is None else _CopyToModel.apply(x, g)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum of the model axis's partials ``x`` (a row shard's
    product); backward, the identity (the sum's gradient is whole on every
    rank).  Without a gradient, the bare in-place all-reduce."""
    g, mesh = _grad_mesh(x)
    if g is None:
        return x if mesh is None else mesh.all_reduce_sum(x)
    return _ReduceFromModel.apply(x, g)


def gather_from_model(x: torch.Tensor) -> torch.Tensor:
    """The model axis's column shards side by side; backward, this rank's
    columns of the gradient."""
    g, mesh = _grad_mesh(x)
    if g is None:
        return x if mesh is None else mesh.gather_columns(x)
    return _GatherFromModel.apply(x, g)


_ctx = threading.local()


@contextlib.contextmanager
def set_mesh(mesh):
    """Activate ``mesh`` (None: none) for the model code in the ``with``
    body, on this thread."""
    prev = getattr(_ctx, "mesh", None)
    _ctx.mesh = mesh
    try:
        yield mesh
    finally:
        _ctx.mesh = prev


def get_mesh():
    """The active ``Mesh`` of this thread, or None."""
    return getattr(_ctx, "mesh", None)


@contextlib.contextmanager
def replicated_batch(on: bool = True):
    """Mark the model calls in the ``with`` body as holding the whole
    batch on every data row (a batch the data axis does not divide, which
    the reference's ``batch_spec`` replicates); outside it a call's batch
    is this data row's shard (a training batch, a split serving step)."""
    prev = getattr(_ctx, "replicated", False)
    _ctx.replicated = on
    try:
        yield
    finally:
        _ctx.replicated = prev


def batch_replicated() -> bool:
    """Whether the running model call holds the whole batch on every
    data row (``replicated_batch``)."""
    return getattr(_ctx, "replicated", False)


def make_test_mesh(n_data: int = 1, n_model: int = 2) -> Mesh:
    """A ``(n_data, n_model)`` mesh over the process group this rank
    joined (``run_ranks`` joins it); every rank must make it, in the same
    order as its other meshes."""
    return Mesh(n_data, n_model)


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, rank, world, n_data, port, device, args, out_q):
    try:
        dev = torch.device(device)
        if dev.type == "cpu":
            torch.set_num_threads(1)
        else:
            torch.cuda.set_device(dev.index or 0)
        dist.init_process_group(
            "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
            world_size=world, timeout=datetime.timedelta(minutes=10))
        mesh = make_test_mesh(n_data, world // n_data)
        out = fn(mesh, *args)
        # pickled here by value: a queue would share a tensor's storage
        # with a process that is about to exit
        out_q.put((rank, True, pickle.dumps(out) if rank == 0 else None))
    except BaseException:
        out_q.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def run_ranks(fn, n_model: int, *args, n_data: int = 1, device="cpu",
              timeout: float = 3600.0):
    """``fn(mesh, *args)`` on ``n_data · n_model`` spawned ranks joined
    over gloo; returns rank 0's result (host objects only: it is pickled
    back).  ``fn`` must be importable by name (a module-level function).
    A rank that raises fails the call with its traceback, and the other
    ranks are stopped.  On the card every rank uses ``device``; the
    kernels are built here first, so the ranks load the cached build."""
    import multiprocessing as mp
    if torch.device(device).type == "cuda":
        from repro_torch.kernels import build
        build.build()
    world = n_data * n_model
    ctx = mp.get_context("spawn")
    out_q = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, n_data, port, str(device), args,
                               out_q), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results, deadline = {}, time.monotonic() + timeout
    try:
        while len(results) < world:
            try:
                rank, ok, val = out_q.get(timeout=1.0)
            except queue.Empty:
                dead = [(r, p.exitcode) for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f"rank {dead[0][0]} exited with code "
                                       f"{dead[0][1]} before its result")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks not done in {timeout:.0f}s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{val}")
            results[rank] = val
        for p in procs:
            p.join(timeout=120)
        codes = [p.exitcode for p in procs]
        if any(c != 0 for c in codes):
            raise RuntimeError(f"ranks exited with codes {codes}")
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(timeout=30)
    return pickle.loads(results[0])

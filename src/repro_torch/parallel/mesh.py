"""The tensor-parallel mesh over ``torch.distributed`` (port of
``repro/launch/mesh.py`` and the mesh context of
``repro/parallel/sharding.py:52-72``).

The reference runs one process over a GSPMD mesh; the port runs one
process per rank.  A ``Mesh`` is the process group with the axes
``(data, model)``: this slice takes ``data = 1`` only (the data axis is a
ROADMAP item), so the model axis is the whole group.  The backend is gloo
everywhere, on the CPU and on the card: NCCL refuses two ranks on one
device.  gloo reduces CUDA tensors by staging them through the host
itself, so ``all_reduce_sum``/``all_reduce_max`` take CUDA tensors as
they are; the column gather is an ``all_reduce_sum`` of a zero-filled full
buffer, exact since ``x + 0 = x`` in f32.

``set_mesh``/``get_mesh`` hold the active mesh per thread, as the
reference's; model code reads it to pick its local shapes.  ``run_ranks``
spawns one process per rank and returns rank 0's result.
"""
from __future__ import annotations

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
DATA_AXIS_TODO = ("a data axis (--mesh DxM with D > 1) is not ported yet: "
                  "ROADMAP Queue A, item 3 (the data axis)")


class Mesh:
    """The ``(data, model)`` axes over the default process group, this
    rank's coordinates, and the collectives the model code uses.

    Every collective is counted (``collectives``) and timed on the host
    clock (``collective_s``): gloo on a CUDA tensor waits for the card,
    copies through the host and back, so the time includes that wait."""

    axis_names = (AXIS_DATA, AXIS_MODEL)

    def __init__(self, n_data: int = 1, n_model: int = None):
        world = dist.get_world_size()
        if n_model is None:
            n_model = world // n_data
        if n_data != 1:
            raise NotImplementedError(DATA_AXIS_TODO)
        if n_data * n_model != world:
            raise ValueError(f"a {n_data}x{n_model} mesh needs "
                             f"{n_data * n_model} ranks, the group has "
                             f"{world}")
        self.shape = {AXIS_DATA: n_data, AXIS_MODEL: n_model}
        self.rank = dist.get_rank()
        self.model_rank = self.rank % n_model
        self.collectives = 0
        self.collective_s = 0.0

    @property
    def n_model(self) -> int:
        return self.shape[AXIS_MODEL]

    def _reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        t = t.contiguous()
        t0 = time.perf_counter()
        dist.all_reduce(t, op=op)
        self.collective_s += time.perf_counter() - t0
        self.collectives += 1
        return t

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        """The sum of ``t`` over the model axis (``t`` is reduced in place
        where it is contiguous); every rank gets the same bits."""
        return self._reduce(t, dist.ReduceOp.SUM)

    def all_reduce_max(self, t: torch.Tensor) -> torch.Tensor:
        """The elementwise max of ``t`` over the model axis."""
        return self._reduce(t, dist.ReduceOp.MAX)

    def gather_columns(self, t: torch.Tensor) -> torch.Tensor:
        """The model axis's column shards of ``t`` (..., n) side by side,
        in rank order: (..., n · n_model) on every rank, bit for bit."""
        n = t.shape[-1]
        full = t.new_zeros(*t.shape[:-1], n * self.n_model)
        full[..., self.model_rank * n:(self.model_rank + 1) * n] = t
        return self.all_reduce_sum(full)

    def agree(self, obj) -> bool:
        """Whether every rank holds an equal ``obj`` (compared by its
        pickle, so lists, dicts and numpy arrays compare by value)."""
        mine = pickle.dumps(obj)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, mine)
        return all(g == mine for g in got)

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


def make_test_mesh(n_data: int = 1, n_model: int = 2) -> Mesh:
    """A ``(n_data, n_model)`` mesh over the process group this rank
    joined (``run_ranks`` joins it)."""
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
    if n_data != 1:
        raise NotImplementedError(DATA_AXIS_TODO)
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

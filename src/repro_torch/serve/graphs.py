"""The engine's steps as captured CUDA graphs: the port's counterpart of
the reference's jitted serving steps (``repro/serve/engine.py``
``_jitted_paged_steps`` / ``_jitted_spec_steps``).

A ``Step`` wraps one step function already bound to the engine's params
and pools.  Its inputs are int32 numpy arrays (tokens, the cache's page
table and lens), which it copies into one device buffer of its own (one
host-to-device copy per call), or device tensors that stay the same from
call to call (the draft step's output and its bound inputs, which the
verify step reads).  On the card the first call runs the function
once on a side stream (the warm-up: the kernels' first launches, library
set-up; a step rewrites the same K/V from the same inputs, so running it
twice changes nothing), captures it into a CUDA graph and replays it;
later calls copy their inputs in and replay.  The outputs are the graph's
own tensors, overwritten by the next replay: read them first.

Replays skip the kernels' Python wrappers, whose launch counters would
then stop.  Each graph records the change of every registered counter
(``repro_torch.kernels.counts``) during its capture, undoes it (the
capture ran nothing) and adds it on every replay.

A failed capture or replay raises; nothing falls back to eager execution.
With ``graphs=False`` the same function runs eagerly on the same buffers.
``captures`` counts a step's captures and ``binds`` its first bindings of
its input buffers (the call that captures on the card), which the
captured-step audit (``analysis/compiled.py``) pins on either path.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels.counts import (add_counts, diff_counts,
                                        launch_counts, set_launch_counts)


class Step:
    """One engine step: ``fn(*inputs)`` eagerly, or captured once into a
    CUDA graph and replayed (``graphs=True``, the card only).

    With ``Step.keep_graph`` set before a capture, the graph keeps its
    node list beside its instantiated form (``CUDAGraph(keep_graph=True)``),
    so that ``graph.debug_dump(path)`` can write every node it replays."""

    keep_graph = False

    def __init__(self, name: str, fn, device, graphs: bool):
        device = torch.device(device)
        if graphs and device.type != "cuda":
            raise ValueError(f"CUDA graphs need the card, not {device}")
        self.name, self.fn, self.device, self.graphs = (name, fn, device,
                                                        graphs)
        self._block = None            # device buffer of the numpy inputs
        self._args = None             # the arguments fn is called with
        self.graph = None
        self.out = None
        self.delta = None             # launch counters added per replay
        self.captures = 0
        self.binds = 0                # input buffers set up (first call)

    def arg(self, i: int) -> torch.Tensor:
        """The device tensor the step reads as its input ``i``."""
        return self._args[i]

    @torch.inference_mode()
    def __call__(self, *inputs):
        args = self._bind(inputs)
        if not self.graphs:
            return self.fn(*args)
        if self.graph is None:
            self._capture(args)
        self.graph.replay()
        add_counts(self.delta)
        return self.out

    def _bind(self, inputs):
        """Copy the numpy inputs into the step's buffer (one copy) and
        return the arguments: its views, and the device tensors as given
        (on a graph, the very tensors it was captured with)."""
        host = [x for x in inputs if isinstance(x, np.ndarray)]
        if self._args is None:
            self.binds += 1
            self._block = torch.empty(sum(x.size for x in host),
                                      dtype=torch.int32, device=self.device)
            args, off = [], 0
            for x in inputs:
                if isinstance(x, np.ndarray):
                    args.append(self._block[off:off + x.size].view(x.shape))
                    off += x.size
                else:
                    args.append(x)
            self._args = args
        elif len(inputs) != len(self._args):
            raise ValueError(f"{self.name}: {len(inputs)} inputs, "
                             f"expected {len(self._args)}")
        args = list(self._args)
        for i, (x, a) in enumerate(zip(inputs, self._args)):
            if tuple(x.shape) != tuple(a.shape):
                raise ValueError(f"{self.name}: input {i} has shape "
                                 f"{tuple(x.shape)}, the step takes "
                                 f"{tuple(a.shape)}")
            if isinstance(x, np.ndarray):
                continue
            if self.graphs and x is not a:
                raise ValueError(f"{self.name}: input {i} must be the "
                                 "tensor the graph was captured with")
            args[i] = x
        if host:
            self._block.copy_(torch.from_numpy(np.concatenate(
                [np.asarray(x, np.int32).ravel() for x in host])))
        return args

    def _capture(self, args) -> None:
        cur = torch.cuda.current_stream(self.device)
        side = torch.cuda.Stream(self.device)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            self.fn(*args)
        cur.wait_stream(side)
        before = launch_counts()
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_graph)
        with torch.cuda.graph(graph):
            out = self.fn(*args)
        if self.keep_graph:
            graph.instantiate()
        self.delta = diff_counts(launch_counts(), before)
        set_launch_counts(before)
        self.graph, self.out = graph, out
        self.captures += 1

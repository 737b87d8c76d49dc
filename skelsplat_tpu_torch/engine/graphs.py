"""Captured macro steps (counterpart of the jitted scene programs that
``skelsplat_tpu/engine/trainer.py::_build_run`` returns).

JAX runs a scene's prepare and all of its macro steps as one compiled
program (``jit`` of a ``lax.scan``). On the card the counterpart is a CUDA
graph: ``StepGraph`` captures ONE macro step (the forward over the visited
views, K1, autograd, the gradient composition, Adam, the early-stop window
and the history writes) and the trainer replays it once per macro step.
The step reads its index from a device counter that the step itself
advances, so the same graph serves every step of every scene of its shape.

A graph works on static buffers: the scene's inputs (cameras, view aux,
2D poses, GT pose, extent) and the loop state (the carry, the history, the
stop iteration, the step counter). ``load`` copies a new scene into them;
the results are read from them after the last replay, before the next
``load``. Per-scene set-up (initial parameters, the GT spec) stays eager.

Why one macro step and not the whole scene: checkpoints
(``checkpoint_iterations``) and ``pipeline.debug``'s finite check (a host
sync) run between replays, and a ~1,200-node graph is cheap to capture
and replays the same kernels as 125 copies of it would.

Capture follows ``torch.cuda.graphs``: the first ``WARMUP_STEPS`` steps of
a graph's shape run eagerly on a side stream (autograd and the caching
allocator set themselves up there) and are real steps of the scene; the
next step is captured, into the graph's own memory pool, and then
replayed. Each graph keeps its own pool: graphs of a sweep of mixed shapes
do not replay in the order they were captured, which a shared pool would
need. A capture or replay failure raises; nothing falls back to the eager
loop.

The K1 wrapper counts its launches in ``cuda_raster.launches`` where it
launches. During a capture it launches nothing, so the graph undoes the
count that capture made, keeps it as the launches the graph holds, and
adds them on every replay.
"""

from __future__ import annotations

import ctypes
import time

import torch

from skelsplat_tpu_torch.ops import cuda_raster
from skelsplat_tpu_torch.utils import tree_leaves, tree_map

WARMUP_STEPS = 3


def graph_nodes(graph: torch.cuda.CUDAGraph) -> int:
    """Nodes of a captured graph kept with ``keep_graph=True``, by the
    driver API's ``cuGraphGetNodes``."""
    lib = ctypes.CDLL("libcuda.so.1")
    lib.cuGraphGetNodes.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_size_t)]
    n = ctypes.c_size_t(0)
    rc = lib.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None,
                             ctypes.byref(n))
    if rc != 0:
        raise RuntimeError(f"cuGraphGetNodes failed (CUresult {rc})")
    return int(n.value)


def _assign(dst, src):
    """Copy every leaf of ``src`` into the same-shaped leaf of ``dst``."""
    for d, s in zip(tree_leaves(dst), tree_leaves(src), strict=True):
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"static buffer {tuple(d.shape)} {d.dtype} "
                             f"cannot take {tuple(s.shape)} {s.dtype}")
        d.copy_(s)


class StepGraph:
    """One macro step of one program shape, captured on first use.

    ``inputs`` and ``state`` are trees of the first scene's tensors: the
    graph keeps copies of them as its static buffers. ``make_step(inputs,
    state)`` returns the step over the static buffers: a function of no
    argument that runs one macro step, updating ``state`` in place, and
    returns tensors the caller may read after it (the step's losses and
    gradients)."""

    def __init__(self, inputs, state, make_step):
        self.inputs = tree_map(torch.clone, inputs)
        self.state = tree_map(torch.clone, state)
        self._step = make_step(self.inputs, self.state)
        self.graph = None
        self.outputs = None
        self.warm = 0
        self.launches = {}          # kernel launches one replay makes
        self.capture_seconds = None
        self.instantiate_seconds = None
        self.nodes = None
        self.replays = 0
        self._side = torch.cuda.Stream()

    def load(self, inputs, state):
        """A scene's inputs and initial loop state into the static
        buffers."""
        _assign(self.inputs, inputs)
        _assign(self.state, state)

    def step(self):
        """Run one macro step: a warm-up step, or the capture and its first
        replay, or a replay."""
        if self.graph is None:
            if self.warm < WARMUP_STEPS:
                self.warm += 1
                return self._warm_step()
            self._capture()
        self.graph.replay()
        self.replays += 1
        for name, n in self.launches.items():
            cuda_raster.launches[name] += n
        return self.outputs

    def _warm_step(self):
        main = torch.cuda.current_stream()
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = self._step()
        main.wait_stream(self._side)
        for t in tree_leaves(out):
            t.record_stream(main)
        return out

    def _capture(self):
        before = dict(cuda_raster.launches)
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        t0 = time.perf_counter()
        # thread-local: a call another thread makes meanwhile (the
        # profiler's, NCCL's watchdog) must not invalidate this capture
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            self.outputs = self._step()
        torch.cuda.synchronize()
        self.capture_seconds = time.perf_counter() - t0
        self.launches = {k: cuda_raster.launches[k] - before[k]
                         for k in before}
        cuda_raster.launches.update(before)
        self.nodes = graph_nodes(graph)
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize()
        self.instantiate_seconds = time.perf_counter() - t0
        self.graph = graph

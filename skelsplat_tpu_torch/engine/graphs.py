"""Captured scene programs (counterpart of the jitted scene programs that
``skelsplat_tpu/engine/trainer.py::_build_run`` returns).

JAX runs a scene's prepare and all of its macro steps as one compiled
program (``jit`` of a ``lax.scan``), and a chain of scenes as a scan of
that program. On the card the counterpart is a set of CUDA graphs per
program shape, held by one ``StepGraph``:

* the **prepare**: scene g's set-up from the static group buffers (the
  initial parameters, the GT spec and the view aux, the fresh Adam state,
  the early-stop window seeded from the group's window buffer), written
  into the step's static buffers: the scene's inputs, the carry, the
  history, the stop iteration and the step counter;
* the **step**: ONE macro step (the forward over the visited views
  through any renderer, K1 or the fused or dense autograd renderer, the
  backward, the gradient composition, Adam, the early-stop window and the
  history writes), replayed once per macro step. It reads its index from
  a device counter that the step itself advances, so the same graph
  serves every step of every scene of its shape;
* the **collect** (a chain's): scene g's results into the group's stacked
  outputs, its window into the window buffer (the next scene's seed), and
  the device scene counter advanced, so the next prepare picks scene
  g + 1.

The host copies a group's inputs into the group buffers once (``load``);
between two scenes of the group it launches graphs only. Checkpoints
(``checkpoint_iterations``) and ``pipeline.debug``'s finite check (a host
sync) run between step replays; a ~1,200-node step is cheap to capture
and replays the same kernels as 125 copies of it would.

Capture follows ``torch.cuda.graphs``: the first ``WARMUP_STEPS`` steps of
a graph's shape run eagerly on a side stream (autograd and the caching
allocator set themselves up there) and are real steps of the scene; the
next step is captured, into the graph's own memory pool, and then
replayed. The first prepare and the first collect of a shape run eagerly
on the current stream and allocate the static buffers; the next ones are
captured. Each graph keeps its own pool: graphs of a sweep of mixed shapes
do not replay in the order they were captured, which a shared pool would
need. Python's collector is off during a capture: a graph destroyed
inside another's capture invalidates it. A capture or
replay failure raises; nothing falls back to the eager loop.

A capture launches nothing, so the counts of device work it makes are
held back (``tracing.capturing``) and credited on every replay.
"""

from __future__ import annotations

import ctypes
import gc
import time

import torch

from skelsplat_tpu_torch import tracing
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


class Program:
    """A function of no argument over static buffers, captured on first
    use: its first ``warmup`` calls run eagerly on a side stream, the next
    is captured into a graph of its own (its own memory pool) and
    replayed, and every later call is a replay. Returns what the function
    returned when it was captured (tensors of the graph's pool, rewritten
    by every replay). ``kind`` names the program (prepare, step, collect)
    in the ``tracing`` counters and replay records; ``credit`` is what
    one replay adds to the counters (``tracing.Credit``)."""

    def __init__(self, fn, warmup: int, kind: str):
        self._fn = fn
        self._warmup = warmup
        self.kind = kind
        self.warm = 0
        self.graph = None
        self.outputs = None
        self.credit = None
        self.capture_seconds = None
        self.instantiate_seconds = None
        self.nodes = None
        self._side = torch.cuda.Stream() if warmup else None

    def __call__(self):
        if self.graph is None:
            if self.warm < self._warmup:
                self.warm += 1
                return self._warm_call()
            self._capture()
        with tracing.replay(self.kind):
            self.graph.replay()
        tracing.credit(self.credit)
        return self.outputs

    def _warm_call(self):
        main = torch.cuda.current_stream()
        self._side.wait_stream(main)
        with torch.cuda.stream(self._side):
            out = self._fn()
        main.wait_stream(self._side)
        for t in tree_leaves(out):
            t.record_stream(main)
        return out

    def _capture(self):
        # the capture's own time: the queued work drained and the cache
        # emptied first (torch.cuda.graph empties it on entry)
        torch.cuda.synchronize()
        tracing.synced("graphs.capture")
        torch.cuda.empty_cache()
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        with tracing.span("skelsplat.capture") as capture, \
                tracing.capturing(self.kind) as held:
            # a dead trainer's graphs sit in reference cycles, and the
            # collector would run their destructor (cudaGraphExecDestroy,
            # not permitted while capturing) wherever it fires: not inside
            # the capture
            collecting = gc.isenabled()
            gc.disable()
            try:
                # thread-local: a call another thread makes meanwhile (the
                # profiler's, NCCL's watchdog) must not invalidate this
                # capture
                with torch.cuda.graph(graph,
                                      capture_error_mode="thread_local"):
                    self.outputs = self._fn()
            finally:
                if collecting:
                    gc.enable()
            torch.cuda.synchronize()
            tracing.synced("graphs.capture")
        self.capture_seconds = capture.seconds
        self.credit = tracing.Credit(self.kind, held)
        self.nodes = graph_nodes(graph)
        t0 = time.perf_counter()
        graph.instantiate()
        torch.cuda.synchronize()
        tracing.synced("graphs.instantiate")
        self.instantiate_seconds = time.perf_counter() - t0
        self.graph = graph


class StepGraph:
    """The captured programs of one program shape: a scene's prepare, its
    macro step and a chain's collect, over static buffers.

    ``group_inputs`` is a tree of the first group's inputs, every leaf
    with a leading group axis: the graph keeps buffers of their shapes
    (grown when a larger group comes). ``make_scene(group, scene,
    window)`` returns (inputs, state): the step's inputs and the initial
    loop state of the scene at the device index ``scene`` of ``group``,
    its early-stop window seeded from ``window`` (None without early
    stopping). ``make_step(inputs, state)`` returns the step over the
    static buffers: a function of no argument that runs one macro step,
    updating ``state`` in place, and returns tensors the caller may read
    after it (the step's losses and gradients). ``make_results(inputs,
    state)`` returns the tree of a finished scene's results that a chain
    collects; ``window_of(state)`` its final early-stop window.
    ``window_shape`` is the window buffer's shape (None without early
    stopping)."""

    def __init__(self, group_inputs, make_scene, make_step, make_results,
                 window_shape=None, window_of=None):
        self._make_scene = make_scene
        self._make_step = make_step
        self._make_results = make_results
        self._window_of = window_of
        dev = tree_leaves(group_inputs)[0].device
        self.scene = torch.zeros((), dtype=torch.int64, device=dev)
        self.window = (None if window_shape is None else
                       torch.zeros(window_shape, dtype=torch.float32,
                                   device=dev))
        self.group = None
        self.capacity = 0
        self.inputs = None          # the step's inputs, written by prepare
        self.state = None           # the loop state, written by prepare
        self.out = None             # a chain's stacked results
        self.step_program = None
        self.prepare_program = self.collect_program = None
        self._grow(group_inputs)

    # the step program's figures, under the names the step graph had
    nodes = property(lambda self: self.step_program.nodes)
    capture_seconds = property(lambda self: self.step_program.capture_seconds)
    instantiate_seconds = property(
        lambda self: self.step_program.instantiate_seconds)

    def _grow(self, group_inputs):
        """Group buffers that hold ``group_inputs``' group; the prepare and
        collect read and write the buffers they were captured with, so
        new buffers mean new captures."""
        n = tree_leaves(group_inputs)[0].shape[0]
        if n <= self.capacity:
            return
        self.capacity = n
        self.group = tree_map(
            lambda x: x.new_empty((n,) + tuple(x.shape[1:])), group_inputs)
        self.prepare_program = Program(self._prepare_into, 0, "prepare")
        self.collect_program = Program(self._collect_into, 0, "collect")
        self.out = None

    def load(self, group_inputs, window=None):
        """A group's inputs (leading group axis) into the group buffers,
        the scene counter to 0 and the early-stop window to ``window``
        (+inf when None)."""
        with tracing.span("skelsplat.load"):
            self._grow(group_inputs)
            n = tree_leaves(group_inputs)[0].shape[0]
            for d, s in zip(tree_leaves(self.group),
                            tree_leaves(group_inputs), strict=True):
                d[:n].copy_(s)
            self.scene.zero_()
            if self.window is not None:
                if window is None:
                    self.window.fill_(float("inf"))
                else:
                    self.window.copy_(window)

    def prepare(self):
        """Set up the scene at the scene counter: the first call of a
        shape runs eagerly and allocates the step's static buffers; later
        calls replay the captured prepare."""
        if self.inputs is None:
            inputs, state = self._make_scene(self.group, self.scene,
                                             self.window)
            self.inputs = tree_map(torch.clone, inputs)
            self.state = tree_map(torch.clone, state)
            return
        self.prepare_program()

    def _prepare_into(self):
        inputs, state = self._make_scene(self.group, self.scene,
                                         self.window)
        _assign(self.inputs, inputs)
        _assign(self.state, state)

    def step(self):
        """Run one macro step: a warm-up step, or the capture and its first
        replay, or a replay."""
        if self.step_program is None:
            run = self._make_step(self.inputs, self.state)
            self.step_program = Program(run, WARMUP_STEPS, "step")
        return self.step_program()

    def collect(self):
        """A chain's: the finished scene's results into row ``scene`` of
        the stacked outputs, its window into the window buffer, and the
        scene counter advanced. The first call after the group buffers
        are made allocates the outputs eagerly; later calls replay the
        captured collect."""
        if self.out is None:
            res = self._make_results(self.inputs, self.state)
            self.out = tree_map(
                lambda x: x.new_zeros((self.capacity,) + tuple(x.shape)), res)
            self._collect_into(res)
            return
        self.collect_program()

    def _collect_into(self, res=None):
        if res is None:
            res = self._make_results(self.inputs, self.state)
        at = self.scene.reshape(1)
        for o, x in zip(tree_leaves(self.out), tree_leaves(res), strict=True):
            o.index_copy_(0, at, x.unsqueeze(0))
        if self.window is not None:
            self.window.copy_(self._window_of(self.state))
        self.scene.add_(1)

    def collected(self, n: int):
        """Copies of the first ``n`` scenes' collected results, and of the
        window the last one left (None without early stopping)."""
        out = tree_map(lambda o: o[:n].clone(), self.out)
        return out, None if self.window is None else self.window.clone()

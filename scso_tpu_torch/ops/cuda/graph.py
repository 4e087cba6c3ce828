"""Loops on the device: conditionals inside captured CUDA graphs, and a
cache of the captured solves.

The JAX package runs a solve as one jitted `lax.while_loop` whose CG and
Armijo loops are `lax.while_loop`s too. Here a solve's loop bodies are
captured into CUDA graphs and replayed: every data-dependent branch is
:func:`device_if`, a conditional node of the graph whose predicate is a
0-d bool tensor computed on the card just before it, and a loop
(:func:`device_loop`) is a WHILE conditional node whose body, captured
once, ends by setting the node's handle from its own test again. The
host reads the card only between replays.

On a CPU tensor the same calls run their plain form (``if bool(pred):
body()``), which is no synchronisation; this is the form the CPU tests
run. On a CUDA tensor :func:`device_if` records a conditional node while a
graph is being captured, and raises otherwise, unless the caller asked
for the eager form explicitly (:func:`eager`: the solve loops' private
``capture=False``, and timed mode on a row shard, whose collectives
cannot sit inside a conditional node): the same bodies then run eagerly,
reading each predicate on the host. That form is chosen by its caller,
never a fallback.

Under ``torch.func.vmap`` (the batched solve, `algorithms.batched`) a
predicate holds one bool an instance. There the helpers take the JAX
package's vmap semantics: :func:`device_loop` runs while ANY instance
is live (one loop on the device, its test the OR of the instances'
predicates) and updates each instance's ``state`` under its
own mask, ``torch.where(live, new, old)``; :func:`device_cond` runs both
branches and selects. :func:`device_if` has no other branch to select
and refuses a batched predicate.

The conditional nodes are the repo's own (``csrc/graph.cu``: this
PyTorch has no API for them): a one-thread kernel sets the node's
handle from the predicate (for a WHILE node, again at the end of its
body), and the body is captured on a side stream, one a nesting depth,
into the node's body graph.

A body may read any tensor made before its conditional and must write
what outlives it into such a tensor (``copy_``): a skipped body leaves
its own temporaries unwritten. Every graph captures into one memory pool
a card, and every body into a second one (the allocator routes the
side streams there while a capture runs); no tensor of either stays
referenced past its capture, so all graphs share their temporaries.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
import time
import weakref

import torch
import torch._C._functorch as _functorch

from scso_tpu_torch.ops.cuda import build, counters

#: what the solve loops did on the card since :func:`reset_stats`: graphs
#: captured, seconds spent capturing (instantiation included), replays,
#: and host reads (a read of the card that waits for it; the eager form
#: counts one a predicate)
STATS = {"captures": 0, "capture_s": 0.0, "replays": 0, "host_reads": 0}

_state = threading.local()


def reset_stats() -> None:
    STATS.update(captures=0, capture_s=0.0, replays=0, host_reads=0)


def host_read(count: int = 1) -> None:
    """Count ``count`` host reads of the card (the solve loops call it)."""
    STATS["host_reads"] += count


@contextlib.contextmanager
def eager():
    """Run :func:`device_if` bodies on CUDA tensors eagerly, each
    predicate read on the host: the reference form of a captured solve,
    for checks on the card, and a row shard's timed mode. Private to the
    solve loops."""
    prev = getattr(_state, "eager", False)
    _state.eager = True
    try:
        yield
    finally:
        _state.eager = prev


def _plain(pred: torch.Tensor) -> bool:
    """True where ``pred`` is read on the host: a CPU tensor, or a CUDA
    tensor in the eager form. False while capturing; raises on a CUDA
    tensor otherwise."""
    if pred.device.type == "cpu":
        return True
    if pred.device.type != "cuda":
        raise ValueError(f"device_if: tensors on {pred.device} are not "
                         "supported")
    if torch.cuda.is_current_stream_capturing():
        return False
    if getattr(_state, "eager", False):
        return True
    raise RuntimeError(
        "device_if on a CUDA tensor outside a graph capture: the solve "
        "loops run on the card only as captured graphs")


def _read(pred: torch.Tensor) -> bool:
    if pred.device.type == "cuda":
        host_read()
    return bool(pred)


def is_batched(t) -> bool:
    """True for a tensor batched by ``torch.func.vmap``: one value an
    instance of a batched solve."""
    return isinstance(t, torch.Tensor) and _functorch.is_batchedtensor(t)


def _any_live(pred: torch.Tensor) -> torch.Tensor:
    """A 0-d bool tensor, outside the vmap level: whether the batched
    ``pred`` holds for any instance."""
    flat = _functorch.get_unwrapped(pred)
    if is_batched(flat):
        raise ValueError("device_loop: nested vmap levels are not supported")
    return flat.any()


def device_if(pred: torch.Tensor, body) -> None:
    """``body()`` where the 0-d bool tensor ``pred`` is true: a
    conditional node under capture, ``if bool(pred)`` in the plain and
    eager forms."""
    _check_pred(pred)
    if is_batched(pred):
        raise ValueError(
            "device_if on a per-instance predicate: a batched solve has no "
            "branch to select instead; use device_cond")
    if _plain(pred):
        if _read(pred):
            body()
        return
    _conditional(pred, body, loop=False)


def _check_pred(pred: torch.Tensor) -> None:
    if pred.dtype != torch.bool or pred.numel() != 1:
        raise ValueError(f"device_if: pred must be one bool, got "
                         f"{pred.dtype} of shape {tuple(pred.shape)}")


def _conditional(pred: torch.Tensor, body, loop: bool) -> None:
    """Capture ``body`` into an IF node on ``pred`` or, with ``loop``, a
    WHILE node that tests ``pred`` before each run of its body."""
    lib = build.load()
    depth = getattr(_state, "depth", 0)
    parent = torch.cuda.current_stream()
    child = _side_stream(parent.device.index, depth)
    if not pred.is_contiguous():
        raise ValueError("device_if: pred must be contiguous")
    handle = ctypes.c_uint64(0)
    build.check(lib.scso_graph_cond_begin(
        parent.cuda_stream, pred.data_ptr(), child.cuda_stream, int(loop),
        ctypes.addressof(handle)), "device_if")
    nodes = ctypes.c_int64(0)
    _state.depth = depth + 1
    try:
        with torch.cuda.stream(child):
            body()
    finally:
        _state.depth = depth
        build.check(lib.scso_graph_cond_end(
            child.cuda_stream, handle.value,
            pred.data_ptr() if loop else None, ctypes.addressof(nodes)),
            "device_if: end of the body")
    _state.body_nodes = getattr(_state, "body_nodes", 0) + nodes.value


def device_cond(pred: torch.Tensor, if_true, if_false):
    """``if_true()`` where ``pred`` holds, else ``if_false()``; both
    return tensors of the same shapes (a tuple or a NamedTuple of them),
    which ``if_true`` makes itself. Under capture: two conditionals, the
    second copying its outputs into the first's (the JAX package's
    `lax.cond`)."""
    if is_batched(pred):
        return _select(pred, if_true(), if_false())
    if _plain(pred):
        return if_true() if _read(pred) else if_false()
    out = []
    device_if(pred, lambda: out.append(if_true()))

    def other():
        for dst, src in zip(out[0], if_false()):
            dst.copy_(src)

    device_if(~pred, other)
    return out[0]


def _select(pred, a, b):
    """``torch.where(pred, ·, ·)`` over two equal structures of tensors
    (a tensor, a tuple or a NamedTuple)."""
    if isinstance(a, torch.Tensor):
        return torch.where(pred, a, b)
    items = [_select(pred, u, v) for u, v in zip(a, b)]
    return type(a)(*items) if hasattr(a, "_fields") else type(a)(items)


def device_loop(live: torch.Tensor, count: int, body,
                state: tuple = ()) -> None:
    """``while live: body()``; ``body`` updates the 0-d bool ``live`` in
    place and sets it false within ``count`` runs (the plain and eager
    forms stop there in any case). Under capture: one WHILE node, its
    body captured once.

    ``state`` names the tensors ``body`` updates in place. It is read
    only where ``live`` is batched (`torch.func.vmap`): there the loop
    runs while any instance is live, and after each run of ``body`` an
    instance that was not live gets its ``state`` and its ``live`` back
    as they were, so that each instance takes exactly the iterations of
    its own loop. Every tensor of ``state`` must be batched too."""
    _check_pred(live)
    if is_batched(live):
        _batched_loop(live, count, body, state)
        return
    if _plain(live):
        for _ in range(count):
            if not _read(live):
                break
            body()
        return
    _conditional(live, body, loop=True)


def _batched_loop(live, count: int, body, state) -> None:
    """`device_loop` on a batched ``live``: one loop on whether any
    instance is live, each run masked per instance."""
    for t in state:
        if not is_batched(t):
            raise ValueError(
                "device_loop: under vmap every tensor of the loop's state "
                "must be batched (make it with *_like of a batched one)")
    going = _any_live(live)

    def masked():
        keep = live.clone()
        old = [t.clone() for t in state]
        body()
        for t, o in zip(state, old):
            t.copy_(torch.where(keep, t, o))
        live.copy_(keep & live)
        going.copy_(_any_live(live))

    device_loop(going, count, masked)


# ---------------------------------------------------------------------------
# capture
# ---------------------------------------------------------------------------

_POOLS: dict = {}
_STREAMS: dict = {}


def _pools(index: int):
    """The card's two pools: the graphs' and their bodies'."""
    if index not in _POOLS:
        _POOLS[index] = (torch.cuda.graph_pool_handle(),
                         torch.cuda.graph_pool_handle())
    return _POOLS[index]


def _side_stream(index: int, depth: int):
    """The stream a capture runs on (depth -1) or a body of that nesting
    depth is captured on."""
    if (index, depth) not in _STREAMS:
        _STREAMS[index, depth] = torch.cuda.Stream(index)
    return _STREAMS[index, depth]


class Captured:
    """A captured graph: ``replay()`` enqueues it on the current stream;
    ``seconds`` is what capture and instantiation took, ``nodes`` its
    node count with those of its conditionals' bodies (None where this
    PyTorch keeps no graph to count)."""

    def __init__(self, graph, seconds: float, nodes):
        self.graph = graph
        self.seconds = seconds
        self.nodes = nodes

    def replay(self) -> None:
        self.graph.replay()
        STATS["replays"] += 1


def _top_nodes(graph):
    try:
        raw = graph.raw_cuda_graph()
    except (AttributeError, RuntimeError):
        return None
    n = ctypes.c_int64(0)
    build.check(build.load().scso_graph_nodes(raw, ctypes.addressof(n)),
                "graph node count")
    return n.value


_WARM: set = set()


def _warm(index: int) -> None:
    """Make the library handles a capture's ops use (cuBLAS, cuBLASLt,
    cuSOLVER) before the first capture on card ``index``: made inside a
    conditional's body, they break its capture. The autograd engine runs
    a backward's CUDA ops on a thread of its own (a vjp of a user's
    out_fn, the gradient of an f without grad_fx), which keeps handles
    of its own: a backward through the same products makes them."""
    if index in _WARM:
        return
    with torch.cuda.device(index):
        for dt in (torch.float32, torch.float64):
            a = torch.eye(2, dtype=dt, device=f"cuda:{index}")
            torch.dot(a[0], a[0])
            a @ a[0]
            a @ a
            torch.linalg.solve_ex(a, a[0])
            w = a.clone().requires_grad_(True)
            (torch.dot(w[0], w[1]) + (w @ w[0]).sum()
             + (w @ w).sum()).backward()
        torch.cuda.synchronize(index)
    _WARM.add(index)


def capture(fn, device: torch.device) -> Captured:
    """Capture ``fn()`` into a CUDA graph on ``device`` and instantiate
    it. ``fn`` must leave no tensor it made referenced when it returns:
    the next capture reuses the pools."""
    index = device.index if device.index is not None else \
        torch.cuda.current_device()
    build.load()
    _warm(index)
    for depth in range(-1, 8):
        _side_stream(index, depth)
    main, bodies = _pools(index)
    try:
        graph = torch.cuda.CUDAGraph(keep_graph=True)
    except TypeError:
        graph = torch.cuda.CUDAGraph()
    _state.body_nodes = 0
    t0 = time.perf_counter()
    # the counters on the card are made before the capture begins
    with torch.cuda.device(index), counters.on_card(index):
        with torch.cuda.graph(graph, pool=main,
                              stream=_side_stream(index, -1)):
            # the bodies' side streams are not the capture's stream:
            # route what they allocate to the bodies' pool
            torch._C._cuda_beginAllocateToPool(index, bodies)
            try:
                # a backward inside the capture (a vjp, the gradient of an
                # f without grad_fx) runs on this thread, with its handles
                with torch.autograd.set_multithreading_enabled(False):
                    fn()
            finally:
                torch._C._cuda_endAllocateToPool(index, bodies)
        if hasattr(graph, "instantiate"):
            graph.instantiate()
    seconds = time.perf_counter() - t0
    top = _top_nodes(graph)
    STATS["captures"] += 1
    STATS["capture_s"] += seconds
    return Captured(graph, seconds,
                    None if top is None else top + _state.body_nodes)


# ---------------------------------------------------------------------------
# the cache of captured solves
# ---------------------------------------------------------------------------

_CACHE: dict = {}
_LAST: dict = {}   # {"graphs": the last captured solve's graphs}


def clear() -> None:
    """Drop every cached capture (their graphs and buffers)."""
    _CACHE.clear()
    _LAST.clear()


def cached(key):
    """The entry stored under ``key``, or None; a hit becomes
    :func:`last_graphs`."""
    entry = _CACHE.get(key)
    if entry is not None:
        _LAST["graphs"] = entry.graphs
    return entry


def last_graphs() -> dict:
    """The graphs (name → :class:`Captured`) the last captured solve
    replayed."""
    return dict(_LAST.get("graphs", {}))


def store(key, entry, refs) -> None:
    """Keep ``entry`` under ``key`` as long as every object of ``refs``
    lives (the tensors and objects whose identity the key holds): the
    death of any one drops it, so that a key never meets another object
    at a reused address. An object that takes no weak reference is held
    strongly instead, in the entry's ``held``."""
    _CACHE[key] = entry
    _LAST["graphs"] = entry.graphs
    entry.held = []
    mine = weakref.ref(entry)

    def drop():
        if _CACHE.get(key) is mine():
            _CACHE.pop(key, None)

    for obj in refs:
        try:
            weakref.finalize(obj, drop)
        except TypeError:
            entry.held.append(obj)


def identity_key(obj, refs: list):
    """A hashable key of ``obj`` for the cache: dataclasses, tuples and
    lists by their items; numbers, strings, dtypes, devices and None by
    value; tensors and any other object by identity (appended to
    ``refs``) — with a tensor's shape, dtype and device."""
    if obj is None or isinstance(obj, (bool, int, float, str, torch.dtype,
                                       torch.device)):
        return obj
    if isinstance(obj, torch.Tensor):
        refs.append(obj)
        return ("tensor", id(obj), tuple(obj.shape), obj.dtype,
                str(obj.device))
    if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
        return (type(obj),) + tuple(
            (f.name, identity_key(getattr(obj, f.name), refs))
            for f in dataclasses.fields(obj))
    if isinstance(obj, (tuple, list)):
        return (type(obj),) + tuple(identity_key(v, refs) for v in obj)
    refs.append(obj)
    return ("object", id(obj))

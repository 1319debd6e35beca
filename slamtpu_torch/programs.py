"""Jitted steps as captured CUDA graphs: the port's counterpart of `jax.jit`.

The JAX package runs each per-frame and per-keyframe step as ONE device
program (`jax.jit`). Run eagerly, the same step is thousands of kernel
launches issued one at a time from Python. `Program` wraps a pure step
function so that on the card it runs as one CUDA graph replay:

  - key: the step's static keyword arguments (as `static_argnames`) and,
    for each tensor leaf of its positional arguments, shape, strides,
    dtype, device and which storage it views where (leaves that share a
    storage, as a pyramid level's stack and its six planes do, stay views
    of one static buffer, so the graph sees the layouts the eager call
    sees). One capture per key, as `jax.jit` compiles once per key;
  - capture, on a miss: static inputs allocated and filled from the
    caller's tensors, one eager warm-up call on a side stream (it builds
    the kernel library and fills the module caches outside any capture),
    then `torch.cuda.CUDAGraph` capture on that stream with
    capture_error_mode="thread_local" (in threaded mode other threads keep
    launching while one captures). A capture that fails raises, naming
    the step and the key; nothing runs eagerly in its place;
  - call: the caller's tensors copied into the static inputs on the
    current stream, one `replay()`, the static outputs cloned into fresh
    tensors (the next replay overwrites them; the pipeline keeps several
    frames' carries in flight);
  - sharing: the cache is process-wide, as `jax.jit`'s. Programs name a
    memory pool, and the graphs of one pool share it (their intermediates
    are dead between replays), so the pool holds the largest capture's
    working set, not the sum over keys. One lock a pool covers copy-in,
    replay and clone-out, and an event recorded after each clone-out is
    waited on by the next caller's stream before its copy-in, so two
    threads or two managers on different streams never race on a pool's
    static buffers or its intermediates. One capture runs at a time in
    the process (PyTorch's rule);
  - launch counts: under replay no Python wrapper runs, so each kernel
    wrapper's `launches` count (kernels.count_launch) would stop. A capture
    records how far each count would have moved (kernels.recording_launches)
    and every replay adds that amount;
  - spans (utils/profiling.py): a call is the span `programs.<pool>`, a
    capture the span `programs.capture` (its info: the step and the key);
  - device time: a pair of timing events on the caller's stream brackets
    each `replay()` (copy-in and clone-out outside it). The pair is read
    without waiting (`Event.query()`) at the program's next call and at
    `read_device_times()` (SlamManager.finish), and its ms go to the
    recorder as `programs.<pool>.device`, with the frame id and the
    `profiled` flag of the call's span. A pair recorded before a
    `TIMERS.reset()` is dropped. The events return to the pool's free list.

While a step is being captured no thread may synchronize the whole device
(`torch.cuda.synchronize()`): CUDA refuses to synchronize a device with a
capture underway, and the capture fails. In threaded mode the estimator
thread captures local BA's buckets as they first come, so a caller that
waits while the workers run waits for a stream
(`torch.cuda.current_stream().synchronize()`).

CPU tensors run the eager function: the plain path, chosen because the
tensors lie on the CPU, as the kernels' plain versions are. `eager()` runs
the wrapped steps as plain calls on the card too, on the calling thread
(the counterpart of `jax.disable_jit()`); the card tests and chip_smoke.py
use it to hold a replay against its eager call. A step called while
another step is being captured on this thread runs inline, inside the
outer graph (as a jitted call inside a jitted function is inlined).
"""
from __future__ import annotations

import contextlib
import ctypes
import threading
import time
from collections import deque

import torch

from . import kernels
from .utils.profiling import TIMERS

_LOCAL = threading.local()
_CAPTURE_LOCK = threading.RLock()


@contextlib.contextmanager
def eager():
    """Run every Program as its plain eager function on this thread."""
    _LOCAL.eager = getattr(_LOCAL, "eager", 0) + 1
    try:
        yield
    finally:
        _LOCAL.eager -= 1


def eager_active() -> bool:
    return getattr(_LOCAL, "eager", 0) > 0


# -- pytrees of tensors -------------------------------------------------------

def _flatten(tree, leaves: list):
    """A hashable spec of nested dicts (in key order, as JAX's pytrees) /
    tuples / lists; tensors appended to `leaves`."""
    if torch.is_tensor(tree):
        leaves.append(tree)
        return None
    if isinstance(tree, dict):
        return ("dict", tuple((k, _flatten(tree[k], leaves))
                              for k in sorted(tree)))
    if isinstance(tree, (tuple, list)):
        return (type(tree).__name__,
                tuple(_flatten(v, leaves) for v in tree))
    raise TypeError(f"a program's positional arguments and results hold "
                    f"only tensors (static values go as keyword "
                    f"arguments); got {type(tree).__name__}")


def leaves(tree) -> list:
    """The tensors of a pytree, in the order _flatten gives them."""
    out = []
    _flatten(tree, out)
    return out


def _unflatten(spec, leaves):
    it = iter(leaves)

    def build(s):
        if s is None:
            return next(it)
        kind, items = s
        if kind == "dict":
            return {k: build(v) for k, v in items}
        seq = [build(v) for v in items]
        return tuple(seq) if kind == "tuple" else seq

    return build(spec)


def _storage_bytes(t: torch.Tensor) -> torch.Tensor:
    """The whole storage under `t` as a 1-D uint8 tensor."""
    s = t.untyped_storage()
    return torch.empty(0, dtype=torch.uint8, device=t.device).set_(
        s, 0, (s.nbytes(),), (1,))


def layout(leaves) -> tuple:
    """(per-leaf (group, dtype, shape, stride, offset), per-group nbytes):
    leaves grouped by the storage they view."""
    groups: dict = {}
    sizes = []
    desc = []
    for t in leaves:
        s = t.untyped_storage()
        g = groups.get(s.data_ptr())
        if g is None:
            g = groups[s.data_ptr()] = len(sizes)
            sizes.append(s.nbytes())
        desc.append((g, t.dtype, tuple(t.shape), tuple(t.stride()),
                     t.storage_offset()))
    return tuple(desc), tuple(sizes)


def _materialize(lay, device, bases=None):
    """Fresh storages for a layout (or the given byte `bases`) and the
    leaves as views of them, with the layout's aliasing."""
    desc, sizes = lay
    if bases is None:
        bases = [torch.empty(n, dtype=torch.uint8, device=device)
                 for n in sizes]
    leaves = [bases[g].view(dtype).as_strided(shape, stride, offset)
              for g, dtype, shape, stride, offset in desc]
    return bases, leaves


def _group_sources(leaves, lay):
    """One leaf a storage group (its storage is the group's bytes)."""
    first = {}
    for t, (g, *_rest) in zip(leaves, lay[0]):
        first.setdefault(g, t)
    return [first[g] for g in range(len(lay[1]))]


def clone_tree(tree):
    """A copy of a pytree of tensors with the same aliasing between its
    leaves: one copy a storage."""
    flat = []
    spec = _flatten(tree, flat)
    if not flat:
        return tree
    lay = layout(flat)
    bases = [_storage_bytes(t).clone() for t in _group_sources(flat, lay)]
    _, out = _materialize(lay, flat[0].device, bases)
    return _unflatten(spec, out)


# -- memory pools ---------------------------------------------------------------

class Pool:
    """A CUDA graph memory pool shared by the graphs of its programs, with
    the lock and the event that order their replays."""

    def __init__(self, name: str):
        self.name = name
        self.lock = threading.RLock()
        self.handle = None
        self.graphs = 0           # graphs captured into the pool
        self.cards: dict = {}     # device -> _Card

    def card(self, device) -> "_Card":
        if self.handle is None:
            self.handle = torch.cuda.graph_pool_handle()
        if device not in self.cards:
            self.cards[device] = _Card(device)
        return self.cards[device]

    def reserved_bytes(self):
        """Bytes the pool holds on the card (memory_snapshot's segments of
        this pool), or None before its first capture."""
        if self.handle is None:
            return None
        pool_id = tuple(self.handle)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool_id)


class _Card:
    """A pool's state on one card: the event recorded after the last
    clone-out, the side stream of its warm-ups and captures, and the free
    timing events of its replays."""

    def __init__(self, device):
        with torch.cuda.device(device):
            self.done = torch.cuda.Event()
            self.stream = torch.cuda.Stream(device)
        self.events: list = []

    def timing_event(self):
        return (self.events.pop() if self.events
                else torch.cuda.Event(enable_timing=True))


POOLS: dict = {}
PROGRAMS: list = []


def pool(name: str) -> Pool:
    return POOLS.setdefault(name, Pool(name))


# -- graph statistics -----------------------------------------------------------

def _graph_nodes(graph) -> int | None:
    """Nodes of a captured graph (the driver's cuGraphGetNodes on the kept
    graph), or None if the driver refuses."""
    fn = ctypes.CDLL("libcuda.so.1").cuGraphGetNodes
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.POINTER(ctypes.c_size_t)]
    fn.restype = ctypes.c_int
    count = ctypes.c_size_t(0)
    if fn(ctypes.c_void_p(graph.raw_cuda_graph()), None,
          ctypes.byref(count)) != 0:
        return None
    return int(count.value)


# -- programs -------------------------------------------------------------------

class Entry:
    """One captured graph: its static buffers and its bookkeeping."""

    def __init__(self, graph, in_bases, in_layout, out_spec, static_out,
                 launches: dict):
        self.graph = graph
        self.in_bases = in_bases
        self.in_layout = in_layout
        self.out_spec = out_spec
        self.static_out = static_out
        self.launches = launches      # kernel wrapper -> launches a replay
        self.replays = 0
        self.capture_ms = 0.0
        self.nodes = None

    def copy_in(self, flat):
        for base, src in zip(self.in_bases,
                             _group_sources(flat, self.in_layout)):
            base.copy_(_storage_bytes(src))

    def replay(self):
        """One replay and its launch accounting."""
        self.graph.replay()
        self.replays += 1
        kernels.add_launches(self.launches)

    def clone_out(self):
        return clone_tree(_unflatten(self.out_spec, self.static_out))


class Program:
    """A pure step function run as one CUDA graph replay a call on the card
    (module docstring). Positional arguments are pytrees of tensors;
    keyword arguments are static and hashable."""

    def __init__(self, fn, name: str, pool_name: str):
        self.fn = fn
        self.name = name
        self.pool = pool(pool_name)
        self.entries: dict = {}
        self.span = f"programs.{pool_name}"
        # Replays' event pairs not read yet: (start, end, card, epoch,
        # span), oldest first.
        self._timed: deque = deque()
        self.__doc__ = fn.__doc__
        PROGRAMS.append(self)

    def key(self, *args, **static):
        flat = []
        spec = _flatten(args, flat)
        return self._key(spec, flat, static)

    def _key(self, spec, flat, static):
        devices = {t.device for t in flat}
        if len(devices) > 1:
            raise ValueError(f"{self.name}: inputs on several devices "
                             f"{sorted(map(str, devices))}")
        return (spec, tuple(sorted(static.items())), layout(flat),
                next(iter(devices), None))

    def __call__(self, *args, **static):
        flat = []
        spec = _flatten(args, flat)
        if (not any(t.is_cuda for t in flat) or eager_active()
                or torch.cuda.is_current_stream_capturing()):
            with TIMERS.stage(self.span):
                return self.fn(*args, **static)
        key = self._key(spec, flat, static)
        dev = key[3]
        with TIMERS.stage(self.span) as span, self.pool.lock, \
                torch.cuda.device(dev):
            card = self.pool.card(dev)
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(card.done)
            self._read_device_times()
            entry = self.entries.get(key)
            if entry is None:
                with TIMERS.stage("programs.capture",
                                  info=f"{self.name} {_describe(key)}"):
                    entry = self._capture(key, flat, static, stream,
                                          card.stream)
                self.entries[key] = entry
            else:
                entry.copy_in(flat)
            start, end = card.timing_event(), card.timing_event()
            start.record(stream)
            entry.replay()
            end.record(stream)
            self._timed.append((start, end, card, TIMERS.epoch, span))
            out = entry.clone_out()
            card.done.record(stream)
        return out

    def _read_device_times(self):
        """The finished replays' device ms into the recorder, oldest
        first; never waits for the card. Under the pool's lock."""
        timed = self._timed
        while timed and timed[0][1].query():
            start, end, card, epoch, span = timed.popleft()
            if epoch == TIMERS.epoch:
                TIMERS.add_device(f"{self.span}.device",
                                  start.elapsed_time(end), span.frame,
                                  span.id, span.profiled)
            card.events += (start, end)

    def _capture(self, key, flat, static, stream, side):
        t0 = time.perf_counter()
        spec, _, in_layout, dev = key
        in_bases, static_flat = _materialize(in_layout, dev)
        for base, src in zip(in_bases, _group_sources(flat, in_layout)):
            base.copy_(_storage_bytes(src))
        static_args = _unflatten(spec, static_flat)
        side.wait_stream(stream)
        # Kept after instantiation, for its node count.
        graph = torch.cuda.CUDAGraph(keep_graph=True)
        try:
            with _CAPTURE_LOCK, torch.cuda.stream(side):
                self.fn(*static_args, **static)          # warm-up
                with kernels.recording_launches() as launches:
                    graph.capture_begin(pool=self.pool.handle,
                                        capture_error_mode="thread_local")
                    try:
                        out = self.fn(*static_args, **static)
                    finally:
                        graph.capture_end()
            graph.instantiate()
        except Exception as exc:
            if not self.pool.graphs:
                # PyTorch frees a pool with its last graph: the next
                # capture takes a fresh handle.
                self.pool.handle = None
            raise RuntimeError(
                f"CUDA graph capture of {self.name} failed for the key "
                f"{_describe(key)}: {exc}") from exc
        self.pool.graphs += 1
        stream.wait_stream(side)
        out_flat = []
        out_spec = _flatten(out, out_flat)
        entry = Entry(graph, in_bases, in_layout, out_spec, out_flat,
                      dict(launches))
        entry.nodes = _graph_nodes(graph)
        entry.capture_ms = (time.perf_counter() - t0) * 1e3
        return entry

    def stats(self):
        """One dict a captured key: its static arguments, its inputs'
        shapes, capture ms (warm-up, capture and instantiation), graph
        nodes and replays."""
        return [{"static": dict(k[1]),
                 "shapes": [d[2] for d in k[2][0]],
                 "capture_ms": e.capture_ms, "nodes": e.nodes,
                 "replays": e.replays}
                for k, e in list(self.entries.items())]


def read_device_times():
    """Every program's finished replays into the recorder, without waiting
    for the card; a program whose pool another thread holds is read at its
    next call."""
    for prog in PROGRAMS:
        if prog.pool.lock.acquire(blocking=False):
            try:
                prog._read_device_times()
            finally:
                prog.pool.lock.release()


def _describe(key) -> str:
    _spec, static, (desc, _sizes), dev = key
    shapes = [tuple(d[2]) for d in desc]
    return f"{dict(static)} shapes {shapes} on {dev}"

"""The program store: every captured program of the process.

Counterpart of ``mxnet_tpu/program_store.py``, holding what the compiled
train step (``cached_step.TrainStep``, ``models.make_train_step``), the
hybridized forward (``gluon.HybridBlock``) and the serving engines
(``serving.ServingEngine``, ``serving_decode.GenerativeEngine``) need:

- **Namespaces** ``train_step`` (cap ``MXNET_COMPILED_STEP_CACHE``, 16),
  ``hybrid_forward``, ``serving``, ``serving_decode`` and ``serving_spec``
  (the speculative draft and verify programs) (cap
  ``MXNET_FORWARD_CACHE``, 32) and ``sharded_step``, each one metrics
  surface: hits, misses, evictions, traces and dispatches (:func:`stats`).
  Caps are per owner (below), so two engines never evict each other's
  programs.
- **ScopeCache**: one owner's keyspace, an LRU under its namespace's cap,
  so that two owners never evict each other's programs.
- **Program**, the counterpart of ``build(name, jitted, lower_args)``.
  Where the reference traces a ``jax.jit`` program with donated buffers,
  a Program on a CUDA device is a ``torch.cuda.CUDAGraph`` captured over
  static input buffers. Its first call runs the body once eagerly on a
  side stream (that call's own work, which also does the first-time work:
  kernel builds, cuBLAS and cuDNN set-up, lazy state) and then captures
  it; later calls copy their inputs into the static buffers (``copy_``, no
  host sync), replay, and return clones of the static outputs.
  On the CPU, asked for explicitly, a Program runs the same body through
  the same static buffers with no graph, so that its keys, copies and
  counters run in the CPU tests. A failed capture raises: nothing falls
  back to eager. Each capture counts as 1 trace and each call as 1
  dispatch, as the reference counts traces and dispatches;
  :meth:`Program.prepare` captures without a dispatch (the engines'
  ``warmup``, the counterpart of compiling from abstract shapes).

**Threads.** The serving engines capture from their scheduler or
dispatcher threads while other threads stage copies or replay, so a
capture is made safe for that (:func:`_graph`): captures are serialized
under one process-wide lock; Python's cyclic garbage collector stays off
until the last capture in flight has ended (a collection there could free
a dead cycle that holds another program's graph, and destroying a graph
while a stream captures invalidates the capture); a capture uses
``capture_error_mode="thread_local"``, so that another thread's legal
CUDA calls (a pinned-memory allocation, a synchronizing copy) neither
fail nor spoil it; and each thread has its own side stream per device, so
one thread's eager first call never lands in another thread's capture. A
replay from a thread other than the one that captured is allowed. A
device-wide synchronization from another thread would still invalidate a
capture: :func:`synchronize` waits for the capture lock first (stream
synchronizations are safe).

A replay runs no Python of the body: counts that the body bumps in Python
(the kernel wrappers' launch counts, the fused-site counts) move at the
first call, by its eager run and by its capture, and not on a replay. What
a replay launches shows in a profiler trace of it, where the graph's
kernels appear by name (``ops.cuda_kernels.kernel_of``).

A program's key names the tensors its body reads and updates in place
(:func:`storage_key`), and the program keeps them alive. When an owner
calls with tensors that replace some of them (``cast``, a new set of
params), the programs that hold the replaced ones can never hit again:
:func:`run` drops them (counted as evictions), which frees the old tensors
and the programs' graphs.

Not ported: ahead-of-time executables and the persistent compilation
cache (a CUDA graph lives in one process) and ``MXNET_PROGRAM_CACHE_CAPS``.
"""
from __future__ import annotations

import contextlib
import gc
import threading
from collections import OrderedDict
from typing import Any, Callable, Dict, Optional, Sequence

import torch

from . import config as _config
from . import telemetry as _telemetry

__all__ = ["Namespace", "ScopeCache", "Program", "VjpProgram",
           "CapturedFunction", "CaptureError", "synchronize",
           "NAMESPACES", "namespace", "scope", "stats", "reset_counters",
           "run", "capture", "in_program", "knob_key", "tensor_key",
           "storage_key"]

_FIELDS = ("hits", "misses", "evictions", "traces", "dispatches")

# the knobs that the port's captured bodies read from Python: part of
# every program key, so that flipping one re-captures
ROUTE_KNOBS = ("MXNET_FUSED_EPILOGUE", "MXNET_FUSED_CONV_BN",
               "MXNET_FUSED_CONV_BN_KINDS", "MXNET_BN_TWO_PASS_VAR")


class Namespace:
    """One metrics and eviction surface shared by every scope of a family
    of programs. Its counters live in the telemetry registry as
    ``program_store.<namespace>.<field>`` (family
    ``program_store.namespace``), as the reference's do."""

    def __init__(self, name: str, cap_default: int,
                 cap_env: Optional[str] = None):
        self.name = name
        self.cap_default = cap_default
        self.cap_env = cap_env
        self._c = _telemetry.CounterGroup(
            f"program_store.{name}", _FIELDS,
            f"program-store namespace {name!r}",
            family="program_store.namespace")

    def bump(self, field: str, n: int = 1) -> None:
        self._c.inc(field, n)

    def reset(self) -> None:
        self._c.reset()

    def cap(self) -> int:
        """Programs per scope: the namespace's knob, else its default."""
        cap = self.cap_default if self.cap_env is None \
            else int(_config.get(self.cap_env))
        if cap < 1:
            raise ValueError(f"{self.cap_env} must be >= 1, got {cap}")
        return cap

    def stats(self) -> Dict[str, int]:
        return dict(self._c, cap=self.cap())


for _f in _FIELDS:
    setattr(Namespace, _f, property(lambda self, f=_f: self._c[f]))
del _f


class ScopeCache(OrderedDict):
    """One owner's programs in a namespace: an ``OrderedDict`` whose
    ``lookup`` and ``insert`` count hits, misses and evictions in the
    namespace and keep it under the namespace's cap, oldest out first (a
    program dropped so frees its graph and memory pool)."""

    def __init__(self, ns: Namespace):
        super().__init__()
        self._ns = ns

    @property
    def namespace(self) -> Namespace:
        return self._ns

    def lookup(self, key):
        """Counted get; a hit refreshes the key's recency."""
        rec = self.get(key)
        if rec is None:
            self._ns.bump("misses")
        else:
            self._ns.bump("hits")
            self.move_to_end(key)
        return rec

    def insert(self, key, rec):
        self[key] = rec
        cap = self._ns.cap()
        while len(self) > cap:
            self.popitem(last=False)
            self._ns.bump("evictions")
        return rec

    def drop_stale(self, live) -> None:
        """Drop the programs that keep a tensor not among ``live``, the
        tensors the owner calls with now: it has replaced that tensor, so
        their keys cannot hit again."""
        ids = {id(t) for t in live}
        for key in [k for k, p in self.items()
                    if any(id(t) not in ids
                           for t in getattr(p, "keep", None) or ())]:
            del self[key]
            self._ns.bump("evictions")


NAMESPACES: Dict[str, Namespace] = {
    "train_step": Namespace("train_step", 16, "MXNET_COMPILED_STEP_CACHE"),
    "hybrid_forward": Namespace("hybrid_forward", 32, "MXNET_FORWARD_CACHE"),
    "serving": Namespace("serving", 32, "MXNET_FORWARD_CACHE"),
    "serving_decode": Namespace("serving_decode", 32, "MXNET_FORWARD_CACHE"),
    "serving_spec": Namespace("serving_spec", 32, "MXNET_FORWARD_CACHE"),
    "sharded_step": Namespace("sharded_step", 16,
                              "MXNET_COMPILED_STEP_CACHE"),
}


def namespace(name: str) -> Namespace:
    try:
        return NAMESPACES[name]
    except KeyError:
        raise KeyError(f"undeclared program-store namespace {name!r}; "
                       f"known: {sorted(NAMESPACES)}") from None


def scope(name: str) -> ScopeCache:
    """A new per-owner cache in ``name``'s namespace."""
    return ScopeCache(namespace(name))


def stats(name: Optional[str] = None) -> Dict[str, Any]:
    """Counters of one namespace, or of all by name."""
    if name is not None:
        return namespace(name).stats()
    return {n: ns.stats() for n, ns in NAMESPACES.items()}


def reset_counters(name: Optional[str] = None) -> None:
    """Zero the namespace counters (programs stay)."""
    for ns in ([namespace(name)] if name is not None
               else NAMESPACES.values()):
        ns.reset()


# ---------------------------------------------------------------------------
# programs
# ---------------------------------------------------------------------------
class _Building(threading.local):
    def __init__(self):
        super().__init__()
        self.depth = 0


_BUILDING = _Building()
_SIDE_STREAMS = threading.local()     # per thread: {device: stream}
_CAPTURE_LOCK = threading.RLock()
_GC_HOLD = {"depth": 0, "was_enabled": False}


def in_program() -> bool:
    """True while a Program's body runs (warm-up, capture, or a CPU call):
    a block called there runs eagerly inside it, not as a program of its
    own."""
    return _BUILDING.depth > 0


def _side_stream(device: torch.device):
    """This thread's side stream on ``device``."""
    streams = getattr(_SIDE_STREAMS, "by_device", None)
    if streams is None:
        streams = _SIDE_STREAMS.by_device = {}
    if device not in streams:
        streams[device] = torch.cuda.Stream(device)
    return streams[device]


def synchronize(device=None) -> None:
    """``torch.cuda.synchronize(device)`` outside every capture: a device
    synchronization while another thread captures would invalidate that
    capture, so it waits for the capture lock."""
    with _CAPTURE_LOCK:
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def _gc_held():
    """The cyclic garbage collector off from the first capture in flight
    until the last one has ended; the cycles it would have freed are
    collected by a later collection."""
    with _CAPTURE_LOCK:
        if _GC_HOLD["depth"] == 0:
            _GC_HOLD["was_enabled"] = gc.isenabled()
            gc.disable()
        _GC_HOLD["depth"] += 1
    try:
        yield
    finally:
        with _CAPTURE_LOCK:
            _GC_HOLD["depth"] -= 1
            if _GC_HOLD["depth"] == 0 and _GC_HOLD["was_enabled"]:
                gc.enable()


@contextlib.contextmanager
def _graph(graph, **kwargs):
    """``torch.cuda.graph(graph, **kwargs)``, safe beside other threads
    (see the module docstring): one capture at a time process-wide, the
    garbage collector held off, thread-local capture errors. A capture
    that fails is cleaned up after: ``torch.cuda.graph``'s exit raises
    from its ``capture_end`` before it restores this thread's stream, and
    before the device's default generator leaves its capture state (where
    the next random draw outside a capture raises), so both are put back
    as they were when the capture began."""
    kwargs.setdefault("capture_error_mode", "thread_local")
    with _CAPTURE_LOCK, _gc_held():
        stream = torch.cuda.current_stream()
        side = kwargs.get("stream")
        rng = torch.cuda.default_generators[
            side.device.index if side is not None
            else torch.cuda.current_device()]
        before = rng.clone_state()
        try:
            with torch.cuda.graph(graph, **kwargs):
                yield
        except BaseException:
            rng.graphsafe_set_state(before)
            torch.cuda.set_stream(stream)
            raise


def _tensors(out) -> list:
    if isinstance(out, torch.Tensor):
        return [out]
    if isinstance(out, (tuple, list)):
        return [o for o in out if isinstance(o, torch.Tensor)]
    return []


def _clone(out):
    if isinstance(out, torch.Tensor):
        return out.clone()
    if isinstance(out, (tuple, list)):
        return type(out)(o.clone() if isinstance(o, torch.Tensor) else o
                         for o in out)
    return out


class CaptureError(RuntimeError):
    """A program's body ran eagerly but its CUDA-graph capture failed. A
    train step raises it; ``ServingEngine`` serves the batch's requests
    through the eager forward instead, as for any failed dispatch."""


class Program:
    """One captured body over static input buffers (see the module
    docstring). ``fn(*static_inputs)`` returns a tensor, or a tuple or list
    whose tensors are the outputs; ``args`` give the inputs' shapes and
    dtypes, and the buffers live on ``device``. A replay returns clones of
    the static outputs, which the next replay overwrites. ``keep``, the
    tensors the program's key names, stays alive with it."""

    def __init__(self, ns: Namespace, fn: Callable, args: Sequence, device,
                 keep=None):
        self._ns = ns
        self._fn = fn
        self.keep = keep
        self.device = torch.device(device)
        with torch.inference_mode(False):
            self._static = [torch.empty(a.shape, dtype=a.dtype,
                                        device=self.device) for a in args]
        self._called = False
        self._graph = None
        self._out = None

    def _run(self):
        _BUILDING.depth += 1
        try:
            return self._fn(*self._static)
        finally:
            _BUILDING.depth -= 1

    def _first_call(self):
        """Run the body once eagerly on the side stream, then capture it.
        Returns the eager run's outputs (fresh tensors)."""
        stream = _side_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            warm = self._run()
        cur.wait_stream(stream)
        for t in _tensors(warm):
            t.record_stream(cur)
        graph = torch.cuda.CUDAGraph()
        try:
            with _graph(graph, stream=stream):
                out = self._run()
        except Exception as e:
            raise CaptureError(f"capture of a {self._ns.name!r} program "
                               f"failed: {e!r}") from e
        self._graph, self._out = graph, out
        return warm

    def _copy_in(self, args):
        with torch.inference_mode(False):
            for s, a in zip(self._static, args):
                if a is not s:
                    s.copy_(a, non_blocking=True)

    def prepare(self, *args) -> None:
        """Capture the program at its first call on ``args`` without
        counting a dispatch (an engine's ``warmup``); a no-op once it was
        called. The eager run's outputs are dropped."""
        if self._called:
            return
        self._copy_in(args)
        self._called = True
        self._ns.bump("traces")
        if self.device.type == "cuda":
            self._first_call()
        else:
            self._run()

    def __call__(self, *args):
        self._copy_in(args)
        self._ns.bump("dispatches")
        if not self._called:
            self._called = True
            self._ns.bump("traces")
            if self.device.type == "cuda":
                return self._first_call()
        if self._graph is None:
            return self._run()          # the CPU: fresh outputs each call
        self._graph.replay()
        return _clone(self._out)


class VjpProgram:
    """A forward and its backward as two captured programs over static
    buffers: the counterpart of the reference's recorded ``jax.vjp`` node
    over a cached program. ``fn(*static_inputs)``, run with grad mode on,
    returns ``(outputs, wrt)``: a list of output tensors and the tensors
    the backward differentiates them by.

    :meth:`forward` copies the inputs into the static buffers and returns
    ``(generation, clones of the outputs)``; :meth:`backward` takes the
    generation and the outputs' gradients and returns the gradients of
    ``wrt`` (None where unused). On a CUDA device the first forward runs
    ``fn`` eagerly on the side stream, keeping its autograd graph for its
    own backward, and captures the forward; the backward is captured at
    the first backward, after an eager run of it (over that call's own
    graph) has done the first-time work. Later calls replay. The two
    graphs share one memory pool, which holds the activations between a
    forward and its backward, so the activations are those of the last
    forward only: a backward for an older generation raises, and the
    caller (``HybridBlock``) runs a second call eagerly while the first's
    backward is pending (:attr:`pending`). On the CPU every forward runs
    ``fn`` through the static buffers and its backward differentiates that
    run's graph. Counts 1 trace at the first forward and 1 dispatch a
    forward."""

    def __init__(self, ns: Namespace, fn: Callable, args: Sequence, device,
                 keep=None):
        self._ns = ns
        self._fn = fn
        self.keep = keep
        self.device = torch.device(device)
        with torch.inference_mode(False):
            self._static = [torch.empty(a.shape, dtype=a.dtype,
                                        device=self.device) for a in args]
        self._called = False
        self._fwd = self._bwd = None
        self._outs = self._wrt = self._gouts = self._grads = None
        # (generation, outputs, wrt) of the last forward if it ran eagerly,
        # kept (a backward may be repeated) until the next forward
        self._eager: Optional[tuple] = None
        self.generation = 0
        self.pending: Optional[int] = None

    def _run(self):
        _BUILDING.depth += 1
        try:
            with torch.enable_grad():
                outs, wrt = self._fn(*self._static)
            return list(outs), list(wrt)
        finally:
            _BUILDING.depth -= 1

    def _on_side(self, fn):
        """fn() on the side stream, ordered after and before the current
        stream's work."""
        stream = _side_stream(self.device)
        cur = torch.cuda.current_stream(self.device)
        stream.wait_stream(cur)
        with torch.cuda.stream(stream):
            out = fn()
        cur.wait_stream(stream)
        for t in out:
            for u in (t if isinstance(t, list) else [t]):
                if isinstance(u, torch.Tensor):
                    u.record_stream(cur)
        return out

    def forward(self, args):
        with torch.inference_mode(False):
            for s, a in zip(self._static, args):
                s.copy_(a)
        self._ns.bump("dispatches")
        self.generation += 1
        gen = self.generation
        self._eager = None
        if not self._called:
            self._called = True
            self._ns.bump("traces")
            if self.device.type == "cuda":
                outs, wrt = self._on_side(lambda: self._run())
                self._eager = (gen, outs, wrt)
                self._fwd = torch.cuda.CUDAGraph()
                with _graph(self._fwd, stream=_side_stream(self.device)):
                    self._outs, self._wrt = self._run()
                return gen, [o.detach().clone() for o in outs]
        if self._fwd is None:
            outs, wrt = self._run()
            self._eager = (gen, outs, wrt)
            return gen, [o.detach().clone() for o in outs]
        self._fwd.replay()
        return gen, [o.detach().clone() for o in self._outs]

    def backward(self, gen: int, gouts):
        if gen != self.generation:
            raise RuntimeError(
                f"backward through call {gen} of a graphed forward after "
                f"call {self.generation} replaced its activations; the "
                "block runs a call eagerly while an earlier call's backward "
                "is pending, so this is a backward through a call whose "
                "graph was freed and recorded again")
        if self._eager is not None:
            _, outs, wrt = self._eager
            grad = (lambda: torch.autograd.grad(
                outs, wrt, gouts, allow_unused=True, retain_graph=True))
            if self.device.type != "cuda":
                return list(grad())
            grads = self._on_side(grad)
            if self._bwd is None:
                self._capture_backward()
            return list(grads)
        if self._bwd is None:
            grads = self._on_side(lambda: torch.autograd.grad(
                self._outs, self._wrt, gouts, allow_unused=True,
                retain_graph=True))
            self._capture_backward()
            return list(grads)
        for s, g in zip(self._gouts, gouts):
            s.copy_(g)
        self._bwd.replay()
        return [None if g is None else g.clone() for g in self._grads]

    def _capture_backward(self):
        with torch.inference_mode(False):
            self._gouts = [torch.zeros_like(o) for o in self._outs]
        self._bwd = torch.cuda.CUDAGraph()
        with _graph(self._bwd, pool=self._fwd.pool(),
                    stream=_side_stream(self.device)):
            self._grads = torch.autograd.grad(
                self._outs, self._wrt, self._gouts, allow_unused=True)


def run(cache: ScopeCache, key, build: Callable[[], Callable],
        args: Sequence[torch.Tensor], device=None, keep=None):
    """Call the program of ``cache`` under ``key`` on ``args`` (on
    ``device``, else theirs); on a miss, make it from the body ``build()``
    returns, call it (the capture), and keep it only once that call has
    succeeded. ``keep`` is held by the program (the tensors its key
    names); a miss first drops the programs that keep tensors ``keep``
    has replaced."""
    prog = cache.lookup(key)
    if prog is not None:
        return prog(*args)
    if keep is not None:
        cache.drop_stale(keep)
    prog = Program(cache.namespace, build(), args,
                   args[0].device if device is None else device, keep=keep)
    out = prog(*args)
    cache.insert(key, prog)
    return out


def knob_key() -> tuple:
    """The Python state a captured body reads besides its inputs: the
    route knobs, the AMP generation (``amp.init`` / ``uninit`` change the
    casts inside every op) and torch's math-mode flags."""
    from .ndarray import ndarray as _nd

    return (tuple(_config.get(k) for k in ROUTE_KNOBS), _nd._amp_generation,
            torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32,
            torch.backends.cudnn.benchmark,
            torch.backends.cudnn.deterministic)


def tensor_key(tensors: Sequence[torch.Tensor]) -> tuple:
    """Shapes, dtypes and devices of a call's inputs."""
    return tuple((tuple(t.shape), t.dtype, t.device) for t in tensors)


def storage_key(tensors) -> tuple:
    """Which tensors a body reads and writes in place: each one's identity
    and storage address. Pass the tensors to :func:`run` as ``keep``, so
    that neither can pass to another tensor while the program lives."""
    return tuple((id(t), t.data_ptr()) for t in tensors)


class CapturedFunction:
    """``fn`` as a program of the ``hybrid_forward`` namespace per input
    signature: the counterpart of ``jax.jit(fn)`` for callers such as the
    LM's forward. ``fn`` takes tensors only; what else it reads (the
    tensors it closes over) is fixed, as ``jax.jit`` bakes it in. It runs
    with torch's grad mode off, whatever the caller's: a graph's outputs
    carry no autograd history, and ``fn`` reads no other mode."""

    def __init__(self, fn: Callable):
        self._fn = fn
        self.programs = scope("hybrid_forward")

    def _body(self, *args):
        with torch.no_grad():
            return self._fn(*args)

    def __call__(self, *args: torch.Tensor):
        return run(self.programs, (tensor_key(args), knob_key()),
                   lambda: self._body, args)


def capture(fn: Callable) -> CapturedFunction:
    """``fn`` captured per input signature."""
    return CapturedFunction(fn)

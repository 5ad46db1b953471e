"""Gluon Block / HybridBlock.

Counterpart of ``mxnet_tpu/gluon/block.py``. ``Block`` keeps the
reference's contract: assigning a Block or Parameter attribute registers
it, ``collect_params`` walks the tree with the reference's structural names
(``features.4.0.body.0.weight``), a parameter of unknown shape is completed
by the layer's ``infer_shape`` on the first call, and ``cast``,
``load_dict`` and ``zero_grad`` act on every parameter. Blocks take
``NDArray``s or ``torch.Tensor``s and return the flavor they were given,
as the reference's ``_flavor_of`` (``ndarray.py:642``) keeps its flavors
apart: a call given an NDArray unwraps its NDArrays before anything else
(so an NDArray batch takes the captured paths below as a tensor does) and
wraps the outputs on the first NDArray's context. Inside, layers dispatch
their ops on tensors through ``ndarray.tensor_op``.

A hybridized block runs its forward as captured programs
(``program_store``, namespace ``hybrid_forward``), the counterpart of the
reference's cached forward (``block.py:621-700``):

- Outside ``autograd.record()`` (or where nothing takes a gradient), one
  program of the forward, run with grad mode off. Its key: the inputs'
  shapes, dtypes and device, ``autograd.is_training()``, the route knobs
  and math flags, and which tensors hold the parameters (``cast``
  replaces them and so re-captures). It returns clones of the program's
  outputs, as the reference returns fresh arrays; batch-norm running
  statistics that a training-mode forward updates are updated in place by
  every replay.
- Under ``record()``, one graphed tape node (``_GraphedNode``, the
  reference's recorded ``jax.vjp`` node, ``block.py:659-689``): its
  forward replays a captured forward and its backward a captured backward
  (``program_store.VjpProgram``); the gradients reach the parameters and
  the inputs through torch's autograd, so ``grad_req`` write and add keep
  their meaning, and the forward replay updates the running statistics.
  The key adds which inputs require grad and which parameters take
  gradients. The program holds the activations of its last call only, so
  a second call before the first call's backward runs eagerly; so does a
  second-order backward (``create_graph=True``), which recomputes the
  forward, and every recorded call under ``MXNET_COMPILED_STEP=0`` (the
  eager tape everywhere; still the port's trace, so the fused sites run
  as in the graphed node). Each names its reason in
  ``last_eager_reason``.
- ``hybridize(bucket=True)``: predict-mode calls pad the batch axis to
  their bucket (``serving.BucketPolicy``), checked once per bucket against
  the unpadded eager forward (``block.py:538-565, :706-760``).

Inside :func:`traced_call` (a hybridized block's call, a compiled step's
body, ``ShardedTrainer``'s step), :func:`in_hybridized_call` is true. The
fused ResNet sites read it where the reference asks whether it is being
traced, so eager calls of a block that is not hybridized never take the
fused sites, as in the reference, and every compiled step does.
"""
from __future__ import annotations

import contextlib
import threading
from collections import OrderedDict
from typing import Optional

import torch

from .. import autograd, initializer
from .. import config as _config
from .. import program_store as _pstore
from .. import serving as _serving
from ..context import resolve_device
from ..ndarray.ndarray import NDArray, _wrap
from .parameter import DeferredInitializationError, Parameter

__all__ = ["Block", "HybridBlock", "in_hybridized_call", "traced_call"]


class _Hybrid(threading.local):
    def __init__(self):
        super().__init__()
        self.depth = 0


_HYBRID = _Hybrid()


@contextlib.contextmanager
def traced_call():
    """The scope of a traced call: :func:`in_hybridized_call` is true
    inside it. A hybridized block's call, a compiled step's body
    (``cached_step.TrainStep``) and ``parallel.ShardedTrainer``'s step
    run in it, as the reference's hybridized forward and its compiled
    steps are traces."""
    _HYBRID.depth += 1
    try:
        yield
    finally:
        _HYBRID.depth -= 1


def in_hybridized_call() -> bool:
    """True while a hybridized block (with its parameters initialized)
    runs its forward: the port's stand-in for the reference's trace."""
    return _HYBRID.depth > 0


def _nd_call(block, args, kwargs):
    """``block``'s call given NDArrays: the call on their tensors, its
    tensor outputs wrapped on the first NDArray's context."""
    ctx = next(a.ctx for a in (*args, *kwargs.values())
               if isinstance(a, NDArray))

    def un(a):
        return a._data if isinstance(a, NDArray) else a

    out = block(*map(un, args), **{k: un(v) for k, v in kwargs.items()})
    return _rewrap(out, ctx)


def _rewrap(out, ctx):
    if isinstance(out, torch.Tensor):
        return _wrap(out, ctx)
    if isinstance(out, (list, tuple)):
        return type(out)(_rewrap(o, ctx) for o in out)
    return out


class Block:
    """Base class of layers and models."""

    _default_ctx = None      # the device ``initialize`` uses when given none

    def __init__(self):
        self._children: "OrderedDict[str, Block]" = OrderedDict()
        self._reg_params: "OrderedDict[str, Parameter]" = OrderedDict()

    def __setattr__(self, name, value):
        if isinstance(value, Block):
            self.__dict__.get("_children", {})[name] = value
        elif isinstance(value, Parameter):
            if "_reg_params" not in self.__dict__:
                raise RuntimeError("Block.__init__() must be called before "
                                   "assigning Parameters")
            self._reg_params[name] = value
        super().__setattr__(name, value)

    def register_child(self, block: "Block") -> None:
        """Register ``block`` as the next numbered child ("0", "1", ...)."""
        self._children[str(len(self._children))] = block

    # -- params ----------------------------------------------------------
    def collect_params(self) -> "OrderedDict[str, Parameter]":
        """Structural name -> Parameter over the whole tree: a block's own
        parameters first, then its children's under ``<child name>.``."""
        out: "OrderedDict[str, Parameter]" = OrderedDict()

        def walk(block: "Block", prefix: str):
            for name, p in block._reg_params.items():
                out[prefix + name] = p
            for cname, child in block._children.items():
                walk(child, prefix + cname + ".")

        walk(self, "")
        return out

    def initialize(self, init=None, ctx=None, verbose=False,
                   force_reinit=False) -> None:
        """Initialize every parameter on ``ctx`` (the block's default
        device, else ``cuda``; raises without CUDA unless given the CPU),
        filled by ``init`` (default ``Uniform()``) where the parameter has
        no initializer of its own."""
        device = resolve_device(ctx if ctx is not None
                                else self._default_ctx)
        init = initializer.create(init)
        for p in self.collect_params().values():
            p.initialize(None, device, default_init=init,
                         force_reinit=force_reinit)

    def load_dict(self, param_dict) -> None:
        """Set every parameter by structural name from tensors or arrays;
        raises ``KeyError`` on a missing or extra name."""
        params = self.collect_params()
        missing = sorted(set(params) - set(param_dict))
        extra = sorted(set(param_dict) - set(params))
        if missing or extra:
            raise KeyError(f"param names differ from the block's: missing "
                           f"{missing[:5]}, unexpected {extra[:5]}")
        for k, v in param_dict.items():
            params[k].set_data(v)

    def cast(self, dtype):
        for p in self.collect_params().values():
            p.cast(dtype)
        return self

    def zero_grad(self) -> None:
        for p in self.collect_params().values():
            p.zero_grad()

    def hybridize(self, active: bool = True, **kwargs) -> None:
        for child in self._children.values():
            child.hybridize(active, **kwargs)

    def infer_shape(self, *args):
        raise ValueError(
            f"{type(self).__name__} has parameters with unknown shape. You "
            "must implement infer_shape(self, *args) for deferred "
            "initialization, or specify input sizes explicitly.")

    def _deferred_infer_shape(self, *args):
        self.infer_shape(*args)
        for p in self._reg_params.values():
            if p._deferred_init:
                p._finish_deferred_init()

    # -- execution -------------------------------------------------------
    def __call__(self, *args, **kwargs):
        # given NDArrays, the call runs on their tensors (so the forward,
        # and every block call nested in it, holds only tensors); the test
        # is inline, as every block call makes it
        for a in args:
            if isinstance(a, NDArray):
                return _nd_call(self, args, kwargs)
        if kwargs and any(isinstance(v, NDArray) for v in kwargs.values()):
            return _nd_call(self, args, kwargs)
        return self._eager(*args, **kwargs)

    def _eager(self, *args, **kwargs):
        """The forward on tensors, completing a deferred initialization."""
        try:
            return self.forward(*args, **kwargs)
        except DeferredInitializationError:
            self._deferred_infer_shape(*args)
            return self.forward(*args, **kwargs)

    def forward(self, *args, **kwargs):
        raise NotImplementedError


class _Pending:
    """A graphed call's claim on its program's activations, released by
    its backward or when its autograd node is freed."""

    def __init__(self, prog, gen):
        self._prog, self._gen = prog, gen
        prog.pending = gen

    def release(self):
        if self._prog.pending == self._gen:
            self._prog.pending = None

    __del__ = release


class _GraphedNode(torch.autograd.Function):
    """A hybridized block's recorded call as one tape node: the forward
    replays the block's captured forward, the backward its captured
    backward (``program_store.VjpProgram``). Inputs: the call's tensors,
    then the parameters that take gradients, so that autograd delivers
    their gradients to the parameters (``grad_req`` write and add)."""

    @staticmethod
    def forward(ctx, block, prog, n_in, *tensors):
        gen, outs = prog.forward(tensors[:n_in])
        ctx.block, ctx.prog, ctx.gen, ctx.n_in = block, prog, gen, n_in
        ctx.pending = _Pending(prog, gen)
        ctx.training = autograd.is_training()
        ctx.needs = [t.requires_grad for t in tensors]
        ctx.save_for_backward(*tensors)
        return tuple(outs)

    @staticmethod
    def backward(ctx, *gouts):
        if torch.is_grad_enabled():
            grads = ctx.block._second_order(ctx, gouts)
        else:
            wrt = iter(ctx.prog.backward(ctx.gen, list(gouts)))
            grads = [next(wrt) if need else None for need in ctx.needs]
        ctx.pending.release()
        return (None, None, None) + tuple(grads)


class HybridBlock(Block):
    """A block that can be hybridized (see the module docstring). As in the
    reference, only the outermost block's flag counts, since ``hybridize``
    clears the children's, and each ``hybridize`` call drops the block's
    programs."""

    def __init__(self):
        super().__init__()
        self._active = False
        self._programs = None
        self._bucket = False
        self._bucket_refused: Optional[str] = None
        self._bucket_verified: set = set()
        # why the last call under record() ran eagerly (None: graphed)
        self.last_eager_reason: Optional[str] = None

    def hybridize(self, active: bool = True, bucket=None, **kwargs) -> None:
        """Run the block's forward as captured programs (see the module
        docstring). ``bucket=True`` pads the batch axis of predict-mode
        calls outside ``record()`` up to its bucket
        (``serving.BucketPolicy``, ``MXNET_SHAPE_BUCKETS``) and slices the
        outputs back; the first call of each bucket is checked against the
        unpadded eager forward (``MXNET_SERVE_VERIFY``), and a mismatch
        refuses bucketing for good (reason in ``_bucket_refused``)."""
        self._active = bool(active)
        if bucket is not None:
            self._bucket = bool(bucket)
        self._programs = None
        super().hybridize(False, **kwargs)

    def __call__(self, *args, **kwargs):
        for a in args:                  # as Block.__call__
            if isinstance(a, NDArray):
                return _nd_call(self, args, kwargs)
        if kwargs and any(isinstance(v, NDArray) for v in kwargs.values()):
            return _nd_call(self, args, kwargs)
        if not self._active:
            return self._eager(*args, **kwargs)
        params = self.collect_params()
        if any(p._data is None for p in params.values()):
            # a first call that completes deferred initialization runs
            # eagerly, as in the reference
            return self._eager(*args, **kwargs)
        with traced_call():
            if kwargs or _pstore.in_program() or not args or not all(
                    isinstance(a, torch.Tensor) for a in args):
                return self._eager(*args, **kwargs)
            if autograd.is_recording() and (
                    any(p.grad_req != "null" for p in params.values())
                    or any(a.requires_grad for a in args)):
                if not _config.get("MXNET_COMPILED_STEP"):
                    self.last_eager_reason = "MXNET_COMPILED_STEP=0"
                    return self._eager(*args)
                return self._call_recorded(args, params)
            if self._bucket and self._bucket_refused is None and \
                    not autograd.is_training() and \
                    not autograd.is_recording():
                out = self._call_bucketed(args, params)
                if out is not None:
                    return out
            return self._call_cached(args, params)

    def _scope(self):
        if self._programs is None:
            self._programs = _pstore.scope("hybrid_forward")
        return self._programs

    def _call_cached(self, args, params):
        """The forward as a program of this block's ``hybrid_forward``
        scope, run with torch's grad mode off."""
        held = [p._data for p in params.values()]
        key = (_pstore.tensor_key(args), autograd.is_training(),
               _pstore.knob_key(), _pstore.storage_key(held))

        def body(*inputs):
            with torch.no_grad():
                return self._eager(*inputs)

        return _pstore.run(self._scope(), key, lambda: body, args,
                           keep=held)

    # -- the recorded forward ---------------------------------------------
    def _call_recorded(self, args, params):
        """The call as one graphed tape node (:class:`_GraphedNode`), or
        eagerly, with the reason in ``last_eager_reason``, while the
        program's last call still awaits its backward."""
        diff = [p for p in params.values() if p.grad_req != "null"]
        held = [p._data for p in params.values()]
        needs = tuple(a.requires_grad for a in args)
        key = ("recorded", _pstore.tensor_key(args), needs,
               tuple(p.grad_req != "null" for p in params.values()),
               autograd.is_training(), _pstore.knob_key(),
               _pstore.storage_key(held))
        cache = self._scope()
        prog = cache.lookup(key)
        if prog is not None and prog.pending is not None:
            self.last_eager_reason = (
                "an earlier recorded call of this block still awaits its "
                "backward (one graphed call at a time: the program's "
                "activations are those of its last call)")
            return self._eager(*args)
        self.last_eager_reason = None
        weights = [p._data for p in diff]
        tensors = list(args) + weights
        if prog is not None:
            return self._unpack(_GraphedNode.apply(self, prog, len(args),
                                                   *tensors))
        cache.drop_stale(held)

        def body(*inputs):
            ins = [x.detach().requires_grad_(need)
                   for x, need in zip(inputs, needs)]
            leaves = [w.detach().requires_grad_() for w in weights]
            try:
                for p, leaf in zip(diff, leaves):
                    p._data = leaf
                out = self._eager(*ins)
            finally:
                for p, w in zip(diff, weights):
                    p._data = w
            outs = list(out) if isinstance(out, (tuple, list)) else [out]
            wrt = [x for x, need in zip(ins, needs) if need] + leaves
            return outs, wrt

        prog = _pstore.VjpProgram(cache.namespace, body, args,
                                  args[0].device, keep=held)
        out = _GraphedNode.apply(self, prog, len(args), *tensors)
        cache.insert(key, prog)
        return self._unpack(out)

    @staticmethod
    def _unpack(out):
        return out[0] if len(out) == 1 else out

    def _second_order(self, ctx, gouts):
        """A backward that builds a graph itself (``create_graph=True``)
        runs eagerly: the forward is recomputed from the node's saved
        inputs with the running statistics restored after it, and
        differentiated with ``create_graph``."""
        self.last_eager_reason = (
            "a second-order backward (create_graph=True) recomputes the "
            "forward eagerly")
        saved = ctx.saved_tensors
        ins = saved[:ctx.n_in]
        frozen = [p._data for p in self.collect_params().values()
                  if p.grad_req == "null" and p._data is not None]
        snap = [t.clone() for t in frozen]
        try:
            with traced_call(), autograd.record(train_mode=ctx.training):
                out = self._eager(*ins)
        finally:
            with torch.no_grad():
                for t, v in zip(frozen, snap):
                    t.copy_(v)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        wrt = [t for t, need in zip(saved, ctx.needs) if need]
        grads = iter(torch.autograd.grad(outs, wrt, list(gouts),
                                         create_graph=True,
                                         allow_unused=True))
        return [next(grads) if need else None for need in ctx.needs]

    # -- shape buckets ----------------------------------------------------
    def _call_bucketed(self, args, params):
        """A predict-mode call padded to its bucket and sliced back, or
        None where padding does not apply (bucketing off, an exact fit, no
        common batch axis); see :meth:`hybridize`."""
        policy = _serving.BucketPolicy()
        if not policy.enabled or any(a.dim() < 1 for a in args):
            return None
        n = int(args[0].shape[0])
        if any(int(a.shape[0]) != n for a in args):
            return None
        b = policy.bucket(n)
        if b is None or b == n:
            return None
        out = self._call_cached([_serving.pad_axis0(a, b) for a in args],
                                params)
        outs = list(out) if isinstance(out, (tuple, list)) else [out]
        if any(o.dim() < 1 or int(o.shape[0]) != b for o in outs):
            self._bucket_refused = (
                "output does not carry the batch axis; cannot slice padded "
                "rows back")
            with torch.no_grad():
                return self._eager(*args)
        sliced = [o[:n] for o in outs]
        result = type(out)(sliced) if isinstance(out, (tuple, list)) \
            else sliced[0]
        key = (b, _pstore.tensor_key(args))
        ns = _pstore.namespace("serving")
        if key in self._bucket_verified:
            ns.bump("hits")
            return result
        ns.bump("misses")
        verify = int(_config.get("MXNET_SERVE_VERIFY"))
        if verify:
            with torch.no_grad():
                ref = self._eager(*args)
            refs = list(ref) if isinstance(ref, (tuple, list)) else [ref]
            for got, want in zip(sliced, refs):
                if got.shape == want.shape and (torch.equal(got, want) or (
                        verify < 2 and torch.allclose(got, want, rtol=1e-5,
                                                      atol=1e-6))):
                    continue
                self._bucket_refused = (
                    "padded and sliced forward differs from the unpadded "
                    "eager forward (outputs couple across the batch axis); "
                    "bucketing refused for this block")
                return ref
        self._bucket_verified.add(key)
        return result

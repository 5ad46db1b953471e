"""Continuous-batching autoregressive serving: captured decode programs, a
paged KV cache with a content-addressed prefix cache, multi-model SLO-aware
admission, and seeded sampling.

Counterpart of ``mxnet_tpu/serving_decode.py``:

1. **A bounded program set.** Per-token work is ONE captured decode
   program (``GenerativeEngine._decode_fn``): the page-table gather of
   the KV context, the attention, the sampler for every row and the KV
   scatter (dead rows into the trash page) are one CUDA graph over static
   input buffers (tokens, tables, lengths, sampling arguments) at a fixed
   row capacity ``MXNET_SERVE_DECODE_ROWS``, plus one captured prefill per
   sequence-length bucket (``serving.BucketPolicy``) and, on a partial
   prefix hit, one suffix-prefill program per suffix bucket. Programs live
   in the program store's ``serving_decode`` namespace;
   :meth:`GenerativeEngine.warmup` captures the prefill grid and the
   decode program before the scheduler thread starts. Steady state: 0
   captures, 1 replay per decode iteration, 1 host read of the next tokens
   per iteration.

2. **Paged KV cache** (:class:`PagePool`): a fixed device pool of
   ``MXNET_KV_PAGES`` pages of ``MXNET_KV_PAGE`` tokens, one global free
   list, storage per KV geometry as ``(pages+1, page, L, H, D)`` K and V
   tensors whose index ``pages`` is the trash page. The programs update
   the storage in place (the counterpart of the reference's donation), so
   every captured program sees fixed addresses.

3. **Multi-model, SLO-aware admission**: engines share one pool
   (:func:`shared_pool`), program caps stay per owner, dispatches of the
   engines on one pool order through :class:`_DispatchGate`, and admission
   is priced from measured EMAs: queue, pool, SLO, draining and deadline
   refusals raise the typed :class:`faults.ShedError` at once (site
   ``serving.admit``). Pool exhaustion mid-decode preempts the youngest
   sequence, which re-queues keeping its seniority and enqueue clock.

4. **Content-addressed prefix cache** (``MXNET_PREFIX_CACHE``, on by
   default): prompt pages keyed by a chained hash of their token blocks,
   refcounted, published after prefill, kept in an LRU when unreferenced,
   forked copy-on-write at the first divergent write.

5. **Seeded sampling** (:class:`SamplingSpec`): temperature, top-k and
   top-p by Gumbel-argmax, keyed by ``fold_in(PRNGKey(seed), position)``.
   The port reproduces JAX's threefry-2x32 (``PRNGKey``, ``fold_in``, the
   32-bit ``random_bits`` path with ``jax_threefry_partitionable`` and
   ``gumbel``'s uniform-to-Gumbel map) in int64 tensors masked to 32 bits,
   so a sampled request replays the reference seed for seed and stays a
   pure function of (seed, position): safe inside a CUDA graph and across
   a preemption. Temperature 0 is the plain argmax, bitwise. The decode,
   draft-round and verify programs each come in two sampler forms
   (:data:`FORMS`), picked per step from what the host knows of the live
   rows: ``greedy`` (every row greedy: no sampler) and ``full``. Each
   form gives its rows the full sampler's tokens bitwise;
   the reference traces the full sampler into every program, where XLA
   fuses it, while here each of its ops is a launch (or, on the CPU, a
   dispatch).

6. **Speculative decoding** (``MXNET_SPEC_DECODE``, ``MXNET_SPEC_K``;
   reference :1141-1170, :2060-2620): an engine built with a ``draft``
   model runs, when the cost table says it pays, rounds of ONE captured
   draft program (an optional catch-up step, then ``kmax`` proposals with
   their sampling distributions, all on the device) and ONE captured verify
   program per ``k`` (the target's ``decode_chunk`` over the pending token
   and ``k`` proposals, standard rejection sampling, the residual resample,
   and the KV scatter of the accepted prefix only; rejected positions write
   the trash page), then one host read of ``(n_acc, next, proposals)``. The
   draft's KV pages live in the same pool under their own geometry and are
   never published to the prefix cache. The programs live in the
   ``serving_spec`` namespace; ``warmup`` captures them too. Greedy decode
   stays token-exact; sampled decode draws the accept test from JAX's
   ``uniform`` (:func:`uniform`, bitwise) and the resample from ``gumbel``
   on the same counter-based keys as the reference. A page shortage skips
   the round (plain decode instead), as in the reference; a failing
   dispatch or capture raises to the round's requests, where the reference
   turns speculation off.

One deliberate divergence: :meth:`PagePool.poison_free` takes the free
list and writes the poison under one lock; the reference copies the list
under its lock and writes later, so a page reallocated in between gets
poisoned (ROADMAP Queue C).
"""
from __future__ import annotations

import hashlib
import heapq
import math
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import config as _config
from . import engine as _engine
from . import faults as _faults
from . import preemption as _preemption
from . import program_store as _pstore
from . import telemetry as _telemetry
from .context import resolve_device
from .faults import ShedError
from .serving import BucketPolicy

__all__ = ["PagePool", "PagePoolExhausted", "ShedError", "DecodeModel",
           "TinyCausalLM", "GenerativeEngine", "shared_pool",
           "eager_generate", "trace_count", "dispatch_count",
           "reset_counters", "SamplingSpec", "GREEDY", "sample_token",
           "sample_scores",
           "token_key", "prng_key", "fold_in", "threefry_2x32",
           "random_bits", "gumbel", "uniform", "spec_trace_count",
           "spec_dispatch_count", "high_agreement_pair", "FORMS",
           "sampling_form"]

_NS = _pstore.namespace("serving_decode")
# the speculative programs (draft prefill, draft round, verify) in their own
# namespace, so that their program set and "0 spec dispatches with
# MXNET_SPEC_DECODE=0" read apart from the plain decode budget
_SPEC_NS = _pstore.namespace("serving_spec")


def trace_count() -> int:
    return _NS.traces


def dispatch_count() -> int:
    return _NS.dispatches


def spec_trace_count() -> int:
    return _SPEC_NS.traces


def spec_dispatch_count() -> int:
    return _SPEC_NS.dispatches


def reset_counters() -> None:
    _NS.reset()
    _SPEC_NS.reset()


class PagePoolExhausted(ShedError):
    """No free KV-cache pages: the typed refusal admission raises and the
    scheduler's preemption path absorbs."""

    kind = "pool"


class _DispatchGate:
    """SLO-aware dispatch ordering across the engines sharing one pool:
    each prefill or decode dispatch acquires the gate with a priority (the
    engine's SLO, ``inf`` when unset) and waiters are served most urgent
    first, FIFO on ties, so a fast model waits for at most one slow step."""

    def __init__(self):
        self._cv = threading.Condition()
        self._busy = False
        self._seq = 0
        self._heap: List[Tuple[float, int]] = []

    def acquire(self, priority: float) -> None:
        with self._cv:
            self._seq += 1
            tok = (priority, self._seq)
            heapq.heappush(self._heap, tok)
            while self._busy or self._heap[0] != tok:
                self._cv.wait()
            heapq.heappop(self._heap)
            self._busy = True

    def release(self) -> None:
        with self._cv:
            self._busy = False
            self._cv.notify_all()


# process-global prefix-cache counters (family 'prefix')
_PREFIX_STATS = _telemetry.CounterGroup(
    "prefix", ("hit_blocks", "miss_blocks", "cow_forks", "evictions"),
    doc="content-addressed KV prefix cache (MXNET_PREFIX_CACHE)",
    family="prefix")


# process-global speculative-decoding counters (family 'spec'): rounds (1
# draft + 1 verify dispatch each), draft tokens proposed and accepted, rounds
# the arbiter declined, sticky low-acceptance cutoffs
_SPEC_STATS = _telemetry.CounterGroup(
    "spec", ("rounds", "proposed", "accepted", "fallback_rounds",
             "autodisabled"),
    doc="speculative decoding (MXNET_SPEC_DECODE)", family="spec")

_telemetry.gauge_fn(
    "spec.acceptance_rate",
    lambda: (_SPEC_STATS["accepted"] / _SPEC_STATS["proposed"]
             if _SPEC_STATS["proposed"] else 0.0),
    doc="speculative decoding: fraction of drafted tokens accepted",
    family="spec")
_telemetry.gauge_fn(
    "spec.tokens_per_target_dispatch",
    lambda: ((_SPEC_STATS["accepted"] + _SPEC_STATS["rounds"])
             / _SPEC_STATS["rounds"] if _SPEC_STATS["rounds"] else 0.0),
    doc="speculative decoding: tokens committed per verify dispatch",
    family="spec")


def _chain_keys(tokens: Sequence[int], page: int,
                geom: Tuple) -> List[bytes]:
    """Rolling content keys, one per ``page``-token block of ``tokens``
    (the last block may be partial): key ``i`` is ``blake2b(key[i-1] ||
    block_i)`` seeded with the KV geometry, so a key commits to the whole
    token prefix through its block and to the storage layout."""
    prev = repr((geom, page)).encode()
    keys: List[bytes] = []
    for i in range(0, len(tokens), page):
        h = hashlib.blake2b(prev, digest_size=16)
        h.update(np.asarray(tokens[i:i + page], np.int64).tobytes())
        prev = h.digest()
        keys.append(prev)
    return keys


# ---------------------------------------------------------------------------
# Paged KV-cache pool
# ---------------------------------------------------------------------------
class PagePool:
    """Fixed pool of KV-cache pages shared by every engine in the process.

    Accounting is global (one free list of ``pages`` page ids); storage is
    per KV geometry ``(n_layers, n_heads, head_dim, dtype)``: a
    ``(pages+1, page, L, H, D)`` K tensor and V tensor on the pool's
    device, index ``pages`` the trash page that masked rows and pad
    positions write. Engines sharing a geometry share storage, so their
    dispatches serialize through :meth:`exclusive`. The programs update the
    storage in place; :meth:`set_storage` copies into the same tensors, so
    their addresses never change. ``alloc`` raises
    :class:`PagePoolExhausted` instead of blocking. ``device`` (default:
    the first registering engine's) is where the storage lives.
    """

    def __init__(self, pages: Optional[int] = None,
                 page: Optional[int] = None, device=None):
        self.page = int(page if page is not None
                        else _config.get("MXNET_KV_PAGE"))
        self.pages = int(pages if pages is not None
                         else _config.get("MXNET_KV_PAGES"))
        if self.page < 1 or self.pages < 1:
            raise ValueError(
                f"PagePool needs pages>=1, page>=1 (got {self.pages}, "
                f"{self.page})")
        self.device = None if device is None else resolve_device(device)
        # LIFO free list: a just-freed page is reused first
        self._free: List[int] = list(range(self.pages - 1, -1, -1))
        self._in_use: set = set()
        self._refs: Dict[int, int] = {}
        self._index: Dict[Tuple, Dict[bytes, int]] = {}  # geom -> key -> page
        self._page_key: Dict[int, Tuple[Tuple, bytes]] = {}
        self._lru: "OrderedDict[int, None]" = OrderedDict()
        self._lock = threading.Lock()
        self._storage: Dict[Tuple, List[torch.Tensor]] = {}
        self._geom_locks: Dict[Tuple, threading.RLock] = {}
        self.gate = _DispatchGate()
        self._counts = _telemetry.CounterGroup(
            _telemetry.instance_name("kv_pool"),
            ("alloc", "free", "exhausted"),
            doc="paged KV-cache pool page accounting", family="kv_pool")
        self.high_water = 0

    @property
    def alloc_count(self) -> int:
        return self._counts["alloc"]

    @property
    def free_count(self) -> int:
        return self._counts["free"]

    @property
    def exhausted_count(self) -> int:
        return self._counts["exhausted"]

    @property
    def trash(self) -> int:
        """The reserved scratch page index (== ``pages``): never allocated
        and never read unmasked."""
        return self.pages

    # -- accounting (by reference: alloc and a prefix hit acquire one, free
    # releases one, so alloc_count - free_count == live references) -------
    def _evict_locked(self, n: int) -> None:
        """Reclaim ``n`` cached, unreferenced pages (oldest first) onto the
        free list; a referenced page is never reclaimed."""
        for _ in range(n):
            p, _ = self._lru.popitem(last=False)
            geom, key = self._page_key.pop(p)
            self._index[geom].pop(key, None)
            self._free.append(p)
            _PREFIX_STATS.inc("evictions")

    def alloc(self, n: int) -> List[int]:
        with self._lock:
            short = n - len(self._free)
            if short > len(self._lru):
                self._counts.inc("exhausted")
                raise PagePoolExhausted(
                    f"KV page pool exhausted: need {n} page(s), "
                    f"{len(self._free)} free + {len(self._lru)} "
                    f"evictable of {self.pages} "
                    f"(page={self.page} tokens)")
            if short > 0:
                self._evict_locked(short)
            got = [self._free.pop() for _ in range(n)]
            self._in_use.update(got)
            for p in got:
                self._refs[p] = 1
            self._counts.inc("alloc", n)
            self.high_water = max(self.high_water, len(self._in_use))
            return got

    def free(self, pages: Sequence[int]) -> None:
        """Release one reference per page; an unreferenced page returns to
        the free list, or parks in the resident LRU when it holds
        published prefix content."""
        with self._lock:
            for p in pages:
                if p not in self._in_use:
                    raise ValueError(
                        f"double/foreign free of page {p} (in_use="
                        f"{len(self._in_use)})")
                self._counts.inc("free")
                self._refs[p] -= 1
                if self._refs[p] > 0:
                    continue
                del self._refs[p]
                self._in_use.discard(p)
                if p in self._page_key:
                    self._lru[p] = None
                else:
                    self._free.append(p)

    def in_use(self) -> int:
        with self._lock:
            return len(self._in_use)

    def free_pages(self) -> int:
        """Allocatable pages: free plus cached-but-unreferenced."""
        with self._lock:
            return len(self._free) + len(self._lru)

    def ref(self, p: int) -> int:
        """Reference count of page ``p`` (0 = free or cached)."""
        with self._lock:
            return self._refs.get(p, 0)

    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {"pages": self.pages, "page": self.page,
                    "in_use": len(self._in_use),
                    "free": len(self._free),
                    "cached": len(self._lru),
                    "alloc_count": self.alloc_count,
                    "free_count": self.free_count,
                    "exhausted_count": self.exhausted_count,
                    "high_water": self.high_water}

    # -- content-addressed prefix cache ------------------------------------
    def lookup(self, geom: Tuple, keys: Sequence[bytes]) -> List[int]:
        """Longest cached prefix of the chain ``keys``: acquires one
        reference per hit page (an LRU resident revives) and stops at the
        first miss; counts hit and miss blocks."""
        hits: List[int] = []
        with self._lock:
            idx = self._index.get(geom, {})
            for key in keys:
                p = idx.get(key)
                if p is None:
                    break
                if p in self._in_use:
                    self._refs[p] += 1
                else:
                    self._lru.pop(p)
                    self._in_use.add(p)
                    self._refs[p] = 1
                self._counts.inc("alloc")
                self.high_water = max(self.high_water, len(self._in_use))
                hits.append(p)
        _PREFIX_STATS.inc("hit_blocks", len(hits))
        _PREFIX_STATS.inc("miss_blocks", len(keys) - len(hits))
        return hits

    def publish(self, geom: Tuple,
                entries: Sequence[Tuple[bytes, int]]) -> None:
        """Register freshly prefilled pages under their chain keys; the
        first writer wins."""
        with self._lock:
            idx = self._index.setdefault(geom, {})
            for key, p in entries:
                if key in idx or p in self._page_key:
                    continue
                if p not in self._in_use:
                    raise ValueError(
                        f"publish of page {p} which is not in use")
                idx[key] = p
                self._page_key[p] = (geom, key)

    def holds(self, geom: Tuple, keys: Sequence[bytes]) -> int:
        """How many leading blocks of the chain are resident; no reference
        bump, no device work."""
        with self._lock:
            idx = self._index.get(geom)
            if not idx:
                return 0
            n = 0
            for key in keys:
                if key not in idx:
                    break
                n += 1
            return n

    def shared(self, p: int) -> bool:
        """True when writing page ``p`` needs a copy-on-write fork first:
        another row references it, or it is published content."""
        with self._lock:
            return self._refs.get(p, 0) > 1 or p in self._page_key

    def fork(self, geom: Tuple, p: int) -> int:
        """Copy-on-write: a private copy of page ``p`` (device copy under
        the geometry's lock), this caller's reference on ``p`` released;
        returns the new page id. May evict or raise like ``alloc``."""
        new = self.alloc(1)[0]
        with self.exclusive(geom):
            k, v = self._storage[geom]
            k[new].copy_(k[p])
            v[new].copy_(v[p])
        self.free([p])
        _PREFIX_STATS.inc("cow_forks")
        return new

    def clear_prefix_cache(self) -> int:
        """Drop every cached, unreferenced page back to the free list and
        unpublish all keys; returns the pages reclaimed."""
        with self._lock:
            reclaimed = len(self._lru)
            for p in self._lru:
                self._free.append(p)
            self._lru.clear()
            self._index.clear()
            self._page_key.clear()
            return reclaimed

    def audit(self) -> List[str]:
        """Refcount and bookkeeping invariants: violation strings, [] when
        sound."""
        bad: List[str] = []
        with self._lock:
            if set(self._refs) != self._in_use:
                bad.append(f"refs/in_use mismatch: {sorted(self._refs)}"
                           f" vs {sorted(self._in_use)}")
            for p, r in self._refs.items():
                if r < 1:
                    bad.append(f"page {p} in use with refcount {r}")
            free, lru = set(self._free), set(self._lru)
            if free & lru:
                bad.append(f"pages both free and cached: {free & lru}")
            if free & self._in_use or lru & self._in_use:
                bad.append("pages both free/cached and in use: "
                           f"{(free | lru) & self._in_use}")
            total = len(self._free) + len(self._lru) + len(self._in_use)
            if total != self.pages:
                bad.append(f"page conservation broke: {len(self._free)}"
                           f" free + {len(self._lru)} cached + "
                           f"{len(self._in_use)} in use != {self.pages}")
            for geom, idx in self._index.items():
                for key, p in idx.items():
                    if self._page_key.get(p) != (geom, key):
                        bad.append(f"index key {key.hex()} -> page {p} "
                                   "lacks its reverse mapping")
                    if p not in self._in_use and p not in lru:
                        bad.append(f"index key {key.hex()} -> page {p} "
                                   "which is neither live nor cached")
        return bad

    # -- storage -----------------------------------------------------------
    def register(self, n_layers: int, n_heads: int, head_dim: int,
                 dtype=torch.float32, device=None) -> Tuple:
        """Declare a KV geometry on ``device`` (the pool's, which the first
        registration fixes); allocates its K and V storage on first sight.
        Returns the storage key."""
        dtype = torch.float32 if dtype is None else dtype
        geom = (int(n_layers), int(n_heads), int(head_dim),
                str(dtype).replace("torch.", ""))
        with self._lock:
            dev = resolve_device(device if device is not None
                                 else self.device)
            if self.device is None:
                self.device = dev
            elif dev != self.device:
                raise ValueError(
                    f"PagePool storage lives on {self.device}; an engine on "
                    f"{dev} cannot share it")
            if geom not in self._storage:
                shape = (self.pages + 1, self.page, geom[0], geom[1],
                         geom[2])
                self._storage[geom] = [
                    torch.zeros(shape, dtype=dtype, device=dev),
                    torch.zeros(shape, dtype=dtype, device=dev)]
                self._geom_locks[geom] = threading.RLock()
        return geom

    def exclusive(self, geom: Tuple) -> threading.RLock:
        """The per-geometry dispatch lock: every program that updates this
        geometry's storage holds it across the dispatch."""
        return self._geom_locks[geom]

    def storage(self, geom: Tuple) -> Tuple[torch.Tensor, torch.Tensor]:
        k, v = self._storage[geom]
        return k, v

    def set_storage(self, geom: Tuple, k, v) -> None:
        """Write ``k`` and ``v`` into the geometry's storage tensors, which
        keep their addresses (a no-op for the storage itself)."""
        sk, sv = self._storage[geom]
        if k is not sk:
            sk.copy_(k)
        if v is not sv:
            sv.copy_(v)

    # -- test hook ---------------------------------------------------------
    def poison_free(self, value: float = 1e30) -> int:
        """Overwrite every free page (all geometries) with ``value``: the
        aliasing canary. The free list is read and the poison written
        under one hold of the pool's lock, so no page can be allocated in
        between and get poisoned while live (the reference reads under the
        lock and writes after it). Returns the pages poisoned."""
        with self._lock:
            free = list(self._free)
            if not free:
                return 0
            for g, (k, v) in self._storage.items():
                idx = torch.tensor(free, dtype=torch.long, device=k.device)
                with self.exclusive(g):
                    k[idx] = value
                    v[idx] = value
            return len(free)


_SHARED: Optional[PagePool] = None
_SHARED_LOCK = threading.Lock()


def shared_pool() -> PagePool:
    """The process-shared pool every engine defaults to (sized by
    ``MXNET_KV_PAGES`` / ``MXNET_KV_PAGE`` at first use)."""
    global _SHARED
    with _SHARED_LOCK:
        if _SHARED is None:
            _SHARED = PagePool()
        return _SHARED


# ---------------------------------------------------------------------------
# Model contract
# ---------------------------------------------------------------------------
def _row(x: torch.Tensor, i) -> torch.Tensor:
    """``x[i]`` for an int or a 0-d index tensor (no host read)."""
    if isinstance(i, torch.Tensor):
        return x.index_select(0, i.reshape(1).long())[0]
    return x[i]


class DecodeModel:
    """What a model provides to serve through :class:`GenerativeEngine`:
    ``vocab``, ``n_layers``, ``n_heads``, ``head_dim``, ``max_seq`` and
    functions of explicit parameter dicts (the engine owns paging, dead-row
    masking and batching):

    - ``prefill(params, tokens, length) -> (logits, k, v)``: one sequence,
      ``tokens`` ``(B,)`` padded to a bucket, ``length`` the true length;
      next-token ``logits`` ``(vocab,)`` at ``length-1`` and the cache
      ``k``/``v`` ``(L, B, H, D)``.
    - ``decode(params, tokens, k_ctx, v_ctx, lengths) -> (logits, k_new,
      v_new)``: one token per row at positions ``lengths`` ``(R,)``,
      attending ``k_ctx``/``v_ctx`` ``(L, R, C, H, D)`` where context
      position ``j`` is valid iff ``j < lengths[r]``.
    - optional ``prefill_chunk(params, tokens, k_ctx, v_ctx, offset,
      length)``: the uncached suffix at positions ``offset ..``, context
      ``(L, C, H, D)`` valid below ``offset``; ``None`` recomputes the
      whole prompt on a partial prefix hit.
    - optional ``decode_chunk(params, tokens, k_ctx, v_ctx, lengths)``:
      ``tokens`` ``(R, S)``, row ``r``'s chunk at positions ``lengths[r] ..
      lengths[r]+S-1``, context ``(L, R, C, H, D)`` valid below
      ``lengths[r]``, causal inside the chunk; ``logits`` ``(R, S, vocab)``
      (``logits[r, i]`` scores the token after chunk position ``i``) and the
      chunk's ``k_new``/``v_new`` ``(L, R, S, H, D)``. The verify scorer of
      speculative decoding; ``None`` refuses a draft.

    ``decode`` over cached K/V equals a fresh ``prefill`` over the
    extended sequence, and ``decode_chunk`` equals ``S`` successive
    ``decode`` calls: that is what makes continuous-batched (and
    speculative) greedy decode token-exact against the eager loop.
    """

    vocab: int
    n_layers: int
    n_heads: int
    head_dim: int
    max_seq: int
    prefill_chunk = None
    decode_chunk = None

    def init_params(self, seed: int = 0, device=None):
        raise NotImplementedError

    def prefill(self, params, tokens, length):
        raise NotImplementedError

    def decode(self, params, tokens, k_ctx, v_ctx, lengths):
        raise NotImplementedError


class TinyCausalLM(DecodeModel):
    """The reference :class:`DecodeModel` (``serving_decode.py:668``): a
    causal transformer with learned token and position embeddings,
    multi-head attention, a ReLU MLP and an untied output head, without
    layer norms, as plain torch functions of explicit parameter dicts."""

    def __init__(self, vocab: int = 64, d_model: int = 32,
                 n_layers: int = 2, n_heads: int = 2,
                 d_mlp: Optional[int] = None, max_seq: int = 128):
        if d_model % n_heads:
            raise ValueError("d_model must divide by n_heads")
        self.vocab = vocab
        self.d_model = d_model
        self.n_layers = n_layers
        self.n_heads = n_heads
        self.head_dim = d_model // n_heads
        self.d_mlp = d_mlp or 2 * d_model
        self.max_seq = max_seq

    def init_params(self, seed: int = 0, device=None):
        """The reference's weights, draw for draw
        (``numpy.random.RandomState(seed)``), as fp32 tensors on
        ``device`` (``cuda`` if None; raises without CUDA unless given the
        CPU)."""
        dev = resolve_device(device)
        rng = np.random.RandomState(seed)

        def mat(*shape, scale=None):
            scale = scale or 1.0 / math.sqrt(shape[0])
            arr = (rng.randn(*shape) * scale).astype(np.float32)
            return torch.from_numpy(arr).to(dev)

        params = {
            "emb": mat(self.vocab, self.d_model, scale=0.5),
            "pos": mat(self.max_seq, self.d_model, scale=0.1),
            "out": mat(self.d_model, self.vocab),
            "layers": [],
        }
        for _ in range(self.n_layers):
            params["layers"].append({
                "wq": mat(self.d_model, self.d_model),
                "wk": mat(self.d_model, self.d_model),
                "wv": mat(self.d_model, self.d_model),
                "wo": mat(self.d_model, self.d_model),
                "w1": mat(self.d_model, self.d_mlp),
                "w2": mat(self.d_mlp, self.d_model),
            })
        return params

    # -- helpers -----------------------------------------------------------
    def _heads(self, x):
        return x.reshape(x.shape[:-1] + (self.n_heads, self.head_dim))

    def _attend(self, q, k, v, valid):
        # q (R, H, D); k/v (R, J, H, D); valid (R, J) bool
        scores = torch.einsum("rhd,rjhd->rhj", q, k) \
            / math.sqrt(self.head_dim)
        scores = scores.masked_fill(~valid[:, None, :], -1e30)
        w = torch.softmax(scores, dim=-1)
        return torch.einsum("rhj,rjhd->rhd", w, v)

    def _mlp(self, h, lp):
        return h + torch.relu(h @ lp["w1"]) @ lp["w2"]

    # -- contract ----------------------------------------------------------
    def prefill(self, params, tokens, length):
        b = tokens.shape[0]
        h = params["emb"][tokens] + params["pos"][:b]        # (B, d)
        pos = torch.arange(b, device=tokens.device)
        causal = pos[:, None] >= pos[None, :]                # (B, B)
        ks, vs = [], []
        for lp in params["layers"]:
            q = self._heads(h @ lp["wq"])                    # (B, H, D)
            k = self._heads(h @ lp["wk"])
            v = self._heads(h @ lp["wv"])
            ks.append(k)
            vs.append(v)
            scores = torch.einsum("ihd,jhd->ihj", q, k) \
                / math.sqrt(self.head_dim)
            scores = scores.masked_fill(~causal[:, None, :], -1e30)
            w = torch.softmax(scores, dim=-1)
            att = torch.einsum("ihj,jhd->ihd", w, v)         # (B, H, D)
            h = h + att.reshape(b, self.d_model) @ lp["wo"]
            h = self._mlp(h, lp)
        logits = _row(h, length - 1) @ params["out"]         # (vocab,)
        return logits, torch.stack(ks), torch.stack(vs)      # (L,B,H,D)

    def decode(self, params, tokens, k_ctx, v_ctx, lengths):
        r = tokens.shape[0]
        c = k_ctx.shape[2]
        h = params["emb"][tokens] + params["pos"][lengths]   # (R, d)
        ctx_valid = torch.arange(c, device=tokens.device)[None, :] \
            < lengths[:, None]                               # (R, C)
        # the new token always attends itself (appended key slot C)
        valid = torch.cat(
            [ctx_valid, torch.ones((r, 1), dtype=torch.bool,
                                   device=tokens.device)], dim=1)
        k_news, v_news = [], []
        for li, lp in enumerate(params["layers"]):
            q = self._heads(h @ lp["wq"])                    # (R, H, D)
            k_new = self._heads(h @ lp["wk"])
            v_new = self._heads(h @ lp["wv"])
            k_news.append(k_new)
            v_news.append(v_new)
            k = torch.cat([k_ctx[li], k_new[:, None]], dim=1)
            v = torch.cat([v_ctx[li], v_new[:, None]], dim=1)
            att = self._attend(q, k, v, valid)               # (R, H, D)
            h = h + att.reshape(r, self.d_model) @ lp["wo"]
            h = self._mlp(h, lp)
        logits = h @ params["out"]                           # (R, vocab)
        return logits, torch.stack(k_news), torch.stack(v_news)

    def prefill_chunk(self, params, tokens, k_ctx, v_ctx, offset, length):
        b = tokens.shape[0]
        c = k_ctx.shape[1]
        dev = tokens.device
        ii = torch.arange(b, device=dev)
        pos = offset + ii
        h = params["emb"][tokens] \
            + params["pos"][torch.clamp(pos, max=self.max_seq - 1)]
        # cached context: every suffix token attends positions < offset
        ctx_valid = (torch.arange(c, device=dev)[None, :] < offset) \
            .expand(b, c)
        # in-chunk: causal, and pad keys (global pos >= length) masked
        chunk_valid = (ii[None, :] <= ii[:, None]) \
            & (ii[None, :] < length - offset)
        valid = torch.cat([ctx_valid, chunk_valid], dim=1)
        ks, vs = [], []
        for li, lp in enumerate(params["layers"]):
            q = self._heads(h @ lp["wq"])                    # (B, H, D)
            k_new = self._heads(h @ lp["wk"])
            v_new = self._heads(h @ lp["wv"])
            ks.append(k_new)
            vs.append(v_new)
            k = torch.cat([k_ctx[li], k_new], dim=0)         # (C+B,H,D)
            v = torch.cat([v_ctx[li], v_new], dim=0)
            scores = torch.einsum("ihd,jhd->ihj", q, k) \
                / math.sqrt(self.head_dim)
            scores = scores.masked_fill(~valid[:, None, :], -1e30)
            w = torch.softmax(scores, dim=-1)
            att = torch.einsum("ihj,jhd->ihd", w, v)         # (B, H, D)
            h = h + att.reshape(b, self.d_model) @ lp["wo"]
            h = self._mlp(h, lp)
        logits = _row(h, length - offset - 1) @ params["out"]
        return logits, torch.stack(ks), torch.stack(vs)      # (L,B,H,D)

    def decode_chunk(self, params, tokens, k_ctx, v_ctx, lengths):
        r, s = tokens.shape
        c = k_ctx.shape[2]
        dev = tokens.device
        ii = torch.arange(s, device=dev)
        pos = lengths[:, None] + ii[None, :]                 # (R, S)
        h = params["emb"][tokens] \
            + params["pos"][torch.clamp(pos, max=self.max_seq - 1)]
        # cached context: chunk tokens attend positions < lengths
        ctx_valid = (torch.arange(c, device=dev)[None, None, :]
                     < lengths[:, None, None]).expand(r, s, c)
        # in-chunk: plain causal (the engine masks rejected tails at the KV
        # scatter, not here)
        chunk_valid = (ii[None, :] <= ii[:, None])[None].expand(r, s, s)
        valid = torch.cat([ctx_valid, chunk_valid], dim=2)
        k_news, v_news = [], []
        for li, lp in enumerate(params["layers"]):
            q = self._heads(h @ lp["wq"])                    # (R,S,H,D)
            k_new = self._heads(h @ lp["wk"])
            v_new = self._heads(h @ lp["wv"])
            k_news.append(k_new)
            v_news.append(v_new)
            k = torch.cat([k_ctx[li], k_new], dim=1)         # (R,C+S,H,D)
            v = torch.cat([v_ctx[li], v_new], dim=1)
            scores = torch.einsum("rshd,rjhd->rshj", q, k) \
                / math.sqrt(self.head_dim)
            scores = scores.masked_fill(~valid[:, :, None, :], -1e30)
            w = torch.softmax(scores, dim=-1)
            att = torch.einsum("rshj,rjhd->rshd", w, v)      # (R,S,H,D)
            h = h + att.reshape(r, s, self.d_model) @ lp["wo"]
            h = self._mlp(h, lp)
        logits = h @ params["out"]                           # (R,S,V)
        return logits, torch.stack(k_news), torch.stack(v_news)


def high_agreement_pair(vocab: int = 64, d_model: int = 32,
                        target_layers: int = 4, draft_layers: int = 1,
                        n_heads: int = 2, max_seq: int = 128,
                        seed: int = 0, device=None):
    """``(target, target_params, draft, draft_params)`` whose draft agrees
    with the target exactly (reference ``serving_decode.py:841``): both
    share the embeddings, the position table, the output head and the
    leading ``draft_layers`` layers, and the target's extra layers have
    ``wo = 0`` and ``w2 = 0``, so each is the identity and the target's
    logits are the draft's while it still pays ``target_layers /
    draft_layers`` times the compute. Acceptance is 1.0 by construction.
    The draws are :meth:`TinyCausalLM.init_params`' (the reference's): the
    draft from ``seed``, the target from ``seed + 1``, on ``device``
    (``cuda`` if None)."""
    draft = TinyCausalLM(vocab, d_model, draft_layers, n_heads,
                         max_seq=max_seq)
    target = TinyCausalLM(vocab, d_model, target_layers, n_heads,
                          max_seq=max_seq)
    dp = draft.init_params(seed, device=device)
    tp = target.init_params(seed + 1, device=device)
    tp["emb"], tp["pos"], tp["out"] = dp["emb"], dp["pos"], dp["out"]
    for i in range(draft_layers):
        tp["layers"][i] = dp["layers"][i]
    for i in range(draft_layers, target_layers):
        tp["layers"][i]["wo"] = torch.zeros_like(tp["layers"][i]["wo"])
        tp["layers"][i]["w2"] = torch.zeros_like(tp["layers"][i]["w2"])
    return target, tp, draft, dp


# ---------------------------------------------------------------------------
# threefry-2x32, as JAX computes it (jax/_src/prng.py, random.py)
# ---------------------------------------------------------------------------
_M32 = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) | (x >> (32 - r))) & _M32


def threefry_2x32(k1, k2, x1, x2):
    """The threefry-2x32 hash (20 rounds) of the count pair ``(x1, x2)``
    under the key ``(k1, k2)``: int64 tensors holding uint32 values,
    broadcast together. Returns the pair of uint32 words."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _M32
    x2 = (x2 + ks[1]) & _M32
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _M32
            x2 = _rotl(x2, r) ^ x1
        x1 = (x1 + ks[(i + 1) % 3]) & _M32
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _M32
    return x1, x2


def _u32(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, device=device).to(torch.int64) & _M32


def prng_key(seed, device=None) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)``'s key data for seeds in [0, 2**31)
    (what :class:`SamplingSpec` keeps): ``(..., 2)`` int64 words
    ``(0, seed)``."""
    s = _u32(seed, device)
    return torch.stack([torch.zeros_like(s), s], dim=-1)


def fold_in(key: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: the hash of the count pair
    ``(0, uint32(data))`` under ``key``. A Python int ``data`` stays a
    Python number (no host-to-device copy, so that it folds inside a
    capture)."""
    if isinstance(data, int):
        y1, y2 = threefry_2x32(key[..., 0], key[..., 1], 0, data & _M32)
    else:
        d = _u32(data, key.device)
        y1, y2 = threefry_2x32(key[..., 0], key[..., 1],
                               torch.zeros_like(d), d)
    return torch.stack([y1, y2], dim=-1)


def token_key(seed, position, device=None) -> torch.Tensor:
    """The key of the token at absolute sequence ``position``:
    ``fold_in(PRNGKey(seed), position)``, a pure function of (seed,
    position)."""
    return fold_in(prng_key(seed, device), position)


def random_bits(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.bits(key, (n,), uint32)`` on the partitionable path:
    ``(..., n)`` int64 words, the XOR of the hash of ``(0, i)``."""
    counts = torch.arange(n, device=key.device, dtype=torch.int64)
    b1, b2 = threefry_2x32(key[..., 0:1], key[..., 1:2],
                           torch.zeros_like(counts), counts)
    return b1 ^ b2


def _unit_floats(bits: torch.Tensor) -> torch.Tensor:
    """JAX's float32 draw on [0, 1) from uint32 words: the top 23 bits as
    the mantissa of a float in [1, 2), minus 1."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    return fbits.view(torch.float32) - 1.0


def uniform(key: torch.Tensor, n: Optional[int] = None) -> torch.Tensor:
    """``jax.random.uniform(key)`` (float32 on [0, 1)) bitwise, one draw per
    key ``(..., 2)``: shape ``(...)``, or ``(..., n)`` draws each for ``n``
    (``jax.random.uniform(key, (n,))``)."""
    bits = random_bits(key, 1 if n is None else n)
    # JAX's floats * (1 - 0) + 0, then max(0, .), which change nothing
    u = _unit_floats(bits)
    return u[..., 0] if n is None else u


_F32_TINY = float(np.finfo(np.float32).tiny)


def gumbel(key: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.gumbel(key, (n,))`` (mode "low", float32): the uniform
    draw on [tiny, 1) from the top 23 bits, then ``-log(-log(u))``."""
    floats = _unit_floats(random_bits(key, n))
    # (1 - tiny) is 1.0 in fp32, as JAX's (maxval - minval); Python
    # scalars, so that nothing is copied from the host inside a capture
    u = torch.clamp(floats * (1.0 - _F32_TINY) + _F32_TINY, min=_F32_TINY)
    return -torch.log(-torch.log(u))


# ---------------------------------------------------------------------------
# Sampling (temperature / top-k / top-p)
# ---------------------------------------------------------------------------
class SamplingSpec:
    """Per-request stochastic decoding spec. ``temperature == 0`` is greedy
    (the sampler's 0-branch is the plain argmax, bitwise); ``top_k <= 0`` /
    ``top_p >= 1`` disable their filters; ``seed`` keys the counter-based
    PRNG: the token at absolute position ``i`` draws from
    ``fold_in(PRNGKey(seed), i)``, so a preemption re-prefill replays the
    same tokens."""

    __slots__ = ("temperature", "top_k", "top_p", "seed")

    def __init__(self, temperature: float = 0.0, top_k: int = 0,
                 top_p: float = 1.0, seed: int = 0):
        t = float(temperature)
        if not (0.0 <= t < float("inf")):
            raise ValueError(f"temperature must be finite >= 0, got {t}")
        p = float(top_p)
        if not (0.0 < p <= 1.0):
            raise ValueError(f"top_p must be in (0, 1], got {p}")
        self.temperature = t
        self.top_k = int(top_k)
        self.top_p = p
        self.seed = int(seed) & 0x7FFFFFFF

    @property
    def greedy(self) -> bool:
        return self.temperature == 0.0

    def to_wire(self) -> Dict[str, Any]:
        return {"temperature": self.temperature, "top_k": self.top_k,
                "top_p": self.top_p, "seed": self.seed}

    @classmethod
    def from_wire(cls, d: Dict[str, Any]) -> "SamplingSpec":
        return cls(temperature=d.get("temperature", 0.0),
                   top_k=d.get("top_k", 0), top_p=d.get("top_p", 1.0),
                   seed=d.get("seed", 0))

    def __eq__(self, other) -> bool:
        return (isinstance(other, SamplingSpec)
                and self.to_wire() == other.to_wire())

    def __repr__(self) -> str:
        return (f"SamplingSpec(temperature={self.temperature}, "
                f"top_k={self.top_k}, top_p={self.top_p}, "
                f"seed={self.seed})")


#: the spec every greedy request decodes under
GREEDY = SamplingSpec()


def _keep_mask(scaled, top_k, top_p):
    """Keep-mask of the top-k and nucleus (top-p) filters over
    temperature-scaled logits ``scaled`` ``(..., V)``; ``top_k`` and
    ``top_p`` ``(...)``. The rank-0 token is always kept."""
    v = scaled.shape[-1]
    order = torch.argsort(-scaled, dim=-1, stable=True)
    iota = torch.arange(v, device=scaled.device).expand_as(order)
    ranks = torch.empty_like(order).scatter_(-1, order, iota)
    k_eff = torch.where(top_k <= 0, torch.full_like(top_k, v), top_k)
    keep_k = ranks < k_eff[..., None]
    # nucleus: smallest prefix of the sorted distribution whose mass
    # reaches top_p; exclusive cumsum < p keeps the boundary token
    sprobs = torch.softmax(torch.gather(scaled, -1, order), dim=-1)
    excl = torch.cumsum(sprobs, dim=-1) - sprobs
    keep_p = torch.gather(excl < top_p[..., None], -1, ranks)
    return keep_k & keep_p


def _scaled(logits, temperature, top_k, top_p):
    """``(temperature, scaled, masked)``: the temperature over the rows of
    ``logits`` ``(..., V)``, the temperature-scaled logits, and those
    masked by top-k / top-p. The sampling arguments are tensors of shape
    ``(...)`` (or scalars)."""
    dev = logits.device
    temperature = torch.as_tensor(temperature, dtype=torch.float32,
                                  device=dev).expand(logits.shape[:-1])
    top_k = torch.as_tensor(top_k, dtype=torch.int64, device=dev)
    top_p = torch.as_tensor(top_p, dtype=torch.float32, device=dev)
    scaled = logits / torch.clamp(temperature, min=1e-6)[..., None]
    keep = _keep_mask(scaled, top_k.expand(scaled.shape[:-1]),
                      top_p.expand(scaled.shape[:-1]))
    return temperature, scaled, scaled.masked_fill(~keep, float("-inf"))


def _one_hot(ids, v: int, dtype):
    return (ids[..., None] == torch.arange(v, device=ids.device)).to(dtype)


def sample_scores(logits, temperature, top_k, top_p, key):
    """``(scaled, scores)`` of the sampler: the temperature-scaled logits,
    and ``scaled`` masked by top-k / top-p plus the Gumbel noise of ``key``
    ``(..., 2)``, whose argmax is the sampled token. The sampling arguments
    are tensors of shape ``(...)`` (or scalars)."""
    _t, scaled, masked = _scaled(logits, temperature, top_k, top_p)
    return scaled, masked + gumbel(key, logits.shape[-1])


def sample_token(logits, temperature, top_k, top_p, key):
    """Sample token ids from ``logits`` ``(..., V)`` under temperature /
    top-k / top-p by Gumbel-argmax on the masked scaled logits
    (:func:`sample_scores`). Where the temperature is 0 the result is the
    plain argmax, bitwise. No host read: it runs inside the captured
    programs and in the eager oracle alike."""
    return _sample(logits, temperature, top_k, top_p, key)[0]


#: the sampler's program forms: every row greedy (no sampler at all), and
#: the full sampler
FORMS = ("greedy", "full")


def sampling_form(specs: Sequence[Optional[SamplingSpec]]) -> str:
    """The form that gives the rows of ``specs`` (None is greedy) their
    full sampler's results bitwise at the least cost: ``greedy`` when every
    row is greedy, else ``full``."""
    if all(s is None or s.greedy for s in specs):
        return "greedy"
    return "full"


def _sample(logits, temperature, top_k, top_p, key, form: str = "full",
            dist: bool = False):
    """``(tokens, dist)``: :func:`sample_token`'s tokens and, with
    ``dist``, :func:`_sample_dist`'s distribution, from one scaling and one
    keep mask. The ``greedy`` form (:data:`FORMS`) runs no sampler; it
    equals the full one bitwise on the rows it is chosen for
    (:func:`sampling_form`). ``key`` may be None under ``greedy``."""
    greedy = torch.argmax(logits, dim=-1)
    one_hot = _one_hot(greedy, logits.shape[-1], logits.dtype) \
        if dist else None
    if form == "greedy":
        return greedy.to(torch.int32), one_hot
    temperature, _s, masked = _scaled(logits, temperature, top_k, top_p)
    hot = temperature > 0.0
    sampled = torch.argmax(masked + gumbel(key, logits.shape[-1]), dim=-1)
    tokens = torch.where(hot, sampled, greedy).to(torch.int32)
    if not dist:
        return tokens, None
    return tokens, torch.where(hot[..., None],
                               torch.softmax(masked, dim=-1), one_hot)


def _sample_dist(logits, temperature, top_k, top_p, form: str = "full"):
    """The sampling distribution ``(..., V)`` a request decodes under (the
    masked, normalized one :func:`sample_token` draws from; one-hot at the
    argmax where the temperature is 0): the ``p`` and ``q`` both sides of
    speculative rejection sampling score (reference
    ``serving_decode.py:979``). The sampling arguments are tensors of shape
    ``(...)`` (or scalars)."""
    one_hot = _one_hot(torch.argmax(logits, dim=-1), logits.shape[-1],
                       logits.dtype)
    if form == "greedy":
        return one_hot
    temperature, _s, masked = _scaled(logits, temperature, top_k, top_p)
    return torch.where(temperature[..., None] > 0.0,
                       torch.softmax(masked, dim=-1), one_hot)


def _rejection_sample(logits, props, lengths, q_dist, temps, top_ks,
                      top_ps, seeds, form: str = "full"):
    """``(n_acc, next token)`` of verify's rejection sampling (see
    ``GenerativeEngine._verify_fn``) from the target's logits ``(R, k+1,
    V)``, the proposals and their distributions ``q_dist`` ``(R, k, V)``,
    and the rows' sampling arguments. Under the ``greedy`` form ``q_dist``
    is unused (None): with one-hot ``p`` and ``q`` the test accepts a
    proposal iff it is the target's argmax, and the resample at the first
    rejection (or the bonus) is the target's argmax there."""
    r, s, _v = logits.shape
    k = s - 1
    rows = torch.arange(r, device=logits.device)
    ar = torch.arange(s, device=logits.device)
    if form == "greedy":
        best = torch.argmax(logits, dim=-1)                    # (R, S)
        n_acc = torch.cumprod((best[:, :k] == props).long(),
                              dim=1).sum(dim=1)
        return n_acc, best[rows, n_acc]
    # the target's own sampling distribution at every position
    p = _sample_dist(logits, temps[:, None].expand(r, s),
                     top_ks[:, None].expand(r, s),
                     top_ps[:, None].expand(r, s), form)
    # accept d_j iff u_j q_j(d_j) < p_j(d_j) (strict, so a proposal p gives
    # no mass never survives); n_acc is the length of the accepted prefix
    jpos = lengths[:, None] + 1 + ar[None, :k]
    u = uniform(fold_in(token_key(seeds[:, None], jpos), 1))
    qd = torch.gather(q_dist, 2, props[..., None])[..., 0]
    pd = torch.gather(p[:, :k], 2, props[..., None])[..., 0]
    acc = (u * qd < pd).long()
    n_acc = torch.cumprod(acc, dim=1).sum(dim=1)
    # the residual at every candidate rejection point
    qz = torch.cat([q_dist, torch.zeros_like(q_dist[:, :1])], dim=1)
    res = torch.clamp(p - qz, min=0.0)
    tot = res.sum(dim=-1, keepdim=True)
    dist = torch.where(
        tot > 0.0, res / torch.where(tot > 0.0, tot, torch.ones_like(tot)),
        p)
    rpos = lengths[:, None] + 1 + ar[None, :]
    gum = gumbel(fold_in(token_key(seeds[:, None], rpos), 2),
                 logits.shape[-1])
    cand = torch.argmax(torch.log(dist) + gum, dim=-1)       # (R, S)
    return n_acc, cand[rows, n_acc]


def _signature(key: tuple) -> tuple:
    """A program key without its sampler form (:data:`FORMS`)."""
    return key[:-1] if key and key[-1] in FORMS else key


def _sampling_args(sampling: Optional[SamplingSpec]):
    """The four host scalars a spec rides the program signature as."""
    s = sampling or GREEDY
    return (np.float32(s.temperature), np.int32(s.top_k),
            np.float32(s.top_p), np.int32(s.seed))


def _device_of(params) -> torch.device:
    return params["emb"].device


def _param_tensors(params) -> List[torch.Tensor]:
    out = [params["emb"], params["pos"], params["out"]]
    for lp in params["layers"]:
        out += list(lp.values())
    return out


def eager_generate(model: DecodeModel, params, prompt: Sequence[int],
                   max_new_tokens: int, eos: Optional[int] = None,
                   sampling: Optional[SamplingSpec] = None) -> List[int]:
    """The one-request-at-a-time reference loop: a full forward over the
    tokens so far for every generated token (no KV cache, no batching,
    exact shapes), on the parameters' device; the parity oracle of the
    continuous batcher. ``sampling`` keys each token by
    ``fold_in(PRNGKey(seed), position)`` as the engine's programs do."""
    dev = _device_of(params)
    toks = [int(t) for t in prompt]
    out: List[int] = []
    temp, top_k, top_p, seed = _sampling_args(sampling)
    with torch.no_grad():
        for _ in range(max_new_tokens):
            logits, _k, _v = model.prefill(
                params, torch.tensor(toks, dtype=torch.long, device=dev),
                len(toks))
            if sampling is None or sampling.greedy:
                nxt = int(torch.argmax(logits))
            else:
                # the token being generated sits at absolute position
                # len(toks): the counter the engine's programs fold in
                nxt = int(sample_token(
                    logits, float(temp), int(top_k), float(top_p),
                    token_key(int(seed), len(toks), dev)))
            out.append(nxt)
            toks.append(nxt)
            if eos is not None and nxt == eos:
                break
    return out


# ---------------------------------------------------------------------------
# Requests + per-row state
# ---------------------------------------------------------------------------
class _GenRequest:
    __slots__ = ("prompt", "max_new", "eos", "out", "event", "error",
                 "t_enqueue", "t_done", "preempts", "joined", "trace_id",
                 "sampling")

    def __init__(self, prompt: List[int], max_new: int,
                 eos: Optional[int],
                 sampling: Optional[SamplingSpec] = None):
        self.prompt = prompt
        self.max_new = max_new
        self.eos = eos
        # carried like t_enqueue: a preemption re-queue replays the same
        # seed, and the position-keyed PRNG regenerates the same tokens
        self.sampling = sampling
        self.out: List[int] = []        # survives preemption
        self.event = threading.Event()
        self.error: Optional[BaseException] = None
        self.trace_id: Optional[str] = None
        # the one enqueue clock, never reset by a preemption re-queue
        self.t_enqueue = time.monotonic()
        self.t_done = 0.0
        self.preempts = 0
        # admission order, stamped at the first prefill and kept across
        # preemption re-queues (youngest-first victims)
        self.joined: Optional[int] = None


class _Row:
    __slots__ = ("req", "pages", "cached", "pending", "joined",
                 "draft_pages", "draft_cached")

    def __init__(self, req: _GenRequest, pages: List[int], cached: int,
                 pending: int, joined: int):
        self.req = req
        self.pages = pages        # page ids, in sequence order
        self.cached = cached      # tokens whose KV is in the pool
        self.pending = pending    # next token to feed the decode step
        self.joined = joined      # admission order
        # speculative decoding: the draft's own page table in the shared
        # pool (never published to the prefix cache) and how many leading
        # tokens hold valid draft KV; a rejected speculation just rewinds
        # draft_cached (stale KV past it is masked out of every attention)
        self.draft_pages: List[int] = []
        self.draft_cached = 0


class GenerativeEngine:
    """Continuous-batching decoder over one :class:`DecodeModel`.

    ``eng = GenerativeEngine(model, params, device="cpu"); toks =
    eng.generate([1, 2, 3], max_new_tokens=16)``: ``generate`` is
    thread-safe and blocking; concurrent callers share decode iterations
    (one replay per token batch). Admission sheds loudly
    (:class:`faults.ShedError`) instead of queueing toward a timeout. The
    engine runs on ``device`` (``cuda`` unless given the CPU; raises
    without CUDA), where its parameters must lie; it never moves them.
    ``draft`` (with ``draft_params``, on the same device) enables
    speculative decoding under ``MXNET_SPEC_DECODE``, ``spec_k`` (an int
    or ``"auto"``) overriding ``MXNET_SPEC_K``. See the module docstring
    for the design."""

    def __init__(self, model: DecodeModel, params=None,
                 pool: Optional[PagePool] = None,
                 name: Optional[str] = None,
                 max_rows: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 slo_us: Optional[int] = None,
                 policy: Optional[BucketPolicy] = None,
                 eos: Optional[int] = None,
                 draft: Optional[DecodeModel] = None,
                 draft_params=None,
                 spec_k: Optional[Any] = None,
                 device=None):
        self._device = resolve_device(device)
        self._model = model
        self._params = (params if params is not None
                        else model.init_params(device=self._device))
        self._check_device(self._params)
        self._pool = pool if pool is not None else shared_pool()
        self.name = name or type(model).__name__
        self._rows = int(max_rows if max_rows is not None
                         else _config.get("MXNET_SERVE_DECODE_ROWS"))
        self._max_queue = int(max_queue if max_queue is not None
                              else _config.get("MXNET_SERVE_MAX_QUEUE"))
        self._slo = (slo_us if slo_us is not None
                     else _config.get("MXNET_SERVE_SLO_US")) / 1e6
        # dispatch-gate urgency: a tighter SLO dispatches first
        self._priority = self._slo if self._slo > 0 else float("inf")
        self._policy = policy or BucketPolicy()
        self._eos = eos
        self._geom = self._pool.register(
            model.n_layers, model.n_heads, model.head_dim,
            dtype=self._params["emb"].dtype, device=self._device)
        self._max_pages = -(-int(model.max_seq) // self._pool.page)
        self._programs = _pstore.scope("serving_decode")
        self._keep = _param_tensors(self._params) + list(
            self._pool.storage(self._geom))
        # -- speculative decoding: a co-hosted draft proposes k tokens a
        # round and the target scores all k+1 in one verify dispatch
        self._draft = draft
        self._draft_params = None
        if draft is not None:
            if model.decode_chunk is None:
                raise ValueError(
                    "speculative decoding needs the TARGET model to "
                    "implement decode_chunk (the k+1-position verify "
                    "scorer)")
            if int(draft.vocab) != int(model.vocab):
                raise ValueError(
                    f"draft vocab {draft.vocab} != target vocab "
                    f"{model.vocab}: rejection sampling needs one token "
                    "space")
            self._draft_params = (draft_params if draft_params is not None
                                  else draft.init_params(
                                      device=self._device))
            self._check_device(self._draft_params)
            self._draft_geom = self._pool.register(
                draft.n_layers, draft.n_heads, draft.head_dim,
                dtype=self._draft_params["emb"].dtype, device=self._device)
            self._draft_max_pages = -(-int(draft.max_seq) // self._pool.page)
            # every speculative program keeps both models' tensors, so
            # that no call of one drops another as stale
            self._spec_keep = self._keep + _param_tensors(
                self._draft_params) + list(
                self._pool.storage(self._draft_geom))
            self._spec_host = self._spec_buffers()
        self._spec_programs = _pstore.scope("serving_spec")
        # the constructor's spec_k wins over MXNET_SPEC_K (both take 'auto')
        self._spec_k_setting = str(spec_k) if spec_k is not None else None
        # the sticky low-acceptance cutoff and the acceptance-rate EMA that
        # trips it
        self._spec_disabled = False
        self._spec_acc_ema: Optional[float] = None
        self._spec_rounds_done = 0
        # the cost table: measured seconds per prefill bucket and per
        # decode step (admission prices requests from these EMAs)
        self._cost: Dict[Any, float] = {}
        self._cv = threading.Condition()
        self._queue: "deque[_GenRequest]" = deque()
        self._live: List[_Row] = []
        self._joined = 0
        self._thread: Optional[threading.Thread] = None
        self._closed = False
        self._draining = False
        self._latencies: "deque[float]" = deque(maxlen=8192)
        self._decode_host = self._host_buffers()
        self._stats = _telemetry.CounterGroup(
            _telemetry.instance_name("decode.engine"),
            ("requests", "delivered", "tokens_out", "prefills",
             "decode_steps", "decode_row_util", "shed", "shed_queue",
             "shed_pool", "shed_slo", "shed_draining", "shed_deadline",
             "preempts", "slo_violations", "warmup_programs",
             "bucket_fallbacks", "spec_rounds", "spec_proposed",
             "spec_accepted", "spec_fallbacks"),
            doc=f"GenerativeEngine counters (model {self.name!r})",
            family="decode.engine")
        _telemetry.register_load_gauges(self, self._stats.prefix)
        _engine.register_drainable(self)

    @property
    def device(self) -> torch.device:
        return self._device

    def _check_device(self, params) -> None:
        pdev = _device_of(params)
        if pdev.type != self._device.type or (
                pdev.index is not None and self._device.index is not None
                and pdev.index != self._device.index):
            raise ValueError(
                f"GenerativeEngine on {self._device} was given parameters "
                f"on {pdev}; the engine never moves its parameters")

    def _host_buffers(self) -> List[torch.Tensor]:
        """The decode step's host-side inputs (pinned on CUDA, so their
        copies into the program's buffers are asynchronous): tokens,
        tables, lengths, temperatures, top-k, top-p, seeds."""
        r, p = self._rows, self._max_pages
        pin = self._device.type == "cuda"
        return [torch.empty(shape, dtype=dtype, pin_memory=pin)
                for shape, dtype in (
                    ((r,), torch.int64), ((r, p), torch.int64),
                    ((r,), torch.int64), ((r,), torch.float32),
                    ((r,), torch.int64), ((r,), torch.float32),
                    ((r,), torch.int64))]

    # -- public ------------------------------------------------------------
    def generate(self, prompt, max_new_tokens: int = 32,
                 eos: Optional[int] = None,
                 sampling: Optional[SamplingSpec] = None) -> List[int]:
        """Generate up to ``max_new_tokens`` token ids after ``prompt`` (a
        1-D int sequence); blocks until delivered. ``sampling`` turns on
        temperature / top-k / top-p decode inside the same programs
        (``None`` or temperature 0 is greedy). Raises
        :class:`faults.ShedError` at once when admission refuses."""
        with _telemetry.trace_scope():
            return self._generate_traced(prompt, max_new_tokens, eos,
                                         sampling)

    def _generate_traced(self, prompt, max_new_tokens: int,
                         eos: Optional[int],
                         sampling: Optional[SamplingSpec] = None
                         ) -> List[int]:
        if self._closed:
            raise RuntimeError("GenerativeEngine is closed")
        if isinstance(prompt, torch.Tensor):
            prompt = prompt.tolist()
        toks = [int(t) for t in np.asarray(prompt).ravel()]
        if not toks:
            raise ValueError("generate() needs a non-empty prompt")
        if max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if len(toks) + max_new_tokens > self._model.max_seq:
            raise ValueError(
                f"prompt({len(toks)}) + max_new({max_new_tokens}) "
                f"exceeds model.max_seq={self._model.max_seq}")
        eos = eos if eos is not None else self._eos
        if sampling is not None and not isinstance(sampling,
                                                   SamplingSpec):
            raise TypeError(
                f"sampling must be a SamplingSpec, got {sampling!r}")
        req = _GenRequest(toks, int(max_new_tokens), eos,
                          sampling=sampling)
        req.trace_id = _telemetry.current_trace()
        self._stats.inc("requests")
        if req.trace_id is not None:
            _telemetry.event("admit", self.name, tokens=len(toks),
                             max_new=int(max_new_tokens))
        rem_us = _faults.deadline_remaining_us()
        until = (time.monotonic() + rem_us / 1e6
                 if rem_us is not None else None)
        self._admit(req)                 # may raise ShedError, fail-fast
        with self._cv:
            self._start_thread()
            self._queue.append(req)
            self._cv.notify_all()
        if until is None:
            delivered = req.event.wait(timeout=600.0)
        else:
            delivered = req.event.wait(
                timeout=max(0.0, until - time.monotonic()))
        if not delivered:
            if until is not None:
                with self._cv:
                    try:
                        self._queue.remove(req)
                    except ValueError:
                        pass
                self._shed("deadline",
                           f"deadline budget exhausted after "
                           f"{(time.monotonic() - req.t_enqueue) * 1e6:.0f}"
                           "us (admission + queue + decode)")
            raise _faults.DeadlineExceeded(
                "generation not delivered within 600s (scheduler "
                "wedged?)")
        if req.error is not None:
            raise req.error
        self._latencies.append(req.t_done - req.t_enqueue)
        if self._slo > 0 and req.t_done - req.t_enqueue > self._slo:
            self._stats.inc("slo_violations")
        if req.trace_id is not None:
            _telemetry.event("retire", self.name,
                             tokens_out=len(req.out),
                             preempts=req.preempts)
        _telemetry.record_span(
            "decode.request", "serving",
            int(req.t_enqueue * 1e9), int(req.t_done * 1e9),
            args={"model": self.name, "tokens_out": len(req.out),
                  "preempts": req.preempts})
        return list(req.out)

    def spans(self, limit: Optional[int] = None) -> List[Dict[str, Any]]:
        """Recent decode-path spans (prefill dispatches and decode
        iterations, cat ``decode``)."""
        return _telemetry.spans(cat="decode", limit=limit)

    def load(self) -> Dict[str, float]:
        """Live load signals: queue depth, live-row occupancy, page-pool
        pressure. No device reads."""
        with self._cv:
            depth = len(self._queue)
            live = len(self._live)
        return {
            "queue_depth": depth + 0.0,
            "in_flight": live / max(self._rows, 1),
            "pool_pressure": 1.0 - (self._pool.free_pages()
                                    / max(self._pool.pages, 1)),
        }

    def stats(self) -> Dict[str, Any]:
        """Per-model counters and request-latency percentiles."""
        out = dict(self._stats)
        out["model"] = self.name
        # a signature's sampler forms count as one program
        out["programs"] = len({_signature(k) for k in self._programs})
        out["spec_programs"] = len({_signature(k)
                                    for k in self._spec_programs})
        out["program_forms"] = len(self._programs) + len(
            self._spec_programs)
        out["spec_disabled"] = self._spec_disabled
        out["queue_depth"] = len(self._queue)
        out["live_rows"] = len(self._live)
        out["rows"] = self._rows
        out["pool"] = self._pool.stats()
        if out["decode_steps"]:
            out["rows_per_decode"] = (out["decode_row_util"]
                                      / out["decode_steps"])
        lat = sorted(self._latencies)
        if lat:
            out["p50_us"] = lat[len(lat) // 2] * 1e6
            out["p99_us"] = lat[min(len(lat) - 1,
                                    int(len(lat) * 0.99))] * 1e6
        else:
            out["p50_us"] = out["p99_us"] = 0.0
        return out

    def drain(self, timeout: float = 120.0) -> None:
        """``engine.waitall()`` hook: block until every admitted request
        has been delivered (queue empty, no live rows)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._cv:
                if not self._queue and not self._live:
                    return
            time.sleep(0.002)

    def begin_drain(self) -> None:
        """Drain this one engine: new admissions and the queued backlog
        shed typed ``draining``, live rows decode to completion."""
        with self._cv:
            self._draining = True
            self._cv.notify_all()

    def pool_audit(self) -> List[str]:
        """``PagePool.audit()``: [] when every page is free, cached, or
        referenced consistently."""
        return list(self._pool.audit())

    def pool_in_use(self) -> int:
        """Referenced pages right now (0 after a drain = no leak)."""
        return int(self._pool.in_use())

    def close(self) -> None:
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
            self._thread = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- admission (site serving.admit) -------------------------------------
    def _estimate_s(self, req: _GenRequest) -> float:
        """Cost-table price of one request: its prefill bucket's EMA plus
        max_new decode-step EMAs; unknown entries price 0."""
        b = self._policy.bucket(len(req.prompt))
        pre = self._cost.get(("prefill", b), 0.0)
        dec = self._cost.get("decode", 0.0)
        return pre + req.max_new * dec

    def _shed(self, kind: str, reason: str,
              cause: Optional[BaseException] = None):
        self._stats.inc("shed")
        self._stats.inc("shed_" + kind)
        _telemetry.event("shed", self.name, shed_kind=kind, reason=reason)
        _faults.record_event("serving.admit", "shed", cause,
                             model=self.name, kind=kind, reason=reason)
        err = ShedError(f"[{self.name}] {reason}", kind=kind)
        if cause is not None:
            raise err from cause
        raise err

    def _admit(self, req: _GenRequest) -> None:
        """Fail-fast admission in the caller's thread: the
        ``serving.admit`` site and the draining / deadline / queue / pool /
        SLO checks, each refusal an immediate typed ShedError."""
        if _preemption.draining() or self._draining:
            self._shed("draining",
                       "engine draining (preemption notice or replica "
                       "drain); re-queue this request on another "
                       "replica or after the restart")
        try:
            _faults.inject("serving.admit")
        except _faults.FaultInjected as e:
            self._shed("queue", "admission fault injected", cause=e)
        rem_us = _faults.deadline_remaining_us()
        if rem_us is not None:
            est = self._estimate_s(req)
            if rem_us <= 0:
                self._shed("deadline",
                           "deadline budget already spent at admission")
            if est > rem_us / 1e6:
                self._shed("deadline",
                           f"cost table predicts {est * 1e6:.0f}us vs "
                           f"{rem_us}us remaining in the deadline budget")
        with self._cv:
            qlen = len(self._queue)
        if qlen >= self._max_queue:
            self._shed("queue",
                       f"admission queue full ({qlen} >= "
                       f"MXNET_SERVE_MAX_QUEUE={self._max_queue})")
        need = -(-(len(req.prompt) + req.max_new) // self._pool.page)
        if need > self._pool.pages:
            self._shed("pool",
                       f"request needs {need} KV pages, pool holds "
                       f"{self._pool.pages} total — can never fit")
        if self._slo > 0:
            est = (qlen + 1) * self._estimate_s(req)
            if est > self._slo:
                self._shed("slo",
                           f"cost table predicts {est*1e6:.0f}us wait "
                           f"vs SLO {self._slo*1e6:.0f}us "
                           f"({qlen} queued ahead)")

    # -- scheduler ----------------------------------------------------------
    def _start_thread(self) -> None:
        if self._thread is None and not self._closed:
            self._thread = threading.Thread(
                target=self._sched_loop, daemon=True,
                name=f"mxnet-decode-{self.name}")
            self._thread.start()

    def _sched_loop(self) -> None:
        while True:
            with self._cv:
                while (not self._queue and not self._live
                       and not self._closed):
                    self._cv.wait(timeout=0.1)
                if self._closed and not self._queue and not self._live:
                    return
            try:
                self._iteration()
            except BaseException as e:      # deliver, never wedge
                self._fail_all(e)

    def _fail_all(self, e: BaseException) -> None:
        with self._cv:
            rows, self._live = self._live, []
            reqs = list(self._queue)
            self._queue.clear()
        for row in rows:
            self._release(row)
            self._finish(row.req, e)
        for req in reqs:
            self._finish(req, e)

    @staticmethod
    def _finish(req: _GenRequest, error: Optional[BaseException]) -> None:
        req.error = error
        req.t_done = time.monotonic()
        req.event.set()

    def _requeue_for_drain(self) -> None:
        """Drain handback: queued, not-yet-prefilled requests return to
        their callers as typed ``draining`` sheds, while live rows keep
        decoding to completion."""
        with self._cv:
            reqs, self._queue = list(self._queue), deque()
        for req in reqs:
            self._stats.inc("shed")
            self._stats.inc("shed_draining")
            with _telemetry.trace_scope(trace_id=req.trace_id):
                _telemetry.event(
                    "shed", self.name, shed_kind="draining",
                    reason="queued request re-queued at drain")
                _faults.record_event(
                    "serving.admit", "shed", model=self.name,
                    kind="draining",
                    reason="queued request re-queued at drain",
                    tokens_done=len(req.out))
            self._finish(req, ShedError(
                f"[{self.name}] draining after a preemption notice "
                "before this request was scheduled; re-queue it after the "
                f"restart (its {len(req.out)} partial token(s) regenerate "
                "token-exactly)", kind="draining"))

    def _iteration(self) -> None:
        """One scheduler iteration: admit prefills into free rows, run one
        decode step over the live sequences, retire."""
        if _preemption.draining() or self._draining:
            self._requeue_for_drain()
        while len(self._live) < self._rows:
            with self._cv:
                if not self._queue:
                    break
                req = self._queue.popleft()
            try:
                self._prefill(req)
                continue
            except PagePoolExhausted:
                with self._cv:
                    self._queue.appendleft(req)   # head-of-line: retry
                if not self._live:
                    # nothing of ours will retire: wait briefly for other
                    # engines, then shed loudly
                    if self._wait_for_pages(req):
                        continue
                    with self._cv:
                        self._queue.remove(req)
                    self._stats.inc("shed")
                    self._stats.inc("shed_pool")
                    with _telemetry.trace_scope(trace_id=req.trace_id):
                        _telemetry.event(
                            "shed", self.name, shed_kind="pool",
                            reason="pool exhausted at prefill")
                        _faults.record_event(
                            "serving.admit", "shed", model=self.name,
                            kind="pool",
                            reason="pool exhausted at prefill")
                    self._finish(req, ShedError(
                        f"[{self.name}] KV page pool exhausted at "
                        "prefill and no progress upstream", kind="pool"))
                break
            except BaseException as e:
                # a bad request fails only its own caller
                self._finish(req, e)
        # one decode dispatch for the live sequences, or, when the cost
        # table says speculation pays, one draft and one verify dispatch
        # for up to k+1 tokens a row
        if self._live:
            k = self._spec_should_engage()
            if not (k and self._spec_round(k)):
                self._decode_step()
            self._retire_finished()

    def _wait_for_pages(self, req: _GenRequest, budget: float = 5.0
                        ) -> bool:
        need = -(-len(req.prompt) // self._pool.page) or 1
        deadline = time.monotonic() + budget
        while time.monotonic() < deadline:
            if self._pool.free_pages() >= need:
                return True
            if self._closed:
                return False
            time.sleep(0.005)
        return False

    # -- prefill ------------------------------------------------------------
    def _prefill(self, req: _GenRequest) -> None:
        """The prompt program of the request's bucket: writes its KV into
        fresh pages (scatter inside the program) and emits the first
        generated token. Runs on the scheduler thread inside the request's
        trace."""
        with _telemetry.trace_scope(trace_id=req.trace_id):
            self._prefill_traced(req)

    def _prefix_on(self) -> bool:
        return bool(_config.get("MXNET_PREFIX_CACHE"))

    def _prefix_min_blocks(self) -> int:
        """Cost-table floor for content addressing: the per-block probe
        cost must undercut the per-block prefill a hit saves; an
        unmeasured table prices the floor at 1."""
        probe = self._cost.get(("prefix", "probe"), 0.0)
        saved = self._cost.get(("prefix", "block"), 0.0)
        if probe <= 0.0 or saved <= 0.0:
            return 1
        return max(1, int(math.ceil(probe / saved)))

    def _prefix_lookup(self, prompt: List[int]
                       ) -> Tuple[List[bytes], List[int]]:
        """Hash the prompt's block chain and acquire the longest cached
        prefix: ``(keys, hit_pages)``, both empty when the knob is off or
        the prompt is under the cost-table floor."""
        if not self._prefix_on():
            return [], []
        t0 = time.perf_counter()
        keys = _chain_keys(prompt, self._pool.page, self._geom)
        if len(keys) < self._prefix_min_blocks():
            return [], []
        hits = self._pool.lookup(self._geom, keys)
        self._ema(("prefix", "probe"),
                  (time.perf_counter() - t0) / len(keys))
        return keys, hits

    def prefix_probe(self, prompt: Sequence[int]) -> int:
        """How many leading page blocks of ``prompt`` are resident in this
        engine's pool; 0 when the cache is off."""
        if not self._prefix_on():
            return 0
        toks = [int(t) for t in prompt]
        return self._pool.holds(
            self._geom, _chain_keys(toks, self._pool.page, self._geom))

    def _join(self, req: _GenRequest) -> int:
        if req.joined is None:           # first admission only: a
            req.joined = self._joined    # preemption re-queue keeps its
            self._joined += 1            # original seniority
        return req.joined

    def _add_row(self, row: _Row) -> None:
        if self._done(row):
            self._deliver(row)
        else:
            self._live.append(row)

    def _prefill_traced(self, req: _GenRequest) -> None:
        prompt = req.prompt + req.out     # re-grown after preemption
        n = len(prompt)
        page = self._pool.page
        keys, hits = self._prefix_lookup(prompt)
        blocks = len(keys)
        if hits and min(len(hits) * page, n) >= n:
            # full hit: no prefill dispatch; rewind one position so the
            # decode step recomputes the last prompt token's logits (its
            # write lands in a shared page, which _ensure_page forks)
            _telemetry.event("prefix_hit", self.name,
                             hit_blocks=blocks, blocks=blocks,
                             hit_rate=1.0, tokens=n)
            self._add_row(_Row(req, hits, cached=n - 1, pending=prompt[-1],
                               joined=self._join(req)))
            return
        if hits and self._model.prefill_chunk is None:
            self._pool.free(hits)
            hits = []
        cached = len(hits) * page   # page-aligned: a partial-tail hit is a
        m = n - cached              # full hit
        bucket = self._policy.bucket(m)
        if bucket is None:                # above the largest bucket
            self._stats.inc("bucket_fallbacks")
            bucket = m
        bucket = min(bucket, int(self._model.max_seq))
        try:
            fresh = self._pool.alloc(-(-n // page) - len(hits))
        except BaseException:
            if hits:
                self._pool.free(hits)    # lookup references never leak
            raise
        pages = hits + fresh
        try:
            tokens = np.zeros((bucket,), np.int64)
            tokens[:m] = prompt[cached:]
            table = np.full((self._max_pages,), self._pool.trash, np.int64)
            table[:len(pages)] = pages
            span_args: Dict[str, Any] = {"model": self.name,
                                         "bucket": bucket, "tokens": n}
            if keys:
                span_args.update(
                    hit_blocks=len(hits), blocks=blocks,
                    hit_rate=len(hits) / max(blocks, 1))
            samp = [torch.tensor(a) for a in _sampling_args(req.sampling)]
            t0 = time.perf_counter()
            with _telemetry.span("decode.prefill", cat="decode",
                                 args=span_args):
                self._pool.gate.acquire(self._priority)
                try:
                    with self._pool.exclusive(self._geom):
                        if hits:
                            # suffix-only dispatch: the cached prefix
                            # rides in through the page-table gather
                            first = self._call(
                                ("prefill_chunk", bucket),
                                lambda: self._chunk_fn(bucket),
                                [torch.from_numpy(tokens),
                                 torch.tensor(cached), torch.tensor(n),
                                 torch.from_numpy(table), *samp])
                        else:
                            first = self._call(
                                ("prefill", bucket),
                                lambda: self._prefill_fn(bucket),
                                [torch.from_numpy(tokens), torch.tensor(n),
                                 torch.from_numpy(table), *samp])
                        first = int(first)    # host read = real cost
                finally:
                    self._pool.gate.release()
            secs = time.perf_counter() - t0
            self._ema(("prefill", bucket), secs)
            self._ema(("prefix", "block"), secs * page / max(m, 1))
            self._stats.inc("prefills")
            if keys:
                self._pool.publish(
                    self._geom, [(keys[i], pages[i])
                                 for i in range(len(hits), blocks)])
        except BaseException:
            self._pool.free(pages)
            raise
        req.out.append(first)
        self._add_row(_Row(req, pages, cached=n, pending=first,
                           joined=self._join(req)))

    def _call(self, key, build, args):
        """The program of ``key`` on ``args``: a replay, or on a miss a new
        program captured at this first call (kept once that succeeded)."""
        return _pstore.run(self._programs, key, build, args,
                           device=self._device, keep=self._keep)

    def _scatter(self, pidx, slot, k, v, geom=None) -> None:
        """Write per-position K/V rows ``(L, ..., H, D)`` at (page, slot)
        ``(...)`` of the pool storage of ``geom`` (the target's if None), in
        place."""
        k_pool, v_pool = self._pool.storage(geom or self._geom)
        k_pool[pidx, slot] = k.movedim(0, -3)
        v_pool[pidx, slot] = v.movedim(0, -3)

    def _prefill_fn(self, bucket: int):
        model, params = self._model, self._params
        page, trash = self._pool.page, self._pool.trash

        def prefill_fn(tokens, length, table, temp, top_k, top_p, seed):
            with torch.no_grad():
                logits, k, v = model.prefill(params, tokens, length)
                pos = torch.arange(bucket, device=tokens.device)
                pidx = torch.where(pos < length, table[pos // page],
                                   torch.full_like(pos, trash))
                self._scatter(pidx, pos % page, k, v)
                # the first generated token sits at absolute position
                # ``length``: its counter-based key
                return sample_token(logits, temp, top_k, top_p,
                                    token_key(seed, length))

        return prefill_fn

    def _gather_ctx(self, table, geom=None, model=None):
        """The page-table gather: ``(..., P)`` page ids -> K and V context
        ``(L, ..., P*page, H, D)`` of ``model`` from ``geom``'s storage
        (the target's if None)."""
        model, page = model or self._model, self._pool.page
        k_pool, v_pool = self._pool.storage(geom or self._geom)
        lead = table.shape[:-1]
        c = table.shape[-1] * page
        nd = len(lead)
        perm = (nd + 1,) + tuple(range(nd + 1)) + (nd + 2, nd + 3)
        out = []
        for pool_t in (k_pool, v_pool):
            ctx = pool_t[table].reshape(lead + (c, model.n_layers,
                                                model.n_heads,
                                                model.head_dim))
            out.append(ctx.permute(perm))
        return out

    def _chunk_fn(self, bucket: int):
        model, params = self._model, self._params
        page, trash = self._pool.page, self._pool.trash
        max_pages = self._max_pages

        def prefill_chunk_fn(tokens, offset, length, table, temp, top_k,
                             top_p, seed):
            with torch.no_grad():
                k_ctx, v_ctx = self._gather_ctx(table)      # (L, C, H, D)
                logits, k, v = model.prefill_chunk(
                    params, tokens, k_ctx, v_ctx, offset, length)
                pos = offset + torch.arange(bucket, device=tokens.device)
                # bucket padding can point past the table: clamp, then
                # mask to the trash page
                pidx = torch.where(
                    pos < length,
                    table[torch.clamp(pos // page, max=max_pages - 1)],
                    torch.full_like(pos, trash))
                self._scatter(pidx, pos % page, k, v)
                return sample_token(logits, temp, top_k, top_p,
                                    token_key(seed, length))

        return prefill_chunk_fn

    def _decode_fn(self, form: str = "full"):
        """The decode program; ``form`` (:data:`FORMS`) is the sampler's,
        chosen from the live rows' specs at each step."""
        model, params, page = self._model, self._params, self._pool.page

        def decode_fn(tokens, tables, lengths, temps, top_ks, top_ps,
                      seeds):
            with torch.no_grad():
                k_ctx, v_ctx = self._gather_ctx(tables)   # (L, R, C, H, D)
                logits, k_new, v_new = model.decode(
                    params, tokens, k_ctx, v_ctx, lengths)
                # the new token's KV at (page of position len, slot); dead
                # rows have trash tables and length 0
                rows = torch.arange(tokens.shape[0], device=tokens.device)
                self._scatter(tables[rows, lengths // page], lengths % page,
                              k_new, v_new)
                # the sampled token lands at absolute position lengths+1
                keys = (None if form == "greedy"
                        else token_key(seeds, lengths + 1))
                return _sample(logits, temps, top_ks, top_ps, keys,
                               form)[0]

        return decode_fn

    @staticmethod
    def _scalars(*dtypes):
        return [torch.zeros((), dtype=d) for d in dtypes]

    def _sampling_example(self):
        return self._scalars(torch.float32, torch.int64, torch.float32,
                             torch.int64)

    def _prefill_example(self, bucket: int):
        table = torch.full((self._max_pages,), self._pool.trash,
                           dtype=torch.int64)
        return [torch.zeros((bucket,), dtype=torch.int64),
                torch.tensor(bucket), table, *self._sampling_example()]

    def _decode_example(self):
        r, p = self._rows, self._max_pages
        return [torch.zeros((r,), dtype=torch.int64),
                torch.full((r, p), self._pool.trash, dtype=torch.int64),
                torch.zeros((r,), dtype=torch.int64),
                torch.zeros((r,), dtype=torch.float32),
                torch.zeros((r,), dtype=torch.int64),
                torch.ones((r,), dtype=torch.float32),
                torch.zeros((r,), dtype=torch.int64)]

    # -- decode -------------------------------------------------------------
    def _decode_step(self) -> None:
        """One replay for every live sequence (gather, attend, sample,
        scatter inside the one program; dead rows masked into the trash
        page), then the iteration's one host read of the next tokens."""
        for row in list(self._live):
            # a preemption inside an earlier row's _ensure_page may have
            # evicted this row: allocating onto it would orphan the page
            if row in self._live:
                self._ensure_page(row)
        if not self._live:
            return
        bufs = self._decode_host
        tokens, tables, lengths, temps, top_ks, top_ps, seeds = \
            [b.numpy() for b in bufs]
        tokens[:] = 0
        tables[:] = self._pool.trash
        lengths[:] = 0
        temps[:] = 0.0
        top_ks[:] = 0
        top_ps[:] = 1.0
        seeds[:] = 0
        for i, row in enumerate(self._live):
            tokens[i] = row.pending
            tables[i, :len(row.pages)] = row.pages
            lengths[i] = row.cached
            (temps[i], top_ks[i], top_ps[i],
             seeds[i]) = _sampling_args(row.req.sampling)
        t0 = time.perf_counter()
        step_args: Dict[str, Any] = {"model": self.name,
                                     "rows": len(self._live)}
        traces = [row.req.trace_id for row in self._live
                  if row.req.trace_id is not None]
        if traces:
            step_args["trace_ids"] = traces
        form = sampling_form([row.req.sampling for row in self._live])
        with _telemetry.span("decode.step", cat="decode",
                             args=step_args):
            self._pool.gate.acquire(self._priority)
            try:
                with self._pool.exclusive(self._geom):
                    nxt = self._call(("decode", form),
                                     lambda: self._decode_fn(form), bufs)
                    # THE one host read per decode iteration
                    nxt = nxt.tolist()
            finally:
                self._pool.gate.release()
        self._ema("decode", time.perf_counter() - t0)
        self._stats.inc("decode_steps")
        self._stats.inc("decode_row_util", len(self._live))
        for i, row in enumerate(self._live):
            row.cached += 1               # pending's KV is now paged
            row.pending = int(nxt[i])
            row.req.out.append(row.pending)
        self._stats.inc("tokens_out", len(self._live))

    def _ensure_page(self, row: _Row) -> None:
        """The incoming token writes KV at position ``row.cached``:
        allocate its page if that position opens one, fork it first when
        it is shared or published. Exhaustion preempts the youngest other
        live sequence (pages freed, request re-queued at the head)."""
        if row.cached < len(row.pages) * self._pool.page:
            i = row.cached // self._pool.page
            if not self._pool.shared(row.pages[i]):
                return

            def grow() -> None:
                row.pages[i] = self._pool.fork(self._geom, row.pages[i])
        else:

            def grow() -> None:
                row.pages.extend(self._pool.alloc(1))
        while True:
            try:
                grow()
                return
            except PagePoolExhausted as e:
                victims = [x for x in self._live if x is not row]
                if not victims:
                    # this sequence alone outgrew the pool: a loud typed
                    # failure, never a silent truncation
                    self._live.remove(row)
                    self._release(row)
                    self._stats.inc("shed")
                    self._stats.inc("shed_pool")
                    with _telemetry.trace_scope(
                            trace_id=row.req.trace_id):
                        _telemetry.event(
                            "shed", self.name, shed_kind="pool",
                            reason="single sequence outgrew pool")
                        _faults.record_event(
                            "serving.admit", "shed", e, model=self.name,
                            kind="pool",
                            reason="single sequence outgrew pool")
                    self._finish(row.req, ShedError(
                        f"[{self.name}] sequence needs page "
                        f"{len(row.pages) + 1}, pool exhausted with no "
                        "other sequence to preempt", kind="pool"))
                    return
                self._preempt(max(victims, key=lambda x: x.joined))

    def _preempt(self, row: _Row) -> None:
        self._live.remove(row)
        self._release(row)
        row.req.preempts += 1
        self._stats.inc("preempts")
        with _telemetry.trace_scope(trace_id=row.req.trace_id):
            _telemetry.event("preempt", self.name,
                             tokens_done=len(row.req.out))
            _faults.record_event("serving.admit", "preempt",
                                 model=self.name,
                                 tokens_done=len(row.req.out))
        with self._cv:
            self._queue.appendleft(row.req)

    # -- speculative decoding (MXNET_SPEC_DECODE) ----------------------------
    #: draft depth ceiling under MXNET_SPEC_K=auto: the draft-round program
    #: is captured once at this k and verify consumes the first k of its
    #: proposals, so auto-k never re-captures the draft
    _SPEC_AUTO_KMAX = 4

    def _spec_setting(self) -> str:
        return (self._spec_k_setting if self._spec_k_setting is not None
                else str(_config.get("MXNET_SPEC_K")))

    def _spec_kmax(self) -> int:
        s = self._spec_setting()
        if s == "auto":
            return self._SPEC_AUTO_KMAX
        if not _config.VARIABLES["MXNET_SPEC_K"].validator(s):
            raise ValueError(f"spec_k must be 'auto' or an int >= 1, got "
                             f"{s!r}")
        return int(s)

    def _spec_should_engage(self) -> int:
        """Per-round arbitration: the k to draft this round, or 0 for a
        plain decode step. Speculation engages only when the cost table
        says a round pays for itself, ``(E_acc + 1) * t_target > t_draft +
        t_verify``, over measured EMAs; unmeasured entries engage, so the
        table only ever turns speculation off once it has numbers."""
        if (self._draft is None or not _config.get("MXNET_SPEC_DECODE")
                or self._spec_disabled):
            return 0
        kmax = self._spec_kmax()
        k = self._spec_auto_k() if self._spec_setting() == "auto" else kmax
        # every live row must fit the draft's kmax-deep proposal run and
        # the k+1-position verify chunk inside max_seq
        for row in self._live:
            if row.cached + kmax + 1 > int(self._model.max_seq) - 1:
                self._spec_fallback()
                return 0
        t_t = self._cost.get("decode")
        t_d = self._cost.get(("spec", "draft"))
        t_v = self._cost.get(("spec_verify", k))
        if t_t is not None and t_d is not None and t_v is not None:
            # an unmeasured acceptance prices as k (optimistic bootstrap)
            e_acc = self._cost.get(("spec", "acc"), float(k))
            if (e_acc + 1.0) * t_t <= t_d + t_v:
                self._spec_fallback()
                return 0
        return k

    def _spec_auto_k(self) -> int:
        """``MXNET_SPEC_K=auto``: the verify depth k that maximizes the
        expected tokens per second, ``E_tok(k) = (1 - beta^(k+1)) / (1 -
        beta)`` over the acceptance-rate EMA ``beta``, priced at ``t_draft
        + t_verify(k)``. An unmeasured k is tried first (smallest first)."""
        t_d = self._cost.get(("spec", "draft"))
        beta = self._spec_acc_ema
        if t_d is None or beta is None:
            return self._SPEC_AUTO_KMAX
        beta = min(max(beta, 0.0), 0.999)
        best_k, best = self._SPEC_AUTO_KMAX, -1.0
        for k in range(1, self._SPEC_AUTO_KMAX + 1):
            t_v = self._cost.get(("spec_verify", k))
            if t_v is None:
                return k
            e_tok = (1.0 - beta ** (k + 1)) / max(1.0 - beta, 1e-6)
            score = e_tok / max(t_d + t_v, 1e-12)
            if score > best:
                best, best_k = score, k
        return best_k

    def _spec_fallback(self) -> None:
        _SPEC_STATS.inc("fallback_rounds")
        self._stats.inc("spec_fallbacks")

    def _spec_autodisable(self, reason: str, **fields) -> None:
        """Sticky degrade to plain decode, for this engine's lifetime, once
        the measured acceptance collapses: plain decode is always correct,
        so this costs throughput only."""
        if self._spec_disabled:
            return
        self._spec_disabled = True
        _SPEC_STATS.inc("autodisabled")
        _telemetry.event("spec.autodisabled", self.name, reason=reason,
                         **fields)
        _faults.record_event("serving.spec", "autodisabled",
                             model=self.name, reason=reason)

    def _ensure_spec_pages(self, row: _Row, last_pos: int) -> bool:
        """Grow the target's page table to cover verify's writes through
        ``last_pos``, forking a shared or published page on the way; never
        preempts: on exhaustion the round is skipped and plain decode
        proceeds under the ordinary preemption rules."""
        page = self._pool.page
        try:
            for i in range(row.cached // page, last_pos // page + 1):
                if i < len(row.pages):
                    if self._pool.shared(row.pages[i]):
                        row.pages[i] = self._pool.fork(self._geom,
                                                       row.pages[i])
                else:
                    row.pages.extend(self._pool.alloc(1))
            return True
        except PagePoolExhausted:
            return False

    def _ensure_draft_ready(self, row: _Row, kmax: int) -> bool:
        """Draft pages covering this round's writes (positions ``cached ..
        cached + kmax - 1``), and a draft prefill where the draft lags the
        target by more than the round's catch-up step absorbs (the row's
        first round, or rounds decoded plainly meanwhile)."""
        page = self._pool.page
        c = row.cached
        try:
            while len(row.draft_pages) * page <= c + kmax - 1:
                row.draft_pages.extend(self._pool.alloc(1))
        except PagePoolExhausted:
            return False
        if c - row.draft_cached > 1 and c > 0:
            self._draft_prefill(row)
        return True

    def _spec_call(self, key, build, args):
        """The speculative program of ``key`` on ``args`` (``_call`` in the
        ``serving_spec`` scope)."""
        return _pstore.run(self._spec_programs, key, build, args,
                           device=self._device, keep=self._spec_keep)

    def _draft_prefill(self, row: _Row) -> None:
        """One draft-prefill dispatch at the bucket of the row's committed
        prefix: writes the draft's KV for it, so that the round can start
        proposing from ``pending``."""
        c = row.cached
        seq = (row.req.prompt + row.req.out)[:c]
        bucket = self._policy.bucket(c)
        if bucket is None:
            bucket = c
        bucket = min(bucket, int(self._draft.max_seq))
        tokens = np.zeros((bucket,), np.int64)
        tokens[:c] = seq
        table = np.full((self._draft_max_pages,), self._pool.trash, np.int64)
        table[:len(row.draft_pages)] = row.draft_pages
        t0 = time.perf_counter()
        with _telemetry.span("decode.spec_draft_prefill", cat="decode",
                             args={"model": self.name, "bucket": bucket,
                                   "tokens": c}):
            self._pool.gate.acquire(self._priority)
            try:
                with self._pool.exclusive(self._draft_geom):
                    self._spec_call(
                        ("draft_prefill", bucket),
                        lambda: self._draft_prefill_fn(bucket),
                        [torch.from_numpy(tokens), torch.tensor(c),
                         torch.from_numpy(table)])
            finally:
                self._pool.gate.release()
        self._ema(("spec", "draft_prefill"), time.perf_counter() - t0)
        row.draft_cached = c

    def _spec_buffers(self) -> Dict[str, torch.Tensor]:
        """The round's host-side inputs (pinned on CUDA): the draft round's
        catch-up token, its switch and the pending tokens, the draft and
        target page tables and lengths, and the sampling arguments."""
        r = self._rows
        pin = self._device.type == "cuda"
        shapes = {"catch": ((r,), torch.int64),
                  "catch_on": ((r,), torch.bool),
                  "pending": ((r,), torch.int64),
                  "dtables": ((r, self._draft_max_pages), torch.int64),
                  "dlengths": ((r,), torch.int64),
                  "tables": ((r, self._max_pages), torch.int64),
                  "lengths": ((r,), torch.int64),
                  "temps": ((r,), torch.float32),
                  "top_ks": ((r,), torch.int64),
                  "top_ps": ((r,), torch.float32),
                  "seeds": ((r,), torch.int64)}
        return {k: torch.empty(shape, dtype=dtype, pin_memory=pin)
                for k, (shape, dtype) in shapes.items()}

    def _spec_round(self, k: int) -> bool:
        """One speculative round over the live rows: one draft-round
        dispatch (kmax proposals a row) and one verify dispatch (k+1
        target positions a row), then the host commit of each row's
        accepted prefix and its resampled or bonus token. False when the
        pages did not fit: the caller runs a plain decode step
        (speculation is opportunistic). A failing dispatch or capture
        raises, to the round's requests (the reference instead turns
        speculation off and decodes plainly, which would hide a fault of
        the programs behind a slower stream)."""
        kmax = self._spec_kmax()
        live = list(self._live)
        for row in live:
            if (not self._ensure_spec_pages(row, row.cached + k)
                    or not self._ensure_draft_ready(row, kmax)):
                self._spec_fallback()
                return False
        h = {name: b.numpy() for name, b in self._spec_host.items()}
        trash = self._pool.trash
        h["catch"][:] = 0
        h["catch_on"][:] = False
        h["pending"][:] = 0
        h["dtables"][:] = trash
        h["dlengths"][:] = 0
        h["tables"][:] = trash
        h["lengths"][:] = 0
        h["temps"][:] = 0.0
        h["top_ks"][:] = 0
        h["top_ps"][:] = 1.0
        h["seeds"][:] = 0
        for i, row in enumerate(live):
            h["pending"][i] = row.pending
            d = row.draft_cached
            if row.cached - d == 1:
                # a lag of 1 iff the last round accepted every proposal:
                # its last proposal is committed but its KV never drafted
                h["catch_on"][i] = True
                h["catch"][i] = (row.req.prompt + row.req.out)[d]
            h["dtables"][i, :len(row.draft_pages)] = row.draft_pages
            h["dlengths"][i] = d
            h["tables"][i, :len(row.pages)] = row.pages
            h["lengths"][i] = row.cached
            (h["temps"][i], h["top_ks"][i], h["top_ps"][i],
             h["seeds"][i]) = _sampling_args(row.req.sampling)
        b = self._spec_host
        form = sampling_form([row.req.sampling for row in live])
        samp = ([] if form == "greedy"
                else [b["temps"], b["top_ks"], b["top_ps"], b["seeds"]])
        dargs = [b["catch"], b["catch_on"], b["pending"], b["dtables"],
                 b["dlengths"], *samp]
        step_args: Dict[str, Any] = {"model": self.name, "rows": len(live),
                                     "k": k}
        traces = [row.req.trace_id for row in live
                  if row.req.trace_id is not None]
        if traces:
            step_args["trace_ids"] = traces
        with _telemetry.span("decode.spec_round", cat="decode",
                             args=step_args):
            t0 = time.perf_counter()
            self._pool.gate.acquire(self._priority)
            try:
                with self._pool.exclusive(self._draft_geom):
                    drafted = self._spec_call(
                        ("draft_round", kmax, form),
                        lambda: self._draft_round_fn(kmax, form), dargs)
            finally:
                self._pool.gate.release()
            t1 = time.perf_counter()
            vargs = [b["pending"], drafted[0][:, :k], b["tables"],
                     b["lengths"]]
            if form != "greedy":
                vargs += [drafted[1][:, :k], *samp]
            self._pool.gate.acquire(self._priority)
            try:
                with self._pool.exclusive(self._geom):
                    res = self._spec_call(
                        ("verify", k, form),
                        lambda: self._verify_fn(k, form), vargs)
                    # THE one host read per round: accepted counts, next
                    # tokens and proposals feed the host commit
                    res = res.tolist()
            finally:
                self._pool.gate.release()
            t2 = time.perf_counter()
        self._ema(("spec", "draft"), t1 - t0)
        self._ema(("spec_verify", k), t2 - t1)
        total_acc = 0
        committed = 0
        for i, row in enumerate(live):
            na, nxt, props_i = res[i][0], res[i][1], res[i][2:]
            total_acc += na
            c = row.cached
            for t in props_i[:na] + [nxt]:
                row.req.out.append(t)
                committed += 1
                if self._done(row):
                    break
            if not self._done(row):
                row.cached = c + 1 + na
                row.pending = row.req.out[-1]
            # the draft's KV stays valid through the committed prefix it
            # holds: positions c .. c+kmax-1 hold [pending, d_1 ..
            # d_{kmax-1}], of which 1 + min(na, kmax-1) lead the committed
            # sequence; a rejected tail just rewinds
            row.draft_cached = c + 1 + min(na, kmax - 1)
        self._stats.inc("spec_rounds")
        self._stats.inc("spec_proposed", k * len(live))
        self._stats.inc("spec_accepted", total_acc)
        self._stats.inc("tokens_out", committed)
        _SPEC_STATS.inc("rounds")
        _SPEC_STATS.inc("proposed", k * len(live))
        _SPEC_STATS.inc("accepted", total_acc)
        # the expected-acceptance EMA feeds the arbiter; the rate EMA trips
        # the sticky low-acceptance cutoff
        self._ema(("spec", "acc"), total_acc / max(len(live), 1))
        rate = total_acc / float(max(k * len(live), 1))
        self._spec_acc_ema = (rate if self._spec_acc_ema is None
                              else 0.7 * self._spec_acc_ema + 0.3 * rate)
        self._spec_rounds_done += 1
        if self._spec_rounds_done >= 4 and self._spec_acc_ema < 0.2:
            self._spec_autodisable("measured acceptance persistently low",
                                   acceptance=round(self._spec_acc_ema, 4))
        return True

    # -- speculative programs (namespace 'serving_spec') ---------------------
    def _draft_prefill_fn(self, bucket: int):
        draft, dparams = self._draft, self._draft_params
        page, trash = self._pool.page, self._pool.trash

        def draft_prefill_fn(tokens, length, table):
            with torch.no_grad():
                _logits, k, v = draft.prefill(dparams, tokens, length)
                pos = torch.arange(bucket, device=tokens.device)
                pidx = torch.where(pos < length, table[pos // page],
                                   torch.full_like(pos, trash))
                self._scatter(pidx, pos % page, k, v, geom=self._draft_geom)
            return ()

        return draft_prefill_fn

    def _draft_round_fn(self, kmax: int, form: str = "full"):
        """The whole draft phase of a round as one program: a masked
        catch-up step, then the pending token, then kmax-1 proposal feeds
        (kmax+1 draft decode steps), so a round costs two dispatches
        however deep it drafts. Returns the proposals ``(R, kmax)`` and
        their sampling distributions ``(R, kmax, V)``, which stay on the
        device into verify; under the ``greedy`` form the proposals alone
        (the argmax; verify needs no distribution) and no sampling
        arguments are taken."""
        draft, dparams = self._draft, self._draft_params
        page, trash = self._pool.page, self._pool.trash
        dmp = self._draft_max_pages
        dgeom = self._draft_geom

        def draft_round_fn(catch, catch_on, pending, tables, lengths,
                           temps=None, top_ks=None, top_ps=None,
                           seeds=None):
            rows = torch.arange(tables.shape[0], device=tables.device)

            def step(tok, pos, write):
                # feed tok at per-row position pos, scatter its KV (masked
                # rows into the trash page); re-gathers, so step j attends
                # step j-1's KV
                k_ctx, v_ctx = self._gather_ctx(tables, dgeom, draft)
                logits, k_new, v_new = draft.decode(dparams, tok, k_ctx,
                                                    v_ctx, pos)
                pidx = torch.where(
                    write, tables[rows, torch.clamp(pos // page,
                                                    max=dmp - 1)],
                    torch.full_like(pos, trash))
                self._scatter(pidx, pos % page, k_new, v_new, geom=dgeom)
                return logits

            with torch.no_grad():
                # catch-up: after a fully accepted round the draft lags by
                # one committed token; rows that do not need it write the
                # trash page and do not advance
                step(catch, lengths, catch_on)
                cur = lengths + catch_on.long()
                props, qs = [], []
                tok = pending
                for j in range(1, kmax + 1):
                    logits = step(tok, cur + (j - 1),
                                  torch.ones_like(catch_on))
                    if form == "greedy":
                        d = torch.argmax(logits, dim=-1)
                    else:
                        # proposal j sits at position cur + j; salt 3
                        # keeps the draft's noise apart from verify's
                        # accept (1) and resample (2) streams on the same
                        # counter. One scaling and keep mask give both the
                        # token and its distribution q.
                        keys = fold_in(token_key(seeds, cur + j), 3)
                        d, q = _sample(logits, temps, top_ks, top_ps, keys,
                                       form, dist=True)
                        d = d.long()
                        qs.append(q)
                    props.append(d)
                    tok = d
                if form == "greedy":
                    return (torch.stack(props, dim=1),)
                return torch.stack(props, dim=1), torch.stack(qs, dim=1)

        return draft_round_fn

    def _verify_fn(self, k: int, form: str = "full"):
        """The verify program of depth k: one target ``decode_chunk`` over
        the k+1 positions (pending and k proposals), standard rejection
        sampling against the draft's distributions (accept ``d_j`` iff
        ``u_j q_j(d_j) < p_j(d_j)``), the first rejection resampled from
        ``norm(max(p - q, 0))`` (the bonus token after a full acceptance as
        the residual with ``q := 0``; ``p`` where the residual is all
        zero), and the KV scatter of the accepted prefix only (rejected
        positions write the trash page). Returns ``(R, 2 + k)``: ``n_acc``,
        the next token, and the proposals. The ``greedy`` form takes no
        distributions and no sampling arguments."""
        model, params = self._model, self._params
        page, trash = self._pool.page, self._pool.trash
        mp = self._max_pages
        s = k + 1

        def verify_fn(pending, props, tables, lengths, *sampled):
            dev = tables.device
            r = tables.shape[0]
            rows = torch.arange(r, device=dev)
            ar = torch.arange(s, device=dev)
            with torch.no_grad():
                k_ctx, v_ctx = self._gather_ctx(tables)
                toks = torch.cat([pending[:, None], props], dim=1)
                logits, k_new, v_new = model.decode_chunk(
                    params, toks, k_ctx, v_ctx, lengths)       # (R, S, V)
                if form == "greedy":
                    sampled = (None,) * 5
                n_acc, nxt = _rejection_sample(logits, props, lengths,
                                               *sampled, form=form)
                # chunk position i commits iff i <= n_acc (pending always,
                # then the accepted proposals)
                keep = ar[None, :] <= n_acc[:, None]
                wpos = lengths[:, None] + ar[None, :]
                pidx = torch.where(
                    keep, tables[rows[:, None],
                                 torch.clamp(wpos // page, max=mp - 1)],
                    torch.full_like(wpos, trash))
                self._scatter(pidx, wpos % page, k_new, v_new)
                return torch.cat([n_acc[:, None], nxt[:, None], props],
                                 dim=1)

        return verify_fn

    def _spec_examples(self, k: Optional[int] = None, form: str = "full"):
        """Example inputs of the draft round (``k`` None) or of verify at
        depth ``k`` in ``form``: every table the trash page, so a capture
        writes only the trash page."""
        r, trash, v = self._rows, self._pool.trash, int(self._model.vocab)
        samp = ([] if form == "greedy" else
                [torch.zeros((r,)), torch.zeros((r,), dtype=torch.int64),
                 torch.ones((r,)), torch.zeros((r,), dtype=torch.int64)])
        z = torch.zeros((r,), dtype=torch.int64)
        if k is None:
            return [z, torch.zeros((r,), dtype=torch.bool), z,
                    torch.full((r, self._draft_max_pages), trash,
                               dtype=torch.int64), z, *samp]
        out = [z, torch.zeros((r, k), dtype=torch.int64),
               torch.full((r, self._max_pages), trash, dtype=torch.int64), z]
        if form == "greedy":
            return out
        return out + [torch.zeros((r, k, v),
                                  dtype=self._draft_params["emb"].dtype),
                      *samp]

    # -- retire / deliver ----------------------------------------------------
    def _done(self, row: _Row) -> bool:
        req = row.req
        return (len(req.out) >= req.max_new
                or (req.eos is not None and bool(req.out)
                    and req.out[-1] == req.eos))

    def _retire_finished(self) -> None:
        for row in [x for x in self._live if self._done(x)]:
            self._live.remove(row)
            self._deliver(row)

    def _release(self, row: _Row) -> None:
        if row.pages:
            self._pool.free(row.pages)
            row.pages = []
        if row.draft_pages:
            self._pool.free(row.draft_pages)
            row.draft_pages = []
            row.draft_cached = 0

    def _deliver(self, row: _Row) -> None:
        self._release(row)               # pages free this iteration
        self._stats.inc("delivered")
        self._finish(row.req, None)

    def _ema(self, key, secs: float, alpha: float = 0.3) -> None:
        prev = self._cost.get(key)
        self._cost[key] = secs if prev is None \
            else (1 - alpha) * prev + alpha * secs

    # -- ahead-of-time warmup ------------------------------------------------
    def warmup(self, max_len: Optional[int] = None) -> int:
        """Capture the bounded program set before serving: one prefill per
        bucket of the ``MXNET_SHAPE_BUCKETS`` grid (pow2 spans
        1..``max_len``, default ``model.max_seq``; an explicit grid is
        taken as it is) and THE decode program; with a draft, also a draft
        prefill per bucket (up to the draft's ``max_seq``), the draft-round
        program and a verify program per k the arbiter can pick (1..4
        under ``auto``). The decode, draft-round and verify programs are
        captured in each sampler form (:data:`FORMS`), so that no mix of
        requests captures after warm-up. Each capture writes only the trash
        page. Returns the program signatures captured, a signature's forms
        counting once (0 = already warm)."""
        if self._closed:
            raise RuntimeError("GenerativeEngine is closed")
        cap = int(max_len if max_len is not None else self._model.max_seq)
        cap = min(cap, int(self._model.max_seq))
        if not self._policy.enabled:
            grid: List[int] = [cap]
        elif self._policy.buckets() is not None:
            grid = [b for b in self._policy.buckets() if b <= cap]
        else:
            grid, b = [], 1
            while b <= cap:
                grid.append(b)
                b <<= 1
        plain = (self._programs, self._geom, self._keep)
        specs = [(plain, ("prefill", b), lambda b=b: self._prefill_fn(b),
                  self._prefill_example(b)) for b in grid]
        for form in FORMS:
            specs.append((plain, ("decode", form),
                          lambda form=form: self._decode_fn(form),
                          self._decode_example()))
        if self._draft is not None:
            # the spec grid: a draft prefill per bucket, ONE draft round,
            # and a verify per k the arbiter can pick, so that a spec storm
            # captures nothing after warm-up, as the plain lane
            kmax = self._spec_kmax()
            dcap = min(cap, int(self._draft.max_seq))
            draft = (self._spec_programs, self._draft_geom, self._spec_keep)
            verify = (self._spec_programs, self._geom, self._spec_keep)
            for b in grid:
                if b <= dcap:
                    specs.append((draft, ("draft_prefill", b),
                                  lambda b=b: self._draft_prefill_fn(b),
                                  [torch.zeros((b,), dtype=torch.int64),
                                   torch.tensor(b),
                                   torch.full((self._draft_max_pages,),
                                              self._pool.trash,
                                              dtype=torch.int64)]))
            ks = (range(1, kmax + 1) if self._spec_setting() == "auto"
                  else [kmax])
            for form in FORMS:
                specs.append((draft, ("draft_round", kmax, form),
                              lambda form=form: self._draft_round_fn(
                                  kmax, form),
                              self._spec_examples(form=form)))
                for kk in ks:
                    specs.append((verify, ("verify", kk, form),
                                  lambda kk=kk, form=form: self._verify_fn(
                                      kk, form),
                                  self._spec_examples(kk, form)))
        compiled = set()
        for (cache, geom, keep), key, build, example in specs:
            if key in cache:
                continue
            cache.lookup(key)                         # counted miss
            with self._pool.exclusive(geom):
                prog = _pstore.Program(cache.namespace, build(), example,
                                       self._device, keep=keep)
                prog.prepare(*example)
            cache.insert(key, prog)
            compiled.add((cache.namespace.name, _signature(key)))
        compiled = len(compiled)
        self._stats.inc("warmup_programs", compiled)
        return compiled


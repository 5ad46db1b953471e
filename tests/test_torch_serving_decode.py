"""The port's continuous-batching generative serving
(``mxnet_tpu_torch/serving_decode.py``) against the JAX package's
``serving_decode`` on the CPU, at vocab 64, d_model 32, 2 layers, 2 heads,
max_seq 64:

- ``TinyCausalLM``: the same numpy draws, and ``prefill`` / ``decode`` /
  ``prefill_chunk`` teacher-forced on the reference's own inputs, logits
  and K/V within 1e-5 (fp32);
- ``eager_generate`` greedy token-exact against the reference;
- threefry: keys and random bits bitwise for a grid of (seed, position),
  Gumbel noise within 1e-6 (last ulp of the log), sampled tokens seed for
  seed;
- the ``PagePool`` allocator, and ``poison_free`` writing under one hold of
  the pool's lock (a page allocated meanwhile is never poisoned);
- the continuous batcher token-exact against the port's ``eager_generate``
  through a join/retire storm, pool-pressure preemption (greedy and
  seeded sampling), EOS, multi-model accounting on one pool; warmup's
  bounded program set (prefill buckets + 1), 0 captures after it, one
  dispatch per decode iteration and per prefill; the admission sheds
  raised as the reference's typed errors; ``engine.waitall``.

The ``cuda``-marked test runs the engine on the card as captured graphs and
skips without one.
"""
import functools
import threading
import time

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import engine as tengine
from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import preemption as tpreemption
from mxnet_tpu_torch import serving_decode as sd
from mxnet_tpu_torch.convert import decode_params_from_numpy

from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
rsd = LazyModule("mxnet_tpu.serving_decode")
rfaults = LazyModule("mxnet_tpu.faults")
rpreemption = LazyModule("mxnet_tpu.preemption")
jnp = LazyModule("jax.numpy")
jax = LazyModule("jax")

CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, max_seq=64)
TOL = 1e-5          # fp32 logits and K/V against the reference
GUMBEL_TOL = 1e-6   # the Gumbel noise: its log differs in the last ulp
CPU = "cpu"
JOIN_S = 120.0


def tiny(seed=0, **kw):
    """Module-shared CPU model and params per (seed, config)."""
    return _tiny_cached(seed, tuple(sorted(kw.items())))


@functools.lru_cache(maxsize=None)
def _tiny_cached(seed, kw_items):
    cfg = dict(CFG)
    cfg.update(dict(kw_items))
    model = sd.TinyCausalLM(**cfg)
    return model, model.init_params(seed, device=CPU)


@functools.lru_cache(maxsize=None)
def _reference(seed):
    model = rsd.TinyCausalLM(**CFG)
    return model, model.init_params(seed)


def _np(x):
    return onp.asarray(x)


def _close(got, want, tol=TOL):
    want = _np(want)
    assert got.shape == want.shape
    assert onp.abs(got.detach().numpy() - want).max() <= tol


def _run_threads(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a request thread hung"


@pytest.fixture
def engines():
    """Make engines on the CPU; every one is closed at the end."""
    made = []

    def make(model, params, **kw):
        kw.setdefault("device", CPU)
        eng = sd.GenerativeEngine(model, params=params, **kw)
        made.append(eng)
        return eng

    try:
        yield make
    finally:
        for eng in made:
            eng.close()


# ---------------------------------------------------------------------------
# The model against the reference
# ---------------------------------------------------------------------------
def test_init_params_draw_for_draw_and_convert():
    model, params = tiny(3)
    _rm, rparams = _reference(3)
    for name in ("emb", "pos", "out"):
        assert onp.array_equal(params[name].numpy(), _np(rparams[name]))
    for lp, rlp in zip(params["layers"], rparams["layers"]):
        for name, t in lp.items():
            assert onp.array_equal(t.numpy(), _np(rlp[name]))
    conv = decode_params_from_numpy(
        {"emb": _np(rparams["emb"]), "pos": _np(rparams["pos"]),
         "out": _np(rparams["out"]),
         "layers": [{k: _np(v) for k, v in lp.items()}
                    for lp in rparams["layers"]]}, device=CPU)
    assert torch.equal(conv["emb"], params["emb"])
    assert torch.equal(conv["layers"][1]["w2"], params["layers"][1]["w2"])
    with pytest.raises(KeyError):
        decode_params_from_numpy({"emb": _np(rparams["emb"]),
                                  "layers": []}, device=CPU)


@pytest.mark.parametrize("n,bucket", [(1, 1), (5, 8), (13, 16), (32, 32)])
def test_prefill_matches_reference(n, bucket):
    model, params = tiny(0)
    rm, rparams = _reference(0)
    toks = onp.random.RandomState(n).randint(0, CFG["vocab"], size=bucket)
    logits, k, v = model.prefill(params, torch.from_numpy(toks), n)
    rl, rk, rv = rm.prefill(rparams, jnp.asarray(toks, jnp.int32), n)
    _close(logits, rl)
    # pad positions may hold anything: compare the true ones
    _close(k[:, :n], _np(rk)[:, :n])
    _close(v[:, :n], _np(rv)[:, :n])


def _context(rm, rparams, prompts, c):
    """The reference's K/V of each prompt, laid out as a decode context
    (L, R, C, H, D) (positions past a prompt's length are zero)."""
    L, H, D = rm.n_layers, rm.n_heads, rm.head_dim
    k_ctx = onp.zeros((L, len(prompts), c, H, D), onp.float32)
    v_ctx = onp.zeros_like(k_ctx)
    for r, p in enumerate(prompts):
        _l, k, v = rm.prefill(rparams, jnp.asarray(p, jnp.int32), len(p))
        k_ctx[:, r, :len(p)] = _np(k)
        v_ctx[:, r, :len(p)] = _np(v)
    return k_ctx, v_ctx


def test_decode_teacher_forced_matches_reference():
    """Three decode steps over three rows of different lengths, each step
    fed the reference's own tokens and context (teacher forcing), so that
    one argmax cannot hide a logits difference."""
    model, params = tiny(1)
    rm, rparams = _reference(1)
    rng = onp.random.RandomState(11)
    prompts = [rng.randint(0, 64, size=n).tolist() for n in (3, 9, 17)]
    c = 24
    for step in range(3):
        k_ctx, v_ctx = _context(rm, rparams, prompts, c)
        tokens = onp.array([p[-1] for p in prompts])
        lengths = onp.array([len(p) - 1 for p in prompts])
        # the context holds the tokens before the last one of each row
        for r, p in enumerate(prompts):
            k_ctx[:, r, len(p) - 1:] = 0
            v_ctx[:, r, len(p) - 1:] = 0
        rl, rk, rv = rm.decode(rparams, jnp.asarray(tokens, jnp.int32),
                               jnp.asarray(k_ctx), jnp.asarray(v_ctx),
                               jnp.asarray(lengths, jnp.int32))
        logits, k, v = model.decode(params, torch.from_numpy(tokens),
                                    torch.from_numpy(k_ctx),
                                    torch.from_numpy(v_ctx),
                                    torch.from_numpy(lengths))
        _close(logits, rl)
        _close(k, rk)
        _close(v, rv)
        for r, p in enumerate(prompts):
            p.append(int(onp.argmax(_np(rl)[r])))


def test_prefill_chunk_matches_reference():
    model, params = tiny(2)
    rm, rparams = _reference(2)
    rng = onp.random.RandomState(4)
    seq = rng.randint(0, 64, size=21).tolist()
    offset, bucket, c = 12, 16, 32
    L, H, D = rm.n_layers, rm.n_heads, rm.head_dim
    _l, k, v = rm.prefill(rparams, jnp.asarray(seq, jnp.int32), len(seq))
    k_ctx = onp.zeros((L, c, H, D), onp.float32)
    v_ctx = onp.zeros_like(k_ctx)
    k_ctx[:, :offset] = _np(k)[:, :offset]
    v_ctx[:, :offset] = _np(v)[:, :offset]
    suffix = onp.zeros(bucket, onp.int64)
    suffix[:len(seq) - offset] = seq[offset:]
    rl, rk, rv = rm.prefill_chunk(rparams, jnp.asarray(suffix, jnp.int32),
                                  jnp.asarray(k_ctx), jnp.asarray(v_ctx),
                                  offset, len(seq))
    logits, tk, tv = model.prefill_chunk(
        params, torch.from_numpy(suffix), torch.from_numpy(k_ctx),
        torch.from_numpy(v_ctx), offset, len(seq))
    m = len(seq) - offset
    _close(logits, rl)
    _close(tk[:, :m], _np(rk)[:, :m])
    _close(tv[:, :m], _np(rv)[:, :m])


def test_eager_generate_greedy_token_exact_vs_reference():
    model, params = tiny(0)
    rm, rparams = _reference(0)
    rng = onp.random.RandomState(7)
    for n in (1, 4, 11, 20):
        prompt = rng.randint(0, 64, size=n).tolist()
        assert sd.eager_generate(model, params, prompt, 12) == \
            rsd.eager_generate(rm, rparams, prompt, 12), n


# ---------------------------------------------------------------------------
# threefry and sampling
# ---------------------------------------------------------------------------
SEEDS = (0, 1, 7, 12345, 2 ** 31 - 1)
POSITIONS = (0, 1, 5, 63, 511, 70000)


@pytest.mark.parametrize("seed", SEEDS)
def test_threefry_keys_and_bits_bitwise(seed):
    for pos in POSITIONS:
        key = sd.token_key(seed, pos)
        rkey = rsd.token_key(seed, pos)
        assert onp.array_equal(key.numpy().astype(onp.uint32),
                               _np(jax.random.key_data(rkey)))
        bits = sd.random_bits(key, 97).numpy().astype(onp.uint32)
        rbits = _np(jax.random.bits(rkey, (97,), jnp.uint32))
        assert onp.array_equal(bits, rbits), (seed, pos)
        assert onp.allclose(sd.gumbel(key, 97).numpy(),
                            _np(jax.random.gumbel(rkey, (97,))),
                            rtol=GUMBEL_TOL, atol=GUMBEL_TOL)
    # batched keys: one row per (seed, position), the same words
    keys = sd.token_key(torch.full((3,), seed), torch.tensor([0, 5, 63]))
    for i, pos in enumerate((0, 5, 63)):
        assert torch.equal(keys[i], sd.token_key(seed, pos))


SPECS = [(0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.9), (0.8, 8, 0.6)]


@pytest.mark.parametrize("temp,top_k,top_p", SPECS)
def test_sample_token_seed_for_seed(temp, top_k, top_p):
    logits = onp.random.RandomState(int(temp * 10) + top_k).randn(
        64).astype(onp.float32) * 3
    for seed in SEEDS:
        for pos in (3, 40):
            got = int(sd.sample_token(torch.from_numpy(logits), temp, top_k,
                                      top_p, sd.token_key(seed, pos)))
            want = int(rsd.sample_token(jnp.asarray(logits), temp, top_k,
                                        top_p, rsd.token_key(seed, pos)))
            assert got == want, (seed, pos)


def test_greedy_branch_is_the_plain_argmax():
    logits = torch.from_numpy(onp.random.RandomState(0).randn(
        6, 64).astype(onp.float32))
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1    # a tie
    got = sd.sample_token(logits, torch.zeros(6), torch.zeros(6),
                          torch.ones(6), sd.token_key(torch.arange(6), 3))
    assert torch.equal(got.long(), torch.argmax(logits, dim=-1))
    assert int(got[2]) == 7


def test_eager_generate_sampled_seed_for_seed_vs_reference():
    model, params = tiny(0)
    rm, rparams = _reference(0)
    prompt = [5, 9, 33, 2]
    for temp, top_k, top_p in SPECS:
        for seed in (0, 11):
            spec = sd.SamplingSpec(temp, top_k, top_p, seed)
            rspec = rsd.SamplingSpec(temp, top_k, top_p, seed)
            assert sd.eager_generate(model, params, prompt, 10,
                                     sampling=spec) == \
                rsd.eager_generate(rm, rparams, prompt, 10,
                                   sampling=rspec), (temp, top_k, seed)


def test_sampling_spec_validates_like_the_reference():
    for bad in (dict(temperature=-1.0), dict(top_p=0.0),
                dict(top_p=1.5), dict(temperature=float("inf"))):
        with pytest.raises(ValueError):
            sd.SamplingSpec(**bad)
        with pytest.raises(ValueError):
            rsd.SamplingSpec(**bad)
    s = sd.SamplingSpec(0.5, 3, 0.9, seed=-5)
    assert s.seed == rsd.SamplingSpec(0.5, 3, 0.9, seed=-5).seed
    assert sd.SamplingSpec.from_wire(s.to_wire()) == s
    assert sd.GREEDY.greedy and not s.greedy


# ---------------------------------------------------------------------------
# PagePool allocator
# ---------------------------------------------------------------------------
def test_pagepool_alloc_free_reuse():
    pool = sd.PagePool(pages=4, page=2)
    a = pool.alloc(2)
    b = pool.alloc(1)
    assert len(set(a) | set(b)) == 3 and pool.in_use() == 3
    pool.free(a)
    assert pool.in_use() == 1 and pool.free_pages() == 3
    c = pool.alloc(2)                   # LIFO: the just-freed pages first
    assert set(c) == set(a) and pool.in_use() == 3
    st = pool.stats()
    assert st["alloc_count"] == 5 and st["free_count"] == 2
    assert st["high_water"] == 3


def test_pagepool_exhaustion_is_typed_shed():
    pool = sd.PagePool(pages=2, page=4)
    pool.alloc(2)
    with pytest.raises(sd.PagePoolExhausted) as ei:
        pool.alloc(1)
    assert isinstance(ei.value, tfaults.ShedError)
    assert ei.value.kind == "pool"
    assert pool.stats()["exhausted_count"] == 1


def test_pagepool_double_free_raises():
    pool = sd.PagePool(pages=2, page=2)
    pages = pool.alloc(1)
    pool.free(pages)
    with pytest.raises(ValueError):
        pool.free(pages)


def test_pagepool_trash_page_reserved_and_storage_shape():
    pool = sd.PagePool(pages=3, page=2)
    assert pool.trash not in pool.alloc(3)
    geom = pool.register(2, 2, 16, device=CPU)
    k, v = pool.storage(geom)
    assert k.shape == (4, 2, 2, 2, 16) and v.shape == k.shape
    ptr = k.data_ptr()
    pool.set_storage(geom, torch.ones_like(k), v)
    assert pool.storage(geom)[0].data_ptr() == ptr          # in place
    assert bool((pool.storage(geom)[0] == 1).all())


def test_poison_free_writes_only_free_pages():
    pool = sd.PagePool(pages=4, page=2)
    geom = pool.register(1, 1, 2, device=CPU)
    live = pool.alloc(2)
    assert pool.poison_free(7.0) == 2
    k, v = pool.storage(geom)
    for p in range(pool.pages):
        want = 0.0 if p in live else 7.0
        assert bool((k[p] == want).all()) and bool((v[p] == want).all())
    assert bool((k[pool.trash] == 0).all())


def test_poison_free_never_poisons_a_page_allocated_meanwhile():
    """``poison_free`` holds the pool's lock from reading the free list to
    writing the poison: an ``alloc`` that comes in between waits, so the
    page it gets (and writes) is never overwritten afterwards. The
    reference reads the list under its lock and writes later, which
    poisons such a page."""
    pool = sd.PagePool(pages=2, page=1)
    geom = pool.register(1, 1, 1, device=CPU)
    k, _v = pool.storage(geom)
    got = {}
    geom_lock = pool.exclusive(geom)
    geom_lock.acquire()                 # poison_free will wait on this
    poisoner = threading.Thread(target=lambda: got.setdefault(
        "n", pool.poison_free(1e30)))
    poisoner.start()
    time.sleep(0.2)                     # it now holds the pool's lock

    def alloc_and_write():
        page = pool.alloc(1)[0]
        with pool.exclusive(geom):
            k[page] = 5.0
        got["page"] = page

    allocator = threading.Thread(target=alloc_and_write)
    allocator.start()
    time.sleep(0.2)
    assert "page" not in got            # alloc waits for the poison
    geom_lock.release()
    poisoner.join(timeout=JOIN_S)
    allocator.join(timeout=JOIN_S)
    assert not poisoner.is_alive() and not allocator.is_alive()
    assert got["n"] == 2
    assert float(k[got["page"]].max()) == 5.0


# ---------------------------------------------------------------------------
# The continuous batcher against the port's eager loop
# ---------------------------------------------------------------------------
def test_single_sequence_token_exact(engines):
    model, params = tiny()
    pool = sd.PagePool(pages=32, page=4)
    eng = engines(model, params, pool=pool, max_rows=4, name="m")
    eng.warmup(max_len=16)
    for prompt, n in (([3, 5, 7], 6), ([1], 8), (list(range(11)), 4)):
        assert eng.generate(prompt, max_new_tokens=n) == \
            sd.eager_generate(model, params, prompt, n)
    assert pool.in_use() == 0


def test_join_retire_storm_token_exact_and_bounded_programs(engines):
    """Sequences join mid-stream and retire early; every result is
    token-exact, the program set stays prefill buckets + 1, 0 captures
    after warm-up, one dispatch per decode iteration and per prefill."""
    model, params = tiny(seed=1)
    pool = sd.PagePool(pages=64, page=4)
    eng = engines(model, params, pool=pool, max_rows=3, name="m")
    grid = eng.warmup(max_len=16)
    assert grid == 6                    # pow2 buckets 1..16 + decode
    t0, d0 = sd.trace_count(), sd.dispatch_count()
    rng = onp.random.RandomState(5)
    prompts = [rng.randint(0, 64, size=rng.randint(1, 12)).tolist()
               for _ in range(6)]
    budgets = [2, 7, 3, 6, 5, 8]
    results = [None] * 6

    def fire(i):
        def go():
            time.sleep(0.01 * (i // 2))
            results[i] = eng.generate(prompts[i],
                                      max_new_tokens=budgets[i])
        return go

    _run_threads([fire(i) for i in range(6)])
    for i in range(6):
        assert results[i] == sd.eager_generate(
            model, params, prompts[i], budgets[i]), f"request {i}"
    st = eng.stats()
    assert sd.trace_count() - t0 == 0
    assert st["programs"] == grid
    assert sd.dispatch_count() - d0 == st["decode_steps"] + st["prefills"]
    assert st["prefills"] >= 6
    assert pool.in_use() == 0 and eng.pool_audit() == []


def test_poisoned_free_pages_do_not_alias_live_sequences(engines):
    model, params = tiny(seed=2)
    pool = sd.PagePool(pages=32, page=4)
    eng = engines(model, params, pool=pool, max_rows=2, name="m")
    eng.warmup(max_len=8)
    res = {}
    ta = threading.Thread(target=lambda: res.setdefault(
        "a", eng.generate([2, 3, 4], max_new_tokens=2)))
    tb = threading.Thread(target=lambda: res.setdefault(
        "b", eng.generate([5, 6], max_new_tokens=10)))
    ta.start()
    tb.start()
    ta.join(timeout=JOIN_S)
    n = pool.poison_free(1e30)
    tb.join(timeout=JOIN_S)
    assert not ta.is_alive() and not tb.is_alive()
    assert n > 0
    assert res["a"] == sd.eager_generate(model, params, [2, 3, 4], 2)
    assert res["b"] == sd.eager_generate(model, params, [5, 6], 10)


def test_preemption_under_pool_pressure_token_exact(engines):
    model, params = tiny(seed=3)
    pool = sd.PagePool(pages=4, page=2)
    eng = engines(model, params, pool=pool, max_rows=2, name="m")
    eng.warmup(max_len=8)
    prompts, res = [[1, 2, 3], [4, 5]], {}
    _run_threads([lambda i=i: res.setdefault(
        i, eng.generate(prompts[i], max_new_tokens=4)) for i in (0, 1)])
    for i in (0, 1):
        assert res[i] == sd.eager_generate(model, params, prompts[i], 4)
    assert eng.stats()["preempts"] >= 1
    assert pool.in_use() == 0


def test_sampled_request_replays_after_preemption(engines):
    """Seeded sampling is a pure function of (seed, position): a request
    preempted mid-decode and re-prefilled draws the same tokens as the
    eager loop, and as the reference's eager loop."""
    model, params = tiny(seed=3)
    rm, rparams = _reference(3)
    spec = sd.SamplingSpec(temperature=0.9, top_k=12, top_p=0.95, seed=21)
    pool = sd.PagePool(pages=4, page=2)
    eng = engines(model, params, pool=pool, max_rows=2, name="m")
    prompts, res = [[1, 2, 3], [4, 5]], {}
    _run_threads([lambda i=i: res.setdefault(
        i, eng.generate(prompts[i], max_new_tokens=4, sampling=spec))
        for i in (0, 1)])
    assert eng.stats()["preempts"] >= 1
    rspec = rsd.SamplingSpec(temperature=0.9, top_k=12, top_p=0.95,
                             seed=21)
    for i in (0, 1):
        want = sd.eager_generate(model, params, prompts[i], 4,
                                 sampling=spec)
        assert res[i] == want
        assert want == rsd.eager_generate(rm, rparams, prompts[i], 4,
                                          sampling=rspec)


def test_preemption_keeps_enqueue_clock_and_seniority(engines):
    model, params = tiny(seed=4)
    pool = sd.PagePool(pages=64, page=4)
    eng = engines(model, params, pool=pool, max_rows=4, name="sen")
    eng.warmup(max_len=8)
    r1 = sd._GenRequest([1, 2, 3], 12, None)
    r2 = sd._GenRequest([4, 5], 12, None)
    eng._prefill(r1)
    eng._prefill(r2)
    assert (r1.joined, r2.joined) == (0, 1)
    t_orig = r2.t_enqueue
    row2 = next(r for r in eng._live if r.req is r2)
    eng._preempt(row2)
    assert r2.preempts == 1 and r2.t_enqueue == t_orig
    r3 = sd._GenRequest([6, 7], 12, None)
    eng._prefill(r3)
    assert r3.joined == 2
    with eng._cv:
        eng._queue.remove(r2)
    eng._prefill(r2)
    assert r2.joined == 1 and r2.t_enqueue == t_orig
    rows = {r.req: r for r in eng._live}
    victims = [x for x in eng._live if x is not rows[r1]]
    assert max(victims, key=lambda x: x.joined).req is r3
    for row in list(eng._live):
        eng._live.remove(row)
        eng._release(row)
    assert pool.in_use() == 0


def test_eos_stops_generation(engines):
    model, params = tiny(seed=4)
    prompt = [7, 9]
    ref = sd.eager_generate(model, params, prompt, 8)
    eos = ref[2]
    pool = sd.PagePool(pages=16, page=4)
    eng = engines(model, params, pool=pool, max_rows=2, name="m")
    out = eng.generate(prompt, max_new_tokens=8, eos=eos)
    assert out == sd.eager_generate(model, params, prompt, 8, eos=eos)
    assert out[-1] == eos and len(out) <= 8


# ---------------------------------------------------------------------------
# Admission: the reference's typed sheds
# ---------------------------------------------------------------------------
def _shed_scenario(mod, faults_mod, preemption_mod, kind, model, params,
                   device_kw):
    """Drive one admission refusal on ``mod``'s engine; returns (error
    type name, kind, counters of the engine)."""
    small = kind == "pool"
    pool = mod.PagePool(pages=2 if small else 8, page=2 if small else 4)
    eng = mod.GenerativeEngine(model, params=params, pool=pool, name="m",
                               max_queue=2, slo_us=10, **device_kw)
    try:
        if kind == "queue":
            eng._queue.extend([object(), object()])
            call = lambda: eng.generate([1, 2], max_new_tokens=2)  # noqa
        elif kind == "pool":
            call = lambda: eng.generate([1] * 8, max_new_tokens=4)  # noqa
        elif kind == "slo":
            eng._cost["decode"] = 1.0
            eng._queue.append(object())
            call = lambda: eng.generate([1, 2], max_new_tokens=5)  # noqa
        elif kind == "fault":
            plan = faults_mod.FaultPlan().fail("serving.admit", times=1)
            call = lambda: _with_plan(faults_mod, plan, eng)  # noqa
        elif kind == "draining":
            eng.begin_drain()
            call = lambda: eng.generate([1, 2], max_new_tokens=2)  # noqa
        else:                                   # deadline
            call = lambda: _spent_deadline(faults_mod, eng)  # noqa
        t0 = time.monotonic()
        with pytest.raises(faults_mod.ShedError) as ei:
            call()
        assert time.monotonic() - t0 < 1.0      # fail fast, no timeout
        st = eng.stats()
        eng._queue.clear()
        return (type(ei.value).__name__, ei.value.kind,
                {k: st[k] for k in ("shed", "shed_queue", "shed_pool",
                                    "shed_slo", "shed_draining",
                                    "shed_deadline")})
    finally:
        eng.close()


def _with_plan(faults_mod, plan, eng):
    with faults_mod.active(plan):
        eng.generate([1, 2], max_new_tokens=2)


def _spent_deadline(faults_mod, eng):
    with faults_mod.deadline_scope(-1, site="test.deadline"):
        eng.generate([1, 2], max_new_tokens=2)


@pytest.mark.parametrize("kind", ["queue", "pool", "slo", "fault",
                                  "draining", "deadline"])
def test_admission_sheds_as_the_reference(kind):
    model, params = tiny()
    rm, rparams = _reference(0)
    got = _shed_scenario(sd, tfaults, tpreemption, kind, model, params,
                         {"device": CPU})
    want = _shed_scenario(rsd, rfaults, rpreemption, kind, rm, rparams, {})
    assert got == want


def test_admission_injected_fault_is_logged():
    model, params = tiny()
    tfaults.reset()
    eng = sd.GenerativeEngine(model, params=params,
                              pool=sd.PagePool(pages=8, page=4), name="m",
                              device=CPU)
    try:
        with tfaults.active(tfaults.FaultPlan().fail("serving.admit")):
            with pytest.raises(sd.ShedError):
                eng.generate([1, 2], max_new_tokens=2)
    finally:
        eng.close()
    assert any(e["action"] == "shed"
               for e in tfaults.events("serving.admit"))


def test_shed_is_not_retryable():
    assert not tfaults.is_retryable(sd.ShedError("x"))
    assert not tfaults.is_retryable(sd.PagePoolExhausted("x"))


# ---------------------------------------------------------------------------
# Warm-up, program set, stats, drain, devices
# ---------------------------------------------------------------------------
def test_warmup_grid_and_idempotence(engines):
    model, params = tiny()
    eng = engines(model, params, pool=sd.PagePool(pages=16, page=4),
                  name="m")
    assert eng.warmup(max_len=8) == 5   # buckets 1, 2, 4, 8 + decode
    assert eng.warmup(max_len=8) == 0
    assert eng.stats()["programs"] == 5
    t0 = sd.trace_count()
    out = eng.generate([1, 2, 3], max_new_tokens=2)
    assert len(out) == 2 and sd.trace_count() == t0


def test_warmup_writes_only_the_trash_page(engines):
    model, params = tiny()
    pool = sd.PagePool(pages=8, page=4)
    eng = engines(model, params, pool=pool, name="m")
    eng.warmup(max_len=16)
    k, v = pool.storage(eng._geom)
    assert not bool(k[:pool.pages].any()) and not bool(v[:pool.pages].any())


def test_stats_surface_and_latency_percentiles(engines):
    model, params = tiny()
    eng = engines(model, params, pool=sd.PagePool(pages=16, page=4),
                  name="modelA")
    eng.warmup(max_len=8)
    eng.generate([1, 2], max_new_tokens=3)
    st = eng.stats()
    assert st["model"] == "modelA"
    for key in ("p50_us", "p99_us", "shed", "shed_queue", "shed_pool",
                "shed_slo", "preempts", "slo_violations", "tokens_out",
                "decode_steps", "prefills", "delivered", "pool"):
        assert key in st, key
    assert st["p50_us"] > 0 and st["delivered"] == 1
    assert st["tokens_out"] + 1 >= 3
    assert [s["name"] for s in eng.spans()][-1] == "decode.step"
    load = eng.load()
    assert set(load) == {"queue_depth", "in_flight", "pool_pressure"}


def test_waitall_drains_engine(engines):
    model, params = tiny()
    pool = sd.PagePool(pages=16, page=4)
    eng = engines(model, params, pool=pool, name="m")
    eng.warmup(max_len=8)
    done = []
    t = threading.Thread(target=lambda: done.append(
        eng.generate([1, 2], max_new_tokens=6)))
    t.start()
    deadline = time.monotonic() + 30.0
    while eng.stats()["prefills"] == 0 and time.monotonic() < deadline:
        time.sleep(0.001)
    tengine.waitall()                   # blocks until delivered
    with eng._cv:
        assert not eng._queue and not eng._live
    t.join(timeout=JOIN_S)
    assert not t.is_alive()
    assert len(done[0]) == 6 and pool.in_use() == 0


def test_multi_model_shared_pool_accounting(engines):
    """Two engines of different geometries draw pages from one pool,
    decode concurrently, stay token-exact, and the accounting returns to
    zero."""
    m1, p1 = tiny(seed=6)
    m2 = sd.TinyCausalLM(vocab=64, d_model=24, n_layers=1, n_heads=3,
                         max_seq=64)
    p2 = m2.init_params(7, device=CPU)
    pool = sd.PagePool(pages=32, page=4)
    e1 = engines(m1, p1, pool=pool, max_rows=2, name="a")
    e2 = engines(m2, p2, pool=pool, max_rows=2, name="b")
    e1.warmup(max_len=8)
    e2.warmup(max_len=8)
    res = {}
    _run_threads([
        lambda: res.setdefault("a", e1.generate([1, 2, 3],
                                                max_new_tokens=5)),
        lambda: res.setdefault("b", e2.generate([4, 5],
                                                max_new_tokens=6))])
    assert res["a"] == sd.eager_generate(m1, p1, [1, 2, 3], 5)
    assert res["b"] == sd.eager_generate(m2, p2, [4, 5], 6)
    assert pool.in_use() == 0 and pool.audit() == []
    assert pool.stats()["high_water"] >= 2
    assert len(pool._storage) == 2


def test_generate_validates_inputs(engines):
    model, params = tiny()
    eng = engines(model, params, pool=sd.PagePool(pages=8, page=4),
                  name="m")
    with pytest.raises(ValueError):
        eng.generate([], max_new_tokens=2)
    with pytest.raises(ValueError):
        eng.generate([1], max_new_tokens=0)
    with pytest.raises(ValueError):
        eng.generate(list(range(60)), max_new_tokens=10)
    with pytest.raises(TypeError):
        eng.generate([1], max_new_tokens=2, sampling={"seed": 1})


def test_engine_never_moves_its_parameters():
    model, params = tiny()
    meta = dict(params, emb=params["emb"].to("meta"))
    with pytest.raises(ValueError, match="never moves"):
        sd.GenerativeEngine(model, params=meta, device=CPU,
                            pool=sd.PagePool(pages=4, page=4))


def test_engine_and_init_params_default_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    model, params = tiny()
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init_params(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        sd.GenerativeEngine(model, params=params,
                            pool=sd.PagePool(pages=4, page=4))


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_engine_on_card_replays_one_graph_per_iteration(cuda_device):
    """The storm on the card: captured prefill and decode graphs, token
    exact against the eager loop on the card, 0 captures after warm-up,
    one dispatch per decode iteration and per prefill, 0 leaked pages."""
    model = sd.TinyCausalLM(**CFG)
    params = model.init_params(1, device=cuda_device)
    pool = sd.PagePool(pages=64, page=4)
    eng = sd.GenerativeEngine(model, params=params, pool=pool, max_rows=4,
                              name="card", device=cuda_device)
    try:
        assert eng.warmup(max_len=32) == 7
        t0, d0 = sd.trace_count(), sd.dispatch_count()
        rng = onp.random.RandomState(2)
        prompts = [rng.randint(0, 64, size=rng.randint(2, 20)).tolist()
                   for _ in range(8)]
        res = [None] * 8
        _run_threads([lambda i=i: res.__setitem__(
            i, eng.generate(prompts[i], max_new_tokens=9))
            for i in range(8)])
        for i in range(8):
            assert res[i] == sd.eager_generate(model, params, prompts[i],
                                               9), i
        st = eng.stats()
        assert sd.trace_count() == t0
        assert sd.dispatch_count() - d0 == st["decode_steps"] + \
            st["prefills"]
        assert pool.in_use() == 0 and eng.pool_audit() == []
    finally:
        eng.close()

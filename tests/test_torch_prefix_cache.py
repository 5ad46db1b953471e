"""The port's content-addressed KV prefix cache
(``mxnet_tpu_torch/serving_decode.py``, ``MXNET_PREFIX_CACHE``): the
counterparts of the JAX package's ``tests/test_prefix_cache.py`` on the
CPU, at vocab 64, d_model 32, 2 layers, max_seq 64.

Pins: (1) the chained keys are the reference's, byte for byte, and commit
to the full prefix and the geometry; (2) refcounted lookup / publish with
the resident LRU; (3) eviction never reclaims a live page, and the typed
shed fires only when eviction cannot help; (4) copy-on-write fork at
divergence, counted and token-exact; (5) full- and partial-hit prefill
token-exact against the port's eager loop, against a cold cache, and
against the reference's eager loop; (6) ``MXNET_PREFIX_CACHE=0`` is a true
off switch.
"""
import functools

import pytest
import torch

from mxnet_tpu_torch import faults as tfaults
from mxnet_tpu_torch import serving_decode as sd
from mxnet_tpu_torch import telemetry

from test_torch_package import LazyModule

rsd = LazyModule("mxnet_tpu.serving_decode")

CFG = dict(vocab=64, d_model=32, n_layers=2, n_heads=2, max_seq=64)


@functools.lru_cache(maxsize=None)
def tiny(seed=0):
    model = sd.TinyCausalLM(**CFG)
    return model, model.init_params(seed, device="cpu")


def prefix_delta(base):
    return {k: v for k, v in telemetry.delta(base).items()
            if k.startswith("prefix.") and v}


@pytest.fixture
def engines():
    made = []

    def make(model, params, **kw):
        eng = sd.GenerativeEngine(model, params=params, device="cpu", **kw)
        made.append(eng)
        return eng

    try:
        yield made, make
    finally:
        for eng in made:
            eng.close()


def test_chain_keys_commit_to_full_prefix_and_match_reference():
    geom = (2, 2, 8, "float32")
    a = sd._chain_keys([1, 2, 3, 4, 5, 6, 7, 8], 4, geom)
    assert a == rsd._chain_keys([1, 2, 3, 4, 5, 6, 7, 8], 4, geom)
    assert a == sd._chain_keys([1, 2, 3, 4, 5, 6, 7, 8], 4, geom)
    assert len(a) == 2
    c = sd._chain_keys([9, 9, 9, 9, 5, 6, 7, 8], 4, geom)
    assert c[1] != a[1] and c[0] != a[0]
    d = sd._chain_keys([1, 2, 3, 4, 5, 6], 4, geom)
    assert len(d) == 2 and d[0] == a[0] and d[1] != a[1]
    e = sd._chain_keys([1, 2, 3, 4, 5, 6, 7, 8], 4, (4, 4, 16, "float32"))
    assert e[0] != a[0]


def test_lookup_publish_refcount_lifecycle():
    base = telemetry.snapshot()
    geom = ("test-geom",)
    pool = sd.PagePool(pages=4, page=4)
    keys = sd._chain_keys(list(range(8)), 4, geom)
    pages = pool.alloc(2)
    pool.publish(geom, list(zip(keys, pages)))
    pool.free(pages)
    st = pool.stats()
    assert st["in_use"] == 0 and st["cached"] == 2
    assert pool.free_pages() == 4
    hits = pool.lookup(geom, keys)
    assert hits == pages
    assert pool.ref(pages[0]) == 1 and pool.in_use() == 2
    hits2 = pool.lookup(geom, keys[:1])
    assert hits2 == pages[:1] and pool.ref(pages[0]) == 2
    pool.free(hits2)
    assert pool.ref(pages[0]) == 1 and pool.in_use() == 2
    pool.free(hits)
    assert pool.in_use() == 0 and pool.stats()["cached"] == 2
    assert pool.holds(geom, keys) == 2 and pool.in_use() == 0
    d = prefix_delta(base)
    assert d.get("prefix.hit_blocks") == 3
    assert "prefix.miss_blocks" not in d
    assert pool.audit() == []


def test_lookup_stops_at_first_miss():
    base = telemetry.snapshot()
    geom = ("test-geom-miss",)
    pool = sd.PagePool(pages=4, page=4)
    keys = sd._chain_keys(list(range(12)), 4, geom)
    pages = pool.alloc(2)
    pool.publish(geom, list(zip(keys[:2], pages)))
    hits = pool.lookup(geom, keys)
    assert hits == pages
    d = prefix_delta(base)
    assert d.get("prefix.hit_blocks") == 2
    assert d.get("prefix.miss_blocks") == 1
    pool.free(hits)
    assert pool.audit() == []


def test_eviction_never_reclaims_live_then_typed_shed():
    base = telemetry.snapshot()
    geom = ("test-geom-evict",)
    pool = sd.PagePool(pages=4, page=4)
    live = pool.alloc(2)
    cached = pool.alloc(2)
    pool.publish(geom, list(zip(
        sd._chain_keys(list(range(8)), 4, geom), cached)))
    pool.free(cached)
    assert pool.stats()["cached"] == 2 and pool.free_pages() == 2
    got = pool.alloc(2)
    assert set(got) == set(cached) and set(got).isdisjoint(live)
    assert pool.ref(live[0]) == 1 and pool.ref(live[1]) == 1
    assert prefix_delta(base).get("prefix.evictions") == 2
    assert pool.holds(geom, sd._chain_keys(list(range(8)), 4, geom)) == 0
    with pytest.raises(sd.PagePoolExhausted) as ei:
        pool.alloc(1)
    assert isinstance(ei.value, tfaults.ShedError)
    assert pool.ref(live[0]) == 1
    pool.free(live)
    pool.free(got)
    assert pool.audit() == [] and pool.in_use() == 0


def test_fork_copies_the_page_and_releases_the_shared_one():
    pool = sd.PagePool(pages=4, page=2)
    geom = pool.register(1, 1, 2, device="cpu")
    k, v = pool.storage(geom)
    p = pool.alloc(1)[0]
    k[p] = 3.0
    v[p] = 4.0
    pool.lookup(geom, [])                      # nothing published yet
    pool.publish(geom, [(b"key", p)])
    assert pool.shared(p)
    new = pool.fork(geom, p)
    assert new != p and bool((k[new] == 3.0).all())
    assert bool((v[new] == 4.0).all())
    assert pool.ref(p) == 0 and pool.stats()["cached"] == 1
    pool.free([new])
    assert pool.audit() == []


def test_full_hit_prefills_once_and_cow_forks(engines):
    base = telemetry.snapshot()
    model, params = tiny()
    pool = sd.PagePool(pages=16, page=4)
    _made, make = engines
    eng = make(model, params, pool=pool, max_rows=4, name="pxfull")
    prompt = [3, 1, 4, 1, 5, 9, 2, 6]
    first = eng.generate(list(prompt), max_new_tokens=6)
    assert eng.stats()["prefills"] == 1
    second = eng.generate(list(prompt), max_new_tokens=6)
    assert eng.stats()["prefills"] == 1      # the repeat was a full hit
    oracle = sd.eager_generate(model, params, list(prompt), 6)
    assert first == oracle and second == oracle
    d = prefix_delta(base)
    assert d.get("prefix.hit_blocks", 0) >= 2
    assert d.get("prefix.cow_forks", 0) >= 1
    eng.close()
    assert pool.in_use() == 0 and pool.audit() == []


def test_partial_prefill_parity_vs_eager_oracle(engines):
    base = telemetry.snapshot()
    model, params = tiny()
    rm = rsd.TinyCausalLM(**CFG)
    rparams = rm.init_params(0)
    pool = sd.PagePool(pages=16, page=4)
    _made, make = engines
    eng = make(model, params, pool=pool, max_rows=4, name="pxpart")
    sys_prompt = [7, 2, 9, 4, 8, 1, 6, 3]
    pa = sys_prompt + [5, 5, 5]
    pb = sys_prompt + [11, 12]
    out_a = eng.generate(list(pa), max_new_tokens=5)
    hits_before = prefix_delta(base).get("prefix.hit_blocks", 0)
    out_b = eng.generate(list(pb), max_new_tokens=5)
    d = prefix_delta(base)
    assert d.get("prefix.hit_blocks", 0) - hits_before == 2
    assert eng.stats()["prefills"] == 2       # A full, B its suffix
    assert eng.stats()["programs"] >= 1
    assert out_a == sd.eager_generate(model, params, list(pa), 5)
    assert out_b == sd.eager_generate(model, params, list(pb), 5)
    assert out_b == rsd.eager_generate(rm, rparams, list(pb), 5)
    pool.clear_prefix_cache()
    assert out_b == eng.generate(list(pb), max_new_tokens=5)
    eng.close()
    assert pool.in_use() == 0 and pool.audit() == []


def test_prefix_probe_counts_resident_blocks(engines):
    model, params = tiny()
    pool = sd.PagePool(pages=16, page=4)
    _made, make = engines
    eng = make(model, params, pool=pool, max_rows=4, name="pxprobe")
    prompt = [2, 7, 1, 8, 2, 8, 1, 8]
    assert eng.prefix_probe(prompt) == 0
    eng.generate(list(prompt), max_new_tokens=3)
    assert eng.prefix_probe(prompt) == 2
    assert eng.prefix_probe(prompt[:4]) == 1
    assert pool.in_use() == 0 and pool.audit() == []


def test_knob_off_zero_counters_same_tokens(monkeypatch, engines):
    model, params = tiny()
    prompt = [4, 2, 4, 2, 4, 2, 4, 2]
    oracle = sd.eager_generate(model, params, prompt, 6)
    monkeypatch.setenv("MXNET_PREFIX_CACHE", "0")
    base = telemetry.snapshot()
    pool = sd.PagePool(pages=16, page=4)
    _made, make = engines
    eng = make(model, params, pool=pool, max_rows=4, name="pxoff")
    for _ in range(2):
        assert eng.generate(list(prompt), max_new_tokens=6) == oracle
    assert eng.stats()["prefills"] == 2
    assert eng.prefix_probe(prompt[:4]) == 0
    eng.close()
    assert prefix_delta(base) == {}
    assert pool.stats()["cached"] == 0 and pool.in_use() == 0
    assert pool.audit() == []


def test_shared_prompt_burst_hits_and_stays_token_exact(engines):
    """Many concurrent requests of one prompt: one physical prefill, the
    rest hits, every output token-exact."""
    import threading

    base = telemetry.snapshot()
    model, params = tiny(1)
    pool = sd.PagePool(pages=64, page=4)
    _made, make = engines
    eng = make(model, params, pool=pool, max_rows=8, name="pxburst")
    eng.warmup(max_len=16)
    prompt = list(range(3, 19))                # 4 full blocks
    oracle = sd.eager_generate(model, params, prompt, 5)
    assert eng.generate(list(prompt), max_new_tokens=5) == oracle
    outs = [None] * 6
    threads = [threading.Thread(target=lambda i=i: outs.__setitem__(
        i, eng.generate(list(prompt), max_new_tokens=5)))
        for i in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert all(o == oracle for o in outs)
    d = prefix_delta(base)
    assert d.get("prefix.hit_blocks", 0) >= 6 * 4
    assert eng.stats()["prefills"] == 1
    assert pool.in_use() == 0 and pool.audit() == []


def test_pool_storage_follows_the_engine_dtype():
    pool = sd.PagePool(pages=2, page=2)
    g = pool.register(1, 1, 4, dtype=torch.float32, device="cpu")
    assert g[-1] == "float32"
    assert pool.storage(g)[0].dtype == torch.float32

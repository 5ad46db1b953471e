"""Speculative decoding in the port's ``GenerativeEngine``
(``mxnet_tpu_torch/serving_decode.py``) against the JAX package's on the
CPU, at the reference test file's sizes (vocab 31, d_model 16, 2 heads,
max_seq 32; ``tests/test_serving_spec.py``):

- ``TinyCausalLM.decode_chunk`` teacher-forced on the reference's own
  inputs, logits and K/V within 1e-5 (fp32), and equal to successive
  ``decode`` calls within 1e-5;
- JAX's ``random.uniform`` bitwise on a grid of seeds and positions, and
  ``_sample_dist`` within 1e-6;
- ``high_agreement_pair``'s draws bitwise;
- the speculative engine against the reference's at a pinned ``spec_k``:
  greedy and seeded sampled tokens seed for seed, and the same rounds,
  proposals and accepted counts, for the high-agreement draft and a
  low-agreement one (which auto-disables); greedy against the port's
  non-spec path (``eager_generate``);
- the counterparts of the reference's spec tests
  (``test_serving_spec.py:260-404``) that need no router or remote
  replica: knob off means 0 spec dispatches, temperature 0 through the
  spec lane stays greedy, the low-agreement auto-disable, the
  ``decode_chunk`` / vocab ``ValueError``s; warm-up's program set and 0
  captures after it, ``auto`` k, page pressure, preemption, and no leaked
  or published draft page.

The ``cuda``-marked test runs the spec engine on the card as captured
graphs and skips without one.
"""
import functools
import threading

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import config as tconfig
from mxnet_tpu_torch import serving_decode as sd

from test_torch_package import LazyModule

# the reference, imported inside the tests that use it
rsd = LazyModule("mxnet_tpu.serving_decode")
jnp = LazyModule("jax.numpy")
jax = LazyModule("jax")

CFG = dict(vocab=31, d_model=16, n_heads=2, max_seq=32)
TOL = 1e-5          # fp32 logits and K/V against the reference
DIST_TOL = 1e-6     # sampling distributions: softmax in another order
CPU = "cpu"
JOIN_S = 120.0


@functools.lru_cache(maxsize=None)
def _pair(seed=0):
    return sd.high_agreement_pair(target_layers=2, draft_layers=1,
                                  seed=seed, device=CPU, **CFG)


@functools.lru_cache(maxsize=None)
def _ref_pair(seed=0):
    return rsd.high_agreement_pair(target_layers=2, draft_layers=1,
                                   seed=seed, **CFG)


@functools.lru_cache(maxsize=None)
def _low(seed=77):
    model = sd.TinyCausalLM(n_layers=1, **CFG)
    return model, model.init_params(seed, device=CPU)


@functools.lru_cache(maxsize=None)
def _ref_low(seed=77):
    model = rsd.TinyCausalLM(n_layers=1, **CFG)
    return model, model.init_params(seed)


def _np(x):
    return onp.asarray(x)


def _close(got, want, tol=TOL):
    want = _np(want)
    assert tuple(got.shape) == want.shape
    assert onp.abs(got.detach().numpy() - want).max() <= tol


def _run_threads(fns):
    threads = [threading.Thread(target=f) for f in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=JOIN_S)
    assert not any(t.is_alive() for t in threads), "a request thread hung"


@pytest.fixture
def spec_on(monkeypatch):
    monkeypatch.setenv("MXNET_SPEC_DECODE", "1")


@pytest.fixture
def engines():
    """Make spec engines on the CPU (each on its own pool unless given
    one); every one is closed at the end."""
    made = []

    def make(model, params, draft=None, dparams=None, pages=64, page=4,
             max_rows=4, warm=8, **kw):
        kw.setdefault("device", CPU)
        kw.setdefault("pool", sd.PagePool(pages=pages, page=page))
        eng = sd.GenerativeEngine(model, params=params, max_rows=max_rows,
                                  draft=draft, draft_params=dparams, **kw)
        made.append(eng)
        if warm:
            eng.warmup(max_len=warm)
        return eng

    try:
        yield make
    finally:
        for eng in made:
            eng.close()


# ---------------------------------------------------------------------------
# decode_chunk, uniform, _sample_dist, high_agreement_pair
# ---------------------------------------------------------------------------
def _ref_context(rm, rparams, prompts, c):
    """The reference's K/V of each prompt as a context (L, R, C, H, D),
    zero past each prompt."""
    L, H, D = rm.n_layers, rm.n_heads, rm.head_dim
    k_ctx = onp.zeros((L, len(prompts), c, H, D), onp.float32)
    v_ctx = onp.zeros_like(k_ctx)
    for r, p in enumerate(prompts):
        _l, k, v = rm.prefill(rparams, jnp.asarray(p, jnp.int32), len(p))
        k_ctx[:, r, :len(p)] = _np(k)
        v_ctx[:, r, :len(p)] = _np(v)
    return k_ctx, v_ctx


@pytest.mark.parametrize("s", [1, 3, 5])
def test_decode_chunk_teacher_forced_matches_reference(s):
    """Chunks of s tokens after prompts of three lengths, on the
    reference's own context: logits and the chunk's K/V within 1e-5."""
    target, tp, _d, _dp = _pair()
    rt, rtp, _rd, _rdp = _ref_pair()
    rng = onp.random.RandomState(s)
    prompts = [rng.randint(0, 31, size=n).tolist() for n in (2, 7, 13)]
    k_ctx, v_ctx = _ref_context(rt, rtp, prompts, 20)
    chunk = rng.randint(0, 31, size=(3, s))
    lengths = onp.array([len(p) for p in prompts])
    rl, rk, rv = rt.decode_chunk(rtp, jnp.asarray(chunk, jnp.int32),
                                 jnp.asarray(k_ctx), jnp.asarray(v_ctx),
                                 jnp.asarray(lengths, jnp.int32))
    logits, k, v = target.decode_chunk(
        tp, torch.from_numpy(chunk), torch.from_numpy(k_ctx),
        torch.from_numpy(v_ctx), torch.from_numpy(lengths))
    _close(logits, rl)
    _close(k, rk)
    _close(v, rv)


def test_decode_chunk_equals_successive_decodes():
    """The exactness contract: chunk position i equals the i-th of s
    successive ``decode`` calls, each writing its K/V into the context."""
    target, tp, _d, _dp = _pair()
    L, H, D = target.n_layers, target.n_heads, target.head_dim
    rng = onp.random.RandomState(0)
    c, s = 24, 4
    lengths = torch.tensor([3, 9])
    k_ctx = torch.from_numpy(rng.randn(L, 2, c, H, D).astype(onp.float32))
    v_ctx = torch.from_numpy(rng.randn(L, 2, c, H, D).astype(onp.float32))
    chunk = torch.from_numpy(rng.randint(0, 31, size=(2, s)))
    logits, k, v = target.decode_chunk(tp, chunk, k_ctx, v_ctx, lengths)
    kc, vc = k_ctx.clone(), v_ctx.clone()
    rows = torch.arange(2)
    for i in range(s):
        li, ki, vi = target.decode(tp, chunk[:, i], kc, vc, lengths + i)
        assert torch.allclose(logits[:, i], li, rtol=0, atol=TOL)
        assert torch.allclose(k[:, :, i], ki, rtol=0, atol=TOL)
        kc[:, rows, lengths + i] = ki
        vc[:, rows, lengths + i] = vi


SEEDS = (0, 1, 7, 12345, 2 ** 31 - 1)
POSITIONS = (0, 1, 5, 63, 511, 70000)


@pytest.mark.parametrize("seed", SEEDS)
def test_uniform_bitwise_vs_jax(seed):
    """JAX's float32 uniform on the accept-test keys ``fold_in(token_key(
    seed, pos), 1)``, one draw a key and 97 draws a key, bitwise."""
    for pos in POSITIONS:
        key = sd.fold_in(sd.token_key(seed, pos), 1)
        rkey = jax.random.fold_in(rsd.token_key(seed, pos), 1)
        assert onp.array_equal(key.numpy().astype(onp.uint32),
                               _np(jax.random.key_data(rkey)))
        one = sd.uniform(key)
        assert one.dtype == torch.float32 and one.shape == ()
        assert _np(one).view(onp.uint32) == _np(
            jax.random.uniform(rkey)).view(onp.uint32), (seed, pos)
        many = sd.uniform(key, 97).numpy()
        assert onp.array_equal(many.view(onp.uint32), _np(
            jax.random.uniform(rkey, (97,))).view(onp.uint32))
    # batched keys (the verify program's (R, k) grid), the same bits
    pos = torch.tensor([[3, 4, 5], [40, 41, 42]])
    keys = sd.fold_in(sd.token_key(torch.full((2, 1), seed), pos), 1)
    got = sd.uniform(keys)
    for i in range(2):
        for j in range(3):
            want = sd.uniform(sd.fold_in(sd.token_key(seed, int(pos[i, j])),
                                         1))
            assert torch.equal(got[i, j], want)


SPECS = [(0.0, 0, 1.0), (0.7, 0, 1.0), (1.0, 5, 1.0), (1.3, 0, 0.9),
         (0.8, 8, 0.6)]


@pytest.mark.parametrize("temp,top_k,top_p", SPECS)
def test_sample_dist_matches_reference(temp, top_k, top_p):
    logits = onp.random.RandomState(int(temp * 10) + top_k).randn(
        6, 64).astype(onp.float32) * 3
    logits[2, 7] = logits[2, 9] = logits[2].max() + 1       # a tie
    got = sd._sample_dist(torch.from_numpy(logits), temp, top_k, top_p)
    for r in range(6):
        want = _np(rsd._sample_dist(jnp.asarray(logits[r]), temp, top_k,
                                    top_p))
        assert onp.abs(got[r].numpy() - want).max() <= DIST_TOL, r
    # per-row arguments, as the programs pass them
    temps = torch.tensor([temp, 0.0] * 3)
    rows = sd._sample_dist(torch.from_numpy(logits), temps,
                           torch.full((6,), top_k), torch.full((6,), top_p))
    assert torch.equal(rows[1], torch.nn.functional.one_hot(
        torch.argmax(torch.from_numpy(logits[1])), 64).float())
    assert torch.equal(rows[0], got[0])


def test_high_agreement_pair_draws_bitwise():
    target, tp, draft, dp = _pair()
    rt, rtp, rd, rdp = _ref_pair()
    assert (target.n_layers, draft.n_layers) == (rt.n_layers, rd.n_layers)
    for ours, ref in ((tp, rtp), (dp, rdp)):
        for name in ("emb", "pos", "out"):
            assert onp.array_equal(ours[name].numpy(), _np(ref[name]))
        for lp, rlp in zip(ours["layers"], ref["layers"]):
            for name, t in lp.items():
                assert onp.array_equal(t.numpy(), _np(rlp[name])), name
    # shared tensors, and the target's extra layer is the identity
    assert tp["emb"] is dp["emb"] and tp["layers"][0] is dp["layers"][0]
    assert not tp["layers"][1]["wo"].any() and not tp["layers"][1]["w2"].any()


# ---------------------------------------------------------------------------
# the spec engine against the reference's
# ---------------------------------------------------------------------------
def _spec_stats(st):
    return {k: st[k] for k in ("spec_rounds", "spec_proposed",
                               "spec_accepted", "spec_disabled",
                               "decode_steps")}


def _ref_spec(draft_kind, prompt, n, spec):
    rt, rtp, rd, rdp = _ref_pair()
    if draft_kind == "low":
        rd, rdp = _ref_low()
    eng = rsd.GenerativeEngine(rt, params=rtp,
                               pool=rsd.PagePool(pages=64, page=4),
                               max_rows=4, name="ref", draft=rd,
                               draft_params=rdp, spec_k=3)
    try:
        eng.warmup(max_len=8)
        samp = None if spec is None else rsd.SamplingSpec(*spec)
        return eng.generate(prompt, max_new_tokens=n, sampling=samp), \
            _spec_stats(eng.stats())
    finally:
        eng.close()


@pytest.mark.parametrize("draft_kind,spec", [
    ("high", None), ("high", (0.8, 5, 0.9, 11)),
    ("low", None), ("low", (1.5, 0, 0.8, 3))])
def test_spec_engine_seed_for_seed_vs_reference(spec_on, engines,
                                                draft_kind, spec):
    """One request at spec_k 3 (so every round's schedule is the
    reference's): the same tokens, rounds, proposals and accepted counts
    (the n_acc of every round summed), greedy and seeded sampled, for the
    agreeing draft (every proposal accepted) and an independent one (the
    low-agreement draft: rejections, residual resamples, then the
    auto-disable after the probation rounds, where it trips)."""
    target, tp, draft, dp = _pair()
    if draft_kind == "low":
        draft, dp = _low()
    eng = engines(target, tp, draft, dp, spec_k=3)
    prompt = [3, 5, 7]
    samp = None if spec is None else sd.SamplingSpec(*spec)
    got = eng.generate(prompt, max_new_tokens=12, sampling=samp)
    want, rstats = _ref_spec(draft_kind, prompt, 12, spec)
    assert got == want
    stats = _spec_stats(eng.stats())
    assert stats == rstats
    assert stats["spec_rounds"] >= 3
    if draft_kind == "high":
        assert stats["spec_accepted"] == stats["spec_proposed"]
    else:
        assert stats["spec_accepted"] < stats["spec_proposed"]
    if spec is None:
        assert got == sd.eager_generate(target, tp, prompt, 12)


def test_spec_greedy_token_exact_high_agreement(spec_on, engines):
    """Counterpart of the reference's greedy pin: three concurrent
    requests token-exact against the target-only eager loop while
    speculation runs (rounds > 0, acceptance 1.0), both geometries' pages
    returned."""
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, spec_k=4)
    prompts = [[3, 5, 7], [1], [8, 2, 9, 4]]
    budgets = [8, 6, 7]
    res = [None] * 3
    _run_threads([lambda i=i: res.__setitem__(
        i, eng.generate(prompts[i], max_new_tokens=budgets[i]))
        for i in range(3)])
    for i in range(3):
        assert res[i] == sd.eager_generate(target, tp, prompts[i],
                                           budgets[i]), i
    st = eng.stats()
    assert st["spec_rounds"] > 0 and not st["spec_disabled"]
    assert st["spec_accepted"] == st["spec_proposed"] > 0
    assert st["spec_programs"] > 0
    assert eng.pool_in_use() == 0 and eng.pool_audit() == []


def test_spec_off_by_default_zero_spec_dispatches(engines, monkeypatch):
    """A draft attached with the knob unset: warm-up captures the spec
    grid, serving runs plain decode with 0 spec captures and dispatches,
    and the tokens are the draftless chain's."""
    monkeypatch.delenv("MXNET_SPEC_DECODE", raising=False)
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, spec_k=4)
    st0, sd0 = sd.spec_trace_count(), sd.spec_dispatch_count()
    out = eng.generate([2, 7, 1], max_new_tokens=5)
    assert out == sd.eager_generate(target, tp, [2, 7, 1], 5)
    assert eng.stats()["spec_rounds"] == 0
    assert sd.spec_trace_count() - st0 == 0
    assert sd.spec_dispatch_count() - sd0 == 0
    assert eng.pool_in_use() == 0


def test_spec_sampled_lane_temp_zero_stays_exact(spec_on, engines):
    """A temperature-0 spec with active filters rides the rejection
    sampling verify and stays the greedy chain; a hot spec speculates and
    emits in-vocab tokens."""
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, spec_k=4)
    g0 = eng.generate([6, 3], max_new_tokens=6,
                      sampling=sd.SamplingSpec(temperature=0.0, top_k=5,
                                               top_p=0.7, seed=31))
    assert g0 == sd.eager_generate(target, tp, [6, 3], 6)
    hot = eng.generate([6, 3], max_new_tokens=6,
                       sampling=sd.SamplingSpec(temperature=1.1, top_k=7,
                                                top_p=0.95, seed=31))
    assert len(hot) == 6 and all(0 <= t < 31 for t in hot)
    assert eng.stats()["spec_rounds"] > 0
    assert eng.pool_in_use() == 0


def test_spec_low_agreement_auto_disables_stream_stays_exact(spec_on,
                                                             engines):
    target, tp, _d, _dp = _pair()
    low, lp = _low()
    before = sd._SPEC_STATS["autodisabled"]
    eng = engines(target, tp, low, lp, spec_k=4)
    out = eng.generate([5, 1, 3], max_new_tokens=12)
    assert out == sd.eager_generate(target, tp, [5, 1, 3], 12)
    st = eng.stats()
    assert st["spec_disabled"] is True
    assert st["spec_rounds"] >= 4
    assert st["spec_accepted"] < st["spec_proposed"]
    assert sd._SPEC_STATS["autodisabled"] == before + 1
    assert eng.pool_in_use() == 0 and eng.pool_audit() == []


def test_spec_requires_decode_chunk_and_matching_vocab():
    target, tp, draft, dp = _pair()
    pool = sd.PagePool(pages=8, page=4)
    other = sd.TinyCausalLM(vocab=13, d_model=16, n_layers=1, n_heads=2,
                            max_seq=32)
    with pytest.raises(ValueError, match="vocab"):
        sd.GenerativeEngine(target, params=tp, pool=pool, device=CPU,
                            draft=other,
                            draft_params=other.init_params(device=CPU))

    class NoChunk(sd.TinyCausalLM):
        decode_chunk = None

    plain = NoChunk(n_layers=2, **CFG)
    with pytest.raises(ValueError, match="decode_chunk"):
        sd.GenerativeEngine(plain, params=tp, pool=pool, device=CPU,
                            draft=draft, draft_params=dp)
    # the reference refuses the same two
    with pytest.raises(ValueError):
        rsd.GenerativeEngine(_ref_pair()[0], params=_ref_pair()[1],
                             pool=rsd.PagePool(pages=8, page=4),
                             draft=rsd.TinyCausalLM(vocab=13, d_model=16,
                                                    n_layers=1, n_heads=2,
                                                    max_seq=32))


@pytest.mark.parametrize("spec_k,verifies", [("2", 1), ("auto", 4)])
def test_spec_warmup_program_set_and_no_capture_after(spec_on, engines,
                                                      monkeypatch, spec_k,
                                                      verifies):
    """``warmup`` captures a draft prefill per bucket, ONE draft round and
    a verify per k the arbiter can pick (the knob MXNET_SPEC_K here); a
    mixed storm after it captures nothing, and every request is exact."""
    monkeypatch.setenv("MXNET_SPEC_K", spec_k)
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, warm=0)
    buckets = [1, 2, 4, 8]
    spec = len(buckets) + 1 + verifies
    assert eng.warmup(max_len=8) == len(buckets) + 1 + spec
    assert eng.stats()["spec_programs"] == spec
    assert eng.warmup(max_len=8) == 0
    t0, st0 = sd.trace_count(), sd.spec_trace_count()
    d0 = sd.spec_dispatch_count()
    prompts = [[1, 2, 3], [4], [5, 6, 7, 8, 9], [2, 2]]
    samps = [None, sd.SamplingSpec(0.9, seed=4), None,
             sd.SamplingSpec(1.2, top_k=5, seed=8)]
    res = [None] * 4
    _run_threads([lambda i=i: res.__setitem__(i, eng.generate(
        prompts[i], max_new_tokens=9, sampling=samps[i])) for i in range(4)])
    for i in (0, 2):
        assert res[i] == sd.eager_generate(target, tp, prompts[i], 9)
    st = eng.stats()
    assert sd.trace_count() == t0 and sd.spec_trace_count() == st0
    assert st["spec_rounds"] > 0
    # two dispatches a round, plus the draft prefills
    assert sd.spec_dispatch_count() - d0 >= 2 * st["spec_rounds"]
    assert eng.pool_in_use() == 0 and eng.pool_audit() == []


def test_spec_k_knob_is_validated(spec_on, engines, monkeypatch):
    monkeypatch.setenv("MXNET_SPEC_K", "0")
    with pytest.raises(ValueError):
        tconfig.get("MXNET_SPEC_K")
    monkeypatch.setenv("MXNET_SPEC_K", "3")
    assert tconfig.get("MXNET_SPEC_K") == "3"
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, warm=0, spec_k="x")
    with pytest.raises(ValueError, match="spec_k"):
        eng.warmup(max_len=4)


def test_spec_page_shortage_skips_the_round(spec_on, engines):
    """Speculation is opportunistic: on a pool too small for the draft's
    and the verify's pages the round is skipped (counted), plain decode
    carries on, and the tokens stay exact."""
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, pages=8, page=4, spec_k=4)
    out = eng.generate([1, 2, 3, 4, 5, 6, 7], max_new_tokens=12)
    assert out == sd.eager_generate(target, tp, [1, 2, 3, 4, 5, 6, 7], 12)
    st = eng.stats()
    assert st["spec_fallbacks"] > 0 and st["decode_steps"] > 0
    assert eng.pool_in_use() == 0 and eng.pool_audit() == []


def test_spec_preemption_releases_draft_pages(spec_on, engines):
    """Pool pressure preempts a sequence that holds draft pages: both its
    page tables return to the pool, and both requests finish exact."""
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, pages=14, page=4, max_rows=2,
                  spec_k=2)
    prompts = [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1, 8, 2, 8, 1, 8]]
    res = [None] * 2
    _run_threads([lambda i=i: res.__setitem__(
        i, eng.generate(prompts[i], max_new_tokens=18)) for i in range(2)])
    for i in range(2):
        assert res[i] == sd.eager_generate(target, tp, prompts[i], 18), i
    st = eng.stats()
    assert st["spec_rounds"] > 0 and st["preempts"] + st[
        "spec_fallbacks"] > 0
    assert eng.pool_in_use() == 0 and eng.pool_audit() == []


def test_spec_dispatch_error_reaches_the_requests(spec_on, engines):
    """A draft round that fails raises to the round's requests (no quiet
    fall back to plain decode); the engine's pages all return."""
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, warm=0, spec_k=2)

    def broken(kmax, form="full"):
        def fn(*args):
            raise RuntimeError("draft round failed")
        return fn

    eng._draft_round_fn = broken
    with pytest.raises(RuntimeError, match="draft round failed"):
        eng.generate([1, 2, 3], max_new_tokens=6)
    assert not eng.stats()["spec_disabled"]
    assert eng.pool_in_use() == 0 and eng.pool_audit() == []


def test_draft_pages_never_published(spec_on, engines):
    """Draft KV pages are never content-addressed: after a spec request
    the prefix index holds only target pages, and a repeat of the prompt
    hits them and stays exact."""
    target, tp, draft, dp = _pair()
    eng = engines(target, tp, draft, dp, spec_k=4)
    pool = eng._pool
    prompt = list(range(1, 10))
    first = eng.generate(prompt, max_new_tokens=6)
    geoms = {geom for geom, _key in pool._page_key.values()}
    assert geoms == {eng._geom}
    assert eng.generate(prompt, max_new_tokens=6) == first == \
        sd.eager_generate(target, tp, prompt, 6)
    assert eng.pool_in_use() == 0 and eng.pool_audit() == []


def test_spec_engine_defaults_to_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    target, tp, draft, dp = _pair()
    with pytest.raises(RuntimeError, match="CUDA"):
        sd.high_agreement_pair(target_layers=2, draft_layers=1, **CFG)
    with pytest.raises(RuntimeError, match="CUDA"):
        sd.GenerativeEngine(target, params=tp, draft=draft,
                            draft_params=dp,
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
def test_spec_engine_on_card(cuda_device, monkeypatch):
    """The spec engine on the card as captured graphs: greedy requests
    token-exact against the eager loop on the card, acceptance 1.0, 0
    captures after warm-up, no leaked page; and a seeded sampled request
    equal to the same engine's arithmetic on the CPU."""
    monkeypatch.setenv("MXNET_SPEC_DECODE", "1")
    target, tp, draft, dp = sd.high_agreement_pair(
        target_layers=4, draft_layers=1, device=cuda_device, **CFG)
    pool = sd.PagePool(pages=64, page=4)
    eng = sd.GenerativeEngine(target, params=tp, pool=pool, max_rows=4,
                              name="card", draft=draft, draft_params=dp,
                              spec_k=4, device=cuda_device)
    try:
        eng.warmup(max_len=8)
        t0, st0 = sd.trace_count(), sd.spec_trace_count()
        rng = onp.random.RandomState(2)
        prompts = [rng.randint(0, 31, size=rng.randint(2, 9)).tolist()
                   for _ in range(6)]
        res = [None] * 6
        _run_threads([lambda i=i: res.__setitem__(
            i, eng.generate(prompts[i], max_new_tokens=12))
            for i in range(6)])
        for i in range(6):
            assert res[i] == sd.eager_generate(target, tp, prompts[i], 12)
        st = eng.stats()
        assert st["spec_rounds"] > 0
        assert st["spec_accepted"] == st["spec_proposed"]
        assert sd.trace_count() == t0 and sd.spec_trace_count() == st0
        assert pool.in_use() == 0 and eng.pool_audit() == []
    finally:
        eng.close()

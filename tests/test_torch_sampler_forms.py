"""The sampler's program forms (``serving_decode.FORMS``): each form gives
the rows it is chosen for the full sampler's tokens and distributions
bitwise, so that the decode step, the draft round and verify can skip the
sampler when every row is greedy without changing a result; and the forms'
programs in the engine, captured at warm-up, keep a mixed storm
token-exact against the eager loop.

The full sampler itself is held to the JAX package's in
``test_torch_serving_decode.py`` and ``test_torch_serving_spec.py``.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import serving_decode as sd

V = 64


def _logits(seed, *lead):
    rng = onp.random.RandomState(seed)
    # peaked rows too, where a tail token's mass is below fp32's ulp of 1
    x = rng.randn(*lead, V).astype(onp.float32) * rng.choice(
        [1.0, 8.0, 30.0], size=lead + (1,)).astype(onp.float32)
    return torch.from_numpy(x)


def _rows(specs):
    args = [sd._sampling_args(s) for s in specs]
    return (torch.tensor([a[0] for a in args]),
            torch.tensor([int(a[1]) for a in args], dtype=torch.int64),
            torch.tensor([a[2] for a in args]),
            torch.tensor([int(a[3]) for a in args], dtype=torch.int64))


SPECS = {
    "greedy": [None, sd.GREEDY, sd.SamplingSpec(0.0, top_k=5, seed=3)],
    "full": [sd.SamplingSpec(0.9, top_k=5, seed=2),
             sd.SamplingSpec(1.1, top_p=0.8, seed=4), None,
             sd.SamplingSpec(0.7, seed=1), sd.SamplingSpec(0.0, top_k=4)],
}


@pytest.mark.parametrize("form", sd.FORMS)
def test_sampling_form_is_the_cheapest_that_fits(form):
    assert sd.sampling_form(SPECS[form]) == form
    assert sd.sampling_form([]) == "greedy"


@pytest.mark.parametrize("form", sd.FORMS)
def test_each_form_equals_the_full_sampler_bitwise(form):
    for seed in range(6):
        logits = _logits(seed, len(SPECS[form]))
        temps, top_ks, top_ps, seeds = _rows(SPECS[form])
        keys = sd.token_key(seeds, torch.tensor(7 + seed))
        tok, dist = sd._sample(logits, temps, top_ks, top_ps, keys, form,
                               dist=True)
        assert torch.equal(tok, sd.sample_token(logits, temps, top_ks,
                                                top_ps, keys))
        assert torch.equal(dist, sd._sample_dist(logits, temps, top_ks,
                                                 top_ps))
        assert torch.equal(
            sd._sample_dist(logits, temps, top_ks, top_ps, form), dist)


@pytest.mark.parametrize("form", sd.FORMS)
def test_verify_forms_equal_the_full_rejection_sample(form):
    r, k = len(SPECS[form]), 3
    temps, top_ks, top_ps, seeds = _rows(SPECS[form])
    for seed in range(6):
        logits = _logits(100 + seed, r, k + 1)
        dlogits = _logits(200 + seed, r, k)
        lengths = torch.arange(r, dtype=torch.int64) + 5
        keys = sd.fold_in(sd.token_key(seeds[:, None],
                                       lengths[:, None] + 1
                                       + torch.arange(k)), 3)
        props, q = sd._sample(dlogits, temps[:, None].expand(r, k),
                              top_ks[:, None].expand(r, k),
                              top_ps[:, None].expand(r, k), keys, "full",
                              dist=True)
        props = props.long()
        if seed % 2:
            props[:, 0] = torch.argmax(logits[:, 0], -1)   # an acceptance
        want = sd._rejection_sample(logits, props, lengths, q, temps,
                                    top_ks, top_ps, seeds)
        qf = None if form == "greedy" else q
        got = sd._rejection_sample(logits, props, lengths, qf, temps,
                                   top_ks, top_ps, seeds, form=form)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_engine_runs_each_form_captured_at_warmup(monkeypatch):
    """Greedy, unfiltered and filtered requests through one spec engine:
    both forms' decode, draft-round and verify program captured at
    warm-up (none after), and the greedy stream token-exact against the
    eager loop. (A sampled stream's tokens depend on the round schedule,
    which the arbiter's timing sets: the seed-for-seed parity runs pin it,
    ``test_torch_serving_spec.py``.)"""
    monkeypatch.setenv("MXNET_SPEC_DECODE", "1")
    target, tp, draft, dp = sd.high_agreement_pair(
        vocab=V, d_model=16, target_layers=2, draft_layers=1, n_heads=2,
        max_seq=32, seed=0, device="cpu")

    def engine():
        return sd.GenerativeEngine(target, params=tp,
                                   pool=sd.PagePool(pages=64, page=4),
                                   draft=draft, draft_params=dp, spec_k=2,
                                   max_rows=2, device="cpu")

    reqs = [([1, 2, 3], None), ([4, 5], sd.SamplingSpec(0.8, seed=3)),
            ([6, 7, 8], sd.SamplingSpec(0.9, top_k=5, seed=5))]
    with engine() as eng:
        eng.warmup(max_len=8)
        st = eng.stats()
        assert st["program_forms"] == st["programs"] + st["spec_programs"] \
            + (len(sd.FORMS) - 1) * (1 + 1 + 1)  # decode, round, verify
        t0, s0 = sd.trace_count(), sd.spec_trace_count()
        got = [eng.generate(p, 6, sampling=s) for p, s in reqs]
        assert sd.trace_count() == t0 and sd.spec_trace_count() == s0
        assert eng.stats()["spec_rounds"] > 0
    assert [len(g) for g in got] == [6, 6, 6]
    assert got[0] == sd.eager_generate(target, tp, [1, 2, 3], 6)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("form", sd.FORMS)
def test_each_form_equals_the_full_sampler_on_card(cuda_device, form):
    """The forms bitwise the full sampler on CUDA tensors too (where the
    fp32 cumsum of the keep mask runs in fp32, not fp64 as on the CPU)."""
    for seed in range(6):
        logits = _logits(seed, len(SPECS[form])).to(cuda_device)
        temps, top_ks, top_ps, seeds = (t.to(cuda_device)
                                        for t in _rows(SPECS[form]))
        keys = sd.token_key(seeds, torch.tensor(7 + seed,
                                                device=cuda_device))
        tok, dist = sd._sample(logits, temps, top_ks, top_ps, keys, form,
                               dist=True)
        assert torch.equal(tok, sd.sample_token(logits, temps, top_ks,
                                                top_ps, keys))
        assert torch.equal(dist, sd._sample_dist(logits, temps, top_ks,
                                                 top_ps))

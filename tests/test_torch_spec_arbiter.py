"""The speculative arbiter of the port's ``GenerativeEngine`` against the
JAX package's on the same cost tables (``serving_decode``: the per-round
engage test ``(E_acc + 1) * t_target > t_draft + t_verify`` over the
EMAs, ``MXNET_SPEC_K=auto``'s choice of k over the acceptance-rate EMA,
and the fallback count), on the CPU.

Both engines hold the same pair and draft (``tests/test_serving_spec.py``
sizes) and are not warmed up: each draw writes one cost table (entries
measured or missing, timings and acceptance drawn from a seeded numpy
generator) and one acceptance-rate EMA into both, and the two arbiters
must take the same decision. The sticky low-acceptance cutoff and the
rounds themselves are held by ``test_torch_serving_spec.py``'s
seed-for-seed runs.
"""
import numpy as onp
import pytest

from mxnet_tpu_torch import serving_decode as sd

from test_torch_package import LazyModule

rsd = LazyModule("mxnet_tpu.serving_decode")

CFG = dict(vocab=31, d_model=16, n_heads=2, max_seq=32)
DRAWS = 400


def _engines(spec_k):
    target, tp, draft, dp = sd.high_agreement_pair(
        target_layers=2, draft_layers=1, seed=0, device="cpu", **CFG)
    rt, rtp, rd, rdp = rsd.high_agreement_pair(
        target_layers=2, draft_layers=1, seed=0, **CFG)
    port = sd.GenerativeEngine(target, params=tp, max_rows=2, draft=draft,
                               draft_params=dp, spec_k=spec_k, device="cpu",
                               pool=sd.PagePool(pages=16, page=4))
    ref = rsd.GenerativeEngine(rt, params=rtp, max_rows=2, draft=rd,
                               draft_params=rdp, spec_k=spec_k,
                               pool=rsd.PagePool(pages=16, page=4))
    return port, ref


def _table(rng):
    """A cost table as the engines keep it (seconds; acceptance in
    tokens a row), each entry measured or not."""
    table = {}
    if rng.rand() < 0.9:
        table["decode"] = rng.uniform(1e-4, 5e-3)
    if rng.rand() < 0.9:
        table[("spec", "draft")] = rng.uniform(1e-4, 5e-3)
    for k in range(1, 5):
        if rng.rand() < 0.8:
            table[("spec_verify", k)] = rng.uniform(1e-4, 8e-3)
    if rng.rand() < 0.8:
        table[("spec", "acc")] = rng.uniform(0.0, 4.0)
    beta = None if rng.rand() < 0.15 else float(rng.uniform(0.0, 1.0))
    return table, beta


@pytest.mark.parametrize("spec_k", ["auto", "3", "4"])
def test_arbiter_takes_the_reference_decisions(spec_k, monkeypatch):
    monkeypatch.setenv("MXNET_SPEC_DECODE", "1")
    port, ref = _engines(spec_k)
    rng = onp.random.RandomState({"auto": 0, "3": 1, "4": 2}[spec_k])
    try:
        decisions = []
        for _ in range(DRAWS):
            table, beta = _table(rng)
            for eng in (port, ref):
                eng._cost = dict(table)
                eng._spec_acc_ema = beta
            got = (port._spec_should_engage(), port._spec_auto_k())
            want = (ref._spec_should_engage(), ref._spec_auto_k())
            assert got == want, (table, beta)
            decisions.append(got[0])
        assert port.stats()["spec_fallbacks"] == \
            ref.stats()["spec_fallbacks"]
        # the draws reach both outcomes, and under auto several k
        assert 0 in decisions and any(d > 0 for d in decisions)
        if spec_k == "auto":
            assert len({d for d in decisions if d}) >= 3
    finally:
        port.close()
        ref.close()


def test_disabled_or_knob_off_never_engages(monkeypatch):
    port, ref = _engines("auto")
    try:
        monkeypatch.setenv("MXNET_SPEC_DECODE", "0")
        assert port._spec_should_engage() == ref._spec_should_engage() == 0
        monkeypatch.setenv("MXNET_SPEC_DECODE", "1")
        assert port._spec_should_engage() == ref._spec_should_engage() == 4
        port._spec_disabled = ref._spec_disabled = True
        assert port._spec_should_engage() == ref._spec_should_engage() == 0
    finally:
        port.close()
        ref.close()

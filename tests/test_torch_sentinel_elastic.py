"""The port's integrity sentinel, checkpoints and elastic loop on the CPU,
against the reference where the reference runs here:

- ``sentinel.tree_digest`` bitwise the reference's on fp32, bf16, fp16,
  int32, bool and empty leaves and on a narrow ResNet's converted
  parameters; ``Window`` verdicts equal to the reference's on seeded
  series; the compiled step's digest form (parameters after a sentinel
  step bitwise those after a plain step, every digest bitwise
  ``tree_digest`` of the same state, one capture per form, one dispatch a
  step); the verdict paths of ``run_elastic`` (cadence, the pre-save
  flush, the ``sentinel.rollback`` site), the cross-rank vote, the
  quarantine and its exclusion of devices;
- ``CheckpointManager`` (round trip, retention, partial multi-rank steps,
  the digest sidecar, copy-on-write snapshots, stale temp files) and
  ``run_elastic`` (crash and resume, the step-0 anchor, backoff budget,
  ``__graft_entry__.py``'s small LM with its simulated rank death:
  bitwise the port's uninterrupted run and within 2e-4 of the
  reference's); ``Trainer.save_states`` / ``load_states`` and the state
  tree; the cooperative preemption drain; and a SIGTERM drill in real
  processes on a narrow ResNet (``tools/torch_elastic_drill.py``), ending
  bitwise equal to the uninterrupted run.

Mirrors ``tests/test_sentinel.py``, ``test_elastic.py`` and
``test_preemption.py`` (their drain and checkpoint cases).
"""
import json
import os
import subprocess
import sys
import time

import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_step as tcs
from mxnet_tpu_torch import engine, faults, preemption, sentinel, telemetry
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel.elastic import (CheckpointManager,
                                              DigestMismatch,
                                              HeartbeatMonitor,
                                              nonfinite_anomaly, run_elastic)

from test_torch_cached_step import OPT, _batch, _loss, _net
from test_torch_package import LazyModule

jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
jsentinel = LazyModule("mxnet_tpu.sentinel")
jmodels = LazyModule("mxnet_tpu.models")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LM_TOL = 2e-4


def _bf16(a):
    import ml_dtypes

    return a.astype(ml_dtypes.bfloat16)


def _torch_leaf(a):
    """A numpy leaf as the port's tensor (bf16 through fp32)."""
    import ml_dtypes

    if a.dtype == ml_dtypes.bfloat16:
        return torch.from_numpy(a.astype(onp.float32)).to(torch.bfloat16)
    return torch.from_numpy(onp.ascontiguousarray(a))


DIGEST_TREES = {
    "fp32": lambda r: {"w": r.randn(33, 7).astype(onp.float32)},
    "bf16": lambda r: {"w": _bf16(r.randn(65).astype(onp.float32))},
    "fp16": lambda r: [r.randn(5, 5).astype(onp.float16)],
    "int32": lambda r: {"i": r.randint(-2 ** 31, 2 ** 31 - 1, 40,
                                       dtype=onp.int64).astype(onp.int32)},
    "bool": lambda r: {"m": r.rand(17) > 0.5},
    "empty": lambda r: {"e": onp.zeros((0, 4), onp.float32),
                        "w": r.randn(3).astype(onp.float32)},
    "mixed": lambda r: {"a": [r.randn(4).astype(onp.float32),
                              (r.randint(0, 9, 3).astype(onp.int32),)],
                        "b": None, "c": onp.float32(2.5)},
}


@pytest.mark.parametrize("kind", sorted(DIGEST_TREES))
def test_tree_digest_bitwise_reference(kind):
    tree = DIGEST_TREES[kind](onp.random.RandomState(3))
    want = jsentinel.tree_digest(tree)
    got = sentinel.tree_digest(jax.tree_util.tree_map(
        lambda a: _torch_leaf(onp.asarray(a)), tree))
    assert got == want
    # the batched per-leaf folds are the one-leaf fold's
    ts = [sentinel._as_tensor(_torch_leaf(onp.asarray(a)))
          for a in jax.tree_util.tree_leaves(tree)]
    assert [int(f) for f in sentinel._leaf_folds(ts)] == \
        [int(sentinel._fold_leaf(t)) for t in ts]
    # a single flipped bit moves it
    leaves = [x for x in jax.tree_util.tree_leaves(tree)
              if onp.asarray(x).size]
    flip = onp.array(leaves[0], copy=True).reshape(-1)
    raw = flip.view(onp.uint8)
    raw[0] ^= 1
    assert sentinel.fold_leaves([_torch_leaf(flip)]) != \
        sentinel.fold_leaves([_torch_leaf(onp.asarray(leaves[0])
                                          .reshape(-1))])


@pytest.mark.parametrize("chunk", [7, 1000])
def test_chunked_fold_bitwise_reference(chunk, monkeypatch):
    """Leaves cut across the fold's chunks (one leaf over several, several
    in one) fold as the one-leaf fold and the reference do."""
    monkeypatch.setattr(sentinel, "_FOLD_CHUNK", chunk)
    r = onp.random.RandomState(5)
    tree = {"a": r.randn(3, 50).astype(onp.float32),
            "b": r.randn(5).astype(onp.float32),
            "c": _bf16(r.randn(600)), "d": r.randn(1).astype(onp.float32),
            "e": r.randint(0, 99, 1500).astype(onp.int32)}
    ts = [sentinel._as_tensor(_torch_leaf(onp.asarray(a)))
          for a in jax.tree_util.tree_leaves(tree)]
    assert [int(f) for f in sentinel._leaf_folds(ts)] == \
        [int(sentinel._fold_leaf(t)) for t in ts]
    assert sentinel.tree_digest(jax.tree_util.tree_map(
        lambda a: _torch_leaf(onp.asarray(a)), tree)) == \
        jsentinel.tree_digest(tree)


def test_tree_digest_of_narrow_resnet_params():
    net = _net()
    params = {k: p.data().detach().numpy().copy()
              for k, p in net.collect_params().items()}
    assert sentinel.tree_digest({k: torch.from_numpy(v)
                                 for k, v in params.items()}) == \
        jsentinel.tree_digest(params)


def test_window_verdicts_match_reference():
    rng = onp.random.RandomState(11)
    series = list(onp.abs(rng.randn(60)) + 5.0)
    series[20] = 400.0
    series[41] = float("nan")
    series[50] = float("inf")
    for zmax in (3.0, 6.0):
        a, b = sentinel.Window(zmax=zmax), jsentinel.Window(zmax=zmax)
        assert [a.update(v) for v in series] == \
            [b.update(v) for v in series]
        assert (a.mean, a.var, a.count) == (b.mean, b.var, b.count)


def test_sentinel_observe_loss_trips_window():
    snt = sentinel.Sentinel(every=1)
    for v in (4.0, 3.5, 3.1, 2.8):
        snt.observe_loss(v)
    snt.observe_loss(4e6)
    assert snt()
    assert snt.last_rollback["reason"] == "loss_anomaly"


DIGEST_OPTS = {"sgd": dict(OPT),
               "adam": {"learning_rate": 1e-3, "wd": 1e-4}}


def _run_steps(every, n=6, opt="sgd"):
    with tmx.cpu():
        net = _net()
        tr = tgluon.Trainer(net.collect_params(), opt,
                            dict(DIGEST_OPTS[opt]))
        step = tr.compile_step(net, _loss)
        snt = sentinel.Sentinel(step=step, every=every) if every else None
        clones = []
        tcs.reset_counters()
        for i in range(n):
            x, y = _batch(seed=i)
            step(x, y)
            if every and (i + 1) % every == 0:
                clones.append([t.detach().clone()
                               for t in step.digest_leaves()])
        engine.waitall()
    return net, tr, snt, clones


@pytest.mark.parametrize("opt", sorted(DIGEST_OPTS))
def test_digest_form_in_the_compiled_step(opt):
    plain, tr0, _s, _c = _run_steps(0, opt=opt)
    assert (tcs.trace_count(), tcs.dispatch_count()) == (1, 6)
    d0 = telemetry.get("sentinel.digests").value
    net, tr, snt, clones = _run_steps(2, opt=opt)
    # both forms captured at the first call, one dispatch a step
    assert (tcs.trace_count(), tcs.dispatch_count()) == (2, 6)
    assert telemetry.get("sentinel.digests").value - d0 == 3
    for a, b in zip(plain.collect_params().values(),
                    net.collect_params().values()):
        assert torch.equal(a.data(), b.data())
    # every optimizer state leaf (Adam's (mean, var) pairs) and device
    # scalar (Adam's step count) too
    sa = tcs._state_leaves(tr0._init_states())
    sb = tcs._state_leaves(tr._init_states())
    assert len(sa) == len(sb) > 0
    assert all(torch.equal(a, b) for a, b in zip(sa, sb))
    for dev, sc in tr0._optimizer._scalars.items():
        for k, v in sc.items():
            assert torch.equal(v, tr._optimizer._scalars[dev][k]), k
    n_w = len(tr._params)
    for rec, state in zip(snt.history, clones):
        assert rec["fold"] == sentinel.tree_digest(state)
        psum = sum(float(t.double().sum()) for t in state[:n_w])
        assert rec["psum"] == pytest.approx(psum, rel=1e-5)
        assert onp.isfinite(rec["gnorm"]) and rec["gnorm"] > 0


def _host_step(state, b):
    return {"w": state["w"] + b, "i": state["i"] + 1}


def test_anomaly_fn_cadence_routing(tmp_path):
    calls = []

    def det(state):
        calls.append(int(state["i"]))
        return False
    det.every = 3
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=False)
    run_elastic(_host_step, {"w": onp.float32(0), "i": onp.int64(0)},
                [onp.float32(1)] * 9, mgr, save_every=5, anomaly_fn=det)
    assert calls == [3, 6, 9]
    mgr.close()


def test_presave_flush_gates_tainted_checkpoint(tmp_path):
    class Det:
        every = 10 ** 9
        trips = [False, True, False, False, False]

        def __call__(self, state):
            return False

        def flush(self):
            return self.trips.pop(0) if self.trips else False

    mgr = CheckpointManager(str(tmp_path / "c"), async_save=False)
    out, steps, restarts = run_elastic(
        _host_step, {"w": onp.float32(0), "i": onp.int64(0)},
        [onp.float32(1)] * 12, mgr, save_every=4, max_restarts=2,
        anomaly_fn=Det())
    assert steps == 12 and restarts == 1 and float(out["w"]) == 12.0
    evs = telemetry.events(kind="restart", name="elastic")
    assert any(e.get("step") == 4 and e.get("replay") == 4 for e in evs)
    mgr.close()


def test_sentinel_rollback_site_drives_restore(tmp_path, monkeypatch):
    monkeypatch.setattr(faults, "_sleep", lambda s: None)
    snt = sentinel.Sentinel(every=1)
    mgr = CheckpointManager(str(tmp_path / "c"), async_save=False)
    with faults.active(faults.FaultPlan().fail("sentinel.rollback",
                                               after=6)):
        out, steps, restarts = run_elastic(
            _host_step, {"w": onp.float32(0), "i": onp.int64(0)},
            [onp.float32(1)] * 10, mgr, save_every=3, max_restarts=2,
            anomaly_fn=snt)
    assert steps == 10 and restarts == 1 and float(out["w"]) == 10.0
    mgr.close()


def test_vote_names_and_quarantines_a_divergent_rank(tmp_path,
                                                     monkeypatch):
    snt = sentinel.Sentinel(every=1, directory=str(tmp_path))
    monkeypatch.setattr(sentinel, "_rank_values", lambda v: [v, v + 1, v])
    snt.offer(torch.tensor(5, dtype=torch.int64), torch.tensor(1.0),
              torch.tensor(1.0))
    assert snt.flush()
    assert snt.last_vote["suspects"] == [1]
    assert snt.last_rollback["reason"] == "replica_divergence"
    q = sentinel.Quarantine(str(tmp_path / "quarantine.json"))
    assert q.ranks() == [1]
    sentinel.install_quarantine(None)


def test_quarantine_persists_and_excludes_devices(tmp_path):
    path = str(tmp_path / "q" / "quarantine.json")
    q = sentinel.Quarantine(path)
    assert q.add_device(1, "replica divergence")
    assert not q.add_device(1, "again")
    assert sentinel.Quarantine(path).device_ids() == [1]
    devices = [torch.device("cuda", i) for i in range(4)]
    try:
        sentinel.install_quarantine(q)
        kept = tmesh.admitted_devices(devices)
        assert [d.index for d in kept] == [0, 2, 3]
        assert any(e["name"] == "spmd.quarantine_excluded"
                   for e in telemetry.events(kind="corruption"))
        for i in (0, 2, 3):
            q.add_device(i)
        with pytest.warns(UserWarning, match="quarantined"):
            assert tmesh.admitted_devices(devices) == devices
    finally:
        sentinel.install_quarantine(None)
    assert sentinel.quarantine_ranks([3]) == 0


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

def test_checkpoint_roundtrip_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    tree = {"w": torch.arange(6.0).reshape(2, 3), "step": onp.int64(7),
            "nested": [torch.ones(4, dtype=torch.bfloat16),
                       onp.zeros((2, 2))]}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    out, step = mgr.restore()
    assert step == 4 and out["step"] == 7
    assert torch.equal(out["w"], tree["w"])
    assert out["nested"][0].dtype == torch.bfloat16
    mgr.close()


def test_restore_skips_partial_multirank_step(tmp_path, monkeypatch):
    from mxnet_tpu_torch.parallel import elastic as tel

    mgr = CheckpointManager(str(tmp_path), keep=3, async_save=False)
    for r in (0, 1):
        monkeypatch.setattr(tel, "_world", lambda r=r: (r, 2))
        mgr.save(5, {"w": torch.arange(4.0)})
    monkeypatch.setattr(tel, "_world", lambda: (1, 2))
    mgr.save(6, {"w": torch.arange(4.0) + 1})
    assert mgr.complete_steps() == [5] and mgr.latest_step() == 5
    monkeypatch.setattr(tel, "_world", lambda: (0, 2))
    out, step = mgr.restore()
    assert step == 5 and torch.equal(out["w"], torch.arange(4.0))
    mgr.close()


def test_corrupted_latest_digest_fallback(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=5, async_save=False)
    mgr.save(1, {"w": torch.arange(4.0)}, block=True)
    mgr.save(2, {"w": torch.arange(4.0) + 1}, block=True)
    path = mgr._path(2)
    with open(path, "r+b") as f:
        f.seek(-7, os.SEEK_END)
        b = f.read(1)
        f.seek(-7, os.SEEK_END)
        f.write(bytes([b[0] ^ 0xFF]))
    out, step = mgr.restore()
    assert step == 1 and torch.equal(out["w"], torch.arange(4.0))
    with pytest.raises(DigestMismatch):
        mgr.restore(step=2)
    with pytest.raises(ValueError, match="leaves"):
        mgr._restore_step(1, like={"w": torch.zeros(4), "x": torch.zeros(1)})
    mgr.close()


def test_async_snapshot_is_copy_on_write(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    live = {"w": torch.zeros(4), "h": onp.zeros(3, onp.float32)}
    mgr.save(1, live)
    live["w"].add_(99.0)                  # in place, after the save call
    live["h"][:] = 5.0
    mgr.wait()
    out, _ = mgr.restore(like=live)
    assert torch.equal(out["w"], torch.zeros(4))
    assert (out["h"] == 0).all() and mgr.snapshot_stats["async"] == 1
    mgr.close()


def test_checkpoint_async_fault_surfaces_at_wait(tmp_path, monkeypatch):
    monkeypatch.setattr(faults, "_sleep", lambda s: None)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    with faults.active(faults.FaultPlan().fail(
            "checkpoint.async", times=1, exc=RuntimeError)):
        mgr.save(1, {"w": torch.ones(2)})
        with pytest.raises(RuntimeError, match="async checkpoint failed"):
            mgr.wait()
    mgr.close()


def test_stale_tmp_files_cleaned_for_dead_writers(tmp_path):
    d = tmp_path / "ckpt"
    d.mkdir()
    (d / "ckpt-4.pkl.999999.tmp").write_bytes(b"torn")
    (d / f"ckpt-8.pkl.{os.getpid()}.tmp").write_bytes(b"mine")
    mgr = CheckpointManager(str(d), async_save=False)
    files = set(os.listdir(str(d)))
    assert "ckpt-4.pkl.999999.tmp" not in files
    assert f"ckpt-8.pkl.{os.getpid()}.tmp" in files
    mgr.close()


def test_heartbeat_monitor(tmp_path):
    hb_dir = str(tmp_path / "hb")
    a = HeartbeatMonitor(hb_dir, rank=0, interval=0.2, timeout=1.0).start()
    b = HeartbeatMonitor(hb_dir, rank=1, interval=0.2, timeout=1.0).start()
    time.sleep(0.3)
    assert a.ranks() == [0, 1] and a.dead_ranks() == []
    b.stop()
    old = time.time() - 5.0
    os.utime(os.path.join(hb_dir, "rank-1.hb"), (old, old))
    assert a.dead_ranks() == [1]
    a.stop()
    mem = HeartbeatMonitor(rank="r0", timeout=10.0)
    mem.beat()
    assert mem.ranks() == ["r0"] and mem.dead_ranks() == []


# ---------------------------------------------------------------------------
# run_elastic
# ---------------------------------------------------------------------------

def test_run_elastic_crash_resume_and_anchor(tmp_path):
    seen = {"crashed": False}

    def step(state, b):
        if state["i"] == 13 and not seen["crashed"]:
            seen["crashed"] = True
            raise RuntimeError("injected worker failure")
        return _host_step(state, b)

    batches = [onp.float32(b) for b in onp.arange(1, 21)]
    mgr = CheckpointManager(str(tmp_path / "a"), keep=5, async_save=False)
    r0 = telemetry.get("elastic.steps_replayed").value
    out, steps, restarts = run_elastic(
        step, {"w": onp.float32(0), "i": onp.int64(0)}, batches, mgr,
        save_every=5, max_restarts=2)
    assert restarts == 1 and steps == 20
    assert float(out["w"]) == float(sum(batches))
    assert telemetry.get("elastic.steps_replayed").value - r0 == 3
    calls = {"n": 0}

    def early(state, b):
        calls["n"] += 1
        if calls["n"] == 2:
            raise RuntimeError("early failure")
        return {"w": state["w"] + b}

    mgr2 = CheckpointManager(str(tmp_path / "b"), async_save=False)
    out, steps, restarts = run_elastic(
        early, {"w": onp.float32(0)}, [onp.float32(1)] * 4, mgr2,
        save_every=100, max_restarts=2)
    assert restarts == 1 and steps == 4 and float(out["w"]) == 4.0
    mgr3 = CheckpointManager(str(tmp_path / "c"), async_save=False)
    with pytest.raises(RuntimeError, match="deterministic bug"):
        run_elastic(lambda s, b: (_ for _ in ()).throw(
            RuntimeError("deterministic bug")), {"w": onp.float32(0)},
            [1, 2], mgr3, max_restarts=2)
    det = nonfinite_anomaly("w", every=2)
    assert det.every == 2 and det({"w": torch.tensor([float("nan")])})
    for m in (mgr, mgr2, mgr3):
        m.close()


def _lm_setup():
    from mxnet_tpu_torch import models as tmodels

    jcfg = jmodels.TransformerLMConfig(
        vocab_size=64, num_layers=1, num_heads=2, hidden=16, mlp_hidden=32,
        max_len=16, dtype=jnp.float32)
    params = {k: onp.asarray(v) for k, v in
              jmodels.init_params(jax.random.PRNGKey(3), jcfg).items()}
    rng = onp.random.RandomState(5)
    inputs = [rng.randint(0, 64, (4, 8)).astype(onp.int32)
              for _ in range(8)]
    cfg = tmodels.TransformerLMConfig(
        vocab_size=64, num_layers=1, num_heads=2, hidden=16, mlp_hidden=32,
        max_len=16, dtype=torch.float32)
    return tmodels, jcfg, cfg, params, inputs


def test_run_elastic_small_lm_rank_death_matches(tmp_path):
    """``__graft_entry__.py:168-210``: SGD at lr 1e-2 over 8 batches with
    one simulated rank death at step 5; bitwise the port's uninterrupted
    run, within 2e-4 of the reference's."""
    tmodels, jcfg, cfg, params, inputs = _lm_setup()

    def sgd_step(state, toks):
        t = torch.from_numpy(toks).long()
        leaves = {k: v.detach().requires_grad_() for k, v in state.items()}
        loss = tmodels.loss_fn(leaves, t, t, cfg, device="cpu")
        names = sorted(leaves)
        grads = torch.autograd.grad(loss, [leaves[k] for k in names])
        return {k: (leaves[k] - 1e-2 * g).detach()
                for k, g in zip(names, grads)}

    from mxnet_tpu_torch.convert import params_from_numpy

    init = params_from_numpy(params, cfg, device="cpu")
    ref = dict(init)
    for toks in inputs:
        ref = sgd_step(ref, toks)
    died = {"done": False}

    def flaky(state, toks):
        if not died["done"] and toks is inputs[5]:
            died["done"] = True
            raise RuntimeError("simulated rank death at step 5")
        return sgd_step(state, toks)

    mgr = CheckpointManager(str(tmp_path))
    final, steps, restarts = run_elastic(flaky, dict(init), inputs, mgr,
                                         save_every=2, max_restarts=2)
    assert steps == len(inputs) and restarts == 1
    for k in ref:
        assert torch.equal(final[k], ref[k]), k

    @jax.jit
    def jstep(state, toks):
        g = jax.grad(lambda p: jmodels.loss_fn(p, toks, toks, jcfg))(state)
        return jax.tree_util.tree_map(lambda w, gg: w - 1e-2 * gg, state, g)

    jstate = {k: jnp.asarray(v) for k, v in params.items()}
    for toks in inputs:
        jstate = jstep(jstate, jnp.asarray(toks))
    for k in ref:
        onp.testing.assert_allclose(final[k].numpy(),
                                    onp.asarray(jstate[k]), atol=LM_TOL,
                                    rtol=0)
    mgr.close()


# ---------------------------------------------------------------------------
# Trainer states, the cooperative drain, the SIGTERM drill
# ---------------------------------------------------------------------------

def test_trainer_states_round_trip_in_place(tmp_path):
    with tmx.cpu():
        net = _net()
        tr = tgluon.Trainer(net.collect_params(), "sgd", dict(OPT))
        step = tr.compile_step(net, _loss)
        for i in range(2):
            step(*_batch(seed=i))
        fname = str(tmp_path / "states.pkl")
        tr.save_states(fname)
        saved = [s.clone() for s in tr._init_states()]
        snap = {k: v.detach().clone() for k, v in
                tr.state_tree(net)["params"].items()}
        moms = tr._init_states()
        tcs.reset_counters()
        step(*_batch(seed=2))
        tr.load_states(fname)
        assert all(torch.equal(a, b) for a, b in zip(tr._init_states(),
                                                      saved))
        assert all(a is b for a, b in zip(tr._init_states(), moms))
        tree = tr.state_tree(net)
        tr.load_state_tree({"params": snap, "opt": {}}, net)
        for k, v in tr.state_tree(net)["params"].items():
            assert torch.equal(v, snap[k]) and v is tree["params"][k]
        step(*_batch(seed=3))
        assert tcs.trace_count() == 0          # the program survived
    with pytest.raises(ValueError, match="optimizer"):
        adam = tgluon.Trainer(net.collect_params(), "adam", {})
        adam.load_states(fname)


def test_cooperative_drain_saves_the_last_completed_step(tmp_path):
    codes = []
    preemption.install(exit_fn=codes.append)
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    try:
        def step(state, i):
            if int(state["i"]) == 4:
                preemption.notice()            # only flags, inside the loop
            return _host_step(state, onp.float32(1))

        out, steps, _r = run_elastic(step, {"w": onp.float32(0),
                                            "i": onp.int64(0)},
                                     list(range(10)), mgr, save_every=3)
        assert codes == [preemption.exit_code()]
        assert steps == 5 and mgr.latest_step() == 5
        restored, at = mgr.restore()
        assert at == 5 and float(restored["w"]) == 5.0
        assert telemetry.get("preemption.drain_s").value > 0
    finally:
        preemption.reset()
        preemption.uninstall()
        mgr.close()


def test_sigterm_drill_in_subprocesses_is_bitwise(tmp_path):
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run(
        [sys.executable, os.path.join(ROOT, "tools",
                                      "torch_elastic_drill.py"),
         "--device", "cpu", "--net", "narrow", "--steps", "8",
         "--save-every", "3", "--kill-at", "5", "--dir", str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=300)
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert out.returncode == 0, (rec["failures"], out.stderr[-2000:])
    assert rec["final_bitwise"] and rec["steps_replayed"] == 0
    assert rec["children"]["preempt"]["returncode"] == \
        preemption.exit_code()
    assert rec["merged_counters"]["elastic.recovery_s"] > 0

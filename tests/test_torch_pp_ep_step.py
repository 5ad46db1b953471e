"""The compiled Gluon step (``Trainer(kvstore='tpu').compile_step``) over
the ``pp`` and ``ep`` axes in a gloo world of 8 processes on the CPU,
held against the JAX package's ``tests/test_moe_step.py`` and
``tests/test_pp_step.py`` scenarios on its 8 virtual devices:

- ``MoEBlock`` on ``ep=4,dp=2``: one program a step, no retrace and no
  reshard in steady state, the expert weights placed ``P('ep')`` on dim 0
  with their optimizer state, the gate whole (:175); the 4-step
  trajectory on ``ep=4,dp=2``, ``ep=2,dp=4`` and ``dp=8`` against the
  reference's own run of each (:210, whose pin is red on the reference),
  the dispatch inside the step bitwise the reference's gating on the
  same rows and gate, and the aux loss reaching the optimizer through the
  fold over the split batch (:141);
- ``PipelineBlock`` on ``pp=2,dp=2,fsdp=2``: one program a step, N + 1 a
  window under accumulation, the packed stage buffer ``P('pp', None)``,
  tied leaves bitwise tied, the batch split over ``dp`` only, and the
  trajectory against the reference's (``tests/test_pp_step.py:181-347``);
- ``MoEBlock`` and ``PipelineBlock`` in one net on ``pp=2,dp=2,ep=2``
  (:318), against the reference's run of the same net;
- ``bucket=True`` with parameters split over ``fsdp`` (``dp=2,fsdp=4``).

The reference's pp tests on the sentinel, ``CheckpointManager`` and
preemption (``tests/test_pp_step.py:376-450``) and the restore across an
``ep`` mesh change (``tests/test_moe_step.py:283``) are
``tests/test_torch_elastic_world.py``'s.
"""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch import cached_step as tcs
from mxnet_tpu_torch import gluon as tgluon
from mxnet_tpu_torch.parallel import moe as tmoe
from mxnet_tpu_torch.parallel import spmd as tspmd
from mxnet_tpu_torch.parallel.pipeline import HeteroPipeline
from mxnet_tpu_torch.serving import BucketPolicy

from test_torch_package import LazyModule
from test_torch_sharding import run_world
from test_torch_spmd import knobs

jmx = LazyModule("mxnet_tpu")
jnp = LazyModule("jax.numpy")
jgluon = LazyModule("mxnet_tpu.gluon")
jmoe = LazyModule("mxnet_tpu.parallel.moe")
jpipe = LazyModule("mxnet_tpu.parallel.pipeline")
jspmd = LazyModule("mxnet_tpu.parallel.spmd")
jms = LazyModule("test_moe_step")
jps = LazyModule("test_pp_step")

G, S, M, H, E = 4, 6, 8, 16, 4     # tests/test_moe_step.py:54
DIM = 8                            # tests/test_pp_step.py:54
MOE_SPECS = ("ep=4,dp=2", "ep=2,dp=4", "dp=8")


# ---------------------------------------------------------------------------
# the port's side (run in the world)
# ---------------------------------------------------------------------------
def _moe_net(seed=0):
    net = tmoe.MoEBlock(units=M, hidden=H, num_experts=E, k=2)
    net.initialize(ctx=tmx.cpu())
    rng = onp.random.RandomState(seed)
    for _name, p in sorted(net.collect_params().items()):
        p.set_data(torch.from_numpy(
            rng.randn(*p.shape).astype(onp.float32) * 0.2))
    return net


_TARGET = onp.random.RandomState(99).randn(G, S, M).astype(onp.float32)


def _moe_loss(net, x):
    y = net(x)
    return ((y - torch.from_numpy(_TARGET)) ** 2).sum()


def _run_moe(spec, steps=4, seed=0, aux_weight=0.01):
    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1,
               MXNET_MOE_AUX_WEIGHT=aux_weight):
        net = _moe_net(seed)
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9},
                            kvstore="tpu")
        step = tr.compile_step(net, _moe_loss)
        rng = onp.random.RandomState(7)
        losses = []
        for _ in range(steps):
            x = rng.randn(G, S, M).astype(onp.float32)
            losses.append(float(step(torch.from_numpy(x), batch_size=G)))
            assert step.last_step_compiled, step.last_fallback_reason
    return net, tr, step, losses


def _moe_scenarios():
    out = {}
    tspmd.reset_counters()
    with knobs(MXNET_SPMD_MESH="ep=4,dp=2", MXNET_FSDP_MIN_SIZE=1):
        net = _moe_net()
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01, "momentum": 0.9},
                            kvstore="tpu")
        step = tr.compile_step(net, _moe_loss)
        x = torch.from_numpy(
            onp.random.RandomState(3).randn(G, S, M).astype(onp.float32))
        step(x, batch_size=G)
        d0, t0 = tcs.dispatch_count(), tcs.trace_count()
        r0 = tspmd.reshard_count()
        # record the routing inside the step: its rows, gate and dispatch
        seen = []
        real = tmoe.top_k_gating

        def spy(x, gate_w, **kw):
            d, c, a = real(x, gate_w, **kw)
            seen.append((x.detach().clone(), gate_w.detach().clone(),
                         d.detach().clone(), c.detach().clone()))
            return d, c, a

        tmoe.top_k_gating = spy
        try:
            for _ in range(5):
                step(x, batch_size=G)
        finally:
            tmoe.top_k_gating = real
        out["ep|dispatches"] = tcs.dispatch_count() - d0
        out["ep|traces"] = tcs.trace_count() - t0
        out["ep|reshards"] = tspmd.reshard_count() - r0
        params = net.collect_params()
        for name in ("expert.ffn_1.weight", "expert.ffn_2.weight",
                     "gate.weight"):
            out[f"ep|shape:{name}"] = onp.array(params[name].data().shape)
        i = next(j for j, p in enumerate(tr._params)
                 if p is params["expert.ffn_1.weight"])
        st = tr._states[i]
        out["ep|state_shape"] = onp.array(
            (st if isinstance(st, torch.Tensor) else st[0]).shape)
        xs, gw, d, c = seen[-1]
        out["ep|route_x"], out["ep|route_gate"] = xs.numpy(), gw.numpy()
        out["ep|route_dispatch"], out["ep|route_combine"] = d.numpy(), \
            c.numpy()
    for spec in MOE_SPECS:
        net, _tr, step, losses = _run_moe(spec)
        out[f"{spec}|losses"] = onp.array(losses)
        for k, v in step.full_params().items():
            out[f"{spec}|p:{k}"] = v.numpy()
    for w in (0.0, 0.5):
        _net, _tr, step, _l = _run_moe("ep=2,dp=4", steps=3, aux_weight=w)
        for k, v in step.full_params().items():
            out[f"aux{w}|p:{k}"] = v.numpy()
    return out


def _stages(n=2, seed=0, dim=DIM):
    rng = onp.random.RandomState(seed)
    ws = [torch.from_numpy((rng.randn(dim, dim) * 0.3).astype(onp.float32))
          for _ in range(n)]
    return [lambda p, x: torch.tanh(x @ p["w"])] * n, [{"w": w} for w in ws]


def _pipe(spec, batch=4, seed=0, stage_params=None):
    mesh = tspmd.resolve_mesh(spec)
    fns, params = _stages(2, seed)
    return HeteroPipeline(fns, stage_params or params, mesh,
                          num_microbatches=2,
                          example_x=torch.zeros(batch, DIM))


def _pp_loss(net, x):
    y = net(x)
    return (y * y).sum()


def _run_pp(spec, steps=4, accum=1, seed=0, ties=None, stage_params=None,
            lr=0.05, momentum=0.9):
    from mxnet_tpu_torch.parallel.pipeline import PipelineBlock

    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1):
        pipe = _pipe(spec, seed=seed, stage_params=stage_params)
        if ties is not None:
            pipe.tied = ties
        blk = PipelineBlock(pipe)
        opt = {"learning_rate": lr}
        if momentum:
            opt["momentum"] = momentum
        tr = tgluon.Trainer(blk.collect_params(), "sgd", opt, kvstore="tpu")
        step = tr.compile_step(blk, _pp_loss, accum_steps=accum)
        rng = onp.random.RandomState(7 if ties is None else 11)
        for _ in range(steps):
            for _m in range(accum):
                x = rng.randn(4, DIM).astype(onp.float32)
                step(torch.from_numpy(x), batch_size=4)
                assert step.last_step_compiled, step.last_fallback_reason
    return blk, step, pipe


def _pp_scenarios():
    out = {}
    spec = "pp=2,dp=2,fsdp=2"
    tspmd.reset_counters()
    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1):
        blk, step, _pipe_ = _run_pp(spec, steps=1)
        d0, t0 = tcs.dispatch_count(), tcs.trace_count()
        r0 = tspmd.reshard_count()
        x = torch.from_numpy(onp.random.RandomState(3).randn(4, DIM)
                             .astype(onp.float32))
        for _ in range(5):
            step(x, batch_size=4)
        out["pp|dispatches"] = tcs.dispatch_count() - d0
        out["pp|traces"] = tcs.trace_count() - t0
        out["pp|reshards"] = tspmd.reshard_count() - r0
        out["pp|replicated"] = tspmd.replicated_batch_count()
        out["pp|block"] = onp.array(blk.pp_stages.data().shape)
        out["pp|spec"] = onp.array(step._specs[id(blk.pp_stages)],
                                   dtype=object).astype(str)
        placed = tspmd.put_batch(torch.arange(6 * DIM, dtype=torch.float32)
                                 .reshape(6, DIM), tspmd.resolve_mesh())
        out["pp|put_rows"] = onp.array(placed.shape)
    # N + 1 dispatches a window
    blk, step, _p = _run_pp(spec, steps=1, accum=2)
    d0, t0 = tcs.dispatch_count(), tcs.trace_count()
    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1):
        for _ in range(6):
            step(x, batch_size=4)
    out["accum|dispatches"] = tcs.dispatch_count() - d0
    out["accum|traces"] = tcs.trace_count() - t0
    # the trajectory
    blk, step, _p = _run_pp(spec, steps=4)
    out["traj|pp_stages"] = step.full_params()["pp_stages"].numpy()
    # tied leaves: stages 0 and 1 share 'w', started equal
    rng = onp.random.RandomState(5)
    w0 = torch.from_numpy((rng.randn(DIM, DIM) * 0.3).astype(onp.float32))
    for name, ties in (("tied", (((0, "w"), (1, "w")),)), ("untied", ())):
        blk, step, pipe = _run_pp(spec, steps=3, ties=ties, momentum=0,
                                  stage_params=[{"w": w0.clone()},
                                                {"w": w0.clone()}])
        w = step.full_params()["pp_stages"].numpy()
        o0, n0 = pipe.leaf_slice(0, "w")
        o1, n1 = pipe.leaf_slice(1, "w")
        out[f"{name}|s0"], out[f"{name}|s1"] = w[0, o0:o0 + n0], \
            w[1, o1:o1 + n1]
    return out


class _EveryAxisNet(tgluon.Block):
    def __init__(self, pipe):
        from mxnet_tpu_torch.parallel.pipeline import PipelineBlock

        super().__init__()
        self.moe = tmoe.MoEBlock(units=M, hidden=H, num_experts=E, k=2)
        self.pp = PipelineBlock(pipe)

    def forward(self, x):
        h = self.moe(x)                       # this rank's rows, [g, S, M]
        return self.pp(h.reshape((h.shape[0], S * M)))


def _every_axis_scenario():
    spec = "pp=2,dp=2,fsdp=1,ep=2"
    out = {}
    tspmd.reset_counters()
    with knobs(MXNET_SPMD_MESH=spec, MXNET_FSDP_MIN_SIZE=1):
        mesh = tspmd.resolve_mesh()
        rng = onp.random.RandomState(2)
        ws = [torch.from_numpy((rng.randn(S * M, S * M) * 0.1)
                               .astype(onp.float32)) for _ in range(2)]
        pipe = HeteroPipeline([lambda p, h: torch.tanh(h @ p["w"])] * 2,
                              [{"w": w} for w in ws], mesh,
                              num_microbatches=2,
                              example_x=torch.zeros(G, S * M))
        net = _EveryAxisNet(pipe)
        net.initialize(ctx=tmx.cpu())
        rng2 = onp.random.RandomState(8)
        for name, p in sorted(net.collect_params().items()):
            if name.endswith("pp_stages"):
                continue
            p.set_data(torch.from_numpy(
                rng2.randn(*p.shape).astype(onp.float32) * 0.2))

        def loss_fn(n, x):
            y = n(x)
            return (y * y).sum()

        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01}, kvstore="tpu")
        step = tr.compile_step(net, loss_fn)
        x = torch.from_numpy(rng2.randn(G, S, M).astype(onp.float32))
        step(x, batch_size=G)
        d0, t0 = tcs.dispatch_count(), tcs.trace_count()
        losses = [float(step(x, batch_size=G)) for _ in range(6)]
        out["dispatches"] = tcs.dispatch_count() - d0
        out["traces"] = tcs.trace_count() - t0
        out["replicated"] = tspmd.replicated_batch_count()
        out["losses"] = onp.array(losses)
        params = net.collect_params()
        out["pp_block"] = onp.array(params["pp.pp_stages"].data().shape)
        out["expert_block"] = onp.array(
            params["moe.expert.ffn_1.weight"].data().shape)
        out["gate_block"] = onp.array(params["moe.gate.weight"].data().shape)
    return out


class _MaskedMlp(tgluon.HybridBlock):
    def __init__(self):
        super().__init__()
        self.d1 = tgluon.nn.Dense(16, in_units=8)
        self.d2 = tgluon.nn.Dense(4, in_units=16)

    def forward(self, x):
        return self.d2(torch.relu(self.d1(x)))


def _masked_loss(net, x, y, m):
    """Pad-safe: the masked squared error summed row after row."""
    err = (((net(x) - y) ** 2).sum(dim=1, keepdim=True) * m)[:, 0]
    total = err[0]
    for i in range(1, err.shape[0]):
        total = total + err[i]
    return total


def bucket_run(spec):
    """Batches of 5, 6, 3 and 8 rows, bucketed to 4 and 8, on ``spec``
    (None: one device, no bucketing)."""
    with knobs(MXNET_SPMD_MESH=spec or "off", MXNET_FSDP_MIN_SIZE=1,
               MXNET_SHAPE_BUCKETS="4,8"):
        net = _MaskedMlp()
        net.initialize(ctx=tmx.cpu())
        rng = onp.random.RandomState(0)
        for _n, p in sorted(net.collect_params().items()):
            p.set_data(torch.from_numpy(
                (rng.randn(*p.shape) * 0.1).astype(onp.float32)))
        tr = tgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.05},
                            kvstore="tpu" if spec else None)
        step = tr.compile_step(net, _masked_loss, bucket=spec is not None)
        rng = onp.random.RandomState(14)
        for n in (5, 6, 3, 8):
            b = (rng.randn(n, 8).astype(onp.float32),
                 rng.randn(n, 4).astype(onp.float32),
                 onp.ones((n, 1), onp.float32))
            step(*map(torch.from_numpy, b), batch_size=n)
            assert step.last_step_compiled, step.last_fallback_reason
        out = {f"p:{k}": v.numpy() for k, v in step.full_params().items()}
        out["padded"] = step.padded_steps
        out["refused"] = int(step.bucket_refused is not None)
        out["split"] = int(any(step._specs.values())) if spec else 0
        out["buckets"] = onp.array(BucketPolicy().buckets())
    return out


def world8():
    out = {}
    for prefix, fn in (("moe", _moe_scenarios), ("pp", _pp_scenarios),
                       ("all", _every_axis_scenario)):
        for k, v in fn().items():
            out[f"{prefix}/{k}"] = v
    for k, v in bucket_run("dp=2,fsdp=4").items():
        out[f"bucket/{k}"] = v
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return [r["world8"] for r in run_world(
        8, [f"{__name__}:world8"], tmp_path_factory.mktemp("ppep"))]


def _part(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "/")}


# ---------------------------------------------------------------------------
# MoE over ep
# ---------------------------------------------------------------------------
def test_moe_compiled_one_launch_ep_mesh(world):
    for res in world:
        got = _part(res, "moe")
        assert int(got["ep|dispatches"]) == 5
        assert int(got["ep|traces"]) == 0
        assert int(got["ep|reshards"]) == 0
        # one expert a pair of ranks, the gate whole, the state as its
        # weight
        assert list(got["ep|shape:expert.ffn_1.weight"]) == [E // 4, M, H]
        assert list(got["ep|shape:expert.ffn_2.weight"]) == [E // 4, H, M]
        assert list(got["ep|shape:gate.weight"]) == [M, E]
        assert list(got["ep|state_shape"]) == [E // 4, M, H]


def test_moe_dispatch_in_the_step_is_the_reference_gating_bitwise(world):
    """The last step's routing on this rank's rows: the dispatch bit for
    bit the reference's ``top_k_gating`` on the same rows and gate."""
    for res in world:
        got = _part(res, "moe")
        d, c, _a = jmoe.top_k_gating(jnp.asarray(got["ep|route_x"]),
                                     jnp.asarray(got["ep|route_gate"]),
                                     num_experts=E, k=2)
        assert got["ep|route_x"].shape == (G // 2, S, M)   # this rank's rows
        assert onp.array_equal(got["ep|route_dispatch"], onp.asarray(d))
        # the combine weights are gate probabilities: the softmax of the
        # same logits, within fp32 rounding
        onp.testing.assert_allclose(got["ep|route_combine"], onp.asarray(c),
                                    rtol=1e-6, atol=0)


@pytest.mark.parametrize("spec", MOE_SPECS)
def test_moe_trajectory_across_mesh_shapes_matches_reference(world, spec):
    """The reference's ``test_moe_parity_bit_exact_across_mesh_shapes``
    pins bitwise equality across its own mesh shapes and is red; the port
    is held to the reference's own run of each shape instead."""
    net, _tr, _step, losses = jms._run_moe(spec, steps=4, seed=0)
    want = jms._params_of(net)
    for res in world:
        got = _part(res, "moe")
        onp.testing.assert_allclose(got[f"{spec}|losses"], losses,
                                    rtol=1e-5, atol=1e-6)
        for k, w in want.items():
            onp.testing.assert_allclose(got[f"{spec}|p:{k}"], w, rtol=1e-5,
                                        atol=1e-6, err_msg=k)


def test_aux_reaches_the_optimizer_over_a_split_batch(world):
    got = _part(world[0], "moe")
    for name in ("gate.weight", "expert.ffn_1.weight"):
        assert not onp.array_equal(got[f"aux0.0|p:{name}"],
                                   got[f"aux0.5|p:{name}"])
    for w in (0.0, 0.5):
        net, _t, _s, _l = jms._run_moe("ep=2,dp=4", steps=3, aux_weight=w)
        for k, want in jms._params_of(net).items():
            onp.testing.assert_allclose(got[f"aux{w}|p:{k}"], want,
                                        rtol=1e-5, atol=1e-6, err_msg=k)


def test_expert_parallel_plan_rule():
    from mxnet_tpu_torch.parallel import sharding as tsh

    from test_torch_sharding import fake_mesh

    mesh = fake_mesh(ep=4, dp=2)
    plan = tsh.expert_parallel_plan()
    assert plan.spec_for("expert.ffn_1.weight", (E, M, H), mesh) == ("ep",)
    assert plan.spec_for("block.expert.ffn_2.weight", (E, H, M), mesh) \
        == ("ep",)
    assert plan.spec_for("gate.weight", (M, E), mesh) == ()


def test_param_spec_pp_and_ep_name_rules():
    from test_torch_sharding import _spec, fake_mesh, jax_mesh

    cases = [({"pp": 2, "dp": 2, "fsdp": 2}, (2, 64), "pp_stages"),
             ({"pp": 2, "dp": 2, "fsdp": 2}, (2, 64), "body.pp_stages"),
             ({"pp": 2, "dp": 2, "fsdp": 2}, (4, 64), "pp_stages"),
             ({"pp": 2, "dp": 2, "fsdp": 2}, (2, 64), None),
             ({"ep": 4, "dp": 2}, (4, 8, 16), "expert.ffn_1.weight"),
             ({"ep": 4, "dp": 2}, (8, 4, 16), "expert.ffn_1.weight"),
             ({"ep": 4, "dp": 2}, (6, 8, 16), "expert.ffn_1.weight"),
             ({"ep": 4, "dp": 2}, (8, 16), "gate.weight")]
    for axes, shape, name in cases:
        want = jspmd.param_spec(shape, jax_mesh(axes), min_size=1, name=name)
        got = tspmd.param_spec(shape, fake_mesh(**axes), min_size=1,
                               name=name)
        assert _spec(got) == _spec(want), (axes, shape, name)
    assert tspmd.param_spec((2, 64), fake_mesh(pp=2, dp=2, fsdp=2),
                            min_size=1, name="pp_stages") == ("pp", None)
    assert tspmd.model_axes_active(fake_mesh(ep=4, dp=2))
    assert not tspmd.model_axes_active(fake_mesh(dp=8))


# ---------------------------------------------------------------------------
# PipelineBlock over pp
# ---------------------------------------------------------------------------
def test_pp_one_launch_no_retrace_no_reshard(world):
    for res in world:
        got = _part(res, "pp")
        assert int(got["pp|dispatches"]) == 5
        assert int(got["pp|traces"]) == 0
        assert int(got["pp|reshards"]) == 0
        assert int(got["pp|replicated"]) == 0
        # rank i holds stage i's row of the packed buffer
        assert list(got["pp|block"])[0] == 1
        assert list(got["pp|spec"]) == ["pp", "None"]


def test_pp_accum_n_plus_one_dispatches(world):
    for res in world:
        got = _part(res, "pp")
        assert int(got["accum|dispatches"]) == (2 + 1) * 3
        assert int(got["accum|traces"]) == 0


def test_pp_batch_shards_dp_only(world):
    for res in world:
        assert list(_part(res, "pp")["pp|put_rows"]) == [3, DIM]


def test_pp_tied_grads_stay_tied(world):
    got = _part(world[0], "pp")
    assert onp.array_equal(got["tied|s0"], got["tied|s1"])
    assert not onp.array_equal(got["untied|s0"], got["untied|s1"])


def test_pp_trajectory_matches_reference(world):
    blk, _tr, _step, _pipe = jps._run_pp("pp=2,dp=2,fsdp=2", steps=4,
                                         seed=0)
    want = blk.pp_stages.data().asnumpy()
    for res in world:
        onp.testing.assert_allclose(_part(res, "pp")["traj|pp_stages"],
                                    want, rtol=1e-4, atol=5e-6)


# ---------------------------------------------------------------------------
# every axis in one program
# ---------------------------------------------------------------------------
def _reference_every_axis():
    """The reference's ``test_every_axis_one_program`` net and steps,
    returning its losses."""
    spec = "pp=2,dp=2,fsdp=1,ep=2"
    with jms._mesh_env(spec):
        mesh = jspmd.resolve_mesh()
        rng = onp.random.RandomState(2)
        ws = [jnp.asarray((rng.randn(S * M, S * M) * 0.1)
                          .astype(onp.float32)) for _ in range(2)]
        pipe = jpipe.HeteroPipeline(
            [lambda p, h: jnp.tanh(h @ p["w"])] * 2, [{"w": w} for w in ws],
            mesh, num_microbatches=2,
            example_x=jnp.zeros((G, S * M), jnp.float32))

        class Net(jgluon.Block):
            def __init__(self):
                super().__init__()
                self.moe = jmoe.MoEBlock(units=M, hidden=H, num_experts=E,
                                         k=2)
                self.pp = jpipe.PipelineBlock(pipe)

            def forward(self, x):
                return self.pp(self.moe(x).reshape((G, S * M)))

        net = Net()
        net.initialize(ctx=jmx.cpu())
        rng2 = onp.random.RandomState(8)
        for name, p in sorted(net.collect_params().items()):
            if name.endswith("pp_stages"):
                continue
            p.data()._set_data(jmx.nd.array(
                rng2.randn(*p.shape).astype(onp.float32) * 0.2)._data)

        def loss_fn(n, x):
            y = n(x)
            return (y * y).sum()

        tr = jgluon.Trainer(net.collect_params(), "sgd",
                            {"learning_rate": 0.01}, kvstore="tpu")
        step = tr.compile_step(net, loss_fn)
        x = rng2.randn(G, S, M).astype(onp.float32)
        step(jmx.nd.array(x), batch_size=G)
        return [float(step(jmx.nd.array(x), batch_size=G).asnumpy()
                      .ravel()[0]) for _ in range(6)]


def test_every_axis_one_program(world):
    want = _reference_every_axis()
    for res in world:
        got = _part(res, "all")
        assert int(got["dispatches"]) == 6
        assert int(got["traces"]) == 0
        assert int(got["replicated"]) == 0
        assert got["losses"][-1] < got["losses"][0]      # it trains
        onp.testing.assert_allclose(got["losses"], want, rtol=1e-5)
        assert list(got["pp_block"])[0] == 1
        assert list(got["expert_block"]) == [E // 2, M, H]
        assert list(got["gate_block"]) == [M, E]


# ---------------------------------------------------------------------------
# bucketing with split parameters
# ---------------------------------------------------------------------------
def test_bucket_with_parameters_split_over_fsdp(world):
    plain = bucket_run(None)
    for res in world:
        got = _part(res, "bucket")
        assert int(got["split"]) == 1
        assert int(got["refused"]) == 0
        assert int(got["padded"]) == 3          # 8 rows fit exactly
        assert list(got["buckets"]) == [4, 8]
        for k, w in plain.items():
            if k.startswith("p:"):
                onp.testing.assert_allclose(got[k], w, rtol=1e-5,
                                            atol=1e-6, err_msg=k)

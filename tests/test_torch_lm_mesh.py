"""The port's flagship LM on a mesh (``mxnet_tpu_torch.models.
transformer_lm``: ``sharding_plan``, ``forward`` / ``loss_fn`` and
``make_train_step`` over ``dp``, ``fsdp``, ``tp``, ``sp`` and ``ep``) in
gloo worlds of 4 and 8 processes on the CPU, held against the JAX
package's on its 8 virtual devices, on the same numpy weights and
batches, in fp32 within 2e-4 unless a case says otherwise:

- ``dp=2,tp=2``: the whole logits, the loss, 3 Adam and 3 LAMB steps
  (``tests/test_models.py:60``), and ``grad_accum=4`` against the whole
  batch (:81);
- ``sp=4``: the forward with ring attention against the dense one
  (:204, atol 2e-3) and the reference's, and without ring attention (K
  and V gathered over ``sp``) 2 Adam steps whose gradients cross the
  gather;
- ``tp=2,sp=2,ep=2``: ``dryrun_multichip`` part 1 (the MoE config with
  ring attention, LAMB lr 1e-3, ``__graft_entry__.py:85-114``), its loss
  and updated parameters (``tests/test_models.py:188`` held to numbers);
- ``dp=2,fsdp=2,tp=2`` with the ``fsdp`` rule placing the rest: 2 LAMB
  steps (whole-tensor norms over split blocks);
- ``ep=4,dp=2``: 2 Adam steps of the MoE LM, each rank running its own
  experts.

Every rank returns the same loss and, gathered, the same parameters. A
mesh of one is the plain step bit for bit (in this process, and on the
card in the ``cuda`` test). The weights are drawn with numpy and carried
into both packages (``convert.params_from_numpy``).
"""
import dataclasses

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import models as tm
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.convert import params_from_numpy
from mxnet_tpu_torch.models import transformer_lm as ttl
from mxnet_tpu_torch.parallel import spmd as tspmd

from test_torch_package import LazyModule
from test_torch_sharding import run_world

jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
jm = LazyModule("mxnet_tpu.models")
jpar = LazyModule("mxnet_tpu.parallel")

TOL = dict(rtol=2e-4, atol=2e-4)

DENSE = dict(vocab_size=64, num_layers=2, num_heads=4, hidden=32,
             mlp_hidden=64, max_len=32)
# dryrun_multichip part 1 (__graft_entry__.py:95-99)
PART1 = dict(vocab_size=256, num_layers=2, num_heads=4, hidden=64,
             mlp_hidden=128, max_len=64, num_experts=4,
             use_ring_attention=True)
MOE = dict(DENSE, num_experts=4)

# name -> (config, mesh axes, optimizer, steps, (B, S), grad_accum, world)
RUNS = {
    "adam": (DENSE, {"dp": 2, "tp": 2}, "adam", 3, (8, 16), 1, 4),
    "lamb": (DENSE, {"dp": 2, "tp": 2}, "lamb", 3, (8, 16), 1, 4),
    "accum1": (DENSE, {"dp": 2, "tp": 2}, "adam", 1, (8, 16), 1, 4),
    "accum4": (DENSE, {"dp": 2, "tp": 2}, "adam", 1, (8, 16), 4, 4),
    "sp_gather": (DENSE, {"sp": 4}, "adam", 2, (2, 16), 1, 4),
    "part1": (PART1, {"tp": 2, "sp": 2, "ep": 2}, "lamb", 1, (4, 32), 1, 8),
    "fsdp_lamb": (DENSE, {"dp": 2, "fsdp": 2, "tp": 2}, "lamb", 2, (8, 16),
                  1, 8),
    "ep4": (MOE, {"ep": 4, "dp": 2}, "adam", 2, (4, 16), 1, 8),
}


def np_params(cfg, seed):
    """Weights drawn with numpy, by the port's names and shapes."""
    rng = onp.random.RandomState(seed)
    out = {}
    for name, (shape, _dt) in tm.param_shapes(cfg).items():
        if name.endswith("gamma"):
            a = 1.0 + 0.1 * rng.randn(*shape)
        elif name.endswith(("beta", "bias")):
            a = 0.02 * rng.randn(*shape)
        else:
            a = 0.05 * rng.randn(*shape)
        out[name] = a.astype(onp.float32)
    return out


def batch(cfg, shape, seed):
    rng = onp.random.RandomState(seed)
    toks = rng.randint(0, cfg["vocab_size"], shape).astype(onp.int32)
    labels = rng.randint(0, cfg["vocab_size"], shape).astype(onp.int32)
    labels[rng.rand(*shape) < 0.4] = -1
    return toks, labels


def t_cfg(kw):
    return tm.TransformerLMConfig(dtype=torch.float32, **kw)


def j_cfg(kw):
    return jm.TransformerLMConfig(dtype=jnp.float32, **kw)


def _t_place(params, cfg, mesh, fsdp):
    """This rank's blocks: the LM's plan, and with ``fsdp`` the ``fsdp``
    rule for the leaves the plan leaves whole."""
    plan = tm.sharding_plan(cfg)
    if not fsdp:
        return plan.shard_tree(params, mesh)
    out = {}
    for n, w in params.items():
        spec = plan.spec_for(n, tuple(w.shape), mesh)
        if not spec:
            spec = tspmd.param_spec(tuple(w.shape), mesh, min_size=1)
        out[n] = tpar.shard_array(w, mesh, spec)
    return out


def _t_whole(params, cfg, mesh):
    specs = ttl._param_specs(params, cfg, mesh)
    return {n: tspmd.gather_full(w, specs[n], mesh).numpy()
            for n, w in params.items()}


def t_run(name):
    kw, axes, opt, steps, shape, accum, _world = RUNS[name]
    cfg = t_cfg(kw)
    mesh = tpar.make_mesh(axes, devices=[torch.device("cpu")])
    params = params_from_numpy(np_params(cfg, 1), cfg, device="cpu")
    params = _t_place(params, cfg, mesh, fsdp="fsdp" in axes)
    m, v = tm.init_opt_state(params)
    m = tm.sharding_plan(cfg).shard_tree(m, mesh)     # a no-op: placed
    v = tm.sharding_plan(cfg).shard_tree(v, mesh)
    step = tm.make_train_step(cfg, mesh, optimizer=opt, lr=1e-3,
                              grad_accum=accum)
    out = {}
    for t in range(1, steps + 1):
        toks, labels = batch(kw, shape, 10 + t)
        params, m, v, loss = step(params, m, v, torch.from_numpy(toks),
                                  torch.from_numpy(labels), t)
        out[f"loss{t}"] = float(loss)
    for n, a in _t_whole(params, cfg, mesh).items():
        out[f"p:{n}"] = a
    return out


def j_run(name):
    kw, axes, opt, steps, shape, accum, _world = RUNS[name]
    cfg = j_cfg(kw)
    mesh = jpar.make_mesh(axes)
    plan = jm.sharding_plan(cfg)
    params = {k: jnp.asarray(a) for k, a in np_params(t_cfg(kw), 1).items()}
    out = {}
    with mesh:
        params = plan.shard_tree(params, mesh)
        m, v = jm.init_opt_state(params)
        m, v = plan.shard_tree(m, mesh), plan.shard_tree(v, mesh)
        step = jm.make_train_step(cfg, mesh, optimizer=opt, lr=1e-3,
                                  grad_accum=accum)
        for t in range(1, steps + 1):
            toks, labels = batch(kw, shape, 10 + t)
            params, m, v, loss = step(params, m, v, jnp.asarray(toks),
                                      jnp.asarray(labels), jnp.float32(t))
            out[f"loss{t}"] = float(loss)
    for n, a in params.items():
        out[f"p:{n}"] = onp.asarray(a)
    return out


def t_forward(kw, axes, shape, seed=2):
    cfg = t_cfg(kw)
    mesh = tpar.make_mesh(axes, devices=[torch.device("cpu")])
    params = params_from_numpy(np_params(cfg, 1), cfg, device="cpu")
    params = tm.sharding_plan(cfg).shard_tree(params, mesh)
    toks, labels = batch(kw, shape, seed)
    logits, aux = tm.forward(params, torch.from_numpy(toks), cfg, mesh)
    loss = tm.loss_fn(params, torch.from_numpy(toks),
                      torch.from_numpy(labels), cfg, mesh)
    return {"logits": logits.numpy(), "aux": float(aux),
            "loss": float(loss)}


def j_forward(kw, axes, shape, seed=2):
    cfg = j_cfg(kw)
    mesh = jpar.make_mesh(axes)
    params = {k: jnp.asarray(a) for k, a in np_params(t_cfg(kw), 1).items()}
    toks, labels = batch(kw, shape, seed)
    with mesh:
        params = jm.sharding_plan(cfg).shard_tree(params, mesh)
        logits, aux = jax.jit(lambda p, t: jm.forward(p, t, cfg, mesh))(
            params, jnp.asarray(toks))
        loss = jax.jit(lambda p, t, lab: jm.loss_fn(p, t, lab, cfg, mesh))(
            params, jnp.asarray(toks), jnp.asarray(labels))
    return {"logits": onp.asarray(logits), "aux": float(aux),
            "loss": float(loss)}


FORWARDS = {
    "dp_tp": (DENSE, {"dp": 2, "tp": 2}, (4, 16)),
    "ring": (dict(DENSE, use_ring_attention=True), {"sp": 4}, (2, 16)),
    "sp_dense": (DENSE, {"sp": 4}, (2, 16)),
}


def _world(n):
    out = {}
    for name, (kw, axes, shape) in FORWARDS.items():
        if n == 4:
            for k, a in t_forward(kw, axes, shape).items():
                out[f"fwd:{name}|{k}"] = a
    for name, spec in RUNS.items():
        if spec[-1] == n:
            for k, a in t_run(name).items():
                out[f"{name}|{k}"] = a
    return out


def world4():
    return _world(4)


def world8():
    return _world(8)


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    res = {}
    for n in (4, 8):
        res[n] = [r[f"world{n}"] for r in run_world(
            n, [f"{__name__}:world{n}"], tmp_path_factory.mktemp(f"w{n}"))]
    return res


def _part(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "|")}


@pytest.mark.parametrize("name", list(FORWARDS))
def test_forward_and_loss_on_a_mesh_match_reference(worlds, name):
    kw, axes, shape = FORWARDS[name]
    want = j_forward(kw, axes, shape)
    for rank, res in enumerate(worlds[4]):
        got = _part(res, f"fwd:{name}")
        onp.testing.assert_allclose(got["logits"], want["logits"],
                                    err_msg=f"rank {rank}", **TOL)
        onp.testing.assert_allclose(float(got["loss"]), want["loss"], **TOL)
        onp.testing.assert_allclose(float(got["aux"]), want["aux"], **TOL)


def test_ring_attention_forward_matches_dense(worlds):
    """``tests/test_models.py:204``: the sp=4 ring forward against the
    dense forward of the same weights, at the reference's bound."""
    kw, _axes, shape = FORWARDS["ring"]
    cfg = t_cfg(kw)
    params = params_from_numpy(np_params(cfg, 1), cfg, device="cpu")
    toks, _labels = batch(kw, shape, 2)
    dense, _ = tm.forward(params, torch.from_numpy(toks),
                          dataclasses.replace(cfg, use_ring_attention=False),
                          device="cpu")
    got = _part(worlds[4][0], "fwd:ring")["logits"]
    onp.testing.assert_allclose(got, dense.numpy(), atol=2e-3)


@pytest.mark.parametrize("name", list(RUNS))
def test_train_step_on_a_mesh_matches_reference(worlds, name):
    want = j_run(name)
    ranks = worlds[RUNS[name][-1]]
    got = _part(ranks[0], name)
    for k, w in want.items():
        onp.testing.assert_allclose(got[k], w, err_msg=k, **TOL)
    # every rank ends with the same loss and the same whole parameters
    for rank, res in enumerate(ranks[1:], start=1):
        other = _part(res, name)
        for k, w in got.items():
            assert onp.array_equal(other[k], w), (rank, k)


def test_grad_accum_on_a_mesh_matches_the_whole_batch(worlds):
    """``tests/test_models.py:81`` on dp=2,tp=2: four micro-batches take
    the whole batch's update."""
    one = _part(worlds[4][0], "accum1")
    four = _part(worlds[4][0], "accum4")
    assert abs(float(one["loss1"]) - float(four["loss1"])) < 1e-5
    for k in one:
        if k.startswith("p:"):
            onp.testing.assert_allclose(one[k], four[k], atol=2e-5,
                                        err_msg=k)


def test_mesh_of_one_is_the_plain_step_bitwise():
    """Axes of size 1 are elided: the step on a mesh of one (no world) is
    the single-device step bit for bit, Adam and LAMB, dense and MoE."""
    for kw in (DENSE, dict(MOE, use_ring_attention=True)):
        cfg = t_cfg(kw)
        for opt in ("adam", "lamb"):
            runs = []
            for mesh in (None, tpar.make_mesh(
                    {"dp": 1, "fsdp": 1, "tp": 1, "sp": 1, "ep": 1},
                    devices=[torch.device("cpu")])):
                p = params_from_numpy(np_params(cfg, 3), cfg, device="cpu")
                if mesh is not None:
                    p = tm.sharding_plan(cfg).shard_tree(p, mesh)
                m, v = tm.init_opt_state(p)
                step = tm.make_train_step(cfg, mesh, optimizer=opt,
                                          device="cpu")
                losses = []
                for t in (1, 2):
                    toks, labels = batch(kw, (4, 16), t)
                    p, m, v, loss = step(p, m, v, torch.from_numpy(toks),
                                         torch.from_numpy(labels), t)
                    losses.append(loss.clone())
                runs.append((losses, p))
            (la, pa), (lb, pb) = runs
            assert all(torch.equal(a, b) for a, b in zip(la, lb)), (kw, opt)
            assert all(torch.equal(pa[k], pb[k]) for k in pa), (kw, opt)


def test_sharding_plan_matches_reference():
    from test_torch_sharding import _spec, fake_mesh

    for kw in (DENSE, MOE):
        tcfg, jcfg = t_cfg(kw), j_cfg(kw)
        tplan, jplan = tm.sharding_plan(tcfg), jm.sharding_plan(jcfg)
        for axes in ({"dp": 2, "tp": 2}, {"tp": 2, "sp": 2, "ep": 2},
                     {"ep": 4, "dp": 2}, {"tp": 8}):
            jmesh = jpar.make_mesh(axes)
            for name, (shape, _dt) in tm.param_shapes(tcfg).items():
                assert _spec(tplan.spec_for(name, shape, fake_mesh(**axes))) \
                    == _spec(jplan.spec_for(name, shape, jmesh)), (axes, name)


def test_blocks_of_another_layout_are_refused():
    cfg = t_cfg(DENSE)
    mesh = tpar.make_mesh({"dp": 1}, devices=[torch.device("cpu")])
    p = params_from_numpy(np_params(cfg, 1), cfg, device="cpu")
    p["layer0.ffn_1.weight"] = p["layer0.ffn_1.weight"][:8]
    toks, _ = batch(DENSE, (2, 8), 0)
    with pytest.raises(ValueError, match="layer0.ffn_1.weight"):
        tm.forward(p, torch.from_numpy(toks), cfg, mesh)


# ---------------------------------------------------------------------------
# on the card: the mesh of one over NCCL (chip_smoke.py phase 15's claims)
# ---------------------------------------------------------------------------
CARD = dict(vocab_size=256, num_layers=2, num_heads=2, hidden=128,
            mlp_hidden=256, max_len=64)      # head_dim 64: the flash kernels


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kw", [CARD, dict(CARD, num_experts=4)],
                         ids=["dense", "moe"])
def test_mesh_of_one_over_nccl_is_the_plain_step_on_card(cuda_device,
                                                         tmp_path, kw):
    """bf16, captured: the step on the mesh of one over an NCCL world of
    one rank, its params placed by the plan, is the plain step bit for
    bit (Adam and LAMB, 3 steps), and its first call counts each flash
    kernel twice a step's launches (its eager run and its capture)."""
    import torch.distributed as dist
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    own = not dist.is_initialized()
    if own:
        dist.init_process_group("nccl", init_method=f"file://{tmp_path}/s",
                                rank=0, world_size=1)
    try:
        t = torch.ones(4, device=cuda_device)
        dist.all_reduce(t)                 # the communicator, eagerly
        cfg = tm.TransformerLMConfig(dtype=torch.bfloat16, **kw)
        mesh = tpar.make_mesh({"dp": 1, "fsdp": 1, "tp": 1, "sp": 1,
                               "ep": 1})
        assert mesh.device_mesh is not None
        toks, labels = (torch.from_numpy(a).to(cuda_device)
                        for a in batch(kw, (4, 64), 0))
        for opt in ("adam", "lamb"):
            runs = []
            for on in (None, mesh):
                p = {k: t.to(tm.param_shapes(cfg)[k][1]) for k, t in
                     params_from_numpy(np_params(cfg, 3), cfg,
                                       device=cuda_device).items()}
                if on is not None:
                    p = tm.sharding_plan(cfg).shard_tree(p, on)
                m, v = tm.init_opt_state(p)
                step = tm.make_train_step(cfg, on, optimizer=opt,
                                          device=cuda_device)
                losses = []
                for t_ in (1, 2, 3):
                    c0 = ck.launch_counts()
                    p, m, v, loss = step(p, m, v, toks, labels, t_)
                    c1 = ck.launch_counts()
                    if t_ == 1:
                        assert c1["flash_attention_fwd"] - \
                            c0["flash_attention_fwd"] == \
                            2 * cfg.num_layers
                        assert c1["flash_attention_bwd_dkv"] - \
                            c0["flash_attention_bwd_dkv"] == \
                            2 * cfg.num_layers
                    losses.append(loss.clone())
                runs.append((losses, [x.clone() for d in (p, m, v)
                                      for x in d.values()]))
            (la, sa), (lb, sb) = runs
            assert all(torch.equal(a, b) for a, b in zip(la + sa, lb + sb))
    finally:
        if own:
            dist.destroy_process_group()


def test_blockwise_parameters_need_the_plans_split():
    """Under tp the forward reads the plan's blocks: a weight left whole
    where the plan splits it refuses, naming it."""
    from types import SimpleNamespace

    cfg = t_cfg(DENSE)
    mesh = SimpleNamespace(shape={"tp": 2}, device=torch.device("cpu"),
                           axis_names=("tp",), ranks=(0, 1),
                           coordinate=lambda axis: 0)
    p = params_from_numpy(np_params(cfg, 1), cfg, device="cpu")
    with pytest.raises(ValueError, match="'embed.weight' is placed"):
        ttl._param_specs(p, cfg, mesh)
    # on a tp axis of 1 the plan's split is no split
    one = tpar.make_mesh({"tp": 1}, devices=[torch.device("cpu")])
    p = tm.sharding_plan(cfg).shard_tree(p, one)
    assert ttl._param_specs(p, cfg, one)["layer0.ffn_1.weight"] == ()

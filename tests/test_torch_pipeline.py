"""The port's pipeline parallelism (``mxnet_tpu_torch.parallel.pipeline``:
``pipelined``, ``HeteroPipeline``, the wire checks; and the LM's pp
functions ``make_pp_pipeline``, ``pp_loss_fn``, ``pp_pad_batch``,
``make_pp_train_step``) in a gloo world of 8 processes on the CPU, held
against the JAX package's on its 8 virtual devices and against the
unpipelined programs:

- identical stages over ``pp=8`` (``tests/test_parallel.py:118``) and
  heterogeneous ones over ``pp=2,dp=4``, outputs and, with ``remat``,
  gradients (:141, :180) within 1e-5;
- ``dryrun_multichip`` part 2 (``__graft_entry__.py:116-166``): the LM
  through ``pp=2,dp=4``, four Adam steps against the unpipelined oracle
  within 2e-4, the ragged batch within 1e-4;
- the LM's pp loss and gradients (tied embedding = the sum of the two
  copies' gradients), ten steps of pp training against the unpipelined
  Adam loop, and the ragged batch's gradients (:280, :498, :568);
- the wire checks (``tests/test_pp_step.py:452-521``) and
  ``bubble_fraction``.
"""
import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import models as tm
from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.base import MXNetError
from mxnet_tpu_torch.convert import params_from_numpy
from mxnet_tpu_torch.parallel.mesh import Mesh
from mxnet_tpu_torch.parallel.pipeline import HeteroPipeline, \
    bubble_fraction

from test_torch_package import LazyModule
from test_torch_sharding import run_world

jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
jm = LazyModule("mxnet_tpu.models")
jpar = LazyModule("mxnet_tpu.parallel")
JP = LazyModule("jax.sharding", "PartitionSpec")

CPU = torch.device("cpu")
# dryrun_multichip part 2 (__graft_entry__.py:121-124)
PART2 = dict(vocab_size=128, num_layers=2, num_heads=2, hidden=32,
             mlp_hidden=64, max_len=32)
# tests/test_parallel.py:251-253
SMALL = dict(vocab_size=64, num_layers=2, num_heads=2, hidden=16,
             mlp_hidden=32, max_len=16)


def np_params(kw, seed):
    cfg = tm.TransformerLMConfig(dtype=torch.float32, **kw)
    rng = onp.random.RandomState(seed)
    out = {}
    for name, (shape, _dt) in tm.param_shapes(cfg).items():
        scale = 0.1 if name.endswith(("gamma", "beta")) else 0.05
        base = 1.0 if name.endswith("gamma") else 0.0
        out[name] = (base + scale * rng.randn(*shape)).astype(onp.float32)
    return out


def lm_batches(kw, steps, B, S, seed, mask=True):
    rng = onp.random.RandomState(seed)
    out = []
    for _ in range(steps):
        toks = rng.randint(0, kw["vocab_size"], (B, S)).astype(onp.int32)
        labels = toks.copy() if not mask else \
            rng.randint(0, kw["vocab_size"], (B, S)).astype(onp.int32)
        if mask:
            labels[rng.rand(B, S) < 0.5] = -1
        out.append((toks, labels))
    return out


def _stage_weights():
    rng = onp.random.RandomState(3)
    ws = [(rng.randn(8, 8) * 0.2).astype(onp.float32) for _ in range(8)]
    rng = onp.random.RandomState(7)
    het = dict(w0=(rng.randn(4, 16) * 0.3).astype(onp.float32),
               b0=(rng.randn(16) * 0.1).astype(onp.float32),
               w1=(rng.randn(16, 8) * 0.3).astype(onp.float32),
               x=rng.randn(16, 4).astype(onp.float32),
               y=rng.randn(16, 8).astype(onp.float32))
    return ws, rng.randn(16, 8).astype(onp.float32), het


def _t_stage0(p, a):
    return torch.relu(a @ p["w"] + p["b"])


def _t_stage1(p, a):
    return a @ p["w"]


def t_pp_lm(kw, batches, n_micro, remat, ragged_rows=None):
    """Train the LM through pp=2,dp=4: the losses and, unpacked, the
    final params; the ragged batch's loss and gradient."""
    cfg = tm.TransformerLMConfig(dtype=torch.float32, **kw)
    mesh = tpar.make_mesh({"pp": 2, "dp": 4}, devices=[CPU])
    params = params_from_numpy(np_params(kw, 1), cfg, device="cpu")
    pipe = tm.make_pp_pipeline(cfg, params, mesh, num_microbatches=n_micro,
                               example_tokens=torch.from_numpy(batches[0][0]),
                               remat=remat)
    out = {}
    # the loss and gradient at the initial params
    toks, labels = map(torch.from_numpy, batches[0])
    leaf = pipe.packed_params.clone().requires_grad_()
    loss = tm.pp_loss_fn(pipe, leaf, toks, labels)
    (g,) = torch.autograd.grad(loss, [leaf])
    out["loss0"] = float(loss)
    for j, part in enumerate(pipe.unpack_stage_params(g)):
        for k, a in part.items():
            out[f"g{j}:{k}"] = a.numpy()
    step = tm.make_pp_train_step(pipe, optimizer="adam", lr=1e-3)
    packed = pipe.packed_params.clone()
    m, v = torch.zeros_like(packed), torch.zeros_like(packed)
    for t, (tk, lb) in enumerate(batches, start=1):
        packed, m, v, loss = step(packed, m, v, torch.from_numpy(tk),
                                  torch.from_numpy(lb), t)
        out[f"loss{t}"] = float(loss)
    for j, part in enumerate(pipe.unpack_stage_params(packed)):
        for k, a in part.items():
            out[f"p{j}:{k}"] = a.numpy()
    if ragged_rows is not None:
        rt = torch.from_numpy(batches[0][0][:ragged_rows])
        rl = torch.from_numpy(batches[0][1][:ragged_rows])
        pt, pl = tm.pp_pad_batch(rt, rl, n_micro * 4)
        out["padded_rows"] = pt.shape[0]
        rpipe = tm.make_pp_pipeline(cfg, params, mesh,
                                    num_microbatches=n_micro,
                                    example_tokens=pt)
        leaf = rpipe.packed_params.clone().requires_grad_()
        loss = tm.pp_loss_fn(rpipe, leaf, pt, pl)
        (g,) = torch.autograd.grad(loss, [leaf])
        out["ragged_loss"] = float(loss)
        out["ragged_g0:layer0.attn.qkv.weight"] = \
            rpipe.unpack_stage_params(g)[0]["layer0.attn.qkv.weight"].numpy()
    return out


def world8():
    out = {}
    ws, x8, het = _stage_weights()
    # identical stages over pp=8
    mesh = tpar.make_mesh({"pp": 8}, devices=[CPU])
    stacked = tpar.stack_stage_params([{"w": torch.from_numpy(w)}
                                       for w in ws])
    fn = tpar.pipelined(lambda p, a: torch.tanh(a @ p["w"]), mesh,
                        num_microbatches=4)
    out["pipelined"] = fn(stacked, torch.from_numpy(x8)).numpy()
    # heterogeneous stages over pp=2,dp=4: output and gradients
    mesh = tpar.make_mesh({"pp": 2, "dp": 4}, devices=[CPU])
    t = {k: torch.from_numpy(a) for k, a in het.items()}
    for remat, n_micro in ((False, 2), (True, 4)):
        pipe = HeteroPipeline(
            [_t_stage0, _t_stage1], [{"w": t["w0"], "b": t["b0"]},
                                     {"w": t["w1"]}], mesh,
            num_microbatches=n_micro, example_x=t["x"], remat=remat)
        leaf = pipe.packed_params.clone().requires_grad_()
        y = pipe.apply(leaf, t["x"])
        (g,) = torch.autograd.grad(((y - t["y"]) ** 2).mean(), [leaf])
        key = f"het{n_micro}"
        out[f"{key}|out"] = y.detach().numpy()
        g0, g1 = pipe.unpack_stage_params(g)
        out[f"{key}|gw0"], out[f"{key}|gb0"] = g0["w"].numpy(), \
            g0["b"].numpy()
        out[f"{key}|gw1"] = g1["w"].numpy()
        p0, p1 = pipe.unpack_stage_params()
        out[f"{key}|w0"], out[f"{key}|w1"] = p0["w"].numpy(), \
            p1["w"].numpy()
    # int32 token inputs through the wire (test_pp_step.py:489)
    rng = onp.random.RandomState(0)
    emb = torch.from_numpy((rng.randn(32, 8) * 0.1).astype(onp.float32))
    toks = torch.from_numpy(rng.randint(0, 32, (16, 3)).astype(onp.int32))
    pipe = HeteroPipeline(
        [lambda p, tk: p["emb"][tk.long()],
         lambda p, h: torch.tanh(h @ p["w"])],
        [{"emb": emb}, {"w": torch.eye(8)}], mesh, num_microbatches=2,
        example_x=torch.empty((16, 3), dtype=torch.int32, device="meta"))
    out["tokens"] = pipe.apply(pipe.packed_params, toks).numpy()
    # the LM: dryrun part 2, and the small config's checks
    b2 = lm_batches(PART2, 4, 16, 16, 2, mask=False)
    for k, a in t_pp_lm(PART2, b2, 2, True, ragged_rows=15).items():
        out[f"part2|{k}"] = a
    bs = lm_batches(SMALL, 10, 8, 16, 3)
    for k, a in t_pp_lm(SMALL, bs, 2, False, ragged_rows=6).items():
        out[f"small|{k}"] = a
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return [r["world8"] for r in run_world(
        8, [f"{__name__}:world8"], tmp_path_factory.mktemp("pp"))]


def _part(res, prefix):
    return {k[len(prefix) + 1:]: v for k, v in res.items()
            if k.startswith(prefix + "|")}


def test_pipeline_matches_sequential(world):
    ws, x8, _het = _stage_weights()
    want = x8
    for w in ws:
        want = onp.tanh(want @ w)
    mesh = jpar.make_mesh({"pp": 8})
    stacked = jpar.stack_stage_params([{"w": jnp.asarray(w)} for w in ws])
    fn = jpar.pipelined(lambda p, a: jnp.tanh(a @ p["w"]), mesh,
                        num_microbatches=4, axis_name="pp",
                        param_spec={"w": JP("pp", None, None)}, x_spec=JP())
    ref = onp.asarray(fn(stacked, jnp.asarray(x8)))
    for res in world:
        onp.testing.assert_allclose(res["pipelined"], want, atol=1e-5)
        onp.testing.assert_allclose(res["pipelined"], ref, atol=1e-5)


@pytest.mark.parametrize("n_micro", [2, 4])
def test_hetero_pipeline_matches_sequential_and_reference(world, n_micro):
    _ws, _x8, het = _stage_weights()
    t = {k: torch.from_numpy(a).requires_grad_() for k, a in het.items()
         if k in ("w0", "b0", "w1")}
    x, y = torch.from_numpy(het["x"]), torch.from_numpy(het["y"])
    out = _t_stage1({"w": t["w1"]}, _t_stage0({"w": t["w0"],
                                               "b": t["b0"]}, x))
    gw0, gb0, gw1 = torch.autograd.grad(((out - y) ** 2).mean(),
                                        [t["w0"], t["b0"], t["w1"]])
    # the reference's pipeline on the same mesh shape
    mesh = jpar.make_mesh({"pp": 2, "dp": 4})
    jw = {k: jnp.asarray(het[k]) for k in ("w0", "b0", "w1")}
    pipe = jpar.HeteroPipeline(
        [lambda p, a: jax.nn.relu(a @ p["w"] + p["b"]),
         lambda p, a: a @ p["w"]],
        [{"w": jw["w0"], "b": jw["b0"]}, {"w": jw["w1"]}], mesh,
        num_microbatches=n_micro, example_x=jnp.asarray(het["x"]),
        remat=n_micro == 4)
    jg = jax.grad(lambda pk: jnp.mean((pipe.apply(pk, jnp.asarray(het["x"]))
                                       - het["y"]) ** 2))(pipe.packed_params)
    jg0, jg1 = pipe.unpack_stage_params(jg)
    for res in world:
        got = _part(res, f"het{n_micro}")
        onp.testing.assert_allclose(got["out"], out.detach().numpy(),
                                    atol=1e-5)
        assert onp.array_equal(got["w0"], het["w0"])
        assert onp.array_equal(got["w1"], het["w1"])
        for k, want, ref in (("gw0", gw0, jg0["w"]), ("gb0", gb0, jg0["b"]),
                             ("gw1", gw1, jg1["w"])):
            onp.testing.assert_allclose(got[k], want.numpy(), atol=1e-5,
                                        err_msg=k)
            onp.testing.assert_allclose(got[k], onp.asarray(ref), atol=1e-5,
                                        err_msg=k)


def test_int32_tokens_cross_the_wire(world):
    rng = onp.random.RandomState(0)
    emb = (rng.randn(32, 8) * 0.1).astype(onp.float32)
    toks = rng.randint(0, 32, (16, 3))
    want = onp.tanh(emb[toks])
    for res in world:
        onp.testing.assert_allclose(res["tokens"], want, rtol=1e-6,
                                    atol=1e-6)


def _oracle(kw, batches, lr=1e-3):
    """The unpipelined reference: the JAX package's loss_fn and Adam in
    tree space, as ``make_pp_train_step``'s (wd=0)."""
    cfg = jm.TransformerLMConfig(dtype=jnp.float32, **kw)
    params = {k: jnp.asarray(a) for k, a in np_params(kw, 1).items()}
    tmap = jax.tree_util.tree_map
    toks, labels = map(jnp.asarray, batches[0])
    loss0, g0 = jax.value_and_grad(
        lambda p: jm.loss_fn(p, toks, labels, cfg))(params)
    m = tmap(jnp.zeros_like, params)
    v = tmap(jnp.zeros_like, params)
    losses = []
    for t, (tk, lb) in enumerate(batches, start=1):
        loss, g = jax.value_and_grad(
            lambda p: jm.loss_fn(p, jnp.asarray(tk), jnp.asarray(lb),
                                 cfg))(params)
        m = tmap(lambda a, b: 0.9 * a + 0.1 * b, m, g)
        v = tmap(lambda a, b: 0.999 * a + 0.001 * jnp.square(b), v, g)
        lr_t = lr * onp.sqrt(1 - 0.999 ** t) / (1 - 0.9 ** t)
        params = tmap(lambda w, a, b: w - lr_t * a / (jnp.sqrt(b) + 1e-8),
                      params, m, v)
        losses.append(float(loss))
    return cfg, float(loss0), g0, losses, params


@pytest.mark.parametrize("which,kw,seed,rows", [
    ("part2", PART2, 2, 15), ("small", SMALL, 3, 6)])
def test_pp_lm_matches_the_unpipelined_oracle(world, which, kw, seed, rows):
    if which == "part2":
        batches = lm_batches(PART2, 4, 16, 16, seed, mask=False)
    else:
        batches = lm_batches(SMALL, 10, 8, 16, seed)
    cfg, loss0, g0, losses, params = _oracle(kw, batches)
    got = _part(world[0], which)
    # the loss and gradients at the initial params; the tied embedding's
    # gradient is the sum of its two copies'
    assert abs(float(got["loss0"]) - loss0) < 1e-4
    for name in ("layer0.attn.qkv.weight", "layer1.ffn_2.weight"):
        stage = 0 if name.startswith("layer0") else 1
        onp.testing.assert_allclose(got[f"g{stage}:{name}"],
                                    onp.asarray(g0[name]), atol=1e-4,
                                    err_msg=name)
    onp.testing.assert_allclose(
        got["g0:embed.weight"] + got["g1:head.weight"],
        onp.asarray(g0["embed.weight"]), atol=1e-4)
    # every step's loss against the oracle's (part 2: 2e-4 absolute)
    onp.testing.assert_allclose(
        [float(got[f"loss{t}"]) for t in range(1, len(batches) + 1)],
        losses, rtol=2e-4, atol=2e-4)
    # the tied copies stay tied, and the params track the oracle's
    onp.testing.assert_array_equal(got["p0:embed.weight"],
                                   got["p1:head.weight"])
    for name, a in params.items():
        stage = 0 if name.startswith(("embed", "pos_embed", "layer0")) \
            else 1
        onp.testing.assert_allclose(got[f"p{stage}:{name}"], onp.asarray(a),
                                    atol=2e-4, err_msg=name)
    # the ragged batch, padded with label -1 rows: the unpadded loss, and
    # the unpadded gradient
    assert int(got["padded_rows"]) == (16 if which == "part2" else 8)
    tk, lb = (jnp.asarray(a[:rows]) for a in batches[0])
    r_loss, r_g = jax.value_and_grad(
        lambda p: jm.loss_fn(p, tk, lb, cfg))(
        {k: jnp.asarray(a) for k, a in np_params(kw, 1).items()})
    assert abs(float(got["ragged_loss"]) - float(r_loss)) < 1e-4
    onp.testing.assert_allclose(got["ragged_g0:layer0.attn.qkv.weight"],
                                onp.asarray(r_g["layer0.attn.qkv.weight"]),
                                atol=1e-4)


def test_every_rank_holds_the_same_results(world):
    want = world[0]
    for rank, res in enumerate(world[1:], start=1):
        for k, w in want.items():
            assert onp.array_equal(res[k], w), (rank, k)


# ---------------------------------------------------------------------------
# in this process: the wire checks and the schedule's arithmetic
# ---------------------------------------------------------------------------
def _mesh(pp=1, dp=1):
    """A mesh of the given shape for the construction-time checks (which
    run before any collective)."""
    return Mesh(("pp", "dp"), CPU, shape={"pp": pp, "dp": dp})


def test_wire_rejects_wide_int_param_by_name():
    big = {"count": torch.tensor([2 ** 24 + 1], dtype=torch.int32)}
    with pytest.raises(MXNetError, match=r"stage 0 param.*count.*2\*\*24"):
        HeteroPipeline([lambda p, x: x], [big], _mesh(),
                       num_microbatches=1, example_x=torch.zeros(2, 4))


def test_wire_rejects_abstract_int_boundary():
    def s0(params, x):
        return torch.argmax(x, dim=-1).to(torch.int32)

    with pytest.raises(MXNetError, match="stage 0 output boundary.*int32"):
        HeteroPipeline([s0, lambda p, ids: ids.float()], [{}, {}],
                       _mesh(pp=2), num_microbatches=1,
                       example_x=torch.zeros(2, 4))


def test_wire_narrow_and_small_ints_pass():
    def fn(params, x):
        return x * params["scale"].float().sum()

    ok = {"scale": torch.tensor([3, -7], dtype=torch.int32),
          "flags": torch.tensor([1, 0], dtype=torch.int16)}
    pipe = HeteroPipeline([fn], [ok], _mesh(), num_microbatches=1,
                          example_x=torch.zeros(2, 4))
    (got,) = pipe.unpack_stage_params()
    assert got["scale"].tolist() == [3, -7]
    assert got["flags"].tolist() == [1, 0]
    assert got["scale"].dtype == torch.int32
    # a concrete int64 example input within 2**24 passes, an abstract one
    # refuses (the reference's rule for 64-bit inputs)
    HeteroPipeline([fn], [ok], _mesh(), num_microbatches=1,
                   example_x=torch.zeros(2, 4, dtype=torch.int64))
    with pytest.raises(MXNetError, match="64-bit"):
        HeteroPipeline([fn], [ok], _mesh(), num_microbatches=1,
                       example_x=torch.empty(2, 4, dtype=torch.int64,
                                             device="meta"))


def test_bubble_fraction_math():
    assert bubble_fraction(1, 4) == 0.0
    assert bubble_fraction(2, 2) == pytest.approx(1 / 3)
    assert bubble_fraction(4, 12) == pytest.approx(3 / 15)
    assert bubble_fraction(4, 32) < bubble_fraction(4, 8)
    assert bubble_fraction(4, 12) == jpar.pipeline.bubble_fraction(4, 12)


def test_leaf_slices_and_ties_match_the_reference_layout():
    """The packed layout is the reference's (leaves in key order), so a
    leaf's (offset, size) and the tied sum are the same."""
    rng = onp.random.RandomState(0)
    s0 = {"b": rng.randn(3).astype(onp.float32),
          "a": rng.randn(2, 2).astype(onp.float32)}
    s1 = {"a": rng.randn(2, 2).astype(onp.float32)}
    tpipe = HeteroPipeline(
        [lambda p, x: x, lambda p, x: x],
        [{k: torch.from_numpy(v) for k, v in s.items()} for s in (s0, s1)],
        _mesh(pp=2), num_microbatches=1, example_x=torch.zeros(2, 4))
    jpipe = jpar.HeteroPipeline(
        [lambda p, x: x, lambda p, x: x],
        [{k: jnp.asarray(v) for k, v in s.items()} for s in (s0, s1)],
        jpar.make_mesh({"pp": 2}), num_microbatches=1,
        example_x=jnp.zeros((2, 4)))
    assert onp.array_equal(tpipe.packed_params.numpy(),
                           onp.asarray(jpipe.packed_params))
    for stage, key in ((0, "a"), (0, "b"), (1, "a")):
        assert tpipe.leaf_slice(stage, key) == jpipe.leaf_slice(stage, key)
    g = rng.randn(*tpipe.packed_params.shape).astype(onp.float32)
    ties = (((0, "a"), (1, "a")),)
    onp.testing.assert_array_equal(
        tpipe.tie_grads(torch.from_numpy(g), ties).numpy(),
        onp.asarray(jpipe.tie_grads(jnp.asarray(g), ties)))


# ---------------------------------------------------------------------------
# on the card: the pipeline at pp=1 (chip_smoke.py phase 15's claims)
# ---------------------------------------------------------------------------
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("n_micro", [2, 4])
def test_pp1_pipeline_on_card_is_the_unpipelined_step(cuda_device, n_micro):
    """fp32, head_dim 64 (the flash kernels' fp32 path): four captured pp
    steps at pp=1 take the unpipelined Adam steps' losses within 2e-4,
    and the first call counts each flash kernel ``n_micro`` x the layers
    twice (its eager run and its capture)."""
    from mxnet_tpu_torch.ops import cuda_kernels as ck

    kw = dict(vocab_size=256, num_layers=2, num_heads=2, hidden=128,
              mlp_hidden=256, max_len=64)
    cfg = tm.TransformerLMConfig(dtype=torch.float32, **kw)
    mesh = tpar.make_mesh({"pp": 1, "dp": 1}, devices=[cuda_device])
    batches = lm_batches(kw, 4, 8, 64, 5)
    params = params_from_numpy(np_params(kw, 1), cfg, device=cuda_device)
    toks = [(torch.from_numpy(a).to(cuda_device),
             torch.from_numpy(b).to(cuda_device)) for a, b in batches]
    pipe = tm.make_pp_pipeline(cfg, params, mesh, num_microbatches=n_micro,
                               example_tokens=toks[0][0])
    step = tm.make_pp_train_step(pipe, optimizer="adam", lr=1e-3)
    packed = pipe.packed_params.clone()
    m, v = torch.zeros_like(packed), torch.zeros_like(packed)
    losses = []
    for t, (tk, lb) in enumerate(toks, start=1):
        c0 = ck.launch_counts()
        packed, m, v, loss = step(packed, m, v, tk, lb, t)
        c1 = ck.launch_counts()
        if t == 1:
            for name in ("flash_attention_fwd", "flash_attention_bwd_dq",
                         "flash_attention_bwd_dkv"):
                assert c1[name] - c0[name] == \
                    2 * n_micro * cfg.num_layers, name
        losses.append(loss.item())
    # the unpipelined Adam loop on the same device
    plain = tm.make_train_step(cfg, optimizer="adam", lr=1e-3, wd=0.0,
                               device=cuda_device)
    pm, vm = tm.init_opt_state(params)
    want = [plain(params, pm, vm, tk, lb, t)[3].item()
            for t, (tk, lb) in enumerate(toks, start=1)]
    onp.testing.assert_allclose(losses, want, rtol=2e-4, atol=2e-4)

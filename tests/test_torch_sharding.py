"""The port's mesh placement rules and collectives
(``mxnet_tpu_torch.parallel.{mesh,sharding,collectives,spmd}``) held
against the JAX package's (``mxnet_tpu.parallel``) on the CPU:

- in one process, spec for spec over a table of shapes and mesh shapes:
  ``spmd.param_spec`` (the ``fsdp`` rule, the floor, the loud fallback),
  ``fsdp_plan``, ``tensor_parallel_plan``, ``expert_parallel_plan``,
  ``_legalize`` and ``batch_spec_for`` with their refusal counters, against
  the reference on its 8 virtual devices (mirrors
  ``tests/test_fsdp_step.py:152-185``);
- ``spmd.resolve_mesh``'s forms and errors, without a world and in one;
- in a gloo world of 8 processes on the CPU (one world for the file, its
  scenarios run in one go): every collective inside ``run_sharded``
  (psum / pmean / all_gather / reduce_scatter / all_to_all / ring_shift /
  ppermute / broadcast_from / axis_index) against the reference's
  ``run_sharded`` over the same global inputs, bitwise for the moves and
  within fp32 rounding for the sums; ``make_mesh`` over the world, and
  ``constraint`` turning a ``tp`` axis into a DTensor layout.

``run_world`` is the harness of the port's multi-process tests: one
``torch.distributed`` gloo world of spawned processes over a ``file://``
store in the test's temporary directory (never a fixed port: xdist
workers would collide), one intra-op thread a rank, joined with a
deadline so that a hang fails the test; every rank saves its results with
``numpy.savez``, so that a test can hold each rank to the others. A rank
imports this module under ``spawn``, so the reference is imported only
inside the tests (``LazyModule``).
"""
import importlib
import multiprocessing
import os
import time
from types import SimpleNamespace

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch.parallel import collectives as tcoll
from mxnet_tpu_torch.parallel import mesh as tmesh
from mxnet_tpu_torch.parallel import sharding as tsh
from mxnet_tpu_torch.parallel import spmd as tspmd

from test_torch_package import LazyModule

jax = LazyModule("jax")
jnp = LazyModule("jax.numpy")
jpar = LazyModule("mxnet_tpu.parallel")
jsh = LazyModule("mxnet_tpu.parallel.sharding")
jspmd = LazyModule("mxnet_tpu.parallel.spmd")
jcoll = LazyModule("mxnet_tpu.parallel.collectives")
JP = LazyModule("jax.sharding", "PartitionSpec")

WORLD_DEADLINE_S = 150.0


# ---------------------------------------------------------------------------
# the gloo world harness
# ---------------------------------------------------------------------------
def _rank_main(rank, world, store, scenarios, out_dir, env):
    os.environ.update(env)
    torch.set_num_threads(1)
    import torch.distributed as dist

    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    try:
        results = {}
        for name in scenarios:
            mod, fn = name.split(":")
            got = getattr(importlib.import_module(mod), fn)()
            for k, v in got.items():
                results[f"{fn}/{k}"] = onp.asarray(v)
        onp.savez(os.path.join(out_dir, f"rank{rank}.npz"), **results)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def run_world(world, scenarios, tmp_dir, env=None,
              deadline=WORLD_DEADLINE_S):
    """Run the ``module:function`` scenarios, in order, on every rank of a
    gloo world of ``world`` spawned processes; each rank's results, in
    rank order, as ``{function: {key: array}}``. A rank that fails or a
    world that outlives ``deadline`` fails the caller."""
    ctx = multiprocessing.get_context("spawn")
    store = os.path.join(str(tmp_dir), "store")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, world, store, list(scenarios),
                               str(tmp_dir), dict(env or {})))
             for r in range(world)]
    for p in procs:
        p.start()
    end = time.monotonic() + deadline
    for p in procs:
        p.join(max(end - time.monotonic(), 0.0))
    hung = [p for p in procs if p.is_alive()]
    for p in hung:
        p.kill()
        p.join()
    assert not hung, f"world of {world} outlived its {deadline} s deadline"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * world, f"ranks exited with {codes}"
    ranks = []
    for r in range(world):
        res = {}
        with onp.load(os.path.join(str(tmp_dir), f"rank{r}.npz")) as npz:
            for key in npz.files:
                fn, _, k = key.partition("/")
                res.setdefault(fn, {})[k] = npz[key]
        ranks.append(res)
    return ranks


def fake_mesh(**shape):
    """A mesh for the spec functions, which read only ``.shape``."""
    return SimpleNamespace(shape=dict(shape))


def jax_mesh(axes):
    return jpar.make_mesh(dict(axes))


def _spec(s):
    """A spec as a plain tuple, trailing Nones dropped (both packages'
    legalized specs end in a sharded dim)."""
    t = tuple(tuple(a) if isinstance(a, list) else a for a in tuple(s))
    while t and t[-1] is None:
        t = t[:-1]
    return t


MESHES = [{"dp": 8}, {"dp": 2, "fsdp": 4}, {"dp": 4, "fsdp": 2},
          {"dp": 2, "fsdp": 2, "tp": 2}, {"dp": 1, "fsdp": 8},
          {"dp": 2, "tp": 4}]
SHAPES = [(), (4,), (16,), (16, 8), (8, 16), (15, 3), (12, 6), (6, 12, 4),
          (3, 5, 7), (64, 64), (1024,), (2, 2)]


# ---------------------------------------------------------------------------
# placement rules in one process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("min_size", [1, 16, 1024])
def test_param_spec_table_matches_reference(min_size):
    for axes in MESHES:
        jm, tm = jax_mesh(axes), fake_mesh(**axes)
        for shape in SHAPES:
            jsh.reset_legalize_refusals()
            tsh.reset_legalize_refusals()
            want = jspmd.param_spec(shape, jm, min_size=min_size)
            got = tspmd.param_spec(shape, tm, min_size=min_size)
            assert _spec(got) == _spec(want), (axes, shape)
            assert tsh.legalize_refusal_count() == \
                jsh.legalize_refusal_count(), (axes, shape)


def test_param_spec_reads_the_floor_knob(monkeypatch):
    monkeypatch.setenv("MXNET_FSDP_MIN_SIZE", "200")
    tm = fake_mesh(dp=2, fsdp=2)
    assert tspmd.param_spec((16, 8), tm) == ()
    assert tspmd.param_spec((32, 8), tm) == ("fsdp", None)
    # the reference's own pins (test_fsdp_step.py:168-185)
    assert tspmd.param_spec((16, 8), tm, min_size=1) == ("fsdp", None)
    assert tspmd.param_spec((8, 16), tm, min_size=1) == (None, "fsdp")
    tsh.reset_legalize_refusals()
    assert tspmd.param_spec((15, 3), tm, min_size=1) == ()
    assert tsh.legalize_refusal_count() == 1


NAMES = ["0.weight", "0.bias", "d1.weight", "ffn_1.weight", "ffn_1.bias",
         "ffn_2.weight", "attn.qkv.weight", "attn.out_proj.weight",
         "embed.weight", "expert.ffn_1.weight", "moe.expert.w", "gate.weight",
         "norm.gamma"]


@pytest.mark.parametrize("plan", ["replicated", "fsdp", "fsdp_floor", "tp",
                                  "ep", "fsdp+tp"])
def test_plans_match_reference(plan):
    def make(mod):
        if plan == "replicated":
            return mod.replicated_plan()
        if plan == "fsdp":
            return mod.fsdp_plan(min_size=1)
        if plan == "fsdp_floor":
            return mod.fsdp_plan()
        if plan == "tp":
            return mod.tensor_parallel_plan()
        if plan == "ep":
            return mod.expert_parallel_plan()
        return mod.tensor_parallel_plan().extend(mod.fsdp_plan(min_size=1))

    jp, tp = make(jsh), make(tsh)
    for axes in MESHES + [{"dp": 2, "ep": 4}]:
        jm, tm = jax_mesh(axes), fake_mesh(**axes)
        for name in NAMES:
            for shape in SHAPES:
                if not shape:
                    continue
                assert _spec(tp.spec_for(name, shape, tm)) == \
                    _spec(jp.spec_for(name, shape, jm)), (axes, name, shape)


@pytest.mark.parametrize("loud", [False, True])
def test_legalize_and_its_refusals_match_reference(loud, recwarn):
    specs = [("dp",), ("fsdp", None), (None, "tp"), (("dp", "fsdp"),),
             ("tp", "dp"), ("sp",), ("nope",), (("fsdp", "tp"), None)]
    for axes in MESHES:
        jm, tm = jax_mesh(axes), fake_mesh(**axes)
        for spec in specs:
            for shape in SHAPES[1:]:
                jsh.reset_legalize_refusals()
                tsh.reset_legalize_refusals()
                want = jsh._legalize(JP(*spec), shape, jm, loud=loud)
                got = tsh._legalize(tsh.PartitionSpec(*spec), shape, tm,
                                    loud=loud)
                assert _spec(got) == _spec(want), (axes, spec, shape)
                assert tsh.legalize_refusal_count() == \
                    jsh.legalize_refusal_count()


def test_batch_spec_for_counts_replication_as_the_reference():
    for axes in MESHES:
        jm, tm = jax_mesh(axes), fake_mesh(**axes)
        for shape in [(16, 8), (6, 8), (7,), (), (8,), (12, 3, 2)]:
            jspmd.reset_counters()
            tspmd.reset_counters()
            with _quiet():
                want = jspmd.batch_spec_for(shape, jm)
                got = tspmd.batch_spec_for(shape, tm)
            assert _spec(got) == _spec(want), (axes, shape)
            assert tspmd.replicated_batch_count() == \
                jspmd.replicated_batch_count(), (axes, shape)


class _quiet:
    def __enter__(self):
        import warnings

        self._w = warnings.catch_warnings()
        self._w.__enter__()
        warnings.simplefilter("ignore")

    def __exit__(self, *exc):
        return self._w.__exit__(*exc)


def test_constraint_without_a_mesh_is_a_no_op_and_typos_raise():
    x = torch.ones(4, 8)
    assert tsh.constraint(x, ("dp", "tp")) is x
    with tmesh.mesh_scope(tmesh.make_mesh({"dp": 1},
                                          devices=[torch.device("cpu")])):
        # canonical axes the mesh lacks legalize away, a typo raises
        assert tsh.constraint(x, ("dp", "tp")) is x
        with pytest.raises(ValueError, match="typo"):
            tsh.constraint(x, ("dp", "tpp"))


def test_resolve_mesh_forms_and_errors_without_a_world(monkeypatch):
    for off in ("off", "0", "none", "disabled"):
        monkeypatch.setenv("MXNET_SPMD_MESH", off)
        assert tspmd.resolve_mesh() is None
    monkeypatch.setenv("MXNET_SPMD_MESH", "auto")
    assert tspmd.resolve_mesh() is None           # a world of one
    with pytest.raises(ValueError, match="needs 4 devices"):
        tspmd.resolve_mesh("4")
    with pytest.raises(ValueError, match="needs 8 devices"):
        tspmd.resolve_mesh("dp=2,fsdp=2,tp=2")
    with pytest.raises(ValueError, match="must name the 'dp' axis"):
        tspmd.resolve_mesh("fsdp=2")
    assert tspmd.mesh_for_store("device") is None
    assert tspmd.mesh_for_store(None) is None
    # the reference raises the same ways (its world has 8 devices)
    with pytest.raises(ValueError, match="devices"):
        jspmd.resolve_mesh("dp=2,fsdp=64")
    with pytest.raises(ValueError, match="dp"):
        jspmd.resolve_mesh("fsdp=2")


def test_make_mesh_orders_axes_and_auto_mesh_fills_dp():
    cpu = [torch.device("cpu")]
    m = tmesh.make_mesh({"tp": 1, "dp": 1, "fsdp": 1, "zz": 1}, devices=cpu)
    assert m.axis_names == ("dp", "fsdp", "tp", "zz")
    assert m.size == 1 and m.ranks == (0,) and m.device_mesh is None
    with pytest.raises(ValueError, match="needs 2 devices"):
        tmesh.make_mesh({"dp": 2}, devices=cpu)
    with pytest.raises(ValueError, match="strand"):
        tmesh.auto_mesh(1, dp=2)
    assert tmesh.current_mesh() is None
    with tmesh.mesh_scope(m):
        assert tmesh.current_mesh() is m
    assert tmesh.current_mesh() is None


def test_collectives_on_a_mesh_without_a_world_are_their_definitions():
    m = tmesh.make_mesh({"dp": 1}, devices=[torch.device("cpu")])
    x = torch.arange(8.0).reshape(2, 4)
    for got in (tcoll.all_reduce(x, "dp", mesh=m), tcoll.pmean(x, "dp", m),
                tcoll.all_gather(x, "dp", mesh=m),
                tcoll.reduce_scatter(x, "dp", mesh=m),
                tcoll.all_to_all(x, "dp", 1, 0, mesh=m),
                tcoll.ring_shift(x, "dp", mesh=m),
                tcoll.broadcast_from(x, "dp", mesh=m)):
        assert torch.equal(got, x)
    assert tcoll.axis_index("dp", m) == 0 and tcoll.axis_size("dp", m) == 1


# ---------------------------------------------------------------------------
# a gloo world of 8: collectives against the reference's run_sharded
# ---------------------------------------------------------------------------
COLL_MESH = {"dp": 2, "fsdp": 2, "tp": 2}


def _coll_inputs():
    rng = onp.random.RandomState(0)
    return {"x": rng.randn(8, 12).astype(onp.float32),
            "y": rng.randn(16, 4).astype(onp.float32)}


def _coll_programs(c, P):
    """name -> (fn, in_spec, out_spec, input) over c's collectives (the
    port's and the reference's modules share the names)."""
    return {
        "psum": (lambda x: c.all_reduce(x, "tp"), P("dp"), P("dp"), "x"),
        "psum_2axes": (lambda x: c.all_reduce(x, ("dp", "fsdp")),
                       P(("dp", "fsdp")), P(("dp", "fsdp")), "y"),
        "pmean": (lambda x: c.pmean(x, "fsdp"), P(("dp", "fsdp", "tp")),
                  P(("dp", "fsdp", "tp")), "x"),
        "max": (lambda x: c.all_reduce(x, "dp", op="max"), P("dp"), P("dp"),
                "x"),
        "all_gather": (lambda x: c.all_gather(x, "tp", axis=1),
                       P(None, "tp"), P(None, None), "x"),
        "all_gather_stack": (lambda x: c.all_gather(x, "dp", tiled=False),
                             P("dp"), P(None, "fsdp"), "x"),
        "reduce_scatter": (lambda x: c.reduce_scatter(x, "fsdp", axis=0),
                           P(None), P("fsdp"), "y"),
        "all_to_all": (lambda x: c.all_to_all(x, "tp", 1, 0), P("tp"),
                       P("tp"), "y"),
        "ring_shift": (lambda x: c.ring_shift(x, "dp"), P("dp"), P("dp"),
                       "x"),
        "ring_shift_back": (lambda x: c.ring_shift(x, "tp", shift=-1),
                            P(("dp", "tp")), P(("dp", "tp")), "y"),
        "ppermute": (lambda x: c.ppermute(x, "fsdp", [(0, 1)]),
                     P(("fsdp", "tp")), P(("fsdp", "tp")), "y"),
        "broadcast_from": (lambda x: c.broadcast_from(x, "dp", src=1),
                           P("dp"), P("dp"), "x"),
    }


def world8_collectives():
    """(rank side) every collective through the port's run_sharded."""
    mesh = tmesh.make_mesh(COLL_MESH, devices=[torch.device("cpu")])
    ins = _coll_inputs()
    out = {}
    for name, (fn, i_s, o_s, arg) in _coll_programs(
            tcoll, tsh.PartitionSpec).items():
        f = tcoll.run_sharded(fn, mesh, (i_s,), o_s)
        out[name] = f(torch.from_numpy(ins[arg])).numpy()
    # axis_index and axis_size, as the reference's psum(1) / axis_index
    idx = tcoll.run_sharded(
        lambda x: x + (tcoll.axis_index("fsdp") * 10
                       + tcoll.axis_size("tp")),
        mesh, (tsh.PartitionSpec(("dp", "fsdp", "tp")),),
        tsh.PartitionSpec(("dp", "fsdp", "tp")))
    out["axis_index"] = idx(torch.zeros(8)).numpy()
    out["mesh_shape"] = onp.array([mesh.shape[a] for a in mesh.axis_names])
    out["mesh_names"] = onp.array(mesh.axis_names)
    out["ranks"] = onp.array(mesh.ranks)
    # resolve_mesh over the world
    m = tspmd.resolve_mesh("dp=2,fsdp=2,tp=2")
    out["resolved"] = onp.array([m.shape["dp"], m.shape["fsdp"],
                                 m.shape["tp"]])
    out["auto"] = onp.array(tspmd.resolve_mesh("auto").shape["dp"])
    try:
        tspmd.resolve_mesh("dp=2,fsdp=2")
        out["size_error"] = onp.array(0)
    except ValueError as e:
        out["size_error"] = onp.array("needs 4 devices" in str(e))
    # constraint on tp: a DTensor sharded on the feature dim, the batch
    # axis (dp) of the running step already real
    with tspmd.data_parallel(mesh, ("dp",)):
        h = torch.arange(24.0).reshape(2, 12)
        dt = tsh.constraint(h, ("dp", "tp"), mesh=mesh)
    out["constraint_local"] = dt.to_local().numpy()
    out["constraint_full"] = dt.full_tensor().numpy()
    return out


@pytest.fixture(scope="module")
def world8(tmp_path_factory):
    return run_world(8, [f"{__name__}:world8_collectives"],
                     tmp_path_factory.mktemp("world8_coll"))


def _reference_collectives():
    mesh = jax_mesh(COLL_MESH)
    ins = _coll_inputs()
    out = {}
    for name, (fn, i_s, o_s, arg) in _coll_programs(jcoll, JP).items():
        f = jcoll.run_sharded(fn, mesh, (i_s,), o_s)
        with mesh:
            out[name] = onp.asarray(f(jnp.asarray(ins[arg])))
    return out


def test_collectives_match_reference_run_sharded(world8):
    got = world8[0]["world8_collectives"]
    want = _reference_collectives()
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if name.startswith(("psum", "pmean", "reduce_scatter")):
            onp.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6,
                                        err_msg=name)
        else:
            assert onp.array_equal(g, w), name


def test_axis_index_and_the_world_mesh(world8):
    got = world8[0]["world8_collectives"]
    # rank r of the (dp, fsdp, tp) mesh holds element r: fsdp index * 10 +
    # tp size
    want = onp.array([(r // 2) % 2 * 10 + 2 for r in range(8)],
                     dtype=onp.float32)
    assert onp.array_equal(got["axis_index"], want)
    assert list(got["mesh_names"]) == ["dp", "fsdp", "tp"]
    assert list(got["mesh_shape"]) == [2, 2, 2]
    assert list(got["ranks"]) == list(range(8))
    assert list(got["resolved"]) == [2, 2, 2]
    assert int(got["auto"]) == 8
    assert bool(got["size_error"])


def test_constraint_makes_the_tp_layout_a_dtensor(world8):
    full = onp.arange(24.0, dtype=onp.float32).reshape(2, 12)
    for rank, res in enumerate(world8):
        got = res["world8_collectives"]
        assert onp.array_equal(got["constraint_full"], full)
        # tp is the fastest axis: rank r holds tp block r % 2 of the
        # features
        t = rank % 2
        assert onp.array_equal(got["constraint_local"],
                               full[:, 6 * t:6 * (t + 1)]), rank


def test_every_rank_sees_the_same_global_results(world8):
    """run_sharded returns global arrays: every rank's are rank 0's,
    bitwise, and every rank resolves the same mesh."""
    want = world8[0]["world8_collectives"]
    for rank, res in enumerate(world8[1:], start=1):
        got = res["world8_collectives"]
        assert set(got) == set(want)
        for k, w in want.items():
            if k == "constraint_local":
                continue                    # this rank's block
            assert onp.array_equal(got[k], w), (rank, k)


def test_a_new_world_makes_its_own_device_mesh(tmp_path):
    """A world made after one was destroyed gets DeviceMeshes of its own:
    the cache never hands back groups of a destroyed world."""
    import torch.distributed as dist

    if dist.is_initialized():
        pytest.skip("a world is already initialized in this process")
    meshes = []
    for i in range(2):
        dist.init_process_group("gloo", init_method=f"file://{tmp_path}/s{i}",
                                rank=0, world_size=1)
        try:
            m = tmesh.make_mesh({"dp": 1, "tp": 1})
            assert m.device_mesh is not None
            assert tmesh.make_mesh({"dp": 1, "tp": 1}).device_mesh \
                is m.device_mesh                       # reused in a world
            # and nothing of a destroyed world is kept
            assert list(tmesh._DEVICE_MESHES.values()) == [m.device_mesh]
            x = torch.arange(4.0)
            assert torch.equal(tcoll.all_reduce(x, ("dp", "tp"), mesh=m), x)
            meshes.append(m.device_mesh)
        finally:
            dist.destroy_process_group()
    assert meshes[0] is not meshes[1]

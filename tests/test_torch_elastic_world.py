"""Checkpoints, the sentinel's digest, the preemption drain and the
quarantine on meshes of several ranks: a gloo world of 8 CPU processes
(``test_torch_sharding.run_world``).

- ``restore(like=)`` of a packed pipeline stage buffer placed
  ``P('pp', None)`` on pp=2,dp=2,fsdp=2, re-placed on pp=2,dp=4 bit-exactly
  (the reference's ``test_pp_step.py:376``);
- expert weights placed ``P('ep')`` by ``spmd.param_spec``'s name rule on
  ep=4,dp=2, restored on ep=2,dp=4: a real re-split of the [E, ...] leaves
  (``test_moe_step.py:283``);
- ``sentinel.tree_digest`` of pp-sharded and replicated placements equal
  to each other and to the reference's digest of the host array
  (``test_pp_step.py:401``);
- a preemption notice inside ``run_elastic`` force-saves the last
  completed step of pp-sharded state on every rank, restored with its
  placement (``test_pp_step.py:418``);
- a quarantine persisted by one rank read by all, its rank's device left
  out of every rank's ``admitted_devices``.
"""
import os
from types import SimpleNamespace

import numpy as onp
import torch

from test_torch_package import LazyModule
from test_torch_sharding import run_world

jsentinel = LazyModule("mxnet_tpu.sentinel")

STAGES = onp.random.RandomState(2).randn(2, 64).astype(onp.float32)
EXPERTS = onp.random.RandomState(5).randn(4, 8, 16).astype(onp.float32)


def _mesh(spec):
    from mxnet_tpu_torch.parallel import make_mesh

    return make_mesh(dict((k, int(v)) for k, v in
                          (a.split("=") for a in spec.split(","))))


def _placed(arr, mesh, spec):
    from mxnet_tpu_torch.parallel import NamedSharding, PartitionSpec, spmd

    return spmd.ensure_placed(torch.from_numpy(arr),
                              NamedSharding(mesh, PartitionSpec(*spec)))


def _barrier():
    import torch.distributed as dist

    dist.barrier()


def world_restore_across_meshes():
    from mxnet_tpu_torch.parallel import collectives, spmd
    from mxnet_tpu_torch.parallel.elastic import CheckpointManager

    out = {}
    root = os.environ["ELASTIC_WORLD_DIR"]
    for name, arr, save_mesh, load_mesh in (
            ("pp", STAGES, "pp=2,dp=2,fsdp=2", "pp=2,dp=4"),
            ("ep", EXPERTS, "ep=4,dp=2", "ep=2,dp=4")):
        m1, m2 = _mesh(save_mesh), _mesh(load_mesh)
        key = "pp_stages" if name == "pp" else "expert.ffn_1.weight"
        spec1 = spmd.param_spec(arr.shape, m1, min_size=1, name=key) \
            if name == "ep" else ("pp", None)
        spec2 = spmd.param_spec(arr.shape, m2, min_size=1, name=key) \
            if name == "ep" else ("pp", None)
        tree = {key: _placed(arr, m1, spec1)}
        mgr = CheckpointManager(os.path.join(root, name), async_save=False)
        mgr.save(1, tree, block=True)
        _barrier()
        like = {key: _placed(onp.zeros_like(arr), m2, spec2)}
        restored, step = mgr.restore(like=like)
        got = restored[key]
        want = collectives.local_block(torch.from_numpy(arr), spec2, m2)
        out[f"{name}_equal"] = onp.asarray(torch.equal(got, want))
        out[f"{name}_placed"] = onp.asarray(
            got._spmd_placement == like[key]._spmd_placement)
        out[f"{name}_block_rows"] = onp.asarray(got.shape[0])
        out[f"{name}_step"] = onp.asarray(step)
        out[f"{name}_spec0"] = onp.asarray(str(spec2[0]))
        mgr.close()
    return out


def world_digest_invariant_to_pp_sharding():
    from mxnet_tpu_torch import sentinel

    out = {"host": onp.asarray(sentinel.tree_digest(
        {"pp_stages": torch.from_numpy(STAGES)}), onp.int64)}
    for i, (spec, pspec) in enumerate((("pp=2,dp=2,fsdp=2", ("pp", None)),
                                       ("pp=2,dp=4", ("pp", None)),
                                       ("dp=8", ()))):
        mesh = _mesh(spec)
        placed = {"pp_stages": _placed(STAGES, mesh, pspec)}
        out[f"mesh{i}"] = onp.asarray(sentinel.tree_digest(placed),
                                      onp.int64)
    return out


def world_drain_force_saves_pp_state():
    from mxnet_tpu_torch import preemption
    from mxnet_tpu_torch.parallel.elastic import (CheckpointManager,
                                                  run_elastic)

    mesh = _mesh("pp=2,dp=2,fsdp=2")
    w0 = _placed(onp.zeros((2, 64), onp.float32), mesh, ("pp", None))
    mgr = CheckpointManager(os.path.join(os.environ["ELASTIC_WORLD_DIR"],
                                         "drain"), async_save=True)
    codes = []
    preemption.install(exit_fn=codes.append)
    try:
        def step(state, i):
            if int(state["i"]) == 4:
                preemption.notice()
            w = state["w"] + 1.0
            w._spmd_placement = state["w"]._spmd_placement
            return {"w": w, "i": state["i"] + 1}

        run_elastic(step, {"w": w0, "i": onp.int64(0)}, list(range(10)),
                    mgr, save_every=3)
        _barrier()
        latest = mgr.latest_step()
        restored, at = mgr.restore(like={"w": w0, "i": onp.int64(0)})
    finally:
        preemption.reset()
        preemption.uninstall()
        mgr.close()
    return {"codes": onp.asarray(codes), "latest": onp.asarray(latest),
            "at": onp.asarray(at),
            "w": restored["w"].numpy(),
            "placed": onp.asarray(restored["w"]._spmd_placement ==
                                  w0._spmd_placement)}


def world_quarantine_exclusion():
    import torch.distributed as dist

    from mxnet_tpu_torch import sentinel
    from mxnet_tpu_torch.parallel import mesh as tmesh

    path = os.path.join(os.environ["ELASTIC_WORLD_DIR"], "q",
                        "quarantine.json")
    if dist.get_rank() == 0:
        sentinel.Quarantine(path).add_rank(3, "suspected dead")
    _barrier()
    q = sentinel.install_quarantine(sentinel.Quarantine(path))
    devices = [SimpleNamespace(id=r, index=r, process_index=r)
               for r in range(dist.get_world_size())]
    try:
        kept = tmesh.admitted_devices(devices)
    finally:
        sentinel.install_quarantine(None)
    return {"kept": onp.asarray([d.id for d in kept]),
            "ranks": onp.asarray(q.ranks())}


def test_checkpoints_digest_drain_quarantine_in_a_world_of_8(tmp_path):
    scen = [f"{__name__}:{f}" for f in (
        "world_restore_across_meshes", "world_digest_invariant_to_pp_sharding",
        "world_drain_force_saves_pp_state", "world_quarantine_exclusion")]
    ranks = run_world(8, scen, tmp_path,
                      env={"ELASTIC_WORLD_DIR": str(tmp_path / "w")})
    want_digest = jsentinel.tree_digest({"pp_stages": STAGES})
    for r in ranks:
        rs = r["world_restore_across_meshes"]
        for name, rows in (("pp", 1), ("ep", 2)):
            assert bool(rs[f"{name}_equal"]) and bool(rs[f"{name}_placed"])
            assert int(rs[f"{name}_step"]) == 1
            assert int(rs[f"{name}_block_rows"]) == rows
        assert str(rs["ep_spec0"]) == "ep"
        dg = r["world_digest_invariant_to_pp_sharding"]
        assert {int(v) for v in dg.values()} == {want_digest}
        dr = r["world_drain_force_saves_pp_state"]
        assert dr["codes"].tolist() == [83]
        assert int(dr["latest"]) == 5 and int(dr["at"]) == 5
        assert (dr["w"] == 5.0).all() and bool(dr["placed"])
        assert dr["w"].shape == (1, 64)
        qx = r["world_quarantine_exclusion"]
        assert qx["ranks"].tolist() == [3]
        assert qx["kept"].tolist() == [0, 1, 2, 4, 5, 6, 7]

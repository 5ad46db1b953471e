"""The port's drill matrix (``mxnet_tpu_torch/drills.py``) on the CPU: one
test per scenario of ``SCENARIOS`` and ``ROUTER_SCENARIOS``, each the real
thing at the reference's drill widths (``_drill_net``: Dense 8 -> 16 -> 4,
24 steps, saves every 4, 16 rows; ``TinyCausalLM(vocab=50, d_model=16,
n_layers=1, n_heads=2, max_seq=96)``): children in their own processes,
real SIGTERM / SIGKILL, gloo worlds of 4 and 2 for ``topology_change`` and
``bitflip_param``, replica processes behind the router for
``router_scale_storm`` and ``router_host_loss``.

The scenarios run once for the module, concurrently (a bounded pool; the
reference runs they share first), under one root; each test reads its
scenario's report and holds it to the budgets of
``tools/torch_check_recovery_budget.py`` and
``tools/torch_check_availability_budget.py``. The uninterrupted train-drill
trajectory is held within 1e-5 relative of the reference's, run here on
the same seeded weights and batches. The whole gates are the ``slow``
tests, as the reference marks them.
"""
import concurrent.futures
import os

import numpy as onp
import pytest

from mxnet_tpu_torch import drills

from test_torch_package import LazyModule

rdrills = LazyModule("mxnet_tpu.drills")
rmx = LazyModule("mxnet_tpu")
rgluon = LazyModule("mxnet_tpu.gluon")

CPU = "cpu"
TRAJ_RTOL = 1e-5
ALL = drills.SCENARIOS + drills.ROUTER_SCENARIOS


@pytest.fixture(scope="module")
def reports(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("drills"))
    fails = []
    # the shared reference runs first (a world of 1 and a world of 4)
    with concurrent.futures.ThreadPoolExecutor(2) as ex:
        list(ex.map(lambda w: drills._ensure_reference(root, fails, w, CPU),
                    (1, drills.TOPO_WORLDS[0])))
    assert not fails, fails
    with concurrent.futures.ThreadPoolExecutor(4) as ex:
        futs = {n: ex.submit(drills.run_drill, n, root, device=CPU)
                for n in ALL}
        out = {n: f.result() for n, f in futs.items()}
    out["_root"] = root
    return out


def _budget(name, rep):
    import tools.torch_check_availability_budget as avail
    import tools.torch_check_recovery_budget as recov

    gate = avail if name in drills.ROUTER_SCENARIOS else recov
    return gate.budget_failures(name, rep)


@pytest.mark.parametrize("name", ALL)
def test_drill_scenario_green(reports, name):
    rep = reports[name]
    assert rep["ok"], rep["failures"]
    assert _budget(name, rep) == []
    assert rep["device"] == CPU


def test_recovery_drills_replay_what_the_reference_does(reports):
    assert reports["sigterm_drain"]["steps_replayed"] == 0
    assert reports["sigterm_drain"]["restored_at"] == 9
    assert reports["sigkill_between_saves"]["steps_replayed"] == 2
    assert reports["corrupt_latest"]["restored_at"] == \
        drills.HALF - drills.SAVE_EVERY
    assert reports["loss_spike"]["steps_replayed"] == drills.SAVE_EVERY
    for name in drills.SCENARIOS:
        assert reports[name]["captures_after_warmup"] == 0, name
    flip = reports["bitflip_param"]
    assert flip["restart_excluded"] == [flip["flipped_device"]]
    assert flip["flipped_device"] not in flip["restart_mesh_devices"]


def test_availability_drills_fail_over_and_leak_nothing(reports):
    for name in drills.ROUTER_SCENARIOS:
        rep = reports[name]
        assert rep["dropped"] == 0 and rep["leaked_pages"] == 0, name
    assert reports["router_kill"]["failovers"] >= 1
    assert reports["router_wedge"]["failovers"] >= 1
    assert reports["router_flap"]["re_admit_s"] is not None
    assert reports["router_scale_storm"]["fleet"]["scale_ups"] >= 2
    assert reports["router_host_loss"]["kill_to_recovered_s"] is not None
    assert all(s["spec_disabled"]
               for s in reports["spec_draft_poison"]["spec"])


def _reference_trajectory():
    """The reference's uninterrupted drill trajectory on one device: its
    ``_drill_net`` and ``_host_batch``, SGD momentum 0.9 at lr 0.1."""
    net = rdrills._drill_net(seed=0)
    trainer = rgluon.Trainer(net.collect_params(), "sgd",
                             {"learning_rate": 0.1, "momentum": 0.9})
    step = trainer.compile_step(net, rdrills._drill_loss)
    out = []
    for i in range(drills.N_STEPS):
        x, y = rdrills._host_batch(i)
        loss = step(rmx.nd.array(x), rmx.nd.array(y),
                    batch_size=drills.ROWS)
        out.append(float(loss.asnumpy().ravel()[0]))
    return out


def test_uninterrupted_trajectory_matches_reference(reports):
    path = os.path.join(reports["_root"], "ref1-cpu", "losses-ref.txt")
    got = drills._read_losses(os.path.dirname(path), "ref")
    assert sorted(got) == list(range(drills.N_STEPS))
    port = onp.array([float.fromhex(got[i])
                      for i in range(drills.N_STEPS)])
    want = onp.array(_reference_trajectory())
    assert onp.all(onp.abs(port - want) <= TRAJ_RTOL * onp.abs(want)), \
        (port, want)
    # the port's batches and weights are the reference's draws
    for i in (0, 7, 23):
        for a, b in zip(drills._host_batch(i), rdrills._host_batch(i)):
            assert onp.array_equal(a, b)


@pytest.mark.slow
def test_recovery_gate_whole():
    import tools.torch_check_recovery_budget as gate

    assert gate.main(["--device", CPU]) == 0


@pytest.mark.slow
def test_availability_gate_whole():
    import tools.torch_check_availability_budget as gate

    assert gate.main(["--device", CPU]) == 0


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["router_kill", "decode_drain"])
def test_drill_on_card(cuda_device, tmp_path, name):
    """A serving drill's children on the card, held to its gate."""
    import tools.torch_check_availability_budget as avail
    import tools.torch_check_recovery_budget as recov

    rep = drills.run_drill(name, str(tmp_path), device=cuda_device)
    gate = avail if name in drills.ROUTER_SCENARIOS else recov
    assert rep["ok"], rep["failures"]
    assert gate.budget_failures(name, rep) == []
    assert rep["captures_after_warmup"] == 0

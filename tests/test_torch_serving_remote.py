"""The port's cross-process replicas (``mxnet_tpu_torch/serving_remote.py``)
on the CPU, against the JAX package's ``serving_remote``:

- frames: ``send_frame`` writes the reference's bytes for the same objects,
  each package's ``recv_frame`` reads the other's, and a corrupt length
  prefix past ``_MAX_FRAME`` raises ``FatalFault`` in both;
- a reference ``RemoteReplica`` against a port ``ReplicaServer``, and a port
  ``RemoteReplica`` against a reference ``ReplicaServer``: token-exact
  greedy and seeded-sampled streams (the ``SamplingSpec`` rides the frame),
  typed ``draining`` and ``deadline`` sheds that cross in both directions,
  the ``load`` / ``ping`` / ``pool`` surface;
- the server as an ``engine`` drainable, transport faults as replica-blamed
  ``TransientFault``s, and a remote replica behind the router failing over
  token-exact when its server goes away.
"""
import socket
import threading

import pytest

from mxnet_tpu_torch import engine as _engine
from mxnet_tpu_torch import faults
from mxnet_tpu_torch import serving_decode as sd
from mxnet_tpu_torch import serving_remote as srm
from mxnet_tpu_torch.serving_router import ReplicaRouter

from test_torch_package import LazyModule

rsrm = LazyModule("mxnet_tpu.serving_remote")
rsd = LazyModule("mxnet_tpu.serving_decode")
rfaults = LazyModule("mxnet_tpu.faults")

CPU = "cpu"
CFG = dict(vocab=31, d_model=16, n_layers=1, n_heads=2, max_seq=48)
FRAMES = [
    {"op": "ping"},
    {"op": "generate", "prompt": [1, 2, 3], "max_new_tokens": 5,
     "eos": None, "sampling": None, "deadline_us": 1500000,
     "trace_id": "abc"},
    {"ok": True, "tokens": list(range(40))},
    {"ok": False, "shed_kind": "draining", "error": "x é ☃"},
    {"ok": True, "load": {"queue_depth": 0.0, "in_flight": 1.5,
                          "pool_pressure": 0.25}},
    {"nested": {"a": [1, 2.5, None, True, "s"]}, "empty": {}},
]


def _sent_bytes(mod, obj) -> bytes:
    a, b = socket.socketpair()
    try:
        mod.send_frame(a, obj)
        a.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = b.recv(65536)
            if not chunk:
                return out
            out += chunk
    finally:
        a.close()
        b.close()


def test_frames_byte_identical_to_reference():
    assert srm._MAX_FRAME == rsrm._MAX_FRAME
    for obj in FRAMES:
        assert _sent_bytes(srm, obj) == _sent_bytes(rsrm, obj), obj


@pytest.mark.parametrize("writer,reader", [("port", "ref"), ("ref", "port")])
def test_frames_cross_between_packages(writer, reader):
    mods = {"port": srm, "ref": rsrm}
    for obj in FRAMES:
        a, b = socket.socketpair()
        try:
            mods[writer].send_frame(a, obj)
            assert mods[reader].recv_frame(b) == obj
        finally:
            a.close()
            b.close()


def test_corrupt_length_prefix_is_fatal():
    import struct

    for mod, fatal in ((srm, faults.FatalFault),
                       (rsrm, rfaults.FatalFault)):
        a, b = socket.socketpair()
        try:
            a.sendall(struct.pack("!I", srm._MAX_FRAME + 1))
            with pytest.raises(fatal):
                mod.recv_frame(b)
        finally:
            a.close()
            b.close()


def _port_engine(name, seed=0):
    model = sd.TinyCausalLM(**CFG)
    params = model.init_params(seed, device=CPU)
    eng = sd.GenerativeEngine(model, params=params,
                              pool=sd.PagePool(pages=32, page=4),
                              max_rows=2, name=name, device=CPU)
    eng.warmup(max_len=8)
    return model, params, eng


def _ref_engine(name, seed=0):
    model = rsd.TinyCausalLM(**CFG)
    params = model.init_params(seed)
    eng = rsd.GenerativeEngine(model, params=params,
                               pool=rsd.PagePool(pages=32, page=4),
                               max_rows=2, name=name)
    return model, params, eng


def test_reference_client_against_port_server():
    model, params, eng = _port_engine("wire_port")
    srv = srm.ReplicaServer(eng).start()
    try:
        rr = rsrm.RemoteReplica("127.0.0.1", srv.port)
        for p in ([4, 5, 6], [1, 2], [7, 8, 9, 10]):
            assert rr.generate(p, max_new_tokens=5) == \
                sd.eager_generate(model, params, p, 5)
        samp = rsd.SamplingSpec(temperature=0.8, top_k=5, top_p=0.9,
                                seed=17)
        local = sd.SamplingSpec.from_wire(samp.to_wire())
        assert rr.generate([3, 4], max_new_tokens=6, sampling=samp) == \
            eng.generate([3, 4], max_new_tokens=6, sampling=local)
        assert rr.ping() is True
        assert set(rr.load()) >= {"queue_depth", "in_flight",
                                  "pool_pressure"}
        assert rr.pool()["audit"] == []
        # a typed deadline shed crosses the wire typed
        with rfaults.deadline_scope(1, site="client.deadline"):
            with pytest.raises(rfaults.ShedError) as ei:
                rr.generate([4, 5, 6], max_new_tokens=30)
        assert ei.value.kind == "deadline"
        eng.begin_drain()
        with pytest.raises(rfaults.ShedError) as ei:
            rr.generate([4, 5, 6], max_new_tokens=2)
        assert ei.value.kind == "draining"
    finally:
        srv.close()
    _engine.waitall()
    assert eng.pool_in_use() == 0


def test_port_client_against_reference_server():
    rmodel, rparams, reng = _ref_engine("wire_ref")
    srv = rsrm.ReplicaServer(reng).start()
    try:
        rr = srm.RemoteReplica("127.0.0.1", srv.port)
        for p in ([4, 5, 6], [1, 2]):
            assert rr.generate(p, max_new_tokens=5) == \
                rsd.eager_generate(rmodel, rparams, p, 5)
        samp = sd.SamplingSpec(temperature=0.8, top_k=5, top_p=0.9, seed=17)
        want = rsd.eager_generate(
            rmodel, rparams, [3, 4], 6,
            sampling=rsd.SamplingSpec.from_wire(samp.to_wire()))
        assert rr.generate([3, 4], max_new_tokens=6, sampling=samp) == want
        assert rr.ping() is True
        reng.begin_drain()
        with pytest.raises(faults.ShedError) as ei:
            rr.generate([4, 5, 6], max_new_tokens=2)
        assert ei.value.kind == "draining"
    finally:
        srv.close()
        reng.close()


def test_remote_replica_protocol_token_exact():
    model, params, eng = _port_engine("wire0")
    srv = srm.ReplicaServer(eng).start()
    try:
        rr = srm.RemoteReplica("127.0.0.1", srv.port)
        assert rr.generate([4, 5, 6], max_new_tokens=5) == \
            sd.eager_generate(model, params, [4, 5, 6], 5)
        assert rr.ping() is True
        load = rr.load()
        for k in ("queue_depth", "in_flight", "pool_pressure"):
            assert k in load
        pool = rr.pool()
        assert pool["in_use"] == 0 and pool["audit"] == []
        eng.begin_drain()
        with pytest.raises(faults.ShedError) as ei:
            rr.generate([4, 5, 6], max_new_tokens=2)
        assert ei.value.kind == "draining"
    finally:
        srv.close()
    _engine.waitall()
    assert eng.pool_in_use() == 0


def test_server_is_a_drainable_that_answers_in_flight_requests():
    model, params, eng = _port_engine("wire_drain")
    srv = srm.ReplicaServer(eng).start()
    assert srv in _engine._DRAINABLES
    out = []
    try:
        rr = srm.RemoteReplica("127.0.0.1", srv.port)
        threads = [threading.Thread(target=lambda i=i: out.append(
            rr.generate([1 + i, 2], max_new_tokens=6))) for i in range(4)]
        for t in threads:
            t.start()
        _engine.waitall()
        for t in threads:
            t.join(timeout=60)
        assert len(out) == 4
        with srv._lock:
            assert srv._active == 0
    finally:
        srv.close()


def test_transport_faults_are_transient_and_unknown_ops_refused():
    rr = srm.RemoteReplica("127.0.0.1", 1, timeout_s=1.0)
    with pytest.raises(faults.TransientFault):
        rr.generate([1], max_new_tokens=1)
    assert rr.ping() is False
    model, params, eng = _port_engine("wire_ops")
    srv = srm.ReplicaServer(eng).start()
    try:
        rr = srm.RemoteReplica("127.0.0.1", srv.port)
        with pytest.raises(faults.TransientFault, match="unknown op"):
            rr._call({"op": "nope"})
        rr.close()
        with pytest.raises(RuntimeError, match="closed"):
            rr._call({"op": "ping"})
    finally:
        srv.close()
        eng.close()


def test_router_fails_over_when_a_remote_server_goes_away():
    model, params, local = _port_engine("local")
    _m, _p, far = _port_engine("far")
    srv = srm.ReplicaServer(far).start()
    router = ReplicaRouter(
        [local, srm.RemoteReplica("127.0.0.1", srv.port, timeout_s=5.0)],
        breaker_errs=1, breaker_cooldown_s=30.0)
    prompts = [[1 + i, 2, 3] for i in range(4)]
    assert [router.generate(p, max_new_tokens=4) for p in prompts] == \
        [sd.eager_generate(model, params, p, 4) for p in prompts]
    srv.close()
    outs = []
    threads = [threading.Thread(target=lambda p=p: outs.append(
        router.generate(p, max_new_tokens=4))) for p in prompts * 2]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert sorted(map(str, outs)) == sorted(
        str(sd.eager_generate(model, params, p, 4)) for p in prompts * 2)
    assert router.stats()["delivered"] == 12
    _engine.waitall()
    assert local.pool_in_use() == 0 and far.pool_in_use() == 0

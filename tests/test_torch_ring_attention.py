"""Ring attention and the differentiable ring shift of the port
(``mxnet_tpu_torch.parallel.ring_attention``, ``collectives.ppermute`` /
``ring_shift``) in a gloo world of 4 processes on the CPU (``sp=4``),
held against the JAX package's (``tests/test_parallel.py:57, :70``, on
4 of its 8 virtual devices) and against dense attention:

- ``ring_shift`` rotates the shards as the reference's does, and its
  gradient is the inverse rotation;
- ``ring_attention_sharded`` (causal and not) matches the reference's
  output and dense attention within 1e-4 in fp32, and with a loss every
  rank computes alike on the output, the gradients of q, k and v match
  dense autograd's within 1e-4;
- ``ring_attention`` on each rank's own shards, its gradients through
  the ring gathered, matches dense autograd's.
"""
import math

import numpy as onp
import pytest
import torch

from mxnet_tpu_torch import parallel as tpar
from mxnet_tpu_torch.parallel import collectives as tcoll
from mxnet_tpu_torch.parallel.ring_attention import (
    ring_attention, ring_attention_sharded)
from mxnet_tpu_torch.parallel.sharding import PartitionSpec as TP

from test_torch_package import LazyModule
from test_torch_sharding import run_world

jnp = LazyModule("jax.numpy")
jpar = LazyModule("mxnet_tpu.parallel")
JP = LazyModule("jax.sharding", "PartitionSpec")

B, H, S, D = 2, 4, 64, 16
TOL = dict(atol=1e-4, rtol=0)


def _qkvw():
    rng = onp.random.RandomState(0)
    return [rng.randn(B, H, S, D).astype(onp.float32) for _ in range(4)]


def dense(q, k, v, causal):
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) / math.sqrt(D)
    if causal:
        mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
        s = s.masked_fill(~mask, -math.inf)
    return torch.einsum("bhqk,bhkd->bhqd", torch.softmax(s, -1), v)


def world4():
    mesh = tpar.make_mesh({"sp": 4}, devices=[torch.device("cpu")])
    out = {}
    # ring_shift: forward, and the gradient of a weighted sum
    x = torch.arange(8.0).requires_grad_()
    f = tcoll.run_sharded(lambda t: tcoll.ring_shift(t, "sp", shift=1),
                          mesh, (TP("sp"),), TP("sp"))
    out["shift"] = f(x.detach()).numpy()
    xl = tcoll.local_block(x.detach(), TP("sp"), mesh).requires_grad_()
    y = tcoll.ring_shift(xl, "sp", shift=1, mesh=mesh)
    (g,) = torch.autograd.grad((y * torch.arange(2.0)).sum() + 0 * y.sum(),
                               [xl])
    out["shift_grad"] = tcoll.all_gather(g, "sp", mesh=mesh).numpy()
    q, k, v, w = map(torch.from_numpy, _qkvw())
    for causal in (False, True):
        name = "causal" if causal else "full"
        ts = [t.clone().requires_grad_() for t in (q, k, v)]
        o = ring_attention_sharded(*ts, mesh, causal=causal,
                                         batch_axes=())
        gs = torch.autograd.grad((o * w).sum(), ts)
        out[f"{name}|out"] = o.detach().numpy()
        for n, gi in zip("qkv", gs):
            out[f"{name}|d{n}"] = gi.numpy()
        # on each rank's own shards, the gradients gathered
        spec = TP(None, None, "sp", None)
        ls = [tcoll.local_block(t, spec, mesh).clone().requires_grad_()
              for t in (q, k, v)]
        lo = ring_attention(*ls, "sp", causal=causal, mesh=mesh)
        lgs = torch.autograd.grad(
            (lo * tcoll.local_block(w, spec, mesh)).sum(), ls)
        for n, gi in zip("qkv", lgs):
            out[f"{name}|local_d{n}"] = tcoll.all_gather(
                gi, "sp", axis=2, mesh=mesh).numpy()
    return out


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return [r["world4"] for r in run_world(
        4, [f"{__name__}:world4"], tmp_path_factory.mktemp("ring"))]


def test_ring_shift_rotates_as_the_reference(world):
    mesh = jpar.make_mesh({"sp": 4})
    f = jpar.run_sharded(lambda xs: jpar.ring_shift(xs, "sp", shift=1),
                         mesh, in_specs=(JP("sp"),), out_specs=JP("sp"))
    want = onp.asarray(f(jnp.arange(8.0)))
    # two elements a member: member j receives member j - 1's pair
    assert onp.allclose(want, onp.roll(onp.arange(8.0), 2))
    for res in world:
        assert onp.array_equal(res["shift"], want)
        # d/dx of sum(shift(x) * [0, 1] per shard): member j's second
        # element went to member j + 1
        assert onp.array_equal(res["shift_grad"],
                               onp.tile([0.0, 1.0], 4))


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_dense_and_reference(world, causal):
    name = "causal" if causal else "full"
    q, k, v, w = map(torch.from_numpy, _qkvw())
    ts = [t.clone().requires_grad_() for t in (q, k, v)]
    o = dense(*ts, causal)
    gs = torch.autograd.grad((o * w).sum(), ts)
    mesh = jpar.make_mesh({"sp": 4})
    want = onp.asarray(jpar.ring_attention_sharded(
        *[jnp.asarray(t.numpy()) for t in (q, k, v)], mesh, causal=causal,
        batch_axes=()))
    for rank, res in enumerate(world):
        got = res[f"{name}|out"]
        onp.testing.assert_allclose(got, want, err_msg=f"rank {rank}", **TOL)
        onp.testing.assert_allclose(got, o.detach().numpy(), **TOL)
        for n, g in zip("qkv", gs):
            onp.testing.assert_allclose(res[f"{name}|d{n}"], g.numpy(),
                                        err_msg=f"d{n}", **TOL)
            onp.testing.assert_allclose(res[f"{name}|local_d{n}"],
                                        g.numpy(), err_msg=f"local d{n}",
                                        **TOL)


def test_ring_of_one_is_attention():
    mesh = tpar.make_mesh({"sp": 1}, devices=[torch.device("cpu")])
    q, k, v, _w = map(torch.from_numpy, _qkvw())
    for causal in (False, True):
        got = ring_attention(q, k, v, "sp", causal=causal, mesh=mesh)
        onp.testing.assert_allclose(got.numpy(),
                                    dense(q, k, v, causal).numpy(), **TOL)
    with pytest.raises(ValueError, match="no axis"):
        ring_attention_sharded(q, k, v, mesh, axis_name="tp")


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_ring_of_one_on_card(cuda_device):
    """Ring attention at sp=1 on the card, fp32 and bf16, against dense
    attention in fp32 (a ring of more members needs more cards)."""
    mesh = tpar.make_mesh({"sp": 1}, devices=[cuda_device])
    q, k, v, _w = (torch.from_numpy(a).to(cuda_device) for a in _qkvw())
    for causal in (False, True):
        want = dense(q, k, v, causal)
        got = ring_attention(q, k, v, "sp", causal=causal, mesh=mesh)
        torch.testing.assert_close(got, want, atol=1e-4, rtol=0)
        got16 = ring_attention(*(t.bfloat16() for t in (q, k, v)), "sp",
                               causal=causal, mesh=mesh)
        torch.testing.assert_close(got16.float(), want, atol=2e-2,
                                   rtol=2e-2)

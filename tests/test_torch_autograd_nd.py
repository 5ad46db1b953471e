"""Autograd on NDArrays (``mxnet_tpu_torch.autograd``) against the
reference's tape, on the CPU: ``grad_req`` write and add, ``backward``
writing only marked variables, ``grad`` with respect to an input nobody
marked, ``create_graph`` second order, ``mark_variables``, a custom
``Function``, ``_set_data`` on a marked variable, and the scopes. Each
case computes the reference's gradients in the test from the same numpy
data; fp32 within ``rtol 1e-6, atol 1e-7``."""
import numpy as onp
import pytest
import torch

import mxnet_tpu_torch as tmx
from test_torch_package import LazyModule

mx = LazyModule("mxnet_tpu")

_R = onp.random.RandomState(5)
X = _R.rand(3, 4).astype(onp.float32) + 0.5
W = _R.rand(2, 4).astype(onp.float32) - 0.5


def _close(got, want):
    onp.testing.assert_allclose(got.asnumpy(), onp.asarray(want.asnumpy()),
                                rtol=1e-6, atol=1e-7)


def _both(fn):
    """fn(package, array-maker) run in both packages."""
    with tmx.cpu():
        got = fn(tmx, lambda a: tmx.nd.array(a))
    want = fn(mx, lambda a: mx.nd.array(a))
    return got, want


def _loss(pkg, x, w):
    y = pkg.nd.FullyConnected(x, w, num_hidden=2, no_bias=True)
    return (pkg.nd.tanh(y) * y).sum()


@pytest.mark.parametrize("req", ["write", "add"])
def test_grad_req_write_and_add(req):
    def run(pkg, arr):
        x, w = arr(X), arr(W)
        w.attach_grad(grad_req=req)
        for _ in range(2):
            with pkg.autograd.record():
                loss = _loss(pkg, x, w)
            loss.backward()
        return w.grad

    got, want = _both(run)
    _close(got, want)


def test_backward_writes_only_marked_variables():
    with tmx.cpu():
        x, w = tmx.nd.array(X), tmx.nd.array(W)
        w.attach_grad()
        with tmx.autograd.record():
            loss = _loss(tmx, x, w)
        tmx.autograd.backward(loss)
        # the unmarked input was made to require grad by the recorded op,
        # but nothing is accumulated into it
        assert x._data.requires_grad and x._data.grad is None
        assert x.grad is None and w.grad is not None


def test_grad_with_respect_to_an_unmarked_input():
    def run(pkg, arr):
        x, w = arr(X), arr(W)
        w.attach_grad()
        with pkg.autograd.record():
            loss = _loss(pkg, x, w)
        gx, gw = pkg.autograd.grad(loss, [x, w])
        return gx, gw, w.grad

    (gx, gw, wg), (rx, rw, rwg) = _both(run)
    _close(gx, rx)
    _close(gw, rw)
    _close(wg, rwg)                     # grad() writes no .grad


def test_grad_of_an_unreached_variable_is_zeros():
    def run(pkg, arr):
        x, z = arr(X), arr(X)
        z.attach_grad()                 # tracked, but the heads miss it
        with pkg.autograd.record():
            y = (x * x).sum()
        return pkg.autograd.grad(y, z)

    gz, rz = _both(run)
    assert gz.shape == rz.shape and not gz.asnumpy().any()
    _close(gz, rz)


def _dense(pkg):
    net = pkg.gluon.nn.Dense(2, in_units=4)
    net.initialize()
    net.weight.set_data(pkg.nd.array(W))
    net.bias.set_data(pkg.nd.array(onp.array([0.25, -0.5], onp.float32)))
    return net


@pytest.mark.parametrize("case", ["block_input", "never_read"])
def test_grad_of_an_untracked_variable_raises(case):
    """An NDArray nobody marked and no recorded op read has no gradient
    path in torch: ``grad`` raises rather than answer zeros (a Gluon block
    reads its NDArray input untracked, where the reference records it)."""
    with tmx.cpu():
        x, z = tmx.nd.array(X), tmx.nd.array(X)
        net = _dense(tmx)
        with tmx.autograd.record():
            y = net(x).sum() if case == "block_input" else (z * z).sum()
        with pytest.raises(tmx.base.MXNetError, match="never tracked"):
            tmx.autograd.grad(y, x)
        assert not x._data.requires_grad


def test_grad_of_a_marked_block_input():
    """Marked first, a Gluon block's NDArray input gets the reference's
    gradient."""
    def run(pkg, arr):
        x = arr(X)
        x.attach_grad()
        net = _dense(pkg)
        with pkg.autograd.record():
            y = (pkg.nd.tanh(net(x)) * 3).sum()
        return pkg.autograd.grad(y, x)

    got, want = _both(run)
    _close(got, want)


def test_create_graph_second_order():
    def run(pkg, arr):
        x = arr(X)
        x.attach_grad()
        with pkg.autograd.record():
            y = (x * x * x).sum()
            g = pkg.autograd.grad(y, x, create_graph=True)
            z = (g * g).sum()
        z.backward()
        return g, x.grad

    (g, gg), (rg, rgg) = _both(run)
    _close(g, rg)                       # 3 x^2
    _close(gg, rgg)                     # d/dx sum(9 x^4) = 36 x^3


def test_mark_variables_and_head_grads():
    def run(pkg, arr):
        x, w = arr(X), arr(W)
        gbuf = pkg.nd.zeros(W.shape, ctx=w.ctx)
        pkg.autograd.mark_variables([w], [gbuf], "write")
        with pkg.autograd.record():
            y = pkg.nd.FullyConnected(x, w, num_hidden=2, no_bias=True)
        pkg.autograd.backward([y], [arr(onp.full((3, 2), 0.5,
                                                 onp.float32))])
        return gbuf

    got, want = _both(run)
    _close(got, want)


def test_custom_function():
    def run(pkg, arr):
        class Sigmoid(pkg.autograd.Function):
            def forward(self, x):
                y = 1 / (1 + pkg.nd.exp(-x))
                self.save_for_backward(y)
                return y

            def backward(self, dy):
                y, = self.saved_tensors
                return dy * y * (1 - y)

        x = arr(X - 1)
        x.attach_grad()
        with pkg.autograd.record():
            out = Sigmoid()(x)
            loss = (out * arr(W[:1].repeat(3, 0))).sum()
        loss.backward()
        return out, x.grad

    (out, g), (rout, rg) = _both(run)
    _close(out, rout)
    _close(g, rg)


def test_set_data_on_a_marked_variable_keeps_it_marked():
    """SKILL.md's loop: the update rebinds the variable, which stays a
    leaf that requires grad with its grad buffer, and the next backward
    writes it again."""
    def run(pkg, arr):
        x, w = arr(X), arr(W)
        w.attach_grad()
        grads = []
        for _ in range(3):
            with pkg.autograd.record():
                loss = _loss(pkg, x, w)
            loss.backward()
            grads.append(w.grad.copy())
            w._set_data(pkg.nd.sgd_update(w, w.grad, lr=0.1)._data)
        return grads, w

    (grads, w), (rgrads, rw) = _both(run)
    for g, rg in zip(grads, rgrads):
        _close(g, rg)
    _close(w, rw)
    assert w._data.requires_grad and w._data.is_leaf and w.version == 3


def test_scopes():
    ag = tmx.autograd
    assert not ag.is_recording() and not ag.is_training()
    with ag.record():
        assert ag.is_recording() and ag.is_training()
        assert torch.is_grad_enabled()
        with ag.pause():
            assert not ag.is_recording() and not torch.is_grad_enabled()
        with ag.predict_mode():
            assert ag.is_recording() and not ag.is_training()
    with ag.train_mode():
        assert ag.is_training() and not ag.is_recording()
    assert not ag.is_training()


def test_ops_outside_record_build_no_graph():
    with tmx.cpu():
        w = tmx.nd.array(W)
        w.attach_grad()
        y = tmx.nd.sgd_update(w, w, lr=0.1)
        z = w * 2
    assert not y._data.requires_grad and not z._data.requires_grad

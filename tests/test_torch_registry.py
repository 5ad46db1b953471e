"""The port's op registry against the reference's.

The op modules A3 ports (``elemwise``, ``tensor``, ``reduce``, ``init``,
``random``, ``nn``, ``optimizer``) hold the reference's 228 schemas, with
its canonical names and fields; every alias the port registers is one of
the reference's for the same op (the aliases ``ref_aliases.py`` and
``np_extra.py`` add come with ROADMAP A9); and every other name of the
reference's ``nd`` namespace is listed as not ported, so ``mx.nd.<name>``
raises ``NotImplementedError`` for it.
"""
import json
import os
import subprocess
import sys

import pytest

import mxnet_tpu_torch as tmx
from mxnet_tpu_torch.ndarray._unported import UNPORTED
from mxnet_tpu_torch.ops import registry as tregistry
from test_torch_package import ROOT, LazyModule

rregistry = LazyModule("mxnet_tpu.ops.registry")
mx = LazyModule("mxnet_tpu")

MODULES = ("elemwise", "tensor", "reduce", "init", "random", "nn",
           "optimizer")
FIELDS = ("num_inputs", "num_outputs", "differentiable", "namespaces",
          "rng_input", "draws_key")


def _ref_schemas():
    mx.nd                                   # registers every reference op
    mods = {f"mxnet_tpu.ops.{m}" for m in MODULES}
    return {n: rregistry.get_op(n) for n in rregistry.list_ops()
            if rregistry.get_op(n).fn.__module__ in mods}


def test_canonical_names_equal_the_reference():
    ref = _ref_schemas()
    port = {n: tregistry.get_op(n) for n in tregistry.list_ops()
            if tregistry.get_op(n).fn.__module__.rsplit(".", 1)[-1]
            in MODULES}
    assert len(ref) == 228
    assert sorted(port) == sorted(ref)
    for n, s in port.items():
        module = s.fn.__module__.rsplit(".", 1)[-1]
        assert module == ref[n].fn.__module__.rsplit(".", 1)[-1], n


@pytest.mark.parametrize("field", FIELDS)
def test_schema_fields_equal_the_reference(field):
    ref = _ref_schemas()
    diff = {n: (getattr(tregistry.get_op(n), field), getattr(s, field))
            for n, s in ref.items()
            if getattr(tregistry.get_op(n), field) != getattr(s, field)}
    assert not diff, diff


def test_port_aliases_are_reference_aliases_of_the_same_op():
    _ref_schemas()
    for name, schema in tregistry._OPS.items():
        ref = rregistry.find_op(name)
        assert ref is not None and ref.name == schema.name, name


_REF_ND_NAMES = r"""
import json, warnings
warnings.simplefilter("ignore")
import mxnet_tpu
from mxnet_tpu.ops import registry
print(json.dumps(sorted(n for n, s in registry._OPS.items()
                        if "nd" in s.namespaces)))
"""


def test_unported_names_are_the_reference_nd_names_less_the_ports():
    """Against the reference's names at import, taken in a fresh
    interpreter: test files that share this process register test ops in
    the reference's registry (``mx.operator.register``,
    ``library.register_op``)."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    out = subprocess.run([sys.executable, "-c", _REF_ND_NAMES],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=240)
    assert out.returncode == 0, out.stderr[-2000:]
    ref_nd = set(json.loads(out.stdout.strip().splitlines()[-1]))
    helpers = {"linalg", "contrib", "sparse", "utils", "save", "load",
               "save_legacy", "to_dlpack_for_read", "to_dlpack_for_write",
               "from_dlpack"}
    assert UNPORTED == (ref_nd - set(tregistry._OPS)) | helpers
    assert not UNPORTED & set(tregistry._OPS)


@pytest.mark.parametrize("name", ["linalg_gemm2", "Embedding", "contrib",
                                  "_contrib_quantize_v2", "RNN"])
def test_unported_nd_names_raise_naming_the_roadmap_item(name):
    if name == "Embedding":
        assert callable(tmx.nd.Embedding)        # a ported alias
        return
    with pytest.raises(NotImplementedError, match="ROADMAP A9"):
        getattr(tmx.nd, name)


def test_unknown_nd_names_are_attribute_errors():
    assert not hasattr(tmx.nd, "no_such_op")
    with pytest.raises(AttributeError):
        tmx.nd.no_such_op


def test_every_ported_op_is_an_nd_function():
    for name in tregistry._OPS:
        assert callable(getattr(tmx.nd, name)), name


def test_registering_twice_raises():
    with pytest.raises(ValueError, match="registered twice"):
        tregistry.register("relu")(lambda x: x)
    with pytest.raises(ValueError, match="registered twice"):
        tregistry.alias("relu", "sigmoid")
    with pytest.raises(KeyError):
        tregistry.get_op("no_such_op")
    assert tregistry.find_op("no_such_op") is None

"""The port's fake-tensor input specs (`repro_torch.launch.specs`) against the
JAX package's `input_specs`, and the dry run's per-device argument bytes
against the arithmetic over the reference's specs.

All 32 runnable (arch × shape) cells of the reference's `ARCHS` and
`SHAPES`, at full size: every input's shape and dtype equal the
reference's ShapeDtypeStructs.  Each arch's parameter specs are built once
per package (the test memoizes the packages' `params_specs`; every other
input is built per cell).  The reference's shardings are taken bare, as in
`tests/test_torch_sharding.py`.
"""
import os
import subprocess
import sys
import types

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.slow  # full sweep, over 30 s; excluded from `pytest -m "not slow"`

import jax.numpy as jnp  # noqa: E402

import repro.distributed.sharding as jax_sharding  # noqa: E402
import repro.launch.specs as jax_specs  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.configs import supports_shape as jax_supports_shape  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.launch.dryrun import argument_bytes  # noqa: E402
from repro_torch.launch.mesh import production_mesh_shape  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

CELLS = [(a, s) for a in sorted(JAX_ARCHS) for s in JAX_SHAPES
         if jax_supports_shape(jax_get_arch(a), JAX_SHAPES[s])[0]]
ROOT = os.path.join(os.path.dirname(__file__), "..")


def test_the_reference_has_32_runnable_cells():
    assert len(CELLS) == 32


_PARAMS: dict = {}


def memo(key, fn):
    if key not in _PARAMS:
        _PARAMS[key] = fn()
    return _PARAMS[key]


@pytest.fixture
def inputs(monkeypatch):
    """(reference input_specs, port input_specs) of a cell, each arch's
    parameters built once per package."""
    real_jax, real_port = jax_specs.params_specs, specs.params_specs
    monkeypatch.setattr(jax_specs, "params_specs", lambda cfg, model: memo(
        ("jax", cfg.name), lambda: real_jax(cfg, model)))
    monkeypatch.setattr(specs, "params_specs", lambda cfg, model, mode=None: memo(
        ("port", cfg.name), lambda: real_port(cfg, model, mode)))

    def make(arch, shape):
        jcfg, cfg = jax_get_arch(arch), get_arch(arch)
        return (jax_specs.input_specs(jcfg, JAX_SHAPES[shape], jax_build_model(jcfg)),
                specs.input_specs(cfg, SHAPES[shape], build_model(cfg, device="cpu")))
    return make


def flat(tree, prefix=""):
    """{path: leaf} over dicts and NamedTuples."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in flat(sub, f"{prefix}{k}/").items()}
    if hasattr(tree, "_asdict"):
        return flat(tree._asdict(), prefix)
    return {prefix[:-1]: tree}


def same_dtype(jdt, tdt) -> bool:
    return jnp.dtype(jdt).name == str(tdt).replace("torch.", "")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_match_the_reference(arch, shape, inputs):
    """Fake tensors of the reference's shapes and dtypes, leaf for leaf."""
    from torch._subclasses.fake_tensor import FakeTensor
    ref, port = (flat(t) for t in inputs(arch, shape))
    assert sorted(ref) == sorted(port)
    for path, leaf in ref.items():
        got = port[path]
        assert isinstance(got, FakeTensor), path
        assert tuple(got.shape) == tuple(leaf.shape), (path, got.shape, leaf.shape)
        assert same_dtype(leaf.dtype, got.dtype), (path, got.dtype, leaf.dtype)


def test_nemotron_specs_take_no_memory():
    """Building nemotron-4-340b's train_4k specs (341 billion parameters,
    their AdamW moments, the batch) grows the process by under 200 MB: a
    fresh interpreter, its peak resident size before and after."""
    code = ("import resource\n"
            "from repro_torch.configs import SHAPES, get_arch\n"
            "from repro_torch.launch.specs import input_specs\n"
            "before = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss\n"
            "specs = input_specs(get_arch('nemotron-4-340b'), SHAPES['train_4k'])\n"
            "n = sum(p.numel() for p in __import__('torch').utils._pytree.tree_leaves("
            "specs['params']))\n"
            "print(n, resource.getrusage(resource.RUSAGE_SELF).ru_maxrss - before)\n")
    env = {**os.environ, "PYTHONPATH": os.path.join(ROOT, "src")}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=300, check=True).stdout.split()
    n_params, grown_kib = int(out[0]), int(out[1])
    assert n_params > 340e9
    assert grown_kib < 200 * 1024


def _ref_bytes(tree, spec_tree, mesh) -> int:
    """Per-device bytes of reference ShapeDtypeStructs under bare specs."""
    total = 0
    leaves, specs_ = flat(tree), flat(spec_tree)
    for path, leaf in leaves.items():
        n = leaf.dtype.itemsize
        spec = tuple(specs_[path])
        for i, dim in enumerate(leaf.shape):
            entry = spec[i] if i < len(spec) else None
            axes = () if entry is None else (entry if isinstance(entry, tuple) else (entry,))
            size = 1
            for a in axes:
                size *= mesh.shape[a]
            assert dim % size == 0
            n *= dim // size
        total += n
    return total


class _Placed(Exception):
    """Raised by `reference_param_variant`'s stand-in once make_cell has
    placed its parameters."""


def reference_param_variant(jcfg, shape, stub, variant: str, monkeypatch) -> str:
    """The `param_spec` variant the reference's `make_cell` gives a cell's
    parameters under `variant`: its first `param_shardings` call, recorded
    and cut short there (its logical rules reset after)."""
    from repro.models.common import set_logical_rules
    seen = []

    def record(tree, cfg, mesh, variant="baseline"):
        seen.append(variant)
        raise _Placed
    with monkeypatch.context() as m:
        m.setattr(jax_specs, "param_shardings", record)
        try:
            jax_specs.make_cell(jcfg, shape, stub, variant=variant)
        except _Placed:
            pass
        finally:
            set_logical_rules(None)
    return seen[0]


def reference_argument_bytes(jcfg, shape, ref, mesh, pvariant: str = "baseline") -> int:
    """The arithmetic over the reference's in_shardings of its main step
    (`repro.launch.specs.make_cell`): params under `pvariant`, and the
    moments (under the baseline rules, whatever the variant), batch, or
    decode state, token and position."""
    stub = types.SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)
    total = _ref_bytes(ref["params"], jax_sharding.param_shardings(ref["params"], jcfg, stub,
                                                                   pvariant), mesh)
    if shape.kind == "train":
        total += _ref_bytes(ref["opt_state"],
                            jax_sharding.param_shardings(ref["opt_state"], jcfg, stub), mesh)
    if shape.kind in ("train", "prefill"):
        total += _ref_bytes(ref["batch"], jax_sharding.batch_shardings(ref["batch"], jcfg, stub),
                            mesh)
    else:
        total += _ref_bytes(ref["state"], jax_sharding.state_shardings(
            ref["state"], jcfg, stub, shape.global_batch), mesh)
        total += _ref_bytes({"token": ref["token"]}, {"token": jax_sharding.batch_shardings(
            ref["token"], jcfg, stub)}, mesh)
        total += _ref_bytes({"pos": ref["pos"]}, {"pos": ()}, mesh)
    return total


# every cell under baseline (ids as they were), then under opt and opt-zmlp
VARIANT_CELLS = [pytest.param(a, s, v, id=f"{a}-{s}" if v == "baseline" else f"{a}-{s}-{v}")
                 for v in ("baseline", "opt", "opt-zmlp") for a, s in CELLS]


@pytest.mark.parametrize("arch,shape,variant", VARIANT_CELLS)
def test_dry_run_argument_bytes_match_the_reference_rules(arch, shape, variant, inputs,
                                                          monkeypatch):
    """At 16 x 16 and 2 x 16 x 16: `argument_bytes` over the cell's inputs
    and `cell_specs` under `variant` equals the per-device bytes of the
    reference's inputs under its shardings, the parameters under the
    variant its `make_cell` gives them (opt-rowssm for mamba2's opt decode,
    ROADMAP C.4), the moments under the baseline rules."""
    monkeypatch.setattr(jax_sharding, "NamedSharding", lambda mesh, spec: tuple(spec))
    ref, port = inputs(arch, shape)
    jcfg, cfg = jax_get_arch(arch), get_arch(arch)
    for multi in (False, True):
        mesh = production_mesh_shape(multi_pod=multi)
        got = argument_bytes(port, specs.cell_specs(cfg, SHAPES[shape], port, mesh, variant),
                             mesh)
        stub = types.SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)
        pvariant = reference_param_variant(jcfg, JAX_SHAPES[shape], stub, variant,
                                           monkeypatch)
        assert pvariant == specs.cell_rules(cfg, SHAPES[shape].kind, variant, mesh)[1]
        want = reference_argument_bytes(jcfg, JAX_SHAPES[shape], ref, mesh, pvariant)
        assert got == want, (mesh.name, got, want)
        whole = sum(t.numel() * t.element_size() for t in flat(port).values())
        assert 0 < got < whole           # every cell shards something on these meshes

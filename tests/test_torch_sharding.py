"""The port's sharding rules (`repro_torch.distributed.sharding`) against the
JAX package's, at production sizes, and their placement on a torch
DeviceMesh.

Every arch of the reference's `ARCHS` at full size, on 1 x 1, 2 x 2, 16 x
16 and 2 x 16 x 16 meshes, under the baseline, opt-rowssm and opt-zmlp
variants: the parameter tree (the reference's from `jax.eval_shape` of its
init, the port's from an init on fake tensors), the optimizer's m/ and v/
trees, the batch of each shape and the decode state of decode_32k and
long_500k.  Every leaf's spec must equal the reference's ``PartitionSpec``.
The reference's rules wrap each spec in a ``NamedSharding`` over a JAX
mesh; here `NamedSharding` is replaced, in the test only, by one that
returns the bare spec, over a stub mesh with the ``axis_names`` and
``shape`` that the rules read, so no devices are needed.

Then `placements`, `local_shape` and `shard_tree` against
`distribute_tensor`'s local shards, contents included, in four gloo
processes (`torch_ranks`, spawned, meeting through a file store under the
test's temporary directory), on a 2 x 2 and a 2 x 2 x 1 pod mesh.
"""
import types

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.distributed.sharding as jax_sharding  # noqa: E402
from repro.configs import ARCHS as JAX_ARCHS  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kvcache.cache import decode_state_shapes as jax_decode_state_shapes  # noqa: E402
from repro.launch.specs import batch_specs as jax_batch_specs  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training.optimizer import AdamWState as JaxAdamWState  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.kvcache.cache import decode_state_shapes  # noqa: E402
from repro_torch.launch.mesh import MeshShape, production_mesh_shape  # noqa: E402
from repro_torch.launch.specs import batch_specs, params_specs  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training.optimizer import AdamWState  # noqa: E402
from torch_ranks import placement_ranks, spawn  # noqa: E402

ARCH_NAMES = sorted(JAX_ARCHS)
MESHES = {"1x1": MeshShape(("data", "model"), (1, 1)),
          "2x2": MeshShape(("data", "model"), (2, 2)),
          "16x16": production_mesh_shape(),
          "2x16x16": production_mesh_shape(multi_pod=True)}
VARIANTS = ("baseline", "opt-rowssm", "opt-zmlp")
STATE_SHAPES = ("decode_32k", "long_500k")


def stub(mesh: MeshShape):
    """What the reference's rules read of a mesh."""
    return types.SimpleNamespace(axis_names=mesh.axis_names, shape=mesh.shape)


@pytest.fixture
def bare_specs(monkeypatch):
    """The reference's rules return their bare PartitionSpec, as a tuple."""
    monkeypatch.setattr(jax_sharding, "NamedSharding", lambda mesh, spec: tuple(spec))


def flat(tree, prefix=""):
    """{path: leaf} over dicts and NamedTuples (a spec tuple is a leaf)."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in flat(sub, f"{prefix}{k}/").items()}
    if hasattr(tree, "_asdict"):
        return flat(tree._asdict(), prefix)
    return {prefix[:-1]: tree}


_TREES: dict = {}


def param_trees(name: str):
    """(the reference's parameter shapes, the port's fake parameters) at
    full size, made once per arch."""
    if name not in _TREES:
        jm = jax_build_model(jax_get_arch(name))
        cfg = get_arch(name)
        _TREES[name] = (jax.eval_shape(jm.init, jax.random.key(0)),
                        params_specs(cfg, build_model(cfg, device="cpu")))
    return _TREES[name]


def opt_trees(name: str):
    """The AdamW states of both packages over those parameters."""
    jp, tp = param_trees(name)
    f32 = lambda a: jax.ShapeDtypeStruct(a.shape, jnp.float32)   # noqa: E731
    jopt = JaxAdamWState(jax.ShapeDtypeStruct((), jnp.int32), jax.tree.map(f32, jp),
                         jax.tree.map(f32, jp))
    return jopt, AdamWState(torch.zeros((), dtype=torch.int32), tp, tp)


def assert_same_specs(ref, port, what):
    ref, port = flat(ref), flat(port)
    assert sorted(ref) == sorted(port), what
    for path in ref:
        assert tuple(ref[path]) == port[path], (what, path, ref[path], port[path])


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("name", ARCH_NAMES)
def test_rules_match_the_reference(name, mesh_name, bare_specs):
    """Parameters and optimizer moments under the three variants, each
    shape's batch, and the decode state of decode_32k and long_500k."""
    mesh = MESHES[mesh_name]
    jcfg, cfg = jax_get_arch(name), get_arch(name)
    jp, tp = param_trees(name)
    jopt, topt = opt_trees(name)
    for variant in VARIANTS:
        assert_same_specs(jax_sharding.param_shardings(jp, jcfg, stub(mesh), variant),
                          sharding.param_shardings(tp, cfg, mesh, variant), ("params", variant))
        assert_same_specs(jax_sharding.param_shardings(jopt, jcfg, stub(mesh), variant),
                          sharding.param_shardings(topt, cfg, mesh, variant), ("opt", variant))
    for sname in SHAPES:
        assert_same_specs(jax_sharding.batch_shardings(
                              jax_batch_specs(jcfg, JAX_SHAPES[sname]), jcfg, stub(mesh)),
                          sharding.batch_shardings(batch_specs(cfg, SHAPES[sname]), cfg, mesh),
                          ("batch", sname))
    for sname in STATE_SHAPES:
        shape = SHAPES[sname]
        b, s = shape.global_batch, shape.seq_len
        assert_same_specs(jax_sharding.state_shardings(
                              jax_decode_state_shapes(jcfg, b, s), jcfg, stub(mesh), b),
                          sharding.state_shardings(decode_state_shapes(cfg, b, s), cfg, mesh, b),
                          ("state", sname))


def test_the_rules_shard_every_kind_of_leaf(bare_specs):
    """The comparison is not vacuous: at 16 x 16 the leaves take columns
    over `model`, FSDP rows over "data", and a pod mesh's rows over
    ("pod", "data") as one tuple entry."""
    jp, tp = param_trees("nemotron-4-340b")
    cfg = get_arch("nemotron-4-340b")
    single = flat(sharding.param_shardings(tp, cfg, MESHES["16x16"]))
    multi = flat(sharding.param_shardings(tp, cfg, MESHES["2x16x16"]))
    assert single["layers/attn/wq"] == (None, "data", "model")
    assert multi["layers/attn/wq"] == (None, ("pod", "data"), "model")
    assert multi["layers/mlp/w_down"] == (None, "model", ("pod", "data"))
    small = flat(sharding.param_shardings(param_trees("smollm-360m")[1],
                                          get_arch("smollm-360m"), MESHES["16x16"]))
    assert small["layers/attn/wq"] == (None, None, "model")     # no FSDP under 4 GB


@pytest.mark.parametrize("name", ARCH_NAMES)
def test_fsdp_enabled_matches(name):
    assert sharding.fsdp_enabled(get_arch(name)) == jax_sharding.fsdp_enabled(
        jax_get_arch(name))


@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("variant", ["baseline", "opt", "opt-zmlp"])
def test_activation_rules_match(variant, kind):
    for mesh in MESHES.values():
        assert sharding.activation_rules(mesh, variant, kind) == \
            jax_sharding.activation_rules(stub(mesh), variant, kind)


def test_local_shape_splits_each_dim_by_its_axes():
    mesh = MESHES["2x16x16"]
    assert sharding.local_shape((96, 18432, 768), (None, ("pod", "data"), "model"), mesh) == \
        (96, 576, 48)
    assert sharding.local_shape((), (), mesh) == ()
    with pytest.raises(ValueError, match="does not split"):
        sharding.local_shape((24, 10), ("model", None), mesh)


# ---------------------------------------------------------------------------
# on a DeviceMesh, four ranks (`torch_ranks.placement_ranks`)
# ---------------------------------------------------------------------------

def test_placements_and_local_shapes_match_distribute_tensor(tmp_path, monkeypatch):
    """On each rank of a 2 x 2 and a 2 x 2 x 1 pod mesh, for hand-picked
    specs and the rules' specs of a reduced model: `distribute_tensor`
    under `placements(spec)` holds the shape `local_shape` gives and the
    contents `local_slice` cuts (a tuple of axes major to minor), as does
    `shard_tree`; the placements give the spec back, and `gather_tree`
    the whole tensor."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    spawn(placement_ranks, 4, (str(tmp_path),))
    seen_tuple = False
    for rank in range(4):
        for r in torch.load(tmp_path / f"rank{rank}.pt", weights_only=False):
            where = (rank, r["mesh"], r["path"], r["spec"])
            assert r["local_shape"] == r["rules_shape"], where
            assert r["slice_equal"] and r["shard_equal"] and r["gathered_equal"], where
            assert r["spec_back"] == r["spec"], where
            seen_tuple |= any(isinstance(e, tuple) for e in r["spec"])
    assert seen_tuple


def test_placements_refuse_axes_out_of_the_mesh_order():
    mesh = types.SimpleNamespace(mesh_dim_names=("pod", "data", "model"))
    with pytest.raises(ValueError, match="mesh's order"):
        sharding.placements((("data", "pod"), None), mesh)
    assert len(sharding.placements((None, "model"), mesh)) == 3


def test_fake_specs_allocate_nothing():
    """The port's parameter specs are fake tensors in one fake mode."""
    from torch._subclasses.fake_tensor import FakeTensor
    _, tp = param_trees("smollm-360m")
    assert all(isinstance(v, FakeTensor) for v in flat(tp).values())

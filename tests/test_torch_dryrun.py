"""The port's dry run (`repro_torch.launch.dryrun`): one rank's step of a
cell on fake tensors against `jax.eval_shape` of the reference's step, and
the records it writes.

One cell per (family × kind): the output shapes and dtypes of the port's
step (`launch.specs.make_cell` on a 1 x 1 mesh, where a rank holds the
whole batch) equal those of the reference's train_step, prefill or
serve_step on its `input_specs`.  Depth is cut to 2 layers (Hymba keeps
one global layer, seamless 2 encoder layers) in both packages: the outputs
depend on depth only through the stacked [L, ...] leaves, and the plain
SSD scan's chunk loop on fake tensors takes some 30 s a cell at full depth.
Widths, batches and sequence lengths are the cells' own.
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.slow  # full sweep, over 30 s; excluded from `pytest -m "not slow"`

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro.launch.specs as jax_specs  # noqa: E402
from repro.configs import SHAPES as JAX_SHAPES  # noqa: E402
from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro.training.train import make_train_step as jax_make_train_step  # noqa: E402
from repro_torch.configs import SHAPES, get_arch  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import LOCAL_MESH_SHAPE  # noqa: E402
from repro_torch.launch.specs import Cell, ShapeCollectives, fake_mode, make_cell  # noqa: E402

FAMILY_ARCHS = {"dense": "smollm-360m", "moe": "moonshot-v1-16b-a3b", "ssm": "mamba2-780m",
                "hybrid": "hymba-1.5b", "vlm": "phi-3-vision-4.2b",
                "encdec": "seamless-m4t-large-v2"}
KIND_SHAPES = {"train": "train_4k", "prefill": "prefill_32k", "decode": "decode_32k"}
# the keys of the reference's run_cell record (src/repro/launch/dryrun.py),
# and those its main adds
RECORD_KEYS = {"arch", "shape", "mesh", "status", "step", "chips", "per_device", "roofline",
               "fits_hbm", "collective_breakdown", "parts", "wall_s", "variant"}
PER_DEVICE_KEYS = {"flops", "bytes_accessed", "collective_bytes", "argument_bytes",
                   "temp_bytes", "output_bytes", "hbm_total_bytes"}
ROOFLINE_KEYS = {"compute_s", "memory_s", "collective_s", "dominant", "model_flops_per_dev",
                 "useful_flops_ratio"}
COLLECTIVE_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                   "collective-permute"}
SKIPPED_KEYS = {"arch", "shape", "mesh", "status", "reason", "wall_s", "variant"}


def cut(cfg):
    """2 layers of `cfg`, its widths as they are."""
    kw = {"num_layers": 2}
    if cfg.family == "hybrid":
        kw["full_attn_layers"] = (0,)
    if cfg.family == "encdec":
        kw["num_encoder_layers"] = 2
    return dataclasses.replace(cfg, **kw)


def reference_outputs(jcfg, shape):
    """`jax.eval_shape` of the reference's main step of the cell."""
    model = jax_build_model(jcfg)
    ins = jax_specs.input_specs(jcfg, shape, model)
    if shape.kind == "train":
        return jax.eval_shape(jax_make_train_step(model, JaxTrainConfig()), ins["params"],
                              ins["opt_state"], ins["batch"])
    if shape.kind == "prefill":
        return jax.eval_shape(lambda p, b: model.prefill(p, b, max_len=shape.seq_len),
                              ins["params"], ins["batch"])
    return jax.eval_shape(model.decode_step, ins["params"], ins["state"], ins["token"],
                          ins["pos"])


def flat(tree, prefix=""):
    """{path: leaf} over dicts, NamedTuples, tuples and lists."""
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items() for p, v in flat(sub, f"{prefix}{k}/").items()}
    if hasattr(tree, "_asdict"):
        return flat(tree._asdict(), prefix)
    if isinstance(tree, (tuple, list)):
        return flat(dict(enumerate(tree)), prefix)
    return {prefix[:-1]: tree}


@pytest.mark.parametrize("kind", list(KIND_SHAPES))
@pytest.mark.parametrize("family", list(FAMILY_ARCHS))
def test_fake_step_outputs_match_the_references(family, kind):
    arch, sname = FAMILY_ARCHS[family], KIND_SHAPES[kind]
    ref = flat(reference_outputs(cut(jax_get_arch(arch)), JAX_SHAPES[sname]))
    cell = make_cell(cut(get_arch(arch)), SHAPES[sname], LOCAL_MESH_SHAPE)
    with cell.mode:
        got = flat(cell.fn(*cell.args))
    assert sorted(got) == sorted(ref)
    for path, leaf in ref.items():
        if isinstance(got[path], int):      # the next position: a host int in the port
            assert tuple(leaf.shape) == () and jnp.dtype(leaf.dtype) == jnp.int32, path
            continue
        assert tuple(got[path].shape) == tuple(leaf.shape), (path, got[path].shape, leaf.shape)
        assert str(got[path].dtype) == f"torch.{jnp.dtype(leaf.dtype).name}", path


def _chain(a, b, d, c):
    """Three [4, 16] f32 intermediates (256 bytes each), each freed once the
    next is made, an output of 32 bytes, and an input doubled in place."""
    h1 = a @ b
    h2 = h1 @ d
    del h1
    h3 = h2 @ d
    del h2
    out = h3 @ c
    a.mul_(2)
    return out, a


def test_step_memory_counts_a_matmul_chain_exactly():
    """`analyse_cell` on `_chain` over fake f32 a [4,8], b [8,16], d [16,16],
    c [16,2], figures worked out by hand:
    - flops 2·4·16·(8 + 16 + 16) + 2·4·2·16 = 5,376;
    - bytes accessed, inputs and output of each op: a@b 128+512+256,
      h1@d and h2@d 256+1,024+256 each, h3@c 256+128+32, a.mul_ 128+128:
      4,640;
    - temp peak 512: two intermediates live at once, never three (768 if a
      freed one were still counted), the output left out;
    - outputs 32 + 128 bytes, of which `a` (128) is an input updated in
      place."""
    mode = fake_mode()
    with mode:
        args = tuple(torch.empty(s, dtype=torch.float32)
                     for s in ((4, 8), (8, 16), (16, 16), (16, 2)))
    part = dryrun.analyse_cell(Cell("chain", _chain, args, {}, {}, mode,
                                    ShapeCollectives(LOCAL_MESH_SHAPE)))
    assert part["flops"] == 5376 and part["bytes_accessed"] == 4640
    assert part["memory"] == {"output_bytes": 160, "temp_bytes": 512, "alias_bytes": 128}
    assert sum(part["collective_bytes"].values()) == 0


def test_dry_run_writes_the_references_record_keys(tmp_path, capsys):
    """`python -m repro_torch.launch.dryrun` on one runnable and one skipped
    cell: the reference's record keys, every figure measured or counted,
    and a second run resumes past the cells already written."""
    out = tmp_path / "dryrun.json"
    for shape in ("decode_32k", "long_500k"):
        dryrun.main(["--arch", "smollm-360m", "--shape", shape, "--mesh", "single",
                     "--out", str(out)])
    recs = json.loads(out.read_text())
    ok, skipped = recs
    assert set(ok) == RECORD_KEYS and set(skipped) == SKIPPED_KEYS
    assert set(ok["per_device"]) == PER_DEVICE_KEYS and set(ok["roofline"]) == ROOFLINE_KEYS
    assert set(ok["collective_breakdown"]) == COLLECTIVE_KEYS
    assert (ok["status"], ok["step"], ok["mesh"], ok["chips"]) == ("ok", "serve_step", "16x16",
                                                                  256)
    assert skipped["status"] == "skipped" and "sub-quadratic" in skipped["reason"]
    pd = ok["per_device"]
    assert all(pd[k] > 0 for k in PER_DEVICE_KEYS)
    assert pd["hbm_total_bytes"] == pd["argument_bytes"] + pd["temp_bytes"] + pd["output_bytes"]
    assert ok["fits_hbm"] is (pd["hbm_total_bytes"] <= dryrun.HBM_CAPACITY_BYTES)
    # decode gathers the parameters (columns over `model`) and the cache's
    # sequence shards, and reduces nothing
    assert ok["collective_breakdown"]["all-reduce"] == 0
    assert ok["collective_breakdown"]["all-gather"] == pd["collective_bytes"]
    capsys.readouterr()
    dryrun.main(["--arch", "smollm-360m", "--shape", "decode_32k", "--mesh", "single",
                 "--out", str(out)])
    assert len(json.loads(out.read_text())) == 2
    assert "wrote" in capsys.readouterr().out


def test_dry_run_covers_the_references_cells():
    """The dry run's archs are the reference's ARCHS: 40 cells a mesh, 32
    of them runnable."""
    from repro.configs import ARCHS as JAX_ARCHS
    assert sorted(dryrun.DRYRUN_ARCHS) == sorted(JAX_ARCHS)
    assert len(dryrun.DRYRUN_ARCHS) * len(SHAPES) == 40

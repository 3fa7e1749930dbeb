"""The port's distributed layer over `torch.distributed` on the CPU:
`compressed_allreduce` and the sharded train step
(`repro_torch.distributed.train_step`) in four gloo processes, held to the
JAX package; a world of one held bit for bit to `make_train_step`; a
sharded run's checkpoint resumed in one process.

The ranks are spawned processes (`torch_ranks`, which imports no JAX) that
meet through a file store under the test's temporary directory (no TCP
rendezvous; gloo's transport on the loopback interface) and write their
results for the parent, which holds the reference.  Tolerances: `compressed_allreduce`'s payloads and scales
exactly, its sums within 2e-5 (`tests/test_kernels.py`'s fp32 band); the
sharded steps within the band of `tests/test_torch_training.py`'s five
train steps (loss and gradient norm 1e-4 relative, parameters 2 lr).
"""
import dataclasses
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.optimizer import compressed_allreduce as jax_compressed_allreduce  # noqa: E402
from repro.training.optimizer import quantize_int8 as jax_quantize_int8  # noqa: E402
from repro.training.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.launch import train as port_train  # noqa: E402
from repro_torch.distributed.train_step import rank_batch, rank_step  # noqa: E402
from repro_torch.launch.mesh import make_local_mesh  # noqa: E402
from repro_torch.launch.specs import ShapeCollectives, fake_mode  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import (TrainConfig, adamw_init, make_train_step,  # noqa: E402
                                  restore_checkpoint)
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402
from torch.utils._pytree import tree_leaves as pytree_leaves  # noqa: E402
from torch_ranks import (LR, ONE_RANK, STEP_MESHES, WORLD, four_ranks,  # noqa: E402
                         internlm2_cfg, one_rank, spawn)

STEPS = 2


def uneven_batches(vocab: int, n: int = STEPS, b: int = 4, s: int = 16, seed: int = 3):
    """Batches whose loss masks differ between the two data shards (rows
    0-1 and 2-3): shard 0 keeps about a third of its positions, shard 1
    all of them."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        mask = np.ones((b, s), np.float32)
        mask[: b // 2] = (rng.random((b // 2, s)) < 0.35).astype(np.float32)
        out.append({"tokens": rng.integers(0, vocab, (b, s)).astype(np.int32),
                    "targets": rng.integers(0, vocab, (b, s)).astype(np.int32),
                    "loss_mask": mask})
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The four ranks' results (`torch_ranks.four_ranks`), and the
    reference's inputs."""
    out = tmp_path_factory.mktemp("four_ranks")
    jcfg = dataclasses.replace(jax_get_arch("internlm2-1.8b").reduced(), dtype="float32")
    tcfg = internlm2_cfg()
    jm = jax_build_model(jcfg)
    jparams = jm.init(jax.random.PRNGKey(0))
    params_np = jax.tree.map(np.asarray, jparams)
    xs = np.random.default_rng(0).standard_normal((WORLD, 256)).astype(np.float32)
    batches = uneven_batches(tcfg.vocab_size)
    mp = pytest.MonkeyPatch()
    mp.setenv("GLOO_SOCKET_IFNAME", "lo")
    try:
        spawn(four_ranks, WORLD, (str(out), xs, params_np, batches))
    finally:
        mp.undo()
    results = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"ranks": results, "xs": xs, "jm": jm, "jparams": jparams, "params_np": params_np,
            "batches": batches, "cfg": tcfg, "ckpt": out / "ckpt",
            "train_ckpt": out / "train_ckpt"}


def test_compressed_allreduce_matches_the_reference_on_four_ranks(ranks):
    """The reference under `jax.vmap(..., axis_name="dp")`: each rank's
    all-gathered int8 payloads and scales equal the reference's per-rank
    `quantize_int8`, and every rank's sum is the reference's within 2e-5."""
    xs = ranks["xs"]
    ref_sum = jax.vmap(lambda x: jax_compressed_allreduce(x, "dp"), axis_name="dp")(
        jnp.asarray(xs))
    ref_q, ref_scale = jax.vmap(jax_quantize_int8)(jnp.asarray(xs))
    for r, res in enumerate(ranks["ranks"]):
        car = res["car"]
        # each rank sends its payload as int8: numel bytes
        assert car["q"].dtype == torch.int8 and car["q"].numel() == WORLD * xs[r].size
        np.testing.assert_array_equal(car["q"].numpy().reshape(WORLD, -1), np.asarray(ref_q))
        np.testing.assert_array_equal(car["scale"].numpy(), np.asarray(ref_scale))
        np.testing.assert_allclose(car["sum"].numpy(), np.asarray(ref_sum[r]),
                                   rtol=2e-5, atol=2e-5)
        assert torch.equal(car["sum"], ranks["ranks"][0]["car"]["sum"])


def _reference_steps(ranks, accum: int):
    """(losses, norms, params) of the reference's and of the port's
    unsharded train steps on the whole batches, `accum` microbatches a
    step."""
    jm, jp = ranks["jm"], ranks["jparams"]
    cfg = ranks["cfg"]
    jstep = jax.jit(jax_make_train_step(jm, JaxTrainConfig(lr=LR, grad_accum=accum)))
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(cfg, ranks["params_np"], device="cpu")
    tstep = make_train_step(tm, TrainConfig(lr=LR, grad_accum=accum))
    jo, to = jax_adamw_init(jp), adamw_init(tp)
    jax_run, port_run = {"loss": [], "grad_norm": []}, {"loss": [], "grad_norm": []}
    for b in ranks["batches"]:
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp, to, tmet = tstep(tp, to, {k: torch.from_numpy(v) for k, v in b.items()})
        for run, met in ((jax_run, jmet), (port_run, tmet)):
            run["loss"].append(float(met["loss"]))
            run["grad_norm"].append(float(met["grad_norm"]))
    jax_run["params"] = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    port_run["params"] = tp
    return jax_run, port_run


@pytest.mark.parametrize("mesh", [m[0] for m in STEP_MESHES])
def test_sharded_steps_match_the_unsharded_and_the_reference(ranks, mesh):
    """Two steps on uneven loss masks: every rank's loss and gradient norm
    are the global ones, and they and the gathered parameters match the
    port's `make_train_step` and the reference's train step on the whole
    batch, with the mesh's number of microbatches a step."""
    accum = next(m[3] for m in STEP_MESHES if m[0] == mesh)
    jax_run, port_run = _reference_steps(ranks, accum)
    runs = [res[mesh] for res in ranks["ranks"]]
    for run in runs[1:]:
        assert run["loss"] == runs[0]["loss"] and run["grad_norm"] == runs[0]["grad_norm"]
    for ref in (port_run, jax_run):
        for key in ("loss", "grad_norm"):
            for got, want in zip(runs[0][key], ref[key]):
                assert got == pytest.approx(want, rel=1e-4), (mesh, key)
        for a, b in zip(tree_leaves(runs[0]["params"]), tree_leaves(ref["params"])):
            assert (a - b).abs().max().item() <= 2 * LR


def test_a_mean_of_rank_means_would_differ(ranks):
    """The uneven masks are uneven enough that averaging the two data
    shards' own masked means misses the global loss (what the step's
    weighting is for)."""
    cfg = ranks["cfg"]
    tm = build_model(cfg, device="cpu")
    tp = params_from_jax(cfg, ranks["params_np"], device="cpu")
    b = {k: torch.from_numpy(v) for k, v in ranks["batches"][0].items()}
    whole = tm.loss(tp, b).item()
    halves = [tm.loss(tp, {k: v[i:i + 2] for k, v in b.items()}).item() for i in (0, 2)]
    assert abs(sum(halves) / 2 - whole) > 1e-3 * abs(whole)
    assert ranks["ranks"][0]["2x2"]["loss"][0] == pytest.approx(whole, rel=1e-6)


def fake_step_bytes(cfg, mesh, params, specs, batch, accum: int) -> dict:
    """What the dry run counts for one rank's train step: `rank_step` over
    `ShapeCollectives` on fake shards of the rules' local shapes and the
    rank's share of a fake batch."""
    model = build_model(cfg, device="cpu")
    comm = ShapeCollectives(mesh)
    with fake_mode():
        local = tree_map(lambda t, s: torch.empty(sharding.local_shape(t.shape, s, mesh),
                                                  dtype=t.dtype), params, specs)
        b, split = rank_batch({k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype)
                               for k, v in batch.items()}, cfg, mesh, comm.coords, accum)
        rank_step(model, TrainConfig(lr=LR, grad_accum=accum), local, specs, adamw_init(local),
                  b, split, comm)
    return comm.bytes


@pytest.mark.parametrize("mesh", [m[0] for m in STEP_MESHES])
def test_collective_bytes_equal_the_dry_runs_arithmetic(ranks, mesh, monkeypatch):
    """What each rank's step counted, by kind, is what the dry run's fake
    step counts for that config and mesh, and both are the split step's
    schedule (f32 throughout): all-reduced are the gradients of the leaves
    the data axes do not split, each microbatch's mask count, the loss and
    the per-leaf squared norms, one a tensor whatever the number of data
    axes, and over `model` per layer and microbatch the attention's and the
    MLP's outputs and their inputs' gradients, the embedding, the head's
    input gradient and each token's max, sum of exps and target logit;
    with FSDP rows over ("pod", "data"), each use of such a leaf gathers
    its rows (the shard over `data`, then two shards' worth over `pod`) and
    its backward reduce-scatters them (four, then two); the shards hold the
    rules' local shapes."""
    name, shape, fsdp, accum = next(m for m in STEP_MESHES if m[0] == mesh)
    if fsdp:
        monkeypatch.setattr(sharding, "fsdp_enabled", lambda cfg: True)
    cfg = ranks["cfg"]
    params = params_from_jax(cfg, ranks["params_np"], device="cpu")
    specs = sharding.param_shardings(params, cfg, shape)
    want = fake_step_bytes(cfg, shape, params, specs, ranks["batches"][0], accum)
    leaves, leaf_specs = tree_leaves(params), tree_leaves(specs)
    local = [math.prod(sharding.local_shape(p.shape, sp, shape)) for p, sp in
             zip(leaves, leaf_specs)]
    rows = sum(n for n, sp in zip(local, leaf_specs)
               if any(e is not None and e != "model" for e in sp))
    b, s = ranks["batches"][0]["tokens"].shape
    b_rank = b // math.prod(shape.shape[a] for a in shape.axis_names if a != "model")
    activations = b_rank * s * ((2 + 4 * cfg.num_layers) * cfg.d_model + 3)
    assert want["all-reduce"] == 4 * (sum(local) - rows + accum + 1 + len(leaves)
                                      + activations)
    # a shard's rows: gathered from 1 then 2 shards' worth, reduce-scattered from 4 then 2
    assert want["all-gather"] == 4 * 3 * accum * rows
    assert want["reduce-scatter"] == 4 * 6 * accum * rows
    assert (rows > 0) is fsdp
    for res in ranks["ranks"]:
        assert res[mesh]["bytes"] == [want] * STEPS
        for k, got in res[mesh]["local_shapes"].items():
            leaf = params["layers"]["attn"][k]
            assert got == sharding.local_shape(leaf.shape, specs["layers"]["attn"][k], shape)


def test_sharded_checkpoint_resumes_in_one_process_bit_for_bit(ranks, tmp_path):
    """Rank 0's checkpoint of the 2 x 2 run after step 1 holds the gathered
    state bit for bit; one process restores it and steps on exactly as
    from the gathered state."""
    cfg = ranks["cfg"]
    saved = ranks["ranks"][0]["saved"]
    template = {"params": tree_zeros(saved["params"]), "opt": adamw_init(saved["params"])}
    restored, at = restore_checkpoint(str(ranks["ckpt"]), template)
    assert at == 1 and int(restored["opt"].step) == 1
    for a, b in zip(pytree_leaves(restored), pytree_leaves(saved), strict=True):
        assert a.dtype == b.dtype and torch.equal(a, b)
    step = make_train_step(build_model(cfg, device="cpu"), TrainConfig(lr=LR))
    batch = {k: torch.from_numpy(v) for k, v in ranks["batches"][1].items()}
    p1, _, m1 = step(restored["params"], restored["opt"], batch)
    p2, _, m2 = step(saved["params"], saved["opt"], batch)
    assert m1["loss"].item() == m2["loss"].item()
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2)))


def test_launch_train_sharded_run_resumes_in_one_process(ranks, capsys):
    """launch.train on a 2 x 2 mesh wrote step 2's full-tensor checkpoint;
    one process resumes it and trains on."""
    args = ["--arch", "internlm2-1.8b", "--reduced", "--device", "cpu", "--batch", "4",
            "--seq", "16", "--ckpt-every", "1", "--log-every", "1",
            "--ckpt-dir", str(ranks["train_ckpt"])]
    port_train.main(args + ["--steps", "3"])
    out = capsys.readouterr().out
    assert "resumed from step 2" in out and "step     3" in out


def tree_zeros(tree):
    return {k: tree_zeros(v) for k, v in tree.items()} if isinstance(tree, dict) else \
        torch.zeros_like(tree)


# ---------------------------------------------------------------------------
# a world of one
# ---------------------------------------------------------------------------

def test_a_world_of_one_is_the_unsharded_step_bit_for_bit(tmp_path, monkeypatch):
    """On one rank every collective is a copy: three sharded steps (dense,
    moe, and two microbatches) give the unsharded step's losses, norms,
    parameters and moments bit for bit."""
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    spawn(one_rank, 1, (str(tmp_path),))
    res = torch.load(tmp_path / "one.pt", weights_only=False)
    assert "needs 4 ranks" in res["refused"]
    for name, _ in ONE_RANK:
        r = res[name]
        assert r["steps"] == (3, 3)
        for (la, na), (lb, nb) in zip(r["runs"]["plain"], r["runs"]["sharded"]):
            assert torch.equal(la, lb) and torch.equal(na, nb), name
        for a, b in zip(tree_leaves(r["plain"]), tree_leaves(r["sharded"])):
            assert a.dtype == b.dtype and torch.equal(a, b), name


def test_without_a_card_the_cuda_mesh_raises():
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_local_mesh("cuda")

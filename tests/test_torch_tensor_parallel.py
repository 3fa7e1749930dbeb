"""Split compute on a mesh for the dense, moe and vlm families
(`repro_torch.distributed.tensor_parallel`, `serve_step` and the split
`train_step.rank_step`), in four gloo processes on the CPU, held to the
unsharded port and to the JAX package.

Meshes: 2 x 2 (data, model), FSDP off and forced on; 1 x 4 (model) with
heads split unevenly (6:2 and 5:5 heads on 4 ranks: 1 or 2 a rank, none
padded).  Reduced fp32 internlm2-1.8b (GQA), smollm-360m (tied head, 5:5
heads), qwen3-moe-30b-a3b (experts over `model`) and phi-3-vision-4.2b
(`torch_tp_ranks.CONFIGS`).

Tolerances: train steps within the band of `test_torch_distributed.py`
(loss and gradient norm 1e-4 relative, parameters 2 lr); serving's greedy
tokens exactly, its logits and decode state within 1e-4; the decode
kernel's plain version within 2e-5 of the Pallas kernel in interpret mode
(`test_torch_kernels.py`'s fp32 band), its LSE within 1e-5 of a float64
log-sum-exp.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.kernels.decode_attention import decode_attention as pallas_decode  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.serve_step import rank_decode  # noqa: E402
from repro_torch.distributed.tensor_parallel import combine  # noqa: E402
from repro_torch.distributed.train_step import rank_batch, rank_step  # noqa: E402
from repro_torch.kernels import ref  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.specs import ShapeCollectives, fake_mode  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import TrainConfig, adamw_init, make_train_step  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402
from torch_ranks import WORLD, forced_fsdp, spawn  # noqa: E402
from torch_tp_ranks import (CONFIGS, LR, MESHES, NEW_TOKENS, SERVE_CASES, STEPS,  # noqa: E402
                            TRAIN_CASES, case_name, config, tp_ranks)


def jax_config(name: str):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(jax_get_arch(arch).reduced(), dtype="float32", **kw)


def train_batches(cfg, seed: int, b: int = 4, s: int = 16):
    """STEPS batches whose loss masks differ between the two data shards
    (rows 0-1 keep about a third of their positions, rows 2-3 all)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(STEPS):
        mask = np.ones((b, s), np.float32)
        mask[: b // 2] = (rng.random((b // 2, s)) < 0.35).astype(np.float32)
        batch = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 "targets": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
                 "loss_mask": mask}
        if cfg.family == "vlm":
            batch["patch_embeds"] = rng.standard_normal(
                (b, cfg.num_patches, cfg.d_model)).astype(np.float32)
        out.append(batch)
    return out


def prompt(cfg, seed: int, b: int = 2, s: int = 8):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patch_embeds"] = rng.standard_normal((b, cfg.num_patches, cfg.d_model)
                                                  ).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The four ranks' results (`torch_tp_ranks.tp_ranks`) and the inputs."""
    out = tmp_path_factory.mktemp("tp_ranks")
    params_np, jms, jps = {}, {}, {}
    for name in CONFIGS:
        jms[name] = jax_build_model(jax_config(name))
        jps[name] = jms[name].init(jax.random.PRNGKey(0))
        params_np[name] = jax.tree.map(np.asarray, jps[name])
    batches = {n: train_batches(config(n), 3 + i) for i, n in enumerate(CONFIGS)}
    prompts = {n: prompt(config(n), 7 + i) for i, n in enumerate(CONFIGS)}
    tp = {"params_np": params_np, "jms": jms, "jps": jps, "batches": batches,
          "prompts": prompts}

    def references():       # while the ranks run
        return {case: _reference_steps(tp, case[0], case[3]) for case in TRAIN_CASES}
    mp = pytest.MonkeyPatch()
    mp.setenv("GLOO_SOCKET_IFNAME", "lo")
    try:
        tp["refs"] = spawn(tp_ranks, WORLD, (str(out), params_np, batches, prompts),
                           timeout=300.0, meanwhile=references)
    finally:
        mp.undo()
    tp["ranks"] = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return tp


def _reference_steps(tp, name: str, accum: int):
    """(reference's, port's) runs of the unsharded step on the whole batches:
    losses, norms and the final parameters."""
    cfg = config(name)
    jp = tp["jps"][name]
    jstep = jax.jit(jax_make_train_step(tp["jms"][name],
                                        JaxTrainConfig(lr=LR, grad_accum=accum)))
    tp_params = params_from_jax(cfg, tp["params_np"][name], device="cpu")
    tstep = make_train_step(build_model(cfg, device="cpu"),
                            TrainConfig(lr=LR, grad_accum=accum))
    jo, to = jax_adamw_init(jp), adamw_init(tp_params)
    runs = ({"loss": [], "grad_norm": []}, {"loss": [], "grad_norm": []})
    for b in tp["batches"][name]:
        jp, jo, jmet = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        tp_params, to, tmet = tstep(tp_params, to, {k: torch.from_numpy(v)
                                                    for k, v in b.items()})
        for run, met in zip(runs, (jmet, tmet)):
            run["loss"].append(float(met["loss"]))
            run["grad_norm"].append(float(met["grad_norm"]))
    runs[0]["params"] = params_from_jax(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    runs[1]["params"] = tp_params
    return runs


@pytest.mark.parametrize("case", TRAIN_CASES, ids=case_name)
def test_split_train_step_matches_the_unsharded_and_the_reference(tp, case):
    """STEPS steps on uneven loss masks: every rank's loss and gradient norm
    are the global ones, and they and the gathered parameters match the
    port's `make_train_step` and the reference's train step on the whole
    batch."""
    runs = [res[case_name(case)] for res in tp["ranks"]]
    for run in runs[1:]:
        assert run["loss"] == runs[0]["loss"] and run["grad_norm"] == runs[0]["grad_norm"]
    for want in tp["refs"][case]:
        for key in ("loss", "grad_norm"):
            for got, w in zip(runs[0][key], want[key]):
                assert got == pytest.approx(w, rel=1e-4), (case, key)
        for a, b in zip(tree_leaves(runs[0]["params"]), tree_leaves(want["params"])):
            assert (a - b).abs().max().item() <= 2 * LR, case


def _greedy(cfg, params, batch, max_len: int):
    """The unsharded port: prefill, then NEW_TOKENS greedy steps."""
    model = build_model(cfg, device="cpu")
    logits, state, pos = model.prefill(params, batch, max_len=max_len)
    out = {"logits": [logits], "tokens": [],
           "state0": tree_map(torch.clone, state)}
    for _ in range(NEW_TOKENS):
        tok = logits.argmax(-1)
        out["tokens"].append(tok)
        logits, state = model.decode_step(params, state, tok, pos)
        out["logits"].append(logits)
        pos += 1
    out["state"] = state
    return out


@pytest.mark.parametrize("case", SERVE_CASES, ids=case_name)
def test_split_prefill_and_decode_match_the_unsharded(tp, case):
    """Sharded prefill plus NEW_TOKENS greedy steps: each rank's tokens are
    the unsharded port's for its rows, its logits within 1e-4, and its
    decode state (after prefill and at the end) its slice of the unsharded
    state under `state_shardings`."""
    name, mesh_name = case
    cfg, mesh = config(name), MESHES[mesh_name]
    batch = {k: torch.from_numpy(v) for k, v in tp["prompts"][name].items()}
    s = batch["tokens"].shape[1] + (cfg.num_patches if cfg.family == "vlm" else 0)
    want = _greedy(cfg, params_from_jax(cfg, tp["params_np"][name], device="cpu"), batch,
                   s + NEW_TOKENS)
    st_specs = sharding.state_shardings(want["state"], cfg, mesh, batch["tokens"].shape[0])
    row_spec = sharding.batch_shardings(want["tokens"][0], cfg, mesh)
    for res in tp["ranks"]:
        got, coords = res[case_name(case)], res["coords"][mesh_name]

        def rows(t):
            return sharding.local_slice(t, row_spec + (None,) * (t.dim() - 1), mesh, coords)
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, rows(b)), case
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(a.numpy(), rows(b).numpy(), rtol=1e-4, atol=1e-4)
        for key in ("state0", "state"):
            for a, b, s_ in zip(tree_leaves(got[key]), tree_leaves(want[key]),
                                tree_leaves(st_specs)):
                b = sharding.local_slice(b, s_, mesh, coords)
                assert a.shape == b.shape, (case, key)
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def _fake_local(tree, specs, mesh):
    return tree_map(lambda t, s: torch.empty(sharding.local_shape(t.shape, s, mesh),
                                             dtype=t.dtype), tree, specs)


def fake_train_bytes(cfg, mesh, batch, accum: int) -> dict:
    """What the dry run counts for one rank's split train step: `rank_step`
    over `ShapeCollectives` on fake shards and a fake batch share."""
    model = build_model(cfg, device="cpu")
    comm = ShapeCollectives(mesh)
    with fake_mode():
        params = model.init(torch.Generator())
        specs = sharding.param_shardings(params, cfg, mesh)
        local = _fake_local(params, specs, mesh)
        b, split = rank_batch({k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype)
                               for k, v in batch.items()}, cfg, mesh, comm.coords, accum)
        rank_step(model, TrainConfig(lr=LR, grad_accum=accum), local, specs,
                  adamw_init(local), b, split, comm)
    return comm.bytes


@pytest.mark.parametrize("case", TRAIN_CASES, ids=case_name)
def test_split_collective_bytes_equal_the_fake_steps(tp, case):
    """What a rank at the last `model` coordinate counted in its split
    train step, by kind, is what the dry run's fake step (that rank) counts
    for that config and mesh, and no rank counts more of any kind (the last
    computes the largest share of an uneven split; a rank's FSDP rows are
    gathered for its own columns only); a step with FSDP rows
    reduce-scatters them."""
    name, mesh_name, fsdp, accum = case
    cfg = config(name)
    mesh = MESHES[mesh_name]
    want = (forced_fsdp if fsdp else (lambda f: f()))(
        lambda: fake_train_bytes(cfg, mesh, tp["batches"][name][0], accum))
    assert want["all-reduce"] > 0 and want["all-to-all"] == 0
    if fsdp:
        assert want["reduce-scatter"] > 0
    for res in tp["ranks"]:
        got = res[case_name(case)]["bytes"]
        assert all(g[k] <= want[k] for g in got for k in want), case
        if res["coords"][mesh_name]["model"] == mesh.shape["model"] - 1:
            assert got == [want] * STEPS, case


@pytest.mark.parametrize("case", SERVE_CASES, ids=case_name)
def test_split_decode_bytes_equal_the_fake_step(tp, case):
    """A decode step's collectives, counted on every rank, are the fake
    step's: no all-to-all and nothing gathered along the sequence (q and the
    new K/V all-gathered over `model`, the logits over the vocabulary,
    whatever columns a rank lacks); prefill moves the K/V by one
    all-to-all."""
    name, mesh_name = case
    cfg, mesh = config(name), MESHES[mesh_name]
    model = build_model(cfg, device="cpu")
    prompt_ = tp["prompts"][name]
    b = prompt_["tokens"].shape[0]
    s = prompt_["tokens"].shape[1] + (cfg.num_patches if cfg.family == "vlm" else 0)
    comm = ShapeCollectives(mesh)
    with fake_mode():
        params = model.init(torch.Generator())
        specs = sharding.param_shardings(params, cfg, mesh)
        state = {"kv": {k: torch.empty((cfg.num_layers, b, s + NEW_TOKENS, cfg.num_kv_heads,
                                         cfg.resolved_head_dim)) for k in ("k", "v")}}
        st_specs = sharding.state_shardings(state, cfg, mesh, b)
        tok = torch.empty((b // mesh.shape["data"],), dtype=torch.int64)
        rank_decode(model, _fake_local(params, specs, mesh), specs,
                    _fake_local(state, st_specs, mesh), st_specs, tok, s, comm)
    assert comm.bytes["all-to-all"] == 0 and comm.bytes["all-gather"] > 0
    for res in tp["ranks"]:
        assert res[case_name(case)]["decode_bytes"] == [comm.bytes] * NEW_TOKENS, case
    # a rank sends what it holds for the others' slices (some hold none)
    assert sum(res[case_name(case)]["prefill_bytes"]["all-to-all"] for res in tp["ranks"]) > 0


def test_remat_gathers_the_rows_again_and_reduce_scatters_them_once():
    """With remat, a layer's recompute gathers its FSDP rows again, and the
    backward still reduce-scatters them once per use: one rank's step on a
    2 x 2 mesh with FSDP forced on, counted on fake tensors."""
    cfg = config("internlm2")
    batch = train_batches(cfg, 0)[0]
    counts = {}
    for remat in (False, True):
        def count():
            model = build_model(cfg, device="cpu", remat=remat)
            comm = ShapeCollectives(MESHES["2x2"])
            with fake_mode():
                params = model.init(torch.Generator())
                specs = sharding.param_shardings(params, cfg, MESHES["2x2"])
                local = _fake_local(params, specs, MESHES["2x2"])
                b, split = rank_batch({k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype)
                                       for k, v in batch.items()}, cfg, MESHES["2x2"],
                                      comm.coords, 1)
                rank_step(model, TrainConfig(), local, specs, adamw_init(local), b, split, comm)
            return dict(comm.bytes)
        counts[remat] = forced_fsdp(count)
    assert counts[True]["reduce-scatter"] == counts[False]["reduce-scatter"] > 0
    assert counts[True]["all-gather"] > counts[False]["all-gather"] > 0


@pytest.mark.parametrize("name", ["internlm2", "smollm-5:5", "qwen3-moe", "phi-3-vision"])
def test_a_rank_at_model_2_counts_at_most_0_6_of_the_flops(name):
    """Under `FlopCounterMode`, one rank's train step on a 1 x 2 mesh counts
    at most 0.6 of a world of one's FLOPs on the same batch: the work is
    split, not repeated."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(config(name), d_model=128, d_ff=256 if config(name).d_ff else 0)
    model = build_model(cfg, device="cpu")
    batch = train_batches(cfg, 0)[0]
    flops = {}
    for m in (1, 2):
        mesh = MeshShape(("data", "model"), (1, m))
        comm = ShapeCollectives(mesh)
        with fake_mode():
            params = model.init(torch.Generator())
            specs = sharding.param_shardings(params, cfg, mesh)
            local = _fake_local(params, specs, mesh)
            b = {k: torch.empty(v.shape, dtype=torch.from_numpy(v).dtype)
                 for k, v in batch.items()}
            with FlopCounterMode(display=False) as fc:
                rank_step(model, TrainConfig(), local, specs, adamw_init(local), b, True, comm)
        flops[m] = fc.get_total_flops()
    assert flops[2] <= 0.6 * flops[1], flops


# ---------------------------------------------------------------------------
# decode_attention's LSE and the cross-slice combine
# ---------------------------------------------------------------------------

def _decode_inputs(seed, b=2, s=96, hq=6, hkv=2, d=32):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal(sh).astype(np.float32)
               for sh in ((b, hq, d), (b, s, hkv, d), (b, s, hkv, d)))
    return torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)


def _lse64(q, k, valid):
    """float64 log-sum-exp of the masked scaled scores, [B,Hq]."""
    b, hq, d = q.shape
    hkv = k.shape[2]
    qg = q.double().reshape(b, hkv, hq // hkv, d)
    sc = torch.einsum("bhgd,bkhd->bhgk", qg, k.double()) * d ** -0.5
    sc = torch.where(valid, sc, torch.tensor(ref.NEG_INF, dtype=torch.float64))
    return torch.logsumexp(sc, dim=-1).reshape(b, hq)


@pytest.mark.parametrize("pattern", ["prefix", "holes", "none"])
def test_decode_attention_plain_lse(pattern):
    """With its LSE, `decode_attention_ref`'s output is the same bits as
    without, within 2e-5 of the Pallas kernel in interpret mode; the LSE is
    a float64 log-sum-exp of the masked scores within 1e-5, and NEG_INF (f32)
    for a cache with no valid key."""
    q, k, v = _decode_inputs(0)
    s = k.shape[1]
    valid = {"prefix": torch.arange(s) < 70,
             "holes": torch.from_numpy(np.random.default_rng(1).random(s) < 0.5),
             "none": torch.zeros(s, dtype=torch.bool)}[pattern]
    o, lse = ref.decode_attention_ref(q, k, v, valid, with_lse=True)
    assert torch.equal(o, ref.decode_attention_ref(q, k, v, valid))
    want = pallas_decode(jnp.asarray(q.numpy()), jnp.asarray(k.numpy()),
                         jnp.asarray(v.numpy()), jnp.asarray(valid.numpy()), interpret=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want), rtol=2e-5, atol=2e-5)
    assert lse.dtype == torch.float32 and lse.shape == q.shape[:2]
    if pattern == "none":
        assert torch.all(lse == ref.NEG_INF)
    else:
        np.testing.assert_allclose(lse.double().numpy(), _lse64(q, k, valid).numpy(),
                                   rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("cut,valid_to", [(48, 70), (48, 30), (32, 96)])
def test_two_slices_combine_to_the_whole_cache(cut, valid_to):
    """The plain version over two slices of a cache, combined by
    `tensor_parallel.combine`, equals it over the whole cache within 1e-6,
    also where one slice holds no valid key (its weight is exactly 0: the
    result does not move when that slice's V changes)."""
    q, k, v = _decode_inputs(2)
    s = k.shape[1]
    valid = torch.arange(s) < valid_to
    whole = ref.decode_attention_ref(q, k, v, valid)
    parts = [ref.decode_attention_ref(q, k[:, a:b].contiguous(), v[:, a:b].contiguous(),
                                      valid[a:b], with_lse=True) for a, b in ((0, cut), (cut, s))]

    def merged(ps):
        return combine(torch.stack([p[0] for p in ps]), torch.stack([p[1] for p in ps]),
                       lambda t: t.amax(0), lambda t: t.sum(0))
    got = merged(parts)
    assert torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), whole.numpy(), rtol=1e-6, atol=1e-6)
    if valid_to <= cut:     # the second slice is empty: its average must not leak in
        v2 = v[:, cut:] * 3.0 + 1.0
        moved = merged([parts[0], ref.decode_attention_ref(q, k[:, cut:].contiguous(),
                                                           v2.contiguous(), valid[cut:],
                                                           with_lse=True)])
        assert torch.equal(moved, got)


class _Recorded(ShapeCollectives):
    """`ShapeCollectives` that records which axes reached the transport."""

    def __init__(self, mesh):
        super().__init__(mesh)
        self.sent = []

    def _gather(self, out, src, axes):
        self.sent.append(("all-gather", axes))

    def _reduce(self, t, axes, op):
        self.sent.append(("all-reduce", axes))

    def _reduce_scatter(self, out, src, axes):
        self.sent.append(("reduce-scatter", axes))

    def _all_to_all(self, out, src, out_sizes, in_sizes, axes):
        self.sent.append(("all-to-all", axes))


@pytest.mark.parametrize("sizes", [(1, 1), (1, 2)])
def test_a_collective_over_one_rank_moves_and_copies_nothing(sizes):
    """Over a group of one rank each collective hands its operand back
    (no transport, no copy) and still counts its bytes; over two ranks it
    reaches the transport."""
    comm = _Recorded(MeshShape(("data", "model"), sizes))
    t = torch.arange(24, dtype=torch.float32).reshape(4, 6)
    out = {"all-gather": comm.all_gather(t, 1, "data"),
           "all-reduce": comm.all_reduced(t, ("data",)),
           "reduce-scatter": comm.reduce_scatter(t, 0, "data"),
           "all-to-all": comm.all_to_all([t], [(6, 4)], "data")[0]}
    assert all(o.data_ptr() == t.data_ptr() for o in out.values())
    assert torch.equal(out["all-to-all"], t.reshape(6, 4))
    assert comm.all_reduce(t, "data") is t
    assert comm.sent == []
    assert comm.bytes == {"all-gather": 96, "all-reduce": 192, "reduce-scatter": 96,
                          "all-to-all": 96, "collective-permute": 0}
    got = comm.all_reduced(t, "model")
    assert (got is t) == (sizes[1] == 1)
    assert comm.sent == ([] if sizes[1] == 1 else [("all-reduce", ("model",))])
    assert comm.bytes["all-reduce"] == 288

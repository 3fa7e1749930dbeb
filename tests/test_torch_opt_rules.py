"""The reference's `opt` variants on the mesh (`launch.specs.cell_rules`,
`distributed.tensor_parallel.Split`'s sequence parallelism, opt-zmlp and
opt-rowssm, `models.attention.attend_blocked`), in four gloo processes on
the CPU (`torch_opt_ranks`), held to the unsharded port and to the JAX
package; a world of one, in this process, held to the unsharded port bit
for bit; blocked attention against the reference's; and the dry run's
mamba2-780m decode cells under opt (ROADMAP C.4).

Tolerances: train steps within the band of `test_torch_distributed.py`
(loss and gradient norm 1e-4 relative, parameters 2 lr); serving's greedy
tokens exactly, its logits within 1e-4; blocked attention within 2e-5 (the
reference's fp32 band); a world of one bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import attention as jax_attention  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.serve_step import rank_decode, rank_prefill  # noqa: E402
from repro_torch.distributed.train_step import rank_batch, rank_step  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.specs import ShapeCollectives, cell_rules  # noqa: E402
from repro_torch.models import attention  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import TrainConfig, adamw_init, make_train_step  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402
from torch_opt_ranks import (CONFIGS, DRYRUN_CELLS, LR, MESHES, NEW_TOKENS,  # noqa: E402
                             SERVE_CASES, STEPS, TRAIN_CASES, case_name, config, fake_train_bytes,
                             max_len, opt_ranks, prompt, train_batches)
from torch_ranks import WORLD, spawn  # noqa: E402

# the cases the parent also holds to the JAX package's train step
JAX_CASES = [c for c in TRAIN_CASES if c[0] in ("dense", "ssm", "hybrid", "encdec")
             and c[2] == 16 and c[1] == "opt"]


def jax_config(name: str):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(jax_get_arch(arch).reduced(), dtype="float32", **kw)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_steps(params_np, name: str, s: int):
    """The reference's train step, jitted once, on the whole batches."""
    jp = jax.tree.map(jnp.asarray, params_np[name])
    jstep = jax.jit(jax_make_train_step(jax_build_model(jax_config(name)),
                                        JaxTrainConfig(lr=LR)))
    jo = jax_adamw_init(jp)
    run = {"loss": [], "grad_norm": []}
    for b in train_batches(name, s):
        jp, jo, met = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        run["loss"].append(float(met["loss"]))
        run["grad_norm"].append(float(met["grad_norm"]))
    run["params"] = params_from_jax(config(name), jax.tree.map(np.asarray, jp), device="cpu")
    return run


def _fake_serve_bytes(case) -> dict:
    """What the dry run counts for the last `model` rank's prefill and
    decode step of SERVE_CASES' `case`, under its variant's placements."""
    from torch_opt_ranks import _fake
    from torch_tp_family_ranks import fake_local
    name, mesh_name, variant, rows, tokens = case
    cfg, mesh = config(name), MESHES[mesh_name]
    model = build_model(cfg, device="cpu")
    comm = ShapeCollectives(mesh)
    from repro_torch.launch.specs import fake_mode
    with fake_mode():
        params = model.init(torch.Generator())
        local = {}
        for kind in ("prefill", "decode"):
            specs = sharding.param_shardings(params, cfg, mesh,
                                             cell_rules(cfg, kind, variant, mesh)[1])
            local[kind] = (fake_local(params, specs, mesh), specs)
        batch = _fake(prompt(case))
        mine = fake_local(batch, sharding.batch_shardings(batch, cfg, mesh), mesh)
        _, state, pos, st_specs = rank_prefill(model, *local["prefill"], mine,
                                               max_len(cfg, tokens), comm, rows, variant)
        out = {"prefill": dict(comm.bytes), "specs": st_specs}
        comm.reset()
        rank_decode(model, *local["decode"], state, st_specs, mine["tokens"][:, 0].long(),
                    pos, comm, variant)
    return {**out, "decode": dict(comm.bytes)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The four ranks' results and, made while they run, the JAX package's
    steps, the fake serve counts and the baseline's fake train counts."""
    out = tmp_path_factory.mktemp("opt_ranks")
    params_np = {name: tree_map(lambda t: t.numpy(), build_model(config(name), device="cpu")
                                .init(torch.Generator().manual_seed(i)))
                 for i, name in enumerate(CONFIGS)}
    torch.save(params_np, out / "params.pt")

    def references():
        return ({case: _jax_steps(params_np, case[0], case[2]) for case in JAX_CASES},
                {case: _fake_serve_bytes(case) for case in SERVE_CASES},
                {name: fake_train_bytes((name, "baseline", 16, False))
                 for name in ("dense", "ssm", "hybrid", "encdec", "moe", "vlm")})
    mp = pytest.MonkeyPatch()
    mp.setenv("GLOO_SOCKET_IFNAME", "lo")
    try:
        jax_refs, fake_serve, fake_base = spawn(opt_ranks, WORLD, (str(out),), timeout=300.0,
                                                meanwhile=references)
    finally:
        mp.undo()
    ranks = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    return {"params_np": params_np, "ranks": ranks, "fake_serve": fake_serve,
            "fake_base": fake_base,
            "fake": {k: v for res in ranks for k, v in res["fake"].items()},
            "refs": {case: [run] + ([jax_refs[case]] if case in jax_refs else [])
                     for res in ranks for case, run in res["unsharded"].items()}}


@pytest.mark.parametrize("case", TRAIN_CASES, ids=case_name)
def test_opt_train_step_matches_the_unsharded_and_the_reference(runs, case):
    """STEPS steps on uneven loss masks: every rank's loss and gradient norm
    are the global ones, and they and the gathered parameters match the
    port's `make_train_step` on the whole batch (and, for opt at 16
    tokens, the reference's)."""
    got = [res[case_name(case)] for res in runs["ranks"]]
    for run in got[1:]:
        assert run["loss"] == got[0]["loss"] and run["grad_norm"] == got[0]["grad_norm"]
    for want in runs["refs"][case]:
        for key in ("loss", "grad_norm"):
            for g, w in zip(got[0][key], want[key]):
                assert g == pytest.approx(w, rel=1e-4), (case, key)
        for a, b in zip(tree_leaves(got[0]["params"]), tree_leaves(want["params"])):
            assert (a - b).abs().max().item() <= 2 * LR, case


@pytest.mark.parametrize("case", TRAIN_CASES, ids=case_name)
def test_opt_collective_bytes_equal_the_fake_steps(runs, case):
    """The last `model` rank counts in each step what the dry run's fake
    step counts.  Where the stream is cut over `model` (16 tokens, not
    moe) reduce-scatters and all-gathers take the place of all-reduces:
    under opt the all-reduces fall below the baseline's fake step (under
    opt-zmlp the MLP weights' gradients, whole over `model`, are summed
    over it instead); the moe family and a stream `model` does not divide
    keep the baseline's form."""
    want = runs["fake"][case]
    for res in runs["ranks"]:
        if res["coords"]["2x2"]["model"] == 1:
            assert res[case_name(case)]["bytes"] == [want] * STEPS, case
    name, variant, s, fsdp = case
    if name == "moe":
        assert want == runs["fake_base"]["moe"]
    elif s == 16 and not fsdp:
        base = runs["fake_base"][name]
        if variant == "opt":
            assert want["all-reduce"] < base["all-reduce"], (want, base)
        assert want["reduce-scatter"] > base["reduce-scatter"]
        assert want["all-gather"] > base["all-gather"]
    elif s == 15:
        assert want["reduce-scatter"] == 0


@pytest.mark.parametrize("case", SERVE_CASES, ids=case_name)
def test_opt_serving_gives_the_unsharded_tokens(runs, case):
    """Sharded prefill under the variant's prefill placements and NEW_TOKENS
    greedy steps under its decode placements (opt-rowssm for a pure SSM):
    each rank's tokens are the unsharded port's for its rows and its logits
    within 1e-4; a rank at the last `model` coordinate counts what the
    fake steps count."""
    name, mesh_name, variant, rows, tokens = case
    cfg, mesh = config(name), MESHES[mesh_name]
    model = build_model(cfg, device="cpu")
    params = params_from_jax(cfg, runs["params_np"][name], device="cpu")
    logits, state, pos = model.prefill(params, {k: torch.from_numpy(v) for k, v in
                                                prompt(case).items()}, max_len=max_len(cfg, tokens))
    want = {"logits": [logits], "tokens": []}
    for _ in range(NEW_TOKENS):
        tok = logits.argmax(-1)
        want["tokens"].append(tok)
        logits, state = model.decode_step(params, state, tok, pos)
        want["logits"].append(logits)
        pos += 1
    row_spec = sharding.batch_shardings(want["tokens"][0], cfg, mesh)
    fake = runs["fake_serve"][case]
    for res in runs["ranks"]:
        got, coords = res[case_name(case)], res["coords"][mesh_name]

        def mine(t):
            return sharding.local_slice(t, row_spec + (None,) * (t.dim() - 1), mesh, coords)
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, mine(b)), case
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(a.numpy(), mine(b).numpy(), rtol=1e-4, atol=1e-4)
        assert got["specs"] == fake["specs"]
        assert got["decode_bytes"] == [fake["decode"]] * NEW_TOKENS, case
        if coords["model"] == mesh.shape["model"] - 1:
            assert got["prefill_bytes"] == fake["prefill"], case


@pytest.mark.parametrize("case", SERVE_CASES[:2], ids=case_name)
def test_opt_rowssm_decode_gathers_no_weight(runs, case):
    """opt-rowssm places `w_in`'s d_model rows, `w_out`'s d_inner rows and
    the tied embedding's d_model columns over `model`, and a decode step
    all-gathers only activations: the rank's embedding columns [B,1,d/n]
    and, where the rank decodes its own SSM heads, their new x channels
    [B,d_inner/n] a layer, in f32."""
    name, mesh_name = case[:2]
    cfg, mesh = config(name), MESHES[mesh_name]
    n, rows = mesh.shape["model"], case[3] // mesh.shape["data"]
    got = runs["ranks"][0][case_name(case)]
    specs = got["decode_param_specs"]
    assert specs["embed"] == (None, "model")
    assert specs["layers"]["ssm"]["w_in"] == (None, "model", None)
    assert specs["layers"]["ssm"]["w_out"] == (None, "model", None)
    heads_split = got["specs"]["ssd"][2] == "model"
    assert heads_split == (cfg.ssm_nheads % n == 0)
    inner = cfg.num_layers * cfg.d_inner // n if heads_split else 0
    want = 4 * rows * (cfg.d_model // n + inner)
    assert got["decode_bytes"][0]["all-gather"] == want
    assert got["decode_bytes"][0]["reduce-scatter"] == 0


@pytest.mark.parametrize("variant", ["opt", "opt-zmlp"])
def test_a_world_of_one_under_opt_is_the_unsharded_model_bit_for_bit(variant):
    """On a 1 x 1 mesh, in this process, reduced mamba2 (no attention, so no
    blocked route): two split train steps under `variant` give the
    unsharded `make_train_step`'s losses, norms, parameters and moments,
    and prefill then NEW_TOKENS greedy decode steps under its placements
    (opt-rowssm in decode) its logits and state, bit for bit."""
    cfg = config("ssm")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mesh = MeshShape(("data", "model"), (1, 1))
    comm = ShapeCollectives(mesh)

    def specs(kind):
        return sharding.param_shardings(params, cfg, mesh, cell_rules(cfg, kind, variant,
                                                                      mesh)[1])
    tcfg = TrainConfig(lr=LR)
    pa, oa = tree_map(torch.clone, params), adamw_init(params)
    pb, ob = tree_map(torch.clone, params), adamw_init(params)
    for batch in train_batches("ssm", 16):
        batch = {k: torch.from_numpy(v) for k, v in batch.items()}
        pa, oa, ma = make_train_step(model, tcfg)(pa, oa, batch)
        mine, split = rank_batch(batch, cfg, mesh, comm.coords, 1)
        pb, ob, mb = rank_step(model, tcfg, pb, specs("train"), ob, mine, split, comm,
                               variant=variant,
                               m_specs=sharding.param_shardings(params, cfg, mesh))
        assert torch.equal(ma["loss"], mb["loss"])
        assert torch.equal(ma["grad_norm"], mb["grad_norm"])
    for a, b in zip(tree_leaves({"p": pa, "m": oa.m, "v": oa.v}),
                    tree_leaves({"p": pb, "m": ob.m, "v": ob.v})):
        assert torch.equal(a, b)
    batch = {"tokens": batch["tokens"][:2, :12]}
    la, sa, qa = model.prefill(params, batch, max_len=24)
    lb, sb, qb, st_specs = rank_prefill(model, params, specs("prefill"), batch, 24, comm, 2,
                                        variant)
    for i in range(NEW_TOKENS + 1):
        assert torch.equal(la, lb)
        for a, b in zip(tree_leaves(sa), tree_leaves(sb)):
            assert torch.equal(a, b)
        if i == NEW_TOKENS:
            break
        tok = la.argmax(-1)
        la, sa = model.decode_step(params, sa, tok, qa)
        lb, sb = rank_decode(model, params, specs("decode"), sb, st_specs, tok, qb, comm,
                             variant)
        qa, qb = qa + 1, qb + 1


# (causal, window, meta tokens, ALiBi) over 40 queries and keys; the
# reference's blocks 16 x 24 (three query blocks, two key blocks, both last
# ones short), the port's key blocks 24
BLOCKED_CASES = {"causal": (True, 0, 0, False), "window_meta": (True, 12, 3, False),
                 "alibi": (True, 0, 0, True), "full": (False, 0, 0, False)}


@pytest.mark.parametrize("case", list(BLOCKED_CASES))
def test_attend_blocked_matches_the_reference(case):
    """`attend_blocked` against the reference's `attend_blocked` at the same
    block sizes, GQA 6:2, f32, within 2e-5; and against the plain `attend`
    with the same mask and bias."""
    causal, window, meta, use_alibi = BLOCKED_CASES[case]
    rng = np.random.default_rng(3)
    q, k, v = (rng.standard_normal((2, 40, h, 16)).astype(np.float32) for h in (6, 2, 2))
    pos = np.arange(40, dtype=np.int32)
    slopes = np.linspace(0.1, 0.6, 6).astype(np.float32) if use_alibi else None
    kw = dict(causal=causal, window=window, num_meta=meta, block_k=24)
    want = np.asarray(jax_attention.attend_blocked(
        *(jnp.asarray(t) for t in (q, k, v, pos, pos)),
        alibi=None if slopes is None else jnp.asarray(slopes), block_q=16, **kw))
    tq, tk, tv, tpos = (torch.from_numpy(t) for t in (q, k, v, pos))
    alibi = None if slopes is None else torch.from_numpy(slopes)
    got = attention.attend_blocked(tq, tk, tv, tpos, tpos, alibi=alibi, **kw)
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-5, atol=2e-5)
    mask = attention.build_mask(tpos, tpos, causal=causal, window=window, num_meta=meta)
    bias = None if alibi is None else attention.alibi_bias(alibi, tpos, tpos)
    plain = attention.attend(tq, tk, tv, mask=mask, bias=bias)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("cell", DRYRUN_CELLS,
                         ids=lambda c: f"{c[0]}-{'2x16x16' if c[1] else '16x16'}")
def test_the_mamba2_decode_cells_run_under_opt(runs, cell):
    """ROADMAP C.4: the dry run's mamba2-780m decode cells under opt (its
    decode takes opt-rowssm, the embedding's d_model columns over `model`;
    one cell a rank) are ok, move no reduce-scatter, and hold under 0.15
    GB of arguments a device (0.145 GB at 16 x 16: the reference's,
    `test_torch_specs.py`), a tenth of the baseline's."""
    res = next(r["dryrun"][cell] for r in runs["ranks"] if cell in r["dryrun"])
    assert res["status"] == "ok", res
    assert res["collective_breakdown"]["reduce-scatter"] == 0
    assert res["per_device"]["argument_bytes"] < 0.15e9

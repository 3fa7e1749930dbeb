"""Split compute on a mesh for the ssm, hybrid and encdec families
(`repro_torch.distributed.tensor_parallel`, `serve_step` and
`train_step.rank_step`), in four gloo processes on the CPU, held to the
unsharded port and to the JAX package; and a world of one, in this
process, held to the unsharded port bit for bit.

Meshes: 2 x 2 (data, model), FSDP off and forced on; 1 x 4 (model) with 6
SSM heads (1 or 2 a rank) and 6:2 attention heads.  Reduced fp32
mamba2-780m, hymba-1.5b and seamless-m4t-large-v2
(`torch_tp_family_ranks.CONFIGS`).  The decode states take every
placement the rules give them: caches over `model`, whole, or over `data`
(batch 1, long_500k's), SSD heads over `model` or whole.

Tolerances: train steps within the band of `test_torch_distributed.py`
(loss and gradient norm 1e-4 relative, parameters 2 lr); serving's greedy
tokens exactly, its logits and decode state within 1e-4; a world of one
bit for bit.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_arch as jax_get_arch  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro.training import adamw_init as jax_adamw_init  # noqa: E402
from repro.training import make_train_step as jax_make_train_step  # noqa: E402
from repro.training.train import TrainConfig as JaxTrainConfig  # noqa: E402
from repro_torch.bridge import params_from_jax  # noqa: E402
from repro_torch.configs import get_arch  # noqa: E402
from repro_torch.distributed import sharding  # noqa: E402
from repro_torch.distributed.serve_step import rank_decode, rank_prefill  # noqa: E402
from repro_torch.distributed.train_step import rank_batch, rank_step  # noqa: E402
from repro_torch.launch.mesh import MeshShape  # noqa: E402
from repro_torch.launch.specs import ShapeCollectives  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.training import TrainConfig, adamw_init, make_train_step  # noqa: E402
from repro_torch.training.optimizer import tree_leaves, tree_map  # noqa: E402
from torch_ranks import WORLD, spawn  # noqa: E402
from torch_tp_family_ranks import (CONFIGS, JAX_CASES, LR, MESHES, NEW_TOKENS,  # noqa: E402
                                   SERVE_CASES, STEPS, TRAIN_CASES, case_name, config,
                                   fake_serve_bytes, family_ranks, max_len, prompt,
                                   train_batches)


def jax_config(name: str):
    arch, kw = CONFIGS[name]
    return dataclasses.replace(jax_get_arch(arch).reduced(), dtype="float32", **kw)


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread for this module's tiny models: several contend
    with the ranks and with each other."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fam(tmp_path_factory):
    """The four ranks' results (`torch_tp_family_ranks.family_ranks`: the
    split runs, and the port's unsharded steps and the dry run's counts of
    the train cases, a share each) and, made while they run, the JAX
    package's steps and the dry run's counts of the serve cases.
    Every config's weights are the port's init from a seed, handed to the
    ranks and, as numpy arrays in the reference's layout, to the JAX
    package's step."""
    out = tmp_path_factory.mktemp("tp_family_ranks")
    params_np = {name: tree_map(lambda t: t.numpy(), build_model(config(name), device="cpu")
                                .init(torch.Generator().manual_seed(i)))
                 for i, name in enumerate(CONFIGS)}
    fam = {"params_np": params_np}
    torch.save(params_np, out / "params.pt")     # read by the ranks: small spawn arguments

    def references():
        return ({case: _jax_steps(fam, case[0], case[3]) for case in JAX_CASES},
                {case: fake_serve_bytes(case) for case in SERVE_CASES})
    mp = pytest.MonkeyPatch()
    mp.setenv("GLOO_SOCKET_IFNAME", "lo")
    try:
        jax_refs, fam["fake_serve"] = spawn(family_ranks, WORLD, (str(out),), timeout=300.0,
                                            meanwhile=references)
    finally:
        mp.undo()
    fam["ranks"] = [torch.load(out / f"rank{r}.pt", weights_only=False) for r in range(WORLD)]
    fam["fake_train"] = {k: v for res in fam["ranks"] for k, v in res["fake"].items()}
    fam["refs"] = {case: [run] + ([jax_refs[case]] if case in jax_refs else [])
                   for res in fam["ranks"] for case, run in res["unsharded"].items()}
    return fam


def _jax_steps(fam, name: str, accum: int):
    """The reference's train step, jitted once, on the whole batches, from
    the same weights."""
    jp = jax.tree.map(jnp.asarray, fam["params_np"][name])
    jstep = jax.jit(jax_make_train_step(jax_build_model(jax_config(name)),
                                        JaxTrainConfig(lr=LR, grad_accum=accum)))
    jo = jax_adamw_init(jp)
    run = {"loss": [], "grad_norm": []}
    for b in train_batches(name):
        jp, jo, met = jstep(jp, jo, {k: jnp.asarray(v) for k, v in b.items()})
        run["loss"].append(float(met["loss"]))
        run["grad_norm"].append(float(met["grad_norm"]))
    run["params"] = params_from_jax(config(name), jax.tree.map(np.asarray, jp), device="cpu")
    return run


@pytest.mark.parametrize("case", TRAIN_CASES, ids=case_name)
def test_split_train_step_matches_the_unsharded_and_the_reference(fam, case):
    """STEPS steps on uneven loss masks: every rank's loss and gradient norm
    are the global ones, and they and the gathered parameters match the
    port's `make_train_step` on the whole batch (and, in JAX_CASES, the
    reference's)."""
    runs = [res[case_name(case)] for res in fam["ranks"]]
    for run in runs[1:]:
        assert run["loss"] == runs[0]["loss"] and run["grad_norm"] == runs[0]["grad_norm"]
    for want in fam["refs"][case]:
        for key in ("loss", "grad_norm"):
            for got, w in zip(runs[0][key], want[key]):
                assert got == pytest.approx(w, rel=1e-4), (case, key)
        for a, b in zip(tree_leaves(runs[0]["params"]), tree_leaves(want["params"])):
            assert (a - b).abs().max().item() <= 2 * LR, case


def _greedy(cfg, params, batch, slots: int):
    """The unsharded port: prefill, then NEW_TOKENS greedy steps."""
    model = build_model(cfg, device="cpu")
    logits, state, pos = model.prefill(params, batch, max_len=slots)
    out = {"logits": [logits], "tokens": [], "state0": tree_map(torch.clone, state)}
    for _ in range(NEW_TOKENS):
        tok = logits.argmax(-1)
        out["tokens"].append(tok)
        logits, state = model.decode_step(params, state, tok, pos)
        out["logits"].append(logits)
        pos += 1
    out["state"] = state
    return out


@pytest.mark.parametrize("case", SERVE_CASES, ids=case_name)
def test_split_prefill_and_decode_match_the_unsharded(fam, case):
    """Sharded prefill plus NEW_TOKENS greedy steps: the state's placement is
    the rules' (`state_shardings`), and each rank's tokens are the
    unsharded port's for its rows, its logits within 1e-4, and its decode
    state (after prefill and at the end) its slice of the unsharded
    state."""
    name, mesh_name, rows, _ = case
    cfg, mesh = config(name), MESHES[mesh_name]
    batch = {k: torch.from_numpy(v) for k, v in prompt(case).items()}
    want = _greedy(cfg, params_from_jax(cfg, fam["params_np"][name], device="cpu"), batch,
                   max_len(cfg, case[3]))
    st_specs = sharding.state_shardings(want["state"], cfg, mesh, rows)
    row_spec = sharding.batch_shardings(want["tokens"][0], cfg, mesh)
    for res in fam["ranks"]:
        got, coords = res[case_name(case)], res["coords"][mesh_name]
        assert got["specs"] == st_specs, case

        def mine(t):
            return sharding.local_slice(t, row_spec + (None,) * (t.dim() - 1), mesh, coords)
        for a, b in zip(got["tokens"], want["tokens"]):
            assert torch.equal(a, mine(b)), case
        for a, b in zip(got["logits"], want["logits"]):
            np.testing.assert_allclose(a.numpy(), mine(b).numpy(), rtol=1e-4, atol=1e-4)
        for key in ("state0", "state"):
            for a, b, s_ in zip(tree_leaves(got[key]), tree_leaves(want[key]),
                                tree_leaves(st_specs)):
                b = sharding.local_slice(b, s_, mesh, coords)
                assert a.shape == b.shape, (case, key)
                np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-4, atol=1e-4)


def test_the_serve_cases_take_every_placement(fam):
    """Between them the serve cases place a cache's sequence over `model`,
    over `data` and nowhere, and the SSD heads over `model` and whole."""
    seen = set()
    for case in SERVE_CASES:
        for key, s in fam["ranks"][0][case_name(case)]["specs"].items():
            s = next(iter(s.values())) if isinstance(s, dict) else s
            if key.startswith(("kv", "cross")):
                seen.add(("seq", s[2]))
            elif key == "ssd":
                seen.add(("ssd", s[2]))
    assert seen == {("seq", "model"), ("seq", "data"), ("seq", None), ("ssd", "model"),
                    ("ssd", None)}


@pytest.mark.parametrize("case", TRAIN_CASES, ids=case_name)
def test_split_collective_bytes_equal_the_fake_steps(fam, case):
    """What a rank at the last `model` coordinate counted in its split
    train step, by kind, is what the dry run's fake step (that rank,
    `fake_train_bytes`) counts for that config and mesh, and no rank counts
    more of any kind; a step with FSDP rows reduce-scatters them."""
    want = fam["fake_train"][case]
    mesh_name, fsdp = case[1], case[2]
    mesh = MESHES[mesh_name]
    assert want["all-reduce"] > 0 and want["all-to-all"] == 0
    if fsdp:
        assert want["reduce-scatter"] > 0
    for res in fam["ranks"]:
        got = res[case_name(case)]["bytes"]
        assert all(g[k] <= want[k] for g in got for k in want), case
        if res["coords"][mesh_name]["model"] == mesh.shape["model"] - 1:
            assert got == [want] * STEPS, case


@pytest.mark.parametrize("case", SERVE_CASES, ids=case_name)
def test_split_serve_bytes_equal_the_fake_steps(fam, case):
    """A rank at the last `model` coordinate counts in prefill and in each
    decode step what the dry run's fake steps count (`fake_serve_bytes`:
    `rank_prefill`, `rank_decode` over `ShapeCollectives`), the fake state
    is placed as the real one, and decode moves no all-to-all."""
    want = fam["fake_serve"][case]
    mesh_name = case[1]
    mesh = MESHES[mesh_name]
    assert want["decode"]["all-to-all"] == 0 and want["decode"]["all-gather"] > 0
    for res in fam["ranks"]:
        got = res[case_name(case)]
        assert got["specs"] == want["specs"], case
        assert got["decode_bytes"] == [want["decode"]] * NEW_TOKENS, case
        if res["coords"][mesh_name]["model"] == mesh.shape["model"] - 1:
            assert got["prefill_bytes"] == want["prefill"], case


@pytest.mark.parametrize("name", ["mamba2", "hymba", "seamless"])
def test_a_rank_at_model_2_counts_at_most_0_6_of_the_flops(name):
    """Under `FlopCounterMode`, one rank's train step on a 1 x 2 mesh (the
    last rank of `model`, its collectives counted and not carried out)
    counts at most 0.6 of a world of one's FLOPs on the same batch, at
    d_model 128: the work is split, not repeated."""
    from torch.utils.flop_counter import FlopCounterMode
    cfg = dataclasses.replace(config(name), d_model=128, d_ff=256 if config(name).d_ff else 0)
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    batch = {"tokens": torch.zeros(4, 16, dtype=torch.int32),
             "targets": torch.zeros(4, 16, dtype=torch.int32), "loss_mask": torch.ones(4, 16)}
    if cfg.family == "encdec":
        batch["src_embeds"] = torch.zeros(4, 10, cfg.d_model)
    flops = {}
    for m in (1, 2):
        mesh = MeshShape(("data", "model"), (1, m))
        comm = ShapeCollectives(mesh)
        specs = sharding.param_shardings(params, cfg, mesh)
        local = tree_map(lambda t, s: sharding.local_slice(t, s, mesh, comm.coords).clone(),
                         params, specs)
        with FlopCounterMode(display=False) as fc:
            rank_step(model, TrainConfig(), local, specs, adamw_init(local), batch, True, comm)
        flops[m] = fc.get_total_flops()
    assert flops[2] <= 0.6 * flops[1], flops


@pytest.mark.parametrize("arch", ["mamba2-780m", "hymba-1.5b", "seamless-m4t-large-v2"])
def test_a_world_of_one_is_the_unsharded_model_bit_for_bit(arch):
    """On a 1 x 1 mesh, in this process (every collective over a group of
    one is the identity), two split train steps (`rank_step`) give the
    unsharded `make_train_step`'s losses, norms and parameters, and split
    prefill and NEW_TOKENS greedy decode steps its logits and state, bit
    for bit."""
    cfg = dataclasses.replace(get_arch(arch).reduced(), dtype="float32")
    model = build_model(cfg, device="cpu")
    params = model.init(torch.Generator().manual_seed(0))
    mesh = MeshShape(("data", "model"), (1, 1))
    comm = ShapeCollectives(mesh)
    specs = sharding.param_shardings(params, cfg, mesh)
    tcfg = TrainConfig(lr=LR)
    step = make_train_step(model, tcfg)
    pa, oa = tree_map(torch.clone, params), adamw_init(params)
    pb, ob = tree_map(torch.clone, params), adamw_init(params)
    rng = np.random.default_rng(1)
    for _ in range(STEPS):
        batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
                 "targets": torch.from_numpy(rng.integers(0, cfg.vocab_size, (4, 16))),
                 "loss_mask": torch.from_numpy((rng.random((4, 16)) < 0.7)
                                               .astype(np.float32))}
        if cfg.family == "encdec":
            batch["src_embeds"] = torch.from_numpy(rng.standard_normal((4, 10, cfg.d_model))
                                                   .astype(np.float32))
        pa, oa, ma = step(pa, oa, batch)
        mine, split = rank_batch(batch, cfg, mesh, comm.coords, 1)
        pb, ob, mb = rank_step(model, tcfg, pb, specs, ob, mine, split, comm)
        assert torch.equal(ma["loss"], mb["loss"]) and torch.equal(ma["grad_norm"],
                                                                   mb["grad_norm"])
    for a, b in zip(tree_leaves({"p": pa, "m": oa.m, "v": oa.v}),
                    tree_leaves({"p": pb, "m": ob.m, "v": ob.v})):
        assert torch.equal(a, b)
    batch = {k: v[:2, :12] if k == "tokens" else v[:2] for k, v in batch.items()
             if k in ("tokens", "src_embeds")}
    slots = max_len(cfg, 12)
    la, sa, qa = model.prefill(params, batch, max_len=slots)
    lb, sb, qb, st_specs = rank_prefill(model, params, specs, batch, slots, comm, 2)
    assert qa == qb
    for i in range(NEW_TOKENS + 1):
        assert torch.equal(la, lb)
        for a, b in zip(tree_leaves(sa), tree_leaves(sb)):
            assert torch.equal(a, b)
        if i == NEW_TOKENS:
            break
        tok = la.argmax(-1)
        la, sa = model.decode_step(params, sa, tok, qa)
        lb, sb = rank_decode(model, params, specs, sb, st_specs, tok, qb, comm)
        qa, qb = qa + 1, qb + 1

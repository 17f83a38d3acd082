"""Training under the GPipe schedule and expert parallelism (ROADMAP A8b's
training half) on the CPU, 8 gloo ranks.

One launch (``python -m torch.distributed.run --standalone
--nproc-per-node 8``, each rank pinned to one torch thread, rank 0 writing
one JSON file) runs, with f32 activations and batch 8 x 32:

- 3 AdamW steps of reduced Qwen (4 layers) under ``pp2_fsdp`` on a
  ``(pipe 2, data 4, model 1)`` mesh and ``pp2_fsdp_tp`` on ``(2, 2, 2)``
  (with ``grad_accum=2``: each chunk pipelined),
  and of reduced DeepSeekMoE (4 layers: 2 dense, 2 MoE of 4 experts, top 2)
  under ``pp2_fsdp_tp_ep`` on ``(2, 2, 2)``, ``fsdp_tp_ep`` on ``(data 2,
  model 4)`` (EP degree 4) and ``hsdp_tp_ep`` on the same mesh (one pod:
  FSDP and the experts' storage over ``data``, as in ``fsdp_tp_ep``): ``ce`` and ``router_lb`` within ``LOSS_TOL`` of the
  port's one-device curve (``router_lb`` too, after ROADMAP C8) and ``ce``
  of JAX's one-device ``make_train_step`` on the same numpy params, final
  params within ``PARAM_TOL`` of the one-device run's (A8a's bounds,
  ``tests/test_torch_mesh_train.py``);
- one step's gradients of reduced DeepSeekMoE at its initial params under
  ``fsdp_tp_ep`` on ``(2, 4)`` (EP degree 4) and ``pp2_fsdp_tp_ep`` on
  ``(2, 2, 2)`` (EP degree 2), every leaf within ``GRAD_TOL`` of the
  one-device gradient: the batch is dropless (T·k 512 <= 4096), so EP's
  gradients are the dropless ones exactly, up to the order of f32 sums (the
  curves cannot show a uniform scale of the expert gradients: AdamW's
  first update is ``lr · sign(g)`` and the clip rescales every leaf);
- a checkpoint saved under ``pp2_fsdp`` restored under ``fsdp`` on ``(8,
  1)``, saved again and restored under ``pp2_fsdp``, every leaf ``==`` the
  first saved state, the stacked leaves staged over ``pipe`` again.

- ``examples/configs/train_pp.yaml`` through the CLI's ``main`` in the
  same processes (its directories moved into the test's): 20 steps, one
  ``done:`` line over the 8 ranks, JAX's ``pipeline`` record, and the
  losses of the port's one-device run of the document.
"""
import functools
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.config.resolver import load_yaml
from repro_torch.run import api
from repro_torch.run.overrides import apply_overrides, parse_overrides

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
TRAIN_PP = os.path.join(os.path.dirname(__file__), "..", "examples",
                        "configs", "train_pp.yaml")
#: A8a's bounds (``tests/test_torch_mesh_train.py``): losses relative (f32,
#: a plan changes only the order of f32 sums), final params absolute (AdamW
#: normalises each update, so an element whose gradient is near 0 takes
#: its sign from rounding)
LOSS_TOL = 1e-5
PARAM_TOL = 1e-3
#: (arch, plan, (dp, tp, pp)); ``pp2_fsdp_tp`` runs with ``grad_accum`` 2:
#: two equal chunks' mean ``ce`` and mean gradient are the batch's, so its
#: curve is held to the same curves
#: EP plans whose gradients are held leaf by leaf: EP degree 4 and 2
EP_GRADS = [("fsdp_tp_ep", (2, 4, 1)), ("pp2_fsdp_tp_ep", (2, 2, 2))]
#: each leaf's gradient against the one-device one, relative to its
#: largest element (f32: the plans change only the order of sums; an EP
#: reduction counted twice would be off by the EP degree)
GRAD_TOL = 1e-5
CASES = [("qwen1p5_0p5b", "pp2_fsdp", (4, 1, 2)),
         ("qwen1p5_0p5b", "pp2_fsdp_tp", (2, 2, 2)),
         ("deepseek_moe_16b", "pp2_fsdp_tp_ep", (2, 2, 2)),
         ("deepseek_moe_16b", "fsdp_tp_ep", (2, 4, 1)),
         ("deepseek_moe_16b", "hsdp_tp_ep", (2, 4, 1))]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(arch, get):
    """Reduced ``arch`` at 4 layers (DeepSeekMoE: 2 dense + 2 MoE), from
    ``get`` (the port's or JAX's ``get_reduced``)."""
    import dataclasses

    cfg = get(arch).with_(n_layers=4)
    if cfg.moe is not None:
        cfg = cfg.with_(moe=dataclasses.replace(cfg.moe, n_dense_layers=2))
    return cfg


def _batch(vocab):
    toks = np.random.default_rng(1).integers(3, vocab, (8, 32))
    return {"tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, 1).astype(np.int32)}


_RANKS = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import numpy as np
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import Shard
    from repro_torch.ckpt import AsyncCheckpointer
    from repro_torch.ckpt import elastic as EL
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import plans as PL
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_leaves
    import test_torch_pp_train as T

    out_dir = sys.argv[1]
    rank = dist.get_rank() if dist.is_initialized() else int(
        os.environ["RANK"])
    out = {{"curves": {{}}}}

    def model_of(arch):
        model = build_model(T._cfg(arch, get_reduced))
        embed = model.embed_tokens
        model.embed_tokens = lambda p, t: embed(p, t, dtype=torch.float32)
        return model

    def batch_of(model):
        return {{k: torch.from_numpy(v)
                 for k, v in T._batch(model.cfg.vocab).items()}}

    def fresh(model, opt):
        return ST.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0))

    def metrics(m):
        return [float(m["loss"]), float(m["router_lb"])]

    meshes = {{}}

    def mesh_of(shape):
        if shape not in meshes:
            meshes[shape] = make_local_mesh(*shape, device_type="cpu")
        return meshes[shape]

    def planned(model, opt, name, shape, grad_accum=1):
        mesh = mesh_of(shape)
        plan = PL.make_plan(name)
        sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
        st = PL.distribute(fresh(model, opt), sh)
        step = ST.make_train_step(
            model, opt, PL.mesh_context(plan, mesh),
            plan.ep_storage_axes if plan.ep else (), grad_accum=grad_accum)
        lay = lambda b: PL.distribute(b, PL.batch_shardings(plan, mesh, b))
        return st, step, lay, sh

    refs = {{}}
    for arch, name, shape in T.CASES:
        model, opt = model_of(arch), AdamW(lr=1e-3)
        batch = batch_of(model)
        if arch not in refs:
            st, step = fresh(model, opt), ST.make_train_step(model, opt)
            rows = []
            for _ in range(3):
                st, m = step(st, batch)
                rows.append(metrics(m))
            refs[arch] = (rows, tree_leaves(st["params"]))
        st, step, lay, _ = planned(model, opt, name, shape,
                                   2 if name == "pp2_fsdp_tp" else 1)
        rows = []
        for _ in range(3):
            st, m = step(st, lay(batch))
            rows.append(metrics(m))
        perr = max(float((a.full_tensor() - b).abs().max())
                   for a, b in zip(tree_leaves(st["params"]), refs[arch][1]))
        out["curves"][name] = {{"one_device": refs[arch][0],
                               "plan": rows, "param_err": perr}}

    # EP at degree > 1: one step's gradients against the one-device ones
    model = model_of("deepseek_moe_16b")
    batch = batch_of(model)
    loss = lambda p, b, *a: ST.compute_loss(model, p, b, *a)
    _, ref = ST.value_and_grad(loss, fresh(model, AdamW(lr=1e-3))["params"],
                               batch)
    ref = dict(PL._flatten(ref))
    out["ep_grads"] = {{}}
    for name, shape in T.EP_GRADS:
        plan = PL.make_plan(name)
        st, _, lay, _ = planned(model, AdamW(lr=1e-3), name, shape)
        _, got = ST.value_and_grad(loss, st["params"], lay(batch),
                                   PL.mesh_context(plan, mesh_of(shape)),
                                   plan.ep_storage_axes)
        out["ep_grads"][name] = {{
            k: float((g.full_tensor() - ref[k]).abs().max()
                     / ref[k].abs().max().clamp_min(1e-30))
            for k, g in PL._flatten(got)}}

    # pp2_fsdp -> fsdp -> pp2_fsdp through checkpoints
    model, opt = model_of("qwen1p5_0p5b"), AdamW(lr=1e-3)
    batch = batch_of(model)
    st, step, lay, sh = planned(model, opt, "pp2_fsdp", (4, 1, 2))
    for _ in range(2):
        st, _ = step(st, lay(batch))
    saved = {{k: t.full_tensor() for k, t in PL._flatten(st)}}

    def same(state):
        flat = dict(PL._flatten(state))
        return flat.keys() == saved.keys() and all(
            torch.equal(t.full_tensor(), saved[k]) for k, t in flat.items())

    def save(state, sub):
        ck = AsyncCheckpointer(os.path.join(out_dir, sub))
        ck.save(state, int(state["step"].full_tensor()))
        ck.wait()
        ck.close()
        return ck.latest()[1]

    like = {{"params": model.init(torch.Generator().manual_seed(1)),
             "opt": None, "step": torch.zeros((), dtype=torch.int32)}}
    like["opt"] = opt.init(like["params"])
    path = save(st, "pp2")
    flat = EL.restore_train_state(like, path, plan=PL.make_plan("fsdp"),
                                  mesh=mesh_of((8, 1, 1)), model=model,
                                  optimizer=opt)
    out["ckpt_fsdp"] = same(flat)
    back = EL.restore_train_state(like, save(flat, "fsdp"),
                                  plan=PL.make_plan("pp2_fsdp"),
                                  mesh=mesh_of((4, 1, 2)), model=model,
                                  optimizer=opt)
    staged = back["params"]["blocks"]["attn"]["wq"]
    out["ckpt_back"] = same(back) and staged.placements[0] == Shard(0)

    # train_pp.yaml through the CLI, in these processes
    import contextlib, io
    from repro_torch.run.cli import main as cli_main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli_main(["train", "--config", {train_pp!r}, "--device", "cpu",
                       "--set", "dataset.config.prefix=" + out_dir + "/pp",
                       "--set", "run.output_dir=" + out_dir + "/train_pp"])
    said = [None] * dist.get_world_size()
    dist.all_gather_object(said, (rc, buf.getvalue()))
    out["cli"] = said
    if rank == 0:
        with open(os.path.join(out_dir, "ranks.json"), "w") as f:
            json.dump(out, f)
''')


def _torchrun(args, cwd, timeout=900):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "8", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    out = tmp_path_factory.mktemp("pp_ranks")
    script = out / "ranks.py"
    script.write_text(_RANKS.format(src=SRC, tests=os.path.dirname(
        os.path.abspath(__file__)), train_pp=os.path.abspath(TRAIN_PP)))
    proc = _torchrun([str(script), str(out)], cwd=str(out))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "ranks.json") as f:
        res = json.load(f)
    res["dir"] = str(out)
    return res


@functools.lru_cache(maxsize=None)
def _jax_curve(arch):
    """JAX's one-device ``make_train_step``, 3 steps, on the port's initial
    params (numpy) and the same batch, f32 activations."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_reduced as jax_get_reduced
    from repro.models import build_model as jax_build_model
    from repro.optim.adamw import AdamW as JaxAdamW
    from repro.train import steps as JST
    from repro_torch.bridge import params_to_numpy
    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model
    from repro_torch.optim.adamw import AdamW
    from repro_torch.train import steps as ST

    jm = jax_build_model(_cfg(arch, jax_get_reduced))
    embed = jm.embed_tokens
    jm.embed_tokens = lambda p, t: embed(p, t, dtype=jnp.float32)
    model = build_model(_cfg(arch, get_reduced))
    params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
        ST.init_train_state(model, AdamW(lr=1e-3),
                            torch.Generator().manual_seed(0))["params"]))
    opt = JaxAdamW(lr=1e-3)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    batch = {k: jnp.asarray(v) for k, v in _batch(model.cfg.vocab).items()}
    step = jax.jit(JST.make_train_step(jm, opt))
    rows = []
    for _ in range(3):
        state, m = step(state, batch)
        rows.append([float(m["loss"]), float(m.get("router_lb", 0.0))])
    return rows


@pytest.mark.parametrize("case", CASES, ids=[c[1] for c in CASES])
def test_plan_curve_matches_one_device_and_jax(ranks, case):
    arch, name, _ = case
    row = ranks["curves"][name]
    for (got_ce, got_lb), (ce, lb) in zip(row["plan"], row["one_device"]):
        assert abs(got_ce - ce) <= LOSS_TOL * ce, row
        assert abs(got_lb - lb) <= LOSS_TOL * max(lb, 1e-30), row
    if arch == "deepseek_moe_16b":
        assert all(lb > 0 for _, lb in row["plan"])
    for (got_ce, _), (ce, _) in zip(row["plan"], _jax_curve(arch)):
        assert abs(got_ce - ce) <= LOSS_TOL * ce, (row, name)
    assert row["param_err"] <= PARAM_TOL, row


@pytest.mark.parametrize("plan", [p for p, _ in EP_GRADS])
def test_ep_gradients_at_degree_above_one_equal_the_one_device_ones(ranks,
                                                                    plan):
    errs = ranks["ep_grads"][plan]
    assert sum("w_gate" in k and "moe" in k for k in errs) >= 1, errs
    worst = max(errs, key=errs.get)
    assert errs[worst] <= GRAD_TOL, (worst, errs[worst])


def test_checkpoint_round_trip_pp2_fsdp_and_fsdp(ranks):
    assert ranks["ckpt_fsdp"] and ranks["ckpt_back"]


def _doc(tmp_path, *sets):
    os.makedirs(tmp_path, exist_ok=True)
    return apply_overrides(load_yaml(TRAIN_PP), parse_overrides(
        [f"dataset.config.prefix={tmp_path / 'pp'}",
         f"run.output_dir={tmp_path / 'out'}", *sets]))


def test_train_pp_document_trains_under_torchrun(ranks, tmp_path):
    """``train_pp.yaml`` unchanged but for its directories: a ``(pipe 2,
    data 4)`` mesh, the inline ``{fsdp_axes: [data], pp: 2, n_micro: 4}``
    plan, 20 steps; the losses of the one-device run of the document
    (bf16 activations: ``test_torch_mesh_train``'s CLI bound)."""
    said = ranks["cli"]
    assert [rc for rc, _ in said] == [0] * 8
    stdout = "".join(text for _, text in said)
    assert stdout.count("done: ") == 1, stdout
    assert stdout.count("run artifact:") == 1
    with open(os.path.join(ranks["dir"], "train_pp", "result.json")) as f:
        result = json.load(f)
    assert result["pipeline"] == {"pp": 2, "pipe_axis": "pipe", "n_micro": 4,
                                  "bubble_fraction": 0.2}
    assert result["plan"] == "custom(dp=data; fsdp=data; pp=2@pipe(m=4))"
    assert result["history"][-1]["step"] == 20
    one = api.execute_doc(
        _doc(tmp_path / "one", "mesh={component_key: mesh_provider, "
             "variant_key: single_device}"), device="cpu",
        log=lambda m: None)
    for got, want in zip(result["history"], one["history"]):
        assert abs(got["loss"] - want["loss"]) <= 3e-3 * want["loss"]

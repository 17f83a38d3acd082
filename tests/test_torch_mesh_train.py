"""Training under meshes and sharding plans (ROADMAP A8a) on the CPU.

Multi-rank layouts run as JAX's run theirs, in a subprocess: here
``python -m torch.distributed.run --standalone --nproc-per-node 4`` over
gloo, one launch for several plans (``_RANKS``), each rank pinned to one
torch thread; rank 0 writes one JSON file.  The cases:

- each rank's local block of every param leaf is the numpy block JAX's
  ``NamedSharding`` gives that device for the leaf's spec (``==``), on a
  ``(4, 1)`` and a ``(2, 2)`` ``data x model`` mesh and on a ``(2, 2, 1)``
  ``pod x data x model`` mesh, whose multi-pod ``fsdp`` entry names two
  axes;
- reduced Qwen (4 layers), Mamba2 and Granite (one KV head: replicated
  under TP while the query heads shard), f32 activations, batch 8 x 32, 3
  steps of AdamW under ``ddp`` and ``fsdp`` on ``(4, 1)`` and ``hsdp`` and
  ``fsdp_tp`` on ``(2, 2)``: losses within ``LOSS_TOL`` of the port's
  one-device curve and of JAX's one-device ``make_train_step`` on the same
  numpy params, final params within ``PARAM_TOL`` of the one-device run's;
- the block a restore cuts on the host (``plans.local_block``) is the one
  ``distribute_tensor`` keeps;
- a checkpoint saved under ``fsdp_tp`` on ``(2, 2)`` (rank 0 alone holding
  host buffers) restores under ``ddp`` on ``(4, 1)`` and with no mesh
  ``==`` the saved state
  (``tests/test_ckpt.py:650-657``'s check), and its manifest ``==`` the one
  JAX's writer makes of the same arrays with JAX's specs for that plan;
- ``torchrun ... -m repro_torch train --config DOC --device cpu`` trains a
  document with ``mesh``/``sharding_plan`` nodes, written into
  ``tmp_path``, and writes its artifacts once.

And, in this process: a plan with no mesh, or a ``single_device`` mesh,
trains unsharded and ``==`` the straight run, as in JAX.
"""
import json
import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.ckpt import format as JF
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.sharding import plans as JPL
from repro.train import steps as JST
from repro_torch.bridge import params_to_numpy
from repro_torch.config.resolver import load_yaml
from repro_torch.configs import get_reduced
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.run import api
from repro_torch.run.overrides import apply_overrides, parse_overrides
from repro_torch.train import steps as ST

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
QUICKSTART = os.path.join(os.path.dirname(__file__), "..", "examples",
                          "configs", "quickstart.yaml")
#: losses, relative: f32 activations, where a plan changes only the order
#: of f32 sums (partial sums over ranks, the one-hot gold logit); JAX's own
#: test allows 2e-2 (``tests/test_sharding.py``)
LOSS_TOL = 1e-5
#: final params, absolute: AdamW normalises each element's update, so an
#: element whose gradient is near 0 takes its update's sign from rounding,
#: and two runs that round apart differ there by up to 2 x lr a step (lr
#: 1e-3; 4e-5 to 9e-5 seen in 1 to 42 of 2.5 M elements)
PARAM_TOL = 1e-3
ARCHS = {"qwen1p5_0p5b": 4, "mamba2_780m": 0, "granite_34b": 0}
PLANS = [("ddp", 4, 1), ("fsdp", 4, 1), ("hsdp", 2, 2), ("fsdp_tp", 2, 2)]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _model(arch, n_layers=0):
    """The reduced arch with f32 activations (its embedding's output)."""
    cfg = get_reduced(arch)
    model = build_model(cfg.with_(n_layers=n_layers) if n_layers else cfg)
    embed = model.embed_tokens
    model.embed_tokens = lambda p, t: embed(p, t, dtype=torch.float32)
    return model


def _batch(vocab):
    toks = np.random.default_rng(1).integers(3, vocab, (8, 32))
    return {"tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, 1).astype(np.int32)}


def _fresh(model, opt):
    return ST.init_train_state(model, opt, torch.Generator().manual_seed(0))


_RANKS = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor
    import numpy as np
    from repro_torch.ckpt import AsyncCheckpointer
    from repro_torch.ckpt import elastic as EL
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.optim.adamw import AdamW
    from repro_torch.sharding import plans as PL
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_leaves

    from repro_torch.configs import get_reduced
    from repro_torch.models import build_model

    ARCHS, PLANS = {archs!r}, {plans!r}
    out_dir = sys.argv[1]

    def _model(arch, n_layers=0):
        cfg = get_reduced(arch)
        model = build_model(cfg.with_(n_layers=n_layers) if n_layers else cfg)
        embed = model.embed_tokens
        model.embed_tokens = lambda p, t: embed(p, t, dtype=torch.float32)
        return model

    def _torch_batch(vocab):
        toks = np.random.default_rng(1).integers(3, vocab, (8, 32))
        return {{"tokens": torch.tensor(toks.astype(np.int32)),
                 "labels": torch.tensor(np.roll(toks, -1, 1).astype(
                     np.int32))}}

    def _fresh(model, opt):
        return ST.init_train_state(model, opt,
                                   torch.Generator().manual_seed(0))

    meshes = {{(dp, tp): make_local_mesh(dp, tp, device_type="cpu")
               for dp, tp in ((4, 1), (2, 2))}}
    pod = init_device_mesh("cpu", (2, 2, 1),
                           mesh_dim_names=("pod", "data", "model"))
    out = {{"shards": {{}}, "host_blocks": {{}}, "curves": {{}}}}

    def block(full, spec, mesh):
        """The block of ``full`` JAX's NamedSharding gives this rank: each
        entry's axes split the dim major to minor, in the entry's order."""
        sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
        coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
        for d, entry in enumerate(spec):
            if entry is None:
                continue
            idx, n = 0, 1
            for a in (entry if isinstance(entry, tuple) else (entry,)):
                idx, n = idx * sizes[a] + coord[a], n * sizes[a]
            c = full.shape[d] // n
            full = full.narrow(d, idx * c, c)
        return full

    for arch in ("qwen1p5_0p5b", "granite_34b"):
        model = _model(arch)
        params = model.init(torch.Generator().manual_seed(0))
        for name, mp, mesh in (("fsdp", False, meshes[(4, 1)]),
                               ("fsdp_tp", False, meshes[(2, 2)]),
                               ("hsdp", False, meshes[(2, 2)]),
                               ("fsdp", True, pod)):
            plan = PL.make_plan(name, mp)
            sh, _ = PL.param_shardings(plan, mesh, params, model.param_axes())
            laid = PL.distribute(params, sh)
            ok = all(torch.equal(t.to_local(), block(p, s.spec, mesh))
                     for t, p, s in zip(tree_leaves(laid), tree_leaves(params),
                                        tree_leaves(sh)))
            out["shards"][f"{{arch}}/{{name}}/{{mp}}"] = ok
            # the block a restore cuts on the host is DTensor's own
            out["host_blocks"][f"{{arch}}/{{name}}/{{mp}}"] = all(
                torch.equal(t.to_local(), PL.local_block(p, mesh,
                                                         s.placements))
                for t, p, s in zip(tree_leaves(laid), tree_leaves(params),
                                   tree_leaves(sh)))
    # a dim shorter than its mesh dim: torch.chunk's pieces, then empty
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    short = torch.arange(6.0).reshape(3, 2)
    for mesh, pl in ((meshes[(4, 1)], [Shard(0), Replicate()]),
                     (pod, [Shard(0), Shard(0), Replicate()])):
        got = PL.local_block(short, mesh, pl)
        want = distribute_tensor(short, mesh, pl,
                                 src_data_rank=None).to_local()
        out["host_blocks"][f"short/{{mesh.mesh_dim_names}}"] = (
            got.shape == want.shape and torch.equal(got, want))

    for arch, n_layers in ARCHS.items():
        model = _model(arch, n_layers)
        opt = AdamW(lr=1e-3)
        batch = _torch_batch(model.cfg.vocab)
        state = _fresh(model, opt)
        step = ST.make_train_step(model, opt)
        ref = []
        for _ in range(3):
            state, m = step(state, batch)
            ref.append(float(m["loss"]))
        ref_params = tree_leaves(state["params"])
        rows = {{"one_device": ref}}
        for name, dp, tp in PLANS:
            mesh, plan = meshes[(dp, tp)], PL.make_plan(name)
            sh, warns = PL.train_state_shardings(plan, mesh, model, opt)
            st = PL.distribute(_fresh(model, opt), sh)
            stp = ST.make_train_step(model, opt, PL.mesh_context(plan, mesh))
            bsh = PL.batch_shardings(plan, mesh, batch)
            losses = []
            for _ in range(3):
                st, m = stp(st, PL.distribute(batch, bsh))
                losses.append(float(m["loss"]))
            dp_ = max(float((a.full_tensor() - b).abs().max())
                      for a, b in zip(tree_leaves(st["params"]), ref_params))
            rows[name] = {{"losses": losses, "param_err": dp_,
                          "warnings": warns}}
        out["curves"][arch] = rows

    # gradient accumulation (2 microbatches) under fsdp_tp
    model, opt = _model("qwen1p5_0p5b", 4), AdamW(lr=1e-3)
    batch = _torch_batch(model.cfg.vocab)
    _, m = ST.make_train_step(model, opt, grad_accum=2)(_fresh(model, opt),
                                                         batch)
    plan, mesh = PL.make_plan("fsdp_tp"), meshes[(2, 2)]
    sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
    _, dm = ST.make_train_step(model, opt, PL.mesh_context(plan, mesh),
                               grad_accum=2)(
        PL.distribute(_fresh(model, opt), sh),
        PL.distribute(batch, PL.batch_shardings(plan, mesh, batch)))
    out["accum"] = [float(m["loss"]), float(dm["loss"])]

    # a checkpoint saved under fsdp_tp restores under ddp and with no mesh
    model, opt = _model("qwen1p5_0p5b", 4), AdamW(lr=1e-3)
    batch = _torch_batch(model.cfg.vocab)
    plan, mesh = PL.make_plan("fsdp_tp"), meshes[(2, 2)]
    sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
    st = PL.distribute(_fresh(model, opt), sh)
    stp = ST.make_train_step(model, opt, PL.mesh_context(plan, mesh))
    for _ in range(2):
        st, _ = stp(st, PL.distribute(batch, PL.batch_shardings(plan, mesh,
                                                                batch)))
    ck = AsyncCheckpointer(os.path.join(out_dir, "ck"))
    ck.save(st, 2)
    ck.wait()
    ck.close()
    # every rank joined the gathers; rank 0 alone holds host buffers
    held = [None] * 4
    torch.distributed.all_gather_object(held, len(ck._host))
    out["host_buffers"] = held
    saved = [t.full_tensor() for t in tree_leaves(st)]
    like = {{"params": model.init(torch.Generator().manual_seed(1)),
             "opt": None, "step": torch.zeros((), dtype=torch.int32)}}
    like["opt"] = opt.init(like["params"])
    path = ck.latest()[1]
    ddp = EL.restore_train_state(like, path, plan=PL.make_plan("ddp"),
                                 mesh=meshes[(4, 1)], model=model,
                                 optimizer=opt)
    plain = EL.restore(like, path, device="cpu")
    out["restore"] = {{
        "ddp": all(isinstance(t, DTensor)
                   and all(p.is_replicate() for p in t.placements)
                   and torch.equal(t.full_tensor(), s)
                   for t, s in zip(tree_leaves(ddp), saved)),
        "plain": all(type(t) is torch.Tensor and torch.equal(t, s)
                     for t, s in zip(tree_leaves(plain), saved)),
        "path": path}}
    if int(os.environ["RANK"]) == 0:
        with open(os.path.join(out_dir, "ranks.json"), "w") as f:
            json.dump(out, f)
''')


def _torchrun(args, cwd, timeout=600):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 4-rank launch for the layout, curve and checkpoint cases."""
    out = tmp_path_factory.mktemp("ranks")
    script = out / "ranks.py"
    script.write_text(_RANKS.format(src=SRC, archs=ARCHS, plans=PLANS))
    proc = _torchrun([str(script), str(out)], cwd=str(out))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "ranks.json") as f:
        return json.load(f)


def test_local_shards_are_the_spec_blocks(ranks):
    assert ranks["shards"] and all(ranks["shards"].values()), ranks["shards"]


def test_host_block_is_the_dtensor_block(ranks):
    """``plans.local_block``, which a restore cuts on the host before it
    moves a block to its device, is the block ``distribute_tensor`` keeps,
    also where a dim is shorter than its mesh dims."""
    blocks = ranks["host_blocks"]
    assert len(blocks) == 10 and all(blocks.values()), blocks


def _jax_curve(arch, n_layers):
    """JAX's one-device ``make_train_step``, 3 steps, on the port's initial
    params (numpy) and the same batch, f32 activations."""
    cfg = jax_get_reduced(arch)
    jm = jax_build_model(cfg.with_(n_layers=n_layers) if n_layers else cfg)
    embed = jm.embed_tokens
    jm.embed_tokens = lambda p, t: embed(p, t, dtype=jnp.float32)
    model = _model(arch, n_layers)
    params = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
        _fresh(model, AdamW(lr=1e-3))["params"]))
    opt = JaxAdamW(lr=1e-3)
    state = {"params": params, "opt": opt.init(params),
             "step": jnp.zeros((), jnp.int32)}
    batch = {k: jnp.asarray(v) for k, v in _batch(model.cfg.vocab).items()}
    step = jax.jit(JST.make_train_step(jm, opt))
    losses = []
    for _ in range(3):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
    return losses


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_plan_curves_match_one_device_and_jax(ranks, arch):
    rows = ranks["curves"][arch]
    jax_losses = _jax_curve(arch, ARCHS[arch])
    for ref in (rows["one_device"], jax_losses):
        for name, _, _ in PLANS:
            for got, want in zip(rows[name]["losses"], ref):
                assert abs(got - want) <= LOSS_TOL * abs(want), (name, rows)
    for name, _, _ in PLANS:
        assert rows[name]["param_err"] <= PARAM_TOL, (name, rows[name])
    # Granite's single KV head stays replicated under TP, with JAX's words
    warns = rows["fsdp_tp"]["warnings"]
    if arch == "granite_34b":
        assert any("kv_heads=1 !% model 2 -> replicated" in w for w in warns)
    else:
        assert warns == []


def test_grad_accum_under_a_plan_matches_one_device(ranks):
    one, mesh = ranks["accum"]
    assert abs(mesh - one) <= LOSS_TOL * abs(one), ranks["accum"]


def _jax_specs(arch, n_layers, plan, sizes):
    """JAX's spec of every leaf of the train state under ``plan`` on a mesh
    of ``sizes`` (``train_state_shardings``' rule: moments mirror the
    params, scalars replicated), as its checkpoint manifest records it."""
    cfg = jax_get_reduced(arch)
    jm = jax_build_model(cfg.with_(n_layers=n_layers))
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    axes = jax.tree_util.tree_flatten(
        jm.param_axes(), is_leaf=lambda t: isinstance(t, tuple))[0]

    class Mesh:
        shape = sizes

    specs = {}
    for (path, leaf), ax in zip(paths, axes):
        key = "/".join(str(p.key) for p in path)
        spec = JPL.spec_to_json(JPL.leaf_spec(JPL.make_plan(plan), Mesh,
                                              tuple(leaf.shape), ax))
        for prefix in ("params", "opt/m", "opt/v"):
            specs[f"{prefix}/{key}"] = spec
    specs["opt/count"] = specs["step"] = []
    return specs


def test_checkpoint_saved_under_fsdp_tp_restores_across_layouts(ranks,
                                                                 tmp_path):
    res = ranks["restore"]
    assert res["ddp"] and res["plain"], res
    # each leaf gathered into rank 0's host buffer; the other ranks keep none
    n_leaves = len(JF.read_manifest(res["path"])["leaves"])
    assert ranks["host_buffers"] == [n_leaves, 0, 0, 0], ranks["host_buffers"]
    path = res["path"]
    manifest = JF.read_manifest(path)
    specs = _jax_specs("qwen1p5_0p5b", 4, "fsdp_tp",
                       {"data": 2, "model": 2})
    assert {k: v["spec"] for k, v in manifest["leaves"].items()} == specs
    arrays = {k: np.load(os.path.join(path, v["file"]))
              for k, v in manifest["leaves"].items()}
    jax_dir = JF.write_checkpoint(str(tmp_path / "jax"), 2, arrays, specs)
    assert JF.read_manifest(jax_dir) == manifest
    with open(os.path.join(path, "manifest.json"), "rb") as a, \
            open(os.path.join(jax_dir, "manifest.json"), "rb") as b:
        assert a.read() == b.read()


def _doc(tmp_path, *sets):
    os.makedirs(tmp_path, exist_ok=True)
    return apply_overrides(load_yaml(QUICKSTART), parse_overrides(
        [f"dataset.config.prefix={tmp_path / 'qs'}",
         f"run.output_dir={tmp_path / 'out'}", "run.train.steps=3",
         "run.train.telemetry=false", *sets]))


def test_cli_trains_a_mesh_document_under_torchrun(tmp_path):
    """A 2 x 2 ``fsdp_tp`` run of the quickstart document (its inline plan
    mapping normalised to ``sharding_plan/custom``) through the CLI on 4
    gloo ranks: one ``done`` line, one set of artifacts, the manifest's
    specs the plan's, the losses the one-device run's."""
    import yaml

    sets = ["mesh={component_key: mesh_provider, variant_key: local, "
            "config: {dp: 2, tp: 2}}",
            "gym.config.mesh_provider={instance_key: mesh}",
            "gym.config.sharding_plan={tp: true, fsdp_axes: [data]}",
            "gym.config.ckpt_every=3"]
    doc = _doc(tmp_path, *sets)
    path = tmp_path / "mesh.yaml"
    path.write_text(yaml.safe_dump(doc))
    proc = _torchrun(["-m", "repro_torch", "train", "--config", str(path),
                      "--device", "cpu"], cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert proc.stdout.count("done: 3 logged points") == 1, proc.stdout
    assert proc.stdout.count("run artifact:") == 1
    out = tmp_path / "out"
    with open(out / "result.json") as f:
        result = json.load(f)
    assert result["plan"] == "custom(dp=data; fsdp=data; tp=model)"
    assert result["pipeline"] == {"pp": 1, "pipe_axis": None, "n_micro": 1,
                                  "bubble_fraction": 0.0}
    manifest = JF.read_manifest(str(out / "ckpt" / "step_00000003"))
    assert manifest["leaves"]["params/blocks/attn/wq"]["spec"] == \
        [None, "data", "model", None]
    straight = api.execute_doc(_doc(tmp_path / "one", "gym.config.ckpt_every=3"),
                               device="cpu", log=lambda m: None)
    # bf16 activations (the document's): TP's partial sums round apart,
    # within test_torch_train's STEP_LOSS_TOL for bf16 steps
    for got, want in zip(result["history"], straight["history"]):
        assert abs(got["loss"] - want["loss"]) <= 3e-3 * want["loss"]


@pytest.mark.parametrize("setting", [
    "gym.config.sharding_plan={component_key: sharding_plan, "
    "variant_key: fsdp}",
    "gym.config.mesh_provider={component_key: mesh_provider, "
    "variant_key: single_device}"], ids=["plan-no-mesh", "single-device"])
def test_plan_without_a_mesh_trains_unsharded(tmp_path, setting):
    """Moved here from ``test_torch_gym.py``'s refusals: JAX's gym trains
    unsharded when the mesh builds nothing, and so does the port's."""
    straight = api.execute_doc(_doc(tmp_path / "a"), device="cpu",
                               log=lambda m: None)
    got = api.execute_doc(_doc(tmp_path / "b", setting), device="cpu",
                          log=lambda m: None)
    assert [h["loss"] for h in got["history"]] == \
        [h["loss"] for h in straight["history"]]
    if "sharding_plan" in setting:
        assert got["plan"] == "fsdp(dp=data; fsdp=data)"

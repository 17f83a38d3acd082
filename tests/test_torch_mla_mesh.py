"""DeepSeek-V3's MLA and MTP under a mesh (the third part of ROADMAP A8b)
on the CPU: reduced DeepSeek-V3 as in ``tests/test_torch_mla.py`` (a dense
MLA layer, then a MoE layer of 4 routed experts, top 2, and the MTP head).

- 4 gloo ranks, one ``torchrun`` launch on a ``(2, 2)`` ``data x model``
  mesh (``ranks``):
  - 2 train steps with f32 activations under ``fsdp_tp`` and
    ``fsdp_tp_ep``: ``ce``, ``mtp`` and ``router_lb`` within ``LOSS_TOL``
    (A8a's bound, ``tests/test_torch_mesh_train.py``) of the port's
    one-device steps, and within ``JAX_LOSS_TOL`` of JAX's step under the
    same plan on the same numpy params.  In f32 no token is routed to
    another expert set than on one device (a flip would move the router
    loss by far more than the bound), so no token is masked (``_flips``
    of ``tests/test_torch_mla.py`` is the rule for bf16);
  - the serve shim's engine (``launch.serve.serve_benchmark``'s: the
    dense slot pool, greedy, a static batch) and the paged engine, each
    with expanded and with absorbed decode, under ``fsdp_tp`` and
    ``serve_ep``, with no warm-up pass: on every rank each latent
    cache leaf is a DTensor with ``plans.cache_specs``' placements (the
    sequence over ``model``: a latent has no heads dim), and the streams
    equal the one-device run's or part at a near-tie (ROADMAP C2:
    ``LOGIT_TOL`` of the one-device logits).
- A JAX subprocess on 8 forced host devices: JAX's train step on ``(2,
  2)`` under both plans (the numbers above), and the dryrun of train-,
  prefill- and decode-shaped inputs on ``(2, 4)``,
  against the port's dryrun on a fake world of 8: ``EQUAL_KEYS``
  (``tests/test_torch_dryrun.py``), among them
  ``mem_argument_size_in_bytes`` (a prefill or decode step reads no MTP
  head, so neither package counts it).
- World size 1 in this process (a one-rank gloo group, as the card runs a
  plan; these tests come first, as the dryruns take the group down):
  ``serve_benchmark`` and the paged engine under ``fsdp_tp``, expanded
  and absorbed, ``==`` the unsharded runs, and the shim at the dense
  depth (an empty MoE stack) with and without the plan.
"""
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.bridge import params_to_numpy
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as MESH
from repro_torch.launch.serve import serve_benchmark
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import shared_prefix_trace
from repro_torch.sharding import plans as PL
from repro_torch.train import steps as ST

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
ARCH = "deepseek_v3_671b"
#: relative, f32 activations: a plan changes only the order of f32 sums
#: (``tests/test_torch_mesh_train.py``'s A8a bound)
LOSS_TOL = 1e-5
#: relative, against JAX's sharded step in f32: each package's own sums
#: (``tests/test_torch_mla.py`` holds one device to 1e-6; the router's
#: softmax and the MTP block's sums in other orders add a few f32 steps)
JAX_LOSS_TOL = 1e-5
#: a near-tie in the one-device logits (``tests/test_torch_engine.py``)
LOGIT_TOL = 3e-2
TRAIN_PLANS = ("fsdp_tp", "fsdp_tp_ep")
#: name -> (plan, absorb, paged)
SERVE_CASES = {
    "shim-expanded-fsdp_tp": ("fsdp_tp", False, False),
    "shim-absorbed-serve_ep": ("serve_ep", True, False),
    "paged-expanded-serve_ep": ("serve_ep", False, True),
    "paged-absorbed-fsdp_tp": ("fsdp_tp", True, True),
}
SHIM = dict(batch=2, prompt_len=8, gen=6, seed=0)
PAGED = dict(n=6, prefix_len=16, seed=9, prompt_lens=(4,), gen_tokens=(6,),
             temperature=0.0, max_len=32)
PAGED_ENGINE = dict(n_slots=2, max_len=32, block_len=8, prefill_chunk=8)
#: the dryrun cases: train-, prefill- and decode-shaped inputs
DRY_SHAPES = {"train": {"seq_len": 64, "global_batch": 8, "kind": "train"},
              "prefill": {"seq_len": 128, "global_batch": 8,
                          "kind": "prefill"},
              "decode": {"seq_len": 64, "global_batch": 8, "kind": "decode"}}
DRY_CASES = [("train", "fsdp_tp_ep"), ("prefill", "fsdp_tp"),
             ("decode", "fsdp_tp_ep")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _batch():
    toks = np.random.default_rng(1).integers(3, 512, (8, 16))
    return {"tokens": toks.astype(np.int32),
            "labels": np.roll(toks, -1, 1).astype(np.int32)}


def _f32(model):
    """``model`` with f32 activations (its embedding's output)."""
    embed = model.embed_tokens
    model.embed_tokens = lambda p, t: embed(p, t, dtype=torch.float32)
    return model


def _train(plan=None, mesh=None, steps=2):
    """The port's losses over ``steps`` AdamW steps from the seed-0 init,
    with no mesh or under ``plan`` on ``mesh``."""
    model = _f32(build_model(get_reduced(ARCH)))
    opt = AdamW(lr=1e-3)
    state = ST.init_train_state(model, opt, torch.Generator().manual_seed(0))
    ctx, axes, batch = None, (), {k: torch.as_tensor(v)
                                  for k, v in _batch().items()}
    if plan is not None:
        pl = PL.make_plan(plan)
        sh, _ = PL.train_state_shardings(pl, mesh, model, opt)
        state = PL.distribute(state, sh)
        ctx = PL.mesh_context(pl, mesh)
        axes = pl.ep_storage_axes if pl.ep else ()
        batch = PL.distribute(batch, PL.batch_shardings(pl, mesh, batch))
    step = ST.make_train_step(model, opt, ctx, axes)
    rows = []
    for _ in range(steps):
        state, m = step(state, batch)
        rows.append({k: float(v) for k, v in m.items()})
    return rows


_RANKS = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {src!r})
    sys.path.insert(0, {tests!r})
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    import test_torch_mla_mesh as T
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine, load_params
    from repro_torch.sharding import plans as PL
    from repro_torch.tree import tree_leaves

    mesh = make_local_mesh(2, 2, device_type="cpu")
    out = {{"train": {{p: T._train(p, mesh) for p in T.TRAIN_PLANS}}}}
    pools = []
    make = ServeEngine._init_pool

    def keep(self):
        cache, slots = make(self)
        pools.append((self, cache))
        return cache, slots

    ServeEngine._init_pool = keep
    for name, (plan, absorb, paged) in T.SERVE_CASES.items():
        model = build_model(get_reduced(T.ARCH).with_(mla_absorb=absorb))
        params = load_params(model, seed=0, device="cpu")
        pools.clear()
        streams = T._streams(model, params, paged, mesh=mesh,
                             plan=PL.make_plan(plan))
        eng, cache = pools[-1]
        shapes = (model.init_paged_cache(eng.n_blocks, eng.block_len,
                                         device="meta") if paged else
                  model.init_cache(eng.n_slots, eng.max_len, device="meta"))
        specs = PL.cache_specs(PL.make_plan(plan), mesh, shapes, paged=paged)
        layout = all(isinstance(t, DTensor) and list(t.placements)
                     == PL.spec_placements(mesh, s)
                     for t, s in zip(tree_leaves(cache), tree_leaves(specs)))
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, (streams, layout))
        out[name] = {{"streams": streams,
                      "same_on_every_rank": all(e[0] == streams
                                                for e in every),
                      "layout_on_every_rank": all(e[1] for e in every),
                      "specs": [[list(e) if isinstance(e, tuple) else e
                                 for e in s] for s in tree_leaves(specs)]}}
    if dist.get_rank() == 0:
        with open(os.path.join(sys.argv[1], "ranks.json"), "w") as f:
            json.dump(out, f)
''')

_JAX = textwrap.dedent('''
    import json, os, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    sys.path.insert(0, sys.argv[1])
    sys.path.insert(0, sys.argv[2])
    import jax, jax.numpy as jnp, numpy as np
    from repro.configs import get_reduced
    from repro.launch.mesh import make_local_mesh
    from repro.models import build_model
    from repro.optim.adamw import AdamW
    from repro.run import api
    from repro.sharding import plans as PL
    from repro.train import steps as ST
    import test_torch_mla_mesh as T
    from test_torch_dryrun import EQUAL_KEYS

    flat = np.load(sys.argv[3])
    params = {{}}
    for key in flat.files:
        node = params
        *head, last = key.split("/")
        for part in head:
            node = node.setdefault(part, {{}})
        node[last] = jnp.asarray(flat[key])
    model = build_model(get_reduced(T.ARCH))
    embed = model.embed_tokens
    model.embed_tokens = lambda p, t, dtype=None: embed(p, t, jnp.float32)
    out = {{"train": {{}}, "dryrun": {{}}}}
    mesh = make_local_mesh(2, 2)
    batch = {{k: jnp.asarray(v) for k, v in T._batch().items()}}
    for name in T.TRAIN_PLANS:
        plan = PL.make_plan(name)
        opt = AdamW(lr=1e-3)
        state = {{"params": params, "opt": opt.init(params),
                  "step": jnp.zeros((), jnp.int32)}}
        sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
        ctx = PL.mesh_context(plan, mesh)
        axes = plan.ep_storage_axes if plan.ep else ()
        with mesh:
            state = jax.device_put(state, sh)
            step = jax.jit(ST.make_train_step(model, opt, ctx, axes),
                           in_shardings=(sh, None), out_shardings=(sh, None))
            rows = []
            for _ in range(2):
                state, m = step(state, batch)
                rows.append({{k: float(v) for k, v in m.items()}})
        out["train"][name] = rows
    for shape, plan in T.DRY_CASES:
        res = api.execute_doc(T._dry_doc(shape, plan, sys.argv[4]),
                              write_files=False)
        out["dryrun"][shape + "-" + plan] = {{k: res[k]
                                              for k in EQUAL_KEYS}}
    with open(sys.argv[5], "w") as f:
        json.dump(out, f)
''')


def _streams(model, params, paged, **kw):
    """The greedy streams of the paged engine, or of the shim's engine
    (``serve_benchmark``'s: the dense pool, a static batch), with no
    warm-up pass."""
    from repro_torch.serve.workload import static_trace

    if paged:
        eng = ServeEngine(model, params, **PAGED_ENGINE, **kw)
        trace = _paged_trace()
    else:
        eng = ServeEngine(model, params, n_slots=SHIM["batch"],
                          max_len=SHIM["prompt_len"] + SHIM["gen"],
                          greedy=True, block_len=0, **kw)
        trace = static_trace(_shim_prompts(), SHIM["gen"], seed=SHIM["seed"])
    res = eng.run(trace, realtime=False, warmup=False)
    return [r["gen_ids"] for r in res["requests"]]


def _shim_prompts():
    """``serve_benchmark``'s prompts."""
    return np.random.default_rng(SHIM["seed"] + 1).integers(
        3, get_reduced(ARCH).vocab, size=(SHIM["batch"], SHIM["prompt_len"]),
        dtype=np.int32)


def _paged_trace():
    spec = dict(PAGED)
    n = spec.pop("n")
    return shared_prefix_trace(n, get_reduced(ARCH).vocab, **spec)


def _dry_doc(shape, plan, out):
    from test_torch_dryrun import _doc

    return _doc(ARCH, DRY_SHAPES[shape], out, mesh={"dp": 2, "tp": 4},
                plan=plan)


@pytest.fixture(scope="module", autouse=True)
def _launch(tmp_path_factory):
    """The 4-rank launch and the JAX subprocess, started together before
    this module's first test (each writes its output to a file: a pipe
    left unread could fill and stall it)."""
    out = tmp_path_factory.mktemp("mla_mesh")
    here = os.path.dirname(os.path.abspath(__file__))
    from repro_torch.ckpt.format import flatten_with_paths

    model = build_model(get_reduced(ARCH))
    init = params_to_numpy(model.init(torch.Generator().manual_seed(0)))
    np.savez(out / "params.npz", **dict(flatten_with_paths(init)))
    script = out / "ranks.py"
    script.write_text(_RANKS.format(src=SRC, tests=here))
    logs = {k: open(out / f"{k}.log", "w") for k in ("ranks", "jax")}
    procs = {
        "ranks": subprocess.Popen(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc-per-node", "4", str(script), str(out)], cwd=str(out),
            env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1"),
            stdout=logs["ranks"], stderr=subprocess.STDOUT),
        "jax": subprocess.Popen(
            [sys.executable, "-c", _JAX.format(), SRC, here,
             str(out / "params.npz"), str(out / "jax_dry"),
             str(out / "jax.json")],
            env=dict(os.environ, JAX_PLATFORMS="cpu"),
            stdout=logs["jax"], stderr=subprocess.STDOUT)}
    yield out, procs
    for k, p in procs.items():
        if p.poll() is None:
            p.kill()
            p.wait()
        logs[k].close()


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def mesh():
    m = MESH.make_local_mesh(1, 1, device_type="cpu")
    yield m
    MESH.shutdown()


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorbed"])
def test_shim_and_paged_engine_at_world_size_one(mesh, absorb):
    """Under ``fsdp_tp`` on a one-rank mesh the shim's and the paged
    engine's streams ``==`` the unsharded runs' (every core runs the plain
    one on the whole cache)."""
    m = build_model(get_reduced(ARCH).with_(mla_absorb=absorb))
    p = m.init(torch.Generator().manual_seed(0))
    plan = PL.make_plan("fsdp_tp")
    kw = dict(params=p, device="cpu", log=lambda _m: None, **SHIM)
    assert serve_benchmark(m, mesh=mesh, plan=plan, **kw)[
        "generated_ids"] == serve_benchmark(m, **kw)["generated_ids"]
    assert _streams(m, p, True, mesh=mesh, plan=plan) == \
        _streams(m, p, True)


@pytest.mark.parametrize("absorb", [False, True], ids=["expanded", "absorbed"])
def test_shim_at_the_dense_depth(mesh, absorb):
    """DeepSeek-V3 cut to its dense layers (the card's depth: an empty MoE
    stack, whose prefill cache has no rows, as JAX's scan gives it): the
    shim serves with no mesh, and under ``fsdp_tp`` ``==``."""
    m = build_model(get_reduced(ARCH).with_(n_layers=1, mla_absorb=absorb))
    p = m.init(torch.Generator().manual_seed(0))
    kw = dict(params=p, device="cpu", log=lambda _m: None, **SHIM)
    want = serve_benchmark(m, **kw)["generated_ids"]
    assert len(want) == SHIM["batch"] and all(
        len(s) == SHIM["gen"] for s in want)
    assert serve_benchmark(m, mesh=mesh, plan=PL.make_plan("fsdp_tp"),
                           **kw)["generated_ids"] == want


# ---------------------------------------------------------------------------
# 4 gloo ranks and JAX
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(_launch):
    """The port's one-device runs, in this process, then both launches'
    results."""
    out, procs = _launch
    one = {"train": _train()}
    for name, (_, absorb, paged) in SERVE_CASES.items():
        m = build_model(get_reduced(ARCH).with_(mla_absorb=absorb))
        one[name] = _streams(m, m.init(torch.Generator().manual_seed(0)),
                             paged)
    for k, p in procs.items():
        assert p.wait(timeout=900) == 0, \
            (out / f"{k}.log").read_text()[-4000:]
    with open(out / "ranks.json") as f:
        got = json.load(f)
    with open(out / "jax.json") as f:
        jax_out = json.load(f)
    return {"ranks": got, "one": one, "jax": jax_out}


def _close(got, want, tol):
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert abs(g[k] - w[k]) <= tol * abs(w[k]), (k, g[k], w[k])


@pytest.mark.parametrize("plan", TRAIN_PLANS)
def test_train_steps_under_a_plan_equal_one_device(runs, plan):
    """``ce``, ``mtp`` and ``router_lb`` of 2 steps on 4 ranks within
    ``LOSS_TOL`` of the one-device steps (the heads of MLA and the MTP
    block over ``model``, the experts too under ``fsdp_tp_ep``)."""
    rows = runs["ranks"]["train"][plan]
    assert [sorted(r) for r in rows] == [["ce", "loss", "mtp",
                                          "router_lb"]] * 2
    assert rows[1]["ce"] < rows[0]["ce"]
    _close(rows, runs["one"]["train"], LOSS_TOL)


@pytest.mark.parametrize("plan", TRAIN_PLANS)
def test_train_steps_under_a_plan_match_jax(runs, plan):
    """The same 2 steps against JAX's step under the same plan on ``(2,
    2)`` from the same numpy params, within ``JAX_LOSS_TOL``."""
    _close(runs["ranks"]["train"][plan], runs["jax"]["train"][plan],
           JAX_LOSS_TOL)


def _one_device_logits(absorb, prompt, prefix):
    """The one-device logits after ``prompt + prefix`` (the near-tie
    margins are read there)."""
    m = build_model(get_reduced(ARCH).with_(mla_absorb=absorb))
    p = m.init(torch.Generator().manual_seed(0))
    toks = torch.as_tensor([list(prompt) + list(prefix)], dtype=torch.int64)
    with torch.no_grad():
        logits, _ = m.apply(p, {"tokens": toks})
    return logits[0, -1].float()


@pytest.mark.parametrize("case", list(SERVE_CASES))
def test_serving_under_a_plan(runs, case):
    """Every rank draws the same greedy streams; the latent cache's leaves
    are DTensors with ``cache_specs``' placements on every rank, the
    sequence (the paged pool's block offsets) over ``model``; each stream
    equals the one-device run's or parts where the one-device logits'
    top-2 margin is within ``LOGIT_TOL``."""
    _, absorb, paged = SERVE_CASES[case]
    row = runs["ranks"][case]
    assert row["same_on_every_rank"] and row["layout_on_every_rank"]
    assert all(s[2] == "model" for s in row["specs"])
    want = runs["one"][case]
    prompts = ([r.prompt for r in _paged_trace()] if paged
               else _shim_prompts())
    same = 0
    for prompt, a, b in zip(prompts, row["streams"], want):
        assert len(a) == len(b)
        if a == b:
            same += 1
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        logits = _one_device_logits(absorb, prompt, b[:i])
        assert float(logits[b[i]] - logits[a[i]]) <= LOGIT_TOL, (a, b)
    assert same >= len(want) // 2


@pytest.mark.parametrize("shape,plan", DRY_CASES)
def test_dryrun_matches_jax(tmp_path, runs, shape, plan):
    """The port's dryrun on a fake world of 8 against JAX's on 8 forced
    devices: ``EQUAL_KEYS`` ``==`` (no warnings: 4 heads and 4 experts
    divide 4), among them the argument bytes; FLOPs and collectives
    counted."""
    from repro_torch.run import api
    from test_torch_dryrun import EQUAL_KEYS

    res = api.execute_doc(_dry_doc(shape, plan, str(tmp_path)),
                          device="cpu", log=lambda _m: None)
    want = runs["jax"]["dryrun"][f"{shape}-{plan}"]
    for key in EQUAL_KEYS:
        assert res[key] == want[key], (key, res[key], want[key])
    assert res["hlo_flops_per_dev"] > 0
    assert res["collective_counts"]["all-gather"] > 0

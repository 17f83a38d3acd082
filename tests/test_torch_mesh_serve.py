"""Sharded serving (ROADMAP A8b's serving half) on the CPU: the port's
``ServeEngine(mesh=..., plan=...)``, ``plans.cache_shardings`` and the
``serve`` kind under a mesh, against the port's unsharded engine and JAX's
sharded one.

- World size 1, in this process (a one-rank gloo group on a ``FileStore``,
  as the card runs a plan): reduced Qwen's dense and paged engines under
  ``ddp``, ``fsdp`` and ``fsdp_tp`` ``==`` the port's unsharded engine,
  and ``==`` JAX's engine on its one-device mesh with the same params and
  trace (JAX's ``test_engine_sharded_single_device_matches_unsharded`` and
  ``test_paged_engine_sharded_single_device_matches_unsharded``) or parted
  at a near-tie (ROADMAP C2: moving each of JAX's logits by at most
  ``LOGIT_TOL`` makes JAX's own sampler draw the port's token); reduced
  Mamba2's dense engine under ``fsdp_tp`` ``==`` its unsharded engine.
- 4 gloo ranks, one ``torchrun`` launch (``ranks``): Qwen dense and paged
  under ``ddp`` and ``fsdp_tp``, paged under ``fsdp``, on ``(2, 2)``;
  DeepSeekMoE dense and paged under ``serve_ep`` (EP degree 4 = its 4
  experts), Mamba2 dense under ``fsdp_tp``, and two layouts whose key
  positions span ranks: Qwen's
  dense pool of 3 slots under ``ddp`` (the sequence over ``data``) and on
  ``(1, 4)`` under ``fsdp_tp`` (2 KV heads: the sequence over ``model``).
  Every rank draws the same streams; each stream equals the one-device
  run's or parts where JAX's own top-2 margin is within ``LOGIT_TOL``; on
  every rank each cache leaf is a DTensor whose local block is the one
  ``cache_shardings`` gives it, with the same placements and storage
  after the run as when the pool was made.
- The ``serve`` kind: a plan with no mesh raises JAX's ``RunError``; with
  ``mesh: local {dp: 1, tp: 1}`` and ``plan: fsdp_tp`` the result's
  ``plan`` and streams equal JAX's run of the same document.
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

from repro.configs import get_reduced as jax_get_reduced
from repro.launch.mesh import make_local_mesh as jax_make_local_mesh
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.sampling import sample_tokens as jax_sample_tokens
from repro.sharding.plans import make_plan as jax_make_plan
from repro_torch.bridge import params_from_jax
from repro_torch.configs import get_reduced
from repro_torch.launch import mesh as MESH
from repro_torch.models import build_model
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import shared_prefix_trace, synthetic_trace
from repro_torch.sharding.plans import make_plan

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: a near-tie: the bound of ``tests/test_torch_engine.py`` (bf16 logits,
#: each package rounding at its own places; ROADMAP C2)
LOGIT_TOL = 3e-2

DENSE_TRACE = dict(n=4, seed=6, prompt_lens=(5, 7), gen_tokens=(4,),
                   temperature=0.6, max_len=16)
DENSE_ENGINE = dict(n_slots=2, max_len=16, block_len=0)
PAGED_TRACE = dict(n=4, prefix_len=16, seed=9, prompt_lens=(4,),
                   gen_tokens=(3,), temperature=0.6, max_len=32)
PAGED_ENGINE = dict(n_slots=2, max_len=32, block_len=8, prefill_chunk=8)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one thread for this module (the suite's workers
    share the host's cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _trace(pkg_trace, vocab, spec):
    spec = dict(spec)
    n = spec.pop("n")
    return pkg_trace(n, vocab, **spec)


def _traces(vocab, paged):
    """The same seeded trace from both packages' workload modules."""
    from repro.serve import workload as JW

    if paged:
        return (_trace(shared_prefix_trace, vocab, PAGED_TRACE),
                _trace(JW.shared_prefix_trace, vocab, PAGED_TRACE))
    return (_trace(synthetic_trace, vocab, DENSE_TRACE),
            _trace(JW.synthetic_trace, vocab, DENSE_TRACE))


@pytest.fixture(scope="module")
def models():
    """Reduced Qwen and Mamba2 in both packages on JAX's params."""
    out = {}
    for arch in ("qwen1p5_0p5b", "mamba2_780m"):
        jm = jax_build_model(jax_get_reduced(arch))
        jp = jm.init(jax.random.PRNGKey(0))
        np_params = jax.tree_util.tree_map(np.asarray, jp)
        out[arch] = {"jm": jm, "jp": jp,
                     "model": build_model(get_reduced(arch)),
                     "params": params_from_jax(np_params)}
    return out


@pytest.fixture(scope="module")
def mesh():
    """The port's one-device ``data x model`` mesh (a one-rank gloo group
    on a ``FileStore``), taken down after the module."""
    m = MESH.make_local_mesh(1, 1, device_type="cpu")
    yield m
    MESH.shutdown()


def _streams(out):
    return [r["gen_ids"] for r in out["requests"]]


def _jax_logits(jm, jp, tokens):
    """JAX's ``apply`` logits after ``tokens`` (its own top-2 margin is
    read there, as ROADMAP C2 reads it)."""
    logits, _ = jm.apply(jp, {"tokens": jnp.asarray([tokens], jnp.int32)})
    return np.asarray(logits, np.float32)[0, -1]


def _near_tie(jm, jp, r, prefix, got, want):
    """``got`` and ``want`` are within ``LOGIT_TOL`` of each other in JAX's
    own scores after ``r.prompt + prefix`` (with a sampled request's
    Gumbel noise, in logit units): moving each logit by at most
    ``LOGIT_TOL`` makes JAX's sampler draw ``got``."""
    logits = _jax_logits(jm, jp, list(r.prompt) + list(prefix))
    key = jax.random.fold_in(jax.random.PRNGKey(r.seed), len(prefix))[None]
    if r.temperature > 0:
        score = logits / r.temperature + np.asarray(
            jax.random.gumbel(key[0], logits.shape))
    else:
        score = logits
    delta = np.where(score > score[got], -LOGIT_TOL, LOGIT_TOL)
    tok = jax_sample_tokens(
        jnp.asarray(logits + delta)[None], key, jnp.float32([r.temperature]),
        jnp.int32([r.top_k]), jnp.float32([r.top_p]))
    return int(tok[0]) == got


def _equal_or_tie(jm, jp, trace, got, want):
    """Each stream of ``got`` equals ``want``'s or parts at a near-tie of
    JAX's; returns how many are equal."""
    same = 0
    for r, a, b in zip(trace, got, want):
        assert len(a) == len(b), (r.rid, a, b)
        if a == b:
            same += 1
            continue
        i = next(j for j in range(len(a)) if a[j] != b[j])
        assert _near_tie(jm, jp, r, b[:i], a[i], b[i]), (r.rid, i, a, b)
    return same


# ---------------------------------------------------------------------------
# world size 1
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
@pytest.mark.parametrize("plan", ["ddp", "fsdp", "fsdp_tp"])
def test_engine_under_a_plan_at_world_size_one(models, mesh, plan, paged):
    """The port's engine under ``plan`` on a one-device mesh ``==`` its
    unsharded engine (every redistribution is a no-op and each rank's
    core runs the plain one on the whole pool), and ``==`` JAX's engine on
    its one-device mesh or parted at a near-tie; the pool's leaves are
    DTensors with ``cache_shardings``' placements."""
    m = models["qwen1p5_0p5b"]
    kw = PAGED_ENGINE if paged else DENSE_ENGINE
    trace, jtrace = _traces(m["model"].cfg.vocab, paged)
    want = _streams(ServeEngine(m["model"], m["params"], **kw).run(
        trace, realtime=False))
    eng = ServeEngine(m["model"], m["params"], mesh=mesh,
                      plan=make_plan(plan), **kw)
    pools = []
    make = eng._init_pool
    eng._init_pool = lambda: pools.append(make()) or pools[-1]
    out = eng.run(trace, realtime=False)
    assert _streams(out) == want
    from torch.distributed.tensor import DTensor

    from repro_torch.sharding import plans as PL
    from repro_torch.tree import tree_leaves

    cache = pools[-1][0]
    specs = PL.cache_specs(make_plan(plan), mesh, cache, paged=paged)
    for leaf, spec in zip(tree_leaves(cache), tree_leaves(specs)):
        assert isinstance(leaf, DTensor)
        assert list(leaf.placements) == PL.spec_placements(mesh, spec)
    jeng = JaxServeEngine(m["jm"], m["jp"], mesh=jax_make_local_mesh(1, 1),
                          plan=jax_make_plan(plan), **kw)
    jout = jeng.run(jtrace, realtime=False)
    if paged:
        assert out["prefill_cache_hit_rate"] == \
            jout["prefill_cache_hit_rate"] > 0
    _equal_or_tie(m["jm"], m["jp"], trace, _streams(out), _streams(jout))


def test_mamba2_engine_under_fsdp_tp_at_world_size_one(models, mesh):
    """Mamba2's dense engine under ``fsdp_tp`` on a one-device mesh ``==``
    its unsharded engine: the conv ring and the recurrence stepped on each
    rank's channels and heads (here all of them)."""
    m = models["mamba2_780m"]
    trace, _ = _traces(m["model"].cfg.vocab, False)
    want = _streams(ServeEngine(m["model"], m["params"],
                                **DENSE_ENGINE).run(trace, realtime=False))
    got = _streams(ServeEngine(m["model"], m["params"], mesh=mesh,
                               plan=make_plan("fsdp_tp"),
                               **DENSE_ENGINE).run(trace, realtime=False))
    assert got == want


# ---------------------------------------------------------------------------
# 4 gloo ranks
# ---------------------------------------------------------------------------
#: name -> (arch, mesh (dp, tp), plan, paged, n_slots)
RANK_CASES = {
    "qwen-dense-ddp": ("qwen1p5_0p5b", (2, 2), "ddp", False, 2),
    "qwen-dense-fsdp_tp": ("qwen1p5_0p5b", (2, 2), "fsdp_tp", False, 2),
    "qwen-paged-ddp": ("qwen1p5_0p5b", (2, 2), "ddp", True, 2),
    "qwen-paged-fsdp_tp": ("qwen1p5_0p5b", (2, 2), "fsdp_tp", True, 2),
    "qwen-paged-fsdp": ("qwen1p5_0p5b", (2, 2), "fsdp", True, 2),
    "moe-dense-serve_ep": ("deepseek_moe_16b", (2, 2), "serve_ep", False, 2),
    "moe-paged-serve_ep": ("deepseek_moe_16b", (2, 2), "serve_ep", True, 2),
    "mamba2-dense-fsdp_tp": ("mamba2_780m", (2, 2), "fsdp_tp", False, 2),
    # the key positions span ranks: 3 slots do not divide over data (the
    # sequence goes there), 2 KV heads do not divide over 4 (it goes over
    # model)
    "qwen-dense-ddp-3slots": ("qwen1p5_0p5b", (2, 2), "ddp", False, 3),
    "qwen-dense-fsdp_tp-1x4": ("qwen1p5_0p5b", (1, 4), "fsdp_tp", False, 2),
}
#: the multi-rank traces: greedy and sampled requests, slots reused, a
#: shared prefix hit in the paged pool (JAX's 2 x 2 check of the
#: Motivation: 8 requests on one 16-token prefix)
RANK_DENSE = dict(n=6, seed=6, prompt_lens=(5, 7), gen_tokens=(6,),
                  temperature=0.6, max_len=16)
RANK_PAGED = dict(n=8, prefix_len=16, seed=9, prompt_lens=(4,),
                  gen_tokens=(6,), temperature=0.0, max_len=32)

_RANKS = textwrap.dedent('''
    import json, os, sys
    sys.path.insert(0, {src!r})
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor
    from repro_torch.configs import get_reduced
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models import build_model
    from repro_torch.serve.engine import ServeEngine, load_params
    from repro_torch.serve.workload import shared_prefix_trace, synthetic_trace
    from repro_torch.sharding import plans as PL
    from repro_torch.tree import tree_leaves

    CASES, DENSE, PAGED = {cases!r}, {dense!r}, {paged!r}
    meshes = {{(2, 2): make_local_mesh(2, 2, device_type="cpu"),
               (1, 4): make_local_mesh(1, 4, device_type="cpu")}}

    def trace(vocab, paged):
        spec = dict(PAGED if paged else DENSE)
        n = spec.pop("n")
        fn = shared_prefix_trace if paged else synthetic_trace
        return fn(n, vocab, **spec)

    out = {{}}
    for name, (arch, mshape, plan, paged, n_slots) in CASES.items():
        model = build_model(get_reduced(arch))
        params = load_params(model, seed=0, device="cpu")
        kw = dict(n_slots=n_slots, max_len=(PAGED if paged else DENSE)[
            "max_len"], block_len=8 if paged else 0)
        if paged:
            kw["prefill_chunk"] = 8
        tr = trace(model.cfg.vocab, paged)
        one = ServeEngine(model, params, **kw).run(tr, realtime=False)
        mesh = meshes[tuple(mshape)]
        eng = ServeEngine(model, params, mesh=mesh,
                          plan=PL.make_plan(plan), **kw)
        pools = []
        make = eng._init_pool

        def keep():
            cache, slots = make()
            leaves = tree_leaves(cache)
            pools.append((cache, [tuple(t.placements) for t in leaves],
                          [t.to_local().data_ptr() for t in leaves]))
            return cache, slots

        eng._init_pool = keep
        res = eng.run(tr, realtime=False)
        cache, placements, ptrs = pools[-1]
        shapes = (model.init_paged_cache(eng.n_blocks, eng.block_len,
                                         device="meta") if paged else
                  model.init_cache(n_slots, eng.max_len, device="meta"))
        specs = PL.cache_specs(PL.make_plan(plan), mesh, shapes, paged=paged)
        blocks, layout = [], True
        for t, spec, pl0, p0 in zip(tree_leaves(cache), tree_leaves(specs),
                                    placements, ptrs):
            layout &= (isinstance(t, DTensor)
                       and list(t.placements) == PL.spec_placements(mesh,
                                                                    spec)
                       and tuple(t.placements) == pl0
                       and t.to_local().data_ptr() == p0)
            blocks.append(list(t.to_local().shape))
        streams = [r["gen_ids"] for r in res["requests"]]
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, streams)
        out[name] = {{"streams": streams,
                      "one_device": [r["gen_ids"] for r in one["requests"]],
                      "same_on_every_rank": all(s == streams for s in every),
                      "layout": layout, "blocks": blocks,
                      "specs": [list(map(lambda e: list(e)
                                         if isinstance(e, tuple) else e, s))
                                for s in tree_leaves(specs)],
                      "global": [list(t.shape) for t in tree_leaves(cache)],
                      "hit": res["prefill_cache_hit_rate"],
                      "hit_one": one["prefill_cache_hit_rate"],
                      "warnings": eng.shard_warnings}}
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, {{k: (v["layout"], v["blocks"])
                                    for k, v in out.items()}})
    if dist.get_rank() == 0:
        out["_ranks"] = every
        with open(os.path.join(sys.argv[1], "ranks.json"), "w") as f:
            json.dump(out, f)
''')


def _torchrun(args, cwd, timeout=900):
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "4", *args], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=timeout)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """One 4-rank launch for every multi-rank case."""
    out = tmp_path_factory.mktemp("serve_ranks")
    script = out / "ranks.py"
    script.write_text(_RANKS.format(src=SRC, cases=RANK_CASES,
                                    dense=RANK_DENSE, paged=RANK_PAGED))
    proc = _torchrun([str(script), str(out)], cwd=str(out))
    assert proc.returncode == 0, proc.stderr[-4000:]
    with open(out / "ranks.json") as f:
        return json.load(f)


@pytest.fixture(scope="module")
def jax_models():
    """JAX's reduced models on the port's ``load_params(seed=0)`` params
    (the ranks' params), for the near-tie margins."""
    from repro_torch.bridge import params_to_numpy
    from repro_torch.serve.engine import load_params

    out = {}
    for arch in {a for a, *_ in RANK_CASES.values()}:
        model = build_model(get_reduced(arch))
        jp = jax.tree_util.tree_map(jnp.asarray, params_to_numpy(
            load_params(model, seed=0, device="cpu")))
        out[arch] = (jax_build_model(jax_get_reduced(arch)), jp)
    return out


def _spec_size(entry, sizes):
    axes = () if entry is None else (
        tuple(entry) if isinstance(entry, list) else (entry,))
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_each_rank_holds_its_block_of_the_cache(ranks, case):
    """On every rank each cache leaf is a DTensor with ``cache_shardings``'
    placements, the same placements and the same storage after the run as
    when the pool was made (no redistribution, no reallocation in a
    tick), and its local block is the spec's block of the global leaf (a
    paged pool's: its share of the real pages and its scratch block).  On
    2 x 2, reduced Qwen's dense pool holds K/2 heads of B/2 slots a rank
    and its paged pool half of the 12 pages and one scratch block."""
    arch, (dp, tp), plan, paged, n_slots = RANK_CASES[case]
    row = ranks[case]
    sizes = {"data": dp, "model": tp}
    want = [[g // _spec_size(e, sizes) for g, e in zip(glob, spec)]
            for glob, spec in zip(row["global"], row["specs"])]
    for layout, blocks in (r[case] for r in ranks["_ranks"]):
        assert layout
        assert blocks == want
    cfg = get_reduced(arch)
    if case == "qwen-dense-ddp":
        assert all(b[1:] == [n_slots // 2, 16, cfg.n_kv_heads // 2,
                             cfg.head_dim_] for b in want)
    if case == "qwen-paged-fsdp_tp":
        n_blocks = (n_slots + 1) * (32 // 8)
        assert all(b[1:] == [n_blocks // 2 + 1, 8, cfg.n_kv_heads // 2,
                             cfg.head_dim_] for b in want)
    if case == "qwen-dense-fsdp_tp-1x4":
        assert all(b[2] == 16 // 4 for b in want)      # the sequence
    if case == "mamba2-dense-fsdp_tp":
        assert {tuple(s) for s in map(tuple, (map(str, s)
                                              for s in row["specs"]))} == {
            ("None", "data", "None", "model"),
            ("None", "data", "model", "None", "None")}


@pytest.mark.parametrize("case", list(RANK_CASES))
def test_sharded_streams_equal_the_one_device_run(ranks, jax_models, case):
    """Every rank draws the same streams, and each equals the one-device
    run's or parts where JAX's own top-2 margin is within ``LOGIT_TOL``
    (TP and EP sum partial products in another order; JAX's paged engine
    on 2 x 2 parts from its unsharded one at a 0.0039 margin, ROADMAP C2);
    the paged pool's prefix hit rate is the one-device run's."""
    arch, _, _, paged, _ = RANK_CASES[case]
    row = ranks[case]
    assert row["same_on_every_rank"]
    assert row["hit"] == row["hit_one"]
    if paged:
        assert row["hit"] > 0
    vocab = get_reduced(arch).vocab
    spec = dict(RANK_PAGED if paged else RANK_DENSE)
    n = spec.pop("n")
    trace = (shared_prefix_trace if paged else synthetic_trace)(
        n, vocab, **spec)
    jm, jp = jax_models[arch]
    same = _equal_or_tie(jm, jp, trace, row["streams"], row["one_device"])
    assert same >= len(trace) // 2


# ---------------------------------------------------------------------------
# the serve kind
# ---------------------------------------------------------------------------
_SERVE_WORKLOAD = {"n_requests": 4, "rate": 0.0, "prefix_len": 16,
                   "prompt_lens": [4], "gen_tokens": [3], "seed": 9,
                   "realtime": False}


def _serve_doc(out, mesh=True):
    """Reduced Qwen's paged engine (and the static shim beside it) under
    ``plan: fsdp_tp``, with a one-device ``local`` mesh or none."""
    doc = {"run": {"kind": "serve", "name": "mesh_serve", "output_dir": out,
                   "serve": {"engine": True, "n_slots": 2, "max_len": 32,
                             "block_len": 8, "prefill_chunk": 8,
                             "bench_dir": "", "compare_static": True,
                             "sampling": {"temperature": 0.0},
                             "workload": dict(_SERVE_WORKLOAD)}},
           "arch": {"component_key": "arch_config",
                    "variant_key": "qwen1p5_0p5b",
                    "config": {"reduced": True}},
           "plan": {"component_key": "sharding_plan",
                    "variant_key": "fsdp_tp"}}
    if mesh:
        doc["mesh"] = {"component_key": "mesh_provider",
                       "variant_key": "local", "config": {"dp": 1, "tp": 1}}
    return doc


def test_serve_kind_plan_without_mesh_raises_jax_run_error(tmp_path):
    """JAX's ``execute_serve`` refuses a plan with no mesh (the run would
    serve unsharded without a word); the port raises the same error, in
    the same words, where it used to serve unsharded."""
    from repro.run import api as jax_api
    from repro.run.config import RunError as JaxRunError
    from repro_torch.run import api
    from repro_torch.run.config import RunError

    with pytest.raises(JaxRunError) as jerr:
        jax_api.execute_doc(_serve_doc(str(tmp_path / "j"), mesh=False),
                            write_files=False)
    with pytest.raises(RunError) as err:
        api.execute_doc(_serve_doc(str(tmp_path / "p"), mesh=False),
                        device="cpu", log=lambda m: None)
    assert str(err.value) == str(jerr.value)
    assert "names a sharding 'plan' but its 'mesh' entry" in str(err.value)


def test_serve_kind_under_a_mesh_matches_jax(models, mesh, tmp_path,
                                             monkeypatch):
    """``mesh: local {dp: 1, tp: 1}`` and ``plan: fsdp_tp``: both packages
    shard the engine and the static shim beside it on the same params
    (JAX's init); the result's ``plan``, hit rate and cached tokens
    ``==`` JAX's and the streams equal JAX's or part at a near-tie."""
    import repro.serve.engine as JE
    import repro_torch.serve.engine as PE
    from repro.run import api as jax_api
    from repro_torch.run import api

    m = models["qwen1p5_0p5b"]
    monkeypatch.setattr(JE, "load_params", lambda *a, **k: m["jp"])
    monkeypatch.setattr(PE, "load_params", lambda *a, **k: m["params"])
    jres = jax_api.execute_doc(_serve_doc(str(tmp_path / "j")),
                               write_files=False)
    res = api.execute_doc(_serve_doc(str(tmp_path / "p")), device="cpu",
                          log=lambda m: None)
    assert res["plan"] == jres["plan"] == "fsdp_tp"
    assert res["completed"] == jres["completed"] == 4
    assert res["prefill_cache_hit_rate"] == \
        jres["prefill_cache_hit_rate"] > 0
    assert ([r["cached_tokens"] for r in res["requests"]]
            == [r["cached_tokens"] for r in jres["requests"]])
    assert res["static_shim"]["decode_tokens"] == \
        jres["static_shim"]["decode_tokens"]
    w = dict(_SERVE_WORKLOAD)
    trace = shared_prefix_trace(w["n_requests"], m["model"].cfg.vocab,
                                prefix_len=w["prefix_len"], seed=w["seed"],
                                prompt_lens=w["prompt_lens"],
                                gen_tokens=w["gen_tokens"], max_len=32)
    _equal_or_tie(m["jm"], m["jp"], trace, _streams(res), _streams(jres))

"""The port's plan algebra (``repro_torch.sharding.plans``,
``repro_torch.launch.mesh``) against JAX's (``repro.sharding.plans``,
``repro.launch.mesh``), in pure Python: no process group, no device.

- Layouts: for every arch of ``ARCH_IDS``, every catalog plan and the
  stand-in meshes ``{data 16, model 16}``, ``{pod 2, data 16, model 16}``
  and ``{pipe 2, data 4, model 2}``, the port's ``leaf_spec`` of each leaf
  of the port's own param tree (its shapes on ``meta``) gives JAX's
  ``spec_to_json`` and JAX's warnings, in JAX's leaf order (``==``).
- Plans: ``custom_plan``'s errors, ``describe``, ``mesh_context`` (the pp
  mismatch included) and ``pipeline_info`` equal JAX's
  (``tests/test_parallel_plans.py:31-141``); the inline plan mapping
  normalises as JAX's; the mesh providers stay lazy and a mesh larger
  than the world raises JAX's words.
- The GPipe schedule, expert parallelism, sharded serving and
  post-training under a plan build: a pipe axis of the plan's extent
  gives JAX's pipelined context, an ep plan's train step, the MoE and MLA
  under a mesh, the engine under ``serve_ep``, LoRA's train step, its
  engine and ``load_adapter(shardings=)`` build, and since the rest of
  ROADMAP A8b the hybrid's, Whisper's and LLaVA's steps and a LoRA
  model's over Whisper (they raised naming A8b before).
"""
import functools

import jax
import pytest
import torch

from repro.configs import get_config as jax_get_config
from repro.launch import mesh as JMESH
from repro.models import build_model as jax_build_model
from repro.run.config import parse_run_doc as jax_parse_run_doc
from repro.sharding import pipeline as JPIPE
from repro.sharding import plans as JPL
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.launch import mesh as MESH
from repro_torch.models import base as B
from repro_torch.models import build_model
from repro_torch.run.config import parse_run_doc
from repro_torch.sharding import pipeline as PIPE
from repro_torch.sharding import plans as PL

MESHES = {
    "dm": {"data": 16, "model": 16},
    "pod": {"pod": 2, "data": 16, "model": 16},
    "pipe": {"pipe": 2, "data": 4, "model": 2},
}


class _FakeMesh:
    """A stand-in mesh: JAX's plan functions read only ``mesh.shape``."""

    def __init__(self, shape):
        self.shape = shape


def _plans(mesh_key):
    """(name, multi_pod) of every catalog plan a mesh is laid out under:
    both spellings on the pod mesh, the single-pod catalog elsewhere."""
    pods = (False, True) if mesh_key == "pod" else (False,)
    return [(name, mp) for name in PL.CATALOG for mp in pods]


@functools.lru_cache(maxsize=None)
def _jax_leaves(arch):
    model = jax_build_model(jax_get_config(arch))
    shapes = jax.eval_shape(model.init, jax.random.PRNGKey(0))
    paths = jax.tree_util.tree_flatten_with_path(shapes)[0]
    axes = jax.tree_util.tree_flatten(
        model.param_axes(), is_leaf=lambda t: isinstance(t, tuple))[0]
    return [(jax.tree_util.keystr(p), tuple(leaf.shape), ax)
            for (p, leaf), ax in zip(paths, axes)]


@functools.lru_cache(maxsize=None)
def _port_model(arch):
    model = build_model(get_config(arch))
    return model, model.init(MetaGenerator().manual_seed(0))


@pytest.mark.parametrize("mesh_key", sorted(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_leaf_specs_and_warnings_equal_jax(arch, mesh_key):
    model, shapes = _port_model(arch)
    jleaves = _jax_leaves(arch)
    mesh = _FakeMesh(MESHES[mesh_key])
    for name, multi_pod in _plans(mesh_key):
        jplan = JPL.make_plan(name, multi_pod)
        want_warn, want = [], []
        for path, shape, ax in jleaves:
            want.append((path, JPL.spec_to_json(
                JPL.leaf_spec(jplan, mesh, shape, ax, want_warn, path))))
        specs, warns = PL.param_specs(PL.make_plan(name, multi_pod),
                                      MESHES[mesh_key], shapes,
                                      model.param_axes())
        got = [(path, PL.spec_to_json(s)) for path, s in PL._flatten(specs)]
        assert got == want, (name, multi_pod)
        assert warns == want_warn, (name, multi_pod)


def test_leaf_spec_rules_equal_jax_on_jax_tests_shapes():
    """The cases of ``tests/test_sharding.py`` and
    ``tests/test_parallel_plans.py`` through both packages."""
    cases = [
        ("fsdp_tp", False, MESHES["dm"], (2048, 32, 64),
         (B.D_MODEL, B.HEADS, B.HEAD_DIM)),
        ("fsdp_tp", False, MESHES["dm"], (2048, 1, 64),
         (B.D_MODEL, B.KV_HEADS, B.HEAD_DIM)),
        ("fsdp_tp", False, MESHES["dm"], (24, 2048, 352),
         (B.LAYER, B.D_MODEL, B.D_FF)),
        ("fsdp_tp_ep", False, MESHES["dm"], (64, 2048, 1408),
         (B.EXPERTS, B.D_MODEL, B.D_EXPERT)),
        ("fsdp", True, MESHES["pod"], (8192, 4096), (B.D_MODEL, B.D_FF)),
        ("hsdp", True, MESHES["pod"], (8192, 4096), (B.D_MODEL, B.D_FF)),
        ("pp2_fsdp_tp", False, {"pipe": 2, "data": 2, "model": 2},
         (8, 64, 256), (B.LAYER, B.D_MODEL, B.D_FF)),
        ("pp2_fsdp_tp", False, {"pipe": 2, "data": 2, "model": 2},
         (3, 64, 256), (B.LAYER, B.D_MODEL, B.D_FF)),
        ("pp2_fsdp_tp", False, {"data": 4, "model": 2}, (8, 64, 256),
         (B.LAYER, B.D_MODEL, B.D_FF)),
        ("pp2_fsdp_tp_ep", False, {"pipe": 2, "data": 2, "model": 2},
         (4, 8, 64, 32), (B.LAYER, B.EXPERTS, B.D_MODEL, B.D_EXPERT)),
        ("fsdp", False, MESHES["dm"], (3, 2000), (None, B.D_MODEL)),
    ]
    for name, mp, sizes, shape, ax in cases:
        jw, pw = [], []
        want = JPL.leaf_spec(JPL.make_plan(name, mp), _FakeMesh(sizes), shape,
                             ax, jw, "leaf")
        got = PL.leaf_spec(PL.make_plan(name, mp), sizes, shape, ax, pw,
                           "leaf")
        assert PL.spec_to_json(got) == JPL.spec_to_json(want), (name, shape)
        assert tuple(got) == tuple(want) and pw == jw, (name, shape)
        back = PL.spec_from_json(PL.spec_to_json(got))
        assert tuple(back) == tuple(JPL.spec_from_json(
            JPL.spec_to_json(want)))


# ---------------------------------------------------------------------------
# the plan algebra
# ---------------------------------------------------------------------------
def _outcome(fn):
    try:
        return ("ok", fn())
    except Exception as e:  # the outcome under test
        return ("error", type(e).__name__, str(e))


CUSTOM_SPECS = [
    {"tp": True, "fsdp_axes": ["data"], "pp": 2, "n_micro": 4},
    "fsdp",
    {"tensor_parallel": True},
    {"tp": "yes"},
    {"pp": -1},
    {"pp": 0},
    {"n_micro": 1.5},
    {"fsdp_axes": [1, 2]},
    {"dp_axes": "data"},
    {"pp": 2, "pipe_axis": "data"},
    {"pipe_axis": 3},
    ["ddp"],
    {"ep": True, "ep_axes": ["data", "model"], "name": "mine"},
]


@pytest.mark.parametrize("spec", CUSTOM_SPECS, ids=[str(s)[:30] for s in
                                                    CUSTOM_SPECS])
def test_custom_plan_outcomes_equal_jax(spec):
    got, want = _outcome(lambda: PL.custom_plan(spec)), \
        _outcome(lambda: JPL.custom_plan(spec))
    if want[0] == "ok":
        assert got[0] == "ok"
        assert (dataclass_fields(got[1]) == dataclass_fields(want[1]))
        assert got[1].describe() == want[1].describe()
    else:
        assert got == want


def dataclass_fields(plan):
    import dataclasses

    return dataclasses.asdict(plan)


def test_catalog_describe_defaults_and_errors_equal_jax():
    for name in PL.CATALOG:
        for mp in (False, True):
            a, b = PL.make_plan(name, mp), JPL.make_plan(name, mp)
            assert dataclass_fields(a) == dataclass_fields(b)
            assert a.describe() == b.describe()
            for gb in (0, 1, 6, 8, 12):
                assert a.effective_n_micro(gb) == b.effective_n_micro(gb)
    assert _outcome(lambda: PL.make_plan("zero3")) == \
        _outcome(lambda: JPL.make_plan("zero3"))
    for arch in ("qwen1p5_0p5b", "deepseek_moe_16b"):
        for mp in (False, True):
            assert dataclass_fields(PL.default_plan_for(get_config(arch), mp)) \
                == dataclass_fields(JPL.default_plan_for(
                    jax_get_config(arch), mp))


def test_pipeline_arithmetic_equals_jax():
    for s in range(0, 5):
        for m in range(0, 9):
            assert _outcome(lambda: PIPE.bubble_fraction(s, m)) == \
                _outcome(lambda: JPIPE.bubble_fraction(s, m))
            for gb in (0, 1, 7, 8, 12):
                assert PIPE.effective_n_micro(m, s or 1, gb) == \
                    JPIPE.effective_n_micro(m, s or 1, gb)


def _ctx_fields(ctx):
    return (tuple(ctx.dp_axes), ctx.tp_axis, ctx.ep_enabled,
            tuple(ctx.ep_axes), ctx.pp, ctx.pipe_axis, ctx.n_micro)


@pytest.mark.parametrize("mesh_key", sorted(MESHES) + ["one", "pipe1"])
def test_mesh_context_and_pipeline_info_equal_jax(mesh_key):
    """JAX's ``mesh_context`` and ``pipeline_info`` on stand-in meshes (they
    read ``mesh.shape`` only).  A pp plan on a mesh without its pipe axis
    runs unpipelined in both; a pipe axis of the wrong extent raises JAX's
    ``ValueError``; one of the right extent is the GPipe schedule in both
    (a stand-in mesh has no process group: the port's context holds no
    pipe handles)."""
    sizes = {"one": {"data": 1, "model": 1},
             "pipe1": {"pipe": 1, "data": 1, "model": 1}}.get(
        mesh_key, MESHES.get(mesh_key))
    for name, mp in _plans(mesh_key):
        plan, jplan = PL.make_plan(name, mp), JPL.make_plan(name, mp)
        for gb in (0, 8, 12):
            assert PL.pipeline_info(plan, sizes, gb) == JPL.pipeline_info(
                jplan, _FakeMesh(sizes), gb)
        assert PL.pipeline_info(plan, None, 8) == JPL.pipeline_info(
            jplan, None, 8)
        want = _outcome(lambda: JPL.mesh_context(jplan, _FakeMesh(sizes)))
        got = _outcome(lambda: PL.mesh_context(plan, sizes))
        if want[0] == "error":
            assert got == want, name
        else:
            assert got[0] == "ok", (name, got)
            assert _ctx_fields(got[1]) == _ctx_fields(want[1]), name
            assert got[1].pipe is None


def test_inline_plan_mapping_normalizes_as_jax():
    """``tests/test_parallel_plans.py``'s documents, as train documents:
    the same graph in both."""
    for doc in (
            {"run": {"kind": "train", "name": "t"},
             "plan": {"tp": True, "pp": 2, "fsdp_axes": ["data"]},
             "gym": {"component_key": "gym", "variant_key": "standard",
                     "config": {"sharding_plan": {"pp": 2}}}},
            {"run": {"kind": "train"},
             "plan": {"component_key": "sharding_plan", "variant_key": "fsdp",
                      "config": {}},
             "gym": {"config": {"sharding_plan": {"instance_key": "plan"}}}},
            {"run": {"kind": "train"},
             "items": [{"plan": {"tp": True}}, {"sharding_plan": "ddp"}]}):
        got, want = parse_run_doc(doc), jax_parse_run_doc(doc)
        assert got.graph == want.graph
        assert got.doc == want.doc


def test_custom_plan_registry_variant_equals_jax():
    import repro.core.components  # noqa: F401  (registers JAX's catalog)
    from repro.config.registry import DEFAULT_REGISTRY as JREG
    from repro_torch.config.registry import DEFAULT_REGISTRY as REG
    from repro_torch.core.components import register_all

    register_all()
    kw = dict(tp=True, pp=2, n_micro=4)
    a, b = REG.build("sharding_plan", "custom", **kw), \
        JREG.build("sharding_plan", "custom", **kw)
    assert dataclass_fields(a) == dataclass_fields(b)
    for name in PL.CATALOG:
        assert dataclass_fields(REG.build("sharding_plan", name,
                                          multi_pod=True)) == \
            dataclass_fields(JREG.build("sharding_plan", name,
                                        multi_pod=True))


def test_mesh_providers_are_lazy_and_never_shrink():
    """Constructing a provider touches no process group; ``build`` makes
    the mesh once; a mesh larger than the world raises JAX's words (a
    device here is a rank); the single-device provider builds no mesh."""
    import torch.distributed as dist

    providers = [MESH.LocalMesh(dp=2, tp=2), MESH.ProductionMesh(),
                 MESH.ProductionMesh(multi_pod=True), MESH.SplitMesh(4, 2)]
    assert not dist.is_initialized()
    assert MESH.SingleDeviceMesh().build("cpu") is None
    assert JMESH.SingleDeviceMesh().build() is None
    got = _outcome(lambda: MESH.make_local_mesh(2, 2, device_type="cpu"))
    want = _outcome(lambda: JMESH.make_local_mesh(2, 2))
    assert got[2] == want[2] == "need 4 devices, have 1"
    got = _outcome(lambda: providers[3].build("cpu"))
    want = _outcome(lambda: JMESH.SplitMesh(4, 2).build())
    assert got[:3] == want[:3]
    got = _outcome(lambda: providers[1].build("cpu"))
    assert got[:2] == ("error", "RuntimeError")
    assert got[2].startswith("need 256 devices for the production mesh, "
                             "have 1")
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the GPipe schedule, expert parallelism and the rest of ROADMAP A8b: every
# model the port builds runs under a mesh
# ---------------------------------------------------------------------------
def _fake_ctx(**kw):
    return B.MeshContext(mesh=_FakeMesh({"data": 2, "model": 2}),
                         dp_axes=("data",), **kw)


def _batch_for(cfg, B_=2, S=16):
    """Seeded tokens and labels, with the encoder's frames or the patch
    prefix where the arch reads them."""
    import numpy as np

    rng = np.random.default_rng(1)
    toks = rng.integers(3, cfg.vocab, (B_, S))
    out = {"tokens": toks.astype(np.int32),
           "labels": np.roll(toks, -1, 1).astype(np.int32)}
    if cfg.arch_type == "audio":
        out["frames"] = rng.standard_normal(
            (B_, cfg.encoder_frames, cfg.d_model)).astype(np.float32)
    if cfg.n_patches:
        out["patch_embeds"] = rng.standard_normal(
            (B_, cfg.n_patches, cfg.d_model)).astype(np.float32)
    return {k: torch.as_tensor(v) for k, v in out.items()}


def _step_losses(model, opt, plan_name):
    """One train step's loss from the seed-0 init with no mesh, then under
    ``plan_name`` on a one-rank ``(1, 1)`` mesh (a gloo group of one, as
    the card runs a plan; taken down after), with its params laid out by
    the plan.  At world size 1 every op runs on whole blocks, so the two
    losses are ``==``."""
    from repro_torch.train import steps as ST

    batch = _batch_for(model.cfg)
    losses = []
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cpu")
        for plan in (None, PL.make_plan(plan_name)):
            state = ST.init_train_state(model, opt,
                                        torch.Generator().manual_seed(0))
            b, ctx = batch, None
            if plan is not None:
                sh, _ = PL.train_state_shardings(plan, mesh, model, opt)
                state = PL.distribute(state, sh)
                b = PL.distribute(batch, PL.batch_shardings(plan, mesh,
                                                            batch))
                ctx = PL.mesh_context(plan, mesh)
            _, m = ST.make_train_step(model, opt, ctx)(state, b)
            losses.append(float(m["loss"]))
    finally:
        MESH.shutdown()
    return losses


def test_ep_and_lora_training_and_sharded_serving_name_a8b(tmp_path):
    """An ep plan's train step builds (expert parallelism trains:
    ``tests/test_torch_pp_train.py``), and so does the engine under
    ``serve_ep`` on a one-device mesh (sharded serving:
    ``tests/test_torch_mesh_serve.py``): its params DTensors, its MoE
    through expert parallelism.  LoRA under a plan builds too
    (``tests/test_torch_lora_mesh.py``): its train step, its engine (the
    adapters DTensors beside the base) and ``load_adapter(shardings=)``
    (the adapter a DTensor with the given placements).  A LoRA model over
    Whisper's encoder-decoder builds its step too (JAX's LoRA is
    model-agnostic; Whisper under a plan: ``tests/test_torch_mm_mesh.py``):
    its step under ``fsdp_tp`` on a one-rank mesh gives the no-mesh step's
    loss, where it raised naming A8b before the hybrid, Whisper and LLaVA
    ran under a mesh."""
    from torch.distributed.tensor import DTensor

    from repro_torch.ckpt import write_checkpoint
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.optim.adamw import AdamW
    from repro_torch.posttrain import lora as LO
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import steps as ST
    from repro_torch.tree import tree_leaves

    model = build_model(get_reduced("qwen1p5_0p5b"))
    for arch in ("qwen1p5_0p5b", "deepseek_moe_16b"):
        assert callable(ST.make_train_step(
            build_model(get_reduced(arch)), AdamW(),
            _fake_ctx(tp_axis="model", ep_enabled=True)))
    frozen = LO.FrozenBaseOptimizer(AdamW())
    lora = LO.LoRAModel(model, LO.LoRAConfig())
    assert callable(ST.make_train_step(lora, frozen, _fake_ctx()))
    whisper = build_model(get_reduced("whisper_tiny"))
    assert isinstance(whisper, EncDecLM)
    plain, laid = _step_losses(LO.LoRAModel(whisper, LO.LoRAConfig()),
                               frozen, "fsdp_tp")
    assert plain == laid and plain > 0
    moe = build_model(get_reduced("deepseek_moe_16b"))
    plan = PL.make_plan("serve_ep")
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cpu")
        eng = ServeEngine(moe, moe.init(torch.Generator().manual_seed(0)),
                          n_slots=1, max_len=8, mesh=mesh, plan=plan)
        assert all(isinstance(t, DTensor) for t in tree_leaves(eng.params))
        assert eng.mesh_ctx.ep_enabled and eng.mesh_ctx.ep_axes == \
            ("data", "model")
        eng = ServeEngine(lora, lora.init(torch.Generator().manual_seed(0)),
                          n_slots=1, max_len=8, mesh=mesh, plan=plan)
        assert all(isinstance(t, DTensor) for t in tree_leaves(
            eng.params[LO.ADAPTER_KEY]))
        path = write_checkpoint(str(tmp_path), 1,
                                {f"params/{LO.ADAPTER_KEY}/a":
                                 torch.arange(2.0)})
        sh = PL.NamedSharding(mesh, PL.P("data"))
        got = LO.load_adapter({LO.ADAPTER_KEY: {"a": torch.zeros(2)}}, path,
                              shardings={LO.ADAPTER_KEY: {"a": sh}})
        a = got[LO.ADAPTER_KEY]["a"]
        assert isinstance(a, DTensor) and list(a.placements) == \
            sh.placements
        assert torch.equal(a.full_tensor(), torch.arange(2.0))
    finally:
        MESH.shutdown()


@pytest.mark.parametrize("arch", ["deepseek_moe_16b", "deepseek_v3_671b",
                                  "zamba2_2p7b", "whisper_tiny",
                                  "llava_next_34b"])
def test_non_dense_archs_under_a_mesh_name_a8b(arch):
    """The MoE and MLA (DeepSeek-V3, its MTP head too) train under a mesh
    (``tests/test_torch_mla_mesh.py``), and since the last part of ROADMAP
    A8b so do the hybrid, Whisper and LLaVA, which raised naming A8b
    before (``tests/test_torch_hybrid_mesh.py``,
    ``tests/test_torch_mm_mesh.py``): one step of each under ``fsdp_tp``
    on a one-rank mesh gives the no-mesh step's loss."""
    from repro_torch.optim.adamw import AdamW

    plain, laid = _step_losses(build_model(get_reduced(arch)),
                               AdamW(lr=1e-3), "fsdp_tp")
    assert plain == laid and plain > 0


def test_pipe_axis_training_names_a8b():
    """A pp plan on a mesh that carries its pipe axis is the GPipe
    schedule: ``mesh_context`` (the gym's first call under a mesh) builds
    JAX's pipelined context, for every pp plan of the catalog and a custom
    one with ``n_micro``."""
    sizes = {"pipe": 2, "data": 2, "model": 2}
    plans = [(PL.make_plan(n), JPL.make_plan(n))
             for n in ("pp2_fsdp", "pp2_fsdp_tp", "pp2_fsdp_tp_ep")]
    kw = dict(fsdp_axes=["data"], pp=2, n_micro=4)
    plans.append((PL.custom_plan(dict(kw)), JPL.custom_plan(dict(kw))))
    for plan, jplan in plans:
        ctx = PL.mesh_context(plan, sizes)
        jctx = JPL.mesh_context(jplan, _FakeMesh(sizes))
        assert ctx.pp == 2 and ctx.pipe_axis == "pipe"
        assert _ctx_fields(ctx) == _ctx_fields(jctx), plan.name
        stage = ctx.stage_context()
        assert (stage.pp, stage.pipe_axis, stage.pipe) == (1, None, None)

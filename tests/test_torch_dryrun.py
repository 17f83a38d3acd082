"""The port's dryrun (``repro_torch.launch.dryrun``,
``repro_torch.launch.hlo_analysis``) against JAX's
(``repro.launch.dryrun``), on the CPU.

- ``compile_run`` through both run APIs on a reduced Qwen train step and
  a reduced Mamba2 prefill on a ``local`` 1 x 1 mesh under ``ddp`` (JAX's
  ``tests/test_run_api.py:201`` document): ``chips``, ``mesh``, ``plan``,
  ``model_flops_global``, ``n_params``, ``n_params_active``, ``pipeline``,
  ``sharding_warnings`` and ``mem_argument_size_in_bytes`` ``==``; the
  per-device FLOPs within ``FLOPS_TOL`` of JAX's.
- The Whisper x ``long_500k`` skip record ``==`` JAX's, with no process
  group started; full-width Qwen's ``decode_32k`` and ``long_500k``,
  DeepSeekMoE's, DeepSeek-V3's and Whisper's ``train_4k`` and the
  hybrid's ``prefill_32k`` dry-run on 256 fake ranks (the reduced
  decode cases against JAX: ``tests/test_torch_dryrun_decode.py``;
  reduced DeepSeek-V3's: ``tests/test_torch_mla_mesh.py``).
- A reduced MoE under ``fsdp_tp_ep`` against JAX's dryrun on 8 forced
  devices (keys and ``EQUAL_KEYS``) and a reduced StableLM under
  ``pp2_fsdp_tp`` on a fake world of 256 ranks (JAX's keys, plan and
  pipeline record), the EP collectives and the pipe shift counted.
- On a fake 2 x 2 world, each plan's collectives against the traffic its
  layouts imply.
- The kernel ops on ``meta``: shapes, dtypes, no launch, and FLOP formulas
  ``==`` the plain versions' matmul FLOPs; a step run on the CPU counts
  exactly what its dryrun on ``meta`` counts.
- The fake world: a one-rank group of the port's own is taken down first,
  a launcher's refuses, nothing outlives the dryrun.
"""
import math

import pytest
import torch
import torch.distributed as dist

from repro.run import api as jax_api
from test_torch_trace import jax_launch_module
from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import InputShape
from repro_torch.device import MetaGenerator
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch.hlo_analysis import CostCounter
from repro_torch.models import build_model
from repro_torch.run import api
from repro_torch.sharding import plans as PL
from repro_torch.tree import tree_leaves

#: the port's per-device FLOPs over JAX's, minus one, lie in [0, FLOPS_TOL].
#: Both count 2·M·N·K for every matmul of the same step; the port also
#: counts 1 FLOP per output element of every elementwise op of JAX's set,
#: where JAX counts only those XLA leaves unfused (its walk skips fusion
#: bodies).  Measured on this CPU: +2.68% for the Qwen train step, +1.31%
#: for the Mamba2 prefill, never below JAX's.
FLOPS_TOL = 0.05

#: the keys of JAX's result the port reproduces exactly
EQUAL_KEYS = ("chips", "mesh", "plan", "model_flops_global", "n_params",
              "n_params_active", "pipeline", "sharding_warnings",
              "mem_argument_size_in_bytes")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small: one thread for this module (the suite's
    workers share the host's cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def _doc(arch, shape, out, mesh=None, plan="ddp", kind="dryrun"):
    return {
        "run": {"kind": kind, "name": "d", "output_dir": out},
        "arch": {"component_key": "arch_config", "variant_key": arch,
                 "config": {"reduced": True}},
        "shape": {"component_key": "shape", "variant_key": "custom",
                  "config": shape},
        "mesh": {"component_key": "mesh_provider", "variant_key": "local",
                 "config": mesh or {"dp": 1, "tp": 1}},
        "plan": {"component_key": "sharding_plan", "variant_key": plan},
    }


CASES = {
    "train-qwen": ("qwen1p5_0p5b",
                   {"seq_len": 64, "global_batch": 2, "kind": "train"}),
    "prefill-mamba2": ("mamba2_780m",
                       {"seq_len": 128, "global_batch": 2,
                        "kind": "prefill"}),
}


@pytest.mark.parametrize("case", list(CASES))
def test_compile_run_matches_jax(tmp_path, case):
    jax_launch_module("dryrun")
    arch, shape = CASES[case]
    jres = jax_api.execute_doc(_doc(arch, shape, str(tmp_path / "j")),
                               write_files=False)
    res = api.execute_doc(_doc(arch, shape, str(tmp_path / "p")),
                          device="cpu", log=_quiet)
    for key in EQUAL_KEYS:
        assert res[key] == jres[key], key
    gap = res["hlo_flops_per_dev"] / jres["hlo_flops_per_dev"] - 1
    assert 0 <= gap <= FLOPS_TOL, gap
    # JAX's keys, but the two torch cannot give
    missing = {"xla_cost_flops_unscaled", "mem_generated_code_size_in_bytes"}
    assert set(jres) - set(res) == missing
    assert set(res) == set(jres) - missing
    assert res["compute_term_s"] == res["hlo_flops_per_dev"] / 989.4e12
    assert res["dominant_term"] in ("compute", "memory", "collective")
    assert not dist.is_initialized()


def test_whisper_long_500k_skip_record_starts_no_group(tmp_path, monkeypatch):
    """JAX's skip record, returned before any mesh or process group."""
    doc = {
        "run": {"kind": "dryrun", "name": "skip",
                "output_dir": str(tmp_path / "skip")},
        "arch": {"component_key": "arch_config",
                 "variant_key": "whisper_tiny"},
        "shape": {"component_key": "shape", "variant_key": "long_500k"},
        "mesh": {"component_key": "mesh_provider",
                 "variant_key": "production"},
    }

    def no_world(n):
        raise AssertionError(f"a fake world of {n} ranks was started")

    monkeypatch.setattr(MESH, "fake_world", no_world)
    jax_launch_module("dryrun")
    jres = jax_api.execute_doc(doc, write_files=False)
    res = api.execute_doc(doc, device="cpu", log=_quiet)
    for key in ("arch", "shape", "skipped"):
        assert res[key] == jres[key], key
    assert set(res) - {"kind", "fingerprint", "output_dir"} == \
        {"arch", "shape", "skipped"}
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch,shape", [
    ("qwen1p5_0p5b", "decode_32k"),
    ("qwen1p5_0p5b", "long_500k"),
    ("deepseek_moe_16b", "train_4k"),
    ("deepseek_v3_671b", "train_4k"),
    ("zamba2_2p7b", "prefill_32k"),
    ("whisper_tiny", "train_4k"),
])
def test_later_slices_raise_naming_a8b(tmp_path, arch, shape,
                                       jax_a8b):
    """The archs of the later slices dry-run on the production mesh's fake
    world of 256 ranks, with JAX's result keys, and leave no process
    group: full-width Qwen's decode shapes under its default plan,
    ``fsdp_tp`` (``long_500k`` on the window of 8192 that
    ``specs.adapt_config`` sets: its cache of one row has the sequence
    over ``data``); DeepSeekMoE's and DeepSeek-V3's (MLA, 256 experts, the
    MTP head) ``train_4k`` under their default plan, ``fsdp_tp_ep`` (full
    width), DeepSeek-V3's ``model_flops_global`` JAX's 6·N·D of its active
    params; and the hybrid's ``prefill_32k`` and Whisper's ``train_4k``
    under ``fsdp_tp``, which raised naming ROADMAP A8b before the last
    part of A8b (``tests/test_torch_hybrid_mesh.py``,
    ``tests/test_torch_mm_mesh.py``)."""
    doc = {"run": {"kind": "dryrun", "name": "a8b",
                   "output_dir": str(tmp_path / "a8b")},
           "arch": {"component_key": "arch_config", "variant_key": arch},
           "shape": {"component_key": "shape", "variant_key": shape}}
    missing = {"xla_cost_flops_unscaled", "mem_generated_code_size_in_bytes"}
    if shape in ("decode_32k", "long_500k"):
        res = api.execute_doc(doc, device="cpu", log=_quiet)
        assert set(res) == set(jax_a8b["moe-fsdp_tp_ep"]["keys"]) - missing
        assert res["plan"] == "fsdp_tp(dp=data; fsdp=data; tp=model)"
        assert res["chips"] == 256 and res["sharding_warnings"] == []
        # the cache of 24 layers, K 16 heads of 64 in bf16: 128 rows of
        # 32,768 over data (16) and heads over model (16), or one row of
        # the window's 8,192 with the sequence over data
        cache = (128 // 16 * 32768 if shape == "decode_32k" else 8192 // 16)
        assert res["mem_argument_size_in_bytes"] > \
            2 * 24 * cache * (16 // 16) * 64 * 2
        assert res["collective_counts"]["all-gather"] > 0
        assert not dist.is_initialized()
        return
    res = api.execute_doc(doc, device="cpu", log=_quiet)
    assert set(res) == set(jax_a8b["moe-fsdp_tp_ep"]["keys"]) - missing
    assert res["chips"] == 256
    assert res["collective_counts"]["all-gather"] > 0
    if arch in ("deepseek_moe_16b", "deepseek_v3_671b"):
        assert res["plan"] == ("fsdp_tp_ep(dp=data; fsdp=data; tp=model; "
                               "ep=model+storage=data)")
        assert res["sharding_warnings"] == []
        if arch == "deepseek_v3_671b":
            assert res["model_flops_global"] == \
                6 * res["n_params_active"] * 256 * 4096
    else:
        assert res["plan"] == "fsdp_tp(dp=data; fsdp=data; tp=model)"
        assert res["hlo_flops_per_dev"] > 0
        # Zamba2's conv and norm leaves, Whisper's 6 heads and odd vocab
        assert res["sharding_warnings"]
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# a fake 2 x 2 world: collectives against the plans' layouts
# ---------------------------------------------------------------------------
def _implied(cfg, plan_name, sizes):
    """The parameter traffic a plan's layouts imply for one train step,
    per device, in ``hlo_analysis``'s conventions: a leaf sharded over
    ``data`` is all-gathered at its (TP-)local size once per use (the
    stacked leaves twice: the forward and ``remat: full``'s recompute) and
    its f32 gradient reduce-scattered; a leaf replicated over ``data`` has
    its gradient all-reduced (counted twice)."""
    model = build_model(cfg)
    params = model.init(MetaGenerator())
    specs, _ = PL.param_specs(PL.make_plan(plan_name), sizes, params,
                              model.param_axes())
    stacks = {name for name, _, _ in model._stacks()}
    out = {"all-gather": 0, "reduce-scatter": 0, "all-reduce": 0}
    for name in params:
        for leaf, spec in zip(tree_leaves(params[name]),
                              tree_leaves(specs[name])):
            axes = [a for e in spec if e is not None
                    for a in (e if isinstance(e, tuple) else (e,))]
            nbytes = leaf.numel() * 4 // math.prod(
                sizes[a] for a in axes if a != "data")
            if "data" in axes:
                out["all-gather"] += nbytes * (2 if name in stacks else 1)
                out["reduce-scatter"] += nbytes
            else:
                out["all-reduce"] += 2 * nbytes
    return out


@pytest.mark.parametrize("plan", ["ddp", "fsdp", "fsdp_tp"])
def test_fake_2x2_collectives_match_the_plan_layouts(plan):
    """``ddp`` and ``fsdp`` move exactly the parameter traffic their
    layouts imply, plus the 4-byte metrics' all-reduces; ``fsdp_tp`` moves
    at least its parameter traffic, and the tensor-parallel all-reduces of
    the residual stream (batch 2 x 32 x 256 bf16 per device) on top."""
    cfg = get_reduced("qwen1p5_0p5b")
    shape = InputShape("t", 32, 4, "train")
    res = DR.compile_run(cfg, shape, MESH.LocalMesh(2, 2),
                         PL.make_plan(plan), keep_messages=True)
    got = res["collective_per_kind"]
    want = _implied(cfg, plan, {"data": 2, "model": 2})
    n_metrics = sum(n for k, b, n in res["messages"]
                    if (k, b) == ("all-reduce", 4))
    assert res["chips"] == 4 and res["mesh"] == "2x2"
    if plan == "fsdp_tp":
        for kind in ("all-gather", "reduce-scatter"):
            assert got[kind] >= want[kind], kind
        resid = 2 * 32 * cfg.d_model * 2
        assert ("all-reduce", resid) in {(k, b) for k, b, _ in
                                         res["messages"]}
        return
    for kind in ("all-gather", "reduce-scatter"):
        assert got[kind] == want[kind], kind
    assert got["all-reduce"] == want["all-reduce"] + 2 * 4 * n_metrics
    assert got["all-to-all"] == got["collective-permute"] == 0
    assert not dist.is_initialized()


# ---------------------------------------------------------------------------
# the kernels on meta, and a CPU step against its dryrun
# ---------------------------------------------------------------------------
def test_kernel_ops_fake_and_flop_formulas():
    """Each kernel's custom op on ``meta`` makes its outputs' shapes and
    dtypes and launches nothing; its FLOP formula equals the matmul FLOPs
    of its plain version at the same shapes, and the dryrun's counter
    charges a call its formula on the CPU as on ``meta``."""
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.kernels.flash import ops as FO
    from repro_torch.kernels.flash.ref import attention_ref
    from repro_torch.kernels.ssd import ops as SO
    from repro_torch.kernels.ssd.ref import ssd_chunked

    g = torch.Generator().manual_seed(0)
    q = torch.randn(2, 96, 8, 32, generator=g)
    k, v = (torch.randn(2, 96, 2, 32, generator=g) for _ in "kv")
    with FlopCounterMode(display=False) as fc:
        attention_ref(q, k, v)
    want = FO.flash_fwd_flops(q.shape, k.shape)
    assert fc.get_total_flops() == want == 4 * 2 * 8 * 96 * 96 * 32
    Bq, S, H, P, G, N, Q = 2, 256, 4, 16, 2, 8, 64
    x = torch.randn(Bq, S, H, P, generator=g)
    dt = torch.rand(Bq, S, H, generator=g)
    A, D = -torch.rand(H, generator=g), torch.randn(H, generator=g)
    Bm, Cm = (torch.randn(Bq, S, G, N, generator=g) for _ in "BC")
    with FlopCounterMode(display=False) as fc:
        ssd_chunked(x, dt, A, Bm, Cm, D, chunk=Q)
    assert fc.get_total_flops() == SO.ssd_scan_flops(x.shape, Bm.shape, Q)

    launches = FO.launches, SO.launches
    for device in ("cpu", "meta"):
        fa = [t.to(device) for t in (q, k, v)]
        sa = [t.to(device) for t in (x, dt, A, Bm, Cm, D)]
        with CostCounter() as c:
            o = FO.flash_attention(*fa)
            y, h = SO.ssd_scan(*sa, chunk=Q)
        assert c.flops == want + SO.ssd_scan_flops(x.shape, Bm.shape, Q)
        assert (o.shape, o.dtype, o.device.type) == \
            (q.shape, q.dtype, device)
        assert (y.shape, y.dtype, h.shape, h.dtype, y.device.type) == \
            (x.shape, x.dtype, (Bq, H, P, N), torch.float32, device)
    assert (FO.launches, SO.launches) == launches
    # the backward recomputes through the plain version on meta too
    qm = q.to("meta").requires_grad_(True)
    FO.flash_attention(qm, k.to("meta"), v.to("meta")).sum().backward()
    assert qm.grad.shape == q.shape and qm.grad.device.type == "meta"


@pytest.mark.parametrize("arch,flash", [("qwen1p5_0p5b", True),
                                        ("mamba2_780m", False)])
def test_cpu_step_counts_what_its_dryrun_counts(arch, flash):
    """The card's check on the CPU: one train step run on real tensors
    under the dryrun's counter (a one-rank gloo group, a 1 x 1 mesh)
    counts the FLOPs, bytes and collectives its dryrun on ``meta`` counts,
    and holds the argument bytes the dryrun reports."""
    cfg = get_reduced(arch).with_(use_flash_kernel=flash)
    shape = InputShape("card", 128, 2, "train")
    plan = PL.make_plan("ddp")
    dry = DR.compile_run(cfg, shape, MESH.LocalMesh(1, 1), plan)
    try:
        mesh = MESH.make_local_mesh(1, 1, device_type="cpu")
        setup = DR.build_step(build_model(cfg), shape, mesh, plan,
                              device="cpu")
        with CostCounter(arguments=setup.args) as c:
            out = setup.fn(*setup.args)
        ana, mem = c.analyze(), c.memory(setup.args, out)
    finally:
        MESH.shutdown()
    assert ana["flops"] == dry["hlo_flops_per_dev"]
    assert ana["bytes"] == dry["hlo_bytes_per_dev"]
    assert ana["collective_counts"] == dry["collective_counts"]
    assert mem["mem_argument_size_in_bytes"] == \
        dry["mem_argument_size_in_bytes"]
    assert math.isfinite(float(out[1]["loss"]))


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------
def test_fake_world_takes_down_the_ports_own_group_and_nothing_outlives():
    mesh = MESH.make_local_mesh(1, 1, device_type="cpu")   # our own group
    assert mesh.size() == 1 and dist.is_initialized()
    cfg = get_reduced("qwen1p5_0p5b")
    res = DR.compile_run(cfg, InputShape("t", 32, 2, "train"),
                         MESH.LocalMesh(1, 2), PL.make_plan("fsdp_tp"))
    assert res["chips"] == 2 and not dist.is_initialized()
    with MESH.fake_world(512):
        assert dist.get_world_size() == 512 and dist.get_backend() == "fake"
        mesh = MESH.make_production_mesh(multi_pod=True,
                                         device_type=MESH.FAKE_DEVICE_TYPE)
        assert tuple(mesh.shape) == (2, 16, 16)
    assert not dist.is_initialized()


def test_fake_world_refuses_a_launchers_group(tmp_path):
    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("gloo", store=store, rank=0, world_size=1)
    try:
        with pytest.raises(RuntimeError, match="a launcher's"):
            with MESH.fake_world(4):
                pass
        assert dist.get_backend() == "gloo"
    finally:
        dist.destroy_process_group()


def test_dryrun_modules_never_import_jax_or_repro():
    """The modules this slice adds import neither JAX nor the JAX
    package."""
    import os
    import re

    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    for rel in ("launch/dryrun.py", "launch/hlo_analysis.py",
                "launch/specs.py", "launch/trace.py", "launch/mesh.py"):
        with open(os.path.join(root, rel)) as f:
            text = f.read()
        assert not re.search(r"^\s*(from|import) (repro|jax)\b", text,
                             re.M), rel


# ---------------------------------------------------------------------------
# the MoE under expert parallelism and a dense arch under the GPipe
# schedule
# ---------------------------------------------------------------------------
#: (arch, JAX's mesh of 8 devices, the port's mesh, plan), reduced, train
#: 16 x 64: the MoE on JAX's mesh (its full width on 256 ranks is
#: ``test_later_slices_raise_naming_a8b``'s), the pipelined StableLM on a
#: fake world of 256 ranks
A8B_TRAINING = {
    "moe-fsdp_tp_ep": ("deepseek_moe_16b", {"dp": 2, "tp": 4},
                       {"dp": 2, "tp": 4}, "fsdp_tp_ep"),
    "stablelm-pp2_fsdp_tp": ("stablelm_1p6b", {"dp": 2, "tp": 2, "pp": 2},
                             {"dp": 8, "tp": 16, "pp": 2}, "pp2_fsdp_tp"),
}
_A8B_SHAPE = {"seq_len": 64, "global_batch": 16, "kind": "train"}

_JAX_A8B = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
from repro.run import api
import test_torch_dryrun as T
out = {}
for case, (arch, mesh, _, plan) in T.A8B_TRAINING.items():
    res = api.execute_doc(T._doc(arch, T._A8B_SHAPE, sys.argv[3] + "/" + case,
                                 mesh=mesh, plan=plan), write_files=False)
    out[case] = {"keys": sorted(res),
                 "equal": {k: res[k] for k in T.EQUAL_KEYS}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_a8b(tmp_path_factory):
    """JAX's dryruns of the two cases on 8 forced host devices, in a
    subprocess (this process's JAX has one device)."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX_A8B, os.path.join(here, "..", "src"),
         here, str(tmp_path_factory.mktemp("jax_a8b"))],
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("case", list(A8B_TRAINING))
def test_ep_and_pipelined_dryruns_match_jax(tmp_path, case, jax_a8b):
    """A reduced DeepSeekMoE train step under ``fsdp_tp_ep`` on JAX's 2 x
    4 mesh: JAX's keys and its ``EQUAL_KEYS`` values (the plan, the
    ``pipeline`` record, the warnings, the argument bytes).  A reduced
    StableLM under ``pp2_fsdp_tp`` on a fake world of 256 ranks (2 x 8 x 16
    ``(pipe, data, model)``): JAX's keys, plan and ``pipeline`` record
    (JAX's on 2 x 2 x 2).  EP's all-gather of the experts' stored
    ``d_model`` shards and its reduction of the partial sums are counted;
    the pipe shift is counted as ``all-to-all`` (``all_to_all_single``
    with one non-empty split, where JAX's is a ``collective-permute``): S +
    M - 2 shifts in the forward and as many in the backward."""
    arch, jax_mesh, mesh, plan = A8B_TRAINING[case]
    want = jax_a8b[case]
    missing = {"xla_cost_flops_unscaled", "mem_generated_code_size_in_bytes"}
    res = api.execute_doc(_doc(arch, _A8B_SHAPE, str(tmp_path / "p"),
                               mesh=mesh, plan=plan), device="cpu", log=_quiet)
    assert set(res) == set(want["keys"]) - missing
    same = EQUAL_KEYS if mesh == jax_mesh else ("plan", "pipeline")
    for key in same:
        assert res[key] == want["equal"][key], (key, res[key])
    counts = res["collective_counts"]
    if "pp" in mesh:
        info = res["pipeline"]
        assert res["chips"] == 256
        assert info["pp"] == 2 and info["n_micro"] == 4
        assert counts["all-to-all"] >= 2 * (info["pp"] + info["n_micro"] - 2)
    else:
        assert counts["all-gather"] > 0 and counts["all-reduce"] > 0
    assert not dist.is_initialized()

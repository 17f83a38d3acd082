"""The port's trace, input specs, dryrun components, shims and the three
dryrun documents (``repro_torch.launch.trace``, ``launch.specs``,
``shape``/``precision`` components, ``launch.dryrun``/``launch.trace``
shims, the CLI) against JAX's, on the CPU.

- ``shape/*``, ``shape/custom`` and ``precision/policy`` build JAX's values.
- ``input_specs`` (after ``adapt_config``) gives JAX's shapes and dtypes for
  every arch x shape, the decode caches on ``meta`` included.
- ``format_schedule`` of one result ``==`` JAX's text with the port's
  ``ALPHA``/``BW`` set to JAX's values.
- The deprecated shims build JAX's documents (``legacy_dryrun_doc``).
- ``dryrun.yaml`` and ``trace.yaml`` run through the CLI at reduced width on
  their 256-rank production mesh; JAX's ``fsdp_tp`` dryrun on 4 forced
  host devices (a subprocess) against the port's on a fake 2 x 2 world.
"""
import dataclasses
import importlib
import json
import os
import subprocess
import sys

import jax
import pytest
import torch
import torch.distributed as dist

import repro.core.components as jax_components
from repro.config.registry import DEFAULT_REGISTRY as JAX_REGISTRY
from repro.configs import get_config as jax_get_config
from repro.launch import specs as JSP
from repro.models import build_model as jax_build_model
from repro.run.legacy import legacy_dryrun_doc as jax_legacy_dryrun_doc
from repro_torch.config.registry import DEFAULT_REGISTRY as REGISTRY
from repro_torch.configs import ARCH_IDS, get_config, get_reduced
from repro_torch.configs.shapes import SHAPES, InputShape
from repro_torch.core.components import register_all
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch import specs as SP
from repro_torch.launch import trace as TRACE
from repro_torch.models import build_model
from repro_torch.run import api
from repro_torch.run.cli import main as cli_main
from repro_torch.sharding import plans as PL

ROOT = os.path.join(os.path.dirname(__file__), "..")
CONFIGS = os.path.join(ROOT, "examples", "configs")
SRC = os.path.abspath(os.path.join(ROOT, "src"))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The shapes here are small or on ``meta``: one thread for this module
    (the suite's workers share the host's cores), restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def jax_launch_module(name):
    """JAX's ``repro.launch.<name>``, imported without moving this worker's
    JAX off the one host device the suite gives it: the module sets
    ``XLA_FLAGS`` to force 512 devices when imported, so JAX's backend
    starts first and the variable is restored after."""
    flags = os.environ.get("XLA_FLAGS")
    jax.devices()
    try:
        return importlib.import_module(f"repro.launch.{name}")
    finally:
        if flags is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = flags


# ---------------------------------------------------------------------------
# components and input specs
# ---------------------------------------------------------------------------
def test_shape_and_precision_components_match_jax():
    register_all()
    jax_components.register_all()
    for key in ("shape", "precision"):
        assert REGISTRY.variants(key) == JAX_REGISTRY.variants(key), key
    for name in SHAPES:
        assert dataclasses.asdict(REGISTRY.build("shape", name)) == \
            dataclasses.asdict(JAX_REGISTRY.build("shape", name))
    kw = dict(seq_len=64, global_batch=2, kind="prefill", name="p")
    assert dataclasses.asdict(REGISTRY.build("shape", "custom", **kw)) == \
        dataclasses.asdict(JAX_REGISTRY.build("shape", "custom", **kw))
    with pytest.raises(ValueError) as ours:
        REGISTRY.build("shape", "custom", seq_len=1, global_batch=1,
                       kind="serve")
    with pytest.raises(ValueError) as theirs:
        JAX_REGISTRY.build("shape", "custom", seq_len=1, global_batch=1,
                           kind="serve")
    assert str(ours.value) == str(theirs.value)
    kw = dict(bf16_params=True, serve_bf16=False)
    assert dataclasses.asdict(REGISTRY.build("precision", "policy", **kw)) \
        == dataclasses.asdict(JAX_REGISTRY.build("precision", "policy", **kw))


def _spec_rows(tree, path=""):
    """``{path: (shape, dtype name)}`` of a tree of ``meta`` tensors or
    ``ShapeDtypeStruct``s."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_spec_rows(v, f"{path}/{k}"))
        return out
    return {path: (tuple(tree.shape), str(tree.dtype).replace("torch.", ""))}


ARCHS = ARCH_IDS + ["llama3_8b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_jax(arch):
    """Every shape of one arch: the adapted config, the skip verdict and
    the inputs' shapes and dtypes (``meta`` tensors vs
    ``ShapeDtypeStruct``s)."""
    for shape in SHAPES.values():
        cfg = SP.adapt_config(get_config(arch), shape)
        jcfg = JSP.adapt_config(jax_get_config(arch), shape)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
        assert SP.supports_shape(cfg, shape) == JSP.supports_shape(jcfg,
                                                                   shape)
        decode = shape.kind == "decode"
        ins = SP.input_specs(cfg, shape,
                             model=build_model(cfg) if decode else None)
        jins = JSP.input_specs(jcfg, shape,
                               model=jax_build_model(jcfg) if decode else None)
        assert _spec_rows(ins) == _spec_rows(jins), (arch, shape.name)
        assert all(t.device.type == "meta" for t in
                   _leaves(ins)), (arch, shape.name)


def _leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _leaves(v)]
    return [tree]


# ---------------------------------------------------------------------------
# the schedule and the shims
# ---------------------------------------------------------------------------
def test_format_schedule_equal_to_jax(monkeypatch):
    JTRACE = jax_launch_module("trace")
    cfg = get_reduced("qwen1p5_0p5b")
    res = DR.compile_run(cfg, InputShape("t", 32, 4, "train"),
                         MESH.LocalMesh(2, 2), PL.make_plan("fsdp_tp"),
                         keep_messages=True)
    assert res["messages"] and not dist.is_initialized()
    ours = TRACE.format_schedule(res, top=7)
    assert ours.endswith("at 450 GB/s)")
    monkeypatch.setattr(TRACE, "ALPHA", JTRACE.ALPHA)
    monkeypatch.setattr(TRACE, "BW", JTRACE.BW)
    assert TRACE.format_schedule(res, top=7) == \
        JTRACE.format_schedule(res, top=7)


SHIM_FLAGS = {
    "dryrun": (["--arch", "stablelm-1.6b", "--shape", "prefill_32k",
                "--multi-pod", "--plan", "hsdp", "--scan-block", "2",
                "--grad-accum", "2", "--bf16-params"],
               {"arch": "stablelm-1.6b", "shape": "prefill_32k",
                "multi_pod": True, "plan_name": "hsdp", "scan_block": 2,
                "mesh_split": "", "mla_absorb": False, "grad_accum": 2,
                "serve_bf16": False, "bf16_params": True}),
    "trace": (["--arch", "granite-34b", "--shape", "train_4k", "--plan",
               "fsdp_tp", "--top", "5"],
              {"arch": "granite-34b", "shape": "train_4k",
               "multi_pod": False, "plan_name": "fsdp_tp"}),
}


@pytest.mark.parametrize("kind", list(SHIM_FLAGS))
def test_shims_build_jax_documents(kind, monkeypatch):
    """``python -m repro_torch.launch.{dryrun,trace}`` warn and delegate
    with the document JAX's shim builds from the same flags."""
    from repro_torch.launch import dryrun as shim_dryrun
    from repro_torch.launch import trace as shim_trace

    argv, flat = SHIM_FLAGS[kind]
    seen = []

    def execute_doc(doc, **kw):
        seen.append((doc, kw))
        return {"chips": 1}

    monkeypatch.setattr(api, "execute_doc", execute_doc)
    main = shim_dryrun.main if kind == "dryrun" else shim_trace.main
    with pytest.warns(DeprecationWarning, match=f"repro_torch {kind}"):
        assert main(argv + ["--device", "cpu"]) == 0
    [(doc, kw)] = seen
    name = f"{kind}_{flat['arch']}_{flat['shape']}"
    if kind == "dryrun":
        want = jax_legacy_dryrun_doc(flat, name=name)
    else:
        want = jax_legacy_dryrun_doc(flat, kind="trace",
                                     settings={"top": 5}, name=name)
    assert doc == want and kw["device"] == "cpu"


# ---------------------------------------------------------------------------
# the documents through the CLI, at reduced width
# ---------------------------------------------------------------------------
def test_dryrun_and_trace_documents_through_the_cli(tmp_path, capsys):
    """``dryrun.yaml`` (StableLM-1.6B, ``fsdp_tp``) and ``trace.yaml``
    (Granite-34B) on the 16 x 16 production mesh, reduced in width: the
    dryrun's JSON (``--json``) is the run's result and its
    ``model_flops_global`` 6·N·D; the trace prints the schedule."""
    from repro_torch.telemetry.accounting import model_flops

    out = str(tmp_path / "d.json")
    rc = cli_main(["dryrun", "--config", os.path.join(CONFIGS, "dryrun.yaml"),
                   "--set", "arch.config.reduced=true",
                   "--set", f"run.output_dir={tmp_path / 'dry'}",
                   "--json", out, "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0 and "done: stablelm-1.6b-reduced x train_4k on 16x16" \
        in text
    with open(out) as f:
        res = json.load(f)
    with open(tmp_path / "dry" / "result.json") as f:
        assert json.load(f) == res
    cfg = get_reduced("stablelm_1p6b").with_(scan_block_size=4)
    assert res["model_flops_global"] == model_flops(
        cfg, SHAPES["train_4k"])[0]
    assert res["chips"] == 256 and res["plan"].startswith("fsdp_tp")
    assert res["collective_counts"]["all-gather"] > 0
    rc = cli_main(["trace", "--config", os.path.join(CONFIGS, "trace.yaml"),
                   "--set", "arch.config={reduced: true}",
                   "--set", f"run.output_dir={tmp_path / 'tr'}",
                   "--device", "cpu"])
    text = capsys.readouterr().out
    assert rc == 0
    assert "# collective schedule: granite-34b-reduced x train_4k x 16x16 " \
        "(fsdp_tp(" in text
    assert "total collective bytes/device:" in text
    with open(tmp_path / "tr" / "result.json") as f:
        assert json.load(f)["schedule"].startswith("# collective schedule:")
    assert not dist.is_initialized()


_JAX_FSDP_TP = """
import os, json, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, {src!r})
from repro.configs import get_reduced
from repro.configs.shapes import InputShape
from repro.launch.dryrun import compile_run
from repro.launch.mesh import LocalMesh
from repro.sharding.plans import make_plan
res = compile_run(get_reduced("qwen1p5_0p5b"), InputShape("t", 32, 4, "train"),
                  LocalMesh(2, 2), make_plan("fsdp_tp"))
print(json.dumps(res, default=str))
"""


def test_fsdp_tp_on_four_ranks_against_jax():
    """JAX's dryrun on 4 forced host devices and the port's on a fake
    2 x 2 world, ``fsdp_tp``: the layouts' per-device argument bytes, the
    warnings and the model's counts ``==``; both gather the FSDP shards
    and all-reduce the tensor-parallel partial sums.  XLA's CPU
    partitioner reduces the gradients with all-reduces where DTensor
    reduce-scatters them, half the bytes in ``hlo_analysis``'s convention,
    so the port moves fewer bytes than JAX (measured 1.009e7 vs 1.458e7).
    The port's FLOPs per device lie within ``FSDP_TP_FLOPS_TOL`` above
    JAX's (measured +3.50%): the elementwise ops XLA fuses."""
    out = subprocess.run(
        [sys.executable, "-c", _JAX_FSDP_TP.format(src=SRC)],
        capture_output=True, text=True, timeout=300,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert out.returncode == 0, out.stderr[-3000:]
    jres = json.loads(out.stdout.strip().splitlines()[-1])
    res = DR.compile_run(get_reduced("qwen1p5_0p5b"),
                         InputShape("t", 32, 4, "train"),
                         MESH.LocalMesh(2, 2), PL.make_plan("fsdp_tp"))
    for key in ("chips", "mesh", "plan", "model_flops_global", "n_params",
                "sharding_warnings", "mem_argument_size_in_bytes"):
        assert res[key] == jres[key], key
    for kind in ("all-gather", "all-reduce"):
        assert jres["collective_counts"][kind] > 0, kind
        assert res["collective_counts"][kind] > 0, kind
    assert res["collective_counts"]["reduce-scatter"] > 0
    assert res["collective_bytes_per_dev"] < jres["collective_bytes_per_dev"]
    gap = res["hlo_flops_per_dev"] / jres["hlo_flops_per_dev"] - 1
    assert 0 <= gap <= FSDP_TP_FLOPS_TOL, gap


FSDP_TP_FLOPS_TOL = 0.05

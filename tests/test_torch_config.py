"""The port's config table, registry and run documents against the JAX
package's: every architecture, full and reduced, field for field."""
import dataclasses
import json
import os

import pytest

import repro.configs as JCFG
import repro.models.base as JB
import repro_torch.configs as PCFG
import repro_torch.models.base as PB
from repro.config.resolver import load_yaml
from repro.config.resolver import resolve_config as jax_resolve_config
from repro.core.components import register_all as jax_register_all
from repro_torch.config.resolver import resolve_config
from repro_torch.core.components import register_all
from repro_torch.run.config import RunError, parse_run_doc
from repro_torch.run.overrides import apply_overrides, parse_overrides

ARCHS = JCFG.ARCH_IDS + ["llama3_8b"]
SERVE_YAML = os.path.join(os.path.dirname(__file__), "..", "examples", "configs",
                          "serve.yaml")
SERVE_ENGINE_YAML = os.path.join(os.path.dirname(SERVE_YAML),
                                 "serve_engine.yaml")


def test_arch_table_is_the_same():
    assert PCFG.ARCH_IDS == JCFG.ARCH_IDS
    assert PCFG._ALIASES == JCFG._ALIASES
    assert {k: dataclasses.asdict(v) for k, v in PCFG.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in JCFG.SHAPES.items()}


@pytest.mark.parametrize("cls", ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig"])
def test_config_dataclass_fields_match_jax(cls):
    def fields(c):
        return [(f.name, f.default) for f in dataclasses.fields(c)]

    assert fields(getattr(PB, cls)) == fields(getattr(JB, cls))


@pytest.mark.parametrize("reduced", [False, True], ids=["full", "reduced"])
@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_jax(arch, reduced):
    get_p = PCFG.get_reduced if reduced else PCFG.get_config
    get_j = JCFG.get_reduced if reduced else JCFG.get_config
    assert dataclasses.asdict(get_p(arch)) == dataclasses.asdict(get_j(arch))


@pytest.mark.parametrize("name", ["qwen1.5-0.5b", "llama3-8b", "zamba2-2.7b",
                                  "stablelm_12b"])
def test_canonical_names_match_jax(name):
    assert PCFG.canonical(name) == JCFG.canonical(name)


def test_serve_yaml_resolves_to_the_same_arch_config():
    """``examples/configs/serve.yaml`` unchanged, with the overrides the chip
    run uses, builds the same ArchConfig in both registries."""
    sets = ["arch.config.reduced=false", "arch.config.use_flash_kernel=true"]
    doc = apply_overrides(load_yaml(SERVE_YAML), parse_overrides(sets))
    graph = {k: v for k, v in doc.items() if k != "run"}
    register_all()
    jax_register_all()
    port = resolve_config({"arch": graph["arch"]})["arch"]
    ref = jax_resolve_config({"arch": graph["arch"]})["arch"]
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.n_layers == 24 and port.use_flash_kernel


def test_serve_document_parses_and_engine_mode_is_refused():
    """``serve.yaml`` parses to the shim's settings, and the engine document
    ``serve_engine.yaml`` to JAX's settings field for field (sampling,
    workload and telemetry blocks included; ``bench_dir`` keeps JAX's
    ``"."`` default, which the port reads as the run's output directory)."""
    from repro.run.config import parse_run_doc as jax_parse_run_doc

    doc = load_yaml(SERVE_YAML)
    cfg = parse_run_doc(doc, kind="serve")
    assert (cfg.settings.batch, cfg.settings.prompt_len, cfg.settings.gen) == \
        (4, 32, 16)
    engine_doc = load_yaml(SERVE_ENGINE_YAML)
    port = parse_run_doc(engine_doc, kind="serve").settings
    ref = jax_parse_run_doc(engine_doc).settings
    assert port.engine and port.workload.prefix_len == 32
    assert [f.name for f in dataclasses.fields(port)] == \
        [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        a, b = getattr(port, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            a, b = dataclasses.asdict(a), dataclasses.asdict(b)
        assert a == b, f.name
    with pytest.raises(RunError):
        parse_run_doc(apply_overrides(doc, parse_overrides(["run.serve.bogus=1"])))
    with pytest.raises(RunError):
        parse_run_doc(apply_overrides(engine_doc, parse_overrides(
            ["run.serve.sampling.top_p=0.0"])))
    # the dryrun kind is ported: its document parses to JAX's settings
    dry = {"run": {"kind": "dryrun"}}
    assert dataclasses.asdict(parse_run_doc(dry).settings) == \
        dataclasses.asdict(jax_parse_run_doc(dry).settings)


def test_custom_arch_config_resolves_as_in_jax():
    node = {"arch": {"component_key": "arch_config", "variant_key": "custom",
                     "config": {"name": "tiny", "arch_type": "moe", "n_layers": 2,
                                "d_model": 64, "n_heads": 4, "n_kv_heads": 2,
                                "d_ff": 128, "vocab": 100,
                                "moe": {"n_routed": 4, "n_shared": 1,
                                        "top_k": 2, "d_expert": 32}}}}
    register_all()
    jax_register_all()
    port = resolve_config(node)["arch"]
    assert isinstance(port.moe, PB.MoEConfig)
    assert dataclasses.asdict(port) == \
        dataclasses.asdict(jax_resolve_config(node)["arch"])


def test_cli_serves_on_the_cpu_when_asked(tmp_path, capsys):
    from repro_torch.run.cli import main

    rc = main(["serve", "--config", SERVE_YAML, "--device", "cpu",
               "--set", "run.serve.prompt_len=6", "--set", "run.serve.gen=3",
               "--set", "run.serve.batch=2",
               "--set", f"run.output_dir={tmp_path}"])
    assert rc == 0
    assert "done: 2 requests x 3 tokens" in capsys.readouterr().out
    with open(tmp_path / "result.json") as f:
        result = json.load(f)
    assert result["gen_tokens_total"] == 6 and result["arch"] == "qwen1.5-0.5b-reduced"


def test_kernel_build_without_nvcc_raises():
    import shutil

    from repro_torch.kernels import build

    if shutil.which("nvcc") or os.path.exists(
            os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")):
        pytest.skip("nvcc is installed here: the build would run")
    with pytest.raises(build.KernelBuildError, match="nvcc not found"):
        build.load("flash_fwd")

"""The port's extension surface against the JAX package's, on the CPU: run
kinds as registry components (a kind registered at runtime dispatches with
no edit to the port; a caller's registry without run kinds falls back to
the built-ins), the component interfaces (an instance that breaks its IF is
refused at build time; every built-in component builds and satisfies its
IF), a user's model trained by the generic gym, and the resolver's edge
cases, each held to JAX's outcome on the same document: the same resolved
value, or the same error class and message fragment.

Tolerance: the bigram model's loss curve in f32, ``BIGRAM_TOL`` 1e-5
absolute on losses near ln 64: one gather and an f32 log-softmax a step,
whose summation orders differ between XLA and PyTorch by a few ulps, and
15 Adam steps that carry those differences on.
"""
import os

import jax
import numpy as np
import pytest
import torch

import repro.core.components  # noqa: F401  (populates JAX's registry)
import repro.run.kinds  # noqa: F401  (registers JAX's run kinds)
from repro.config.registry import DEFAULT_REGISTRY as JAX_REGISTRY
from repro.config.registry import Registry as JaxRegistry
from repro.config.resolver import resolve_config as jax_resolve_config
from repro.config.resolver import validate_config as jax_validate_config
from repro.core import interfaces as JIF
from repro.run import api as jax_api
from repro.run.config import SETTINGS_SCHEMAS as JAX_SETTINGS_SCHEMAS
from repro.run.config import parse_run_doc as jax_parse_run_doc
from repro.run.kinds import register_run_kind as jax_register_run_kind
from repro_torch.config.registry import DEFAULT_REGISTRY, Registry
from repro_torch.config.resolver import ConfigError, resolve_config, validate_config
from repro_torch.configs import get_reduced
from repro_torch.core import interfaces as IF
from repro_torch.core.gym import Gym
from repro_torch.data.tokenizer import ByteTokenizer
from repro_torch.data.packed_dataset import (ChunkedLMDataset, PackedDataset,
                                             ShardedLoader, synthetic_dataset)
from repro_torch.models.base import ArchConfig, Model
from repro_torch.optim.adamw import AdamW
from repro_torch.run import api
from repro_torch.run.config import SETTINGS_SCHEMAS, parse_run_doc
from repro_torch.run.kinds import RunKind, register_run_kind

BIGRAM_TOL = 1e-5

# the catalog is enumerated below at collection time
api._registry()


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops: one torch thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _quiet(_msg):
    pass


def _outcome(fn):
    """("ok", value) or ("error", class name, message) of ``fn()``."""
    try:
        return ("ok", fn())
    except Exception as e:  # the outcome under test
        return ("error", type(e).__name__, str(e))


def _same_error(port, jax_out, fragment):
    assert port[0] == jax_out[0] == "error", (port, jax_out)
    assert port[1] == jax_out[1], (port, jax_out)
    assert fragment in port[2] and fragment in jax_out[2], (port, jax_out)


# ---------------------------------------------------------------------------
# run kinds
# ---------------------------------------------------------------------------
def test_run_kinds_are_registry_components():
    """New run kinds are a registry entry + settings schema, not a script:
    a kind registered at runtime parses and dispatches with no edit to the
    port, and its document has JAX's fingerprint."""
    assert set(DEFAULT_REGISTRY.variants("run_kind")) >= {
        "train", "warmstart", "sft", "dpo", "bench", "serve"}
    kind = DEFAULT_REGISTRY.build("run_kind", "train")
    assert isinstance(kind, RunKind) and callable(kind.execute)

    seen = []

    def export(ctx):
        seen.append(ctx.device)
        return {"exported": True}

    doc = {"run": {"kind": "export", "name": "ex", "output_dir": ""}}
    try:
        register_run_kind("export", None, export)
        jax_register_run_kind("export", None, lambda ctx: {"exported": True})
        assert "export" in DEFAULT_REGISTRY.variants("run_kind")
        cfg = parse_run_doc(doc)
        assert cfg.kind == jax_parse_run_doc(doc).kind == "export"
        res = api.execute(cfg, device="cpu", log=_quiet)
        jres = jax_api.execute_doc(doc, write_files=False)
        assert res["exported"] and res["kind"] == jres["kind"] == "export"
        assert res["fingerprint"] == jres["fingerprint"]
        assert seen == [torch.device("cpu")]
    finally:  # the default registries are process-global: undo the demo kind
        DEFAULT_REGISTRY._entries.pop(("run_kind", "export"), None)
        SETTINGS_SCHEMAS.pop("export", None)
        JAX_REGISTRY._entries.pop(("run_kind", "export"), None)
        JAX_SETTINGS_SCHEMAS.pop("export", None)


class _StubGym:
    ckpt_dir = ""
    loader = None

    def setup(self):
        return {"step": 0}

    def run(self, steps, state=None):
        return {"state": state, "history": [{"loss": 1.0}]}


def test_execute_with_custom_registry_falls_back_for_run_kinds(tmp_path):
    """A caller-supplied registry without run_kind entries still dispatches
    (the built-in kinds are the fallback), in both packages alike."""
    def doc(pkg):
        return {"run": {"kind": "train", "name": "custom",
                        "output_dir": str(tmp_path / pkg),
                        "train": {"steps": 3}},
                "gym": {"component_key": "gym", "variant_key": "stub"}}

    reg = Registry()
    reg.register("gym", "stub", _StubGym)
    result = api.execute_doc(doc("port"), registry=reg, device="cpu",
                             log=_quiet)
    jreg = JaxRegistry()
    jreg.register("gym", "stub", _StubGym)
    jres = jax_api.execute_doc(doc("jax"), registry=jreg)
    assert result["steps"] == jres["steps"] == 3
    assert result["logged_points"] == jres["logged_points"] == 1
    assert result["goodput"] == jres["goodput"]
    with pytest.raises(ConfigError, match="gym: unknown variant .stub."):
        api.execute_doc(doc("default"), device="cpu", log=_quiet)


# ---------------------------------------------------------------------------
# interfaces
# ---------------------------------------------------------------------------
def test_interfaces_bind_jax_keys_but_the_sharding_plan():
    """The port binds every component key JAX binds, to an IF of the same
    name, ``sharding_plan`` too since A8a (the name is the case's from
    before, when the plan was the one key left unbound)."""
    from repro_torch.sharding.plans import ShardingPlan

    jax_ifs = JIF.register_builtin_interfaces()
    port_ifs = IF.register_builtin_interfaces()
    assert set(jax_ifs) == set(port_ifs)
    for key, iface in port_ifs.items():
        assert iface.__name__ == jax_ifs[key].__name__, key
    assert DEFAULT_REGISTRY._interfaces["sharding_plan"] is ShardingPlan
    assert port_ifs["sharding_plan"] is ShardingPlan
    for key in ("optimizer", "dataset", "loader", "tokenizer", "tracker",
                "checkpointer", "mesh_provider", "model", "gym",
                "sharding_plan"):
        assert DEFAULT_REGISTRY._interfaces[key] is port_ifs[key], key


def _component_kwargs(tmp_path):
    """Minimal settings that build each built-in component."""
    prefix = str(tmp_path / "d")
    synthetic_dataset(4000, 64, prefix, seed=0)
    ds = ChunkedLMDataset(PackedDataset(prefix), 16)
    loader = ShardedLoader(ds, 2)
    reduced = get_reduced("qwen1p5_0p5b")
    sft_path = str(tmp_path / "sft.jsonl")
    with open(sft_path, "w") as f:
        f.write('{"prompt": "a b", "response": "c d e"}\n')
    return {
        ("arch_config", "custom"): dict(
            name="tiny", arch_type="dense", n_layers=1, d_model=16,
            n_heads=2, n_kv_heads=1, d_ff=32, vocab=64),
        ("model", "auto"): dict(arch_config=reduced),
        ("lr_schedule", "constant"): dict(lr=1e-3),
        ("lr_schedule", "warmup_cosine"): dict(peak_lr=1e-3, warmup_steps=2,
                                               total_steps=10),
        ("lr_schedule", "wsd"): dict(peak_lr=1e-3, warmup_steps=2,
                                     total_steps=10),
        ("dataset", "packed_chunked"): dict(prefix=prefix, seq_len=16),
        ("dataset", "synthetic"): dict(n_tokens=4000, vocab=64,
                                       prefix=str(tmp_path / "s"), seq_len=16),
        ("dataset", "sft_synthetic"): dict(seq_len=32, vocab=64,
                                           n_examples=8),
        ("dataset", "preference_synthetic"): dict(seq_len=32, vocab=64,
                                                  n_pairs=8),
        ("dataset", "sft_jsonl"): dict(path=sft_path, seq_len=4,
                                       tokenizer=ByteTokenizer()),
        ("loader", "sharded"): dict(dataset=ds, global_batch=2),
        ("loader", "prefetch"): dict(loader=loader),
        ("evaluator", "perplexity"): dict(dataset=ds),
        ("tracker", "jsonl"): dict(path=str(tmp_path / "t.jsonl")),
        ("sink", "jsonl"): dict(path=str(tmp_path / "s.jsonl")),
        ("sink", "csv"): dict(path=str(tmp_path / "s.csv")),
        ("sink", "multi"): dict(sinks=[]),
        ("gym", "standard"): dict(
            model=DEFAULT_REGISTRY.build("model", "auto",
                                         arch_config=reduced),
            optimizer=AdamW(), loader=loader),
        ("checkpointer", "async"): dict(ckpt_dir=str(tmp_path / "ck")),
        ("checkpointer", "sync"): dict(ckpt_dir=str(tmp_path / "ck")),
        ("mesh_provider", "split"): dict(dp=1, tp=1),
        ("shape", "custom"): dict(seq_len=64, global_batch=2, kind="train"),
    }


CATALOG = sorted(DEFAULT_REGISTRY._entries)


@pytest.mark.parametrize("key,variant", CATALOG,
                         ids=[f"{k}/{v}" for k, v in CATALOG])
def test_builtin_component_builds_and_satisfies_its_interface(
        tmp_path, key, variant):
    """Every built-in component builds and satisfies its bound IF (and the
    catalog's IF); one of a later slice raises its own refusal, naming the
    ROADMAP item, never an IF error."""
    entry = DEFAULT_REGISTRY.entry(key, variant)
    kwargs = _component_kwargs(tmp_path).get((key, variant), {})
    refusal = getattr(entry.factory, "not_ported", None)
    if refusal:
        with pytest.raises(NotImplementedError, match="ROADMAP A") as e:
            DEFAULT_REGISTRY.build(key, variant, **kwargs)
        assert str(e.value) == refusal
        return
    obj = DEFAULT_REGISTRY.build(key, variant, **kwargs)
    if entry.interface is not None:
        assert isinstance(obj, entry.interface)
    if key in IF.INTERFACES:
        assert isinstance(obj, IF.INTERFACES[key])
    if key == "run_kind":
        assert obj.settings_cls is SETTINGS_SCHEMAS[variant]
    close = getattr(obj, "close", None)
    if key in ("checkpointer", "sink") and callable(close):
        close()


def test_custom_component_runtime_registration():
    """A new component key registered at runtime composes through config
    only; a wrong-IF component is rejected at build time, as in JAX."""
    for Reg in (Registry, JaxRegistry):
        reg = Reg()
        reg.register("greeting", "upper", lambda text: text.upper(), str)
        assert reg.build("greeting", "upper", text="hi") == "HI"
        reg.register("number", "bad", lambda: "not a number", int)
        assert _outcome(lambda: reg.build("number", "bad"))[:2] == \
            ("error", "RegistryError")
    reg, jreg = Registry(), JaxRegistry()
    for r in (reg, jreg):
        r.register("number", "bad", lambda: "not a number", int)
    _same_error(_outcome(lambda: reg.build("number", "bad")),
                _outcome(lambda: jreg.build("number", "bad")),
                "does not satisfy IF")


def test_interface_violation_flagged():
    """A 'model' component that does not satisfy the Model IF is rejected,
    in the port as in JAX; a resolved document names it in its path."""
    from repro.models.base import Model as JaxModel

    reg, jreg = Registry(), JaxRegistry()
    reg.register("model", "broken", lambda: object(), Model)
    jreg.register("model", "broken", lambda: object(), JaxModel)
    _same_error(_outcome(lambda: reg.build("model", "broken")),
                _outcome(lambda: jreg.build("model", "broken")),
                "does not satisfy IF Model")
    raw = {"m": {"component_key": "model", "variant_key": "broken"}}
    _same_error(_outcome(lambda: resolve_config(raw, reg)),
                _outcome(lambda: jax_resolve_config(raw, jreg)),
                "m: model/broken produced object")


class _BigramModel(Model):
    def init(self, gen):
        v = self.cfg.vocab
        return {"table": torch.randn(v, v, generator=gen,
                                     device=gen.device) * 0.01}

    def apply(self, params, batch):
        return params["table"][batch["tokens"]], {}

    def param_axes(self):
        from repro_torch.models import base as B

        return {"table": (B.VOCAB, B.VOCAB)}


def _bigram_cfg(vocab, cls=ArchConfig):
    return cls(name="bigram", arch_type="dense", n_layers=0, d_model=0,
               n_heads=0, n_kv_heads=0, d_ff=0, vocab=vocab)


def test_custom_model_composes_with_gym(tmp_path):
    """End to end: a user's torch Model registered at runtime trains
    through the port's generic gym with zero framework changes, on JAX's
    bigram document; from JAX's initial table its curve is JAX's."""
    from repro.core.gym import Gym as JaxGym
    from repro.data import packed_dataset as JD
    from repro.models.base import ArchConfig as JaxArchConfig
    from repro.models.base import Model as JaxModel
    from repro.optim.adamw import AdamW as JaxAdamW

    class JaxBigram(JaxModel):
        def init(self, rng):
            v = self.cfg.vocab
            return {"table": jax.random.normal(rng, (v, v)) * 0.01}

        def apply(self, params, batch, mesh_ctx=None, storage_axes=()):
            return params["table"][batch["tokens"]], {}

        def param_axes(self):
            from repro.models import base as JB

            return {"table": (JB.VOCAB, JB.VOCAB)}

    reg = Registry()
    reg.register("model", "bigram",
                 lambda vocab: _BigramModel(_bigram_cfg(vocab)), Model)
    model = reg.build("model", "bigram", vocab=64)
    prefix = str(tmp_path / "bigram")
    synthetic_dataset(20000, 64, prefix, seed=1)
    loader = ShardedLoader(ChunkedLMDataset(PackedDataset(prefix), 32, seed=1),
                           global_batch=8)
    gym = Gym(model=model, optimizer=AdamW(lr=0.05), loader=loader,
              log_every=5, device="cpu")
    out = gym.run(steps=15)
    losses = [h["loss"] for h in out["history"]]
    assert losses[-1] < losses[0] + 0.05

    jloader = JD.ShardedLoader(JD.ChunkedLMDataset(JD.PackedDataset(prefix),
                                                   32, seed=1),
                               global_batch=8)
    jgym = JaxGym(model=JaxBigram(_bigram_cfg(64, JaxArchConfig)),
                  optimizer=JaxAdamW(lr=0.05), loader=jloader, log_every=5)
    jstate = jgym.setup()
    table = torch.from_numpy(np.array(jstate["params"]["table"]))
    jout = jgym.run(15, state=jstate)
    gym.setup()
    params = {"table": table}
    state = {"params": params, "opt": gym.optimizer.init(params),
             "step": torch.zeros((), dtype=torch.int32)}
    out = gym.run(15, state=state)
    assert [h["step"] for h in out["history"]] == \
        [h["step"] for h in jout["history"]]
    np.testing.assert_allclose([h["loss"] for h in out["history"]],
                               [h["loss"] for h in jout["history"]],
                               atol=BIGRAM_TOL, rtol=0)


# ---------------------------------------------------------------------------
# the resolver's edge cases (tests/test_config_system.py and
# tests/test_resolver_edges.py), each on both packages
# ---------------------------------------------------------------------------
def _box_regs():
    regs = []
    for Reg in (Registry, JaxRegistry):
        reg = Reg()
        reg.register("box", "list", lambda items: list(items))
        reg.register("box", "pair", lambda a, b=0: (a, b))
        regs.append(reg)
    return regs


def _both(fn, raw, regs=None):
    """fn(raw, reg) through the port and through JAX: (port, jax)."""
    port_reg, jax_reg = regs or (None, None)
    port_fn, jax_fn = fn
    return (_outcome(lambda: port_fn(raw, port_reg)),
            _outcome(lambda: jax_fn(raw, jax_reg)))


RESOLVE = (resolve_config, jax_resolve_config)
VALIDATE = (validate_config, jax_validate_config)


def test_variable_interpolation():
    raw = {"variables": {"lr": 0.01},
           "opt": {"component_key": "optimizer", "variant_key": "adamw",
                   "config": {"lr": "${lr}"}}}
    port, jax_out = _both(RESOLVE, raw)
    assert port[0] == jax_out[0] == "ok"
    assert port[1]["opt"].lr == jax_out[1]["opt"].lr == 0.01
    assert isinstance(port[1]["opt"], IF.OptimizerIF)


def test_undefined_variable_flagged():
    raw = {"opt": {"component_key": "optimizer", "variant_key": "adamw",
                   "config": {"lr": "${nope}"}}}
    _same_error(*_both(RESOLVE, raw), "undefined variable")


def test_cycle_detection():
    raw = {
        "a": {"component_key": "model", "variant_key": "auto",
              "config": {"arch_config": {"instance_key": "b"}}},
        "b": {"component_key": "model", "variant_key": "auto",
              "config": {"arch_config": {"instance_key": "a"}}},
    }
    _same_error(*_both(RESOLVE, raw), "cyclic")


def test_interpolation_inside_lists():
    raw = {"variables": {"x": 3, "name": "abc"},
           "vals": ["${x}", "prefix-${name}", ["${x}", "${x}"]]}
    port, jax_out = _both(RESOLVE, raw, _box_regs())
    assert port == jax_out == ("ok", {"vals": [3, "prefix-abc", [3, 3]]})


def test_interpolation_inside_nested_component_config():
    raw = {
        "variables": {"x": 7},
        "outer": {"component_key": "box", "variant_key": "pair",
                  "config": {"a": {"component_key": "box",
                                   "variant_key": "list",
                                   "config": {"items": ["${x}", "${x}"]}},
                             "b": "${x}"}},
    }
    port, jax_out = _both(RESOLVE, raw, _box_regs())
    assert port == jax_out == ("ok", {"outer": ([7, 7], 7)})


def test_undefined_variable_inside_list_flagged():
    _same_error(*_both(RESOLVE, {"vals": [1, "${missing}"]}, _box_regs()),
                "undefined variable ${missing}")


def test_mixed_string_interpolation_coerces_to_str():
    raw = {"variables": {"n": 4}, "v": "n=${n}"}
    port, jax_out = _both(RESOLVE, raw, _box_regs())
    assert port == jax_out == ("ok", {"v": "n=4"})


def test_cycle_through_list_element_detected():
    raw = {
        "a": {"component_key": "box", "variant_key": "list",
              "config": {"items": [{"instance_key": "b"}]}},
        "b": {"component_key": "box", "variant_key": "list",
              "config": {"items": [1, {"instance_key": "a"}]}},
    }
    regs = _box_regs()
    _same_error(*_both(RESOLVE, raw, regs), "cyclic")
    _same_error(*_both(VALIDATE, raw, regs), "cyclic")


def test_self_cycle_in_plain_list_detected():
    _same_error(*_both(RESOLVE, {"xs": [{"instance_key": "xs"}]},
                       _box_regs()), "cyclic")


def test_diamond_reference_through_lists_is_shared_not_cyclic():
    raw = {
        "leaf": {"component_key": "box", "variant_key": "list",
                 "config": {"items": [1, 2]}},
        "both": {"component_key": "box", "variant_key": "pair",
                 "config": {"a": [{"instance_key": "leaf"}],
                            "b": {"instance_key": "leaf"}}},
    }
    regs = _box_regs()
    port, jax_out = _both(RESOLVE, raw, regs)
    assert port == jax_out
    for out in (port[1], jax_out[1]):
        assert out["both"][0][0] is out["both"][1]  # one shared instance
    assert _both(VALIDATE, raw, regs) == (("ok", {"components": 2,
                                                  "top_level": 2}),) * 2


def test_validate_counts_without_building():
    raw = {"p": {"component_key": "probe", "variant_key": "x",
                 "config": {"n": 3}},
           "q": {"component_key": "probe", "variant_key": "x"}}
    calls = []
    regs = []
    for Reg in (Registry, JaxRegistry):
        reg = Reg()
        reg.register("probe", "x", lambda n=1: calls.append(n))
        regs.append(reg)
    port, jax_out = _both(VALIDATE, raw, regs)
    assert port == jax_out == ("ok", {"components": 2, "top_level": 2})
    assert calls == [], "validate must not invoke factories"


@pytest.mark.parametrize("raw,fragment", [
    ({"p": {"component_key": "box", "variant_key": "cube"}},
     "unknown variant"),
    ({"p": {"component_key": "box", "variant_key": "pair",
            "config": {"a": 1, "z": 2}}}, "unexpected config keys"),
    ({"p": {"component_key": "box", "variant_key": "pair", "config": {}}},
     "missing required"),
], ids=["variant", "unexpected", "missing"])
def test_validate_flags_unknown_variant_and_keys(raw, fragment):
    _same_error(*_both(VALIDATE, raw, _box_regs()), fragment)


def test_validate_flags_unknown_reference_target():
    _same_error(*_both(VALIDATE, {"p": [{"instance_key": "ghost"}]},
                       _box_regs()), "unknown top-level entry")


def test_validate_checks_nested_component_configs():
    raw = {"outer": {"component_key": "box", "variant_key": "list",
                     "config": {"items": [
                         {"component_key": "box", "variant_key": "pair",
                          "config": {"typo": 1}}]}}}
    _same_error(*_both(VALIDATE, raw, _box_regs()), "unexpected config keys")


def test_validate_of_a_later_slice_names_its_item():
    """A plan validates as in JAX (A8a), and so does a local mesh with a
    pipe axis (A8b's GPipe schedule), with JAX's counts."""
    raw = {"plan": {"component_key": "sharding_plan", "variant_key": "fsdp"}}
    assert _outcome(lambda: jax_validate_config(raw)) == \
        _outcome(lambda: validate_config(raw))
    pipe = {"mesh": {"component_key": "mesh_provider", "variant_key": "local",
                     "config": {"dp": 4, "pp": 2}}}
    assert _outcome(lambda: jax_validate_config(pipe))[0] == "ok"
    assert _outcome(lambda: validate_config(pipe)) == \
        _outcome(lambda: jax_validate_config(pipe))


def test_port_never_imports_jax_or_repro():
    """The modules this slice adds import neither JAX nor the JAX
    package."""
    import re

    root = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch")
    for rel in ("core/interfaces.py", "run/kinds.py", "run/api.py",
                "core/components.py", "core/gym.py"):
        with open(os.path.join(root, rel)) as f:
            text = f.read()
        assert not re.search(r"^(from|import) (repro|jax)\b", text, re.M), rel

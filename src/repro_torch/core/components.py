"""Component catalog of the port: registers what this slice can build with
the port's own registry (``repro_torch.config.registry.DEFAULT_REGISTRY``).

Registered: ``arch_config/<arch>`` for every arch of the table (with the
``reduced`` flag and field overrides), ``arch_config/custom``,
``model/auto``, and the training graph: ``optimizer/adamw``,
``lr_schedule/*``, ``dataset/synthetic`` and ``dataset/packed_chunked``,
the post-training datasets ``dataset/sft_synthetic``, ``dataset/sft_jsonl``
and ``dataset/preference_synthetic``, ``tokenizer/byte`` and
``tokenizer/bpe``, ``loader/sharded`` and ``loader/prefetch``,
``remat_policy/*``,
``evaluator/perplexity``, ``tracker/stdout`` and ``tracker/jsonl``,
``sink/*``, ``checkpointer/async`` and ``checkpointer/sync``,
``fault_injector/schedule``, ``gym/standard``, the mesh providers
``mesh_provider/{single_device,local,production,split}``, every catalog
``sharding_plan`` plus ``sharding_plan/custom``, and the dryrun's
``shape/<name>`` for every input shape plus ``shape/custom`` and
``precision/policy``.  The names and settings
match ``repro.core.components``, so a run YAML of the JAX package
resolves here unchanged, a local mesh with a pipe axis (``pp > 1``)
included.  Each component key
is bound to its interface (:mod:`.interfaces`), as in JAX: the registry
refuses a built instance
that does not satisfy it, and the port's concrete classes are registered
into the ABCs they implement.
"""
from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional

from ..config.registry import DEFAULT_REGISTRY as REG
from ..configs import ARCH_IDS, get_config, get_reduced
from ..models import build_model
from ..models.base import ArchConfig, MLAConfig, Model, MoEConfig, SSMConfig
from ..models.stacked import REMAT_VARIANTS, RematPolicy
from . import interfaces as IF

_REGISTERED = False


def register_all() -> None:
    global _REGISTERED
    if _REGISTERED:
        return
    _REGISTERED = True
    _register_interfaces()
    for arch in ARCH_IDS + ["llama3_8b"]:
        REG.register("arch_config", arch,
                     (lambda a: (lambda reduced=False, **overrides:
                                 _cfg(a, reduced, overrides)))(arch),
                     ArchConfig)
    REG.register("arch_config", "custom", _custom_cfg, ArchConfig)
    REG.register("model", "auto", lambda arch_config: build_model(arch_config),
                 Model)
    _register_training()


def _register_interfaces() -> None:
    """Bind the IFs and virtual-subclass the concrete classes into them."""
    from ..ckpt import AsyncCheckpointer
    from ..data.packed_dataset import ChunkedLMDataset, ShardedLoader
    from ..data.prefetch import PrefetchLoader
    from ..data.tokenizer import BpeTokenizer, ByteTokenizer
    from ..launch.mesh import MeshProvider
    from ..optim.adamw import AdamW
    from ..posttrain.dpo import PreferencePairDataset
    from ..posttrain.lora import FrozenBaseOptimizer
    from ..posttrain.sft import PackedSFTDataset

    IF.register_builtin_interfaces()
    IF.TokenizerIF.register(ByteTokenizer)
    IF.TokenizerIF.register(BpeTokenizer)
    IF.OptimizerIF.register(AdamW)
    IF.OptimizerIF.register(FrozenBaseOptimizer)
    IF.DatasetIF.register(ChunkedLMDataset)
    IF.DatasetIF.register(PackedSFTDataset)
    IF.DatasetIF.register(PreferencePairDataset)
    IF.LoaderIF.register(ShardedLoader)
    IF.LoaderIF.register(PrefetchLoader)
    IF.CheckpointerIF.register(AsyncCheckpointer)
    IF.MeshProviderIF.register(MeshProvider)


def _register_training() -> None:
    from ..ckpt import AsyncCheckpointer, RetentionPolicy
    from ..data.packed_dataset import (ChunkedLMDataset, PackedDataset,
                                       ShardedLoader)
    from ..data.prefetch import PrefetchLoader
    from ..optim import schedules as SCHED
    from ..optim.adamw import AdamW
    from ..telemetry.sinks import (CsvSink, JsonlSink, ListSink, MultiSink,
                                   StdoutSink, TelemetrySink)
    from .evaluator import PerplexityEvaluator
    from .gym import Gym

    REG.register("optimizer", "adamw",
                 lambda lr=3e-4, b1=0.9, b2=0.95, eps=1e-8, weight_decay=0.1,
                 grad_clip=1.0: AdamW(lr=lr, b1=b1, b2=b2, eps=eps,
                                      weight_decay=weight_decay,
                                      grad_clip=grad_clip),
                 IF.OptimizerIF)
    REG.register("lr_schedule", "constant", SCHED.constant)
    REG.register("lr_schedule", "warmup_cosine", SCHED.warmup_cosine)
    REG.register("lr_schedule", "wsd", SCHED.wsd)

    REG.register("dataset", "packed_chunked",
                 lambda prefix, seq_len, seed=0, shuffle=True:
                 ChunkedLMDataset(PackedDataset(prefix), seq_len, seed,
                                  shuffle),
                 IF.DatasetIF)
    REG.register("dataset", "synthetic", _synthetic_chunked)
    # post-training datasets (loss-masked SFT rows, DPO preference pairs)
    from ..data.tokenizer import ByteTokenizer
    from ..posttrain.dpo import preference_synthetic_dataset
    from ..posttrain.sft import sft_jsonl_dataset, sft_synthetic_dataset

    REG.register("dataset", "sft_synthetic", sft_synthetic_dataset)
    REG.register("dataset", "sft_jsonl", sft_jsonl_dataset, IF.DatasetIF)
    REG.register("dataset", "preference_synthetic",
                 preference_synthetic_dataset)
    REG.register("tokenizer", "byte", ByteTokenizer, IF.TokenizerIF)
    REG.register("tokenizer", "bpe", _bpe_tokenizer, IF.TokenizerIF)
    REG.register("loader", "sharded",
                 lambda dataset, global_batch, dp_rank=0, dp_size=1:
                 ShardedLoader(dataset, global_batch, dp_rank, dp_size),
                 IF.LoaderIF)
    REG.register("loader", "prefetch",
                 lambda loader, depth=2, to_device=True:
                 PrefetchLoader(loader, depth=depth, to_device=to_device))

    for name in REMAT_VARIANTS:
        REG.register("remat_policy", name,
                     (lambda n: (lambda: RematPolicy(n)))(name), RematPolicy)
    REG.register("evaluator", "perplexity",
                 lambda dataset, n_samples=16, offset=None, batch=4:
                 PerplexityEvaluator(dataset, n_samples, offset, batch))

    REG.register("tracker", "stdout", lambda prefix="": _StdoutTracker(prefix),
                 IF.TrackerIF)
    REG.register("tracker", "jsonl", lambda path: _JsonlTracker(path))
    REG.register("sink", "jsonl", lambda path: JsonlSink(path), TelemetrySink)
    REG.register("sink", "csv", lambda path: CsvSink(path), TelemetrySink)
    REG.register("sink", "stdout",
                 lambda prefix="telemetry ": StdoutSink(prefix), TelemetrySink)
    REG.register("sink", "memory", lambda: ListSink(), TelemetrySink)
    REG.register("sink", "multi", lambda sinks: MultiSink(list(sinks)),
                 TelemetrySink)

    def gym(model, optimizer, loader, mesh_provider=None, sharding_plan=None,
            seed=0, grad_accum=1, log_every=10, eval_every=0, ckpt_every=0,
            ckpt_dir="", checkpointer=None, prefetch=2, tracker=None):
        # the provider stays lazy: the gym builds its mesh at setup, on the
        # type of the device the run is on
        return Gym(model=model, optimizer=optimizer, loader=loader,
                   mesh=mesh_provider, plan=sharding_plan, seed=seed,
                   grad_accum=grad_accum, log_every=log_every,
                   eval_every=eval_every, ckpt_every=ckpt_every,
                   ckpt_dir=ckpt_dir or getattr(checkpointer, "ckpt_dir", ""),
                   checkpointer=checkpointer, prefetch=prefetch,
                   logger=tracker)

    REG.register("gym", "standard", gym, Gym)
    REG.register("checkpointer", "async",
                 lambda ckpt_dir, keep_last=3, keep_every=0:
                 AsyncCheckpointer(ckpt_dir, RetentionPolicy(
                     int(keep_last), int(keep_every))),
                 IF.CheckpointerIF)
    REG.register("checkpointer", "sync",
                 lambda ckpt_dir, keep_last=3, keep_every=0:
                 AsyncCheckpointer(ckpt_dir, RetentionPolicy(
                     int(keep_last), int(keep_every)), background=False),
                 IF.CheckpointerIF)

    from ..resilience import FaultInjector

    REG.register("fault_injector", "schedule",
                 lambda faults=(): FaultInjector.from_config(faults),
                 FaultInjector)

    _register_parallelism()


def _register_parallelism() -> None:
    """Sharding plans and mesh providers (JAX's ``:84-90``, ``:191-196``):
    every catalog plan, the declarative ``custom`` plan, and the four mesh
    providers, each a ``MeshProvider`` whose ``build()`` makes the mesh
    lazily."""
    from ..launch import mesh as MESH
    from ..sharding.plans import CATALOG, ShardingPlan, custom_plan, make_plan

    for name in CATALOG:
        REG.register("sharding_plan", name,
                     (lambda n: (lambda multi_pod=False:
                                 make_plan(n, multi_pod)))(name),
                     ShardingPlan)
    REG.register("sharding_plan", "custom", lambda **kw: custom_plan(kw),
                 ShardingPlan)
    REG.register("mesh_provider", "single_device", MESH.SingleDeviceMesh,
                 IF.MeshProviderIF)

    REG.register("mesh_provider", "local", MESH.LocalMesh)
    REG.register("mesh_provider", "production", MESH.ProductionMesh)
    REG.register("mesh_provider", "split", MESH.SplitMesh)
    _register_dryrun()


def _register_dryrun() -> None:
    """The dryrun's input shapes and precision policy (JAX's
    ``:103-110``)."""
    from ..configs.shapes import SHAPES, InputShape
    from ..launch.specs import PrecisionPolicy

    for name in SHAPES:
        REG.register("shape", name, (lambda n: (lambda: SHAPES[n]))(name),
                     InputShape)
    REG.register("shape", "custom", _custom_shape, InputShape)
    REG.register("precision", "policy",
                 lambda bf16_params=False, serve_bf16=False:
                 PrecisionPolicy(bf16_params=bf16_params,
                                 serve_bf16=serve_bf16),
                 PrecisionPolicy)


def _custom_shape(seq_len: int, global_batch: int, kind: str,
                  name: str = "custom"):
    from ..configs.shapes import InputShape

    if kind not in ("train", "prefill", "decode"):
        raise ValueError(f"shape kind must be train|prefill|decode, got {kind!r}")
    return InputShape(name, int(seq_len), int(global_batch), kind)


def _cfg(arch: str, reduced: bool, overrides: Dict[str, Any]) -> ArchConfig:
    cfg = get_reduced(arch) if reduced else get_config(arch)
    return cfg.with_(**overrides) if overrides else cfg


def _custom_cfg(**kw) -> ArchConfig:
    for key, cls in (("moe", MoEConfig), ("mla", MLAConfig), ("ssm", SSMConfig)):
        if isinstance(kw.get(key), dict):
            kw[key] = cls(**kw[key])
    return ArchConfig(**kw)


def _bpe_tokenizer(path: str = "", corpus: str = "",
                   n_merges: Optional[int] = None):
    """Load from ``path``, or train ``n_merges`` merges on a ``corpus`` text
    file (one text per line); JAX's ``tokenizer/bpe``, its errors word for
    word."""
    from ..data.tokenizer import BpeTokenizer

    if path:
        if n_merges is not None:
            raise ValueError(
                "tokenizer/bpe: n_merges applies when training from 'corpus'; "
                "a tokenizer loaded from 'path' has its merges baked in"
            )
        return BpeTokenizer.load(path)
    if corpus:
        with open(corpus) as f:
            texts = f.read().splitlines()
        return BpeTokenizer.train(texts, n_merges=256 if n_merges is None
                                  else int(n_merges))
    if n_merges is not None:
        raise ValueError(
            "tokenizer/bpe: n_merges needs a 'corpus' text file to train on"
        )
    return BpeTokenizer()


def _synthetic_chunked(n_tokens: int, vocab: int, prefix: str, seq_len: int,
                       seed: int = 0, shuffle: bool = True):
    """Write the synthetic packed dataset at ``prefix`` unless it is there
    (its doc index, the file written last), then chunk it (JAX's
    ``dataset/synthetic``)."""
    from ..data.packed_dataset import (ChunkedLMDataset, PackedDataset,
                                       synthetic_dataset)
    from ..data.tokenize_pipeline import DOCIDX_SUFFIX

    if not os.path.exists(prefix + DOCIDX_SUFFIX):
        synthetic_dataset(n_tokens, vocab, prefix, seed)
    return ChunkedLMDataset(PackedDataset(prefix), seq_len, seed, shuffle)


class _StdoutTracker(IF.TrackerIF):
    def __init__(self, prefix: str = ""):
        self.prefix = prefix

    def __call__(self, metrics: Dict[str, Any]) -> None:
        print(self.prefix + json.dumps(metrics, default=float), flush=True)


class _JsonlTracker(IF.TrackerIF):
    def __init__(self, path: str):
        self.path = path

    def __call__(self, metrics: Dict[str, Any]) -> None:
        with open(self.path, "a") as f:
            f.write(json.dumps(metrics, default=float) + "\n")

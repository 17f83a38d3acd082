"""Dry run: trace one step of every (arch × input-shape × mesh × plan)
combination on a fake world of the mesh's size, with no card, and report
its per-device cost, memory and collectives for the roofline (port of
``repro.launch.dryrun``).

Run API (preferred — every knob is a YAML-addressable component):

  PYTHONPATH=src python -m repro_torch dryrun --config examples/configs/dryrun.yaml

Deprecated flag shim (delegates through the same Run API):

  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch stablelm-1.6b \\
      --shape train_4k [--multi-pod] [--plan fsdp_tp] [--json out.json]

Where JAX compiles on 512 forced host devices and reads XLA's cost and
memory analysis, the port builds the mesh inside
:func:`repro_torch.launch.mesh.fake_world` (one process standing for every
rank, its collectives moving no data), lays the train state or the params
out on it as ``meta`` DTensors (no memory), and runs the step once under
:class:`repro_torch.launch.hlo_analysis.CostCounter`, which counts rank 0's
local ops.  The hand-written kernels take part through their fake
implementations and FLOP formulas.  The roofline terms use the H100's
constants (:mod:`repro_torch.device`).

The result has JAX's keys but two that torch cannot give:
``xla_cost_flops_unscaled`` (XLA's own cost analysis) and
``mem_generated_code_size_in_bytes`` (there is no compiled program).
``lower_s`` is the time to build the state and the inputs, ``compile_s``
the traced step's.  A decode shape traces ``make_serve_step`` under the
mesh: the params (cast to bf16 under ``serve_bf16``) laid out by the plan,
the cache of ``shape.global_batch`` rows by ``plans.cache_shardings``, the
tokens and positions by ``plans.batch_shardings``.  A train or prefill
batch's ``frames`` (Whisper) and ``patch_embeds`` (LLaVA) are laid out
with its tokens, and counted as argument bytes as JAX counts them.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from typing import Any, Dict, Optional, Tuple

import torch

from ..configs import get_config
from ..configs.shapes import SHAPES
from ..device import HBM_BYTES_S, NVLINK_BYTES_S, PEAK_FLOPS_BF16, MetaGenerator
from ..models import build_model
from ..optim.adamw import AdamW
from ..sharding import plans as PL
from ..train import steps as ST
from . import mesh as MESH
from . import specs as SP
from .hlo_analysis import analyze


def model_flops(cfg, shape) -> Tuple[float, int, int]:
    """6·N_active·D (training) or 2·N_active·D (per-token inference).

    The estimate lives in :mod:`repro_torch.telemetry.accounting` so the
    dryrun's roofline and the live MFU accounting share one numerator;
    this alias keeps the historic dryrun import path working.
    """
    from ..telemetry.accounting import model_flops as _mf

    return _mf(cfg, shape)


# ---------------------------------------------------------------------------
# the dry run
# ---------------------------------------------------------------------------
def dryrun(arch: str, shape_name: str, multi_pod: bool = False,
           plan_name: str = "", scan_block: int = 0,
           verbose: bool = True, mesh_split: str = "",
           mla_absorb: bool = False, grad_accum: int = 1,
           serve_bf16: bool = False, bf16_params: bool = False,
           keep_messages: bool = False) -> Dict[str, Any]:
    """Historic flag-based entrypoint, now a thin wrapper over the
    component-driven :func:`compile_run` core."""
    shape = SHAPES[shape_name]
    cfg = get_config(arch)
    if scan_block:
        cfg = cfg.with_(scan_block_size=scan_block)
    if mla_absorb:
        cfg = cfg.with_(mla_absorb=True)
    if mesh_split:  # e.g. "32x8": re-split the same 256 chips (perf tuning)
        dp, tp = (int(x) for x in mesh_split.split("x"))
        assert dp * tp == 256 and not multi_pod
        mesh = MESH.SplitMesh(dp, tp)
    else:
        mesh = MESH.ProductionMesh(multi_pod=multi_pod)
    plan = PL.make_plan(plan_name, multi_pod) if plan_name else None
    return compile_run(cfg, shape, mesh, plan, grad_accum=grad_accum,
                       serve_bf16=serve_bf16, bf16_params=bf16_params,
                       verbose=verbose, keep_messages=keep_messages,
                       arch_label=arch, shape_label=shape_name)


@dataclasses.dataclass
class StepSetup:
    """One step laid out on a mesh: ``fn(*args)`` runs it."""

    fn: Any
    args: Tuple[Any, ...]
    warnings: list


def build_step(model, shape, mesh, plan, *, device="meta",
               grad_accum: int = 1, bf16_params: bool = False,
               serve_bf16: bool = False, seed: int = 0) -> StepSetup:
    """The step that ``shape.kind`` runs (the train step, the prefill, or
    one decode step), its state and its inputs laid out on ``mesh`` by
    ``plan``.  On ``meta`` the tensors hold no memory (a dryrun); on a card
    they are seeded: params from ``model.init``, tokens drawn in ``[0,
    vocab)``, a decode step's positions in ``[0, seq_len)`` and its cache
    zeroed, each rank allocating its block (``plans.pool_zeros``)."""
    device = torch.device(device)
    cfg = model.cfg
    gen = (MetaGenerator() if device.type == "meta"
           else torch.Generator(device).manual_seed(seed))
    mesh_ctx = PL.mesh_context(plan, mesh)
    storage_axes = plan.ep_storage_axes if plan.ep else ()
    if shape.kind == "decode":
        return _decode_step(model, shape, mesh, plan, mesh_ctx, gen, device,
                            serve_bf16)
    batch = SP.input_specs(cfg, shape)["batch"]
    if device.type != "meta":
        batch = {k: (torch.randint(0, cfg.vocab, v.shape, generator=gen,
                                   device=device, dtype=v.dtype)
                     if v.dtype == torch.int32 else
                     torch.randn(v.shape, generator=gen, device=device,
                                 dtype=v.dtype))
                 for k, v in batch.items()}
    if shape.kind == "train":
        opt = AdamW(lr=3e-4, master_weights=bf16_params)
        state_sh, warnings = PL.train_state_shardings(plan, mesh, model, opt)
        state = ST.init_train_state(
            model, opt, gen,
            param_dtype=torch.bfloat16 if bf16_params else None)
        first = PL.distribute(state, state_sh)
        fn = ST.make_train_step(model, opt, mesh_ctx, storage_axes,
                                grad_accum=grad_accum)
    else:
        params = model.init(gen)
        pspecs, warnings = PL.param_shardings(plan, mesh, params,
                                              model.param_axes())
        first = PL.distribute(params, pspecs)
        fn = ST.make_prefill_step(model, mesh_ctx, storage_axes)
    batch = PL.distribute(batch, PL.batch_shardings(plan, mesh, batch))
    return StepSetup(fn=fn, args=(first, batch), warnings=warnings)


def _decode_step(model, shape, mesh, plan, mesh_ctx, gen, device,
                 serve_bf16: bool) -> StepSetup:
    """JAX's decode branch: ``make_serve_step(model, mesh_ctx)`` on the
    params (bf16 under ``serve_bf16``: serving keeps no f32 master), the
    cache of ``shape.global_batch`` rows laid out by ``cache_shardings``,
    and the tokens and positions by ``batch_shardings``."""
    from ..tree import tree_map

    cfg = model.cfg
    params = model.init(gen)
    if serve_bf16:
        params = tree_map(lambda p: p.to(torch.bfloat16)
                          if p.dtype == torch.float32 else p, params)
    pspecs, warnings = PL.param_shardings(plan, mesh, params,
                                          model.param_axes())
    params = PL.distribute(params, pspecs)
    ins = SP.input_specs(cfg, shape, model=model)
    csh = PL.cache_shardings(plan, mesh, ins["cache"], shape.global_batch)
    cache = PL.pool_zeros(ins["cache"], csh, device)
    toks = {"tokens": ins["tokens"], "positions": ins["positions"]}
    if device.type != "meta":
        toks = {"tokens": torch.randint(0, cfg.vocab, (shape.global_batch,),
                                        generator=gen, device=device,
                                        dtype=torch.int32),
                "positions": torch.randint(0, shape.seq_len,
                                           (shape.global_batch,),
                                           generator=gen, device=device,
                                           dtype=torch.int32)}
    toks = PL.distribute(toks, PL.batch_shardings(plan, mesh, toks))
    return StepSetup(fn=ST.make_serve_step(model, mesh_ctx),
                     args=(params, cache, toks["tokens"], toks["positions"]),
                     warnings=warnings)


def compile_run(cfg, shape, mesh, plan=None, *, grad_accum: int = 1,
                bf16_params: bool = False, serve_bf16: bool = False,
                verbose: bool = False, keep_messages: bool = False,
                arch_label: str = "", shape_label: str = "") -> Dict[str, Any]:
    """Trace one (arch config × shape × mesh × plan) point and emit the
    memory / cost / collective analysis.

    Every argument is a resolved component (the Run API's ``dryrun``
    graph): ``cfg`` an ArchConfig, ``shape`` an InputShape, ``mesh`` a
    MeshProvider (built after the skip check, inside a fake world of its
    size) or a ``DeviceMesh`` of the caller's world, ``plan`` a
    ShardingPlan (default: per-arch), precision via the two bf16 flags
    (``bf16_params`` applies to a train shape, ``serve_bf16`` to a decode
    shape, as in JAX).
    """
    arch_label = arch_label or cfg.name
    shape_label = shape_label or shape.name
    cfg = SP.adapt_config(cfg, shape)
    ok, why = SP.supports_shape(cfg, shape)
    if not ok:
        return {"arch": arch_label, "shape": shape_label, "skipped": why}
    kw = dict(grad_accum=grad_accum, bf16_params=bf16_params,
              serve_bf16=serve_bf16, verbose=verbose, keep_messages=keep_messages,
              arch_label=arch_label, shape_label=shape_label)
    if not hasattr(mesh, "build"):
        if mesh is None:
            raise ValueError("compile_run needs a mesh")
        return _trace(cfg, shape, mesh, plan, **kw)
    if not mesh.n_devices:
        raise ValueError("compile_run needs a mesh (a MeshProvider that "
                         "produces none cannot be dry-run)")
    with MESH.fake_world(mesh.n_devices):
        return _trace(cfg, shape, mesh.build(MESH.FAKE_DEVICE_TYPE), plan,
                      **kw)


def _trace(cfg, shape, mesh, plan, *, grad_accum, bf16_params, serve_bf16,
           verbose, keep_messages, arch_label,
           shape_label) -> Dict[str, Any]:
    multi_pod = "pod" in mesh.mesh_dim_names
    if plan is None:
        plan = PL.default_plan_for(cfg, multi_pod)
    model = build_model(cfg)

    t0 = time.time()
    setup = build_step(model, shape, mesh, plan, grad_accum=grad_accum,
                       bf16_params=bf16_params, serve_bf16=serve_bf16)
    t_lower = time.time() - t0
    t0 = time.time()
    _, ana = analyze(setup.fn, *setup.args)
    t_compile = time.time() - t0
    mflops, n_total, n_active = model_flops(cfg, shape)

    chips = mesh.size()
    flops_dev = float(ana["flops"])
    bytes_dev = float(ana["bytes"])
    res = {
        "arch": arch_label,
        "shape": shape_label,
        "mesh": "x".join(str(s) for s in mesh.shape),
        "plan": plan.describe(),
        "chips": int(chips),
        "hlo_flops_per_dev": flops_dev,
        "hlo_bytes_per_dev": bytes_dev,
        "collective_bytes_per_dev": ana["collective_bytes"],
        "collective_counts": ana["collective_counts"],
        "collective_per_kind": ana["collective_per_kind"],
        "collective_msgs_large": sorted(
            ana["messages"], key=lambda m: -m[1]
        )[:8],
        "model_flops_global": mflops,
        "n_params": n_total,
        "n_params_active": n_active,
        "compute_term_s": flops_dev / PEAK_FLOPS_BF16,
        "memory_term_s": bytes_dev / HBM_BYTES_S,
        "collective_term_s": ana["collective_bytes"] / NVLINK_BYTES_S,
        "lower_s": round(t_lower, 1),
        "compile_s": round(t_compile, 1),
        "sharding_warnings": setup.warnings,
        # per-plan pipeline cost block (MoFa-style observable bubble term)
        "pipeline": PL.pipeline_info(plan, mesh, shape.global_batch
                                     if shape.kind == "train" else 0),
    }
    for key in ("mem_temp_size_in_bytes", "mem_argument_size_in_bytes",
                "mem_output_size_in_bytes"):
        res[key] = ana[key]
    terms = {
        "compute": res["compute_term_s"],
        "memory": res["memory_term_s"],
        "collective": res["collective_term_s"],
    }
    res["dominant_term"] = max(terms, key=terms.get)
    res["useful_flops_ratio"] = (
        mflops / (flops_dev * chips) if flops_dev else 0.0
    )
    if verbose:
        print(json.dumps(res, indent=2, default=str))
    if keep_messages:
        res["messages"] = ana["messages"]
    return res


def main(argv: Optional[list] = None) -> int:
    """DEPRECATED shim: delegates to ``python -m repro_torch dryrun``."""
    import warnings

    warnings.warn(
        "python -m repro_torch.launch.dryrun is deprecated; use "
        "`python -m repro_torch dryrun --config <run.yaml>` (this shim "
        "delegates through the same Run API)", DeprecationWarning,
        stacklevel=2)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--plan", default="")
    ap.add_argument("--scan-block", type=int, default=0)
    ap.add_argument("--mesh-split", default="")
    ap.add_argument("--mla-absorb", action="store_true")
    ap.add_argument("--grad-accum", type=int, default=1)
    ap.add_argument("--serve-bf16", action="store_true")
    ap.add_argument("--bf16-params", action="store_true")
    ap.add_argument("--json", default="")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..run import api as run_api
    from ..run.legacy import legacy_dryrun_doc

    doc = legacy_dryrun_doc({
        "arch": args.arch, "shape": args.shape, "multi_pod": args.multi_pod,
        "plan_name": args.plan, "scan_block": args.scan_block,
        "mesh_split": args.mesh_split, "mla_absorb": args.mla_absorb,
        "grad_accum": args.grad_accum, "serve_bf16": args.serve_bf16,
        "bf16_params": args.bf16_params,
    }, name=f"dryrun_{args.arch}_{args.shape}".replace("/", "-"))
    res = run_api.execute_doc(doc, device=args.device,
                              options={"verbose": True},
                              log=lambda m: print(m, flush=True))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(res, f, indent=2, default=str)
    return 0 if ("skipped" in res or res.get("chips")) else 1


if __name__ == "__main__":
    sys.exit(main())

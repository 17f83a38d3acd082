"""A training cell's run: set-up, the timed window, the traced chunk and
the check against the reference.

The program is ``repro_torch`` from the checkout's ``src``.  Its gym is
built from a run document as ``python -m repro_torch train`` builds it
(the port's registry resolves the component graph), with the benchmark's
weights handed to it and its dataset a packed stream the benchmark wrote.
Set-up drives the gym's own ``run`` through the first steps, taking the
readings the reference is held to (``correct.py``); the window then calls
``run`` in chunks of the traffic's ``log_every`` steps until ``seconds``
have passed on the host clock, from a synchronised card to the
synchronisation that ends the last chunk.
"""
from __future__ import annotations

import gc
import math
import os
import tempfile
import time
from typing import Any, Callable, Dict, List, Optional

from .. import correct as CORRECT
from .. import trace as TRACE
from .. import traffic as TRAFFIC
from ..harness import BenchError, process_age_s


def run_document(cell, prefix: str) -> Dict[str, Any]:
    """The train document of the cell, as the port's CLI reads one."""
    cfg, tr = cell["config"], cell["traffic"]
    if cfg["port_key"] == "custom":
        arch = {"component_key": "arch_config", "variant_key": "custom",
                "config": {**cfg["arch"], "name": cfg["name"],
                           **cfg["settings"]}}
    else:
        arch = {"component_key": "arch_config", "variant_key": cfg["port_key"],
                "config": {"reduced": False, **cfg.get("overrides", {}),
                           **cfg["settings"]}}

    def ref(key):
        return {"instance_key": key}

    opt = dict(cfg["optimizer"])
    doc = {}
    if isinstance(opt["lr"], dict):
        lr = dict(opt["lr"])
        doc["schedule"] = {"component_key": "lr_schedule",
                           "variant_key": lr.pop("schedule"), "config": lr}
        opt["lr"] = ref("schedule")
    return doc | {
        "run": {"kind": "train", "name": cell["name"],
                "train": {"steps": 1}},
        "arch": arch,
        "model": {"component_key": "model", "variant_key": "auto",
                  "config": {"arch_config": ref("arch")}},
        "optimizer": {"component_key": "optimizer", "variant_key": "adamw",
                      "config": opt},
        "dataset": {"component_key": "dataset", "variant_key": "packed_chunked",
                    "config": {"prefix": prefix, "seq_len": tr["seq_len"],
                               "seed": 0, "shuffle": False}},
        "loader": {"component_key": "loader", "variant_key": "sharded",
                   "config": {"dataset": ref("dataset"),
                              "global_batch": tr["global_batch"]}},
        "gym": {"component_key": "gym", "variant_key": "standard",
                "config": {"model": ref("model"), "optimizer": ref("optimizer"),
                           "loader": ref("loader"), "seed": 0,
                           "log_every": tr["log_every"], "prefetch": 2}},
    }


def build_gym(cell, prefix: str):
    """The gym the port's train kind would run for the document."""
    from repro_torch.config.registry import DEFAULT_REGISTRY
    from repro_torch.config.resolver import resolve_config
    from repro_torch.core.components import register_all
    from repro_torch.run.config import parse_run_doc

    register_all()
    doc = run_document(cell, prefix)
    rc = parse_run_doc(doc, default_name=cell["name"])
    graph = resolve_config(rc.graph, DEFAULT_REGISTRY)
    gym = graph[rc.settings.gym_key]
    _check_arch(gym.model.cfg, cell["config"])
    return gym


def _check_arch(port_cfg, config) -> None:
    """The configuration the port built is the file's, key for key."""
    import dataclasses

    got = dataclasses.asdict(port_cfg)
    want = dict(config["arch"], **config["settings"])
    diff = {k: (got.get(k), v) for k, v in want.items() if got.get(k) != v}
    if diff:
        raise BenchError(f"the port's {config['port_key']} differs from "
                         f"{config['name']}.json: {diff}")


def _check_tree(model, specs) -> None:
    from repro_torch.device import MetaGenerator

    meta = model.init(MetaGenerator())
    got = {path: tuple(v.shape) for path, v in _flatten(meta)}
    want = {path: tuple(shape) for path, shape, _ in specs}
    if got != want:
        raise BenchError(f"the port's parameter tree differs from the "
                         f"benchmark's: only the port {sorted(set(got) - set(want))}, "
                         f"only the benchmark {sorted(set(want) - set(got))}, "
                         f"shapes {[k for k in got if k in want and got[k] != want[k]]}")


def _flatten(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def leaf_norms(tree, specs) -> Dict[str, float]:
    from ..reference.params import get_leaf, path_name

    return {path_name(path): float(get_leaf(tree, path).double().norm())
            for path, _, _ in specs}


# ---------------------------------------------------------------------------
# one run
# ---------------------------------------------------------------------------
def run_cell(cell, seed: int, seconds: Optional[float], trace: bool,
             device="cuda",
             hook: Optional[Callable] = None,
             reference: bool = True, log=lambda msg: None) -> Dict[str, Any]:
    """Run ``cell`` once.  Returns the run's record (set-up seconds, peak
    memory, the window, spans, the traced chunk, the readings and the
    reference's), which :func:`result_line` and the metric readers read.
    ``hook(gym)`` is called
    after the gym's set-up (the tests and the calibration plant faults
    through it); ``seconds=None`` runs no window; ``reference=False`` skips
    the check (the calibration runs it itself)."""
    import torch

    seed = int(seed) % 2 ** 63     # any whole number, as numpy seeds want
    t_start = time.perf_counter() - (process_age_s() if device != "cpu"
                                     else 0.0)
    cuda = torch.device(device).type == "cuda"

    def sync():
        if cuda:
            torch.cuda.synchronize()

    log(f"imports done at {time.perf_counter() - t_start:.3f} s")
    cfg, tr = cell["config"], cell["traffic"]
    arch, opt = cfg["arch"], cfg["optimizer"]
    B, S, k = tr["global_batch"], tr["seq_len"], tr["log_every"]
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.data.tokenize_pipeline import DOCIDX_SUFFIX, TOKENS_SUFFIX

    from ..reference.params import make_weights, param_specs

    with tempfile.TemporaryDirectory(prefix="portbench-") as tmp:
        prefix = os.path.join(tmp, "stream")
        TRAFFIC.write(tr, token_ids(cfg), seed, prefix + TOKENS_SUFFIX,
                      prefix + DOCIDX_SUFFIX)
        gym = build_gym(cell, prefix)
        gym.device = device
        specs = param_specs(arch)
        weights = make_weights(arch, seed, device)
        _check_tree(gym.model, specs)

        def init_state():
            return {"params": weights, "opt": gym.optimizer.init(weights),
                    "step": torch.zeros((), dtype=torch.int32,
                                        device=device)}

        gym._init_state = init_state
        state = gym.setup()
        del weights
        log(f"gym built at {time.perf_counter() - t_start:.3f} s")
        if hook is not None:
            hook(gym)

        # set-up: the first steps through the window's own call and feed
        losses: List[float] = []
        readings: Dict[str, Any] = {}
        for i in range(tr["warmup_steps"]):
            out = gym.run(1, state)
            state = out["state"]
            losses += [float(r["loss"]) for r in out["history"] if "loss" in r]
            log(f"set-up step {i + 1} ends at "
                f"{time.perf_counter() - t_start:.3f} s")
            if i == 0:
                readings["grad_norms"] = {
                    n: v / (1 - opt["b1"])
                    for n, v in leaf_norms(state["opt"]["m"], specs).items()}
            if i == CORRECT.CHECKED_STEPS - 1:
                readings["change_norms"] = _change_norms(state["params"],
                                                         arch, seed, device,
                                                         specs)
        readings["losses"] = losses[:CORRECT.CHECKED_STEPS]
        sync()
        setup_s = time.perf_counter() - t_start
        log(f"set-up {setup_s:.3f} s; first losses {readings['losses']}")

        # the window
        rec = None
        if trace:
            from repro_torch.telemetry.recorder import TelemetryRecorder
            from repro_torch.telemetry.sinks import ListSink

            rec = gym.telemetry = TelemetryRecorder(ListSink(), spans=True)
        history: List[Dict[str, Any]] = []
        steps = 0
        ends: List[float] = []     # host clock at each chunk's return
        sync()
        t0 = time.perf_counter()
        while seconds is not None:
            out = gym.run(k, state)
            state = out["state"]
            history += out["history"]
            steps += k
            ends.append(time.perf_counter())
            if ends[-1] - t0 >= seconds:
                break
        sync()
        t1 = time.perf_counter()
        window = {"t0": t0, "t1": t1, "seconds": t1 - t0, "steps": steps,
                  "tokens": steps * B * S, "chunk_ends": ends}
        log(f"window {steps} steps in {t1 - t0:.3f} s; chunks end at "
            f"{[round(e - t0, 3) for e in ends]} s")

        prof = None
        if trace and seconds is not None:
            t = time.perf_counter()
            prof = TRACE.profile(lambda: gym.run(k, state), device)
            ev = prof["device_events"]
            log(f"traced chunk read in {time.perf_counter() - t:.3f} s: "
                f"{len(ev)} device events from "
                f"{ev[0][1] - prof['t0'] if ev else 0:.4f} s to "
                f"{ev[-1][2] - prof['t1'] if ev else 0:.4f} s off the "
                f"window's ends")
        peak = torch.cuda.max_memory_allocated() if cuda else 0
        spans = []
        if rec is not None:
            spans = [(r["name"], rec.t0 + r["t0_s"], rec.t0 + r["t1_s"],
                      r.get("step")) for r in rec.rows if r["type"] == "span"]
        window_losses = [float(r["loss"]) for r in history if "loss" in r]
        # the program's state goes before the reference runs
        out = None
        del state, gym
        gc.collect()
        if cuda:
            torch.cuda.empty_cache()

        record: Dict[str, Any] = {
            "setup_s": setup_s, "peak_bytes": peak, "window": window,
            "attempted": steps,
            "failed": sum(1 for v in window_losses if not math.isfinite(v)),
            "spans": spans, "profile": prof, "cell": cell,
            "readings": readings, "window_losses": window_losses,
        }
        if reference:
            batches = check_batches(prefix + TOKENS_SUFFIX, tr, device)
            t = time.perf_counter()
            record["reference"] = reference_readings(cell, seed, batches, device)
            log(f"reference: {CORRECT.CHECKED_STEPS} steps in "
                f"{time.perf_counter() - t:.3f} s, losses "
                f"{record['reference']['losses']}")
    return record


def _change_norms(params, arch, seed, device, specs):
    import torch

    from ..reference.params import get_leaf, make_weights, path_name

    w0 = make_weights(arch, seed, device)
    out = {}
    with torch.no_grad():
        for path, _, _ in specs:
            d = get_leaf(params, path) - get_leaf(w0, path)
            out[path_name(path)] = float(d.double().norm())
    del w0
    return out


def check_batches(tokens_path, tr, device):
    import torch

    B, S = tr["global_batch"], tr["seq_len"]
    out = []
    for s in range(CORRECT.CHECKED_STEPS):
        x, y = TRAFFIC.rows(tokens_path, S, s * B, B)
        out.append((torch.from_numpy(x).to(device),
                    torch.from_numpy(y).to(device)))
    return out


def token_ids(config) -> int:
    """The ids the configuration's tokenizer emits (the traffic's range)."""
    return int(config.get("token_ids", config["arch"]["vocab"]))


def judge(record, limits):
    """({name: {value, limit}}, correct) of a run record."""
    return CORRECT.compare(record["readings"], record["reference"], limits)


def reference_readings(cell, seed, batches, device, mm=None):
    from ..reference.lm import f32_mm, run_reference

    cfg = cell["config"]
    return run_reference(cfg["arch"], cfg["optimizer"], seed, batches, device,
                         mm or f32_mm, cfg["reference"]["rows_per_block"])



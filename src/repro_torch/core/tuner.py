"""Hyperparameter / throughput search (port of ``repro.core.tuner``; paper
§2: "hyperparameter search functionality for scalability / throughput
optimization").

Thin compatibility wrapper over the declarative sweep subsystem
(``repro_torch.sweep``): ``grid()`` expands a flat ``{path: values}`` space
into a one-axis sweep spec, runs it in-process through the gym backend on
``device`` (the card unless the caller asks for the CPU), and returns the
historic ranked-result shape.  New code should author sweep YAMLs and use
``repro_torch.sweep`` / ``python -m repro_torch sweep`` directly.
"""
from __future__ import annotations

from typing import Any, Dict, Iterable, List

from ..sweep.report import rank
from ..sweep.runner import SweepRunner
from ..sweep.spec import SweepSpec, set_path

__all__ = ["grid", "set_path"]

# historic private alias (pre-sweep callers patched configs through this)
_set_path = set_path


def grid(raw_config: Dict[str, Any], space: Dict[str, Iterable[Any]],
         steps: int = 10, gym_key: str = "gym",
         device: Any = None) -> List[Dict[str, Any]]:
    """space: {"optimizer.config.lr": [1e-3, 3e-4], "gym.config.grad_accum": [1, 2]}"""
    spec = SweepSpec(
        name="tuner-grid",
        base=raw_config,
        axes=[{"type": "grid",
               "parameters": {p: list(v) for p, v in space.items()}}],
        backend="gym",
        steps=steps,
        gym_key=gym_key,
        seed_path=None,
        create_missing=True,  # historic _set_path created missing leaf keys
    )
    records = SweepRunner(spec, device=device).run(resume=False)
    results = []
    for rec in rank(records, "final_loss", "min"):
        if rec.get("status") != "ok":
            raise RuntimeError(
                f"trial {rec.get('trial_id')} {rec.get('status')}: "
                f"{rec.get('error', rec.get('skip_reason', ''))}"
            )
        m = rec["metrics"]
        results.append({
            "trial": dict(rec["patches"]),
            "final_loss": m["final_loss"],
            "tokens_per_s": m["tokens_per_s"],
            "wall_s": m["wall_s"],
        })
    return results

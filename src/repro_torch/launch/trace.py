"""Communication tracing (port of ``repro.launch.trace``): the collective
schedule of one traced step for any (arch × shape × mesh) — kind, message
bytes per device, count, and an α–β time estimate.

Run API (preferred):

  PYTHONPATH=src python -m repro_torch trace --config examples/configs/trace.yaml

Deprecated flag shim (delegates through the same Run API):

  PYTHONPATH=src python -m repro_torch.launch.trace --arch granite-34b --shape train_4k
"""
import argparse
import math
import sys

from ..device import NVLINK_BYTES_S

#: ``ALPHA`` is the per-hop start-up latency in seconds, an assumption
#: stated here and never measured (NCCL's per-step latency over NVLink is
#: of this order); ``BW`` is the card's NVLink bandwidth, one direction
#: (``repro_torch.device.NVLINK_BYTES_S``)
ALPHA, BW = 1e-6, NVLINK_BYTES_S


def format_schedule(res, top: int = 20) -> str:
    """Render a compile_run result (with ``messages`` kept) as the collective
    schedule table."""
    n = res["chips"]
    lines = [
        f"# collective schedule: {res['arch']} x {res['shape']} x "
        f"{res['mesh']} ({res['plan']})",
        f"{'kind':20s} {'msg bytes':>14s} {'count':>7s} "
        f"{'total bytes':>14s} {'t_est (ms)':>11s}",
    ]
    agg = {}
    for kind, nbytes, mult in res["messages"]:
        key = (kind, nbytes)
        agg[key] = agg.get(key, 0) + mult
    rows = sorted(agg.items(), key=lambda kv: -(kv[0][1] * kv[1]))
    for (kind, nbytes), count in rows[:top]:
        t = count * (ALPHA * math.log2(max(n, 2)) + nbytes / BW) * 1e3
        lines.append(f"{kind:20s} {nbytes:14,d} {int(count):7d} "
                     f"{int(nbytes * count):14,d} {t:11.3f}")
    lines.append("")
    lines.append(f"total collective bytes/device: "
                 f"{res['collective_bytes_per_dev']:.3e}  "
                 f"(term {res['collective_term_s']:.3f}s at "
                 f"{BW / 1e9:.0f} GB/s)")
    return "\n".join(lines)


def main(argv=None) -> int:
    """DEPRECATED shim: delegates to ``python -m repro_torch trace``."""
    import warnings

    warnings.warn(
        "python -m repro_torch.launch.trace is deprecated; use "
        "`python -m repro_torch trace --config <run.yaml>` (this shim "
        "delegates through the same Run API)", DeprecationWarning,
        stacklevel=2)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--plan", default="")
    ap.add_argument("--top", type=int, default=20)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..run import api as run_api
    from ..run.legacy import legacy_dryrun_doc

    doc = legacy_dryrun_doc(
        {"arch": args.arch, "shape": args.shape, "multi_pod": args.multi_pod,
         "plan_name": args.plan},
        kind="trace", settings={"top": args.top},
        name=f"trace_{args.arch}_{args.shape}".replace("/", "-"))
    run_api.execute_doc(doc, device=args.device,
                        log=lambda m: print(m, flush=True))
    return 0


if __name__ == "__main__":
    sys.exit(main())

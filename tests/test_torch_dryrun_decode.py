"""The port's decode-shape dryrun (``launch/dryrun.py``'s decode branch:
``make_serve_step(model, mesh_ctx)`` on the plan's params, the cache laid
out by ``plans.cache_shardings``) against JAX's, on the CPU.

- Six reduced cases, ``seq_len`` 64 and ``global_batch`` 16 (one with 1,
  where the cache's sequence goes over ``data``), against JAX's dryrun on
  8 forced host devices in one subprocess: JAX's keys and the values of
  ``EQUAL_KEYS``.  ``mem_argument_size_in_bytes`` is what holds
  ``cache_shardings`` to JAX's layout: it is the params', the cache's,
  the tokens' and the positions' bytes on one device, an argument the step
  never reads left out as ``jax.jit`` prunes it (a Mamba2 step's
  positions).
- A decode step run on the CPU under the dryrun's counter (a one-rank
  gloo group, a 1 x 1 mesh) counts the FLOPs, bytes and collectives its
  dryrun on ``meta`` counts, and holds the argument bytes it reports; the
  cache write is counted as JAX counts a ``dynamic-update-slice``.
"""
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch.configs import get_reduced
from repro_torch.configs.shapes import InputShape
from repro_torch.launch import dryrun as DR
from repro_torch.launch import mesh as MESH
from repro_torch.launch.hlo_analysis import CostCounter
from repro_torch.models import build_model
from repro_torch.run import api
from repro_torch.sharding import plans as PL
from test_torch_dryrun import EQUAL_KEYS, _doc

#: case -> (arch, mesh of 8 devices, plan, serve_bf16, global_batch)
CASES = {
    "qwen-fsdp_tp": ("qwen1p5_0p5b", {"dp": 2, "tp": 4}, "fsdp_tp", False,
                     16),
    "qwen-fsdp_tp-serve_bf16": ("qwen1p5_0p5b", {"dp": 2, "tp": 4},
                                "fsdp_tp", True, 16),
    "qwen-fsdp_tp-batch1": ("qwen1p5_0p5b", {"dp": 2, "tp": 4}, "fsdp_tp",
                            False, 1),
    "qwen-ddp": ("qwen1p5_0p5b", {"dp": 8, "tp": 1}, "ddp", False, 16),
    "mamba2-fsdp_tp": ("mamba2_780m", {"dp": 2, "tp": 4}, "fsdp_tp", False,
                       16),
    # EP degree 4 = its 4 experts (on 2 x 4 they do not divide 8: JAX
    # warns and replicates them)
    "moe-serve_ep": ("deepseek_moe_16b", {"dp": 2, "tp": 2}, "serve_ep",
                     False, 16),
}
#: JAX's per-device argument bytes of each case (its dryrun on 8 forced
#: devices, this repo's JAX package)
JAX_BYTES = {"qwen-fsdp_tp": 986944, "qwen-fsdp_tp-serve_bf16": 559040,
             "qwen-fsdp_tp-batch1": 864008, "qwen-ddp": 5383184,
             "mamba2-fsdp_tp": 699808, "moe-serve_ep": 3155008}
MISSING = {"xla_cost_flops_unscaled", "mem_generated_code_size_in_bytes"}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: one thread for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _case_doc(case, out):
    arch, mesh, plan, bf16, batch = CASES[case]
    doc = _doc(arch, {"seq_len": 64, "global_batch": batch,
                      "kind": "decode"}, out, mesh=mesh, plan=plan)
    doc["precision"] = {"component_key": "precision", "variant_key": "policy",
                        "config": {"serve_bf16": bf16}}
    return doc


_JAX = """
import json, os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
from repro.run import api
import test_torch_dryrun_decode as T
out = {}
for case in T.CASES:
    res = api.execute_doc(T._case_doc(case, sys.argv[3] + "/" + case),
                          write_files=False)
    out[case] = {"keys": sorted(res),
                 "equal": {k: res[k] for k in T.EQUAL_KEYS}}
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_decode(tmp_path_factory):
    """JAX's decode dryruns of the six cases on 8 forced host devices, in a
    subprocess (this process's JAX has one device)."""
    import json
    import os
    import subprocess
    import sys

    here = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run(
        [sys.executable, "-c", _JAX, os.path.join(here, "..", "src"), here,
         str(tmp_path_factory.mktemp("jax_decode"))],
        capture_output=True, text=True, timeout=900)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def _quiet(_msg):
    pass


@pytest.mark.parametrize("case", list(CASES))
def test_decode_dryrun_matches_jax(tmp_path, case, jax_decode):
    """JAX's keys but the two torch cannot give, and ``EQUAL_KEYS`` ``==``:
    the plan, the warnings (Qwen's 2 KV heads do not divide 4: its ``wk``,
    ``wv``, ``bk``, ``bv`` replicated over ``model``), the argument bytes
    (the cache's layout: its KV heads, else its sequence, over ``model``;
    its rows over ``data``, else its sequence)."""
    want = jax_decode[case]
    res = api.execute_doc(_case_doc(case, str(tmp_path / "p")), device="cpu",
                          log=_quiet)
    assert set(res) == set(want["keys"]) - MISSING
    for key in EQUAL_KEYS:
        assert res[key] == want["equal"][key], (key, res[key])
    assert res["mem_argument_size_in_bytes"] == JAX_BYTES[case]
    assert res["collective_counts"]["all-gather"] > 0
    assert not dist.is_initialized()


@pytest.mark.parametrize("arch", ["qwen1p5_0p5b", "mamba2_780m"])
def test_cpu_decode_step_counts_what_its_dryrun_counts(arch):
    """One decode step on real tensors under the dryrun's counter (a
    one-rank gloo group, a 1 x 1 mesh) counts what its dryrun on ``meta``
    counts: FLOPs, bytes (each cache write as a ``dynamic-update-slice``:
    its rows and indices read and written, not the cache), collectives,
    argument bytes; the greedy tokens are in the vocab."""
    cfg = get_reduced(arch)
    shape = InputShape("card", 64, 4, "decode")
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
    tok = out[0]
    assert tok.shape == (4,) and int(tok.min()) >= 0 \
        and int(tok.max()) < cfg.vocab
    assert math.isfinite(float(out[1].full_tensor().float().abs().max()))


def test_cache_write_counts_as_a_dynamic_update_slice():
    """``index_put_`` into a buffer moves twice its update and its indices
    (JAX's ``_is_inplace_update``), not the buffer: 1,000 rows of 64 f32
    take 2 rows at 2 int64 indices."""
    buf = torch.zeros(1000, 64)
    idx = torch.tensor([3, 7])
    rows = torch.ones(2, 64)
    with CostCounter() as c:
        buf.index_put_((idx,), rows)
    assert c.bytes == 2 * (2 * 64 * 4 + 2 * 8)

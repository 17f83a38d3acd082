"""Expert parallelism of the port (``repro_torch.models.moe``: ``_capacity``,
``_ep_local``, ``moe_ep``) against JAX's (``repro.models.moe``), on the
CPU.

JAX's ``moe_ep`` runs under ``shard_map`` in a subprocess with 8 forced
host devices, on a ``(data 1, model 4)`` mesh (EP degree 4, one expert a
rank) and a ``(data 2, model 2)`` mesh (tokens sharded over ``data``, two
experts a rank, their ``d_model`` stored sharded over ``data``).  The port
runs its per-rank body ``_ep_local`` for each rank in this process, each
data shard's rows through each EP rank's experts, and sums the partial
outputs, as ``moe_ep``'s ``Partial()`` output is reduced (the distributed
path itself trains on 8 gloo ranks in ``tests/test_torch_pp_train.py``).
Reduced DeepSeekMoE's experts (E 4, top 2, capacity factor 1.25), f32:

- dropless: 64 tokens (T·k = 128 <= 4096, every expert's bucket holds all
  its assignments);
- dropping: 4096 tokens at d_model 32 (T·k = 8192 > 4096), every token's
  first choice expert 0, so expert 0 keeps the first ``C_e`` of its 4096
  assignments in row-major order and drops the rest, as JAX does.

Outputs and the gradients of ``sum(out * cot)`` with respect to the
tokens, the gates and the three expert weights within ``TOL`` of JAX's;
the dropped assignments are the ones JAX's cumsum drops (``==``); and the
result equals ``moe_dense`` with the dropped assignments' gates zeroed.
"""
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import get_reduced
from repro_torch.models import moe as MOE

SRC = os.path.abspath(os.path.join(os.path.dirname(__file__), "..", "src"))
#: f32: the port's products are batched matmuls over buckets, JAX's the
#: same einsums; relative to each tensor's largest element
TOL = 1e-5
MESHES = {"ep4": (1, 4), "dp2_ep2": (2, 2)}
REGIMES = {"dropless": (64, 0), "dropping": (4096, 32)}   # tokens, d_model


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cfg(d_model):
    cfg = get_reduced("deepseek_moe_16b")
    return cfg.with_(d_model=d_model) if d_model else cfg


def _inputs(regime):
    T, d_model = REGIMES[regime]
    cfg = _cfg(d_model)
    m = cfg.moe
    D, E, F = cfg.d_model, m.n_routed, m.d_expert
    rng = np.random.default_rng(5)
    idx = np.stack([rng.permutation(E)[:m.top_k] for _ in range(T)])
    if regime == "dropping":
        idx[:, 0] = 0
        idx[:, 1] = rng.integers(1, E, T)
    gate = rng.uniform(0.1, 1.0, (T, m.top_k))
    gate = gate / gate.sum(1, keepdims=True)
    f32 = np.float32
    return {
        "x": rng.standard_normal((T, D)).astype(f32),
        "idx": idx.astype(np.int32), "gate": gate.astype(f32),
        "w_gate": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(f32),
        "w_up": (rng.standard_normal((E, D, F)) / np.sqrt(D)).astype(f32),
        "w_down": (rng.standard_normal((E, F, D)) / np.sqrt(F)).astype(f32),
        "cot": rng.standard_normal((T, D)).astype(f32),
    }


_JAX = textwrap.dedent('''
    import os
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import sys
    sys.path.insert(0, {src!r})
    import jax, jax.numpy as jnp, numpy as np
    from jax.sharding import Mesh
    from repro.configs import get_reduced
    from repro.models import base as B
    from repro.models import moe as M

    out = {{}}
    for regime, (T, d_model) in {regimes!r}.items():
        cfg = get_reduced("deepseek_moe_16b")
        if d_model:
            cfg = cfg.with_(d_model=d_model)
        inp = dict(np.load(sys.argv[1] + "/" + regime + ".npz"))
        for name, (dp, tp) in {meshes!r}.items():
            mesh = Mesh(np.asarray(jax.devices()[:dp * tp]).reshape(dp, tp),
                        ("data", "model"))
            ctx = B.MeshContext(mesh=mesh, dp_axes=("data",),
                                tp_axis="model", ep_enabled=True,
                                ep_axes=("model",))
            storage = ("data",) if dp > 1 else ()

            def f(x, gate, wg, wu, wd):
                p = {{"w_gate": wg, "w_up": wu, "w_down": wd}}
                return M.moe_ep(cfg, p, x, jnp.asarray(inp["idx"]), gate,
                                ctx, storage)

            args = [jnp.asarray(inp[k]) for k in
                    ("x", "gate", "w_gate", "w_up", "w_down")]
            cot = jnp.asarray(inp["cot"])
            with mesh:
                y = jax.jit(f)(*args)
                g = jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * cot),
                                     argnums=(0, 1, 2, 3, 4)))(*args)
            key = regime + "/" + name
            out[key + "/out"] = np.asarray(y)
            for k, v in zip(("x", "gate", "w_gate", "w_up", "w_down"), g):
                out[key + "/d_" + k] = np.asarray(v)
    np.savez(sys.argv[1] + "/out.npz", **out)
''')


@pytest.fixture(scope="module")
def jax_ref(tmp_path_factory):
    d = tmp_path_factory.mktemp("jax_ep")
    for regime in REGIMES:
        np.savez(d / f"{regime}.npz", **_inputs(regime))
    script = _JAX.format(src=SRC, regimes=REGIMES, meshes=MESHES)
    proc = subprocess.run([sys.executable, "-c", script, str(d)],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return dict(np.load(d / "out.npz"))


def _port_ep(cfg, inp, dp, ep):
    """``moe_ep``'s function on a ``(data dp, model ep)`` mesh: each data
    shard's rows through each EP rank's ``_ep_local``, the partial sums
    added; returns (out, leaf tensors that take gradient, drops)."""
    t = {k: torch.from_numpy(v) for k, v in inp.items()}
    for k in ("x", "gate", "w_gate", "w_up", "w_down"):
        t[k].requires_grad_(True)
    E_loc = cfg.moe.n_routed // ep
    rows = t["x"].shape[0] // dp
    parts, drops = [], 0
    for d in range(dp):
        sl = slice(d * rows, (d + 1) * rows)
        idx = t["idx"][sl].long()
        acc = 0
        for r in range(ep):
            ex = slice(r * E_loc, (r + 1) * E_loc)
            acc = acc + MOE._ep_local(
                cfg, t["x"][sl], idx, t["gate"][sl], t["w_gate"][ex],
                t["w_up"][ex], t["w_down"][ex], e0=r * E_loc, ep_size=ep)
            local, keep, _, _, _ = MOE.capacity_buckets(
                cfg, idx, r * E_loc, E_loc, ep)
            drops += int((local & ~keep).sum())
        parts.append(acc)
    return torch.cat(parts), t, drops


def _kept(idx, n_experts, C_e):
    """Which of the row-major ``[T·k]`` assignments of ``idx`` are among
    the first ``C_e`` of their expert, by a stable sort (not the program's
    running count)."""
    e = idx.reshape(-1)
    order = torch.argsort(e, stable=True)
    counts = torch.bincount(e, minlength=n_experts)
    starts = torch.cumsum(counts, 0) - counts
    rank = torch.empty_like(e)
    rank[order] = torch.arange(e.numel()) - starts[e[order]]
    return rank < C_e


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1e-30)
    return float(np.abs(got - want).max()) / scale


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_ep_matches_jax_moe_ep(jax_ref, regime, mesh):
    inp = _inputs(regime)
    cfg = _cfg(REGIMES[regime][1])
    dp, ep = MESHES[mesh]
    out, t, drops = _port_ep(cfg, inp, dp, ep)
    (out * t["cot"]).sum().backward()
    key = f"{regime}/{mesh}"
    assert _close(out.detach().numpy(), jax_ref[f"{key}/out"]) < TOL
    for k in ("x", "gate", "w_gate", "w_up", "w_down"):
        err = _close(t[k].grad.numpy(), jax_ref[f"{key}/d_{k}"])
        assert err < TOL, (k, err)
    T = inp["x"].shape[0]
    if regime == "dropless":
        assert drops == 0
    else:
        # JAX's cumsum order: each data shard's rows in order, expert 0
        # keeps the first C_e of them
        k = cfg.moe.top_k
        C_total = MOE._capacity(T // dp, k, ep, cfg.moe.capacity_factor)
        E_loc = cfg.moe.n_routed // ep
        C_e = max(8, -(-int(C_total * cfg.moe.capacity_factor) // E_loc))
        assert drops == dp * max(0, T // dp - C_e), (drops, C_e)
        # one EP rank's expert 0 takes every row: it drops; two data
        # shards' halves fit their buckets
        assert (drops > 0) == (mesh == "ep4")


@pytest.mark.parametrize("regime", sorted(REGIMES))
def test_ep_equals_moe_dense_with_dropped_gates_zeroed(regime):
    """The kept assignments exactly: ``moe_dense`` over the same tokens
    with the gates of the assignments the capacity drops set to 0."""
    inp = _inputs(regime)
    cfg = _cfg(REGIMES[regime][1])
    out, t, _ = _port_ep(cfg, inp, 1, 4)
    gate = t["gate"].detach().clone()
    T = gate.shape[0]
    if regime == "dropping":
        C_total = MOE._capacity(T, cfg.moe.top_k, 4, cfg.moe.capacity_factor)
        C_e = max(8, -(-int(C_total * cfg.moe.capacity_factor) // 1))
        gate[C_e:, 0] = 0.0        # expert 0: every row's first choice
    x = t["x"].detach()
    p = {k: t[k].detach() for k in ("w_gate", "w_up", "w_down")}
    want = MOE.moe_dense(cfg, p, x, t["idx"].long(), gate)
    assert _close(out.detach().numpy(), want.numpy()) < TOL


def test_capacity_equals_jax():
    from repro.models import moe as JMOE

    for T in (1, 8, 2048, 2049, 8192, 49152 // 6):
        for k in (1, 2, 6):
            for ep in (1, 2, 4, 64):
                for cf in (1.0, 1.25):
                    assert MOE._capacity(T, k, ep, cf) == \
                        JMOE._capacity(T, k, ep, cf)
    # DeepSeekMoE-16B at 8 x 1024 tokens, EP degree 1: C_e 960
    assert max(8, -(-int(MOE._capacity(8192, 6, 1, 1.25) * 1.25) // 64)) \
        == 960


def test_route_stats_sum_over_shards_to_the_batch_s():
    """The balance loss of a batch from the summed statistics of its
    shards equals ``route``'s over the whole batch."""
    cfg = get_reduced("deepseek_moe_16b")
    g = torch.Generator().manual_seed(3)
    x = torch.randn(96, cfg.d_model, generator=g)
    w = torch.randn(cfg.d_model, cfg.moe.n_routed, generator=g) / 16
    _, _, aux = MOE.route(cfg, w, x)
    stats = sum(MOE.route_stats(cfg, w, part)[2] for part in x.split(24))
    assert abs(float(MOE.balance_loss(cfg, stats, 96)) - float(aux)) \
        <= 1e-6 * float(aux)


def test_ep_counts_its_calls():
    """A wrapper patched over ``_ep_local`` (how ``chip_smoke.py`` counts
    the EP body) sees one call per EP rank, and the drops
    ``capacity_buckets`` gives each call equal those of a stable sort by
    expert, on the dropping regime's assignments."""
    from unittest import mock

    inp = _inputs("dropping")
    cfg = _cfg(REGIMES["dropping"][1])
    calls = []
    body = MOE._ep_local

    def counted(cfg_, x, idx, gate, wg, wu, wd, *, e0, ep_size):
        E_loc = wg.shape[0]
        local, keep, _, _, C_e = MOE.capacity_buckets(cfg_, idx, e0, E_loc,
                                                      ep_size)
        kept = _kept(torch.where(local, idx.reshape(-1) - e0, E_loc)
                     .reshape(idx.shape), E_loc + 1, C_e)
        calls.append((int((local & ~keep).sum()), int((local & ~kept).sum()),
                      bool(torch.equal(keep, local & kept))))
        return body(cfg_, x, idx, gate, wg, wu, wd, e0=e0, ep_size=ep_size)

    with mock.patch.object(MOE, "_ep_local", counted):
        _, _, drops = _port_ep(cfg, inp, 1, 4)
    assert len(calls) == 4
    assert all(same for _, _, same in calls)
    assert [a for a, _, _ in calls] == [b for _, b, _ in calls]
    assert sum(a for a, _, _ in calls) == drops > 0

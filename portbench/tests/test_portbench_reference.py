"""The plain reference against the port at a tiny size on the CPU, and
the benchmark's own weights and traffic."""
import numpy as np
import torch

from conftest import TINY_ARCH, tiny_cell
from portbench import traffic
from portbench.kinds import train
from portbench.reference import lm, params, ssm


def test_ssd_matches_the_ports_recurrence():
    from repro_torch.kernels.ssd.ref import ssd_recurrence_ref

    g = torch.Generator().manual_seed(0)
    b, S, H, P, G, N = 2, 96, 4, 8, 2, 16
    x = torch.randn(b, S, H, P, generator=g)
    dt = torch.rand(b, S, H, generator=g) * 0.5
    A = -torch.rand(H, generator=g) * 4 - 0.5
    Bm = torch.randn(b, S, G, N, generator=g)
    Cm = torch.randn(b, S, G, N, generator=g)
    D = torch.randn(H, generator=g)
    want = ssd_recurrence_ref(x, dt, A, Bm, Cm, D)
    got = ssm.ssd(x, dt, A, Bm, Cm, D, 32)
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4)


def _layer(tree, i):
    return {k: (_layer(v, i) if isinstance(v, dict) else v[i])
            for k, v in tree.items()}


def test_mamba2_layer_matches_the_ports_in_f32():
    from repro_torch.models import ssm as port_ssm
    from repro_torch.models.base import ArchConfig, SSMConfig

    arch = TINY_ARCH
    cfg = ArchConfig(name="t", **{**arch, "ssm": SSMConfig(**arch["ssm"])})
    w = params.make_weights(arch, 7, "cpu")
    lp = _layer(w["ssm_blocks"], 1)
    x = torch.randn(2, 64, arch["d_model"], generator=torch.Generator()
                    .manual_seed(1))
    want = port_ssm.ssm_forward(cfg, lp["ssm"], x)
    got = ssm.mamba2_mixer(arch, lp["ssm"], x, lm.f32_mm)
    torch.testing.assert_close(got, want, rtol=2e-4, atol=2e-5)


def test_weights_are_the_ports_tree_and_repeat(tmp_path):
    cell = tiny_cell()
    arch = cell["config"]["arch"]
    a, b = (params.make_weights(arch, 2**31 + 5, "cpu") for _ in range(2))
    specs = params.param_specs(arch)
    for path, shape, init in specs:
        ta, tb = params.get_leaf(a, path), params.get_leaf(b, path)
        assert tuple(ta.shape) == shape and torch.equal(ta, tb)
    prefix = str(tmp_path / "s")
    traffic.write(cell["traffic"], train.token_ids(cell["config"]), 1,
                  prefix + ".tokens.u32", prefix + ".docidx.npy")
    gym = train.build_gym(cell, prefix)
    train._check_tree(gym.model, specs)
    assert "lm_head" not in a
    ssm_p = a["ssm_blocks"]["ssm"]
    A = -torch.exp(ssm_p["A_log"])
    assert float(A.max()) <= -1.0 and float(A.min()) >= -16.0
    dt = torch.nn.functional.softplus(ssm_p["dt_bias"])
    assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001


def test_traffic_rows_are_the_ports_batches(tmp_path):
    from repro_torch.data.packed_dataset import (ChunkedLMDataset,
                                                 PackedDataset, ShardedLoader)

    cell = tiny_cell()
    tr, n_ids = cell["traffic"], train.token_ids(cell["config"])
    prefix = str(tmp_path / "s")
    traffic.write(tr, n_ids, 99, prefix + ".tokens.u32",
                  prefix + ".docidx.npy")
    again = traffic.stream(tr, n_ids, 99)
    assert np.array_equal(np.fromfile(prefix + ".tokens.u32", np.uint32),
                          again)
    assert not np.array_equal(traffic.stream(tr, n_ids, 100), again)
    assert int(again.max()) < n_ids < cell["config"]["arch"]["vocab"]
    loader = ShardedLoader(ChunkedLMDataset(PackedDataset(prefix),
                                            tr["seq_len"], 0, False),
                           tr["global_batch"])
    for step, batch in enumerate(loader.batches(3)):
        x, y = traffic.rows(prefix + ".tokens.u32", tr["seq_len"],
                            step * tr["global_batch"], tr["global_batch"])
        assert np.array_equal(batch["tokens"], x)
        assert np.array_equal(batch["labels"], y)
    rows = traffic.rows(prefix + ".tokens.u32", tr["seq_len"], 0,
                        3 * tr["global_batch"])[0]
    assert len({r.tobytes() for r in rows}) == len(rows)

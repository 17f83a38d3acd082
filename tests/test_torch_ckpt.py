"""The port's checkpoint format, engine, restore, export and legacy surface
(``repro_torch.ckpt``, ``repro_torch.train.checkpoint``) on the CPU, held
against the JAX package's ``repro.ckpt``.

The cases of ``tests/test_ckpt.py`` that need no mesh and those of
``tests/test_checkpoint.py`` run on the port's own trees; then the two
packages read each other's checkpoints.  JAX writes a reduced-Qwen train
state (``PRNGKey(0)`` and one JAX step) and the port restores it; the port
writes it back and JAX restores that.  Both ways the leaves must be equal
(``==``, bf16 included), and the manifests and leaf files byte-equal when
both carry the same fingerprint.  No tolerance: a checkpoint moves bits.
"""
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.ckpt as JCK
from repro.ckpt import elastic as JEL
from repro.ckpt import export as JEXP
from repro.ckpt import format as JF
from repro.configs import get_reduced as jax_get_reduced
from repro.models import build_model as jax_build_model
from repro.optim.adamw import AdamW as JaxAdamW
from repro.train import checkpoint as JLEGACY
from repro.train import steps as JST
from repro_torch.bridge import params_from_jax
from repro_torch.ckpt import (AsyncCheckpointer, LossyCastWarning,
                              RestoreError, RetentionPolicy, latest_checkpoint,
                              list_checkpoints, read_manifest, restore,
                              restore_train_state, write_checkpoint)
from repro_torch.ckpt import elastic as EL
from repro_torch.ckpt import format as CF
from repro_torch.ckpt.export import export_flat
from repro_torch.configs import get_reduced
from repro_torch.device import NoDeviceError
from repro_torch.models import build_model
from repro_torch.optim.adamw import AdamW
from repro_torch.train import checkpoint as CK
from repro_torch.train import steps as ST
from repro_torch.tree import tree_leaves, tree_map

FP = "sha256:" + "ab" * 32
f32, bf16 = torch.float32, torch.bfloat16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The models here are reduced: their ops are far too small to split
    across threads, and under the suite's parallel workers, which share the
    host's cores, torch's default of one thread per core leaves each op
    waiting on descheduled threads.  One thread for this module, restored
    after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return dict(CF.flatten_with_paths(tree))


def _assert_trees_equal(a, b):
    fa, fb = CF.flatten_with_paths(a), CF.flatten_with_paths(b)
    assert [k for k, _ in fa] == [k for k, _ in fb]
    for (k, x), (_, y) in zip(fa, fb):
        assert x.dtype == y.dtype and x.shape == y.shape, k
        assert torch.equal(x, y), k


def _port_state(arch="qwen1p5_0p5b", seed=0):
    model = build_model(get_reduced(arch))
    gen = torch.Generator().manual_seed(seed)
    return model, ST.init_train_state(model, AdamW(lr=1e-3), gen)


# ---------------------------------------------------------------------------
# format layer
# ---------------------------------------------------------------------------
def test_format_roundtrip_and_manifest(tmp_path):
    tree = {"params": {"w": torch.arange(6, dtype=f32).reshape(2, 3),
                       "b": torch.ones(3)},
            "step": torch.tensor(7, dtype=torch.int32)}
    path = write_checkpoint(str(tmp_path), 7, _flat(tree),
                            specs={"params/w": ["data", None]})
    assert os.path.basename(path) == "step_00000007"
    man = read_manifest(path)
    assert man["step"] == 7 and man["n_leaves"] == 3
    assert list(man["leaves"]) == ["params/b", "params/w", "step"]
    assert man["leaves"]["params/w"]["spec"] == ["data", None]
    assert man["leaves"]["params/w"]["dtype"] == "float32"
    assert man["leaves"]["step"]["shape"] == []
    _assert_trees_equal(restore(tree, path), tree)


def test_uncommitted_and_tmp_dirs_are_invisible(tmp_path):
    d = str(tmp_path)
    write_checkpoint(d, 5, {"x": torch.zeros(2)})
    os.makedirs(os.path.join(d, ".tmp-step_00000009-dead"))
    os.makedirs(os.path.join(d, "step_00000011"))       # no manifest
    assert [s for s, _ in list_checkpoints(d)] == [5]
    assert latest_checkpoint(d)[0] == 5
    assert CF.sweep_aborted(d) == 1
    assert not any(fn.startswith(".tmp-") for fn in os.listdir(d))


def test_dotted_keys_do_not_collide(tmp_path):
    tree = {"a": {"b": torch.ones(2)}, "a.b": torch.full((2,), 5.0)}
    path = write_checkpoint(str(tmp_path), 1, _flat(tree))
    man = read_manifest(path)
    assert man["leaves"]["a/b"]["file"] != man["leaves"]["a.b"]["file"]
    # JAX's writer resolves the collision the same way (same file names)
    jpath = JF.write_checkpoint(
        str(tmp_path / "jax"), 1,
        dict(JF.flatten_with_paths({"a": {"b": np.ones(2, np.float32)},
                                    "a.b": np.full(2, 5.0, np.float32)})))
    assert JF.read_manifest(jpath)["leaves"] == man["leaves"]
    out = restore({"a": {"b": torch.zeros(2)}, "a.b": torch.zeros(2)}, path)
    _assert_trees_equal(out, tree)


# ---------------------------------------------------------------------------
# async engine
# ---------------------------------------------------------------------------
def test_async_save_retention_and_latest(tmp_path):
    d = str(tmp_path / "ck")
    ck = AsyncCheckpointer(d, RetentionPolicy(keep_last=2, keep_every=20))
    tree = {"w": torch.arange(4, dtype=f32), "step": torch.tensor(0)}
    for step in (10, 20, 30, 40):
        ck.save(dict(tree, step=torch.tensor(step, dtype=torch.int32)), step)
    ck.wait()
    assert [s for s, _ in list_checkpoints(d)] == [20, 30, 40]
    assert ck.latest()[0] == 40
    assert [s["step"] for s in ck.saves] == [10, 20, 30, 40]
    assert all(s["bytes"] == 4 * 4 + 4 for s in ck.saves)
    back = ck.restore({"w": torch.zeros(4), "step": torch.tensor(
        0, dtype=torch.int32)}, device="cpu")
    assert int(back["step"]) == 40
    ck.close()


def test_snapshot_does_not_follow_in_place_updates(tmp_path):
    """The port's optimizer writes the state in place: a save must hold
    the values at the save, not the ones written after it."""
    d = str(tmp_path / "ck")
    w = torch.arange(4, dtype=f32)
    ck = AsyncCheckpointer(d)
    ck.save({"w": w}, 1)
    w.add_(100.0)               # the next step's in-place update
    ck.save({"w": w}, 2)        # reuses the buffers once write 1 committed
    w.add_(100.0)
    ck.close()
    assert torch.equal(restore({"w": torch.zeros(4)}, f"{d}/step_00000001")
                       ["w"], torch.arange(4, dtype=f32))
    assert torch.equal(restore({"w": torch.zeros(4)}, f"{d}/step_00000002")
                       ["w"], torch.arange(4, dtype=f32) + 100.0)


def test_async_error_surfaces_on_wait_and_clears_its_latch(tmp_path):
    blocker = tmp_path / "ck"
    blocker.write_text("not a directory")
    ck = AsyncCheckpointer(str(blocker))
    ck.save({"w": torch.zeros(2)}, 1)
    with pytest.raises(OSError):
        ck.wait()
    ck.wait()                               # the latch was cleared
    blocker.unlink()
    ck.save({"w": torch.zeros(2)}, 2)       # and the checkpointer is usable
    ck.close()
    assert [s for s, _ in list_checkpoints(str(blocker))] == [2]


def test_sync_and_async_write_the_same_format(tmp_path):
    _, state = _port_state()
    for name, background in (("a", True), ("s", False)):
        ck = AsyncCheckpointer(str(tmp_path / name), background=background)
        ck.save(state, 3, extra={"fingerprint": FP})
        ck.close()
    a, s = (str(tmp_path / n / "step_00000003") for n in "as")
    with open(f"{a}/manifest.json", "rb") as fa, \
            open(f"{s}/manifest.json", "rb") as fs:
        assert fa.read() == fs.read()
    for entry in read_manifest(a)["leaves"].values():
        with open(f"{a}/{entry['file']}", "rb") as fa, \
                open(f"{s}/{entry['file']}", "rb") as fs:
            assert fa.read() == fs.read(), entry["file"]


def test_checkpointer_registry_components(tmp_path):
    from repro_torch.config.registry import DEFAULT_REGISTRY as REG
    from repro_torch.core.components import register_all

    register_all()
    ck = REG.build("checkpointer", "async", ckpt_dir=str(tmp_path / "c"),
                   keep_last=1)
    assert isinstance(ck, AsyncCheckpointer) and ck.background
    ck.save({"w": torch.zeros(2)}, 1)
    ck.save({"w": torch.zeros(2)}, 2)
    ck.close()
    assert [s for s, _ in list_checkpoints(str(tmp_path / "c"))] == [2]
    sync = REG.build("checkpointer", "sync", ckpt_dir=str(tmp_path / "s"))
    assert not sync.background and sync.retention == RetentionPolicy(3, 0)


def test_later_slices_are_refused(tmp_path):
    """Since A8a the layout arguments behave as JAX's (the name is the
    case's from before): a ``None`` target sharding is the default
    placement, and a plan/mesh restore without the model and optimizer to
    derive the layout from raises JAX's ``RestoreError``."""
    w = np.arange(2, dtype=np.float32)
    path = write_checkpoint(str(tmp_path), 1, {"w": torch.tensor(w)})
    like = {"w": torch.zeros(2)}
    got = restore(like, path, shardings={"w": None})
    want = JEL.restore({"w": jnp.zeros(2)}, path, {"w": None})
    assert np.array_equal(got["w"].numpy(), np.asarray(want["w"]))
    with pytest.raises(EL.RestoreError) as a:
        restore_train_state(like, path, plan=object(), mesh=object())
    with pytest.raises(JEL.RestoreError) as b:
        JEL.restore_train_state({"w": jnp.zeros(2)}, path, plan=object(),
                                mesh=object())
    assert str(a.value) == str(b.value)


def test_restore_entry_point_needs_a_card_or_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the default is the card")
    write_checkpoint(str(tmp_path), 1, {"w": torch.zeros(2)})
    with pytest.raises(NoDeviceError):
        AsyncCheckpointer(str(tmp_path)).restore({"w": torch.zeros(2)})


# ---------------------------------------------------------------------------
# dtype-cast rules
# ---------------------------------------------------------------------------
CAST_DTYPES = ["float32", "bfloat16", "float16", "int32", "int8"]
CAST_PAIRS = [(s, d) for s in CAST_DTYPES for d in CAST_DTYPES if s != d]


@pytest.mark.parametrize("src,dst", CAST_PAIRS,
                         ids=[f"{s}-{d}" for s, d in CAST_PAIRS])
def test_lossy_cast_rules_equal_jax(src, dst):
    assert EL.is_lossy_cast(src, dst) == JEL.is_lossy_cast(
        getattr(jnp, src), getattr(jnp, dst))


def test_lossy_cast_warns_f32_into_bf16(tmp_path):
    path = write_checkpoint(str(tmp_path), 1,
                            {"params/w": torch.linspace(0, 1, 8)})
    with pytest.warns(LossyCastWarning, match="params/w"):
        out = restore({"params": {"w": torch.zeros(8, dtype=bf16)}}, path)
    assert out["params"]["w"].dtype == bf16


def test_widening_cast_does_not_warn(tmp_path):
    path = write_checkpoint(str(tmp_path), 1, {
        "w": torch.ones(4, dtype=torch.float16),
        "n": torch.tensor(3, dtype=torch.int16)})
    with warnings.catch_warnings():
        warnings.simplefilter("error", LossyCastWarning)
        restore({"w": torch.zeros(4), "n": torch.tensor(0.0)}, path)


def test_int_to_narrow_float_warns(tmp_path):
    path = write_checkpoint(str(tmp_path), 1,
                            {"n": torch.tensor(1 << 25, dtype=torch.int32)})
    with pytest.warns(LossyCastWarning):
        restore({"n": torch.tensor(0.0)}, path)


def test_master_weights_suppress_compute_param_warning(tmp_path):
    w = torch.linspace(0, 1, 4)
    path = write_checkpoint(str(tmp_path), 1, _flat(
        {"params": {"w": w, "lone": w}, "opt": {"master": {"w": w}}}))
    like = {"params": {"w": torch.zeros(4, dtype=bf16),
                       "lone": torch.zeros(4, dtype=bf16)},
            "opt": {"master": {"w": torch.zeros(4)}}}
    with pytest.warns(LossyCastWarning) as rec:
        restore(like, path)
    messages = [str(r.message) for r in rec]
    assert any("params/lone" in m for m in messages)
    assert not any("params/w " in m for m in messages)


def test_params_only_restore_still_warns_despite_saved_masters(tmp_path):
    w = torch.linspace(0, 1, 4)
    path = write_checkpoint(str(tmp_path), 1, _flat(
        {"params": {"w": w}, "opt": {"master": {"w": w}}}))
    with pytest.warns(LossyCastWarning, match="params/w"):
        restore({"w": torch.zeros(4, dtype=bf16)}, path, prefix="params")


def test_range_lossy_cast_bf16_to_f16_warns(tmp_path):
    path = write_checkpoint(str(tmp_path), 1,
                            {"w": torch.tensor([70000.0]).to(bf16)})
    with pytest.warns(LossyCastWarning):
        restore({"w": torch.zeros(1, dtype=torch.float16)}, path)


def test_bf16_leaves_roundtrip_bitwise(tmp_path):
    src = {"w": torch.linspace(-2, 2, 16).to(bf16), "s": torch.tensor(1.5)}
    path = write_checkpoint(str(tmp_path), 1, _flat(src))
    assert read_manifest(path)["leaves"]["w"]["dtype"] == "bfloat16"
    with warnings.catch_warnings():
        warnings.simplefilter("error", LossyCastWarning)
        out = restore({"w": torch.zeros(16, dtype=bf16),
                       "s": torch.tensor(0.0)}, path)
    _assert_trees_equal(out, src)


def test_restore_shape_mismatch_and_missing_keys(tmp_path):
    path = write_checkpoint(str(tmp_path), 1, {"a": torch.zeros(2, 3)})
    with pytest.raises(RestoreError, match="shape"):
        restore({"a": torch.zeros(3, 2)}, path)
    with pytest.raises(RestoreError, match="missing"):
        restore({"a": torch.zeros(2, 3), "b": torch.zeros(1)}, path)
    out = restore({"a": torch.zeros(2, 3), "b": torch.ones(1)}, path,
                  strict=False)
    assert torch.equal(out["b"], torch.ones(1))
    with pytest.warns(UserWarning, match="keeping the current value"):
        out = restore({"a": torch.full((4, 3), 9.0)}, path, strict=False)
    assert torch.equal(out["a"], torch.full((4, 3), 9.0))


def test_restore_onto_the_meta_device_target(tmp_path):
    """``load_params`` builds its target on ``meta``: the restore places
    each leaf on the device it is given, keeping the tree's key order."""
    _, state = _port_state()
    path = write_checkpoint(str(tmp_path), 1, _flat(state))
    like = tree_map(lambda t: torch.empty(t.shape, dtype=t.dtype,
                                          device="meta"), state["params"])
    out = restore(like, path, prefix="params", device="cpu")
    assert list(out) == list(like)
    assert {t.device.type for t in tree_leaves(out)} == {"cpu"}
    _assert_trees_equal(out, state["params"])


# ---------------------------------------------------------------------------
# legacy .npz surface
# ---------------------------------------------------------------------------
def test_legacy_roundtrip_exact_and_latest(tmp_path):
    _, state = _port_state()
    d = str(tmp_path / "ck")
    CK.save_checkpoint(state, d, 3)
    path = CK.save_checkpoint(state, d, 12)
    step, latest = CK.latest_checkpoint(d)
    assert step == 12 and latest == path and latest.endswith(
        "step_00000012.npz")
    _assert_trees_equal(CK.restore_checkpoint(state, path), state)


def test_legacy_save_is_atomic_and_sees_both_formats(tmp_path):
    d = str(tmp_path / "ck")
    path = CK.save_checkpoint({"w": torch.zeros(4)}, d, 1)
    assert os.path.exists(path)
    assert not [f for f in os.listdir(d) if ".tmp" in f]
    write_checkpoint(d, 9, {"w": torch.zeros(4)})
    step, newest = CK.latest_checkpoint(d)
    assert step == 9 and os.path.isdir(newest)
    back = CK.restore_checkpoint({"w": torch.ones(4)}, newest)
    assert torch.equal(back["w"], torch.zeros(4))


def test_legacy_restore_warns_on_lossy_cast_and_keeps_bf16(tmp_path):
    path = CK.save_checkpoint({"w": torch.linspace(0, 1, 8)},
                              str(tmp_path / "ck"), 0)
    with pytest.warns(LossyCastWarning):
        out = CK.restore_checkpoint({"w": torch.zeros(8, dtype=bf16)}, path)
    assert out["w"].dtype == bf16
    b = {"w": torch.linspace(-3, 3, 8).to(bf16)}
    path = CK.save_checkpoint(b, str(tmp_path / "b"), 0)
    _assert_trees_equal(CK.restore_checkpoint(
        {"w": torch.zeros(8, dtype=bf16)}, path), b)


def test_legacy_npz_of_jax_restores_in_the_port(tmp_path):
    jstate, _ = _jax_state_and_step()
    path = JLEGACY.save_checkpoint(jax.device_get(jstate),
                                   str(tmp_path / "ck"), 1)
    _, like = _port_state()
    _assert_trees_equal(CK.restore_checkpoint(like, path),
                        params_from_jax(jax.device_get(jstate)))
    got = CK.restore_params(like["params"], path)
    _assert_trees_equal(got, params_from_jax(
        jax.device_get(jstate["params"])))


def test_export_flat_unstacks_layers(tmp_path):
    _, state = _port_state()
    out = np.load(export_flat(state["params"], str(tmp_path / "hf")))
    wq = state["params"]["blocks"]["attn"]["wq"]
    assert np.array_equal(out["model.blocks.1.attn.wq"], wq[1].numpy())
    assert out["model.blocks.0.attn.wq"].ndim == wq.ndim - 1
    assert os.path.exists(tmp_path / "hf" / "export_manifest.json")


# ---------------------------------------------------------------------------
# interop with the JAX package
# ---------------------------------------------------------------------------
_JAX_STATE = {}


def _jax_state_and_step():
    """JAX's reduced-Qwen train state from ``PRNGKey(0)`` after one JAX
    step (built once for the module)."""
    if not _JAX_STATE:
        jm = jax_build_model(jax_get_reduced("qwen1p5_0p5b"))
        jopt = JaxAdamW(lr=1e-3)
        state = JST.init_train_state(jm, jopt, jax.random.PRNGKey(0))
        toks = np.random.default_rng(1).integers(
            3, 512, (2, 32)).astype(np.int32)
        batch = {"tokens": jnp.asarray(toks),
                 "labels": jnp.asarray(np.roll(toks, -1, 1))}
        state, _ = jax.jit(JST.make_train_step(jm, jopt))(state, batch)
        _JAX_STATE["state"] = jax.device_get(state)
    return _JAX_STATE["state"], 1


def _files_equal(a: str, b: str):
    with open(f"{a}/manifest.json", "rb") as fa, \
            open(f"{b}/manifest.json", "rb") as fb:
        assert fa.read() == fb.read()
    for entry in read_manifest(a)["leaves"].values():
        with open(f"{a}/{entry['file']}", "rb") as fa, \
                open(f"{b}/{entry['file']}", "rb") as fb:
            assert fa.read() == fb.read(), entry["file"]


def test_train_state_checkpoints_read_each_other(tmp_path):
    """JAX's checkpoint of a stepped train state restores into the port's
    state ``==`` the bridged arrays (``opt/count`` and ``step`` included);
    the port's checkpoint of it is JAX's, byte for byte, and JAX restores
    it ``==``."""
    jstate, step = _jax_state_and_step()
    jck = JCK.AsyncCheckpointer(str(tmp_path / "jax"), background=False)
    jck.save(jstate, step, extra={"fingerprint": FP})
    jdir = str(tmp_path / "jax" / "step_00000001")
    assert read_manifest(jdir)["n_leaves"] == 44

    _, like = _port_state()
    got = restore(like, jdir)
    _assert_trees_equal(got, params_from_jax(jstate))
    assert got["opt"]["count"].dtype == got["step"].dtype == torch.int32
    assert int(got["opt"]["count"]) == int(got["step"]) == 1

    ck = AsyncCheckpointer(str(tmp_path / "port"), background=False)
    ck.save(got, step, extra={"fingerprint": FP})
    pdir = str(tmp_path / "port" / "step_00000001")
    _files_equal(pdir, jdir)
    back = JCK.restore(jax.tree_util.tree_map(jnp.zeros_like, jstate), pdir)
    for (path, a), b in zip(
            jax.tree_util.tree_leaves_with_path(jstate),
            jax.tree_util.tree_leaves(back)):
        assert np.asarray(a).dtype == np.asarray(b).dtype
        assert np.array_equal(np.asarray(a), np.asarray(b)), path


def test_bf16_params_read_each_other(tmp_path):
    jstate, _ = _jax_state_and_step()
    jparams = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                     jstate["params"])
    jdir = JF.write_checkpoint(str(tmp_path / "jax"), 2,
                               dict(JF.flatten_with_paths(jparams)))
    _, state = _port_state()
    like = tree_map(lambda t: t.to(bf16), state["params"])
    with warnings.catch_warnings():
        warnings.simplefilter("error", LossyCastWarning)
        got = restore(like, jdir)
    _assert_trees_equal(got, params_from_jax(jax.device_get(jparams)))
    pdir = write_checkpoint(str(tmp_path / "port"), 2, _flat(got))
    _files_equal(pdir, jdir)
    back = JCK.restore(jparams, pdir)
    for a, b in zip(jax.tree_util.tree_leaves(jparams),
                    jax.tree_util.tree_leaves(back)):
        assert b.dtype == jnp.bfloat16
        assert np.array_equal(np.asarray(a, np.float32),
                              np.asarray(b, np.float32))


@pytest.mark.parametrize("arch", ["mamba2_780m", "zamba2_2p7b"])
def test_train_state_keys_and_export_equal_jax(arch, tmp_path):
    """Reduced Mamba2 and Zamba2: JAX's and the port's train states have the
    same checkpoint keys in the same order (Zamba2's ``shared_attn``
    leaves included), and the port's flat export of the bridged params is
    JAX's, array for array, with the same ``export_manifest.json``."""
    jm = jax_build_model(jax_get_reduced(arch))
    jstate = jax.device_get(JST.init_train_state(
        jm, JaxAdamW(lr=1e-3), jax.random.PRNGKey(0)))
    _, state = _port_state(arch)
    keys = [k for k, _ in CF.flatten_with_paths(state)]
    assert keys == [k for k, _ in JF.flatten_with_paths(jstate)]
    if arch == "zamba2_2p7b":
        assert any(k.startswith("params/shared_attn/") for k in keys)
    jpath = JEXP.export_flat(jstate["params"], str(tmp_path / "jax"))
    ppath = export_flat(params_from_jax(jstate["params"]),
                        str(tmp_path / "port"))
    with np.load(jpath) as a, np.load(ppath) as b:
        assert a.files == b.files
        for k in a.files:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k
    with open(tmp_path / "jax" / "export_manifest.json", "rb") as fa, \
            open(tmp_path / "port" / "export_manifest.json", "rb") as fb:
        assert fa.read() == fb.read()

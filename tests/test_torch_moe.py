"""The port's MoE (``repro_torch.models.moe`` and the ``moe_block`` of the
decoder) against the JAX package, on the CPU.

Reduced ``deepseek_moe_16b``: 2 layers, the first dense and the second MoE
(4 routed experts of width 128, top 2, 2 shared experts), 4 query heads
over 2 kv heads of 64, with JAX's params carried across by
``repro_torch.bridge``.  Inputs are numpy draws from a seed.

Tolerances, stated per assertion:

- ``route``: the same expert indices (``==``); gates and the balance loss
  within 1e-6 (f32 softmax of f32 logits summed in another order).
- ``moe_forward`` against JAX's: 1e-5 of the output's largest element in
  f32; in bf16 ``LOGIT_TOL`` 3e-2 absolute on outputs of size ~1, where a
  bf16 step is 2**-8..2**-7 and the expert products round at other places.
- the main path (``moe_routed``) against the port's ``moe_dense``: 1e-6 of
  the largest element in f32 (the same products summed in another order);
  in bf16 one bf16 step of the largest element, 2**-7 of it (each routed
  output is rounded to bf16 once on both paths, from f32 sums of another
  order); gradients 1e-5 of each leaf's largest in f32.
- the reduced model: logits within ``LOGIT_TOL`` in bf16 and 5e-4 in f32,
  the router balance loss within 1e-6 in f32 and, in bf16, where each
  package's router reads its own bf16 hidden states, within 3e-3 of its
  value (the loss bound below); the decode contracts of ``tests/test_decode_consistency.py``
  (5e-4 decode vs forward, 5e-3 prefill vs decode, f32).
- one train step: ``tests/test_torch_train.py``'s bounds (3e-3 of the loss
  and 5e-2 of each leaf's largest gradient in bf16; 1e-6 and 1e-4 in f32).
- the paged engine's streams equal JAX's, or part at a near-tie: moving
  each of JAX's logits by at most ``LOGIT_TOL`` makes JAX's own sampler
  draw the port's token (``tests/test_torch_engine.py``'s rule).
"""
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from unittest import mock

import repro.models.moe as JMOE
from repro.configs import get_config as jax_get_config
from repro.configs import get_reduced as jax_get_reduced
from repro.configs.shapes import SHAPES as JAX_SHAPES
from repro.models import build_model as jax_build_model
from repro.serve.engine import ServeEngine as JaxServeEngine
from repro.serve.sampling import sample_tokens as jax_sample_tokens
from repro.serve.workload import shared_prefix_trace as jax_shared_prefix_trace
from repro.telemetry import accounting as JACC
from repro.train import steps as JST
from repro_torch.bridge import params_from_jax
from repro_torch.configs import SHAPES, get_config, get_reduced
from repro_torch.device import MetaGenerator
from repro_torch.models import build_model
from repro_torch.models import moe as MOE
from repro_torch.run.cli import main as cli_main
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.workload import shared_prefix_trace
from repro_torch.telemetry import accounting as ACC
from repro_torch.train import steps as PST
from repro_torch.tree import tree_leaves

ARCH = "deepseek_moe_16b"
QUICKSTART = os.path.join(os.path.dirname(__file__), "..", "examples",
                          "configs", "quickstart.yaml")
LOGIT_TOL = 3e-2
F32_TOL = 5e-4
PREFILL_DECODE_TOL = 5e-3
STEP_GRAD_TOL = 5e-2
STEP_LOSS_TOL = 3e-3
STEP_F32_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Reduced models: their ops are far too small to split across threads,
    and the suite's parallel workers share the host's cores.  One thread
    for this module, restored after it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(x):
    return np.asarray(x, np.float32)


def _jax_params(cfg, seed=0):
    return jax.tree_util.tree_map(
        np.asarray, jax_build_model(cfg).init(jax.random.PRNGKey(seed)))


def _moe_layer(params):
    """The MoE layer's own params (layer 0 of the ``moe_blocks`` stack)."""
    return jax.tree_util.tree_map(lambda a: a[0], params["moe_blocks"]["moe"])


def _acts(model, dtype):
    embed = model.embed_tokens
    return mock.patch.object(model, "embed_tokens",
                             lambda p, t: embed(p, t, dtype=dtype))


@contextlib.contextmanager
def _routes():
    """Record each package's routing of the MoE layer (the first call of a
    run; remat calls it again): JAX's indices with its router input and
    weights, through ``jax.debug.callback`` inside jit, and the port's
    indices."""
    rec = {"jax": [], "port": []}
    # the port's layer routes through ``route_stats`` (the balance loss
    # is formed from its sums: ROADMAP C8)
    jroute, proute = JMOE.route, MOE.route_stats

    def jax_route(cfg, w, x):
        out = jroute(cfg, w, x)
        jax.debug.callback(lambda i, x_, w_: rec["jax"].append(
            (np.asarray(i), _np(x_), _np(w_))), out[0], x, w)
        return out

    def port_route(cfg, w, x):
        out = proute(cfg, w, x)
        rec["port"].append(out[0].detach().numpy().copy())
        return out

    with mock.patch.object(JMOE, "route", jax_route), \
            mock.patch.object(MOE, "route_stats", port_route):
        yield rec


def _flips(rec, k):
    """The tokens whose top-k expert sets differ between the packages (bf16
    hidden states rounded at other places reach the router).  Each must sit
    at a near-tie of JAX's own router: its k-th and (k+1)-th probabilities
    within 2**-7, one bf16 step, of the k-th."""
    jidx, x, w = rec["jax"][0]
    pidx = rec["port"][0]
    flips = [t for t in range(len(jidx)) if set(jidx[t]) != set(pidx[t])]
    logits = x.astype(np.float64) @ w.astype(np.float64)
    probs = np.exp(logits - logits.max(1, keepdims=True))
    probs /= probs.sum(1, keepdims=True)
    for t in flips:
        top = np.sort(probs[t])[::-1]
        assert top[k - 1] - top[k] <= 2 ** -7 * top[k - 1], (t, top)
    return flips


@pytest.fixture(scope="module")
def reduced():
    cfg = jax_get_reduced(ARCH)
    params = _jax_params(cfg)
    return {"jcfg": cfg, "cfg": get_reduced(ARCH), "params": params,
            "jm": jax_build_model(cfg),
            "jp": jax.tree_util.tree_map(jnp.asarray, params),
            "model": build_model(get_reduced(ARCH)),
            "pp": params_from_jax(params)}


# ---------------------------------------------------------------------------
# structure
# ---------------------------------------------------------------------------
def test_full_width_moe_builds_with_jax_tree():
    """28 layers: one dense, then 27 MoE blocks in two stacks; the param
    tree and shapes (on ``meta``) are JAX's, the paged pool is admitted."""
    cfg = get_config(ARCH)
    model = build_model(cfg)
    assert model.kinds == ["dense_block"] + ["moe_block"] * 27
    assert [s[:2] for s in model._stacks()] == [
        ("dense_blocks", "dense_block"), ("moe_blocks", "moe_block")]
    assert model.supports_paged_cache()
    shapes = lambda t: jax.tree_util.tree_map(  # noqa: E731
        lambda a: tuple(a.shape), t)
    want = shapes(jax.eval_shape(jax_build_model(jax_get_config(ARCH)).init,
                                 jax.random.PRNGKey(0)))
    mine = model.init(MetaGenerator())
    got = shapes(mine)
    assert got == want
    assert got["moe_blocks"]["moe"]["w_gate"] == (27, 64, 2048, 1408)
    assert got["moe_blocks"]["moe"]["shared"]["w_down"] == (27, 2816, 2048)
    # JAX's init order (jax's tree_map above sorts the keys)
    assert list(mine["moe_blocks"]["moe"]) == ["router", "w_gate", "w_up",
                                               "w_down", "shared"]


def test_param_axes_match_jax():
    jm = jax_build_model(jax_get_reduced(ARCH))
    assert build_model(get_reduced(ARCH)).param_axes() == jax.tree_util.tree_map(
        tuple, jm.param_axes(), is_leaf=lambda t: isinstance(t, tuple))


@pytest.mark.parametrize("arch,item", [("whisper_tiny", "A7.5"),
                                       ("llava_next_34b", "A7.6")])
def test_unported_archs_name_their_item(arch, item):
    """The last two archs, once refused with their ROADMAP item, build at
    full width: Whisper's encoder-decoder (A7.5), LLaVA's decoder behind
    its 576-patch prefix (A7.6)."""
    from repro_torch.models.encdec import EncDecLM
    from repro_torch.models.transformer import DecoderLM

    model = build_model(get_config(arch))
    if item == "A7.5":
        assert isinstance(model, EncDecLM) and model.cfg.n_encoder_layers == 4
    else:
        assert isinstance(model, DecoderLM) and model.cfg.n_patches == 576
        assert not model.supports_paged_cache()


def test_expert_parallel_mesh_is_refused(reduced):
    """Expert parallelism is no longer refused: ``moe_forward`` takes JAX's
    ``mesh_ctx`` and ``storage_axes``; an EP context with no mesh (no
    devices to spread the experts over) runs the one-device path, as JAX's
    condition says (``tests/test_torch_ep.py`` holds the EP path against
    JAX's)."""
    from repro_torch.models import base as B

    cfg, p = reduced["cfg"], reduced["pp"]["moe_blocks"]["moe"]
    p = {k: (v[0] if not isinstance(v, dict) else
             {kk: vv[0] for kk, vv in v.items()}) for k, v in p.items()}
    x = torch.randn((1, 4, cfg.d_model), generator=torch.Generator()
                    .manual_seed(0))
    ctx = B.MeshContext(tp_axis="model", ep_enabled=True)
    assert not MOE.use_ep(cfg, ctx)
    want = MOE.moe_forward(cfg, p, x)
    got = MOE.moe_forward(cfg, p, x, ctx, ("data",))
    assert all(torch.equal(a, b) for a, b in zip(got, want))


# ---------------------------------------------------------------------------
# the MoE layer against JAX's
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_route_matches_jax(full):
    """At the reduced (4 experts, top 2) and the full routing (64, top 6,
    over d_model 2048): the same indices, gates and balance loss."""
    jcfg = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    rng = np.random.default_rng(2)
    x = rng.standard_normal((96, cfg.d_model), dtype=np.float32)
    w = (rng.standard_normal((cfg.d_model, cfg.moe.n_routed), dtype=np.float32)
         / np.sqrt(cfg.d_model))
    jidx, jgate, jaux = JMOE.route(jcfg, jnp.asarray(w), jnp.asarray(x))
    idx, gate, aux = MOE.route(cfg, torch.from_numpy(w), torch.from_numpy(x))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(gate.numpy(), _np(jgate), atol=1e-6, rtol=0)
    assert abs(float(aux) - float(jaux)) <= 1e-6
    assert float(aux) > 0


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
def test_moe_forward_matches_jax(reduced, act):
    """The layer (routed + shared experts) on [2, 48, 256] activations."""
    p = _moe_layer(reduced["params"])
    x = np.random.default_rng(3).standard_normal((2, 48, 256), dtype=np.float32)
    jout, jaux = JMOE.moe_forward(
        reduced["jcfg"], jax.tree_util.tree_map(jnp.asarray, p),
        jnp.asarray(x).astype(getattr(jnp, act)))
    out, aux = MOE.moe_forward(reduced["cfg"], params_from_jax(p),
                               torch.from_numpy(x).to(getattr(torch, act)))
    assert out.dtype == getattr(torch, act) and out.shape == (2, 48, 256)
    want = _np(jout)
    tol = 1e-5 * float(np.abs(want).max()) if act == "float32" else LOGIT_TOL
    np.testing.assert_allclose(_np(out.float()), want, atol=tol, rtol=0)
    assert abs(float(aux) - float(jaux)) <= 1e-6


@pytest.mark.parametrize("act", ["float32", "bfloat16"])
@pytest.mark.parametrize("T", [2, 40], ids=["gathered", "grouped"])
def test_main_path_matches_moe_dense(reduced, act, T):
    """``moe_routed`` against the plain ``moe_dense`` on the same routing:
    2 tokens x top 2 = 4 assignments, no more than the 4 experts, take the
    per-assignment gather; 40 tokens the grouped products.  Outputs, and in
    f32 the gradients of every expert leaf, the router's (through the
    gates) and the input's."""
    cfg = reduced["cfg"]
    dt = getattr(torch, act)
    p = {k: v.requires_grad_(True) for k, v in params_from_jax(
        _moe_layer(reduced["params"])).items() if k != "shared"}
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (T, 256), dtype=np.float32)).to(dt).requires_grad_(True)
    outs = []
    for fn in (MOE.moe_dense, MOE.moe_routed):
        idx, gate, _ = MOE.route(cfg, p["router"], x)
        out = fn(cfg, p, x, idx, gate)
        grads = torch.autograd.grad(torch.sum(out.float() ** 2),
                                    [x] + list(p.values()))
        outs.append((out, grads))
    (want, wg), (got, gg) = outs
    assert got.dtype == dt and got.shape == (T, 256)
    scale = float(want.detach().float().abs().max())
    tol = 1e-6 * scale if act == "float32" else 2 ** -7 * scale
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=0)
    if act == "float32":
        for name, a, b in zip(["x"] + list(p), wg, gg):
            s = float(a.abs().max())
            assert s > 0, name
            assert float((a - b).abs().max()) <= 1e-5 * s, name


def test_path_is_chosen_by_the_assignment_count(reduced):
    """Which path runs: T·k <= E assignments gather per assignment, more
    are grouped by expert."""
    cfg = reduced["cfg"]
    p = params_from_jax(_moe_layer(reduced["params"]))
    x = torch.randn((2, 256), generator=torch.Generator().manual_seed(0))
    idx, gate, _ = MOE.route(cfg, p["router"], x)
    with mock.patch.object(MOE, "_grouped", side_effect=AssertionError):
        MOE.moe_routed(cfg, p, x, idx, gate)
    x = torch.randn((3, 256), generator=torch.Generator().manual_seed(0))
    idx, gate, _ = MOE.route(cfg, p["router"], x)
    with mock.patch.object(MOE, "_gathered", side_effect=AssertionError):
        MOE.moe_routed(cfg, p, x, idx, gate)


# ---------------------------------------------------------------------------
# the reduced model
# ---------------------------------------------------------------------------
S, B_ = 20, 2


def _tokens(seed):
    return np.random.default_rng(seed).integers(3, 512, (B_, S)).astype(np.int32)


@pytest.mark.parametrize("act", ["bfloat16", "float32"])
def test_forward_logits_and_router_loss_match_jax(reduced, act):
    """Logits at every token whose routing agrees (the MoE layer is the
    last, so a token routed otherwise at a near-tie changes its own logits
    only; ``_flips``), and the balance loss."""
    toks = _tokens(1)
    jm, model = reduced["jm"], reduced["model"]
    with _acts(jm, getattr(jnp, act)), _acts(model, getattr(torch, act)), \
            _routes() as rec, torch.no_grad():
        jl, jaux = jax.jit(jm.apply)(reduced["jp"], {"tokens": jnp.asarray(toks)})
        pl, paux = model.apply(reduced["pp"], {
            "tokens": torch.as_tensor(toks, dtype=torch.int64)})
    keep = np.ones(B_ * S, bool)
    keep[_flips(rec, reduced["cfg"].moe.top_k)] = False
    tol = LOGIT_TOL if act == "bfloat16" else F32_TOL
    np.testing.assert_allclose(_np(pl.float()).reshape(B_ * S, -1)[keep],
                               _np(jl).reshape(B_ * S, -1)[keep], atol=tol,
                               rtol=0)
    lb = float(jaux["router_lb"])
    assert float(paux["router_lb"]) > 0
    assert abs(float(paux["router_lb"]) - lb) <= _lb_tol(act, lb)


def test_decode_matches_forward(reduced):
    """Token-by-token decode from an empty f32 cache (the gathered path: 2
    tokens x top 2 = 4 experts) reproduces the forward's logits (the
    grouped path), f32 activations, within 5e-4."""
    model, params = reduced["model"], reduced["pp"]
    toks = torch.as_tensor(_tokens(2), dtype=torch.int64)
    with _acts(model, torch.float32), torch.no_grad():
        full, _ = model.apply(params, {"tokens": toks})
        cache = model.init_cache(B_, S, dtype=torch.float32, device="cpu")
        outs = []
        for pos in range(S):
            lg, cache = model.decode_step(params, cache, toks[:, pos],
                                          torch.full((B_,), pos))
            outs.append(lg)
    err = float((full - torch.stack(outs, 1)).abs().max())
    assert err < F32_TOL, err


def test_prefill_matches_decode_prefix(reduced):
    """The prefill's cache equals token-by-token decode's: last logits and
    one continuation step from each within 5e-3 (f32)."""
    model, params = reduced["model"], reduced["pp"]
    toks = torch.as_tensor(_tokens(3), dtype=torch.int64)
    with _acts(model, torch.float32), torch.no_grad():
        lpf, cpf = model.prefill(params, {"tokens": toks}, max_len=S + 4,
                                 cache_dtype=torch.float32)
        cdec = model.init_cache(B_, S + 4, dtype=torch.float32, device="cpu")
        for pos in range(S):
            ldec, cdec = model.decode_step(params, cdec, toks[:, pos],
                                           torch.full((B_,), pos))
        assert float((lpf - ldec).abs().max()) < PREFILL_DECODE_TOL
        nxt = torch.argmax(lpf, -1).to(torch.int32)
        l1, _ = model.decode_step(params, cpf, nxt, torch.full((B_,), S))
        l2, _ = model.decode_step(params, cdec, nxt, torch.full((B_,), S))
    assert float((l1 - l2).abs().max()) < PREFILL_DECODE_TOL


def _lb_tol(act, lb):
    """The balance loss: 1e-6 in f32; in bf16 its router probabilities come
    from each package's own bf16 hidden states, so it is held as the loss
    is, to ``STEP_LOSS_TOL`` of its value."""
    return 1e-6 if act == "float32" else STEP_LOSS_TOL * lb


class _Capture:
    """An optimizer that keeps the gradients it is handed."""

    def update(self, grads, state, params):
        self.grads = grads
        return params, state


def _leaves_by_path(tree, prefix=""):
    if isinstance(tree, dict):
        return {p: v for k, sub in tree.items()
                for p, v in _leaves_by_path(sub, f"{prefix}/{k}").items()}
    return {prefix: tree}


@pytest.mark.parametrize("act", ["bfloat16", "float32"])
def test_train_step_matches_jax(reduced, act):
    """One ``make_train_step`` (``remat: full``) against JAX's
    ``value_and_grad`` of ``compute_loss`` on the same params and batch:
    the total loss (cross-entropy plus the router balance loss) and every
    leaf's gradient, the router's included, which reaches it through the
    gates and the balance loss alone.  A token routed otherwise at a
    near-tie (``_flips``) is masked out of the loss on both sides: the MoE
    layer is the last, so its output reaches no other token."""
    jm, pm = reduced["jm"], build_model(reduced["cfg"])
    toks = np.random.default_rng(5).integers(3, 512, (2, 32)).astype(np.int32)
    batch = {"tokens": toks, "labels": np.roll(toks, -1, 1)}

    def both(batch):
        with _acts(jm, getattr(jnp, act)), _acts(pm, getattr(torch, act)), \
                _routes() as rec:
            jb = {k: jnp.asarray(v) for k, v in batch.items()}
            (jloss, jaux), jgrads = jax.jit(jax.value_and_grad(
                lambda p, b: JST.compute_loss(jm, p, b), has_aux=True))(
                    reduced["jp"], jb)
            cap = _Capture()
            state = {"params": params_from_jax(reduced["params"]), "opt": {},
                     "step": torch.zeros((), dtype=torch.int32)}
            _, metrics = PST.make_train_step(pm, cap)(
                state, {k: torch.from_numpy(v) for k, v in batch.items()})
        return jloss, jaux, jgrads, metrics, cap, rec

    jloss, jaux, jgrads, metrics, cap, rec = both(batch)
    flips = _flips(rec, reduced["cfg"].moe.top_k)
    if flips:
        mask = np.ones(toks.size, np.float32)
        mask[flips] = 0.0
        batch["loss_mask"] = mask.reshape(toks.shape)
        jloss, jaux, jgrads, metrics, cap, _ = both(batch)
    loss_tol = STEP_LOSS_TOL if act == "bfloat16" else 1e-6
    lb = float(jaux["router_lb"])
    assert lb > 0
    assert abs(float(metrics["router_lb"]) - lb) <= _lb_tol(act, lb)
    # "loss" is the cross-entropy in both packages; the gradient is of the
    # total, cross-entropy plus the balance loss
    total = float(metrics["ce"]) + float(metrics["router_lb"])
    assert abs(float(metrics["loss"]) - float(jaux["ce"])) <= loss_tol * float(jloss)
    assert abs(total - float(jloss)) <= loss_tol * float(jloss)
    grad_tol = STEP_GRAD_TOL if act == "bfloat16" else STEP_F32_TOL
    want = _leaves_by_path(jax.tree_util.tree_map(_np, jgrads))
    got = _leaves_by_path(cap.grads)
    assert set(got) == set(want)
    assert "/moe_blocks/moe/router" in want
    for path, a in want.items():
        scale = float(np.abs(a).max())
        assert scale > 0, path
        err = float(np.abs(got[path].float().numpy() - a).max())
        assert err <= grad_tol * scale, (path, err / scale)


# ---------------------------------------------------------------------------
# the paged engine
# ---------------------------------------------------------------------------
def _jax_paged_logits(reduced, prompt, gen, bl, C, max_len):
    """JAX's logits for the token after ``prompt + gen``, teacher-forced
    through its paged programs."""
    jm, jp = reduced["jm"], reduced["jp"]
    chunk, step = jax.jit(jm.prefill_chunk), jax.jit(jm.decode_step)
    max_pages = -(-max_len // bl)
    cache = jm.init_paged_cache(max_pages, bl)
    row = jnp.arange(max_pages, dtype=jnp.int32)
    P = len(prompt)
    for lo in range(0, P, C):
        toks = np.zeros((C,), np.int32)
        toks[:min(C, P - lo)] = prompt[lo:lo + C]
        logits, cache = chunk(jp, cache, row, jnp.asarray(toks),
                              jnp.int32(lo), jnp.int32(min(C, P - lo)))
    for j, tok in enumerate(gen):
        logits, cache = step(jp, cache, jnp.asarray([tok], jnp.int32),
                             jnp.asarray([P + j], jnp.int32), pages=row[None],
                             active=jnp.asarray([True]))
    return np.asarray(logits, np.float32)[0]


def _parts_at_a_near_tie(reduced, r, i, port_tok, jax_stream):
    logits = _jax_paged_logits(reduced, r.prompt, jax_stream[:i], 8, 8, 48)
    key = jax.random.fold_in(jax.random.PRNGKey(r.seed), i)[None]
    score = logits / r.temperature + np.asarray(
        jax.random.gumbel(key[0], logits.shape))
    delta = np.where(score > score[port_tok], -LOGIT_TOL, LOGIT_TOL)
    tok = jax_sample_tokens(
        jnp.asarray(logits + delta)[None], key, jnp.float32([r.temperature]),
        jnp.int32([r.top_k]), jnp.float32([r.top_p]))
    return int(tok[0]) == port_tok


def test_paged_engine_streams_match_jax_or_tie(reduced):
    """Both packages' paged engines (2 slots, pages of 8, chunk 8) on one
    prefix-heavy sampled trace: the same cache hits, each stream equal to
    JAX's or parted at a near-tie, and each port stream equal to the
    request run alone in a fresh engine of the same pool shape (``==``)."""
    kw = dict(n_prefixes=2, prefix_len=16, seed=7, prompt_lens=(4, 8),
              gen_tokens=(6,), temperature=0.7, top_k=12, top_p=0.9,
              max_len=48)
    eng = dict(n_slots=2, max_len=48, block_len=8, prefill_chunk=8)
    jout = JaxServeEngine(reduced["jm"], reduced["jp"], **eng).run(
        jax_shared_prefix_trace(6, 512, **kw), realtime=False)
    trace = shared_prefix_trace(6, 512, **kw)
    pout = ServeEngine(reduced["model"], reduced["pp"], **eng).run(
        trace, realtime=False)
    assert pout["prefill_cache_hit_rate"] == jout["prefill_cache_hit_rate"] > 0
    same = 0
    for r, prow, jrow in zip(trace, pout["requests"], jout["requests"]):
        assert prow["cached_tokens"] == jrow["cached_tokens"]
        a, b = prow["gen_ids"], jrow["gen_ids"]
        assert len(a) == len(b) == 6
        if a == b:
            same += 1
            continue
        i = next(j for j in range(6) if a[j] != b[j])
        assert _parts_at_a_near_tie(reduced, r, i, a[i], b), (r.rid, i)
    assert same >= 4
    for r, prow in list(zip(trace, pout["requests"]))[:3]:
        solo = ServeEngine(reduced["model"], reduced["pp"], **eng).run(
            [r], realtime=False)
        assert solo["requests"][0]["gen_ids"] == prow["gen_ids"], r.rid


# ---------------------------------------------------------------------------
# accounting and the CLI
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("full", [False, True], ids=["reduced", "full"])
def test_model_flops_equal_jax(full):
    """6·N_active·D with the inactive routed experts discounted: the port's
    ``meta`` count against JAX's ``eval_shape`` count, every shape."""
    cfg = get_config(ARCH) if full else get_reduced(ARCH)
    jcfg = jax_get_config(ARCH) if full else jax_get_reduced(ARCH)
    for shape in SHAPES:
        got = ACC.model_flops(cfg, SHAPES[shape])
        assert got == JACC.model_flops(jcfg, JAX_SHAPES[shape])
    if full:
        _, n, n_active = ACC.model_flops(cfg, SHAPES["train_4k"])
        assert n == 16317138944 and n_active < n
        four = cfg.with_(n_layers=4)
        _, n4, a4 = ACC.model_flops(four, SHAPES["train_4k"])
        assert n4 == 2208450560
        assert a4 == n4 - 3 * 3 * 2048 * 1408 * (64 - 6)


def test_cli_trains_the_moe_on_the_cpu(tmp_path, capsys):
    """``python -m repro_torch train`` on the quickstart document with
    ``arch.variant_key=deepseek_moe_16b`` (reduced): a settings path of
    the JAX document that used to be refused runs one step."""
    rc = cli_main(["train", "--config", QUICKSTART,
                   "--device", "cpu",
                   "--set", "arch.variant_key=deepseek_moe_16b",
                   "--set", "run.train.steps=1",
                   "--set", f"dataset.config.prefix={tmp_path / 'qs'}",
                   "--set", f"run.output_dir={tmp_path / 'out'}"])
    assert rc == 0
    assert "done: 1 logged points; first loss" in capsys.readouterr().out
    with open(tmp_path / "out" / "result.json") as f:
        result = json.load(f)
    assert len(result["history"]) == 1
    assert np.isfinite(result["history"][0]["loss"])
    flops = ACC.model_flops(get_reduced(ARCH), SHAPES["train_4k"])[2]
    assert result["model_flops_per_step"] == 6.0 * flops * 8 * 64


def test_tree_leaves_are_in_jax_init_order(reduced):
    """``init`` follows JAX's key order, so flattened trees line up with
    JAX's (the checkpoint format writes leaves by path either way)."""
    mine = reduced["model"].init(torch.Generator().manual_seed(0))
    assert list(mine) == ["embed", "final_norm", "lm_head", "dense_blocks",
                          "moe_blocks"]
    assert len(tree_leaves(mine)) == len(jax.tree_util.tree_leaves(
        reduced["params"]))

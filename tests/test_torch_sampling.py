"""The port's sampling head and its threefry noise against ``jax.random`` and
``repro.serve.sampling``, on the CPU.

The noise is JAX's own generator re-implemented in integer tensor ops, so
the key arithmetic and the random bits are compared bit for bit, and the
uniforms of unit range too (bit manipulations and an exact multiply-add;
over another range XLA fuses the multiply-add, an ulp of maxval apart).
The Gumbel noise takes two logarithms, whose last bit differs between XLA's
and PyTorch's CPU implementations: it is held to 1e-5 absolute (values up
to about 16, where an f32 ulp is 2e-6).  The filters (top-k at the k-th value,
the top-p nucleus) are compared as kept sets on logits with no value within
1e-5 of a threshold, and the sampled tokens as equal: one ulp of noise or
of a softmax moves neither.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as JS
from repro_torch.serve import prng
from repro_torch.serve import sampling as PS
from repro_torch.serve.sampling import request_key, sample_tokens, token_key

VOCAB = 151936                  # Qwen1.5's vocabulary: a full-width row
SEEDS = [0, 1, 7, 12345, 700022, 2**31 - 1, -1, -123]
GUMBEL_TOL = 1e-5


def _u32(key) -> np.ndarray:
    return np.asarray(key).astype(np.int64)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_and_fold_in_match_jax(seed):
    base = jax.random.PRNGKey(seed)
    assert request_key(seed).tolist() == _u32(base).tolist()
    for t in (0, 1, 2, 63, 1000, 2**32 - 1):
        want = _u32(jax.random.fold_in(base, t))
        assert token_key(request_key(seed), t).tolist() == want.tolist()
    # a batch of keys, one generation index each, as the tick folds them
    ts = np.arange(5, dtype=np.int32)
    want = _u32(jax.vmap(jax.random.fold_in)(
        jnp.broadcast_to(base, (5, 2)), jnp.asarray(ts)))
    got = token_key(request_key(seed).expand(5, 2),
                    torch.as_tensor(ts))
    assert np.array_equal(got.numpy(), want)


def test_seed_outside_int32_is_refused_like_jax():
    with pytest.raises(ValueError, match="int32"):
        request_key(2**31)


def _keys(n):
    """n distinct keys: request seeds folded with generation indices."""
    return torch.stack([token_key(request_key(s), 3 * s + 1)
                        for s in range(n)])


@pytest.mark.parametrize("n_keys", [1, 8])
def test_random_bits_and_uniform_match_jax_bit_for_bit(n_keys):
    keys = _keys(n_keys)
    jkeys = jnp.asarray(keys.numpy().astype(np.uint32))
    want = jax.vmap(lambda k: jax.random.bits(k, (VOCAB,), jnp.uint32))(jkeys)
    assert np.array_equal(prng.random_bits32(keys, VOCAB).numpy(),
                          _u32(want))
    tiny = float(np.finfo(np.float32).tiny)
    for lo, hi in ((0.0, 1.0), (tiny, 1.0), (-2.0, 3.0)):
        want = np.asarray(jax.vmap(lambda k: jax.random.uniform(
            k, (VOCAB,), minval=lo, maxval=hi))(jkeys))
        got = prng.uniform(keys, VOCAB, lo, hi).numpy()
        if hi - lo == 1.0:      # the Gumbel draw's range: exact
            assert np.array_equal(got, want), (lo, hi)
        else:   # XLA fuses the multiply-add: an ulp of maxval apart
            np.testing.assert_allclose(got, want, rtol=0,
                                       atol=float(np.spacing(np.float32(hi))))


def test_gumbel_matches_jax():
    keys = _keys(8)
    jkeys = jnp.asarray(keys.numpy().astype(np.uint32))
    want = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (VOCAB,)))(jkeys))
    got = prng.gumbel(keys, VOCAB).numpy()
    assert got.dtype == np.float32 and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=GUMBEL_TOL, rtol=0)


def _knobs(B, temperature, top_k, top_p):
    return (np.full((B,), temperature, np.float32),
            np.full((B,), top_k, np.int32), np.full((B,), top_p, np.float32))


def _probe_rows(logits, *knobs):
    """Row r of ``logits`` once per token j, as rows r * V + j, with the
    key ``[0, j]``: the noise below puts a huge bonus on token ``key[1]``,
    so row r * V + j draws j exactly when j survives the filters (a masked
    entry stays -inf, and -inf plus the bonus is still -inf)."""
    R, V = logits.shape
    keys = np.stack([np.zeros(R * V), np.tile(np.arange(V), R)], 1)
    return (np.repeat(logits, V, axis=0), keys.astype(np.int64),
            *(np.repeat(x, V) for x in knobs))


def _kept(draws, R, V):
    return draws.reshape(R, V) == np.arange(V)[None, :]


def jax_kept_set(logits, t, k, p, monkeypatch):
    def bonus(key, shape):
        return jnp.where(jnp.arange(shape[0]) == key[1], 1e30, 0.0)

    monkeypatch.setattr(jax.random, "gumbel", bonus)
    rows, keys, *knobs = _probe_rows(logits, t, k, p)
    draws = JS.sample_tokens(jnp.asarray(rows),
                             jnp.asarray(keys.astype(np.uint32)),
                             *(jnp.asarray(x) for x in knobs))
    monkeypatch.undo()
    return _kept(np.asarray(draws), *logits.shape)


def port_kept_set(logits, t, k, p, monkeypatch):
    def bonus(keys, n):
        return torch.where(torch.arange(n)[None, :] == keys[:, 1:2], 1e30, 0.0)

    monkeypatch.setattr(PS.prng, "gumbel", bonus)
    draws = sample_tokens(*(torch.from_numpy(x)
                            for x in _probe_rows(logits, t, k, p)))
    monkeypatch.undo()
    return _kept(draws.numpy(), *logits.shape)


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.8, 50, 1.0), (0.8, 0, 0.9), (0.7, 20, 0.6), (1.3, 0, 0.5)])
def test_kept_set_matches_jax(temperature, top_k, top_p, monkeypatch):
    """Top-k keeps the k largest scaled logits, top-p the smallest sorted
    prefix with mass >= p: the same tokens in both packages.  The logits
    are a seeded permutation of a 0.01 grid, so no two are tied, and the
    test checks first that no cumulative mass lies within 1e-5 of p."""
    R, V = 3, 256
    rng = np.random.default_rng(11)
    logits = np.stack([rng.permutation(V) * 0.01 for _ in range(R)]
                      ).astype(np.float32)
    t, k, p = _knobs(R, temperature, top_k, top_p)
    scaled = logits / t[:, None]
    for r in range(R):
        top = np.sort(scaled[r])[::-1][: (k[r] or V)]
        probs = np.exp(top - top.max())
        excl = np.cumsum(probs / probs.sum()) - probs / probs.sum()
        assert np.abs(excl - p[r]).min() > 1e-5
    want = jax_kept_set(logits, t, k, p, monkeypatch)
    got = port_kept_set(logits, t, k, p, monkeypatch)
    assert want.any(axis=1).all()
    assert np.array_equal(got, want)
    if top_k:
        assert (want.sum(axis=1) <= top_k).all()


@pytest.mark.parametrize("temperature,top_k,top_p", [
    (0.8, 50, 0.95), (1.0, 0, 1.0), (0.6, 0, 0.9), (1.5, 200, 1.0)])
def test_sampled_tokens_match_jax(temperature, top_k, top_p):
    """Rows of full-width logits, each with its own key: the same token from
    both packages."""
    # 64 keys at the engine's knobs; fewer elsewhere, for JAX's CPU sorts
    B = 64 if (temperature, top_k, top_p) == (0.8, 50, 0.95) else 16
    logits = (np.random.default_rng(3).standard_normal((B, VOCAB)) * 3.0
              ).astype(np.float32)
    keys = _keys(B)
    t, k, p = _knobs(B, temperature, top_k, top_p)
    want = np.asarray(JS.sample_tokens(
        jnp.asarray(logits), jnp.asarray(keys.numpy().astype(np.uint32)),
        jnp.asarray(t), jnp.asarray(k), jnp.asarray(p)))
    got = sample_tokens(torch.from_numpy(logits), keys, torch.from_numpy(t),
                        torch.from_numpy(k), torch.from_numpy(p))
    assert got.dtype == torch.int32
    assert got.numpy().tolist() == want.tolist()
    # the draws really are spread out, not all the argmax
    assert (got.numpy() != logits.argmax(-1)).sum() >= B // 4


def test_greedy_rows_are_the_argmax_beside_sampled_rows():
    """``temperature <= 0`` rows return the argmax whatever their key and
    filters, in the same batch as sampled rows; bf16 logits included."""
    B = 8
    logits = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (B, 1000)).astype(np.float32)).to(torch.bfloat16)
    t = torch.tensor([0.0, 0.9, -1.0, 0.9, 0.0, 0.5, 0.0, 2.0])
    k = torch.tensor([5, 0, 1, 10, 0, 3, 7, 0], dtype=torch.int32)
    p = torch.tensor([0.1, 1.0, 0.5, 0.9, 1.0, 1.0, 0.2, 0.8])
    got = sample_tokens(logits, _keys(B), t, k, p)
    greedy = t <= 0
    assert torch.equal(got[greedy],
                       logits.float().argmax(-1).to(torch.int32)[greedy])
    want = np.asarray(JS.sample_tokens(
        jnp.asarray(logits.float().numpy()).astype(jnp.bfloat16),
        jnp.asarray(_keys(B).numpy().astype(np.uint32)),
        jnp.asarray(t.numpy()), jnp.asarray(k.numpy()),
        jnp.asarray(p.numpy())))
    assert got.tolist() == want.tolist()


def test_top_k_one_and_tiny_top_p_collapse_to_the_argmax():
    """As the JAX package's sampling-head test: top_k=1 at a high
    temperature, and a tiny top_p, both give the argmax."""
    logits = torch.randn((4, 64), generator=torch.Generator().manual_seed(0)) * 3
    keys = _keys(4)
    ones = torch.ones((4,))
    k1 = sample_tokens(logits, keys, ones * 5.0,
                       torch.ones((4,), dtype=torch.int32), ones)
    tiny = sample_tokens(logits, keys, ones,
                         torch.zeros((4,), dtype=torch.int32), ones * 1e-6)
    argmax = logits.argmax(-1).to(torch.int32)
    assert torch.equal(k1, argmax) and torch.equal(tiny, argmax)

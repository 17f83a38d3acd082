"""Work of one ``flash_fwd`` call: q, k and v read once, o written once,
and 4·dh operations for each attended (query, key) pair and head (QKᵀ and
PV, a multiply-add counting 2)."""


def causal_pairs(s: int) -> int:
    return s * (s + 1) // 2


def flash_work(b: int, s: int, h: int, k: int, dh: int, itemsize: int = 2):
    """(bytes, operations) of one causal call at ``[b, s, h, dh]`` queries
    over ``k`` key/value heads."""
    q_bytes = b * s * h * dh * itemsize
    kv_bytes = b * s * k * dh * itemsize
    n_bytes = 2 * q_bytes + 2 * kv_bytes          # q and o; k and v
    n_ops = 4 * dh * causal_pairs(s) * b * h
    return n_bytes, n_ops

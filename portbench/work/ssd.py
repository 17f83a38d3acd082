"""Work of one ``ssd_scan`` call: each input read once, y and the final
state written once, and the products the chunked algorithm needs (2 a
multiply-add): C·Bᵀ over the lower triangle once per group and chunk, M·x
over the lower triangle, C·hᵀ and xᵀ·(B·decay) per head and chunk."""


def ssd_work(b, s, h, p, g, n, q, itemsize=2):
    n_bytes = (2 * b * s * h * p * itemsize          # x, y
               + 2 * b * s * g * n * itemsize        # Bm, Cm
               + b * s * h * 4 + 2 * h * 4           # dt; A, D
               + b * h * p * n * 4)                  # h_final
    tri = q * (q + 1) // 2
    n_ops = 2 * b * (s // q) * (g * tri * n + h * (tri * p + 2 * q * p * n))
    return n_bytes, n_ops

"""Plain PyTorch versions of the SSD chunk scan (port of
``repro.models.ssm.ssd_chunked`` and ``repro.kernels.ssd.ref``).

``ssd_chunked`` is what the CUDA kernel in ``csrc/ssd_scan.cu`` computes:
the wrapper in ``ops.py`` runs it for tensors on the CPU, and
``chip_smoke.py`` holds the kernel against it on the card.
``ssd_recurrence_ref`` is the step-by-step recurrence that defines the scan,
for the tests.  ``ssd_chunked_passes`` computes the scan as the kernel does
(chunk states, the walk over chunks, outputs, with f32 operands split into
bf16 high and low parts for the tensor cores), so the tests hold that
algebra and the split's accuracy on the CPU.  All compute in f32 and return
y in x's dtype.
"""
from __future__ import annotations

import torch


def ssd_chunked(x, dt, A, Bm, Cm, D_skip, chunk: int, h0=None):
    """Chunked SSD scan.

    x [B,S,H,P]; dt [B,S,H] (post-softplus); A [H] (negative); Bm/Cm
    [B,S,G,N]; D_skip [H].  Returns (y [B,S,H,P] in x's dtype, final state
    [B,H,P,N] f32).  ``h0`` is the state before the first chunk (zeros when
    None).
    """
    Bq, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_chunked: seq {S} not divisible by chunk {Q}")
    nc = S // Q
    rep = H // G
    f32 = torch.float32

    xc = x.reshape(Bq, nc, Q, H, Pd).float()
    dtc = dt.reshape(Bq, nc, Q, H).float()
    Bc = Bm.reshape(Bq, nc, Q, G, N).float()
    Cc = Cm.reshape(Bq, nc, Q, G, N).float()
    A = A.float()
    D_skip = D_skip.float()
    h = (torch.zeros((Bq, H, Pd, N), dtype=f32, device=x.device)
         if h0 is None else h0.float())
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    ys = []
    for c in range(nc):
        xq, dtq, Bq_, Cq = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c]
        a = dtq * A                                          # [B,Q,H]
        Sa = torch.cumsum(a, dim=1)                          # inclusive
        # intra-chunk dual (quadratic) form
        CB = torch.einsum("bigr,bjgr->bgij", Cq, Bq_)        # [B,G,Q,Q]
        rel = Sa[:, :, None, :] - Sa[:, None, :, :]          # [B,i,j,H]
        # masked before the exp: above the diagonal rel > 0 and exp(rel)
        # overflows once a chunk's decay passes ~88, and the backward's
        # 0 * inf would make the dt and A gradients NaN (JAX's
        # where-after-exp does); the forward values are the same
        Lmat = torch.exp(torch.where(causal[None, :, :, None], rel,
                                     torch.full((), -torch.inf, dtype=f32,
                                                device=x.device)))
        CBh = CB.repeat_interleave(rep, dim=1)               # [B,H,Q,Q]
        M = CBh.permute(0, 2, 3, 1) * Lmat * dtq[:, None, :, :]
        y_intra = torch.einsum("bijh,bjhp->bihp", M, xq)
        # inter-chunk contribution from the carried state
        Ch = Cq.repeat_interleave(rep, dim=2)                # [B,Q,H,N]
        y_inter = torch.einsum("bihn,bhpn->bihp",
                               Ch * torch.exp(Sa)[..., None], h)
        y = y_intra + y_inter + D_skip[None, None, :, None] * xq
        # state update: h' = exp(S_Q) h + sum_j exp(S_Q - S_j) B_j (dt_j x_j)
        decay_out = torch.exp(Sa[:, -1:, :] - Sa)            # [B,Q,H]
        Bh = Bq_.repeat_interleave(rep, dim=2)               # [B,Q,H,N]
        dBx = torch.einsum("bjhn,bjhp->bhpn",
                           Bh * (decay_out * dtq)[..., None], xq)
        h = torch.exp(Sa[:, -1, :])[:, :, None, None] * h + dBx
        ys.append(y.to(x.dtype))
    y = torch.stack(ys, dim=1).reshape(Bq, S, H, Pd)
    return y, h


def ssd_recurrence_ref(x, dt, A, Bm, Cm, D_skip):
    """O(S) sequential recurrence: the ground-truth definition."""
    Bq, S, H, P = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    rep = H // G
    A = A.float()
    D_skip = D_skip.float()
    h = torch.zeros((Bq, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(S):
        xs = x[:, t].float()                                 # [B,H,P]
        dts = dt[:, t].float()                               # [B,H]
        bh = Bm[:, t].float().repeat_interleave(rep, dim=1)  # [B,H,N]
        ch = Cm[:, t].float().repeat_interleave(rep, dim=1)
        dA = torch.exp(dts * A)
        h = h * dA[..., None, None] + torch.einsum("bhn,bhp,bh->bhpn",
                                                   bh, xs, dts)
        ys.append(torch.einsum("bhpn,bhn->bhp", h, ch)
                  + D_skip[None, :, None] * xs)
    return torch.stack(ys, dim=1).to(x.dtype)


def _parts(v, split: bool):
    """``v`` as the kernel feeds it to the tensor cores: [v] where bf16 holds
    it exactly, else [hi, lo] with hi = bf16(v), lo = bf16(v - hi)."""
    v = v.float()
    if not split:
        return [v]
    hi = v.to(torch.bfloat16).float()
    return [hi, (v - hi).to(torch.bfloat16).float()]


def _product(eq, a, b):
    """einsum of two operands given as parts: hi.hi + lo.hi + hi.lo (the
    lo.lo term is dropped, as in the kernel); each product of bf16 parts is
    exact in f32 and the sum is taken in f32."""
    out = torch.einsum(eq, a[0], b[0])
    if len(a) > 1:
        out = out + torch.einsum(eq, a[1], b[0])
    if len(b) > 1:
        out = out + torch.einsum(eq, a[0], b[1])
    return out


def ssd_chunked_passes(x, dt, A, Bm, Cm, D_skip, chunk: int):
    """The SSD scan as ``csrc/ssd_scan.cu`` decomposes it, from a zero state.

    (a) per chunk: Sa = cumsum(dt A), the log-decay Sa_Q and the chunk's own
    state s_c = sum_j exp(Sa_Q - Sa_j) dt_j x_j^T B_j, and C B^T once per
    group; (b) the walk h_c = exp(Sa_Q) h_{c-1} + s_c, keeping the state
    entering each chunk; (c) y = (C B^T . L . dt) x + exp(Sa) C h_{c-1}^T +
    D x.  Products take f32 operands in hi/lo bf16 parts (x, B and C too
    when they are f32), as the kernel's tensor-core products do.  Same
    arguments and returns as ``ssd_chunked``.
    """
    Bq, S, H, Pd = x.shape
    G, N = Bm.shape[2], Bm.shape[3]
    Q = chunk
    if Q < 1 or S % Q:
        raise ValueError(f"ssd_chunked_passes: seq {S} not divisible by "
                         f"chunk {Q}")
    nc, rep = S // Q, H // G
    wide = x.dtype == torch.float32        # x, B, C need a low part too
    xc = x.reshape(Bq, nc, Q, H, Pd).float()
    dtc = dt.reshape(Bq, nc, Q, H).float()
    Bc = Bm.reshape(Bq, nc, Q, G, N).float()
    Cc = Cm.reshape(Bq, nc, Q, G, N).float()
    Bp, Cp, xp = (_parts(t, wide) for t in (Bc, Cc, xc))

    # (a) chunk states and C B^T
    Sa = torch.cumsum(dtc * A.float(), dim=2)                 # [B,nc,Q,H]
    ldec = Sa[:, :, -1]                                        # [B,nc,H]
    w = torch.exp(ldec[:, :, None] - Sa) * dtc
    xw = _parts(xc * w[..., None], True)
    Bh = [t.repeat_interleave(rep, dim=3) for t in Bp]         # [B,nc,Q,H,N]
    states = _product("bcjhp,bcjhn->bchpn", xw, Bh)
    CB = _product("bcign,bcjgn->bcgij", Cp, Bp)                # [B,nc,G,Q,Q]

    # (b) the walk over chunks
    h = torch.zeros((Bq, H, Pd, N), dtype=torch.float32, device=x.device)
    h_in = []
    for c in range(nc):
        h_in.append(h)
        h = torch.exp(ldec[:, c])[:, :, None, None] * h + states[:, c]
    h_in = torch.stack(h_in, dim=1)                            # [B,nc,H,P,N]

    # (c) outputs
    causal = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    L = torch.exp(Sa[:, :, :, None, :] - Sa[:, :, None, :, :])  # [B,nc,i,j,H]
    M = torch.where(causal[None, None, :, :, None],
                    CB.repeat_interleave(rep, dim=2).permute(0, 1, 3, 4, 2)
                    * L * dtc[:, :, None], torch.zeros((), device=x.device))
    y_intra = _product("bcijh,bcjhp->bcihp", _parts(M, True), xp)
    Ch = [t.repeat_interleave(rep, dim=3) for t in Cp]         # [B,nc,Q,H,N]
    y_inter = _product("bcihn,bchpn->bcihp", Ch, _parts(h_in, True))
    y = (y_intra + torch.exp(Sa)[..., None] * y_inter
         + D_skip.float()[:, None] * sum(xp))
    return y.reshape(Bq, S, H, Pd).to(x.dtype), h

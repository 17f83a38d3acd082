"""Plain PyTorch versions of the SSD chunk scan (port of
``repro.models.ssm.ssd_chunked`` and ``repro.kernels.ssd.ref``).

``ssd_chunked`` is what the CUDA kernel in ``csrc/ssd_scan.cu`` computes:
the wrapper in ``ops.py`` runs it for tensors on the CPU, and
``chip_smoke.py`` holds the kernel against it on the card.
``ssd_recurrence_ref`` is the step-by-step recurrence that defines the scan,
for the tests.  Both compute in f32 and return y in x's dtype.
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
        Lmat = torch.where(causal[None, :, :, None], torch.exp(rel),
                           torch.zeros((), dtype=f32, device=x.device))
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

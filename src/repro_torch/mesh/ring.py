"""Ring attention: the additive-Schwarz neighbour exchange applied to
sequence-parallel attention.  Counterpart of ``repro.mesh.ring``.

Q stays put (each rank owns a contiguous block of the sequence); K/V
blocks travel round the ring one hop a step (:meth:`repro_torch.core.comm.
Comm.shift`, the paper's ``communicate``), and the online-softmax state
(acc, m, l) accumulates as in the flash kernel, so after n hops every rank
has attended over the whole sequence while holding 1/n of K/V at a time.

This is the long-context alternative to the K/V gather of the training
forward (:meth:`repro_torch.mesh.grad_comm.TrainMesh.attention_kv`), which
is cheaper under GQA at moderate S but holds the whole K/V.  It is plain
PyTorch, as the reference's is plain ``jnp``: no TPU kernel reaches it.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def ring_attention(q, k, v, comm, *, causal: bool = True):
    """q, k, v: (B, S_local, H, D), this rank's block of the sequence, the
    blocks laid out in rank order over ``comm``.  Returns (B, S_local, Hq,
    D) in q's dtype; every rank must call it (2 (n - 1) point-to-point
    exchanges a call)."""
    B, Sq, Hq, D = q.shape
    Hkv = k.shape[2]
    G = Hq // Hkv
    n, rank = comm.size(), comm.rank()
    f32 = torch.float32
    dev = q.device
    qg = (q.reshape(B, Sq, Hkv, G, D) * D ** -0.5).to(f32)
    q_pos = rank * Sq + torch.arange(Sq, device=dev)
    acc = torch.zeros(B, Hkv, G, Sq, D, dtype=f32, device=dev)
    m = torch.full((B, Hkv, G, Sq), NEG_INF, dtype=f32, device=dev)
    l = torch.zeros(B, Hkv, G, Sq, dtype=f32, device=dev)
    kc, vc = k, v
    for i in range(n):
        src = (rank - i) % n                     # whose block we now hold
        k_pos = src * Sq + torch.arange(Sq, device=dev)
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, kc.to(f32))
        if causal:
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s,
                            torch.tensor(NEG_INF, dtype=f32, device=dev))
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", p, vc.to(f32))
        m = m_new
        if i + 1 < n:                            # pass the blocks on
            kc = comm.shift(kc, offset=1)
            vc = comm.shift(vc, offset=1)
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, Hq, D).to(q.dtype)

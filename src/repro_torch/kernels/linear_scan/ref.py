"""Plain PyTorch versions of the RWKV6 linear-scan kernel.

The function is the RWKV6/GLA recurrence with a data-dependent decay per
channel, for r, k, v, logw of (B, T, H, K) and a bonus u of (H, K):

    out_t = r_t . S_{t-1} + (r_t . (u * k_t)) v_t
    S_t   = diag(exp(logw_t)) S_{t-1} + k_t v_t^T

``rwkv6_ref`` is the step-by-step oracle (the reference's
``kernels/linear_scan/ref.py``, with an initial state). ``rwkv6_split_ref``
is the step form in the CUDA kernel's order: 16-step chunks, a readout
split over row groups and summed in group order, the bonus as the
kernel's tree. ``rwkv6_chunked``
ports the reference model's chunked scan (``models/ssm.py``
``rwkv6_chunked``): exact intra-chunk pair weights in the difference form
``exp(Lx_i - L_j)``, clamped at 0 where masked, and the carried state
between chunks; any T (a ragged tail is padded with decay 1 and k = v = 0).
The CPU path of the port takes ``rwkv6_chunked``, so the CPU tests compare
with the reference model's own arithmetic; on the card the CUDA kernel is
held against all three. Both compute in float32 and return float32 outputs
(B, T, H, K) and a float32 final state (B, H, K, K).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _zero_state(r: torch.Tensor, init_state):
    B, _, H, K = r.shape
    if init_state is None:
        return torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    return init_state.float()


def rwkv6_ref(r, k, v, logw, u, init_state=None):
    """The recurrence one step at a time, in float32."""
    r32, k32, v32, lw = (a.float() for a in (r, k, v, logw))
    u32 = u.float()
    S = _zero_state(r, init_state)
    outs = []
    for t in range(r.shape[1]):
        rt, kt, vt = r32[:, t], k32[:, t], v32[:, t]  # (B, H, K)
        outs.append(torch.einsum("bhk,bhkv->bhv", rt, S)
                    + (rt * u32 * kt).sum(-1, keepdim=True) * vt)
        S = S * torch.exp(lw[:, t])[..., None] + kt[..., :, None] * vt[..., None, :]
    return torch.stack(outs, dim=1), S


def rwkv6_chunked(r, k, v, logw, u, chunk: int, init_state=None):
    """The recurrence chunk by chunk (chunk length ``min(chunk, T)``), in
    float32. Each chunk's own terms (the pair-weighted products within it,
    the bonus, its summary k v^T) are independent of the carried state, so
    they are formed for all chunks at once, batched over the chunk axis;
    only the state's recurrence between chunks, one multiply-add a chunk,
    is a loop (then the carried state's readout, batched again). Every
    term is the reference's per-chunk arithmetic, in its order; the loop
    over chunks launches two kernels a chunk where a loop over the whole
    body launched about twenty. The chunk length sizes the (B, nc, Q, Q,
    H, K) pair tensor; it does not change the function."""
    B, T, H, K = r.shape
    Q = min(chunk, T)
    if T % Q:
        # pad with logw = 0 (decay 1) and k = v = 0: the state is unaffected
        padn = Q - T % Q
        y, final = rwkv6_chunked(*(F.pad(a, (0, 0, 0, 0, 0, padn)) for a in (r, k, v, logw)),
                                 u, chunk, init_state)
        return y[:, :T], final
    nc = T // Q
    rc, kc, vc, lwc = (a.float().reshape(B, nc, Q, H, K) for a in (r, k, v, logw))
    ii = torch.arange(Q, device=r.device)
    strictly = (ii[:, None] > ii[None, :])[:, :, None, None]  # (Q, Q, 1, 1)
    L = torch.cumsum(lwc, dim=2)  # inclusive, within each chunk
    Lx = L - lwc  # exclusive
    # pair decays exp(Lx_i - L_j) for j < i (<= 0, exact); the clamp keeps
    # masked (j >= i) entries finite
    diff = torch.clamp(Lx[:, :, :, None] - L[:, :, None, :], max=0.0)  # (B, nc, Q, Q, H, K)
    w_pair = torch.where(strictly, torch.exp(diff), 0.0)
    att = torch.einsum("bcihk,bcijhk,bcjhk->bchij", rc, w_pair, kc)
    y = torch.einsum("bchij,bcjhv->bcihv", att, vc)
    y = y + torch.einsum("bcihk,hk,bcihk->bcih", rc, u.float(), kc)[..., None] * vc  # bonus
    last = L[:, :, -1:]  # (B, nc, 1, H, K)
    kv = torch.einsum("bcjhk,bcjhv->bchkv", kc * torch.exp(last - L), vc)
    decay = torch.exp(last[:, :, 0])[..., None]  # (B, nc, H, K, 1)
    S = _zero_state(r, init_state)
    prevs = []
    for c in range(nc):  # the state entering each chunk
        prevs.append(S)
        S = S * decay[:, c] + kv[:, c]
    y = y + torch.einsum("bcihk,bchkv->bcihv", rc * torch.exp(Lx), torch.stack(prevs, dim=1))
    return y.reshape(B, T, H, K), S


CHUNK_STEPS = 16  # the kernel's chunk (csrc: kSteps)
ROWS = 8  # state rows a kernel thread holds (csrc: kRT): the readout's row groups


def _bonus_tree(r, u, k):
    """r . (u * k) over the last axis of 64 as the kernel forms it: four
    lanes in order, then a butterfly over the 16 four-lane parts."""
    x = r * u * k
    p = ((x[..., 0::4] + x[..., 1::4]) + x[..., 2::4]) + x[..., 3::4]  # (..., 16)
    while p.shape[-1] > 1:
        half = p.shape[-1] // 2
        p = p[..., :half] + p[..., half:]
    return p[..., 0]


def rwkv6_split_ref(r, k, v, logw, u, init_state=None):
    """The recurrence one step at a time in float32, in the kernel's order:
    per step, the readout partial of each group of ``ROWS`` state rows with
    S_{t-1}, then the update; per 16-step chunk, the partials summed in
    group order and the bonus added. K = 64."""
    B, T, H, K = r.shape
    G = K // ROWS
    r32, k32, v32 = (a.float() for a in (r, k, v))
    u32 = u.float()
    S = _zero_state(r, init_state)
    ys = []
    for c0 in range(0, T, CHUNK_STEPS):
        sl = slice(c0, min(c0 + CHUNK_STEPS, T))
        rc, kc, vc = r32[:, sl], k32[:, sl], v32[:, sl]
        wc = torch.exp(logw[:, sl].float())
        bonus = _bonus_tree(rc, u32, kc)  # (B, n, H)
        parts = []
        for s in range(rc.shape[1]):
            parts.append(torch.einsum("bhgi,bhgij->bhgj", rc[:, s].reshape(B, H, G, ROWS),
                                      S.reshape(B, H, G, ROWS, K)))
            S = S * wc[:, s][..., None] + kc[:, s][..., :, None] * vc[:, s][..., None, :]
        P = torch.stack(parts, dim=1)  # (B, n, H, G, K)
        y = P[..., 0, :]
        for g in range(1, G):
            y = y + P[..., g, :]
        ys.append(y + bonus[..., None] * vc)
    return torch.cat(ys, dim=1), S

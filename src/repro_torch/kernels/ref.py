"""Plain PyTorch oracles (counterparts of ``repro/kernels/ref.py``).

These are the semantics of the kernels, written as straightforward tensor
code.  On a CPU tensor the kernel dispatch (``ops``) runs them; on the
card the hand-written kernels are held against them.

* ``attention_ref`` — causal / sliding-window GQA attention (K1's contract).
* ``fit_chunk`` / ``ce_chunk_size`` — chunk sizing for the chunked CE head.
* ``ssd_chunked_ref`` / ``ssd_naive`` — the Mamba2 SSD scan (K2's contract)
  and its sequential recurrence.
* ``wkv6_chunked_ref`` / ``wkv6_naive`` — the RWKV6 WKV recurrence (K3's
  contract) and its sequential form.

Where the reference runs ``lax.scan`` over chunks or steps, these run a
Python loop; where it contracts several operands in one ``einsum``, these
contract them pairwise in a fixed order.  The WKV6 functions also take the
bonus ``u`` per client, (U, H, N) with B // U consecutive batch rows per
client, besides the reference's (H, N): the fed step folds N clients, each
with its own ``u``, into one batch.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

NEG_INF = -1e30


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, sliding_window: int = 0
                  ) -> torch.Tensor:
    """q (B,S,Hq,d), k/v (B,L,Hkv,d) -> (B,S,Hq,d).  fp32 softmax.

    GQA is a grouped einsum: query head h reads KV head h // G, and the
    KV heads are never repeated."""
    B, S, Hq, d = q.shape
    L, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qg = q.reshape(B, S, Hkv, G, d)
    scale = 1.0 / math.sqrt(d)
    scores = torch.einsum("bshgd,blhd->bhgsl", qg, k).float() * scale
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(L, device=q.device)[None, :]
    mask = torch.ones((S, L), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos <= qpos
    if sliding_window:
        mask &= kpos > qpos - sliding_window
    scores = torch.where(mask, scores, torch.full((), NEG_INF,
                                                  device=q.device))
    probs = torch.softmax(scores, dim=-1).to(v.dtype)
    out = torch.einsum("bhgsl,blhd->bshgd", probs, v)
    return out.reshape(B, S, Hq, d)


def fit_chunk(seq_len: int, chunk: int) -> int:
    """Largest divisor of ``seq_len`` that is <= ``chunk``."""
    c = min(chunk, seq_len)
    while seq_len % c:
        c -= 1
    return c


def ce_chunk_size(seq_len: int, chunk: int) -> int:
    """``fit_chunk`` with a sanity floor for the chunked-CE head.

    Raises when the best divisor degrades below a quarter of the request
    (e.g. prime seq lengths end at C=1, which silently destroys the
    memory win chunking exists for).
    """
    c = fit_chunk(seq_len, chunk)
    floor = max(1, min(chunk, seq_len) // 4)
    if c < floor:
        raise ValueError(
            f"ce_chunk={chunk} is incompatible with seq_len={seq_len}: the "
            f"largest divisor <= chunk is {c} (< floor {floor}), which "
            "degrades the chunked head to near token-at-a-time.  Pick a "
            "chunk sharing a factor with the sequence length.")
    return c


# ---------------------------------------------------------------------------
# Mamba2 SSD
# ---------------------------------------------------------------------------

def _segsum(x: torch.Tensor) -> torch.Tensor:
    """x (..., Q) -> (..., Q, Q): out[i,j] = sum_{k=j+1..i} x_k (i>=j),
    -inf else; built from the inclusive cumsum, out[i,j] = cum_i - cum_j."""
    Q = x.shape[-1]
    cum = torch.cumsum(x, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    keep = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=x.device))
    return torch.where(keep, diff, torch.full((), -math.inf,
                                              device=x.device))


def _initial_state(initial_state: Optional[torch.Tensor], shape,
                   device) -> torch.Tensor:
    if initial_state is None:
        return torch.zeros(shape, dtype=torch.float32, device=device)
    return initial_state.float()


def ssd_chunked_ref(x: torch.Tensor, log_decay: torch.Tensor,
                    b: torch.Tensor, c: torch.Tensor, chunk: int = 64,
                    initial_state: Optional[torch.Tensor] = None,
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mamba2 SSD: y_t = c_t . S_t,  S_t = exp(log_decay_t) S_{t-1} +
    b_t x_t^T.

    Shapes: x (B,S,H,P), log_decay (B,S,H) (<= 0), b/c (B,S,N) (ngroups=1,
    shared over heads).  Returns (y (B,S,H,P) in x's dtype, final_state
    (B,H,P,N) fp32).  Computed in fp32, as the reference's mixed-dtype
    einsums promote to fp32."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    chunk = fit_chunk(S, chunk)
    nc, Q = S // chunk, chunk

    xc = x.reshape(B, nc, Q, H, P).float()
    bc = b.reshape(B, nc, Q, N).float()
    cc = c.reshape(B, nc, Q, N).float()
    a = log_decay.reshape(B, nc, Q, H).permute(0, 3, 1, 2).float()  # (B,H,nc,Q)
    a_cum = torch.cumsum(a, dim=-1)                                 # inclusive

    # intra-chunk ("diagonal block") term: ((C B^T) * L) @ x
    L = torch.exp(_segsum(a))                                       # (B,H,nc,Q,Q)
    cb = torch.einsum("bcln,bcsn->bcls", cc, bc)                    # (B,nc,Q,Q)
    scores = cb[:, None] * L                                        # (B,H,nc,Q,Q)
    y_diag = torch.einsum("bhcls,bcshp->bclhp", scores, xc)

    # per-chunk end states (contribution of this chunk's inputs), fp32
    decay_states = torch.exp(a_cum[..., -1:] - a_cum)               # (B,H,nc,Q)
    x_dec = xc * decay_states.permute(0, 2, 3, 1)[..., None]        # (B,nc,Q,H,P)
    chunk_states = torch.einsum("bclhp,bcln->bchpn", x_dec, bc)

    # inter-chunk recurrence
    chunk_decay = torch.exp(a_cum[..., -1])                         # (B,H,nc)
    s = _initial_state(initial_state, (B, H, P, N), x.device)
    prev = []
    for i in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, :, i, None, None] + chunk_states[:, i]
    prev_states = torch.stack(prev, dim=2)                          # (B,H,nc,P,N)

    # inter-chunk ("off-diagonal") output term
    c_state = torch.einsum("bcln,bhcpn->bhclp", cc, prev_states)
    y_off = (c_state * torch.exp(a_cum)[..., None]).permute(0, 2, 3, 1, 4)

    y = (y_diag + y_off).reshape(B, S, H, P)
    return y.to(x.dtype), s


def ssd_naive(x: torch.Tensor, log_decay: torch.Tensor, b: torch.Tensor,
              c: torch.Tensor, initial_state: Optional[torch.Tensor] = None,
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential SSD recurrence (slow oracle).  Like the reference, it
    returns the final state in x's dtype."""
    B, S, H, P = x.shape
    N = b.shape[-1]
    s = _initial_state(initial_state, (B, H, P, N), x.device)
    ys = []
    for t in range(S):
        xt = x[:, t].float()                                        # (B,H,P)
        bt, ct = b[:, t].float(), c[:, t].float()                   # (B,N)
        s = (s * torch.exp(log_decay[:, t].float())[..., None, None]
             + xt[..., :, None] * bt[:, None, None, :])
        ys.append(torch.einsum("bhpn,bn->bhp", s, ct))
    return torch.stack(ys, dim=1).to(x.dtype), s.to(x.dtype)


# ---------------------------------------------------------------------------
# RWKV6 WKV
# ---------------------------------------------------------------------------

def _u_rows(u: torch.Tensor, batch: int) -> torch.Tensor:
    """The bonus per batch row, fp32: (H, N) -> (1, H, N); (U, H, N) ->
    (B, H, N), each row of ``u`` repeated for its B // U consecutive batch
    rows (the gradient sums back per client)."""
    u = u.float()
    if u.dim() == 2:
        return u[None]
    if batch % u.shape[0]:
        raise ValueError(f"u has {u.shape[0]} rows, which do not divide "
                         f"the batch of {batch}")
    return torch.repeat_interleave(u, batch // u.shape[0], dim=0)


def wkv6_naive(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               log_w: torch.Tensor, u: torch.Tensor,
               initial_state: Optional[torch.Tensor] = None,
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sequential WKV6.

    Shapes: r/k (B,S,H,N), v (B,S,H,M), log_w (B,S,H,N) (<0, data-dependent
    decay), u (H,N) or (U,H,N) bonus.  Recurrence (per head):
        out_t = r_t @ (diag(u) k_t v_t^T + S_{t-1})
        S_t   = diag(exp(log_w_t)) S_{t-1} + k_t v_t^T
    Returns (out (B,S,H,M) in v's dtype, final_state (B,H,N,M) fp32).
    """
    B, S, H, N = r.shape
    M = v.shape[-1]
    s = _initial_state(initial_state, (B, H, N, M), r.device)
    uu = _u_rows(u, B)[..., None]                                   # (B|1,H,N,1)
    outs = []
    for t in range(S):
        rt, kt, vt, lwt = (a[:, t].float() for a in (r, k, v, log_w))
        kv = kt[..., :, None] * vt[..., None, :]                    # (B,H,N,M)
        outs.append(torch.einsum("bhn,bhnm->bhm", rt, uu * kv + s))
        s = torch.exp(lwt)[..., None] * s + kv
    return torch.stack(outs, dim=1).to(v.dtype), s


def wkv6_chunked_ref(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     log_w: torch.Tensor, u: torch.Tensor, chunk: int = 16,
                     initial_state: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Chunked WKV6: parallel within a chunk, a loop over chunks.

    Exact (no decay clamping): intra-chunk pairwise decays are ``exp`` of
    *masked* log-differences, so nothing overflows however strong the
    data-dependent decay.  It builds a (Q, Q, N) tensor per (batch, head,
    chunk), so ``chunk`` stays modest (16 by default)."""
    B, S, H, N = r.shape
    M = v.shape[-1]
    chunk = fit_chunk(S, chunk)
    nc, Q = S // chunk, chunk

    rc = r.reshape(B, nc, Q, H, N).float()
    kc = k.reshape(B, nc, Q, H, N).float()
    vc = v.reshape(B, nc, Q, H, M).float()
    lw = log_w.reshape(B, nc, Q, H, N).float()
    cum = torch.cumsum(lw, dim=2)                                   # inclusive
    total = cum[:, :, -1]                                           # (B,nc,H,N)

    # intra-chunk: A[t,i] = sum_n r_t k_i exp(cum_{t-1} - cum_i), i < t;
    # diagonal bonus A[t,t] = sum_n r_t u k_t
    cum_tm1 = torch.cat([torch.zeros_like(cum[:, :, :1]), cum[:, :, :-1]],
                        dim=2)                                      # exclusive
    dlog = cum_tm1[:, :, :, None] - cum[:, :, None, :]              # (B,nc,t,i,H,N)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=r.device),
                     diagonal=-1)[:, :, None, None]
    decay = torch.where(tri, torch.exp(torch.where(tri, dlog, 0.0)), 0.0)
    scores = (rc[:, :, :, None] * kc[:, :, None, :] * decay).sum(-1)  # (B,nc,t,i,H)
    bonus = (rc * _u_rows(u, B)[:, None, None] * kc).sum(-1)       # (B,nc,t,H)
    eye = torch.eye(Q, device=r.device)[:, :, None]
    scores = scores + bonus[:, :, :, None, :] * eye
    y_intra = torch.einsum("bctih,bcihm->bcthm", scores, vc)

    # per-chunk state contribution: sum_i exp(total - cum_i) k_i v_i^T
    k_dec = kc * torch.exp(total[:, :, None] - cum)                 # (B,nc,Q,H,N)
    chunk_states = torch.einsum("bcihn,bcihm->bchnm", k_dec, vc)
    chunk_decay = torch.exp(total)                                  # (B,nc,H,N)

    # inter-chunk recurrence
    s = _initial_state(initial_state, (B, H, N, M), r.device)
    prev = []
    for i in range(nc):
        prev.append(s)
        s = s * chunk_decay[:, i, ..., None] + chunk_states[:, i]
    prev_states = torch.stack(prev, dim=1)                          # (B,nc,H,N,M)

    # inter-chunk output: r_t decayed to the chunk start @ carried state
    r_dec = rc * torch.exp(cum_tm1)
    y_inter = torch.einsum("bcthn,bchnm->bcthm", r_dec, prev_states)

    y = (y_intra + y_inter).reshape(B, S, H, M)
    return y.to(v.dtype), s

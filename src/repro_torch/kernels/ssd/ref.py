"""Plain PyTorch versions of the Mamba2 SSD scan: the oracle and the chunked form.

- :func:`ssd_naive` ports ``repro.kernels.ssd.ref.ssd_naive``, the
  sequential recurrence and ground truth::

      S_t = exp(la_t)·S_{t-1} + B_t ⊗ x_t     (state: (h, n, p))
      y_t = C_t · S_t

- :func:`ssd_chunked_ref` ports ``repro.models.layers.ssd_chunked``
  (``layers.py:479-533``), which the reference's model calls and its
  ``ssd_chunked_ref`` re-exports: within a chunk a masked-decay product
  ``(C Bᵀ ⊙ exp(La_q − La_k))_{k≤q} · xdt``, across chunks a state carried
  in fp32. It keeps the reference's two guards: ``diff`` is masked to -inf
  *before* the ``exp`` (never the exp of a positive masked difference), and
  the state that crosses chunks stays fp32. Mixed-type products follow
  JAX's promotion (a bf16 operand meets fp32 as fp32): ``C Bᵀ`` stays in
  the inputs' type, everything after it is fp32, and ``y`` is rounded to
  xdt's type once. It is the CPU path of
  :func:`repro_torch.kernels.ssd.ops.ssd` and, run in fp32, the oracle the
  CUDA kernel is held to.

Shapes: xdt (b, s, h, p) dt-scaled inputs, la (b, s, h) fp32 log decay
(≤ 0), B and C (b, s, n), one group shared over the heads; y (b, s, h, p).

Both take the cumulative log decay La from :func:`cumsum`, which adds in
the reference's order. The decay weights are ``exp`` of differences of
La, so one ulp of La is an error of that size in a weight: 3e-5 at |La| ≈
400 (a chunk of 256 at decays near -1.5), more than the 1e-5 the port is
held to. torch's own cumsum adds in other orders (in double on the CPU).
"""
from __future__ import annotations

import torch

SCAN_BLOCK = 16


def _sequential_cumsum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive cumulative sum along dim 0, one fp32 add at a time, in order."""
    out = torch.empty_like(x)
    acc = out[0] = x[0]
    for i in range(1, x.shape[0]):
        acc = out[i] = acc + x[i]
    return out


def cumsum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """Inclusive cumulative sum along ``dim`` in the order of the
    reference's ``jnp.cumsum`` on the CPU (XLA rewrites the cumulative
    reduce-window as a scan of blocks of 16: in order within each block,
    the block totals scanned the same way, then each total's exclusive
    prefix added to its block), so the two agree bitwise. The CUDA kernel
    adds in the same order (``csrc/ssd.cu``)."""
    x = x.movedim(dim, 0)
    n = x.shape[0]
    if n <= SCAN_BLOCK:
        return _sequential_cumsum(x).movedim(0, dim)
    nb = -(-n // SCAN_BLOCK)
    pad = x.new_zeros((nb * SCAN_BLOCK - n, *x.shape[1:]))
    blocks = torch.cat([x, pad]).reshape(nb, SCAN_BLOCK, *x.shape[1:])
    within = _sequential_cumsum(blocks.movedim(1, 0)).movedim(0, 1)
    prefix = cumsum(within[:, -1], 0)
    out = torch.cat([within[:1], within[1:] + prefix[:-1, None]])
    return out.reshape(nb * SCAN_BLOCK, *x.shape[1:])[:n].movedim(0, dim)


def ssd_naive(xdt, la, B, C) -> torch.Tensor:
    """Sequential recurrence → y (b, s, h, p)."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    state = torch.zeros((b, h, n, p), dtype=xdt.dtype, device=xdt.device)
    ys = []
    for t in range(s):
        state = torch.exp(la[:, t])[..., None, None] * state + torch.einsum(
            "bn,bhp->bhnp", B[:, t], xdt[:, t])
        ys.append(torch.einsum("bn,bhnp->bhp", C[:, t], state))
    return torch.stack(ys, dim=1)


def ssd_chunked_ref(xdt, la, B, C, chunk: int) -> torch.Tensor:
    """Chunked SSD scan → y (b, s, h, p) in xdt's type. Raises
    ``ValueError`` unless ``s % chunk == 0`` (the reference asserts it)."""
    b, s, h, p = xdt.shape
    n = B.shape[-1]
    if chunk < 1 or s % chunk != 0:
        raise ValueError(f"ssd: sequence length {s} is not a multiple of chunk {chunk}")
    c, q = s // chunk, chunk
    x = xdt.reshape(b, c, q, h, p)
    la = la.reshape(b, c, q, h)
    Bc = B.reshape(b, c, q, n)
    Cc = C.reshape(b, c, q, n)

    La = cumsum(la, dim=2)  # (b,c,q,h) inclusive cumulative log decay
    # intra-chunk: quadratic within the chunk
    G = torch.einsum("bcqn,bckn->bcqk", Cc, Bc)  # (b,c,q,q) in the inputs' type
    # decay exp(La_i - La_j) for i >= j; masked BEFORE the exp
    diff = La[:, :, :, None, :] - La[:, :, None, :, :]  # (b,c,q,k,h)
    mask = torch.tril(torch.ones((q, q), dtype=torch.bool, device=xdt.device))
    diff = torch.where(mask[None, None, :, :, None], diff, -torch.inf)
    M = G[..., None] * torch.exp(diff)  # (b,c,q,k,h) fp32
    f32 = M.dtype  # fp32 for fp32 and bf16 inputs
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", M, x.to(f32))

    # chunk-boundary states
    seg = torch.exp(La[:, :, -1:, :] - La)  # (b,c,q,h): decay from t to the chunk's end
    S_c = torch.einsum("bcqh,bcqn,bcqhp->bchnp", seg, Bc.to(f32), x.to(f32))
    chunk_decay = torch.exp(La[:, :, -1, :])  # (b,c,h)
    carry = torch.zeros((b, h, n, p), dtype=f32, device=xdt.device)
    S_prev = []  # the state entering each chunk, kept in fp32
    for ci in range(c):
        S_prev.append(carry)
        carry = chunk_decay[:, ci, :, None, None] * carry + S_c[:, ci].to(f32)
    S_prev = torch.stack(S_prev, dim=1)  # (b,c,h,n,p)

    y_inter = torch.einsum("bcqn,bchnp,bcqh->bcqhp", Cc.to(f32), S_prev, torch.exp(La))
    return (y_intra + y_inter).to(xdt.dtype).reshape(b, s, h, p)

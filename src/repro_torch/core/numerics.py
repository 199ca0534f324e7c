"""Numeric conventions of the queueing core (port of ``repro.core.numerics``).

The normalising constants ``Z_{n,m}`` span hundreds of orders of
magnitude, so the core runs in log space and in float64.  The JAX package
flips a global x64 switch; the port instead names ``DTYPE`` explicitly at
every tensor it creates and never changes torch's default dtype.
"""
from __future__ import annotations

# contract: padded-n — reductions here are on the bitwise padding contract

import torch

DTYPE = torch.float64
NEG_INF = -1e30  # used instead of -inf to keep gradients NaN-free


def safe_log(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp_min(x, 1e-300))


class _SeqSum(torch.autograd.Function):
    """:func:`seqsum` with its gradient written out: the output's gradient
    broadcast along ``dim``, contiguous (the values the loop's own graph
    passes back, in the input's layout, with no graph node per entry)."""

    @staticmethod
    def forward(ctx, x, dim):
        ctx.dim, ctx.shape = dim, x.shape
        x = torch.movedim(x, dim, 0)
        acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
        for v in x:
            acc = acc + v
        return acc

    @staticmethod
    def backward(ctx, g):
        return g.unsqueeze(ctx.dim).expand(ctx.shape).contiguous(), None


def seqsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Strictly left-to-right float sum along ``dim`` (a Python loop).

    ``torch.sum`` on CUDA reduces in a tree whose association changes with
    the length, so a zero-padded sum is not bitwise the unpadded one.  A
    sequential loop is: appended zeros satisfy ``acc + 0 == acc`` exactly
    and the real entries keep their left-to-right association.  Used for
    every client-axis reduction on the padded-``n`` bitwise contract.

    Its gradient is the output's, broadcast along ``dim`` into a
    contiguous tensor.  The loop's own graph passes back the same values
    in a transposed layout, and a later reduction over a transposed
    gradient (the broadcast of a per-row scalar, as in ``p / seqsum(p)``)
    rounds differently as the batch of rows grows: a row's gradient would
    depend on the rows beside it.
    """
    return _SeqSum.apply(x, dim)


def seqcumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    """Strictly left-to-right inclusive prefix sum along ``dim``; the last
    entry doubles as a padding-stable :func:`seqsum`."""
    x = torch.movedim(x, dim, 0)
    acc = torch.zeros(x.shape[1:], dtype=x.dtype, device=x.device)
    out = []
    for v in x:
        acc = acc + v
        out.append(acc)
    if not out:
        return torch.movedim(x.clone(), 0, dim)
    return torch.movedim(torch.stack(out), 0, dim)


def map_tensors(fn, tree):
    """``fn`` on every tensor of a tensor, a tuple or a ``NamedTuple``
    (nested); every other leaf (``None``, a float, an int) as it is."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, tuple):
        leaves = [map_tensors(fn, x) for x in tree]
        return (type(tree)(*leaves) if hasattr(tree, "_fields")
                else tuple(leaves))
    return tree


# ---------------------------------------------------------------------------
# correctly rounded fused multiply-add from float64 operations
# ---------------------------------------------------------------------------

_SPLIT = 134217729.0  # 2**27 + 1: Veltkamp's splitter for binary64


def _two_sum(a, b):
    """``a + b = s + e`` exactly (Knuth)."""
    s = a + b
    bb = s - a
    return s, (a - (s - bb)) + (b - bb)


def _two_prod(a, b):
    """``a * b = p + e`` exactly (Dekker, with Veltkamp splitting)."""
    p = a * b
    c = _SPLIT * a
    ah = c - (c - a)
    al = a - ah
    c = _SPLIT * b
    bh = c - (c - b)
    bl = b - bh
    return p, ((ah * bh - p) + ah * bl + al * bh) + al * bl


def fma(a, b, c) -> torch.Tensor:
    """``a * b + c`` with one rounding, from float64 operations.

    The event engine's energy integral accumulates as fused multiply-adds:
    that is how the JAX reference's compiled CPU program rounds it, and the
    port keeps the same rounding on every device by emulating the FMA
    exactly (Boldo and Melquiond's algorithm: an exact product and sum,
    the low part rounded to odd, then one round to nearest).  Each step is
    a separate PyTorch operation, so no compiler contracts it further.
    """
    a, b, c = torch.broadcast_tensors(torch.as_tensor(a), torch.as_tensor(b),
                                      torch.as_tensor(c))
    uh, ul = _two_prod(a, b)
    th, tl = _two_sum(c, uh)
    vh, vl = _two_sum(tl, ul)
    # round to odd: an inexact low part with an even significand moves one
    # ulp toward the exact value
    even = (vh.contiguous().view(torch.int64) & 1) == 0
    toward = torch.where(vl > 0, torch.inf, -torch.inf).to(vh.dtype)
    v = torch.where((vl != 0) & even, torch.nextafter(vh, toward), vh)
    return th + v

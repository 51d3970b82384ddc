"""Context-parallel primitives over the ``context`` dimension, the port's
counterparts of the JAX package's ``parallel/context.py``.

The JAX functions run inside ``shard_map`` over a global array; here each
one runs in the rank's own process on its local block (the rank's band of
rows, or its windows) and moves data with ``all_to_all_single`` over the
context group of a ``core.meshes.ContextParallel``.  Each collective is a
``torch.autograd.Function`` whose backward is the adjoint collective, so
the gradients a rank gets are the one device's for the rows it holds.

- ``halo_exchange``: a boundary strip of rows to the neighbouring rank of
  the ring ("up": receive the next rank's first rows, "down": the previous
  rank's last rows), the ``ppermute`` of the JAX function;
- ``cp_shift_roll`` / ``cp_unshift_roll`` / ``cp_roll2d``: the cyclic
  rolls of shifted windows, one halo strip each;
- ``halo_rows``: the rank's rows with its neighbours' edge rows above and
  below (zeros, or nothing, past the map's edge), the halo a convolution
  or a kernel's 3x3 taps read; both strips in one collective;
- ``cp_window_attention`` (identity projections, with the rolls),
  ``cp_window_attention_qkv`` (the rank's windows, the shift mask's rows of
  its windows) and ``ulysses_window_attention`` (heads sharded by two
  all-to-alls): the window attention through ``ops.window_attention``, so
  the kernel runs on each rank's windows;
- ``all_reduce_sum`` (``reduce_sum`` without autograd): a sum over the
  group, the adjoint of itself (the LN+MDTA stats of the rank's band);
- ``sharded_fft2`` / ``sharded_ifft2``: the 2-D FFT over (rows, columns)
  of a row-sharded array: FFT over the columns, all-to-all to shard the
  columns, FFT over the rows, all-to-all back;
- ``gather_rows`` (backward: the sum of every rank's cotangent for the
  rank's rows, a reduce-scatter), ``gather_replicated`` (backward: the
  rank's rows of the cotangent; for a function every rank computes
  alike, such as the loss) and ``slice_rows``.

With one rank in the group every primitive is its single-device op.
``sent_bytes`` counts the bytes this process sent to the other ranks of
its group and ``collectives`` the collectives it made, by kind
("exchange": the halo strips, "all_to_all": the transposes and gathers,
"all_reduce": the sums).
"""
from __future__ import annotations

import collections
import functools
from typing import Optional

import torch

from ..ops.window_attention import window_attention
from ..ops.windows import mask_rows, window_partition, window_reverse


def _dist():
    import torch.distributed as dist

    return dist


# bytes sent to the other ranks of the context group, and collectives made,
# by kind
sent_bytes = collections.Counter()
collectives = collections.Counter()


def _real(t):
    """A complex tensor as its real view (collectives move real data)."""
    return torch.view_as_real(t) if t.is_complex() else t


def _like(out, complex_: bool):
    return torch.view_as_complex(out) if complex_ else out


def _exchange(t, cp, dst: int, src: int):
    """Send ``t`` to context rank ``dst`` and return the tensor of the same
    shape that context rank ``src`` sends (one ``all_to_all_single``)."""
    cx, t = t.is_complex(), _real(t).contiguous()
    if cp.size == 1:
        return _like(t.clone(), cx)
    n = t.numel()
    if dst != cp.index:
        sent_bytes["exchange"] += n * t.element_size()
    collectives["exchange"] += 1
    send = [n if j == dst else 0 for j in range(cp.size)]
    recv = [n if j == src else 0 for j in range(cp.size)]
    out = torch.empty_like(t)
    _dist().all_to_all_single(out.view(-1), t.view(-1), recv, send,
                              group=cp.group)
    return _like(out, cx)


def _all_to_all(t, cp):
    """(n, ...) -> (n, ...): chunk j of dim 0 goes to context rank j, and
    chunk j of the result came from context rank j."""
    cx, t = t.is_complex(), _real(t).contiguous()
    if cp.size == 1:
        return _like(t.clone(), cx)
    out = torch.empty_like(t)
    sent_bytes["all_to_all"] += (t.numel() // cp.size * (cp.size - 1)
                                 * t.element_size())
    collectives["all_to_all"] += 1
    _dist().all_to_all_single(out, t, group=cp.group)
    return _like(out, cx)


class _Shift(torch.autograd.Function):
    """Each context rank sends ``t`` ``step`` ranks on around the ring and
    receives what the rank ``step`` back sends; the backward sends the
    cotangent the other way."""

    @staticmethod
    def forward(ctx, t, cp, step):
        ctx.cp, ctx.step = cp, step
        return _exchange(t, cp, (cp.index + step) % cp.size,
                         (cp.index - step) % cp.size)

    @staticmethod
    def backward(ctx, g):
        cp, step = ctx.cp, ctx.step
        return (_exchange(g, cp, (cp.index - step) % cp.size,
                          (cp.index + step) % cp.size), None, None)


class _AllToAll(torch.autograd.Function):
    """``_all_to_all``, its own adjoint."""

    @staticmethod
    def forward(ctx, t, cp):
        ctx.cp = cp
        return _all_to_all(t, cp)

    @staticmethod
    def backward(ctx, g):
        return _all_to_all(g, ctx.cp), None


def all_to_all(t, cp):
    """Differentiable ``_all_to_all`` over dim 0 (its size the group's)."""
    return _AllToAll.apply(t, cp)


def reduce_sum(t, cp):
    """The sum of ``t`` over the context group (one ``all_reduce``), a new
    tensor; ``t`` itself without a group.  Counted as a ring all-reduce
    sends: 2 (n - 1) / n of the tensor a rank."""
    if cp is None or cp.size == 1:
        return t
    out = t.contiguous().clone()
    n = cp.size
    sent_bytes["all_reduce"] += (2 * (n - 1) * out.numel()
                                 * out.element_size() // n)
    collectives["all_reduce"] += 1
    _dist().all_reduce(out, group=cp.group)
    return out


class _AllReduce(torch.autograd.Function):
    """``reduce_sum``, its own adjoint: every rank's output is the sum, so
    the cotangent of a rank's input is the sum of the ranks' cotangents."""

    @staticmethod
    def forward(ctx, t, cp):
        ctx.cp = cp
        return reduce_sum(t, cp)

    @staticmethod
    def backward(ctx, g):
        return reduce_sum(g, ctx.cp), None


def all_reduce_sum(t, cp):
    """Differentiable ``reduce_sum`` (the stats of LN+MDTA's attention,
    summed over the ranks' bands)."""
    if cp is None or cp.size == 1:
        return t
    return _AllReduce.apply(t, cp)


# --------------------------------------------------------------------------
# halo exchange and the rolls


def halo_exchange(x_local, halo: int, cp, direction: str = "up",
                  dim: int = 1):
    """Move a ``halo``-row boundary strip to the neighbouring rank.

    direction="up": each rank receives the FIRST ``halo`` rows of the NEXT
    rank (wrapping), what a cyclic roll by -halo needs.  direction="down":
    each rank receives the LAST ``halo`` rows of the PREVIOUS rank (for a
    roll by +halo).  x_local: the rank's block, rows along ``dim`` (1 for
    (B, H_loc, W, C)); returns the received strip."""
    if direction == "up":
        return _Shift.apply(x_local.narrow(dim, 0, halo), cp, -1)
    rows = x_local.shape[dim]
    return _Shift.apply(x_local.narrow(dim, rows - halo, halo), cp, 1)


def cp_shift_roll(x_local, shift: int, cp):
    """Distributed ``torch.roll(x, -shift, 1)`` of the row-sharded image:
    one halo strip."""
    if shift == 0:
        return x_local
    incoming = halo_exchange(x_local, shift, cp, "up")
    return torch.cat([x_local[:, shift:], incoming], 1)


def cp_unshift_roll(x_local, shift: int, cp):
    """The inverse roll (+shift)."""
    if shift == 0:
        return x_local
    incoming = halo_exchange(x_local, shift, cp, "down")
    return torch.cat([incoming, x_local[:, :-shift]], 1)


def cp_roll2d(x_local, shift_h: int, shift_w: int, cp):
    """Distributed ``torch.roll(x, (shift_h, shift_w), (1, 2))`` of a
    row-sharded (B, H_loc, W, C) block: the column roll is the rank's own,
    the row roll moves one |shift_h|-row strip.  |shift_h| <= H_loc."""
    if abs(shift_h) > x_local.shape[1]:
        raise ValueError(f"cp_roll2d: a shift of {shift_h} rows over a band "
                         f"of {x_local.shape[1]}")
    if shift_w:
        x_local = torch.roll(x_local, shift_w, 2)
    if shift_h < 0:
        x_local = cp_shift_roll(x_local, -shift_h, cp)
    elif shift_h > 0:
        x_local = cp_unshift_roll(x_local, shift_h, cp)
    return x_local


def _swap(to_prev, to_next, cp):
    """Send ``to_prev`` to the previous rank of the ring and ``to_next`` to
    the next, in one ``all_to_all_single``; returns (the next rank's
    ``to_prev``, the previous rank's ``to_next``).  A destination that is
    both (two ranks, or one) gets the pair in that order."""
    a, b = (_real(t).contiguous() for t in (to_prev, to_next))
    n, c = cp.size, cp.index
    prev, nxt = (c - 1) % n, (c + 1) % n
    na, nb = a.numel(), b.numel()
    send, recv, chunks = [], [], []
    for j in range(n):
        send.append((na if j == prev else 0) + (nb if j == nxt else 0))
        recv.append((na if j == nxt else 0) + (nb if j == prev else 0))
        chunks += ([a.view(-1)] if j == prev else []) + (
            [b.view(-1)] if j == nxt else [])
    out = a.new_empty(sum(recv))
    if n == 1:
        out.copy_(torch.cat(chunks))
    else:
        sent_bytes["exchange"] += (na + nb) * a.element_size()
        collectives["exchange"] += 1
        _dist().all_to_all_single(out, torch.cat(chunks), recv, send,
                                  group=cp.group)
    offs = [sum(recv[:j]) for j in range(n)]
    from_next = out[offs[nxt]:offs[nxt] + na].view_as(a)
    start = offs[prev] + (na if prev == nxt else 0)
    from_prev = out[start:start + nb].view_as(b)
    return from_next, from_prev


class _HaloRows(torch.autograd.Function):
    """``halo_rows``'s forward: the rank's first rows to the previous rank
    and its last rows to the next, one collective; its backward sends the
    halo rows' cotangents back to the ranks that own those rows (zeros
    from past the map's edge) and adds what the neighbours send, on every
    rank, so the ranks' collectives always match."""

    @staticmethod
    def forward(ctx, x, top, bottom, cp, dim, zeros):
        ctx.args = (top, bottom, cp, dim)
        rows = x.shape[dim]
        first, last = cp.index == 0, cp.index == cp.size - 1
        # the next rank's first rows, the previous rank's last rows
        below_rows, above_rows = _swap(x.narrow(dim, 0, bottom),
                                       x.narrow(dim, rows - top, top), cp)
        parts, above, below = [x], 0, 0
        if top and (not first or zeros):
            parts.insert(0, torch.zeros_like(above_rows) if first
                         else above_rows)
            above = top
        if bottom and (not last or zeros):
            parts.append(torch.zeros_like(below_rows) if last
                         else below_rows)
            below = bottom
        ctx.kept = (above, below)
        return torch.cat(parts, dim) if len(parts) > 1 else x.clone()

    @staticmethod
    def backward(ctx, g):
        top, bottom, cp, dim = ctx.args
        above, below = ctx.kept
        rows = g.shape[dim] - above - below
        dx = g.narrow(dim, above, rows).clone()
        shape_t, shape_b = list(g.shape), list(g.shape)
        shape_t[dim], shape_b[dim] = top, bottom
        gt = (g.narrow(dim, 0, top) if above and cp.index > 0
              else g.new_zeros(shape_t))
        gb = (g.narrow(dim, above + rows, bottom)
              if below and cp.index < cp.size - 1 else g.new_zeros(shape_b))
        # the next rank's top-halo cotangent belongs to our last rows, the
        # previous rank's bottom-halo cotangent to our first rows
        to_last, to_first = _swap(gt, gb, cp)
        dx.narrow(dim, rows - top, top).add_(to_last)
        dx.narrow(dim, 0, bottom).add_(to_first)
        return dx, None, None, None, None, None


def halo_rows(x_local, top: int, bottom: int, cp, dim: int = 1,
              zeros: bool = True):
    """The rank's rows with ``top`` rows of the previous rank above them and
    ``bottom`` of the next one below (the non-cyclic halo of a
    convolution).  Past the map's edge (above rank 0, below the last rank)
    the rows are zeros when ``zeros`` (a convolution's zero padding), else
    left out (a kernel that zero-pads past the rows it is given).  Returns
    (rows, the number of rows added above)."""
    if top > x_local.shape[dim] or bottom > x_local.shape[dim]:
        raise ValueError(f"halo_rows: halos of {top} and {bottom} rows over "
                         f"a band of {x_local.shape[dim]}")
    above = top if (cp.index > 0 or zeros) else 0
    return _HaloRows.apply(x_local, top, bottom, cp, dim, zeros), above


# --------------------------------------------------------------------------
# gathers


def _gather(t, cp, dim):
    out = _all_to_all(t.unsqueeze(0).expand(cp.size, *t.shape), cp)
    return torch.cat(out.unbind(0), dim)


class _GatherRows(torch.autograd.Function):
    """All-gather along ``dim``; backward: the sum over the ranks of their
    cotangents for this rank's rows (a reduce-scatter, summed in rank
    order)."""

    @staticmethod
    def forward(ctx, t, cp, dim):
        ctx.cp, ctx.dim = cp, dim
        return _gather(t, cp, dim)

    @staticmethod
    def backward(ctx, g):
        cp = ctx.cp
        parts = _all_to_all(torch.stack(g.chunk(cp.size, ctx.dim)), cp)
        return functools.reduce(torch.add, parts.unbind(0)), None, None


class _GatherReplicated(torch.autograd.Function):
    """All-gather along ``dim``; backward: the rank's rows of the cotangent
    (every rank computes the same function of the gathered tensor)."""

    @staticmethod
    def forward(ctx, t, cp, dim):
        ctx.cp, ctx.dim = cp, dim
        return _gather(t, cp, dim)

    @staticmethod
    def backward(ctx, g):
        return g.chunk(ctx.cp.size, ctx.dim)[ctx.cp.index], None, None


def gather_rows(x_local, cp, dim: int = 1):
    """The whole tensor from every rank's rows along ``dim``, for a
    computation that each rank then takes its own rows of
    (``slice_rows``): the backward sums every rank's cotangent of this
    rank's rows."""
    if cp is None or cp.size == 1:
        return x_local
    return _GatherRows.apply(x_local, cp, dim)


def gather_replicated(x_local, cp, dim: int = 1):
    """The whole tensor from every rank's rows along ``dim``, for a
    computation every rank makes alike (the loss, the metrics): the
    backward keeps the rank's rows of the cotangent."""
    if cp is None or cp.size == 1:
        return x_local
    return _GatherReplicated.apply(x_local, cp, dim)


def slice_rows(x, cp, dim: int = 1):
    """The rank's rows of the whole tensor ``x`` along ``dim`` (its
    backward puts the cotangent there, zeros elsewhere)."""
    if cp is None or cp.size == 1:
        return x
    return x[(slice(None),) * (dim % x.dim()) + (cp.band(x.shape[dim]),)]


# --------------------------------------------------------------------------
# context-parallel window attention


def cp_window_attention_qkv(q, k, v, bias, *, scale: float, cp,
                            n_win_h: int, sparse_w=None, mask=None):
    """Window attention of the rank's windows (q, k, v (B_loc nW_loc, heads,
    N, d), batch-major then window-row-major as ``window_partition`` gives
    them from the rank's band): ``ops.window_attention`` (the kernel on the
    card) with the rows of the global (nW, N, N) ``mask`` that belong to
    the rank's windows.  ``n_win_h``: window rows of the whole map."""
    return window_attention(q, k, v, bias, scale=scale, sparse_w=sparse_w,
                            mask=mask_rows(mask, cp, n_win_h))


def cp_window_attention(x_local, bias, *, cp, win_size: int = 8,
                        num_heads: int = 1, scale: Optional[float] = None,
                        sparse_w=None, shift: int = 0, mask=None):
    """Window self-attention with identity projections of the rank's
    row-sharded (B, H_loc, W, C) block, rolled by -shift first and back
    after (one halo strip each way): the JAX function's body on the rank's
    rows.  H_loc must be a multiple of win_size; ``mask`` the global (nW,
    N, N) shift mask."""
    b, h_loc, w, c = x_local.shape
    if h_loc % win_size:
        raise ValueError(f"H_loc={h_loc} not a multiple of win_size="
                         f"{win_size}")
    scale = (c // num_heads) ** -0.5 if scale is None else scale
    y = cp_shift_roll(x_local, shift, cp)
    n = win_size * win_size
    wins = window_partition(y, win_size).reshape(-1, n, c)
    qkv = wins.reshape(wins.shape[0], n, num_heads, c // num_heads
                       ).transpose(1, 2)
    out = cp_window_attention_qkv(qkv, qkv, qkv, bias, scale=scale, cp=cp,
                                  n_win_h=h_loc * cp.size // win_size,
                                  sparse_w=sparse_w, mask=mask)
    out = out.transpose(1, 2).reshape(-1, win_size, win_size, c)
    return cp_unshift_roll(window_reverse(out, win_size, h_loc, w), shift,
                           cp)


def ulysses_window_attention(q, k, v, bias, *, cp, scale: float,
                             sparse_w=None):
    """Window attention with the HEADS sharded over the context group: the
    rank's windows (bq, H, N, d) go to the rank that holds their heads (an
    all-to-all), every rank attends all windows with H/n heads, and a
    second all-to-all brings its windows back: the JAX function's recipe.
    H must be divisible by the group's size."""
    n = cp.size
    bq, nh, tok, d = q.shape
    if nh % n:
        raise ValueError(f"H={nh} not divisible by context={n}")
    h = nh // n

    def to_heads(t):  # (bq, H, N, d) -> (n bq, H/n, N, d), source order
        t = t.reshape(bq, n, h, tok, d).transpose(0, 1)
        return all_to_all(t, cp).reshape(n * bq, h, tok, d)

    out = window_attention(to_heads(q), to_heads(k), to_heads(v),
                           bias[cp.index * h:(cp.index + 1) * h],
                           scale=scale, sparse_w=sparse_w)
    out = all_to_all(out.reshape(n, bq, h, tok, d), cp)
    return out.transpose(0, 1).reshape(bq, nh, tok, d)


# --------------------------------------------------------------------------
# distributed 2-D FFT (transpose decomposition)


def _fft2_rows(x_local, cp, inverse: bool):
    """x_local (B, R_loc, S, ...), rows R sharded: FFT over S, all-to-all
    to shard S instead, FFT over R, all-to-all back (complex64)."""
    fft = torch.fft.ifft if inverse else torch.fft.fft
    n = cp.size
    y = fft(x_local.to(torch.complex64), dim=2)
    b, r, s = y.shape[:3]
    rest = tuple(y.shape[3:])
    # (B, R/n, S, ...) -> (B, R, S/n, ...): shard S instead of R
    y = y.reshape(b, r, n, s // n, *rest).movedim(2, 0)
    y = all_to_all(y, cp).movedim(0, 1).reshape(b, n * r, s // n, *rest)
    y = fft(y, dim=1)
    y = y.reshape(b, n, r, s // n, *rest).movedim(1, 0)
    y = all_to_all(y, cp).movedim(0, 2).reshape(b, r, s, *rest)
    return y


def sharded_fft2(x_local, cp):
    """``torch.fft.fft2`` over dims (1, 2) of a row-sharded (B, H_loc, W,
    ...) block (W divisible by the group's size), the rank's rows of the
    result, complex64."""
    return _fft2_rows(x_local, cp, inverse=False)


def sharded_ifft2(x_local, cp):
    return _fft2_rows(x_local, cp, inverse=True)

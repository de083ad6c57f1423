"""Transcendental functions whose result for a cell does not depend on
where the cell lies in its tensor: ``exp``, ``log``, ``log10``, ``pow``;
and ``sum0``, a sum over the first axis likewise.

On the CPU, torch computes an elementwise function of a contiguous tensor
with its vectorised version (SLEEF) in steps of two vector widths, and the
elements left over at the end of each loop -- how many depends on the
tensor's size and on how the work is split over threads -- with the scalar
libm function. The two differ by an ulp now and then, so a block of a
sharded domain, whose tensors have other sizes, would not compute a cell
as the whole domain does. Here a CPU operand is flattened, padded to a
multiple of ``_ALIGN`` elements and cut into pieces of at most torch's
grain (each runs as one loop on one thread), so every element takes the
vectorised version. A CUDA tensor computes every element alike and goes
straight to torch.
"""

from __future__ import annotations

import math

import numpy as np
import torch

# a multiple of twice the widest vector (AVX-512: 16 floats) that divides
# torch's grain of 32768 elements, below which a loop is not split
_ALIGN = 64
_PIECE = 32768


def _position_free(fn, *args):
    """``fn(*args)`` for an elementwise ``fn`` of tensors and numbers."""
    tensors = [a for a in args if torch.is_tensor(a)]
    if tensors[0].device.type != "cpu":
        return fn(*args)
    shape = torch.broadcast_shapes(*(t.shape for t in tensors))
    n = math.prod(shape)
    pad = -n % _ALIGN

    def flat(a):
        if not torch.is_tensor(a):
            return a
        f = a.expand(shape).reshape(-1)
        return torch.cat([f, f.new_ones(pad)]) if pad else f.contiguous()
    flats = [flat(a) for a in args]
    pieces = [fn(*(f[i:i + _PIECE] if torch.is_tensor(f) else f
                   for f in flats))
              for i in range(0, n + pad, _PIECE)]
    return torch.cat(pieces)[:n].reshape(shape)


def exp(x):
    return _position_free(torch.exp, x)


def log(x):
    return _position_free(torch.log, x)


def log10(x):
    return _position_free(torch.log10, x)


def pow(x, e):  # noqa: A001 (torch.pow's name)
    """``x ** e``; either may be a number."""
    return _position_free(torch.pow, x, e)


# ATen's outer sum: rows of 2**_SUM_LEVEL_POWER (at least) summed in turn,
# each run's total carried into up to _SUM_LEVELS accumulators
_SUM_LEVELS = 4


def sum0(x):
    """``torch.sum(x, dim=0)`` of a floating tensor. On the CPU torch sums
    the leading axis of most columns in its vectorised loop, whose order
    this reproduces with elementwise additions of whole planes (ATen's
    ``multi_row_sum``: runs of 16 rows summed in turn, each run's total
    carried into a cascade of four accumulators), and the columns left
    over at the end of that loop in another order, so a column's sum
    would depend on its place in its tensor. A CUDA tensor goes straight
    to torch."""
    if x.device.type != "cpu":
        return torch.sum(x, dim=0)
    n = x.shape[0]
    power = max(4, math.ceil(math.log2(n)) // _SUM_LEVELS if n > 1 else 0)
    step = 1 << power
    acc = [torch.zeros_like(x[0]) for _ in range(_SUM_LEVELS)]
    i = 0
    while i + step <= n:
        for _ in range(step):
            acc[0] = acc[0] + x[i]
            i += 1
        for j in range(1, _SUM_LEVELS):
            acc[j] = acc[j] + acc[j - 1]
            acc[j - 1] = torch.zeros_like(x[0])
            if i & ((step - 1) << (j * power)):
                break
    for k in range(i, n):
        acc[0] = acc[0] + x[k]
    for j in range(1, _SUM_LEVELS):
        acc[0] = acc[0] + acc[j]
    return acc[0]


def inv(c) -> float:
    """The float32 reciprocal of the number ``c``, for writing ``x / c`` as
    ``x * inv(c)``: the JAX package's compiled step divides by a constant
    so (XLA folds the division), and torch itself does so on the card but
    not on the CPU, so the product gives one result on both devices."""
    return float(np.float32(1.0) / np.float32(c))


def div(a, b):
    """``a / b`` rounded as one IEEE division where one operand is a
    Python number, as XLA and numpy divide: torch divides a tensor by a
    number on the card as a product with the number's reciprocal, and a
    number by a tensor on either device as the tensor's reciprocal times
    the number. The number becomes a tensor of the other operand's dtype
    and device first."""
    t = a if torch.is_tensor(a) else b
    as_t = lambda v: v if torch.is_tensor(v) else torch.tensor(
        v, dtype=t.dtype, device=t.device)
    return as_t(a) / as_t(b)


# the block length of XLA's cumulative sums on the CPU
_SCAN_BLOCK = 16


def cumsum(x, dim: int):
    """The cumulative sum of ``x`` along ``dim`` in the order of
    ``jnp.cumsum`` on the JAX package's CPU backend: sequential within
    blocks of 16, each block's total carried by the same scan of the
    totals. torch.cumsum accumulates float32 in float64 on the CPU and
    scans in another order on the card; this order is the same on both
    devices, and equal to the JAX package's bit for bit."""
    return _blocked_scan(x.movedim(dim, -1), False).movedim(-1, dim)


def cumprod(x, dim: int):
    """The cumulative product of ``x`` along ``dim`` in the order of
    ``jnp.cumprod`` on the JAX package's CPU backend (the blocks of
    ``cumsum``), bit-equal to it."""
    return _blocked_scan(x.movedim(dim, -1), True).movedim(-1, dim)


def _blocked_scan(x, product):
    n = x.shape[-1]
    if n <= _SCAN_BLOCK:
        return _sequential_scan(x, product)
    nb = -(-n // _SCAN_BLOCK)
    blocks = torch.nn.functional.pad(x, (0, nb * _SCAN_BLOCK - n),
                                     value=1.0 if product else 0.0)
    inner = _sequential_scan(blocks.reshape(*x.shape[:-1], nb,
                                            _SCAN_BLOCK), product)
    totals = _blocked_scan(inner[..., -1], product)
    first = (torch.ones_like if product else torch.zeros_like)(
        totals[..., :1])
    carry = torch.cat([first, totals[..., :-1]], dim=-1)[..., None]
    out = (inner * carry if product else inner + carry)
    return out.reshape(*x.shape[:-1], -1)[..., :n]


def _sequential_scan(x, product=False):
    out = torch.empty_like(x)
    acc = x[..., 0]
    out[..., 0] = acc
    for i in range(1, x.shape[-1]):
        acc = acc * x[..., i] if product else acc + x[..., i]
        out[..., i] = acc
    return out

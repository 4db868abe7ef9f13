"""The model axis's gathers, on ``all_reduce`` alone.

Gloo on CUDA tensors has no ``all_gather``, so a gather is an
``all_reduce`` of a zero-filled buffer into which each rank has written its
block: ``x + 0`` is exact, so the gathered tensor is bitwise the blocks.

:class:`GatherBlocks` is differentiable.  Every rank of a model group holds
the same rows and computes the same loss from the gathered tensor, so the
gradient that reaches the gather is the same on every rank, and each
rank's block takes its own slice of it.  A reduce-scatter (the backward of
an all-gather across ranks that compute different losses) would add the M
equal copies and multiply every gradient by M.
"""

from __future__ import annotations

import functools
import math
from typing import Sequence

import torch
import torch.distributed as dist

# the model axis's gathers since the last reset: one per collective
GATHERS = 0


def _all_reduce(buf: torch.Tensor, mesh) -> None:
    global GATHERS
    dist.all_reduce(buf, group=mesh.model_group)
    GATHERS += 1


class GatherBlocks(torch.autograd.Function):
    """(block of ``x`` along ``dim``) -> the whole tensor over the model
    group: this rank's block at ``lo`` of ``total``.  Backward: this rank's
    slice of the incoming gradient."""

    @staticmethod
    def forward(ctx, x, mesh, dim: int, lo: int, total: int):
        dim = dim % x.ndim
        shape = list(x.shape)
        shape[dim] = total
        out = x.new_zeros(shape)
        out.narrow(dim, lo, x.shape[dim]).copy_(x)
        _all_reduce(out, mesh)
        ctx.meta = (dim, lo, x.shape[dim])
        return out

    @staticmethod
    def backward(ctx, grad):
        dim, lo, n = ctx.meta
        return grad.narrow(dim, lo, n), None, None, None, None


def gather_blocks(x: torch.Tensor, mesh, dim: int, lo: int,
                  total: int) -> torch.Tensor:
    """:class:`GatherBlocks` over ``mesh``'s model group; the identity on a
    model axis of one rank."""
    if mesh is None or mesh.n_model <= 1:
        return x
    return GatherBlocks.apply(x, mesh, dim, lo, total)


def join(mesh, parts: Sequence[tuple], device) -> list[torch.Tensor]:
    """Whole tensors from the model ranks' pieces in one collective.

    ``parts``: (shape, dtype, piece or None, rows) a tensor: this rank adds
    ``piece`` at ``rows`` of dim 0 (None: the whole tensor), or nothing
    where ``piece`` is None.  Each tensor must be added once over the
    group, by one rank or in disjoint rows.  The buffer has the promoted
    dtype of the parts (every float32 and float64 value goes through it
    unchanged).  Returns the tensors, each in its own dtype."""
    if not parts:
        return []
    dtype = functools.reduce(torch.promote_types, [p[1] for p in parts])
    sizes = [math.prod(p[0]) for p in parts]
    flat = torch.zeros(sum(sizes), dtype=dtype, device=device)
    views = [v.view(p[0]) for v, p in zip(flat.split(sizes), parts)]
    for v, (_, _, piece, rows) in zip(views, parts):
        if piece is not None:
            (v if rows is None else v[rows]).copy_(piece)
    if mesh is not None and mesh.n_model > 1:
        _all_reduce(flat, mesh)
    return [v.to(p[1]) for v, p in zip(views, parts)]


"""The mesh's collectives as autograd functions: what the reference's
GSPMD inserts around a cut tensor, and its transpose in the backward
(the tensor-parallel and FSDP training of a (data, model) mesh of ranks,
``launch.mesh.RankMesh``).

Each forward gives the value the serving path's collectives give (the
in-place ``RankMesh.all_reduce`` there, an out-of-place reduce here, and
the in-place one itself where nothing asks for a gradient), so a
training forward and a serving forward of the same rank agree bit for
bit; the backward is what training adds:

* :func:`copy_to_model` -- identity; the backward sums the gradient over
  ``model``.  At a column-cut module's input (and on a replicated leaf
  that acts on the rank's own heads: each rank's gradient is partial).
* :func:`reduce_from_model` -- the sum over ``model`` of the ranks'
  partials (a row-cut module's output); the backward is the identity.
* :func:`gather_from_model` -- the ranks' blocks of ``dim`` concatenated
  (the vocab-cut head's logits); the backward keeps the rank's block.
* :func:`gather_rows_from_model` -- the ranks' rows concatenated, rank
  i's ``sizes[i]`` of them (the MoE layer's expert output rows); the
  backward keeps the rank's rows.
* :func:`vocab_embed` -- the lookup in a vocab-cut table, the ranks'
  lookups summed as integers over their bit patterns (one rank holds each
  row); the backward adds the output gradient into the rows this rank
  holds, for the tokens it holds.
* :func:`fsdp_gather` -- a leaf cut over ``data`` (FSDP) gathered whole;
  the backward reduce-scatters the gradient, the mean over ``data``.
* :func:`sum_over_data` -- a sum over ``data`` (the loss's masked sum and
  count over the batch's data blocks); the backward scales by the data
  axis's size, so that the ranks' gradients, meaned over ``data`` as the
  train step means them, are the gradient of the global loss.

Every function returns its input untouched on an axis of one rank.
"""
from __future__ import annotations

import torch

__all__ = ["copy_to_model", "reduce_from_model", "gather_from_model",
           "gather_rows_from_model", "vocab_embed", "fsdp_gather",
           "sum_over_data"]


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.mesh.all_reduced(g, "model"), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.all_reduced(x, "model")

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim, ctx.size = mesh, dim, x.shape[dim]
        return mesh.all_gather(x, "model", dim)

    @staticmethod
    def backward(ctx, g):
        start = ctx.mesh.coords["model"] * ctx.size
        return g.narrow(ctx.dim, start, ctx.size), None, None


class _GatherRowsFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, sizes):
        me = mesh.coords["model"]
        ctx.start, ctx.n = sum(sizes[:me]), sizes[me]
        return torch.cat(mesh.all_gather_rows(x, "model", sizes))

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.start, ctx.n), None, None


def _lookup(table, tokens, mesh, dtype):
    """This rank's rows of the tokens it holds (zeros elsewhere), summed
    over ``model`` as integers over the values' bit patterns: one rank
    holds each row, so the sum is its bits exactly (a float sum would
    turn a -0.0 into +0.0).  Also the rows' local index and mask."""
    rows = table.shape[0]
    local = tokens.long() - mesh.coords["model"] * rows
    mine = (local >= 0) & (local < rows)
    x = table[local.clamp(0, rows - 1)].to(dtype)
    x = torch.where(mine[..., None], x, torch.zeros((), dtype=dtype,
                                                   device=x.device))
    bits = x.contiguous().view(torch.int32)   # d even for 16-bit dtypes
    # ``bits`` is this call's own tensor: reduced in place
    return mesh.all_reduce(bits, "model").view(dtype), local, mine


class _VocabEmbed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, tokens, mesh, dtype):
        x, local, mine = _lookup(table, tokens, mesh, dtype)
        ctx.save_for_backward(local, mine)
        ctx.rows, ctx.table_dtype = table.shape, table.dtype
        return x

    @staticmethod
    def backward(ctx, g):
        local, mine = ctx.saved_tensors
        grad = torch.zeros(ctx.rows, dtype=ctx.table_dtype, device=g.device)
        # the sum one rank's ``table[tokens]`` backward makes (on the card
        # a sorted, deterministic accumulation; ``index_add_`` adds by
        # atomics in no fixed order); another rank's tokens add zeros to
        # a row of this one's, which keeps the shapes data-independent (a
        # traced step on the meta device has no mask to count)
        g = torch.where(mine[..., None], g, torch.zeros((), dtype=g.dtype,
                                                        device=g.device))
        grad.index_put_((local.clamp(0, ctx.rows[0] - 1),),
                        g.to(ctx.table_dtype), accumulate=True)
        return grad, None, None, None


class _FSDPGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return mesh.all_gather(x, "data", dim)

    @staticmethod
    def backward(ctx, g):
        n = ctx.mesh.shape["data"]
        return ctx.mesh.reduce_scatter(g, "data", ctx.dim) / n, None, None


class _SumOverData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.n = mesh.shape["data"]
        return mesh.all_reduced(x, "data")

    @staticmethod
    def backward(ctx, g):
        return g * ctx.n, None


def _grad(*ts) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in ts)


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x``; its gradient summed over ``model`` in the backward."""
    if mesh.shape["model"] == 1 or not _grad(x):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``model``, ``x`` untouched (the
    in-place ``RankMesh.all_reduce``'s value); the identity backward."""
    if mesh.shape["model"] == 1:
        return x
    if not _grad(x):
        return mesh.all_reduce(x, "model")
    return _ReduceFromModel.apply(x, mesh)


def gather_from_model(x: torch.Tensor, mesh, dim: int = -1
                      ) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order; the
    backward keeps the rank's block."""
    if mesh.shape["model"] == 1:
        return x
    if not _grad(x):
        return mesh.all_gather(x, "model", dim)
    return _GatherFromModel.apply(x, mesh, dim % x.ndim)


def gather_rows_from_model(x: torch.Tensor, mesh, sizes
                           ) -> torch.Tensor:
    """The ranks' ``x`` concatenated along dim 0 in rank order, rank i's
    holding ``sizes[i]`` rows (``launch.mesh.RankMesh.all_gather_rows``);
    the backward keeps the rank's rows (every rank of the model axis
    reads the same whole result)."""
    if mesh.shape["model"] == 1:
        return x
    if not _grad(x):
        return torch.cat(mesh.all_gather_rows(x, "model", sizes))
    return _GatherRowsFromModel.apply(x, mesh, list(sizes))


def vocab_embed(table: torch.Tensor, tokens: torch.Tensor, mesh,
                dtype: torch.dtype) -> torch.Tensor:
    """The tokens' rows of the vocab-cut ``table`` (this rank's block of
    rows), whole on every rank, in ``dtype``."""
    if not _grad(table):
        return _lookup(table, tokens, mesh, dtype)[0]
    return _VocabEmbed.apply(table, tokens, mesh, dtype)


def fsdp_gather(x: torch.Tensor, mesh, dim: int) -> torch.Tensor:
    """The leaf whose ``dim`` is cut over ``data``, gathered whole; its
    gradient reduce-scattered back, meaned over ``data``."""
    if mesh.shape["data"] == 1:
        return x
    if not _grad(x):
        return mesh.all_gather(x, "data", dim)
    return _FSDPGather.apply(x, mesh, dim)


def sum_over_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the ranks' ``x`` over ``data``; the backward scales by
    the data axis's size (the module docstring)."""
    if mesh.shape["data"] == 1:
        return x
    if not _grad(x):
        return mesh.all_reduced(x, "data")
    return _SumOverData.apply(x, mesh)

"""Pipeline parallelism: the GPipe schedule over a ``pp`` mesh axis
(``opendwm_tpu/parallel/pipeline.py``).

Stage s of P holds its slice of the stacked stage parameters (leading dim
P) and runs ``block_fn`` on the microbatches that reach it: at tick t it
takes microbatch t - s from stage s - 1 (stage 0 from the input), and
passes its output on to stage s + 1 by point-to-point send; the schedule
has M + P - 1 ticks (the P - 1 fill and drain ticks are GPipe's bubble).
The last stage's outputs are broadcast over ``pp``, so the result is
replicated there, as JAX's ``psum`` of the masked outputs makes it.

JAX's stacked-stage formulation (one SPMD program in which every device
slices its stage from the stacked tree) is kept, so the loop is written
here rather than on ``torch.distributed.pipelining``, whose stages own
separate modules. It is differentiable: the schedule is one autograd
Function whose backward runs the microbatches' backwards in reverse
order, sending each input gradient to the previous stage; a replicated
input's gradient (the input and the conditioning, consumed by every rank
of ``pp``) is summed over the stages, so every rank holds the gradient of
one copy of the loss, as JAX's transposes give. ``batch_axis`` composes
data parallelism: each rank of that axis pipelines its slice of the batch,
and the outputs are all-gathered; the parameters' gradients are summed
over it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.utils import _pytree as pytree

from opendwm_tpu_torch.parallel.collectives import (
    gather_along,
    replicated,
    slice_along,
)
from opendwm_tpu_torch.parallel.mesh import AXIS_PP, axis_group, axis_size
from opendwm_tpu_torch.parallel.sharding import is_distributed


def stack_stage_params(per_stage_params: list):
    """[stage0_tree, stage1_tree, ...] -> one tree with a leading stage
    dim."""
    return pytree.tree_map(lambda *xs: torch.stack(xs), *per_stage_params)


def stage_slice(stacked_params, stage: int):
    """Stage ``stage``'s slice of a stacked tree."""
    return pytree.tree_map(lambda a: a[stage], stacked_params)


def _chunks(t, m: int):
    return list(t.reshape(m, t.shape[0] // m, *t.shape[1:]).unbind(0))


class _GPipe(torch.autograd.Function):
    """One stage's run of the schedule; inputs ``x``, the conditioning
    arrays and the stage's flattened parameters."""

    @staticmethod
    def forward(ctx, block_fn, spec, m, group, n_conds, x, *flat):
        conds, params = flat[:n_conds], flat[n_conds:]
        n = dist.get_world_size(group)
        stage = dist.get_rank(group)
        prv = dist.get_global_rank(group, stage - 1) if stage > 0 else None
        nxt = dist.get_global_rank(group, stage + 1) if stage < n - 1 \
            else None
        grad = any(ctx.needs_input_grad[5:])
        leaves = [p.detach().requires_grad_(p.requires_grad) for p in params]
        stage_params = pytree.tree_unflatten(leaves, spec)
        xs = _chunks(x, m)
        cs = [_chunks(c, m) for c in conds]
        runs, outs, sends = [], [None] * m, []
        for t in range(m + n - 1):
            mb = t - stage
            if not 0 <= mb < m:
                continue
            if prv is None:
                h_in = xs[mb]
            else:
                h_in = torch.empty_like(xs[mb])
                dist.recv(h_in, prv, group=group)
            with torch.enable_grad() if grad else torch.no_grad():
                h_in = h_in.detach().requires_grad_(grad)
                c_in = [c[mb].detach().requires_grad_(grad) for c in cs]
                h_out = block_fn(stage_params, h_in, *c_in)
            runs.append((h_in, c_in, h_out))
            if nxt is None:
                outs[mb] = h_out.detach()
            else:
                sends.append(dist.isend(h_out.detach().contiguous(), nxt,
                                        group=group))
        for req in sends:
            req.wait()
        last = dist.get_global_rank(group, n - 1)
        out = torch.cat(outs) if nxt is None else torch.empty_like(x)
        dist.broadcast(out, last, group=group)
        ctx.runs, ctx.leaves, ctx.group, ctx.m = runs, leaves, group, m
        ctx.prv, ctx.nxt = prv, nxt
        return out

    @staticmethod
    def backward(ctx, g):
        runs, leaves, group, m = ctx.runs, ctx.leaves, ctx.group, ctx.m
        g_mbs = _chunks(g, m)
        dx = [torch.zeros_like(g_mbs[0]) for _ in range(m)]
        dc = [[torch.zeros_like(c) for c in cin] for _, cin, _ in runs]
        dp = [torch.zeros_like(p) if p.requires_grad else None
              for p in leaves]
        trainable = [p for p in leaves if p.requires_grad]
        sends = []
        for mb in reversed(range(m)):
            h_in, c_in, h_out = runs[mb]
            if ctx.nxt is None:  # the replicated output's one cotangent
                g_out = g_mbs[mb]
            else:
                g_out = torch.empty_like(h_out)
                dist.recv(g_out, ctx.nxt, group=group)
            got = torch.autograd.grad(h_out, [h_in, *c_in, *trainable],
                                      g_out, allow_unused=True)
            g_in, g_c, g_p = got[0], got[1:1 + len(c_in)], \
                got[1 + len(c_in):]
            if ctx.prv is None:
                dx[mb] = g_in
            else:
                sends.append(dist.isend(g_in.contiguous(), ctx.prv,
                                        group=group))
            for j, gc in enumerate(g_c):
                if gc is not None:
                    dc[mb][j] = gc
            it = iter(g_p)
            for i, p in enumerate(leaves):
                if p.requires_grad:
                    gp = next(it)
                    if gp is not None:
                        dp[i] += gp
        for req in sends:
            req.wait()
        # x and the conditioning are replicated over pp: the gradient of the
        # one copy the loss saw is the sum of the stages' parts
        dx = torch.cat(dx)
        dist.all_reduce(dx, group=group)
        dconds = []
        for j in range(len(runs[0][1])):
            d = torch.cat([dc[mb][j] for mb in range(m)])
            dist.all_reduce(d, group=group)
            dconds.append(d)
        return (None, None, None, None, None, dx, *dconds, *dp)


def pipeline_apply(block_fn, stacked_params, x, mesh, *, axis: str = AXIS_PP,
                   microbatches: int, conds: tuple = (),
                   batch_axis: str | None = None):
    """Run ``x`` through the P stages of ``block_fn`` on ``mesh``'s
    ``axis`` (JAX's ``pipeline_apply``).

    block_fn: ``(stage_params, h, *stage_conds) -> h`` with ``h`` of
      constant shape; stacked_params: a tree whose leaves have leading dim
      P (the rank of ``axis`` takes its slice); x: ``(batch, ...)``,
      replicated over ``axis``, batch divisible by ``microbatches`` (per
      rank of ``batch_axis`` where given); conds: per-sample conditioning
      arrays passed to every stage with their microbatch.
    Returns the ``(batch, ...)`` output, replicated over ``axis`` (and
    all-gathered over ``batch_axis``).
    """
    m = microbatches
    n_data = axis_size(mesh, batch_axis) if batch_axis is not None else 1
    local_batch = x.shape[0] // n_data
    if x.shape[0] % n_data or local_batch % m:
        raise ValueError(f"batch {local_batch} not divisible by {m}.")
    data_group = axis_group(mesh, batch_axis) if batch_axis else None
    x = slice_along(x, 0, data_group)
    conds = tuple(slice_along(c, 0, data_group) for c in conds)
    # the pp group, also at one stage where the mesh has the axis (the
    # schedule's collectives then run over a group of one)
    group = axis_group(mesh, axis)
    if group is None and is_distributed(mesh) and \
            axis in mesh.mesh_dim_names:
        group = mesh.get_group(axis)
    n_stages = axis_size(mesh, axis)
    flat, spec = pytree.tree_flatten(stacked_params)
    if any(leaf.shape[0] != n_stages for leaf in flat):
        raise ValueError(f"stacked params need a leading dim of the "
                         f"{n_stages} stages")
    stage = 0 if group is None else dist.get_rank(group)
    # the parameters are replicated over the batch axis: their gradient is
    # the sum of the data ranks'
    params = [replicated(leaf[stage], data_group) for leaf in flat]
    if group is None:
        stage_params = pytree.tree_unflatten(params, spec)
        cs = [_chunks(c, m) for c in conds]
        out = torch.cat([block_fn(stage_params, h, *(c[i] for c in cs))
                         for i, h in enumerate(_chunks(x, m))])
    else:
        out = _GPipe.apply(block_fn, spec, m, group, len(conds), x, *conds,
                           *params)
    return gather_along(out, 0, data_group)

"""GPipe over a uniform block stack (``csts_tpu/parallel/pipeline.py``).

The scope is JAX's: the encoder's uniform identity-block run (the
flagship's v4-v11, ``models/csts.py`` picks it as JAX does); the patch
embeds, the stage transitions, the fusion and the decoder run on every
rank.

The schedule is JAX's, written with the c10d collectives gloo carries on
CUDA tensors: the batch splits into M microbatches, microbatch m holding
samples m, m+M, ... (JAX's minor microbatch index); at step t of M+S-1,
stage s runs its L/S blocks on microbatch t-s; after each step one
all-gather over the pipe axis hands stage s+1 what stage s made (JAX's
``ppermute``) and hands every rank what the last stage made, which is the
result, replicated (JAX's ``psum``). A stage with no microbatch at a step
computes nothing and sends zeros.

The backward is the reverse schedule in one autograd Function: each stage
keeps the graph of every microbatch it ran; at step t, from the last down,
it back-propagates the gradient of its output at step t (the caller's for
the last stage, else what stage s+1 sent) through that graph, and one
all-gather hands stage s-1 the gradient of this stage's input. Stage 0's
input gradients are summed over the pipe axis, so every rank has the
gradient of the run's input (the transpose of JAX's replicated input).
Each rank's gradients of the run's parameters are those of its own stage:
``mesh.sync_grads`` sums them over the pipe axis.

The other axes compose (JAX's pipeline is a partial-manual ``shard_map``
over ``pipe`` with the seq and model shardings left to GSPMD). On the seq
axis's stripes each stage's blocks run on its rank's stripe, the exchange
carries the stripes between the stages of one seq coordinate (the pipe
group of every coordinate is its own), and the result stays striped; the
seq collectives inside a stage's blocks, and those in the nested backward,
run in one order on the ranks of a seq group, which hold one stage. Under
FSDP2 the run's blocks belong to the model's own group (``mesh.
wrap_for_training``): their parameters are whole from the model's forward
to the end of its backward, the stage differentiates those unsharded
tensors, and FSDP's reduce-scatter of their gradients follows the outer
backward, so no FSDP hook fires inside the nested one.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence

import torch
from torch import nn

from csts_torch.parallel import mesh

# Microbatches a pipeline round; 0: the pipe size S (bubble (S-1)/(M+S-1)).
# Set from cfg.PARALLEL.PIPE_MICROBATCHES by mesh_from_cfg; an explicit
# ``microbatches=`` wins over it.
MICROBATCHES = 0


def effective_microbatches(S: int, microbatches: Optional[int] = None) -> int:
    """The microbatch count: the argument, else the module's, else S."""
    return microbatches or MICROBATCHES or S


def pipe_size() -> Optional[int]:
    """The installed mesh's pipe size, or None without a pipe axis."""
    s = mesh.axis_size(mesh.PIPE_AXIS)
    return s if s > 1 else None


def _stage_fn(apply_one: Callable, lo: int, n: int) -> Callable:
    def run(z, m):
        for j in range(lo, lo + n):
            z = apply_one(j, z, m)
        return z
    return run


def _exchange(x: torch.Tensor) -> List[torch.Tensor]:
    return mesh.all_gather(x, mesh.PIPE_AXIS)


def _forward(stage, xs: Sequence[torch.Tensor], S: int, s: int, keep_graphs: bool):
    """The schedule over microbatches ``xs``; returns the last stage's
    outputs (every rank's) and, with ``keep_graphs``, this stage's
    (input leaf, output) per microbatch."""
    M = len(xs)
    outs: List[Optional[torch.Tensor]] = [None] * M
    graphs = {}
    state = None
    for t in range(M + S - 1):
        m = t - s
        if 0 <= m < M:
            inp = xs[m] if s == 0 else state
            if keep_graphs:
                leaf = inp.detach().requires_grad_(True)
                with torch.enable_grad():
                    out = stage(leaf, m)
                graphs[m] = (leaf, out)
            else:
                out = stage(inp, m)
        else:
            out = torch.zeros_like(xs[0])
        parts = _exchange(out)
        if s > 0:
            state = parts[s - 1]
        if t >= S - 1:
            outs[t - (S - 1)] = parts[S - 1]
    return outs, graphs


class _Pipeline(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, stage, S, s, M, n_stage_params, *params):
        xs = list(x.reshape(x.shape[0] // M, M, *x.shape[1:]).unbind(1))
        outs, graphs = _forward(stage, xs, S, s, keep_graphs=True)
        ctx.graphs, ctx.S, ctx.s, ctx.M = graphs, S, s, M
        ctx.stage_params = params[:n_stage_params]
        ctx.n_params = len(params)
        ctx.shape = x.shape
        return torch.stack(outs, dim=1).reshape(x.shape)

    @staticmethod
    def backward(ctx, dy):
        S, s, M = ctx.S, ctx.s, ctx.M
        dys = list(dy.reshape(dy.shape[0] // M, M, *dy.shape[1:]).unbind(1))
        stage_params = ctx.stage_params
        pgrads: List[Optional[torch.Tensor]] = [None] * len(stage_params)
        dxs: List[Optional[torch.Tensor]] = [None] * M
        from_above = None
        for t in reversed(range(M + S - 1)):
            m = t - s
            if 0 <= m < M:
                leaf, out = ctx.graphs.pop(m)
                g = dys[m] if s == S - 1 else from_above
                got = torch.autograd.grad(out, [leaf, *stage_params], g, allow_unused=True)
                send = got[0]
                for i, gp in enumerate(got[1:]):
                    if gp is not None:
                        pgrads[i] = gp if pgrads[i] is None else pgrads[i] + gp
                if s == 0:
                    dxs[m] = send
            else:
                send = torch.zeros_like(dys[0])
            parts = _exchange(send)
            if s < S - 1:
                from_above = parts[s + 1]
        if s == 0:
            dx = torch.stack(dxs, dim=1).reshape(ctx.shape)
        else:
            dx = torch.zeros(ctx.shape, dtype=dy.dtype, device=dy.device)
        dx = mesh.all_reduce(dx, mesh.PIPE_AXIS)
        rest = [None] * (ctx.n_params - len(stage_params))
        return (dx, None, None, None, None, None, *pgrads, *rest)


def pipeline_blocks(apply_one: Callable[[int, torch.Tensor, int], torch.Tensor],
                    blocks: Sequence[nn.Module], x: torch.Tensor,
                    microbatches: Optional[int] = None) -> torch.Tensor:
    """Runs the L = len(``blocks``) shape-preserving blocks as an S-stage
    pipeline over the installed pipe axis. ``apply_one(j, z, m)`` applies
    block j of the run to microbatch m's activations ``z``; the stage's
    backward returns the gradients of the parameters ``blocks[j]`` holds
    now (under FSDP2 the unsharded ones it computes with), and
    ``mesh.sync_grads`` sums them over the pipe axis by (module, name),
    which follows FSDP2's swaps. L must divide by S and the batch by M; the
    result is the whole (B, ...) output on every rank (under the seq axis,
    every rank's stripe, which the exchange carries between the stages of
    one seq coordinate)."""
    L = len(blocks)
    S = pipe_size()
    assert S is not None, "pipeline_blocks needs an installed mesh with a pipe axis"
    assert L % S == 0, f"block stack of {L} does not divide over pipe={S}"
    M = effective_microbatches(S, microbatches)
    B = x.shape[0]
    assert B % M == 0, f"batch {B} does not divide into {M} microbatches"
    s, per = mesh.axis_index(mesh.PIPE_AXIS), L // S
    stage = _stage_fn(apply_one, s * per, per)
    mine = [p for b in blocks[s * per:(s + 1) * per] for p in b.parameters()]
    everyone = [p for b in blocks for p in b.parameters()]
    mesh.note_partial(mesh.PIPE_AXIS, [it for b in blocks for it in mesh.module_params(b)])
    if torch.is_grad_enabled() and (x.requires_grad or any(p.requires_grad for p in mine)):
        mine_ids = {id(p) for p in mine}
        others = [p for p in everyone if id(p) not in mine_ids]
        return _Pipeline.apply(x, stage, S, s, M, len(mine), *mine, *others)
    xs = list(x.reshape(B // M, M, *x.shape[1:]).unbind(1))
    outs, _ = _forward(stage, xs, S, s, keep_graphs=False)
    return torch.stack(outs, dim=1).reshape(x.shape)

"""Rank workers of the model, seq and pipe axes (``csts_torch/parallel``),
spawned by ``tests/test_torch_model_axes.py`` on the CPU and by
``tests/test_torch_cuda.py`` on a card (two gloo ranks sharing it). This
module imports no JAX, so the ranks start fast; results go through files."""

from __future__ import annotations

import os

import torch

from csts_torch import presets
from csts_torch.models.csts import CSTS, build_spec
from csts_torch.parallel import collectives, mesh, pipeline
from csts_torch.train import step as tstep

AXIS_KW = {"pipe": "pipe_parallel", "model": "model_parallel", "seq": "seq_parallel"}


def axes_cfg(batch: int = 4, depth: int = 6):
    """``small_cfg`` deepened to 6 video blocks, so that v4-v5 form the
    uniform identity run the encoder pipelines (``tests/test_pipeline.py``'s
    ``_depth6_cfg``); drop-path 0.2, kldiv+egonce, fp32."""
    cfg = presets.small_cfg(batch)
    cfg.MVIT.DEPTH = depth
    cfg.MVIT.DROPPATH_RATE = 0.2
    return cfg


def whole_grads(model) -> dict:
    return {n: collectives.whole(p.grad, like=p).detach().cpu().clone()
            for n, p in model.named_parameters()}


def whole_params(model) -> dict:
    return {n: collectives.whole(p.detach(), like=p).cpu().clone()
            for n, p in model.named_parameters()}


def _launches(reset: bool = False) -> dict:
    from chip_smoke import WRAPPERS, reset_launches

    if reset:
        reset_launches()
        return {}
    return {n: WRAPPERS[n].launches for n in
            ("attention", "mlp_tail", "attention_bwd", "mlp_tail_train")}


def axes_worker(rank: int, inputs: str, out: str, axes: dict, device: str = "cpu",
                solver: dict = None) -> None:
    """Under a mesh of ``axes`` ({"pipe": 2} ...; the data axis is the rest
    of the group): the fp32 eval forward of this rank's data stripe of the
    batch, then one training step on it from the same weights with the
    given global masks (``solver``: SOLVER.* overrides, e.g. FSDP); each
    rank's file records the logits, the stats, the whole gradients and
    parameters, the split leaves' and their moments' shapes, the
    collectives run and, on a card, the kernels' launches of the forward
    and of the step."""
    d = torch.load(inputs)
    if device == "cuda":
        torch.cuda.set_device(0)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    res = layout_run(rank, d, axes, device, solver)
    torch.save(res, os.path.join(out, f"rank{rank}.pt"))


# the layouts composed on four ranks (tests/test_torch_axes_compose.py):
# name -> (axes, SOLVER.* overrides); the data axis is the rest of the group
LAYOUTS = {
    "sp2xpp2": ({"seq": 2, "pipe": 2}, {}),
    "dp2xpp2_fsdp": ({"pipe": 2}, {"FSDP": True}),
    "dp2xsp2_fsdp": ({"seq": 2}, {"FSDP": True}),
    "dp2xtp2_zero1": ({"model": 2}, {"ZERO1": True}),
    "dp2xpp2_zero1": ({"pipe": 2}, {"ZERO1": True}),
}


def compose_worker(rank: int, inputs: str, out: str, layouts: list, device: str = "cpu"
                   ) -> None:
    """:func:`layout_run` under each of ``layouts`` (names of
    :data:`LAYOUTS`, or (axes, solver) pairs) one after another in one
    group, each saving its npz TrainState under ``out/<name>``; this rank's
    results to ``out/compose<rank>.pt``."""
    d = torch.load(inputs)
    res = {}
    for name in layouts:
        axes, solver = LAYOUTS[name] if isinstance(name, str) else name
        tag = name if isinstance(name, str) else "x".join(f"{a}{n}" for a, n in axes.items())
        res[tag] = layout_run(rank, d, axes, device, solver, os.path.join(out, tag))
    torch.save(res, os.path.join(out, f"compose{rank}.pt"))


def layout_run(rank: int, d: dict, axes: dict, device: str, solver: dict = None,
               save: str = None) -> dict:
    """The body of :func:`axes_worker` on the loaded inputs ``d``; with
    ``save``, the step's TrainState saved there as an npz (rank 0 writes;
    every rank gathers), and what each rank holds of the parameters and
    the moments."""
    from csts_torch.utils import checkpoint as tcu

    cfg = axes_cfg(d["batch"]["video"].shape[0])
    for k, v in (solver or {}).items():
        setattr(cfg.SOLVER, k, v)
    spec = build_spec(cfg)
    drop = [None if m is None else tuple(x.to(device) for x in m) for m in d["drop"]]
    kw = {AXIS_KW[a]: n for a, n in axes.items()}
    res = {"rank": rank}
    with mesh.use(mesh.make_mesh(**kw)) as m:
        res["coords"] = dict(m.coords)
        lo, n = res["rows"] = mesh.local_rows(cfg.TRAIN.BATCH_SIZE)
        batch = {k: v[lo:lo + n].to(device) for k, v in d["batch"].items()}
        model = CSTS(spec)
        model.load_state_dict(d["sd"])
        model = model.float().to(device).eval()
        if m.size(mesh.MODEL_AXIS) > 1:
            mesh.split_model(model, m)
        if device == "cuda":
            _launches(reset=True)
        with torch.inference_mode():
            res["logits"] = model(batch["video"], batch["audio"]).cpu()
        if device == "cuda":
            res["launches_forward"] = _launches()
        state = tstep.create_train_state(cfg, spec, state_dict=d["sd"], device=device)
        step = tstep.make_train_step(cfg, spec, steps_per_epoch=10)
        mesh.COUNTS.clear()
        if device == "cuda":
            _launches(reset=True)
        stats, _ = step(state, batch, None, drop=drop)
        if device == "cuda":
            res["launches_step"] = _launches()
        res["counts"] = dict(mesh.COUNTS)
        res["stats"] = {k: float(v) for k, v in stats.items()}
        res["grads"] = whole_grads(state.model)
        res["params"] = whole_params(state.model)
        res["split"] = {}
        opt = state.optimizer.local
        for n, p in state.model.named_parameters():
            how = getattr(p, "model_split", None)
            if how is not None:  # under ZeRO-1, None where another data rank keeps it
                st = opt.state.get(p, {})
                res["split"][n] = (how, tuple(p.shape), *(
                    tuple(st[k].shape) if k in st else None for k in ("exp_avg", "exp_avg_sq")))
        res["dtensor"] = any(isinstance(p, collectives.DTensor)
                             for p in state.model.parameters())
        res["pipe_plan"] = {"S": pipeline.pipe_size(),
                            "M": pipeline.effective_microbatches(pipeline.pipe_size() or 1)}
        params = list(state.model.parameters())
        res["all_dtensor"] = all(isinstance(p, collectives.DTensor) for p in params)
        res["held"] = (sum(collectives.local(p).numel() for p in params)
                       / sum(p.numel() for p in params))
        res["moments_of"] = sorted(n for n, p in state.model.named_parameters()
                                   if "exp_avg" in opt.state.get(p, {}))
        if save is not None:
            res["npz"] = tcu.save_checkpoint(save, state, 0, cfg)
        del state
    return res


def sync_order_worker(rank: int, out: str) -> None:
    """sp2 x pp2 on four ranks: two one-tensor "blocks", one a stage; this
    rank's gradient of its own stage's block is its stripe's part (10·stage
    + seq index + 1), marked on the seq axis, and both blocks are marked on
    the pipe axis, as ``models/csts.py`` marks a pipelined run on stripes.
    Summed by ``sync_grads`` (seq, then pipe) and by the pipe axis first."""
    res = {}
    with mesh.use(mesh.make_mesh(seq_parallel=2, pipe_parallel=2)) as m:
        s, q = m.index(mesh.PIPE_AXIS), m.index(mesh.SEQ_AXIS)
        res["stage"] = s
        for order in ("seq_then_pipe", "pipe_then_seq"):
            ws = [torch.nn.Parameter(torch.zeros(3)) for _ in range(2)]
            ws[s].grad = torch.full((3,), float(10 * s + q + 1))
            mesh.note_partial(mesh.SEQ_AXIS, [ws[s]])
            mesh.note_partial(mesh.PIPE_AXIS, ws)
            if order == "seq_then_pipe":
                mesh.sync_grads()
            else:
                mesh.sum_partial(mesh.PIPE_AXIS)
                mesh.sum_partial(mesh.SEQ_AXIS)
            res[order] = [w.grad.clone() for w in ws]
    torch.save(res, os.path.join(out, f"sync{rank}.pt"))


def schedule_worker(rank: int, out: str) -> None:
    """``pipeline_blocks`` on a pipe axis of the whole group against a plain
    loop over the same blocks: the forward, the input's and the weights'
    gradients (summed over the pipe by ``sync_grads``), at M = S and M = 2S;
    then the microbatch index each block is handed."""
    S = torch.distributed.get_world_size()
    L, B, D = 4, 8, 16
    g = torch.Generator().manual_seed(0)
    ws = [torch.nn.Parameter(torch.randn(D, D, generator=g) * 0.1) for _ in range(L)]
    bs = [torch.nn.Parameter(torch.randn(D, generator=g) * 0.1) for _ in range(L)]
    x0 = torch.randn(B, 4, D, generator=g)
    blocks = [torch.nn.Module() for _ in range(L)]
    for blk, w, b in zip(blocks, ws, bs):
        blk.w, blk.b = w, b

    def apply_one(j, z, m):
        return torch.tanh(z @ ws[j] + bs[j])

    def ref(z):
        for j in range(L):
            z = apply_one(j, z, 0)
        return z

    res = {}
    with mesh.use(mesh.make_mesh(pipe_parallel=S)):
        for M in (S, 2 * S):
            x = x0.clone().requires_grad_()
            y = pipeline.pipeline_blocks(apply_one, blocks, x, microbatches=M)
            (y ** 2).sum().backward()
            mesh.sync_grads()
            res[M] = {"y": y.detach().clone(), "dx": x.grad.clone(),
                      "dw": [w.grad.clone() for w in ws], "db": [b.grad.clone() for b in bs]}
            for p in ws + bs:
                p.grad = None
        x = x0.clone().requires_grad_()
        y = ref(x)
        (y ** 2).sum().backward()
        res["ref"] = {"y": y.detach(), "dx": x.grad, "dw": [w.grad for w in ws],
                      "db": [b.grad for b in bs]}
        # the microbatch index: each block adds a constant of m, so a wrong m
        # at any stage or step changes the output
        consts = torch.randn(8, generator=torch.Generator().manual_seed(5))
        with torch.no_grad():
            res["index"] = pipeline.pipeline_blocks(
                lambda j, z, m: z + consts[m], [torch.nn.Module() for _ in range(S)],
                torch.zeros(8, 4), microbatches=4)
        res["consts"] = consts
    torch.save(res, os.path.join(out, f"schedule{rank}.pt"))

"""The device mesh as process groups (``csts_tpu/parallel/mesh.py``;
reference ``slowfast/utils/multiprocessing.py`` and ``launch_job``, SURVEY
§2 C20).

One process per device: ``NUM_SHARDS`` shards (hosts) of ``NUM_DEVICES``
processes each, rank ``SHARD_ID · NUM_DEVICES + local_rank``. The backend
follows the device: NCCL on CUDA (the process's own card, ``local_rank``),
gloo on the CPU. Each rank takes rows ``[r·lb, (r+1)·lb)`` of every global
batch (``local_rows``), so W ranks compute what one process computes at the
global batch.

The mesh (:func:`make_mesh`) lays the ranks out on JAX's axes, (data, pipe,
seq, model) from major to minor, by plain enumeration: rank r sits at the
C-order index of r in that shape (the TPU's topology layout has no meaning
here). Each axis of size > 1 has the group of the ranks that differ on it
alone. :func:`use` installs a mesh (JAX's ``set_mesh``): the data axis's
collectives (``parallel/collectives.py``) then run over its data group, and
the model reads its axes:

* ``pipe`` (``parallel/pipeline.py``): GPipe over the encoder's uniform
  identity-block run (the flagship's v4-v11);
* ``model``: the Megatron pairs of each block split by heads
  (:func:`split_model`, :func:`param_sharding_rules`; ``models/mvit.py``);
* ``seq``: each rank holds a stripe of the encoder's tokens between blocks
  (:func:`seq_constraint`; ``models/csts.py``).

Every rank keeps whole copies of what its axes do not split, so the
gradients of what a rank computed only in part are summed over that axis
after the backward (:func:`sync_grads`). The collectives are the c10d ones
gloo carries on CUDA tensors too (``all_reduce``, ``all_gather``): two
ranks may share one card, which NCCL refuses.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import itertools
import os
import shutil
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch import nn

from csts_torch.config import Config
from csts_torch.parallel import collectives

DATA_AXIS = "data"
MODEL_AXIS = "model"
SEQ_AXIS = "seq"
PIPE_AXIS = "pipe"
AXES = (DATA_AXIS, PIPE_AXIS, SEQ_AXIS, MODEL_AXIS)

# collectives run by each axis's helpers since the counter was cleared (a
# test's proof that a split step communicates)
COUNTS: collections.Counter = collections.Counter()


@contextlib.contextmanager
def rendezvous():
    """A ``file://`` init method for the ranks of one host: a store file in
    a fresh temporary directory, removed on exit. No port is chosen, so two
    groups started at once cannot meet on one (a port freed by one process
    and bound later by another could be taken in between)."""
    d = tempfile.mkdtemp(prefix="csts-group-")
    try:
        yield "file://" + os.path.join(d, "store")
    finally:
        shutil.rmtree(d, ignore_errors=True)


@dataclasses.dataclass
class Mesh:
    """The ranks on the axes (data, pipe, seq, model). ``shape`` and
    ``coords`` name all four axes (size 1 where absent); ``groups`` holds
    this rank's group on each axis of size > 1, and on the data axis unless
    that is the whole world (then the default group)."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, object]

    @property
    def axis_names(self) -> Tuple[str, ...]:
        """JAX's axis names: data, then each other axis of size > 1."""
        return tuple(a for a in AXES if a == DATA_AXIS or self.shape[a] > 1)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups.get(axis)


_CURRENT: Optional[Mesh] = None


def current() -> Optional[Mesh]:
    """The installed mesh (None: the data axis alone, over the default group)."""
    return _CURRENT


def axis_size(axis: str) -> int:
    """The installed mesh's size on ``axis`` (1 without a mesh)."""
    return _CURRENT.shape[axis] if _CURRENT is not None else 1


def axis_index(axis: str) -> int:
    return _CURRENT.coords[axis] if _CURRENT is not None else 0


def set_current(mesh: Optional[Mesh]) -> None:
    """Installs ``mesh`` (None: none) and points the data axis's
    collectives at its data group."""
    global _CURRENT
    _CURRENT = mesh
    collectives.set_data_group(mesh.group(DATA_AXIS) if mesh is not None else None)
    _PARTIAL.clear()


@contextlib.contextmanager
def use(mesh: Optional[Mesh]):
    """``mesh`` installed for the block (``jax.sharding.set_mesh``)."""
    saved = _CURRENT
    set_current(mesh)
    try:
        yield mesh
    finally:
        set_current(saved)


def layout(n: int, model_parallel: int = 1, seq_parallel: int = 1, pipe_parallel: int = 1
           ) -> Tuple[Dict[str, int], np.ndarray]:
    """({axis: size} over the four axes, the ranks laid on them): the data
    size is n over the others' product; rank r sits at r's C-order index."""
    denom = model_parallel * seq_parallel * pipe_parallel
    if n % denom:
        raise ValueError(f"{n} ranks do not divide into model {model_parallel} x seq "
                         f"{seq_parallel} x pipe {pipe_parallel}")
    shape = {DATA_AXIS: n // denom, PIPE_AXIS: pipe_parallel, SEQ_AXIS: seq_parallel,
             MODEL_AXIS: model_parallel}
    return shape, np.arange(n).reshape([shape[a] for a in AXES])


def make_mesh(num_devices: Optional[int] = None, model_parallel: int = 1,
              seq_parallel: int = 1, pipe_parallel: int = 1) -> Mesh:
    """The started group's ranks on (data, pipe, seq, model): the data size
    is the world over the product of the others, the layout a C-order
    enumeration. Every rank calls it (it makes the axes' groups).
    ``num_devices``, if given, must be the world size: the port runs one
    process a device and cannot leave ranks out."""
    n = dist.get_world_size() if collectives.initialized() else 1
    if num_devices is not None and num_devices != n:
        raise ValueError(f"num_devices {num_devices}: the group has {n} ranks")
    shape, grid = layout(n, model_parallel, seq_parallel, pipe_parallel)
    dims = [shape[a] for a in AXES]
    me = dist.get_rank() if collectives.initialized() else 0
    coords = dict(zip(AXES, (int(c) for c in np.unravel_index(me, dims))))
    groups: Dict[str, object] = {}
    for k, axis in enumerate(AXES):
        # the data axis's collectives need a group of their own (one rank
        # included) unless it is the whole world
        if (dims[k] == n) if axis == DATA_AXIS else dims[k] == 1:
            continue
        # every rank makes every group of the axis, in one order
        others = [range(d) for j, d in enumerate(dims) if j != k]
        for rest in itertools.product(*others):
            idx = list(rest)
            idx.insert(k, slice(None))
            ranks = [int(r) for r in grid[tuple(idx)]]
            g = dist.new_group(ranks)
            if me in ranks:
                groups[axis] = g
    return Mesh(shape, coords, groups)


def check_axes(cfg: Config) -> None:
    """The axes divide the run's ranks (the ``finalize`` guard over
    NUM_SHARDS × NUM_DEVICES processes). Any of them compose."""
    p = cfg.PARALLEL
    world = cfg.NUM_SHARDS * cfg.NUM_DEVICES
    if world % (p.MODEL * p.SEQ * p.PIPE):
        raise ValueError(f"{world} ranks do not divide into PARALLEL.MODEL/SEQ/PIPE "
                         f"{p.MODEL}/{p.SEQ}/{p.PIPE}")


def mesh_from_cfg(cfg: Config) -> Mesh:
    """The run's mesh from ``cfg.PARALLEL`` over the started group, with
    ``pipeline.MICROBATCHES`` set from PARALLEL.PIPE_MICROBATCHES."""
    from csts_torch.parallel import pipeline

    check_axes(cfg)
    pipeline.MICROBATCHES = cfg.PARALLEL.PIPE_MICROBATCHES
    return make_mesh(model_parallel=cfg.PARALLEL.MODEL, seq_parallel=cfg.PARALLEL.SEQ,
                     pipe_parallel=cfg.PARALLEL.PIPE)


def init_from_cfg(cfg: Config, device, local_rank: int = 0,
                  init_method: Optional[str] = None) -> torch.device:
    """Starts the default group of ``NUM_SHARDS × NUM_DEVICES`` processes as
    rank ``SHARD_ID · NUM_DEVICES + local_rank`` and returns this rank's
    device (on CUDA the card ``local_rank``, made current). ``init_method``
    is the rendezvous (``tcp://host:port``, or ``file://path`` on one host);
    a group of one rank needs none (an in-memory store). With model, seq or
    pipe axes the run's mesh is installed (:func:`mesh_from_cfg`). Raises
    when the group does not start."""
    check_axes(cfg)
    world = cfg.NUM_SHARDS * cfg.NUM_DEVICES
    rank = cfg.SHARD_ID * cfg.NUM_DEVICES + local_rank
    device = torch.device(device)
    if device.type == "cuda":
        if local_rank >= torch.cuda.device_count():
            raise RuntimeError(f"local rank {local_rank} has no card: "
                               f"{torch.cuda.device_count()} visible")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
        backend = "nccl"
    else:
        backend = "gloo"
    meet = {"init_method": init_method}
    if init_method is None:
        if cfg.NUM_SHARDS > 1:
            raise ValueError("several shards need --init-method tcp://host:port")
        if world > 1:
            raise ValueError(f"{world} ranks need an init_method (run_net makes one)")
        meet = {"store": dist.HashStore()}
    dist.init_process_group(backend, world_size=world, rank=rank,
                            device_id=device if backend == "nccl" else None, **meet)
    p = cfg.PARALLEL
    if p.MODEL * p.SEQ * p.PIPE > 1:
        set_current(mesh_from_cfg(cfg))
    return device


def local_rows(global_batch_size: int) -> Tuple[int, int]:
    """(first row, rows) of this rank's stripe of a global batch (its data
    axis index's)."""
    w = collectives.world_size()
    if global_batch_size % w:
        raise ValueError(f"batch {global_batch_size} does not divide over {w} ranks")
    n = global_batch_size // w
    return collectives.rank() * n, n


def wrap_for_training(model: nn.Module, cfg: Config) -> nn.Module:
    """The module a training step calls. With a group started:
    ``DistributedDataParallel`` over the data axis (its ``.module`` is
    ``model``), or under SOLVER.FSDP ``model`` itself with each transformer
    block and then the whole model sharded by FSDP2's ``fully_shard`` (in
    place: the parameters become DTensors, whole again inside each block's
    forward; the blocks of the pipe axis's pipelined runs stay in the
    model's group, whole from the model's forward to the end of its
    backward). Under an installed mesh the model axis first splits the
    Megatron pairs in place (:func:`split_model`; FSDP then shards the parts
    again over the data axis's group), and a data axis of one rank takes no
    DDP. Without a group, ``model``."""
    if not collectives.initialized():
        return model
    check_axes(cfg)
    m = current()
    if m is not None and m.size(MODEL_AXIS) > 1:
        split_model(model, m)
    axes = m is not None and any(m.size(a) > 1 for a in (PIPE_AXIS, SEQ_AXIS, MODEL_AXIS))
    if cfg.SOLVER.FSDP:
        from torch.distributed.fsdp import fully_shard, register_fsdp_forward_method

        from csts_torch.models.mvit import MultiScaleBlock

        kw = {}
        if m is not None and m.group(DATA_AXIS) is not None:
            from torch.distributed.device_mesh import DeviceMesh

            kw["mesh"] = DeviceMesh.from_group(m.group(DATA_AXIS),
                                               next(model.parameters()).device.type)
        # a model-axis shard is sharded again over the data axis (JAX's
        # fsdp_param_sharding: 2-D); FSDP2 makes new parameters, which keep
        # the split's mark
        split = {n: p.model_split for n, p in model.named_parameters()
                 if getattr(p, "model_split", None) is not None}
        # the pipelined runs' blocks stay in the root's group: the root
        # gathers them before the forward and reduce-scatters their gradients
        # after the whole backward, so a stage's own backward (a nested
        # autograd.grad, parallel/pipeline.py) differentiates the unsharded
        # tensors it computed with and fires no FSDP hook
        piped = {id(model.blocks[j]) for lo, n in getattr(model, "pipe_runs", list)()
                 for j in range(lo, lo + n)}
        for mod in list(model.modules()):
            if isinstance(mod, MultiScaleBlock) and id(mod) not in piped:
                fully_shard(mod, **kw)
                if m is not None and m.size(SEQ_AXIS) > 1:
                    # a stripe's block runs forward_rows (models/csts.py _seq_block)
                    register_fsdp_forward_method(mod, "forward_rows")
        fully_shard(model, **kw)
        for n, p in model.named_parameters():
            if n in split:
                p.model_split = split[n]
        return model
    if axes and m.size(DATA_AXIS) == 1:
        return model
    device = next(model.parameters()).device
    return nn.parallel.DistributedDataParallel(
        model, device_ids=[device] if device.type == "cuda" else None,
        process_group=collectives.data_group(),
        # kldiv alone never reaches the NCE projections; a pipe stage runs its blocks only
        find_unused_parameters="nce" not in cfg.MODEL.LOSS_FUNC or axis_size(PIPE_AXIS) > 1)


# ----------------------------------------------------------------------------------
# collectives of the model axes
# ----------------------------------------------------------------------------------


def all_reduce(x: torch.Tensor, axis: str) -> torch.Tensor:
    """The sum of ``x`` over ``axis``'s group (a new tensor; ``x`` itself
    without a group)."""
    g = _CURRENT.group(axis) if _CURRENT is not None else None
    if g is None:
        return x
    # a fresh contiguous buffer; a 16-bit float is summed in fp32 and rounded once
    y = torch.empty(x.shape, dtype=torch.float32 if x.element_size() == 2 else x.dtype,
                    device=x.device).copy_(x.detach())
    COUNTS[axis] += 1
    dist.all_reduce(y, group=g)
    return y.to(x.dtype)


def all_gather(x: torch.Tensor, axis: str) -> List[torch.Tensor]:
    """Every rank's ``x`` (equal shapes) on ``axis``, in its order; no
    gradient. A 16-bit float travels as its bytes."""
    g = _CURRENT.group(axis)
    x = x.detach().contiguous()
    wire = x.view(torch.uint8) if x.element_size() == 2 and x.dim() else x
    parts = [torch.empty_like(wire) for _ in range(_CURRENT.size(axis))]
    COUNTS[axis] += 1
    dist.all_gather(parts, wire, group=g)
    return [p.view(x.dtype) for p in parts] if wire is not x else parts


class _Gather(torch.autograd.Function):
    """All-gather along ``dim`` over ``axis``. ``partial``: each rank's
    downstream computes a different part, so the backward sums the ranks'
    gradients before it keeps its slice (an all-reduce and a slice); else
    the downstream is replicated and the backward keeps its slice alone."""

    @staticmethod
    def forward(ctx, x, axis, dim, partial):
        ctx.axis, ctx.dim, ctx.partial = axis, dim, partial
        ctx.n, ctx.me = x.shape[dim], _CURRENT.index(axis)
        return torch.cat(all_gather(x, axis), dim=dim)

    @staticmethod
    def backward(ctx, grad):
        if ctx.partial:
            grad = all_reduce(grad, ctx.axis)
        return grad.narrow(ctx.dim, ctx.me * ctx.n, ctx.n).contiguous(), None, None, None


class _Reduce(torch.autograd.Function):
    """Sum over ``axis``; the backward passes the gradient through (the
    downstream is replicated): Megatron's ``g``."""

    @staticmethod
    def forward(ctx, x, axis):
        return all_reduce(x, axis)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _Copy(torch.autograd.Function):
    """The identity; the backward sums the gradient over ``axis`` (each
    rank's downstream used a part): Megatron's ``f``."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad, ctx.axis), None


def gather(x: torch.Tensor, axis: str, dim: int, partial: bool) -> torch.Tensor:
    """``x`` of every rank on ``axis`` concatenated along ``dim``,
    differentiable (see :class:`_Gather`)."""
    return _Gather.apply(x, axis, dim, partial)


def reduce_sum(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _Reduce.apply(x, axis)


def copy_in(x: torch.Tensor, axis: str) -> torch.Tensor:
    return _Copy.apply(x, axis)


# ----------------------------------------------------------------------------------
# the seq axis
# ----------------------------------------------------------------------------------


def seq_divides(n_tokens: int) -> bool:
    """Whether a token axis of ``n_tokens`` shards over the seq axis."""
    s = axis_size(SEQ_AXIS)
    return s > 1 and n_tokens % s == 0


def seq_constraint(tokens: torch.Tensor) -> torch.Tensor:
    """JAX's ``seq_constraint`` on whole (B, L, C) tokens: this rank's stripe
    of the token axis when an installed seq axis divides L, else ``tokens``.
    The backward gathers the stripes' gradients (the upstream is whole on
    every rank)."""
    if tokens.dim() != 3 or not seq_divides(tokens.shape[1]):
        return tokens
    return _Stripe.apply(tokens)


class _Stripe(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        s, me = axis_size(SEQ_AXIS), axis_index(SEQ_AXIS)
        n = x.shape[1] // s
        return x[:, me * n:(me + 1) * n].contiguous()

    @staticmethod
    def backward(ctx, grad):
        return torch.cat(all_gather(grad, SEQ_AXIS), dim=1)


def seq_rows(n_tokens: int) -> Tuple[int, int]:
    """(first, count) of this rank's stripe of ``n_tokens`` tokens."""
    n = n_tokens // axis_size(SEQ_AXIS)
    return axis_index(SEQ_AXIS) * n, n


# ----------------------------------------------------------------------------------
# the model axis and the gradients computed in part
# ----------------------------------------------------------------------------------

# per axis, the parameters whose gradients a rank computed in part in the
# last forward with a graph (summed over the axis by sync_grads): each a
# parameter, or (module, name) where FSDP2 swaps the module's parameter
# between its sharded and unsharded tensors
_PARTIAL: Dict[str, Dict[object, object]] = collections.defaultdict(dict)


def note_partial(axis: str, items) -> None:
    """Marks ``items`` (parameters, or (module, parameter name) pairs) as
    computed in part on ``axis`` by this forward (only where a graph is
    built, and the same on every rank of the axis)."""
    if axis_size(axis) > 1 and torch.is_grad_enabled():
        d = _PARTIAL[axis]
        for it in items:
            d.setdefault(id(it) if isinstance(it, torch.Tensor) else (id(it[0]), it[1]), it)


def module_params(module: nn.Module, prefixes: Tuple[str, ...] = ("",)) -> list:
    """(module, name) of ``module``'s parameters whose names start with one
    of ``prefixes``: what ``note_partial`` follows through FSDP2."""
    return [(module, n) for n, _ in module.named_parameters() if n.startswith(prefixes)]


@torch.no_grad()
def sum_partial(axis: str) -> None:
    """Sums over ``axis`` the gradients its ranks computed in part since the
    last call (a missing gradient counts as zeros; under FSDP each rank's
    shard, which the axis's ranks hold alike), as one flat all-reduce."""
    items = list(_PARTIAL.pop(axis, {}).values())
    if not items:
        return
    params = [it if isinstance(it, torch.Tensor) else it[0].get_parameter(it[1])
              for it in items]
    for p in params:
        if p.grad is None:
            p.grad = torch.zeros_like(p)
    grads = [collectives.local(p.grad) for p in params]
    flat = all_reduce(torch.cat([g.reshape(-1) for g in grads]), axis)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()


def sync_grads() -> None:
    """:func:`sum_partial` over the model, seq and pipe axes, in that order;
    every rank of an axis calls it in the same order. A pipe stage marks
    only its own blocks on the model and seq axes (the heads' parts of the
    shared pool weights, the stripes' parts of every weight), and those
    groups hold the ranks of one stage: so the stage's parts are summed
    within it before the pipe axis sums the stages. Summed the other way,
    a stage's rank would keep its own stripe's part of the other stage's
    blocks."""
    for axis in (MODEL_AXIS, SEQ_AXIS, PIPE_AXIS):
        sum_partial(axis)


def split_model(model: nn.Module, m: Optional[Mesh] = None) -> nn.Module:
    """Splits the Megatron pairs of every block whose heads and hidden width
    divide the model axis, in place (``models/mvit.py``
    ``MultiScaleBlock.split_heads``): qkv by heads and fc1 by columns
    (column-parallel), the attention's proj and fc2 by their input columns
    (row-parallel). The split parameters are marked ``model_split``."""
    from csts_torch.models.mvit import MultiScaleBlock

    m = m or current()
    w, r = m.size(MODEL_AXIS), m.index(MODEL_AXIS)
    for mod in model.modules():
        if isinstance(mod, MultiScaleBlock) and mod.tp is None and mod.can_split(w):
            mod.split_heads(r, w)
    return model


def param_sharding_rules(model: nn.Module, model_parallel: int = 1
                         ) -> Dict[str, Optional[int]]:
    """{parameter name: the dimension a model axis of ``model_parallel``
    ranks splits (torch's layout: 0 for a column-parallel weight and bias,
    1 for a row-parallel weight), or None where the parameter stays whole}:
    JAX's ``param_sharding_rules`` (qkv and fc1 column-parallel, proj and
    fc2 row-parallel) over the blocks :func:`split_model` splits."""
    from csts_torch.models.mvit import MultiScaleBlock

    rules = {n: None for n, _ in model.named_parameters()}
    if model_parallel <= 1:
        return rules
    for name, mod in model.named_modules():
        if isinstance(mod, MultiScaleBlock) and (mod.tp is not None
                                                 or mod.can_split(model_parallel)):
            pre = f"{name}." if name else ""
            for leaf, dim in (("attn.qkv.weight", 0), ("attn.qkv.bias", 0),
                              ("attn.proj.weight", 1), ("mlp.fc1.weight", 0),
                              ("mlp.fc1.bias", 0), ("mlp.fc2.weight", 1)):
                if pre + leaf in rules:
                    rules[pre + leaf] = dim
    return rules


def whole_split(t: torch.Tensor, how) -> torch.Tensor:
    """A model-axis shard (or a state of one) gathered whole: "qkv" by
    heads within each of Q, K and V, else along dimension ``how``."""
    parts = all_gather(t, MODEL_AXIS)
    if how == "qkv":
        return torch.cat([p.reshape(3, -1, *t.shape[1:]) for p in parts], 1).reshape(
            -1, *t.shape[1:])
    return torch.cat(parts, dim=how)


def shard_split(value: torch.Tensor, how) -> torch.Tensor:
    """This rank's model-axis shard of a whole tensor (``whole_split``'s inverse)."""
    w, r = axis_size(MODEL_AXIS), axis_index(MODEL_AXIS)
    if how == "qkv":
        heads = value.reshape(3, w, -1, *value.shape[1:])[:, r]
        return heads.reshape(-1, *value.shape[1:])
    n = value.shape[how] // w
    return value.narrow(how, r * n, n)


def whole_shape(t: torch.Tensor) -> Tuple[int, ...]:
    """The whole shape of a tensor that may be a model-axis shard."""
    how = getattr(t, "model_split", None)
    shape = list(t.shape)
    if how is not None:
        shape[0 if how == "qkv" else how] *= axis_size(MODEL_AXIS)
    return tuple(shape)

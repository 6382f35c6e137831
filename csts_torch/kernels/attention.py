"""K1 and B8: the multiscale attention core, softmax(q kᵀ · scale [+ mask]) v,
and its backward.

Port of ``csts_tpu/kernels/attention.py``: ``_attn_kernel`` (K1) and
``_flash_bwd_kernel`` (B8). On a CUDA tensor :func:`fused_attention` launches
the hand-written kernel in ``csrc/attention.cu`` (bf16: wgmma products fed by
a TMA ring of K/V chunks, online softmax in registers, the keys split 1-4
ways where the grid would leave the card idle, see :func:`key_splits`; fp32:
an exact FMA body) and :func:`fused_attention_bwd` the one in
``csrc/attention_bwd.cu``; on a CPU tensor each runs its ``*_plain`` twin,
the same function in plain PyTorch. There is no other route.
:func:`fused_attention_split_plain` is the plain model of the key split and
its merge. Both wrappers take any head dim, as the JAX kernels do. Which
body a call takes is a function of (head dim, dtype) alone, chosen before
the launch (:func:`kernel_head_dim`, :func:`streamed`): bf16 head dims up to
384 run the wgmma bodies at the next compiled head dim, zero-padded to it
(:func:`pad_head_dim`; exact), with the output columns split over blocks
above 192 (:func:`column_blocks`); fp32 at any head dim, and bf16 above 384,
run the streamed bodies, which sum the logits over 64-column steps of the
head dim and cut the rows a block takes until its accumulators fit
(:func:`fused_attention_streamed_plain` and
:func:`fused_attention_bwd_streamed_plain` are their plain models).

Training goes through :func:`attention_train` (the autograd Function
:class:`FusedAttention`): unmasked sites run K1 forward, which then also
writes each row's log-sum-exp, and B8 backward, as the JAX package's
``_fwd``/``_bwd`` do with its kernels on; a masked site (the spatial fusion)
runs K1 forward and recomputes the probabilities in plain PyTorch backward,
as JAX's XLA fallback does.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from csts_torch.kernels import _build


# head dims the bf16 wgmma bodies are compiled for (the flagship uses 96, and 192 at d2)
HEAD_DIMS = (64, 96, 128, 192, 256, 384)
# head-dim columns a step of the streamed bodies (csrc/attention.cu, attention_bwd.cu)
STREAM_COLS = 64


def streamed(hd: int, dtype: torch.dtype) -> bool:
    """Whether a call at head dim ``hd`` runs the streamed bodies
    (``attn_streamed_kernel``, ``dq_streamed_kernel``, ``dkdv_streamed_kernel``):
    every fp32 call, and bf16 above the largest wgmma instance (384), where
    whole-head-dim Q and K tiles no longer fit a block's shared memory."""
    return dtype != torch.bfloat16 or hd > HEAD_DIMS[-1]


def kernel_head_dim(hd: int, dtype: torch.dtype) -> int:
    """The head dim a call of K1 or B8 runs at: the inputs' last axis is
    zero-padded to it and the outputs sliced back (see :func:`pad_head_dim`).
    bf16 up to 384: the next compiled head dim of the wgmma bodies (16 and
    32 run at 64, 112 at 128, 200 at 256). The streamed bodies (fp32, and
    bf16 above 384, see :func:`streamed`) take any head dim (B8's needs it
    even), so an odd one gains one column."""
    if not streamed(hd, dtype):
        return next(d for d in HEAD_DIMS if hd <= d)
    return hd + hd % 2


def column_blocks(hd: int) -> Tuple[int, int, int]:
    """How many blocks share the output columns of one head in the bf16
    bodies at compiled head dim ``hd`` (``csrc/attention_wg.cuh``
    ``WgPlan``, ``csrc/attention_bwd.cu`` ``BwdPlan``): (K1, B8's dq pass,
    B8's dk/dv pass). A block holds its output columns in registers (a 64 x
    D fp32 accumulator is D/2 of a thread's): K1 up to 192 columns, then
    128 a block; the dq pass up to 192, then 128; the dk/dv pass's two
    accumulators 96 each (64 at 128 and 256). Each block recomputes the
    logits over the whole head dim. The streamed bodies (bf16 above 384)
    keep every column in one block: (1, 1, 1)."""
    if hd > HEAD_DIMS[-1]:
        return 1, 1, 1
    k1 = dq = 1 if hd <= 192 else hd // 128
    dkv = hd // (hd if hd in (64, 96) else 96 if hd in (192, 384) else 64)
    return k1, dq, dkv


def pad_head_dim(hdp: int, *ts: torch.Tensor) -> list:
    """Each tensor's last axis zero-padded to ``hdp``. Exact: zero columns of
    q and k add nothing to q·kᵀ (the logits, and so K1's log-sum-exp rows and
    the probabilities, are unchanged), zero columns of v give zero columns
    of the output, and B8's delta = rowsum(g·out) and its dq, dk, dv keep
    their values in the first columns (the padded ones are zero)."""
    return [t if t.shape[-1] == hdp else F.pad(t, (0, hdp - t.shape[-1])) for t in ts]


def _rows16(t: torch.Tensor) -> torch.Tensor:
    """t if its rows are unit-stride and start on 16-byte boundaries (the
    kernels load 16-byte pieces of them; TMA needs 16-byte strides), else a
    contiguous copy."""
    st = t.stride()
    if st[-1] == 1 and st[0] % 8 == 0 and st[1] % 8 == 0 and st[2] % 8 == 0 \
            and t.data_ptr() % 16 == 0:
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check_shapes(name: str, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    b, n, _, hd = q.shape
    lk = k.shape[2]
    if k.shape != (b, n, lk, hd) or v.shape != k.shape:
        raise ValueError(f"{name}: shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if b * n > 65535:
        raise ValueError(f"{name}: batch·heads above 65535")


def fused_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's numerics: fp32 logits and
    softmax, probabilities rounded to v's dtype, fp32-accumulated P·V, one
    rounding of the output. q: (B, N, Lq, hd); k, v: (B, N, Lk, hd);
    mask: additive fp32 (Lq, Lk). Returns (B, N, Lq, hd)."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    probs = torch.softmax(logits, dim=-1)
    out = torch.matmul(probs.to(v.dtype).float(), v.float())
    return out.to(v.dtype)


# keys a chunk of the bf16 body and a ring stage; query rows a block takes
KEY_CHUNK = 64
MAX_SPLITS = 4


def key_splits(bn: int, lq: int, lk: int, sms: int) -> int:
    """How many ways K1's bf16 body splits the keys: as many as the grid
    still fits in one wave of one block an SM (a block takes 128 query rows
    of one (batch, head), 64 where Lq ≤ 64, and its registers leave room for
    one block), at most 4, and at least 4 key chunks a split, so that the
    merge's extra launch pays for itself. A grid that already fills the card
    is not split: more blocks would only queue."""
    tiles = -(-lq // (128 if lq > 64 else 64)) * bn
    chunks = -(-lk // KEY_CHUNK)
    return max(1, min(MAX_SPLITS, chunks // 4, sms // tiles))


def split_ranges(lk: int, splits: int) -> list:
    """The key range [start, stop) of each split, as the kernel cuts them:
    whole chunks, ceil(chunks / splits) a split (the last may be short)."""
    chunks = -(-lk // KEY_CHUNK)
    per = -(-chunks // splits)
    return [(z * per * KEY_CHUNK, min(lk, (z + 1) * per * KEY_CHUNK))
            for z in range(splits) if z * per * KEY_CHUNK < lk]


def fused_attention_split_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float, splits: int,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain model of the bf16 body's key split and merge: per split z (keys
    of :func:`split_ranges`), fp32 logits, m_z their row max, p_z = exp(s −
    m_z), l_z = Σ p_z in fp32 and o_z = p_z (rounded to v's dtype) · v_z in
    fp32; then m = max m_z, f_z = exp(m_z − m) and out = Σ f_z o_z / Σ f_z l_z,
    rounded once. With one split it is :func:`fused_attention_plain` but for
    the unnormalised rounding of p."""
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits + mask.float()
    parts = []
    for a, b in split_ranges(k.shape[2], splits):
        s = logits[..., a:b]
        m = s.amax(dim=-1, keepdim=True)
        p = torch.exp(s - m)
        parts.append((m, p.sum(dim=-1, keepdim=True),
                      torch.matmul(p.to(v.dtype).float(), v[..., a:b, :].float())))
    m = torch.stack([m_z for m_z, _, _ in parts]).amax(dim=0)
    num = sum(torch.exp(m_z - m) * o_z for m_z, _, o_z in parts)
    den = sum(torch.exp(m_z - m) * l_z for m_z, l_z, _ in parts)
    return (num / den).to(v.dtype)


_SMS: dict = {}
_FWD = []  # the C entry point, looked up once
_ARGS = ctypes.c_longlong * 29


def _sm_count(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def query_tiles_per_block(bn: int, lq: int, sms: int) -> int:
    """How many query tiles (128 rows, 64 where Lq ≤ 64) of one (batch,
    head) a block of K1's bf16 body walks: enough that the grid is one wave
    of one block an SM; the next tile's loads then overlap the current
    tile's work instead of waiting for a second wave."""
    rows = 128 if lq > 64 else 64
    return max(1, -(-(-(-lq // rows) * bn) // sms))


def _attention_fwd(q, k, v, scale, mask, with_lse: bool):
    """K1 on CUDA tensors: (out, lse), lse the fp32 (B·N, Lq) log-sum-exp of
    each row's logits when ``with_lse``, else None. The bf16 body's key
    splits and query tiles a block are :func:`key_splits` and
    :func:`query_tiles_per_block`, read from the module on each call.
    It runs on every launch, so it allocates only the outputs and keeps its
    checks to the tensors' metadata."""
    _build.check_cuda_inputs("fused_attention", q, k, v)
    _check_shapes("fused_attention", q, k, v)
    if not scale > 0:
        raise ValueError(f"fused_attention: scale {scale} must be positive")
    b, n, lq, hd_in = q.shape
    lk = k.shape[2]
    hd = kernel_head_dim(hd_in, q.dtype)  # the caller's scale stays 1/sqrt(hd_in)
    q, k, v = (_rows16(t) for t in pad_head_dim(hd, q, k, v))
    bf16 = q.dtype == torch.bfloat16
    mask_bf16 = 0
    if mask is not None:
        if mask.shape != (lq, lk) or mask.device != q.device:
            raise ValueError(f"fused_attention: mask {tuple(mask.shape)} on {mask.device} is "
                             f"not ({lq}, {lk}) on {q.device}")
        # the bf16 body reads a bf16 or fp32 mask as it is; the fp32 body fp32
        if not (bf16 and mask.dtype == torch.bfloat16):
            mask = mask.to(torch.float32)
        mask_bf16 = int(mask.dtype == torch.bfloat16)
        mask = mask.contiguous()
    dev = q.device
    # above head dim 192 a block takes one 64-row tile and a column slice
    wide = hd > 192
    splits = key_splits(b * n, lq, lk, _sm_count(dev)) if bf16 and not wide else 1
    tpb = (query_tiles_per_block(b * n, lq, _sm_count(dev))
           if bf16 and splits == 1 and not wide else 1)
    out = torch.empty((b, lq, n, hd), dtype=q.dtype, device=dev)
    lse = torch.empty((b * n, lq), dtype=torch.float32, device=dev) if with_lse else None
    ws = ml = None
    if splits > 1:
        ws = torch.empty((splits, b * n, lq, hd), dtype=torch.float32, device=dev)
        ml = torch.empty((splits, b * n, lq, 2), dtype=torch.float32, device=dev)
    if not _FWD:
        _FWD.append(_build.function("attention", "csts_attention_fwd"))
    qs, ks, vs = q.stride(), k.stride(), v.stride()
    ptr = lambda t: 0 if t is None else t.data_ptr()  # noqa: E731
    err = _FWD[0](_ARGS(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), ptr(mask), mask_bf16,
        out.data_ptr(), ptr(lse), ptr(ws), ptr(ml), splits, tpb, b, n, lq, lk, hd,
        qs[0], qs[1], qs[2], ks[0], ks[1], ks[2], vs[0], vs[1], vs[2], lq * n * hd, hd, n * hd,
    ), float(scale), _build.stream_ptr(q))
    _build.check_launch("fused_attention", err)
    fused_attention.launches += 1
    return out.permute(0, 2, 1, 3)[..., :hd_in], lse


def fused_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """softmax(q kᵀ · scale [+ mask]) v, probabilities never in device memory.

    q: (B, N, Lq, hd); k, v: (B, N, Lk, hd), any strides (head views of a
    fused qkv projection pass without a copy; unaligned rows are copied);
    mask: additive (Lq, Lk), broadcast over batch and heads. Returns
    (B, N, Lq, hd); on CUDA it is a view of a token-major (B, Lq, N·hd)
    buffer, so merging the heads afterwards is free. Which body a head dim
    takes: bf16 up to 384 the wgmma body at the next compiled head dim
    (zero-padded; the output columns split over blocks above 192), bf16
    above 384 and fp32 at any head dim the streamed body (see
    :func:`kernel_head_dim`, :func:`streamed`).
    """
    if q.device.type == "cpu":
        return fused_attention_plain(q, k, v, scale, mask)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention: unsupported device {q.device}")
    return _attention_fwd(q, k, v, scale, mask, with_lse=False)[0]


fused_attention.launches = 0


# ----------------------------------------------------------------------------------
# B8: the backward
# ----------------------------------------------------------------------------------


def _bwd_p_dl(q, k, v, out, g, scale):
    """B8's p and dl rounded to q's dtype (as fp32), and g in fp32."""
    dt = q.dtype
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale, dim=-1)
    g32 = g.float()
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    dl = p * (torch.matmul(g32, v.float().transpose(-1, -2)) - delta)
    return p.to(dt).float(), dl.to(dt).float(), g32


def fused_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    scale: float, lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B8 with the kernel's rounding points: fp32
    logits and softmax (recomputed here; ``lse`` is the kernel's shortcut and
    is not read), delta = rowsum(g·out) and dl = p·(g vᵀ − delta) in fp32, p
    and dl rounded to q's dtype before the products dv = pᵀ g, dq = dl k ·
    scale and dk = dlᵀ q · scale, each accumulated in fp32 and rounded once.
    Returns (dq, dk, dv) in the inputs' dtype."""
    dt = q.dtype
    p, dl, g32 = _bwd_p_dl(q, k, v, out, g, scale)
    dq = torch.matmul(dl, k.float()) * scale
    dk = torch.matmul(dl.transpose(-1, -2), q.float()) * scale
    dv = torch.matmul(p.transpose(-1, -2), g32)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def _column_slices(hd: int, blocks: int) -> list:
    w = hd // blocks
    return [slice(i * w, (i + 1) * w) for i in range(blocks)]


def fused_attention_columns_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain model of K1's bf16 plan at any head dim: q, k, v zero-padded to
    :func:`kernel_head_dim`, each of :func:`column_blocks`'s output column
    blocks computed from the logits over the whole padded head dim and its
    own columns of v, the blocks side by side, sliced back to the head dim."""
    hd = q.shape[-1]
    hdp = kernel_head_dim(hd, torch.bfloat16)
    qp, kp, vp = pad_head_dim(hdp, q, k, v)
    outs = [fused_attention_plain(qp, kp, vp[..., c], scale, mask)
            for c in _column_slices(hdp, column_blocks(hdp)[0])]
    return torch.cat(outs, dim=-1)[..., :hd]


def fused_attention_bwd_columns_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain model of B8's bf16 plan at any head dim: the inputs zero-padded
    to :func:`kernel_head_dim`; p and dl over the whole padded head dim (each
    column block of the kernel recomputes them), then dq by the dq pass's
    column blocks (dl k[:, cols]), dk and dv by the dk/dv pass's (dlᵀ
    q[:, cols], pᵀ g[:, cols]), side by side, sliced back to the head dim.
    The rounding points are :func:`fused_attention_bwd_plain`'s."""
    hd, dt = q.shape[-1], q.dtype
    hdp = kernel_head_dim(hd, torch.bfloat16)
    qp, kp, vp, op, gp = pad_head_dim(hdp, q, k, v, out, g)
    p, dl, g32 = _bwd_p_dl(qp, kp, vp, op, gp, scale)
    _, nq, nkv = column_blocks(hdp)
    dq = torch.cat([torch.matmul(dl, kp[..., c].float()) * scale
                    for c in _column_slices(hdp, nq)], dim=-1)
    dlt, pt = dl.transpose(-1, -2), p.transpose(-1, -2)
    dk = torch.cat([torch.matmul(dlt, qp[..., c].float()) * scale
                    for c in _column_slices(hdp, nkv)], dim=-1)
    dv = torch.cat([torch.matmul(pt, g32[..., c]) for c in _column_slices(hdp, nkv)], dim=-1)
    return tuple(t[..., :hd].to(dt) for t in (dq, dk, dv))


def _streamed_logits(q32: torch.Tensor, k32: torch.Tensor) -> torch.Tensor:
    """q kᵀ summed over :data:`STREAM_COLS`-column steps of the head dim, in
    step order (the streamed bodies carry one FMA chain across the steps;
    here each step is a matmul added in turn: the same sum, another order)."""
    s = None
    for d0 in range(0, q32.shape[-1], STREAM_COLS):
        part = torch.matmul(q32[..., d0:d0 + STREAM_COLS],
                            k32[..., d0:d0 + STREAM_COLS].transpose(-1, -2))
        s = part if s is None else s + part
    return s


def fused_attention_streamed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain model of K1's streamed body (``csrc/attention.cu``
    ``attn_streamed_kernel``): per 64-key chunk the logits summed over
    64-column steps of the head dim, times scale (+ mask), an online softmax
    in fp32 (m, l), the probabilities rounded to v's dtype unnormalised
    before o += p·v (l sums the unrounded ones), out = o / l rounded once.
    In fp32 nothing is rounded but the output."""
    dt = v.dtype
    q32, k32, v32 = q.float(), k.float(), v.float()
    lead = q.shape[:-1]
    m = torch.full((*lead, 1), -float("inf"))
    l = torch.zeros((*lead, 1))
    o = torch.zeros((*lead, v.shape[-1]))
    for c0 in range(0, k.shape[2], KEY_CHUNK):
        s = _streamed_logits(q32, k32[..., c0:c0 + KEY_CHUNK, :]) * scale
        if mask is not None:
            s = s + mask[:, c0:c0 + KEY_CHUNK].float()
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(p.to(dt).float(), v32[..., c0:c0 + KEY_CHUNK, :])
        m = m_new
    return (o / l).to(dt)


def fused_attention_bwd_streamed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain model of B8's streamed bodies (``csrc/attention_bwd.cu``
    ``dq_streamed_kernel``, ``dkdv_streamed_kernel``): the logits q kᵀ and
    dP = g vᵀ summed over 64-column steps of the head dim, p = exp(logits·
    scale − lse) with lse the rows' log-sum-exp, delta = rowsum(g·out), dl =
    p·(dP − delta); p and dl rounded to q's dtype before dv = pᵀ g, dq = dl k
    · scale and dk = dlᵀ q · scale, each accumulated in fp32 and rounded
    once. The rounding points are :func:`fused_attention_bwd_plain`'s."""
    dt = q.dtype
    q32, k32, v32, g32 = q.float(), k.float(), v.float(), g.float()
    s = _streamed_logits(q32, k32) * scale
    p = torch.exp(s - torch.logsumexp(s, dim=-1, keepdim=True))
    delta = (g32 * out.float()).sum(dim=-1, keepdim=True)
    dl = (p * (_streamed_logits(g32, v32) - delta)).to(dt).float()
    p = p.to(dt).float()
    dq = torch.matmul(dl, k32) * scale
    dk = torch.matmul(dl.transpose(-1, -2), q32) * scale
    dv = torch.matmul(p.transpose(-1, -2), g32)
    return dq.to(dt), dk.to(dt), dv.to(dt)


def bwd_max_chunks(sms: int, bn: int, lq: int, lk: int, col_blocks: int) -> int:
    """Query chunks of B8's dk/dv pass: about two blocks per SM (blocks are
    64 keys x a chunk x batch·head x ``col_blocks``, the bf16 body's column
    blocks of :func:`column_blocks`, 1 for the fp32 body), at least four
    64-row query tiles per chunk. The chunks' fp32 partials are summed in
    chunk order by a third launch."""
    blocks = -(-lk // 64) * col_blocks * bn
    return max(1, min(-(-lq // 64) // 4, -(-2 * sms // blocks)))


def fused_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    scale: float, lse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of softmax(q kᵀ · scale) v for the output gradient g.

    q, out, g: (B, N, Lq, hd); k, v: (B, N, Lk, hd), any strides with unit
    columns; lse: K1's fp32 (B·N, Lq) log-sum-exp rows, required on CUDA.
    dq is a view of a token-major (B, Lq, N·hd) buffer, dk and dv are
    contiguous, all in q's dtype (views of the padded ones where the head dim
    runs padded). Which body a head dim takes: bf16 up to 384 the wgmma
    passes at the next compiled head dim (the output columns split over
    blocks from 128 on), bf16 above 384 and fp32 at any head dim the
    streamed passes (see :func:`kernel_head_dim`, :func:`streamed`).
    """
    if q.device.type == "cpu":
        return fused_attention_bwd_plain(q, k, v, out, g, scale, lse)
    if q.device.type != "cuda":
        raise ValueError(f"fused_attention_bwd: unsupported device {q.device}")
    _build.check_cuda_inputs("fused_attention_bwd", q, k, v, out, g)
    _check_shapes("fused_attention_bwd", q, k, v)
    b, n, lq, hd_in = q.shape
    lk = k.shape[2]
    if out.shape != q.shape or g.shape != q.shape:
        raise ValueError(f"fused_attention_bwd: out {tuple(out.shape)} / g {tuple(g.shape)} "
                         f"are not q's {tuple(q.shape)}")
    if (lse is None or lse.shape != (b * n, lq) or lse.dtype != torch.float32
            or lse.device != q.device):
        raise ValueError("fused_attention_bwd: needs K1's fp32 (B·N, Lq) log-sum-exp rows "
                         "on q's device")
    hd = kernel_head_dim(hd_in, q.dtype)
    q, k, v, out, g = (_rows16(t) for t in pad_head_dim(hd, q, k, v, out, g))
    lse = lse.contiguous()
    dev, dt = q.device, q.dtype
    bf16 = dt == torch.bfloat16
    # the bf16 body pads delta's and lse's rows to whole 64-row tiles
    lq_pad = -(-lq // 64) * 64
    delta = torch.empty((b * n, lq_pad), dtype=torch.float32, device=dev)
    lse_pad = torch.empty_like(delta) if bf16 else None
    dq = torch.empty((b, lq, n, hd), dtype=dt, device=dev)
    dk = torch.empty((b, n, lk, hd), dtype=dt, device=dev)
    dv = torch.empty_like(dk)
    chunks = bwd_max_chunks(_sm_count(dev), b * n, lq, lk, column_blocks(hd)[2] if bf16 else 1)
    ws = (torch.empty((chunks, 2, b * n, lk, hd), dtype=torch.float32, device=dev)
          if chunks > 1 else None)
    fn = _build.function("attention_bwd", "csts_attention_bwd")
    err = fn(
        _build.dtype_code(q), q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        lse_pad.data_ptr() if lse_pad is not None else None, dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), ws.data_ptr() if ws is not None else None, chunks,
        b, n, lq, lk, hd,
        *(s for t in (q, k, v, out, g) for s in (t.stride(0), t.stride(1), t.stride(2))),
        lq * n * hd, hd, n * hd,
        float(scale), _build.stream_ptr(q),
    )
    _build.check_launch("fused_attention_bwd", err)
    fused_attention_bwd.launches += 1
    return dq.permute(0, 2, 1, 3)[..., :hd_in], dk[..., :hd_in], dv[..., :hd_in]


fused_attention_bwd.launches = 0


def masked_attention_bwd_plain(q, k, v, mask, g, scale):
    """The masked sites' backward, JAX's XLA fallback (``_bwd`` at
    ``attention.py:361-375``) in plain PyTorch: fp32 probabilities recomputed
    from q, k and the mask, delta = rowsum(dP·p), fp32 products, one rounding
    of each gradient. The mask is a buffer and gets none."""
    p = torch.softmax(torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
                      + mask.float(), dim=-1)
    g32 = g.float()
    dv = torch.matmul(p.transpose(-1, -2), g32)
    dp = torch.matmul(g32, v.float().transpose(-1, -2))
    dl = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(dl, k.float()) * scale
    dk = torch.matmul(dl.transpose(-1, -2), q.float()) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


class FusedAttention(torch.autograd.Function):
    """K1 forward; B8 backward where there is no mask, the plain recompute
    where there is one. The same code on both devices: on the CPU the
    wrappers run their plain twins."""

    @staticmethod
    def forward(ctx, q, k, v, scale, mask):
        ctx.scale = float(scale)
        if q.device.type == "cuda":
            out, lse = _attention_fwd(q, k, v, scale, mask, with_lse=mask is None)
        else:
            out, lse = fused_attention(q, k, v, scale, mask), None
        if mask is None:
            ctx.save_for_backward(q, k, v, out, lse)
        else:
            ctx.save_for_backward(q, k, v, mask)
        ctx.masked = mask is not None
        return out

    @staticmethod
    def backward(ctx, g):
        if ctx.masked:
            q, k, v, mask = ctx.saved_tensors
            dq, dk, dv = masked_attention_bwd_plain(q, k, v, mask, g, ctx.scale)
        else:
            q, k, v, out, lse = ctx.saved_tensors
            dq, dk, dv = fused_attention_bwd(q, k, v, out, g, ctx.scale, lse)
        return dq, dk, dv, None, None


def attention_train(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, scale: float,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """:func:`fused_attention` inside autograd (see :class:`FusedAttention`)."""
    return FusedAttention.apply(q, k, v, scale, mask)

"""The kernels of ``csts_tpu/kernels/block.py``:

* K2 :func:`fused_mlp_tail` (``_mlp_tail_kernel``): the MLP tail of an MViT
  block, LN2 → fc1 → GELU → fc2, plus the base (``proj(LN2(x))`` when
  dim ≠ dim_out, else x); ``csrc/mlp_tail.cu``.
* B7 :func:`fused_mlp_tail_train` (``_mlp_tail_train_kernel``): K2 in
  training, with the per-sample stochastic-depth factor on the MLP branch
  and the pre-GELU hidden stored; ``csrc/mlp_tail_train.cu``. Its backward,
  :func:`fused_mlp_tail_train_bwd`, is written by hand in PyTorch (the JAX
  package's is XLA outside any kernel), and :func:`mlp_tail_train` puts the
  two behind one autograd Function.
* B3 :func:`fused_block` (``_block_kernel``): a whole identity-skip block
  from x and the pooled K/V; ``csrc/block.cu`` (a Q GEMM on the caller's
  LN1 rows, K1's body and B4's back; :func:`fused_block_split_plain` is the
  plain model of that split). At 3-8 heads the same
  kernel is B9b/B9c, the JAX package's head-grid (``_block_hg_kernel``) and
  block-diagonal (``_block_bd_kernel``) variants: one kernel for any head
  count, so the port has no ``variant`` argument.
* B4 :func:`fused_pool_block` (``_pool_block_kernel``): a whole Q-pool block
  from the fine pre-pool Q, the max-pooled skip and the pooled K/V;
  ``csrc/pool_block.cu`` (the Q conv, K1's body, a proj GEMM and K2's split
  tail; :func:`fused_pool_block_split_plain` is the plain model of that
  split).
* B5 :func:`fused_decoder_block` (``_decoder_kernel``): a whole upsample-Q
  decoder block from the coarse pre-upsample Q, the trilinear skip and the
  pooled K/V; ``csrc/decoder_block.cu``.

On a CUDA tensor each wrapper launches its kernel (or raises); on a CPU
tensor it runs its ``*_plain`` twin, which computes the same function in
plain PyTorch with the kernel's rounding points (those of the TPU kernels).
Weights are in ``nn.Linear`` / ``nn.Conv3d`` layout.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from csts_torch.kernels import _build
from csts_torch.ops.common import gelu

LN_EPS = 1e-6
Q_NORM_EPS = 1e-5  # norm_q: torch's default, as the reference hard-codes it


def _layer_norm32(x32: torch.Tensor, w: torch.Tensor, b: torch.Tensor, eps: float,
                  width: Optional[int] = None) -> torch.Tensor:
    """fp32 LayerNorm with two-pass statistics, the kernels' form. ``width``:
    the statistics over the first ``width`` columns only (rows zero-padded
    past it, whose weight and bias are zero, so they come out zero)."""
    xs = x32 if width is None else x32[..., :width]
    mean = xs.mean(dim=-1, keepdim=True)
    var = (xs - mean).square().mean(dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps) * w.float() + b.float()


def _tail_plain(x32, dtype, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b):
    """LN2 → MLP (+proj) + base on fp32 rows, rounding LN2 and the hidden to
    ``dtype`` before their products and the sum once at the end."""
    xn = _layer_norm32(x32, ln_w, ln_b, LN_EPS).to(dtype).float()
    hid = torch.matmul(xn, fc1_w.float().t()) + fc1_b.float()
    hid = gelu(hid).to(dtype).float()
    mlp = torch.matmul(hid, fc2_w.float().t()) + fc2_b.float()
    if proj_w is not None:
        base = torch.matmul(xn, proj_w.float().t()) + proj_b.float()
    else:
        base = x32
    return (base + mlp).to(dtype)


def fused_mlp_tail_plain(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor] = None, proj_b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch version with the kernel's rounding points: fp32 LN2
    statistics, LN2(x) and GELU(hidden) rounded to x's dtype before their
    products, fp32 accumulation and bias adds, one rounding of the result."""
    return _tail_plain(x.float(), x.dtype, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b,
                       proj_w, proj_b)


def fused_mlp_tail_split_plain(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor] = None, proj_b: Optional[torch.Tensor] = None,
    dp: Optional[torch.Tensor] = None, ln_width: Optional[int] = None,
):
    """Plain model of the bf16 body's split at the hidden (``csrc/mlp_tail.cuh``),
    launch by launch with its scratch in x's dtype: xn2 = LN2(x) rounded
    once; h = xn2·W1ᵀ + b1 in fp32 and G = GELU(h) rounded once; then one
    fp32 sum acc = G·W2ᵀ, for B7 (``dp`` given) acc = dp·(acc + b2), + xn2·Wpᵀ
    where dim ≠ dim_out, and out = acc (+ b2 for K2) + (bp or x), rounded
    once. The same rounding points as :func:`fused_mlp_tail_plain` and
    :func:`fused_mlp_tail_train_plain`, summed in the kernel's order.
    ``ln_width``: LN2's statistics over that many leading columns (the rows
    and weights zero-padded past it, see :func:`pad_tail`). Returns out
    (K2), or (out, h rounded) (B7)."""
    dt = x.dtype
    x32 = x.float()
    xn2 = _layer_norm32(x32, ln_w, ln_b, LN_EPS, ln_width).to(dt).float()
    h = torch.matmul(xn2, fc1_w.float().t()) + fc1_b.float()
    g = gelu(h).to(dt).float()
    acc = torch.matmul(g, fc2_w.float().t())
    if dp is not None:
        acc = _dp_rows(dp, x) * (acc + fc2_b.float())
    if proj_w is not None:
        acc = acc + torch.matmul(xn2, proj_w.float().t())
    if dp is None:
        acc = acc + fc2_b.float()
    out = (acc + (proj_b.float() if proj_w is not None else x32)).to(dt)
    return out if dp is None else (out, h.to(dt))


def _up16(n: int) -> int:
    return -(-n // 16) * 16


def pad_tail(x: torch.Tensor, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w=None,
             proj_b=None) -> tuple:
    """The tail's rows and weights zero-padded to widths that are multiples
    of 16 (the bf16 body's): x's and LN2's columns and fc1's and proj's
    input columns to C', fc1's rows, its bias and fc2's input columns to H',
    fc2's and proj's rows and their biases to C_out'. Exact where LN2 takes
    its statistics over the true width (``ln_width``): the zero columns of
    LN2's output meet zero weight columns, the zero hidden columns (GELU(0)
    = 0) meet zero columns of fc2, and the zero output columns are sliced
    off. Returns (x, *weights) padded (each unchanged where it already fits)."""
    c, hidden, cout = x.shape[-1], fc1_w.shape[0], fc2_w.shape[0]
    cp, hp, cop = _up16(c), _up16(hidden), _up16(cout)

    def pad(t, *to):
        if t is None:
            return None
        return F.pad(t, [a for n, m in zip(reversed(t.shape), reversed(to)) for a in (0, m - n)])
    return (pad(x, *x.shape[:-1], cp), pad(ln_w, cp), pad(ln_b, cp), pad(fc1_w, hp, cp),
            pad(fc1_b, hp), pad(fc2_w, cop, hp), pad(fc2_b, cop), pad(proj_w, cop, cp),
            pad(proj_b, cop))


def _tail_launch_args(name, x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b):
    """K2's and B7's input checks: one CUDA device and dtype, widths that
    fit. The bf16 body takes widths that are multiples of 16: others are
    zero-padded to them (:func:`pad_tail`; LN2 keeps its statistics over the
    true width, passed as ``ln_width``, and the caller slices the outputs
    back); the fp32 body takes any width. Returns x as (M, C') rows, the
    weights (proj's last when present), each contiguous on a 16-byte
    boundary (the bf16 body reads them with TMA, which takes 16-byte rows
    and bases), and (hidden', dim_out', ln_width)."""
    if (proj_w is None) != (proj_b is None):
        raise ValueError(f"{name}: proj weight and bias go together")
    params = [ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b]
    if proj_w is not None:
        params += [proj_w, proj_b]
    _build.check_cuda_inputs(name, x, *params)
    c = x.shape[-1]
    hidden, cout = fc1_w.shape[0], fc2_w.shape[0]
    if fc1_w.shape != (hidden, c) or fc2_w.shape != (cout, hidden):
        raise ValueError(f"{name}: fc1 {tuple(fc1_w.shape)} / fc2 "
                         f"{tuple(fc2_w.shape)} do not fit width {c}")
    if proj_w is None and cout != c:
        raise ValueError(f"{name}: dim != dim_out needs the proj weights")
    if proj_w is not None and proj_w.shape != (cout, c):
        raise ValueError(f"{name}: proj {tuple(proj_w.shape)} is not ({cout}, {c})")
    x2 = x.reshape(-1, c)
    if x.dtype == torch.bfloat16 and (c % 16 or hidden % 16 or cout % 16):
        x2, *params = (t for t in pad_tail(x2, *params) if t is not None)
    x2, *params = (t if t.data_ptr() % 16 == 0 else t.clone()
                   for t in (x2.contiguous(), *(p.contiguous() for p in params)))
    return x2, params, (params[2].shape[0], params[4].shape[0], c)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _tail_scratch(x2: torch.Tensor, hidden: int):
    """The bf16 body's scratch for rows x2 (M, C): LN2's rounded rows xn2
    (M, C) and GELU of the hidden (M, hidden), both in x's dtype; (None,
    None) for the fp32 body, which keeps both on chip. The wrapper's locals
    hold them until the C call has queued every launch that reads them: a
    buffer freed earlier could be handed to the next allocation on the
    stream while a launch still reads it."""
    if x2.dtype != torch.bfloat16:
        return None, None
    m, c = x2.shape
    return (torch.empty((m, c), dtype=x2.dtype, device=x2.device),
            torch.empty((m, hidden), dtype=x2.dtype, device=x2.device))


def fused_mlp_tail(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor] = None, proj_b: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """x: (B, L, C) residual-complete attention output -> (B, L, dim_out)."""
    if x.device.type == "cpu":
        return fused_mlp_tail_plain(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_tail: unsupported device {x.device}")
    x2, params, (hidden, cout, c) = _tail_launch_args("fused_mlp_tail", x, ln_w, ln_b, fc1_w,
                                                      fc1_b, fc2_w, fc2_b, proj_w, proj_b)
    m, cp = x2.shape
    wp, bp = (params[6], params[7]) if proj_w is not None else (None, None)
    out = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    xn2, g = _tail_scratch(x2, hidden)
    fn = _build.function("mlp_tail", "csts_mlp_tail")
    err = fn(
        _build.dtype_code(x), x2.data_ptr(),
        *(t.data_ptr() for t in params[:6]),
        _ptr(wp), _ptr(bp),
        out.data_ptr(), _ptr(xn2), _ptr(g), m, cp, hidden, cout, c, LN_EPS,
        _build.stream_ptr(x),
    )
    _build.check_launch("fused_mlp_tail", err)
    fused_mlp_tail.launches += 1
    return out[:, :fc2_w.shape[0]].reshape(*x.shape[:-1], fc2_w.shape[0])


fused_mlp_tail.launches = 0


# ----------------------------------------------------------------------------------
# B7: the training tail. Forward kernel plus stored pre-GELU hidden; backward by
# hand from (x, hidden), a port of ``_tail_train_bwd`` (block.py:1672-1755).
# ----------------------------------------------------------------------------------


def _dp_rows(dp: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The per-sample factor (B,) as fp32 broadcastable over x (B, L, C)."""
    return dp.float().reshape(-1, *([1] * (x.dim() - 1)))


def fused_mlp_tail_train_plain(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor], proj_b: Optional[torch.Tensor],
    dp: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of B7 with the kernel's rounding points (K2's,
    see :func:`fused_mlp_tail_plain`): returns (out, hid_pre) with out =
    base + dp·mlp rounded once, dp the fp32 per-sample factor (B,), and
    hid_pre = fc1(LN2(x)) + bias rounded to x's dtype."""
    dt = x.dtype
    x32 = x.float()
    xn = _layer_norm32(x32, ln_w, ln_b, LN_EPS).to(dt).float()
    hid_pre = torch.matmul(xn, fc1_w.float().t()) + fc1_b.float()
    hid = gelu(hid_pre).to(dt).float()
    mlp = torch.matmul(hid, fc2_w.float().t()) + fc2_b.float()
    if proj_w is not None:
        base = torch.matmul(xn, proj_w.float().t()) + proj_b.float()
    else:
        base = x32
    return (base + _dp_rows(dp, x) * mlp).to(dt), hid_pre.to(dt)


def fused_mlp_tail_train(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor], proj_b: Optional[torch.Tensor],
    dp: torch.Tensor,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """B7 forward. x: (B, L, C) residual-complete attention output; dp: fp32
    (B,) stochastic-depth factor of the MLP branch. Returns (out (B, L,
    dim_out), hid_pre (B, L, hidden)), both in x's dtype."""
    if x.device.type == "cpu":
        return fused_mlp_tail_train_plain(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b,
                                          proj_w, proj_b, dp)
    if x.device.type != "cuda":
        raise ValueError(f"fused_mlp_tail_train: unsupported device {x.device}")
    if x.dim() != 3:
        raise ValueError(f"fused_mlp_tail_train: x {tuple(x.shape)} is not (B, L, C)")
    b, l, c = x.shape
    if dp.shape != (b,) or dp.dtype != torch.float32 or dp.device != x.device:
        raise ValueError(f"fused_mlp_tail_train: dp must be fp32 ({b},) on x's device")
    x2, params, (hidden, cout, c) = _tail_launch_args("fused_mlp_tail_train", x, ln_w, ln_b,
                                                      fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b)
    m, cp = x2.shape
    wp, bp = (params[6], params[7]) if proj_w is not None else (None, None)
    dp = dp.detach().contiguous()
    out = torch.empty((m, cout), dtype=x.dtype, device=x.device)
    hid = torch.empty((m, hidden), dtype=x.dtype, device=x.device)
    xn2, g = _tail_scratch(x2, hidden)
    fn = _build.function("mlp_tail_train", "csts_mlp_tail_train")
    err = fn(
        _build.dtype_code(x), x2.data_ptr(),
        *(t.data_ptr() for t in params[:6]),
        _ptr(wp), _ptr(bp),
        dp.data_ptr(), out.data_ptr(), hid.data_ptr(), _ptr(xn2), _ptr(g),
        m, l, cp, hidden, cout, c, LN_EPS, _build.stream_ptr(x),
    )
    _build.check_launch("fused_mlp_tail_train", err)
    fused_mlp_tail_train.launches += 1
    # padded widths (see pad_tail) are sliced back to the true ones
    h_true, co_true = fc1_w.shape[0], fc2_w.shape[0]
    return (out[:, :co_true].reshape(b, l, co_true), hid[:, :h_true].reshape(b, l, h_true))


fused_mlp_tail_train.launches = 0


def fused_mlp_tail_train_bwd(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor], proj_b: Optional[torch.Tensor],
    dp: torch.Tensor, hid_pre: torch.Tensor, g: torch.Tensor,
) -> tuple:
    """B7's hand-written backward from the stored (x, hid_pre) and the output
    gradient g, the same code on both devices, a port of ``_tail_train_bwd``.
    LN2's statistics are recomputed from x in fp32 (``native_layer_norm``),
    GELU and its derivative Φ(z)+z·φ(z) (``gelu_backward``) from the rounded
    hid_pre. The MLP branch takes gm = g·dp, the proj branch and the
    identity skip take g. Products take operands rounded to x's dtype and
    return fp32, as the JAX package's (``preferred_element_type``): a bf16
    product out in bf16 would round the rows that LN2's and the biases'
    gradients then sum over 262144 rows at d4. Sums over rows and LN2's
    backward (``native_layer_norm_backward``) are fp32. Returns dx in x's
    dtype, then the gradients of ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b,
    proj_w, proj_b in each weight's own dtype and ``nn.Linear`` layout (None
    for an absent proj)."""
    dt = x.dtype
    c = x.shape[-1]
    hidden, cout = fc1_w.shape[0], fc2_w.shape[0]

    def mm(a, b_):
        a, b_ = a.to(dt), b_.to(dt)
        if dt == torch.float32 or a.device.type != "cuda":
            return torch.matmul(a.float(), b_.float())
        return torch.mm(a, b_, out_dtype=torch.float32)  # tensor cores, fp32 out

    x32 = x.reshape(-1, c).float()
    w32, b32 = ln_w.float(), ln_b.float()
    xn2, mean, rstd = torch.native_layer_norm(x32, (c,), w32, b32, LN_EPS)
    z = hid_pre.reshape(-1, hidden)
    g32 = g.reshape(-1, cout).float()
    gm = (g.float() * _dp_rows(dp, g)).reshape(-1, cout)  # the MLP branch is dp-scaled

    d_fc2_w = mm(gm.t(), gelu(z))  # GELU in fp32, rounded to x's dtype for the product
    d_fc2_b = gm.sum(dim=0)
    dz = torch.ops.aten.gelu_backward(mm(gm, fc2_w), z.float(), approximate="none")
    d_fc1_w = mm(dz.t(), xn2)
    d_fc1_b = dz.sum(dim=0)
    dxn2 = mm(dz, fc1_w)
    d_proj_w = d_proj_b = None
    if proj_w is not None:
        # the dim-change proj reads LN2(x) and is not dp-scaled
        d_proj_w = mm(g32.t(), xn2)
        d_proj_b = g32.sum(dim=0)
        dxn2 = dxn2 + mm(g32, proj_w)
    dx, d_ln_w, d_ln_b = torch.ops.aten.native_layer_norm_backward(
        dxn2, x32, (c,), mean, rstd, w32, b32, [True, True, True])
    if proj_w is None:
        dx = dx + g32
    cast = lambda t, like: None if t is None else t.to(like.dtype)  # noqa: E731
    return (dx.to(dt).reshape(x.shape), cast(d_ln_w, ln_w), cast(d_ln_b, ln_b),
            cast(d_fc1_w, fc1_w), cast(d_fc1_b, fc1_b), cast(d_fc2_w, fc2_w),
            cast(d_fc2_b, fc2_b), cast(d_proj_w, proj_w), cast(d_proj_b, proj_b))


class MlpTailTrain(torch.autograd.Function):
    """B7 forward (:func:`fused_mlp_tail_train`, the weights cast to x's
    dtype for the kernel), :func:`fused_mlp_tail_train_bwd` backward. The
    weights' gradients come back in their own dtype, so fp32 master weights
    get fp32 gradients, as in the JAX package; dp gets none."""

    @staticmethod
    def forward(ctx, x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b, dp):
        weights = (ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b)
        cast = [None if w is None else w.to(x.dtype) for w in weights]
        out, hid = fused_mlp_tail_train(x, *cast, dp)
        ctx.save_for_backward(x, *weights, dp, hid)
        return out

    @staticmethod
    def backward(ctx, g):
        return (*fused_mlp_tail_train_bwd(*ctx.saved_tensors, g), None)


def mlp_tail_train(
    x: torch.Tensor,
    ln_w: torch.Tensor, ln_b: torch.Tensor,
    fc1_w: torch.Tensor, fc1_b: torch.Tensor,
    fc2_w: torch.Tensor, fc2_b: torch.Tensor,
    proj_w: Optional[torch.Tensor], proj_b: Optional[torch.Tensor],
    dp: torch.Tensor,
) -> torch.Tensor:
    """B7 inside autograd (see :class:`MlpTailTrain`). Returns (B, L, dim_out)."""
    return MlpTailTrain.apply(x, ln_w, ln_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b, dp)


# ----------------------------------------------------------------------------------
# B3, B4, B5: whole blocks. The weights after the attention are the same for all
# three: wproj, bproj, ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b
# (proj_* None when dim == dim_out).
# ----------------------------------------------------------------------------------


def _attend_plain(q, k, v, scale, skip32, wproj, bproj, *tail):
    """q: (B, N, Lq, hd) rounded per head; k, v: (B, N, Lk, hd). fp32 logits
    and softmax, normalised probabilities and av rounded to q's dtype, res1 =
    skip + av·Wprojᵀ + bproj kept in fp32 into the tail."""
    dt = q.dtype
    b, n, lq, hd = q.shape
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(dt).float()
    av = torch.matmul(probs, v.float()).to(dt).float()
    av = av.transpose(1, 2).reshape(b, lq, n * hd)
    res1 = skip32 + torch.matmul(av, wproj.float().t()) + bproj.float()
    return _tail_plain(res1, dt, *tail)


def fused_block_plain(x, k, v, scale, ln1_w, ln1_b, wq, bq, wproj, bproj, ln2_w, ln2_b,
                      fc1_w, fc1_b, fc2_w, fc2_b, proj_w=None, proj_b=None, xn=None):
    """B3 in plain PyTorch: the TPU kernel's function, LN1 included. x:
    (B, L, C); k, v: (B, N, Lk, hd) pooled; wq, bq: the Q rows of the qkv
    projection. LN1 is computed here from x in fp32, so that the twin also
    holds the LN1 rows the kernel is given. ``xn`` is taken, and not read,
    only so that the twin can stand in the kernel's place in the block's
    call (``chip_smoke.py``'s reference run). Returns (B, L, dim_out)."""
    tail = (ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b)
    dt = x.dtype
    b, l, c = x.shape
    n, hd = k.shape[1], k.shape[3]
    xn = _layer_norm32(x.float(), ln1_w, ln1_b, LN_EPS).to(dt).float()
    q = torch.matmul(xn, wq.float().t()) + bq.float()
    q = q.to(dt).reshape(b, l, n, hd).transpose(1, 2)
    return _attend_plain(q, k, v, scale, x.float(), wproj, bproj, *tail)


def _q_conv_plain(q, thw, stride, wconv, nq_w, nq_b, n, transposed):
    """The (transposed) depthwise 3x3x3 conv of the token-major Q (B, L, N·hd)
    on grid ``thw`` in fp32, then norm_q per head, rounded to q's dtype.
    Returns (B, N, L', hd)."""
    b, l, c = q.shape
    hd = c // n
    grid = q.float().reshape(b, *thw, n, hd).permute(0, 4, 5, 1, 2, 3).reshape(b * n, hd, *thw)
    stride = tuple(int(s) for s in stride)
    if transposed:
        out = F.conv_transpose3d(grid, wconv.float(), None, stride, 1,
                                 tuple(s - 1 for s in stride), hd)
    else:
        out = F.conv3d(grid, wconv.float(), None, stride, 1, 1, hd)
    out = out.reshape(b, n, hd, -1).transpose(2, 3)
    return _layer_norm32(out, nq_w, nq_b, Q_NORM_EPS).to(q.dtype)


def fused_pool_block_plain(q, thw, skip, k, v, scale, wconv, nq_w, nq_b, wproj, bproj, *tail):
    """B4 in plain PyTorch. q: (B, L_fine, C) post-Wq fine Q on grid ``thw``;
    skip: (B, L_coarse, C) the max-pooled x; wconv: (hd, 1, 3, 3, 3)."""
    qh = _q_conv_plain(q, thw, (1, 2, 2), wconv, nq_w, nq_b, k.shape[1], False)
    return _attend_plain(qh, k, v, scale, skip.float(), wproj, bproj, *tail)


def _split_back_plain(av, skip32, dt, wproj, bproj, ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b,
                      proj_w=None, proj_b=None):
    """Plain model of the split back (``csrc/split_back.cuh``, B3's and B4's)
    from av (rounded, fp32 values) and the fp32 skip: the proj GEMM's res1 =
    av·Wprojᵀ + bproj + skip in fp32 (never rounded); LN2 of res1 rounded
    (xn2; the kernels compute it in the proj GEMM's epilogue where one output
    tile holds whole rows, the same values), G = GELU(xn2·W1ᵀ + b1) rounded;
    fc2's out = G·W2ᵀ [+ xn2·Wpᵀ] + b2 + (bp or res1), rounded once to
    ``dt``."""
    res1 = skip32 + torch.matmul(av, wproj.float().t()) + bproj.float()
    xn2 = _layer_norm32(res1, ln2_w, ln2_b, LN_EPS).to(dt).float()
    g = gelu(torch.matmul(xn2, fc1_w.float().t()) + fc1_b.float()).to(dt).float()
    acc = torch.matmul(g, fc2_w.float().t())
    if proj_w is not None:
        acc = torch.matmul(xn2, proj_w.float().t()) + acc
    base = proj_b.float() if proj_w is not None else res1
    return (acc + fc2_b.float() + base).to(dt)


def fused_block_split_plain(x, k, v, scale, ln1_w, ln1_b, wq, bq, wproj, bproj, ln2_w, ln2_b,
                            fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b, xn):
    """Plain model of B3's split bf16 body (``csrc/block.cu``), launch by
    launch from the caller's LN1 rows ``xn`` (phase 1's, as the kernel takes
    them): q = xn·Wqᵀ + bq in fp32, rounded once
    (token-major, head h at columns h·hd); K1's attention with
    the probabilities rounded unnormalised
    (:func:`~csts_torch.kernels.attention.fused_attention_split_plain` at one
    split) and av rounded once; then the split back
    (:func:`_split_back_plain`). Arguments as :func:`fused_block`."""
    from csts_torch.kernels.attention import fused_attention_split_plain

    dt = x.dtype
    b, l, c = x.shape
    n, hd = k.shape[1], k.shape[3]
    q = (torch.matmul(xn.float(), wq.float().t()) + bq.float()).to(dt)
    av = fused_attention_split_plain(q.reshape(b, l, n, hd).transpose(1, 2), k, v, scale, 1)
    av = av.float().transpose(1, 2).reshape(b, l, c)
    return _split_back_plain(av, x.float(), dt, wproj, bproj, ln2_w, ln2_b, fc1_w, fc1_b,
                             fc2_w, fc2_b, proj_w, proj_b)


def fused_pool_block_split_plain(q, thw, skip, k, v, scale, wconv, nq_w, nq_b, wproj, bproj,
                                 *tail):
    """Plain model of B4's split bf16 body (``csrc/pool_block.cu``), launch by
    launch: the Q conv and norm_q in fp32, q rounded per head (the conv's
    scratch); K1's attention with the probabilities rounded unnormalised
    (:func:`~csts_torch.kernels.attention.fused_attention_split_plain` at one
    split) and av rounded once (the attention's scratch); then the split
    back (:func:`_split_back_plain`). Arguments as :func:`fused_pool_block`."""
    from csts_torch.kernels.attention import fused_attention_split_plain

    qh = _q_conv_plain(q, thw, (1, 2, 2), wconv, nq_w, nq_b, k.shape[1], False)
    b, n, lq, hd = qh.shape
    av = fused_attention_split_plain(qh, k, v, scale, 1).float()
    av = av.transpose(1, 2).reshape(b, lq, n * hd)
    return _split_back_plain(av, skip.float(), q.dtype, wproj, bproj, *tail)


def fused_decoder_block_plain(q, thw, stride, skip, k, v, scale, wconv, nq_w, nq_b,
                              wproj, bproj, *tail):
    """B5 in plain PyTorch. q: (B, L_coarse, C) post-Wq coarse Q on grid
    ``thw``; stride: the upsample's (1,2,2) or (2,1,1); skip: (B, L_fine, C)
    the trilinear skip; wconv: the ConvTranspose3d weight (hd, 1, 3, 3, 3)."""
    qh = _q_conv_plain(q, thw, stride, wconv, nq_w, nq_b, k.shape[1], True)
    return _attend_plain(qh, k, v, scale, skip.float(), wproj, bproj, *tail)


def _aligned(t: torch.Tensor) -> torch.Tensor:
    """Contiguous and on a 16-byte boundary (the kernels copy 16-byte pieces)."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def split_instance(lib: str, c: int, cout: int, hidden: int, hd: int, proj: bool) -> bool:
    """Whether the bf16 widths have an instance of the redesigned split body
    of ``lib`` ("block", "pool_block", "decoder_block"; ``split_instance`` in
    ``csrc/block.cu``, ``launch_bf16`` in ``pool_block.cu`` and
    ``decoder_block.cu``); other widths take the first design. ``proj``: the
    dim-change proj weights are given."""
    if lib == "block":
        return (hd == 96 and (c, cout) in ((96, 96), (96, 192), (192, 192), (192, 384),
                                           (384, 384), (384, 768), (768, 768))
                and hidden % 128 == 0 and proj == (c != cout))
    if lib == "pool_block":
        return (hd == 96 and (c, cout) in ((192, 192), (192, 384), (384, 384), (384, 768))
                and hidden % 128 == 0 and proj == (c != cout))
    if lib == "decoder_block":
        d4 = (c, cout) == (192, 96)
        return (proj and hd in (96, 192) and (d4 or (c, cout) in ((768, 384), (384, 192)))
                and hidden % (64 if d4 else 128) == 0)
    return False


def _launch_block(name, lib, fn, *, x=None, q=None, q_rs=0, skip=None, k, v, ln1=(None, None),
                  wq=None, bq=None, wconv=None, nq=(None, None), wproj, bproj, tail,
                  out_rows, grid_out=(0, 0, 0), grid_src=(0, 0, 0), stride=(1, 1, 1), scale,
                  scratch=False):
    ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b = tail
    if (proj_w is None) != (proj_b is None):
        raise ValueError(f"{name}: proj weight and bias go together")
    tensors = [t for t in (x, q, skip, k, v, *ln1, wq, bq, wconv, *nq, wproj, bproj, *tail)
               if t is not None]
    _build.check_cuda_inputs(name, *tensors)
    b, n, lk, hd = k.shape
    c, cout, hidden = wproj.shape[0], fc2_w.shape[0], fc1_w.shape[0]
    if v.shape != k.shape or wproj.shape != (c, c) or n * hd != c:
        raise ValueError(f"{name}: k {tuple(k.shape)} v {tuple(v.shape)} wproj "
                         f"{tuple(wproj.shape)} do not fit")
    if fc1_w.shape != (hidden, c) or fc2_w.shape != (cout, hidden):
        raise ValueError(f"{name}: fc1 {tuple(fc1_w.shape)} / fc2 {tuple(fc2_w.shape)}")
    if proj_w is None and cout != c:
        raise ValueError(f"{name}: dim != dim_out needs the proj weights")
    if proj_w is not None and proj_w.shape != (cout, c):
        raise ValueError(f"{name}: proj {tuple(proj_w.shape)} is not ({cout}, {c})")
    if c % 16 or cout % 16 or hidden % 16 or hd % 16 or hd > 256 or c > 768 or lk < 1:
        raise ValueError(f"{name}: widths {c}/{cout}/{hidden}, head dim {hd} and Lk {lk} must "
                         "be multiples of 16 with hd ≤ 256, dim ≤ 768, Lk ≥ 1")
    if b > 65535:
        raise ValueError(f"{name}: batch above 65535")
    dev, dt = k.device, k.dtype
    out = torch.empty((b, out_rows, cout), dtype=dt, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    x, skip, k, v = (None if t is None else _aligned(t) for t in (x, skip, k, v))
    ws = [None if t is None else _aligned(t)
          for t in (*ln1, wq, bq, wconv, *nq, wproj, bproj, *tail)]
    held = []
    if scratch:
        # The split bf16 bodies park q (B4's and B5's conv writes whole tiles:
        # 64 rows of slack a clip; B3's Q GEMM writes it; B3 and B4 then write
        # LN2's rows over it), av, both rounded, res1 (fp32) and, for B3 and
        # B4, the hidden G between their launches; the fp32 body and the
        # first design (widths without a split instance) need none of them
        # and get null pointers. The tensors are held until all the launches
        # are queued: a buffer freed earlier could be handed to the next one
        # on the same stream, and one launch would write over what another
        # reads.
        bf16 = dt == torch.bfloat16 and split_instance(lib, c, cout, hidden, hd,
                                                       proj_w is not None)
        shapes = [((b, out_rows + 64, c), dt), ((b * out_rows, c), dt),
                  ((b * out_rows, c), torch.float32)]
        if scratch == "hidden":
            shapes.append(((b * out_rows, hidden), dt))
        held = [torch.empty(shape, dtype=t, device=dev) if bf16 else None
                for shape, t in shapes]
    err = _build.function(lib, fn)(
        _build.dtype_code(k), ptr(x), ptr(q), ptr(skip), ptr(k), ptr(v), *map(ptr, ws),
        out.data_ptr(), *map(ptr, held), int(q_rs), b, out_rows, c, cout, hidden, n, hd, lk,
        *grid_out, *grid_src, *stride, float(scale), _build.stream_ptr(k),
    )
    _build.check_launch(name, err)
    return out


def _taps(wconv: torch.Tensor) -> torch.Tensor:
    """(hd, 1, 3, 3, 3) depthwise weight -> (27, hd) tap-major, the order the
    kernels read (taps numbered as torch numbers them, no flip)."""
    if tuple(wconv.shape[1:]) != (1, 3, 3, 3):
        raise ValueError(f"Q conv weight {tuple(wconv.shape)} is not (hd, 1, 3, 3, 3)")
    return wconv.reshape(wconv.shape[0], 27).t().contiguous()


def _rows_view(q: torch.Tensor) -> torch.Tensor:
    """q (B, L, C) with unit channel stride and one row stride that keeps
    16-byte rows (a column slice of the fused qkv projection passes as it
    is), else an aligned contiguous copy."""
    b, l, c = q.shape
    if (q.stride(2) == 1 and q.stride(0) == l * q.stride(1) and q.stride(1) % 8 == 0
            and q.data_ptr() % 16 == 0):
        return q
    return _aligned(q)


def fused_block(x, k, v, scale, ln1_w, ln1_b, wq, bq, wproj, bproj, ln2_w, ln2_b, fc1_w,
                fc1_b, fc2_w, fc2_b, proj_w=None, proj_b=None, xn=None):
    """B3: a whole identity-skip block. x: (B, L, C); k, v: (B, N, Lk, hd)
    pooled and normed; wq, bq: the Q rows of the qkv projection; then wproj,
    bproj, ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b; xn:
    LN1(x) in x's dtype, the rows phase 1 normalised for the K/V projection
    (``MultiScaleBlock.forward_block`` passes them), required in bf16: the
    split body (:func:`split_instance`) takes its Q product from them. The
    first design and the fp32 body compute LN1 from x themselves and do not
    read xn. Returns (B, L, dim_out)."""
    tail = (ln2_w, ln2_b, fc1_w, fc1_b, fc2_w, fc2_b, proj_w, proj_b)
    if x.device.type == "cpu":
        return fused_block_plain(x, k, v, scale, ln1_w, ln1_b, wq, bq, wproj, bproj, *tail)
    if x.device.type != "cuda":
        raise ValueError(f"fused_block: unsupported device {x.device}")
    if x.shape[0] != k.shape[0] or x.shape[2] != wproj.shape[0]:
        raise ValueError(f"fused_block: x {tuple(x.shape)} does not fit k {tuple(k.shape)}")
    if x.dtype == torch.bfloat16:
        if xn is None or xn.shape != x.shape:
            raise ValueError("fused_block: bf16 needs xn = LN1(x), of x's shape "
                             f"{tuple(x.shape)}")
        xn = _aligned(xn)
    else:
        xn = None
    out = _launch_block("fused_block", "block", "csts_fused_block", x=x, q=xn, k=k, v=v,
                        ln1=(ln1_w, ln1_b), wq=wq, bq=bq, wproj=wproj, bproj=bproj, tail=tail,
                        out_rows=x.shape[1], scale=scale, scratch="hidden")
    fused_block.launches += 1
    return out


def fused_pool_block(q, thw, skip, k, v, scale, wconv, nq_w, nq_b, wproj, bproj, *tail):
    """B4: a whole Q-pool block (stride (1,2,2)). q: (B, T·H·W, C) fine
    post-Wq Q on grid ``thw``; skip: the max-pooled x on the coarse grid;
    k, v: pooled; wconv: pool_q (hd, 1, 3, 3, 3). Returns (B, L_coarse, dim_out)."""
    if q.device.type == "cpu":
        return fused_pool_block_plain(q, thw, skip, k, v, scale, wconv, nq_w, nq_b,
                                      wproj, bproj, *tail)
    if q.device.type != "cuda":
        raise ValueError(f"fused_pool_block: unsupported device {q.device}")
    t, h, w = (int(s) for s in thw)
    out_grid = (t, (h - 1) // 2 + 1, (w - 1) // 2 + 1)
    l_out = out_grid[0] * out_grid[1] * out_grid[2]
    if q.shape[1] != t * h * w or skip.shape[:2] != (q.shape[0], l_out):
        raise ValueError(f"fused_pool_block: q {tuple(q.shape)} / skip {tuple(skip.shape)} "
                         f"do not fit grid {thw}")
    q = _rows_view(q)
    out = _launch_block("fused_pool_block", "pool_block", "csts_fused_pool_block", q=q,
                        q_rs=q.stride(1), skip=skip, k=k, v=v, wconv=_taps(wconv),
                        nq=(nq_w, nq_b), wproj=wproj, bproj=bproj, tail=tail, out_rows=l_out,
                        grid_out=out_grid, grid_src=(t, h, w), stride=(1, 2, 2), scale=scale,
                        scratch="hidden")
    fused_pool_block.launches += 1
    return out


def fused_decoder_block(q, thw, stride, skip, k, v, scale, wconv, nq_w, nq_b, wproj, bproj,
                        *tail):
    """B5: a whole upsample-Q decoder block. q: (B, T·H·W, C) coarse post-Wq
    Q on grid ``thw``; stride: (1,2,2) or (2,1,1); skip: the trilinear skip on
    the fine grid; k, v: pooled; wconv: upsample_q (hd, 1, 3, 3, 3).
    Returns (B, L_fine, dim_out)."""
    if q.device.type == "cpu":
        return fused_decoder_block_plain(q, thw, stride, skip, k, v, scale, wconv, nq_w, nq_b,
                                         wproj, bproj, *tail)
    if q.device.type != "cuda":
        raise ValueError(f"fused_decoder_block: unsupported device {q.device}")
    src = tuple(int(s) for s in thw)
    stride = tuple(int(s) for s in stride)
    if len(stride) != 3 or any(s not in (1, 2) for s in stride):
        raise ValueError(f"fused_decoder_block: strides {stride} must be 1 or 2")
    out_grid = tuple(n * s for n, s in zip(src, stride))
    l_out = out_grid[0] * out_grid[1] * out_grid[2]
    if q.shape[1] != src[0] * src[1] * src[2] or skip.shape[:2] != (q.shape[0], l_out):
        raise ValueError(f"fused_decoder_block: q {tuple(q.shape)} / skip "
                         f"{tuple(skip.shape)} do not fit grid {thw} at stride {stride}")
    q = _rows_view(q)
    out = _launch_block("fused_decoder_block", "decoder_block", "csts_fused_decoder_block",
                        q=q, q_rs=q.stride(1), skip=skip, k=k, v=v, wconv=_taps(wconv),
                        nq=(nq_w, nq_b), wproj=wproj, bproj=bproj, tail=tail, out_rows=l_out,
                        grid_out=out_grid, grid_src=src, stride=stride, scale=scale,
                        scratch=True)
    fused_decoder_block.launches += 1
    return out


fused_block.launches = 0
fused_pool_block.launches = 0
fused_decoder_block.launches = 0

"""The reference training step of CSTS-B: the training forward with the
stochastic-depth factors given, the per-frame softmax at T = 2, the loss
kldiv + LOSS_ALPHA·EgoNCE (``slowfast/models/losses.py``, ``utils/utils.py``),
fp32 autograd, the global-norm clip and AdamW with decoupled weight decay,
the learning rate of the cosine schedule, in plain fp32 PyTorch.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch

from .arch import CSTSArch
from .models import csts_forward, frame_softmax
from .nn import Round, ident

BETAS = (0.9, 0.999)
EPS = 1e-8


def kldiv(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """KL(pred ‖ target) of per-frame maps (B, T, H, W), summed over frames,
    divided by T·log(HW), averaged over the batch (``losses.py`` KLDiv)."""
    b, t, h, w = pred.shape
    p, q = pred.reshape(b, t, -1), target.reshape(b, t, -1)
    kl = (p * torch.log(p + 1e-10)).sum(-1) - (p * torch.log(q + 1e-10)).sum(-1)
    return (kl.sum(-1) / (t * math.log(h * w))).mean()


def egonce(v: torch.Tensor, a: torch.Tensor, temperature: float = 0.05) -> torch.Tensor:
    """Symmetric InfoNCE over the cosine similarities of the batch's vision
    and audio embeddings (``losses.py`` EgoNCE, ``utils.py`` sim_matrix)."""
    vn = v / v.norm(dim=1, keepdim=True).clamp(min=1e-8)
    an = a / a.norm(dim=1, keepdim=True).clamp(min=1e-8)
    sim = vn @ an.t()
    i = torch.softmax(sim / temperature, dim=1).diagonal()
    j = torch.softmax(sim.t() / temperature, dim=1).diagonal()
    return -torch.log(i).mean() - torch.log(j).mean()


def loss(P, a: CSTSArch, batch: Dict[str, torch.Tensor], drop, alpha: float,
         rd: Round = ident, rows: Optional[int] = None) -> torch.Tensor:
    """The objective of one step; ``rows``: the first rows of the batch only
    (a planted fault: the rest left out)."""
    if rows is not None:
        batch = {k: v[:rows] for k, v in batch.items()}
        drop = [None if d is None else tuple(m[:rows] for m in d) for d in drop]
    logits, v, au = csts_forward(P, a, batch["video"], batch["audio"], drop, embed=True, rd=rd)
    return kldiv(frame_softmax(logits)[..., 0], batch["labels_hm"]) + alpha * egonce(v, au)


def lr_at(c: Dict, epoch: float) -> float:
    """The cosine schedule after its warm-up (none in the configurations here)."""
    if c["SOLVER.LR_POLICY"] != "cosine" or c["SOLVER.WARMUP_EPOCHS"] > 0:
        raise ValueError("the reference schedule is the cosine one without warm-up")
    base, end, top = c["SOLVER.BASE_LR"], c["SOLVER.COSINE_END_LR"], c["SOLVER.MAX_EPOCH"]
    return end + (base - end) * (math.cos(math.pi * epoch / top) + 1.0) * 0.5


def decays(name: str, p: torch.Tensor, c: Dict) -> bool:
    """Weight decay applies except to 1-D tensors and biases (ZERO_WD_1D_PARAM)
    and, with ZERO_DECAY_POS_CLS, the position embeddings and cls token."""
    top = name.split(".")[0]
    if c["MVIT.ZERO_DECAY_POS_CLS"] and (top.startswith("pos_embed") or top == "cls_token"):
        return False
    return not (c["SOLVER.ZERO_WD_1D_PARAM"] and (p.dim() <= 1 or name.endswith("bias")))


def train(P0: Dict[str, torch.Tensor], a: CSTSArch, c: Dict, batches: List[Dict],
          drops: List[List], steps_per_epoch: int, rd: Round = ident,
          rows: Optional[int] = None) -> Dict:
    """``len(batches)`` steps from the weights ``P0`` (not modified).
    Returns {"loss": [per step], "grad": {name: norm of the first step's
    clipped gradient}, "change": {name: norm of the weights' change after the
    last step}}."""
    if c["SOLVER.OPTIMIZING_METHOD"] != "adamw":
        raise ValueError("the reference optimizer is AdamW")
    P = {k: v.detach().clone().float().requires_grad_() for k, v in P0.items()}
    m = {k: torch.zeros_like(v) for k, v in P.items()}
    s = {k: torch.zeros_like(v) for k, v in P.items()}
    wd, clip, alpha = c["SOLVER.WEIGHT_DECAY"], c["SOLVER.CLIP_GRAD_L2NORM"], c["MODEL.LOSS_ALPHA"]
    out: Dict = {"loss": []}
    for step, (batch, drop) in enumerate(zip(batches, drops), start=1):
        value = loss(P, a, batch, drop, alpha, rd, rows)
        grads = torch.autograd.grad(value, list(P.values()), allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for g, p in zip(grads, P.values())]
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        if clip and norm >= clip:
            grads = [g * (clip / norm) for g in grads]
        if step == 1:
            out["grad"] = {k: float(torch.linalg.vector_norm(g)) for k, g in zip(P, grads)}
        lr = lr_at(c, (step - 1) / steps_per_epoch)
        b1, b2 = BETAS
        with torch.no_grad():
            for (k, p), g in zip(P.items(), grads):
                if wd and decays(k, p, c):
                    p.mul_(1.0 - lr * wd)
                m[k].mul_(b1).add_(g, alpha=1.0 - b1)
                s[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                denom = (s[k].sqrt() / math.sqrt(1.0 - b2 ** step)).add_(EPS)
                p.addcdiv_(m[k], denom, value=-lr / (1.0 - b1 ** step))
        out["loss"].append(float(value.detach()))
        del value, grads
    with torch.no_grad():
        out["change"] = {k: float(torch.linalg.vector_norm(P[k] - P0[k].float())) for k in P}
    return out

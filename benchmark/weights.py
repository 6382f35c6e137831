"""Seeded weights made on the device in a few large calls: every parameter
of a model's list (:func:`reference.models.csts_params`, ``mvit_params``)
is a view of one flat buffer, whose truncated-normal part (cut at ±2 std)
is one inverse-CDF draw and whose uniform part one draw scaled per leaf.
No leaf is left at a constant: linears and convolutions take PyTorch's own initialisation
(weights and biases U(±1/sqrt(fan_in))), LayerNorm and pool-norm gains
1 + std 0.1 ("gain") and shifts std 0.1 ("shift"), position embeddings and
the cls token std 0.02 ("tn"). So every block adds to its residual about
as much as it carries, and a kernel that drops or misapplies a bias, a
gain or a shift changes the model's output.
The same seed gives the same values, so the reference makes them again
rather than keeping a copy.
"""

from __future__ import annotations

import math
from typing import Dict

import torch

from . import traffic


def make(seed: int, spec: Dict[str, tuple], device, dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """{name: tensor} in ``dtype`` on ``device`` for ``spec`` {name: (shape, init)}."""
    gen = traffic.generator(seed, "weights", device)
    order = sorted(spec, key=lambda k: str(spec[k][1]))  # the leaves of one rule together
    sizes = [math.prod(spec[k][0]) for k in order]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    views, at = {}, 0
    for k, n in zip(order, sizes):
        views[k] = flat[at:at + n]
        at += n

    def span(rule) -> slice:
        ks = [k for k in order if spec[k][1] == rule or
              (isinstance(rule, str) and rule == "uniform" and isinstance(spec[k][1], tuple))]
        if not ks:
            return slice(0, 0)
        lo = views[ks[0]].storage_offset() - flat.storage_offset()
        hi = views[ks[-1]].storage_offset() - flat.storage_offset() + views[ks[-1]].numel()
        return slice(lo, hi)

    parts = [s for s in map(span, ("gain", "shift", "tn")) if s.stop > s.start]  # adjacent
    normal = slice(parts[0].start, parts[-1].stop)
    lo_p = 0.5 * (1 + math.erf(-2 / math.sqrt(2)))
    u = torch.rand(normal.stop - normal.start, generator=gen, device=device) * (1 - 2 * lo_p) + lo_p
    flat[normal] = torch.special.ndtri(u).clamp_(-2.0, 2.0)
    un = span("uniform")
    flat[un] = torch.rand(un.stop - un.start, generator=gen, device=device) * 2 - 1
    for k in order:
        if isinstance(spec[k][1], tuple):
            views[k].mul_(spec[k][1][1])
    flat[span("tn")] *= 0.02
    flat[span("shift")] *= 0.1
    flat[span("gain")] = flat[span("gain")] * 0.1 + 1.0
    flat = flat.to(dtype)
    out, at = {}, 0
    for k, n in zip(order, sizes):
        out[k] = flat[at:at + n].view(spec[k][0])
        at += n
    return {k: out[k] for k in spec}

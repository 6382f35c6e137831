"""The traced part of a ``--trace 1`` run: a torch.profiler window inside
the measured window, the device activities it holds by kernel family, the
device's busy time and idle share, the longest idle gaps by what the host
was doing, and the work of each launch of the port's kernels.

The family table, the priming launches and the margin are copies of the
program's ``csts_torch/tools/profile_forward.py`` (without the margin and
the priming launches a window loses the device activity of its first
launches), kept here so that the yardstick does not move with the program.
"""

from __future__ import annotations

import contextlib
import functools
import importlib
import inspect
import time
from typing import Callable, Dict, List, Tuple

import torch

from . import counts

# device kernels by family, matched in order on the lowered kernel name
FAMILIES = (
    ("K1 attention", ("attn_wg_kernel", "attn_merge_kernel", "attn_streamed_kernel")),
    ("B8 attention_bwd", ("dq_wg_kernel", "dkdv_wg_kernel", "dq_streamed_kernel",
                          "dkdv_streamed_kernel", "namespace)::reduce_kernel<")),
    ("B7 mlp_tail_train", ("tail_ln_kernel<true", "tail_fc1_kernel<true",
                           "tail_fc2_kernel<true", "mlp_tail_f32_kernel<true")),
    ("K2 mlp_tail", ("tail_ln_kernel", "tail_fc1_kernel", "tail_fc2_kernel",
                     "mlp_tail_f32_kernel")),
    ("K3 t2_upsample", ("t2_upsample_kernel",)),
    ("B9a hw2_upsample", ("hw2_upsample_kernel",)),
    ("B4 pool_block", ("pool_conv_kernel", "pool_attn_kernel", "pool_proj_kernel",
                       "pool_ln_kernel", "pool_fc1_kernel", "pool_fc2_kernel")),
    ("B5 decoder_block", ("decoder_conv_kernel", "decoder_attn_kernel", "decoder_tail_kernel")),
    ("B3 block", ("block_ln_kernel", "block_q_kernel", "block_attn_kernel", "block_proj_kernel",
                  "block_fc1_kernel", "block_fc2_kernel")),
    ("B3-B5, B9b/c whole blocks", ("block_mma_kernel", "block_f32_kernel")),
    ("convolution", ("conv", "cudnn", "implicit", "dgrad", "fprop", "winograd")),
    ("matmul", ("gemm", "cutlass", "xmma", "matmul", "nvjet")),
    ("reduction", ("reduce",)),
    ("copy/layout", ("copy", "cat", "transpose", "permute", "index", "upsample")),
)
LIBRARY_FAMILIES = ("convolution", "matmul", "reduction", "copy/layout", "elementwise/other")
PORT_FAMILIES = tuple(f for f, _ in FAMILIES if f not in LIBRARY_FAMILIES)

MARGIN_S = 0.02  # the profiler keeps no activity that starts before its window opens
PRIMING_LAUNCHES = 256
_PRIMING_KERNEL = "spin_kernel"


def family(name: str) -> str:
    low = name.lower()
    return next((f for f, keys in FAMILIES if any(k in low for k in keys)), "elementwise/other")


# the port's kernel entry points, by (module, attribute), and the kernel each launches
HOOKS = (
    ("csts_torch.kernels.attention", "_attention_fwd", "K1"),
    ("csts_torch.kernels.attention", "fused_attention_bwd", "B8"),
    ("csts_torch.kernels.block", "fused_mlp_tail", "K2"),
    ("csts_torch.kernels.block", "fused_mlp_tail_train", "B7"),
    ("csts_torch.kernels.block", "fused_block", "B3"),
    ("csts_torch.kernels.block", "fused_pool_block", "B4"),
    ("csts_torch.kernels.block", "fused_decoder_block", "B5"),
    ("csts_torch.kernels.upsample", "t2_upsample", "K3"),
    ("csts_torch.kernels.upsample", "hw2_upsample", "B9a"),
)


def _positional(sig: inspect.Signature, args: tuple, kwargs: dict) -> tuple:
    """A call's arguments in the order of its signature, defaults filled in,
    a ``*args`` spread in place."""
    bound = sig.bind(*args, **kwargs)
    bound.apply_defaults()
    out = []
    for name, value in bound.arguments.items():
        star = sig.parameters[name].kind == inspect.Parameter.VAR_POSITIONAL
        out.extend(value if star else (value,))
    return tuple(out)


class KernelWork:
    """Counts the work of each launch of the port's kernels while installed:
    each entry point of :data:`HOOKS` that the program has is wrapped, the
    work of its arguments' shapes (``counts.kernel_work``) added on CUDA
    inputs. An entry point the program no longer has is skipped, so its
    launches add device time and no work: the share can only read low."""

    def __init__(self, device: str = "cuda"):
        self.device = device  # whose launches count (a test counts the CPU's plain twins)
        self.work: Dict[str, List[float]] = {}  # kernel -> [launches, flops, bytes, least s]
        self._saved: List[Tuple[object, str, Callable]] = []
        self._mask_share: Dict[Tuple[int, tuple], float] = {}

    def _share(self, mask) -> float:
        key = (mask.data_ptr(), tuple(mask.shape))
        if key not in self._mask_share:
            self._mask_share[key] = float((mask > -1e4).float().mean())
        return self._mask_share[key]

    def _wrap(self, fn: Callable, kernel: str) -> Callable:
        sig = inspect.signature(fn)

        @functools.wraps(fn)
        def counted(*args, **kwargs):
            out = fn(*args, **kwargs)
            args = _positional(sig, args, kwargs)
            first = args[0] if args else None
            if isinstance(first, torch.Tensor) and first.device.type == self.device:
                share = None
                if kernel == "K1" and args[4] is not None:
                    share = self._share(args[4])
                f, b = counts.kernel_work(kernel, args, share)
                w = self.work.setdefault(kernel, [0, 0.0, 0.0, 0.0])
                w[0] += 1
                w[1] += f
                w[2] += b
                w[3] += counts.least_seconds(f, b)
            return out
        return counted

    def __enter__(self):
        for mod_name, attr, kernel in HOOKS:
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                continue
            fn = getattr(mod, attr, None)
            if fn is None:
                continue
            self._saved.append((mod, attr, fn))
            setattr(mod, attr, self._wrap(fn, kernel))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            launches = getattr(getattr(mod, attr), "launches", None)
            setattr(mod, attr, fn)
            if launches is not None:
                fn.launches = launches
        self._saved.clear()
        return False


def _union(spans: List[Tuple[float, float]]) -> float:
    busy, reach = 0.0, float("-inf")
    for start, end in sorted(spans):
        busy += max(0.0, end - max(start, reach))
        reach = max(reach, end)
    return busy


class Traced:
    """One profiled stretch of a measured window: ``with Traced() as t:`` around
    the calls; afterwards :meth:`summary` reads the trace. The window is the
    host's time from the first call to the final synchronise, mapped onto the
    trace's clock. Only the card's activities are traced unless ``host``: the
    host's operations too, which slow a host-bound loop, so such a stretch
    serves only to name the idle gaps (:meth:`idle_gaps`). ``work``: count
    the port's kernels' work (:class:`KernelWork`)."""

    def __init__(self, work: bool = True, host: bool = False):
        self.kernel_work = KernelWork() if work else None
        self.host = host
        self.prof = None
        self._stack = contextlib.ExitStack()
        self._ns = (0, 0)

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile

        torch.cuda.synchronize()
        acts = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if self.host else [])
        self.prof = self._stack.enter_context(profile(activities=acts))
        for _ in range(PRIMING_LAUNCHES):
            torch.cuda._sleep(1)
        torch.cuda.synchronize()
        time.sleep(MARGIN_S)
        if self.kernel_work is not None:
            self._stack.enter_context(self.kernel_work)
        self._ns = (time.time_ns(), 0)
        return self

    def __exit__(self, *exc):
        torch.cuda.synchronize()
        self._ns = (self._ns[0], time.time_ns())
        self._stack.callback(time.sleep, MARGIN_S)  # runs first: the trace stays open a margin
        return self._stack.__exit__(*exc)

    def _window(self) -> Tuple[float, float]:
        """The window in the trace's µs."""
        start = self.prof.profiler.kineto_results.trace_start_ns()
        return ((self._ns[0] - start) / 1e3, (self._ns[1] - start) / 1e3)

    def _spans(self) -> List[Tuple[float, float, str]]:
        from torch.autograd import DeviceType

        w0, w1 = self._window()
        spans = []
        for e in self.prof.events():
            if (e.device_type != DeviceType.CUDA or getattr(e, "is_user_annotation", False)
                    or _PRIMING_KERNEL in e.name):
                continue
            s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
            if t > s:
                spans.append((s, t, e.name))
        if not spans:
            raise RuntimeError("no device activity in the traced window: the trace's clock "
                               "and the host's disagree, or the card ran nothing")
        return spans

    def summary(self) -> Dict:
        """busy_s, window_s, {family: device s}, the longest device
        operations (``breakdown``) and the kernels' work."""
        w0, w1 = self._window()
        spans, by_name = self._spans(), {}
        for s, t, name in spans:
            by_name[name] = by_name.get(name, 0.0) + (t - s) / 1e6
        fams: Dict[str, float] = {}
        for name, sec in by_name.items():
            fams[family(name)] = fams.get(family(name), 0.0) + sec
        return {"busy_s": _union([(s, t) for s, t, _ in spans]) / 1e6,
                "window_s": (w1 - w0) / 1e6, "families_s": fams,
                "device_ops": sorted(([n, s] for n, s in by_name.items()),
                                     key=lambda x: -x[1])[:10],
                "kernel_work": dict(self.kernel_work.work) if self.kernel_work else {}}

    def idle_gaps(self) -> List[list]:
        """The card's idle gaps in the window (no activity running), named by
        the innermost host operation running at each gap's middle ("host,
        no operation" where none is), summed by name; the 10 longest."""
        from torch.autograd import DeviceType

        w0, w1 = self._window()
        host = sorted((e.time_range.start, e.time_range.end, e.name) for e in self.prof.events()
                      if e.device_type == DeviceType.CPU and w0 <= e.time_range.start <= w1)
        gaps, reach = [], w0
        for s, t, _ in sorted(self._spans()):
            if s > reach:
                gaps.append((reach, s))
            reach = max(reach, t)
        if w1 > reach:
            gaps.append((reach, w1))
        named: Dict[str, float] = {}
        active: list = []
        i = 0
        for a, b in sorted(gaps, key=lambda g: g[0] + g[1]):
            mid = (a + b) / 2
            while i < len(host) and host[i][0] <= mid:
                active.append(host[i])
                i += 1
            active = [h for h in active if h[1] >= mid]
            name = max(active)[2] if active else "host, no operation"  # latest start: innermost
            named[name] = named.get(name, 0.0) + (b - a) / 1e6
        return sorted(([n, s] for n, s in named.items()), key=lambda x: -x[1])[:10]


def traced_calls(call: Callable[[], object], n: int) -> Tuple[Dict, int, float]:
    """``n`` calls under a trace of the card alone (the metrics), then half
    as many under one of the host too (the idle gaps' names). Returns (the
    summary with its ``idle_gaps``, the calls made, the host seconds taken)."""
    t = time.perf_counter()
    with Traced() as dev:
        for _ in range(n):
            call()
    with Traced(work=False, host=True) as host:
        for _ in range(max(1, n // 2)):
            call()
    out = dev.summary()
    out["idle_gaps"] = host.idle_gaps()
    return out, n + max(1, n // 2), time.perf_counter() - t

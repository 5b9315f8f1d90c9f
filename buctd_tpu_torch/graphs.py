"""One CUDA graph per serving bucket: on the card, the counterpart of the XLA
program that buctd_tpu/serving.py compiles for each bucket shape.

``BucketGraphs(device)`` captures ``fn(*inputs)`` once per key, where a key
names one set of input shapes (serving.py's (h, w, p) and (n, h, w, p)
buckets) and ``fn`` is the key's function: ``refine`` for every key of a
PoseEstimator, one loaded program a key for an ExportedPoseEstimator
(serving_export.py).  ``capture`` runs ``fn`` eagerly WARMUP times on a side
stream first (that builds a hand kernel with nvcc at its first launch, sets
its shared-memory attribute, sets up cuDNN and cuBLAS), then records one
call into a ``torch.cuda.CUDAGraph`` reading static device copies of the
inputs.  ``run``
copies the host inputs into those buffers, replays the graph and copies the
outputs to the host at once.  Capture and replay run on the pool's own
device and stream, whatever device is current: a ``mesh=`` estimator
(serving.py) keeps one ``BucketGraphs`` a card.

All graphs of one ``BucketGraphs`` share one memory pool
(``torch.cuda.graph_pool_handle()``).  That is safe because they never run
at once: every replay holds the lock, and its outputs are on the host before
the lock is let go.  A capture that fails raises; nothing falls back to the
eager function.

A hand kernel's wrapper counts its launches in its ``launches`` (K1's and
K1''s also by kernel, in ``wgmma_launches`` and ``mma_launches`` for bf16,
``f32_wgmma_launches`` and ``f32_mma_launches`` for f32).  The
capture records launches and runs none, so ``capture`` takes back what the
counters moved during it and ``run`` adds that amount at each replay: the
counters count the kernels that ran on the card, eager or replayed.
"""

from __future__ import annotations

import importlib
import threading

import torch

WARMUP = 2
# the modules of the hand kernels' wrappers, whose ``launches`` a graph moves
_KERNEL_MODULES = ("flash_attention", "fused_block", "warp", "exp_throughput")


def _counted() -> list:
    """Every launch count of the hand kernels' wrappers (functions with a
    ``launches`` count): (wrapper, attribute) for ``launches`` and each other
    int attribute whose name ends in ``_launches``."""
    mods = [importlib.import_module(f"{__package__}.ops.{m}") for m in _KERNEL_MODULES]
    return [(f, name) for m in mods for f in vars(m).values()
            if callable(f) and isinstance(getattr(f, "launches", None), int)
            for name, value in vars(f).items()
            if (name == "launches" or name.endswith("_launches")) and isinstance(value, int)]


class BucketGraphs:
    """Per-key CUDA graphs on ``device`` (a CUDA device)."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type != "cuda":
            raise ValueError(f"BucketGraphs captures CUDA graphs, not on {self.device}")
        if self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        with torch.cuda.device(self.device):
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        # key -> (graph, static inputs, static outputs,
        #         {(wrapper, count attribute): launches a replay})
        self._graphs: dict = {}
        self._lock = threading.Lock()

    def keys(self) -> list:
        return list(self._graphs)

    def capture(self, key, fn, *inputs) -> None:
        """Capture ``fn(*inputs)`` under ``key``, at the shapes and dtypes of
        ``inputs`` (host arrays or tensors, also the warm-up's values); a key
        already captured is left as it is, and ``fn`` is not kept."""
        with self._lock, torch.cuda.device(self.device):
            if key in self._graphs:
                return
            static = [torch.as_tensor(x).to(self.device) for x in inputs]
            current = torch.cuda.current_stream(self.device)
            self.stream.wait_stream(current)
            with torch.cuda.stream(self.stream):
                for _ in range(WARMUP):
                    fn(*static)
            graph = torch.cuda.CUDAGraph()
            counted = _counted()
            before = [getattr(f, a) for f, a in counted]
            with torch.cuda.graph(graph, pool=self.pool, stream=self.stream):
                outputs = fn(*static)
            current.wait_stream(self.stream)
            launched = {(f, a): getattr(f, a) - n for (f, a), n in zip(counted, before)
                        if getattr(f, a) != n}
            for (f, a), n in launched.items():   # recorded, not run: they count at the replays
                setattr(f, a, getattr(f, a) - n)
            self._graphs[key] = (graph, static, outputs, launched)

    def run(self, key, *inputs) -> list:
        """Replay ``key``'s graph on ``inputs`` (the captured shapes and
        dtypes) on the pool's stream; returns its outputs copied to the
        host (CPU tensors)."""
        with self._lock, torch.cuda.device(self.device), torch.cuda.stream(self.stream):
            graph, static, outputs, launched = self._graphs[key]
            for buf, x in zip(static, inputs):
                x = torch.as_tensor(x)
                if x.shape != buf.shape or x.dtype != buf.dtype:
                    raise ValueError(f"graph {key} was captured for {buf.dtype} "
                                     f"{tuple(buf.shape)}, got {x.dtype} {tuple(x.shape)}")
                buf.copy_(x)
            graph.replay()
            for (f, a), n in launched.items():
                setattr(f, a, getattr(f, a) + n)
            return [t.cpu() for t in outputs]

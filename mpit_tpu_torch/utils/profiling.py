"""Profiler traces and the completion barrier for timed regions.

Counterpart of ``mpit_tpu/utils/profiling.py``. :func:`trace` wraps a
training loop in ``torch.profiler`` where the reference wraps it in
``jax.profiler.trace``: host operators always, and the card's kernels and
copies when the work runs on the card. The trace is a Chrome trace
(``*.pt.trace.json``, TensorBoard's profiler plugin and Perfetto read it)
written into ``log_dir`` when the block ends. :func:`annotate` names a
region on the host timeline.

PyTorch returns from a CUDA call before the card has finished it, so a
host clock read without a barrier times the enqueue. :func:`force_completion`
is ``torch.cuda.synchronize()`` plus one host fetch of a scalar that
depends on the outputs, which proves the work ran and not only that it
was queued. :class:`StepTimer` times steps on the host clock around it.
"""

from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional, Union

import torch

from mpit_tpu_torch.utils.params import tree_leaves


@contextlib.contextmanager
def trace(log_dir: Optional[str],
          device: Union[str, torch.device, None] = None) -> Iterator[None]:
    """Capture a ``torch.profiler`` trace of the block into ``log_dir``
    (a no-op when it is None or empty, so call sites can wrap their loop
    unconditionally). ``device`` is where the work runs: the card's
    activity is recorded for a CUDA device, or, when ``device`` is None,
    whenever CUDA is available."""
    if not log_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    on_card = (torch.device(device).type == "cuda" if device is not None
               else torch.cuda.is_available())
    activities = [ProfilerActivity.CPU]
    if on_card:
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
        if on_card:
            torch.cuda.synchronize()


def annotate(name: str):
    """Named region on the host trace timeline (wrap a step or a phase)."""
    return torch.profiler.record_function(name)


def force_completion(*results) -> float:  # mpit-analysis: host-sync-barrier
    """Proof of execution of every argument; returns the fetched scalar.

    For EACH positional argument the smallest floating-point leaf is
    summed; the per-argument sums are added into one scalar and fetched
    once. Pass a step's state and its metrics as separate arguments, so
    each gets its own proof leaf. Non-tensor and non-floating leaves are
    skipped."""
    total = None
    cuda = False
    for result in results:
        leaves = [
            leaf
            for leaf in tree_leaves(result)
            if isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
        ]
        if not leaves:
            continue
        small = min(leaves, key=lambda leaf: leaf.numel())
        cuda = cuda or small.is_cuda
        term = small.sum(dtype=torch.float32)
        total = term if total is None else total + term
    if cuda:
        torch.cuda.synchronize()
    return float(total) if total is not None else 0.0


class StepTimer:
    """Wall-clock timer for step loops.

    Measures *completed* work: ``stop(result)`` runs
    :func:`force_completion` on the step's output (a CUDA synchronise and
    a fetch) before it reads the clock; without it the queued work looks
    free. ``skip_first`` steps (set-up, allocator warm-up) are not kept."""

    def __init__(self, skip_first: int = 1):
        self.skip_first = skip_first
        self._times: list[float] = []
        self._seen = 0
        self._t0: Optional[float] = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self, result=None) -> float:
        """Prove ``result`` (if given) complete, then record the elapsed
        time; returns the step's wall seconds. A tuple result (a step's
        ``(state, metrics)``) is spread so each part gets its own proof."""
        if result is not None:
            if isinstance(result, tuple):
                force_completion(*result)
            else:
                force_completion(result)
        if self._t0 is None:
            raise RuntimeError("StepTimer.stop() without start()")
        dt = time.perf_counter() - self._t0
        self._t0 = None
        self._seen += 1
        if self._seen > self.skip_first:
            self._times.append(dt)
        return dt

    @property
    def mean(self) -> float:
        return sum(self._times) / len(self._times) if self._times else float("nan")

    @property
    def count(self) -> int:
        return len(self._times)

    def summary(self) -> dict:
        if not self._times:
            return {"steps": 0}
        ts = sorted(self._times)
        return {
            "steps": len(ts),
            "mean_s": self.mean,
            "p50_s": ts[len(ts) // 2],
            "max_s": ts[-1],
        }

"""Tracing and step telemetry.

Counterpart of ``vub_image_denoising_tpu/utils/profiling.py`` (SURVEY.md §5
"tracing/profiling").  The reference's profiling is wall-clock time around
a CUDA sync (evaluate_Unet_diffusion/evaluate_model.py:126-143,
evaluate_SIDD.py:55-57, info.py).

- ``force_completion``: wait for the device and fetch one element of a
  tree's first tensor; a CUDA call returns before the card finishes, so a
  host clock must stop after this.
- ``trace``: a ``torch.profiler`` region written as a TensorBoard trace.
- ``StepTimer``: per-step wall time and throughput in megapixels/s, with a
  moving average; call ``tick`` once per step.
"""

import contextlib
import time
from collections import deque
from typing import Optional

import torch


def first_tensor(tree):
    """The first tensor of a tree of tensors, tuples, lists and dicts (dicts
    in sorted key order), or None."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for leaf in tree:
            found = first_tensor(leaf)
            if found is not None:
                return found
    return None


def force_completion(tree):
    """Wait for the work behind ``tree``'s first tensor and fetch one element."""
    leaf = first_tensor(tree)
    if leaf is None:
        return tree
    if leaf.device.type == "cuda":
        torch.cuda.synchronize(leaf.device)
    return leaf.reshape(-1)[0].item() if leaf.numel() else None


@contextlib.contextmanager
def trace(log_dir: str = "runs/profile"):
    """Profile a region: ``with trace('runs/profile'): step(...)``.  Traces
    the host and, where there is a card, the device; the trace is written
    to ``log_dir`` for TensorBoard's profiler plugin."""
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


class StepTimer:
    """Per-step telemetry with MP/s accounting."""

    def __init__(self, pixels_per_step: float, window: int = 50, writer=None,
                 tag: str = "throughput/mp_per_s"):
        self.pixels_per_step = pixels_per_step
        self.times = deque(maxlen=window)
        self.writer = writer
        self.tag = tag
        self._t0: Optional[float] = None
        self.steps = 0

    def start(self):
        self._t0 = time.perf_counter()

    def tick(self, result=None):
        """Call after each step (optionally passing the step output to force)."""
        if result is not None:
            force_completion(result)
        now = time.perf_counter()
        if self._t0 is not None:
            self.times.append(now - self._t0)
            self.steps += 1
            if self.writer is not None:
                self.writer.add_scalar(self.tag, self.mp_per_s, self.steps)
        self._t0 = now

    @property
    def avg_step_sec(self) -> float:
        return sum(self.times) / len(self.times) if self.times else float("nan")

    @property
    def mp_per_s(self) -> float:
        s = self.avg_step_sec
        return self.pixels_per_step / s / 1e6 if s and s > 0 else float("nan")

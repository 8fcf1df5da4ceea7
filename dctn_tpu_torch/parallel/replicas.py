"""Single-process data parallelism for serving: one replica of a model on
each of N devices, a batch split over them and the outputs gathered.

``predict --mesh-devices N`` and sharded artifacts (``cli/export.py``) run
here, without a process group: the host launches each replica's kernels on
its own card in turn (the wrappers enter the tensor's device, so a call on
``cuda:1`` launches there whatever the current device is), the cards work
at once, and the logits come back to the input's device in batch order.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch


def replica_devices(n: int, device_type: str) -> List[torch.device]:
    """``cuda:0`` … ``cuda:n-1``, refused when fewer cards are visible; or
    n CPU replicas."""
    if n < 1:
        raise ValueError(f"{n} replicas")
    if device_type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if n > visible:
            raise ValueError(f"{n} replicas need {n} CUDA cards; {visible} visible")
        return [torch.device("cuda", i) for i in range(n)]
    if device_type != "cpu":
        raise ValueError(f"replicas run on cuda or cpu, not {device_type}")
    return [torch.device("cpu")] * n


class ShardedForward:
    """``forward(x)``: ``x`` split along ``batch_axis`` into one chunk per
    replica (``torch.tensor_split``: sizes differ by at most one, empty
    chunks skipped), chunk i moved to ``devices[i]`` and run by
    ``replicas[i]``; every replica is launched before any output is
    gathered, then the outputs are concatenated on ``x``'s device."""

    def __init__(self, replicas: Sequence[Callable], devices: Sequence[torch.device],
                 batch_axis: int):
        if len(replicas) != len(devices):
            raise ValueError(f"{len(replicas)} replicas on {len(devices)} devices")
        self.replicas = list(replicas)
        self.devices = list(devices)
        self.batch_axis = batch_axis

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        chunks = torch.tensor_split(x, len(self.replicas), dim=self.batch_axis)
        outs = [fn(c.to(dev, non_blocking=True))
                for fn, dev, c in zip(self.replicas, self.devices, chunks)
                if c.shape[self.batch_axis]]
        return torch.cat([o.to(x.device) for o in outs])

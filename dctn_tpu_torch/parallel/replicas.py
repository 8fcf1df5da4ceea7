"""Single-process parallelism for serving: one replica of a program on
each of N devices, a batch split over them by images (``ShardedForward``)
or each image by bands of rows (``RowShardedForward``), the outputs
gathered.

``predict --mesh-devices N`` and sharded artifacts (``cli/export.py``) run
here, without a process group: the host launches each replica's kernels on
its own card in turn (the wrappers enter the tensor's device, so a call on
``cuda:1`` launches there whatever the current device is), the cards work
at once, and the logits come back to the input's device.
"""

from __future__ import annotations

from typing import Callable, List, Sequence

import torch
import torch.nn.functional as F


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


class RowShardedForward:
    """The height-sharded artifact's serving (JAX's
    ``export_space_sharded_forward`` and the ``shard_map`` that loads it,
    export.py:130-215, :266-293), without a process group: ``forward(x)``,
    ``x`` (C, B, H, W, Q) with H = S·``rows``, on any device. Card s takes
    the overlapped slab of rows [s·rows, s·rows + rows + ``halo``), ``halo``
    being Σ(K_i − 1) over the EPS layers, the image zero-padded past its
    bottom, and its replica runs every layer on it with no exchange (the
    slab holds every row its ``rows`` output rows see) and contracts them
    with ``weights[s]``, its zero-padded h-slice of the classifier
    (rows·W'·O, classes), into partial logits. Every card is launched
    before any output is gathered; the partial logits are summed on ``x``'s
    device in card order and ``bias`` is added once. Where JAX exchanges
    each layer's K − 1 halo rows between neighbours, each card here
    computes the rows below its band that the later layers need: layer 0
    runs Σ_{i≥1}(K_i − 1) more rows than a training slab. A bf16 artifact's
    slab programs round their cores inside the graph, as one card's do."""

    def __init__(self, replicas: Sequence[Callable], devices: Sequence[torch.device], weights,
                 bias: torch.Tensor, rows: int, halo: int):
        if not len(replicas) == len(devices) == len(weights):
            raise ValueError(f"{len(replicas)} replicas on {len(devices)} devices with "
                             f"{len(weights)} classifier slices")
        self.replicas = list(replicas)
        self.devices = list(devices)
        self.weights = [w.to(d) for w, d in zip(weights, devices)]
        self.bias = bias
        self.rows, self.halo = rows, halo

    def slabs(self, x: torch.Tensor) -> list:
        """Each card's slab of ``x``'s rows, on ``x``'s device."""
        n = len(self.replicas)
        if x.shape[2] != n * self.rows:
            raise ValueError(f"an input of {x.shape[2]} rows; this artifact takes "
                             f"{n} x {self.rows}")
        xp = F.pad(x, (0, 0, 0, 0, 0, self.halo))
        return [xp[:, :, s * self.rows : (s + 1) * self.rows + self.halo].contiguous()
                for s in range(n)]

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        outs = [fn(slab.to(dev, non_blocking=True), w) for fn, dev, w, slab in
                zip(self.replicas, self.devices, self.weights, self.slabs(x))]
        total = outs[0].to(x.device)
        for o in outs[1:]:
            total = total + o.to(x.device)
        return total + self.bias.to(x.device)

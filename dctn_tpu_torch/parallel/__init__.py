"""Multi-GPU data parallelism (port of ``dctn_tpu/parallel``'s data-parallel
half; tensor and spatial parallelism are ROADMAP item 19b).

Process model: one rank per card. ``--mesh-devices N`` on one host starts
N rank processes (``mesh.spawn``, the ``spawn`` start method); rank r sets
``cuda:r`` as its current device before it makes any tensor and joins one
process group, ``nccl`` on the cards or ``gloo`` with ``--device cpu``.
``--distributed HOST:PORT,NPROC,PID`` makes the job span NPROC host
processes, each starting its N / NPROC local ranks (global rank
PID·(N / NPROC) + local rank), and ``--distributed auto`` takes torchrun's
ranks. Parameters and optimizer state are replicated, the data sharded;
each step's gradients are averaged in one all-reduce (``data_parallel``).
Local rank 0 of each host writes the run's logs; global rank 0 also writes
its checkpoints, train states and artifacts. A job that asks for more
ranks than a host has visible cards is refused before it starts; nothing
falls back to fewer cards, to ``gloo`` on a card or to the CPU.
"""

from .data_parallel import (
    GradAllReduce,
    ShardedSplit,
    make_local_index_stream,
    make_parallel_fast_train_step,
    make_parallel_pixel_score_fn,
    make_parallel_pixel_train_step,
    make_parallel_predict_fn,
    make_parallel_score_fn,
    make_parallel_train_step,
    replicate,
    shard_pixel_split,
    shard_split,
)
from .mesh import (
    DataMesh,
    data_axis_size,
    initialize_distributed,
    make_mesh,
    plan_job,
    spawn,
)

"""Multi-GPU data, tensor and spatial parallelism and their composition
(port of ``dctn_tpu/parallel``).

Process model: one rank per card. ``--mesh-devices N`` on one host starts
N rank processes (``mesh.spawn``, the ``spawn`` start method); rank r sets
``cuda:r`` as its current device before it makes any tensor and joins one
process group, ``nccl`` on the cards or ``gloo`` with ``--device cpu``.
``--distributed HOST:PORT,NPROC,PID`` makes the job span NPROC host
processes, each starting its N / NPROC local ranks (global rank
PID·(N / NPROC) + local rank), and ``--distributed auto`` takes torchrun's
ranks. Data parallelism (``data_parallel``): parameters and optimizer
state replicated, the data sharded, each step's gradients averaged in one
all-reduce. ``--space-devices S`` and ``--model-devices M`` put the ranks
on a ``(data, space, model)`` grid (``mesh.GridMesh``), N·S·M ranks:
tensor parallelism (``tensor_parallel``) with S = 1, spatial parallelism
(``spatial_parallel``) with M = 1, SP×TP (``sp_tp``) with both over 1, each
with the collectives of ``collectives`` on its named axes. Local rank 0 of
each host writes the run's logs; global rank 0 also writes its
checkpoints, train states and artifacts. A job that asks for more ranks
than a host has visible cards is refused before it starts; nothing falls
back to fewer cards, to ``gloo`` on a card or to the CPU. Serving needs no
process group: ``replicas`` runs a replica of a program on each card from
one process, by batch shares (``ShardedForward``) or by rows of the image
(``RowShardedForward``, the height-sharded artifact).
"""

from .collectives import GridGradReduce, gather_along, psum_value_only, with_halo
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
    GridMesh,
    data_axis_size,
    initialize_distributed,
    make_grid,
    make_mesh,
    make_sp_tp_grid,
    plan_job,
    spawn,
)
from .sp_tp import (
    make_sp_tp_fast_train_step,
    make_sp_tp_forward,
    make_sp_tp_score_fn,
    make_sp_tp_train_step,
    sp_tp_check_config,
    sp_tp_fast_forward,
    sp_tp_forward,
    sp_tp_shard_batch,
)
from .spatial_parallel import (
    make_sp_fast_train_step,
    make_sp_forward,
    make_sp_score_fn,
    make_sp_train_step,
    pad_rows,
    sp_check_config,
    sp_fast_forward,
    sp_forward,
    sp_local_rows,
    sp_row_block,
    sp_shard_batch,
    sp_shard_split,
)
from .tensor_parallel import (
    TPFastModel,
    TPModel,
    check_model_axis,
    load_tp_train_state,
    make_tp_fast_forward,
    make_tp_fast_params,
    make_tp_fast_score_fn,
    make_tp_fast_train_step,
    make_tp_forward,
    make_tp_params,
    make_tp_score_fn,
    make_tp_train_step,
    merge_tp_fast_params,
    merge_tp_params,
    tp_fast_forward,
    tp_forward,
    tp_reference_params,
    tp_train_state_arrays,
)

"""The data mesh, the rank grid, and the processes behind them (port of
``dctn_tpu/parallel/mesh.py`` and of ``make_tp_mesh``, ``make_sp_mesh``
and ``make_sp_tp_mesh``): one rank per card, joined in one
``torch.distributed`` process group.

JAX runs one controller over every device of a host and spans hosts with
``jax.distributed``. Here each rank is a process of its own that holds one
card (``nccl``) or, with ``--device cpu``, one CPU replica (``gloo``), and
the CLIs start the ranks themselves:

- ``--mesh-devices N`` on one host: ``spawn`` starts N ranks
  (``multiprocessing``'s ``spawn`` method); rank r sets ``cuda:r`` as its
  current device before it makes a tensor, and the ranks meet through a
  ``FileStore`` in a temporary directory (no TCP port to collide on).
- ``--distributed HOST:PORT,NPROC,PID`` (``initialize_distributed``): each
  of the NPROC host processes starts N / NPROC local ranks, whose global
  rank is PID·(N / NPROC) + local rank, and they meet at ``tcp://HOST:PORT``
  (global rank 0 serves the store there). ``--mesh-devices`` counts ranks
  across the whole job, as in JAX.
- ``--distributed auto``: torchrun started the ranks; each reads its place
  from torchrun's environment and meets the others through ``env://``.

A job asking for more ranks on a host than it has visible cards is refused
before anything starts. Nothing falls back to fewer cards, to ``gloo`` on a
card or to the CPU.

Tensor and spatial parallelism and their composition run on a 3-D grid of
ranks, ``(data, space, model)`` (``GridMesh``): rank = (d·n_space + s)·n_model
+ m, the order of JAX's ``devices.reshape(n_data, n_space, n_model)``, so
that each model line, then each space line, lies on neighbouring cards. TP
is the grid with a space axis of one rank, SP the grid with a model axis of
one. Every rank creates every group (``dist.new_group``, the same groups in
the same order on every rank), then runs one collective in each group it
belongs to, so that a group's first call is never a point-to-point batch
(NCCL needs every rank of the group in such a first call).
"""

from __future__ import annotations

import dataclasses
import datetime
import math
import os
import pickle
import shutil
import signal
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Optional

import torch
import torch.distributed as dist

# how long a rank waits for the others at a collective, and the spawner for
# the other ranks after one has failed, before giving up on them
COLLECTIVE_TIMEOUT = datetime.timedelta(minutes=30)
KILL_GRACE_S = 5.0

_RESULT = "result.pkl"
_ERROR = "error-rank{}.txt"


@dataclasses.dataclass(frozen=True)
class Host:
    """Where this host process stands in a job: ``nodes`` host processes,
    this one ``node``; the ranks meet at ``init_method``. ``torchrun``:
    the process is itself a rank that torchrun started."""

    init_method: Optional[str] = None
    nodes: int = 1
    node: int = 0
    torchrun: bool = False


@dataclasses.dataclass(frozen=True)
class Job:
    """The ranks a host process runs: ``world_size`` in all, ``local_ranks``
    of them here, on ``device_type`` cards (or CPU replicas), each with
    ``threads`` CPU threads; a rank waits ``timeout`` at a collective before
    its group fails."""

    world_size: int
    local_ranks: int
    host: Host
    device_type: str
    threads: int = 1
    timeout: datetime.timedelta = COLLECTIVE_TIMEOUT
    # (n_data, n_space, n_model) of a grid (``GridMesh``), or None: data only
    grid: Optional[tuple] = None

    @property
    def backend(self) -> str:
        return "nccl" if self.device_type == "cuda" else "gloo"


@dataclasses.dataclass
class DataMesh:
    """One rank's view of the 1-D ``data`` mesh: ``world_size`` ranks, this
    one ``rank`` (``local_rank`` on its host, ``node`` the host process),
    holding ``device``. The collectives run over the default process group.
    ``writes_logs``: local rank 0 of each host keeps the run's logs;
    ``is_primary``: global rank 0 also writes checkpoints and artifacts."""

    world_size: int
    rank: int
    local_rank: int
    node: int
    device: torch.device
    backend: str

    @property
    def is_primary(self) -> bool:
        return self.rank == 0

    @property
    def writes_logs(self) -> bool:
        return self.local_rank == 0

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(t, op=op)
        return t

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (equal shapes) concatenated on dim 0 in rank
        order: the device-major layout of JAX's ``P("data")`` outputs."""
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous())
        return torch.cat(parts)

    def any(self, flag: bool) -> bool:
        """Whether ``flag`` is true on any rank (every rank must call)."""
        t = torch.tensor([1.0 if flag else 0.0], device=self.device)
        return bool(self.all_reduce_(t, dist.ReduceOp.MAX).item())

    def all_gather_object(self, obj: Any) -> list:
        """Every rank's ``obj``, in rank order."""
        out = [None] * self.world_size
        dist.all_gather_object(out, obj)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        """Rank 0's ``obj`` on every rank."""
        box = [obj]
        dist.broadcast_object_list(box, src=0)
        return box[0]

    def barrier(self) -> None:
        dist.barrier()

    # the data axis: the whole world on a 1-D mesh (``GridMesh`` overrides)

    @property
    def data_size(self) -> int:
        return self.world_size

    @property
    def data_index(self) -> int:
        return self.rank

    def reduce_data_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced in place over the ranks of this rank's data group."""
        return self.all_reduce_(t, op)

    def gather_data(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` of this rank's data group, concatenated on dim
        0 in data order."""
        return self.all_gather_cat(t)


# the axes of a grid, in rank order: rank = (d·n_space + s)·n_model + m
GRID_AXES = ("data", "space", "model")


def _axes(axis) -> tuple:
    """An axis name or a tuple of them, as a tuple in grid order."""
    names = (axis,) if isinstance(axis, str) else tuple(axis)
    bad = [a for a in names if a not in GRID_AXES]
    if bad or len(set(names)) != len(names):
        raise ValueError(f"a grid's axes are {GRID_AXES}, not {axis!r}")
    return tuple(a for a in GRID_AXES if a in names)


@dataclasses.dataclass
class GridMesh(DataMesh):
    """One rank's view of the 3-D ``(data, space, model)`` grid
    (``make_sp_tp_mesh``, sp_tp.py:78-87): ``dims`` = (n_data, n_space,
    n_model) ranks, rank = (d·n_space + s)·n_model + m, the order of JAX's
    ``devices.reshape(n_data, n_space, n_model)``. Tensor parallelism is the
    grid with a space axis of one rank, spatial parallelism the grid with a
    model axis of one, SP×TP both over one.

    The accessors take an axis by name (``size``, ``group`` and ``live``
    also a tuple of names, for the ranks that share this rank's other
    coordinates): ``size("space")``, ``index("model")``, ``group(("space",
    "model"))`` (the plane of this rank's data coordinate) and
    ``peer("space", j)``, the global rank at coordinate j of this rank's
    space line. An axis of one rank has no
    group (``group`` is None) and its collectives do nothing. ``groups``
    holds this rank's group of each axis and of the plane, or None where
    the axes span one rank. The collectives of ``DataMesh``
    (``all_gather_object``, ``any``, ``barrier``, …) run over the grid's
    ranks: ``grid_group``, or the default group when the grid fills the
    world."""

    dims: tuple = (1, 1, 1)
    groups: Any = None
    grid_group: Any = None

    def all_reduce_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        dist.all_reduce(t, op=op, group=self.grid_group)
        return t

    def all_gather_cat(self, t: torch.Tensor) -> torch.Tensor:
        parts = [torch.empty_like(t) for _ in range(self.world_size)]
        dist.all_gather(parts, t.contiguous(), group=self.grid_group)
        return torch.cat(parts)

    def all_gather_object(self, obj: Any) -> list:
        out = [None] * self.world_size
        dist.all_gather_object(out, obj, group=self.grid_group)
        return out

    def broadcast_object(self, obj: Any) -> Any:
        box = [obj]
        dist.broadcast_object_list(box, src=0, group=self.grid_group)
        return box[0]

    def barrier(self) -> None:
        dist.barrier(group=self.grid_group)

    # the axes by name

    @property
    def coords(self) -> tuple:
        """This rank's (d, s, m)."""
        _, n_space, n_model = self.dims
        return (self.rank // (n_space * n_model), self.rank // n_model % n_space,
                self.rank % n_model)

    def size(self, axis) -> int:
        """The ranks along ``axis`` (a name, or a tuple: their product)."""
        return math.prod(self.dims[GRID_AXES.index(a)] for a in _axes(axis))

    def index(self, axis: str) -> int:
        """This rank's coordinate along ``axis``."""
        return self.coords[GRID_AXES.index(_axes(axis)[0])]

    def peer(self, axis: str, j: int) -> int:
        """The global rank at coordinate ``j`` of this rank's ``axis`` line."""
        c = list(self.coords)
        c[GRID_AXES.index(_axes(axis)[0])] = j
        return (c[0] * self.dims[1] + c[1]) * self.dims[2] + c[2]

    def live(self, axis) -> tuple:
        """The axes of ``axis`` that span more than one rank."""
        return tuple(a for a in _axes(axis) if self.size(a) > 1)

    def group(self, axis):
        """This rank's group of ``axis`` (None where it spans one rank)."""
        live = self.live(axis)
        return self.groups.get(live) if live else None

    def reduce_(self, t: torch.Tensor, axis, op=dist.ReduceOp.SUM) -> torch.Tensor:
        """``t`` reduced in place over this rank's ``axis`` group."""
        if self.live(axis):
            dist.all_reduce(t, op=op, group=self.group(axis))
        return t

    def gather_cat(self, t: torch.Tensor, axis: str, dim: int = 0) -> torch.Tensor:
        """This rank's ``axis`` group's ``t`` (equal shapes) concatenated on
        ``dim`` in coordinate order."""
        n = self.size(axis)
        if n == 1:
            return t
        parts = [torch.empty_like(t) for _ in range(n)]
        dist.all_gather(parts, t.contiguous(), group=self.group(axis))
        return torch.cat(parts, dim=dim)

    @property
    def n_data(self) -> int:
        return self.dims[0]

    @property
    def data_size(self) -> int:
        return self.n_data

    @property
    def data_index(self) -> int:
        return self.coords[0]

    def reduce_data_(self, t: torch.Tensor, op=dist.ReduceOp.SUM) -> torch.Tensor:
        return self.reduce_(t, "data", op)

    def gather_data(self, t: torch.Tensor) -> torch.Tensor:
        return self.gather_cat(t, "data")


def make_sp_tp_grid(mesh: DataMesh, n_data: int, n_space: int, n_model: int
                    ) -> Optional[GridMesh]:
    """The calling rank's ``GridMesh`` (``make_sp_tp_mesh``) over the first
    n_data·n_space·n_model ranks of the world of ``mesh`` (a job's grid
    fills it; a smaller grid leaves the ranks past it out, and they get
    None). Every rank of the world must call it, in the same order as any
    other call that makes groups: it creates every group of every axis of
    more than one rank, line by line, and the (space, model) planes when
    both are, each on every rank in the same order; then each rank runs one
    collective in each group it belongs to, so that a group's first call is
    never a point-to-point batch (NCCL needs every rank of the group in
    such a first call)."""
    dims = (n_data, n_space, n_model)
    size = n_data * n_space * n_model
    if min(dims) < 1 or size > mesh.world_size:
        raise ValueError(f"a {dims} grid needs {size} ranks; the job has {mesh.world_size}")
    grid_group = dist.new_group(list(range(size))) if size < mesh.world_size else None

    def rank_of(c):
        return (c[0] * n_space + c[1]) * n_model + c[2]

    coords = [(d, s, m) for d in range(n_data) for s in range(n_space) for m in range(n_model)]
    mine = coords[mesh.rank] if mesh.rank < size else None
    groups = {}
    spans = [(0,), (1,), (2,)] + ([(1, 2)] if n_space > 1 and n_model > 1 else [])
    for ks in spans:
        if all(dims[k] == 1 for k in ks):
            continue

        def others(c):
            return tuple(c[k] for k in range(3) if k not in ks)

        # one group along ks for each value of the other coordinates
        for f in sorted({others(c) for c in coords}):
            g = dist.new_group([rank_of(c) for c in coords if others(c) == f])
            if mine is not None and others(mine) == f:
                groups[tuple(GRID_AXES[k] for k in ks)] = g
    if mine is None:
        return None
    grid = GridMesh(size, mesh.rank, mesh.local_rank, mesh.node, mesh.device, mesh.backend,
                    dims, groups, grid_group)
    for g in groups.values():
        dist.all_reduce(torch.zeros(1, device=mesh.device), group=g)
    return grid


def make_grid(mesh: DataMesh, axis: str, n_data: int, n_other: int) -> Optional[GridMesh]:
    """The 2-D grid ``(data, axis)``, ``axis`` being ``"model"`` (tensor
    parallelism) or ``"space"`` (spatial parallelism): ``make_sp_tp_grid``
    with the third axis of one rank, rank = d·n_other + j."""
    if axis not in ("model", "space"):
        raise ValueError(f"a grid's second axis is model or space, not {axis!r}")
    return make_sp_tp_grid(mesh, n_data, n_other if axis == "space" else 1,
                           n_other if axis == "model" else 1)


def make_mesh(n_devices: Optional[int] = None) -> DataMesh:
    """The calling rank's mesh over the process group it joined; with
    ``n_devices``, checked to span that many ranks."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh runs inside a rank: start the ranks with spawn()")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"requested a {n_devices}-rank mesh inside a {world}-rank job")
    local_rank = int(os.environ.get("LOCAL_RANK", "0"))
    backend = dist.get_backend()
    device = (torch.device("cuda", torch.cuda.current_device()) if backend == "nccl"
              else torch.device("cpu"))
    return DataMesh(world, dist.get_rank(), local_rank, int(os.environ.get("GROUP_RANK", "0")),
                    device, backend)


def data_axis_size(mesh: DataMesh) -> int:
    return mesh.data_size


def parse_distributed(spec) -> Host:
    """``--distributed``: ``auto`` or ``HOST:PORT,NPROC,PID``."""
    spec = str(spec).strip()
    if spec.lower() == "auto":
        return initialize_distributed()
    try:
        addr, nproc, pid = (s.strip() for s in spec.rsplit(",", 2))
        return initialize_distributed(addr, int(nproc), int(pid))
    except ValueError:
        raise ValueError("--distributed must be 'auto' or 'HOST:PORT,NPROC,PID'") from None


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None) -> Host:
    """This host process's place in a multi-host job. With no arguments,
    torchrun's environment (``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``, …)
    describes a process that is itself a rank."""
    if coordinator_address is None:
        missing = [k for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT")
                   if k not in os.environ]
        if missing:
            raise ValueError(f"--distributed auto reads torchrun's environment; {missing} unset")
        return Host("env://", int(os.environ.get("GROUP_WORLD_SIZE", "1")),
                    int(os.environ.get("GROUP_RANK", "0")), torchrun=True)
    if not (num_processes and num_processes >= 1 and 0 <= process_id < num_processes):
        raise ValueError(f"--distributed: process id {process_id} outside 0..{num_processes}")
    return Host(f"tcp://{coordinator_address}", num_processes, process_id)


def plan_job(mesh_devices: int, distributed, device_type: str, model_devices: int = 1,
             space_devices: int = 1) -> Optional[Job]:
    """The ranks ``--mesh-devices`` (the data axis), ``--space-devices``,
    ``--model-devices`` and ``--distributed`` ask of this host process:
    mesh_devices × space_devices × model_devices ranks in all, on a
    ``(data, space, model)`` grid when either of the last two is over 1; or
    None for the single-device path (one rank, no group). Too many ranks for
    the visible cards is refused here, before any rank starts."""
    if min(mesh_devices, model_devices, space_devices) < 1:
        raise ValueError("--mesh-devices, --model-devices and --space-devices count ranks: >= 1")
    grid = ((mesh_devices, space_devices, model_devices)
            if model_devices > 1 or space_devices > 1 else None)
    ranks = mesh_devices * model_devices * space_devices
    host = parse_distributed(distributed) if distributed else Host()
    if host.torchrun:
        world = int(os.environ["WORLD_SIZE"])
        if ranks not in (1, world) or (grid is not None and ranks != world):
            raise ValueError(f"{ranks} ranks asked: torchrun started {world}")
        local = 1
    else:
        world = ranks
        if world <= 1 and host.nodes == 1:
            return None
        if world % host.nodes:
            raise ValueError(
                f"--mesh-devices {world} counts ranks across the job: it must be a multiple of "
                f"the {host.nodes} host processes of --distributed"
            )
        local = world // host.nodes
    if device_type == "cuda":
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        need = int(os.environ["LOCAL_RANK"]) + 1 if host.torchrun else local
        if need > visible:
            raise ValueError(
                f"{local} rank(s) on this host need {need} CUDA card(s); {visible} visible"
            )
    elif device_type != "cpu":
        raise ValueError(f"ranks run on cuda or cpu, not {device_type}")
    threads = max(1, torch.get_num_threads() // local) if device_type == "cpu" else 1
    return Job(world, local, host, device_type, threads, grid=grid)


def _init_rank(job: Job, local_rank: int, store_dir: Optional[str]) -> DataMesh:
    """Joins this rank's process group and returns its mesh."""
    host = job.host
    if host.torchrun:
        rank, local_rank = int(os.environ["RANK"]), int(os.environ["LOCAL_RANK"])
        init_method = "env://"
    else:
        rank = host.node * job.local_ranks + local_rank
        init_method = host.init_method or f"file://{os.path.join(store_dir, 'store')}"
        # make_mesh reads these, as under torchrun
        os.environ["LOCAL_RANK"] = str(local_rank)
        os.environ["GROUP_RANK"] = str(host.node)
    if job.device_type == "cuda":
        torch.cuda.set_device(local_rank)  # before this rank makes any tensor
        device = torch.device("cuda", local_rank)
    else:
        torch.set_num_threads(job.threads)
        device = torch.device("cpu")
    dist.init_process_group(job.backend, init_method=init_method, world_size=job.world_size,
                            rank=rank, timeout=job.timeout)
    mesh = DataMesh(job.world_size, rank, local_rank, host.node, device, job.backend)
    return mesh if job.grid is None else make_sp_tp_grid(mesh, *job.grid)


def _rank_main(local_rank: int, fn: Callable, args: tuple, job: Job, run_dir: str) -> None:
    """A rank's body: join the group, run ``fn(mesh, *args)``, and on local
    rank 0 leave its result for the spawner. A failure leaves its traceback
    for the spawner (and on stderr) and ends the process at once with code
    1: destroying the group would wait for the other ranks, which may be
    blocked in a collective this rank will never join (the spawner kills
    them)."""
    try:
        mesh = _init_rank(job, local_rank, run_dir)
        if job.device_type == "cuda":
            _build_kernels_once(mesh)
        result = fn(mesh, *args)
        if mesh.local_rank == 0:
            with open(os.path.join(run_dir, _RESULT + ".tmp"), "wb") as f:
                pickle.dump(result, f)
            os.replace(os.path.join(run_dir, _RESULT + ".tmp"), os.path.join(run_dir, _RESULT))
    except BaseException:
        text = traceback.format_exc()
        with open(os.path.join(run_dir, _ERROR.format(local_rank)), "w") as f:
            f.write(text)
        sys.stderr.write(text)
        sys.stderr.flush()
        os._exit(1)
    dist.destroy_process_group()


def _spawned_rank(parent_pid: int, *args) -> None:
    """A rank that ``spawn`` started: on Linux it gets SIGKILL when the
    spawner ends (``PR_SET_PDEATHSIG``), so that no rank outlives a killed
    spawner and trains on alone; then ``_rank_main``."""
    if sys.platform.startswith("linux"):
        import ctypes

        ctypes.CDLL(None).prctl(1, signal.SIGKILL)  # 1: PR_SET_PDEATHSIG
        if os.getppid() != parent_pid:  # the spawner ended before the prctl
            os._exit(1)
    _rank_main(*args)


def _build_kernels_once(mesh: DataMesh) -> None:
    """Local rank 0 builds every kernel source (one nvcc each, at once)
    while the host's other ranks wait, so that N cold ranks do not start
    7·N compilers."""
    from ..kernels import build

    if mesh.local_rank == 0:
        build.build_all()
    mesh.barrier()


def spawn(fn: Callable, job: Job, *args) -> Any:
    """Runs ``fn(mesh, *args)`` on each of this host's ranks of ``job``
    (``fn`` importable, ``args`` picklable) and returns local rank 0's
    result. SIGTERM to this process is passed on to every rank (which
    decide together when to stop: ``train.preemption``). If a rank fails,
    the others are killed and its traceback is raised here. Under torchrun
    the process is itself the rank: ``fn`` runs here."""
    run_dir = tempfile.mkdtemp(prefix="dctn_ranks_")
    try:
        if job.host.torchrun:
            _rank_main(0, fn, args, job, run_dir)
            with open(os.path.join(run_dir, _RESULT), "rb") as f:
                return pickle.load(f)
        return _spawn_local(fn, args, job, run_dir)
    finally:
        shutil.rmtree(run_dir, ignore_errors=True)


def _spawn_local(fn: Callable, args: tuple, job: Job, run_dir: str) -> Any:
    import multiprocessing

    ctx = multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_spawned_rank, args=(os.getpid(), r, fn, args, job, run_dir),
                         daemon=False)
             for r in range(job.local_ranks)]

    def forward(signum, frame):
        for p in procs:
            if p.pid is not None and p.is_alive():
                os.kill(p.pid, signum)

    try:
        prev = signal.signal(signal.SIGTERM, forward)
    except ValueError:  # not the main thread: no signal to pass on
        prev = None
    try:
        for p in procs:
            p.start()
        failed = None
        while failed is None and any(p.is_alive() for p in procs):
            for r, p in enumerate(procs):
                if p.exitcode not in (None, 0) or os.path.exists(
                        os.path.join(run_dir, _ERROR.format(r))):
                    failed = r
                    break
            time.sleep(0.05)
        for r, p in enumerate(procs):
            if p.exitcode not in (None, 0) and failed is None:
                failed = r
        if failed is not None:
            deadline = time.monotonic() + KILL_GRACE_S
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
            path = os.path.join(run_dir, _ERROR.format(failed))
            detail = open(path).read() if os.path.exists(path) else (
                f"exit code {procs[failed].exitcode}")
            raise RuntimeError(f"rank {job.host.node * job.local_ranks + failed} of "
                               f"{job.world_size} failed:\n{detail}")
        for p in procs:
            p.join()
    finally:
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    with open(os.path.join(run_dir, _RESULT), "rb") as f:
        return pickle.load(f)

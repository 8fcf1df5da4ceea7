"""Grid-search sweep over the port's EPS runner (port of
``dctn_tpu/cli/sweep.py``; reference ``lr_gridsearch.py``): the cartesian
product of hyperparameters, shuffled, fanned out as N concurrent
``python -m dctn_tpu_torch.cli.runner`` subprocesses, one per worker slot; a
finished worker starts the next config at once, and a failed one is logged
and skipped.

The workers are the port's runner, so they run on the card by default
(``--device cuda``). ``run_sweep``'s ``worker_env`` gives each slot its own
environment, e.g. ``CUDA_VISIBLE_DEVICES`` to pin slot i to card i as the
reference does.

Config file: JSON {"base": {flag: value, ...}, "grid": {flag: [v1, v2], ...},
"shuffle_seed": 0}; flags are the runner's option names (with dashes).

Run: ``python -m dctn_tpu_torch.cli.sweep CONFIG.json --experiments-dir DIR -j 2``
"""

from __future__ import annotations

import itertools
import json
import logging
import os
import random
import subprocess
import sys
import time
from typing import Dict, List, Optional, Sequence, Tuple

import click

logger = logging.getLogger(__name__)

RUNNER = "dctn_tpu_torch.cli.runner"


def expand_grid(base: Dict, grid: Dict, shuffle_seed: Optional[int] = 0) -> List[Dict]:
    """Every combination of the grid's values over ``base``, grid keys in
    sorted order, shuffled with ``shuffle_seed`` (None: not shuffled)."""
    keys = sorted(grid)
    configs = []
    for values in itertools.product(*(grid[k] for k in keys)):
        cfg = dict(base)
        cfg.update(dict(zip(keys, values)))
        configs.append(cfg)
    if shuffle_seed is not None:
        random.Random(shuffle_seed).shuffle(configs)
    return configs


def config_to_argv(cfg: Dict) -> List[str]:
    """The runner's command line for one config: a bool as ``--flag`` or
    ``--no-flag``, a list as the flag and its values, anything else as the
    flag and its string."""
    argv = [sys.executable, "-m", RUNNER]
    for flag, value in cfg.items():
        name = f"--{flag.replace('_', '-')}"
        if isinstance(value, bool):
            argv.append(name if value else f"--no-{flag.replace('_', '-')}")
        elif isinstance(value, (list, tuple)):
            argv.append(name)
            argv.extend(str(v) for v in value)
        else:
            argv.extend([name, str(value)])
    return argv


def run_sweep(
    configs: Sequence[Dict],
    num_workers: int = 1,
    worker_env: Optional[Sequence[Dict[str, str]]] = None,
    poll_interval: float = 2.0,
) -> List[Tuple[Dict, int]]:
    """Keeps ``num_workers`` runner subprocesses alive until every config
    ran, slot i with ``worker_env[i % len(worker_env)]`` over the current
    environment. Returns (config, exit code) pairs; a nonzero exit is
    logged and the sweep goes on (lr_gridsearch.py:68-87)."""
    queue = list(configs)
    running: List[Tuple[subprocess.Popen, Dict, int]] = []
    results: List[Tuple[Dict, int]] = []
    worker_env = worker_env or [{}] * num_workers
    free_slots = list(range(num_workers))

    def launch(slot: int, cfg: Dict) -> None:
        env = dict(os.environ)
        env.update(worker_env[slot % len(worker_env)])
        argv = config_to_argv(cfg)
        logger.info("slot %d: launching %s", slot, " ".join(argv[2:]))
        running.append((subprocess.Popen(argv, env=env), cfg, slot))

    while queue or running:
        while queue and free_slots:
            launch(free_slots.pop(), queue.pop(0))
        time.sleep(poll_interval)
        still = []
        for proc, cfg, slot in running:
            code = proc.poll()
            if code is None:
                still.append((proc, cfg, slot))
            else:
                if code != 0:
                    logger.error("config %s exited with error %d!", cfg, code)
                results.append((cfg, code))
                free_slots.append(slot)
        running[:] = still
    return results


@click.command()
@click.argument("config_file", type=click.Path(exists=True, dir_okay=False))
@click.option("--experiments-dir", type=click.Path(file_okay=False), required=True)
@click.option("-j", "--num-workers", type=int, default=1)
@click.option("--config-stride", type=click.IntRange(min=1), default=1,
              help="run every STRIDE-th config (a fan-out over hosts: give each host the "
                   "same grid with its own offset)")
@click.option("--config-offset", type=click.IntRange(min=0), default=0)
def main(config_file: str, experiments_dir: str, num_workers: int, config_stride: int,
         config_offset: int) -> None:
    logging.basicConfig(level=logging.INFO)
    with open(config_file) as f:
        spec = json.load(f)
    configs = expand_grid(spec.get("base", {}), spec.get("grid", {}), spec.get("shuffle_seed", 0))
    configs = configs[config_offset::config_stride]
    for cfg in configs:
        cfg.setdefault("experiments-dir", experiments_dir)
    results = run_sweep(configs, num_workers)
    failed = [c for c, code in results if code != 0]
    logger.info("sweep done: %d ok, %d failed", len(results) - len(failed), len(failed))


if __name__ == "__main__":
    main()

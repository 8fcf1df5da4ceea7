"""Generate a plot-config JSON from an experiments directory (a copy of
``dctn_tpu/viz/make_plot_config.py``; reference
``make_plot_training_json_for_dir.py``): walk run dirs, split hyperparameters
into shared vs varying across runs, name each experiment by its varying
values, optionally subsample."""

from __future__ import annotations

import json
import os
import random
from typing import Dict, Optional


def collect_run_infos(experiments_dir: str) -> Dict[str, Dict]:
    infos = {}
    for entry in sorted(os.listdir(experiments_dir)):
        d = os.path.join(experiments_dir, entry)
        info_path = os.path.join(d, "run_info.txt")
        if os.path.isdir(d) and os.path.exists(info_path):
            try:
                with open(info_path) as f:
                    infos[d] = json.load(f)
            except json.JSONDecodeError:
                continue
    return infos


def split_shared_varying(infos: Dict[str, Dict]):
    keys = set().union(*(set(i) for i in infos.values())) if infos else set()
    shared, varying = {}, set()
    for k in sorted(keys):
        values = {json.dumps(i.get(k), sort_keys=True) for i in infos.values()}
        if len(values) == 1:
            shared[k] = next(iter(infos.values())).get(k)
        else:
            varying.add(k)
    # output_dir always varies and is not a hyperparameter
    varying.discard("output_dir")
    varying.discard("commit")
    return shared, sorted(varying)


def make_plot_config(
    experiments_dir: str,
    title: Optional[str] = None,
    subset: Optional[int] = None,
    seed: int = 0,
) -> Dict:
    infos = collect_run_infos(experiments_dir)
    shared, varying = split_shared_varying(infos)
    dirs = sorted(infos)
    if subset is not None and subset < len(dirs):
        rng = random.Random(seed)
        dirs = sorted(rng.sample(dirs, subset))
    experiments = {}
    for d in dirs:
        info = infos[d]
        name = ", ".join(f"{k}={info.get(k)}" for k in varying) or os.path.basename(d)
        experiments[name] = d
    return {
        "title": title or experiments_dir,
        "experiments": experiments,
        "shared_hyperparameters": shared,
        "varying_hyperparameters": varying,
    }


def main() -> None:  # CLI: python -m dctn_tpu_torch.viz.make_plot_config DIR OUT.json
    import sys

    config = make_plot_config(sys.argv[1])
    with open(sys.argv[2], "w") as f:
        json.dump(config, f, indent=2)


if __name__ == "__main__":
    main()

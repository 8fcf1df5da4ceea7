"""Training-curve dashboards (a copy of ``dctn_tpu/viz/plotting.py``;
reference ``plot_training.py``, Bokeh → here matplotlib, imported only when
the static renderer runs, rendered into one standalone HTML file).

A plot-config JSON (same schema the config generator emits) lists experiments
(name → directory); each directory must contain ``log.log`` (parsed by
viz.log_parsing) and optionally ``run_info.txt`` (shown in the page). Figures:
val-acc vs train-acc, acc vs iterations, mean-ce vs iterations.
"""

from __future__ import annotations

import base64
import html
import io
import json
import os
from typing import Dict

from .log_parsing import load_records


def _fig_to_img_tag(fig) -> str:
    buf = io.BytesIO()
    fig.savefig(buf, format="png", dpi=110, bbox_inches="tight")
    data = base64.b64encode(buf.getvalue()).decode()
    return f'<img src="data:image/png;base64,{data}"/>'


def render_dashboard(
    plot_config: Dict,
    output_html: str,
    increasing_tracc: bool = False,
) -> None:
    """``plot_config``: {"experiments": {name: dir, ...}, "title": ...}."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    experiments = plot_config["experiments"]
    all_records = {}
    infos = {}
    for name, exp_dir in experiments.items():
        log_path = os.path.join(exp_dir, "log.log")
        if not os.path.exists(log_path):
            continue
        all_records[name] = load_records(log_path, increasing_tracc)
        info_path = os.path.join(exp_dir, "run_info.txt")
        if os.path.exists(info_path):
            with open(info_path) as f:
                infos[name] = f.read()

    figs = []
    fig, ax = plt.subplots(figsize=(7, 5))
    for name, recs in all_records.items():
        ax.plot([r.tracc for r in recs], [r.vacc for r in recs], marker=".", label=name)
    ax.set_xlabel("train acc")
    ax.set_ylabel("val acc")
    ax.legend(fontsize=7)
    ax.set_title("val acc vs train acc")
    figs.append(fig)

    for metric, title in (("acc", "accuracy"), ("mce", "mean cross-entropy")):
        fig, ax = plt.subplots(figsize=(7, 5))
        for name, recs in all_records.items():
            xs = [r.nitd for r in recs]
            ax.plot(xs, [getattr(r, "tr" + metric) for r in recs], label=f"{name} train")
            ax.plot(xs, [getattr(r, "v" + metric) for r in recs], "--", label=f"{name} val")
        ax.set_xlabel("iterations")
        ax.set_ylabel(title)
        if metric == "mce":
            ax.set_yscale("log")
        ax.legend(fontsize=6)
        ax.set_title(f"{title} vs iterations")
        figs.append(fig)

    parts = [
        "<html><head><meta charset='utf-8'><title>",
        html.escape(plot_config.get("title", "training curves")),
        "</title></head><body>",
        f"<h1>{html.escape(plot_config.get('title', 'training curves'))}</h1>",
    ]
    for fig in figs:
        parts.append(_fig_to_img_tag(fig))
        plt.close(fig)
    for name, info in infos.items():
        parts.append(
            f"<details><summary>{html.escape(name)}</summary>"
            f"<pre>{html.escape(info)}</pre></details>"
        )
    parts.append("</body></html>")
    with open(output_html, "w") as f:
        f.write("".join(parts))


def main() -> None:
    """CLI: python -m dctn_tpu_torch.viz.plotting CONFIG OUT [--static]

    Default output is the INTERACTIVE dashboard (viz.interactive — linked
    range sliders, hover values, legend toggling, config panes, matching the
    reference's Bokeh dashboards); --static keeps the matplotlib renderer."""
    import sys

    with open(sys.argv[1]) as f:
        config = json.load(f)
    if "--static" in sys.argv[3:]:
        render_dashboard(config, sys.argv[2])
    else:
        from .interactive import render_interactive_dashboard

        render_interactive_dashboard(config, sys.argv[2])


if __name__ == "__main__":
    main()

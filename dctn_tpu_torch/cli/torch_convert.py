"""Convert model checkpoints between the reference's torch format and the
npz files both packages write (port of ``dctn_tpu/cli/torch_convert.py``).

A reference user holds ``.pt`` files written by
``torch.save(model.state_dict(), ...)``; the runners write npz files keyed
by tree path. One command moves either way, on the host only (no device):

    python -m dctn_tpu_torch.cli.torch_convert model.pt model.npz   # torch → npz
    python -m dctn_tpu_torch.cli.torch_convert model.npz model.pt   # npz → torch

The model family (EPSesPlusLinear, or the legacy ConvSBS DCTNMnistModel) is
inferred from the checkpoint's keys; ``--family`` overrides it. The npz
loads with either package's ``--load-model-state`` / ``--init-load-file``
(which also take a ``.pt`` as it is); the ``.pt`` loads into the reference
module with ``model.load_state_dict(torch.load(...))``.
"""

from __future__ import annotations

import logging

import click
import numpy as np
import torch

from ..interop import (
    conv_sbs_params_from_state_dict,
    eps_plus_linear_params_from_state_dict,
    is_torch_checkpoint,
    load_torch_state_dict,
    state_dict_from_conv_sbs_params,
    state_dict_from_eps_plus_linear_params,
)
from ..train.checkpoint import (
    load_conv_sbs_params_npz,
    load_params_npz,
    save_conv_sbs_params_npz,
    save_params_npz,
)

logger = logging.getLogger(__name__)


def _infer_family_from_state_dict(sd) -> str:
    if any(k.startswith("epses.") for k in sd):
        return "eps_plus_linear"
    if any(k.startswith("conv_sbses.") for k in sd):
        return "conv_sbs"
    raise click.ClickException(f"cannot infer model family from state_dict keys {sorted(sd)[:6]}...")


def _infer_family_from_npz(path: str) -> str:
    with np.load(path) as d:
        keys = list(d.files)
    if "linear/w" in keys:
        return "eps_plus_linear"
    if keys and all(p.isdigit() for k in keys for p in k.split("/")):
        return "conv_sbs"
    raise click.ClickException(f"cannot infer model family from npz keys {sorted(keys)[:6]}...")


def convert(src: str, dst: str, family: str | None = None) -> str:
    """Convert ``src`` (a torch ``state_dict`` file or an npz) into ``dst`` in
    the other format; returns the model family."""
    if is_torch_checkpoint(src):
        sd = load_torch_state_dict(src)
        fam = family or _infer_family_from_state_dict(sd)
        if fam == "eps_plus_linear":
            save_params_npz(eps_plus_linear_params_from_state_dict(sd), dst)
        else:
            save_conv_sbs_params_npz(conv_sbs_params_from_state_dict(sd), dst)
        logger.info("converted torch %s checkpoint %s -> npz %s", fam, src, dst)
    else:
        fam = family or _infer_family_from_npz(src)
        if fam == "eps_plus_linear":
            sd = state_dict_from_eps_plus_linear_params(load_params_npz(src))
        else:
            sd = state_dict_from_conv_sbs_params(load_conv_sbs_params_npz(src))
        torch.save(sd, dst)
        logger.info("converted npz %s checkpoint %s -> torch %s", fam, src, dst)
    return fam


@click.command()
@click.argument("src", type=click.Path(exists=True, dir_okay=False))
@click.argument("dst", type=click.Path(dir_okay=False, writable=True))
@click.option("--family", type=click.Choice(["eps_plus_linear", "conv_sbs"]), default=None,
              help="model family; inferred from the checkpoint keys when omitted")
def main(src: str, dst: str, family: str | None) -> None:
    logging.basicConfig(level=logging.INFO)
    convert(src, dst, family)


if __name__ == "__main__":
    main()

from .checkpoint import (
    load_conv_sbs_params_npz,
    load_params_npz,
    save_conv_sbs_params_npz,
    save_params_npz,
)
from .optimizers import make_optimizer
from .step import make_fast_train_step, make_gather_batch, resolve_auto_grad_accum

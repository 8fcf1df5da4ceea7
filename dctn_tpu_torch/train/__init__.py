from .checkpoint import (
    AsyncWriter,
    conv_sbs_train_state_arrays,
    load_conv_sbs_params_npz,
    load_conv_sbs_train_state,
    load_params_npz,
    load_train_state,
    save_conv_sbs_params_npz,
    save_params_npz,
    train_state_arrays,
)
from .evaluation import make_score_fn
from .loop import (
    BestModelCheckpointer,
    LastModelsCheckpointer,
    TrainLoopState,
    ValuesNotImprovingEarlyStopper,
    log_parameters_stats,
    make_stopper_after_n_iters,
    make_stopper_on_nan_loss,
    train,
)
from .optimizers import make_optimizer
from .schedule import EvalSchedule, every_n_iters_intervals
from .step import (
    make_fast_train_step,
    make_gather_batch,
    make_train_step,
    resolve_auto_grad_accum,
)

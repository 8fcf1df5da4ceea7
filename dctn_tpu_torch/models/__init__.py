from .eps_plus_linear import (
    EPSesPlusLinear,
    EPSesPlusLinearConfig,
    eps_plus_linear_forward,
    eps_plus_linear_forward_fast,
    epswise_l2_regularizer_fast,
    fast_layer_plans,
    fast_params_from_reference,
    init_eps_plus_linear,
    reference_params_from_fast,
)

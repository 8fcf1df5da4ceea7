from .feature_maps import apply_feature_map, phi_cos_sin_squared_1
from .pipeline import DATASET_TYPES, Splits, calc_scaling_factor, load_dataset

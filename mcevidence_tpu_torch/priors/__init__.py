from .params_info import ParamsInfo, get_prior_volume, params_info

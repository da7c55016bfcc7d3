"""Built-in target models (PyTorch port of ``mcmc_tpu.models``; the flagship
logistic-regression target, the ill-conditioned Gaussian and the NUTS test
targets so far, the rest are listed in ROADMAP.md). Each factory returns a
batched ``log_kernel(params)``."""

from mcmc_tpu_torch.models.targets import (
    banana_model,
    eight_schools_model,
    gaussian_mean_scale_model,
    ill_conditioned_gaussian,
    logistic_regression_model,
    make_logistic_regression_data,
)

__all__ = [
    "banana_model",
    "eight_schools_model",
    "gaussian_mean_scale_model",
    "ill_conditioned_gaussian",
    "logistic_regression_model",
    "make_logistic_regression_data",
]

"""Built-in target models (PyTorch port of ``mcmc_tpu.models``; the flagship
logistic-regression target, the ill-conditioned Gaussian, the NUTS test
targets and the reference examples' targets so far, the rest are listed in
ROADMAP.md). Each factory returns a batched ``log_kernel(params)``;
``normal_fisher_metric`` returns a batched ``metric_fn``."""

from mcmc_tpu_torch.models.targets import (
    banana_model,
    eight_schools_model,
    gaussian_mean_model,
    gaussian_mean_scale_model,
    gaussian_mixture_model,
    ill_conditioned_gaussian,
    logistic_regression_model,
    make_logistic_regression_data,
    neals_funnel,
    normal_fisher_metric,
)

__all__ = [
    "banana_model",
    "eight_schools_model",
    "gaussian_mean_model",
    "gaussian_mean_scale_model",
    "gaussian_mixture_model",
    "ill_conditioned_gaussian",
    "logistic_regression_model",
    "make_logistic_regression_data",
    "neals_funnel",
    "normal_fisher_metric",
]

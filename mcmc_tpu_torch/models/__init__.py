"""Built-in target models (PyTorch port of ``mcmc_tpu.models``: every
target of ``mcmc_tpu.models.targets``). Each factory returns a batched
``log_kernel(params)``; ``normal_fisher_metric`` returns a batched
``metric_fn``, ``rbf_kernel`` a Gram matrix, ``latent_gp_poisson_model``
``(log_lik, prior_cov)`` and ``gp_regression_exact_posterior`` ``(mean,
cov)``."""

from mcmc_tpu_torch.models.targets import (
    banana_model,
    eight_schools_model,
    gaussian_mean_model,
    gaussian_mean_scale_model,
    gaussian_mixture_model,
    gp_regression_exact_posterior,
    horseshoe_regression_model,
    ill_conditioned_gaussian,
    latent_gp_poisson_model,
    logistic_regression_model,
    make_logistic_regression_data,
    neals_funnel,
    normal_fisher_metric,
    poisson_regression_model,
    rbf_kernel,
    student_t_regression_model,
)

__all__ = [
    "banana_model",
    "eight_schools_model",
    "gaussian_mean_model",
    "gaussian_mean_scale_model",
    "gaussian_mixture_model",
    "gp_regression_exact_posterior",
    "horseshoe_regression_model",
    "ill_conditioned_gaussian",
    "latent_gp_poisson_model",
    "logistic_regression_model",
    "make_logistic_regression_data",
    "neals_funnel",
    "normal_fisher_metric",
    "poisson_regression_model",
    "rbf_kernel",
    "student_t_regression_model",
]

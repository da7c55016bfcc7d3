"""Built-in target models (PyTorch port of ``mcmc_tpu.models``; the flagship
logistic-regression target and the ill-conditioned Gaussian so far, the
rest are listed in ROADMAP.md). Each factory returns a batched ``log_kernel(params)``."""

from mcmc_tpu_torch.models.targets import (
    ill_conditioned_gaussian,
    logistic_regression_model,
    make_logistic_regression_data,
)

__all__ = [
    "ill_conditioned_gaussian",
    "logistic_regression_model",
    "make_logistic_regression_data",
]

"""Built-in target models (PyTorch port of ``mcmc_tpu.models``; only the
flagship logistic-regression target so far, the rest are listed in
ROADMAP.md). Each factory returns a batched ``log_kernel(params)``."""

from mcmc_tpu_torch.models.targets import (
    logistic_regression_model,
    make_logistic_regression_data,
)

__all__ = [
    "logistic_regression_model",
    "make_logistic_regression_data",
]

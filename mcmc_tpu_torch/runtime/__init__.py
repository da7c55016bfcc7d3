"""Host-side runtime of the port: the native draw sink."""

from mcmc_tpu_torch.runtime.drawsink import DrawSink, read_draws

__all__ = ["DrawSink", "read_draws"]

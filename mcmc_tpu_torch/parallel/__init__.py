"""Multi-device and multi-process sampling (PyTorch port of
``mcmc_tpu.parallel``): one process per device on ``torch.distributed``
(:mod:`mcmc_tpu_torch.parallel.mesh` says why), chain, population and
ladder sharding, and the ``(chains, data)`` grid."""

from mcmc_tpu_torch.parallel.mesh import (
    make_mesh, make_grid_mesh, chain_sharding, shard_chain_axis,
    shard_data_axis, data_parallel_kernel, chain_mean, chain_sum,
    chain_all_gather,
)
from mcmc_tpu_torch.parallel.distributed import (
    init_distributed, global_chain_array, global_mesh, launch_local,
)

__all__ = ["make_mesh", "make_grid_mesh", "chain_sharding",
           "shard_chain_axis", "shard_data_axis", "data_parallel_kernel",
           "chain_mean", "chain_sum", "chain_all_gather",
           "build_sharded_de_sweep", "build_sharded_stretch_sweep",
           "aees_sharded", "pt_sharded",
           "init_distributed", "global_chain_array", "global_mesh",
           "launch_local"]


_SHARDED = {"build_sharded_de_sweep": "de_sharded",
            "build_sharded_stretch_sweep": "stretch_sharded",
            "pt_sharded": "pt_sharded", "aees_sharded": "aees_sharded"}


def __getattr__(name):
    # the sharded samplers import the sampler modules, which import the mesh
    # module above: load them on first use
    if name not in _SHARDED:
        raise AttributeError(name)
    import importlib
    fn = getattr(importlib.import_module(
        f"mcmc_tpu_torch.parallel.{_SHARDED[name]}"), name)
    globals()[name] = fn      # over the submodule the import bound here
    return fn

"""``mcmc_tpu_torch.parallel`` in one process: the world of one that
``make_mesh()`` builds without a launcher, the mesh checks, the sharding
helpers, and a mesh of one bit-equal to no mesh on every kind of entry
point (chain, population, particle, ladder, checkpointed, fit).

The multi-process runs are ``tests/test_torch_multiprocess.py``.
"""

import numpy as np
import pytest
import torch

import mcmc_tpu_torch as mt
from mcmc_tpu_torch import parallel as par
from mcmc_tpu_torch.parallel import mesh as mesh_mod

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the tests run in several worker processes at
    once, and torch's default of a thread per core oversubscribes the
    CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def mesh():
    """A mesh over a world of one (a Gloo group over an in-memory store
    when no process group exists yet)."""
    m = par.make_mesh()
    assert m.mesh_dim_names == ("chains",) and m.size() == 1
    return m


def lk(v):
    return -0.5 * ((v - 1.5) ** 2).sum(-1)


def _equal(a, b):
    assert torch.equal(torch.as_tensor(a.draws), torch.as_tensor(b.draws))
    assert torch.equal(torch.as_tensor(a.n_accept_draws),
                       torch.as_tensor(b.n_accept_draws))


@pytest.mark.parametrize("name", ["hmc", "nuts", "chees", "mclmc", "rwmh",
                                  "mala", "slice_sampler", "pt",
                                  "thermo_evidence"])
def test_chain_samplers_mesh_of_one_bit_equal(name, mesh):
    """Every chain-axis entry point on a mesh of one equals the unsharded run
    bit for bit (pooled adaptation included)."""
    fn = getattr(mt, name)
    if name == "thermo_evidence":
        s = mt.AlgoSettings(evidence_settings=mt.EvidenceSettings(
            n_burnin_draws=10, n_keep_draws=10, n_temps=4))
        run = lambda **kw: fn(torch.zeros(2), lambda v: -0.5 * (v * v).sum(
            -1), lk, s, n_chains=4, key=3, **CPU, **kw)
        a, b = run(), run(mesh=mesh)
        assert torch.equal(a.log_z_per_chain, b.log_z_per_chain)
        return
    kw = {"pooled_adaptation": True} if name == "nuts" else {}
    settings = {"nuts": mt.NUTSSettings(n_burnin_draws=15, n_keep_draws=10),
                "pt": mt.PTSettings(n_burnin_draws=10, n_keep_draws=10,
                                    n_temps=3, adapt_temps=True)}
    s = settings.get(name)
    if s is None:
        s = getattr(mt, {"hmc": "HMCSettings", "chees": "ChEESSettings",
                         "mclmc": "MCLMCSettings", "rwmh": "RWMHSettings",
                         "mala": "MALASettings",
                         "slice_sampler": "SliceSettings"}[name])(
            n_burnin_draws=15, n_keep_draws=10)
    run = lambda **m: fn(torch.zeros(2), lk, s, n_chains=4, key=2, **CPU,
                         **kw, **m)
    _equal(run(), run(mesh=mesh))


@pytest.mark.parametrize("name", ["de", "stretch", "smc", "demcz", "aees"])
def test_population_samplers_mesh_of_one_bit_equal(name, mesh):
    extra = {}
    if name == "de":
        s = mt.DESettings(n_pop=8, n_burnin_draws=10, n_keep_draws=10)
    elif name == "stretch":
        s = mt.StretchSettings(n_walkers=8, n_burnin_draws=10,
                               n_keep_draws=10)
    elif name == "smc":
        s = mt.SMCSettings(n_particles=64, max_stages=3)
    elif name == "demcz":
        s = mt.DEMCZSettings(n_pop=4, n_burnin_draws=10, n_keep_draws=10)
        extra = {"n_runs": 2}
    else:
        s = mt.AEESSettings(n_initial_draws=5, n_burnin_draws=5,
                            n_keep_draws=10, temper_vec=[4.0])
        extra = {"n_runs": 2}
    run = lambda **m: getattr(mt, name)(torch.zeros(2), lk, s, key=4, **CPU,
                                        **extra, **m)
    a, b = run(), run(mesh=mesh)
    assert torch.equal(a.draws, b.draws)


def test_checkpointed_and_fit_mesh_of_one_bit_equal(mesh, tmp_path):
    s = mt.HMCSettings(n_burnin_draws=10, n_keep_draws=20)
    a = mt.hmc(torch.zeros(2), lk, s, n_chains=4, key=5,
               checkpoint_dir=str(tmp_path / "a"), checkpoint_every=7, **CPU)
    b = mt.hmc(torch.zeros(2), lk, s, n_chains=4, key=5, mesh=mesh,
               checkpoint_dir=str(tmp_path / "b"), checkpoint_every=7, **CPU)
    _equal(a, b)
    f = lambda **m: mt.fit(torch.zeros(2), lk, n_chains=4, n_warmup=20,
                           n_draws=10, key=6, **CPU, **m)
    _equal(f(), f(mesh=mesh))


@pytest.mark.parametrize("bad", [object(), "chains", 2])
def test_non_mesh_raises_type_error(bad):
    with pytest.raises(TypeError, match="DeviceMesh"):
        mt.hmc(torch.zeros(2), lk, n_chains=2, mesh=bad, **CPU)
    with pytest.raises(TypeError, match="DeviceMesh"):
        mt.de(torch.zeros(2), lk, mesh=bad, **CPU)


def test_mesh_sizes_and_axes(mesh):
    """The world has one rank: larger meshes raise ``ValueError`` (the JAX
    package's ``make_grid_mesh`` check), a mesh without a chain axis is
    refused by the samplers, and the axes report size and index."""
    with pytest.raises(ValueError, match="needs 4 devices, have 1"):
        par.make_grid_mesh(2, 2)
    with pytest.raises(ValueError, match="needs 2 devices"):
        par.make_mesh(2)
    grid = par.make_grid_mesh(1, 1)
    assert grid.mesh_dim_names == ("chains", "data")
    ax = mesh_mod.mesh_axis(grid, "data")
    assert (ax.size, ax.index) == (1, 0)
    assert mesh_mod.chain_axis_of(mesh) is None     # one rank: unsharded
    other = par.make_mesh(axis_name="data")
    with pytest.raises(ValueError, match="no 'chains' axis"):
        mt.hmc(torch.zeros(2), lk, n_chains=2, mesh=other, **CPU)


def test_sharding_helpers_on_a_world_of_one(mesh):
    x = torch.arange(12.0).reshape(6, 2)
    assert par.chain_sharding(mesh, 6) == slice(0, 6)
    tree = {"a": x, "b": torch.tensor(3.0), "c": (x[:, 0], 7)}
    out = par.shard_chain_axis(tree, mesh)
    assert torch.equal(out["a"], x) and out["c"][1] == 7
    assert torch.equal(par.global_chain_array(np.ones((4, 2)), mesh),
                       torch.ones((4, 2), dtype=torch.float64))
    grid = par.make_grid_mesh(1, 1)
    assert torch.equal(par.shard_data_axis(x, grid), x)
    kern = lambda p, d: -0.5 * ((p[:, None, :] - d) ** 2).sum((-1, -2))
    dp = par.data_parallel_kernel(kern, x, grid)
    p = torch.randn(3, 2, generator=torch.Generator().manual_seed(0))
    assert torch.equal(dp(p), kern(p, x))


def test_chain_shard_requires_the_chain_axis_on_every_leaf():
    """Every tensor leaf of a sharded state carries the chain axis first
    and is cut into rank blocks; 0-d leaves replicate. A leaf with another
    leading length (a (d,) or (d, d) mass, say) raises rather than being
    sharded or replicated by a guess from its shape."""
    ax = mesh_mod.MeshAxis(group=None, size=2, index=1)
    x = torch.arange(8.0).reshape(4, 2)
    state = {"x": x, "lk": x[:, 0], "eps": torch.tensor(0.5), "n": 3}
    shard = mesh_mod.ChainShard(ax, state)
    assert (shard.n, shard.rows) == (4, slice(2, 4))
    local = shard.local(state)
    assert torch.equal(local["x"], x[2:]) and torch.equal(local["lk"], x[2:, 0])
    assert local["eps"] is state["eps"] and local["n"] == 3
    for bad in (torch.ones(2), torch.eye(2), torch.ones(4, 4)[:3]):
        with pytest.raises(ValueError, match="chain axis first"):
            mesh_mod.ChainShard(ax, dict(state, mass=bad))


def test_collectives_without_a_sharded_run():
    """Outside a sharded run the collectives are the plain reductions,
    bit for bit (the unsharded samplers' arithmetic is unchanged)."""
    x = torch.randn(5, 3, generator=torch.Generator().manual_seed(1))
    assert torch.equal(par.chain_mean(x, dim=0), x.mean(dim=0))
    assert torch.equal(par.chain_mean(x[:, 0]), x[:, 0].mean())
    assert torch.equal(par.chain_sum(x, dim=0, keepdim=True),
                       x.sum(dim=0, keepdim=True))
    assert torch.equal(par.chain_all_gather(x), x)
    assert bool(mesh_mod.chain_any(x > 2.0)) == bool((x > 2.0).any())


def test_sharded_ladders_refuse_mismatched_meshes(mesh):
    """``pt_sharded`` and ``aees_sharded`` need one rung per rank, and
    ``pt_sharded`` a fixed ladder, as in the JAX package."""
    with pytest.raises(ValueError, match="ladder size"):
        par.pt_sharded(torch.zeros(2), lk, mt.PTSettings(n_temps=3),
                       mesh=mesh, **CPU)
    with pytest.raises(ValueError, match="fixed ladder"):
        par.pt_sharded(torch.zeros(2), lk,
                       mt.PTSettings(n_temps=1, adapt_temps=True),
                       mesh=mesh, **CPU)
    with pytest.raises(ValueError, match="ladder size"):
        par.aees_sharded(torch.zeros(2), lk,
                         mt.AEESSettings(temper_vec=[10.0]), mesh=mesh,
                         **CPU)
    with pytest.raises(ValueError, match="replica"):
        mt.demcz(torch.zeros(2), lk, mesh=mesh, **CPU)
    with pytest.raises(ValueError, match="does not take mesh"):
        mt.fit(torch.zeros(2), lk, algorithm="demcz", mesh=mesh, **CPU)

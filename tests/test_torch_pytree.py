"""The PyTorch port's pytree front-end against the JAX package's, on the
CPU: the port's own flattening gives ``ravel_pytree``'s flat vector (sorted
dict keys, lists and tuples in order), its batched ``unravel`` the leaves
``jax.vmap`` of JAX's gives, ``bounds_like`` the same bounds, and a pytree
``fit`` the flat one's draws bit for bit (``tests/test_pytree.py:24``)."""

import math

import jax
import jax.flatten_util
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mcmc_tpu
import mcmc_tpu_torch
from mcmc_tpu_torch import pytree as tpytree


def _trees():
    rng = np.random.default_rng(0)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return {
        "nested": {"mu": f(3), "L": f(2, 2),
                   "hyper": {"sigma": np.float32(0.7), "tau": f(1)}},
        "tuple_and_scalar": {"b": (f(2, 3), 1.5), "a": f(4)},
        "list_with_none": [f(2), None, {"z": f(3), "c": 2.0}],
    }


@pytest.mark.parametrize("name", sorted(_trees()))
def test_ravel_matches_ravel_pytree(name):
    tree = _trees()[name]
    jflat, junravel = jax.flatten_util.ravel_pytree(
        jax.tree_util.tree_map(jnp.asarray, tree))
    x0, _, unravel = mcmc_tpu_torch.ravel_model(tree, device="cpu")
    np.testing.assert_array_equal(x0.numpy(), np.asarray(jflat))
    # one flat vector back to the leaves, as JAX's unravel gives them
    got = jax.tree_util.tree_leaves(
        jax.tree_util.tree_map(lambda t: t.numpy(), unravel(x0)))
    want = jax.tree_util.tree_leaves(junravel(jflat))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, np.asarray(w))


def test_unravel_draws_matches_jax_on_draw_and_chain_axes():
    tree = _trees()["nested"]
    _, _, junravel = mcmc_tpu.ravel_model(
        jax.tree_util.tree_map(jnp.asarray, tree))
    _, _, unravel = mcmc_tpu_torch.ravel_model(tree, device="cpu")
    draws = np.random.default_rng(1).normal(size=(5, 4, 9)).astype(
        np.float32)
    want = mcmc_tpu.unravel_draws(jnp.asarray(draws), junravel)
    got = mcmc_tpu_torch.unravel_draws(torch.tensor(draws), unravel)
    assert got["L"].shape == (5, 4, 2, 2)
    assert got["hyper"]["sigma"].shape == (5, 4)
    for g, w in zip(jax.tree_util.tree_leaves(
            jax.tree_util.tree_map(lambda t: t.numpy(), got)),
            jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g, np.asarray(w))


@pytest.mark.parametrize("bound", [
    {"mu": None, "L": 0.0, "hyper": {"sigma": 1e-6, "tau": None}},
    {"mu": np.array([-1.0, 0.0, 1.0], np.float32), "L": None,
     "hyper": {"sigma": None, "tau": -2.0}},
])
def test_bounds_like_matches_jax(bound):
    tree = _trees()["nested"]
    jtree = jax.tree_util.tree_map(jnp.asarray, tree)
    for default in (-math.inf, math.inf):
        want = mcmc_tpu.bounds_like(jtree, bound, default)
        got = mcmc_tpu_torch.bounds_like(tree, bound, default, device="cpu")
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_pytree_validation_errors():
    with pytest.raises(TypeError, match="callable"):
        mcmc_tpu_torch.ravel_model({"a": np.zeros(2)}, "not-a-function",
                                   device="cpu")
    with pytest.raises(ValueError, match="prefix"):
        mcmc_tpu_torch.bounds_like({"a": np.zeros(2)}, {"b": 0.0},
                                   default=-math.inf, device="cpu")
    # JAX refuses a scalar standing for a whole dict as well
    with pytest.raises(ValueError, match="prefix"):
        mcmc_tpu.bounds_like({"a": jnp.zeros(2)}, 0.0, default=-jnp.inf)
    with pytest.raises(ValueError, match="prefix"):
        mcmc_tpu_torch.bounds_like({"a": np.zeros(2)}, 0.0,
                                   default=-math.inf, device="cpu")


def _structured_model(x):
    """{mu, log_sigma} Gaussian model with named parameters, batched: each
    leaf carries the chain axis."""
    n = x.shape[0]

    def log_kernel(p):
        sigma = torch.exp(p["log_sigma"])
        return (-n * p["log_sigma"]
                - 0.5 * ((x - p["mu"][:, None]) ** 2).sum(-1) / sigma ** 2)
    return log_kernel


def test_pytree_fit_equals_flat_fit_bitwise():
    """A pytree model fits bit for bit as its hand-flattened twin (the
    wrapper is a reshape, not a reparameterization), and its draws
    unravel with their draw and chain axes."""
    x = torch.tensor(2.0 + np.random.default_rng(0).normal(size=50),
                     dtype=torch.float32)
    tree_lk = _structured_model(x)
    init = {"mu": torch.tensor(1.0), "log_sigma": torch.tensor(0.0)}
    flat_lk = lambda v: tree_lk({"log_sigma": v[:, 0], "mu": v[:, 1]})
    kw = dict(algorithm="chees", n_chains=8, n_warmup=100, n_draws=100,
              key=3, device="cpu")
    a = mcmc_tpu_torch.fit(init, tree_lk, **kw)
    b = mcmc_tpu_torch.fit(torch.tensor([0.0, 1.0]), flat_lk, **kw)
    assert torch.equal(a.draws, b.draws)
    tree = mcmc_tpu_torch.unravel_draws(a.draws,
                                        a.diagnostics["unravel"])
    assert set(tree) == {"mu", "log_sigma"}
    assert tree["mu"].shape == (100, 8)
    assert float(tree["mu"].mean()) == pytest.approx(float(x.mean()),
                                                     abs=0.15)


def test_coerce_model_approximator_surfaces():
    """Dict-parameterized models run directly through map_laplace and
    pathfinder; the results carry ``unravel``."""
    init = {"mu": torch.zeros(2), "log_s": torch.tensor(0.0)}

    def lk(p):
        return (-0.5 * ((p["mu"] - 1.0) ** 2).sum(-1)
                - 0.5 * (p["log_s"] + 0.5) ** 2)

    lap = mcmc_tpu_torch.map_laplace(init, lk, n_steps=400, key=40)
    mode = tpytree.unravel_draws(lap.mode[None], lap.unravel)
    assert abs(float(mode["mu"][0, 0]) - 1.0) < 0.05
    assert abs(float(mode["log_s"][0]) + 0.5) < 0.05
    pf = mcmc_tpu_torch.pathfinder(init, lk, n_paths=2, n_draws=200, key=41)
    tree = tpytree.unravel_draws(pf.draws, pf.unravel)
    assert tree["mu"].shape == (200, 2)
    assert abs(float(tree["mu"].mean()) - 1.0) < 0.2

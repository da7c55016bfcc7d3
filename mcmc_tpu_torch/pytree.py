"""Pytree parameter front-end (PyTorch port of ``mcmc_tpu.pytree``):
structured models on the flat-vector API.

The sampler entry points speak flat parameter vectors, one ``(n_chains, d)``
batch. Real models have structure: ``{"mu": (k,), "L": (k, k), "sigma":
()}``. This module bridges the two with its own flattening over dicts,
lists, tuples, ``None``, Python numbers, numpy arrays and tensors:

    x0, log_kernel, unravel = ravel_model(init_tree, tree_log_kernel)
    out = mcmc_tpu_torch.nuts(x0, log_kernel, ...)
    tree_draws = unravel_draws(out.draws, unravel)   # same structure,
                                                     # leading draw axes

The leaf order is ``jax.flatten_util.ravel_pytree``'s: dict entries by
sorted key, lists and tuples in order, ``None`` an empty subtree. A flat
index therefore names the same parameter in both packages (Gibbs
``blocks=`` and :func:`bounds_like` address parameters by it).

API difference from the JAX package: ``unravel`` takes any leading batch,
mapping ``(..., d)`` to leaves of ``(..., *shape)`` (JAX's takes one
``(d,)`` vector and is ``vmap``-ed). A pytree log-kernel is therefore
batched like every log-kernel of this package: it receives leaves with a
leading chain axis, ``leaf: (n_chains, *shape)``, and returns
``(n_chains,)``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from mcmc_tpu_torch.samplers._resolve import resolve_device

__all__ = ["ravel_model", "unravel_draws", "bounds_like", "coerce_model"]


def _flatten(tree):
    """``(leaves, rebuild)``: the leaves in ``ravel_pytree``'s order and a
    function that puts a list of new leaves back into the structure."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        parts = [_flatten(tree[k]) for k in keys]

        def rebuild(leaves):
            out, i = {}, 0
            for k, (sub, rb) in zip(keys, parts):
                out[k] = rb(leaves[i:i + len(sub)])
                i += len(sub)
            return out
    elif isinstance(tree, (list, tuple)):
        parts = [_flatten(v) for v in tree]
        kind = type(tree)

        def rebuild(leaves):
            out, i = [], 0
            for sub, rb in parts:
                out.append(rb(leaves[i:i + len(sub)]))
                i += len(sub)
            return kind(out) if kind in (list, tuple) else kind(*out)
    elif tree is None:
        return [], lambda leaves: None
    else:
        return [tree], lambda leaves: leaves[0]
    return [leaf for sub, _ in parts for leaf in sub], rebuild


def _flatten_up_to(tree, other):
    """The entries of ``other`` at ``tree``'s leaf positions, in leaf order
    (``treedef.flatten_up_to``): ``other`` must have ``tree``'s containers,
    and holds anything (``None`` too) where ``tree`` has a leaf."""
    if isinstance(tree, dict):
        if not isinstance(other, dict) or sorted(other) != sorted(tree):
            raise ValueError(f"expected a dict with keys {sorted(tree)}, "
                             f"got {other!r}")
        return [e for k in sorted(tree)
                for e in _flatten_up_to(tree[k], other[k])]
    if isinstance(tree, (list, tuple)):
        if type(other) is not type(tree) or len(other) != len(tree):
            raise ValueError(f"expected a {type(tree).__name__} of "
                             f"{len(tree)}, got {other!r}")
        return [e for t, o in zip(tree, other)
                for e in _flatten_up_to(t, o)]
    if tree is None:
        if other is not None:
            raise ValueError(f"expected None, got {other!r}")
        return []
    return [other]


def _leaf_tensor(leaf, device):
    if torch.is_tensor(leaf):
        return leaf.to(device)
    return torch.as_tensor(np.asarray(leaf), device=device)


def _flat_dtype(leaves):
    """float32, or the widest floating dtype among tensor and array
    leaves."""
    dt = torch.float32
    for leaf in leaves:
        if torch.is_tensor(leaf) and leaf.is_floating_point():
            dt = torch.promote_types(dt, leaf.dtype)
        elif isinstance(leaf, np.ndarray) and leaf.dtype.kind == "f":
            dt = torch.promote_types(dt, torch.from_numpy(leaf[:0]).dtype)
    return dt


def _ravel(tree, device=None):
    """``(x0, unravel)`` of a pytree, as ``ravel_pytree`` returns them."""
    leaves, rebuild = _flatten(tree)
    device = resolve_device(device, *leaves)
    dtype = _flat_dtype(leaves)
    ts = [_leaf_tensor(leaf, device) for leaf in leaves]
    shapes = [tuple(t.shape) for t in ts]
    # a Python number takes the flat dtype; arrays keep theirs on the way
    # back, as ravel_pytree's unravel casts to each leaf's dtype
    dtypes = [t.dtype if (torch.is_tensor(leaf)
                          or isinstance(leaf, np.ndarray)) else dtype
              for leaf, t in zip(leaves, ts)]
    sizes = [math.prod(s) for s in shapes]
    if ts:
        x0 = torch.cat([t.reshape(-1).to(dtype) for t in ts])
    else:
        x0 = torch.zeros((0,), dtype=dtype, device=device)
    n = int(x0.shape[0])

    def unravel(x):
        if x.shape[-1] != n:
            raise ValueError(f"unravel expects a last axis of {n}, got "
                             f"shape {tuple(x.shape)}")
        lead, out, i = tuple(x.shape[:-1]), [], 0
        for shape, size, dt in zip(shapes, sizes, dtypes):
            leaf = x[..., i:i + size].reshape(lead + shape)
            out.append(leaf if leaf.dtype == dt else leaf.to(dt))
            i += size
        return rebuild(out)

    return x0, unravel


def ravel_model(init_tree, tree_log_kernel=None, device=None):
    """Flatten a pytree-parameterized model onto the sampler API.

    Returns ``(x0, log_kernel, unravel)``: ``x0`` the flat initial vector
    (on ``device``, default: the device of the first tensor leaf, else the
    card), ``log_kernel(x: (n_chains, d)) -> (n_chains,)`` evaluating the
    batched ``tree_log_kernel`` on the unflattened tree (``None`` if no
    kernel is given — for samplers with another callback contract wrap
    each callback with ``lambda x, *a: f(unravel(x), *a)``), and
    ``unravel(x: (..., d)) -> tree`` with leaves ``(..., *shape)``.
    """
    x0, unravel = _ravel(init_tree, device)
    if x0.ndim != 1 or x0.shape[0] == 0:
        raise ValueError("init_tree must contain at least one array leaf")
    if tree_log_kernel is None:
        return x0, None, unravel
    if not callable(tree_log_kernel):
        raise TypeError("tree_log_kernel must be callable: "
                        "tree_log_kernel(params_tree) -> (n_chains,)")

    def log_kernel(x):
        return tree_log_kernel(unravel(x))

    return x0, log_kernel, unravel


def unravel_draws(draws, unravel):
    """Unflatten sampler draws back into parameter structure.

    ``draws`` is ``(..., d)`` — any number of leading draw/chain axes;
    returns the pytree of ``unravel`` with each leaf carrying those leading
    axes (one reshape per leaf, no loop over draws).
    """
    return unravel(torch.as_tensor(draws))


def bounds_like(init_tree, bound_tree, default, device=None):
    """Flat per-dimension bounds vector from a pytree of per-leaf bounds.

    ``bound_tree`` has ``init_tree``'s structure, as the JAX package's
    ``treedef.flatten_up_to`` requires: each entry is a scalar (applied to
    every element of the matching leaf), an array broadcastable to the
    leaf, or ``None`` (unbounded — ``default``, which callers pass as
    ``-inf``/``+inf``). Returns the flat vector aligned with
    :func:`ravel_model`'s ``x0``, in its dtype and on its device.
    """
    try:
        bounds = _flatten_up_to(init_tree, bound_tree)
    except ValueError as e:
        raise ValueError(
            f"bound_tree must be a pytree prefix of init_tree: {e}") from e
    x0, _ = _ravel(init_tree, device)
    leaves, _ = _flatten(init_tree)
    flat = []
    for leaf, b in zip(leaves, bounds):
        shape = tuple(np.shape(leaf)) if not torch.is_tensor(leaf) \
            else tuple(leaf.shape)
        val = default if b is None else b
        t = torch.as_tensor(val if torch.is_tensor(val) else np.asarray(val),
                            dtype=x0.dtype, device=x0.device)
        flat.append(torch.broadcast_to(t, shape).reshape(-1))
    return torch.cat(flat) if flat else x0.new_zeros((0,))


def _is_tree(initial_vals):
    """Whether ``initial_vals`` is a parameter pytree rather than a flat
    vector: a dict, or anything ``torch.as_tensor`` rejects (a tuple of
    arrays of different shapes, say)."""
    if isinstance(initial_vals, dict):
        return True
    if callable(initial_vals) and not hasattr(initial_vals, "__array__"):
        return False
    if torch.is_tensor(initial_vals) or isinstance(initial_vals, np.ndarray):
        return False
    try:
        torch.as_tensor(initial_vals)
    except (TypeError, ValueError, RuntimeError):
        return True
    return False


def coerce_model(initial_vals, *fns, device=None):
    """Accept flat-vector OR pytree initial values uniformly.

    Returns ``(x0, wrapped_fns, unravel)``: flat inputs pass through with
    ``unravel=None``; a dict (or anything ``torch.as_tensor`` rejects)
    ravels, and every function in ``fns`` is wrapped to take the flat
    ``(n, d)`` batch. The bridge the approximate-inference surfaces
    (``pathfinder``, ``map_laplace``) use; samplers go through ``fit``'s
    richer path, which also maps bound trees.
    """
    if not _is_tree(initial_vals):
        return initial_vals, fns, None
    x0, unravel = _ravel(initial_vals, device)
    wrapped = tuple((lambda f: lambda x, *a: f(unravel(x), *a))(f)
                    for f in fns)
    return x0, wrapped, unravel

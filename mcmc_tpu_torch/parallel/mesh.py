"""Device meshes and chain-axis collectives (PyTorch port of
``mcmc_tpu.parallel.mesh``).

The JAX package shards the chain batch over a ``jax.sharding.Mesh`` inside
one program and lets GSPMD place the collectives. PyTorch has no single
controller, so the port runs **one process per device** on
``torch.distributed``, as ``torchrun --nproc-per-node`` does:

- a mesh is a :class:`torch.distributed.device_mesh.DeviceMesh` over the
  initialised process group, one device per rank: a 1-D mesh has the axis
  ``"chains"``, the grid the axes ``("chains", "data")``;
- every rank calls the same entry point with the same full-batch arguments
  and seed (the JAX package's multi-process contract); each rank runs its
  contiguous slice of the chain (walker, particle, ladder) axis on its own
  device with its own ``torch.Generator``, seeded from the run's seed and
  the first global row of its slice, so a result depends only on the seed
  and the mesh size;
- cross-chain reductions (``lax.pmean`` over the chain axis in JAX) are
  :func:`chain_mean` / :func:`chain_sum`: an ``all_reduce`` over the mesh's
  ``"chains"`` group while a sharded run is active
  (:func:`sharded_chains`), the plain reduction otherwise;
- a mesh of one process, or no mesh, runs exactly as without one.

Why not one process driving several devices: every sampler of the port is
host-bound (each NUTS leaf or ChEES transition is hundreds of small
launches), so one Python thread driving ``n`` cards would pay ``n`` times
the launches per transition. One process per card gives each card its own
host thread.

Backends: NCCL on the card and Gloo on the CPU (:func:`make_mesh` in a
process that never initialised ``torch.distributed`` builds a world of one
over a ``HashStore``, NCCL when the card is available). Gloo also carries
card tensors (two ranks sharing one card, which NCCL refuses); the
collectives here stage those through host memory.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["CHAIN_AXIS", "DATA_AXIS", "make_mesh", "make_grid_mesh",
           "chain_sharding", "shard_chain_axis", "shard_data_axis",
           "data_parallel_kernel", "chain_mean", "chain_sum", "chain_any",
           "chain_all_gather", "sharded_chains", "chain_axis_of",
           "mesh_axis", "active_axis", "MeshAxis", "tree_map", "ChainShard",
           "rank_generator", "shared_generator", "shared_stream", "all_reduce",
           "all_gather", "exchange", "COUNTS", "gather_rows"]

CHAIN_AXIS = "chains"
DATA_AXIS = "data"


class MeshAxis(NamedTuple):
    """One axis of a mesh as this rank sees it: the process ``group`` of
    the ranks along it, its ``size`` and this rank's ``index`` on it."""
    group: object
    size: int
    index: int


def _world_of_one():
    """Initialise a one-rank process group over an in-memory store, NCCL
    when the card is available, else Gloo (``make_mesh`` in a process that
    never called :func:`~mcmc_tpu_torch.parallel.init_distributed`)."""
    backend = "nccl" if torch.cuda.is_available() else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                            world_size=1)


def _mesh_device_type():
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def _device_mesh(shape, names):
    from torch.distributed.device_mesh import DeviceMesh
    if not dist.is_initialized():
        _world_of_one()
    world = dist.get_world_size()
    need = 1
    for n in shape:
        need *= int(n)
    if need > world:
        raise ValueError(
            f"mesh {'x'.join(str(int(n)) for n in shape)} needs {need} "
            f"devices, have {world}")
    if need != world:
        raise ValueError(
            f"mesh {'x'.join(str(int(n)) for n in shape)} covers {need} of "
            f"the world's {world} ranks; a mesh spans every rank (one "
            f"process per device: start as many processes as the mesh has "
            f"devices)")
    return DeviceMesh(_mesh_device_type(),
                      torch.arange(need).reshape(tuple(int(n) for n in shape)),
                      mesh_dim_names=tuple(names))


def make_mesh(n_devices: Optional[int] = None, axis_name: str = CHAIN_AXIS):
    """1-D mesh over every rank of the process group (``n_devices``, when
    given, must equal the world size). Without an initialised process group
    this is a world of one on this process's device."""
    if not dist.is_initialized():
        _world_of_one()
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return _device_mesh((n,), (axis_name,))


def make_grid_mesh(n_chain_devices: int, n_data_devices: int,
                   axis_names=(CHAIN_AXIS, DATA_AXIS)):
    """2-D ``(chains, data)`` mesh for tall-data models: the chain batch
    shards over the first axis and the dataset over the second
    (:func:`data_parallel_kernel`), so one chain's likelihood sum runs over
    ``n_data_devices`` ranks. Raises ``ValueError`` when the world is too
    small (or larger than the grid)."""
    return _device_mesh((int(n_chain_devices), int(n_data_devices)),
                        axis_names)


def mesh_axis(mesh, axis_name: str) -> Optional[MeshAxis]:
    """The :class:`MeshAxis` of ``axis_name`` on ``mesh``, or ``None`` when
    the mesh has no such axis. Raises ``TypeError`` for a non-mesh."""
    from torch.distributed.device_mesh import DeviceMesh
    if not isinstance(mesh, DeviceMesh):
        raise TypeError(
            f"mesh must be a torch.distributed.device_mesh.DeviceMesh "
            f"(mcmc_tpu_torch.parallel.make_mesh / make_grid_mesh); got "
            f"{type(mesh).__name__}")
    names = mesh.mesh_dim_names or ()
    if axis_name not in names:
        return None
    return MeshAxis(group=mesh.get_group(axis_name),
                    size=int(mesh.size(names.index(axis_name))),
                    index=int(mesh.get_local_rank(axis_name)))


def chain_axis_of(mesh, axis_name: str = CHAIN_AXIS) -> Optional[MeshAxis]:
    """The chain axis a run shards over: ``None`` without a mesh or when
    the axis has one rank (the run is then exactly the unsharded one).
    Raises ``TypeError`` for a non-mesh, ``ValueError`` for a mesh without
    the axis."""
    if mesh is None:
        return None
    ax = mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis (its axes: "
                         f"{mesh.mesh_dim_names})")
    return ax if ax.size > 1 else None


def chain_sharding(mesh, n_rows: int, axis_name: str = CHAIN_AXIS) -> slice:
    """The rows of a leading axis of length ``n_rows`` that this rank holds:
    a contiguous block, ``n_rows`` dividing evenly over the axis."""
    ax = mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis")
    return _rows(n_rows, ax)


def _rows(n_rows, ax: MeshAxis) -> slice:
    n_rows = int(n_rows)
    if n_rows % ax.size != 0:
        raise ValueError(f"a leading axis of {n_rows} rows must divide "
                         f"evenly over the mesh's {ax.size} ranks")
    per = n_rows // ax.size
    return slice(ax.index * per, (ax.index + 1) * per)


def tree_map(fn, tree):
    """``fn`` on every tensor leaf of named tuples, tuples, lists and dicts;
    other leaves (host counters, ``None``) pass through."""
    if torch.is_tensor(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*[tree_map(fn, v) for v in tree])
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return tree


def _chain_rows(tree):
    """The chain-axis length of ``tree``: the common leading length of its
    tensor leaves with a leading axis (0-d leaves are replicated). A leaf
    with another leading length raises, so no replicated tensor is ever
    taken for a chain-sharded one."""
    lengths = []
    tree_map(lambda t: lengths.append(int(t.shape[0])) if t.ndim >= 1
             else None, tree)
    if not lengths:
        raise ValueError("nothing to shard: no tensor with a leading axis")
    if len(set(lengths)) > 1:
        raise ValueError(f"every tensor with a leading axis must carry the "
                         f"chain axis first; leading lengths "
                         f"{sorted(set(lengths))} differ")
    return lengths[0]


def shard_chain_axis(tree, mesh, axis_name: str = CHAIN_AXIS):
    """This rank's rows of every leaf's leading (chain) axis; 0-d leaves
    replicate. Every rank must pass the same host-replicated values."""
    ax = mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis")
    rows = _rows(_chain_rows(tree), ax)
    return tree_map(lambda t: t[rows] if t.ndim >= 1 else t, tree)


def shard_data_axis(tree, mesh, axis_name: str = DATA_AXIS):
    """This rank's block of every leaf's leading (observation) axis over the
    mesh's data axis; rank-0 leaves replicate. Leading axes must divide by
    the data-axis size (pad or trim the dataset first)."""
    ax = mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis")
    return tree_map(lambda t: t[_rows(t.shape[0], ax)] if t.ndim >= 1
                    else t, tree)


class ChainShard:
    """This rank's part of a chain-sharded run of ``state0``, a tree whose
    tensor leaves all carry the chain axis first (0-d leaves are
    replicated; any other leaf raises): :meth:`local` takes this rank's
    rows of such a tree, :meth:`gather` joins every rank's rows again."""

    def __init__(self, axis: MeshAxis, state0):
        self.axis = axis
        self.n = _chain_rows(state0)
        self.rows = _rows(self.n, axis)

    def local(self, tree):
        return tree_map(lambda t: t[self.rows] if t.ndim >= 1 else t, tree)

    def gather(self, tree):
        leaves = []
        tree_map(lambda t: leaves.append(t) if t.ndim >= 1 else None, tree)
        it = iter(gather_rows(leaves, self.axis))
        return tree_map(lambda t: next(it) if t.ndim >= 1 else t, tree)


def gather_rows(tensors, axis: MeshAxis, dim=0):
    """Every rank's block of the chain axis ``dim`` of each tensor, joined
    in rank order: one all-gather per dtype for the whole list."""
    out = [None] * len(tensors)
    by_dtype = {}
    for i, t in enumerate(tensors):
        by_dtype.setdefault((t.dtype, t.device), []).append(i)
    for idx in by_dtype.values():
        flat = [tensors[i].movedim(dim, 0) for i in idx]
        rows = flat[0].shape[0]
        packed = torch.cat([f.reshape(rows, -1) for f in flat], dim=1)
        full = all_gather(packed, axis.group, axis.size)
        o = 0
        for i, f in zip(idx, flat):
            w = f[0].numel()
            out[i] = full[:, o:o + w].reshape(
                (rows * axis.size,) + tuple(f.shape[1:])).movedim(0, dim)
            o += w
    return out


def rank_generator(gen, row0: int, device=None):
    """``(seed, generator)`` of the rank whose block starts at global row
    ``row0``: one seed drawn from the run's generator ``gen`` (identical
    on every rank), then the stream ``(seed, row0)``
    (:func:`~mcmc_tpu_torch.samplers._resolve.stream_generator`)."""
    from mcmc_tpu_torch.samplers._resolve import key_seed, stream_generator
    seed = key_seed(gen)
    return seed, stream_generator(seed, int(row0),
                                  device=gen.device if device is None
                                  else device)


def shared_generator(seed: int, device):
    """The stream every rank of a sharded run draws identically (SMC's
    resampling uniforms, PT's swap uniforms, SGLD's shared minibatch):
    ``(seed, 0, 0)``, disjoint from every rank's ``(seed, row0)``."""
    from mcmc_tpu_torch.samplers._resolve import stream_generator
    return stream_generator(seed, 0, 0, device=device)


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------

_ACTIVE: list = []    # (axis, shared generator) of the sharded runs in flight


@contextlib.contextmanager
def sharded_chains(axis: Optional[MeshAxis], shared_gen=None):
    """Make ``axis`` the chain axis that :func:`chain_mean` and its kin
    reduce over while the block runs (``None``: plain reductions), and
    ``shared_gen`` the stream every rank draws identically
    (:func:`shared_stream`)."""
    _ACTIVE.append((axis, shared_gen))
    try:
        yield axis
    finally:
        _ACTIVE.pop()


def active_axis() -> Optional[MeshAxis]:
    """The chain axis of the sharded run in flight, or ``None``."""
    return _ACTIVE[-1][0] if _ACTIVE else None


def shared_stream():
    """The generator every rank of the sharded run in flight draws
    identically (SGLD's shared minibatch indices), or ``None``."""
    return _ACTIVE[-1][1] if _ACTIVE else None


# collectives issued by this process, by kind (read and reset by callers
# that report collectives per draw)
COUNTS = {"all_reduce": 0, "all_gather": 0, "p2p": 0}


def _comm_device(x, group):
    """Where a collective over ``group`` takes ``x``: host memory for Gloo
    (which reduces card tensors only by staging them), the current card for
    NCCL."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def all_reduce(x, group, op=dist.ReduceOp.SUM):
    """``x`` reduced over ``group``, as a new tensor on ``x``'s device."""
    y = x.detach().to(_comm_device(x, group), copy=True).contiguous()
    COUNTS["all_reduce"] += 1
    dist.all_reduce(y, op=op, group=group)
    return y.to(x.device)


def all_gather(x, group, size, dim=0):
    """The ``size`` ranks' ``x`` (equal shapes) concatenated along ``dim``
    in rank order, on ``x``'s device."""
    src = x.detach().to(_comm_device(x, group)).contiguous()
    parts = [torch.empty_like(src) for _ in range(size)]
    COUNTS["all_gather"] += 1
    dist.all_gather(parts, src, group=group)
    return torch.cat(parts, dim=dim).to(x.device)


def exchange(x, group, peer: int):
    """Send ``x`` to the rank at index ``peer`` of ``group`` and receive its
    tensor of the same shape (a point-to-point swap, both sides posting
    before either waits)."""
    dev = _comm_device(x, group)
    src = x.detach().to(dev).contiguous()
    out = torch.empty_like(src)
    g = dist.get_global_rank(group, int(peer))
    COUNTS["p2p"] += 1
    works = [dist.isend(src, g, group=group), dist.irecv(out, g, group=group)]
    for w in works:
        w.wait()
    return out.to(x.device)


def chain_mean(x, dim=None, keepdim=False):
    """Mean over the chain axis (``dim``; ``None``: every element, a 1-D
    per-chain tensor's mean) pooled over every rank of the active sharded
    run: ``x.mean(...)`` exactly when no run is sharded."""
    ax = active_axis()
    if ax is None:
        return x.mean() if dim is None else x.mean(dim=dim, keepdim=keepdim)
    s = x.sum() if dim is None else x.sum(dim=dim, keepdim=keepdim)
    n = x.numel() if dim is None else x.shape[dim]
    return all_reduce(s, ax.group) / float(n * ax.size)


def chain_sum(x, dim=0, keepdim=False):
    """Sum over the chain axis ``dim`` pooled over the active sharded run."""
    s = x.sum(dim=dim, keepdim=keepdim)
    ax = active_axis()
    return s if ax is None else all_reduce(s, ax.group)


def chain_any(x):
    """``x.any()`` over every rank's chains of the active sharded run (one
    small all-reduce): a 0-d bool tensor."""
    a = x.any()
    ax = active_axis()
    if ax is None:
        return a
    return all_reduce(a.to(torch.int32), ax.group, dist.ReduceOp.MAX) > 0


def chain_all_gather(x, dim=0):
    """Every rank's block of the chain axis ``dim``, concatenated in rank
    order (``x`` itself when no run is sharded)."""
    ax = active_axis()
    return x if ax is None else all_gather(x, ax.group, ax.size, dim)


# ---------------------------------------------------------------------------
# tall data
# ---------------------------------------------------------------------------

class _CopyToGroup(torch.autograd.Function):
    """Identity forward; backward sums the gradient over the group, so a
    parameter replicated on every data rank gets the gradient of the sum of
    the ranks' terms."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g, ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Forward sums over the group; identity backward (each rank's term
    gets the value's gradient once)."""

    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def data_parallel_kernel(log_kernel_fn, data, mesh,
                         axis_name: str = DATA_AXIS):
    """A tall-data-parallel batched ``log_kernel(params)`` from
    ``log_kernel_fn(params, data) -> (c,)``: each rank evaluates its block
    of the observations (:func:`shard_data_axis`) and one all-reduce over
    the mesh's data axis sums the terms, for the value and, through
    autograd, the gradient (the parameters enter through an identity whose
    backward all-reduces, the value leaves through an all-reduce whose
    backward is the identity: differentiating through a plain all-reduce
    would scale each rank's gradient by the group size).

    **Contract.** ``log_kernel_fn`` must be additive over the observation
    axis: ``f(p, D) = prior(p) + sum_i l_i(p)``, and accept an empty block
    ``data[:0]`` (giving the prior). Summing ``f`` over R blocks would count
    the prior R times, so each rank subtracts ``(R-1)/R * f(p, data[:0])``
    first; the result is exact for such kernels. GSPMD in the JAX package
    partitions any kernel; this one does not (a kernel with a term that is
    not additive over observations, e.g. a likelihood normalised by the
    dataset's mean, is wrong here). Every rank of the data axis must call
    the kernel the same number of times: the ranks along it run the same
    chains on the same generator stream, which the samplers guarantee."""
    ax = mesh_axis(mesh, axis_name)
    if ax is None:
        raise ValueError(f"mesh has no {axis_name!r} axis")
    if ax.size == 1:
        return lambda params: log_kernel_fn(params, data)
    shard = shard_data_axis(data, mesh, axis_name)
    empty = tree_map(lambda t: t[:0] if t.ndim >= 1 else t, data)
    frac = (ax.size - 1) / ax.size

    def wrapped(params):
        p = _CopyToGroup.apply(params, ax.group)
        local = log_kernel_fn(p, shard) - frac * log_kernel_fn(p, empty)
        return _ReduceFromGroup.apply(local, ax.group)

    return wrapped

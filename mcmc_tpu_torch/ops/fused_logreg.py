"""Fused HMC trajectories for GLM posteriors and multivariate Gaussians
(PyTorch port of ``mcmc_tpu.ops.fused_logreg``; logistic regression is the
flagship).

Under plain tensor code each gradient of the GLM log-posterior writes the
``(n_chains, n_data)`` linear predictor to device memory between two large
matmuls. The fused trajectory runs all ``n_leap`` leapfrog steps for a tile
of chains in one CUDA kernel: positions, momenta and gradients stay on chip,
the design matrix is streamed in row tiles, and the linear predictor never
leaves the SM. Models padded to 128
columns run one block per chain tile (``csrc/fused_glm_body.cuh``); wider
ones, up to ``_cuda.CLUSTER_MAX_DIM_PADDED`` (1,024) columns, a cluster of
blocks, one per 128-column panel, that sum the linear predictor through
distributed shared memory (``csrc/fused_glm_wide_body.cuh``); wider still, a
cluster of blocks that splits each gradient into two passes, the first
over row tiles (eta, the link, bf16 r to device memory), the second over
column panels, each pass's operand multicast to the cluster's blocks
(``csrc/fused_glm_xwide_body.cuh``). The kernels take every
width the JAX package pads to, any multiple of 128: only device memory
limits it.

Links: the five built in (logistic, poisson, linear, probit and
:func:`studentt_link`) run from the package's kernel library, chosen at run
time by their code. Any other callable ``link(eta, y) -> (mu_eff,
ll_terms)``, written in torch, runs on the card too, as the JAX package's
Pallas kernel runs any ``jnp`` link: the factories trace it with
:func:`mcmc_tpu_torch.ops.link_codegen.trace_link` into a CUDA functor when
their data lies on the card, and :func:`mcmc_tpu_torch.ops._cuda.build_link`
compiles the body the width needs on it, once per link and body, into
``build/mcmc_tpu_torch/link-<hash>.so`` (nvcc, 10-20 s at first
use). A link outside the tracer's op table (a reduction, a view, a captured
tensor with elements, data-dependent control flow) raises
``NotImplementedError`` naming the op, at the factory, before any launch.

Precision contract (the JAX package's): matmuls take bf16 operands — the
position rounded to bf16 before ``eta = z X^T`` and the residual rounded to
bf16 before ``g = r X`` — with f32 accumulation; positions, momenta and the
potential are f32. The potential the trajectory returns is computed from the
bf16-path ``eta``, as the Pallas kernel's is.

**Deviation** (from the JAX package's ``make_fused_hmc_step``): the step's
accept test and stored potential use one f32 pass at the end position
(``reference_potential``, the function ``init`` uses, with TF32 off), not
the trajectory's bf16-path potential. The JAX step mixes the two (an f32
potential at the start, bf16-path ones after), which differ by up to 0.5 on
the flagship posterior (``tests/test_fused_logreg.py:48-49``), so its
Metropolis test does not target the f32 density its docstring promises.

**Deviation** (a callable link that restates a built-in one): in the JAX
package such a callable reproduces the built-in link bit for bit
(``tests/test_fused_logreg.py:189-209``); here it does not, for two reasons.
On the CPU the built-in links with terms ``y eta - A(eta)`` sum a chain's
log-likelihood as ``eta @ (w * y) - A(eta) @ w`` (two products, few passes
over ``eta``) where a callable's is ``ll_terms @ w``: z and p are the same
bits, U differs in its last bits (the logistic hook against ``"logistic"``:
at most 1.9e-7 relative, about two units in the last place, on models of
10 to 300 columns and 64 to 1,000 rows; held to 1e-6 by
``tests/test_torch_fused_logreg.py``). On the card the built-in links'
exponential and quotients are the fast intrinsics (``__expf``,
``__fdividef``) where a traced link's are the accurate ones torch's are held
to: the hook differs from ``"logistic"`` by up to 1.3e-5 in z at 16,384
chains (measured on an NVIDIA H100; ``tests/test_torch_kernels_cuda.py``
holds it to 1e-3, and all but one element in 100,000 to 1e-4), not
bit-equal.

:func:`make_fused_trajectory_rt` is the same trajectory with the step size
and a diagonal inverse mass given at call time (the same kernel, with the
step size read from device memory). The Gaussian family
(:func:`make_fused_gaussian_trajectory`, ``csrc/fused_gaussian_trajectory.cu``)
is all f32: its gradient is one product of the chain tile with the precision
matrix, which the kernel keeps in registers for the whole trajectory at 128
padded columns and streams from L2 at 256 to 1,024
(``csrc/fused_gaussian_trajectory_wide.cu``), as f32 FMAs. Past 1,024
(``csrc/fused_gaussian_trajectory_xwide.cu``) its products run on the
tensor cores in 3xTF32, each f32 operand split into a TF32 high and low
part and three TF32 products summed in f32, over blocks of 128 chains and
128-column slices on a grid of one wave (:func:`gaussian_xwide_grid`): an
f32-accurate product, as the TPU kernel's is a 3-pass bf16 decomposition
(``mcmc_tpu/ops/fused_logreg.py:344-350``), but not the plain version's bits
even on a diagonal precision (a Deviation: the card's tests hold both to the
plain version in float64). The plain version stays f32 at the "highest"
matmul precision.
The bodies past 1,024 columns take a workspace in device memory, which the
wrappers allocate with ``torch.empty``; when the card has no room, the error
names the bytes.

On a CPU tensor a trajectory runs its plain PyTorch version
(:func:`_fused_trajectory_plain`, :func:`_fused_gaussian_trajectory_plain`);
on a CUDA tensor it launches the kernel or raises. Factories and entry points
put their tensors on the card unless the caller passes ``device="cpu"`` or
CPU tensors (:func:`mcmc_tpu_torch.samplers._resolve.resolve_device`).

The public entries are :func:`make_fused_hmc_step` and
:func:`make_fused_gaussian_hmc_step`, batched HMC transitions for
``(n_chains, dim)`` chain blocks with the semantics of
:func:`mcmc_tpu_torch.hmc` (reference src/hmc.cpp:150-196: momentum refresh,
leapfrog, min(0.01, .) accept clamp, +inf guard).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import torch

from mcmc_tpu_torch.samplers._resolve import resolve_device

__all__ = ["FusedHMCState", "make_fused_trajectory", "make_fused_hmc_step",
           "make_fused_trajectory_rt", "make_fused_gaussian_trajectory",
           "make_fused_gaussian_hmc_step", "studentt_link",
           "fused_trajectory", "fused_trajectory_cuda",
           "fused_trajectory_rt", "fused_trajectory_rt_cuda",
           "fused_gaussian_trajectory", "fused_gaussian_trajectory_cuda"]

# data rows per tile of the kernel's streamed design matrix: the padded row
# count is a multiple of it (the JAX package pads to the TPU's 512)
ROW_TILE = 64


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class FusedHMCState(NamedTuple):
    position: torch.Tensor   # (n_chains, dim_padded) f32; padding columns zero
    potential: torch.Tensor  # (n_chains,) f32


_LINKS = ("logistic", "poisson", "linear", "probit")
# the kernel's link codes (csrc/fused_glm_trajectory.cu: enum Link)
_LINK_CODES = {"logistic": 0, "poisson": 1, "linear": 2, "probit": 3,
               "studentt": 4}

# f32 floor for probit tail probabilities: below eta ~ -11 the f32 normal
# CDF underflows; clipping makes ll finite with a capped tail penalty
# (log(1e-30) ~ -69) so far-tail proposals are strongly rejected instead of
# NaN-poisoning the trajectory.
_PROBIT_TINY = 1e-30


def _erf_poly(x):
    """erf via Abramowitz & Stegun 7.1.26 (exp-only, |error| <= 1.5e-7).
    The probit family uses this polynomial, not ``torch.erf``, in the
    kernel, its plain version and the reference potential alike, as the JAX
    package does: the approximated likelihood IS the model, which keeps the
    MH accept exact for it."""
    a1, a2, a3, a4, a5 = (0.254829592, -0.284496736, 1.421413741,
                          -1.453152027, 1.061405429)
    p = 0.3275911
    ax = torch.abs(x)
    t = 1.0 / (1.0 + p * ax)
    poly = t * (a1 + t * (a2 + t * (a3 + t * (a4 + t * a5))))
    y = 1.0 - poly * torch.exp(-ax * ax)
    return torch.sign(x) * y


def _softplus(x):
    # logaddexp(x, 0), the JAX package's softplus, as one fused operation
    return torch.logaddexp(x, x.new_zeros(()))


def _link_eval_fns(link):
    """Per-family ``(mu_eff, ll_rows)`` of the linear predictor ``eta``
    ``(n_chains, n_obs)``. ``mu_eff(eta, y)`` carries the gradient contract
    ``d ll / d eta = y - mu_eff`` — exactly the mean function for canonical
    links (logistic/poisson/linear); for the non-canonical ``probit`` and
    :func:`studentt_link` families ``mu_eff = y - score`` encodes the true
    score in the same slot. ``ll_rows(eta, y, w)`` is each chain's
    log-likelihood ``sum_i w_i ll_i`` (``w`` masks padded observations):
    the one definition of the density that the plain trajectory's
    potential and the step's f32 accept potential share. Where a family's
    terms are ``y eta - A(eta)`` the ``y eta`` part is one product with the
    weighted responses, so the row sum reads ``eta`` in few passes. A
    callable ``link(eta, y) -> (mu_eff, ll_terms)`` plugs any family
    written in torch into the same trajectory."""
    if callable(link):
        return (lambda eta, yv: link(eta, yv)[0],
                lambda eta, yv, w: link(eta, yv)[1] @ w)
    if link == "logistic":
        return (lambda eta, yv: torch.sigmoid(eta),
                lambda eta, yv, w: eta @ (w * yv) - _softplus(eta) @ w)
    if link == "poisson":
        return (lambda eta, yv: torch.exp(eta),
                lambda eta, yv, w: eta @ (w * yv) - torch.exp(eta) @ w)
    if link == "probit":
        def probit(eta):
            # stable Bernoulli-probit pieces: Phi clipped at the f32 floor
            phi = torch.exp(-0.5 * eta * eta) * (1.0 / math.sqrt(2.0 * math.pi))
            cdf = torch.clamp(
                0.5 * (1.0 + _erf_poly(eta * (1.0 / math.sqrt(2.0)))),
                _PROBIT_TINY, 1.0 - 1e-7)
            return phi, cdf

        def mu(eta, yv):
            # score phi/Phi for y=1, -phi/(1-Phi) for y=0 (inverse Mills)
            phi, cdf = probit(eta)
            return yv - (yv * phi / cdf - (1.0 - yv) * phi / (1.0 - cdf))

        def ll_rows(eta, yv, w):
            _phi, cdf = probit(eta)
            return (yv * torch.log(cdf)
                    + (1.0 - yv) * torch.log(1.0 - cdf)) @ w
        return mu, ll_rows
    return (lambda eta, yv: eta,
            lambda eta, yv, w: (-0.5 * (yv - eta) ** 2) @ w)


def studentt_link(nu: float = 4.0):
    """Student-t robust-regression link for the fused GLM trajectory:
    ``y | eta ~ t_nu(eta, 1)``. Returns a callable for the ``link=``
    parameter of :func:`make_fused_trajectory` and
    :func:`make_fused_hmc_step`. Score ``(nu+1)(y-eta)/(nu+(y-eta)^2)``
    is bounded — the robustness property — and is encoded in the
    ``mu_eff = y - score`` slot of the gradient contract. The callable
    carries ``builtin = ("studentt", nu)``, by which the CUDA kernel runs
    it as its built-in link 4 (``csrc/fused_glm_common.cuh``) rather than
    tracing it as it traces any other callable (module docstring)."""
    nu = float(nu)
    if not nu > 0.0:
        raise ValueError(f"nu must be positive, got {nu}")

    def link(eta, yv):
        r = yv - eta
        score = (nu + 1.0) * r / (nu + r * r)
        ll = -0.5 * (nu + 1.0) * torch.log1p(r * r / nu)
        return yv - score, ll

    link.builtin = ("studentt", nu)
    return link


def _link_code(link):
    """``(code, parameter)`` of a link the kernel has built in, or for any
    other callable ``(traced, 0.0)``: the link traced to a CUDA functor
    (:func:`mcmc_tpu_torch.ops.link_codegen.trace_link`, which raises
    ``NotImplementedError`` naming an op it cannot trace)."""
    name, param = getattr(link, "builtin", (link, 0.0))
    if callable(name):
        from mcmc_tpu_torch.ops import link_codegen
        return link_codegen.trace_link(name), 0.0
    if name not in _LINK_CODES:
        raise ValueError(f"link must be callable or one of {_LINKS}, got {link!r}")
    return _LINK_CODES[name], float(param)


def _prepare_link(link, device, dp):
    """On the card, trace a callable link and build its library for the
    body of width ``dp`` now, so that a link the kernel cannot run fails at
    the factory, before any launch; nothing to do on the CPU, where the
    plain version runs the callable."""
    if device.type != "cuda":
        return
    from mcmc_tpu_torch.ops import _cuda

    code, _ = _link_code(link)
    if not isinstance(code, int):
        _cuda.build_link(code.source, dp)


def _fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, step_size, n_leap,
                            link, inv_mass=None):
    """Plain PyTorch version of the fused trajectory kernel, with its
    signature and its rounding points: ``z`` and ``p`` ``(n_chains, Dp)``
    f32, ``Xb`` ``(Np, Dp)`` bf16, ``y`` and ``mask`` ``(Np,)`` f32;
    ``step_size`` a float or a 0-d f32 tensor; ``inv_mass`` ``None`` or a
    ``(Dp,)`` f32 diagonal inverse mass of the drift. Returns
    ``(z_new, p_new, U_new)``."""
    mu_eff, ll_rows = _link_eval_fns(link)
    Xf = Xb.float()            # exact: every bf16 value is an f32 value
    half_eps = 0.5 * step_size
    eps = step_size

    def grad_of(z, want_u):
        eta = z.bfloat16().float() @ Xf.T
        r = (y - mu_eff(eta, y)) * mask
        g = r.bfloat16().float() @ Xf - z * inv_pv
        u = None
        if want_u:
            u = -(ll_rows(eta, y, mask) - 0.5 * (z * z).sum(dim=1) * inv_pv)
        return g, u

    # gradient hoisted across steps: n_leap + 1 evaluations
    u_out = None
    g, _ = grad_of(z, False)
    for k in range(n_leap):
        p = p + half_eps * g
        z = z + eps * (p if inv_mass is None else inv_mass * p)
        g, u_out = grad_of(z, k == n_leap - 1)
        p = p + half_eps * g
    return z, p, u_out


def _misaligned(t):
    """Whether a tensor with a dimension starts at an address that is no
    multiple of 16: the kernels read their operands in 16-byte pieces."""
    return bool(t.ndim) and t.data_ptr() % 16 != 0


def _check_width(what, dp):
    """Raise unless the kernels take a model padded to ``dp`` columns."""
    from mcmc_tpu_torch.ops import _cuda

    if not _cuda.takes_dim_padded(dp):
        raise ValueError(
            f"{what} kernel takes dim_padded a multiple of 128; got {dp}")


def _workspace(what, nbytes, dev):
    """``nbytes`` of scratch on ``dev`` for a body past 1,024 columns; when
    the card has no room, the error names the bytes."""
    try:
        return torch.empty((int(nbytes),), dtype=torch.uint8, device=dev)
    except torch.OutOfMemoryError as e:
        raise torch.OutOfMemoryError(
            f"{what} kernel needs {int(nbytes)} bytes of device memory for "
            f"its workspace: {e}") from e


def _check_tensors(what, dev, expect):
    """Raise unless ``dev`` is a CUDA device and every ``(tensor, dtype,
    shape)`` of ``expect`` is contiguous, of that dtype and shape, on it."""
    if dev.type != "cuda":
        raise ValueError(f"{what} kernel takes CUDA tensors; got {dev}")
    for t, dt, shape in expect:
        if t.device != dev or t.dtype != dt or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"{what} kernel takes contiguous {dt} {shape} on "
                f"{dev}; got {t.dtype} {tuple(t.shape)} on {t.device}")
        if _misaligned(t):
            raise ValueError(
                f"{what} kernel reads its operands in 16-byte pieces; got a "
                f"{tuple(t.shape)} tensor at an address that is no multiple "
                "of 16 (a view into a larger tensor: pass a copy)")


def _eps_on_device(eps, dev):
    """The step size as a 0-d f32 tensor on ``dev``; a tensor already there
    is used as is, without a host synchronisation."""
    if torch.is_tensor(eps):
        if eps.device != dev or eps.numel() != 1:
            raise ValueError(f"eps must be one value on {dev}; got "
                             f"{tuple(eps.shape)} on {eps.device}")
        return eps.to(torch.float32).reshape(()).contiguous()
    return torch.full((), float(eps), dtype=torch.float32, device=dev)


def _launch_glm(z, p, Xb, y, mask, inv_pv, n_leap, link, step_size=None,
                eps=None, inv_mass=None):
    """Check the operands and launch the GLM trajectory: with ``step_size``
    (a float) its fixed-step entry, with ``eps`` (a 0-d device tensor) and
    ``inv_mass`` its run-time-parameter entry; a built-in link from the
    package's library (``csrc/fused_glm_trajectory.cu``), a traced one from
    its own (:func:`mcmc_tpu_torch.ops._cuda.build_link`)."""
    code, link_param = _link_code(link)
    from mcmc_tpu_torch.ops import _cuda

    n_chains, dp = z.shape
    n_rows = Xb.shape[0]
    dev = z.device
    _check_width("fused trajectory", dp)
    expect = [(z, torch.float32, (n_chains, dp)),
              (p, torch.float32, (n_chains, dp)),
              (Xb, torch.bfloat16, (n_rows, dp)),
              (y, torch.float32, (n_rows,)),
              (mask, torch.float32, (n_rows,))]
    if eps is not None:
        expect += [(eps, torch.float32, ()), (inv_mass, torch.float32, (dp,))]
    _check_tensors("fused trajectory", dev, expect)
    if n_rows % ROW_TILE or n_chains < 1 or int(n_leap) < 1:
        raise ValueError(
            f"fused trajectory kernel takes a row count that is a multiple "
            f"of {ROW_TILE}, at least one chain and one leapfrog; got "
            f"{n_rows}, {n_chains}, {n_leap}")
    traced = not isinstance(code, int)
    xwide = _cuda.glm_body(dp) == "two-pass"
    lib = _cuda.build_link(code.source, dp) if traced \
        else _cuda.load()
    # a traced link's entries take no link code and parameter
    link_args = () if traced else (code, link_param)
    z_out = torch.empty_like(z)
    p_out = torch.empty_like(p)
    u_out = torch.empty((n_chains,), dtype=torch.float32, device=dev)
    work = ()
    if xwide:
        # the two-pass body's workspace, the last argument before the stream
        size = lib.traced_glm_workspace_bytes if traced \
            else lib.fused_glm_xwide_workspace_bytes
        ws = _workspace("fused trajectory", size(n_chains, n_rows, dp), dev)
        work = (ws.data_ptr(),)
    ptrs = (z.data_ptr(), p.data_ptr(), Xb.data_ptr(), y.data_ptr(),
            mask.data_ptr(), z_out.data_ptr(), p_out.data_ptr(),
            u_out.data_ptr())
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if eps is None:
            launch = lib.traced_glm_launch if traced \
                else lib.fused_glm_xwide_trajectory_launch if xwide \
                else lib.fused_glm_trajectory_launch
            rc = launch(*ptrs, n_chains, n_rows, dp, int(n_leap),
                        0.5 * step_size, float(step_size), float(inv_pv),
                        *link_args, *work, stream)
        else:
            launch = lib.traced_glm_rt_launch if traced \
                else lib.fused_glm_xwide_trajectory_rt_launch if xwide \
                else lib.fused_glm_trajectory_rt_launch
            rc = launch(*ptrs, eps.data_ptr(), inv_mass.data_ptr(), n_chains,
                        n_rows, dp, int(n_leap), float(inv_pv), *link_args,
                        *work, stream)
    if rc != 0:
        errors = lib.traced_glm_error_string if traced \
            else lib.fused_glm_error_string
        raise RuntimeError("fused trajectory kernel launch failed: "
                           + errors(rc).decode())
    return z_out, p_out, u_out


def fused_trajectory_cuda(z, p, Xb, y, mask, inv_pv, step_size, n_leap,
                          link):
    """Launch the fused trajectory kernel (``csrc/fused_glm_body.cuh``,
    ``csrc/fused_glm_wide_body.cuh`` or ``csrc/fused_glm_xwide_body.cuh`` by
    width, on a built-in or a traced link) on
    the card: same signature and result as
    :func:`_fused_trajectory_plain` with a float ``step_size`` and no
    ``inv_mass``. Counts its launches in ``fused_trajectory_cuda.launches``."""
    out = _launch_glm(z, p, Xb, y, mask, inv_pv, n_leap, link,
                      step_size=float(step_size))
    fused_trajectory_cuda.launches += 1
    return out


fused_trajectory_cuda.launches = 0


def fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps, n_leap, link,
                             inv_mass):
    """Launch the same kernel through its run-time-parameter entry: ``eps``
    a float or a 0-d f32 tensor on the card (read by the kernel from device
    memory, so an adapted step never synchronises with the host),
    ``inv_mass`` a ``(Dp,)`` f32 row. Same result as
    :func:`_fused_trajectory_plain` with ``inv_mass``. Counts its launches in
    ``fused_trajectory_rt_cuda.launches``."""
    out = _launch_glm(z, p, Xb, y, mask, inv_pv, n_leap, link,
                      eps=_eps_on_device(eps, z.device), inv_mass=inv_mass)
    fused_trajectory_rt_cuda.launches += 1
    return out


fused_trajectory_rt_cuda.launches = 0


def fused_trajectory(z, p, Xb, y, mask, inv_pv, step_size, n_leap, link):
    """The fused trajectory on the tensors' device: the plain version for
    CPU tensors, the kernel for CUDA tensors."""
    if z.device.type == "cpu":
        return _fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, step_size,
                                       n_leap, link)
    if z.device.type == "cuda":
        return fused_trajectory_cuda(z, p, Xb, y, mask, inv_pv, step_size,
                                     n_leap, link)
    raise ValueError(f"no fused trajectory for device {z.device}")


def fused_trajectory_rt(z, p, Xb, y, mask, inv_pv, eps, n_leap, link,
                        inv_mass):
    """The run-time-parameter trajectory on the tensors' device: the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if z.device.type == "cpu":
        return _fused_trajectory_plain(z, p, Xb, y, mask, inv_pv, eps, n_leap,
                                       link, inv_mass)
    if z.device.type == "cuda":
        return fused_trajectory_rt_cuda(z, p, Xb, y, mask, inv_pv, eps,
                                        n_leap, link, inv_mass)
    raise ValueError(f"no fused trajectory for device {z.device}")


def _padded_glm(X, y, device):
    """``(Xb, y, mask, dim)``: X zero-padded to ``(Np, Dp)`` in bf16, y and
    the row mask zero-padded to ``(Np,)``."""
    X = torch.as_tensor(X, dtype=torch.float32, device=device)
    y = torch.as_tensor(y, dtype=torch.float32, device=device)
    n_data, dim = X.shape
    Np = _round_up(n_data, ROW_TILE)
    Dp = _round_up(dim, 128)
    Xp = torch.zeros((Np, Dp), dtype=torch.float32, device=device)
    Xp[:n_data, :dim] = X
    yrow = torch.zeros((Np,), dtype=torch.float32, device=device)
    yrow[:n_data] = y
    mask = torch.zeros((Np,), dtype=torch.float32, device=device)
    mask[:n_data] = 1.0
    return Xp.to(torch.bfloat16), yrow, mask, dim


def make_fused_trajectory(X, y, prior_scale: float, step_size: float,
                          n_leap: int, block_chains: int = 256,
                          link="logistic", device=None):
    """Build ``traj(z, p) -> (z_new, p_new, U_new)`` over padded tensors.

    ``X`` is (n_data, dim); internally padded to ``(Np, Dp)``, ``Dp =
    round_up(dim, 128)`` as in the JAX package and ``Np`` a multiple of the
    kernel's row tile, with a row mask so padded data rows contribute
    exactly zero to both gradient and log-density. ``link`` selects the GLM
    family (or is a callable ``link_fn(eta, y) -> (mu, ll_terms)``, see
    :func:`_link_eval_fns`; on the card it is traced and built here, module
    docstring). ``device`` defaults to ``X``'s when it is a tensor, else the
    card. ``block_chains`` is kept from the JAX package's API: the chain
    count must be a multiple of it; the kernel tiles chains its own way."""
    if not callable(link) and link not in _LINKS:
        raise ValueError(f"link must be callable or one of {_LINKS}, got {link!r}")
    if int(n_leap) < 1:
        raise ValueError(f"n_leap must be >= 1, got {n_leap}")
    device = resolve_device(device, X)
    Xb, yrow, mask, dim = _padded_glm(X, y, device)
    inv_pv = 1.0 / (prior_scale * prior_scale)
    _prepare_link(link, device, Xb.shape[1])

    def traj(z, p):
        n_chains = z.shape[0]
        if n_chains % block_chains != 0:
            raise ValueError(
                f"n_chains={n_chains} must be a multiple of "
                f"block_chains={block_chains}"
            )
        return fused_trajectory(z, p, Xb, yrow, mask, inv_pv, step_size,
                                n_leap, link)

    traj.dim = dim
    traj.dim_padded = Xb.shape[1]
    # the padded operands, for calling the kernel and its plain version
    # directly (tests, chip_smoke.py)
    traj.Xb, traj.y, traj.mask, traj.inv_pv = Xb, yrow, mask, inv_pv
    return traj


def make_fused_hmc_step(X, y, prior_scale=10.0, step_size=0.01, n_leap=4,
                        block_chains: int = 256, link="logistic",
                        device=None):
    """Batched HMC transition ``step(gen, state) -> (state, info)`` with the
    trajectory fused; each transition draws its momenta and uniforms for all
    chains from the one ``torch.Generator`` ``gen``. ``step.init(positions)``
    pads ``(n_chains, dim)`` positions and computes their f32 potential, the
    same function (``step.reference_potential``) that gives each proposal's
    potential for the accept test."""
    device = resolve_device(device, X)
    traj = make_fused_trajectory(X, y, prior_scale, step_size, n_leap,
                                 block_chains, link, device)
    dim, Dp = traj.dim, traj.dim_padded

    X32 = torch.as_tensor(X, dtype=torch.float32, device=device)
    y32 = torch.as_tensor(y, dtype=torch.float32, device=device)
    inv_pv = 1.0 / (prior_scale * prior_scale)
    _mu_eff, ll_rows = _link_eval_fns(link)
    w1 = torch.ones_like(y32)

    def reference_potential(zp):
        # the f32 density (TF32 off), the plain trajectory's ll_rows for
        # every link (incl. callables): the potential at init and at every
        # accept test (module docstring, Deviation)
        z = zp[:, :dim]
        prev = torch.get_float32_matmul_precision()
        torch.set_float32_matmul_precision("highest")
        try:
            ll = ll_rows(z @ X32.T, y32, w1)
        finally:
            torch.set_float32_matmul_precision(prev)
        return -(ll - 0.5 * (z ** 2).sum(dim=1) * inv_pv)

    def init(positions):
        positions = torch.as_tensor(positions, dtype=torch.float32,
                                    device=device)
        zp = torch.zeros((positions.shape[0], Dp), dtype=torch.float32,
                         device=device)
        zp[:, :dim] = positions
        return FusedHMCState(position=zp, potential=reference_potential(zp))

    col_mask = (torch.arange(Dp, device=device) < dim).to(torch.float32)

    def step(gen, state: FusedHMCState):
        n_chains = state.position.shape[0]
        p0 = torch.randn((n_chains, Dp), generator=gen, dtype=torch.float32,
                         device=device) * col_mask
        prev_K = 0.5 * (p0 * p0).sum(dim=1)

        z_new, p_new, _traj_U = traj(state.position, p0)
        # the accept potential: one f32 pass at the end position, not the
        # trajectory's bf16-path U (module docstring, Deviation)
        prop_U = reference_potential(z_new)
        prop_U = torch.where(torch.isfinite(prop_U), prop_U, torch.inf)
        prop_K = 0.5 * (p_new * p_new).sum(dim=1)

        comp = torch.clamp_max(-(prop_U + prop_K) + (state.potential + prev_K),
                               0.01)
        u = torch.rand((n_chains,), generator=gen, dtype=torch.float32,
                       device=device)
        accepted = u < torch.exp(comp)

        new_state = FusedHMCState(
            position=torch.where(accepted[:, None], z_new, state.position),
            potential=torch.where(accepted, prop_U, state.potential),
        )
        return new_state, {"accepted": accepted}

    step.init = init
    step.reference_potential = reference_potential
    step.dim = dim
    step.dim_padded = Dp
    return step


# ---------------------------------------------------------------------------
# Runtime-parameter fused trajectory: the step size and a diagonal inverse
# mass arrive at call time, so adaptive samplers can drive the fused GLM
# leapfrog with parameters adapted on the device.
# ---------------------------------------------------------------------------

def make_fused_trajectory_rt(X, y, prior_scale: float, n_leap: int,
                             block_chains: int = 256, link="logistic",
                             device=None):
    """Like :func:`make_fused_trajectory` but ``traj(z, p, eps, inv_mass)``
    takes the step size (a float, or a 0-d f32 tensor on the device, which
    the kernel reads there) and a ``(Dp,)`` diagonal inverse mass at call
    time: ``z += eps * inv_mass * p`` drift, kicks unchanged. With
    ``inv_mass = 1`` and the same step it returns the bits of
    :func:`make_fused_trajectory`'s. A callable ``link`` is traced and
    built here when the data lies on the card."""
    if not callable(link) and link not in _LINKS:
        raise ValueError(f"link must be callable or one of {_LINKS}, got {link!r}")
    if int(n_leap) < 1:
        raise ValueError(f"n_leap must be >= 1, got {n_leap}")
    device = resolve_device(device, X)
    Xb, yrow, mask, dim = _padded_glm(X, y, device)
    Dp = Xb.shape[1]
    inv_pv = 1.0 / (prior_scale * prior_scale)
    _prepare_link(link, device, Dp)

    def traj(z, p, eps, inv_mass):
        n_chains = z.shape[0]
        if n_chains % block_chains != 0:
            raise ValueError(
                f"n_chains={n_chains} must be a multiple of "
                f"block_chains={block_chains}"
            )
        im = torch.as_tensor(inv_mass, dtype=torch.float32,
                             device=device).reshape(Dp)
        return fused_trajectory_rt(z, p, Xb, yrow, mask, inv_pv, eps, n_leap,
                                   link, im)

    traj.dim = dim
    traj.dim_padded = Dp
    traj.Xb, traj.y, traj.mask, traj.inv_pv = Xb, yrow, mask, inv_pv
    return traj


# ---------------------------------------------------------------------------
# Fused multivariate-Gaussian trajectory: U(z) = (z-m)^T P (z-m) / 2. The
# gradient is one (chains, Dp) x (Dp, Dp) f32 product per leapfrog step; the
# whole n_leap trajectory stays on chip (P in registers, z and p likewise).
# ---------------------------------------------------------------------------

def _check_live_dim(dim, dp):
    """The model's dimension of a padded Gaussian problem: ``dp`` when not
    given, else an int in ``1..dp``."""
    if dim is None:
        return dp
    if int(dim) != dim or not 1 <= int(dim) <= dp:
        raise ValueError(f"dim must be an int in 1..{dp}, got {dim!r}")
    return int(dim)


def _live_width(dim, dp):
    """The columns a fused Gaussian trajectory evolves when the model's
    dimension is ``dim``, the width the kernel runs: at 128 padded columns
    or fewer the smallest of ``_cuda.GAUSSIAN_LIVE_WIDTHS`` that holds it
    (``dp`` where none does); wider, ``dim`` rounded up to a multiple of
    ``_cuda.WIDE_LIVE_MULTIPLE`` (at most ``dp``); ``dp`` when ``dim`` is
    not given."""
    from mcmc_tpu_torch.ops import _cuda

    dim = _check_live_dim(dim, dp)
    if dp > 128:
        return min(_round_up(dim, _cuda.WIDE_LIVE_MULTIPLE), dp)
    return min([w for w in _cuda.GAUSSIAN_LIVE_WIDTHS if dim <= w <= dp],
               default=dp)


def _fused_gaussian_trajectory_plain(z, p, P, mean, eps, n_leap, dim=None):
    """Plain PyTorch version of the fused Gaussian trajectory kernel, with
    its signature: ``z``, ``p`` ``(n_chains, Dp)`` f32, ``P`` ``(Dp, Dp)``
    f32, ``mean`` ``(Dp,)`` f32, ``eps`` a float or a 0-d f32 tensor. Row
    vector times ``P``, f32 throughout. Returns ``(z_new, p_new, U_new)``.

    ``dim`` is the model's dimension (``Dp`` when not given). As in the
    kernel, only the live block evolves: the first :func:`_live_width`
    columns of ``z``, ``p`` and ``mean`` with that block of ``P``, and ``U``
    is that block's. The columns past it come out as they went in; the
    padding contract (``P`` the identity, ``z``, ``p`` and ``mean`` zero at
    and past ``dim``) keeps them zero."""
    dp = z.shape[1]
    live = _live_width(dim, dp)
    if live < dp:
        z_new, p_new, u = _fused_gaussian_trajectory_plain(
            z[:, :live], p[:, :live], P[:live, :live], mean[:live], eps,
            n_leap)
        return (torch.cat([z_new, z[:, live:]], dim=1),
                torch.cat([p_new, p[:, live:]], dim=1), u)
    half_eps = 0.5 * eps

    def grad_of(z):
        return -((z - mean) @ P)

    # boundary gradient hoisted: n_leap + 1 products, not 2 * n_leap
    g = grad_of(z)
    for _ in range(n_leap):
        p = p + half_eps * g
        z = z + eps * p
        g = grad_of(z)
        p = p + half_eps * g
    d = z - mean
    u = 0.5 * (d * (d @ P)).sum(dim=1)
    return z, p, u


def fused_gaussian_trajectory_cuda(z, p, P, mean, eps, n_leap, dim=None):
    """Launch the fused Gaussian trajectory kernel
    (``csrc/fused_gaussian_trajectory.cu``, ``_wide.cu`` or ``_xwide.cu`` by
    width) on the card: same signature and
    result as :func:`_fused_gaussian_trajectory_plain`. ``eps`` is a float
    or a 0-d f32 tensor on the card, read by the kernel from device memory.
    ``dim`` is the model's dimension (``Dp`` when not given): the kernel
    evolves only the live block, the first :func:`_live_width` columns, and
    copies the columns past it from the input, as the plain version does.
    Counts its launches in ``fused_gaussian_trajectory_cuda.launches``."""
    from mcmc_tpu_torch.ops import _cuda

    n_chains, dp = z.shape
    dev = z.device
    dim = _check_live_dim(dim, dp)
    _check_width("fused Gaussian trajectory", dp)
    eps = _eps_on_device(eps, dev)
    _check_tensors("fused Gaussian trajectory", dev,
                   [(z, torch.float32, (n_chains, dp)),
                    (p, torch.float32, (n_chains, dp)),
                    (P, torch.float32, (dp, dp)),
                    (mean, torch.float32, (dp,)),
                    (eps, torch.float32, ())])
    if n_chains < 1 or int(n_leap) < 1:
        raise ValueError(
            f"fused Gaussian trajectory kernel takes at least one chain and "
            f"one leapfrog; got {n_chains}, {n_leap}")
    lib = _cuda.load()
    z_out = torch.empty_like(z)
    p_out = torch.empty_like(p)
    u_out = torch.empty((n_chains,), dtype=torch.float32, device=dev)
    args = (z.data_ptr(), p.data_ptr(), P.data_ptr(), mean.data_ptr(),
            eps.data_ptr(), z_out.data_ptr(), p_out.data_ptr(),
            u_out.data_ptr(), n_chains, dp, dim, int(n_leap))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        if dp > _cuda.CLUSTER_MAX_DIM_PADDED:
            ws = _workspace("fused Gaussian trajectory",
                            lib.fused_gaussian_xwide_workspace_bytes(
                                n_chains, dim), dev)
            rc = lib.fused_gaussian_xwide_trajectory_launch(
                *args, ws.data_ptr(), stream)
        else:
            rc = lib.fused_gaussian_trajectory_launch(*args, stream)
    if rc != 0:
        raise RuntimeError("fused Gaussian trajectory kernel launch failed: "
                           + lib.fused_glm_error_string(rc).decode())
    fused_gaussian_trajectory_cuda.launches += 1
    return z_out, p_out, u_out


fused_gaussian_trajectory_cuda.launches = 0


def gaussian_xwide_grid(n_chains, dim):
    """The grid the fused Gaussian trajectory kernel launches past 1,024
    padded columns on the current card for ``n_chains`` chains of a
    ``dim``-dimensional model: a dict of ``blocks``, chain ``tiles``,
    ``per_tile`` (blocks a tile), ``capacity`` (the blocks the card runs at
    once, from the occupancy query) and ``waves``."""
    from mcmc_tpu_torch.ops import _cuda

    lib = _cuda.load()
    out = (ctypes.c_int * 5)()
    rc = lib.fused_gaussian_xwide_grid(int(n_chains), int(dim), out)
    if rc != 0:
        raise RuntimeError("fused Gaussian trajectory grid query failed: "
                           + lib.fused_glm_error_string(rc).decode())
    return dict(zip(("blocks", "tiles", "per_tile", "capacity", "waves"),
                    out))


def fused_gaussian_trajectory(z, p, P, mean, eps, n_leap, dim=None):
    """The fused Gaussian trajectory on the tensors' device: the plain
    version for CPU tensors, the kernel for CUDA tensors."""
    if z.device.type == "cpu":
        return _fused_gaussian_trajectory_plain(z, p, P, mean, eps, n_leap,
                                                dim)
    if z.device.type == "cuda":
        return fused_gaussian_trajectory_cuda(z, p, P, mean, eps, n_leap, dim)
    raise ValueError(f"no fused Gaussian trajectory for device {z.device}")


def make_fused_gaussian_trajectory(precision, mean=None, step_size=0.1,
                                   n_leap=4, block_chains: int = 256,
                                   device=None):
    """Build ``traj(z, p, eps=None) -> (z_new, p_new, U_new)`` for a
    multivariate Gaussian target ``N(mean, P^{-1})`` given its precision
    matrix ``P``; ``eps`` overrides ``step_size`` for one call (a float or a
    0-d tensor on the device).

    ``precision`` is (dim, dim) SPD (or a (dim,) diagonal); padded to a
    multiple of 128 with identity on the padded diagonal so padded
    coordinates stay decoupled (their positions never feed back into real
    coordinates and contribute zero to U because z starts 0 there and the
    momentum is masked by the caller, matching :func:`make_fused_hmc_step`'s
    column mask convention). ``device`` defaults to ``precision``'s when it
    is a tensor, else the card, which takes any dimension its memory
    holds."""
    if int(n_leap) < 1:
        raise ValueError(f"n_leap must be >= 1, got {n_leap}")
    device = resolve_device(device, precision)
    P = torch.as_tensor(precision, dtype=torch.float32, device=device)
    if P.ndim == 1:
        P = torch.diag(P)
    dim = P.shape[0]
    Dp = _round_up(dim, 128)
    eps_default = float(step_size)

    Pp = torch.eye(Dp, dtype=torch.float32, device=device)
    Pp[:dim, :dim] = P
    m_row = torch.zeros((Dp,), dtype=torch.float32, device=device)
    if mean is not None:
        m_row[:dim] = torch.as_tensor(mean, dtype=torch.float32,
                                      device=device)

    def traj(z, p, eps=None):
        n_chains = z.shape[0]
        if n_chains % block_chains != 0:
            raise ValueError(
                f"n_chains={n_chains} must be a multiple of "
                f"block_chains={block_chains}"
            )
        return fused_gaussian_trajectory(
            z, p, Pp, m_row, eps_default if eps is None else eps, n_leap, dim)

    traj.dim = dim
    traj.dim_padded = Dp
    # the padded operands, for calling the kernel and its plain version
    # directly (tests, chip_smoke.py)
    traj.P, traj.mean = Pp, m_row
    return traj


def make_fused_gaussian_hmc_step(precision, mean=None, step_size=0.1,
                                 n_leap=4, block_chains: int = 256,
                                 step_jitter: float = 0.2, device=None):
    """Batched HMC transition for a multivariate-Gaussian target with the
    trajectory fused (same loop contract as :func:`make_fused_hmc_step`).

    ``step_jitter=j`` draws the per-draw step size uniformly in
    ``step_size * [1 - j, 1 + j]`` (shared across chains, one scalar on the
    device that the kernel reads there). On an exactly quadratic target this
    is REQUIRED for ergodicity in practice: with fixed ``(step_size,
    n_leap)`` each coordinate's trajectory is a fixed rotation angle, and
    any scale near a 2-pi resonance of that angle stops mixing. Set 0.0 to
    disable.

    Each transition draws from ``gen`` in this order: the momenta
    ``(n_chains, Dp)``, the step-size jitter ``()``, the accept uniforms
    ``(n_chains,)``."""
    device = resolve_device(device, precision)
    traj = make_fused_gaussian_trajectory(precision, mean, step_size, n_leap,
                                          block_chains, device)
    dim, Dp = traj.dim, traj.dim_padded
    P, mean_v = traj.P[:dim, :dim], traj.mean[:dim]

    def reference_potential(zp):
        d = zp[:, :dim] - mean_v
        return 0.5 * (d * (d @ P.T)).sum(dim=1)

    def init(positions):
        positions = torch.as_tensor(positions, dtype=torch.float32,
                                    device=device)
        zp = torch.zeros((positions.shape[0], Dp), dtype=torch.float32,
                         device=device)
        zp[:, :dim] = positions
        return FusedHMCState(position=zp, potential=reference_potential(zp))

    col_mask = (torch.arange(Dp, device=device) < dim).to(torch.float32)

    def step(gen, state: FusedHMCState):
        n_chains = state.position.shape[0]
        p0 = torch.randn((n_chains, Dp), generator=gen, dtype=torch.float32,
                         device=device) * col_mask
        prev_K = 0.5 * (p0 * p0).sum(dim=1)

        # a 0-d tensor on the device: no host synchronisation per transition
        jitter = 2.0 * torch.rand((), generator=gen, dtype=torch.float32,
                                  device=device) - 1.0
        eps = step_size * (1.0 + step_jitter * jitter)
        z_new, p_new, prop_U = traj(state.position, p0, eps)
        prop_U = torch.where(torch.isfinite(prop_U), prop_U, torch.inf)
        prop_K = 0.5 * ((p_new * col_mask) ** 2).sum(dim=1)

        comp = torch.clamp_max(-(prop_U + prop_K) + (state.potential + prev_K),
                               0.01)
        u = torch.rand((n_chains,), generator=gen, dtype=torch.float32,
                       device=device)
        accepted = u < torch.exp(comp)

        new_state = FusedHMCState(
            position=torch.where(accepted[:, None], z_new, state.position),
            potential=torch.where(accepted, prop_U, state.potential),
        )
        return new_state, {"accepted": accepted}

    step.init = init
    step.reference_potential = reference_potential
    step.dim = dim
    step.dim_padded = Dp
    return step

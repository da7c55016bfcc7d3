"""The link tracer (``mcmc_tpu_torch.ops.link_codegen``) on the CPU.

A callable GLM link written in torch is traced with ``make_fx`` and emitted
as a C++ functor, which the CUDA kernels instantiate. No card or ``nvcc``
here: the emitted functors are compiled as host code with ``g++`` (as the
port's draw sink builds, ``mcmc_tpu_torch/runtime/drawsink.py``), through
``link_codegen.HOST_SHIM``, which maps the device intrinsics to the C
library, and each op of the tracer's table is held against torch on a grid
of ``(eta, y)``: the functor's residual ``y - mu`` and log-likelihood term
against the same callable run by torch, to rtol 2e-6 and atol 2e-6 (the C
library's and torch's special functions differ by an ulp or two, and the
grid's values are of order 1-100). Then the refusals, each a
``NotImplementedError`` that names the op, the exact constants, and the
generated translation unit's shape. The traced links themselves run through
the fused trajectory's plain version against the JAX package's Pallas
kernel in tests/test_torch_fused_logreg.py and tests/test_torch_fused_wide.py,
and the compiled kernels against the plain versions on the card in
tests/test_torch_kernels_cuda.py.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mcmc_tpu_torch.ops import _cuda, link_codegen as lc
from mcmc_tpu_torch.ops import fused_logreg as tfl


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cloglog(eta, y):
    m = torch.exp(eta)
    p = -torch.expm1(-m)
    score = y * m * torch.exp(-m) / p - (1 - y) * m
    return y - score, y * torch.log(p) - (1 - y) * m


# one link for each op of the table: (its name, the link). Each keeps its
# op's arguments in its domain on the grid (eta in [-3, 3], y in [0, 3]).
OP_LINKS = {
    "add": lambda e, y: (e + y, e + 2.5),
    "add_alpha": lambda e, y: (torch.add(e, y, alpha=0.3), e),
    "sub": lambda e, y: (e - y, 1.5 - e),
    "sub_alpha": lambda e, y: (torch.sub(e, y, alpha=1.7), y - e),
    "rsub": lambda e, y: (1 - e, 0.25 - y),
    "mul": lambda e, y: (e * y, 0.1 * e),
    "div": lambda e, y: (e / (y + 1.5), e / 3.0),
    "neg": lambda e, y: (-e, -y),
    "reciprocal": lambda e, y: (torch.reciprocal(e * e + 0.5), e),
    "pow2": lambda e, y: (e ** 2, y ** 3),
    "pow_half": lambda e, y: ((e * e + 1) ** 0.5, (y + 1) ** -0.5),
    "pow_neg": lambda e, y: ((e * e + 1) ** -1, (e * e + 1) ** -2),
    "pow_general": lambda e, y: ((e * e + 0.1) ** 1.37, (y + 0.5) ** -2.6),
    "pow_scalar_base": lambda e, y: (2.0 ** e, 0.7 ** e),
    "sqrt": lambda e, y: (torch.sqrt(e * e + 0.25), torch.sqrt(y)),
    "rsqrt": lambda e, y: (torch.rsqrt(e * e + 0.25), e),
    "abs": lambda e, y: (torch.abs(e), torch.abs(e - y)),
    "exp": lambda e, y: (torch.exp(e), torch.exp(-y)),
    "exp2": lambda e, y: (torch.exp2(e), e),
    "expm1": lambda e, y: (torch.expm1(e), torch.expm1(-y)),
    "log": lambda e, y: (torch.log(e * e + 0.1), torch.log(y + 0.5)),
    "log2": lambda e, y: (torch.log2(e * e + 0.1), e),
    "log10": lambda e, y: (torch.log10(e * e + 0.1), e),
    "log1p": lambda e, y: (torch.log1p(e * e), torch.log1p(y)),
    "sigmoid": lambda e, y: (torch.sigmoid(e), torch.sigmoid(-e)),
    "tanh": lambda e, y: (torch.tanh(e), e),
    "erf": lambda e, y: (torch.erf(e), e),
    "erfc": lambda e, y: (torch.erfc(e), e),
    "lgamma": lambda e, y: (torch.lgamma(e * e + 0.5), torch.lgamma(y + 1)),
    "sin_cos": lambda e, y: (torch.sin(e), torch.cos(e)),
    "softplus": lambda e, y: (F.softplus(e), y * e - F.softplus(e)),
    "softplus_beta": lambda e, y: (F.softplus(e, beta=2.0, threshold=3.0),
                                   F.softplus(e, beta=0.5)),
    "clamp": lambda e, y: (torch.clamp(e, -1.0, 2.0),
                           torch.clamp(e, min=-0.5)),
    "clamp_min_max": lambda e, y: (torch.clamp_min(e, 0.3),
                                   torch.clamp_max(e, -0.3)),
    "maximum_minimum": lambda e, y: (torch.maximum(e, y),
                                     torch.minimum(e, y)),
    "where_gt_lt": lambda e, y: (torch.where(e > 0, e, 0.5 * e),
                                 torch.where(e < y, y, e)),
    "where_ge_le": lambda e, y: (torch.where(e >= 1.0, 1.0, e),
                                 torch.where(e <= y, -e, e)),
    "where_eq_ne": lambda e, y: (torch.where(y == 1.0, e, -e),
                                 torch.where(y != 0.0, e, 2.0)),
    "logical": lambda e, y: (torch.where((e > 0) & (y > 1), e, 0.0),
                             torch.where(~(e > 0) | (y < 0.5), y, e)),
    "bool_arith": lambda e, y: ((e > 0) * e, (e > y).float()),
    "like": lambda e, y: (torch.full_like(e, 0.75) + torch.zeros_like(e),
                          torch.ones_like(y) - e),
    "to_f32": lambda e, y: (e.to(torch.float32) * 2, y.float()),
    "scalar_tensor": lambda e, y: (e * torch.tensor(0.1), e + torch.tensor(3)),
    "cloglog": _cloglog,
    "logistic_hook": lambda e, y: (torch.sigmoid(e),
                                   y * e - F.softplus(e)),
}

ETA = torch.linspace(-3.0, 3.0, 121)[:, None].expand(121, 7).contiguous()
Y = torch.tensor([0.0, 0.5, 1.0, 1.3, 2.0, 2.5, 3.0])
RTOL = ATOL = 2e-6

_HARNESS = """
namespace op_{i} {{
{functor}
}}
extern "C" void run_{i}(const float* eta, const float* y, int n, float* r,
                        float* ll, float* r_plain) {{
  for (int k = 0; k < n; ++k) {{
    r[k] = op_{i}::TracedLink::residual<true>(0.0f, eta[k], y[k], &ll[k]);
    r_plain[k] = op_{i}::TracedLink::residual<false>(0.0f, eta[k], y[k],
                                                       nullptr);
  }}
}}
"""


@pytest.fixture(scope="module")
def host_links(tmp_path_factory):
    """Every op link's functor compiled with ``g++`` into one library (one
    compiler run for the module); ``name -> run(eta, y) -> (r, ll,
    r without the log-likelihood)``."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    names = list(OP_LINKS)
    src = lc.HOST_SHIM + "".join(
        _HARNESS.format(i=i, functor=lc.trace_link(OP_LINKS[n]).source)
        for i, n in enumerate(names))
    d = tmp_path_factory.mktemp("links")
    (d / "links.cpp").write_text(src)
    r = subprocess.run(["g++", "-O2", "-fPIC", "-shared", "-std=c++17",
                        str(d / "links.cpp"), "-o", str(d / "links.so")],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    lib = ctypes.CDLL(str(d / "links.so"))

    def runner(i):
        fn = getattr(lib, f"run_{i}")
        fp = ctypes.POINTER(ctypes.c_float)

        def run(eta, y):
            eta = np.ascontiguousarray(eta, np.float32).ravel()
            y = np.ascontiguousarray(y, np.float32).ravel()
            out = [np.empty_like(eta) for _ in range(3)]
            fn(*(a.ctypes.data_as(fp) for a in (eta, y)), eta.size,
               *(a.ctypes.data_as(fp) for a in out))
            return out
        return run

    return {n: runner(i) for i, n in enumerate(names)}


@pytest.mark.parametrize("name", list(OP_LINKS))
def test_emitted_op_matches_torch(name, host_links):
    """The functor of each op's link, compiled as host code, against torch
    on the grid: the residual ``y - mu`` and the log-likelihood term, and
    the residual without the log-likelihood the same bits."""
    link = OP_LINKS[name]
    mu, ll = link(ETA, Y)
    mu, ll = (torch.broadcast_to(torch.as_tensor(t, dtype=torch.float32),
                                 ETA.shape) for t in (mu, ll))
    want_r = (Y - mu).numpy()
    r, got_ll, r_plain = host_links[name](ETA.numpy(),
                                          Y.expand_as(ETA).numpy())
    np.testing.assert_allclose(r.reshape(ETA.shape), want_r, rtol=RTOL,
                               atol=ATOL)
    np.testing.assert_allclose(got_ll.reshape(ETA.shape), ll.numpy(),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(r, r_plain)


@pytest.mark.parametrize("name", ["div", "reciprocal", "pow_neg", "rsqrt",
                                  "sigmoid", "softplus_beta", "cloglog"])
def test_quotients_emit_div_rn(name):
    """Every quotient of a traced link is the kernels' correctly rounded
    ``div_rn`` (``csrc/fused_glm_common.cuh``: no slow-path call), never
    CUDA's ``__fdiv_rn``; the host shim defines it as ``a / b``, so the
    functors above compile and match torch with it."""
    src = lc.trace_link(OP_LINKS[name]).source
    assert "div_rn(" in src and "__fdiv_rn" not in src
    assert "static inline float div_rn(float a, float b) { return a / b; }" \
        in lc.HOST_SHIM
    assert "div_rn(float a, float b)" in \
        (_cuda.CSRC / "fused_glm_common.cuh").read_text()


def test_op_table_is_covered():
    """Every aten op of the table that torch's front end reaches from the
    links above is traced by at least one of them (the comparisons,
    identities and Scalar overloads aside)."""
    seen = set()
    for link in OP_LINKS.values():
        seen.update(lc.trace_link(link).ops)
    for op in ("add.Tensor", "sub.Tensor", "rsub.Scalar", "mul.Tensor",
               "div.Tensor", "neg.default", "reciprocal.default",
               "pow.Tensor_Scalar", "pow.Scalar", "sqrt.default",
               "rsqrt.default", "abs.default", "exp.default",
               "expm1.default", "log.default", "log1p.default",
               "sigmoid.default", "tanh.default", "erf.default",
               "erfc.default", "lgamma.default", "softplus.default",
               "clamp.default", "clamp_min.default", "clamp_max.default",
               "maximum.default", "minimum.default", "where.self",
               "gt.Scalar", "ge.Scalar", "lt.Tensor", "le.Tensor",
               "eq.Scalar", "ne.Scalar", "full_like.default",
               "zeros_like.default", "ones_like.default",
               "scalar_tensor.default", "_to_copy.default"):
        assert f"aten.{op}" in seen, op


def test_constants_are_exact_f32():
    """A Python float is written as the hex-float literal of its f32 value;
    a captured 0-d tensor is folded to its value; non-finite values by
    their bits."""
    src = lc.trace_link(lambda e, y: (e * 0.1, e + torch.tensor(2.5))).source
    f32 = float(np.float32(0.1))
    assert f"{f32.hex()}f" in src and f"{2.5.hex()}f" in src
    assert lc._literal(float("inf")) == "__int_as_float(0x7f800000)"
    assert lc._literal(float("-inf")) == "(-__int_as_float(0x7f800000))"
    assert lc._literal(float("nan")) == "__int_as_float(0x7fc00000)"
    assert lc._literal(True) == "1.0f"


def test_trace_is_cached_and_keyed_by_source():
    """A callable is traced once; two callables with one body give one
    source, so they share one built library."""
    f = lambda e, y: (torch.sigmoid(e), y * e)  # noqa: E731
    g = lambda e, y: (torch.sigmoid(e), y * e)  # noqa: E731
    a, b = lc.trace_link(f), lc.trace_link(f)
    assert a is b
    c = lc.trace_link(g)
    assert c.ops == a.ops and c.digest == a.digest


def test_link_code_of_callables():
    """``_link_code``: the built-in links by their codes (Student-t by its
    ``builtin`` attribute), any other callable traced."""
    assert tfl._link_code("logistic") == (0, 0.0)
    assert tfl._link_code(tfl.studentt_link(3.0)) == (4, 3.0)
    code, param = tfl._link_code(_cloglog)
    assert isinstance(code, lc.TracedLink) and param == 0.0
    assert code.ops[0] == "aten.exp.default"
    # special functions: the residual's two exponentials, expm1 and
    # quotient; the log-likelihood's logarithm on top
    assert code.sfu == (4, 1)
    assert lc.trace_link(OP_LINKS["logistic_hook"]).sfu == (2, 2)


@pytest.mark.parametrize("wide", [False, True])
def test_generated_translation_unit(wide):
    """The translation unit a traced link builds from: the body its width
    needs, instantiated on the functor behind the library's launch
    signatures; its library's name hashes the source, so the two bodies of
    one link are two libraries and a second trace of it is the same."""
    dp = 256 if wide else 128
    src = _cuda.link_source(lc.trace_link(_cloglog).source, dp)
    header = "fused_glm_wide_body.cuh" if wide else "fused_glm_body.cuh"
    assert f'#include "{header}"' in src
    assert (_cuda.CSRC / header).exists()
    assert "struct TracedLink" in src and "switch" not in src
    for entry in ("traced_glm_launch", "traced_glm_rt_launch",
                  "traced_glm_error_string"):
        assert f'extern "C"' in src and entry in src
    ns = "glm_wide" if wide else "glm128"
    assert f"{ns}::launch<TracedLink, false>" in src
    assert f"{ns}::launch<TracedLink, true>" in src
    other = _cuda.link_source(lc.trace_link(_cloglog).source, 384 - dp)
    path = _cuda.link_library_path(src)
    assert path.name.startswith("link-") and path.suffix == ".so"
    assert path.parent == _cuda.BUILD_DIR
    assert path != _cuda.link_library_path(other)
    assert path == _cuda.link_library_path(
        _cuda.link_source(lc.trace_link(_cloglog).source, dp))
    # one library a body: every width the body runs shares its source
    assert src == _cuda.link_source(lc.trace_link(_cloglog).source,
                                    1024 if wide else 128)


def test_generated_translation_unit_past_1024():
    """Past 1,024 padded columns the traced link builds on the two-pass
    body: its entries take the body's workspace before the stream, and
    the unit exports the workspace's size; a library of its own."""
    src = _cuda.link_source(lc.trace_link(_cloglog).source, 1152)
    assert '#include "fused_glm_xwide_body.cuh"' in src
    assert (_cuda.CSRC / "fused_glm_xwide_body.cuh").exists()
    assert "glm_xwide::launch<TracedLink, false>" in src
    assert "glm_xwide::launch<TracedLink, true>" in src
    assert src.count("void* work, void* stream") == 2
    assert src.count("work, n_chains, n_rows, dim_padded, n_leap") == 2
    assert 'extern "C" long long traced_glm_workspace_bytes' in src
    assert "dim_padded > kMaxDimPadded" in src
    assert src == _cuda.link_source(lc.trace_link(_cloglog).source, 8192)
    assert [_cuda.glm_body(dp) for dp in (128, 256, 1024, 1152)] == \
        ["128", "cluster", "cluster", "two-pass"]
    for dp in (128, 1024):
        other = _cuda.link_source(lc.trace_link(_cloglog).source, dp)
        assert "work" not in other
        assert _cuda.link_library_path(src) != _cuda.link_library_path(other)


def _reduction(e, y):
    return e - e.sum(dim=-1, keepdim=True), e


def _view(e, y):
    return e + y.unsqueeze(0), e


OFFSET = torch.linspace(0.0, 1.0, 3)


def _captured(e, y):
    return e + OFFSET, e


def _control_flow(e, y):
    if (e > 0).all():
        return torch.sigmoid(e), e
    return e, e


def _read_back(e, y):
    return e * float(y.max()), e


def _to_f64(e, y):
    return e.double() * 2, e


@pytest.mark.parametrize("link,names", [
    (_reduction, "aten.sum"),
    (_view, "aten.unsqueeze"),
    (_captured, r"captured tensor of shape \(3,\)"),
    (_control_flow, "aten._local_scalar_dense"),
    (_read_back, "aten"),
    (lambda e, y: (e - (e @ y)[:, None], e), "aten.mv"),
    (lambda e, y: (e + y[0], e), "aten.select"),
    (_to_f64, "torch.float64"),
])
def test_refusals_name_the_op(link, names):
    """A link outside the table raises ``NotImplementedError`` naming the
    op and what a link must be; on the CPU the plain version still runs
    it (a reduction or a captured tensor of the data's length is a valid
    torch link there)."""
    with pytest.raises(NotImplementedError, match=names) as info:
        lc.trace_link(link)
    assert "elementwise in (eta, y)" in str(info.value)


def test_refusal_reaches_the_kernel_path():
    """On the kernel path the link is traced first: an untraceable callable
    raises ``NotImplementedError`` before any operand is checked, and a
    traceable one reaches the operand checks (CPU tensors refused)."""
    X = torch.randn(64, 10)
    traj = tfl.make_fused_trajectory(X, torch.rand(64), 10.0, 0.05, 2,
                                     block_chains=1, device="cpu")
    z = torch.zeros((2, 128))
    args = (traj.Xb, traj.y, traj.mask, traj.inv_pv, 0.05, 2)
    with pytest.raises(NotImplementedError, match="aten.sum"):
        tfl.fused_trajectory_cuda(z, z, *args, _reduction)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tfl.fused_trajectory_cuda(z, z, *args, _cloglog)
    # the CPU's plain version runs any callable
    zn, pn, un = traj(z, z.clone())
    assert bool(torch.isfinite(un).all())

"""The port's examples (``examples_torch/``) on the CPU.

(a) Each script has a JAX counterpart of the same name in ``examples/``;
by its syntax tree it imports no ``jax``, no ``mcmc_tpu`` and nothing of
``examples/`` (its ``_common`` is ``examples_torch/_common.py``, found
beside it), takes the shared command line (``--device``, ``--quick``) and
states its ``--quick`` cuts in its docstring. (b) The scripts whose quick
run is short run in this process with ``--device cpu --quick``; the last
line each prints parses as JSON and its figures pass the checks below at
the quick size (the CPU generator makes them the same every run). The
others take 1.5-11 s each on the CPU, past this file's budget together,
and are checked on the card by ``scripts/torch_examples_sweep.py``.
(c) Run without ``--device`` on a
machine without a card, a script raises torch's own error: it never falls
back to the CPU.
"""

import ast
import contextlib
import io
import json
import re
import runpy
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "examples_torch"
JAX = ROOT / "examples"
NAMES = sorted(p.stem for p in JAX.glob("*.py") if not p.name.startswith("_"))
PORT_NAMES = sorted(p.stem for p in PORT.glob("*.py")
                    if not p.name.startswith("_"))
# a truth check's bound in MC standard errors
SIGMAS = 5.0


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread for every test here: the tests run in several
    worker processes at once, and torch's default of a thread per core
    oversubscribes the CPU."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _imports(tree):
    """Every module name a syntax tree imports."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            yield node.module or ""


def _forbidden(module):
    top = module.split(".")[0]
    return top in ("jax", "jaxlib", "mcmc_tpu", "examples")


def test_common_imports_no_jax():
    """``examples_torch/_common.py`` imports neither JAX nor the JAX
    package, and sets ``--device`` to the card by default."""
    src = (PORT / "_common.py").read_text()
    assert not [m for m in _imports(ast.parse(src)) if _forbidden(m)]
    assert re.search(r'"--device", default="cuda"', src)


@pytest.mark.parametrize("name", NAMES)
def test_example_static(name):
    """The port's script of a JAX example: same name, no JAX, no
    ``examples/`` import, the shared command line, its quick cut
    stated."""
    assert PORT_NAMES == NAMES, (set(PORT_NAMES) ^ set(NAMES))
    src = (PORT / f"{name}.py").read_text()
    tree = ast.parse(src)
    mods = list(_imports(tree))
    bad = [m for m in mods if _forbidden(m)]
    assert not bad, f"{name} imports {bad}"
    assert "_common" in mods, f"{name} does not take examples_torch/_common"
    # nothing puts examples/ (whose _common switches JAX's platform) on the
    # path: _common resolves to the one beside the script
    assert "sys.path" not in src and "examples/_common" not in src
    assert "mcmc_tpu_torch" in " ".join(mods)
    calls = [n.func for n in ast.walk(tree) if isinstance(n, ast.Call)]
    setups = [f for f in calls
              if (isinstance(f, ast.Name) and f.id == "setup")
              or (isinstance(f, ast.Attribute) and f.attr == "setup")]
    assert setups, f"{name} never parses the shared command line"
    doc = ast.get_docstring(tree)
    assert doc and len(re.findall(r"^--quick: ", doc, re.M)) == 1, \
        f"{name}'s docstring states its --quick cuts in one line"


def test_readme_lists_every_example():
    """``examples_torch/README.md`` has one table row per script, with the
    JAX counterpart beside it."""
    text = (PORT / "README.md").read_text()
    for name in NAMES:
        assert re.search(rf"^\| `{name}\.py` \| `examples/{name}\.py` \|",
                         text, re.M), name


def run_example(name, *argv):
    """Run ``examples_torch/<name>.py`` in this process with ``argv``;
    return what it printed and its figures (its last line)."""
    saved_argv, saved_path = sys.argv, list(sys.path)
    saved_common = sys.modules.pop("_common", None)
    sys.argv = [str(PORT / f"{name}.py"), *argv]
    sys.path.insert(0, str(PORT))
    out = io.StringIO()
    try:
        with contextlib.redirect_stdout(out):
            runpy.run_path(str(PORT / f"{name}.py"), run_name="__main__")
    finally:
        sys.argv, sys.path[:] = saved_argv, saved_path
        sys.modules.pop("_common", None)
        if saved_common is not None:
            sys.modules["_common"] = saved_common
    lines = [ln for ln in out.getvalue().splitlines() if ln.strip()]
    return lines, json.loads(lines[-1])


def quick(name, *argv):
    return run_example(name, "--device", "cpu", "--quick", *argv)[1]


def within_mcse(f, sigmas=SIGMAS):
    z = [abs(m - e) / s for m, e, s in zip(f["mean"], f["exact_mean"],
                                           f["mcse"])]
    assert max(z) <= sigmas, z


@pytest.mark.parametrize("name", ["rwmh_normal_mean", "mala_normal",
                                  "hmc_normal", "nuts_normal"])
def test_quick_normal_models(name):
    """The reference library's samplers on the Gaussian models: the mean
    within 5 MC standard errors of the conjugate or closed-form posterior
    mean, an acceptance rate that moves."""
    f = quick(name)
    within_mcse(f)
    assert 0.1 < f["accept_rate"] <= 1.0
    if name == "nuts_normal":
        assert 1.0 <= f["mean_tree_depth"] <= 4.0


def test_quick_pt_mixture():
    """Tempering finds both modes: each mode's mean within 0.1 of (+-2,
    +-2), their balance within 0.15 of 0.5, every rung's swaps accepted
    at 0.2-0.7 and the ladder ending at temperature 1."""
    f = quick("pt_mixture")
    for key, t in (("mean_pos", 2.0), ("mean_neg", -2.0)):
        assert max(abs(v - t) for v in f[key]) <= 0.1
    assert abs(f["mode_balance"] - 0.5) <= 0.15
    assert all(0.2 <= a <= 0.7 for a in f["swap_accept_rate"])
    assert f["adapted_ladder"][-1] == 1.0


def test_quick_chees_logreg():
    """ChEES on the 25-feature logistic regression: the posterior mean
    correlated with the truth (0.7), split R-hat under 1.05 at 100 + 100
    draws and an adapted trajectory of at least one leapfrog."""
    f = quick("chees_logreg")
    assert f["corr_with_truth"] >= 0.7
    assert f["max_split_rhat"] <= 1.05
    assert f["mean_leapfrogs_per_draw"] >= 1.0
    assert 0.5 < f["accept_rate"] < 1.0


def test_quick_fused_glm_probit_plain_on_cpu():
    """The fused GLM path on CPU tensors runs K1's plain version: no K1
    launch on either link's 150 transitions, and both posterior means
    correlated with the truth (0.95)."""
    f = quick("fused_glm_probit")
    assert f["transitions_per_link"] == 150
    assert f["k1_launches"] == {"probit": 0, "studentt": 0}
    assert f["probit_corr"] >= 0.95 and f["studentt_corr"] >= 0.95
    assert 0.5 < f["probit_accept_rate"] <= 1.0


def test_quick_de_normal_mean():
    """DE's population mean within a quarter of the posterior sd of the
    conjugate mean (the population's members are coupled, so their MC
    standard error is optimistic)."""
    f = quick("de_normal_mean")
    assert abs(f["mean"][0] - f["exact_mean"][0]) <= 0.25 * f["posterior_sd"]
    assert 0.2 < f["accept_rate"] < 0.7


def test_quick_smc_mixture():
    """1,024 particles: the mode mass at +2 within 0.1 of 0.7 and log Z
    within 0.2 of its exact 0."""
    f = quick("smc_mixture")
    assert abs(f["mode_mass_pos"] - 0.7) <= 0.1
    assert abs(f["log_z"]) <= 0.2
    assert f["lambdas"][-1] == 1.0


def test_quick_stretch_correlated():
    """The untuned ensemble's covariance within 0.15 of the rho = 0.95
    truth after 400 sweeps."""
    f = quick("stretch_correlated")
    assert max(abs(a - b) for a, b in zip(f["cov"], f["true_cov"])) <= 0.15
    assert 0.5 < f["accept_rate"] < 0.9


def test_quick_demcz_smallpop():
    """Eight walkers in 20 dimensions move (1,000 sweeps are too few for
    the archive's geometry: the moments are the card's check)."""
    f = quick("demcz_smallpop")
    assert 0.1 < f["accept_rate"] < 0.5
    assert 0.3 < f["marginal_var"] < 1.7 and 0.3 < f["corr01"] < 1.0


def test_quick_checkpointed_run_resumes(tmp_path):
    """The chunked run's shape, its final state the last stored draw, the
    kept mean within 5 MC standard errors of the closed form; run again on
    the same directory it resumes to the same draws, bit for bit."""
    d = str(tmp_path / "ck")
    lines, f = run_example("checkpointed_run", "--device", "cpu", "--quick",
                           "--dir", d)
    assert f["draws_shape"] == [200, 8, 2] and f["final_equals_last_draw"]
    within_mcse(f)
    _lines2, f2 = run_example("checkpointed_run", "--device", "cpu",
                              "--quick", "--dir", d)
    assert f2 == f


def test_quick_sgld_logreg():
    """Every SGLD update finite; the mean within 0.1 of the truth."""
    f = quick("sgld_logreg")
    assert f["finite_update_rate"] == 1.0
    assert f["max_abs_mean_minus_truth"] <= 0.1


def test_quick_elliptical_gp():
    """Every ellipse draw accepted; the latent field within RMSE 0.7 of the
    truth (prior sd 1) and correlated with it (0.8)."""
    f = quick("elliptical_gp")
    assert f["accept_rate"] == 1.0
    assert f["rmse"] <= 0.7 and f["corr_with_truth"] >= 0.8


def test_quick_distributed_hmc_world_of_one():
    """Without ``--nproc`` the script runs a world of one in this process:
    the mean of N(2, I) within 0.1."""
    f = quick("distributed_hmc")
    assert f["world"] == 1 and f["n_chains"] == 16 and f["ranks_agree"]
    assert abs(f["mean"] - 2.0) <= 0.1 and f["accept_rate"] > 0.8


def test_no_silent_cpu():
    """Without ``--device`` a script asks for the card and, where there is
    none, raises torch's own error instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the script would run on it")
    with pytest.raises((AssertionError, RuntimeError),
                       match="CUDA|cuda|NVIDIA"):
        run_example("rwmh_normal_mean", "--quick")

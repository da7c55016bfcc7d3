"""Restartable sampling: chunked execution with the native draw sink; the
port's rendition of ``examples/checkpointed_run.py``. HMC (step 0.08, one
leapfrog) on the (mu, sigma) Gaussian model, 32 chains from (3, 3), 2000
draws in chunks of 500, the first 1000 discarded in the mean.

Kill this script at any point and re-run it: it resumes from the last
completed chunk and the final draws are bit-identical to an uninterrupted
run. The checkpoint lives in ``--dir`` (default: a directory of its own
under the system's temporary directory, one for each device and size).

--quick: 8 chains, 200 draws in chunks of 50.
"""

import pathlib
import tempfile

from _common import emit, mean_and_mcse, normal_scale_exact_mean, setup

args = setup(__doc__, add_args=lambda ap: ap.add_argument(
    "--dir", default=None, help="checkpoint directory"))
import numpy as np  # noqa: E402
import torch  # noqa: E402

from mcmc_tpu_torch import checkpoint, models  # noqa: E402
from mcmc_tpu_torch.integrators import grad_of  # noqa: E402
from mcmc_tpu_torch.samplers import common  # noqa: E402
from mcmc_tpu_torch.samplers.hmc import build_hmc_kernel  # noqa: E402

chains, n_draws, chunk = (8, 200, 50) if args.quick else (32, 2000, 500)
directory = args.dir or (pathlib.Path(tempfile.gettempdir())
                         / (f"mcmc_tpu_torch_checkpointed_run_"
                            f"{args.device.type}"
                            + ("_quick" if args.quick else "")))

x_data = 2.0 + 2.0 * np.random.default_rng(1).standard_normal(1000)
log_kernel = models.gaussian_mean_scale_model(x_data, device=args.device)

init, step = build_hmc_kernel(
    log_kernel, grad_of(log_kernel),
    common.make_spd(None, 2, torch.float32, args.device),
    step_size=0.08, n_leap_steps=1)
state0 = init(torch.tensor([3.0, 3.0], device=args.device).repeat(chains, 1))

runner = checkpoint.ChunkedRunner(step, lambda st: st.position, directory)
gen = torch.Generator(device=args.device).manual_seed(0)
final_state, draws, totals = runner.run(gen, state0, n_draws=n_draws,
                                        chunk_size=chunk)
kept = np.array(draws[n_draws // 2:], dtype=np.float64)
mean, mcse = mean_and_mcse(kept)
print("draws:", draws.shape, "(memmapped from the native sink)")
print("posterior mean:", mean.numpy())
print("checkpoint directory:", directory)
emit(draws_shape=list(draws.shape), mean=mean, mcse=mcse,
     exact_mean=normal_scale_exact_mean(x_data),
     accept_rate=float(np.asarray(totals["accepted"]).mean()) / n_draws,
     final_equals_last_draw=bool(np.array_equal(
         final_state.position.cpu().numpy(), np.asarray(draws[-1]))))

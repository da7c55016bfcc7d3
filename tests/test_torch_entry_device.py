"""``entry.dryrun_multichip``'s device rule on the CPU, with no process
started: like every entry point of the port it runs on the card unless it
is asked for another device, so with no ``device=`` (and no ``--device``
on its command line) its ranks are told ``cuda``, and ``cpu`` only when
asked. ``parallel.launch_local`` is replaced by a stub that records the
ranks' arguments and returns equal statistics for each."""

import pytest

import mcmc_tpu_torch.parallel as parallel
from mcmc_tpu_torch import entry


@pytest.fixture
def ranks(monkeypatch):
    """The argument lists ``dryrun_multichip`` hands ``launch_local``."""
    seen = []

    def launch_local(n, argv, timeout_s=None):
        seen.append(list(argv))
        return [{"nuts": {"mean": 0.5, "seconds": 0.1}} for _ in range(n)]

    monkeypatch.setattr(parallel, "launch_local", launch_local)
    return seen


@pytest.mark.parametrize("device,want", [(None, "cuda"), ("cpu", "cpu"),
                                         ("cuda", "cuda")])
def test_dryrun_multichip_device(ranks, device, want):
    """With no device the ranks run on the card; the CPU only when asked."""
    out = entry.dryrun_multichip(2, device)
    assert ranks == [["-m", "mcmc_tpu_torch.entry", "--dryrun-rank", want]]
    assert out["device"] == want and out["n_devices"] == 2 and out["ok"]


@pytest.mark.parametrize("flags,want", [([], "cuda"),
                                        (["--device", "cpu"], "cpu")])
def test_dryrun_multichip_command_line_device(ranks, capsys, flags, want):
    """``--dryrun-multichip N`` follows the same rule: the card without
    ``--device``."""
    assert entry._main(["--dryrun-multichip", "3", *flags]) == 0
    assert ranks[0][-1] == want
    assert f'"device": "{want}"' in capsys.readouterr().out

"""The port's control plane (``hbbft_tpu_torch/control/``) and its hooks in
the engine and QueueingHoneyBadger against the JAX package's.

Every case of the reference's ``tests/test_control.py`` runs in both
packages through :mod:`torch_twin`: the reference test's own
checks hold in each (the engine and QHB hooks' checkpoint detachment, the
``("batch_size", B)`` input, the controller's snapshot round trip, the
kill switch's bit-identical fixed-B replay among them), and the two runs'
controller decisions, B traces, series rows, Batches, driver reports,
tracker fingerprints and soak fingerprints are equal call for call, each
on its own package's ``MockBackend``.  The step-and-spike convergence case
runs behind ``-m slow``.
"""

import pytest

from torch_twin import RECORDED, TwinModule, behind_slow, twin

MOD = TwinModule("test_control.py", port_subs=[
    ("from tools.trace_report import", "from hbbft_tpu_torch.tools.trace_report import")],
    recorded=RECORDED + (({"hbbft_tpu": "tools.trace_report",
                           "hbbft_tpu_torch": "hbbft_tpu_torch.tools.trace_report"},
                          None, "diff_traffic"),))
#: the slowest case past the file's share of the suite's time (~4 s here)
SLOW = {"test_controller_converges_on_step_and_spike_traces"}
CASES = behind_slow([p for name in sorted(n for n in vars(MOD.copies["hbbft_tpu"])
                                          if n.startswith("test_"))
                     for p in MOD.params(name)], SLOW)


@pytest.mark.parametrize("name,kwargs", CASES)
def test_port_equals_the_reference(name, kwargs, tmp_path):
    twin(MOD, name, kwargs, tmp_path)


def test_controller_rides_the_snapshot_registry():
    """The three control modules are registered for snapshots in the
    reference's place and order."""
    from hbbft_tpu.utils import snapshot as ref
    from hbbft_tpu_torch.utils import snapshot as port

    want = [m.replace("hbbft_tpu.", "hbbft_tpu_torch.") for m in ref._STATE_MODULES]
    assert list(port._STATE_MODULES) == want
    assert [m for m in port._STATE_MODULES if ".control." in m] == [
        "hbbft_tpu_torch.control.slo", "hbbft_tpu_torch.control.controller",
        "hbbft_tpu_torch.control.trace"]

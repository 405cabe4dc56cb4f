"""The port's traffic subsystem (``hbbft_tpu_torch/traffic/``) against the
JAX package's.

Every case of the reference's ``tests/test_traffic.py`` runs in both
packages through :mod:`torch_twin`: the reference test's own
checks hold in each, and the two runs' arrival waves, proposal samples,
admission outcomes, Batches, driver reports, tracker fingerprints and
why-stalled reports are equal call for call, each on its own package's
``MockBackend``.  One real-crypto A/B holds the port's
``ArrayTrafficDriver`` on ``TorchBackend(device="cpu")`` against the
reference's on its host golden ``CpuBackend`` at N=4, two epochs,
``dedup_verifies=True`` (~55 s, most of it the reference's pure-Python
pairings: behind ``-m slow``).
"""

import random
from dataclasses import fields

import pytest
import torch

from torch_twin import RECORDED, TwinModule, norm, twin

torch.set_num_threads(1)

MOD = TwinModule("test_traffic.py", port_subs=[
    ("from tools.trace_report import", "from hbbft_tpu_torch.tools.trace_report import")],
    recorded=RECORDED + (({"hbbft_tpu": "tools.trace_report",
                           "hbbft_tpu_torch": "hbbft_tpu_torch.tools.trace_report"},
                          None, "diff_traffic"),))
CASES = [p for name in sorted(n for n in vars(MOD.copies["hbbft_tpu"])
                              if n.startswith("test_"))
         for p in MOD.params(name)]


@pytest.mark.parametrize("name,kwargs", CASES)
def test_port_equals_the_reference(name, kwargs, tmp_path):
    twin(MOD, name, kwargs, tmp_path)


def _crypto_run(root, backend):
    import importlib

    tr = importlib.import_module(f"{root}.traffic")
    eng = importlib.import_module(f"{root}.engine.array_engine")
    net = eng.ArrayHoneyBadgerNet(range(4), backend=backend, seed=3, dedup_verifies=True)
    src = tr.OpenLoopSource(40.0, tr.ZipfPopulation(200, 1.1), tr.PayloadSizes("fixed", 16))
    drv = tr.ArrayTrafficDriver(net, src, random.Random(5), batch_size=8, mempool_capacity=256)
    seen = []
    net.batch_listeners.append(lambda b: seen.append({k: v.contributions for k, v in b.items()}))
    rep = drv.run(2)
    counts = [{f.name: getattr(r, f.name) for f in fields(r) if f.name != "phase_seconds"}
              for r in net.reports]
    return seen, norm(rep), drv.tracker.fingerprint(), counts


@pytest.mark.slow
def test_real_crypto_driver_equals_the_reference():
    """The port's driver over real BLS on the CPU: the same Batches (every
    node one Batch), report and tracker fingerprint as the reference's
    over its CpuBackend."""
    from hbbft_tpu.crypto.backend import CpuBackend
    from hbbft_tpu_torch.ops.backend import TorchBackend

    ref = _crypto_run("hbbft_tpu", CpuBackend())
    port = _crypto_run("hbbft_tpu_torch", TorchBackend(device="cpu"))
    batches = port[0]
    assert len(batches) == 2
    for ep in batches:
        assert all(c == ep[0] for c in ep.values())
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2] and port[2]["committed"] > 0
    assert port[3] == ref[3]

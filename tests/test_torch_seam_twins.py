"""The port's dispatch seam and protocol properties against the JAX
package's own tests of them.

Every case of the reference's ``tests/test_deferred_unwind.py`` (crafted
shares out of order through ``MockBackend(pipeline_chunk=…)`` and the
engine's rejected-share raise), ``tests/test_dispatch_kinds.py`` (the
static guard that every dispatch of ``TorchBackend`` carries a kind with a
``device_seconds_*`` counter) and ``tests/test_property.py`` (the
protocol and array-engine agreement properties) runs in both packages
through :mod:`torch_twin`: the reference test's own checks hold in each,
and the two runs' recorded values are equal call for call (the default
record, plus every correct node's outputs each time a test reads them).

``test_dispatch_kinds.py`` inspects ``backend_mod.TpuBackend``; the port's
copy names ``TorchBackend``.  ``test_property.py`` draws its examples from
hypothesis: both copies are loaded under a settings profile with
``derandomize=True`` (and no example database), so the two packages see
the same examples in the same order; the reference file is unchanged.
"""

import pytest

from torch_twin import RECORDED, TwinModule, twin

hypothesis = pytest.importorskip("hypothesis")


def _outputs(args, nodes):
    """(id, outputs) of each correct node, a signature as its bytes."""
    return [(n.id, [o.to_bytes() if hasattr(o, "to_bytes") else o for o in n.outputs])
            for n in nodes]


#: every read of the correct nodes' outputs
OUTPUTS = RECORDED + (("net.virtual_net", "VirtualNet", "correct_nodes", _outputs),)


def _derandomized(filename: str) -> TwinModule:
    """The module loaded while the default settings derandomize: its
    ``settings(...)`` objects inherit that when they are built."""
    hypothesis.settings.register_profile(
        "torch-twin-derandomized", derandomize=True, database=None)
    previous = hypothesis.settings._current_profile
    hypothesis.settings.load_profile("torch-twin-derandomized")
    try:
        return TwinModule(filename, recorded=OUTPUTS)
    finally:
        hypothesis.settings.load_profile(previous or "default")


MODULES = {
    "test_deferred_unwind": TwinModule("test_deferred_unwind.py", recorded=OUTPUTS),
    "test_dispatch_kinds": TwinModule("test_dispatch_kinds.py", port_subs=[
        ("backend_mod.TpuBackend", "backend_mod.TorchBackend")]),
    "test_property": _derandomized("test_property.py"),
}

CASES = [
    pytest.param(stem, *p.values, id=f"{stem}::{p.id}")
    for stem, mod in MODULES.items()
    for name in sorted(n for n in vars(mod.copies["hbbft_tpu"]) if n.startswith("test_"))
    for p in mod.params(name)
]


@pytest.mark.parametrize("stem,name,kwargs", CASES)
def test_port_equals_the_reference(stem, name, kwargs, tmp_path):
    twin(MODULES[stem], name, kwargs, tmp_path)


def test_every_named_case_runs():
    counts = {}
    for p in CASES:
        counts[p.values[0]] = counts.get(p.values[0], 0) + 1
    assert counts == {"test_deferred_unwind": 6, "test_dispatch_kinds": 6, "test_property": 5}


def test_property_examples_are_derandomized():
    """Both copies' property tests carry derandomized settings (the same
    examples in both packages), the reference file's own bounds kept."""
    for root in ("hbbft_tpu", "hbbft_tpu_torch"):
        fn = MODULES["test_property"].copies[root].test_threshold_sign_agreement
        s = fn._hypothesis_internal_use_settings
        assert s.derandomize and s.database is None and s.max_examples == 20

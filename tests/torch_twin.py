"""Run a reference test of the JAX package against both packages and hold
the two runs' observable values equal.

A test module of the JAX package (``tests/test_traffic.py`` and the like)
is loaded twice from its source: once as it is, and once with every
``hbbft_tpu.`` import pointed at ``hbbft_tpu_torch.`` (plus a few named
text substitutions where the port's surface differs, such as its soak
CLI's module path, or the ``hbbft_tpu/`` path scopes of the lint tests).  :func:`twin` then calls the same test function from
both copies, each with a fresh ``monkeypatch`` and its own ``tmp_path``,
so the reference test's own assertions run on the port too.

While each copy runs, the public calls that carry the traffic, control
and soak planes' results are recorded in order: the drivers' reports,
the tracker's fingerprints, the controller's decisions and B traces,
the soak results' rows and fingerprints, the per-epoch series rows, the
engine's Batches, every arrival wave, proposal sample and admission
outcome, and every why-stalled report.  The two records must be equal
call for call: the work is integer and seeded, so the tolerance is zero.
A module may name its own calls to record instead (``recorded=``): the
analysis twins record lint findings, state inventories and the lint
CLI's JSON document.

Where a reference test builds a net without naming a backend (the JAX
package's ``NetBuilder`` defaults to its ``MockBackend``), the port's copy
runs on the port's ``MockBackend`` as well: its ``NetBuilder`` defaults to
the card, which ``test_torch_soak.py`` pins separately.
"""

import hashlib
import importlib
import re
import types
from pathlib import Path

import pytest

TESTS = Path(__file__).resolve().parent

#: (module under the package root, class or None, attribute) whose
#: results are recorded; a class attribute is patched on the class, a
#: module function on the module and on the test copy's globals.  The
#: module may instead be a {package root: module name} map (a module
#: outside the package, such as the reference's ``tools/lint.py``), or
#: None for a function of the test module itself.  An optional fourth
#: element ``pick(args, result)`` names what of a call is recorded (by
#: default its result); a property is recorded on each read.
RECORDED = (
    ("traffic.driver", "_TrafficBase", "report"),
    ("traffic.tracker", "TxTracker", "fingerprint"),
    ("control.controller", "AdaptiveBatchController", "decide"),
    ("control.controller", "AdaptiveBatchController", "b_trace"),
    ("net.scenarios", "SoakResult", "row"),
    ("net.scenarios", "SoakResult", "fingerprint"),
    ("obs.timeseries", "MetricsLog", "snap"),
    ("engine.array_engine", "ArrayHoneyBadgerNet", "run_epoch"),
    ("traffic.workload", "OpenLoopSource", "arrivals"),
    ("traffic.workload", "ClosedLoopSource", "arrivals"),
    ("protocols.transaction_queue", "TransactionQueue", "choose"),
    ("traffic.mempool", "BoundedMempool", "submit"),
    ("obs.health", None, "why_stalled"),
)

_ADDR = re.compile(r" at 0x[0-9a-f]+")


def norm(obj) -> str:
    """A package-neutral value: ``repr`` with the port's package name and
    object addresses taken out (dataclasses, Batches and reports print by
    class name and fields, which the two packages share)."""
    return _ADDR.sub("", repr(obj)).replace("hbbft_tpu_torch", "hbbft_tpu")


class Recorder:
    """The ordered record of one copy's recorded calls, as digests."""

    def __init__(self) -> None:
        self.calls = []

    def add(self, label: str, value) -> None:
        text = norm(value)
        self.calls.append((label, hashlib.sha256(text.encode()).hexdigest(), text[:400]))

    def wrap(self, label: str, fn, pick=None):
        def recorded(*args, **kwargs):
            out = fn(*args, **kwargs)
            self.add(label, out if pick is None else pick(args, out))
            return out

        return recorded


def _patch(mp: pytest.MonkeyPatch, root: str, mod, rec: Recorder, recorded) -> None:
    for path, cls_name, attr, *pick in recorded:
        pick = pick[0] if pick else None
        if path is None:
            if hasattr(mod, attr):
                mp.setattr(mod, attr, rec.wrap(f"test.{attr}", getattr(mod, attr)))
            continue
        if isinstance(path, dict):
            m = importlib.import_module(path[root])
            path = path["hbbft_tpu"]
        else:
            m = importlib.import_module(f"{root}.{path}")
        label = f"{path}.{cls_name + '.' if cls_name else ''}{attr}"
        if cls_name is None:
            fn = getattr(m, attr)
            wrapped = rec.wrap(label, fn, pick)
            mp.setattr(m, attr, wrapped)
            for name, val in list(vars(mod).items()):
                if val is fn:
                    mp.setattr(mod, name, wrapped)
        else:
            cls = getattr(m, cls_name)
            member = cls.__dict__[attr]
            if isinstance(member, property):
                mp.setattr(cls, attr, property(rec.wrap(label, member.fget, pick)))
            else:
                mp.setattr(cls, attr, rec.wrap(label, member, pick))


def _port_mock_default(mp: pytest.MonkeyPatch) -> None:
    """The port's NetBuilder builds on the port's MockBackend where the
    test names no backend (the reference's default)."""
    vn = importlib.import_module("hbbft_tpu_torch.net.virtual_net")
    mock = importlib.import_module("hbbft_tpu_torch.crypto.backend").MockBackend
    build = vn.NetBuilder.build

    def build_on_mock(self, *args, **kwargs):
        if self._backend is None:
            self._backend = mock()
        return build(self, *args, **kwargs)

    mp.setattr(vn.NetBuilder, "build", build_on_mock)


class TwinModule:
    """One reference test module, loaded as the reference and as the port."""

    def __init__(self, filename: str, port_subs=(), recorded=RECORDED) -> None:
        self.recorded = recorded
        src = (TESTS / filename).read_text()
        port_src = src.replace("hbbft_tpu.", "hbbft_tpu_torch.")
        for a, b in port_subs:
            assert a in port_src, a
            port_src = port_src.replace(a, b)
        stem = filename[:-3]
        self.copies = {
            "hbbft_tpu": self._load(f"twin_ref_{stem}", src, filename),
            "hbbft_tpu_torch": self._load(f"twin_port_{stem}", port_src, filename),
        }

    @staticmethod
    def _load(name: str, src: str, filename: str):
        mod = types.ModuleType(name)
        mod.__file__ = str(TESTS / filename)
        exec(compile(src, str(TESTS / filename), "exec"), mod.__dict__)
        return mod

    def params(self, test_name: str):
        """pytest ids for a test: one per parametrize row, else one."""
        fn = getattr(self.copies["hbbft_tpu"], test_name)
        for mark in getattr(fn, "pytestmark", ()):
            if mark.name == "parametrize":
                names = [s.strip() for s in mark.args[0].split(",")]
                rows = [r if len(names) > 1 else (r,) for r in mark.args[1]]
                return [pytest.param(test_name, dict(zip(names, r)),
                                     id=f"{test_name}[{'-'.join(map(str, r))}]")
                        for r in rows]
        return [pytest.param(test_name, {}, id=test_name)]

    def run(self, root: str, test_name: str, kwargs: dict, tmp_path: Path):
        mod = self.copies[root]
        fn = getattr(mod, test_name)
        rec = Recorder()
        mp = pytest.MonkeyPatch()
        try:
            _patch(mp, root, mod, rec, self.recorded)
            if root == "hbbft_tpu_torch":
                _port_mock_default(mp)
            args = dict(kwargs)
            code = fn.__code__.co_varnames[: fn.__code__.co_argcount]
            if "monkeypatch" in code:
                args["monkeypatch"] = mp
            if "tmp_path" in code:
                sub = tmp_path / root
                sub.mkdir()
                args["tmp_path"] = sub
            fn(**args)
        finally:
            mp.undo()
        return rec.calls


def twin(module: TwinModule, test_name: str, kwargs: dict, tmp_path: Path):
    """Run the test in both packages; assert equal records; return the
    port's record."""
    ref = module.run("hbbft_tpu", test_name, kwargs, tmp_path)
    port = module.run("hbbft_tpu_torch", test_name, kwargs, tmp_path)
    assert len(port) == len(ref), ([c[0] for c in ref], [c[0] for c in port])
    for i, (a, b) in enumerate(zip(ref, port)):
        assert a[:2] == b[:2], f"call {i} ({a[0]}) differs:\n ref  {a[2]}\n port {b[2]}"
    return port


def behind_slow(cases, ids):
    """``cases`` with those whose id is in ``ids`` behind ``-m slow``."""
    return [pytest.param(*p.values, id=p.id, marks=(*p.marks, pytest.mark.slow))
            if p.id in ids else p for p in cases]

"""Structural guards for the PyTorch/CUDA port (``hbbft_tpu_torch``).

* The port imports neither JAX nor anything of the JAX package: it keeps
  its own copy of what it needs (checked on the AST of every module).
* No ``try`` wraps a kernel launch, so a CUDA tensor either goes through
  its kernel or raises — there is no quiet fallback to the plain version.
* The card is the default device: without CUDA, ``TorchBackend()``
  raises instead of running on the CPU.
"""

import ast
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.ops import fq_rns, fq_rns_cuda
from hbbft_tpu_torch.ops.backend import TorchBackend
from hbbft_tpu_torch.utils import cuda_build, device

PKG = Path(__file__).resolve().parent.parent / "hbbft_tpu_torch"
SOURCES = sorted(PKG.rglob("*.py"))


def _imported_modules(tree: ast.AST):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _kernel_entry_points() -> set:
    """The C entry points of every csrc/*.cu (extern "C" launchers)."""
    names = set()
    for src in (PKG / "csrc").glob("*.cu"):
        names |= set(re.findall(r"^int\s+(\w+)\s*\(", src.read_text(), re.M))
    return names


def test_sources_found():
    assert len(SOURCES) >= 20
    assert _kernel_entry_points() >= {"fq_rns_mul", "fq_rns_pow"}


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_reference_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib"), f"{path} imports {mod}"
        assert root != "hbbft_tpu", f"{path} imports the JAX package ({mod})"


def test_no_try_around_a_kernel_launch():
    """Every call of a C launcher, and of the wrappers that make them,
    sits outside any ``try`` body in the whole package."""
    launchers = _kernel_entry_points()
    wrapper_module = PKG / "ops" / "fq_rns_cuda.py"
    wrappers = set()
    for node in ast.walk(ast.parse(wrapper_module.read_text())):
        if isinstance(node, ast.FunctionDef):
            for call in ast.walk(node):
                if isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute):
                    if call.func.attr in launchers:
                        wrappers.add(node.name)
    assert {"mul", "pow_fixed"} <= wrappers

    offenders = []
    for path in SOURCES:
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            if not isinstance(node, ast.Try):
                continue
            for stmt in node.body:
                for call in ast.walk(stmt):
                    if not isinstance(call, ast.Call):
                        continue
                    f = call.func
                    name = f.attr if isinstance(f, ast.Attribute) else getattr(f, "id", "")
                    owner = f.value.id if (
                        isinstance(f, ast.Attribute) and isinstance(f.value, ast.Name)
                    ) else ""
                    if name in launchers or (
                        name in wrappers and owner in ("fq_rns_cuda", "K")
                    ):
                        offenders.append(f"{path.name}:{call.lineno} {owner}.{name}")
    assert not offenders, offenders


def test_backend_without_device_needs_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        TorchBackend()
    with pytest.raises(RuntimeError, match="cuda"):
        TorchBackend(device="cuda")
    assert TorchBackend(device="cpu").device == torch.device("cpu")


def test_default_device_is_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert device.DEFAULT_DEVICE == "cuda"
    assert device.resolve().type == "cuda"
    assert device.resolve("cpu").type == "cpu"


def test_tf32_pinned_off():
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_wrappers_never_fall_back_on_other_devices():
    """A tensor that is neither on the CPU nor on the card is refused:
    only a CPU tensor selects the plain version."""
    a = torch.empty((2, fq_rns.NLIMBS), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        fq_rns_cuda.mul(a, a)
    with pytest.raises(ValueError):
        fq_rns_cuda.pow_fixed(a, 5)
    with pytest.raises(ValueError):
        fq_rns_cuda.mul(torch.zeros((2, 80)), torch.zeros((2, 80)))


def test_cpu_wrappers_run_the_plain_version_without_building():
    rows = torch.as_tensor(fq_rns.from_ints([3, 5]))
    before = (fq_rns_cuda.mul.launches, fq_rns_cuda.pow_fixed.launches)
    out = fq_rns_cuda.mul(rows, rows)
    assert np.array_equal(out.numpy(), fq_rns_cuda.mul_plain(rows, rows).numpy())
    assert fq_rns.to_ints(fq_rns_cuda.pow_fixed(rows, 3)) == [27, 125]
    assert (fq_rns_cuda.mul.launches, fq_rns_cuda.pow_fixed.launches) == before
    assert not cuda_build._LIBS  # importing and CPU use never build a kernel


def test_kernel_constants_match_the_library_layout():
    """The packed constant buffer has the length csrc/fq_rns.cu's offset
    table ends at (the library re-checks it at load on the card)."""
    src = (PKG / "csrc" / "fq_rns.cu").read_text()
    consts = {}
    for name, expr in re.findall(r"#define (\w+) (.+?)(?:\s*//.*)?$", src, re.M):
        consts[name] = expr
    env: dict = {}
    for name in ("NB", "NL", "NE", "OFF_E1", "OFF_E2", "OFF_P", "OFF_IP", "OFF_XOFF",
                 "OFF_SIGC", "OFF_M1INV", "OFF_QM1INV", "OFF_W2INV", "OFF_PB1R",
                 "OFF_IPB1R", "OFF_M2B1", "OFF_M2INVR", "N_CONSTS"):
        env[name] = eval(consts[name], {}, dict(env))  # noqa: S307 (own source)
    assert env["N_CONSTS"] == fq_rns_cuda._KCONSTS.size
    k = fq_rns_cuda._KCONSTS
    assert np.array_equal(k[env["OFF_P"] : env["OFF_P"] + env["NL"]], fq_rns_cuda._P)
    assert np.array_equal(k[env["OFF_M2B1"] : env["OFF_M2B1"] + env["NB"]], fq_rns._M2_B1)

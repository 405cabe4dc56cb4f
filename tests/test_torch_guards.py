"""Structural guards for the PyTorch/CUDA port (``hbbft_tpu_torch``).

* The port imports neither JAX nor anything of the JAX package, its root
  ``tools/`` and ``examples/`` included: it keeps its own copy of what it
  needs (checked on the AST of every module).
* No ``try`` wraps a kernel launch, so a CUDA tensor either goes through
  its kernel or raises — there is no quiet fallback to the plain version.
* The card is the default device: without CUDA, ``TorchBackend()``
  raises instead of running on the CPU.
"""

import ast
import hashlib
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from hbbft_tpu_torch.ops import fq, fq_limb, fq_limb_cuda, fq_rns, fq_rns_cuda, probe_cuda
from hbbft_tpu_torch.ops import gf256, sha256
from hbbft_tpu_torch.ops import tower_fused, tower_fused_cuda
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
    assert len(SOURCES) >= 30
    assert _kernel_entry_points() >= {
        "fq_rns_mul", "fq_rns_pow", "fq_rns_chain", "tower_op", "miller_dbl", "hard_exp",
        "fq_limb_mul", "fq_limb_pow", "fma_probe", "sha256_tagged", "sha256_proofs",
        "gf256_matmul",
    }
    # the native host kernels' loader is one of the guarded modules
    assert PKG / "native" / "__init__.py" in SOURCES


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_reference_package_imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for mod in _imported_modules(tree):
        root = mod.split(".")[0]
        assert root not in ("jax", "jaxlib"), f"{path} imports {mod}"
        assert root != "hbbft_tpu", f"{path} imports the JAX package ({mod})"
        # nor the JAX package's root entry points and tools
        assert root not in ("tools", "examples", "bench", "__graft_entry__"), (
            f"{path} imports the JAX package's {mod}")


def test_no_try_around_a_kernel_launch():
    """Every call of a C launcher, and of the wrappers that make them,
    sits outside any ``try`` body in the whole package."""
    launchers = _kernel_entry_points()
    wrappers = set()
    for name in ("fq_rns_cuda.py", "tower_fused_cuda.py", "fq_limb_cuda.py", "probe_cuda.py",
                 "gf256.py", "sha256.py"):
        for node in ast.walk(ast.parse((PKG / "ops" / name).read_text())):
            if isinstance(node, ast.FunctionDef):
                for call in ast.walk(node):
                    if isinstance(call, ast.Call) and isinstance(call.func, ast.Attribute):
                        if call.func.attr in launchers:
                            wrappers.add(node.name)
    assert {"mul", "pow_fixed", "mul_chain", "tower_op", "miller_dbl", "hard_exp",
            "fma_probe", "gf256_matmul", "sha256_tagged", "sha256_proofs"} <= wrappers

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
                        name in wrappers
                        and owner in ("fq_rns_cuda", "K", "tower_fused_cuda", "TK",
                                      "fq_limb_cuda", "LK", "probe_cuda", "PK",
                                      "gf256", "G", "sha256", "S")
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
    with pytest.raises(ValueError):
        fq_rns_cuda.mul_chain(a, a, 3)
    limbs = torch.empty((2, fq_limb.NLIMBS), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        fq_limb_cuda.mul(limbs, limbs)
    with pytest.raises(ValueError):
        fq_limb_cuda.pow_fixed(limbs, 5)
    with pytest.raises(ValueError):
        probe_cuda.fma_probe(limbs, 3)
    packed = torch.empty((12, 2, fq_rns.NLIMBS), dtype=torch.float32, device="meta")
    with pytest.raises(ValueError):
        tower_fused.tower_op("fq12_mul", packed, packed)
    with pytest.raises(ValueError):
        tower_fused.hard_exp_packed(packed)
    with pytest.raises(ValueError):
        tower_fused.miller_double_step_rows(packed, packed[:6], packed[:2])
    meta_bytes = torch.empty((4, 9), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError):
        gf256.gf256_matmul(torch.empty((8, 1), dtype=torch.int32, device="meta"), meta_bytes)
    with pytest.raises(ValueError):
        sha256.sha256_tagged(meta_bytes, 0)
    with pytest.raises(ValueError):
        sha256.sha256_proofs(meta_bytes, torch.empty((4, 2, 32), dtype=torch.uint8,
                                                     device="meta"),
                             torch.empty(4, dtype=torch.int32, device="meta"),
                             torch.empty((4, 32), dtype=torch.uint8, device="meta"))
    with pytest.raises(ValueError):  # operands on two devices
        gf256.gf256_matmul(torch.empty((8, 1), dtype=torch.int32), meta_bytes)


def test_cpu_wrappers_run_the_plain_version_without_building():
    rows = torch.as_tensor(fq_rns.from_ints([3, 5]))
    before = (fq_rns_cuda.mul.launches, fq_rns_cuda.pow_fixed.launches)
    out = fq_rns_cuda.mul(rows, rows)
    assert np.array_equal(out.numpy(), fq_rns_cuda.mul_plain(rows, rows).numpy())
    assert fq_rns.to_ints(fq_rns_cuda.pow_fixed(rows, 3)) == [27, 125]
    assert (fq_rns_cuda.mul.launches, fq_rns_cuda.pow_fixed.launches) == before
    packed = torch.as_tensor(np.stack([fq_rns.from_ints([2, 3])] * 2))
    fused_before = [k.launches for k in tower_fused_cuda.KERNELS]
    got = tower_fused.tower_op("fq2_mul", packed, packed)
    assert [fq_rns.to_ints(c) for c in got] == [[0, 0], [8, 18]]  # (x + xu)² = 2x²u
    assert [k.launches for k in tower_fused_cuda.KERNELS] == fused_before
    chain_before = fq_rns_cuda.mul_chain.launches
    assert fq_rns.to_ints(fq_rns_cuda.mul_chain(rows, rows, 2)) == [27, 125]
    assert fq_rns_cuda.mul_chain.launches == chain_before
    limbs = torch.as_tensor(fq_limb.from_ints([3, 5]))
    limb_before = [k.launches for k in fq_limb_cuda.KERNELS]
    assert fq_limb.to_ints(fq_limb_cuda.mul(limbs, limbs)) == [9, 25]
    assert fq_limb.to_ints(fq_limb_cuda.pow_fixed(limbs, 3)) == [27, 125]
    assert [k.launches for k in fq_limb_cuda.KERNELS] == limb_before
    probe_before = probe_cuda.fma_probe.launches
    probe_cuda.fma_probe(torch.ones((2, 3)), 4)
    assert probe_cuda.fma_probe.launches == probe_before
    plane_before = [k.launches for k in (*sha256.KERNELS, gf256.gf256_matmul)]
    msgs = torch.zeros((2, 5), dtype=torch.uint8)
    assert sha256.sha256_tagged(msgs, 0)[0].numpy().tobytes() == hashlib.sha256(
        bytes(6)).digest()
    levels = sha256.tree_levels(msgs.reshape(1, 2, 5))
    siblings = levels[0][0, [1, 0]].reshape(2, 1, 32)
    assert sha256.verify_proofs(msgs, siblings, torch.tensor([0, 1], dtype=torch.int32),
                                levels[1][0].expand(2, 32)).tolist() == [True, True]
    words = torch.as_tensor(gf256.pack_gf_matrix(np.array([[3]], dtype=np.uint8)))
    assert gf256.gf256_matmul(words, torch.tensor([[7]], dtype=torch.uint8)).item() == 9
    assert [k.launches for k in (*sha256.KERNELS, gf256.gf256_matmul)] == plane_before
    assert not cuda_build._LIBS  # importing and CPU use never build a kernel


def test_limb_kernel_fold_table_is_the_fields():
    """csrc/fq_limb.cu carries the fold matrix as a __constant__ table
    (the library re-checks it against fq_limb.FOLD_ROWS at load on the
    card): the committed numbers are FOLD_ROWS transposed."""
    src = (PKG / "csrc" / "fq_limb.cu").read_text()
    body = src.split("FOLD_T[NLB][NF] = {", 1)[1].split("};", 1)[0]
    rows = [[float(v) for v in r.split(",") if v.strip()]
            for r in re.findall(r"\{([^{}]*)\}", body)]
    assert np.array_equal(np.array(rows, dtype=np.float32), fq_limb.FOLD_ROWS.T)


def test_limb_arm_never_rides_the_fused_chain(monkeypatch):
    """The fused kernels read 79-wide residue rows: under the limb arm the
    verification graphs take the stacked chain whatever the kill switch
    says (the reference's rule, hbbft_tpu/ops/tower_fused.py:94)."""
    monkeypatch.delenv("HBBFT_TPU_NO_FUSED_TOWER", raising=False)
    assert tower_fused.fused_tower_mode()
    monkeypatch.setattr(fq, "IMPL", "limb")
    assert not tower_fused.fused_tower_mode()


def test_kernel_constants_match_the_library_layout():
    """The packed constant buffer has the length the offset table of
    csrc/fq_rns_core.cuh (shared by both CUDA sources) ends at (each
    library re-checks it at load on the card)."""
    src = (PKG / "csrc" / "fq_rns_core.cuh").read_text()
    for cu in ("fq_rns.cu", "tower_fused.cu"):
        assert '#include "fq_rns_core.cuh"' in (PKG / "csrc" / cu).read_text()
    consts = {}
    for name, expr in re.findall(r"#define (\w+) (.+?)(?:\s*//.*)?$", src, re.M):
        consts[name] = expr
    env: dict = {}
    for name in ("NB", "NL", "NE", "OFF_P", "OFF_IP", "OFF_XOFF", "OFF_SIGC", "OFF_M1INV",
                 "OFF_QM1INV", "OFF_W2INV", "OFF_PB1R", "OFF_IPB1R", "OFF_M2B1",
                 "OFF_M2INVR", "N_CONSTS"):
        env[name] = eval(consts[name], {}, dict(env))  # noqa: S307 (own source)
    assert env["N_CONSTS"] == fq_rns_cuda._KCONSTS.size
    # the vectors start at 0 and are copied into shared memory as float4
    assert env["OFF_P"] == 0 and env["N_CONSTS"] % 4 == 0
    k = fq_rns_cuda._KCONSTS
    for off, want in (("OFF_P", fq_rns_cuda._P), ("OFF_IP", fq_rns_cuda._IP),
                      ("OFF_XOFF", fq_rns_cuda._XOFF), ("OFF_SIGC", fq_rns._SIGMA_C_B1),
                      ("OFF_M1INV", fq_rns._M1INV_B2R), ("OFF_QM1INV", fq_rns._QM1INV_B2R),
                      ("OFF_W2INV", fq_rns._W2INV_B2), ("OFF_PB1R", fq_rns_cuda._PB1R),
                      ("OFF_IPB1R", fq_rns_cuda._IPB1R), ("OFF_M2B1", fq_rns._M2_B1)):
        want = np.asarray(want, dtype=np.float32)
        assert np.array_equal(k[env[off] : env[off] + want.size], want), off
    assert k[env["OFF_M2INVR"]] == np.float32(fq_rns_cuda._M2INV_R)

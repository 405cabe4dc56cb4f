"""chip_smoke.py without the card: it refuses to run (no result line, a
non-zero exit), and its main-path phase drives the port correctly at a
tiny size on the CPU backend (the same code the card runs at N=100)."""

import importlib.util
import json
import random
import shutil
import subprocess
import sys
from contextlib import contextmanager
from pathlib import Path

import pytest
import torch

from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.ops import fq_rns, fq_rns_cuda
from hbbft_tpu_torch.ops.backend import TorchBackend

# The suite runs in parallel workers: one intra-op thread per process keeps
# these small CPU tensors from oversubscribing the cores.
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_refuses_without_the_card(smoke, capsys, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out and "needs the card" in out


def test_refuses_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
        timeout=120,
    )
    assert proc.returncode != 0
    assert '"ok"' not in proc.stdout


def test_lazy_rows_carry_their_values(smoke):
    rows, vals = smoke.lazy_rows(random.Random(3), 50, fq_rns)
    assert rows.shape == (50, fq_rns.NLIMBS) and len(vals) == 50
    assert fq_rns.to_ints(rows) == vals
    assert all(0 <= v < Q for v in vals)


def test_bound_model(smoke):
    assert smoke.MUL_EW_OPS_REDUCED == 4250 and smoke.MUL_EW_OPS == 4882
    assert smoke.MUL_TC_FLOPS == 25600
    # one product per lane moves 3 rows: memory is the bound
    ms, by = smoke.bound(1 << 17, 1, smoke.MUL_EW_OPS, 3)
    assert by == "bytes" and ms == pytest.approx((1 << 17) * 3 * 316 / 3.35e12 * 1e3)
    # the Fermat chain does ~570 products on 2 rows: operations are
    ms, by = smoke.bound(4096, 570, 570 * smoke.MUL_EW_OPS_REDUCED, 2)
    assert by == "operations" and ms > 0


def test_main_phase_at_a_tiny_size(smoke, capsys):
    backend = TorchBackend(device="cpu")
    fq_rns_cuda.reset_launches()
    phases = []

    @contextmanager
    def wrap(name):
        phases.append(name)
        yield

    res = smoke.phase_main(backend, random.Random(0), 4, 1, 48, 12, 2, wrap=wrap)
    out = capsys.readouterr().out
    assert phases == list(res["seconds"]) == [
        "host_setup", "verify_ciphertexts", "decrypt_shares_batch", "verify_dec_shares",
        "combine_dec_shares_batch",
    ]
    assert res["verify_items"] == 48 and res["forged_items"] == 6 and res["combines"] == 12
    assert "all rejected" in out and "every plaintext equal" in out
    assert backend.counters.device_dispatches > 0
    # CPU tensors run the plain versions: no kernel launches are counted
    assert fq_rns_cuda.mul.launches == 0 and fq_rns_cuda.pow_fixed.launches == 0
    json.dumps(res)  # the phase result is what the script prints as JSON

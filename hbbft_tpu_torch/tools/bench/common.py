"""What every row of the port's bench shares: knobs, the device the rows
run on, the backend names, the timing loop and the rows file.

The device is the card unless the caller asks for the CPU
(``BENCH_DEVICE=cpu``, or ``--device cpu`` on the command line, which
sets it): every row reads it through :func:`device` when it builds its
tensors or its ``TorchBackend``.
"""

from __future__ import annotations

import json
import os
import time

#: the repo root (the parent of the package): the rows file goes there
ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))
#: the rows file's name; never the JAX bench's ``BENCH_rows.json``
ROWS_FILE = "BENCH_torch_rows.json"

CPU_BASELINE_CHECKS_PER_SEC = 1_000.0
ARRAY_N16_METRIC = "array_epochs_per_sec_n16_realcrypto"


def _env_int(name: str, default: int) -> int:
    return int(os.environ.get(name, str(default)))


def device() -> str:
    """The rows' device: ``cuda`` (the card, the default) or ``cpu``."""
    return os.environ.get("BENCH_DEVICE", "cuda")


def make_backend(name: str):
    """A fresh backend for a ``BENCH_*_BACKEND`` knob's value.

    The names measure what the JAX bench's names measure there:
    ``mock`` is ``MockBackend`` (the protocol layer), ``cpu`` the
    pure-Python ``CpuBackend`` (the single-core real-crypto anchor),
    ``torch`` ``TorchBackend`` (the JAX bench's ``tpu``: the device
    path, on :func:`device`) and ``mesh`` ``MeshBackend`` (every card, or
    four entries of the CPU when the CPU is asked for)."""
    if name == "mock":
        from hbbft_tpu_torch.crypto.backend import MockBackend

        return MockBackend()
    if name == "cpu":
        from hbbft_tpu_torch.crypto.backend import CpuBackend

        return CpuBackend()
    if name == "torch":
        from hbbft_tpu_torch.ops.backend import TorchBackend

        return TorchBackend(device=device())
    if name == "mesh":
        from hbbft_tpu_torch.parallel import MeshBackend, device_mesh
        from hbbft_tpu_torch.tools.simulation import MESH_CPU_ENTRIES

        if device() == "cpu":
            return MeshBackend(device_mesh(MESH_CPU_ENTRIES, device="cpu"))
        return MeshBackend()
    hint = " (the JAX bench's 'tpu' is 'torch' here)" if name == "tpu" else ""
    raise ValueError(f"unknown backend {name!r}{hint}; use mock, cpu, torch or mesh")


def sync(tree) -> None:
    """Wait for the card's work on ``tree`` (a no-op on the CPU)."""
    import torch

    from hbbft_tpu_torch.utils.tree import tree_leaves

    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tree_leaves(tree)):
        torch.cuda.synchronize()


def _time_fn(fn, args, iters: int) -> float:
    """Steady-state seconds per call: one warm call (the kernels' first
    launch, the caches), then ``iters`` calls between a fence before and a
    ``torch.cuda.synchronize()`` fence after."""
    sync(fn(*args))
    sync(args)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    sync(out)
    return (time.perf_counter() - t0) / iters


class _RowSink:
    """Emit each metric row to stdout and keep the cumulative row set in
    ``BENCH_torch_rows.json`` at the repo root (``BENCH_ROWS_PATH``
    overrides the path), rewritten after every row so a killed run keeps
    what it emitted.  The meta block names the platform, the card, the
    field arm and the run's start."""

    def __init__(self, platform: str, card: str = "") -> None:
        self.path = os.environ.get("BENCH_ROWS_PATH", os.path.join(ROOT, ROWS_FILE))
        self.rows = []
        self.meta = {
            "platform": platform,
            "card": card,
            "fq_impl": os.environ.get("HBBFT_TPU_FQ_IMPL", "rns"),
            "started_utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
            "bench_only": os.environ.get("BENCH_ONLY") or None,
        }

    def emit(self, row: dict) -> None:
        print(json.dumps(row), flush=True)
        self.rows.append(row)
        try:
            with open(self.path + ".tmp", "w") as f:
                json.dump({"meta": self.meta, "rows": self.rows}, f, indent=1)
            os.replace(self.path + ".tmp", self.path)
        except OSError:
            pass  # a read-only checkout must not kill the bench

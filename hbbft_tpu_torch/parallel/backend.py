"""MeshBackend — the multi-device crypto backend (the JAX package's
``parallel/backend.py``).

``TorchBackend`` resolves whole verification and combination batches in
single-device dispatches; ``MeshBackend`` spreads the same backend over a
mesh (``parallel/mesh.py``: a list of devices, one CUDA stream an entry on
a card).  It does so with the per-device pipelined dispatcher
(``parallel/shardpipe.py``): every lane-capped chunk of the pipelined
chunk streams — pairing checks, sign/decrypt/DKG ladders, Lagrange
combines, the RLC deferred first round, the erasure/hash plane — lands
WHOLE on one entry picked by the recorded round-robin/least-loaded
policy, with a bounded in-flight queue per entry.

SYNC dispatches (RLC bisection rounds, whose control flow needs the
result at once) shard their batch axis over the whole mesh: each shard
runs the dispatched function on its entry and the outputs are
concatenated in order on ``mesh[0]`` (the JAX package hands a sharded
array to its SPMD partitioner; torch has none, so the split is written
out).  That is exact only where output row i depends on input row i
alone; the one dispatched function that reduces over its leading axis,
the GF(2⁸) product of the RS plane, runs whole on ``mesh[0]``.
``HBBFT_TPU_NO_SHARD_PIPE=1`` shards every dispatch that way (and
reserves nothing), with bit-identical results and conserved
``device_dispatches``.

Small-batch clamp: ``_pad_bucket`` widens a bucket to a multiple of the
mesh so the sharded axis splits evenly, but a bucket narrower than the
mesh stays the single-device bucket and its chunk runs whole on one
entry.

Staging still writes every chunk's rows to ``self.device``, which is
``mesh[0]``; placing a chunk then moves it to its entry, a no-op on one
card and on the CPU mesh.  Staging straight onto the reserved card waits
for a multi-card host.
"""

from __future__ import annotations

import math
from typing import Any, Dict, NamedTuple, Optional, Sequence

import torch

from hbbft_tpu_torch.ops.backend import TorchBackend, _bucket
from hbbft_tpu_torch.ops.gf256 import gf256_matmul
from hbbft_tpu_torch.ops.pipeline import fetch_to_host
from hbbft_tpu_torch.parallel.mesh import (
    device_mesh, entry_streams, join, launch_on, run_sharded, shard_batch,
)
from hbbft_tpu_torch.parallel.shardpipe import ShardedDispatchPipeline, shardpipe_enabled
from hbbft_tpu_torch.utils.tree import tree_leaves, tree_map

#: dispatched functions whose output row i depends on more than input row
#: i: a sharded placement of their inputs runs whole on ``mesh[0]``
WHOLE_FNS = (gf256_matmul,)


class _OnEntry(NamedTuple):
    """A chunk's inputs placed whole on one mesh entry."""

    entry: int
    args: tuple


class _Sharded(NamedTuple):
    """A batch's inputs to be split over the mesh at the launch (or run
    whole there, for a function in WHOLE_FNS)."""

    args: tuple


class MeshBackend(TorchBackend):
    """TorchBackend spread over a device mesh: whole pipelined chunks on
    distinct entries (default) or batch axes sharded over every entry
    (sync dispatches, and everything under ``HBBFT_TPU_NO_SHARD_PIPE=1``).

    ``mesh`` defaults to ``device_mesh()``, every card of the host; without
    CUDA that raises (pass ``device_mesh(n, device="cpu")``)."""

    def __init__(self, mesh: Optional[Sequence[torch.device]] = None) -> None:
        mesh = list(device_mesh() if mesh is None else mesh)
        super().__init__(device=mesh[0])
        self.mesh = mesh
        self._n_dev = len(mesh)
        self._streams = entry_streams(mesh)
        # swap the inherited single-queue pipe for the per-device one
        # (same counters/tracer/probe contract; the tracer is attached
        # after construction, hence the closure)
        self._pipe = ShardedDispatchPipeline(
            self._n_dev, counters=self.counters, tracer_ref=lambda: self.tracer,
        )

    def _pad_bucket(self, n: int) -> int:
        # power-of-two bucket, widened so a SHARDED axis splits evenly
        # (lcm handles a mesh that is not a power of two) — but a bucket
        # narrower than the mesh stays single-device-sized, and _place
        # routes such a chunk whole to one entry
        b = _bucket(n)
        if b < self._n_dev:
            return b
        return math.lcm(b, self._n_dev)

    def _place(self, tree, pipelined: bool = False):
        if pipelined and shardpipe_enabled():
            # whole-chunk placement: reserve the entry (recorded: a seeded
            # replay re-derives the identical sequence), then move the
            # staged inputs to it; the launch runs on its stream
            d = self._pipe.reserve_device()
            return _OnEntry(d, tree_map(lambda t: t.to(self.mesh[d]), tree))
        if any(leaf.shape[0] % self._n_dev for leaf in tree_leaves(tree)):
            # sub-threshold bucket (the _pad_bucket clamp), or inputs whose
            # leading axes are not one batch axis: the whole chunk runs on
            # the first entry
            return tree
        return _Sharded(tree)

    def _launch(self, fn, placed):
        """The launch closure and fetch of one dispatch of ``fn`` on its
        placed inputs."""
        if isinstance(placed, _OnEntry):
            stream = self._streams[placed.entry]

            def launch():
                return launch_on(stream, fn, placed.args)

            return launch, lambda raw: fetch_to_host(join(*raw))
        if isinstance(placed, _Sharded):
            if fn in WHOLE_FNS:
                return (lambda: fn(*placed.args)), fetch_to_host
            return (lambda: run_sharded(fn, shard_batch(placed.args, self.mesh), self.mesh,
                                        self._streams)), fetch_to_host
        return (lambda: fn(*placed)), fetch_to_host

    def _dispatch_fetch(self, fn, args, kind: str = "", items: int = 0):
        launch, fetch = self._launch(fn, args)
        return self._pipe.submit(launch, fetch, kind=kind, items=items, sync=True).value

    def _dispatch_async(self, fn, args, kind: str = "", items: int = 0, on_result=None):
        launch, fetch = self._launch(fn, args)
        return self._pipe.submit(launch, fetch, kind=kind, items=items, on_result=on_result)

    def shard_stats(self) -> Dict[str, Any]:
        """Per-entry dispatch tallies + cumulative imbalance (max/mean,
        1.0 = balanced) — the heartbeat's observability surface."""
        p = self._pipe
        return {
            "shard_devices": p.n_devices,
            "shard_dispatches": list(p.dev_dispatches),
            "shard_seconds": [round(s, 6) for s in p.dev_seconds],
            "shard_imbalance": round(p.imbalance(), 4),
            "shard_placements": len(p.placements),
        }

    @property
    def name(self) -> str:
        return f"MeshBackend[{self._n_dev}]"

"""Multi-device sharding of the crypto batch dimension (the JAX package's
``parallel/mesh.py``).

The batch axis is the (epoch × node × instance × share) work-item axis:
per-item pairing work is purely data-parallel, while a share *combination*
sums partial Jacobian points across the shards.

A mesh here is a list of ``torch.device`` entries, one per shard.  By
default it holds every card of the host.  ``device="cpu"`` (or one card
named n times) gives n entries of that one device: the counterpart of the
JAX package's virtual 8-device CPU mesh, structural only (the entries share
the device's cores or SMs).  On a card every entry gets its own CUDA
stream (:func:`entry_streams`), so work placed on different entries is
free to overlap.

Torch has no SPMD partitioner, so the sharded forms are written out: each
shard runs the unsharded function on its entry, and the outputs are
concatenated in shard order on ``mesh[0]`` (:func:`run_sharded`).  That is
exact only for a function whose output row i depends on input row i alone
(every ladder, pairing and proof walk of the seam); a function that
reduces over the leading axis is either written out with its cross-shard
reduction (:func:`sharded_combine_g2`) or runs whole on one entry.

Cross-stream safety on a card (what :func:`launch_on` and :func:`join`
do): an entry's stream first waits on the stream that staged its inputs;
the inputs are marked with ``record_stream`` so the caching allocator does
not hand their memory out while the entry may still read it; and whoever
consumes the outputs on another stream waits on an event recorded on the
entry's stream after the launch, and marks the outputs as used there.  The
kernels' device constants are built by synchronous host-to-device copies,
so they are complete before any stream can read them.
"""

from __future__ import annotations

from typing import Any, Callable, List, Optional, Sequence

import torch

from hbbft_tpu_torch.ops import curve, pairing
from hbbft_tpu_torch.utils.device import resolve
from hbbft_tpu_torch.utils.tree import tree_leaves, tree_map

BATCH_AXIS = "batch"


def device_mesh(n_devices: Optional[int] = None, device=None) -> List[torch.device]:
    """The mesh's entries.

    ``device=None``: the first ``n_devices`` (default: all) cards of the
    host; raises without CUDA, or when fewer cards than asked for are
    present.  Otherwise ``n_devices`` (default 1) entries of that one
    device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device_mesh() takes the cards but torch.cuda.is_available() is False; "
                "pass device='cpu' for a mesh of CPU entries"
            )
        devs = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            if n_devices > len(devs):
                raise ValueError(f"asked for {n_devices} cards, the host has {len(devs)}")
            devs = devs[:n_devices]
        return devs
    dev = resolve(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    n = 1 if n_devices is None else int(n_devices)
    if n < 1:
        raise ValueError("a mesh needs at least one entry")
    return [dev] * n


def entry_streams(mesh: Sequence[torch.device]) -> List[Optional[Any]]:
    """One CUDA stream an entry of a card mesh (None for a CPU entry)."""
    return [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in mesh]


def shard_batch(tree: Any, mesh: Sequence[torch.device]) -> List[Any]:
    """Every leaf split evenly along its leading (batch) axis, in order: one
    tree a mesh entry, each on its entry's device (a view, not a copy, where
    the entry is the leaf's own device)."""
    n = len(mesh)
    for leaf in tree_leaves(tree):
        if leaf.shape[0] % n:
            raise ValueError(f"a leading axis of {leaf.shape[0]} does not split over {n} entries")
    return [tree_map(lambda leaf, d=d: leaf.tensor_split(n)[d].to(mesh[d]), tree)
            for d in range(n)]


def launch_on(stream, fn: Callable, args: tuple):
    """``fn(*args)`` on an entry's ``stream`` (None: the caller's own
    stream): the stream waits on the staging stream first and the inputs
    are recorded on it.  Returns the output and an event recorded on the
    stream after the launch (None without a stream)."""
    if stream is None:
        return fn(*args), None
    stream.wait_stream(torch.cuda.current_stream(stream.device))
    for leaf in tree_leaves(args):
        if isinstance(leaf, torch.Tensor) and leaf.is_cuda:
            leaf.record_stream(stream)
    with torch.cuda.stream(stream):
        out = fn(*args)
        done = torch.cuda.Event()
        done.record(stream)
    return out, done


def join(out: Any, done) -> Any:
    """Make the caller's stream wait on a :func:`launch_on` output and mark
    the output as used there (so its memory outlives the caller's reads)."""
    if done is None:
        return out
    leaves = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor) and t.is_cuda]
    if leaves:
        cur = torch.cuda.current_stream(leaves[0].device)
        cur.wait_event(done)
        for t in leaves:
            t.record_stream(cur)
    return out


def run_sharded(fn: Callable, shards: Sequence[tuple], mesh: Sequence[torch.device],
                streams: Sequence[Optional[Any]]) -> Any:
    """``fn`` on every shard's entry (its stream), the outputs concatenated
    in shard order along the leading axis on ``mesh[0]``."""
    launched = [launch_on(streams[d], fn, tuple(shards[d])) for d in range(len(shards))]
    outs = [join(out, done) for out, done in launched]
    return tree_map(lambda *cs: torch.cat([c.to(mesh[0]) for c in cs], dim=0), *outs)


def sharded_product2(mesh: Sequence[torch.device], fused=None):
    """The sharded ``pairing.product2_fast``: (P1, Q1, P2, Q2) → the fq12
    values of FE(ML·ML), lane for lane, each shard on its own entry.
    Data-parallel: no cross-shard work until the outputs are gathered."""
    streams = entry_streams(mesh)

    def product2(P1, Q1, P2, Q2):
        shards = shard_batch((P1, Q1, P2, Q2), mesh)
        return run_sharded(lambda *a: pairing.product2_fast(*a, fused=fused), shards, mesh,
                           streams)

    return product2


def sharded_combine_g2(mesh: Sequence[torch.device]):
    """The sharded Lagrange combine Σ ±(bits_i · P_i) over a 1-D batch of
    G2 shares: each entry combines its shard into one partial Jacobian
    point, then the partials are tree-added on ``mesh[0]`` (the reduction
    the JAX package's partitioner inserts as a collective).  After
    ``g2_from_device`` it equals the unsharded ``linear_combine_g2``."""
    streams = entry_streams(mesh)

    def combine(points, bits, negs):
        shards = shard_batch((points, bits, negs), mesh)
        partials = run_sharded(curve.linear_combine_g2, shards, mesh, streams)
        return curve._tree_sum(curve._F2, partials, len(mesh))

    return combine

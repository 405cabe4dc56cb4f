"""One mesh probe: the per-device pipelined dispatcher over k entries (the
port's ``tools/mesh_probe.py``, the future bench's ``mesh_scaling`` row).

Drives ``ShardedDispatchPipeline`` (``parallel/shardpipe.py``) with
``--chunks`` whole-chunk dispatches of a trivial torch reduction, each
placed on its reserved entry (on a card: that entry's own CUDA stream,
``parallel/mesh.py``), and prints one JSON line of structural facts:
placement determinism, balanced per-entry dispatch tallies, imbalance,
results, and chunk throughput.  The entries of one device share its cores
or SMs, so the throughput is STRUCTURAL ONLY and must never be read as a
scale-out measurement.

    python -m hbbft_tpu_torch.tools.mesh_probe --devices 4            # the card
    python -m hbbft_tpu_torch.tools.mesh_probe --devices 4 --device cpu
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def probe(k: int, chunks: int = 64, lanes: int = 4096, device=None) -> dict:
    """The probe's facts for a mesh of ``k`` entries of ``device`` (None:
    the card)."""
    import torch

    from hbbft_tpu_torch.parallel.mesh import device_mesh, entry_streams, join, launch_on
    from hbbft_tpu_torch.parallel.shardpipe import ShardedDispatchPipeline

    mesh = device_mesh(k, device="cuda" if device is None else device)
    streams = entry_streams(mesh)

    def fn(x):
        return (x * 2.0 + 1.0).sum()

    base = torch.arange(lanes, dtype=torch.float32, device=mesh[0])
    for d in range(k):  # warm every entry before timing
        join(*launch_on(streams[d], fn, (base.to(mesh[d]),))).item()

    pipe = ShardedDispatchPipeline(k)
    out = []
    sync = torch.cuda.synchronize if mesh[0].type == "cuda" else (lambda: None)
    sync()
    t0 = time.perf_counter()
    for i in range(chunks):
        d = pipe.reserve_device()
        staged = base.to(mesh[d])
        pipe.submit(
            lambda staged=staged, d=d: launch_on(streams[d], fn, (staged,)),
            fetch=lambda raw: join(*raw).item(),
            kind=f"c{i}",
            items=lanes,
            on_result=out.append,
        )
    pipe.flush()
    sync()
    dt = time.perf_counter() - t0

    expect = fn(base).item()
    return {
        "devices": k,
        "chunks": chunks,
        "chunks_per_s": round(chunks / dt, 2),
        "chunks_per_s_is": "structural",
        "wall_s": round(dt, 4),
        "dev_dispatches": pipe.dev_dispatches,
        "placements_ok": pipe.placements == [i % k for i in range(chunks)],
        "balanced": max(pipe.dev_dispatches) - min(pipe.dev_dispatches)
        <= (1 if chunks % k else 0),
        "imbalance": round(pipe.imbalance(), 4),
        "results_ok": len(out) == chunks
        and all(abs(v - expect) < 1e-3 * abs(expect) for v in out),
        "platform": mesh[0].type,
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--devices", type=int, default=1, help="mesh entries (default 1)")
    ap.add_argument("--chunks", type=int, default=64)
    ap.add_argument("--lanes", type=int, default=4096, help="elements per chunk")
    ap.add_argument("--device", default=None,
                    help="the entries' device (default: the card; 'cpu' for the CPU)")
    args = ap.parse_args(argv)
    print(json.dumps(probe(args.devices, args.chunks, args.lanes, args.device)))
    return 0


if __name__ == "__main__":
    sys.exit(main())

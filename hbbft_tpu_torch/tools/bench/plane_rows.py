"""The erasure/hash plane rows and the field-kernel row: RS parity on the
``gf256_matmul`` kernel and through the host codec, the device plane
against its kill switch, and the RNS and limb field products through
``hbbft_tpu_torch.tools.kernel_bench``.
"""

from __future__ import annotations

import os
import random
import time

from hbbft_tpu_torch.tools.bench.common import _env_int, _time_fn, device


def bench_rs_encode() -> dict:
    """GF(2⁸) RS parity at the N=100 broadcast shape (34 data, 66 parity)
    on ``gf256_matmul``.  The JAX bench's ``HBBFT_TPU_GF_DOT`` arm (the
    MXU's int8 or bf16 dot) has no counterpart: the kernel takes popcount
    parities and has no dot to choose, which the row's ``gf_dot`` says."""
    import numpy as np
    import torch

    from hbbft_tpu_torch.crypto.erasure import RSCodec
    from hbbft_tpu_torch.ops.gf256 import TorchRSCodec, gf256_matmul

    data, parity = 34, 66  # N=100, f=33: N-2f data + 2f parity
    shard = _env_int("BENCH_RS_SHARD", 16384)
    # cheap kernel: the metric-specific knob wins over the global BENCH_ITERS
    iters = _env_int("BENCH_RS_ITERS", _env_int("BENCH_ITERS", 20))
    codec = TorchRSCodec(data, parity, device=device())
    words = codec._encode_words
    rng = np.random.default_rng(0)
    mat = torch.as_tensor(rng.integers(0, 256, size=(data, shard), dtype=np.uint8),
                          device=codec.device)

    def enc(m):
        return gf256_matmul(words, m)

    dt = _time_fn(enc, (mat,), iters)

    # golden spot check against the host codec
    got = enc(mat).cpu().numpy()
    want = RSCodec(data, parity)._parity(mat.cpu().numpy())
    assert np.array_equal(got, want), "device RS parity wrong"

    mb = data * shard / 1e6
    return {
        "metric": "rs_encode_throughput",
        "value": round(mb / dt, 2),
        "unit": "MB/s",
        "vs_baseline": round(mb / dt / 500.0, 3),  # ~500 MB/s single-core est.
        "baseline": "estimated",
        "batch": shard,
        "gf_dot": None,  # no dot arm: gf256_matmul takes popcount parities
    }


def bench_rs_host() -> dict:
    """RS parity through the codec the protocol stack routes to
    (crypto/erasure.RSCodec → the native GF(2⁸) kernel)."""
    import numpy as np

    from hbbft_tpu_torch.crypto.erasure import RSCodec

    data, parity = 34, 66  # N=100 broadcast shape
    shard = _env_int("BENCH_RS_SHARD", 16384)
    iters = _env_int("BENCH_RS_ITERS", _env_int("BENCH_ITERS", 20))
    codec = RSCodec(data, parity)
    rng = np.random.default_rng(0)
    mat = rng.integers(0, 256, size=(data, shard), dtype=np.uint8)
    codec._parity(mat)  # warm (builds tables / loads the native kernel)
    t0 = time.perf_counter()
    for _ in range(iters):
        codec._parity(mat)
    dt = (time.perf_counter() - t0) / iters
    mb = data * shard / 1e6
    return {
        "metric": "rs_encode_host_throughput",
        "value": round(mb / dt, 2),
        "unit": "MB/s",
        "vs_baseline": round(mb / dt / 500.0, 3),
        "baseline": "estimated",
        "batch": shard,
        "engine": "native-simd",
        "role": "protocol path",
    }


def bench_rs_plane_ab() -> dict:
    """Device erasure/hash plane vs host codec A/B (``rs_plane_ab``): the
    full per-proposer RS+Merkle workload — batched encode, tree build, all
    N² proof verifies, and an m-erasure reconstruct — through
    ``TorchBackend``'s plane methods, at the N=16 shape (k=6, m=10) and
    the N=100 f=33 broadcast shape (k=34, m=66).  HBBFT_TPU_NO_DEVICE_RS
    is read per call, so the host arm runs the protocol codec path
    through the same entry points.  Fresh random blocks per timed
    iteration, golden spot checks against the host codec and hashlib
    trees in both arms, and kill-switch non-leak asserts both ways via
    the rs_enc/merkle device seconds."""
    from hbbft_tpu_torch.crypto.erasure import RSCodec
    from hbbft_tpu_torch.crypto.merkle import MerkleTree, PackedProofs
    from hbbft_tpu_torch.ops.backend import TorchBackend

    shapes = [("n16", 6, 10), ("n100_f33", 34, 66)]
    block = _env_int("BENCH_RS_PLANE_BLOCK", 4096)
    iters = max(1, _env_int("BENCH_RS_PLANE_ITERS", 3))

    def arm(no_device: bool) -> dict:
        saved = os.environ.pop("HBBFT_TPU_NO_DEVICE_RS", None)
        if no_device:
            os.environ["HBBFT_TPU_NO_DEVICE_RS"] = "1"
        try:
            rng = random.Random(419)
            be = TorchBackend(device=device())
            out: dict = {}

            def workload(codec, n, datas):
                sh = be.rs_encode_batch(codec, datas)
                trees = be.merkle_build_batch(sh)
                packed = PackedProofs.from_trees(trees, n, device=not no_device)
                verdicts = (
                    be.merkle_verify_batch(packed)
                    if packed is not None
                    else [t.proof(i).validate(n) for t in trees for i in range(n)]
                )
                holes = [list(s) for s in sh]
                for h in holes:
                    for j in rng.sample(range(n), codec.m):
                        h[j] = None
                rec = be.rs_reconstruct_batch(codec, holes)
                return sh, trees, verdicts, rec

            for label, k, m in shapes:
                codec = RSCodec(k, m)
                n = k + m
                datas = [rng.randbytes(block) for _ in range(n)]
                workload(codec, n, datas)  # warm
                t0 = time.perf_counter()
                for _ in range(iters):
                    datas = [rng.randbytes(block) for _ in range(n)]
                    sh, trees, verdicts, rec = workload(codec, n, datas)
                dt = time.perf_counter() - t0
                # golden spot check, last iteration, both arms
                i = rng.randrange(n)
                assert sh[i] == codec.encode(datas[i]), "A/B arm encode wrong"
                assert trees[i].root_hash == MerkleTree(sh[i]).root_hash, "A/B arm tree wrong"
                assert all(verdicts), "A/B arm verify wrong"
                assert rec[i] == sh[i], "A/B arm reconstruct wrong"
                out[label] = iters * n / dt
            c = be.counters
            out["plane_seconds"] = (
                c.device_seconds_rs_enc + c.device_seconds_rs_dec + c.device_seconds_merkle
            )
            return out
        finally:
            if saved is None:
                os.environ.pop("HBBFT_TPU_NO_DEVICE_RS", None)
            else:
                os.environ["HBBFT_TPU_NO_DEVICE_RS"] = saved

    dev = arm(no_device=False)
    host = arm(no_device=True)
    assert dev["plane_seconds"] > 0, "device arm never dispatched — vacuous A/B"
    assert host["plane_seconds"] == 0, "kill switch leaked into the host arm"
    return {
        "metric": "rs_plane_ab",
        "value": round(dev["n100_f33"], 2),
        "unit": "blocks/s",
        "batch": block,
        "host_blocks_per_sec": round(host["n100_f33"], 2),
        "device_vs_host": round(dev["n100_f33"] / host["n100_f33"], 3),
        "n16_blocks_per_sec": round(dev["n16"], 2),
        "n16_host_blocks_per_sec": round(host["n16"], 2),
        "n16_device_vs_host": round(dev["n16"] / host["n16"], 3),
    }


def bench_fq_kernel() -> dict:
    """Raw Fq-multiply throughput, RNS vs limb, through
    ``hbbft_tpu_torch.tools.kernel_bench`` in this process.  The JAX bench
    runs one child process an arm because its field facade
    (``HBBFT_TPU_FQ_IMPL``) is bound at import; the port's kernel bench
    calls both arms' kernels directly, so one call times both:
    ``fq_rns_mul``, ``fq_limb_mul`` and ``fq_rns_chain`` at the
    ``BENCH_FQ_LANES`` widths with ``BENCH_FQ_CHAIN`` products a chain,
    then the FMA probe (at kernel_bench's tile unless
    ``BENCH_FQ_PROBE_SHAPE``/``BENCH_FQ_PROBE_ITERS`` say).  The value is
    the RNS product's rate at the last width; the baseline is the limb
    product's rate there, from the same run (``vs_baseline`` = RNS over
    limb).  The kernel bench's rows and the probe's result ride the row."""
    from hbbft_tpu_torch.tools import kernel_bench

    lanes = os.environ.get("BENCH_FQ_LANES", "65536")
    probe = {}
    if os.environ.get("BENCH_FQ_PROBE_SHAPE"):
        probe["probe_shape"] = kernel_bench._shape(os.environ["BENCH_FQ_PROBE_SHAPE"])
    if os.environ.get("BENCH_FQ_PROBE_ITERS"):
        probe["probe_iters"] = int(os.environ["BENCH_FQ_PROBE_ITERS"])
    res = kernel_bench.run(device(), [int(v) for v in lanes.split(",")],
                           _env_int("BENCH_FQ_CHAIN", 200), log=lambda _line: None, **probe)

    def rate(kernel: str) -> float:
        return [r for r in res["rows"] if r["kernel"] == kernel][-1]["m_muls_per_s"]

    rns_rate, limb_rate = rate("fq_rns_mul"), rate("fq_limb_mul")
    return {
        "metric": "fq_mul_throughput",
        "value": round(rns_rate * 1e6, 0),
        "unit": "muls/s",
        "vs_baseline": round(rns_rate / limb_rate, 3) if limb_rate else None,
        "baseline": "limb arm, same run",
        "impl": "rns",
        "limb_muls_per_sec": round(limb_rate * 1e6, 0),
        "rns_vs_limb": round(rns_rate / limb_rate, 2) if limb_rate else None,
        "lanes": lanes,
        "chain_muls_per_sec": round(rate("fq_rns_chain") * 1e6, 0),
        "card": res["card"],
        "chain": res["chain"],
        "probe": res["probe"],
        "rows": res["rows"],
    }

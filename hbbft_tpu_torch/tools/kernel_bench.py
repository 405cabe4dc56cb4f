"""Field-multiply throughput and the float32 FMA probe on the card: the
port's counterpart of the JAX package's ``tools/kernel_bench.py``.

    python -m hbbft_tpu_torch.tools.kernel_bench            # on the card
    python -m hbbft_tpu_torch.tools.kernel_bench --device cpu --lanes 8 \\
        --chain 2 --probe-shape 4x8 --probe-iters 10        # plain versions
    python -m hbbft_tpu_torch.tools.kernel_bench --launch    # per-launch times
    python -m hbbft_tpu_torch.tools.kernel_bench --launch \\
        --launch-lanes hard_exp=796 --hard-lb 1,2,4           # hard_exp's LB sweep

At each width (lanes; default 4k/16k/64k/256k) it times

* ``fq_rns_mul`` and ``fq_limb_mul`` per launch: a chain of ``--chain``
  dependent launches x ← x·b between two CUDA events, so no launch
  overlaps the next;
* ``fq_rns_chain``: one launch of ``--chain`` products x ← x·b;

and reports ms per launch (per product for the chain) and M muls/s.

With ``--launch`` it times instead one launch of each kernel of the
epoch path — ``fq_rns_mul``, ``miller_dbl``, ``tower_op`` (its
``fq12_mul``) and ``hard_exp`` at the path's mean widths, ``fq_rns_pow``
at its narrowest and widest launches — of the limb arm's
``fq_limb_mul`` and ``fq_limb_pow`` (e = Q−2) at that path's mean widths,
and of ``fq_rns_chain`` (``CHAIN`` products) at the bench's mean width and
one wave (``--launch-lanes`` picks kernels and widths), each three ways: one call between two CUDA events, as
``chip_smoke.time_ms`` does (so it also counts the host's launch
latency); per call of ``STREAM`` back-to-back calls between two events
(the card waits on the host only where a call's host work outlasts its
kernels); and, on the card, the kernel time per call of ``STREAM`` calls
that ``torch.profiler`` reads (the card's time alone).  Only public wrappers that
every version of the port has are called, so this file can time another
checkout's package: run it as a script with that checkout's root on
``PYTHONPATH``.  ``--hard-lb`` adds ``hard_exp`` at the given lanes per
block (this checkout's wrapper only), each checked equal to the default
sizing's result.  On the card it then prints the compiler's register
and spill lines of the RNS and tower libraries (``-Xptxas -v``) and the
occupancy queries the wrappers have.  Both
field arms run in this one process: their kernels are called directly,
not through the ``HBBFT_TPU_FQ_IMPL`` facade.  Then the FMA probe
(``fma_probe``) at a tile that fills the card's 132 SMs several times
over reports TFLOP/s float32 and its share of the H100's 67 TFLOP/s.

Operands are random rows with every lane in [0, 256): valid residue rows
and canonical limb rows alike.  The work does not depend on the values.

Every result line names the device, and on the card the card's name and
power limit as ``nvidia-smi`` reports them.  On the CPU (only when
``--device cpu`` is given) the numbers are the plain versions' host
times, not device metrics.  The last line is the results as one JSON
object.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from hbbft_tpu_torch.crypto.field import Q
from hbbft_tpu_torch.ops import fq_limb_cuda, fq_rns_cuda, probe_cuda
from hbbft_tpu_torch.ops import tower_fused, tower_fused_cuda
from hbbft_tpu_torch.utils.device import resolve

LANES = (4096, 16384, 65536, 262144)
CHAIN = 200
#: 2112 x 1024 elements: 8 threads' worth for each of 132 SMs x 2048 threads
PROBE_SHAPE = (2112, 1024)
PROBE_ITERS = probe_cuda.REF_ITERS
FP32_PEAK_TFLOPS = 67.0  # H100 SXM, float32 outside the tensor cores, 700 W
#: per-launch widths: the mean launch widths of two N=100 epochs, and
#: fq_rns_pow's narrowest and widest launches (no launch has its mean;
#: 2,048 lanes on two epochs) and the top of the widest class, 4,095; the
#: limb arm's means; the chain at the bench's mean (87,040 lanes) and one
#: wave of one-warp blocks (4,096)
LAUNCH_LANES = {"fq_rns_mul": (191251,), "miller_dbl": (1593,), "tower_op": (796,),
                "hard_exp": (796,), "fq_rns_pow": (1, 2048, 4095),
                "fq_limb_mul": (35450,), "fq_limb_pow": (14,),
                "fq_rns_chain": (87040, 4096)}
#: back-to-back calls per sample of the second per-launch timing
STREAM = 50


def card_line(dev: torch.device) -> str:
    """The card's name and power limit (``nvidia-smi``), or the CPU."""
    if dev.type != "cuda":
        return "cpu (plain versions, host clock; not a device metric)"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader",
         "-i", str(dev.index or 0)],
        capture_output=True, text=True, timeout=60,
    )
    lines = out.stdout.strip().splitlines()
    return lines[0] if out.returncode == 0 and lines else "nvidia-smi unavailable"


def seconds_per_call(fn, dev: torch.device, reps: int = 5) -> float:
    """Median seconds of fn() after one warm-up: CUDA events on the card,
    the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if dev.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / 1e3)
        else:
            t = time.perf_counter()
            fn()
            times.append(time.perf_counter() - t)
    times.sort()
    return times[len(times) // 2]


def ms_per_launch(fn, dev: torch.device, reps: int = 7) -> dict:
    """Median ms of one fn() after one warm-up: ``single`` one call between
    two CUDA events, ``stream`` per call of STREAM back-to-back calls (on
    the CPU both are the host clock's, per call); on the card also
    ``device``, the kernel time per call (``device_ms_per_call``)."""
    out = {"single": seconds_per_call(fn, dev, reps) * 1e3,
           "stream": seconds_per_call(_repeat(fn, STREAM), dev, reps) * 1e3 / STREAM}
    if dev.type == "cuda":
        out["device"] = device_ms_per_call(fn)
    return out


def device_ms_per_call(fn, n: int = STREAM) -> float:
    """The card's kernel time per call of fn: every kernel that n
    back-to-back calls launch, summed by torch.profiler, over n."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    us = sum(e.self_device_time_total for e in prof.key_averages()
             if getattr(e, "device_type", None) == DeviceType.CUDA)
    return us / 1e3 / n


def _ms_text(ms: dict) -> str:
    text = (f"{ms['single']:.4f} ms one call, {ms['stream']:.4f} ms a call of {STREAM} "
            f"back to back")
    if "device" in ms:
        text += f", {ms['device']:.4f} ms of kernel time a call"
    return text


def _launch_fn(name: str, n: int, rng, dev):
    """One call of kernel ``name`` at n lanes (its plain version on the
    CPU), on random operands: the work does not depend on the values."""
    nl = fq_rns_cuda.NL
    cuda = dev.type == "cuda"
    if name == "fq_rns_mul":
        a, b = _rows(rng, n, nl, dev), _rows(rng, n, nl, dev)
        return lambda: fq_rns_cuda.mul(a, b)
    if name == "fq_rns_pow":
        x = _rows(rng, n, nl, dev)
        return lambda: fq_rns_cuda.pow_fixed(x, Q - 2)
    if name == "fq_rns_chain":
        a, b = _rows(rng, n, nl, dev), _rows(rng, n, nl, dev)
        return lambda: fq_rns_cuda.mul_chain(a, b, CHAIN)
    if name == "fq_limb_mul":
        a, b = _rows(rng, n, fq_limb_cuda.NL, dev), _rows(rng, n, fq_limb_cuda.NL, dev)
        return lambda: fq_limb_cuda.mul(a, b)
    if name == "fq_limb_pow":
        x = _rows(rng, n, fq_limb_cuda.NL, dev)
        return lambda: fq_limb_cuda.pow_fixed(x, Q - 2)
    if name == "miller_dbl":
        f, r, p = (_rows(rng, c * n, nl, dev).reshape(c, n, -1) for c in (12, 6, 2))
        dbl = tower_fused_cuda.miller_dbl if cuda else tower_fused.dbl_plain
        return lambda: dbl(f, r, p)
    a, b = (_rows(rng, 12 * n, nl, dev).reshape(12, n, -1) for _ in range(2))
    if name == "tower_op":
        k = tower_fused.OP_KINDS.index("fq12_mul")
        if cuda:
            return lambda: tower_fused_cuda.tower_op(k, a, b)
        return lambda: tower_fused.op_plain("fq12_mul", a, b)
    if name == "hard_exp":
        return lambda: (tower_fused_cuda.hard_exp if cuda else tower_fused.hard_plain)(a)
    raise ValueError(f"unknown kernel {name!r}")


def launch_run(device="cuda", lanes=None, hard_lb=(), log=print) -> dict:
    """Per-launch ms of each kernel at each of its widths (``lanes``: name
    → widths, default LAUNCH_LANES); ``hard_lb``: hard_exp's lanes per
    block to time besides the default sizing, at hard_exp's widths."""
    dev = resolve(device)
    card = card_line(dev)
    rng = np.random.default_rng(0)
    lanes = lanes or LAUNCH_LANES
    rows = []
    for name, widths in lanes.items():
        for n in widths:
            ms = ms_per_launch(_launch_fn(name, n, rng, dev), dev)
            rows.append({"kernel": name, "lanes": n, **ms})
            log(f"kernel_bench launch {name} lanes={n}: {_ms_text(ms)} [{card}]")
    if hard_lb and dev.type != "cuda":
        raise ValueError("--hard-lb sweeps the kernel: it needs the card")
    for n in lanes.get("hard_exp", ()) if hard_lb else ():
        m = _rows(rng, 12 * n, fq_rns_cuda.NL, dev).reshape(12, n, -1)
        want = tower_fused_cuda.hard_exp(m)
        for lb in hard_lb:
            if not torch.equal(tower_fused_cuda.hard_exp(m, lb=lb), want):
                raise AssertionError(f"hard_exp at LB={lb} differs from the default sizing")
            ms = ms_per_launch(lambda: tower_fused_cuda.hard_exp(m, lb=lb), dev)
            rows.append({"kernel": "hard_exp", "lanes": n, "lb": lb, **ms})
            log(f"kernel_bench launch hard_exp lanes={n} LB={lb}: {_ms_text(ms)} [{card}]")
    res = {"device": str(dev), "card": card, "launch": rows}
    if dev.type == "cuda":
        res["build"] = build_report(dev, log)
    return res


def build_report(dev, log=print, sources=("fq_rns", "tower_fused")) -> dict:
    """The compiler's entry, register, spill and error lines of the named
    libraries (``-Xptxas -v``), and the blocks per SM of each occupancy
    query of their kernels that this checkout's wrappers have (a query a
    version lacks is left out).  ``chip_smoke.py`` prints it for all four
    libraries, ``--launch`` for the RNS and tower ones."""
    from hbbft_tpu_torch.utils import cuda_build

    ptxas = {name: [ln.strip() for ln in cuda_build.build_log(name).splitlines()
                    if any(w in ln for w in ("Compiling entry", "registers", "spill", "error"))]
             for name in sources}
    for name, lines in ptxas.items():
        for ln in lines:
            log(f"  ptxas {name}: {ln}")
    occ = {}
    for name, mod, kinds in (("fq_rns", fq_rns_cuda, ("mul", "pow", "chain")),
                             ("fq_limb", fq_limb_cuda, ("mul", "pow"))):
        for kind in kinds if name in sources else ():
            query = getattr(mod, f"{kind}_blocks_per_sm", None)
            if query is not None:
                occ[f"{name}_{kind}"] = query(dev)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for kernel in ("tower_op", "miller_dbl", "hard_exp") if "tower_fused" in sources else ():
        if kernel in getattr(tower_fused_cuda, "_BLOCKS_PER_SM", {}):
            occ[kernel] = tower_fused_cuda.resident_blocks(dev, kernel) // sms
    log(f"occupancy, blocks of 128 threads per SM: {json.dumps(occ)} [{card_line(dev)}]")
    return {"ptxas": ptxas, "blocks_per_sm": occ}


def _launch_lanes(text: str) -> dict:
    """``name=n[/n...],...`` → {name: (n, ...)}."""
    out = {}
    for item in text.split(","):
        name, _, widths = item.partition("=")
        out[name.strip()] = tuple(int(v) for v in widths.split("/"))
    return out


def _rows(rng, lanes: int, width: int, dev) -> torch.Tensor:
    return torch.as_tensor(rng.integers(0, 256, size=(lanes, width)).astype(np.float32),
                           device=dev)


def _repeat(fn, n: int):
    def run():
        for _ in range(n):
            fn()

    return run


def _launch_chain(mul, a, b, n: int):
    def run():
        x = a
        for _ in range(n):
            x = mul(x, b)
        return x

    return run


def run(device="cuda", lanes=LANES, chain: int = CHAIN, probe_shape=PROBE_SHAPE,
        probe_iters: int = PROBE_ITERS, log=print) -> dict:
    """Measure everything; log one line per result; return the results."""
    dev = resolve(device)
    card = card_line(dev)
    rng = np.random.default_rng(0)
    log(f"kernel_bench device={dev} chain={chain} [{card}]")
    rows = []
    for n in lanes:
        for name, mul, width in (("fq_rns_mul", fq_rns_cuda.mul, fq_rns_cuda.NL),
                                 ("fq_limb_mul", fq_limb_cuda.mul, fq_limb_cuda.NL)):
            a, b = _rows(rng, n, width, dev), _rows(rng, n, width, dev)
            per = seconds_per_call(_launch_chain(mul, a, b, chain), dev) / chain
            rows.append({"kernel": name, "lanes": n, "ms": per * 1e3,
                         "m_muls_per_s": n / per / 1e6})
            log(f"kernel_bench {name} lanes={n}: {per * 1e3:.4f} ms/launch, "
                f"{n / per / 1e6:.2f} M muls/s [{card}]")
        a, b = _rows(rng, n, fq_rns_cuda.NL, dev), _rows(rng, n, fq_rns_cuda.NL, dev)
        per = seconds_per_call(lambda: fq_rns_cuda.mul_chain(a, b, chain), dev) / chain
        rows.append({"kernel": "fq_rns_chain", "lanes": n, "ms": per * 1e3,
                     "m_muls_per_s": n / per / 1e6})
        log(f"kernel_bench fq_rns_chain lanes={n}: {per * 1e3:.4f} ms/mul ({chain} per "
            f"launch), {n / per / 1e6:.2f} M muls/s [{card}]")

    x = torch.as_tensor(rng.random(probe_shape, dtype=np.float32), device=dev)
    secs = seconds_per_call(lambda: probe_cuda.fma_probe(x, probe_iters), dev, reps=3)
    tflops = probe_cuda.flops(x.numel(), probe_iters) / secs / 1e12
    probe = {"shape": list(probe_shape), "iters": probe_iters, "ms": secs * 1e3,
             "tflops": tflops, "share_of_peak": tflops / FP32_PEAK_TFLOPS}
    log(f"kernel_bench fma_probe {probe_shape[0]}x{probe_shape[1]} x {probe_iters} steps, "
        f"{probe_cuda.CHAINS} independent chains: {secs * 1e3:.4f} ms, {tflops:.3f} TFLOP/s "
        f"f32 = {tflops / FP32_PEAK_TFLOPS:.1%} of {FP32_PEAK_TFLOPS:.0f} TFLOP/s [{card}]")
    return {"device": str(dev), "card": card, "chain": chain, "rows": rows, "probe": probe}


def _shape(text: str) -> tuple:
    return tuple(int(v) for v in text.lower().split("x"))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--lanes", default=",".join(map(str, LANES)),
                    help="comma-separated widths")
    ap.add_argument("--chain", type=int, default=CHAIN,
                    help="dependent launches per timing (products per chain launch)")
    ap.add_argument("--probe-shape", type=_shape, default=PROBE_SHAPE, help="ROWSxCOLS")
    ap.add_argument("--probe-iters", type=int, default=PROBE_ITERS)
    ap.add_argument("--launch", action="store_true",
                    help="time one launch of each kernel of the epoch path instead")
    ap.add_argument("--launch-lanes", type=_launch_lanes, default=None,
                    help="NAME=N[/N...],...: the kernels and widths under --launch "
                         "(default: each epoch kernel at its path widths)")
    ap.add_argument("--hard-lb", default="",
                    help="L,L,...: under --launch, hard_exp also at these lanes per block")
    args = ap.parse_args(argv)
    if args.launch:
        res = launch_run(args.device, args.launch_lanes,
                         tuple(int(v) for v in args.hard_lb.split(",") if v))
        print(json.dumps(res))
        return res
    res = run(args.device, [int(v) for v in args.lanes.split(",")], args.chain,
              args.probe_shape, args.probe_iters)
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()

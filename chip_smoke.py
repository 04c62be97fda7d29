"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

It drives ``repro_torch`` only (no JAX, nothing of the ``repro`` package):

1. prints the card's name and power limit (``nvidia-smi``), builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` and prints the build
   time and ``ptxas`` resource lines;
2. holds each of the four fused Lorenzo kernels against its plain
   PyTorch version on the card, on ragged small sizes, on the shapes of
   the allreduce (one pipelined-ring piece and one sequential-ring chunk
   of the 646 MB run) and on an overflowing stream: words ``[:cap]``, bw,
   anchor and nwords must be equal and every f32 output bitwise equal;
   prints the mismatch counts and each kernel's median time against its
   bound;
3. holds the three unfused kernels (``quantize``, ``dequantize``,
   ``dequantize_reduce``) against their plain versions the same way, on
   ragged sizes, on NaN, +-Inf and values past the int32 range of q, on
   codes whose prefix sum wraps in int32, and at the scatter's shape (8
   chunks of 20,187,500 elements, 630,912 rows in one ``quantize``);
4. runs the allreduce, ``GZCommunicator("x").allreduce`` over a
   ``ThreadGroup`` of ranks on the card, at 646 MB per rank with 8 ranks
   (plan ``ring``, 2 pieces, profiled), 16 MB with 8 ranks (``redoub``)
   and 16 MB with 6 ranks (``redoub`` with the remainder stage), then a
   4 MB allreduce through the kernels and through the plain versions
   (bitwise equal);
5. runs this slice's main path, ``GZCommunicator("x").scatter`` of 646 MB
   at the root over 8 ranks (plan ``binomial``, 343,566,440 wire bytes,
   7 root chunk streams; non-root inputs are NaN, which must not count),
   profiled, and a 64 MB scatter over 6 ranks (the trimmed tree);
6. runs ``broadcast``, ``allgather`` and ``reduce_scatter`` (1 and 2
   pieces) and ``all_to_all`` at 16 MB per rank over 8 ranks, each once
   through the kernels and once through the plain versions (bitwise
   equal);
7. runs the two-pass paths, 16 MB x 8 allreduces with ``fused=False``
   (redoub and ring/2) and ``fused_hop=False`` (ring/2), each bitwise
   equal to the fused run on the same inputs.

Every collective run starts with the launch counts at 0 and must launch
each kernel exactly as often as its schedule says, stay within its error
bound, and not overflow.

The third-to-last line is the card's ``nvidia-smi`` name and power
limit, the second-to-last one JSON object with a record per kernel, the
last ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA card, or without the package
beside it, it prints no result and exits 2.
"""
import contextlib
import json
import math
import os
import pathlib
import subprocess
import sys
import threading
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/lorenzo.cu"
ENTROPY_SOURCE = "src/repro_torch/kernels/csrc/entropy.cu"
ENTROPY_KERNELS = ("entropy_quantize_pack", "entropy_unpack_dequantize",
                   "entropy_unpack_dequantize_reduce")
ENTROPY_CODECS = ("lorenzo+entropy", "lossless")
REPLACES = {
    "quantize_pack": "src/repro/kernels/lorenzo.py:392",
    "unpack_reduce_repack": "src/repro/kernels/lorenzo.py:324",
    "unpack_dequantize_reduce": "src/repro/kernels/lorenzo.py:456",
    "unpack_dequantize": "src/repro/kernels/lorenzo.py:426",
    "quantize": "src/repro/kernels/lorenzo.py:110",
    "dequantize": "src/repro/kernels/lorenzo.py:134",
    "dequantize_reduce": "src/repro/kernels/lorenzo.py:491",
    "entropy_quantize_pack": "src/repro/kernels/entropy.py:230",
    "entropy_unpack_dequantize": "src/repro/kernels/entropy.py:263",
    "entropy_unpack_dequantize_reduce": "src/repro/kernels/entropy.py:289",
}
MAIN_BYTES = 646_000_000  # per rank (allreduce) / at the root (scatter): Figs. 10, 12
SCATTER_WIRE_BYTES = 343_566_440  # benchmarks/BENCH_scatter.json, N = 8
MOVER_BYTES = 16_000_000  # per rank: the data movers and the two-pass paths
EB = 1e-4  # GZConfig's default end-to-end bound


def log(*a):
    print(*a, flush=True)


def _reset_launches():
    from repro_torch.kernels import entropy, lorenzo

    lorenzo.reset_launch_counts()
    entropy.reset_launch_counts()


def _launches():
    """Every kernel's launch count since the last reset (the entropy
    kernels under their ``entropy_`` names)."""
    from repro_torch.kernels import entropy, lorenzo

    return {**lorenzo.LAUNCHES, **{f"entropy_{k}": v for k, v in entropy.LAUNCHES.items()}}


def _median_ms(fn, reps):
    import torch

    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return sorted(times)[len(times) // 2]


def _random_walk(n, gen, device):
    """Seeded random-walk field: cumsum of N(0, 0.01) steps (f64 -> f32)."""
    import torch

    steps = torch.randn(n, dtype=torch.float64, generator=gen, device=device)
    return torch.cumsum(steps.mul_(0.01), 0).to(torch.float32)


# ---------------------------------------------------------------------------
# Phase 2: each kernel against its plain version
# ---------------------------------------------------------------------------


def _mismatch(a, b):
    """(count, max |a - b|) of two equally shaped tensors, f32 compared by bits."""
    import torch

    if a.shape != b.shape:
        raise AssertionError(f"shape {tuple(a.shape)} != {tuple(b.shape)}")
    if a.dtype == torch.float32:
        diff = a.view(torch.int32) != b.view(torch.int32)
        err = (a.double() - b.double()).abs().max().item() if a.numel() else 0.0
    else:
        diff = a != b
        err = (a.long() - b.long()).abs().max().item() if a.numel() else 0
    return int(diff.sum().item()), float(err)


def _compare(name, got, want):
    total, err = 0, 0.0
    for g, w in zip(got, want):
        m, e = _mismatch(g, w)
        total += m
        err = max(err, e)
    if total:
        raise AssertionError(f"{name}: {total} elements differ from the plain version")
    return err


def _bytes(name, n, nb, cap_in, words_in, cap_out, emit):
    """Bytes the function must move: each input read once, each output
    written once; a received stream is read only up to its true length."""
    meta = 8 * nb  # bw + anchor
    if name == "quantize_pack":
        return 4 * n + 4 * cap_out + meta
    read = 4 * min(words_in, cap_in) + meta
    if name == "unpack_dequantize":
        return read + 4 * n
    if name == "unpack_dequantize_reduce":
        return read + 8 * n
    return read + 4 * n + 4 * cap_out + meta + (4 * n if emit else 0)


def check_kernels(device, gen):
    import torch

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import lorenzo, ops

    piece_n = _main_piece_elems()
    chunk_n = -(-MAIN_BYTES // 4 // 8)
    eb_in = torch.full((), EB / 8, dtype=torch.float32, device=device)
    eb_out = torch.full((), EB / 7, dtype=torch.float32, device=device)
    cases = [  # (label, n, capacity_factor, timed)
        ("ragged", 2048 * 3 + 5, 0.6, False),
        ("ragged", 37, 0.6, False),
        ("ragged", 256 * 9 + 200, 2.0, False),
        ("overflow", 300_000, 0.05, False),
        ("ring-chunk", chunk_n, 0.6, False),
        ("ring-piece", piece_n, 0.6, True),
    ]
    records = {}
    for label, n, cf, timed in cases:
        x2d = ops.to_blocks(_random_walk(n, gen, device) * 8.0)
        acc = ops.to_blocks(_random_walk(n, gen, device))
        nb = x2d.shape[0]
        cap = capacity_words_for(n, cf, ops.BLOCK)
        stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap)
        words_in = int(stream[1].long().sum().item()) * 8
        calls = {
            "quantize_pack": ((x2d, eb_in, cap), {}),
            "unpack_reduce_repack": ((*stream, eb_in, acc, eb_out, cap), {"emit_f32": True}),
            "unpack_dequantize_reduce": ((*stream, eb_in, acc), {}),
            "unpack_dequantize": ((*stream, eb_in), {}),
        }
        line = []
        for name, (args, kw) in calls.items():
            kern = getattr(lorenzo, name)
            plain = getattr(lorenzo, f"{name}_plain")
            got, want = kern(*args, **kw), plain(*args, **kw)
            torch.cuda.synchronize()
            got = got if isinstance(got, tuple) else (got,)
            want = want if isinstance(want, tuple) else (want,)
            err = _compare(f"{name} [{label} n={n}]", got, want)
            if name in ("quantize_pack", "unpack_reduce_repack"):
                nw_got = int(got[1].long().sum()) * 8
                nw_want = int(want[1].long().sum()) * 8
                if nw_got != nw_want:
                    raise AssertionError(f"{name}: nwords {nw_got} != {nw_want}")
                if label == "overflow" and nw_got <= cap:
                    raise AssertionError(f"{name}: overflow case did not overflow")
            line.append(f"{name}=0/{sum(g.numel() for g in got)}")
            if timed:
                emit = kw.get("emit_f32", False)
                nbytes = _bytes(name, nb * ops.BLOCK, nb, cap, words_in, cap, emit)
                records[name] = {
                    "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": REPLACES[name], "launches": None,
                    "max_abs_err": err,
                    "ms": _median_ms(lambda: kern(*args, **kw), 20),
                    "plain_ms": _median_ms(lambda: plain(*args, **kw), 5),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None,
                    "shape": [nb, ops.BLOCK], "bytes": nbytes,
                }
        log(f"kernels vs plain [{label} n={n} cap={cap} nwords_in={words_in}]: "
            f"mismatches {' '.join(line)}")
    for r in records.values():
        log(f"  {r['name']:<26} {r['ms']:.4f} ms  plain {r['plain_ms']:.3f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB)")
    return records


def _wild(n, gen, device):
    """Random-walk data with NaN, +-Inf and values whose q passes the int32
    range at eb = 1e-4 (the quantizer saturates them)."""
    import torch

    x = _random_walk(n, gen, device) * 100.0
    x[::97] = float("nan")
    x[5::89] = float("inf")
    x[7::83] = float("-inf")
    x[11::79] = 5e5
    x[13::71] = -1e30
    return x


def _wrapping_codes(nb, gen, device):
    """Full-range random codes and anchors: the in-block prefix sum wraps
    in int32 in nearly every block."""
    import torch

    codes = torch.randint(-2**31, 2**31, (nb, 256), generator=gen, device=device,
                          dtype=torch.int64).to(torch.int32)
    anchor = torch.randint(-2**31, 2**31, (nb,), generator=gen, device=device,
                           dtype=torch.int64).to(torch.int32)
    return codes, anchor


def _unfused_bytes(name, nb):
    """Bytes the unfused kernel must move: inputs once, outputs once."""
    n = nb * 256
    if name == "quantize":
        return 4 * n + 4 * n + 8 * nb  # x in; codes, bw, anchor out
    if name == "dequantize":
        return 4 * n + 4 * nb + 4 * n  # codes, anchor in; f32 out
    return 4 * n + 4 * nb + 8 * n  # + acc in


def check_unfused_kernels(device, gen):
    import torch

    from repro_torch.kernels import lorenzo, ops

    eb = torch.full((), EB, dtype=torch.float32, device=device)
    chunk_n = MAIN_BYTES // 4 // 8
    cases = [  # (label, x2d, timed)
        ("ragged n=37", ops.to_blocks(_random_walk(37, gen, device)), False),
        ("ragged n=6149", ops.to_blocks(_random_walk(2048 * 3 + 5, gen, device)), False),
        ("ragged n=2504", ops.to_blocks(_random_walk(256 * 9 + 200, gen, device)), False),
        ("nan/inf/saturating", ops.to_blocks(_wild(300_000, gen, device)), False),
    ]
    x = torch.zeros((8, ops.n_blocks_for(chunk_n) * ops.BLOCK), device=device)
    x[:, :chunk_n] = _random_walk(8 * chunk_n, gen, device).view(8, chunk_n)
    cases.append(("scatter shape", x.view(-1, ops.BLOCK), True))
    del x
    records = {}
    for label, x2d, timed in cases:
        nb = x2d.shape[0]
        acc = _random_walk(nb * ops.BLOCK, gen, device).view(nb, ops.BLOCK)
        got = lorenzo.quantize(x2d, eb)
        want = lorenzo.quantize_plain(x2d, eb)
        torch.cuda.synchronize()
        errs = {"quantize": _compare(f"quantize [{label}]", got, want)}
        codes, _, anchor = got
        calls = {
            "quantize": (x2d, eb),
            "dequantize": (codes, anchor, eb),
            "dequantize_reduce": (codes, anchor, eb, acc),
        }
        for name in ("dequantize", "dequantize_reduce"):
            errs[name] = _compare(f"{name} [{label}]",
                                  (getattr(lorenzo, name)(*calls[name]),),
                                  (getattr(lorenzo, f"{name}_plain")(*calls[name]),))
        log(f"unfused kernels vs plain [{label}, {nb} rows]: mismatches 0 in "
            f"codes/bw/anchor and both f32 outputs")
        if timed:
            for name, args in calls.items():
                kern = getattr(lorenzo, name)
                plain = getattr(lorenzo, f"{name}_plain")
                nbytes = _unfused_bytes(name, nb)
                records[name] = {
                    "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": REPLACES[name], "launches": None,
                    "max_abs_err": errs[name],
                    "ms": _median_ms(lambda: kern(*args), 20),
                    "plain_ms": _median_ms(lambda: plain(*args), 3),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None,
                    "shape": [nb, ops.BLOCK], "bytes": nbytes,
                }
        del calls, got, want, codes, anchor, acc
    codes, anchor = _wrapping_codes(4096, gen, device)
    acc = _random_walk(4096 * 256, gen, device).view(4096, 256) * 1e6
    for name, args in (("dequantize", (codes, anchor, eb)),
                       ("dequantize_reduce", (codes, anchor, eb, acc))):
        _compare(f"{name} [int32 wrap]", (getattr(lorenzo, name)(*args),),
                 (getattr(lorenzo, f"{name}_plain")(*args),))
    log("unfused kernels vs plain [int32-wrapping prefix sums, 4096 rows]: mismatches 0")
    for r in records.values():
        log(f"  {r['name']:<26} {r['ms']:.4f} ms  plain {r['plain_ms']:.3f} ms  "
            f"bound {r['bound_ms']:.4f} ms ({r['bytes'] / 1e6:.1f} MB)")
    torch.cuda.empty_cache()
    return records


def _main_piece_elems():
    from repro_torch.core.collectives import PIECE_QUANTUM

    n = MAIN_BYTES // 4
    quantum = 8 * 2 * PIECE_QUANTUM
    return -(-n // quantum) * quantum // 16


# ---------------------------------------------------------------------------
# Phase 3/4: the main path
# ---------------------------------------------------------------------------


def _expected_launches(plan, n):
    """Per-kernel launches of one call over all n ranks, from the
    schedule.  ``compress``, ``decompress`` and ``reduce`` are the
    codec's kernels: the fused Lorenzo kernels, with ``fused=False``
    ``quantize``, ``dequantize`` and ``dequantize_reduce``, or the entropy
    kernels 8-10 (the entropy codecs' ``fused=False`` stages and
    ``passthrough`` launch none); a reduce hop is one
    ``unpack_reduce_repack`` with the fused Lorenzo codec and hop, else a
    reduce and a compress.  The scatter and the all-to-all compress their
    Lorenzo chunks in one batched ``quantize``, other codecs chunk by
    chunk."""
    e = dict.fromkeys(_launches(), 0)
    if plan.codec == "lorenzo":
        comp, dec, red = (("quantize_pack", "unpack_dequantize", "unpack_dequantize_reduce")
                          if plan.fused else ("quantize", "dequantize", "dequantize_reduce"))
    elif plan.codec in ENTROPY_CODECS and plan.fused:
        comp, dec, red = ENTROPY_KERNELS
    else:
        return e
    chunked = plan.codec != "lorenzo"
    single_pass = plan.codec == "lorenzo" and plan.fused and plan.fused_hop
    p = plan.pipeline_chunks
    if plan.op in ("allreduce", "reduce_scatter") and plan.algo == "ring":
        hops = (n - 2) * p  # intermediate reduce hops per rank
        if single_pass:
            e["quantize_pack"] += p * n
            e["unpack_reduce_repack"] += hops * n
        else:
            e[comp] += (hops + p) * n
            e[red] += hops * n
        e[red] += p * n
        if plan.op == "allreduce":  # the allgather stage
            e[comp] += p * n
            e[dec] += p * n * n
    elif plan.op == "allreduce":  # redoub
        pw = 1 << (n.bit_length() - 1)
        rem, steps = n - pw, pw.bit_length() - 1
        hops = steps - 1 + (2 if rem else 0)
        e[comp] += n
        if single_pass:
            e["unpack_reduce_repack"] += hops * n
        else:
            e[comp] += hops * n
            e[red] += hops * n
        if not rem:
            e[red] += n
        e[dec] += rem
    elif plan.op == "allgather":
        e[comp] += p * n
        e[dec] += p * n * n
    elif plan.op == "broadcast":
        e[comp] += n
        e[dec] += n
    elif plan.op == "scatter":  # at the root only
        e[comp if chunked else "quantize"] += n if chunked else 1
        e[dec] += n
    elif plan.op == "all_to_all":
        e[comp if chunked else "quantize"] += n * n if chunked else n
        e[dec] += n * n
    return e


def _check_launches(plan, n, launches):
    expected = _expected_launches(plan, n)
    if launches != expected:
        raise AssertionError(f"{plan.op}: launch counts {launches} != schedule's {expected}")


def _nonzero(launches):
    return {k: v for k, v in launches.items() if v}


def run_allreduce(n, nbytes, device, gen, config_kw=None, label="", profile=False):
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n_elems = nbytes // 4
    xs, exact = [], None
    for _ in range(n):
        x = _random_walk(n_elems, gen, device)
        exact = x.double() if exact is None else exact.add_(x.double())
        xs.append(x)
    comm = GZCommunicator("x", config=GZConfig(**(config_kw or {})), axis_size=n,
                          device=device)
    plan = comm.plan("allreduce", (n_elems,))
    group = transport.ThreadGroup(n, device)
    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = group.run(comm.allreduce, xs, axis_name="x")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = _launches()
    outs = [r.value for r in res]
    overflow = any(bool(r.overflow) for r in res)
    nonfinite = any(bool(r.nonfinite) for r in res)
    err = max((o.double() - exact).abs().max().item() for o in outs)
    bound = EB * 1.05 + exact.abs().max().item() * 1e-6
    spread = max((o != outs[0]).sum().item() for o in outs)
    log(f"allreduce {label} N={n} {nbytes / 1e6:.0f} MB/rank: algo={plan.algo} "
        f"pipeline_chunks={plan.pipeline_chunks} wire_bytes={plan.wire_bytes} "
        f"ratio={plan.ratio:.4f} wall={wall * 1e3:.1f} ms err={err:.3e} "
        f"bound={bound:.3e} overflow={overflow} rank_mismatch={spread} "
        f"launches={_nonzero(launches)}")
    _check_launches(plan, n, launches)
    if overflow or nonfinite:
        raise AssertionError(f"overflow={overflow} nonfinite={nonfinite}")
    if not err <= bound:
        raise AssertionError(f"error {err} exceeds the bound {bound}")
    if plan.algo == "ring" and spread:
        raise AssertionError(f"ring ranks differ in {spread} elements")
    del exact, res, outs
    if profile:
        _profile(group, comm.allreduce, xs, plan, intervals=(1e-4,))
    return plan, launches, wall


def _profile(group, fn, xs, plan, intervals=None):
    """Warm wall time of the same call ``fn`` (a communicator method),
    then one run under torch.profiler (device busy time, the kernels that
    take it, and the full names of those launched once per rank), then
    the same schedule at 256 KB per rank, where the device work is
    negligible: the host's floor for this schedule.  The floor and the
    full-size wall are taken at the interpreter's default switch interval
    and at each of ``intervals``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.comm import GZCommunicator

    t0 = time.perf_counter()
    group.run(fn, xs, axis_name="x")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    # Host-device syncs inside the collective would serialize the ranks.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            group.run(fn, xs, axis_name="x")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "called a synchronizing" in str(w.message)})
    log(f"host-device syncs inside the {plan.op}: {len(syncs)} kinds {syncs[:3]}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        group.run(fn, xs, axis_name="x")
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile: warm wall {warm * 1e3:.1f} ms; traced wall {traced * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
    for e in events:
        if e.count == group.size:
            log(f"  launched {e.count} times: {e.key} "
                f"({e.self_device_time_total / 1e3:.2f} ms)")
    small = GZCommunicator("x", config=plan.as_config(), axis_size=group.size,
                           device=xs[0].device)
    small_fn = getattr(small, plan.op)
    tiny = [x[: 1 << 16].clone() for x in xs]
    default_interval = sys.getswitchinterval()
    try:
        # The rank threads meet at a barrier per exchange; a woken thread
        # waits for the interpreter lock up to one switch interval.
        for interval in (default_interval, *(intervals or ())):
            sys.setswitchinterval(interval)
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                group.run(small_fn, tiny, axis_name="x")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            group.run(fn, xs, axis_name="x")
            torch.cuda.synchronize()
            full = time.perf_counter() - t0
            log(f"host floor: {plan.algo}/{plan.pipeline_chunks} at 256 KB/rank, "
                f"N={group.size}, switch interval {interval * 1e3:g} ms: warm wall "
                f"{min(walls[1:]) * 1e3:.1f} ms; at full size {full * 1e3:.1f} ms")
    finally:
        sys.setswitchinterval(default_interval)


@contextlib.contextmanager
def _plain_kernels():
    """Route the kernel entry points to their plain versions (comparison
    only: the package itself never does this)."""
    from repro_torch.kernels import entropy, lorenzo

    saved = [(mod, k, getattr(mod, k)) for mod in (lorenzo, entropy) for k in mod.KERNELS]
    try:
        for mod, k, _ in saved:
            setattr(mod, k, getattr(mod, f"{k}_plain"))
        yield
    finally:
        for mod, k, v in saved:
            setattr(mod, k, v)


def kernels_vs_plain_allreduce(device):
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, 4_000_000 // 4
    for cfg in (GZConfig(), GZConfig(algo="ring", pipeline_chunks=2)):
        gen = torch.Generator(device=device).manual_seed(SEED + 4)
        xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
        comm = GZCommunicator("x", config=cfg, axis_size=n, device=device)
        group = transport.ThreadGroup(n, device)
        kern = group.run(comm.allreduce, xs, axis_name="x")
        with _plain_kernels():
            plain = group.run(comm.allreduce, xs, axis_name="x")
        torch.cuda.synchronize()
        mism = sum(int((a.value.view(torch.int32) != b.value.view(torch.int32)).sum())
                   for a, b in zip(kern, plain))
        algo = comm.plan("allreduce", (n_elems,)).algo
        log(f"allreduce 4 MB/rank N=8 {algo}: kernels vs plain mismatches={mism}")
        if mism:
            raise AssertionError(f"kernel path differs from the plain path in {mism}")


# ---------------------------------------------------------------------------
# Phases 5-7: the data movers and the two-pass paths
# ---------------------------------------------------------------------------


def _run(group, comm, op, xs):
    """One call of ``comm.<op>`` on every rank, launch counts from 0.
    Returns (results, launches, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = group.run(getattr(comm, op), xs, axis_name="x")
    torch.cuda.synchronize()
    return res, _launches(), time.perf_counter() - t0


def _check_result(label, res, wants, err_scale):
    """Error of every rank's output against its f64 reference within
    1.05 eb + 1e-6 max|reference|, no overflow, no non-finite flag.
    Returns the largest error."""
    worst = 0.0
    for r, (out, want) in enumerate(zip((x.value for x in res), wants)):
        err = (out.double() - want).abs().max().item()
        bound = EB * 1.05 + want.abs().max().item() * err_scale
        if not err <= bound:
            raise AssertionError(f"{label}: rank {r} error {err} exceeds the bound {bound}")
        worst = max(worst, err)
    if any(bool(x.overflow) or bool(x.nonfinite) for x in res):
        raise AssertionError(f"{label}: overflow or non-finite flag set")
    return worst


def _bitwise_mismatches(a, b):
    """Elements of two runs' per-rank results whose f32 bits differ."""
    import torch

    return sum(int((x.value.view(torch.int32) != y.value.view(torch.int32)).sum())
               for x, y in zip(a, b))


def run_scatter(n, nbytes, device, gen, label, profile=False, codec="lorenzo"):
    """``scatter`` of ``nbytes`` at the root over n ranks.  Non-root
    inputs are NaN: only the root's payload is significant."""
    import torch

    from repro_torch.core import bitpack, transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator
    from repro_torch.kernels import lorenzo, ops

    n_elems = nbytes // 4 // n * n  # whole chunks
    x_full = _random_walk(n_elems, gen, device)
    junk = torch.full_like(x_full, float("nan"))
    xs = [x_full] + [junk] * (n - 1)
    comm = GZCommunicator("x", config=GZConfig(codec=codec), axis_size=n, device=device)
    plan = comm.plan("scatter", (n_elems,))
    streams = sum(h.chunk_slab[1] for rnd in plan.route_table.rounds for h in rnd
                  if h.sender == 0)
    group = transport.ThreadGroup(n, device)
    res, launches, wall = _run(group, comm, "scatter", xs)
    chunk = n_elems // n
    err = _check_result(f"scatter {label}", res,
                        [x_full[r * chunk:(r + 1) * chunk].double() for r in range(n)],
                        1e-6)
    log(f"scatter {label} N={n} {nbytes / 1e6:.0f} MB at the root, codec {codec}: "
        f"algo={plan.algo} "
        f"pipeline_chunks={plan.pipeline_chunks} wire_bytes={plan.wire_bytes} "
        f"root_chunk_streams={streams} ratio={plan.ratio:.4f} cold wall "
        f"{wall * 1e3:.1f} ms err={err:.3e} launches={_nonzero(launches)}")
    if (plan.algo, plan.pipeline_chunks, streams) != ("binomial", 1, n - 1):
        raise AssertionError(f"scatter plan {plan.algo}/{plan.pipeline_chunks} with "
                             f"{streams} root streams")
    _check_launches(plan, n, launches)
    del res
    if profile:
        _profile(group, comm.scatter, xs, plan)
        rows = ops.n_blocks_for(chunk)
        x2d = ops.to_blocks(x_full[:chunk])
        codes, bw, _ = lorenzo.quantize(x2d, ops.as_eb(EB, device))
        cap = plan.capacity_words
        ms = _median_ms(lambda: bitpack.pack(codes, bw, cap), 5)
        log(f"bitpack.pack (torch ops) at one chunk ({rows} rows, cap {cap}): {ms:.3f} ms "
            f"median; x {n} chunks = {n * ms:.2f} ms per scatter")
    del xs, x_full, junk
    torch.cuda.empty_cache()
    return plan, launches, wall


def _movement_references(op, xs, n):
    """Per-rank f64 reference outputs of a data-movement op."""
    import torch

    chunk = xs[0].shape[0] // n
    if op == "broadcast":
        return [xs[0].double()] * n
    if op == "allgather":
        return [torch.cat(xs).double()] * n
    if op == "reduce_scatter":
        exact = sum(x.double() for x in xs)
        return [exact[r * chunk:(r + 1) * chunk] for r in range(n)]
    return [torch.cat([x[r * chunk:(r + 1) * chunk] for x in xs]).double()
            for r in range(n)]


def run_movers(device, gen):
    """broadcast, allgather (P = 1, 2), reduce_scatter (P = 1, 2) and
    all_to_all at 16 MB per rank over 8 ranks: error bound and launch
    counts, then bitwise equal to the same call through the plain
    versions."""
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, MOVER_BYTES // 4
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
    group = transport.ThreadGroup(n, device)
    for op, chunks in (("broadcast", 1), ("allgather", 1), ("allgather", 2),
                       ("reduce_scatter", 1), ("reduce_scatter", 2), ("all_to_all", 1)):
        comm = GZCommunicator("x", config=GZConfig(pipeline_chunks=chunks), axis_size=n,
                              device=device)
        plan = comm.plan(op, (n_elems,))
        res, launches, wall = _run(group, comm, op, xs)
        err = _check_result(op, res, _movement_references(op, xs, n), 1e-6)
        _check_launches(plan, n, launches)
        with _plain_kernels():
            plain = group.run(getattr(comm, op), xs, axis_name="x")
        torch.cuda.synchronize()
        mism = _bitwise_mismatches(res, plain)
        log(f"{op} {MOVER_BYTES / 1e6:.0f} MB/rank N={n} P={plan.pipeline_chunks}: algo={plan.algo} "
            f"wire_bytes={plan.wire_bytes} cold wall {wall * 1e3:.1f} ms err={err:.3e} "
            f"launches={_nonzero(launches)} kernels vs plain mismatches={mism}")
        if mism:
            raise AssertionError(f"{op}: kernel path differs from the plain path in {mism}")
        del res, plain
    torch.cuda.empty_cache()


def run_two_pass(device, gen):
    """16 MB x 8 allreduces with the two-pass codec (redoub, ring/2) and
    the two-kernel hop (ring/2): launch counts, and bitwise equal to the
    fused run on the same inputs.  Returns each variant's launches."""
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, MOVER_BYTES // 4
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
    exact = sum(x.double() for x in xs)
    group = transport.ThreadGroup(n, device)
    out = {}
    for base, variants in (({"algo": "redoub"}, ({"fused": False},)),
                           ({"algo": "ring", "pipeline_chunks": 2},
                            ({"fused": False}, {"fused_hop": False}))):
        fused = group.run(GZCommunicator("x", config=GZConfig(**base), axis_size=n,
                                         device=device).allreduce, xs, axis_name="x")
        for v in variants:
            comm = GZCommunicator("x", config=GZConfig(**base, **v), axis_size=n,
                                  device=device)
            plan = comm.plan("allreduce", (n_elems,))
            res, launches, wall = _run(group, comm, "allreduce", xs)
            label = f"{plan.algo}/{plan.pipeline_chunks} {v}"
            err = _check_result(label, res, [exact] * n, 1e-6)
            _check_launches(plan, n, launches)
            mism = _bitwise_mismatches(res, fused)
            log(f"two-pass allreduce {MOVER_BYTES / 1e6:.0f} MB/rank N={n} {label}: cold wall "
                f"{wall * 1e3:.1f} ms err={err:.3e} launches={_nonzero(launches)} "
                f"vs fused run mismatches={mism}")
            if mism:
                raise AssertionError(f"{label}: differs from the fused run in {mism}")
            out[(plan.algo, tuple(sorted(v)))] = launches
            del res
        del fused
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phases 8-12: the entropy kernels, the codec registry, the gradient sync
# ---------------------------------------------------------------------------

BUCKET_BYTES = 16 * 1024 * 1024  # SyncConfig's default bucket: 16,384 blocks
# One decoder layer of minitron-8b (src/repro/configs/minitron_8b.py: d_model
# 4096, 32 heads, 8 KV heads, head dim 128, d_ff 16384), in the JAX block's
# parameter names (src/repro/models/blocks.py): 243,277,824 f32 per rank.
MINITRON_LAYER = {
    "attn": {"wq": (4096, 4096), "wk": (4096, 1024), "wv": (4096, 1024),
             "wo": (4096, 4096)},
    "ln1": (4096,),
    "ln2": (4096,),
    "mlp": {"wi": (4096, 16384), "wg": (4096, 16384), "wo": (16384, 4096)},
}
GRAD_SYNC_ELEMS = 243_277_824


def _random_bits(n, gen, device):
    """Full-range f32 bit patterns (NaN and Inf payloads included)."""
    import torch

    return torch.randint(-2**31, 2**31, (n,), generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32).view(torch.float32)


def _entropy_bytes(name, nb, words):
    """Bytes an entropy kernel must move: inputs once, outputs once, the
    stream only to its true length."""
    n, meta = nb * 256, 8 * nb  # desc + anchor
    if name == "entropy_quantize_pack":
        return 4 * n + 4 * words + meta
    if name == "entropy_unpack_dequantize":
        return 4 * words + meta + 4 * n
    return 4 * words + meta + 8 * n  # + acc in


def check_entropy_kernels(device, gen):
    """Kernels 8-10 against their plain versions, bitwise, lossy and
    lossless; median ms at the 16 MiB bucket and the 646 MB payload."""
    import torch

    from repro_torch.core import entropy as ent
    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.core.compressor import lossless_capacity_words
    from repro_torch.kernels import entropy, ops

    eb = torch.full((), EB, dtype=torch.float32, device=device)

    def zero_blocks(n):
        x = _random_walk(n, gen, device)
        x[256:768] = 0.0
        x[1024 + 64:1024 + 128] = x[1024 + 63]
        return x

    cases = [  # (label, x, capacity factor or None = lossless structural, timed)
        ("ragged n=37", _random_walk(37, gen, device), 0.6, False),
        ("ragged n=6149", _random_walk(2048 * 3 + 5, gen, device), 0.6, False),
        ("ragged n=2504", _random_walk(256 * 9 + 200, gen, device), 2.0, False),
        ("zero blocks", zero_blocks(4096), 0.6, False),
        ("nan/inf/saturating", _wild(300_000, gen, device), 2.0, False),
        ("random bits", _random_bits(300_000, gen, device), 2.0, False),
        ("overflow", _random_bits(300_000, gen, device), 0.05, False),
        ("16 MiB bucket", _random_walk(BUCKET_BYTES // 4, gen, device), 0.6, True),
        ("646 MB", _random_walk(MAIN_BYTES // 4, gen, device), 0.6, True),
    ]
    records, names = {}, ENTROPY_KERNELS
    for label, x, cf, timed in cases:
        n = x.numel()
        x2d = ops.to_blocks(x)
        nb = x2d.shape[0]
        acc = _random_walk(nb * 256, gen, device).view(nb, 256)
        for lossless in (False, True):
            cap = (lossless_capacity_words(n) if lossless and cf != 0.05
                   else capacity_words_for(n, cf, 256))
            calls = {"entropy_quantize_pack": ((x2d, eb, cap), "quantize_pack")}
            got = entropy.quantize_pack(x2d, eb, cap, lossless=lossless)
            want = entropy.quantize_pack_plain(x2d, eb, cap, lossless=lossless)
            torch.cuda.synchronize()
            mode = "lossless" if lossless else "lossy"
            errs = {names[0]: _compare(f"entropy quantize_pack [{label} {mode}]", got, want)}
            words = int(ent.packed_words(got[1]))
            if (words > cap) != (cf == 0.05):
                raise AssertionError(f"{label} {mode}: {words} words for capacity {cap}")
            calls["entropy_unpack_dequantize"] = ((*got, eb), "unpack_dequantize")
            calls["entropy_unpack_dequantize_reduce"] = ((*got, eb, acc),
                                                         "unpack_dequantize_reduce")
            for name in names[1:]:
                args, fn = calls[name]
                out = getattr(entropy, fn)(*args, lossless=lossless)
                errs[name] = _compare(f"entropy {fn} [{label} {mode}]", (out,),
                                      (getattr(entropy, f"{fn}_plain")(*args, lossless=lossless),))
                if lossless and fn == "unpack_dequantize" and words <= cap:
                    if not torch.equal(out.view(torch.int32), x2d.view(torch.int32)):
                        raise AssertionError(f"{label}: lossless round trip is not exact")
                del out
            log(f"entropy kernels vs plain [{label} {mode}, {nb} rows, cap {cap}, "
                f"{words} words]: mismatches 0 in stream/desc/anchor and both f32 outputs")
            if timed:
                tag = f"{label} {mode}"
                for name, (args, fn) in calls.items():
                    kern, plain = getattr(entropy, fn), getattr(entropy, f"{fn}_plain")
                    nbytes = _entropy_bytes(name, nb, words)
                    rec = {
                        "name": name, "route": "cuda", "source": ENTROPY_SOURCE,
                        "replaces": REPLACES[name], "launches": None,
                        "max_abs_err": errs[name],
                        "ms": _median_ms(lambda: kern(*args, lossless=lossless), 20),
                        "plain_ms": _median_ms(lambda: plain(*args, lossless=lossless),
                                               1 if nb > 100_000 else 5),
                        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                        "bound_by": "bytes", "library_ms": None,
                        "shape": [nb, 256], "bytes": nbytes,
                    }
                    log(f"  {name:<34} [{tag}] {rec['ms']:.4f} ms  plain "
                        f"{rec['plain_ms']:.3f} ms  bound {rec['bound_ms']:.4f} ms "
                        f"({nbytes / 1e6:.1f} MB)")
                    if label == "16 MiB bucket" and not lossless:
                        records[name] = rec  # the main path's shape and mode
            del got, want, calls
        del x, x2d, acc
        torch.cuda.empty_cache()
    return records


def run_entropy_allreduce(device, gen):
    """The 646 MB x 8 allreduce under ``lorenzo+entropy``, then ``lorenzo``
    on the same inputs: plans, cold and warm walls, error, exact launch
    counts, provisioned wire bytes and true stream bytes."""
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, MAIN_BYTES // 4
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
    exact = sum(x.double() for x in xs)
    group = transport.ThreadGroup(n, device)
    out = {}
    for codec in ("lorenzo+entropy", "lorenzo"):
        comm = GZCommunicator("x", config=GZConfig(codec=codec), axis_size=n,
                              device=device)
        plan = comm.plan("allreduce", (n_elems,))
        res, launches, cold = _run(group, comm, "allreduce", xs)
        err = _check_result(f"allreduce {codec}", res, [exact] * n, 1e-6)
        _check_launches(plan, n, launches)
        del res
        _, _, warm = _run(group, comm, "allreduce", xs)
        c = plan.as_config().compressor().compress(xs[0], plan.eb_stage)
        true_bytes = int(c.payload_bytes())
        del c
        log(f"allreduce {MAIN_BYTES / 1e6:.0f} MB/rank N={n} codec {codec}: "
            f"algo={plan.algo} pipeline_chunks={plan.pipeline_chunks} "
            f"fused_hop={plan.fused_hop} notes={list(plan.notes)} "
            f"provisioned wire_bytes/rank={plan.wire_bytes} ratio={plan.ratio:.4f}; "
            f"true stream bytes of rank 0's payload compressed once at eb_stage "
            f"{plan.eb_stage:.3e}: {true_bytes} ({n_elems * 4 / true_bytes:.3f}x); "
            f"cold wall {cold * 1e3:.1f} ms, warm wall {warm * 1e3:.1f} ms, "
            f"err={err:.3e} launches={_nonzero(launches)}")
        out[codec] = (plan, launches, warm, true_bytes)
    if out["lorenzo+entropy"][0].wire_bytes != out["lorenzo"][0].wire_bytes:
        raise AssertionError("entropy and dense plans provision different wire bytes")
    if not out["lorenzo+entropy"][3] < out["lorenzo"][3]:
        raise AssertionError("the entropy stream is not shorter than the dense one")
    del xs, exact
    torch.cuda.empty_cache()
    return out


def _layer_grads(n, gen, device, shrink=1):
    """n per-rank gradient trees of the minitron-8b layer: seeded random
    walks, 1e-3 steps; ``shrink`` divides every leading dimension."""
    def leaf(shape):
        shape = (shape[0] // shrink,) + tuple(shape[1:])
        return (_random_walk(math.prod(shape), gen, device) * 1e-3).view(shape)

    def tree(spec):
        if isinstance(spec, dict):
            return {k: tree(v) for k, v in spec.items()}
        return leaf(spec)

    return [tree(MINITRON_LAYER) for _ in range(n)]


def _flat_leaves(tree):
    from repro_torch.core import grad_sync

    return grad_sync.tree_flatten(tree)[0]


def _sync_once(group, trees, sync, device):
    """One ``dp_allreduce_grads_stats`` on every rank, launch counts from
    0.  Returns (results, launches, wall seconds)."""
    import torch

    from repro_torch.core import grad_sync

    def body(tree):
        return grad_sync.dp_allreduce_grads_stats(tree, ("x",), sync, device=device)

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = group.run(body, trees, axis_name="x")
    torch.cuda.synchronize()
    return res, _launches(), time.perf_counter() - t0


def _check_sync(label, trees, res, sync, n, launches, device):
    """Every rank's leaves within sum(per-stage bounds) * scale +
    1e-6 max|exact| of the f64 sum, no flag set, and the launch counts
    exactly the per-bucket schedule times the bucket count."""
    import torch

    from repro_torch.core import buckets, error_budget, grad_sync, transport
    from repro_torch.core.comm import GZCommunicator

    leaves = [grad_sync.tree_flatten(t)[0] for t in trees]
    ledger = buckets.ledger_for([a.shape for a in leaves[0]], sync.bucket_bytes)
    plan = GZCommunicator("x", config=sync.gz, axis_size=n, device=device,
                          auto_depth=True).plan("allreduce", (ledger.bucket_elems,))
    scale = transport.ThreadGroup(n, device).run(
        lambda t: grad_sync._tree_scale([a.reshape(-1) for a in grad_sync.tree_flatten(t)[0]],
                                        transport.current("x")), trees)[0].item()
    hops = error_budget.lossy_hops(f"allreduce_{plan.algo}", n)
    worst, worst_ratio = 0.0, 0.0
    outs = [grad_sync.tree_flatten(out)[0] for out, _ in res]
    for i in range(len(leaves[0])):
        exact = sum(lv[i].double() for lv in leaves)
        bound = hops * plan.eb_stage * scale + 1e-6 * exact.abs().max().item()
        for r in range(n):
            err = (outs[r][i].double() - exact).abs().max().item()
            if not err <= bound:
                raise AssertionError(f"{label}: leaf {i} rank {r} error {err} > bound {bound}")
            worst, worst_ratio = max(worst, err), max(worst_ratio, err / bound)
        del exact
    stats = [st for _, st in res]
    if any(bool(st.overflow) or bool(st.nonfinite) for st in stats):
        raise AssertionError(f"{label}: overflow or non-finite flag set")
    expected = {k: v * ledger.n_buckets for k, v in _expected_launches(plan, n).items()}
    if launches != expected:
        raise AssertionError(f"{label}: launches {launches} != schedule's {expected}")
    return plan, ledger, scale, worst, worst_ratio, stats[0]


def run_grad_sync(device, gen):
    """This slice's main path: ``dp_allreduce_grads_stats`` of one minitron-8b
    decoder layer (243,277,824 f32 per rank) over 8 ranks under
    ``lorenzo+entropy`` with 16 MiB buckets; cold and warm walls, a profiled
    warm run, the host floor (the tree and the buckets at 1/256 size); then
    ``lorenzo``, ``lossless``, ``passthrough`` and ``codec="auto"`` on the
    same inputs, and the N = 6 remainder stage.  Returns the launch counts
    of the N = 8 and N = 6 entropy runs."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.grad_sync import SyncConfig

    def sync_for(codec, bucket_bytes=BUCKET_BYTES):
        return SyncConfig(gz=GZConfig(eb=1e-4, algo="redoub", worst_case_budget=False,
                                      codec=codec), bucket_bytes=bucket_bytes)

    n = 8
    torch.cuda.reset_peak_memory_stats()
    trees = _layer_grads(n, gen, device)
    total = sum(a.numel() for a in _flat_leaves(trees[0]))
    if total != GRAD_SYNC_ELEMS:
        raise AssertionError(f"layer tree has {total} elements")
    group = transport.ThreadGroup(n, device)
    sync = sync_for("lorenzo+entropy")
    res, launches, cold = _sync_once(group, trees, sync, device)
    plan, ledger, scale, err, ratio, st = _check_sync(
        "grad sync entropy", trees, res, sync, n, launches, device)
    del res
    log(f"grad sync minitron-8b layer ({total} f32/rank = {total * 4 / 1e6:.0f} MB) "
        f"N={n} codec lorenzo+entropy: {ledger.n_buckets} buckets of {ledger.bucket_elems}; "
        f"plan {plan.algo}/{plan.pipeline_chunks} eb_stage={plan.eb_stage:.3e} "
        f"notes={list(plan.notes)}; scale {scale:.6e}; wire_bytes/rank {st.wire_bytes}; "
        f"cold wall {cold * 1e3:.1f} ms; max err {err:.3e} ({100 * ratio:.1f} % of the "
        f"bound); launches={_nonzero(launches)}; peak memory "
        f"{torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    main_launches = launches
    _, _, warm = _sync_once(group, trees, sync, device)

    def body(tree):
        from repro_torch.core import grad_sync
        return grad_sync.dp_allreduce_grads_stats(tree, ("x",), sync, device=device)

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        group.run(body, trees, axis_name="x")
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = [e for e in prof.key_averages() if getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"grad sync profile: warm wall {warm * 1e3:.1f} ms; traced wall "
        f"{traced * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (traced * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"  {e.count:>6} x {e.self_device_time_total / 1e3:8.2f} ms  {e.key[:160]}")
    del prof, events
    small = _layer_grads(n, gen, device, shrink=256)
    small_sync = sync_for("lorenzo+entropy", BUCKET_BYTES // 256)
    walls = [_sync_once(group, small, small_sync, device)[2] for _ in range(3)]
    log(f"grad sync host floor: the same tree and buckets at 1/256 size "
        f"({sum(a.numel() for a in _flat_leaves(small[0]))} f32/rank), warm wall "
        f"{min(walls[1:]) * 1e3:.1f} ms")
    del small

    results = {}
    for codec in ("lorenzo", "lossless", "passthrough", "auto"):
        s = sync_for(codec)
        res, launches, wall = _sync_once(group, trees, s, device)
        p, _, _, err, ratio, st = _check_sync(f"grad sync {codec}", trees, res, s, n,
                                              launches, device)
        log(f"grad sync N={n} codec {codec}: resolved {p.codec} ({p.algo}/"
            f"{p.pipeline_chunks}) notes={list(p.notes)} wall {wall * 1e3:.1f} ms "
            f"max err {err:.3e} ({100 * ratio:.1f} % of the bound) wire_bytes/rank "
            f"{st.wire_bytes} launches={_nonzero(launches)}")
        if codec in ("lossless", "passthrough"):
            results[codec] = [_flat_leaves(out) for out, _ in res]
        del res
    mism = sum(int((a.view(torch.int32) != b.view(torch.int32)).sum())
               for ra, rb in zip(results["lossless"], results["passthrough"])
               for a, b in zip(ra, rb))
    log(f"grad sync lossless vs passthrough (both exact transports): mismatches {mism}")
    if mism:
        raise AssertionError(f"lossless differs from passthrough in {mism} elements")
    del results

    n6 = 6
    res, launches6, wall = _sync_once(transport.ThreadGroup(n6, device), trees[:n6],
                                      sync, device)
    p, _, _, err, ratio, _ = _check_sync("grad sync entropy N=6", trees[:n6], res, sync,
                                         n6, launches6, device)
    log(f"grad sync N={n6} codec lorenzo+entropy: {p.algo} with the remainder stage, "
        f"wall {wall * 1e3:.1f} ms max err {err:.3e} ({100 * ratio:.1f} % of the bound) "
        f"launches={_nonzero(launches6)}")
    del res, trees
    torch.cuda.empty_cache()
    return main_launches, launches6


def check_a2a_backward_on_threadgroup(device):
    """ROADMAP C6: the ``all_to_all`` backward on a one-card ThreadGroup
    runs on the autograd engine's device thread, where the ranks'
    exchanges cannot meet; it must raise (naming DistGroup) within
    seconds, under a watchdog, and neither hang nor succeed."""
    import torch

    from repro_torch.core import transport
    from repro_torch.core.comm import GZCommunicator

    n = 2
    comm = GZCommunicator("x", axis_size=n, device=device)
    xs = [torch.linspace(0, 1, 4096, device=device) + r for r in range(n)]
    outcome = []

    def body(x):
        x = x.clone().requires_grad_(True)
        comm.all_to_all(x).value.sum().backward()
        return x.grad

    def watched():
        try:
            transport.ThreadGroup(n, device).run(body, xs)
            outcome.append("backward succeeded")
        except RuntimeError as e:
            outcome.append(str(e))

    t0 = time.perf_counter()
    t = threading.Thread(target=watched, daemon=True)
    t.start()
    t.join(timeout=60)
    if t.is_alive():
        log("all_to_all backward on a one-card ThreadGroup: HUNG for 60 s")
        sys.stdout.flush()
        os._exit(1)  # the rank threads cannot be stopped; end the process
    msg = outcome[0]
    log(f"all_to_all backward on a one-card ThreadGroup: raised after "
        f"{time.perf_counter() - t0:.2f} s: {msg[:160]}")
    if "DistGroup" not in msg:
        raise AssertionError(f"all_to_all backward did not raise as expected: {msg}")


# ---------------------------------------------------------------------------


PHASES = ("kernels", "allreduce", "movers", "codecs", "grad-sync", "c6")


def _record(records, name):
    """The kernels-line record of ``name`` (a stub in a partial run
    without the kernel phase)."""
    return records.setdefault(name, {"name": name})


def main(argv=()) -> int:
    phases = set(argv[argv.index("--phases") + 1].split(",")) if "--phases" in argv \
        else set(PHASES)
    if not phases <= set(PHASES):
        print(f"chip_smoke.py: --phases takes a comma list of {PHASES}", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    from repro_torch.kernels import build

    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    log(f"card: {smi}")
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)}")
    t0 = time.perf_counter()
    for name, rec in build.build_all().items():  # one nvcc per source, together
        ptxas = [ln for ln in rec["ptxas"].splitlines() if "registers" in ln]
        log(f"built {name}.cu in {rec['seconds']:.1f} s; " + "; ".join(ptxas))
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    gen = torch.Generator(device=device).manual_seed(SEED)
    records = {}
    if "kernels" in phases:
        records.update(check_kernels(device, gen))
        records.update(check_unfused_kernels(device, gen))
        records.update(check_entropy_kernels(device, gen))

    if "allreduce" in phases:
        plan, launches, _ = run_allreduce(8, MAIN_BYTES, device, gen, label="main",
                                          profile=True)
        if (plan.algo, plan.pipeline_chunks) != ("ring", 2):
            raise AssertionError(f"646 MB plan is {plan.algo}/{plan.pipeline_chunks}, "
                                 "expected ring/2")
        for name in ("quantize_pack", "unpack_reduce_repack", "unpack_dequantize_reduce",
                     "unpack_dequantize"):
            _record(records, name)["launches"] = launches[name]
        run_allreduce(8, 16_000_000, device, gen, label="16MB")
        run_allreduce(6, 16_000_000, device, gen, {"algo": "redoub"}, label="16MB")
        kernels_vs_plain_allreduce(device)
        torch.cuda.empty_cache()

    if "movers" in phases:
        # The paper's Fig. 12 scatter, then the other data movers.
        plan, launches, _ = run_scatter(8, MAIN_BYTES, device, gen, "main", profile=True)
        if plan.wire_bytes != SCATTER_WIRE_BYTES:
            raise AssertionError(f"scatter wire bytes {plan.wire_bytes} != "
                                 f"{SCATTER_WIRE_BYTES}")
        _record(records, "quantize")["launches"] = launches["quantize"]
        run_scatter(6, 64_000_000, device, gen, "trimmed")
        run_movers(device, gen)
        two_pass = run_two_pass(device, gen)
        _record(records, "dequantize_reduce")["launches"] = \
            two_pass[("redoub", ("fused",))]["dequantize_reduce"]
        _record(records, "dequantize")["launches"] = two_pass[("ring", ("fused",))]["dequantize"]

    if "codecs" in phases:
        run_entropy_allreduce(device, gen)
        plan, _, _ = run_scatter(8, MAIN_BYTES, device, gen, "main", codec="lorenzo+entropy")
        if plan.wire_bytes != SCATTER_WIRE_BYTES:
            raise AssertionError(f"entropy scatter wire bytes {plan.wire_bytes}")

    if "grad-sync" in phases:
        # This slice's main path: data-parallel gradient sync.
        main_launches, launches6 = run_grad_sync(device, gen)
        for name in ("entropy_quantize_pack", "entropy_unpack_dequantize_reduce"):
            _record(records, name)["launches"] = main_launches[name]
        _record(records, "entropy_unpack_dequantize")["launches"] = \
            launches6["entropy_unpack_dequantize"]

    if "c6" in phases:
        check_a2a_backward_on_threadgroup(device)

    if phases != set(PHASES):
        log(f"partial run ({sorted(phases)}): every check passed; no result printed")
        return 0
    for r in records.values():
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: not launched on its path")
    print(smi)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k not in ("shape", "bytes")}
        for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

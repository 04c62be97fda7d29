"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

It drives ``repro_torch`` only (no JAX, nothing of the ``repro`` package):

1. prints the card's name and power limit (``nvidia-smi``), builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` and prints the build
   time and ``ptxas`` resource lines;
2. holds each of the four Lorenzo kernels against its plain PyTorch
   version on the card, on ragged small sizes, on the shapes of the main
   path (one pipelined-ring piece and one sequential-ring chunk of the
   646 MB run) and on an overflowing stream: words ``[:cap]``, bw, anchor
   and nwords must be equal and every f32 output bitwise equal; prints
   the mismatch counts and each kernel's median time against its bound;
3. runs the main path, ``GZCommunicator("x").allreduce`` over a
   ``ThreadGroup`` of ranks on the card, at 646 MB per rank with 8 ranks
   (plan ``ring``, 2 pieces), 16 MB with 8 ranks (``redoub``) and 16 MB
   with 6 ranks (``redoub`` with the remainder stage); each run starts
   with the launch counts at 0 and must launch each kernel its schedule
   uses exactly as often as the schedule says, stay within the error
   bound against the f64 exact sum, not overflow, and (ring) agree
   bitwise across ranks;
4. runs a 4 MB allreduce with 8 ranks through the kernels and through the
   plain versions on the card; the outputs must be bitwise equal.

The third-to-last line is the card's ``nvidia-smi`` name and power
limit, the second-to-last one JSON object with a record per kernel, the
last ``{"ok": true, "device": {...}}``.  Any failed check raises and the
script exits non-zero; without a CUDA card, or without the package
beside it, it prints no result and exits 2.
"""
import contextlib
import json
import pathlib
import subprocess
import sys
import time
import warnings

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
SEED = 0
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
KERNEL_SOURCE = "src/repro_torch/kernels/csrc/lorenzo.cu"
REPLACES = {
    "quantize_pack": "src/repro/kernels/lorenzo.py:392",
    "unpack_reduce_repack": "src/repro/kernels/lorenzo.py:324",
    "unpack_dequantize_reduce": "src/repro/kernels/lorenzo.py:456",
    "unpack_dequantize": "src/repro/kernels/lorenzo.py:426",
}
MAIN_BYTES = 646_000_000  # per rank: the paper's Fig. 10 message size
EB = 1e-4  # GZConfig's default end-to-end bound


def log(*a):
    print(*a, flush=True)


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


def _main_piece_elems():
    from repro_torch.core.collectives import PIECE_QUANTUM

    n = MAIN_BYTES // 4
    quantum = 8 * 2 * PIECE_QUANTUM
    return -(-n // quantum) * quantum // 16


# ---------------------------------------------------------------------------
# Phase 3/4: the main path
# ---------------------------------------------------------------------------


def _expected_launches(plan, n):
    """Per-kernel launches of one allreduce over all n ranks, from the
    schedule: what the fused-hop ring and redoub run per rank."""
    if plan.algo == "ring":
        p = plan.pipeline_chunks
        return {"quantize_pack": 2 * p * n,
                "unpack_reduce_repack": (n - 2) * p * n,
                "unpack_dequantize_reduce": p * n,
                "unpack_dequantize": p * n * n}
    pw = 1 << (n.bit_length() - 1)
    rem, steps = n - pw, pw.bit_length() - 1
    return {"quantize_pack": n,
            "unpack_reduce_repack": (steps - 1 + (2 if rem else 0)) * n,
            "unpack_dequantize_reduce": 0 if rem else n,
            "unpack_dequantize": rem}


def run_allreduce(n, nbytes, device, gen, config_kw=None, label="", profile=False):
    import torch

    from repro_torch.core import transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator
    from repro_torch.kernels import lorenzo

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
    lorenzo.reset_launch_counts()
    t0 = time.perf_counter()
    res = group.run(comm.allreduce, xs, axis_name="x")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(lorenzo.LAUNCHES)
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
        f"launches={launches}")
    expected = _expected_launches(plan, n)
    if launches != expected:
        raise AssertionError(f"launch counts {launches} != schedule's {expected}")
    if overflow or nonfinite:
        raise AssertionError(f"overflow={overflow} nonfinite={nonfinite}")
    if not err <= bound:
        raise AssertionError(f"error {err} exceeds the bound {bound}")
    if plan.algo == "ring" and spread:
        raise AssertionError(f"ring ranks differ in {spread} elements")
    del exact, res, outs
    if profile:
        _profile(group, comm, xs, plan)
    return plan, launches, wall


def _profile(group, comm, xs, plan):
    """Warm wall time of the same allreduce, then one run under
    torch.profiler (device busy time and the kernels that take it), then
    the same schedule at 256 KB per rank, where the device work is
    negligible: the host's floor for this schedule.  The floor and the
    full-size wall are taken at the interpreter's default switch interval
    and at 0.1 ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.comm import GZCommunicator

    t0 = time.perf_counter()
    group.run(comm.allreduce, xs, axis_name="x")
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    # Host-device syncs inside the collective would serialize the ranks.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            group.run(comm.allreduce, xs, axis_name="x")
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sorted({str(w.message).splitlines()[0] for w in caught
                    if "called a synchronizing" in str(w.message)})
    log(f"host-device syncs inside the allreduce: {len(syncs)} kinds {syncs[:3]}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        group.run(comm.allreduce, xs, axis_name="x")
        torch.cuda.synchronize()
        traced = time.perf_counter() - t0
    events = [e for e in prof.key_averages()
              if getattr(e, "self_device_time_total", 0) > 0]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile: warm wall {warm * 1e3:.1f} ms; traced wall {traced * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:12]:
        log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
    small = GZCommunicator("x", config=plan.as_config(), axis_size=group.size,
                           device=xs[0].device)
    tiny = [x[: 1 << 16].clone() for x in xs]
    default_interval = sys.getswitchinterval()
    try:
        # The rank threads meet at a barrier per exchange; a woken thread
        # waits for the interpreter lock up to one switch interval.
        for interval in (default_interval, 1e-4):
            sys.setswitchinterval(interval)
            walls = []
            for _ in range(3):
                t0 = time.perf_counter()
                group.run(small.allreduce, tiny, axis_name="x")
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            group.run(comm.allreduce, xs, axis_name="x")
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
    from repro_torch.kernels import lorenzo

    saved = {k: getattr(lorenzo, k) for k in lorenzo.KERNELS}
    try:
        for k in lorenzo.KERNELS:
            setattr(lorenzo, k, getattr(lorenzo, f"{k}_plain"))
        yield
    finally:
        for k, v in saved.items():
            setattr(lorenzo, k, v)


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


def main() -> int:
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
    rec = build.build("lorenzo")
    ptxas = [ln for ln in rec["ptxas"].splitlines() if "registers" in ln]
    log(f"built lorenzo.cu in {rec['seconds']:.1f} s; " + "; ".join(ptxas))
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")

    gen = torch.Generator(device=device).manual_seed(SEED)
    records = check_kernels(device, gen)

    plan, launches, _ = run_allreduce(8, MAIN_BYTES, device, gen, label="main",
                                      profile=True)
    if (plan.algo, plan.pipeline_chunks) != ("ring", 2):
        raise AssertionError(f"646 MB plan is {plan.algo}/{plan.pipeline_chunks}, "
                             "expected ring/2")
    for name, r in records.items():
        r["launches"] = launches[name]
    run_allreduce(8, 16_000_000, device, gen, label="16MB")
    run_allreduce(6, 16_000_000, device, gen, {"algo": "redoub"}, label="16MB")
    kernels_vs_plain_allreduce(device)

    print(smi)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k not in ("shape", "bytes")}
        for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

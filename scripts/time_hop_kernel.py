"""Time the Lorenzo ring hop (kernel 2, ``unpack_reduce_repack``), or,
with ``--kernel quantize_pack``, kernel 1, or, with ``--kernel compress``,
the fused ``ErrorBoundedLorenzo.compress`` around it, or, with ``--kernel
unpack_dequantize`` or ``unpack_dequantize_reduce``, kernel 4 or 3, or,
with ``--kernel dequantize`` or ``dequantize_reduce``, kernel 6 or 7, of
one checkout of the port.

    python3 scripts/time_hop_kernel.py [--src DIR] [--label NAME]
        [--kernel unpack_reduce_repack|quantize_pack|compress|
                  unpack_dequantize|unpack_dequantize_reduce|
                  dequantize|dequantize_reduce]

``--src`` is the ``src`` directory that holds ``repro_torch`` (default:
this checkout's).  Run it for two checkouts in one process list on one
card (for example a parent unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, then this tree, this tree, the parent) to
compare them.  Shapes: one 16 MiB gradient bucket (16,384 rows) with the
f32 sum written (the recursive-doubling carry of the default ``lorenzo``
grad sync), and one pipelined-ring piece of the 646 MB allreduce (39,432
rows) without it (the ring's mode) and with it; the incoming stream is
packed at eb = 1e-4 / 8, re-packed at 1e-4 / 7, capacity factor 0.6, as
in ``chip_smoke.py``.  Kernel 1 packs the same inputs at eb = 1e-4 / 8,
capacity factor 0.6, at the bucket and the ring piece; kernels 3 and 4
decode such a stream there (kernel 3 adds it to a second random walk).
Kernels 6 and 7 decode the unfused ``quantize``'s codes of a random walk
at eb = 1e-4 (kernel 7 adds them to a second walk) at the scatter's
batched shape (630,912 rows), at one ``fused=False`` scatter chunk of the
646 MB scatter over 8 ranks (78,864 rows) and at one piece of the
``fused=False`` ring/2 allreduce of 16 MB over 8 ranks (984 rows).  ``compress``
packs one 16 MiB bucket as the default ``lorenzo`` grad sync does, and
then prints the host cost of each step of the call apart (the stream
lookup, the look-back scratch, the eb scalars, one allocation, the
ctypes call, the word count that ``compress`` takes from the widths where
the wrapper returns no total), in us per call over 2,000 calls.  For each
it checks the kernel against the plain version (stream words, widths,
anchors, the total and the f32 sum bitwise) and prints the median ms of
20 event pairs around 10 back-to-back calls, around one call, the host us
per call of 1,000 calls queued without a sync, the device time per call of
the port's kernels from the profiler (by kernel name, with launches per
call), and the bytes bound at 3.35 TB/s.  Earlier designs launched
``quantize_front_kernel``, ``word_offsets_kernel`` and ``pack_kernel``
(kernel 1), ``word_offsets_kernel`` and ``unpack_kernel`` (kernels 3
and 4) and ``dequantize_kernel`` (kernels 6 and 7, one CTA per block),
so ``OWN`` names them too: it times a parent checkout with the same
columns.  It needs a CUDA card and imports no JAX.
"""
import time
import argparse
import pathlib
import re
import subprocess
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))
from chip_smoke import ptxas_lines  # noqa: E402  (stdlib only at import)

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
EB = 1e-4
OWN = re.compile(r"\(anonymous namespace\)::(hop_\w+_kernel|qp_\w+_kernel|ud_\w+_kernel|"
                 r"dq_\w+_kernel|pack_kernel|quantize_front_kernel|word_offsets_kernel|"
                 r"unpack_kernel|dequantize_kernel)(<[^>]*>)?")


def _median_ms(torch, fn, reps=20, calls=1):
    for _ in range(2):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return sorted(times)[len(times) // 2]


def _device(torch, fn, calls=10):
    """{kernel: (launches per call, device us per call)} from the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    rows = {}
    for e in prof.key_averages():
        m = OWN.search(e.key)
        if e.device_type == DeviceType.CUDA and m:
            n, us = rows.get(m.group(0), (0, 0.0))
            rows[m.group(0)] = (n + e.count / calls, us + e.self_device_time_total / calls)
    return rows


def _host_us(torch, fn, calls=1000):
    """Host us per call of ``calls`` calls queued without a sync."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def _walk(torch, n, gen, dev):
    steps = torch.randn(n, dtype=torch.float64, generator=gen, device=dev).mul_(0.01)
    return torch.cumsum(steps, 0).to(torch.float32)


def _report(torch, label, what, fn, nbytes):
    """Print ``fn``'s median ms back-to-back and over one call, its
    kernels' device time per call by name, and the bytes bound."""
    b2b = _median_ms(torch, fn, calls=10)
    one = _median_ms(torch, fn)
    host = _host_us(torch, fn)
    rows = _device(torch, fn)
    dev_us = sum(us for _, us in rows.values())
    split = "; ".join(f"{k} x{c:g} {us:.1f} us" for k, (c, us) in sorted(rows.items()))
    print(f"[{label}] {what}: mismatches 0; {b2b:.4f} ms back-to-back, {one:.4f} ms one "
          f"call, {host:.1f} us host per call, {dev_us / 1e3:.4f} ms device ({split}); bound "
          f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB)", flush=True)


def _time_quantize_pack(torch, lorenzo, ops, label, shape, n, gen, dev, eb):
    """Kernel 1 on a random walk of n elements: checked against the plain
    version, then timed.  Bytes: x in; the stream to its capacity, bw,
    anchor and the total out."""
    from repro_torch.core.compressed import capacity_words_for

    x2d = ops.to_blocks(_walk(torch, n, gen, dev) * 8.0)
    nb = x2d.shape[0]
    cap = capacity_words_for(n, 0.6, 256)
    got = lorenzo.quantize_pack(x2d, eb, cap)
    want = lorenzo.quantize_pack_plain(x2d, eb, cap)
    mism = sum(int((g != w).sum()) for g, w in zip(got, want))  # the parent's has no total
    if mism:
        raise AssertionError(f"{shape}: {mism} elements differ from the plain version")
    words = 8 * int(want[1].long().sum())
    _report(torch, label, f"quantize_pack {shape} ({nb} rows, {words} words)",
            lambda: lorenzo.quantize_pack(x2d, eb, cap), 4 * nb * 256 + 4 * cap + 8 * nb + 4)
    del x2d, got, want
    torch.cuda.empty_cache()


def _time_unpack(torch, lorenzo, ops, name, label, shape, n, gen, dev, eb):
    """Kernel 4 (``unpack_dequantize``) or 3 (``unpack_dequantize_reduce``)
    on the stream of a random walk of n elements: checked against the plain
    version by bits, then timed.  Bytes: the stream to its true length,
    bw and anchor (and acc) in; f32 out."""
    from repro_torch.core.compressed import capacity_words_for

    x2d = ops.to_blocks(_walk(torch, n, gen, dev) * 8.0)
    acc = ops.to_blocks(_walk(torch, n, gen, dev))
    nb = x2d.shape[0]
    cap = capacity_words_for(n, 0.6, 256)
    stream = lorenzo.quantize_pack_plain(x2d, eb, cap)[:3]
    reduce = name == "unpack_dequantize_reduce"
    args = (*stream, eb) + ((acc,) if reduce else ())
    kern = getattr(lorenzo, name)
    got, want = kern(*args), getattr(lorenzo, f"{name}_plain")(*args)
    mism = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if mism:
        raise AssertionError(f"{name} {shape}: {mism} elements differ from the plain version")
    words = 8 * int(stream[1].long().sum())
    _report(torch, label, f"{name} {shape} ({nb} rows, {words} words)", lambda: kern(*args),
            4 * min(words, cap) + 8 * nb + 4 * nb * 256 * (2 if reduce else 1))
    del x2d, acc, stream, got, want
    torch.cuda.empty_cache()


def _time_dequantize(torch, lorenzo, name, label, shape, nb, gen, dev):
    """Kernel 6 (``dequantize``) or 7 (``dequantize_reduce``) on the codes
    and anchors of a random walk of nb rows at eb = 1e-4: checked against
    the plain version by bits, then timed.  Bytes: codes and anchor (and
    acc) in; f32 out."""
    eb = torch.full((), EB, dtype=torch.float32, device=dev)
    codes, _, anchor = lorenzo.quantize(_walk(torch, nb * 256, gen, dev).view(nb, 256), eb)
    acc = _walk(torch, nb * 256, gen, dev).view(nb, 256)
    reduce = name == "dequantize_reduce"
    args = (codes, anchor, eb) + ((acc,) if reduce else ())
    kern = getattr(lorenzo, name)
    got, want = kern(*args), getattr(lorenzo, f"{name}_plain")(*args)
    mism = int((got.view(torch.int32) != want.view(torch.int32)).sum())
    if mism:
        raise AssertionError(f"{name} {shape}: {mism} elements differ from the plain version")
    _report(torch, label, f"{name} {shape} ({nb} rows)", lambda: kern(*args),
            4 * nb * 256 + 4 * nb + 4 * nb * 256 * (2 if reduce else 1))
    del codes, anchor, acc, got, want
    torch.cuda.empty_cache()


def _time_compress(torch, lorenzo, ops, label, n, gen, dev, eb):
    """The fused ``ErrorBoundedLorenzo.compress`` of one bucket: checked
    against the plain kernel 1 (stream, widths, anchors, nwords = 8 *
    sum(bw)), timed as ``_report`` does, then each host step of the call
    timed apart."""
    from repro_torch.core import bitpack
    from repro_torch.core.compressor import ErrorBoundedLorenzo
    from repro_torch.kernels import build, lookback

    comp = ErrorBoundedLorenzo()
    x = _walk(torch, n, gen, dev) * 8.0
    x2d = ops.to_blocks(x)
    c = comp.compress(x, eb)
    cap = c.packed.shape[0]
    want = lorenzo.quantize_pack_plain(x2d, eb, cap)
    mism = sum(int((g != w).sum()) for g, w in zip((c.packed, c.bitwidth, c.anchor), want))
    if mism or int(c.nwords) != 8 * int(want[1].long().sum()):
        raise AssertionError(f"compress: {mism} elements differ, nwords {int(c.nwords)}")
    nb = x2d.shape[0]
    _report(torch, label, f"compress 16 MiB bucket ({nb} rows, cap {cap})",
            lambda: comp.compress(x, eb), 4 * nb * 256 + 4 * cap + 8 * nb + 4)
    lib = build.load("lorenzo", lorenzo._SIGNATURES)
    twoeb, _ = lorenzo._scalars(eb)
    small = (torch.zeros((8, 256), dtype=torch.int32, device=dev),
             torch.zeros(8, dtype=torch.int32, device=dev),
             torch.empty((8, 256), dtype=torch.float32, device=dev))
    steps = {
        "current_stream().cuda_stream": lambda: torch.cuda.current_stream().cuda_stream,
        "build.stream_handle": getattr(build, "stream_handle", None),
        "lookback.scratch": lambda: lookback.scratch(x2d.device, lookback.tiles_for(nb)),
        "eb scalars (2 x eb, 1 / 2eb)": lambda: lorenzo._scalars(eb),
        "torch.empty(cap, int32)": lambda: torch.empty(cap, dtype=torch.int32, device=dev),
        "build.launch of one 8-block lz_dequantize": lambda: build.launch(
            lib, "lz_dequantize", small[0].data_ptr(), small[1].data_ptr(), 8,
            twoeb.data_ptr(), None, small[2].data_ptr()),
        "bitpack.packed_words(bw)": lambda: bitpack.packed_words(c.bitwidth, 256),
        "ops.to_blocks + as_eb": lambda: (ops.to_blocks(x), ops.as_eb(eb, dev)),
    }
    for what, fn in steps.items():
        if fn is None:  # a checkout without this step
            continue
        print(f"[{label}]   host step {what}: {_host_us(torch, fn, 2000):.2f} us per call",
              flush=True)
    del x, x2d, c, want
    torch.cuda.empty_cache()


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default=None)
    ap.add_argument("--kernel", default="unpack_reduce_repack",
                    choices=("unpack_reduce_repack", "quantize_pack", "compress",
                             "unpack_dequantize", "unpack_dequantize_reduce",
                             "dequantize", "dequantize_reduce"))
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_hop_kernel.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core.collectives import PIECE_QUANTUM
    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import lorenzo, ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    label = args.label or args.src
    print(f"[{label}] card: {smi}; package {lorenzo.__file__}", flush=True)
    from repro_torch.kernels import build

    for line in ptxas_lines(build.build("lorenzo")["ptxas"]):
        print(f"[{label}] ptxas lorenzo.cu {line}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    eb_in = torch.full((), EB / 8, dtype=torch.float32, device=dev)
    eb_out = torch.full((), EB / 7, dtype=torch.float32, device=dev)
    quantum = 8 * 2 * PIECE_QUANTUM
    piece = -(-(646_000_000 // 4) // quantum) * quantum // 16
    if args.kernel == "compress":
        _time_compress(torch, lorenzo, ops, label, 4 * 1024 * 1024, gen, dev, eb_in)
        return 0
    if args.kernel == "quantize_pack":
        for shape, n in (("16 MiB bucket", 4 * 1024 * 1024), ("646 MB ring piece", piece)):
            _time_quantize_pack(torch, lorenzo, ops, label, shape, n, gen, dev, eb_in)
        return 0
    if args.kernel in ("dequantize", "dequantize_reduce"):
        chunk = ops.n_blocks_for(646_000_000 // 4 // 8)  # one fused=False scatter chunk
        ring = -(-(16_000_000 // 4) // quantum) * quantum // 16 // 256
        for shape, nb in (("scatter shape", 8 * chunk), ("fused=False scatter chunk", chunk),
                          ("fused=False ring/2 piece at 16 MB", ring)):
            _time_dequantize(torch, lorenzo, args.kernel, label, shape, nb, gen, dev)
        return 0
    if args.kernel.startswith("unpack_dequantize"):
        for shape, n in (("16 MiB bucket", 4 * 1024 * 1024), ("646 MB ring piece", piece)):
            _time_unpack(torch, lorenzo, ops, args.kernel, label, shape, n, gen, dev, eb_in)
        return 0
    cases = [("16 MiB bucket", 4 * 1024 * 1024, True),
             ("646 MB ring piece", piece, False), ("646 MB ring piece", piece, True)]
    for shape, n, emit in cases:
        x2d = ops.to_blocks(_walk(torch, n, gen, dev) * 8.0)
        acc = ops.to_blocks(_walk(torch, n, gen, dev))
        nb = x2d.shape[0]
        cap = capacity_words_for(n, 0.6, 256)
        stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap)[:3]
        words_in = 8 * int(stream[1].long().sum())
        hop_args = (*stream, eb_in, acc, eb_out, cap)
        got = lorenzo.unpack_reduce_repack(*hop_args, emit_f32=emit)
        want = lorenzo.unpack_reduce_repack_plain(*hop_args, emit_f32=emit)
        mism = sum(int((g.view(torch.int32) != w.view(torch.int32)).sum())
                   for g, w in zip(got, want))
        if mism:
            raise AssertionError(f"{shape}: {mism} elements differ from the plain version")
        meta = 8 * nb
        nbytes = 4 * min(words_in, cap) + meta + 4 * nb * 256 + 4 * cap + meta + \
            (4 * nb * 256 if emit else 0)
        _report(torch, label, f"{shape} ({nb} rows, {words_in} words in) emit_f32={emit}",
                lambda: lorenzo.unpack_reduce_repack(*hop_args, emit_f32=emit), nbytes)
        del x2d, acc, stream, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

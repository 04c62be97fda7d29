"""Time the entropy kernels (kernels 8-10) of one checkout of the port.

    python3 scripts/time_entropy_kernels.py [--src DIR] [--label NAME]

``--src`` is the ``src`` directory that holds ``repro_torch`` (default:
this checkout's).  Run it for two checkouts in one process list on one
card (for example a parent unpacked with ``git archive`` into a directory
that ``.gitignore`` lists, then this tree, this tree, the parent) to
compare them.  At the 16 MiB gradient bucket (16,384 rows) and at the
646 MB payload (630,864 rows), lossy at eb = 1e-4 and capacity factor
0.6, it prints for each kernel the median ms of 20 event pairs around 10
back-to-back calls, around one call, the device time per call of the
port's kernels from the profiler (by kernel name, with launches per
call), and the bytes bound at 3.35 TB/s.  It needs a CUDA card, imports
no JAX, and accepts both wrapper signatures: ``quantize_pack`` returning
(stream, desc, anchor) or (stream, desc, anchor, total).
"""
import argparse
import pathlib
import re
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
SHAPES = {"16 MiB bucket": 4 * 1024 * 1024, "646 MB": 646_000_000 // 4}
OWN = re.compile(r"\(anonymous namespace\)::(ent_\w+_kernel|word_offsets_kernel)(<[^>]*>)?")


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


def main(argv):
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve().parents[1] / "src"))
    ap.add_argument("--label", default=None)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("time_entropy_kernels.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(args.src).resolve()))
    from repro_torch.core import entropy as ent
    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, ops

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()[0]
    label = args.label or args.src
    print(f"[{label}] card: {smi}; package {entropy.__file__}", flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    eb = torch.full((), 1e-4, dtype=torch.float32, device=dev)
    for shape, n in SHAPES.items():
        steps = torch.randn(n, dtype=torch.float64, generator=gen, device=dev).mul_(0.01)
        x2d = ops.to_blocks(torch.cumsum(steps, 0).to(torch.float32))
        del steps
        nb = x2d.shape[0]
        acc = torch.randn(nb * 256, generator=gen, device=dev).view(nb, 256)
        cap = capacity_words_for(n, 0.6, 256)
        stream = entropy.quantize_pack(x2d, eb, cap)[:3]
        words = int(ent.packed_words(stream[1]))
        calls = {
            "quantize_pack": (lambda: entropy.quantize_pack(x2d, eb, cap),
                              4 * nb * 256 + 4 * cap + 8 * nb),
            "unpack_dequantize": (lambda: entropy.unpack_dequantize(*stream, eb),
                                  4 * words + 8 * nb + 4 * nb * 256),
            "unpack_dequantize_reduce": (
                lambda: entropy.unpack_dequantize_reduce(*stream, eb, acc),
                4 * words + 8 * nb + 8 * nb * 256),
        }
        for name, (fn, nbytes) in calls.items():
            b2b = _median_ms(torch, fn, calls=10)
            one = _median_ms(torch, fn)
            rows = _device(torch, fn)
            dev_us = sum(us for _, us in rows.values())
            split = "; ".join(f"{k} x{c:g} {us:.1f} us" for k, (c, us) in sorted(rows.items()))
            print(f"[{label}] {shape} ({nb} rows, {words} words) {name}: "
                  f"{b2b:.4f} ms back-to-back, {one:.4f} ms one call, "
                  f"{dev_us / 1e3:.4f} ms device ({split}); bound "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms ({nbytes / 1e6:.1f} MB)",
                  flush=True)
        del x2d, acc, stream
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""Smoke run of the PyTorch/CUDA port on one GPU.

Run from the root of a checkout, with one CUDA card:

    python3 chip_smoke.py

It drives ``repro_torch`` only (no JAX, nothing of the ``repro`` package):

1. prints the card's name and power limit (``nvidia-smi``), builds the
   CUDA kernels from ``src/repro_torch/kernels/csrc`` and prints the build
   time and ``ptxas`` resource lines, and counts the ``HGMMA`` (wgmma) and
   ``UTMALDG`` (TMA load) instructions of kernel 11's bf16 kernel in
   ``cuobjdump -sass`` of its library (it fails if either is 0);
2. holds each of the four fused Lorenzo kernels against its plain
   PyTorch version on the card, on ragged small sizes, on the shapes of
   the allreduce (one pipelined-ring piece and one sequential-ring chunk
   of the 646 MB run), on an overflowing stream and at the default
   ``lorenzo`` gradient sync's 16 MiB bucket: words ``[:cap]``, bw,
   anchor and nwords must be equal and every f32 output bitwise equal;
   prints the mismatch counts and, for rows 1-10, each kernel's median
   time over 10 back-to-back calls, over one call, and its kernels' device
   time (profiler) against its bound (the ring hop, kernel 2, without the
   f32 sum at the ring piece and with it at the bucket, as its paths call
   it); then kernel 2 on its single-pass design's edges, both ``emit_f32``
   modes and its total: one tile, part-full last tiles, outgoing
   capacities on and inside a tile, an incoming stream cut inside a tile,
   an overflowing stream, full-width random bits at the ring piece, 50
   back-to-back calls on one scratch, hop calls interleaved with entropy
   calls on the same stream, and from the profiler one
   ``hop_lookback_kernel`` and one ``hop_zero_tail_kernel`` launch per
   call; then kernel 1 on its single-pass design's
   edges (stream, bw, anchor and total bitwise): one tile, part-full last
   tiles, capacities on and inside a tile, an overflowing stream,
   NaN/Inf/saturating input, full-width random bits at the ring piece, 50
   back-to-back calls on one scratch, calls interleaved with hop and
   entropy calls, and from the profiler one ``qp_lookback_kernel`` and one
   ``qp_zero_tail_kernel`` launch per call; then kernels 3 and 4 on their
   single-pass design's edges (f32 by bits): one tile, part-full last
   tiles, all-zero widths, full-width random bits at the ring piece,
   streams cut on and inside a tile and far below their length,
   ``packed`` 1, 2 and 3 words off a 16-byte boundary and an unaligned
   ``acc``, 50 back-to-back calls on one scratch, calls interleaved with
   kernel 1, kernel 2 and entropy calls, a 0-block call raising, and from
   the profiler one ``ud_lookback_kernel`` launch per call; then kernels
   3, 7 and 10
   (lossy and lossless) with signalling NaNs and NaNs carrying payloads in
   ``acc``, by bits;
3. holds the three unfused kernels (``quantize``, ``dequantize``,
   ``dequantize_reduce``) against their plain versions the same way, on
   ragged sizes, on NaN, +-Inf and values past the int32 range of q, on
   codes whose prefix sum wraps in int32, and at the scatter's shape (8
   chunks of 20,187,500 elements, 630,912 rows in one ``quantize``); then
   kernels 6 and 7 on their tiled design's edges (f32 by bits): one tile
   and part-full last tiles, ``codes`` and ``acc`` 1, 2 and 3 words off a
   16-byte boundary, int32-wrapping codes at the scatter's shape, 50
   back-to-back calls, a 0-row call raising, and from the profiler one
   ``dq_tile_kernel`` launch per call and no ``dequantize_kernel``;
4. runs the allreduce, ``GZCommunicator("x").allreduce`` over a
   ``ThreadGroup`` of ranks on the card, at 646 MB per rank with 8 ranks
   (plan ``ring``, 2 pieces, profiled: the Lorenzo kernels' launches are
   checked against the schedule: 96 hop, 32 kernel 1 and 144
   ``ud_lookback_kernel`` launches of kernels 3 and 4),
   16 MB with 8 ranks (``redoub``)
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
   equal to the fused run on the same inputs, then the 646 MB x 8
   ``scatter`` with ``fused=False`` (the paper's gZ-Scatter on the
   two-pass codec: one ``quantize`` at the root, one ``dequantize`` per
   rank), profiled, bitwise equal to phase 5's fused scatter on the same
   input;
8. holds the three entropy kernels (``entropy_quantize_pack``,
   ``entropy_unpack_dequantize``, ``entropy_unpack_dequantize_reduce``)
   against their plain versions, lossy and lossless (stream, desc, anchor,
   total and both f32 outputs bitwise), at one 16 MiB gradient bucket and
   at the 646 MB payload, and on the single-pass look-back's edges: one
   tile, part-full last tiles, an all-zero stream, capacities on and
   inside a tile, full-width random bits at 646 MB, 50 back-to-back calls
   on one scratch; checks from the profiler that kernel 8 is two launches
   per call, kernels 9 and 10 one;
9. runs the 646 MB x 8 allreduce and the 646 MB scatter under
   ``lorenzo+entropy`` (phase ``codecs``);
10. runs the gradient sync of one minitron-8b decoder layer (973 MB per
    rank, 8 ranks, 59 buckets of 16 MiB) under ``lorenzo+entropy``,
    profiled (each entropy sub-kernel's launches and device time, the
    launch structure checked again), with its host floor at 1/256 size
    (phase ``grad-sync``);
11. the same sync under ``lorenzo`` (then profiled once: kernels 1, 2
    and 3's launches and device time, the launch structure checked), ``lossless``,
    ``passthrough`` and ``codec="auto"``, and at N = 6;
12. runs the degradation layer on the main paths with their real kernels
    (phase ``faults``): the 646 MB x 8 allreduce (ring/2) clean under
    ``verify_streams`` (bitwise the unguarded run, no flag), an injected
    overflow on rank 3, 8 NaNs on rank 5, and a round-1 wire bitflip
    under ``fallback`` (bitwise the rank-order lossless sum of the
    poisoned or sanitized inputs; the bitflip silent without
    ``verify_streams``, caught with it, missed at round 10,000), and
    ``raise`` (every rank raises the reference's message on a forced
    overflow, none on clean data); the 646 MB x 8 scatter with NaN on the
    root (the sanitized lossless scatter) and on a non-root (no flag);
    the gradient sync of one minitron-8b layer in 57 full buckets, every
    one overflowing under ``fallback`` (every leaf bitwise the lossless
    sum); every case with its health counters and the compressed pass's
    exact launches; then the clean allreduce timed with and without
    ``verify_streams`` (warm walls in turns, device busy and the
    checksum's launches and device time from one profile each) and the
    fallback of a forced overflow beside its compressed call;
13. runs the integer ring and the two-level allreduce (phase ``hier``):
    ``GZCommunicator(algo="intring")`` at 646 MB x 8 (every rank the same
    bits, within N 1.05 eb, kernel 5 launched once a rank and kernels
    1-4 never; profiled: kernel 5's device time beside the torch pack,
    unpack and prefix-sum ops; host floor) and at 16 MB x 8 (bitwise the
    port's CPU run on the same inputs; ``policy="accuracy"`` resolves
    ``intring``); ``GZHierCommunicator`` on ``make_hier_mesh(2, 4)`` at
    646 MB and ``A100_SLINGSHOT`` (hierarchical; the inter plan's
    launches; wall and device busy beside the flat 8-rank composite
    call), 4x2 at 16 MB, 2x4 at 16 MB on ``TPU_V5E`` (flat, bitwise the
    8-rank ``GZCommunicator``), the hier fallback of a forced overflow
    at 646 MB (bitwise the composite rank-order sum on every rank), and
    the gradient sync of one minitron-8b layer over ``("local", "node")``
    2x4 under ``lorenzo`` (every leaf within its bound, the bucket count,
    the inter plan's wire bytes);
14. checks that the all-to-all's backward on a one-card ``ThreadGroup``
    raises instead of hanging (phase ``c6``);
15. holds the flash-attention kernel (kernel 11; bf16 on the tensor-core
    route, f32 on the CUDA-core route, each counted) against its plain
    version at D = 32, 64 and 128, f32 and bf16, causal, causal with
    windows 64, 100, 128 and 1000, non-causal with Sq != Sk, ragged lengths
    and rows that see no key, the TMA edges in bf16 (Sq, Sk in {1, 127,
    129, 2049} at D = 64 and 128; H = 1 through ``flash_attention_bhsd``),
    and at the main path's shape (B=2, S=2048, H=32, D=128, bf16), timed
    there beside the plain version, SDPA and the bound, then checked and
    timed beside SDPA at B=8 S=2048 and B=2 S=8192 causal and S=4096
    non-causal (phase ``model``, as are 16-18);
16. runs this slice's main path, ``Model.loss_fn`` of minitron-8b at full
    width and depth (19.76 GB of bf16 weights from seed 0) on a B=2,
    S=2048 batch, through kernel 11 (32 launches, all on the tensor-core
    route) and through the chunked path (none), within 2e-3 of each other,
    profiled;
17. compares the full-sequence logits through kernel 11 at S=128 with 128
    ``decode_fn`` steps (rel <= 0.05);
18. runs ``repro_torch.launch.serve.serve`` at full size (batch 4, 16
    prompt and 32 generated tokens, cache 128) and prints its tokens per
    second.

Every collective run starts with the launch counts at 0 and must launch
each kernel exactly as often as its schedule says, stay within its error
bound, and not overflow (the ``faults`` phase's cases overflow or fail on
purpose and are held by bits to the lossless result instead).

``--phases`` takes a comma list of ``kernels`` (2-3, 8), ``allreduce`` (4),
``movers`` (5-7), ``codecs`` (9), ``grad-sync`` (10-11), ``faults`` (12),
``hier`` (13), ``c6`` (14) and ``model`` (15-18); a partial run prints no
result lines.

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
import re
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
    "flash_attention": "src/repro/kernels/flash_attn.py:82",
}
FLASH_SOURCE = "src/repro_torch/kernels/csrc/flash_attn_sm90.cu"  # the bf16 route
FLASH_BF16_KERNEL = "flash_fwd_wgmma_kernel"
BF16_FLOPS_PER_S = 989.4e12  # H100 SXM dense bf16 tensor-core peak, data sheet
MAIN_BYTES = 646_000_000  # per rank (allreduce) / at the root (scatter): Figs. 10, 12
SCATTER_WIRE_BYTES = 343_566_440  # benchmarks/BENCH_scatter.json, N = 8
MOVER_BYTES = 16_000_000  # per rank: the data movers and the two-pass paths
EB = 1e-4  # GZConfig's default end-to-end bound


def log(*a):
    print(*a, flush=True)


def ptxas_lines(log):
    """``kernel<template arguments>: registers ...; stack and spills`` for
    each entry function of an ``nvcc -Xptxas -v`` log.  The mangled name is
    read by its length prefixes (a namespace, then the kernel); a name of
    another shape is printed as it is."""
    out, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name, spill = _kernel_name(m.group(1)), ""
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line and name:
            out.append(f"{name}: {line.split('Used', 1)[1].strip()}; {spill}")
            name = None
    return out


def _kernel_name(sym):
    m = re.match(r"_ZN(\d+)", sym) or re.match(r"_Z()", sym)
    if not m:
        return sym
    rest = sym[m.end() + int(m.group(1) or 0):]
    n = re.match(r"\d+", rest)
    if not n:
        return sym
    name = rest[n.end(): n.end() + int(n.group())]
    args = re.match(r"I((?:L[bi]\d+E)+)E", rest[n.end() + int(n.group()):])
    if args:
        vals = [("false", "true")[int(v)] if k == "b" else v
                for k, v in re.findall(r"L([bi])(\d+)E", args.group(1))]
        name += f"<{', '.join(vals)}>"
    return name


def _reset_launches():
    from repro_torch.kernels import entropy, flash_attn, lorenzo

    lorenzo.reset_launch_counts()
    entropy.reset_launch_counts()
    flash_attn.reset_launch_counts()


def _launches():
    """Every kernel's launch count since the last reset (the entropy
    kernels under their ``entropy_`` names)."""
    from repro_torch.kernels import entropy, flash_attn, lorenzo

    return {**lorenzo.LAUNCHES, **{f"entropy_{k}": v for k, v in entropy.LAUNCHES.items()},
            **flash_attn.LAUNCHES}


def _device_events(prof):
    """The profile's device-side rows (kernels, copies, fills) with their
    device time.  A host op's row (``aten::mm``) also carries the device
    time of the kernels it launched, so summing every row counts those
    kernels twice; only the device rows are summed."""
    from torch.autograd import DeviceType

    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]


def _median_ms(fn, reps, calls=1):
    """Median over ``reps`` event pairs of the time per call, with ``calls``
    back-to-back calls between the two events (more than one keeps the
    device queue full, so the host's launch time stays out of the figure)."""
    import torch

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


# The port's own kernels (csrc/lorenzo.cu, csrc/entropy.cu) by symbol.
OWN_KERNEL = re.compile(r"\(anonymous namespace\)::(ent_\w+_kernel|hop_\w+_kernel|"
                        r"qp_\w+_kernel|ud_\w+_kernel|quantize_front_kernel|"
                        r"dq_\w+_kernel)\b")


def _device_ms(fn, calls=10):
    """Device time per call of the port's kernels that ``fn`` launches,
    from the profiler over ``calls`` calls (no host time, no torch ops)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return sum(e.self_device_time_total for e in _device_events(prof)
               if OWN_KERNEL.search(e.key)) / 1e3 / calls


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


def _log_time(r, tag):
    log(f"  {r['name']:<34} [{tag}] {r['ms']:.4f} ms back-to-back, "
        f"{r['one_call_ms']:.4f} ms one call, {r['device_ms']:.4f} ms of kernel time "
        f"(profiler); plain {r['plain_ms']:.3f} ms; bound {r['bound_ms']:.4f} ms "
        f"({r['bytes'] / 1e6:.1f} MB)")


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
        # the default ``lorenzo`` grad sync's shape: one 16 MiB bucket
        ("16 MiB bucket", BUCKET_BYTES // 4, 0.6, True),
    ]
    records, timings = {}, []
    for label, n, cf, timed in cases:
        x2d = ops.to_blocks(_random_walk(n, gen, device) * 8.0)
        acc = ops.to_blocks(_random_walk(n, gen, device))
        nb = x2d.shape[0]
        cap = capacity_words_for(n, cf, ops.BLOCK)
        stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap)[:3]
        words_in = int(stream[1].long().sum().item()) * 8
        # the hop in its path's mode: the ring piece without the f32 sum,
        # the bucket (the redoub carry) and the other cases with it
        hop_kw = {"emit_f32": label != "ring-piece", "return_total": True}
        calls = {
            "quantize_pack": ((x2d, eb_in, cap), {}),
            "unpack_reduce_repack": ((*stream, eb_in, acc, eb_out, cap), hop_kw),
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
                if int(got[-1]) != nw_got:
                    raise AssertionError(f"{name}: total {int(got[-1])} != 8 * sum(bw) {nw_got}")
            if name == "unpack_reduce_repack":
                other = {**kw, "emit_f32": not kw["emit_f32"]}  # the other mode too
                _compare(f"{name} [{label} n={n} emit_f32={other['emit_f32']}]",
                         kern(*args, **other), plain(*args, **other))
            line.append(f"{name}=0/{sum(g.numel() for g in got)}")
            if timed:
                emit = kw.get("emit_f32", False)
                nbytes = _bytes(name, nb * ops.BLOCK, nb, cap, words_in, cap, emit)
                rec = {
                    "name": name, "route": "cuda", "source": KERNEL_SOURCE,
                    "replaces": REPLACES[name], "launches": None,
                    "max_abs_err": err,
                    "ms": _median_ms(lambda: kern(*args, **kw), 20, 10),
                    "one_call_ms": _median_ms(lambda: kern(*args, **kw), 20),
                    "device_ms": _device_ms(lambda: kern(*args, **kw)),
                    "plain_ms": _median_ms(lambda: plain(*args, **kw), 5),
                    "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
                    "bound_by": "bytes", "library_ms": None,
                    "shape": [nb, ops.BLOCK], "bytes": nbytes,
                }
                timings.append((label, rec))
                if label == "ring-piece":  # the allreduce's shape
                    records[name] = rec
        log(f"kernels vs plain [{label} n={n} cap={cap} nwords_in={words_in}]: "
            f"mismatches {' '.join(line)}")
    for label, r in timings:
        _log_time(r, label)
    _check_hop_edges(device, gen, eb_in, eb_out)
    _check_pack_edges(device, gen, eb_in)
    _check_unpack_edges(device, gen, eb_in, eb_out)
    _check_nan_acc(device, gen)
    return records


ENTROPY_SYMBOLS = r"ent_\w+_kernel"
LORENZO_SYMBOLS = r"hop_\w+_kernel|qp_\w+_kernel|ud_\w+_kernel|dq_\w+_kernel|quantize_front_kernel"


def _kernel_launches(events, symbols):
    """{kernel symbol: [device launches, device ms]} over a profile's device
    rows of the port's kernels whose names match ``symbols`` (a regex
    alternation)."""
    rows = {}
    for e in events:
        m = re.search(rf"::({symbols})(<[^>]*>)?", e.key)
        if m:
            row = rows.setdefault(m.group(1) + (m.group(2) or ""), [0, 0.0])
            row[0] += e.count
            row[1] += e.self_device_time_total / 1e3
    return rows


def _ud_summary(rows, kernel="ud_lookback_kernel"):
    """Kernels 3 and 4's (or, with ``dq_tile_kernel``, 7 and 6's) launches
    and device ms in ``_kernel_launches`` rows."""
    return ", ".join(f"{rows.get(k, [0, 0.0])[0]} {k} launches, "
                     f"{rows.get(k, [0, 0.0])[1]:.2f} ms"
                     for k in (f"{kernel}<true>", f"{kernel}<false>"))


class ProfileShortfall(AssertionError):
    """A profile that holds fewer launches of a kernel than the bound allows
    and no kernel more than its wrapper launched: what a lossy trace shows."""


def _check_counts(got, want, dropped, what):
    """Each kernel's profiled launches ``got`` within [(1 - dropped) *
    want, want]: more is an error, fewer a ``ProfileShortfall``."""
    if set(got) != set(want) or any(got[k] > want[k] for k in want):
        raise AssertionError(f"{what}: {got} for wrapper calls {want}")
    if any(got[k] < (1 - dropped) * want[k] for k in want):
        raise ProfileShortfall(f"{what}: {got} for wrapper calls {want}")


def _check_hop_launch_structure(rows, calls, label, dropped=0.0):
    """Every ``unpack_reduce_repack`` call is one ``hop_lookback_kernel``
    launch and one ``hop_zero_tail_kernel`` launch, every ``quantize_pack``
    call one ``qp_lookback_kernel`` and one ``qp_zero_tail_kernel``, every
    ``quantize`` call one ``quantize_front_kernel``, every call of kernels
    3 and 4 one ``ud_lookback_kernel`` and every call of kernels 6 and 7
    one ``dq_tile_kernel``.  ``calls`` are the Lorenzo
    wrappers' counts; ``dropped`` is the share of device events a long
    profile may lose (never gain)."""
    want = {"hop_lookback_kernel": calls["unpack_reduce_repack"],
            "hop_zero_tail_kernel": calls["unpack_reduce_repack"],
            "qp_lookback_kernel": calls["quantize_pack"],
            "qp_zero_tail_kernel": calls["quantize_pack"],
            "quantize_front_kernel": calls["quantize"],
            "ud_lookback_kernel": calls["unpack_dequantize"]
            + calls["unpack_dequantize_reduce"],
            "dq_tile_kernel": calls["dequantize"] + calls["dequantize_reduce"]}
    got = dict.fromkeys(want, 0)
    for sym, (count, _) in rows.items():
        base = sym.split("<")[0]
        if base not in got:
            raise AssertionError(f"{label}: {sym} launched {count} times")
        got[base] += count
    _check_counts(got, want, dropped, f"{label}: Lorenzo kernel launches")
    return got


def _check_hop_edges(device, gen, eb_in, eb_out):
    """Kernel 2 against its plain version, bitwise, on the single-pass
    design's edges (both ``emit_f32`` modes, the total too): one tile,
    part-full last tiles, outgoing capacities on and inside a tile, an
    incoming stream cut inside a tile, an overflowing stream, full-width
    random bits at the 646 MB ring piece; 50 back-to-back calls on one
    scratch, and hop calls interleaved with entropy calls on the same stream
    (one scratch allocator); then the launches per call from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, lorenzo, ops

    def hop_case(label, x2d, acc, cap_in, cap_out):
        stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap_in)[:3]
        for emit in (False, True):
            args = (*stream, eb_in, acc, eb_out, cap_out)
            got = lorenzo.unpack_reduce_repack(*args, emit_f32=emit, return_total=True)
            want = lorenzo.unpack_reduce_repack_plain(*args, emit_f32=emit, return_total=True)
            torch.cuda.synchronize()
            _compare(f"unpack_reduce_repack [{label} emit_f32={emit}]", got, want)
        log(f"hop kernel vs plain [{label}, {x2d.shape[0]} rows, cap_in {cap_in}, cap_out "
            f"{cap_out}, {int(got[-1])} words out]: mismatches 0 in stream/bw/anchor/total/"
            f"f32, both emit_f32 modes")
        return got

    def walk(nb):
        return ops.to_blocks(_random_walk(nb * 256, gen, device) * 8.0)

    for nb in (32, 8, 40, 72):  # one tile; part-full last tiles
        x2d, acc = walk(nb), walk(nb) / 8.0
        hop_case("one tile" if nb == 32 else "part-full last tile", x2d, acc,
                 capacity_words_for(nb * 256, 0.6, 256), capacity_words_for(nb * 256, 0.6, 256))
    nb = 5 * 32
    x2d, acc = walk(nb), walk(nb) / 8.0
    ample = capacity_words_for(nb * 256, 2.0, 256)
    bw_out = lorenzo.unpack_reduce_repack_plain(
        *lorenzo.quantize_pack_plain(x2d, eb_in, ample)[:3], eb_in, acc, eb_out, 8)[1]
    for label, cap in _tile_caps((8 * bw_out.long()).tolist(), 3).items():
        if not int(hop_case(label, x2d, acc, ample, cap)[-1]) > cap:
            raise AssertionError(f"{label}: the outgoing stream does not overflow")
    bw_in = lorenzo.quantize_pack_plain(x2d, eb_in, 8)[1]
    hop_case("incoming stream cut inside a tile", x2d, acc,
             _tile_caps((8 * bw_in.long()).tolist(), 2)["cap inside a tile"], ample)
    if not int(hop_case("overflow", x2d, acc, ample, 64)[-1]) > 64:
        raise AssertionError("overflow case did not overflow")
    n = _main_piece_elems()
    bits = ops.to_blocks(_random_bits(n, gen, device))
    acc_bits = ops.to_blocks(_random_bits(n, gen, device))
    cap = capacity_words_for(n, 2.0, 256)
    got = hop_case("646 MB ring piece, full-width random bits", bits, acc_bits, cap, cap)
    full = int((got[1] == 32).sum())
    if full < 0.9 * bits.shape[0]:
        raise AssertionError(f"random bits: {full} of {bits.shape[0]} blocks at width 32")
    del bits, acc_bits, got

    n = BUCKET_BYTES // 4
    x2d, acc = ops.to_blocks(_random_walk(n, gen, device) * 8.0), \
        ops.to_blocks(_random_walk(n, gen, device))
    cap = capacity_words_for(n, 0.6, 256)
    stream = lorenzo.quantize_pack_plain(x2d, eb_in, cap)[:3]
    args = (*stream, eb_in, acc, eb_out, cap)
    want = lorenzo.unpack_reduce_repack_plain(*args, emit_f32=True, return_total=True)
    outs = [lorenzo.unpack_reduce_repack(*args, emit_f32=True, return_total=True)
            for _ in range(50)]
    for i, got in enumerate(outs):
        _compare(f"unpack_reduce_repack [back-to-back call {i}]", got, want)
    del outs
    ent = entropy.quantize_pack_plain(acc, eb_in, cap)
    ent_want = (ent, entropy.unpack_dequantize_reduce_plain(*ent[:3], eb_in, x2d))
    outs = []
    for _ in range(20):  # hop, entropy pack, hop, entropy unpack-reduce: one scratch
        outs.append(("hop", lorenzo.unpack_reduce_repack(*args, emit_f32=True,
                                                         return_total=True)))
        outs.append(("ent", entropy.quantize_pack(acc, eb_in, cap)))
        outs.append(("hop", lorenzo.unpack_reduce_repack(*args, emit_f32=True,
                                                         return_total=True)))
        outs.append(("red", (entropy.unpack_dequantize_reduce(*ent[:3], eb_in, x2d),)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"interleaved call {i} ({kind})", got,
                 want if kind == "hop" else ent_want[0] if kind == "ent" else (ent_want[1],))
    log("hop kernel vs plain [50 back-to-back calls at the 16 MiB bucket, one scratch; "
        "20 rounds interleaved with entropy calls on the same stream]: mismatches 0")
    del outs
    lorenzo.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lorenzo.unpack_reduce_repack(*args, emit_f32=True)
            lorenzo.unpack_reduce_repack(*args)
        torch.cuda.synchronize()
    rows = _kernel_launches(_device_events(prof), LORENZO_SYMBOLS)
    _check_hop_launch_structure(rows, lorenzo.LAUNCHES, "hop calls")
    log(f"hop kernel launches for 6 calls (16 MiB bucket): {rows}")
    del prof, stream, args, want, ent, ent_want
    torch.cuda.empty_cache()


def _check_pack_edges(device, gen, eb):
    """Kernel 1 against its plain version, bitwise (stream, bw, anchor and
    the total, which must be 8 * sum(bw)), on the single-pass design's
    edges: one tile, part-full last tiles, capacities on and inside a tile,
    an overflowing stream, NaN/Inf/saturating input, full-width random bits
    at the 646 MB ring piece; 50 back-to-back calls on one scratch, and
    calls interleaved with hop and entropy calls on the same stream; then
    the launches per call from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, lorenzo, ops

    def case(label, x2d, cap):
        got = lorenzo.quantize_pack(x2d, eb, cap)
        want = lorenzo.quantize_pack_plain(x2d, eb, cap)
        torch.cuda.synchronize()
        _compare(f"quantize_pack [{label}]", got, want)
        total = int(got[-1])
        if total != 8 * int(got[1].long().sum()):
            raise AssertionError(f"quantize_pack [{label}]: total {total} != 8 * sum(bw)")
        log(f"quantize_pack kernel vs plain [{label}, {x2d.shape[0]} rows, cap {cap}, "
            f"{total} words]: mismatches 0 in stream/bw/anchor/total")
        return got

    def walk(nb):
        return ops.to_blocks(_random_walk(nb * 256, gen, device) * 8.0)

    for nb in (32, 8, 40, 72):  # one tile; part-full last tiles
        case("one tile" if nb == 32 else "part-full last tile", walk(nb),
             capacity_words_for(nb * 256, 0.6, 256))
    x2d = walk(5 * 32)
    bw = lorenzo.quantize_pack_plain(x2d, eb, 8)[1]
    for label, cap in {**_tile_caps((8 * bw.long()).tolist(), 3), "overflow": 64}.items():
        if not int(case(label, x2d, cap)[-1]) > cap:
            raise AssertionError(f"{label}: the stream does not overflow")
    case("nan/inf/saturating", ops.to_blocks(_wild(300_000, gen, device)),
         capacity_words_for(300_000, 2.0, 256))
    n = _main_piece_elems()
    bits = ops.to_blocks(_random_bits(n, gen, device))
    got = case("646 MB ring piece, full-width random bits", bits,
               capacity_words_for(n, 2.0, 256))
    full = int((got[1] == 32).sum())
    if full < 0.9 * bits.shape[0]:
        raise AssertionError(f"random bits: {full} of {bits.shape[0]} blocks at width 32")
    del bits, got

    n = BUCKET_BYTES // 4
    x2d, acc = ops.to_blocks(_random_walk(n, gen, device) * 8.0), \
        ops.to_blocks(_random_walk(n, gen, device))
    cap = capacity_words_for(n, 0.6, 256)
    want = lorenzo.quantize_pack_plain(x2d, eb, cap)
    outs = [lorenzo.quantize_pack(x2d, eb, cap) for _ in range(50)]
    for i, got in enumerate(outs):
        _compare(f"quantize_pack [back-to-back call {i}]", got, want)
    hop_args = (*want[:3], eb, acc, eb, cap)
    hop_want = lorenzo.unpack_reduce_repack_plain(*hop_args, emit_f32=True, return_total=True)
    ent = entropy.quantize_pack_plain(acc, eb, cap)
    red_want = (entropy.unpack_dequantize_reduce_plain(*ent[:3], eb, x2d),)
    wants = {"qp": want, "hop": hop_want, "ent": ent, "red": red_want}
    outs = []
    for _ in range(20):  # one scratch for all: kernel 1, hop, entropy pack, kernel 1, reduce
        outs.append(("qp", lorenzo.quantize_pack(x2d, eb, cap)))
        outs.append(("hop", lorenzo.unpack_reduce_repack(*hop_args, emit_f32=True,
                                                         return_total=True)))
        outs.append(("ent", entropy.quantize_pack(acc, eb, cap)))
        outs.append(("qp", lorenzo.quantize_pack(x2d, eb, cap)))
        outs.append(("red", (entropy.unpack_dequantize_reduce(*ent[:3], eb, x2d),)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"interleaved call {i} ({kind})", got, wants[kind])
    log("quantize_pack kernel vs plain [50 back-to-back calls at the 16 MiB bucket, one "
        "scratch; 20 rounds interleaved with hop and entropy calls on the same stream]: "
        "mismatches 0")
    del outs, wants
    lorenzo.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lorenzo.quantize_pack(x2d, eb, cap)
        torch.cuda.synchronize()
    rows = _kernel_launches(_device_events(prof), LORENZO_SYMBOLS)
    _check_hop_launch_structure(rows, lorenzo.LAUNCHES, "quantize_pack calls")
    log(f"quantize_pack kernel launches for 3 calls (16 MiB bucket): {rows}")
    del prof, x2d, acc, want, hop_want, ent, red_want
    torch.cuda.empty_cache()


def _check_unpack_edges(device, gen, eb, eb_out):
    """Kernels 3 and 4 against their plain versions, f32 by bits, on the
    single-pass design's edges: one tile, part-full last tiles, all-zero
    widths, full-width random bits at the 646 MB ring piece (NaNs in acc
    too), streams cut on and inside a tile and far below their length,
    ``packed`` as a view 1, 2 and 3 words off a 16-byte boundary, ``acc``
    as an unaligned view; 50 back-to-back calls on one scratch, and calls
    interleaved on the same stream with kernel 1, kernel 2 and entropy
    calls; a 0-block call raises ``ValueError``; then one
    ``ud_lookback_kernel`` launch per call from the profiler."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, lorenzo, ops

    def case(label, stream, acc):
        got = (lorenzo.unpack_dequantize(*stream, eb),
               lorenzo.unpack_dequantize_reduce(*stream, eb, acc))
        want = (lorenzo.unpack_dequantize_plain(*stream, eb),
                lorenzo.unpack_dequantize_reduce_plain(*stream, eb, acc))
        torch.cuda.synchronize()
        _compare(f"unpack_dequantize [{label}]", got[:1], want[:1])
        _compare(f"unpack_dequantize_reduce [{label}]", got[1:], want[1:])
        words = 8 * int(stream[1].long().sum())
        log(f"unpack kernels vs plain [{label}, {stream[1].shape[0]} rows, cap "
            f"{stream[0].shape[0]}, {words} words]: mismatches 0 by bits, kernels 3 and 4")
        return words

    def walk(nb):
        return ops.to_blocks(_random_walk(nb * 256, gen, device) * 8.0)

    def packed_of(x2d, cap):
        return lorenzo.quantize_pack_plain(x2d, eb, cap)[:3]

    for nb in (32, 8, 40, 72):  # one tile; part-full last tiles
        case("one tile" if nb == 32 else "part-full last tile",
             packed_of(walk(nb), capacity_words_for(nb * 256, 0.6, 256)), walk(nb) / 8.0)
    zero = packed_of(torch.zeros((40, 256), device=device), capacity_words_for(40 * 256, 0.6, 256))
    if case("all-zero widths", zero, walk(40) / 8.0) != 0:
        raise AssertionError("all-zero input: the stream is not empty")
    nb = 5 * 32
    x2d, acc = walk(nb), walk(nb) / 8.0
    ample = capacity_words_for(nb * 256, 2.0, 256)
    stream = packed_of(x2d, ample)
    case("ample capacity", stream, acc)
    for label, cap in {**_tile_caps((8 * stream[1].long()).tolist(), 3),
                       "cut far below the stream": 64}.items():
        if not case(label, packed_of(x2d, cap), acc) > cap:
            raise AssertionError(f"{label}: the stream is not cut")
    for k in (1, 2, 3):  # the stream pointer k words past a 16-byte boundary
        buf = torch.zeros(ample + 4, dtype=torch.int32, device=device)
        view = buf[k: k + ample]
        view.copy_(stream[0])
        case(f"packed {4 * k} bytes off a 16-byte boundary", (view, *stream[1:]), acc)
    buf = torch.empty(nb * 256 + 1, dtype=torch.float32, device=device)
    acc_view = buf[1:].view(nb, 256)
    acc_view.copy_(acc)
    case("acc 4 bytes off a 16-byte boundary", stream, acc_view)
    n = _main_piece_elems()
    bits = ops.to_blocks(_random_bits(n, gen, device))
    stream = packed_of(bits, capacity_words_for(n, 2.0, 256))
    full = int((stream[1] == 32).sum())
    if full < 0.9 * bits.shape[0]:
        raise AssertionError(f"random bits: {full} of {bits.shape[0]} blocks at width 32")
    case("646 MB ring piece, full-width random bits", stream,
         ops.to_blocks(_random_bits(n, gen, device)))
    del bits, stream, buf, acc_view
    words8 = torch.zeros(8, dtype=torch.int32, device=device)
    empty = torch.zeros(0, dtype=torch.int32, device=device)
    for extra in ((), (torch.empty((0, 256), device=device),)):
        fn = lorenzo.unpack_dequantize_reduce if extra else lorenzo.unpack_dequantize
        try:
            fn(words8, empty, empty, eb, *extra)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__}: a 0-block call did not raise ValueError")

    n = BUCKET_BYTES // 4
    x2d, acc = ops.to_blocks(_random_walk(n, gen, device) * 8.0), \
        ops.to_blocks(_random_walk(n, gen, device))
    cap = capacity_words_for(n, 0.6, 256)
    stream = packed_of(x2d, cap)
    wants = {"ud": (lorenzo.unpack_dequantize_plain(*stream, eb),),
             "udr": (lorenzo.unpack_dequantize_reduce_plain(*stream, eb, acc),)}
    outs = []
    for _ in range(25):  # 50 calls back to back, one scratch
        outs.append(("ud", (lorenzo.unpack_dequantize(*stream, eb),)))
        outs.append(("udr", (lorenzo.unpack_dequantize_reduce(*stream, eb, acc),)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"unpack [back-to-back call {i} ({kind})]", got, wants[kind])
    del outs
    hop_args = (*stream, eb, acc, eb_out, cap)
    ent = entropy.quantize_pack_plain(acc, eb, cap)
    wants.update(qp=lorenzo.quantize_pack_plain(x2d, eb, cap),
                 hop=lorenzo.unpack_reduce_repack_plain(*hop_args, emit_f32=True,
                                                        return_total=True),
                 ent=ent, red=(entropy.unpack_dequantize_reduce_plain(*ent[:3], eb, x2d),))
    outs = []
    for _ in range(20):  # kernels 4, 1, 3, 2, entropy pack, 4, entropy reduce: one scratch
        outs.append(("ud", (lorenzo.unpack_dequantize(*stream, eb),)))
        outs.append(("qp", lorenzo.quantize_pack(x2d, eb, cap)))
        outs.append(("udr", (lorenzo.unpack_dequantize_reduce(*stream, eb, acc),)))
        outs.append(("hop", lorenzo.unpack_reduce_repack(*hop_args, emit_f32=True,
                                                         return_total=True)))
        outs.append(("ent", entropy.quantize_pack(acc, eb, cap)))
        outs.append(("ud", (lorenzo.unpack_dequantize(*stream, eb),)))
        outs.append(("red", (entropy.unpack_dequantize_reduce(*ent[:3], eb, x2d),)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"interleaved call {i} ({kind})", got, wants[kind])
    log("unpack kernels vs plain [50 back-to-back calls at the 16 MiB bucket, one scratch; "
        "20 rounds interleaved with kernel 1, kernel 2 and entropy calls on the same "
        "stream]: mismatches 0; a 0-block call raises ValueError")
    del outs, wants
    lorenzo.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lorenzo.unpack_dequantize(*stream, eb)
            lorenzo.unpack_dequantize_reduce(*stream, eb, acc)
        torch.cuda.synchronize()
    rows = _kernel_launches(_device_events(prof), LORENZO_SYMBOLS)
    _check_hop_launch_structure(rows, lorenzo.LAUNCHES, "unpack calls")
    if {k: c for k, (c, _) in rows.items()} != {"ud_lookback_kernel<true>": 3,
                                                 "ud_lookback_kernel<false>": 3}:
        raise AssertionError(f"unpack calls: launches {rows} for 3 calls of kernels 3 and 4")
    log(f"unpack kernel launches for 3 calls each of kernels 3 and 4 (16 MiB bucket): {rows}")
    del prof, x2d, acc, stream, ent
    torch.cuda.empty_cache()


# Signalling NaNs, then quiet ones and NaNs carrying payloads, as f32 bits.
NAN_BITS = (0x7F800001, 0xFF800001, 0x7FA5A5A5, 0xFFBFFFFF,
            0x7FC00000, 0xFFC00000, 0x7FC12345, 0xFFE00ABC, 0x7FFFFFFF)


def _nan_laden(n, gen, device, stride):
    """A random walk with the NaNs of ``NAN_BITS`` every ``stride`` elements
    and +-Inf every 53 and 59."""
    import torch

    x = _random_walk(n, gen, device)
    idx = torch.arange(0, n, stride, device=device)
    nans = torch.tensor(NAN_BITS, dtype=torch.int64, device=device).to(torch.int32)
    x.view(torch.int32)[idx] = nans[torch.arange(idx.numel(), device=device) % len(NAN_BITS)]
    x[11::53] = float("inf")
    x[13::59] = float("-inf")
    return x


def _check_nan_acc(device, gen):
    """Kernels 3, 7 and 10 (lossy and lossless) against their plain
    versions, by bits, with signalling NaNs and NaNs carrying payloads in
    ``acc`` (lossless: NaN values too, both NaN, and inf - inf): a NaN in
    acc comes out as itself, quieted, where the value is not NaN."""
    import torch

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.core.compressor import lossless_capacity_words
    from repro_torch.kernels import entropy, lorenzo, ops

    n = 300_000
    eb = torch.full((), EB, dtype=torch.float32, device=device)
    x2d = ops.to_blocks(_random_walk(n, gen, device) * 8.0)
    acc = ops.to_blocks(_nan_laden(n, gen, device, 37))
    vals = ops.to_blocks(_nan_laden(n, gen, device, 41))  # lossless values
    infs = torch.isinf(acc)
    vals[infs] = -acc[infs]
    cap = capacity_words_for(n, 0.6, 256)
    stream = lorenzo.quantize_pack_plain(x2d, eb, cap)[:3]
    codes, _, anchor = lorenzo.quantize_plain(x2d, eb)
    ent = entropy.quantize_pack_plain(x2d, eb, cap)
    ent_l = entropy.quantize_pack_plain(vals, eb, lossless_capacity_words(n), lossless=True)
    cases = {  # name: (kernel, plain, arguments, keywords, the values decoded)
        "unpack_dequantize_reduce": (lorenzo.unpack_dequantize_reduce,
                                     lorenzo.unpack_dequantize_reduce_plain,
                                     (*stream, eb, acc), {}, x2d),
        "dequantize_reduce": (lorenzo.dequantize_reduce, lorenzo.dequantize_reduce_plain,
                              (codes, anchor, eb, acc), {}, x2d),
        "entropy_unpack_dequantize_reduce": (
            entropy.unpack_dequantize_reduce, entropy.unpack_dequantize_reduce_plain,
            (*ent[:3], eb, acc), {}, x2d),
        "entropy_unpack_dequantize_reduce lossless": (
            entropy.unpack_dequantize_reduce, entropy.unpack_dequantize_reduce_plain,
            (*ent_l[:3], eb, acc), {"lossless": True}, vals),
    }
    nan = torch.isnan(acc)
    for name, (kern, plain, args, kw, values) in cases.items():
        got = kern(*args, **kw)
        want = plain(*args, **kw)
        torch.cuda.synchronize()
        _compare(f"{name} [NaN in acc]", (got,), (want,))
        only = nan & ~torch.isnan(values)
        if not torch.equal(got.view(torch.int32)[only],
                           acc.view(torch.int32)[only] | 0x00400000):
            raise AssertionError(f"{name}: a NaN in acc did not come out as itself, quieted")
        log(f"{name} kernel vs plain [NaN in acc: {int(nan.sum())} NaNs, "
            f"{int(infs.sum())} infinities, {int((nan & ~only).sum())} NaN values under a "
            f"NaN acc]: mismatches 0 by bits")
    del x2d, acc, vals, stream, codes, ent, ent_l
    torch.cuda.empty_cache()


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


def _check_dequant_edges(device, gen, eb):
    """Kernels 6 and 7 against their plain versions, f32 by bits, on the
    tiled design's edges: one tile, full tiles and part-full last tiles
    (1, 7, 8, 31, 32, 33, 40, 72, 264 and 16,895 rows in 8-block tiles,
    16,896 and 16,929 rows in 32-block tiles), ``codes`` and ``acc`` as
    views 1, 2 and 3 words off a 16-byte boundary, int32-wrapping codes
    at the scatter's shape (630,912 rows), 50 back-to-back calls at one
    ``fused=False`` scatter chunk (78,864 rows); a 0-row call raises
    ``ValueError``; then,
    from the profiler, one ``dq_tile_kernel`` launch per call and no other
    Lorenzo kernel (the one-CTA-per-block ``dequantize_kernel`` included)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import lorenzo, ops

    def case(label, codes, anchor, acc):
        got = (lorenzo.dequantize(codes, anchor, eb),
               lorenzo.dequantize_reduce(codes, anchor, eb, acc))
        want = (lorenzo.dequantize_plain(codes, anchor, eb),
                lorenzo.dequantize_reduce_plain(codes, anchor, eb, acc))
        torch.cuda.synchronize()
        _compare(f"dequantize [{label}]", got[:1], want[:1])
        _compare(f"dequantize_reduce [{label}]", got[1:], want[1:])
        log(f"unfused decode vs plain [{label}, {codes.shape[0]} rows]: mismatches 0 by "
            f"bits, kernels 6 and 7")

    def smooth(nb):
        x2d = (_random_walk(nb * 256, gen, device) * 8.0).view(nb, 256)
        codes, _, anchor = lorenzo.quantize_plain(x2d, eb)
        return codes, anchor, _random_walk(nb * 256, gen, device).view(nb, 256)

    for nb in (1, 7, 8, 31, 32, 33, 40, 72, 264, 16_895, 16_896, 16_929):
        tile = 32 if nb >= 16_896 else 8  # lz_dequantize's kWideRows
        label = "one tile" if nb == tile else "part-full last tile" if nb % tile else \
            "full tiles"
        case(f"{label} of {tile} blocks", *smooth(nb))
    nb = 72
    codes, anchor, acc = smooth(nb)
    for k in (1, 2, 3):  # both pointers k words past a 16-byte boundary
        cbuf = torch.zeros(nb * 256 + 4, dtype=torch.int32, device=device)
        abuf = torch.zeros(nb * 256 + 4, dtype=torch.float32, device=device)
        cview, aview = cbuf[k: k + nb * 256].view(nb, 256), abuf[k: k + nb * 256].view(nb, 256)
        cview.copy_(codes)
        aview.copy_(acc)
        case(f"codes and acc {4 * k} bytes off a 16-byte boundary", cview, anchor, aview)
    del cbuf, abuf, cview, aview
    rows = 8 * ops.n_blocks_for(MAIN_BYTES // 4 // 8)
    codes, anchor = _wrapping_codes(rows, gen, device)
    case("int32-wrapping codes at the scatter shape", codes, anchor,
         _random_walk(rows * 256, gen, device).view(rows, 256) * 1e6)
    del codes, anchor
    torch.cuda.empty_cache()
    for extra in ((), (torch.empty((0, 256), device=device),)):
        fn = lorenzo.dequantize_reduce if extra else lorenzo.dequantize
        try:
            fn(torch.zeros((0, 256), dtype=torch.int32, device=device),
               torch.zeros(0, dtype=torch.int32, device=device), eb, *extra)
        except ValueError:
            continue
        raise AssertionError(f"{fn.__name__}: a 0-row call did not raise ValueError")

    codes, anchor, acc = smooth(ops.n_blocks_for(MAIN_BYTES // 4 // 8))
    wants = {"dq": lorenzo.dequantize_plain(codes, anchor, eb),
             "dqr": lorenzo.dequantize_reduce_plain(codes, anchor, eb, acc)}
    outs = []
    for _ in range(25):  # 50 calls back to back
        outs.append(("dq", lorenzo.dequantize(codes, anchor, eb)))
        outs.append(("dqr", lorenzo.dequantize_reduce(codes, anchor, eb, acc)))
    for i, (kind, got) in enumerate(outs):
        _compare(f"unfused decode [back-to-back call {i} ({kind})]", (got,), (wants[kind],))
    log(f"unfused decode vs plain [50 back-to-back calls at one fused=False scatter chunk, "
        f"{codes.shape[0]} rows]: mismatches 0; a 0-row call raises ValueError")
    del outs, wants
    lorenzo.reset_launch_counts()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            lorenzo.dequantize(codes, anchor, eb)
            lorenzo.dequantize_reduce(codes, anchor, eb, acc)
        torch.cuda.synchronize()
    rows = _kernel_launches(_device_events(prof), LORENZO_SYMBOLS + "|dequantize_kernel")
    _check_hop_launch_structure(rows, lorenzo.LAUNCHES, "unfused decode calls")
    if {k: c for k, (c, _) in rows.items()} != {"dq_tile_kernel<true>": 3,
                                                 "dq_tile_kernel<false>": 3}:
        raise AssertionError(f"unfused decode calls: launches {rows} for 3 calls of kernels "
                             f"6 and 7")
    log(f"unfused decode kernel launches for 3 calls each of kernels 6 and 7 "
        f"({codes.shape[0]} rows): {rows}")
    del prof, codes, anchor, acc
    torch.cuda.empty_cache()


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
                    "ms": _median_ms(lambda: kern(*args), 20, 10),
                    "one_call_ms": _median_ms(lambda: kern(*args), 20),
                    "device_ms": _device_ms(lambda: kern(*args)),
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
    del codes, anchor, acc
    _check_dequant_edges(device, gen, eb)
    for r in records.values():
        _log_time(r, "scatter shape")
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
    if plan.op == "allreduce" and plan.algo == "intring":
        e["quantize"] += n  # one quantization per rank; packs and sums are torch ops
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
    and at each of ``intervals``.  Returns (the profile's device events,
    device busy ms, warm wall seconds, traced wall seconds)."""
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
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"profile: warm wall {warm * 1e3:.1f} ms; traced wall {traced * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %)")
    rows = _kernel_launches(events, LORENZO_SYMBOLS)
    got = _check_hop_launch_structure(rows, _expected_launches(plan, group.size),
                                      f"profiled {plan.op}", dropped=0.05)
    log(f"  Lorenzo launches in the profile (by kernel): {got}; "
        + "; ".join(f"{k} {c} x {ms:.2f} ms" for k, (c, ms) in sorted(rows.items())))
    log("  kernels 3 and 4 (ud_lookback_kernel<true> / <false>): "
        + _ud_summary(rows))
    log("  kernels 7 and 6 (dq_tile_kernel<true> / <false>): "
        + _ud_summary(rows, "dq_tile_kernel"))
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
    return events, busy, warm, traced


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


def run_scatter(n, nbytes, device, gen, label, profile=False, codec="lorenzo", fused=True,
                fused_run=None):
    """``scatter`` of ``nbytes`` at the root over n ranks.  Non-root
    inputs are NaN: only the root's payload is significant.  With
    ``fused_run``, the (root input, results) of an earlier scatter, it
    scatters that input and must be bitwise equal to those results.
    Returns (plan, launches, wall, (root input, results))."""
    import torch

    from repro_torch.core import bitpack, transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator
    from repro_torch.kernels import lorenzo, ops

    n_elems = nbytes // 4 // n * n  # whole chunks
    x_full = _random_walk(n_elems, gen, device) if fused_run is None else fused_run[0]
    junk = torch.full_like(x_full, float("nan"))
    xs = [x_full] + [junk] * (n - 1)
    comm = GZCommunicator("x", config=GZConfig(codec=codec, fused=fused), axis_size=n,
                          device=device)
    plan = comm.plan("scatter", (n_elems,))
    streams = sum(h.chunk_slab[1] for rnd in plan.route_table.rounds for h in rnd
                  if h.sender == 0)
    group = transport.ThreadGroup(n, device)
    res, launches, wall = _run(group, comm, "scatter", xs)
    chunk = n_elems // n
    err = _check_result(f"scatter {label}", res,
                        [x_full[r * chunk:(r + 1) * chunk].double() for r in range(n)],
                        1e-6)
    log(f"scatter {label} N={n} {nbytes / 1e6:.0f} MB at the root, codec {codec}, "
        f"fused={fused}: algo={plan.algo} "
        f"pipeline_chunks={plan.pipeline_chunks} wire_bytes={plan.wire_bytes} "
        f"root_chunk_streams={streams} ratio={plan.ratio:.4f} cold wall "
        f"{wall * 1e3:.1f} ms err={err:.3e} launches={_nonzero(launches)}")
    if (plan.algo, plan.pipeline_chunks, streams) != ("binomial", 1, n - 1):
        raise AssertionError(f"scatter plan {plan.algo}/{plan.pipeline_chunks} with "
                             f"{streams} root streams")
    _check_launches(plan, n, launches)
    if fused_run is not None:
        mism = _bitwise_mismatches(res, fused_run[1])
        log(f"scatter {label}: vs the earlier run on the same input, mismatches={mism}")
        if mism:
            raise AssertionError(f"scatter {label}: differs from the earlier run in {mism}")
    if profile:
        _profile(group, comm.scatter, xs, plan)
        rows = ops.n_blocks_for(chunk)
        x2d = ops.to_blocks(x_full[:chunk])
        codes, bw, _ = lorenzo.quantize(x2d, ops.as_eb(EB, device))
        cap = plan.capacity_words
        ms = _median_ms(lambda: bitpack.pack(codes, bw, cap), 5)
        log(f"bitpack.pack (torch ops) at one chunk ({rows} rows, cap {cap}): {ms:.3f} ms "
            f"median; x {n} chunks = {n * ms:.2f} ms per scatter")
        if not fused:  # the two-pass decode's unpack, once per rank
            packed = bitpack.pack(codes, bw, cap)[0]
            ms = _median_ms(lambda: bitpack.unpack(packed, bw, ops.BLOCK), 5)
            log(f"bitpack.unpack (torch ops) at one chunk: {ms:.3f} ms median, once per rank")
    del xs, junk
    torch.cuda.empty_cache()
    return plan, launches, wall, (x_full, res)


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


def _entropy_bytes(name, nb, words, cap):
    """Bytes an entropy kernel must move: inputs once, outputs once; a
    received stream only to its true length, a packed one to its capacity
    (the words past the total are zeroed)."""
    n, meta = nb * 256, 8 * nb  # desc + anchor
    if name == "entropy_quantize_pack":
        return 4 * n + 4 * cap + meta + 4
    if name == "entropy_unpack_dequantize":
        return 4 * words + meta + 4 * n
    return 4 * words + meta + 8 * n  # + acc in


def _entropy_calls(stream, x2d, acc, eb, cap):
    """Kernels 8-10's (wrapper name, arguments) on one input and stream."""
    return {ENTROPY_KERNELS[0]: ("quantize_pack", (x2d, eb, cap)),
            ENTROPY_KERNELS[1]: ("unpack_dequantize", (*stream, eb)),
            ENTROPY_KERNELS[2]: ("unpack_dequantize_reduce", (*stream, eb, acc))}


def _time_entropy(tag, stream, x2d, acc, eb, cap, words, errs, lossless):
    """Kernels 8-10's records at one shape: median ms of 10 back-to-back
    calls per event pair (``ms``) and of one call per pair
    (``one_call_ms``, the host's launch included), the plain version's,
    and the bytes bound."""
    from repro_torch.kernels import entropy

    records, nb = {}, x2d.shape[0]
    for name, (fn, args) in _entropy_calls(stream, x2d, acc, eb, cap).items():
        kern, plain = getattr(entropy, fn), getattr(entropy, f"{fn}_plain")
        nbytes = _entropy_bytes(name, nb, words, cap)
        rec = records[name] = {
            "name": name, "route": "cuda", "source": ENTROPY_SOURCE,
            "replaces": REPLACES[name], "launches": None, "max_abs_err": errs[name],
            "ms": _median_ms(lambda: kern(*args, lossless=lossless), 20, 10),
            "one_call_ms": _median_ms(lambda: kern(*args, lossless=lossless), 20),
            "device_ms": _device_ms(lambda: kern(*args, lossless=lossless)),
            "plain_ms": _median_ms(lambda: plain(*args, lossless=lossless),
                                   1 if nb > 100_000 else 5),
            "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "bound_by": "bytes", "library_ms": None,
            "shape": [nb, 256], "bytes": nbytes,
        }
        _log_time(rec, tag)
    return records


def _tile_caps(words, tile):
    """Capacities that end a stream of per-block word counts ``words``
    exactly at the end of look-back tile ``tile`` and inside it (in its
    first non-empty block)."""
    from repro_torch.kernels import lookback

    r = lookback.TILE_BLOCKS
    first = next(w for w in words[tile * r:] if w)
    return {"cap on a tile boundary": sum(words[: (tile + 1) * r]),
            "cap inside a tile": sum(words[: tile * r]) + first // 2 + 1}


def _entropy_words(desc):
    from repro_torch.core import entropy as ent

    return (ent.split_desc(desc).long().sum(dim=1) * ent.SUB_WORDS_PER_BIT).tolist()


def _entropy_case(label, x2d, acc, eb, cap, lossless):
    """Kernels 8-10 against their plain versions on one input: stream
    words [:cap], desc, anchor, the total and both f32 outputs bitwise.
    Returns (each kernel's max |err|, the kernel's stream, total words)."""
    import torch

    from repro_torch.core import entropy as ent
    from repro_torch.kernels import entropy

    mode = "lossless" if lossless else "lossy"
    got = entropy.quantize_pack(x2d, eb, cap, lossless=lossless)
    want = entropy.quantize_pack_plain(x2d, eb, cap, lossless=lossless)
    torch.cuda.synchronize()
    errs = {ENTROPY_KERNELS[0]: _compare(f"entropy quantize_pack [{label} {mode}]", got, want)}
    words = int(got[3])
    if words != int(ent.packed_words(got[1])):
        raise AssertionError(f"{label} {mode}: total {words} != packed_words(desc)")
    calls = _entropy_calls(got[:3], x2d, acc, eb, cap)
    for name in ENTROPY_KERNELS[1:]:
        fn, args = calls[name]
        out = getattr(entropy, fn)(*args, lossless=lossless)
        errs[name] = _compare(f"entropy {fn} [{label} {mode}]", (out,),
                              (getattr(entropy, f"{fn}_plain")(*args, lossless=lossless),))
        if lossless and fn == "unpack_dequantize" and words <= cap:
            if not torch.equal(out.view(torch.int32), x2d.view(torch.int32)):
                raise AssertionError(f"{label}: lossless round trip is not exact")
        del out
    log(f"entropy kernels vs plain [{label} {mode}, {x2d.shape[0]} rows, cap {cap}, "
        f"{words} words]: mismatches 0 in stream/desc/anchor/total and both f32 outputs")
    return errs, got[:3], words


def _check_entropy_edges(device, gen, eb):
    """The look-back's edges beyond the data cases: capacities on and
    inside a tile, a part-full last tile (the unpack kernels take any
    block count; quantize_pack's is a multiple of the tile), and 50
    back-to-back calls of each kernel on one scratch, each compared."""
    import torch

    from repro_torch.core.compressed import capacity_words_for
    from repro_torch.kernels import entropy, ops

    nb5 = 5 * entropy.TILE_BLOCKS
    x2d = ops.to_blocks(_random_walk(nb5 * 256, gen, device))
    acc = _random_walk(nb5 * 256, gen, device).view(nb5, 256)
    for lossless in (False, True):
        packed, desc, anchor, _ = entropy.quantize_pack_plain(x2d, eb, nb5 * 256,
                                                              lossless=lossless)
        for label, cap in _tile_caps(_entropy_words(desc), 3).items():
            if not _entropy_case(label, x2d, acc, eb, cap, lossless)[2] > cap:
                raise AssertionError(f"{label}: the stream does not overflow")
        for nb in (45, 13, 1):
            for fn, extra in (("unpack_dequantize", ()),
                              ("unpack_dequantize_reduce", (acc[:nb],))):
                args = (packed, desc[:nb], anchor[:nb], eb, *extra)
                _compare(f"entropy {fn} [{nb} rows, part-full tile]",
                         (getattr(entropy, fn)(*args, lossless=lossless),),
                         (getattr(entropy, f"{fn}_plain")(*args, lossless=lossless),))
        log(f"entropy unpack kernels vs plain [45, 13 and 1 rows: a part-full last tile, "
            f"{'lossless' if lossless else 'lossy'}]: mismatches 0")

    n = BUCKET_BYTES // 4
    x2d = ops.to_blocks(_random_walk(n, gen, device))
    acc = _random_walk(n, gen, device).view(-1, 256)
    cap = capacity_words_for(n, 0.6, 256)
    want = entropy.quantize_pack_plain(x2d, eb, cap)
    calls = _entropy_calls(want[:3], x2d, acc, eb, cap)
    wants = {name: want if name == ENTROPY_KERNELS[0] else
             (getattr(entropy, f"{fn}_plain")(*args),) for name, (fn, args) in calls.items()}
    outs = [{name: getattr(entropy, fn)(*args) for name, (fn, args) in calls.items()}
            for _ in range(50)]
    for i, out in enumerate(outs):
        for name, got in out.items():
            _compare(f"{name} [back-to-back call {i}]",
                     got if isinstance(got, tuple) else (got,), wants[name])
    log("entropy kernels vs plain [50 back-to-back calls of each at the 16 MiB bucket, "
        "one scratch]: mismatches 0")
    del outs, wants
    torch.cuda.empty_cache()


def _check_entropy_launch_structure(rows, calls, label, dropped=0.0):
    """Kernel 8 is one look-back launch and one tail launch per call,
    kernels 9 and 10 one launch each, and nothing else runs.  Over
    a long traced window the profiler can lose a few device events (it
    kept 1,392 of 1,416 in a traced gradient sync on the H100), never add
    any: ``dropped`` is the share of launches it may miss."""
    want = {"ent_pack_lookback_kernel": calls["quantize_pack"],
            "ent_zero_tail_kernel": calls["quantize_pack"],
            "ent_unpack_lookback_kernel": calls["unpack_dequantize"]
            + calls["unpack_dequantize_reduce"]}
    got = dict.fromkeys(want, 0)
    for sym, (count, _) in rows.items():
        base = sym.split("<")[0]
        got[base] = got.get(base, 0) + count
    _check_counts(got, want, dropped, f"{label}: entropy kernel launches")


def check_entropy_kernels(device, gen):
    """Kernels 8-10 against their plain versions, bitwise, lossy and
    lossless, on ragged, zero-width, non-finite and overflowing inputs and
    the look-back's edges (one tile, an all-zero stream, full-width random
    bits at 646 MB, then ``_check_entropy_edges``); the launches each call
    makes, from the profiler; median ms at the 16 MiB bucket and the 646 MB
    payload."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        ("one part-full tile n=2048", _random_walk(2048, gen, device), 0.6, False),
        ("one tile n=8192", _random_walk(8192, gen, device), 0.6, False),
        ("ragged n=6149", _random_walk(2048 * 3 + 5, gen, device), 0.6, False),
        ("ragged n=2504", _random_walk(256 * 9 + 200, gen, device), 2.0, False),
        ("zero blocks", zero_blocks(4096), 0.6, False),
        ("all zero", torch.zeros(64 * 256, device=device), 0.6, False),
        ("nan/inf/saturating", _wild(300_000, gen, device), 2.0, False),
        ("random bits", _random_bits(300_000, gen, device), 2.0, False),
        ("overflow", _random_bits(300_000, gen, device), 0.05, False),
        ("16 MiB bucket", _random_walk(BUCKET_BYTES // 4, gen, device), 0.6, True),
        ("646 MB", _random_walk(MAIN_BYTES // 4, gen, device), 0.6, True),
        ("646 MB random bits", _random_bits(MAIN_BYTES // 4, gen, device), 2.0, False),
    ]
    records = {}
    for label, x, cf, timed in cases:
        n = x.numel()
        x2d = ops.to_blocks(x)
        nb = x2d.shape[0]
        acc = _random_walk(nb * 256, gen, device).view(nb, 256)
        for lossless in (False, True):
            cap = (lossless_capacity_words(n) if lossless and cf != 0.05
                   else capacity_words_for(n, cf, 256))
            errs, stream, words = _entropy_case(label, x2d, acc, eb, cap, lossless)
            if (words > cap) != (cf == 0.05):
                raise AssertionError(f"{label}: {words} words for capacity {cap}")
            if label == "all zero" and words:
                raise AssertionError(f"all-zero input packed to {words} words")
            if label == "646 MB random bits" and lossless and not cap - 256 < words <= cap:
                raise AssertionError(f"full-width stream: {words} words, capacity {cap}")
            if label == "16 MiB bucket":  # launches per call, from the profiler
                calls = _entropy_calls(stream, x2d, acc, eb, cap)
                entropy.reset_launch_counts()
                with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                    for fn, args in calls.values():
                        for _ in range(3):
                            getattr(entropy, fn)(*args, lossless=lossless)
                    torch.cuda.synchronize()
                rows = _kernel_launches(_device_events(prof), ENTROPY_SYMBOLS)
                _check_entropy_launch_structure(rows, entropy.LAUNCHES, label)
                log(f"entropy kernel launches for 3 calls of each ({label}): {rows}")
                del prof
            if timed:
                recs = _time_entropy(f"{label} {'lossless' if lossless else 'lossy'}",
                                     stream, x2d, acc, eb, cap, words, errs, lossless)
                if label == "16 MiB bucket" and not lossless:
                    records.update(recs)  # the main path's shape and mode
            del stream
        del x, x2d, acc
        torch.cuda.empty_cache()
    _check_entropy_edges(device, gen, eb)
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


def _sync_for(codec, bucket_bytes=None):
    """The gradient sync's config: redoub, relative eb 1e-4, ``codec``,
    16 MiB buckets unless ``bucket_bytes`` is given."""
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.grad_sync import SyncConfig

    return SyncConfig(gz=GZConfig(eb=1e-4, algo="redoub", worst_case_budget=False,
                                  codec=codec), bucket_bytes=bucket_bytes or BUCKET_BYTES)


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


def _traced_sync(group, trees, sync, device, label, check):
    """``_sync_once`` under torch.profiler, its launch structure held by
    ``check(device events, launch counts)``.  A trace of a whole sync can
    lose device events (on the H100 up to 7 % of a sync's launches, in
    stretches at either end or inside; the wrappers' counts, checked
    exactly beside it, were right): a trace whose counts fall short of the
    bound (``ProfileShortfall``), and no more, is logged and taken again,
    at most three times.  Returns (device events, launch counts, traced
    wall seconds, what ``check`` returned)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, calls, traced = _sync_once(group, trees, sync, device)
        del res
        events = _device_events(prof)
        try:
            return events, calls, traced, check(events, calls)
        except ProfileShortfall as e:
            log(f"{label}: {e}; taking the trace again")
    raise AssertionError(f"{label}: three traces fell short of the wrappers' launch counts")


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

    from repro_torch.core import transport

    n = 8
    torch.cuda.reset_peak_memory_stats()
    trees = _layer_grads(n, gen, device)
    total = sum(a.numel() for a in _flat_leaves(trees[0]))
    if total != GRAD_SYNC_ELEMS:
        raise AssertionError(f"layer tree has {total} elements")
    group = transport.ThreadGroup(n, device)
    sync = _sync_for("lorenzo+entropy")
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
    def entropy_calls(launches):
        return {k[len("entropy_"):]: v for k, v in launches.items() if k in ENTROPY_KERNELS}

    events, calls, traced, _ = _traced_sync(
        group, trees, sync, device, "grad sync entropy",
        lambda ev, launches: _check_entropy_launch_structure(
            _kernel_launches(ev, ENTROPY_SYMBOLS), entropy_calls(launches), "grad sync",
            dropped=0.05))
    calls = entropy_calls(calls)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"grad sync profile: warm wall {warm * 1e3:.1f} ms; traced wall "
        f"{traced * 1e3:.1f} ms, device busy {busy:.1f} ms "
        f"({100 * busy / (traced * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:16]:
        log(f"  {e.count:>6} x {e.self_device_time_total / 1e3:8.2f} ms  {e.key[:160]}")
    rows = _kernel_launches(events, ENTROPY_SYMBOLS)
    for sym, (count, ms) in sorted(rows.items()):
        log(f"  entropy sub-kernel {sym}: {count} launches, {ms:.2f} ms of device time "
            f"({1e3 * ms / max(count, 1):.2f} us each)")
    log(f"  wrapper calls in the profiled sync: {calls}")
    del events
    small = _layer_grads(n, gen, device, shrink=256)
    small_sync = _sync_for("lorenzo+entropy", BUCKET_BYTES // 256)
    walls = [_sync_once(group, small, small_sync, device)[2] for _ in range(3)]
    log(f"grad sync host floor: the same tree and buckets at 1/256 size "
        f"({sum(a.numel() for a in _flat_leaves(small[0]))} f32/rank), warm wall "
        f"{min(walls[1:]) * 1e3:.1f} ms")
    del small

    results = {}
    for codec in ("lorenzo", "lossless", "passthrough", "auto"):
        s = _sync_for(codec)
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
        if codec == "lorenzo":  # kernels 1 and 2 in the default sync, from the profiler
            events, calls, traced, got = _traced_sync(
                group, trees, s, device, "grad sync lorenzo",
                lambda ev, launches: _check_hop_launch_structure(
                    _kernel_launches(ev, LORENZO_SYMBOLS), launches, "grad sync lorenzo",
                    dropped=0.05))
            busy = sum(e.self_device_time_total for e in events) / 1e3
            rows = _kernel_launches(events, LORENZO_SYMBOLS)
            hop = [(c, ms) for k, (c, ms) in rows.items() if k.startswith("hop_lookback")]
            qp_ms = sum(ms for k, (_, ms) in rows.items() if k.startswith("qp_"))
            ud_ms = sum(ms for k, (_, ms) in rows.items() if k.startswith("ud_"))
            log(f"grad sync lorenzo profile: traced wall {traced * 1e3:.1f} ms, device busy "
                f"{busy:.1f} ms; kernel 2: {calls['unpack_reduce_repack']} calls, "
                f"{sum(c for c, _ in hop)} hop_lookback_kernel launches, "
                f"{sum(ms for k, (_, ms) in rows.items() if k.startswith('hop_')):.2f} ms of "
                f"device time with its tail launches; kernel 1: {calls['quantize_pack']} "
                f"calls, {qp_ms:.2f} ms of device time with its tail launches, "
                f"{qp_ms / n:.3f} ms per rank; kernel 3: "
                f"{calls['unpack_dequantize_reduce']} calls, {_ud_summary(rows)}, "
                f"{ud_ms / n:.3f} ms per rank; Lorenzo launches {got}; "
                + "; ".join(f"{k} {c} x {ms:.2f} ms" for k, (c, ms) in sorted(rows.items())))
            del events
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
# Phase faults: the degradation layer at full size
# ---------------------------------------------------------------------------

FAULTS_SCATTER_NAN = 8  # poisoned positions of the NaN specs
# 57 full buckets of the layer's 243,277,824 f32 (17.07 MB each): under the
# default 16 MiB the 59th bucket holds 1,728 values and zeros, a stream
# that fits any capacity (one word per block at least), so it could not
# overflow.
FALLBACK_BUCKET_BYTES = GRAD_SYNC_ELEMS // 57 * 4


def _fold(parts):
    """Rank-order sum, the lossless fallback's (``transport.sum_across``)."""
    out = parts[0]
    for p in parts[1:]:
        out = out + p
    return out


def _sanitized(x):
    import torch

    return torch.where(torch.isfinite(x), x, torch.zeros((), dtype=x.dtype, device=x.device))


def _health(op, want, label):
    """The health counters of the one call since the last clear: exactly
    ``want`` = (overflow, nonfinite, fell back) for ``op``."""
    from repro_torch.core import comm

    got = comm.health_stats()
    comm.clear_health_stats()
    o, nf, fb = want
    expect = {(op, "'x'"): {"calls": 1, "overflow": int(o), "nonfinite": int(nf),
                            "fallbacks": int(fb)}}
    if got != expect:
        raise AssertionError(f"{label}: health counters {got} != {expect}")


def _flags(res):
    """(overflow, nonfinite), which must be the same on every rank."""
    pairs = {(bool(r.overflow), bool(r.nonfinite)) for r in res}
    if len(pairs) != 1:
        raise AssertionError(f"ranks disagree on the flags: {pairs}")
    return pairs.pop()


def _equal_to(res, wants, label):
    """Every rank's value bitwise equal to its wanted tensor."""
    import torch

    mism = sum(int((r.value.view(torch.int32) != w.view(torch.int32)).sum())
               for r, w in zip(res, wants))
    if mism:
        raise AssertionError(f"{label}: {mism} elements differ")


def _fault_case(group, comm, op, xs, spec, plan, label, want_flags, wants):
    """One call under ``spec`` (or none): flags, the health counters, the
    compressed pass's exact launches (the lossless re-run launches no
    codec kernel) and, with ``wants``, bitwise values.  Returns (results,
    wall seconds)."""
    from repro_torch.core import faults

    with faults.inject(spec) if spec is not None else contextlib.nullcontext():
        res, launches, wall = _run(group, comm, op, xs)
    flags = _flags(res)
    log(f"faults {label}: flags (overflow, nonfinite) {flags}, wall {wall * 1e3:.1f} ms, "
        f"launches={_nonzero(launches)}")
    if want_flags is not None and flags != want_flags:
        raise AssertionError(f"{label}: flags {flags} != {want_flags}")
    _check_launches(plan, group.size, launches)
    if wants is not None:
        _equal_to(res, wants, label)
    fell_back = comm.config.on_overflow == "fallback" and any(flags)
    _health(op, flags + (fell_back,), label)
    return res, wall


def _checksum_profile(group, comm, xs, label):
    """Device busy time of one call, and the launches and device time of
    the stream checksum's kernels (the concatenation and the XOR fold)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        group.run(comm.allreduce, xs, axis_name="x")
        torch.cuda.synchronize()
    events = _device_events(prof)
    busy = sum(e.self_device_time_total for e in events) / 1e3
    xor = [e for e in events if "BitwiseXor" in e.key]
    cat = [e for e in events if "CatArrayBatchedCopy" in e.key]
    rows = {k: (sum(e.count for e in ev), sum(e.self_device_time_total for e in ev) / 1e3)
            for k, ev in (("xor", xor), ("cat", cat))}
    log(f"faults {label} profile: device busy {busy:.2f} ms; checksum XOR fold "
        f"{rows['xor'][0]} launches, {rows['xor'][1]:.2f} ms; concatenation "
        f"{rows['cat'][0]} launches, {rows['cat'][1]:.2f} ms")
    return busy, rows


def run_faults(device, gen):
    """The degradation layer on the port's main paths, with their real
    kernels: the 646 MB x 8 allreduce (ring/2) clean under
    ``verify_streams``, an injected overflow, a NaN and wire bitflips
    under ``fallback``, and ``raise``; the 646 MB x 8 scatter with NaN on
    the root and on a non-root; the gradient sync of one minitron-8b
    layer with every bucket overflowing under ``fallback``.  Values are
    checked by bits against the lossless rank-order sum, flags and health
    counters by the event, launches against the schedule; then the clean
    allreduce is timed with and without ``verify_streams`` and the
    fallback beside the compressed call."""
    import numpy as np
    import torch

    from repro_torch.core import buckets, comm as comm_mod, faults, grad_sync, transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator

    n, n_elems = 8, MAIN_BYTES // 4
    group = transport.ThreadGroup(n, device)
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]

    def communicator(**kw):
        return GZCommunicator("x", config=GZConfig(**kw), axis_size=n, device=device)

    flag = communicator()
    plan = flag.plan("allreduce", (n_elems,))
    if (plan.algo, plan.pipeline_chunks) != ("ring", 2):
        raise AssertionError(f"646 MB plan is {plan.algo}/{plan.pipeline_chunks}")
    comm_mod.clear_health_stats()
    comm_mod.enable_health_tracking(True)
    try:
        clean, _ = _fault_case(group, flag, "allreduce", xs, None, plan, "clean, flag",
                               (False, False), None)
        verify = communicator(verify_streams=True)
        _fault_case(group, verify, "allreduce", xs, None, plan, "clean, verify_streams",
                    (False, False), [r.value for r in clean])
        fallback = communicator(on_overflow="fallback")
        spec = faults.FaultSpec("overflow", ranks=(3,))
        noise = torch.from_numpy(faults._overflow_noise((n_elems,), spec)).to(device)
        _fault_case(group, fallback, "allreduce", xs, spec, plan, "overflow on rank 3",
                    (True, False), [_fold(xs[:3] + [noise] + xs[4:])] * n)
        del noise
        spec = faults.FaultSpec("nan", ranks=(5,), n=FAULTS_SCATTER_NAN)
        x5 = xs[5].clone()
        x5[torch.from_numpy(faults._poison_positions(n_elems, spec)).to(device)] = 0.0
        res, _ = _fault_case(group, fallback, "allreduce", xs, spec, plan,
                             "NaN on rank 5", None, [_fold(xs[:5] + [x5] + xs[6:])] * n)
        if not _flags(res)[1]:
            raise AssertionError("NaN on rank 5: the non-finite flag is not set")
        del x5, res
        spec = faults.FaultSpec("bitflip", ranks=(1,), rounds=(1,))
        res, _ = _fault_case(group, flag, "allreduce", xs, spec, plan,
                             "bitflip round 1, unguarded", (False, False), None)
        log(f"faults bitflip round 1, unguarded: {_bitwise_mismatches(res, clean)} elements "
            "differ from the clean run, silently")
        # 64 flips: some land inside the valid stream and corrupt values
        res, _ = _fault_case(group, flag, "allreduce", xs,
                             faults.FaultSpec("bitflip", ranks=(1,), rounds=(1,), n=64), plan,
                             "64 bitflips round 1, unguarded", (False, False), None)
        silent = _bitwise_mismatches(res, clean)
        log(f"faults 64 bitflips round 1, unguarded: {silent} elements differ from the clean "
            "run, no flag")
        if not silent:
            raise AssertionError("64 bitflips corrupted nothing: the hook misses the streams")
        del res
        guarded = communicator(on_overflow="fallback", verify_streams=True)
        _fault_case(group, guarded, "allreduce", xs, spec, plan,
                    "bitflip round 1, verify_streams + fallback", (True, False),
                    [_fold(xs)] * n)
        _fault_case(group, guarded, "allreduce", xs,
                    faults.FaultSpec("bitflip", ranks=(1,), rounds=(10_000,)), plan,
                    "bitflip round 10000, verify_streams + fallback", (False, False),
                    [r.value for r in clean])
        starved = dict(capacity_factor=0.02)  # a forced overflow, no injection
        raising = communicator(on_overflow="raise", **starved)
        messages = group.run(lambda x: _raise_message(raising, x), xs, axis_name="x")
        want = ("gZ collective degraded (allreduce over 'x'): overflow=True nonfinite=False"
                " — a compressed stream exceeded its provisioned capacity (or failed "
                "verification) or the input held NaN/Inf.  Use on_overflow='fallback' for "
                "in-trace lossless recovery, or 'flag' to only report.")
        if messages != [want] * n:
            raise AssertionError(f"raise policy: {messages[0]!r} on some rank, want {want!r}")
        _health("allreduce", (True, False, False), "raise on a forced overflow")
        _fault_case(group, communicator(on_overflow="raise"), "allreduce", xs, None, plan,
                    "clean, raise", (False, False), [r.value for r in clean])
        log(f"faults raise policy: every rank raised the reference's message: {want[:60]}...")
        del clean

        # Timing: the clean call with and without verify_streams, in turns,
        # and the fallback of a forced overflow beside its compressed call,
        # with the health counters (a host sync a call) off.
        comm_mod.enable_health_tracking(False)
        starved_flag = communicator(**starved)
        starved_fb = communicator(on_overflow="fallback", **starved)
        walls = {}
        for name, c in (("flag", flag), ("verify", verify), ("verify", verify),
                        ("flag", flag), ("flag", flag), ("verify", verify),
                        ("starved flag", starved_flag), ("starved fallback", starved_fb),
                        ("starved fallback", starved_fb), ("starved flag", starved_flag)):
            walls.setdefault(name, []).append(_run(group, c, "allreduce", xs)[2])
        for name, w in walls.items():
            log(f"faults timing 646 MB x 8 allreduce, {name}: warm walls "
                + ", ".join(f"{v * 1e3:.1f}" for v in w) + f" ms; min {min(w) * 1e3:.1f} ms")
        busy_flag, _ = _checksum_profile(group, flag, xs, "clean, flag")
        busy_verify, rows = _checksum_profile(group, verify, xs, "clean, verify_streams")
        comm_mod.enable_health_tracking(True)
        log(f"faults verify_streams overhead at 646 MB x 8: warm wall "
            f"{min(walls['verify']) * 1e3:.1f} vs {min(walls['flag']) * 1e3:.1f} ms "
            f"(+{(min(walls['verify']) / min(walls['flag']) - 1) * 100:.1f} %); device busy "
            f"{busy_verify:.2f} vs {busy_flag:.2f} ms; checksum kernels "
            f"{rows['xor'][0] + rows['cat'][0]} launches, "
            f"{rows['xor'][1] + rows['cat'][1]:.2f} ms; fallback wall "
            f"{min(walls['starved fallback']) * 1e3:.1f} ms beside the compressed call's "
            f"{min(walls['starved flag']) * 1e3:.1f} ms")
        del xs
        torch.cuda.empty_cache()

        # The scatter: NaN on the root recovers the sanitized lossless
        # scatter; NaN on a non-root does not trip the guard.
        x_full = _random_walk(n_elems // n * n, gen, device)
        chunk = x_full.shape[0] // n
        junk = torch.full_like(x_full, float("nan"))
        sx = [x_full] + [junk] * (n - 1)
        sc = communicator(on_overflow="fallback")
        splan = sc.plan("scatter", x_full.shape)
        clean, _ = _fault_case(group, communicator(), "scatter", sx, None, splan,
                               "scatter clean, flag", (False, False), None)
        _fault_case(group, sc, "scatter", sx, faults.FaultSpec("nan", ranks=(3,), n=8), splan,
                    "scatter NaN on rank 3 (non-root)", (False, False),
                    [r.value for r in clean])
        spec = faults.FaultSpec("nan", ranks=(0,), n=FAULTS_SCATTER_NAN)
        root = x_full.clone()
        root[torch.from_numpy(faults._poison_positions(root.numel(), spec)).to(device)] = 0.0
        res, _ = _fault_case(group, sc, "scatter", sx, spec, splan, "scatter NaN on the root",
                             None, [root[r * chunk:(r + 1) * chunk] for r in range(n)])
        if not _flags(res)[1]:
            raise AssertionError("scatter NaN on the root: the non-finite flag is not set")
        del x_full, junk, sx, clean, root, res
        torch.cuda.empty_cache()

        # The gradient sync: every bucket overflows and falls back.
        trees = _layer_grads(n, gen, device)
        sync = grad_sync.SyncConfig(
            gz=GZConfig(eb=1e-9, algo="redoub", worst_case_budget=False,
                        codec="lorenzo+entropy", capacity_factor=0.05,
                        on_overflow="fallback"),
            relative_eb=False, bucket_bytes=FALLBACK_BUCKET_BYTES)
        res, launches, wall = _sync_once(group, trees, sync, device)
        leaves = [_flat_leaves(t) for t in trees]
        ledger = buckets.ledger_for([a.shape for a in leaves[0]], sync.bucket_bytes)
        gplan = GZCommunicator("x", config=sync.gz, axis_size=n, device=device,
                               auto_depth=True).plan("allreduce", (ledger.bucket_elems,))
        expected = {k: v * ledger.n_buckets for k, v in _expected_launches(gplan, n).items()}
        if launches != expected:
            raise AssertionError(f"grad sync fallback: launches {launches} != {expected}")
        mism = 0
        outs = [_flat_leaves(out) for out, _ in res]
        for i in range(len(leaves[0])):
            want = _fold([lv[i] for lv in leaves])
            mism += sum(int((o[i].view(torch.int32) != want.view(torch.int32)).sum())
                        for o in outs)
        stats = {(bool(st.overflow), bool(st.nonfinite)) for _, st in res}
        health = comm_mod.health_stats()
        comm_mod.clear_health_stats()
        want_health = {("allreduce", "'x'"): {"calls": ledger.n_buckets,
                                              "overflow": ledger.n_buckets, "nonfinite": 0,
                                              "fallbacks": ledger.n_buckets}}
        log(f"faults grad sync minitron-8b layer N={n}, lorenzo+entropy at eb 1e-9, capacity "
            f"0.05, fallback: {ledger.n_buckets} buckets, wall {wall * 1e3:.1f} ms, "
            f"mismatches vs the lossless sum {mism}, stats {stats}, health {health}, "
            f"launches={_nonzero(launches)}")
        if mism or stats != {(True, False)} or health != want_health:
            raise AssertionError("grad sync fallback: values, flags or health counters wrong")
        del trees, res, outs, leaves
        torch.cuda.empty_cache()
    finally:
        comm_mod.enable_health_tracking(False)
        comm_mod.clear_health_stats()


def _raise_message(comm, x):
    """A rank's ``allreduce`` under the ``raise`` policy: the message it
    raised, or None."""
    try:
        comm.allreduce(x)
    except RuntimeError as e:
        return str(e)
    return None


# ---------------------------------------------------------------------------
# Phase hier: the integer ring and the two-level node x local allreduce
# ---------------------------------------------------------------------------

HIER_AXES = ("node", "local")
# Device-event groups of the intring call's profile: kernel 5 and the
# torch ops around it (bitpack's pack and unpack, the final prefix sum).
INTRING_ROWS = (("kernel 5 (quantize_front_kernel)", r"quantize_front_kernel"),
                ("pack scatter-add (index_add_)", r"index_add|indexFunc"),
                ("unpack gathers (indexing)", r"index_elementwise|gather|index_kernel"),
                ("prefix sum (cumsum)", r"scan|cumsum"),
                ("reductions (amax)", r"reduce_kernel"),
                ("copies and fills", r"copy|fill|Memcpy|Memset|CatArray"),
                ("elementwise (shifts, xor, casts, adds)", r""))


def _mesh_call(m, fn, xs):
    """One call of ``fn`` on every rank of mesh ``m``, launch counts from
    0.  Returns (results, launches, wall seconds)."""
    import torch

    torch.cuda.synchronize()
    _reset_launches()
    t0 = time.perf_counter()
    res = m.run(fn, xs)
    torch.cuda.synchronize()
    return res, _launches(), time.perf_counter() - t0


def _mesh_profile(m, fn, xs, label, check=None):
    """Warm wall of ``fn`` on mesh ``m`` (the second of two calls), then
    one call under torch.profiler: device busy and the top device rows.
    ``check(events, launches)`` holds the trace's launch structure; a
    trace that falls short of it (``ProfileShortfall``: the profiler lost
    device events) is taken again, at most three times.  Returns (warm
    wall seconds, device busy ms, device events)."""
    from torch.profiler import ProfilerActivity, profile

    _mesh_call(m, fn, xs)
    _, _, warm = _mesh_call(m, fn, xs)
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            res, launches, traced = _mesh_call(m, fn, xs)
        del res
        events = _device_events(prof)
        try:
            if check is not None:
                check(events, launches)
            break
        except ProfileShortfall as e:
            log(f"{label}: {e}; taking the trace again")
    else:
        raise AssertionError(f"{label}: three traces fell short of the wrappers' counts")
    busy = sum(e.self_device_time_total for e in events) / 1e3
    log(f"{label} profile: warm wall {warm * 1e3:.1f} ms; traced wall {traced * 1e3:.1f} ms, "
        f"device busy {busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %)")
    for e in sorted(events, key=lambda e: -e.self_device_time_total)[:8]:
        log(f"  {e.count:>6} x {e.self_device_time_total / 1e3:8.2f} ms  {e.key[:120]}")
    return warm, busy, events


def _check_intring_launch_structure(events, launches):
    """Every ``quantize`` call is one ``quantize_front_kernel`` launch and
    the intring call launches no other kernel of the port."""
    rows = _kernel_launches(events, LORENZO_SYMBOLS + "|" + ENTROPY_SYMBOLS)
    _check_hop_launch_structure(rows, launches, "intring", dropped=0.05)


def _intring_rows(events):
    """Device ms and launches of the intring call by ``INTRING_ROWS`` group."""
    out = {name: [0, 0.0] for name, _ in INTRING_ROWS}
    for e in events:
        for name, pattern in INTRING_ROWS:
            if re.search(pattern, e.key):
                out[name][0] += e.count
                out[name][1] += e.self_device_time_total / 1e3
                break
    return out


def _sum_exact(xs):
    exact = None
    for x in xs:
        exact = x.double() if exact is None else exact.add_(x.double())
    return exact


def _within(label, res, exact, bound):
    """Every rank's value within ``bound`` of ``exact``, no flag set.
    Returns the largest error."""
    err = max((r.value.double() - exact).abs().max().item() for r in res)
    if not err <= bound:
        raise AssertionError(f"{label}: error {err} exceeds the bound {bound}")
    if any(bool(r.overflow) or bool(r.nonfinite) for r in res):
        raise AssertionError(f"{label}: overflow or non-finite flag set")
    return err


def _hier_launches(hplan):
    """The hier call's kernel launches over all ranks: the inter plan's
    schedule over ``n_nodes`` ranks, once per local index (the intra
    stages are exact torch folds and copies)."""
    n_nodes, L = hplan.topology
    return {k: v * L for k, v in _expected_launches(hplan.inter, n_nodes).items()}


def run_hier(device):
    """The integer ring and the two-level allreduce, through the port's
    entry points on the card: ``GZCommunicator(algo="intring")`` at 646 MB
    x 8 (every rank the same bits, within N 1.05 eb, kernel 5 once a
    rank; profiled, host floor) and at 16 MB x 8 (bitwise the port's CPU
    run; ``policy="accuracy"``); ``GZHierCommunicator`` on a 2x4
    ``make_hier_mesh`` at 646 MB (hierarchical at ``A100_SLINGSHOT``,
    beside the flat 8-rank composite call), 4x2 at 16 MB, 2x4 at 16 MB on
    a flat fabric (bitwise the 8-rank ``GZCommunicator``), the hier
    fallback of a forced overflow at 646 MB; the gradient sync of one
    minitron-8b layer over ``("local", "node")`` 2x4.  Returns kernel 5's
    launches in the 646 MB intring call."""
    import torch

    from repro_torch.core import buckets, cost_model, error_budget, grad_sync, transport
    from repro_torch.core.collectives import GZConfig
    from repro_torch.core.comm import GZCommunicator, GZHierCommunicator
    from repro_torch.launch.mesh import ThreadMesh, make_hier_mesh

    n, n_elems = 8, MAIN_BYTES // 4
    gen = torch.Generator(device=device).manual_seed(SEED + 24)
    xs = [_random_walk(n_elems, gen, device) for _ in range(n)]
    exact = _sum_exact(xs)
    top = exact.abs().max().item()
    ring = ThreadMesh((n,), ("x",), device)

    # intring at 646 MB x 8
    intring = GZCommunicator("x", config=GZConfig(algo="intring"), axis_size=n, device=device)
    plan = intring.plan("allreduce", (n_elems,))
    torch.cuda.reset_peak_memory_stats()
    res, launches, cold = _mesh_call(ring, intring.allreduce, xs)
    peak = torch.cuda.max_memory_allocated() / 1e9
    _check_launches(plan, n, launches)
    if _nonzero(launches) != {"quantize": n}:
        raise AssertionError(f"intring launched {_nonzero(launches)}, expected quantize x {n}")
    spread = sum(int((r.value.view(torch.int32) != res[0].value.view(torch.int32)).sum())
                 for r in res)
    bound = n * 1.05 * EB + 1e-6 * top
    err = _within("intring 646 MB", res, exact, bound)
    log(f"intring N={n} {MAIN_BYTES / 1e6:.0f} MB/rank: plan {plan.algo} wire_bytes "
        f"{plan.wire_bytes} ratio {plan.ratio:.4f} capacity {plan.capacity_words} words; "
        f"cold wall {cold * 1e3:.1f} ms; err {err:.3e} (bound N 1.05 eb + 1e-6 max = "
        f"{bound:.3e}); ranks differing from rank 0 in {spread} elements; launches "
        f"{_nonzero(launches)}; peak memory {peak:.1f} GB")
    if spread:
        raise AssertionError(f"intring ranks differ in {spread} elements")
    del res
    k5_launches = launches["quantize"]
    warm, busy, events = _mesh_profile(ring, intring.allreduce, xs, "intring 646 MB",
                                       _check_intring_launch_structure)
    rows = _intring_rows(events)
    log("intring device time by group: " + "; ".join(
        f"{name} {c} launches {ms:.2f} ms ({100 * ms / max(busy, 1e-9):.1f} %)"
        for name, (c, ms) in rows.items()))
    small = GZCommunicator("x", config=plan.as_config(), axis_size=n, device=device)
    tiny = [x[: 1 << 16].clone() for x in xs]
    walls = [_mesh_call(ring, small.allreduce, tiny)[2] for _ in range(3)]
    log(f"intring host floor: 256 KB/rank, N={n}: warm wall {min(walls[1:]) * 1e3:.1f} ms "
        f"against {warm * 1e3:.1f} ms at 646 MB")
    del tiny

    # intring at 16 MB x 8: the card against the port's CPU run; the accuracy policy
    m_elems = MOVER_BYTES // 4
    xs16 = [_random_walk(m_elems, gen, device) for _ in range(n)]
    exact16 = _sum_exact(xs16)
    card, _, _ = _mesh_call(ring, intring.allreduce, xs16)
    cpu_comm = GZCommunicator("x", config=GZConfig(algo="intring"), axis_size=n, device="cpu")
    t0 = time.perf_counter()
    cpu = ThreadMesh((n,), ("x",), "cpu").run(cpu_comm.allreduce, [x.cpu() for x in xs16])
    cpu_s = time.perf_counter() - t0
    mism = sum(int((a.value.cpu().view(torch.int32) != b.value.view(torch.int32)).sum())
               for a, b in zip(card, cpu))
    log(f"intring 16 MB x {n}: card vs the port's CPU run ({cpu_s:.1f} s on the host): "
        f"mismatches {mism}")
    if mism or any(bool(r.overflow) for r in cpu):
        raise AssertionError(f"intring 16 MB: the card differs from the CPU run in {mism}")
    accuracy = GZCommunicator("x", config=GZConfig(), policy="accuracy", axis_size=n,
                              device=device)
    p_acc = accuracy.plan("allreduce", (m_elems,))
    acc, launches, wall = _mesh_call(ring, accuracy.allreduce, xs16)
    err = _within("accuracy policy", acc, exact16, n * 1.05 * EB + 1e-6 *
                  exact16.abs().max().item())
    mism = _bitwise_mismatches(acc, card)
    log(f"policy='accuracy' 16 MB x {n}: resolved {p_acc.algo}, wall {wall * 1e3:.1f} ms, "
        f"err {err:.3e}, vs the intring run mismatches {mism}, launches {_nonzero(launches)}")
    if p_acc.algo != "intring" or mism or _nonzero(launches) != {"quantize": n}:
        raise AssertionError(f"accuracy policy: {p_acc.algo}, {mism} mismatches")
    del card, cpu, acc

    # hier 2x4 at 646 MB on the port's default point, beside the flat composite call
    m24 = make_hier_mesh(2, 4, device=device)
    hier = GZHierCommunicator("node", "local", config=GZConfig(),
                              hw=cost_model.A100_SLINGSHOT, topology=(2, 4), device=device)
    hplan = hier.plan((n_elems,))
    if hplan.flat:
        raise AssertionError("hier 2x4 at A100_SLINGSHOT resolved flat")
    inter = hplan.inter
    res, launches, cold = _mesh_call(m24, hier.allreduce, xs)
    err = _within("hier 2x4 646 MB", res, exact, EB * 1.05 + 1e-6 * top)
    if launches != _hier_launches(hplan):
        raise AssertionError(f"hier launches {launches} != the inter plan's "
                             f"{_hier_launches(hplan)}")
    if {r.wire_bytes for r in res} != {hplan.inter_wire_bytes}:
        raise AssertionError("hier wire bytes are not the inter plan's")
    log(f"hier 2x4 {MAIN_BYTES / 1e6:.0f} MB/rank at {hier.hw.name}: flat={hplan.flat}; "
        f"inter plan {inter.algo}/{inter.pipeline_chunks} codec {inter.codec} over "
        f"{inter.axis_size} nodes at {inter.n_elems} f32 (eb_stage {inter.eb_stage:.3e}); "
        f"inter_wire_bytes {hplan.inter_wire_bytes} (flat plan {hplan.flat_plan.algo}/"
        f"{hplan.flat_plan.pipeline_chunks}: {hplan.flat_plan.wire_bytes}), intra "
        f"{hplan.intra_wire_bytes}; modeled {hplan.t_model * 1e3:.3f} ms vs flat "
        f"{hplan.t_flat * 1e3:.3f} ms; cold wall {cold * 1e3:.1f} ms; err {err:.3e}; "
        f"launches {_nonzero(launches)} ({_nonzero(_expected_launches(inter, 2))} per node "
        "pair)")
    del res
    h_warm, h_busy, _ = _mesh_profile(m24, hier.allreduce, xs, "hier 2x4 646 MB")
    flat = GZCommunicator(HIER_AXES, config=GZConfig(), axis_size=n, device=device)
    fplan = flat.plan("allreduce", (n_elems,))
    if (fplan.algo, fplan.pipeline_chunks, fplan.wire_bytes) != (
            hplan.flat_plan.algo, hplan.flat_plan.pipeline_chunks, hplan.flat_plan.wire_bytes):
        raise AssertionError(f"flat composite plan {fplan} is not the HierPlan's flat plan")
    res, launches, _ = _mesh_call(m24, flat.allreduce, xs)
    _within("flat composite 646 MB", res, exact, EB * 1.05 + 1e-6 * top)
    _check_launches(fplan, n, launches)
    del res
    f_warm, f_busy, _ = _mesh_profile(m24, flat.allreduce, xs, "flat composite 646 MB")
    log(f"hier vs flat at 646 MB x 8 on one card: warm wall {h_warm * 1e3:.1f} vs "
        f"{f_warm * 1e3:.1f} ms, device busy {h_busy:.1f} vs {f_busy:.1f} ms; inter-node "
        f"wire {hplan.inter_wire_bytes} vs {fplan.wire_bytes} bytes a rank "
        f"({fplan.wire_bytes / hplan.inter_wire_bytes:.2f}x less); one card has no "
        "inter-node link, so the walls do not show the link asymmetry")

    # the hier fallback of a forced overflow at 646 MB
    hfb = GZHierCommunicator("node", "local",
                             config=GZConfig(capacity_factor=0.02, on_overflow="fallback"),
                             hw=cost_model.A100_SLINGSHOT, topology=(2, 4), device=device)
    fbplan = hfb.plan((n_elems,))
    res, launches, wall = _mesh_call(m24, hfb.allreduce, xs)
    flags = {(bool(r.overflow), bool(r.nonfinite)) for r in res}
    want = _fold(xs)
    mism = sum(int((r.value.view(torch.int32) != want.view(torch.int32)).sum()) for r in res)
    log(f"hier fallback 2x4 {MAIN_BYTES / 1e6:.0f} MB, capacity_factor 0.02: flat="
        f"{fbplan.flat}; flags {flags}; vs the composite rank-order sum mismatches {mism}; "
        f"wall {wall * 1e3:.1f} ms (hier call {h_warm * 1e3:.1f} ms warm); launches "
        f"{_nonzero(launches)}")
    if fbplan.flat or flags != {(True, False)} or mism or launches != _hier_launches(fbplan):
        raise AssertionError("hier fallback: not flagged everywhere, not the exact sum, or "
                             "not the compressed pass's launches")
    del res, want, xs, exact

    # 4x2 at 16 MB; 2x4 at 16 MB on a flat fabric
    top16 = exact16.abs().max().item()
    h42 = GZHierCommunicator("node", "local", config=GZConfig(),
                             hw=cost_model.A100_SLINGSHOT, topology=(4, 2), device=device)
    p42 = h42.plan((m_elems,))
    res, launches, wall = _mesh_call(make_hier_mesh(4, 2, device=device), h42.allreduce, xs16)
    err = _within("hier 4x2 16 MB", res, exact16, EB * 1.05 + 1e-6 * top16)
    log(f"hier 4x2 16 MB/rank: flat={p42.flat} inter {p42.inter.algo}/"
        f"{p42.inter.pipeline_chunks} over {p42.inter.axis_size} nodes; wall "
        f"{wall * 1e3:.1f} ms; err {err:.3e}; launches {_nonzero(launches)}")
    if p42.flat or launches != _hier_launches(p42):
        raise AssertionError("hier 4x2: flat, or launches not the inter plan's")
    htpu = GZHierCommunicator("node", "local", config=GZConfig(), hw=cost_model.TPU_V5E,
                              topology=(2, 4), device=device)
    ptpu = htpu.plan((m_elems,))
    res, _, _ = _mesh_call(m24, htpu.allreduce, xs16)
    plain = GZCommunicator("x", config=GZConfig(), hw=cost_model.TPU_V5E, axis_size=n,
                           device=device)
    ref, _, _ = _mesh_call(ring, plain.allreduce, xs16)
    mism = _bitwise_mismatches(res, ref)
    log(f"hier 2x4 16 MB/rank at {htpu.hw.name} (no link asymmetry): flat={ptpu.flat} "
        f"({ptpu.flat_plan.algo}); vs the 8-rank GZCommunicator mismatches {mism}")
    if not ptpu.flat or mism:
        raise AssertionError("flat-fabric hier: not flat, or differs from the 8-rank call")
    del res, ref, xs16, exact16

    # the gradient sync of one minitron-8b layer over ("local", "node") 2x4
    trees = _layer_grads(n, gen, device)
    sync = _sync_for("lorenzo")
    names = ("local", "node")

    def body(t):
        return grad_sync.dp_allreduce_grads_stats(t, names, sync, device=device)

    res, launches, cold = _mesh_call(m24, body, trees)
    leaves = [grad_sync.tree_flatten(t)[0] for t in trees]
    ledger = buckets.ledger_for([a.shape for a in leaves[0]], sync.bucket_bytes)
    gplan = m24.run(lambda _: grad_sync._hier_comm(names, sync, device).plan(
        (ledger.bucket_elems,)), [None] * n)[0]
    scale = m24.run(lambda t: grad_sync._tree_scale(
        [a.reshape(-1) for a in grad_sync.tree_flatten(t)[0]],
        transport.current(names)), trees)[0].item()
    if gplan.flat:
        raise AssertionError("grad sync 2x4: the bucket plan resolved flat")
    hops = error_budget.lossy_hops(f"allreduce_{gplan.inter.algo}", gplan.inter.axis_size)
    worst = 0.0
    outs = [grad_sync.tree_flatten(out)[0] for out, _ in res]
    for i in range(len(leaves[0])):
        ex = _sum_exact([lv[i] for lv in leaves])
        bound = hops * gplan.inter.eb_stage * scale + 1e-6 * ex.abs().max().item()
        for r in range(n):
            e = (outs[r][i].double() - ex).abs().max().item()
            if not e <= bound:
                raise AssertionError(f"grad sync 2x4: leaf {i} rank {r} error {e} > {bound}")
            worst = max(worst, e / bound)
        del ex
    stats = [st for _, st in res]
    want_launches = {k: v * ledger.n_buckets for k, v in _hier_launches(gplan).items()}
    log(f"grad sync minitron-8b layer over {names} 2x4 (codec lorenzo): {ledger.n_buckets} "
        f"buckets of {ledger.bucket_elems}; bucket plan flat={gplan.flat}, inter "
        f"{gplan.inter.algo}/{gplan.inter.pipeline_chunks} over {gplan.inter.axis_size} "
        f"nodes; scale {scale:.6e}; wire_bytes/rank {stats[0].wire_bytes} (inter plan "
        f"{gplan.inter_wire_bytes} x {ledger.n_buckets}); cold wall {cold * 1e3:.1f} ms; "
        f"worst error {100 * worst:.1f} % of its bound; launches {_nonzero(launches)}")
    if any(bool(st.overflow) or bool(st.nonfinite) for st in stats) or \
            {(st.n_buckets, st.wire_bytes) for st in stats} != \
            {(ledger.n_buckets, gplan.inter_wire_bytes * ledger.n_buckets)} or \
            launches != want_launches:
        raise AssertionError(f"grad sync 2x4: flags, buckets, wire bytes or launches "
                             f"{launches} != {want_launches}")
    del res, outs, leaves
    _mesh_profile(m24, body, trees, "grad sync 2x4")
    del trees
    torch.cuda.empty_cache()
    return k5_launches


# ---------------------------------------------------------------------------
# Phases 15-18: the dense model's forward and serving path, kernel 11
# ---------------------------------------------------------------------------

MODEL_ARCH = "minitron-8b"  # src/repro/configs/minitron_8b.py, full width and depth
MODEL_SMOKE = False
MODEL_PARAMS = 9_882_046_464
MODEL_BATCH, MODEL_SEQ = 2, 2048
PREFILL_SEQ = 128
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # tests/test_flash_kernel.py
SERVE_ARGV = ["--arch", "minitron-8b", "--batch", "4", "--prompt-len", "16", "--gen",
              "32", "--cache-len", "128"]


def check_flash_sass():
    """Kernel 11's bf16 kernel runs on Hopper's tensor cores and TMA: count
    the ``HGMMA`` (wgmma) and ``UTMALDG`` (TMA load) instructions in the
    SASS of its functions (``cuobjdump -sass`` of the built library) and
    fail if either is 0."""
    import re

    from repro_torch.kernels import build

    cuobjdump = pathlib.Path(build.nvcc_path()).parent / "cuobjdump"
    lib = build.build("flash_attn_sm90")["path"]
    sass = subprocess.run([str(cuobjdump), "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    counts = {"HGMMA": 0, "UTMALDG": 0}
    funcs = 0
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        if FLASH_BF16_KERNEL not in part.split("\n", 1)[0]:
            continue
        funcs += 1
        for op in counts:
            counts[op] += len(re.findall(rf"\b{op}\b", part))
    log(f"flash_attn_sm90 SASS: {funcs} {FLASH_BF16_KERNEL} functions, "
        f"{counts['HGMMA']} HGMMA, {counts['UTMALDG']} UTMALDG")
    if not funcs or not all(counts.values()):
        raise AssertionError(f"kernel 11's bf16 kernel lacks wgmma or TMA in SASS: {counts}")


def check_flash_kernel(device, gen):
    """Phase 13: kernel 11 against its plain version on the card, at every
    head dim, both dtypes (bf16 on the tensor-core route, f32 on the
    CUDA-core route, counted), causal, causal with windows 64, 100, 128 and
    1000, non-causal with Sq != Sk, ragged lengths, rows that see no key,
    the bf16 edges that only TMA can get wrong (Sq, Sk in {1, 127, 129,
    2049} at D = 64 and 128, H = 1 through ``flash_attention_bhsd``), and
    the main path's shape (B=2, S=2048, H=32, D=128, bf16, causal), timed
    there beside the plain version, SDPA and the bound; then larger shapes
    checked and timed beside SDPA."""
    import torch

    from repro_torch.kernels import flash_attn

    f32, bf16 = torch.float32, torch.bfloat16
    cases = [  # (label, b, sq, sk, h, d, dtype, causal, window, timed)
        *[("causal", 2, 300, 300, 2, d, dt, True, 0, False)
          for d in (32, 64, 128) for dt in (f32, bf16)],
        *[("window", 1, 700, 700, 2, d, dt, True, w, False)
          for w in (64, 100, 128, 1000) for d, dt in ((64, f32), (128, bf16), (64, bf16))],
        ("non-causal", 2, 100, 300, 2, 64, f32, False, 0, False),
        ("non-causal", 2, 100, 300, 2, 128, bf16, False, 0, False),
        ("non-causal", 1, 2049, 129, 2, 64, bf16, False, 0, False),
        ("ragged", 3, 1000, 1000, 4, 32, bf16, True, 0, False),
        ("ragged", 1, 77, 77, 3, 64, f32, True, 0, False),
        ("no-key rows", 1, 300, 100, 2, 32, f32, True, 64, False),
        ("no-key rows", 1, 300, 100, 2, 128, bf16, True, 64, False),
        *[("TMA edges", 1, sq, sk, 2, d, bf16, True, 0, False)
          for d in (64, 128) for sq in (1, 127, 129, 2049) for sk in (1, 127, 129, 2049)],
        *[("H=1 bhsd", 6, 300, 300, 1, d, bf16, True, 0, False) for d in (32, 64, 128)],
        ("H=1 bhsd", 4, 129, 2049, 1, 128, bf16, False, 0, False),
        ("main", MODEL_BATCH, MODEL_SEQ, MODEL_SEQ, 32, 128, bf16, True, 0, True),
    ]
    record = None
    flash_attn.reset_launch_counts()
    calls = {"tensor_core_bf16": 0, "cuda_core_f32": 0}
    for label, b, sq, sk, h, d, dt, causal, window, timed in cases:
        q, k, v = (torch.randn((b, s, h, d), generator=gen, device=device).to(dt)
                   for s in (sq, sk, sk))
        if label == "H=1 bhsd":  # the reference's (BH, S, D) call, H = 1 in the maps
            got = flash_attn.flash_attention_bhsd(q[:, :, 0], k[:, :, 0], v[:, :, 0],
                                                  causal=causal, window=window)[:, :, None]
        else:
            got = flash_attn.flash_attention(q, k, v, causal=causal, window=window)
        calls["tensor_core_bf16" if dt == bf16 else "cuda_core_f32"] += 1
        if flash_attn.ROUTES != calls:
            raise AssertionError(f"kernel 11 routes {flash_attn.ROUTES}, expected {calls}")
        want = flash_attn.flash_attention_plain(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        tol = FLASH_TOL[str(dt).removeprefix("torch.")]
        diff = (got.float() - want.float()).abs()
        err = float(diff.max())
        bad = int((diff > tol + tol * want.float().abs()).sum())
        log(f"flash_attention vs plain [{label} B={b} Sq={sq} Sk={sk} H={h} D={d} "
            f"{str(dt).removeprefix('torch.')} causal={causal} window={window}]: max |err| "
            f"{err:.3e} (atol = rtol = {tol:g}); {bad} of {got.numel()} outside")
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention [{label}] disagrees with its plain version")
        if timed:
            # causal, Sq = Sk: 4*D FLOPs (QK^T and PV) per unmasked (q, k) pair;
            # q, k, v read once and o written once
            flops = 4 * b * h * d * sq * (sq + 1) // 2
            nbytes = 4 * q.numel() * q.element_size()
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib = sdpa(qt, kt, vt, is_causal=True).transpose(1, 2)
            lib_err = float((lib.float() - want.float()).abs().max())
            record = {
                "name": "flash_attention", "route": "cuda", "source": FLASH_SOURCE,
                "replaces": REPLACES["flash_attention"], "launches": None,
                "max_abs_err": err,
                "ms": _median_ms(lambda: flash_attn.flash_attention(q, k, v), 20, 10),
                "plain_ms": _median_ms(lambda: flash_attn.flash_attention_plain(q, k, v), 5),
                "bound_ms": max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3,
                "bound_by": ("operations" if flops / BF16_FLOPS_PER_S
                             >= nbytes / HBM_BYTES_PER_S else "bytes"),
                "library_ms": _median_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 20, 10),
                "shape": [b, sq, h, d], "bytes": nbytes,
            }
            one_call = (_median_ms(lambda: flash_attn.flash_attention(q, k, v), 20),
                        _median_ms(lambda: sdpa(qt, kt, vt, is_causal=True), 20))
            log(f"  flash_attention {record['ms']:.4f} ms  plain {record['plain_ms']:.3f} ms  "
                f"SDPA {record['library_ms']:.4f} ms (10 calls per event pair; one call per "
                f"pair, the host's launch included: kernel {one_call[0]:.4f} ms, SDPA "
                f"{one_call[1]:.4f} ms; max |SDPA - plain| {lib_err:.3e})  "
                f"bound {record['bound_ms']:.4f} ms ({flops / 1e9:.2f} GFLOP at "
                f"{BF16_FLOPS_PER_S / 1e12:g} TFLOP/s; {nbytes / 1e6:.1f} MB at "
                f"{HBM_BYTES_PER_S / 1e12:g} TB/s)")
            del qt, kt, vt, lib
        del q, k, v, got, want, diff
    log(f"kernel 11 routes over phase 15: {calls}")
    # How the bf16 kernel scales against SDPA beyond the model's shape:
    # checked against the plain version, then timed (median of 10).
    sdpa = torch.nn.functional.scaled_dot_product_attention
    for b, s, h, causal in ((8, 2048, 32, True), (2, 8192, 32, True), (2, 4096, 16, False)):
        q, k, v = (torch.randn((b, s, h, 128), generator=gen, device=device).to(bf16)
                   for _ in range(3))
        got = flash_attn.flash_attention(q, k, v, causal=causal)
        want = flash_attn.flash_attention_plain(q, k, v, causal=causal)
        tol = FLASH_TOL["bfloat16"]
        diff = (got.float() - want.float()).abs()
        bad = int((diff > tol + tol * want.float().abs()).sum())
        if bad or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"flash_attention [B={b} S={s}] disagrees with its plain version")
        del got, want, diff
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        flops = 4 * b * h * 128 * (s * (s + 1) // 2 if causal else s * s)
        ms = _median_ms(lambda: flash_attn.flash_attention(q, k, v, causal=causal), 10, 5)
        lib_ms = _median_ms(lambda: sdpa(qt, kt, vt, is_causal=causal), 10, 5)
        log(f"  scaling B={b} S={s} H={h} D=128 causal={causal}: kernel {ms:.4f} ms "
            f"({flops / ms / 1e9:.0f} TFLOP/s), SDPA {lib_ms:.4f} ms "
            f"({flops / lib_ms / 1e9:.0f} TFLOP/s); {bad} outside the bf16 tolerance")
        del q, k, v, qt, kt, vt
    torch.cuda.empty_cache()
    return {"flash_attention": record}


def _forward_logits(model, params, tokens):
    """Full-sequence logits at every position (the prefill reference of
    tests/test_prefill_decode_consistency.py)."""
    import torch

    from repro_torch.models.layers import embed_lookup, rms_norm, vocab_parallel_logits

    h = embed_lookup(tokens, params["embed"], model.ctx)
    h, _ = model._backbone(h, params, positions=torch.arange(h.shape[1], device=h.device))
    h = rms_norm(h, params["final_norm"], model.cfg.norm_eps)
    return vocab_parallel_logits(h, params["unembed"], model.ctx)


def _timed(fn):
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def run_model(device):
    """Phases 16-18, this slice's main path.  16: ``Model.loss_fn`` of
    minitron-8b at full width and depth (32 layers, 19.76 GB of bf16
    weights drawn from seed 0 on the card) on one ``SyntheticStream`` batch
    of B=2, S=2048, with ``use_flash_kernel`` True (kernel 11 launched once
    per layer, counted) and False (the chunked path, no launch): both
    finite, within 2e-3 relative of each other; walls, and the device busy
    share and kernel 11's share of device time from one profiled call.  17:
    the full-sequence logits through kernel 11 at S=128 against 128 steps
    of ``decode_fn``, rel <= 0.05.  18: ``serve`` at full size (batch 4,
    16 + 32 tokens, cache 128).  Returns kernel 11's launches in the loss
    run."""
    import dataclasses
    import io

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import registry
    from repro_torch.data.pipeline import SyntheticStream
    from repro_torch.kernels import flash_attn
    from repro_torch.launch.serve import serve
    from repro_torch.models.attention import KVCacheSpec
    from repro_torch.models.model import Model

    cfg = registry.get(MODEL_ARCH, smoke=MODEL_SMOKE)
    kcfg = dataclasses.replace(cfg, use_flash_kernel=True)
    torch.cuda.reset_peak_memory_stats()
    model, init_s = _timed(lambda: Model(cfg, device=device, seed=SEED))
    n_params = sum(p.numel() for p in model.parameters())
    if n_params != MODEL_PARAMS:
        raise AssertionError(f"{cfg.arch_id}: {n_params} parameters, expected {MODEL_PARAMS}")
    params = model.params()
    kmodel = Model(kcfg, params=params, device=device)  # the same tensors
    log(f"model {cfg.arch_id}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_heads} heads ({cfg.n_kv_heads} kv), head dim {cfg.head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab}; {n_params} parameters "
        f"({sum(p.numel() * p.element_size() for p in model.parameters()) / 1e9:.2f} GB "
        f"bf16) drawn from seed {SEED} in {init_s:.2f} s")
    batch = next(SyntheticStream(cfg, MODEL_BATCH, MODEL_SEQ, seed=SEED))

    with torch.inference_mode():
        # 16: the loss forward, through kernel 11 and through the chunked path
        _reset_launches()
        l1, cold1 = _timed(lambda: kmodel.loss_fn(params, batch))
        launches, routes = _launches(), dict(flash_attn.ROUTES)
        _reset_launches()
        l0, cold0 = _timed(lambda: model.loss_fn(params, batch))
        chunked_launches = _launches()
        l1, l0 = float(l1), float(l0)
        if _nonzero(launches) != {"flash_attention": cfg.n_layers}:
            raise AssertionError(f"loss forward with the kernel launched {_nonzero(launches)},"
                                 f" expected flash_attention x {cfg.n_layers}")
        if routes != {"tensor_core_bf16": cfg.n_layers, "cuda_core_f32": 0}:
            raise AssertionError(f"kernel 11 routes in the loss forward: {routes}, expected "
                                 f"tensor_core_bf16 x {cfg.n_layers}")
        if _nonzero(chunked_launches):
            raise AssertionError(f"chunked loss forward launched {_nonzero(chunked_launches)}")
        if not (math.isfinite(l0) and math.isfinite(l1)):
            raise AssertionError(f"non-finite loss: kernel {l1}, chunked {l0}")
        if abs(l1 - l0) > 2e-3 * max(abs(l0), 1.0):
            raise AssertionError(f"loss with kernel 11 {l1} vs chunked {l0}")
        _, warm1 = _timed(lambda: kmodel.loss_fn(params, batch))
        _, warm0 = _timed(lambda: model.loss_fn(params, batch))
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            _, traced = _timed(lambda: kmodel.loss_fn(params, batch))
        events = _device_events(prof)
        busy = sum(e.self_device_time_total for e in events) / 1e3
        flash_events = [e for e in events if FLASH_BF16_KERNEL in e.key]
        flash_ms = sum(e.self_device_time_total for e in flash_events) / 1e3
        if sum(e.count for e in flash_events) != cfg.n_layers:
            raise AssertionError(f"profile shows {sum(e.count for e in flash_events)} "
                                 f"{FLASH_BF16_KERNEL} launches, expected {cfg.n_layers}")
        log(f"loss forward {cfg.arch_id} B={batch['tokens'].shape[0]} "
            f"S={batch['tokens'].shape[1]}: loss with kernel 11 {l1:.6f}, chunked {l0:.6f} "
            f"(|diff| {abs(l1 - l0):.3e}, bound {2e-3 * max(abs(l0), 1.0):.3e}; "
            f"ln(vocab) {math.log(cfg.vocab):.4f}); launches {_nonzero(launches)}; wall "
            f"kernel path cold {cold1 * 1e3:.1f} ms warm {warm1 * 1e3:.1f} ms, chunked "
            f"path cold {cold0 * 1e3:.1f} ms warm {warm0 * 1e3:.1f} ms; kernel 11 routes "
            f"{routes}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
        log(f"profile (kernel path): traced wall {traced * 1e3:.1f} ms, device busy "
            f"{busy:.1f} ms ({100 * busy / (traced * 1e3):.1f} %); kernel 11 {flash_ms:.1f} ms "
            f"({100 * flash_ms / max(busy, 1e-9):.1f} % of device time, "
            f"{flash_ms / cfg.n_layers:.4f} ms per launch)")
        for e in sorted(events, key=lambda e: -e.self_device_time_total)[:10]:
            log(f"  {e.key[:72]:<72} {e.count:>5} x {e.self_device_time_total / 1e3:8.2f} ms")
        del prof, events, batch
        torch.cuda.empty_cache()

        # 17: decode against prefill
        rng = np.random.default_rng(SEED)
        tokens = torch.from_numpy(
            rng.integers(0, cfg.vocab, (2, PREFILL_SEQ)).astype(np.int32)).to(device)
        _reset_launches()
        want, prefill_s = _timed(lambda: _forward_logits(kmodel, params, tokens))
        if _launches()["flash_attention"] != cfg.n_layers:
            raise AssertionError(f"prefill launched {_nonzero(_launches())}")
        spec = KVCacheSpec(s_total=PREFILL_SEQ, cp_axis=None, cp_size=1)
        cache = {k: torch.zeros(v, dtype=torch.float32, device=device)
                 for k, v in model.cache_defs(2, spec).items()}

        def decode_all():
            c = cache
            out = []
            for i in range(PREFILL_SEQ):
                logits, c = model.decode_fn(params, c, tokens[:, i:i + 1], i, spec)
                out.append(logits[:, 0])
            return torch.stack(out, dim=1)

        got, decode_s = _timed(decode_all)
        rel = float((got - want).abs().max() / want.abs().max())
        log(f"decode vs prefill {cfg.arch_id} B=2 S={PREFILL_SEQ}: max rel err {rel:.4e} "
            f"(bound 0.05); prefill through kernel 11 {prefill_s * 1e3:.1f} ms, "
            f"{PREFILL_SEQ} decode steps {decode_s * 1e3:.1f} ms "
            f"({decode_s * 1e3 / PREFILL_SEQ:.2f} ms/step)")
        if not rel <= 0.05 or not bool(torch.isfinite(got).all()):
            raise AssertionError(f"decode/prefill mismatch: rel {rel}")
        del want, got, cache, model, kmodel, params
        torch.cuda.empty_cache()

    # 18: serving at full size
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        gen, serve_s = _timed(lambda: serve(SERVE_ARGV + (["--smoke"] if MODEL_SMOKE else [])
                                            + ["--device", str(device)]))
    for line in out.getvalue().splitlines():
        log(f"serve: {line}")
    n_batch, n_gen = int(SERVE_ARGV[3]), int(SERVE_ARGV[7])
    if gen.shape != (n_batch, n_gen + 1):
        raise AssertionError(f"serve returned tokens of shape {gen.shape}")
    log(f"serve: {n_batch} x {int(SERVE_ARGV[5]) + n_gen} decode steps; wall with model "
        f"init {serve_s:.2f} s")
    torch.cuda.empty_cache()
    return launches["flash_attention"]


# ---------------------------------------------------------------------------


PHASES = ("kernels", "allreduce", "movers", "codecs", "grad-sync", "faults", "hier", "c6",
          "model")


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
        log(f"built {name}.cu in {rec['seconds']:.1f} s")
        for line in ptxas_lines(rec["ptxas"]):
            log(f"  ptxas {name}.cu {line}")
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    check_flash_sass()
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
        plan, launches, _, fused_run = run_scatter(8, MAIN_BYTES, device, gen, "main",
                                                   profile=True)
        if plan.wire_bytes != SCATTER_WIRE_BYTES:
            raise AssertionError(f"scatter wire bytes {plan.wire_bytes} != "
                                 f"{SCATTER_WIRE_BYTES}")
        _record(records, "quantize")["launches"] = launches["quantize"]
        run_scatter(6, 64_000_000, device, gen, "trimmed")
        run_movers(device, gen)
        two_pass = run_two_pass(device, gen)
        # The paper's gZ-Scatter on the two-pass codec, on the same input.
        plan, launches, _, _ = run_scatter(8, MAIN_BYTES, device, gen, "main", profile=True,
                                           fused=False, fused_run=fused_run)
        if plan.wire_bytes != SCATTER_WIRE_BYTES or \
                (launches["quantize"], launches["dequantize"]) != (1, 8):
            raise AssertionError(f"fused=False scatter: wire bytes {plan.wire_bytes}, "
                                 f"launches {_nonzero(launches)}")
        del fused_run
        torch.cuda.empty_cache()
        _record(records, "dequantize_reduce")["launches"] = \
            two_pass[("redoub", ("fused",))]["dequantize_reduce"]
        _record(records, "dequantize")["launches"] = two_pass[("ring", ("fused",))]["dequantize"]

    if "codecs" in phases:
        run_entropy_allreduce(device, gen)
        plan, *_ = run_scatter(8, MAIN_BYTES, device, gen, "main", codec="lorenzo+entropy")
        if plan.wire_bytes != SCATTER_WIRE_BYTES:
            raise AssertionError(f"entropy scatter wire bytes {plan.wire_bytes}")

    if "grad-sync" in phases:
        # This slice's main path: data-parallel gradient sync.
        main_launches, launches6 = run_grad_sync(device, gen)
        for name in ("entropy_quantize_pack", "entropy_unpack_dequantize_reduce"):
            _record(records, name)["launches"] = main_launches[name]
        _record(records, "entropy_unpack_dequantize")["launches"] = \
            launches6["entropy_unpack_dequantize"]

    if "faults" in phases:
        run_faults(device, gen)

    if "hier" in phases:
        # This slice's paths: intring (kernel 5 once a rank) and the hier allreduce.
        _record(records, "quantize")["launches"] = run_hier(device)
        torch.cuda.empty_cache()

    if "c6" in phases:
        check_a2a_backward_on_threadgroup(device)

    if "model" in phases:
        # This slice's main path: the dense model's forward and serving.
        records.update(check_flash_kernel(device, gen))
        _record(records, "flash_attention")["launches"] = run_model(device)

    log(f"chip_smoke.py: every phase passed in {time.perf_counter() - t0:.1f} s "
        f"(the kernel build included)")
    if phases != set(PHASES):
        log(f"partial run ({sorted(phases)}): every check passed; no result printed")
        return 0
    for r in records.values():
        if not r["launches"]:
            raise AssertionError(f"{r['name']}: not launched on its path")
    print(smi)
    print(json.dumps({"kernels": [
        {k: v for k, v in r.items() if k not in ("shape", "bytes", "one_call_ms", "device_ms")}
        for r in records.values()]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

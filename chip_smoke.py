#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):

1. kernels — build every hand-written kernel from ``src/repro_torch``'s
   sources (one ``nvcc`` per source, all started together), then hold each
   against its plain PyTorch version on the card over the shape sweeps of
   ``tests/test_kernels.py`` in fp32 (tol 1e-4) and bf16 (tol 2e-2), then
   at the shape each slice of phase 3 gives it: K1 (flash-attention
   forward; tinyllama's GQA blocks and zamba2's MHA shared block), K2 (the
   Mamba2 SSD scan) and K3 (the RWKV6 WKV recurrence, one ``u`` per
   client), K2 and K3 also across a sequence cut in two through
   ``initial_state`` and K3 under decay scale 8.  Each case is checked
   elementwise against the plain version on the same inputs, and by its
   relative norm error ||got - want|| / ||want|| against the plain version
   computed in fp32 on the same values (limit 1e-5 for fp32, 5e-3 for
   bf16, about two bf16 roundings), so a kernel wrong by a few percent
   where |out| is small cannot pass.  At each slice's shape each kernel
   and its plain version are timed with CUDA events, K1 also beside one
   PyTorch library call, and the least time the card could take is
   computed from the shapes.
2. path parity — one ``make_fed_step`` on the tinyllama, rwkv6 and zamba2
   smoke configs (fp32) on the card and on the CPU from the same params
   and batches: losses and new params agree within 1e-4, and the path's
   kernels were launched; then the port's ``sim`` with its default flags
   on the card and on the CPU: identical host traces, losses within 1e-4.
3. slices — the ``RoundDriver`` (fedpairing, vmapped engine, paper pairing
   and split, mean aggregation) at full width, bf16 compute with fp32
   params, depth cut, on tinyllama-1.1b, rwkv6-1.6b and zamba2-1.2b in
   turn; each kernel's launch count is read from each slice's run alone.
4. breakdown — after each slice, one more fed step of it under
   ``torch.profiler``: device time by kernel group and the device's idle
   share.

The last two lines are the ``kernels`` JSON summary (one record for each
kernel and slice that runs it, with its launches in that slice) and the
result line.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# published H100 SXM peaks (dense), see PERF.md
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

# tests/test_kernels.py:24-32: (B, S, Hq, Hkv, d, causal, window)
ATTN_SWEEP = [
    (2, 128, 4, 2, 64, True, 0),
    (1, 256, 4, 4, 64, True, 64),
    (2, 128, 8, 2, 128, False, 0),
    (1, 128, 2, 1, 64, True, 0),
    (2, 64, 4, 4, 32, True, 16),
]
# K1's main-path shapes by slice: N=4 clients x batch 2 folded, seq 1024
K1_MAIN = {
    "tinyllama-1.1b": dict(B=8, S=1024, Hq=32, Hkv=4, d=64),    # GQA blocks
    "zamba2-1.2b": dict(B=8, S=1024, Hq=32, Hkv=32, d=64),      # shared block
}
# tests/test_kernels.py:57-63: (B, S, H, P, N, chunk)
SSD_SWEEP = [
    (2, 128, 4, 64, 32, 32),
    (1, 256, 2, 32, 64, 64),
    (2, 64, 8, 64, 16, 16),
    (1, 96, 2, 32, 32, 32),
]
# tests/test_kernels.py:112-118: (B, S, H, N, M, chunk, decay_scale)
WKV_SWEEP = [
    (2, 128, 4, 32, 32, 32, 1.0),
    (1, 256, 2, 64, 64, 64, 1.0),
    (2, 64, 4, 32, 32, 16, 8.0),
    (1, 64, 2, 16, 16, 64, 1.0),
]
# the main path's shapes: N=4 clients x batch 2 folded, seq 1024
SSD_MAIN = dict(B=8, S=1024, H=64, P=64, N=64, chunk=64)     # zamba2-1.2b
# rwkv6-1.6b: u per client, U=4 rows for the 8 folded batch rows
WKV_MAIN = dict(B=8, S=1024, H=32, N=64, M=64, U=4, chunk=16)
SLICE = dict(clients=4, batch=2, seq=1024, rounds=2, batches_per_round=2)
# (arch, depth cut, why, expected launches per fed step by kernel)
SLICES = [
    ("tinyllama-1.1b", 4, "keeps the 4 stacked replicas near 21 GiB",
     {"K1": 4}),
    ("rwkv6-1.6b", 4, "as the tinyllama slice; the 65536-row vocab keeps "
     "the embedding and head at full size", {"K3": 4}),
    ("zamba2-1.2b", 7, "shared_attn_every 6 unchanged, so the shared block "
     "runs twice and its per-invocation out_proj[1] is exercised",
     {"K2": 7, "K1": 2}),
]
SMOKE_PATHS = {"tinyllama-1.1b": ("K1",), "rwkv6-1.6b": ("K3",),
               "zamba2-1.2b": ("K2", "K1")}


def log(msg: str) -> None:
    print(msg, flush=True)


def short_symbol(sym: str) -> str:
    """``_ZN<n><namespace><m><name>I<args>EEv...`` -> ``<name> I<args>``."""
    m = re.match(r"_ZN(\d+)", sym)
    if not m:
        return sym
    rest = sym[m.end() + int(m.group(1)):]
    m = re.match(r"(\d+)", rest)
    if not m:
        return sym
    end = m.end() + int(m.group(1))
    return f"{rest[m.end():end]} {rest[end:].split('EEv')[0]}"


def log_ptxas(name: str, text: str) -> None:
    """One line per compiled kernel: its registers and spills, as
    ``nvcc -Xptxas -v`` reported them."""
    entry = spill = ""
    for line in text.splitlines():
        if "Compiling entry function" in line:
            entry = short_symbol(line.split("'")[1])
        elif "spill stores" in line:
            spill = line.strip()
        elif "Used" in line and "registers" in line:
            regs = line.split("Used", 1)[1].strip()
            log(f"  ptxas {name} {entry}: {regs}; {spill}")


def time_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median of ``reps`` CUDA-event timings of ``fn`` (ms)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(flops: float, nbytes: float):
    """(least ms, what bounds it): the larger of the FLOPs over the bf16
    peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                       else "bytes")


def attention_work(B, S, L, Hq, Hkv, d, causal, window, itemsize):
    """(FLOPs, bytes) attention needs on these inputs: 4*d FLOPs per
    visible (query, key) pair and head (QK^T and PV); q, k, v read once,
    o written once."""
    pairs = 0
    for s in range(S):
        hi = min(s, L - 1) if causal else L - 1
        lo = max(0, s - window + 1) if window else 0
        pairs += max(0, hi - lo + 1)
    flops = 4 * d * B * Hq * pairs
    nbytes = itemsize * (2 * B * S * Hq * d + 2 * B * L * Hkv * d)
    return flops, nbytes


def ssd_work(B, S, H, P, N, itemsize):
    """(FLOPs, bytes) of the SSD scan: 4*P*N FLOPs per step and head (the
    recurrence's state update and output, one multiply-add per state
    element each); x, b, c read once in the compute dtype, log_decay in
    fp32, y written once in the compute dtype, the final state in fp32."""
    flops = 4 * P * N * B * S * H
    nbytes = (itemsize * (2 * B * S * H * P + 2 * B * S * N)
              + 4 * (B * S * H + B * H * P * N))
    return flops, nbytes


def wkv_work(B, S, H, N, M, U, itemsize):
    """(FLOPs, bytes) of WKV6: 4*N*M FLOPs per step and head (state update
    and output, one multiply-add per state element each); r, k, v read
    once in the compute dtype, log_w and u in fp32, out written once in
    the compute dtype, the final state in fp32."""
    flops = 4 * N * M * B * S * H
    nbytes = (itemsize * (2 * B * S * H * N + 2 * B * S * H * M)
              + 4 * (B * S * H * N + U * H * N + B * H * N * M))
    return flops, nbytes


def check_case(torch, kid, label, got, want, want32, state=None):
    """A kernel's output against its plain version on the same inputs
    (``want``), elementwise at the dtype's tolerance, and against the plain
    version computed in fp32 on the same values (``want32``) by relative
    norm error; ``state`` = (got, want, tol) compares the fp32 final
    states.  Returns (max_abs_err, rel_err)."""
    tol, rel_tol = ((1e-4, 1e-5) if got.dtype == torch.float32
                    else (2e-2, 5e-3))
    torch.cuda.synchronize()
    got, want, want32 = got.float(), want.float(), want32.float()
    err = (got - want).abs().max().item()
    rel = ((got - want32).norm() / want32.norm()).item()
    ok = torch.allclose(got, want, rtol=tol, atol=tol) and rel <= rel_tol
    extra = ""
    if state is not None:
        sg, sw, stol = state
        serr = (sg.float() - sw.float()).abs().max().item()
        ok = ok and torch.allclose(sg.float(), sw.float(), rtol=stol,
                                   atol=stol)
        extra = f" state_err={serr:.3e} (tol {stol})"
    log(f"  {kid} {label}: max_abs_err={err:.3e} (tol {tol}) "
        f"rel_err={rel:.3e} (limit {rel_tol}){extra} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{kid} disagrees with its plain version at "
                             f"{label}: max_abs_err {err}, rel_err {rel}")
    return err, rel


def check_k1(torch, fa, ref, q, k, v, causal, window, label):
    got = fa.launch(q, k, v, causal=causal, sliding_window=window)
    want = ref.attention_ref(q, k, v, causal=causal, sliding_window=window)
    want32 = ref.attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, sliding_window=window)
    return check_case(torch, "K1", label, got, want, want32)


def timed_record(torch, kid, path, name, source, replaces, err, rel,
                 kernel_fn, plain_fn, work, shape_note, library_ms=None):
    """Time the kernel and its plain version at the shape that slice
    ``path`` gives it and return the kernel's line of the ``kernels``
    summary for that path."""
    ms = time_ms(kernel_fn)
    plain_ms = time_ms(plain_fn)
    flops, nbytes = work
    bound_ms, bound_by = bound(flops, nbytes)
    log(f"  {kid} {path} main shape {shape_note}: {flops / 1e9:.2f} GFLOP, "
        f"{nbytes / 1e6:.1f} MB")
    log(f"  {kid} {path} ms={ms!r} plain_ms={plain_ms!r} "
        f"library_ms={library_ms!r} bound_ms={bound_ms!r} ({bound_by}); "
        f"kernel at {flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s, "
        f"{nbytes / (ms * 1e-3) / 1e9:.1f} GB/s")
    return {"id": kid, "path": path, "name": name, "route": "cuda",
            "source": source, "shape": shape_note,
            "replaces": replaces, "max_abs_err": err, "rel_err": rel,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "library_ms": library_ms}


def k1_phase(torch, fa, ref):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)

    def qkv(B, S, Hq, Hkv, d, dtype):
        return (torch.randn((B, S, Hq, d), generator=gen, device=dev).to(dtype),
                torch.randn((B, S, Hkv, d), generator=gen, device=dev).to(dtype),
                torch.randn((B, S, Hkv, d), generator=gen, device=dev).to(dtype))

    for dtype in (torch.float32, torch.bfloat16):
        for B, S, Hq, Hkv, d, causal, window in ATTN_SWEEP:
            q, k, v = qkv(B, S, Hq, Hkv, d, dtype)
            check_k1(torch, fa, ref, q, k, v, causal, window,
                     f"{str(dtype)[6:]} B={B} S={S} Hq={Hq} Hkv={Hkv} d={d} "
                     f"causal={causal} window={window}")

    return [k1_main(torch, fa, ref, qkv, path, m)
            for path, m in K1_MAIN.items()]


def k1_main(torch, fa, ref, qkv, path, m):
    """K1 at the shape slice ``path`` gives it: checked, timed beside its
    plain version and the library call, and bounded."""
    q, k, v = qkv(m["B"], m["S"], m["Hq"], m["Hkv"], m["d"], torch.bfloat16)
    err, rel = check_k1(torch, fa, ref, q, k, v, True, 0,
                        f"{path} main-path shape bf16 causal")
    want = ref.attention_ref(q, k, v, causal=True)
    library_ms = None
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh = (t.transpose(1, 2) for t in (q, k, v))    # (B, H, S, d)
    try:
        lib_out = sdpa(qh, kh, vh, is_causal=True, enable_gqa=True)
    except TypeError as exc:                   # torch without enable_gqa
        log(f"  library call unavailable: {exc}")
    else:
        lib_err = (lib_out.transpose(1, 2).float() - want.float()).abs().max()
        log(f"  library sdpa(enable_gqa) max_abs_err vs plain: "
            f"{lib_err.item():.3e}")
        library_ms = time_ms(lambda: sdpa(qh, kh, vh, is_causal=True,
                                          enable_gqa=True))
    return timed_record(
        torch, "K1", path, "flash_attention_fwd",
        "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:81", err, rel,
        lambda: fa.launch(q, k, v, causal=True),
        lambda: ref.attention_ref(q, k, v, causal=True),
        attention_work(m["B"], m["S"], m["S"], m["Hq"], m["Hkv"], m["d"],
                       True, 0, 2),
        f"q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 causal",
        library_ms=library_ms)


def k2_phase(torch, ssd_scan):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(1)
    plain = ssd_scan.ssd_plain

    def inputs(B, S, H, P, N, dtype):
        x = torch.randn((B, S, H, P), generator=gen, device=dev).to(dtype)
        ld = -torch.nn.functional.softplus(
            torch.randn((B, S, H), generator=gen, device=dev))
        b = (torch.randn((B, S, N), generator=gen, device=dev) * 0.5).to(dtype)
        c = (torch.randn((B, S, N), generator=gen, device=dev) * 0.5).to(dtype)
        return x, ld, b, c

    def case(label, x, ld, b, c, chunk):
        y, sfin = ssd_scan.launch(x, ld, b, c)
        want, swant = plain(x, ld, b, c, chunk=chunk)
        want32, _ = plain(x.float(), ld, b.float(), c.float(), chunk=chunk)
        stol = 1e-4 if x.dtype == torch.float32 else 1e-2
        return check_case(torch, "K2", label, y, want, want32,
                          state=(sfin, swant, stol))

    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, P, N, chunk in SSD_SWEEP:
            case(f"{str(dtype)[6:]} B={B} S={S} H={H} P={P} N={N} "
                 f"chunk={chunk}", *inputs(B, S, H, P, N, dtype), chunk)

    # a sequence cut in two through initial_state equals one pass
    x, ld, b, c = inputs(1, 96, 2, 32, 16, torch.float32)
    cut = 40
    y1, s1 = ssd_scan.launch(*(t[:, :cut].contiguous() for t in (x, ld, b, c)))
    y2, s2 = ssd_scan.launch(*(t[:, cut:].contiguous() for t in (x, ld, b, c)),
                             initial_state=s1)
    want, swant = plain(x, ld, b, c, chunk=32)
    check_case(torch, "K2", f"fp32 S=96 cut at {cut} through initial_state",
               torch.cat([y1, y2], dim=1), want, want,
               state=(s2, swant, 1e-4))

    m = SSD_MAIN
    x, ld, b, c = inputs(m["B"], m["S"], m["H"], m["P"], m["N"],
                         torch.bfloat16)
    err, rel = case("main-path shape bf16", x, ld, b, c, m["chunk"])
    return timed_record(
        torch, "K2", "zamba2-1.2b", "ssd_scan_fwd",
        "src/repro_torch/kernels/csrc/ssd_scan.cu",
        "src/repro/kernels/ssd_scan.py:74",
        err, rel, lambda: ssd_scan.launch(x, ld, b, c),
        lambda: plain(x, ld, b, c, chunk=m["chunk"]),
        ssd_work(m["B"], m["S"], m["H"], m["P"], m["N"], 2),
        f"x {tuple(x.shape)} bf16, log_decay {tuple(ld.shape)} fp32, b/c "
        f"{tuple(b.shape)} bf16, plain at chunk {m['chunk']}")


def k3_phase(torch, wkv6):
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(2)
    plain = wkv6.wkv6_plain

    def inputs(B, S, H, N, M, scale, dtype, U=0):
        def rnd(*shape):
            return torch.randn(shape, generator=gen, device=dev)
        r = (rnd(B, S, H, N) * 0.5).to(dtype)
        k = (rnd(B, S, H, N) * 0.5).to(dtype)
        v = (rnd(B, S, H, M) * 0.5).to(dtype)
        lw = -torch.exp(rnd(B, S, H, N)) * scale
        u = rnd(*((U, H, N) if U else (H, N))) * 0.5
        return r, k, v, lw, u

    def case(label, r, k, v, lw, u, chunk):
        out, sfin = wkv6.launch(r, k, v, lw, u)
        want, swant = plain(r, k, v, lw, u, chunk=chunk)
        want32, _ = plain(r.float(), k.float(), v.float(), lw, u,
                          chunk=chunk)
        stol = 1e-4 if r.dtype == torch.float32 else 1e-2
        return check_case(torch, "K3", label, out, want, want32,
                          state=(sfin, swant, stol))

    for dtype in (torch.float32, torch.bfloat16):
        for B, S, H, N, M, chunk, scale in WKV_SWEEP:
            case(f"{str(dtype)[6:]} B={B} S={S} H={H} N={N} M={M} "
                 f"chunk={chunk} decay_scale={scale}",
                 *inputs(B, S, H, N, M, scale, dtype), chunk)
    # one u per client, two batch rows a client (the fed step's folding)
    case("fp32 B=4 S=64 H=2 N=M=32, u per client (2 rows each)",
         *inputs(4, 64, 2, 32, 32, 1.0, torch.float32, U=2), 16)

    # a sequence cut in two through initial_state equals one pass
    r, k, v, lw, u = inputs(1, 96, 2, 32, 32, 1.0, torch.float32)
    cut = 40
    o1, s1 = wkv6.launch(*(t[:, :cut].contiguous() for t in (r, k, v, lw)),
                         u)
    o2, s2 = wkv6.launch(*(t[:, cut:].contiguous() for t in (r, k, v, lw)),
                         u, initial_state=s1)
    want, swant = plain(r, k, v, lw, u, chunk=16)
    check_case(torch, "K3", f"fp32 S=96 cut at {cut} through initial_state",
               torch.cat([o1, o2], dim=1), want, want,
               state=(s2, swant, 1e-4))

    m = WKV_MAIN
    r, k, v, lw, u = inputs(m["B"], m["S"], m["H"], m["N"], m["M"], 1.0,
                            torch.bfloat16, U=m["U"])
    err, rel = case(f"main-path shape bf16, u per client ({m['B'] // m['U']} "
                    f"rows each)", r, k, v, lw, u, m["chunk"])
    return timed_record(
        torch, "K3", "rwkv6-1.6b", "wkv6_fwd",
        "src/repro_torch/kernels/csrc/wkv6.cu",
        "src/repro/kernels/wkv6.py:79", err, rel,
        lambda: wkv6.launch(r, k, v, lw, u),
        lambda: plain(r, k, v, lw, u, chunk=m["chunk"]),
        wkv_work(m["B"], m["S"], m["H"], m["N"], m["M"], m["U"], 2),
        f"r/k/v {tuple(r.shape)} bf16, log_w fp32, u {tuple(u.shape)} fp32, "
        f"plain at chunk {m['chunk']}")


def path_parity_phase(torch, counters, arch):
    """One fed step on ``arch``'s smoke config (fp32) on the CPU and on the
    card from the same params and batches."""
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import fedpair, splitting
    from repro_torch.models import registry
    from repro_torch.tree import tree_items, tree_map

    cfg = get_smoke_config(arch)
    n = 4
    g = registry.init_params(cfg, 0, "cpu")
    noise = torch.Generator().manual_seed(1)
    base = tree_map(lambda a: torch.stack(
        [a + 0.02 * torch.randn(a.shape, generator=noise) for _ in range(n)]),
        g)
    rng = torch.Generator().manual_seed(2)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (n, 2, 64),
                                     generator=rng),
             "labels": torch.randint(0, cfg.vocab_size, (n, 2, 64),
                                     generator=rng)}
    partner = [2, 3, 0, 1]
    lengths = [1, 1, 1, 1]
    agg_w = [0.5, 0.5, 0.5, 0.5]
    results = {}
    for dev in ("cpu", "cuda"):
        step = fedpair.make_fed_step(
            lambda p, b: registry.loss_fn(p, b, cfg)[0],
            splitting.split_plan(cfg, g), cfg.num_layers,
            fedpair.FedPairingConfig(lr=0.05, donate=False),
            unread=registry.unread_leaves(cfg))
        params = tree_map(lambda a: a.to(dev), base)
        before = {kid: m.launches for kid, m in counters.items()}
        new, m = step(params, {k: v.to(dev) for k, v in batch.items()},
                      partner, lengths, agg_w)
        torch.cuda.synchronize()
        launched = {kid: counters[kid].launches - before[kid]
                    for kid in counters}
        results[dev] = (new, m["loss"].cpu(), launched)
    (cpu_new, cpu_loss, cpu_launched), (gpu_new, gpu_loss, gpu_launched) = \
        results["cpu"], results["cuda"]
    log(f"  {cfg.name}: losses cpu {cpu_loss.tolist()} cuda "
        f"{gpu_loss.tolist()}")
    if not torch.allclose(gpu_loss, cpu_loss, rtol=1e-4, atol=1e-4):
        raise AssertionError(f"{cfg.name}: fed step losses differ between "
                             f"cuda and cpu")
    worst = 0.0
    for (path, a), (_, b) in zip(tree_items(gpu_new), tree_items(cpu_new)):
        worst = max(worst, (a.cpu() - b).abs().max().item())
        if not torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"{cfg.name}: fed step param {path} differs "
                                 f"between cuda and cpu")
    if any(cpu_launched.values()) or not all(
            gpu_launched[kid] > 0 for kid in SMOKE_PATHS[arch]):
        raise AssertionError(f"{cfg.name}: kernel launches cpu "
                             f"{cpu_launched}, cuda {gpu_launched}; expected "
                             f"{SMOKE_PATHS[arch]} on cuda only")
    log(f"  {cfg.name}: new params agree (max_abs_diff {worst:.3e}); kernel "
        f"launches in the cuda step: {gpu_launched}")


def sim_phase(torch, fa):
    """The port's ``sim`` entry point with its default flags on the card
    and on the CPU: identical host traces, losses within 1e-4."""
    from repro_torch.launch import sim

    args = sim.build_parser().parse_args([])
    states, launched = {}, {}
    for dev in ("cuda", "cpu"):
        before = fa.launches
        states[dev] = sim.run_sim(args, device=dev)
        launched[dev] = fa.launches - before
    if launched["cuda"] <= 0 or launched["cpu"] != 0:
        raise AssertionError(f"K1 launches by device: {launched}")
    host = ("round", "cohort", "pairs", "lengths", "sim_round_s",
            "sim_total_s", "objective")
    for gr, cr in zip(states["cuda"].history, states["cpu"].history):
        for field in host:
            if getattr(gr, field) != getattr(cr, field):
                raise AssertionError(f"sim round {gr.round}: {field} differs "
                                     f"between cuda and cpu")
        if not math.isclose(gr.mean_loss, cr.mean_loss, rel_tol=1e-4,
                            abs_tol=1e-4):
            raise AssertionError(f"sim round {gr.round}: loss "
                                 f"{gr.mean_loss} (cuda) vs {cr.mean_loss} "
                                 f"(cpu)")
    log(f"  sim defaults: {len(states['cuda'].history)} rounds, host traces "
        f"identical cuda vs cpu, losses within 1e-4; K1 launches "
        f"{launched['cuda']} on cuda")


def widths(cfg) -> str:
    """The full-width shapes of a slice, by family."""
    fam = cfg.family.value
    common = f"d_model {cfg.d_model}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}"
    if fam == "ssm":
        return (f"{common}, {cfg.d_model // cfg.rwkv_head_dim} WKV heads of "
                f"{cfg.rwkv_head_dim}")
    attn = (f"{cfg.num_heads}/{cfg.num_kv_heads} heads of "
            f"{cfg.resolved_head_dim}")
    if fam == "hybrid":
        d_inner = cfg.ssm_expand * cfg.d_model
        return (f"{common}, d_inner {d_inner} = {d_inner // cfg.ssm_head_dim} "
                f"SSD heads of {cfg.ssm_head_dim}, ssm_state {cfg.ssm_state}, "
                f"shared block {attn}, shared_attn_every "
                f"{cfg.shared_attn_every}")
    return f"{common}, {attn}"


def slice_phase(torch, counters, arch, layers, why, per_step):
    """The ``RoundDriver`` on ``arch`` at full width with its depth cut to
    ``layers``.  Checks each kernel's launches against ``per_step`` per fed
    step, and returns (launches, driver, state)."""
    from repro_torch.configs import get_config
    from repro_torch.core import latency, rounds
    from repro_torch.tree import tree_leaves

    s = SLICE
    full = get_config(arch)
    cfg = full.with_overrides(num_layers=layers)
    log(f"  depth cut: {arch} num_layers {full.num_layers} -> "
        f"{cfg.num_layers} ({why}); full width {widths(cfg)}; compute "
        f"{cfg.dtype}, params {cfg.param_dtype}; "
        f"{cfg.param_count() / 1e6:.1f}M params a replica")
    log(f"  N={s['clients']} clients, batch {s['batch']}, seq {s['seq']}, "
        f"{s['rounds']} rounds x {s['batches_per_round']} batches")
    rc = rounds.RoundConfig(rounds=s["rounds"],
                            batches_per_round=s["batches_per_round"], seed=0)
    fleet = latency.make_fleet(n=s["clients"], seed=0)
    workload = latency.workload_from_arch(
        cfg, seq_len=s["seq"], batch_size=s["batch"],
        batches_per_epoch=s["batches_per_round"], local_epochs=1)
    driver = rounds.RoundDriver(
        cfg, rc, fleet, workload=workload,
        batch_fn=rounds.make_lm_batch_fn(cfg, s["clients"], s["batch"],
                                         s["seq"], 0, device="cuda"),
        device="cuda")
    step_ms = []
    engine_step = driver._engine.step

    def timed_step(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = engine_step(*args)
        torch.cuda.synchronize()
        step_ms.append(1e3 * (time.perf_counter() - t0))
        return out

    driver._engine.step = timed_step
    state = driver.init_state()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for m in counters.values():                # count the main path alone
        m.launches = 0
    for _ in range(s["rounds"]):
        t0 = time.perf_counter()
        state = driver.run_round(state)
        torch.cuda.synchronize()
        r = state.history[-1]
        log(f"  round {r.round}: cohort={list(r.cohort)} "
            f"pairs={list(r.pairs)} lengths={list(r.lengths)} "
            f"loss={r.mean_loss!r} sim_round_s={r.sim_round_s!r} "
            f"wall={time.perf_counter() - t0:.3f}s")
        if not math.isfinite(r.mean_loss):
            raise AssertionError(f"round {r.round} loss is not finite")
    launches = {kid: m.launches for kid, m in counters.items()}
    for leaf in tree_leaves(state.client_params):
        if not torch.isfinite(leaf).all():
            raise AssertionError("non-finite params after the slice")
    log(f"  step ms: {[round(t, 3) for t in step_ms]} (first includes "
        f"warm-up); median {statistics.median(step_ms):.3f}")
    peak = torch.cuda.max_memory_allocated()
    log(f"  peak device memory: {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated)")
    steps = s["rounds"] * s["batches_per_round"]
    expected = {kid: per_step.get(kid, 0) * steps for kid in counters}
    log(f"  kernel launches on the main path: {launches} (expected "
        f"{expected}: per fed step {per_step}, the N clients folded into "
        f"the batch)")
    if launches != expected:
        raise AssertionError(f"{arch}: kernel launches {launches}, expected "
                             f"{expected}")
    return launches, driver, state


KERNEL_GROUPS = (          # (group, substrings of the device kernel name)
    ("K1 flash-attention fwd", ("fa_fwd_kernel",)),
    ("K2 SSD scan fwd", ("ssd_fwd_kernel",)),
    ("K3 WKV6 fwd", ("wkv6_fwd_kernel",)),
    ("matmul", ("gemm", "cutlass", "xmma", "nvjet", "cublas")),
    ("softmax", ("softmax",)),
    ("reduction", ("reduce",)),
    ("gather/scatter/index", ("index", "scatter", "gather")),
    ("concat", ("cat",)),
    ("copy/fill", ("memcpy", "memset", "copy", "fill")),
    ("elementwise", ("elementwise", "vectorized", "unrolled")),
)


def breakdown_phase(torch, driver, state):
    """One more fed step of the slice under ``torch.profiler``: device
    time by kernel group, and the device's idle share of the step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import fedpair

    plan = state.plan
    agg_w = fedpair.pair_weights(state.fleet.data_sizes,
                                 plan.partner_array())
    batch = driver.batch_fn()
    params = state.client_params
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        driver._engine.step(params, batch, plan, agg_w)
        torch.cuda.synchronize()
        wall_us = 1e6 * (time.perf_counter() - t0)
    spans = [(e.time_range.start, e.time_range.end, e.name)
             for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not spans:
        log("  the profiler recorded no device time: breakdown not measured")
        return
    groups = {}
    for start, end, name in spans:
        low = name.lower()
        group = next((g for g, keys in KERNEL_GROUPS
                      if any(k in low for k in keys)), "other")
        groups[group] = groups.get(group, 0.0) + (end - start)
    busy, last = 0.0, float("-inf")
    for start, end, _ in sorted(spans):
        if end > last:
            busy += end - max(start, last)
            last = end
    log(f"  profiled step: wall {wall_us / 1e3:.3f} ms, device busy "
        f"{busy / 1e3:.3f} ms ({len(spans)} device ops), idle share "
        f"{1 - busy / wall_us:.3f}")
    for group, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"    {group:24s} {us / 1e3:9.3f} ms  {us / busy:6.1%}")
    ops = sorted(((e.key, e.self_device_time_total, e.count)
                  for e in prof.key_averages()
                  if e.device_type == DeviceType.CPU
                  and e.self_device_time_total > 0), key=lambda r: -r[1])
    log("  top host ops by the device time of their own kernels:")
    for key, us, count in ops[:12]:
        log(f"    {key:32s} {us / 1e3:9.3f} ms  {us / busy:6.1%}  "
            f"x{count}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card",
              file=sys.stderr)
        return 2
    try:
        from repro_torch.kernels import build, ref, ssd_scan, wkv6
        from repro_torch.kernels import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository "
              f"({exc})", file=sys.stderr)
        return 2
    counters = {"K1": fa, "K2": ssd_scan, "K3": wkv6}

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    log(smi[0])
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; "
        f"{torch.cuda.get_device_name(0)}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("set torch.backends.cuda.matmul.allow_tf32 = False and "
        "torch.backends.cudnn.allow_tf32 = False")

    t0 = time.perf_counter()
    built = build.build_all()
    log(f"[build] {built} in {time.perf_counter() - t0:.1f}s wall")
    for name in build.KERNELS:
        log_ptxas(name, build.build_log(name))

    log("[1] kernels vs plain versions on the card")
    records = (k1_phase(torch, fa, ref) + [k2_phase(torch, ssd_scan),
                                           k3_phase(torch, wkv6)])
    log("[2] path parity: make_fed_step on cuda vs cpu (smoke configs, fp32)")
    for arch in SMOKE_PATHS:
        path_parity_phase(torch, counters, arch)
    sim_phase(torch, fa)
    by_path = {}
    for arch, layers, why, per_step in SLICES:
        log(f"[3] slice: RoundDriver on {arch}, full width, cut depth")
        launches, driver, state = slice_phase(torch, counters, arch, layers,
                                              why, per_step)
        by_path[arch] = launches
        log(f"[4] breakdown: one more {arch} step under torch.profiler")
        breakdown_phase(torch, driver, state)
        del driver, state
        gc.collect()
        torch.cuda.empty_cache()
    for rec in records:                  # each record's launches on its path
        rec["launches"] = by_path[rec["path"]][rec["id"]]

    print(json.dumps({"kernels": records}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each raising on failure (any failure exits non-zero):

1. kernels — build every hand-written kernel from ``src/repro_torch``'s
   sources (one ``nvcc`` per source, all started together), then hold each
   against its plain PyTorch version on the card: K1 (flash-attention
   forward) over the shape sweep of ``tests/test_kernels.py`` in fp32
   (tol 1e-4) and bf16 (tol 2e-2), then at the main path's shape.  Each
   case is checked elementwise against the plain version on the same
   inputs, and by its relative norm error ||got - want|| / ||want||
   against the plain version computed in fp32 on the same values (limit
   1e-5 for fp32, 5e-3 for bf16, about two bf16 roundings), so a kernel
   wrong by a few percent where |out| is small cannot pass.  At the main
   path's shape
   the kernel, its plain version and one PyTorch library call are timed
   with CUDA events and the least time the card could take is computed.
2. path parity — one ``make_fed_step`` on the tinyllama smoke config
   (fp32) on the card and on the CPU from the same params and batches:
   losses and new params agree within 1e-4, and K1 was launched; then
   the port's ``sim`` with its default flags on the card and on the CPU:
   identical host traces, losses within 1e-4.
3. slice — the ``RoundDriver`` (fedpairing, vmapped engine, paper pairing
   and split, mean aggregation) on tinyllama-1.1b at full width, bf16
   compute with fp32 params, depth cut to 4 layers; K1's launch count is
   read from this run alone.
4. breakdown — one more fed step of the slice under ``torch.profiler``:
   device time by kernel group and the device's idle share.

The last two lines are the ``kernels`` JSON summary and the result line.
Without a CUDA device, or outside a checkout of the repository, it exits
non-zero and prints no result.
"""
from __future__ import annotations

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
MAIN_SHAPE = dict(B=8, S=1024, Hq=32, Hkv=4, d=64)   # N=4 clients x batch 2
SLICE_LAYERS = 4
SLICE = dict(clients=4, batch=2, seq=1024, rounds=2, batches_per_round=2)


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


def check_k1(torch, fa, ref, q, k, v, causal, window, label):
    """K1 against its plain version on the same inputs: elementwise at the
    dtype's tolerance, and by relative norm error against the plain
    version in fp32 on the same values.  Returns (max_abs_err, rel_err)."""
    tol, rel_tol = ((1e-4, 1e-5) if q.dtype == torch.float32
                    else (2e-2, 5e-3))
    got = fa.launch(q, k, v, causal=causal, sliding_window=window).float()
    want = ref.attention_ref(q, k, v, causal=causal,
                             sliding_window=window).float()
    want32 = ref.attention_ref(q.float(), k.float(), v.float(),
                               causal=causal, sliding_window=window)
    torch.cuda.synchronize()
    err = (got - want).abs().max().item()
    rel = ((got - want32).norm() / want32.norm()).item()
    ok = (torch.allclose(got, want, rtol=tol, atol=tol) and rel <= rel_tol)
    log(f"  K1 {label}: max_abs_err={err:.3e} (tol {tol}) "
        f"rel_err={rel:.3e} (limit {rel_tol}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"K1 disagrees with its plain version at "
                             f"{label}: max_abs_err {err}, rel_err {rel}")
    return err, rel


def kernel_phase(torch, fa, ref):
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

    m = MAIN_SHAPE
    q, k, v = qkv(m["B"], m["S"], m["Hq"], m["Hkv"], m["d"], torch.bfloat16)
    err, rel = check_k1(torch, fa, ref, q, k, v, True, 0,
                        "main-path shape bf16 causal")
    want = ref.attention_ref(q, k, v, causal=True)
    ms = time_ms(lambda: fa.launch(q, k, v, causal=True))
    plain_ms = time_ms(lambda: ref.attention_ref(q, k, v, causal=True))
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
    flops, nbytes = attention_work(m["B"], m["S"], m["S"], m["Hq"], m["Hkv"],
                                   m["d"], True, 0, 2)
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    bound_ms = 1e3 * max(t_ops, t_bytes)
    bound_by = "operations" if t_ops >= t_bytes else "bytes"
    log(f"  K1 main shape q {tuple(q.shape)} k/v {tuple(k.shape)} bf16 "
        f"causal: {flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB")
    log(f"  K1 ms={ms!r} plain_ms={plain_ms!r} library_ms={library_ms!r} "
        f"bound_ms={bound_ms!r} ({bound_by}); kernel at "
        f"{flops / (ms * 1e-3) / 1e12:.2f} TFLOP/s")
    return {"name": "flash_attention_fwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:81",
            "max_abs_err": err, "rel_err": rel, "ms": ms,
            "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": library_ms}


def path_parity_phase(torch, fa):
    from repro_torch.configs import get_smoke_config
    from repro_torch.core import fedpair, splitting
    from repro_torch.models import registry
    from repro_torch.tree import tree_items, tree_map

    cfg = get_smoke_config("tinyllama-1.1b")
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
            fedpair.FedPairingConfig(lr=0.05, donate=False))
        params = tree_map(lambda a: a.to(dev), base)
        before = fa.launches
        new, m = step(params, {k: v.to(dev) for k, v in batch.items()},
                      partner, lengths, agg_w)
        torch.cuda.synchronize()
        results[dev] = (new, m["loss"].cpu(), fa.launches - before)
    (cpu_new, cpu_loss, _), (gpu_new, gpu_loss, gpu_launches) = \
        results["cpu"], results["cuda"]
    log(f"  losses cpu {cpu_loss.tolist()} cuda {gpu_loss.tolist()}")
    if not torch.allclose(gpu_loss, cpu_loss, rtol=1e-4, atol=1e-4):
        raise AssertionError("fed step losses differ between cuda and cpu")
    worst = 0.0
    for (path, a), (_, b) in zip(tree_items(gpu_new), tree_items(cpu_new)):
        worst = max(worst, (a.cpu() - b).abs().max().item())
        if not torch.allclose(a.cpu(), b, rtol=1e-4, atol=1e-4):
            raise AssertionError(f"fed step param {path} differs between "
                                 f"cuda and cpu")
    if gpu_launches <= 0:
        raise AssertionError("the cuda fed step did not launch K1")
    log(f"  new params agree (max_abs_diff {worst:.3e}); K1 launches in "
        f"the cuda step: {gpu_launches}")


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


def slice_phase(torch, fa, cfg, s=SLICE, device="cuda"):
    from repro_torch.core import latency, rounds
    from repro_torch.tree import tree_leaves

    log(f"  depth cut: tinyllama-1.1b num_layers 22 -> {cfg.num_layers}; "
        f"full width d_model {cfg.d_model}, heads {cfg.num_heads}/"
        f"{cfg.num_kv_heads}, head_dim {cfg.resolved_head_dim}, d_ff "
        f"{cfg.d_ff}, vocab {cfg.vocab_size}; compute {cfg.dtype}, params "
        f"{cfg.param_dtype}; {cfg.param_count() / 1e6:.1f}M params a replica")
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
                                         s["seq"], 0, device=device),
        device=device)
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
    fa.launches = 0                            # count the main path alone
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
    launches = fa.launches
    peak = torch.cuda.max_memory_allocated()
    for leaf in tree_leaves(state.client_params):
        if not torch.isfinite(leaf).all():
            raise AssertionError("non-finite params after the slice")
    log(f"  step ms: {[round(t, 3) for t in step_ms]} (first includes "
        f"warm-up); median {statistics.median(step_ms):.3f}")
    log(f"  peak device memory: {peak / 2**30:.2f} GiB "
        f"(max_memory_allocated)")
    expected = cfg.num_layers * s["rounds"] * s["batches_per_round"]
    log(f"  K1 launches on the main path: {launches} (expected {expected}: "
        f"one per layer per step, the N clients folded into the batch)")
    if launches <= 0:
        raise AssertionError("the slice never launched K1")
    return launches, driver, state


KERNEL_GROUPS = (          # (group, substrings of the device kernel name)
    ("K1 flash-attention fwd", ("fa_fwd_kernel",)),
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
        from repro_torch.kernels import build, ref
        from repro_torch.kernels import flash_attention as fa
    except ImportError as exc:
        print(f"chip_smoke: run it from a checkout of the repository "
              f"({exc})", file=sys.stderr)
        return 2

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
    k1 = kernel_phase(torch, fa, ref)
    log("[2] path parity: make_fed_step on cuda vs cpu (smoke config, fp32)")
    path_parity_phase(torch, fa)
    sim_phase(torch, fa)
    log("[3] slice: RoundDriver on tinyllama-1.1b, full width, cut depth")
    from repro_torch.configs import get_config
    cfg = get_config("tinyllama-1.1b").with_overrides(num_layers=SLICE_LAYERS)
    k1["launches"], driver, state = slice_phase(torch, fa, cfg)
    log("[4] breakdown: one more slice step under torch.profiler")
    breakdown_phase(torch, driver, state)

    print(json.dumps({"kernels": [k1]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

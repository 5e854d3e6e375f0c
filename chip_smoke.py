#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``rustqip_tpu_torch`` (never JAX or ``rustqip_tpu``) from the root of
a checkout: builds the four Hopper kernel sources from
``rustqip_tpu_torch/csrc/`` (the window kernel's two paths,
``window_stream.cu`` and ``window_sweep.cu``, then ``row_swap.cu`` and
``plane_copy.cu``; one nvcc each, all started together), holds each against
its plain PyTorch version (the window kernel on the parity windows, a
register-path window on both paths; the row swap on five pair sets,
exactly). On the clean allocator
``phase_capacity`` then runs the main path at n = 32 (2 x 16 GiB of
float32 planes, the largest state one H100 holds): the JAX package's
single-chip capacity circuit, QFT-32 of the basis state with all bits set
and a native Grover-32 iteration, each against its closed form on the
card, with each run's peak memory held to 40 GiB. Then it runs the main
path --
``LocalBuilder`` -> compile -> sweeps (window kernel, row-swap pass) ->
measurement -- at n = 28 qubits in float32 (2 GiB of state) and checks the
results against closed forms and against the plain torch paths on the same
card: CSWAP, QFT-28, Grover-28 (both forms), bench.py's arms, a controlled
wide register swap, QPE-28 (m = 24, k = 4), Shor-28 (order of 2 mod 437,
t = 19), a 28-qubit ripple adder, and the oracle circuits: a traced-oracle
Grover-28 (function ops), a 14 + 14 XOR oracle and its inverse, the XOR
oracle under a control (``plane_copy`` on the main path) and a 12-qubit
sparse permutation. ``measure_prob_fn`` sums a 27-qubit subspace on the
card, and ``soft_measure`` draws all 28 qubits from the traced Grover-28
register and from a product state whose every qubit has its own known
probability of 1. ``phase_interchange`` exports QFT-28 and Adder-28 to
OpenQASM and to JSON, imports both on the card and runs them through the
kernels against the builder-made circuits, profiles and traces QFT-28
through ``utils/observe.py``, and holds the native C++ CPU engine (built on
this host) against the card at n = 20. ``phase_sharded`` splits 28-qubit
states into eight shards on this one card (``parallel/``) and runs the
paths of the JAX package's multi-device dry run through the explicit and
the kernel-off executors, each against the single-device kernel path.
``phase_state_api`` runs the state-vector API on a 2 GiB complex64 state:
QFT-28's op list through ``engine.apply_ops`` (window and row-swap
kernels), a lane ``apply_op`` (``c64_low_matmul``), a row-pair ``SwapOp``
and the complex measurement API, each against its plain version.
``phase_examples`` runs the port twins of the ten programs of
``examples/`` (``rustqip_tpu_torch/examples/``) on the card, each twice,
and holds what each prints to its closed form or to its original's value
(the traced oracle at its full N = 22).

Then it times each kernel window of QFT-28 and Grover-28 alone
(``window_breakdown``; a register-path window also on the tile path, in
turns), one window per redesigned step kind and the element-wise h = 4
windows alone (``step_breakdown``), the swap pass of QFT-28, QPE-28 and Shor-28 by part
(``swap_breakdown``), every sweep of QPE-28 and Shor-28
(``circuit_breakdown``) and the copy floor (``copy_floor``), each beside its
bound: the larger of the bytes it must move at 3.35 TB/s and its 3xTF32
tensor-core flops at 495 TFLOP/s, and, where there is one, the one PyTorch
call that computes the same function.

Each phase prints one JSON line; any failure raises, so the exit code is
non-zero. ``python3 chip_smoke.py --step-breakdown`` builds the kernels and
runs only the parity windows and the two breakdowns (kernel work; no result
line). The second-to-last line is the ``kernels`` summary; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_MAIN = 28
N_PARITY = 20
KERNEL_TOL = 1e-6  # kernel vs plain, normalized n=20 state (max abs)
E2E_TOL = 1e-5  # f32 end to end at n=28 (max abs)
REPS = 3
COPY_PER = 20  # copy-floor calls per timed run
SOFT_DRAWS = 256  # soft_measure draws of the product state
# phase_interchange's QFT-28 input: every bit set. The QFT applies each
# controlled phase while its control is still a basis qubit, so a phase
# acts on the state only where its control's input bit is 1.
QFT_INPUT = (1 << N_MAIN) - 1
# Peak rates of one H100 SXM (NVIDIA data sheet, dense): bounds are
# max(bytes / HBM rate, tensor-core flops / TF32 rate).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = REPS, warm: bool = True, per: int = 1) -> float:
    """Median milliseconds of ``fn()`` by CUDA events (one warm-up unless
    ``warm`` is false). With ``per`` > 1 each timed run is ``per`` calls
    back to back, divided by ``per``: the host's time to launch one call
    then hides behind the calls before it."""
    import torch

    if warm:
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(per):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / per)
    return statistics.median(times)


def window_bound(prog, n: int):
    """(bound ms, "bytes" or "operations") of one window program: the
    larger of the bytes it must move (live strips read + written, both
    planes) at the HBM rate and the tensor-core flops its matrix steps
    perform in 3xTF32 (3 TF32 products per real product: 2 real products
    for a real B on both planes, 3 for a complex B by Karatsuba) at the
    TF32 rate."""
    from rustqip_tpu_torch.engine import window_kernel as wk

    ns = 1 << prog.h
    strip_rows = (1 << (n - 7)) >> prog.h
    moved = (bin(prog.in_mask).count("1") + bin(prog.out_mask).count("1")) \
        * strip_rows * 128 * 4 * 2
    products = 0
    ip = prog.iprog
    for s in range(prog.nsteps):
        rec = ip[8 * s: 8 * s + 8]
        kind = wk.KINDS[rec[0]]
        live = bin(int(rec[1])).count("1")
        if kind == "low":
            products += 3 * live
        elif kind == "lowr":
            products += 2 * live
        elif kind == "rmix":
            for j in range(ns):
                if rec[1] >> j & 1:
                    for i in range(ns):
                        typ = ip[rec[2] + 2 * (j * ns + i)]
                        products += {2: 2, 3: 3}.get(int(typ), 0)
    flops = products * 3 * 2 * strip_rows * 128 * 128
    bytes_ms = moved / HBM_BYTES_PER_S * 1e3
    ops_ms = flops / TF32_FLOPS_PER_S * 1e3
    return (bytes_ms, "bytes") if bytes_ms >= ops_ms else (ops_ms, "operations")


def kernel_modules():
    """{kernel source name: the module whose wrapper counts its launches}.
    ``window_sweep`` counts every launch of the window kernel,
    ``window_stream`` the launches of its register-streaming path."""
    from rustqip_tpu_torch.engine import copy_probe, row_swap
    from rustqip_tpu_torch.engine import window_kernel as wk

    return {"window_sweep": wk, "window_stream": wk, "row_swap": row_swap,
            "plane_copy": copy_probe}


def tile_twin(prog):
    """The same program on the tile path, for a register-path program (A/B
    in one call); None for a tile-path program."""
    import dataclasses

    return dataclasses.replace(prog, path="tile") if prog.path == "registers" else None


def reset_launches() -> None:
    for mod in kernel_modules().values():
        mod.reset_launch_counts()


def read_launches() -> dict:
    return {name: mod.LAUNCHES[name] for name, mod in kernel_modules().items()}


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from rustqip_tpu_torch.engine import cuda_build

    nvcc = cuda_build.nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True)
    try:
        import triton  # noqa: F401

        has_triton = True
    except ImportError:
        has_triton = False
    emit({
        "phase": "env",
        "nvidia_smi": smi,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc,
        "nvcc_version": ver.stdout.strip().splitlines()[-1],
        "triton_importable": has_triton,
        "device": torch.cuda.get_device_name(0),
    })
    return smi


def phase_build():
    """Build the four kernel sources from the checkout (one nvcc each,
    started together) and load them."""
    from rustqip_tpu_torch.engine import cuda_build

    if cuda_build.BUILD_DIR.exists():
        shutil.rmtree(cuda_build.BUILD_DIR)
    t0 = time.perf_counter()
    names = list(kernel_modules())
    per = cuda_build.build(*names)
    for name in names:
        cuda_build.load(name)
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "nvcc_seconds": per,
          "libraries": [str(cuda_build.library_path(k).relative_to(ROOT)) for k in names]})


def seeded_state(n: int, seed: int, device):
    """A normalized random state made from ``seed`` (numpy), as planes."""
    import numpy as np

    from rustqip_tpu_torch.interop import planes_from_numpy

    rng = np.random.default_rng(seed)
    v = rng.normal(size=1 << n) + 1j * rng.normal(size=1 << n)
    v /= np.linalg.norm(v)
    return planes_from_numpy(v, device=device)


def phase_parity():
    """Kernel vs plain on the parity windows at n=20 (f32): the planned
    sequences, the step windows and the tile path's windows (h = 0-4,
    several 8-row tiles to a CTA); a window on the register-streaming path
    is checked on the tile path too."""
    import torch

    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.admission import HOPPER, window_seg_sizes
    from rustqip_tpu_torch.engine.parity_windows import (
        build_sequences,
        lowr_sequence,
        step_windows,
        tile_windows,
    )
    from rustqip_tpu_torch.engine.real_apply import compile_sweeps

    n = N_PARITY
    re0, im0 = seeded_state(n, 0, "cuda")
    seen = set()
    paths = set()
    worst = 0.0
    rows = []
    for name, ops, expected in build_sequences(n) + [lowr_sequence(n)]:
        sweeps = compile_sweeps(n, ops, True, HOPPER, "cuda")
        diff = 0.0
        kinds = set()
        for kind, payload, _run in sweeps:
            if kind != "kwindow":
                raise AssertionError(f"{name}: a sweep left the kernel ({kind})")
            seg, ksteps, prog = payload
            pr, pi = re0.clone(), im0.clone()
            wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
            for p in filter(None, (prog, tile_twin(prog))):
                kr, ki = re0.clone(), im0.clone()
                wk.window_sweep(n, kr, ki, seg, ksteps, prog=p)
                torch.cuda.synchronize()
                diff = max(diff, (kr - pr).abs().max().item(), (ki - pi).abs().max().item())
                paths.add(p.path)
            kinds |= set(prog.kinds)
        if diff > KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain max|diff| {diff}")
        seen |= set(wk.KIND_LAUNCHES)
        worst = max(worst, diff)
        rows.append({"window": name, "kinds": sorted(kinds), "paths": sorted(paths),
                     "max_abs_diff": diff})
        paths = set()
    for name, hq, ksteps, kinds in step_windows(n) + tile_windows(n):
        seg = window_seg_sizes(n, hq)
        prog = wk.encode_window(n, seg, ksteps)
        pr, pi = re0.clone(), im0.clone()
        wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
        diff = 0.0
        for p in filter(None, (prog, tile_twin(prog))):
            kr, ki = re0.clone(), im0.clone()
            wk.window_sweep(n, kr, ki, seg, ksteps, prog=p)
            torch.cuda.synchronize()
            diff = max(diff, (kr - pr).abs().max().item(), (ki - pi).abs().max().item())
            paths.add(p.path)
        if diff > KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain max|diff| {diff}")
        worst = max(worst, diff)
        rows.append({"window": name, "kinds": sorted(kinds), "paths": sorted(paths),
                     "max_abs_diff": diff})
        paths = set()
    seen |= set(wk.KIND_LAUNCHES)
    missing = set(wk.KINDS) - seen
    if missing:
        raise AssertionError(f"step kinds never launched: {sorted(missing)}")
    if not wk.LAUNCHES["window_stream"]:
        raise AssertionError("the register-streaming path never launched")
    emit({"phase": "kernel_vs_plain", "n": n, "tol": KERNEL_TOL,
          "windows": rows, "kinds_launched": dict(wk.KIND_LAUNCHES),
          "launches": dict(wk.LAUNCHES)})
    return worst


def rows_moved(n: int, pairs) -> int:
    """Rows a swap pass over ``pairs`` must move: those whose index differs
    in the two bits of some pair, R - R / 2^k for k disjoint pairs."""
    R = 1 << (n - 7)
    return R - (R >> len(pairs))


def phase_swap_parity():
    """The row-swap kernel against its plain version at n = 20 on the pair
    sets of ``row_swap.parity_pair_sets`` in float32, and one float64
    case: a permutation computes nothing, so they must be equal."""
    import torch

    from rustqip_tpu_torch.engine import row_swap

    n = N_PARITY
    sets = [(name, pairs, torch.float32) for name, pairs in row_swap.parity_pair_sets(n)]
    sets.append((sets[1][0] + "_f64", sets[1][1], torch.float64))
    rows = []
    for name, pairs, dtype in sets:
        xr, xi = (x.to(dtype) for x in seeded_state(n, 3, "cuda"))
        want = row_swap.row_swap_reference(n, pairs, xr, xi)
        got = row_swap.row_swap(n, pairs, xr.clone(), xi.clone())
        torch.cuda.synchronize()
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            raise AssertionError(f"row_swap {name}: kernel differs from the plain version")
        rows.append({"set": name, "pairs": pairs, "dtype": str(dtype).split(".")[-1],
                     "rows_moved": rows_moved(n, pairs), "equal": True})
    emit({"phase": "swap_kernel_vs_plain", "n": n, "sets": rows})
    return 0.0


N_CAP = 32  # phase_capacity: 2 x 16 GiB of float32 planes on one 80 GB card
CAP_PEAK_GIB = 40.0  # its bar per run: the 32 GiB state plus 8 GiB of scratch
CAP_MARKED = 0b10110011100011110000111101011001  # Grover-32's marked value
GROVER28_MARKED = 0b1011001110001111000011110101  # Grover-28's marked value


def capacity_circuit(b, n: int, k: int = 4):
    """The JAX package's single-chip capacity circuit
    (``benches/capacity_single_chip.py:50-63``) on the builder ``b`` of
    either package: H on all n qubits, CNOT(0, n-1) across the row/lane
    seam, ``measure`` of the last k qubits (sample and collapse), then
    ``measure_stochastic`` of the same qubits. Returns both handles."""
    r = b.h(b.register(n))
    rest, q0 = b.split_first_qubit(r)
    rest, qlast = b.split_last_qubit(rest)
    q0, qlast = b.cnot(q0, qlast)
    r = b.merge_registers([q0, rest, qlast])
    res = b.split_register_relative(r, range(n - k))
    head, mreg = res.selected, res.remaining
    mreg, h_meas = b.measure(mreg)
    mreg, h_probs = b.measure_stochastic(mreg)
    b.merge_registers([head, mreg])
    return h_meas, h_probs


def grover_closed_err(re, im, n: int, marked_index: int) -> float:
    """Largest relative error of one Grover iteration with native
    diffusion from |+>^n against its closed form: the marked amplitude
    (3 - 4/N)/sqrt(N), every other (1 - 4/N)/sqrt(N), no imaginary part.
    On the card, in row blocks of 2^24 elements."""
    N = 1 << n
    a0 = N ** -0.5
    other, marked = a0 * (1 - 4 / N), a0 * (3 - 4 / N)
    R, C = re.shape
    rows = max(1, (1 << 24) // C)
    mr, mc = divmod(marked_index, C)
    err = abs(re[mr, mc].item() / marked - 1)
    for r0 in range(0, R, rows):
        d = (re[r0:r0 + rows].double() - other).abs()
        if r0 <= mr < r0 + rows:
            d[mr - r0, mc] = 0.0
        err = max(err, d.max().item() / other, im[r0:r0 + rows].abs().max().item() / other)
    return err


def phase_capacity():
    """The main path at the card's capacity: ``LocalBuilder(dtype="f32",
    device="cuda")`` -> ``compile()`` -> ``CompiledCircuit.run`` at
    n = 32 (2 x 16 GiB of float32 planes) from a basis state, on a clean
    allocator: the JAX package's capacity circuit, QFT-32 of the basis
    state with all bits set, and one Grover-32 iteration with native
    diffusion, each against its closed form on the card. Per circuit: the
    plan, the launches of a run with every counter zeroed just before,
    the peak memory of that run and of the timed runs (held to
    ``CAP_PEAK_GIB``), ms per run and its bound: one write of both planes
    (the one-hot start), a read and a write per sweep, a read per
    probability pass and a read and a write per collapse, at the HBM
    rate."""
    import gc

    import torch

    from rustqip_tpu_torch.algos import grover_iteration, qfft
    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.compile import MeasureEntry
    from rustqip_tpu_torch.prelude import LocalBuilder

    n = N_CAP
    t0 = time.perf_counter()
    gib = float(1 << 30)
    state_bytes = 2 * 4 << n  # both float32 planes
    gc.collect()
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    emit({"phase": "capacity_env", "n": n, "state_gib": state_bytes / gib,
          "free_gib": free / gib, "total_gib": total / gib, "peak_bar_gib": CAP_PEAK_GIB,
          "jax_package_point": "n = 30, 2 x 4 GiB of float32 planes on one 16 GB TPU v5e "
                               "(benches/capacity_single_chip.py): the JAX package's size, "
                               "not a measurement of this card"})
    pass_ms = state_bytes / HBM_BYTES_PER_S * 1e3
    qft_input = (1 << n) - 1
    marked_index = sum(((CAP_MARKED >> j) & 1) << (n - 1 - j) for j in range(n))

    def check_capacity(re, im, res):
        (outcome, prob), probs = res
        p = probs.double().cpu()
        peak, total_p = float(p[outcome]), float(p.sum())
        uniform = 1.0 / p.numel()
        if not (abs(prob - uniform) < 0.05 * uniform and int(p.argmax()) == outcome
                and abs(peak - 1) < 1e-3 and abs(total_p - 1) < 1e-3):
            raise AssertionError(f"capacity-32: outcome {outcome} p {prob}, after the "
                                 f"collapse {p.tolist()}")
        return max(abs(peak - 1), abs(total_p - 1)), {
            "outcome": outcome, "outcome_prob": prob, "post_collapse_peak": peak,
            "post_collapse_sum": total_p}

    def check_qft(re, im, res):
        err = qft_closed_err([re], [im], n, qft_input)
        if err > 1e-8:
            raise AssertionError(f"QFT-32: max |amp - closed form| = {err}")
        return err, {}

    def check_grover(re, im, res):
        err = grover_closed_err(re, im, n, marked_index)
        if err > 1e-4:
            raise AssertionError(f"Grover-32: relative error {err}")
        return err, {}

    def grover(b):
        grover_iteration(b, b.h(b.register(n)), CAP_MARKED, native_diffusion=True)

    circuits = [
        ("capacity32", lambda b: capacity_circuit(b, n), 0, check_capacity),
        ("qft32_all_ones", lambda b: qfft(b, b.register(n)), qft_input, check_qft),
        ("grover32_iteration_native", grover, 0, check_grover),
    ]
    total, kind_total, parts = Counter(), Counter(), {}
    for name, build, init, check in circuits:
        b = LocalBuilder(dtype="f32", device="cuda")
        build(b)
        t_plan = time.perf_counter()
        cc = b.compile()
        plan_s = time.perf_counter() - t_plan
        counts = cc.sweep_counts()
        windows = [[list(p[0]), [st[0] for st in p[1]]] for s in cc.sweeps
                   if not isinstance(s, MeasureEntry) for kind, p, _ in s if kind == "kwindow"]
        passes = 1 + 2 * sum(counts.values()) + sum(
            1 if s.stochastic else 3 for s in cc.sweeps if isinstance(s, MeasureEntry))
        gen = torch.Generator()
        gen.manual_seed(7)
        torch.cuda.synchronize()
        reset_launches()
        torch.cuda.reset_peak_memory_stats()
        re, im, res = cc.run(init, generator=gen)
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / gib
        launches = read_launches()
        kinds = dict(wk.KIND_LAUNCHES)
        err, extra = check(re, im, res)
        del re, im, res
        if launches["window_sweep"] <= 0 or (name.startswith("qft") and launches["row_swap"] <= 0) \
                or (name != "grover32_iteration_native" and launches["window_stream"] <= 0):
            raise AssertionError(f"{name}: the capacity path launched {launches}")
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: cc.run(init, generator=gen))
        timed_peak = torch.cuda.max_memory_allocated() / gib
        if max(peak, timed_peak) > CAP_PEAK_GIB:
            raise AssertionError(f"{name}: peak {peak} / {timed_peak} GiB > {CAP_PEAK_GIB}")
        capacity_breakdown(name, cc, init, pass_ms, parts)
        bound = passes * pass_ms
        emit({"phase": "capacity", "circuit": name, "n": n, "plan_s": plan_s,
              "sweeps": sum(counts.values()), "sweep_counts": counts,
              "kernel_windows": windows, "kernel_launches": launches, "kind_launches": kinds,
              "run_ms": ms, "bound_ms": bound, "bound_by": "bytes", "bound_passes": passes,
              "bound_share": bound / ms, "check_err": err, **extra,
              "peak_gib": peak, "timed_peak_gib": timed_peak,
              "state_gib": state_bytes / gib})
        total.update(launches)
        kind_total.update(kinds)
    gc.collect()
    torch.cuda.empty_cache()
    emit({"phase": "capacity_done", "seconds": time.perf_counter() - t0})
    return dict(total), dict(kind_total), parts


def capacity_breakdown(name, cc, init, pass_ms, parts):
    """Where one capacity run's time goes: each sweep of its plan alone
    (``observe.profile_passes``, on the profiler's own planes, in place),
    each beside its bound (a kernel window's live strips by
    ``window_bound``, a plain sweep a read and a write of both planes);
    the one-hot start; for QFT-32 the row pairs (``row_swap``) and the
    cross pairs of its swap pass alone; for the capacity circuit one
    probability pass and one collapse. Adds QFT-32's window and row-swap
    times and bounds to ``parts`` for the ``kernels`` line."""
    import torch

    from rustqip_tpu_torch.engine import row_swap
    from rustqip_tpu_torch.engine.apply import _cross_swap_planes, _swap_schedule
    from rustqip_tpu_torch.engine.compile import MeasureEntry
    from rustqip_tpu_torch.ops.measurement_ops import _collapse_, measure_probs_ri
    from rustqip_tpu_torch.utils import observe

    n = cc.n
    sweeps = []
    for (info, [(kind, payload, _)]), t in zip(observe.sweep_plans(cc),
                                               observe.profile_passes(cc)):
        bound = window_bound(payload[2], n)[0] if kind == "kwindow" else 2 * pass_ms
        sweeps.append({"kind": kind, "op": info["kind"], "row_bits": info.get("row_bits"),
                       "steps": info["steps"], "ms": t["ms"], "bound_ms": bound,
                       "bound_share": bound / t["ms"]})
    row = {"phase": "capacity_breakdown", "circuit": name, "n": n, "sweeps": sweeps,
           "one_hot_ms": cuda_ms(lambda: cc._one_hot(init)), "one_hot_bound_ms": pass_ms}
    kw = [s for s in sweeps if s["kind"] == "kwindow"]
    row["kernel_windows_ms"] = sum(s["ms"] for s in kw)
    row["kernel_windows_bound_ms"] = sum(s["bound_ms"] for s in kw)
    re, im = cc._one_hot(init)
    for seg in cc.sweeps:
        if isinstance(seg, list):
            for kind, op, _ in seg:
                if kind == "op" and type(op).__name__ == "SwapOp":
                    cross, rowp, _, _ = _swap_schedule(n, op)
                    row["row_swap_ms"] = cuda_ms(lambda: row_swap.row_swap(n, rowp, re, im))
                    row["row_swap_bound_ms"] = (2 * 2 * rows_moved(n, rowp) * 128 * 4
                                                / HBM_BYTES_PER_S * 1e3)
                    row["cross_pairs_ms"] = cuda_ms(
                        lambda: _cross_swap_planes(n, cross, [re, im], inplace=True))
        elif isinstance(seg, MeasureEntry) and not seg.stochastic:
            row["probs_ms"] = cuda_ms(lambda: measure_probs_ri(n, seg.indices, re, im))
            row["collapse_ms"] = cuda_ms(lambda: _collapse_(n, seg.indices, (0, 1.0), [re, im]))
    del re, im
    emit(row)
    if name.startswith("qft"):
        parts.update({k: row[k] for k in ("kernel_windows_ms", "kernel_windows_bound_ms",
                                          "row_swap_ms", "row_swap_bound_ms")})


def _builder(kernel: bool):
    from rustqip_tpu_torch.prelude import LocalBuilder

    return LocalBuilder(dtype="f32", device="cuda", kernel_ok=None if kernel else False)


def builder_circuit(build):
    """``make(kernel)`` for a circuit built on a LocalBuilder by ``build``."""
    def make(kernel):
        b = _builder(kernel)
        handles = build(b)
        return b.compile(), b.initial_index(handles.get("init", ())), handles

    return make


def run_circuit(name, make, check):
    """Compile the same circuit twice (kernel path, plain path), run the
    kernel path once with every launch counter zeroed just before and read
    just after, check both results, and time both paths. ``make(kernel)``
    returns ``(compiled circuit, initial index, handles)``."""
    import torch

    from rustqip_tpu_torch.engine import window_kernel as wk

    out = {}
    for label, kernel in (("kernel", True), ("plain", False)):
        cc, init, handles = make(kernel)
        handles = dict(handles, path=label)
        gen = torch.Generator()
        gen.manual_seed(7)
        torch.cuda.synchronize()
        if kernel:
            reset_launches()
        re, im, res = cc.run(init, generator=gen)
        torch.cuda.synchronize()
        if kernel:
            launches = read_launches()
            kinds = dict(wk.KIND_LAUNCHES)
        check(re, im, res, handles)
        # the plain path was just run once: time one more run of it
        ms = cuda_ms(lambda: cc.run(init, generator=gen),
                     **({} if kernel else {"reps": 1, "warm": False}))
        out[label] = (re, im, cc, ms)
        del re, im
    (kr, ki, kcc, kms), (pr, pi, pcc, pms) = out["kernel"], out["plain"]
    diff = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
    if diff > E2E_TOL:
        raise AssertionError(f"{name}: kernel path vs plain path max|diff| {diff}")
    counts = kcc.sweep_counts()
    row = {"phase": "main_path", "circuit": name, "n": N_MAIN,
           "sweeps": sum(counts.values()), "kwindow_sweeps": counts["kwindow"],
           "plain_plan_sweeps": sum(pcc.sweep_counts().values()),
           "kernel_launches": launches, "kind_launches": kinds,
           "kernel_path_ms": kms, "plain_path_ms": pms,
           "kernel_vs_plain_max_abs_diff": diff}
    del out
    torch.cuda.empty_cache()
    return row, launches, kcc


def _basis_index(n, regs_values):
    """State index of a basis state from (register, value) pairs (value bit
    j on the register's j-th qubit)."""
    idx = 0
    for r, v in regs_values:
        for j, q in enumerate(r.indices):
            idx |= ((v >> j) & 1) << (n - 1 - q)
    return idx


def phase_main():
    import numpy as np
    import torch

    from collections import Counter

    from rustqip_tpu_torch.algos import (
        add,
        grover_iteration,
        phase_estimate,
        qfft,
        shor_period_circuit,
    )
    from rustqip_tpu_torch.algos.shor import period_from_distribution
    from rustqip_tpu_torch.engine.compile import UnitaryEntry, compile_pipeline
    from rustqip_tpu_torch.ops import gates
    from rustqip_tpu_torch.ops.matrix_ops import (
        make_control_op,
        make_matrix_op,
        make_swap_op,
    )
    from rustqip_tpu_torch.utils.bits import flip_bits

    n = N_MAIN
    rows = []
    total = Counter()
    kind_launches = Counter()

    # (a) README CSWAP (examples/simple.py) on a 28-qubit state.
    def cswap(b):
        q = b.qubit()
        ra = b.register(3)
        rb = b.register(3)
        b.register(n - 7)  # idle qubits: full-width state
        q = b.h(q)
        cb = b.condition_with(q)
        ra, rb = cb.swap(ra, rb)
        q = cb.dissolve()
        q = b.h(q)
        q, m = b.measure(q)
        return {"init": [(ra, 0b000), (rb, 0b001)], "m": m}

    def check_cswap(re, im, res, h):
        outcome, p = res[0]
        if abs(p - 0.5) > 1e-5:
            raise AssertionError(f"CSWAP: measured p = {p}, want 0.5")

    # (b) QFT-28 from |0>: every amplitude 2^-14.
    def qft28(b):
        qfft(b, b.register(n))
        return {}

    def check_qft(re, im, res, h):
        amp = 2.0 ** (-n / 2)
        err = max((re - amp).abs().max().item(), im.abs().max().item())
        if err > KERNEL_TOL:
            raise AssertionError(f"QFT: max|amp - 2^(-n/2)| = {err}")

    # (c) one Grover-28 iteration from the uniform state, both forms.
    marked = GROVER28_MARKED
    idx = sum(((marked >> j) & 1) << (n - 1 - j) for j in range(n))
    N = 1 << n
    a0 = N ** -0.5
    want_native = a0 * (3 - 4 / N)
    grover_states = {}

    def grover(native):
        def build(b):
            r = b.register(n)
            r = b.h(r)
            grover_iteration(b, r, marked, native_diffusion=native)
            return {}

        def check(re, im, res, h):
            got = re.reshape(-1)[idx].item()
            want = want_native if native else -want_native
            if abs(got / want - 1) > 1e-4 or im.abs().max().item() > E2E_TOL:
                raise AssertionError(f"Grover-28 native={native}: marked {got}, want {want}")
            grover_states.setdefault(native, (re.clone(), im.clone()))

        return build, check

    # (d) a swap of two 6-qubit registers under a control: a ControlOp wider
    # than DENSE_CAP, whose inner row swap runs on plane copies.
    va, vb = 0b101101, 0b000011
    wide_idx = [sum(((v >> (5 - j)) & 1) << (n - 1 - q) for j, q in enumerate(qs))
                for v, qs in ((va, range(1, 7)), (vb, range(7, 13)))]
    wide_swapped = [sum(((v >> (5 - j)) & 1) << (n - 1 - q) for j, q in enumerate(qs))
                    for v, qs in ((vb, range(1, 7)), (va, range(7, 13)))]

    def wide_swap(kernel):
        entries = [
            UnitaryEntry(make_matrix_op([0], gates.H.reshape(-1))),
            UnitaryEntry(make_control_op([0], make_swap_op(range(1, 7), range(7, 13)))),
        ]
        cc = compile_pipeline(n, entries, np.complex64, device="cuda",
                              kernel_ok=None if kernel else False)
        return cc, sum(wide_idx), {}

    def check_wide_swap(re, im, res, h):
        flat = re.reshape(-1)
        for i in (sum(wide_idx), (1 << (n - 1)) | sum(wide_swapped)):
            if abs(flat[i].item() - 0.5 ** 0.5) > E2E_TOL:
                raise AssertionError(f"controlled wide swap: amplitude {flat[i].item()} at {i}")
        if abs((re ** 2).sum().item() - 1) > E2E_TOL or im.abs().max().item() > E2E_TOL:
            raise AssertionError("controlled wide swap: state not the two expected basis states")

    # (e) QPE-28: m = 24 phase qubits, k = 4 target qubits prepared in the
    # eigenvector |1111> of a diagonal U with dyadic eigenphases P / 2^24.
    m_ph = 24
    P = np.random.default_rng(24).integers(0, 1 << m_ph, size=16)
    U = np.diag(np.exp(2j * np.pi * P / (1 << m_ph)))

    def qpe(b):
        phase_estimate(b, U, m_ph, prepare=lambda bb, t: bb.x(t))
        return {}

    def check_qpe(re, im, res, h):
        outcome, p = res[0]
        got = flip_bits(m_ph, outcome)
        if got != int(P[15]) or p < 1 - 1e-5:
            raise AssertionError(f"QPE-28: read {got} / 2^24 with p {p}, want {P[15]}")
        emit({"phase": "qpe28_reading", "path": h["path"], "phase_integer": got,
              "want": int(P[15]), "probability": p})

    # (f) Shor-28: order of 2 mod 437 = lcm(18, 11) = 198, t = 19.
    def shor(b):
        shor_period_circuit(b, 2, 437, t=19)
        return {}

    def check_shor(re, im, res, h):
        probs = res[0].double().cpu().numpy()
        r = period_from_distribution(probs, 2, 437, 19)
        if r != 198 or abs(probs.sum() - 1) > E2E_TOL:
            raise AssertionError(f"Shor-28: order {r} (sum {probs.sum()}), want 198")
        top = np.argsort(probs)[::-1][:4]
        emit({"phase": "shor28_reading", "path": h["path"], "order": r,
              "top_outcomes": [[int(m), float(probs[m])] for m in top]})

    # (g) Adder-28: rb += ra with carry scratch rc: rc[9], ra[9], rb[10].
    def adder(hadamard):
        def build(b):
            rc, ra, rb = b.register(9), b.register(9), b.register(10)
            if hadamard:
                ra = b.h(ra)
            out = add(b, rc, ra, rb)
            init = [(rb, 301)] if hadamard else [(rc, 0), (ra, 389), (rb, 301)]
            return {"init": init, "out": out}

        def check(re, im, res, h):
            rc, ra, rb = h["out"]
            if hadamard:
                want = [_basis_index(n, [(ra, a), (rb, a + 301)]) for a in range(512)]
                amps = re.reshape(-1)[torch.as_tensor(want, device=re.device)]
                if (amps - 512 ** -0.5).abs().max().item() > E2E_TOL \
                        or abs((amps ** 2).sum().item() - 1) > E2E_TOL:
                    raise AssertionError("Adder-28 (H on ra): a branch misses a + 301")
                return
            i = int(((re ** 2) + (im ** 2)).reshape(-1).argmax().item())
            if i != _basis_index(n, [(ra, 389), (rb, 690)]) \
                    or abs(re.reshape(-1)[i].item() - 1) > E2E_TOL:
                raise AssertionError(f"Adder-28: 389 + 301 read at index {i}")

        return build, check

    circuits = [
        ("cswap_readme", builder_circuit(cswap), check_cswap),
        ("qft28", builder_circuit(qft28), check_qft),
        ("grover28_iteration_gate", *(lambda bc: (builder_circuit(bc[0]), bc[1]))(grover(False))),
        ("grover28_iteration_native", *(lambda bc: (builder_circuit(bc[0]), bc[1]))(grover(True))),
        ("controlled_wide_swap28", wide_swap, check_wide_swap),
        ("qpe28", builder_circuit(qpe), check_qpe),
        ("shor28", builder_circuit(shor), check_shor),
        ("adder28_basis", *(lambda bc: (builder_circuit(bc[0]), bc[1]))(adder(False))),
        ("adder28_hadamard", *(lambda bc: (builder_circuit(bc[0]), bc[1]))(adder(True))),
    ]
    must_launch = {"row_swap": {"qft28", "qpe28", "shor28", "controlled_wide_swap28"},
                   "plane_copy": {"controlled_wide_swap28"},
                   "window_stream": {"qft28", "grover28_iteration_gate"}}
    ccs = {}
    for name, make, check in circuits:
        row, launches, cc = run_circuit(name, make, check)
        if name not in ("cswap_readme", "controlled_wide_swap28") \
                and launches["window_sweep"] <= 0:
            raise AssertionError(f"{name}: the main path launched no window kernel")
        for kernel, names in must_launch.items():
            if name in names and launches[kernel] <= 0:
                raise AssertionError(f"{name}: the main path launched no {kernel} kernel")
        if launches["plane_copy"] != (name == "controlled_wide_swap28"):
            # only a controlled SwapOp with row pairs copies its input
            raise AssertionError(f"{name}: plane_copy launched {launches['plane_copy']} times")
        ccs[name] = cc
        total.update(launches)
        kind_launches.update(row["kind_launches"])
        rows.append(row)
        emit(row)
    (gr, gi), (nr, ni) = grover_states[False], grover_states[True]
    form_diff = max((gr + nr).abs().max().item(), (gi + ni).abs().max().item())
    if form_diff / a0 > 1e-4:
        raise AssertionError(f"Grover forms differ beyond -1: {form_diff}")
    emit({"phase": "grover_forms", "max_abs_gate_plus_native": form_diff,
          "relative_to_uniform_amplitude": form_diff / a0})
    del grover_states, gr, gi, nr, ni

    # (h) bench.py's fused and unfused arms, kernel vs plain paths.
    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.admission import HOPPER
    from rustqip_tpu_torch.engine.real_apply import compile_sweeps, run_sweeps

    fused = [make_matrix_op([(i % 2) * (n - 1)], gates.H.reshape(-1)) for i in range(30)]
    ccx = np.eye(8, dtype=np.complex128)
    ccx[[6, 7]] = ccx[[7, 6]]
    triples = [(3, 4, 5), (6, 7, 8), (9, 10, 11), (4, 6, 10)]
    unfused = [make_matrix_op(list(triples[i % 4]), ccx.reshape(-1)) for i in range(20)]
    g = torch.Generator(device="cuda")
    g.manual_seed(28)
    R = 1 << (n - 7)
    x0 = torch.randn((2, R, 128), generator=g, device="cuda")
    x0 /= x0.norm()
    for name, ops in (("bench_fused_arm", fused), ("bench_unfused_arm", unfused)):
        ks = compile_sweeps(n, ops, True, HOPPER, "cuda")
        ps = compile_sweeps(n, ops, False, HOPPER, "cuda")
        kr, ki = x0[0].clone(), x0[1].clone()
        torch.cuda.synchronize()
        reset_launches()
        kr, ki = run_sweeps(n, ks, kr, ki)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches["window_sweep"] <= 0:
            raise AssertionError(f"{name}: the main path launched no kernel")
        total.update(launches)
        kinds = dict(wk.KIND_LAUNCHES)
        kind_launches.update(kinds)
        pr, pi = run_sweeps(n, ps, x0[0].clone(), x0[1].clone())
        diff = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
        if diff > E2E_TOL:
            raise AssertionError(f"{name}: kernel vs plain max|diff| {diff}")
        del kr, ki, pr, pi
        buf = (x0[0].clone(), x0[1].clone())
        kms = cuda_ms(lambda: run_sweeps(n, ks, *buf))
        pms = cuda_ms(lambda: run_sweeps(n, ps, *buf))
        row = {"phase": "main_path", "circuit": name, "n": n, "gates": len(ops),
               "sweeps": len(ks), "kwindow_sweeps": sum(k == "kwindow" for k, _, _ in ks),
               "plain_plan_sweeps": len(ps), "kernel_launches": launches,
               "kind_launches": kinds, "kernel_path_ms": kms, "plain_path_ms": pms,
               "kernel_vs_plain_max_abs_diff": diff}
        rows.append(row)
        emit(row)
        del buf
        torch.cuda.empty_cache()
    missing = {"low", "lowr", "rmix", "diag"} - set(kind_launches)
    if missing:
        raise AssertionError(f"main path never launched step kinds {sorted(missing)}")
    return rows, dict(total), dict(kind_launches), ccs


def _value_index(n, reg, values):
    """State indices (numpy int64) of register values (value bit j on the
    register's j-th qubit), the other qubits 0."""
    import numpy as np

    values = np.asarray(values, dtype=np.int64)
    idx = np.zeros_like(values)
    for j, q in enumerate(reg.indices):
        idx |= ((values >> j) & 1) << (n - 1 - q)
    return idx


def phase_oracles():
    """The function-oracle and wide-sparse circuits at n = 28 through
    ``run_circuit`` (kernel path vs plain path, launches counted per
    circuit), each against its closed form: a traced-oracle Grover-28 (a
    diagonal ``FnOp`` phase oracle and diffusion flip, 3 rounds), a 14 + 14
    XOR oracle and its inverted circuit, the XOR oracle under a control (a
    ``ControlOp`` of an ``FnOp`` on 28 indices: ``plane_copy`` on the main
    path), and a 12-qubit sparse permutation with phases (above
    ``DENSE_CAP``) on a basis register and an H-superposed one. Returns the
    rows, the launch and step-kind totals, the compiled circuits, and the
    Grover-28 state planes with its solution and that solution's
    probability, for ``phase_measure``."""
    import math

    import numpy as np
    import torch

    from rustqip_tpu_torch.prelude import inverter
    from rustqip_tpu_torch.types import Representation

    n = N_MAIN
    mask = (1 << n) - 1
    rows, total, kinds, ccs = [], Counter(), Counter(), {}
    grover_state = {}

    # (a) examples/traced_oracle_example.py at N = 28: which x satisfies
    # (A x + C) mod 2^28 == TARGET? The register is the whole state, so the
    # oracle's row index is the state index.
    a_mul, c_add, target = (2_654_435_761 % (1 << n)) | 1, 0x2B7E5, 0x5555555 & mask
    solution = (pow(a_mul, -1, 1 << n) * (target - c_add)) % (1 << n)

    def phase_oracle(row):
        hit = ((a_mul * row.to(torch.int64) + c_add) & mask) == target
        return row, torch.where(hit, -1.0, 1.0)

    def flip_all_but_zero(row):
        return row, torch.where(row == 0, 1.0, -1.0)

    def traced_grover(b):
        r = b.h(b.register(n))
        for _ in range(3):
            r = b.apply_fn_matrix(r, phase_oracle, tag="affine-hit-28", diagonal=True)
            r = b.h(r)
            r = b.apply_fn_matrix(r, flip_all_but_zero, tag="flip-all-but-zero", diagonal=True)
            r = b.h(r)
        return {}

    p_grover = math.sin(7 * math.asin(2.0 ** (-n / 2))) ** 2

    def check_traced_grover(re, im, res, h):
        p = re.reshape(-1)[solution].item() ** 2 + im.reshape(-1)[solution].item() ** 2
        if abs(p / p_grover - 1) > 1e-4:
            raise AssertionError(f"traced Grover-28: p(solution) {p}, want {p_grover}")
        emit({"phase": "traced_grover28_reading", "path": h["path"], "solution": solution,
              "p_solution": p, "want": p_grover})
        grover_state.setdefault("state", (re.clone(), im.clone()))

    # (b) |x>|y0> -> |x>|y0 ^ f(x)>, f(x) = (a x + c) mod 2^14, rx under
    # H^14; then the same circuit followed by its inverse.
    k = n // 2
    xa, xc, y0 = 0x2F35, 0x1A7, 0x2B1E & ((1 << k) - 1)

    def xor_f(x):
        return (xa * x + xc) & ((1 << k) - 1), 1

    def xor_oracle(b, rx, ry):
        rx = b.h(rx)
        return b.apply_function_op(rx, ry, xor_f)

    def xor28(inverted):
        def build(b):
            rx, ry = b.register(k), b.register(n - k)
            rx, ry = xor_oracle(b, rx, ry)
            if inverted:
                rx, ry = inverter(b, [rx, ry], xor_oracle)
            return {"init": [(ry, y0)], "rx": rx, "ry": ry}

        def check(re, im, res, h):
            flat = re.reshape(-1)
            if inverted:
                i = int(_value_index(n, h["ry"], [y0])[0])
                p = flat[i].item() ** 2 + im.reshape(-1)[i].item() ** 2
                if p < 1 - 1e-5:
                    raise AssertionError(f"XOR oracle then its inverse: p(|0>|y0>) = {p}")
                return
            xs = np.arange(1 << k)
            idx = _value_index(n, h["rx"], xs) | _value_index(
                n, h["ry"], y0 ^ ((xa * xs + xc) & ((1 << k) - 1)))
            amps = flat[torch.as_tensor(idx, device=flat.device)]
            if (amps - 2.0 ** (-k / 2)).abs().max().item() > 1e-5 \
                    or abs((amps ** 2).sum().item() - 1) > 1e-5:
                raise AssertionError("XOR oracle: a branch misses y0 ^ f(x)")

        return build, check

    # (c) the same oracle (13 + 14 qubits) controlled by a qubit in |+>.
    def controlled_xor(b):
        q = b.h(b.qubit())
        rx, ry = b.h(b.register(k - 1)), b.register(k)
        cb = b.condition_with(q)
        rx, ry = cb.apply_function_op(rx, ry, xor_f)
        q = cb.dissolve()
        return {"init": [(ry, y0)], "q": q, "rx": rx, "ry": ry}

    def check_controlled_xor(re, im, res, h):
        flat = re.reshape(-1)
        xs = np.arange(1 << (k - 1))
        qbit = 1 << (n - 1 - h["q"].indices[0])
        for branch, ys in ((0, np.full_like(xs, y0)),
                           (1, y0 ^ ((xa * xs + xc) & ((1 << k) - 1)))):
            idx = _value_index(n, h["rx"], xs) | _value_index(n, h["ry"], ys) | (branch * qbit)
            amps = flat[torch.as_tensor(idx, device=flat.device)]
            if (amps - 2.0 ** (-k / 2)).abs().max().item() > 1e-5 \
                    or abs((amps ** 2).sum().item() - 0.5) > 1e-5:
                raise AssertionError(f"controlled XOR oracle: control branch {branch} wrong")

    # (d) x -> (5 x + 3) mod 2^12 with a phase -1 where 3 | x, on register
    # values (little-endian rows): out[v] = s(v) in[(5 v + 3) mod 2^12].
    ks = 12
    v0 = 0x9C3

    def sign(v):
        return -1.0 if v % 3 == 0 else 1.0

    def perm_rows(v):
        return [((5 * v + 3) % (1 << ks), sign(v))]

    def wide_sparse(b):
        ra, rb = b.register(ks), b.register(ks)
        if n > 2 * ks:
            b.register(n - 2 * ks)  # idle qubits: full-width state
        rb = b.h(rb)
        ra = b.apply_sparse_matrix_from_function(ra, perm_rows, Representation.LittleEndian)
        rb = b.apply_sparse_matrix_from_function(rb, perm_rows, Representation.LittleEndian)
        return {"init": [(ra, v0)], "ra": ra, "rb": rb}

    def check_wide_sparse(re, im, res, h):
        va = (pow(5, -1, 1 << ks) * (v0 - 3)) % (1 << ks)
        vs = np.arange(1 << ks)
        idx = _value_index(n, h["ra"], [va]) | _value_index(n, h["rb"], vs)
        want = torch.as_tensor([sign(va) * sign(v) * 2.0 ** -6 for v in vs],
                               dtype=re.dtype, device=re.device)
        amps = re.reshape(-1)[torch.as_tensor(idx, device=re.device)]
        if (amps - want).abs().max().item() > 1e-5 or abs((amps ** 2).sum().item() - 1) > 1e-5:
            raise AssertionError("wide sparse permutation: amplitudes off the closed form")

    xor_plain, check_xor_plain = xor28(False)
    xor_inv, check_xor_inv = xor28(True)
    circuits = [
        ("traced_grover28", traced_grover, check_traced_grover),
        ("xor_oracle28", xor_plain, check_xor_plain),
        ("xor_oracle28_inverted", xor_inv, check_xor_inv),
        ("controlled_xor_oracle28", controlled_xor, check_controlled_xor),
        ("wide_sparse_perm28", wide_sparse, check_wide_sparse),
    ]
    for name, build, check in circuits:
        row, launches, ccs[name] = run_circuit(name, builder_circuit(build), check)
        if launches["window_sweep"] <= 0:
            raise AssertionError(f"{name}: the main path launched no window kernel")
        if launches["plane_copy"] != 0:
            # only a controlled SwapOp with row pairs copies its input
            raise AssertionError(f"{name}: the main path launched plane_copy "
                                 f"{launches['plane_copy']} times, want 0")
        total.update(launches)
        kinds.update(row["kind_launches"])
        rows.append(row)
        emit(row)
    return rows, total, kinds, ccs, *grover_state["state"], solution, p_grover


def phase_measure(grover_re, grover_im, solution, p_solution):
    """``measure_prob_fn`` at n = 28 over a 27-qubit subspace on the card
    (tier 1 asserted), with ``f`` the amplitude of a seeded product state,
    against its closed form; timed warm. Then 64 ``soft_measure`` draws of
    the whole traced Grover-28 register: the solution's count against its
    probability, and the draws distinct (the register is near uniform over
    2^28 outcomes: two repeats among 64 draws have odds below 1e-10). Last,
    ``SOFT_DRAWS`` draws of all 28 qubits of a product state built as planes
    on the card, qubit q in cos t_q |0> + sin t_q |1> with p_q = sin^2 t_q
    rising from 0.1 to 0.9 in q: each qubit's count of ones within 5 sigma of
    its p_q. Every draw takes the two-stage path (2^28 outcomes); a sampler
    that ignores the state, or swaps a block's bits with its offset's
    (qubit q with q + 14: p differs by 0.41), is many sigma off."""
    import math

    import numpy as np
    import torch

    from rustqip_tpu_torch.ops import measurement_ops as M
    from rustqip_tpu_torch.utils.bits import flip_bits

    n = N_MAIN
    ts = np.random.default_rng(27).uniform(0.1, 1.4, n)
    # amplitude of prod_q (cos t_q |0> + sin t_q |1>): 7-bit tables
    tables = []
    for g in range((n + 6) // 7):
        vals = np.ones(128)
        for v in range(128):
            for b in range(min(7, n - 7 * g)):
                q = n - 1 - (7 * g + b)
                vals[v] *= math.sin(ts[q]) if (v >> b) & 1 else math.cos(ts[q])
        tables.append(torch.as_tensor(vals, dtype=torch.float64, device="cuda"))

    def amp(i):
        out = 1.0
        for g, tab in enumerate(tables):
            part = (i >> (7 * g)) & 127
            out = out * tab[part.long() if isinstance(part, torch.Tensor) else part]
        return out

    q0 = 5
    want = math.sin(ts[q0]) ** 2
    before = M.TIER_CALLS["device"]
    p1 = M.measure_prob_fn(n, 1, [q0], amp)
    if M.TIER_CALLS["device"] != before + 1:
        raise AssertionError("measure_prob_fn: f did not take tier 1 on the card")
    if abs(p1 - want) > 1e-6:
        raise AssertionError(f"measure_prob_fn: p {p1}, want {want}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    p0 = M.measure_prob_fn(n, 0, [q0], amp)
    warm_ms = (time.perf_counter() - t0) * 1e3
    if M.TIER_CALLS["device"] != before + 2 or abs(p0 - (1 - want)) > 1e-6:
        raise AssertionError(f"measure_prob_fn (warm): p {p0}, want {1 - want}")

    gen = torch.Generator().manual_seed(64)
    draws = 64
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outcomes = [M.soft_measure(n, list(range(n)), grover_re, grover_im, gen)
                for _ in range(draws)]
    soft_ms = (time.perf_counter() - t0) * 1e3 / draws
    hits = sum(o == flip_bits(n, solution) for o in outcomes)
    sigma = math.sqrt(draws * p_solution * (1 - p_solution))
    if abs(hits - draws * p_solution) > 5 * sigma + 1e-12 or len(set(outcomes)) < draws - 1 \
            or not all(0 <= o < 1 << n for o in outcomes):
        raise AssertionError(f"soft_measure: {hits} of {draws} draws hit the solution "
                             f"(expected {draws * p_solution}), {len(set(outcomes))} distinct")

    ps = [0.1 + 0.8 * q / (n - 1) for q in range(n)]
    re = torch.ones(1, dtype=torch.float64, device="cuda")
    for pq in ps:  # qubit 0 is the index's top bit
        factor = torch.tensor([math.sqrt(1 - pq), math.sqrt(pq)], dtype=torch.float64,
                              device="cuda")
        re = torch.outer(re, factor).reshape(-1)
    re = re.to(torch.float32)
    im = torch.zeros_like(re)
    if M.ONE_STAGE_MAX >= re.numel():
        raise AssertionError("soft_measure: 2^28 outcomes would not take the two-stage draw")
    gen = torch.Generator().manual_seed(65)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    product = [M.soft_measure(n, list(range(n)), re, im, gen) for _ in range(SOFT_DRAWS)]
    product_ms = (time.perf_counter() - t0) * 1e3 / SOFT_DRAWS
    del re, im
    ones = [sum((o >> q) & 1 for o in product) for q in range(n)]
    zs = [(c - SOFT_DRAWS * pq) / math.sqrt(SOFT_DRAWS * pq * (1 - pq))
          for c, pq in zip(ones, ps)]
    if max(abs(z) for z in zs) > 5:
        raise AssertionError(f"soft_measure (product state): counts of ones {ones}, "
                             f"want {[SOFT_DRAWS * pq for pq in ps]}")
    emit({"phase": "measure", "n": n, "measure_prob_fn": {
              "subspace_qubits": n - 1, "p": p1, "want": want, "err": abs(p1 - want),
              "tier": "device", "warm_ms": warm_ms, "chunk": M.DEVICE_CHUNK},
          "soft_measure": {"draws": draws, "distinct": len(set(outcomes)),
                           "solution_hits": hits, "expected": draws * p_solution,
                           "ms_per_draw": soft_ms},
          "soft_measure_product": {"draws": SOFT_DRAWS, "ones": ones,
                                   "max_abs_z": max(abs(z) for z in zs),
                                   "ms_per_draw": product_ms}})


def _native_circuit(n: int, seed: int):
    """A seeded random op list at ``n`` qubits for the native engine and
    the card: dense 1- and 2-qubit ops, controlled ops, register swaps and
    6-qubit reflections."""
    import numpy as np

    from rustqip_tpu_torch.ops.matrix_ops import (
        make_control_op,
        make_matrix_op,
        make_reflection_op,
        make_swap_op,
    )

    rng = np.random.default_rng(seed)

    def rand_u(k):
        m = rng.normal(size=(1 << k, 1 << k)) + 1j * rng.normal(size=(1 << k, 1 << k))
        return np.linalg.qr(m)[0].reshape(-1)

    ops = []
    for t in range(40):
        q = [int(v) for v in rng.choice(n, size=6, replace=False)]
        kind = t % 5
        if kind == 0:
            ops.append(make_matrix_op(q[:1], rand_u(1)))
        elif kind == 1:
            ops.append(make_matrix_op(q[:2], rand_u(2)))
        elif kind == 2:
            ops.append(make_control_op(q[:2], make_matrix_op(q[2:3], rand_u(1))))
        elif kind == 3:
            ops.append(make_swap_op(q[:2], q[2:4]))
        else:
            ops.append(make_reflection_op(q))
    return ops


def phase_interchange():
    """The slice's modules on the card at n = 28: QFT-28 and Adder-28, each
    of a basis input, exported with ``to_openqasm``, imported with
    ``circuit_from_qasm`` on the card and run through the window and
    row-swap kernels, against the builder-made circuits (within 1e-5) and
    their closed forms (QFT-28 of ``QFT_INPUT``: every amplitude within
    1e-6 of exp(2 pi i x k / 2^28) / 2^14; Adder-28's exact sum);
    the same circuits through ``circuit_to_json`` -> ``builder_from_json``
    (within 1e-7, the same sweep counts); ``observe`` on QFT-28
    (``pass_breakdown`` against the plan, ``profile_passes`` summed against
    the kernel path within 15 %, and one run under ``observe.trace`` with
    the device's busy share of the traced window); then the native CPU
    engine, built on this host, against the card's kernel path on a seeded
    random circuit at n = 20. Every kernel-path run is counted (counts
    zeroed just before, read just after). Returns the launch and step-kind
    totals."""
    import math

    import numpy as np
    import torch

    from rustqip_tpu_torch.algos import add, qfft
    from rustqip_tpu_torch.engine import cpu_native
    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.compile import UnitaryEntry, compile_pipeline
    from rustqip_tpu_torch.interop import planes_to_numpy
    from rustqip_tpu_torch.ops.measurement_ops import measure_prob
    from rustqip_tpu_torch.prelude import LocalBuilder
    from rustqip_tpu_torch.qasm import circuit_from_qasm
    from rustqip_tpu_torch.utils import observe, serialize

    n = N_MAIN
    total, kinds = Counter(), Counter()

    def drive(cc, init=0, initial_state=None):
        """One counted kernel-path run, then its time (CUDA events)."""
        torch.cuda.synchronize()
        reset_launches()
        re, im, _ = cc.run(init, generator=torch.Generator().manual_seed(7),
                           initial_state=initial_state)
        torch.cuda.synchronize()
        launches = read_launches()
        if launches["window_sweep"] <= 0:
            raise AssertionError("interchange: a run launched no window kernel")
        total.update(launches)
        kinds.update(wk.KIND_LAUNCHES)
        counts = cc.sweep_counts()
        ms = cuda_ms(lambda: cc.run(init, initial_state=initial_state))
        return (re, im), {"sweeps": sum(counts.values()), "kwindow_sweeps": counts["kwindow"],
                          "kernel_launches": launches, "kernel_path_ms": ms}

    def diff(a, b):
        return max((a[0] - b[0]).abs().max().item(), (a[1] - b[1]).abs().max().item())

    def qft_circuit(b):
        """QFT-28 of a register that holds QFT_INPUT, so that every
        controlled phase acts and the swaps move distinct amplitudes."""
        r = b.register(n)
        qfft(b, r)
        return [(r, QFT_INPUT)], None

    def qft_err(st, x):
        return qft_closed_err([st[0]], [st[1]], n, x)

    def adder_circuit(b):
        """rb += ra with carry scratch rc: rc[9], ra[9], rb[10]."""
        rc, ra, rb = b.register(9), b.register(9), b.register(10)
        return [(rc, 0), (ra, 389), (rb, 301)], add(b, rc, ra, rb)

    for name, build in (("qft28", qft_circuit), ("adder28_basis", adder_circuit)):
        b = LocalBuilder(dtype="f32", device="cuda")
        init, out = build(b)
        cc = b.compile()
        ref, ref_row = drive(cc, b.initial_index(init))
        t0 = time.perf_counter()
        text = b.to_openqasm()
        imp = circuit_from_qasm(text, builder=LocalBuilder(dtype="f32", device="cuda"))
        per_qubit = [(imp.qubits[reg.indices[j]], (val >> j) & 1)
                     for reg, val in init for j in range(reg.n)]
        icc = imp.builder.compile()
        qasm_s = time.perf_counter() - t0
        got, qasm_row = drive(icc, imp.builder.initial_index(per_qubit))
        closed = {}
        if name == "qft28":
            if qasm_row["kernel_launches"]["row_swap"] <= 0:
                raise AssertionError("QFT-28 from QASM: no row_swap kernel launched")
            x = b.initial_index(init)
            closed = {"input_index": x, "builder_err": qft_err(ref, x),
                      "qasm_err": qft_err(got, x)}
            if max(closed["builder_err"], closed["qasm_err"]) > KERNEL_TOL:
                raise AssertionError(f"QFT-28 of |{x}> against its closed form: {closed}")
        else:
            _, ra, rb = out
            want = _basis_index(n, [(ra, 389), (rb, 690)])
            for label, st in (("builder", ref), ("QASM", got)):
                i = int((st[0] ** 2 + st[1] ** 2).reshape(-1).argmax().item())
                if i != want or abs(st[0].reshape(-1)[i].item() - 1) > E2E_TOL:
                    raise AssertionError(f"Adder-28 ({label}): 389 + 301 read at index {i}")
        qasm_diff = diff(got, ref)
        if qasm_diff > E2E_TOL:
            raise AssertionError(f"{name}: QASM import vs builder max|diff| {qasm_diff}")
        del got
        t0 = time.perf_counter()
        jb = serialize.builder_from_json(serialize.circuit_to_json(b), dtype="f32",
                                         device="cuda")
        jcc = jb.compile()
        json_s = time.perf_counter() - t0
        rep, json_row = drive(jcc, jb.initial_index(init))
        json_diff = diff(rep, ref)
        if json_diff > 1e-7 or jcc.sweep_counts() != cc.sweep_counts():
            raise AssertionError(f"{name}: JSON replay max|diff| {json_diff}, sweeps "
                                 f"{jcc.sweep_counts()} vs {cc.sweep_counts()}")
        del rep, ref
        torch.cuda.empty_cache()
        emit({"phase": "interchange", "circuit": name, "n": n, **closed, "builder": ref_row,
              "from_qasm": {**qasm_row, "qasm_lines": text.count("\n"),
                            "export_import_plan_s": qasm_s, "max_abs_diff": qasm_diff},
              "json_replay": {**json_row, "json_bytes": len(serialize.circuit_to_json(b)),
                              "load_plan_s": json_s, "max_abs_diff": json_diff}})
        if name == "qft28":
            qft_builder, qft_ms = b, ref_row["kernel_path_ms"]

    # observe on QFT-28: the static breakdown against the plan, the measured
    # per-sweep times against the kernel path, and one traced run.
    cc = qft_builder.compile()
    counts = cc.sweep_counts()
    bd = [e for e in observe.pass_breakdown(qft_builder) if e["kind"] != "measure"]
    if len(bd) != sum(counts.values()) or sum(e["kernel"] for e in bd) != counts["kwindow"]:
        raise AssertionError(f"pass_breakdown: {len(bd)} sweeps vs the plan's {counts}")
    prof = observe.profile_passes(qft_builder, iters=REPS)
    prof_sum = sum(e["ms"] for e in prof)
    if abs(prof_sum / qft_ms - 1) > 0.15:
        raise AssertionError(f"profile_passes: {prof_sum} ms summed vs {qft_ms} ms kernel path")
    trace_dir = ROOT / "build" / "observe_trace"
    with observe.trace(str(trace_dir)):
        cc.run(0)
    traced = observe.trace_summary(str(trace_dir / "trace.json"))
    torch.cuda.empty_cache()
    emit({"phase": "observe", "circuit": "qft28", "n": n, "sweeps": len(bd),
          "kernel_sweeps": sum(e["kernel"] for e in bd),
          "profile_passes_ms": [e["ms"] for e in prof], "profile_passes_sum_ms": prof_sum,
          "kernel_path_ms": qft_ms, "sum_over_kernel_path": prof_sum / qft_ms,
          "trace": traced})

    # the native CPU engine against the card on one seeded circuit at n = 20
    n2 = N_PARITY
    t0 = time.perf_counter()
    cpu_native.load_library()
    build_s = time.perf_counter() - t0
    ops = _native_circuit(n2, 2020)
    rng = np.random.default_rng(20)
    v0 = rng.normal(size=1 << n2) + 1j * rng.normal(size=1 << n2)
    v0 = (v0 / np.linalg.norm(v0)).astype(np.complex64)
    t0 = time.perf_counter()
    st = v0
    for op in ops:
        st = cpu_native.native_apply_op(n2, op, st)
    native_ms = (time.perf_counter() - t0) * 1e3
    ncc = compile_pipeline(n2, [UnitaryEntry(op) for op in ops], np.complex64, device="cuda")
    card, card_row = drive(ncc, 0, initial_state=v0)
    native_diff = float(np.abs(planes_to_numpy(*card) - st).max())
    indices, m = [3, 7, n2 - 1], 0b101
    p_native = cpu_native.native_measure_prob(n2, m, indices, st)
    p_card = float(measure_prob(n2, m, indices, *card))
    if native_diff > E2E_TOL or abs(p_native - p_card) > 1e-6:
        raise AssertionError(f"native engine vs card: max|diff| {native_diff}, "
                             f"p {p_native} vs {p_card}")
    emit({"phase": "native_cpu", "n": n2, "ops": len(ops),
          "kinds": dict(Counter(type(op).__name__ for op in ops)),
          "build_and_load_s": build_s, "threads": cpu_native.native_threads(),
          "compilers": cpu_native.compilers(), "cpu_count": os.cpu_count(),
          "native_ms": native_ms, "card": card_row, "max_abs_diff": native_diff,
          "measure_prob": {"indices": indices, "outcome": m, "native": p_native,
                           "card": p_card}})
    return total, kinds


SHARDS = 8  # phase_sharded's mesh: eight shards of one state on cuda:0


def qft_closed_err(res, ims, n, x):
    """max |amp_k - exp(2 pi i x k / 2^n) / 2^(n/2)| over every state index
    k (the port's QFT is the DFT on big-endian state indices), from a
    float64 closed form made on the card in chunks. ``res``/``ims`` are
    plane lists whose concatenation is the state (one plane, or the shards
    in shard order)."""
    import math

    import torch

    size, amp = 1 << n, 2.0 ** (-n / 2)
    re = torch.cat([r.reshape(-1) for r in res]) if len(res) > 1 else res[0].reshape(-1)
    im = torch.cat([i.reshape(-1) for i in ims]) if len(ims) > 1 else ims[0].reshape(-1)
    # k * x mod 2^n in halves of x: no int64 product passes 2^49 at n = 32
    x_hi, x_lo = (x % size) >> 16, x & 0xFFFF
    err = 0.0
    for lo in range(0, size, 1 << 24):
        k = torch.arange(lo, min(size, lo + (1 << 24)), device=re.device, dtype=torch.int64)
        kx = ((k * x_hi) % size * 65536 + k * x_lo) % size
        ph = kx.to(torch.float64) * (2 * math.pi / size)
        err = max(err,
                  (re[lo:lo + k.numel()].double() - amp * torch.cos(ph)).abs().max().item(),
                  (im[lo:lo + k.numel()].double() - amp * torch.sin(ph)).abs().max().item())
    return err


def phase_sharded():
    """The sharded state vector (``parallel/``) at n = 28 in float32 on
    eight shards of one state, all on cuda:0 (g = 3 shard bits, 25 local
    qubits, 2^18 rows a shard), through the paths of the JAX package's
    multi-device dry run: the dry run's circuit through
    ``strategy="gspmd"`` and the default ``"auto"`` (20 of its qubits,
    three of them shard bits, measured stochastically); one op sequence
    through ``apply_sharded_ops`` (local H, global H, global-control
    CNOT, a seam swap, a local control on a global target, a 28-qubit XOR
    ``FnOp`` that takes the ``gex`` exchange), the same with ``chunks=2``;
    the ``gex`` XOR-flip case at n = g + 5; the three reflections (full,
    grouped, controlled); a window-shaped local run; Grover-28 (native
    diffusion, 3 rounds) as a repeat block; QFT-28 of the basis state with
    every bit set (held also to its closed form within 1e-6); and a
    collapse forced on a global and on a local qubit. Every result is
    held within ``E2E_TOL`` of the single-device kernel path of the same
    circuit, and both are timed (CUDA events, median of 3 after a
    warm-up). The window kernel's launches are counted per path: the
    explicit paths launch it, ``strategy="gspmd"`` never does. Returns
    the launch and step-kind totals."""
    import numpy as np
    import torch

    from rustqip_tpu_torch.algos import grover_iteration, qfft
    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.admission import HOPPER
    from rustqip_tpu_torch.engine.real_apply import compile_sweeps, plan_sweeps, run_sweeps
    from rustqip_tpu_torch.ops import gates
    from rustqip_tpu_torch.ops.matrix_ops import (
        make_control_op,
        make_fn_op,
        make_matrix_op,
        make_reflection_op,
        make_swap_op,
    )
    from rustqip_tpu_torch.parallel import (
        compile_sharded,
        compile_sharded_explicit,
        make_shard_mesh,
        sharded_calculate_state,
    )
    from rustqip_tpu_torch.parallel.shard_ops import (
        _lower_schedule,
        compile_sharded_ops,
        make_sharded_pair,
    )
    from rustqip_tpu_torch.builder.builder import _lower_item
    from rustqip_tpu_torch.prelude import LocalBuilder

    n, d = N_MAIN, SHARDS
    g = d.bit_length() - 1
    mesh = make_shard_mesh(d, devices=["cuda:0"] * d)
    total, kinds = Counter(), Counter()

    def shard_diff(shards, single):
        """max |sharded - single| of the planes, shard by shard."""
        (sr, si), (re, im) = shards, single
        rows = sr[0].shape[0]
        re, im = re.reshape(d, rows, -1), im.reshape(d, rows, -1)
        return max(max((a - re[k]).abs().max().item(), (b - im[k]).abs().max().item())
                   for k, (a, b) in enumerate(zip(sr, si)))

    def counted(fn):
        """``fn()`` with every launch count zeroed just before and read just
        after; returns its result and the window kernel's launches."""
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = read_launches()
        total.update(launches)
        kinds.update(wk.KIND_LAUNCHES)
        return out, launches

    def report(path, err, launches, sharded_ms, single_ms, **extra):
        if err > E2E_TOL:
            raise AssertionError(f"sharded {path}: max|sharded - single| {err}")
        emit({"phase": "sharded", "path": path, "n": n, "shards": d,
              "max_abs_diff_vs_single": err, "kernel_launches": launches,
              "sharded_ms": sharded_ms, "single_device_ms": single_ms, **extra})

    def entries_of(b):
        return [e for item in b.pipeline for e in _lower_item(item)]

    def basis(nq, index):
        """A basis state as one device's (R, 128) planes."""
        re = torch.zeros(1 << nq, device="cuda")
        re[index] = 1.0
        re = re.reshape(-1, min(1 << nq, 128))
        return re, torch.zeros_like(re)

    # (1) the dry run's circuit, through strategy="gspmd" and "auto".
    def dryrun_build(b):
        r = b.register(n)
        qs = b.split_all_register(r)
        qs[0] = b.h(qs[0])                       # global (shard) qubit
        qs[0], qs[-1] = b.cnot(qs[0], qs[-1])    # global -> local exchange
        qs[1], qs[-2] = b.swap(qs[1], qs[-2])    # across the shard seam
        for _ in range(2):                       # strip-window shape
            qs[0] = b.h(qs[0])
            qs[-1] = b.h(qs[-1])
        r = qfft(b, b.merge_registers(qs))
        qs = b.split_all_register(r)
        return b.measure_stochastic(b.merge_registers(qs[:10] + qs[-10:]))[1]

    b1 = LocalBuilder(dtype="f32", device="cuda")
    h1 = dryrun_build(b1)
    cc1 = b1.compile()
    re1, im1, res1 = cc1.run(0)
    single_ms = cuda_ms(lambda: cc1.run(0))
    for strategy, compiler in (("gspmd", compile_sharded), ("auto", compile_sharded_explicit)):
        b = LocalBuilder(dtype="f32", device="cuda")
        h = dryrun_build(b)
        gen = torch.Generator()
        gen.manual_seed(0)
        (sr, si, meas), launches = counted(
            lambda: sharded_calculate_state(b, mesh=mesh, generator=gen, strategy=strategy))
        err = max(shard_diff((sr, si), (re1, im1)),
                  float(np.abs(meas.get_stochastic_measurement(h)
                               - res1[0].cpu().numpy()).max()))
        if strategy == "gspmd" and launches["window_sweep"] != 0:
            raise AssertionError(f"gspmd launched the window kernel {launches['window_sweep']} times")
        if strategy == "auto" and launches["window_sweep"] <= 0:
            raise AssertionError("auto (explicit) launched no window kernel")
        cc = compiler(n, entries_of(b), b.dtype, mesh)
        counts = cc.sweep_counts()
        report(f"dryrun_{strategy}", err, launches, cuda_ms(lambda: cc.run(0)), single_ms,
               sweeps=counts)
        del sr, si, meas, cc
    del re1, im1, res1, cc1
    torch.cuda.empty_cache()

    # (2, 3) the dry run's op sequence through apply_sharded_ops, whole and
    # with chunks=2; (5) the three reflections; (6) a window-shaped run.
    def xor_oracle(row):
        # |x>|y> -> |x>|y ^ f(x)>, x the top n-2 bits: spans every qubit,
        # so the globals can never relocate: the gex exchange.
        return row ^ (((row >> 2) * 5 + 1) & 3), torch.ones((), device=row.device)

    H, X, T = (m.reshape(-1) for m in (gates.H, gates.X, gates.T))
    seq = [
        make_matrix_op([n - 1], H),                          # local qubit
        make_matrix_op([0], H),                              # global qubit
        make_control_op([0], make_matrix_op([n - 1], X)),    # global control
        make_swap_op([1], [n - 2]),                          # seam swap
        make_control_op([n - 2], make_matrix_op([0], X)),    # global target
        make_fn_op(list(range(n)), xor_oracle, tag="sharded-xor-28", self_transpose=True),
    ]
    refl = [make_matrix_op([0], H), make_matrix_op([n - 1], H),
            make_reflection_op(range(n)), make_reflection_op([1, n - 1]),
            make_control_op([n - 1], make_reflection_op([0, 2]))]
    window = [make_matrix_op([g], H), make_matrix_op([n - 1], H),
              make_matrix_op([g], H), make_matrix_op([n - 1], T)]
    local = [make_matrix_op([q - g for q in op.indices], op.data) for op in window]
    local_kinds = sorted({k for k, _, _ in plan_sweeps(n - g, local, True, HOPPER)})
    if "kwindow" not in local_kinds:
        raise AssertionError(f"window-shaped local run planned {local_kinds}")
    if [k for k, *_ in _lower_schedule(n, g, refl[2:])] != ["reflect"] * 3:
        raise AssertionError("the reflections did not lower to grouped sums")
    seq_kinds = [k for k, *_ in _lower_schedule(n, g, seq)]
    if "gex" not in seq_kinds:
        raise AssertionError(f"the 28-qubit XOR oracle lowered to {seq_kinds}")
    for path, ops, chunks, init in (
        ("ops_sequence", seq, 1, 1),
        ("ops_sequence_chunks2", seq, 2, 1),
        ("reflections", refl, 1, 1),
        ("window_local_run", window, 1, 1),
    ):
        sched = compile_sharded_ops(mesh, n, ops, kernel_ok=True, chunks=chunks)
        (sr, si), launches = counted(
            lambda: sched.run(*make_sharded_pair(mesh, n, init)))
        if launches["window_sweep"] <= 0:
            raise AssertionError(f"sharded {path} launched no window kernel")
        sweeps = compile_sweeps(n, ops, True, HOPPER, "cuda")
        single = run_sweeps(n, sweeps, *basis(n, init))
        err = shard_diff((sr, si), single)
        del sr, si, single
        buf = make_sharded_pair(mesh, n, init)
        sharded_ms = cuda_ms(lambda: sched.run(*buf))
        one = basis(n, init)
        single_ms = cuda_ms(lambda: run_sweeps(n, sweeps, *one))
        report(path, err, launches, sharded_ms, single_ms,
               schedule=[e[0] for e in sched.sched], chunks=chunks,
               local_plan_kinds=local_kinds if path == "window_local_run" else None)
        del buf, one
        torch.cuda.empty_cache()

    # (4) the gex XOR-flip case: globals outnumber the free local slots
    # and the oracle touches 3 local bits. Its shards hold 32 amplitudes, too
    # few rows for a kernel window, so it is the one path that launches none.
    n2 = g + 5
    fop = make_fn_op(list(range(6)), lambda row: (row ^ 0b110101, torch.ones((), device=row.device)),
                     tag="sharded-flip", self_transpose=True)
    if [k for k, *_ in _lower_schedule(n2, g, [fop])] != ["gex"]:
        raise AssertionError("the flip oracle did not lower to gex")
    ops2 = [make_matrix_op([q], H) for q in range(0, n2, 2)] + [fop]
    sched = compile_sharded_ops(mesh, n2, ops2, kernel_ok=True)
    (sr, si), launches = counted(lambda: sched.run(*make_sharded_pair(mesh, n2, 1)))
    sweeps2 = compile_sweeps(n2, ops2, True, HOPPER, "cuda")
    single = run_sweeps(n2, sweeps2, *basis(n2, 1))
    report("gex_flip", shard_diff((sr, si), single), launches,
           cuda_ms(lambda: sched.run(*make_sharded_pair(mesh, n2, 1))),
           cuda_ms(lambda: run_sweeps(n2, sweeps2, *basis(n2, 1))), n_flip=n2,
           local_op_qubits=sum(1 for q in fop.indices if q >= g))

    # (7) Grover-28, native diffusion, 3 rounds as one repeat block;
    # (8) QFT-28 of the basis state with every bit set.
    marked = 0b1011001110001111000011110101 & ((1 << n) - 1)

    def grover_build(b):
        r = b.h(b.register(n))
        b.repeat(3, lambda bb, rr: grover_iteration(bb, rr, marked, native_diffusion=True), r)
        return []

    def qft_build(b):
        r = b.register(n)
        qfft(b, r)
        return [(r, QFT_INPUT)]

    for path, build in (("grover28_repeat3", grover_build), ("qft28_all_ones", qft_build)):
        b1 = LocalBuilder(dtype="f32", device="cuda")
        init = b1.initial_index(build(b1))
        cc1 = b1.compile()
        re1, im1, _ = cc1.run(init)
        single_ms = cuda_ms(lambda: cc1.run(init))
        b = LocalBuilder(dtype="f32", device="cuda")
        it = build(b)
        (sr, si, _), launches = counted(lambda: sharded_calculate_state(b, it, mesh=mesh, seed=0))
        if launches["window_sweep"] <= 0:
            raise AssertionError(f"sharded {path} launched no window kernel")
        err = shard_diff((sr, si), (re1, im1))
        extra = {}
        if path == "qft28_all_ones":
            extra = {"closed_form_err": qft_closed_err(sr, si, n, QFT_INPUT),
                     "single_closed_form_err": qft_closed_err([re1], [im1], n, QFT_INPUT)}
            if extra["closed_form_err"] > KERNEL_TOL:
                raise AssertionError(f"sharded QFT-28 vs closed form: {extra}")
        else:
            idx = sum(((marked >> j) & 1) << (n - 1 - j) for j in range(n))
            shard, rest = divmod(idx, 1 << (n - g))
            amp = sr[shard].reshape(-1)[rest].item()
            extra = {"p_marked": amp * amp,
                     "want": float(np.sin(7 * np.arcsin(2.0 ** (-n / 2))) ** 2)}
        cc = compile_sharded_explicit(n, entries_of(b), b.dtype, mesh)
        report(path, err, launches, cuda_ms(lambda: cc.run(b.initial_index(it))), single_ms,
               sweeps=cc.sweep_counts(), **extra)
        del sr, si, re1, im1, cc, cc1
        torch.cuda.empty_cache()

    # a collapse forced on a global qubit (0) and on a local one (n - 1)
    def collapse_build(b):
        qs = b.split_all_register(b.h(b.register(n)))
        qs[0], qs[-1] = b.cnot(qs[0], qs[-1])
        qs[5] = b.t(qs[5])
        qs[-1] = b.rz(qs[-1], 0.37)
        b.measure(qs[0])
        b.measure(qs[-1])

    forced = {0: 1, 1: 0}
    b1 = LocalBuilder(dtype="f32", device="cuda")
    collapse_build(b1)
    cc1 = b1.compile()
    re1, im1, res1 = cc1.run(0, forced=forced)
    b = LocalBuilder(dtype="f32", device="cuda")
    collapse_build(b)
    cc = compile_sharded_explicit(n, entries_of(b), b.dtype, mesh)
    (sr, si, res), launches = counted(lambda: cc.run(0, forced=forced))
    if launches["window_sweep"] <= 0:
        raise AssertionError("sharded forced collapse launched no window kernel")
    perr = max(abs(p - q) for (_, p), (_, q) in zip(res, res1))
    if [o for o, _ in res] != [1, 0] or perr > E2E_TOL:
        raise AssertionError(f"forced collapse: sharded {res} vs single {res1}")
    report("forced_collapse", max(shard_diff((sr, si), (re1, im1)), perr), launches,
           cuda_ms(lambda: cc.run(0, forced=forced)),
           cuda_ms(lambda: cc1.run(0, forced=forced)),
           outcomes=[o for o, _ in res], probs=[p for _, p in res],
           single_probs=[p for _, p in res1])
    del sr, si, re1, im1, cc, cc1
    torch.cuda.empty_cache()
    return dict(total), kinds


API_MEASURED = list(range(2, 26))  # phase_state_api's 24 measured qubits


def phase_state_api():
    """The state-vector API at n = 28 in complex64 on the card: a seeded
    flat state (2 GiB) through ``engine.apply_ops`` with QFT-28's op list
    (the builder's pipeline as ``compile_pipeline`` receives it: 798 ops,
    14 of them one-pair ``SwapOp``s), held within ``E2E_TOL`` of the plain
    path on the same card (``run_sweeps(..., low_kernel=False,
    swap_kernel=False)``, which launches no kernel at all) and the input
    bit-equal afterwards; the
    window kernel must launch once per kernel window of the plan and the
    row-swap kernel once per ``SwapOp`` with row pairs. Then ``apply_op``
    of a random unitary on the lane qubits 26, 27 (one ``c64_low_matmul``
    launch, within ``KERNEL_TOL`` of its plain matmuls), of a ``SwapOp``
    with seven row pairs (one ``row_swap`` launch, bit-equal to the plain
    permutation), and the complex measurement API on the QFT result
    against the plane functions. Times (CUDA events, median of REPS after
    a warm-up): ``apply_ops`` whole, its host planning apart (host clock),
    its sweeps alone and summed by kind (kernel windows, cross-pair and
    row-pair swaps, each sweep timed alone), the split and the join, the
    same pipeline through
    ``CompiledCircuit.run`` (fused, swaps relabelled), and the lane
    ``apply_op`` by part. Returns the launch and step-kind totals of the
    counted runs."""
    import numpy as np
    import torch

    from rustqip_tpu_torch.algos import qfft
    from rustqip_tpu_torch.builder.builder import _lower_item
    from rustqip_tpu_torch.engine import apply_op, apply_ops, compile_pipeline
    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.admission import HOPPER
    from rustqip_tpu_torch.engine.apply import _dense_plan, _join, _mat_key, _split, _swap_schedule
    from rustqip_tpu_torch.engine.real_apply import compile_sweeps, run_sweeps
    from rustqip_tpu_torch.engine.row_swap import row_swap_reference
    from rustqip_tpu_torch.ops import MeasuredCondition, measure, measure_probs, prob_magnitude
    from rustqip_tpu_torch.ops.matrix_ops import SwapOp, make_matrix_op, make_swap_op
    from rustqip_tpu_torch.ops.measurement_ops import measure_probs_ri, measure_ri, measure_state_ri
    from rustqip_tpu_torch.prelude import LocalBuilder

    n = N_MAIN
    total, kinds = Counter(), Counter()

    def counted(fn):
        """``fn()`` with every launch count zeroed just before and read just
        after (a main-path run: added to the totals)."""
        torch.cuda.synchronize()
        reset_launches()
        out = fn()
        torch.cuda.synchronize()
        launches = read_launches()
        total.update(launches)
        kinds.update(wk.KIND_LAUNCHES)
        return out, launches

    def diff(c, re, im):
        """max |c - (re + i im)| of a flat complex state and (R, C) planes."""
        c = c.reshape(re.shape)
        return max((c.real - re).abs().max().item(), (c.imag - im).abs().max().item())

    def host_ms(fn):
        times = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(times)

    g = torch.Generator(device="cuda")
    g.manual_seed(2028)
    state = torch.randn(1 << n, dtype=torch.complex64, device="cuda", generator=g)
    state /= torch.linalg.vector_norm(state)
    keep = state.clone()
    b = LocalBuilder(dtype="f32", device="cuda")
    qfft(b, b.register(n))
    entries = [e for item in b.pipeline for e in _lower_item(item)]
    ops = [e.op for e in entries]
    plan = compile_sweeps(n, ops, True, HOPPER)
    kwindows = sum(k == "kwindow" for k, _, _ in plan)
    row_swaps = sum(isinstance(op, SwapOp) and bool(_swap_schedule(n, op)[1]) for op in ops)

    # (1) QFT-28's op list through apply_ops, against the plain path
    out, launches = counted(lambda: apply_ops(n, ops, state))
    if not torch.equal(state, keep):
        raise AssertionError("state API: apply_ops wrote its input")
    if not (launches["window_sweep"] == kwindows > 0 and launches["row_swap"] == row_swaps > 0):
        raise AssertionError(f"state API: launches {launches}, want {kwindows} window and "
                             f"{row_swaps} row-swap launches")
    plain_plan = compile_sweeps(n, ops, False, HOPPER)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    pr, pi = run_sweeps(n, plain_plan, *_split(n, state, None), low_kernel=False,
                        swap_kernel=False)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    if any(read_launches().values()):
        raise AssertionError(f"state API: the plain path launched {read_launches()}")
    err = diff(out, pr, pi)
    del pr, pi
    norm_err = abs(float(prob_magnitude(out)) - 1.0)
    if err > E2E_TOL or norm_err > E2E_TOL:
        raise AssertionError(f"state API: apply_ops vs plain max|diff| {err}, "
                             f"|norm - 1| {norm_err}")
    row = {"phase": "state_api", "n": n, "dtype": "complex64", "ops": len(ops),
           "kwindow_sweeps": kwindows, "plain_plan_sweeps": len(plain_plan),
           "apply_ops_launches": launches, "apply_ops_vs_plain_max_abs_diff": err,
           "input_bit_equal": True, "norm_err": norm_err, "plain_path_host_ms": plain_ms}
    row["apply_ops_ms"] = cuda_ms(lambda: apply_ops(n, ops, state))
    row["plan_host_ms"] = host_ms(lambda: compile_sweeps(n, ops, True, HOPPER))
    sweeps = compile_sweeps(n, ops, True, HOPPER, "cuda")
    re, im = _split(n, state, None)
    row["sweeps_ms"] = cuda_ms(lambda: run_sweeps(n, sweeps, re, im))
    parts = Counter()
    for sweep in sweeps:
        kind, op = sweep[0], sweep[2][0]
        if kind == "op" and isinstance(op, SwapOp):
            cross, rowp, _, _ = _swap_schedule(n, op)
            kind = "cross_swap" if cross else "row_swap" if rowp else "other_swap"
        parts[kind] += cuda_ms(lambda: run_sweeps(n, [sweep], re, im))
    row["sweeps_ms_by_kind"] = dict(parts)
    row["split_ms"] = cuda_ms(lambda: _split(n, state, None))
    row["join_ms"] = cuda_ms(lambda: _join(re, im))
    del re, im
    torch.cuda.empty_cache()
    cc = compile_pipeline(n, entries, np.complex64, device="cuda")
    row["compiled_run_ms"] = cuda_ms(lambda: cc.run(0))
    row["compiled_sweeps"] = cc.sweep_counts()

    # (2) a dense op on the lane qubits: one c64_low_matmul launch
    rng = np.random.default_rng(26)
    u = np.linalg.qr(rng.normal(size=(4, 4)) + 1j * rng.normal(size=(4, 4)))[0]
    lane = make_matrix_op([n - 2, n - 1], u.reshape(-1))
    lane_out, launches = counted(lambda: apply_op(n, lane, state))
    if launches != {"window_sweep": 1, "window_stream": 0, "row_swap": 0, "plane_copy": 0}:
        raise AssertionError(f"state API: lane apply_op launched {launches}")
    B = _dense_plan(n, lane.indices, _mat_key(lane.data))[1]
    re, im = _split(n, state, None)
    err_lane = diff(lane_out, *wk.c64_low_matmul(re, im, B, kernel=False))
    del lane_out
    if err_lane > KERNEL_TOL or not torch.equal(state, keep):
        raise AssertionError(f"state API: lane apply_op vs plain max|diff| {err_lane}")
    prog = wk._low_program(re.shape[0], B)
    row.update({
        "lane_apply_op_launches": launches, "lane_vs_plain_max_abs_diff": err_lane,
        "lane_apply_op_ms": cuda_ms(lambda: apply_op(n, lane, state)),
        "lane_c64_low_matmul_ms": cuda_ms(lambda: wk.c64_low_matmul(re, im, B)),
        "lane_kernel_in_place_ms": cuda_ms(lambda: wk.window_sweep(
            n, re, im, prog.seg_sizes, [("low", B)], prog=prog)),
        "lane_plain_matmul_ms": cuda_ms(lambda: wk.c64_low_matmul(re, im, B, kernel=False)),
    })
    del re, im
    torch.cuda.empty_cache()

    # (3) a SwapOp of seven row pairs: one row_swap launch, exact
    pairs = [(q, n - 1 - q) for q in range(n // 2) if n - 1 - q < n - 7]  # QFT's row field
    swap = make_swap_op(*zip(*pairs))
    sw_out, launches = counted(lambda: apply_op(n, swap, state))
    if launches != {"window_sweep": 0, "window_stream": 0, "row_swap": 1, "plane_copy": 0}:
        raise AssertionError(f"state API: row-pair SwapOp launched {launches}")
    if not torch.equal(sw_out, _join(*row_swap_reference(n, pairs, *_split(n, state, None)))):
        raise AssertionError("state API: row-pair SwapOp differs from the plain permutation")
    del sw_out
    row["swap_apply_op_launches"] = launches
    row["swap_apply_op_ms"] = cuda_ms(lambda: apply_op(n, swap, state))
    torch.cuda.empty_cache()

    # (4) the complex measurement API on the QFT result, against the planes
    re, im = _split(n, out, None)
    probs = measure_probs(n, API_MEASURED, out)
    probs_ri = measure_probs_ri(n, API_MEASURED, re, im)
    # about 2^-24 an outcome: the limit is relative to the largest
    err_probs = ((probs - probs_ri).abs().max() / probs_ri.max()).item()
    m = int(torch.argmax(probs_ri))
    outcome, prob, col = measure(n, API_MEASURED, out, measured=MeasuredCondition(m))
    err_col = diff(col, *measure_state_ri(n, API_MEASURED, (m, float(probs_ri[m])), re, im))
    col_norm_err = abs(float(prob_magnitude(col)) - 1.0)
    del col
    draws = []
    for seed in (1, 2, 3):
        g1, g2 = torch.Generator(), torch.Generator()
        g1.manual_seed(seed)
        g2.manual_seed(seed)
        draws.append((measure(n, API_MEASURED, out, generator=g1)[0],
                      measure_ri(n, API_MEASURED, re, im, generator=g2)[0]))
    if err_probs > KERNEL_TOL or err_col > KERNEL_TOL or col_norm_err > E2E_TOL \
            or outcome != m or any(x != y for x, y in draws):
        raise AssertionError(f"state API measurement: probs {err_probs}, collapse {err_col}, "
                             f"|norm - 1| {col_norm_err}, draws {draws}")
    row.update({"measured_qubits": len(API_MEASURED), "probs_vs_planes_max_rel_diff": err_probs,
                "forced_outcome": m, "forced_prob": prob, "collapse_vs_planes_max_abs_diff": err_col,
                "collapse_norm_err": col_norm_err, "seeded_draws": [x for x, _ in draws],
                "measure_probs_ms": cuda_ms(lambda: measure_probs(n, API_MEASURED, out))})
    del re, im, out, probs, probs_ri, state, keep
    torch.cuda.empty_cache()
    emit(row)
    return total, kinds


FLOAT = r"[-+]?(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?"
# phase_examples' twins, in the order they run; the two float32 twins at
# n >= 12 must launch the window kernel
EXAMPLES = ("simple", "inverse_example", "invert_fn_example", "macro_example",
            "phase_estimation_example", "shor_example", "grover_example",
            "teleport_qasm_example", "traced_oracle_example", "sharded_example")
EXAMPLES_ON_THE_KERNEL = ("grover_example", "traced_oracle_example")


def _printed(pattern, out, name):
    """The groups of every match of ``pattern`` in a twin's stdout; a twin
    that printed no match fails."""
    import re

    found = re.findall(pattern, out, re.M)
    if not found:
        raise AssertionError(f"examples {name}: {pattern!r} not in its output {out!r}")
    return found


def _close(name, what, got, want, tol):
    if not abs(got - want) <= tol:
        raise AssertionError(f"examples {name}: {what} {got}, want {want} within {tol}")


def check_example(name, out, values):
    """Hold one twin's printed lines and its returned (unrounded) values to
    the closed form, or to its original's value where the run draws: each
    printed value must be the returned one at the printed precision.
    Returns the values the ``examples`` row reports."""
    import math
    import re

    import numpy as np

    if name == "simple":
        ((outcome, chance),) = _printed(rf"^Measured: ([01]) \(with chance ({FLOAT})\)$", out, name)
        _close(name, "chance", values["chance"], 0.5, KERNEL_TOL)
        _close(name, "printed chance", float(chance), values["chance"], 0.0)
        return {"outcome": int(outcome), "chance": values["chance"]}
    if name == "inverse_example":
        s = 2 ** -0.5
        state = [complex(float(a), float(b.replace(" ", ""))) for a, b in _printed(
            rf"({FLOAT})\s*([-+]\s*(?:\d+\.?\d*|\.\d+)(?:[eE][-+]?\d+)?)j", out, name)]
        probs = [float(x) for x in re.findall(FLOAT, out.strip().splitlines()[-1])]
        for what, got, printed, want in (("state", values["state"], state, [s, 0, 0, s]),
                                         ("probs", values["probs"], probs, [0.5, 0, 0, 0.5])):
            _close(name, what, float(np.abs(np.asarray(got) - want).max()), 0.0, KERNEL_TOL)
            _close(name, "printed " + what, float(np.abs(np.asarray(got) - printed).max()),
                   0.0, 1e-7)
        return {"state_err": float(np.abs(values["state"] - np.array([s, 0, 0, s])).max()),
                "probs": [float(p) for p in values["probs"]]}
    if name == "invert_fn_example":
        (index,) = _printed(r"amplitude stayed on the init state: (\d+)$", out, name)
        if int(index) != values["index"] or values["index"] != 42:
            raise AssertionError(f"examples {name}: index {index}, want 42")
        return values
    if name == "macro_example":
        ((depth, norm),) = _printed(rf"^pipeline depth: (\d+)\nnorm: ({FLOAT})$", out, name)
        if int(depth) != values["depth"] or values["depth"] != 117:
            raise AssertionError(f"examples {name}: depth {depth}, want 117")
        _close(name, "norm", values["norm"], 1.0, KERNEL_TOL)
        _close(name, "printed norm", float(norm), values["norm"], 0.0)
        return values
    if name == "phase_estimation_example":
        ((phase, certainty),) = _printed(
            rf"^estimated phase: ({FLOAT}) \(certainty ({FLOAT})\)$", out, name)
        if not float(phase) == values["phase"] == 21 / 64:
            raise AssertionError(f"examples {name}: phase {phase}, want 21/64")
        _close(name, "certainty", values["certainty"], 1.0, 1e-10)
        _close(name, "printed certainty", float(certainty), values["certainty"], 5e-7)
        return values
    if name == "shor_example":
        ((period, p, q),) = _printed(
            r"^period of 7 mod 15: (\d+)\nfactor\(15\): \((\d+), (\d+)\)$", out, name)
        if (int(period), (int(p), int(q))) != (values["period"], values["factors"]) \
                or values["period"] != 4 or values["factors"] != (3, 5):
            raise AssertionError(f"examples {name}: {values}, want 4 and (3, 5)")
        return {"period": values["period"], "factors": list(values["factors"])}
    if name == "grover_example":
        marked = 0b101101011001
        printed = _printed(rf"found=(0b[01]+) p=({FLOAT})$", out, name)
        passes = [int(x) for x in _printed(r"^fused passes: (\d+) ", out, name)]
        for (found, p), f, pv in zip(printed, values["found"], values["p"]):
            if not int(found, 2) == f == marked or pv < 0.999:
                raise AssertionError(f"examples {name}: found {found} at p {pv}, "
                                     f"want {marked:#014b} at p >= 0.999")
            _close(name, "printed p", float(p), pv, 5e-5)
        if len(printed) != 2 or passes != [s.fused_passes for s in values["stats"]]:
            raise AssertionError(f"examples {name}: printed {printed}, passes {passes}")
        return {"p": list(values["p"]), "fused_passes": passes}
    if name == "teleport_qasm_example":
        rows = _printed(rf"^seed=(\d): outcomes=\(([01]),([01])\) "
                        rf"teleported fidelity=({FLOAT})$", out, name)
        if len(rows) != 4:
            raise AssertionError(f"examples {name}: {len(rows)} seeds printed, want 4")
        for (_, m0, m1, fid), (v0, v1, vf) in zip(rows, values["runs"]):
            if (int(m0), int(m1)) != (v0, v1) or vf < 1 - KERNEL_TOL:
                raise AssertionError(f"examples {name}: outcomes ({m0},{m1}) at fidelity {vf}")
            _close(name, "printed fidelity", float(fid), vf, 5e-11)
        return {"outcomes": [[v0, v1] for v0, v1, _ in values["runs"]],
                "fidelity": [vf for _, _, vf in values["runs"]]}
    if name == "traced_oracle_example":
        ((x, p),) = _printed(rf"^solution x = (0x[0-9a-f]+); p = ({FLOAT}) ", out, name)
        want = math.sin(7 * math.asin(2.0 ** -11)) ** 2
        if not int(x, 16) == values["x"] == 0x1B6070:
            raise AssertionError(f"examples {name}: x {x}, want 0x1b6070")
        _close(name, "p / closed form", values["p"] / want, 1.0, 1e-4)
        _close(name, "printed p / p", float(p) / values["p"], 1.0, 5e-4)
        return {"x": values["x"], "p": values["p"], "want": want}
    if name == "sharded_example":
        ((mesh, qubits),) = _printed(r"^devices: 1, mesh: (\d+), qubits: (\d+)$", out, name)
        rows = _printed(rf"^ *(gspmd|explicit): state split into (\d+) shard\(s\) on 1 "
                        rf"device\(s\); norm = ({FLOAT}); top outcome p = ({FLOAT})$", out, name)
        if (int(mesh), int(qubits)) != (8, 7) or [r[0] for r in rows] != ["gspmd", "explicit"] \
                or any(int(r[1]) != 8 for r in rows):
            raise AssertionError(f"examples {name}: mesh {mesh}, qubits {qubits}, rows {rows}")
        for strategy, _, norm, top in rows:
            v = values[strategy]
            _close(name, f"{strategy} norm", v["norm"], 1.0, KERNEL_TOL)
            _close(name, f"{strategy} top p", v["top_p"], 1 / 64, KERNEL_TOL)
            _close(name, f"{strategy} printed norm", float(norm), v["norm"], 5e-7)
            _close(name, f"{strategy} printed top p", float(top), v["top_p"], 5e-5)
        return {s: values[s] for s in ("gspmd", "explicit")}
    raise KeyError(name)


def phase_examples(smi):
    """The ten example programs' port twins (``rustqip_tpu_torch/examples``)
    on the card: each ``main()`` with its default device, twice (a first
    and a warm call; host clock after a CUDA synchronise), its stdout
    captured and held by ``check_example``. The launch counts are zeroed
    just before and read just after each call; the first call's go to the
    totals, and Grover-12 and the traced oracle at N = 22 must launch the
    window kernel. One ``examples`` row per twin. Returns the launch and
    step-kind totals."""
    import contextlib
    import importlib
    import io

    import torch

    from rustqip_tpu_torch.engine import window_kernel as wk

    total, kinds = Counter(), Counter()
    for name in EXAMPLES:
        mod = importlib.import_module(f"rustqip_tpu_torch.examples.{name}")
        calls = []
        for _ in ("first", "warm"):
            buf = io.StringIO()
            torch.cuda.synchronize()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                values = mod.main()
            torch.cuda.synchronize()
            ms = (time.perf_counter() - t0) * 1e3
            calls.append((ms, read_launches(), dict(wk.KIND_LAUNCHES),
                          check_example(name, buf.getvalue(), values)))
        (first_ms, launches, kind_launches, checked), (warm_ms, warm_launches, _, _) = calls
        if name in EXAMPLES_ON_THE_KERNEL and not launches["window_sweep"]:
            raise AssertionError(f"examples {name}: no window kernel launch ({launches})")
        total.update(launches)
        kinds.update(kind_launches)
        emit({"phase": "examples", "example": name, "first_ms": first_ms, "warm_ms": warm_ms,
              "launches": launches, "warm_launches": warm_launches, "checked": checked,
              "nvidia_smi": smi})
    return total, kinds


def phase_window_breakdown(ccs):
    """Each kernel window of QFT-28, the gate-form Grover-28 iteration,
    QPE-28 and Shor-28 alone, on a seeded random state: kernel time (median of
    REPS, CUDA events), device-memory bytes it must move (live strips read
    + written, both planes) and the rate that implies. A window on the
    register-streaming path is also timed on the tile path, in turns
    (tile, registers, registers, tile), and checked on both. QFT-28's
    windows are also run through the plain version, for the kernels line;
    ``stream`` sums QFT-28's register-path windows alone."""
    import torch

    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.utils import observe

    n = N_MAIN
    g = torch.Generator(device="cuda")
    g.manual_seed(14)
    x = torch.randn((2, 1 << (n - 7), 128), generator=g, device="cuda")
    x /= x.norm()
    kms = pms = 0.0
    worst = 0.0
    bound = {"bytes": 0.0, "operations": 0.0}  # QFT-28's windows, by what bounds each
    stream = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "tile_ms": 0.0}
    slower = []  # register-path windows slower than on the tile path
    for name in ("qft28", "grover28_iteration_gate", "qpe28", "shor28"):
        if name not in ccs:
            continue
        windows = []
        for info, plan in observe.sweep_plans(ccs[name]):
            if info["kernel"]:
                sg, ksteps, prog = plan[0][1]
                tile = tile_twin(prog)
                kr, ki = x[0].clone(), x[1].clone()
                turns = [cuda_ms(lambda: wk.window_sweep(n, kr, ki, sg, ksteps, prog=p))
                         for p in ((tile, prog, prog, tile) if tile else (prog,))]
                ms = min(turns[1:3]) if tile else turns[0]
                strip_bytes = (x.shape[1] >> prog.h) * 128 * 4 * 2
                moved = (bin(prog.in_mask).count("1") + bin(prog.out_mask).count("1")) * strip_bytes
                bound_ms, bound_by = window_bound(prog, n)
                row = {"h": prog.h, "path": prog.path, "tile_rows": prog.bt,
                       "steps": prog.nsteps, "kinds": list(prog.kinds),
                       "smem_bytes": prog.smem_bytes, "ms": ms, "bytes": moved,
                       "GB_per_s": moved / ms / 1e6, "bound_ms": bound_ms, "bound_by": bound_by}
                if tile:
                    row["tile_ms"] = min(turns[0], turns[3])
                    row["turns_ms"] = turns
                    if row["tile_ms"] < ms:
                        slower.append([name, len(windows), ms, row["tile_ms"]])
                if name == "qft28":
                    pr, pi = x[0].clone(), x[1].clone()
                    wk.window_sweep_reference(n, pr, pi, sg, ksteps, prog=prog)
                    for p in filter(None, (prog, tile)):
                        kr, ki = x[0].clone(), x[1].clone()
                        wk.window_sweep(n, kr, ki, sg, ksteps, prog=p)
                        torch.cuda.synchronize()
                        worst = max(worst, (kr - pr).abs().max().item(),
                                    (ki - pi).abs().max().item())
                    row["plain_ms"] = cuda_ms(
                        lambda: wk.window_sweep_reference(n, pr, pi, sg, ksteps, prog=prog))
                    kms += ms
                    pms += row["plain_ms"]
                    bound[bound_by] += bound_ms
                    if tile:
                        stream["ms"] += ms
                        stream["plain_ms"] += row["plain_ms"]
                        stream["bound_ms"] += bound_ms
                        stream["tile_ms"] += row["tile_ms"]
                    del pr, pi
                del kr, ki
                windows.append(row)
        emit({"phase": "window_breakdown", "circuit": name,
              "kernel_ms_sum": sum(w["ms"] for w in windows),
              "tile_path_ms_sum": sum(w.get("tile_ms", w["ms"]) for w in windows),
              "windows": windows})
    if worst > E2E_TOL:
        raise AssertionError(f"QFT-28 windows: kernel vs plain max|diff| {worst}")
    emit({"phase": "register_path_vs_tile", "slower_windows": slower})
    return kms, pms, worst, bound, stream


def phase_step_breakdown(ccs):
    """One window per redesigned step kind, alone, at n = 28 on a seeded
    state, and the element-wise h = 4 windows of QFT-28 and Grover-28 (a
    whole window, one of its mix and diag steps alone, mix-only windows
    with 16 and 1 nonzeros per output strip), and the tile path's windows
    (QFT-28's h = 0 lane ladder whole, each of its step kinds alone, its
    butterflies, its diags, its last two steps and the ladder without its
    ``low``; Grover-28's h = 2 lane window of 8-row tiles and
    its diffusion ``rmix``; a lone ``low`` with a complex B and a lone
    ``lowr``, and ``c64_low_matmul`` through its wrapper): kernel ms (CUDA events,
    median of REPS after a warm-up; a register-path window also on the
    tile path, in turns), the plain version's ms, the bound, and the one
    PyTorch call that computes the same function where there is one (timed
    here, used nowhere in the port). Kernel vs plain is checked on every
    row and path."""
    import numpy as np
    import torch

    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.admission import window_seg_sizes
    from rustqip_tpu_torch.engine.parity_windows import (
        rand_u,
        real_orthogonal,
        step_windows,
    )

    n = N_MAIN
    R = 1 << (n - 7)
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    x = torch.randn((2, R, 128), generator=g, device="cuda")
    x /= x.norm()
    steps = {w[0]: w for w in step_windows(n)}
    B = rand_u(7, 61)
    Br = real_orthogonal(63)

    def n_mats(p):
        return sum(1 for st in p[1] if st[0] == "rmix"
                   for b in st[1].values() if b[0] != "scalar")

    # the Grover diffusion corner: its rmix window with the most matrix blocks
    grover_rmix = max((p for seg in ccs["grover28_iteration_gate"].sweeps
                       for k, p, _ in seg if k == "kwindow"), key=n_mats)

    def lone(name):
        _, hq, ksteps, _ = steps[name]
        return tuple(window_seg_sizes(n, hq)), ksteps

    def kwindows(name):
        return [p for seg in ccs[name].sweeps for k, p, _ in seg if k == "kwindow"]

    def mix_nonzeros(step, ns):
        return max(sum(step[1].get((j, i), 0) != 0 for i in range(ns)) for j in range(ns))

    def mix_only(nonzeros):
        """The first mix-only h = 4 window of Grover-28 (gate form) whose
        mix has ``nonzeros`` nonzeros in its fullest output strip."""
        return next(p for p in kwindows("grover28_iteration_gate")
                    if p[2].h == 4 and set(p[2].kinds) == {"mix"}
                    and mix_nonzeros(p[1][0], 16) == nonzeros)

    qft_seg, qft_steps, qft_prog = next(p for p in kwindows("qft28") if p[2].h == 4)
    dense = mix_only(16)
    top = tuple(window_seg_sizes(n, (0, 1, 2, 3)))  # strips = the top row bits
    # the tile path's windows: QFT-28's h = 0 lane ladder, each of its step
    # kinds alone, and Grover-28's h = 2 lane window (8-row tiles)
    lad_seg, lad_steps, lad_prog = next(p for p in kwindows("qft28") if p[2].h == 0)

    def ladder_step(kind, bit=None):
        return [next(s for s in lad_steps if s[0] == kind and (bit is None or s[1] == bit))]

    grover_lane = next(p for p in kwindows("grover28_iteration_gate")
                       if p[2].h == 2 and [s[0] for s in p[1]] == ["mix", "rbf", "rbf", "rbf", "low"])
    cases = [
        ("low_c64_low_matmul", (R,), [("low", B)], None),
        ("lowr_h0", (R,), [("low", Br)], None),
        ("rmix_grover_diffusion", *grover_rmix),
        ("qft28_lane_ladder", lad_seg, lad_steps, lad_prog),
        ("qft28_ladder_rbf0_alone", lad_seg, ladder_step("rbf", 0), None),
        ("qft28_ladder_rbf6_alone", lad_seg, ladder_step("rbf", 6), None),
        ("qft28_ladder_diag_alone", lad_seg, ladder_step("diag"), None),
        ("qft28_ladder_cbf_alone", lad_seg, ladder_step("cbf"), None),
        ("qft28_ladder_low_alone", lad_seg, ladder_step("low"), None),
        ("qft28_ladder_without_low", lad_seg, [s for s in lad_steps if s[0] != "low"], None),
        ("qft28_ladder_cbf_low", lad_seg, lad_steps[-2:], None),
        ("qft28_ladder_butterflies_only", lad_seg,
         [s for s in lad_steps if s[0] in ("rbf", "cbf")], None),
        ("qft28_ladder_diags_only", lad_seg, [s for s in lad_steps if s[0] == "diag"], None),
        ("grover28_h2_lane_window", *grover_lane),
        ("diag_qft_cp_fan", *lone("diag_cp_fan"), None),
        ("diag_many_groups", *lone("diag_many_groups"), None),
        # the window kernel's element-wise h = 4 windows
        ("qft28_h4_window", qft_seg, qft_steps, qft_prog),
        ("qft28_h4_mix_alone", qft_seg,
         [next(s for s in qft_steps if s[0] == "mix")], None),
        ("qft28_h4_diag_alone", qft_seg,
         [next(s for s in qft_steps if s[0] == "diag")], None),
        ("grover28_mix16_window", *dense),
        ("grover28_mix1_window", *mix_only(1)),
        ("mix16_top_row_bits", top, dense[1], None),
        # a dense mix that does not factor per window bit (the register
        # path's term loops, not butterflies), as QPE-28's inverse-QFT head
        ("mix16_unfactored_top_row_bits", top,
         [("mix", {(j, i): complex(v) for (j, i), v in np.ndenumerate(rand_u(4, 64))})], None),
    ]
    worst = 0.0
    mix_library = None
    lane_matmul = None
    for name, seg, ksteps, prog in cases:
        if prog is None:
            prog = wk.encode_window(n, seg, ksteps)
        tile = tile_twin(prog)
        pr, pi = x[0].clone(), x[1].clone()
        wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
        diff = 0.0
        for p in filter(None, (tile, prog)):
            kr, ki = x[0].clone(), x[1].clone()
            wk.window_sweep(n, kr, ki, seg, ksteps, prog=p)
            torch.cuda.synchronize()
            diff = max(diff, (kr - pr).abs().max().item(), (ki - pi).abs().max().item())
        if diff > KERNEL_TOL:
            raise AssertionError(f"step {name}: kernel vs plain max|diff| {diff}")
        worst = max(worst, diff)
        # tile, registers, registers, tile: the two paths in turns
        ms = [cuda_ms(lambda: wk.window_sweep(n, kr, ki, seg, ksteps, prog=p))
              for p in ((tile, prog, prog, tile) if tile else (prog,))]
        plain_ms = cuda_ms(lambda: wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog))
        del pr, pi
        bound_ms, bound_by = window_bound(prog, n)
        row = {"phase": "step_breakdown", "step": name, "n": n, "h": prog.h,
               "path": prog.path, "tile_rows": prog.bt, "smem_bytes": prog.smem_bytes,
               "kinds": list(prog.kinds), "ms": min(ms[1:3]) if tile else ms[0],
               "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
               "library_ms": None, "max_abs_diff": diff}
        row["bound_share"] = bound_ms / row["ms"]
        if tile:
            row["tile_ms"] = min(ms[0], ms[3])
            row["turns_ms"] = ms
        if name == "low_c64_low_matmul":
            # the user-facing function (it reads its input, writes fresh planes)
            row["c64_low_matmul_ms"] = cuda_ms(lambda: wk.c64_low_matmul(kr, ki, B))
            lane_matmul = row
        if len(ksteps) == 1 and ksteps[0][0] == "low" and prog.h == 0:
            # one lane matrix on every row: one torch.matmul, complex64 for
            # a complex B, float32 over both planes for a real one
            Bl = np.asarray(ksteps[0][1])
            if np.any(np.imag(Bl)):
                xc = torch.complex(kr, ki)
                bc = torch.as_tensor(np.ascontiguousarray(Bl.T), dtype=torch.complex64,
                                     device="cuda")
                row["library_ms"] = cuda_ms(lambda: torch.matmul(xc, bc))
                row["library_call"] = "torch.matmul complex64 (R,128)@(128,128), full fp32"
            else:
                xc = torch.cat([kr, ki])
                bc = torch.as_tensor(np.ascontiguousarray(np.real(Bl).T), dtype=torch.float32,
                                     device="cuda")
                row["library_ms"] = cuda_ms(lambda: torch.matmul(xc, bc))
                row["library_call"] = "torch.matmul float32 (2R,128)@(128,128), full fp32"
            del xc, bc
        elif name in ("mix16_top_row_bits", "mix16_unfactored_top_row_bits"):
            (mix,) = ksteps
            m = torch.tensor([[complex(mix[1].get((j, i), 0)) for i in range(16)]
                              for j in range(16)], dtype=torch.complex64, device="cuda")
            xc = torch.complex(kr, ki).view(16, -1)
            row["library_ms"] = cuda_ms(lambda: torch.matmul(m, xc))
            row["library_call"] = "torch.matmul complex64 (16,16)@(16,R/16*128), full fp32"
            if name == "mix16_top_row_bits":
                mix_library = {"ms": row["ms"], "library_ms": row["library_ms"]}
            del xc
        del kr, ki
        torch.cuda.empty_cache()
        emit(row)
    lane_matmul = {k: lane_matmul[k] for k in ("ms", "c64_low_matmul_ms", "plain_ms", "bound_ms",
                                               "library_ms")}
    return worst, mix_library, lane_matmul


def _field(n_m, pairs):
    """(pre, span) when the row pairs reverse one contiguous field of row
    qubits (any span), else None."""
    qubits = sorted(q for p in pairs for q in p)
    lo, hi = qubits[0], qubits[-1]
    span = hi - lo + 1
    if {tuple(sorted(p)) for p in pairs} != {(lo + t, hi - t) for t in range(span // 2)}:
        return None
    return 1 << lo, span


def phase_swap_breakdown(ccs):
    """The swap pass at the end of QFT-28, QPE-28 and Shor-28, by part, on
    a seeded random state: the row-swap kernel (ms, bound by bytes), its
    plain version (``_row_swap_planes``), the one ``reshape -> permute ->
    contiguous`` that computes the same field reversal (the library call,
    both planes stacked), the cross-pair part's plain passes, and the whole
    ``SwapOp`` through ``apply_op_ri``. Kernel and plain are checked equal."""
    import torch

    from rustqip_tpu_torch.engine import row_swap
    from rustqip_tpu_torch.engine.apply import _cross_swap_planes, _swap_schedule
    from rustqip_tpu_torch.engine.real_apply import apply_op_ri
    from rustqip_tpu_torch.ops.matrix_ops import SwapOp

    n = N_MAIN
    n_m = n - 7
    R, C = 1 << n_m, 128
    g = torch.Generator(device="cuda")
    g.manual_seed(19)
    x = torch.randn((2, R, C), generator=g, device="cuda")
    x /= x.norm()
    totals = {"ms": 0.0, "plain_ms": 0.0, "bound_ms": 0.0, "library_ms": 0.0}
    for name in ("qft28", "qpe28", "shor28"):
        swaps = [p for seg in ccs[name].sweeps if isinstance(seg, list)
                 for k, p, _ in seg if k == "op" and isinstance(p, SwapOp)]
        if len(swaps) != 1:
            raise AssertionError(f"{name}: {len(swaps)} swap passes, want 1")
        op = swaps[0]
        cross, rowp, colp, mixed = _swap_schedule(n, op)
        kr, ki = row_swap.row_swap(n, rowp, x[0].clone(), x[1].clone())
        pr, pi = row_swap.row_swap_reference(n, rowp, x[0], x[1])
        torch.cuda.synchronize()
        if not (torch.equal(kr, pr) and torch.equal(ki, pi)):
            raise AssertionError(f"{name}: row_swap kernel differs from the plain version")
        del pr, pi
        field = _field(n_m, rowp)
        library_ms = None
        if field is not None and field[1] + 4 <= 25:
            pre, span = field
            shape = (2, pre) + (2,) * span + (R // (pre << span), C)
            perm = (0, 1) + tuple(range(span + 1, 1, -1)) + (span + 2, span + 3)
            lib = x.reshape(shape).permute(perm).contiguous().reshape(2, R, C)
            if not (torch.equal(lib[0], kr) and torch.equal(lib[1], ki)):
                raise AssertionError(f"{name}: the library permute differs from the kernel")
            del lib
            library_ms = cuda_ms(lambda: x.reshape(shape).permute(perm).contiguous())
        ms = cuda_ms(lambda: row_swap.row_swap(n, rowp, kr, ki))
        plain_ms = cuda_ms(lambda: row_swap.row_swap_reference(n, rowp, x[0], x[1]))
        moved = 2 * 2 * rows_moved(n, rowp) * C * 4
        bound_ms = moved / HBM_BYTES_PER_S * 1e3
        cross_ms = (cuda_ms(lambda: _cross_swap_planes(n, cross, [x[0], x[1]]))
                    if cross else 0.0)
        del kr, ki
        buf = (x[0].clone(), x[1].clone())
        op_ms = cuda_ms(lambda: apply_op_ri(n, op, *buf))
        del buf
        torch.cuda.empty_cache()
        row = {"phase": "swap_breakdown", "circuit": name, "n": n,
               "cross_pairs": cross, "row_pairs": rowp, "col_pairs": colp,
               "dense_pairs": mixed, "row_field": field,
               "rows_moved": rows_moved(n, rowp), "bytes": moved,
               "ms": ms, "GB_per_s": moved / ms / 1e6, "bound_ms": bound_ms,
               "bound_by": "bytes", "bound_share": bound_ms / ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "library_call": "reshape -> permute -> contiguous on (2, R, 128)",
               "cross_plain_ms": cross_ms, "swap_op_ms": op_ms}
        emit(row)
        for k in totals:
            totals[k] += row[k] or 0.0
    return totals


def phase_circuit_breakdown(ccs):
    """Every sweep of the kernel-path plans of QPE-28, Shor-28, the
    traced-oracle Grover-28, the controlled XOR oracle and the wide sparse
    permutation alone, through ``observe.profile_passes`` (CUDA events; one
    warm-up and one timed run of each sweep, from a seeded random state);
    then each measurement alone on a seeded state: the device ms of its
    probability reduction and, for a collapsing one, the host ms of drawing
    its outcome (``sample_outcome``, host clock)."""
    import torch

    from rustqip_tpu_torch.engine.compile import MeasureEntry
    from rustqip_tpu_torch.ops.measurement_ops import measure_probs_ri, sample_outcome
    from rustqip_tpu_torch.utils import observe

    n = N_MAIN
    g = torch.Generator(device="cuda")
    g.manual_seed(22)
    x = torch.randn((2, 1 << (n - 7), 128), generator=g, device="cuda")
    x /= x.norm()
    for name in ("qpe28", "shor28", "traced_grover28", "controlled_xor_oracle28",
                 "wide_sparse_perm28"):
        cc = ccs[name]
        rows = []
        timed = observe.profile_passes(cc, iters=1, seed=22)
        for (info, plan), row in zip(observe.sweep_plans(cc), timed):
            kind, payload, run = plan[0]
            if kind == "kwindow":
                what = "kwindow h=%d %s" % (payload[2].h, "+".join(payload[2].kinds))
            elif kind == "op":
                what = "op %s on %d qubits" % (info["kind"], len(run[0].indices))
            else:
                what = "window"
            rows.append({"sweep": what, "gates": info["ops"], "ms": row["ms"]})
        for seg in cc.sweeps:
            if not isinstance(seg, MeasureEntry):
                continue
            ms = cuda_ms(lambda: measure_probs_ri(n, seg.indices, x[0], x[1]), reps=1)
            row = {"sweep": f"measure {len(seg.indices)} qubits", "ms": ms}
            if not seg.stochastic:
                probs = measure_probs_ri(n, seg.indices, x[0], x[1])
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sample_outcome(probs, torch.Generator().manual_seed(0))
                row["host_sample_ms"] = (time.perf_counter() - t0) * 1e3
            rows.append(row)
        torch.cuda.empty_cache()
        emit({"phase": "circuit_breakdown", "circuit": name, "n": n,
              "ms_sum": sum(r["ms"] for r in rows), "sweeps": rows})


def phase_copy_floor():
    """One read and one write of the n = 28 float32 plane pair: the copy
    kernel to fresh planes and in place, with 1 and 4 strips of each plane,
    beside ``Tensor.copy_`` (the plain version, per plane) and one
    ``copy_`` of both planes stacked (the library call), and the fresh
    kernel's time over the library call's. Each time is the median of
    REPS runs of COPY_PER calls back to back, so that the host's launch
    time (tens of microseconds through the Python wrapper) is not counted
    as the card's."""
    import torch

    from rustqip_tpu_torch.engine import copy_probe

    n = N_MAIN
    R, C = 1 << (n - 7), 128
    g = torch.Generator(device="cuda")
    g.manual_seed(20)
    x = torch.randn((2, R, C), generator=g, device="cuda")
    y = torch.empty_like(x)
    nbytes = 2 * 2 * R * C * 4
    bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
    out = {"bytes": nbytes, "bound_ms": bound_ms}
    for strips in copy_probe.STRIPS:
        y.zero_()
        copy_probe.plane_copy(x[0], x[1], out=(y[0], y[1]), strips=strips)
        torch.cuda.synchronize()
        if not torch.equal(x, y):
            raise AssertionError(f"plane_copy strips={strips} differs from its input")
        fresh = cuda_ms(lambda: copy_probe.plane_copy(x[0], x[1], out=(y[0], y[1]),
                                                      strips=strips), per=COPY_PER)
        inplace = cuda_ms(lambda: copy_probe.plane_copy(y[0], y[1], out=(y[0], y[1]),
                                                        strips=strips), per=COPY_PER)
        out[f"fresh_strips{strips}_ms"] = fresh
        out[f"inplace_strips{strips}_ms"] = inplace
        out[f"fresh_strips{strips}_GB_per_s"] = nbytes / fresh / 1e6
        out[f"inplace_strips{strips}_GB_per_s"] = nbytes / inplace / 1e6
    if not torch.equal(x, y):
        raise AssertionError("plane_copy in place changed the planes")
    out["plain_ms"] = cuda_ms(lambda: copy_probe.plane_copy_reference(x[0], x[1], out=(y[0], y[1])),
                              per=COPY_PER)
    out["library_ms"] = cuda_ms(lambda: y.copy_(x), per=COPY_PER)
    out["library_GB_per_s"] = nbytes / out["library_ms"] / 1e6
    out["fresh_over_library"] = out["fresh_strips1_ms"] / out["library_ms"]
    out["floor_ms"] = min(v for k, v in out.items() if k.endswith("strips1_ms")
                          or k.endswith("strips4_ms") or k == "library_ms")
    emit({"phase": "copy_floor", "n": n, **out})
    return out


def compile_breakdown_circuits():
    """QFT-28 and Grover-28 (gate form) compiled as ``phase_main`` compiles
    them, not run: the windows the breakdown phases time."""
    from rustqip_tpu_torch.algos import grover_iteration, qfft

    ccs = {}
    b = _builder(True)
    qfft(b, b.register(N_MAIN))
    ccs["qft28"] = b.compile()
    b = _builder(True)
    grover_iteration(b, b.h(b.register(N_MAIN)), GROVER28_MARKED, native_diffusion=False)
    ccs["grover28_iteration_gate"] = b.compile()
    return ccs


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on a GPU",
              file=sys.stderr)
        return 2
    if not (ROOT / "rustqip_tpu_torch" / "csrc" / "window_sweep.cu").exists():
        print("chip_smoke: run from a checkout of the repository "
              "(rustqip_tpu_torch/ not found beside this script)", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    t0 = time.perf_counter()
    smi = phase_env()
    phase_build()
    if sys.argv[1:] == ["--step-breakdown"]:
        # a quick check and measurement: the parity windows, the kernel
        # windows of QFT-28 and Grover-28 and the lone windows of
        # phase_step_breakdown only; no result line
        phase_parity()
        ccs = compile_breakdown_circuits()
        phase_window_breakdown(ccs)
        phase_step_breakdown(ccs)
        return 0
    parity_err = phase_parity()
    swap_err = phase_swap_parity()
    cap_launches, cap_kinds, cap_parts = phase_capacity()
    rows, launches, kind_launches, ccs = phase_main()
    launches = {k: launches[k] + cap_launches[k] for k in launches}
    kind_launches = dict(Counter(kind_launches) + Counter(cap_kinds))
    _, oracle_launches, oracle_kinds, oracle_ccs, g_re, g_im, solution, p_solution = \
        phase_oracles()
    ccs.update(oracle_ccs)
    launches = {k: launches[k] + oracle_launches[k] for k in launches}
    kind_launches = dict(Counter(kind_launches) + oracle_kinds)
    phase_measure(g_re, g_im, solution, p_solution)
    del g_re, g_im
    inter_launches, inter_kinds = phase_interchange()
    launches = {k: launches[k] + inter_launches[k] for k in launches}
    kind_launches = dict(Counter(kind_launches) + inter_kinds)
    shard_launches, shard_kinds = phase_sharded()
    launches = {k: launches[k] + shard_launches[k] for k in launches}
    kind_launches = dict(Counter(kind_launches) + shard_kinds)
    api_launches, api_kinds = phase_state_api()
    launches = {k: launches[k] + api_launches[k] for k in launches}
    kind_launches = dict(Counter(kind_launches) + api_kinds)
    ex_launches, ex_kinds = phase_examples(smi)
    launches = {k: launches[k] + ex_launches[k] for k in launches}
    kind_launches = dict(Counter(kind_launches) + ex_kinds)
    kms, pms, qft_err, bound, stream = phase_window_breakdown(ccs)
    step_err, mix_library, lane_matmul = phase_step_breakdown(ccs)
    swap = phase_swap_breakdown(ccs)
    phase_circuit_breakdown(ccs)
    copy = phase_copy_floor()
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [
        {
            "name": "window_sweep",
            "route": "cuda",
            "source": "rustqip_tpu_torch/csrc/window_sweep.cu",
            "replaces": "rustqip_tpu/engine/pallas_kernels.py:1155",
            "launches": launches["window_sweep"],
            "kind_launches": kind_launches,
            "max_abs_err": max(parity_err, qft_err, step_err),
            "ms": kms,
            "plain_ms": pms,
            "bound_ms": sum(bound.values()),
            "bound_by": max(bound, key=bound.get),
            # QFT-32's seven kernel windows, each alone, at the card's capacity
            "capacity_n32": {"ms": cap_parts["kernel_windows_ms"],
                             "bound_ms": cap_parts["kernel_windows_bound_ms"]},
            # no one PyTorch call computes a window's step chain; the lone
            # matrix steps' library calls are in the step_breakdown rows
            "library_ms": None,
            # c64_low_matmul (R = 2^21, complex B): its window alone, the
            # wrapper, and torch.matmul complex64 of the same product
            "c64_low_matmul": lane_matmul,
        },
        {
            # the register-streaming path of the same kernel (its launches
            # are also in window_sweep's): ms, plain_ms, bound_ms are
            # QFT-28's register-path windows (h = 4 and h = 1), each alone,
            # summed; tile_ms the same windows on the tile path in turns;
            # library_ms one torch.matmul of a dense h = 4 mix on the top
            # row bits, beside that window's own ms (step_breakdown)
            "name": "window_stream",
            "route": "cuda",
            "source": "rustqip_tpu_torch/csrc/window_stream.cu",
            "replaces": "rustqip_tpu/engine/pallas_kernels.py:1155",
            "launches": launches["window_stream"],
            "max_abs_err": max(parity_err, qft_err, step_err),
            "ms": stream["ms"],
            "plain_ms": stream["plain_ms"],
            "bound_ms": stream["bound_ms"],
            "bound_by": "bytes",
            "tile_ms": stream["tile_ms"],
            "library_ms": mix_library["library_ms"],
            "library_window_ms": mix_library["ms"],
        },
        {
            # ms, plain_ms, bound_ms, library_ms: the row parts of the swap
            # passes of QFT-28, QPE-28 and Shor-28, summed
            "name": "row_swap",
            "route": "cuda",
            "source": "rustqip_tpu_torch/csrc/row_swap.cu",
            "replaces": "scripts/field_reversal_probe.py:105",
            "launches": launches["row_swap"],
            "max_abs_err": swap_err,
            "ms": swap["ms"],
            "plain_ms": swap["plain_ms"],
            "bound_ms": swap["bound_ms"],
            "bound_by": "bytes",
            "library_ms": swap["library_ms"],
            # QFT-32's nine row pairs at the card's capacity
            "capacity_n32": {"ms": cap_parts["row_swap_ms"],
                             "bound_ms": cap_parts["row_swap_bound_ms"]},
        },
        {
            # ms: a fresh copy with one strip per thread
            "name": "plane_copy",
            "route": "cuda",
            "source": "rustqip_tpu_torch/csrc/plane_copy.cu",
            "replaces": "scripts/copy_bandwidth_probe.py:56",
            "launches": launches["plane_copy"],
            "max_abs_err": 0.0,
            "ms": copy["fresh_strips1_ms"],
            "plain_ms": copy["plain_ms"],
            "bound_ms": copy["bound_ms"],
            "bound_by": "bytes",
            "library_ms": copy["library_ms"],
        },
    ]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

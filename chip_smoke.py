#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``rustqip_tpu_torch`` (never JAX or ``rustqip_tpu``) from the root of
a checkout: builds the three Hopper kernels from
``rustqip_tpu_torch/csrc/`` (``window_sweep.cu``, ``row_swap.cu``,
``plane_copy.cu``; one nvcc each, all started together), holds each against
its plain PyTorch version (the window kernel on the parity windows, the
row swap on five pair sets, exactly), then runs the main path --
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
this host) against the card at n = 20.

Then it times each kernel window of QFT-28 and Grover-28 alone
(``window_breakdown``), one window per redesigned step kind alone
(``step_breakdown``), the swap pass of QFT-28, QPE-28 and Shor-28 by part
(``swap_breakdown``), every sweep of QPE-28 and Shor-28
(``circuit_breakdown``) and the copy floor (``copy_floor``), each beside its
bound: the larger of the bytes it must move at 3.35 TB/s and its 3xTF32
tensor-core flops at 495 TFLOP/s, and, where there is one, the one PyTorch
call that computes the same function.

Each phase prints one JSON line; any failure raises, so the exit code is
non-zero. The second-to-last line is the ``kernels`` summary; the last
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
    """{kernel name: the module whose wrapper counts its launches}."""
    from rustqip_tpu_torch.engine import copy_probe, row_swap
    from rustqip_tpu_torch.engine import window_kernel as wk

    return {"window_sweep": wk, "row_swap": row_swap, "plane_copy": copy_probe}


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


def phase_build():
    """Build the three kernels from the checkout's sources (one nvcc each,
    started together) and load them."""
    from rustqip_tpu_torch.engine import cuda_build

    if cuda_build.BUILD_DIR.exists():
        shutil.rmtree(cuda_build.BUILD_DIR)
    t0 = time.perf_counter()
    names = list(kernel_modules())
    per = cuda_build.build(*names)
    for mod in kernel_modules().values():
        mod._lib()
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
    """Kernel vs plain on the parity windows at n=20 (f32)."""
    import torch

    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.admission import HOPPER, window_seg_sizes
    from rustqip_tpu_torch.engine.parity_windows import (
        build_sequences,
        lowr_sequence,
        step_windows,
    )
    from rustqip_tpu_torch.engine.real_apply import compile_sweeps

    n = N_PARITY
    re0, im0 = seeded_state(n, 0, "cuda")
    seen = set()
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
            kr, ki = re0.clone(), im0.clone()
            pr, pi = re0.clone(), im0.clone()
            wk.window_sweep(n, kr, ki, seg, ksteps, prog=prog)
            wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
            torch.cuda.synchronize()
            diff = max(diff, (kr - pr).abs().max().item(), (ki - pi).abs().max().item())
            kinds |= set(prog.kinds)
        if diff > KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain max|diff| {diff}")
        seen |= set(wk.KIND_LAUNCHES)
        worst = max(worst, diff)
        rows.append({"window": name, "kinds": sorted(kinds), "max_abs_diff": diff})
    for name, hq, ksteps, kinds in step_windows(n):
        seg = window_seg_sizes(n, hq)
        prog = wk.encode_window(n, seg, ksteps)
        kr, ki = re0.clone(), im0.clone()
        pr, pi = re0.clone(), im0.clone()
        wk.window_sweep(n, kr, ki, seg, ksteps, prog=prog)
        wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
        torch.cuda.synchronize()
        diff = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
        if diff > KERNEL_TOL:
            raise AssertionError(f"{name}: kernel vs plain max|diff| {diff}")
        worst = max(worst, diff)
        rows.append({"window": name, "kinds": sorted(kinds), "max_abs_diff": diff})
    seen |= set(wk.KIND_LAUNCHES)
    missing = set(wk.KINDS) - seen
    if missing:
        raise AssertionError(f"step kinds never launched: {sorted(missing)}")
    emit({"phase": "kernel_vs_plain", "n": n, "tol": KERNEL_TOL,
          "windows": rows, "kinds_launched": dict(wk.KIND_LAUNCHES)})
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
    marked = 0b1011001110001111000011110101 & ((1 << n) - 1)
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
                   "plane_copy": {"controlled_wide_swap28"}}
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
        """max |amp_k - exp(2 pi i x k / 2^n) / 2^(n/2)| over every state
        index k (the port's QFT is the DFT on big-endian state indices),
        from a float64 closed form made on the card in chunks."""
        size, amp = 1 << n, 2.0 ** (-n / 2)
        re, im = st[0].reshape(-1), st[1].reshape(-1)
        err = 0.0
        for lo in range(0, size, 1 << 24):
            k = torch.arange(lo, lo + (1 << 24), device="cuda", dtype=torch.int64)
            ph = ((k * x) % size).to(torch.float64) * (2 * math.pi / size)
            err = max(err,
                      (re[lo:lo + k.numel()].double() - amp * torch.cos(ph)).abs().max().item(),
                      (im[lo:lo + k.numel()].double() - amp * torch.sin(ph)).abs().max().item())
        return err

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


def phase_window_breakdown(ccs):
    """Each kernel window of QFT-28 and of the gate-form Grover-28
    iteration alone, on a seeded random state: kernel time (median of
    REPS, CUDA events), device-memory bytes it must move (live strips read
    + written, both planes) and the rate that implies. QFT-28's windows
    are also run through the plain version, for the kernels line."""
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
    for name in ("qft28", "grover28_iteration_gate"):
        windows = []
        for info, plan in observe.sweep_plans(ccs[name]):
            if info["kernel"]:
                sg, ksteps, prog = plan[0][1]
                kr, ki = x[0].clone(), x[1].clone()
                ms = cuda_ms(lambda: wk.window_sweep(n, kr, ki, sg, ksteps, prog=prog))
                strip_bytes = (x.shape[1] >> prog.h) * 128 * 4 * 2
                moved = (bin(prog.in_mask).count("1") + bin(prog.out_mask).count("1")) * strip_bytes
                bound_ms, bound_by = window_bound(prog, n)
                row = {"h": prog.h, "tile_rows": prog.bt, "steps": prog.nsteps,
                       "kinds": list(prog.kinds), "smem_bytes": prog.smem_bytes,
                       "ms": ms, "bytes": moved, "GB_per_s": moved / ms / 1e6,
                       "bound_ms": bound_ms, "bound_by": bound_by}
                if name == "qft28":
                    kr, ki = x[0].clone(), x[1].clone()
                    pr, pi = x[0].clone(), x[1].clone()
                    wk.window_sweep(n, kr, ki, sg, ksteps, prog=prog)
                    wk.window_sweep_reference(n, pr, pi, sg, ksteps, prog=prog)
                    torch.cuda.synchronize()
                    worst = max(worst, (kr - pr).abs().max().item(),
                                (ki - pi).abs().max().item())
                    row["plain_ms"] = cuda_ms(
                        lambda: wk.window_sweep_reference(n, pr, pi, sg, ksteps, prog=prog))
                    kms += ms
                    pms += row["plain_ms"]
                    bound[bound_by] += bound_ms
                    del pr, pi
                del kr, ki
                windows.append(row)
        emit({"phase": "window_breakdown", "circuit": name,
              "kernel_ms_sum": sum(w["ms"] for w in windows), "windows": windows})
    if worst > E2E_TOL:
        raise AssertionError(f"QFT-28 windows: kernel vs plain max|diff| {worst}")
    return kms, pms, worst, bound


def phase_step_breakdown(ccs):
    """One window per redesigned step kind, alone, at n = 28 on a seeded
    state: kernel ms (CUDA events, median of REPS after a warm-up), the
    plain version's ms, the bound, and the one PyTorch call that computes
    the same function where there is one (timed here, used nowhere in the
    port). Kernel vs plain is checked on every row."""
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

    cases = [
        ("low_c64_low_matmul", (R,), [("low", B)], None),
        ("lowr_h0", (R,), [("low", Br)], None),
        ("rmix_grover_diffusion", *grover_rmix),
        ("diag_qft_cp_fan", *lone("diag_cp_fan"), None),
        ("diag_many_groups", *lone("diag_many_groups"), None),
    ]
    worst = 0.0
    for name, seg, ksteps, prog in cases:
        if prog is None:
            prog = wk.encode_window(n, seg, ksteps)
        kr, ki = x[0].clone(), x[1].clone()
        pr, pi = x[0].clone(), x[1].clone()
        wk.window_sweep(n, kr, ki, seg, ksteps, prog=prog)
        wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
        torch.cuda.synchronize()
        diff = max((kr - pr).abs().max().item(), (ki - pi).abs().max().item())
        if diff > KERNEL_TOL:
            raise AssertionError(f"step {name}: kernel vs plain max|diff| {diff}")
        worst = max(worst, diff)
        ms = cuda_ms(lambda: wk.window_sweep(n, kr, ki, seg, ksteps, prog=prog))
        plain_ms = cuda_ms(lambda: wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog))
        del pr, pi
        bound_ms, bound_by = window_bound(prog, n)
        row = {"phase": "step_breakdown", "step": name, "n": n, "h": prog.h,
               "tile_rows": prog.bt, "smem_bytes": prog.smem_bytes,
               "kinds": list(prog.kinds), "ms": ms, "plain_ms": plain_ms,
               "bound_ms": bound_ms, "bound_by": bound_by,
               "bound_share": bound_ms / ms, "library_ms": None,
               "max_abs_diff": diff}
        if name == "low_c64_low_matmul":
            # the user-facing function (it runs the kernel on copies)
            row["c64_low_matmul_ms"] = cuda_ms(lambda: wk.c64_low_matmul(kr, ki, B))
            xc = torch.complex(kr, ki)
            bc = torch.as_tensor(np.ascontiguousarray(B.T), dtype=torch.complex64,
                                 device="cuda")
            row["library_ms"] = cuda_ms(lambda: torch.matmul(xc, bc))
            row["library_call"] = "torch.matmul complex64 (R,128)@(128,128), full fp32"
            del xc
        elif name == "lowr_h0":
            x2 = torch.cat([kr, ki])
            bt = torch.as_tensor(np.ascontiguousarray(Br.T), dtype=torch.float32,
                                 device="cuda")
            row["library_ms"] = cuda_ms(lambda: torch.matmul(x2, bt))
            row["library_call"] = "torch.matmul float32 (2R,128)@(128,128), full fp32"
            del x2
        del kr, ki
        torch.cuda.empty_cache()
        emit(row)
    return worst


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
    phase_env()
    phase_build()
    parity_err = phase_parity()
    swap_err = phase_swap_parity()
    rows, launches, kind_launches, ccs = phase_main()
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
    kms, pms, qft_err, bound = phase_window_breakdown(ccs)
    step_err = phase_step_breakdown(ccs)
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
            # no one PyTorch call computes a window's step chain; the lone
            # matrix steps' library calls are in the step_breakdown rows
            "library_ms": None,
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

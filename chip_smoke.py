#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives ``rustqip_tpu_torch`` (never JAX or ``rustqip_tpu``) from the root of
a checkout: builds the Hopper window kernel from
``rustqip_tpu_torch/csrc/window_sweep.cu``, holds it against its plain
PyTorch version on the parity windows, then runs the main path —
``LocalBuilder`` -> compile -> window-kernel sweeps -> measurement — at
n = 28 qubits in float32 (2 GiB of state) and checks the results against
closed forms and against the plain torch paths on the same card.

Then it times each kernel window of QFT-28 and Grover-28 alone
(``window_breakdown``) and one window per redesigned step kind alone
(``step_breakdown``: the tensor-core matrix steps and the separable diag),
each beside its bound (the larger of the bytes it must move at 3.35 TB/s
and its 3xTF32 tensor-core flops at 495 TFLOP/s) and, for the lone matrix
steps, the one ``torch.matmul`` that computes the same function.

Each phase prints one JSON line; any failure raises, so the exit code is
non-zero. The second-to-last lines are the ``kernels`` summary; the last
line is ``{"ok": true, "device": {...}}``. Without a CUDA device, or without
the package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
N_MAIN = 28
N_PARITY = 20
KERNEL_TOL = 1e-6  # kernel vs plain, normalized n=20 state (max abs)
E2E_TOL = 1e-5  # f32 end to end at n=28 (max abs)
REPS = 3
# Peak rates of one H100 SXM (NVIDIA data sheet, dense): bounds are
# max(bytes / HBM rate, tensor-core flops / TF32 rate).
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def cuda_ms(fn, reps: int = REPS) -> float:
    """Median milliseconds of ``fn()`` by CUDA events (one warm-up)."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
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


def phase_env():
    import torch

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    from rustqip_tpu_torch.engine import window_kernel as wk

    nvcc = wk._nvcc()
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
    from rustqip_tpu_torch.engine import window_kernel as wk

    if wk.BUILD_DIR.exists():
        shutil.rmtree(wk.BUILD_DIR)
    t0 = time.perf_counter()
    so = wk.build()
    wk._lib()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "library": str(so.relative_to(ROOT))})


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


def _builder(kernel: bool):
    from rustqip_tpu_torch.prelude import LocalBuilder

    return LocalBuilder(dtype="f32", device="cuda", kernel_ok=None if kernel else False)


def run_circuit(name, build, check):
    """Build the same circuit twice (kernel path, plain path), run the
    kernel path once with the launch counters zeroed just before and read
    just after, check both results, and time both paths."""
    import torch

    from rustqip_tpu_torch.engine import window_kernel as wk

    out = {}
    for label, kernel in (("kernel", True), ("plain", False)):
        b = _builder(kernel)
        handles = build(b)
        cc = b.compile()
        gen = torch.Generator()
        gen.manual_seed(7)
        torch.cuda.synchronize()
        if kernel:
            wk.reset_launch_counts()
        re, im, res = cc.run(b.initial_index(handles.get("init", ())), generator=gen)
        torch.cuda.synchronize()
        launches = wk.LAUNCHES["window_sweep"] if kernel else 0
        if kernel:
            kinds = dict(wk.KIND_LAUNCHES)
        check(re, im, res, handles)
        ms = cuda_ms(lambda: cc.run(b.initial_index(handles.get("init", ())),
                                    generator=gen))
        out[label] = (re, im, cc, launches, ms)
        del re, im
    (kr, ki, kcc, launches, kms), (pr, pi, pcc, _, pms) = out["kernel"], out["plain"]
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


def phase_main():
    import numpy as np
    import torch

    from rustqip_tpu_torch.algos import grover_iteration, qfft

    from collections import Counter

    n = N_MAIN
    rows = []
    total_launches = 0
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

    circuits = [
        ("cswap_readme", cswap, check_cswap),
        ("qft28", qft28, check_qft),
        ("grover28_iteration_gate", *grover(False)),
        ("grover28_iteration_native", *grover(True)),
    ]
    ccs = {}
    for name, build, check in circuits:
        row, launches, cc = run_circuit(name, build, check)
        if name != "cswap_readme" and launches <= 0:
            raise AssertionError(f"{name}: the main path launched no kernel")
        ccs[name] = cc
        total_launches += launches
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

    # (d) bench.py's fused and unfused arms, kernel vs plain paths.
    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.admission import HOPPER
    from rustqip_tpu_torch.engine.real_apply import compile_sweeps, run_sweeps
    from rustqip_tpu_torch.ops import gates
    from rustqip_tpu_torch.ops.matrix_ops import make_matrix_op

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
        wk.reset_launch_counts()
        kr, ki = run_sweeps(n, ks, kr, ki)
        torch.cuda.synchronize()
        launches = wk.LAUNCHES["window_sweep"]
        if launches <= 0:
            raise AssertionError(f"{name}: the main path launched no kernel")
        total_launches += launches
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
    return rows, total_launches, dict(kind_launches), ccs


def phase_window_breakdown(ccs):
    """Each kernel window of QFT-28 and of the gate-form Grover-28
    iteration alone, on a seeded random state: kernel time (median of
    REPS, CUDA events), device-memory bytes it must move (live strips read
    + written, both planes) and the rate that implies. QFT-28's windows
    are also run through the plain version, for the kernels line."""
    import torch

    from rustqip_tpu_torch.engine import window_kernel as wk

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
        for seg in ccs[name].sweeps:
            for kind, payload, _run in seg:
                if kind != "kwindow":
                    continue
                sg, ksteps, prog = payload
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
    rows, launches, kind_launches, ccs = phase_main()
    kms, pms, qft_err, bound = phase_window_breakdown(ccs)
    step_err = phase_step_breakdown(ccs)
    emit({"phase": "done", "seconds": time.perf_counter() - t0})
    emit({"kernels": [{
        "name": "window_sweep",
        "route": "cuda",
        "source": "rustqip_tpu_torch/csrc/window_sweep.cu",
        "replaces": "rustqip_tpu/engine/pallas_kernels.py:1155",
        "launches": launches,
        "kind_launches": kind_launches,
        "max_abs_err": max(parity_err, qft_err, step_err),
        "ms": kms,
        "plain_ms": pms,
        "bound_ms": sum(bound.values()),
        "bound_by": max(bound, key=bound.get),
        # no one PyTorch call computes a window's step chain; the lone
        # matrix steps' library calls are in the step_breakdown rows
        "library_ms": None,
    }]})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())

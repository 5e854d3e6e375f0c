"""A/B of the window kernel's tile path (``csrc/window_sweep.cu``) on one
card, in one process:

    python -m rustqip_tpu_torch.tools.tile_ab [name=path/to/variant.cu ...]

Builds the checkout's ``window_sweep.cu`` and each variant source given
(a copy of it with one design changed; same C entry point) with
``cuda_build.NVCC_FLAGS`` into ``build/tile_ab/``, then times, at n = 28 on a
seeded state, the tile windows the design choices move: QPE-28's and
QFT-28's h = 0 lane ladders (the latter whole, without its ``low`` and its
last two steps), a lone complex ``low`` and a lone ``lowr``, Grover-28's
h = 2 lane window and h = 4 tile windows and its diffusion ``rmix``. Each
window runs once per arm against the plain version (1e-6), then is timed
(CUDA events, median of 3) per arm in turns, a b ... b a; the checkout's
kernel also runs with a two-stage B ring (``nstage=2``) where its program
has more. Prints the card's name and power limit, then one JSON line per
window: {arm: [ms, ms]}.
"""

from __future__ import annotations

import ctypes
import dataclasses
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]


def _build(out: Path, name: str, src: str):
    from rustqip_tpu_torch.engine import cuda_build

    cu, so = out / f"{name}.cu", out / f"{name}.so"
    cu.write_text(src)
    res = subprocess.run([cuda_build.nvcc(), *cuda_build.NVCC_FLAGS, "-o", str(so), str(cu)],
                         capture_output=True, text=True)
    if res.returncode:
        raise RuntimeError(f"nvcc failed on {name}:\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(str(so))
    fn = lib.rq_window_sweep
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 11 + [ctypes.c_longlong] * 6 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def main(argv) -> int:
    import numpy as np
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from rustqip_tpu_torch.algos.phase_estimation import phase_estimate
    from rustqip_tpu_torch.engine import window_kernel as wk
    from rustqip_tpu_torch.engine.parity_windows import rand_u, real_orthogonal

    if not torch.cuda.is_available():
        print("tile_ab: no CUDA device", file=sys.stderr)
        return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)
    srcs = {"cur": (ROOT / "rustqip_tpu_torch/csrc/window_sweep.cu").read_text()}
    for arg in argv:
        name, path = arg.split("=", 1)
        srcs[name] = Path(path).read_text()
    out = ROOT / "build" / "tile_ab"
    out.mkdir(parents=True, exist_ok=True)
    with ThreadPoolExecutor(len(srcs)) as pool:
        libs = dict(zip(srcs, pool.map(lambda kv: _build(out, *kv), srcs.items())))

    n, R = cs.N_MAIN, 1 << (cs.N_MAIN - 7)
    ccs = cs.compile_breakdown_circuits()
    m_ph = 24  # phase_main's QPE-28
    phases = np.random.default_rng(24).integers(0, 1 << m_ph, size=16)
    b = cs._builder(True)
    phase_estimate(b, np.diag(np.exp(2j * np.pi * phases / (1 << m_ph))), m_ph,
                   prepare=lambda bb, t: bb.x(t))
    ccs["qpe28"] = b.compile()

    def kwindows(name):
        return [item[1] for seg in ccs[name].sweeps if isinstance(seg, (list, tuple))
                for item in seg if isinstance(item, tuple) and item[0] == "kwindow"]

    tile = lambda name: [p for p in kwindows(name) if p[2].path == "tile"]  # noqa: E731
    lad = next(p for p in tile("qft28") if p[2].h == 0)
    grover = tile("grover28_iteration_gate")
    cases = {
        "qpe28_lane_ladder": max((p for p in tile("qpe28") if p[2].h == 0),
                                 key=lambda p: p[2].nsteps),
        "qft28_lane_ladder": lad,
        "qft28_ladder_without_low": (lad[0], [s for s in lad[1] if s[0] != "low"], None),
        "qft28_ladder_cbf_low": (lad[0], lad[1][-2:], None),
        "low_complex_h0": ((R,), [("low", rand_u(7, 61))], None),
        "lowr_h0": ((R,), [("low", real_orthogonal(63))], None),
        "grover28_h2_lane_window": next(p for p in grover if p[2].h == 2
                                        and [s[0] for s in p[1]] == ["mix", "rbf", "rbf", "rbf", "low"]),
        "grover28_h4_mix_rbf": next(p for p in grover if p[2].h == 4 and not p[2].nchunks),
        "grover28_h4_lowr": next(p for p in grover if p[2].h == 4 and "lowr" in p[2].kinds),
        "grover28_diffusion_rmix": max((p for p in grover if "rmix" in p[2].kinds),
                                       key=lambda p: p[2].nchunks),
    }
    g = torch.Generator(device="cuda")
    g.manual_seed(21)
    x = torch.randn((2, R, 128), generator=g, device="cuda")
    x /= x.norm()
    for name, (seg, ksteps, prog) in cases.items():
        prog = prog or wk.encode_window(n, seg, ksteps)
        arms = [(v, prog) for v in libs]
        if prog.nstage > 2:
            arms.append(("cur_nstage2", dataclasses.replace(prog, nstage=2, _dev={})))
        pr, pi = x[0].clone(), x[1].clone()
        wk.window_sweep_reference(n, pr, pi, seg, ksteps, prog=prog)
        kr, ki = x[0].clone(), x[1].clone()
        row = {}
        for arm, p in arms + arms[::-1]:
            wk._LIB = libs[arm.split("_nstage")[0]]
            if arm not in row:
                ar, ai = x[0].clone(), x[1].clone()
                wk.window_sweep(n, ar, ai, seg, ksteps, prog=p)
                torch.cuda.synchronize()
                err = max((ar - pr).abs().max().item(), (ai - pi).abs().max().item())
                if err > cs.KERNEL_TOL:
                    raise AssertionError(f"{name} on {arm}: kernel vs plain max|diff| {err}")
                del ar, ai
            row.setdefault(arm, []).append(
                cs.cuda_ms(lambda: wk.window_sweep(n, kr, ki, seg, ksteps, prog=p)))
        print(json.dumps({"window": name, "h": prog.h, "tile_rows": prog.bt,
                          "group": prog.group, "ms": row}), flush=True)
        del pr, pi, kr, ki
        torch.cuda.empty_cache()
    wk._LIB = None
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

"""The engine's seams, on the CPU: the one launch check of the kernel
libraries (``engine/cuda_build.launch``, with a stand-in entry point), the
one kernel policy (``engine/admission.kernel_policy``), and the direction
of the imports at the bottom of the engine, read from the sources.
"""

import ast
import contextlib
import types as pytypes
from pathlib import Path

import pytest
import torch

from rustqip_tpu_torch.engine import cuda_build
from rustqip_tpu_torch.engine.admission import kernel_policy

torch.set_num_threads(1)  # the test runner keeps one worker per core busy

PACKAGE = Path(__file__).resolve().parents[1] / "rustqip_tpu_torch"


@pytest.mark.parametrize("err", [0, 700])
def test_launch_checks_and_counts(monkeypatch, err):
    """A launch that returns 0 counts under its kernel's name and the keys
    it adds; a non-zero CUDA error raises ``RuntimeError`` naming the
    kernel and counts nothing. The entry point gets its arguments and the
    stream last."""
    monkeypatch.setattr(torch.cuda, "device", lambda device: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: pytypes.SimpleNamespace(cuda_stream=77))
    calls = []

    def entry(*args):
        calls.append(args)
        return err

    before = dict(cuda_build.LAUNCHES)
    if err:
        with pytest.raises(RuntimeError, match=f"row_swap kernel launch failed: CUDA error {err}"):
            cuda_build.launch("row_swap", entry, "cpu", 1, 2, also=["window_kind:mix"])
        assert dict(cuda_build.LAUNCHES) == before
    else:
        cuda_build.launch("row_swap", entry, "cpu", 1, 2, also=["window_kind:mix"])
        assert cuda_build.LAUNCHES["row_swap"] == before.get("row_swap", 0) + 1
        assert cuda_build.LAUNCHES["window_kind:mix"] == before.get("window_kind:mix", 0) + 1
    assert calls == [(1, 2, 77)]


@pytest.mark.parametrize("devices, dtype, kernel_ok, want", [
    (["cpu"], torch.float32, None, False),
    (["cuda"], torch.float32, None, True),
    (["cuda"], torch.float64, True, False),
    (["cpu"], torch.float32, True, True),
], ids=["cpu_default_off", "cuda_default_on", "float64_always_off", "cpu_asked_on"])
def test_kernel_policy(devices, dtype, kernel_ok, want):
    """CUDA by default, float32 only; the caller's ``kernel_ok`` wins on
    any device (the CPU plan twins plan kernel windows that way)."""
    assert kernel_policy([torch.device(d) for d in devices], dtype, kernel_ok) is want


def _package_imports(path: Path) -> set:
    """The package modules a source imports, function-local imports
    included, as dotted names under the package (``engine.cuda_build``)."""
    found = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            mods = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            mods = [f"{node.module}.{a.name}" for a in node.names]
        else:
            continue
        for mod in mods:
            parts = mod.split(".")
            if parts[0] != "rustqip_tpu_torch":
                continue
            parts = parts[1:]
            # ``from pkg.mod import name``: a submodule when its file exists
            while parts and not (PACKAGE.joinpath(*parts).with_suffix(".py").exists()
                                 or PACKAGE.joinpath(*parts).is_dir()):
                parts = parts[:-1]
            found.add(".".join(parts))
    return found


@pytest.mark.parametrize("source, allowed", [
    ("types.py", set()),
    ("engine/apply.py", {"types", "errors", "utils.bits", "ops.matrix_ops"}),
    ("engine/admission.py", {"types"}),
    ("engine/cuda_build.py", set()),
], ids=["types", "apply", "admission", "cuda_build"])
def test_bottom_of_the_engine_imports_only_downward(source, allowed):
    """The plane format, the plain passes, the admission and the kernel
    seam import only the package modules below them."""
    assert _package_imports(PACKAGE / source) <= allowed


@pytest.mark.parametrize("kernel_ok", [True, False], ids=["on", "off"])
def test_compiled_run_keeps_the_monomial_kernel_to_its_policy(monkeypatch, kernel_ok):
    """``CompiledCircuit.run`` hands its kernel policy to the monomial pass:
    with ``kernel_policy`` answering as on a CUDA device, a circuit compiled
    with the kernels off asks every pass for the plain version, one with
    them on asks for the kernel (which a CPU plane then declines)."""
    from rustqip_tpu_torch.algos import shor_period_circuit
    from rustqip_tpu_torch.engine import monomial, real_apply
    from rustqip_tpu_torch.prelude import LocalBuilder

    asked = []
    plain_pass = monomial.monomial_pass

    def recorded(n, plan, xr, xi, inplace=False, kernel=True):
        asked.append(kernel)
        return plain_pass(n, plan, xr, xi, inplace, kernel)

    monkeypatch.setattr(real_apply, "kernel_policy",
                        lambda devices, dtype, ok=None: True if ok is None else ok)
    monkeypatch.setattr(monomial, "monomial_pass", recorded)
    b = LocalBuilder(dtype="f32", device="cpu", kernel_ok=kernel_ok)
    shor_period_circuit(b, 2, 1007, t=3)
    b.compile().run(0, generator=torch.Generator().manual_seed(1))
    assert asked == [kernel_ok] * 3

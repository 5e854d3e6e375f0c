"""What the harness loads: no JAX, no JAX package (top-level names
compared whole, so ``rustqip_tpu_torch`` is not ``rustqip_tpu``), and the
references load nothing of the port."""

import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = {"jax", "jaxlib", "flax", "rustqip_tpu"}


def _top_modules(code: str) -> set:
    prog = (f"import sys; sys.path.insert(0, {str(ROOT)!r})\n{code}\n"
            "import json; print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", prog], capture_output=True, text=True,
                         cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_the_harness_loads_no_jax():
    metrics = sorted(p.stem for p in (ROOT / "portbench" / "metrics").glob("*.py")
                     if p.stem != "__init__")
    circuits = sorted(p.stem for p in (ROOT / "portbench" / "circuits").glob("*.py"))
    refs = sorted(p.stem for p in (ROOT / "portbench" / "reference").glob("*.py"))
    code = "\n".join(
        ["import portbench.run, portbench.harness, portbench.jobs, portbench.check",
         "import portbench.limits, portbench.roofline, portbench.trace_math",
         "from portbench import harness",
         *[f"import portbench.circuits.{c}" for c in circuits],
         *[f"import portbench.reference.{r}" for r in refs],
         *[f"harness.metric_reader({m!r})" for m in metrics],
         "import rustqip_tpu_torch.prelude"])
    mods = _top_modules(code)
    assert "rustqip_tpu_torch" in mods and "torch" in mods
    assert not mods & FORBIDDEN, mods & FORBIDDEN


def test_the_references_load_nothing_of_the_port():
    refs = sorted(p.stem for p in (ROOT / "portbench" / "reference").glob("*.py"))
    mods = _top_modules("\n".join(f"import portbench.reference.{r}" for r in refs))
    assert not mods & (FORBIDDEN | {"rustqip_tpu_torch"})


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "qpe28.resident",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, cwd=ROOT, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""
